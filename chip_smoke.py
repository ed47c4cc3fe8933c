#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own line; any failure prints a ``[failed]``
line naming the phase and the check, and the script exits non-zero
without printing a result:

  1. env      the card (torch and nvidia-smi), torch and CUDA versions;
  2. build    nvcc builds every kernel source of the port; the fused
              conv library's SASS (cuobjdump) holds HGMMA, the tensor
              cores' wgmma, and the flash-attention library's HMMA
              (mma.sync: its bf16 kernels, and HMMA on TF32 operands, its
              f32 forward); the flash-attention and
              flash-decode libraries spill no register (nvcc -Xptxas -v);
  3. kernels  each decode kernel (B3, B4: one cluster launch a call)
              against its plain PyTorch version on the card at cache
              lengths 32, 200, 256, 768 (the slot loop's ring) and 1024,
              head_dims 64 and 128, f32 and bf16, full, ragged, edge and
              anywhere-in-the-ring windows; two launches on
              one input give the same bits; then its time at the served
              shape and at S = 1024 beside the plain version, a library
              call and the card's bound; the query-block form (the
              speculative verify block: T = 2 and 5 queries a row, S =
              256 and 768, f32, bf16 and int8, full, ragged and
              ring-end windows) against its plain version under the same
              limits and bit-equal to T one-query launches, then timed
              at T = 5, S = 768 beside its plain version, SDPA with the
              same mask and its bound;
  4. serving  GPT-2 small (random bf16 weights from --seed) served
              through Server.register_decode/start/submit_decode, once
              with the bf16 KV cache and once with the int8 one: every
              served row equals a batch-1 generate() of its prompt, and
              each kernel's launch count equals layers x decode steps x
              batches (the profile phase times the row-invariant GEMMs
              against plain ones); then one 8-prompt request per wave at short
              sequence buckets (16, 32), whose caches of 32 and 48
              columns are shorter than the kernel's 64-column span:
              launch counts again, and every row equals generate() of the
              same batch and its own batch-1 generate();
  5. profile  one 8-row decode loop timed, then traced with
              torch.profiler: device busy time, kernel launches a step
              and kernel time by name; the decode kernel's time
              (decode_cluster_kernel) must be > 0 when the traced loop
              launched it;
  6. slots    GPT-2 small served through the slot loop (Server with
              FLAGS_decode_slots=8, FLAGS_prefill_chunk=64, one 768-column
              ring, up to 96 new tokens), bf16 then int8 KV, on the churn
              trace of 48 requests (every 5th prompt 96-127 tokens, every
              4th request 96 new tokens): every served token is the
              argmax of batch-1 generate() fed the row's own tokens, or
              within 2^-6 of its max |logit| of the top (a near tie, at
              most 4% of the tokens; the rows equal to generate() are
              counted); no step is built after warm-up; every step is a
              replay of the captured graph (replays = steps, no wrapper
              launch); that graph holds 12 decode-kernel nodes (read
              back through libcuda), so the churn launched 12 x
              steps, and 20 of its replays traced with torch.profiler
              show them run (a replay runs no wrapper; the kernels
              line's launches are the serving phase's);
              the captured step equals the eager step bit for bit at C =
              768 (planes, logits, tokens, finished), and both are timed
              (host and device ms, idle share, kernels a step); a
              shared-prefix pass (6 requests, 256-token prefix, 48-token
              suffix) with the prefix cache on and off: hit tokens > 0,
              rows as above (near ties at most 8.5%), TTFT;
  6a. sessions parked sessions on the same slot server: 16 seeded
              conversations of 3 turns (turn 1 of 96-127 tokens, later
              turns 16-48 new tokens, replies 16-32), each turn of every
              conversation through submit_decode(session_id=) before the
              next turn starts, bf16 then int8 KV, with FLAGS_session_store
              on (restored = 32, parked = 48) and off (the transcript
              re-prefilled; turns 2-3's TTFT of each), and the first 8
              conversations through the speculative slot server (restored
              = 16, the verify block over restored rows): every token held
              as in the slots phase (near ties at most 4%), every restore's
              pull of the row's window equal to its snapshot bit for bit,
              every step a replay of a graph with the slots and spec
              phases' decode nodes; spill and restart (a write-through
              spill directory: spilled blobs equal the RAM snapshots byte
              for byte, one blob truncated, a new server restores the
              other 15 for turn 3 and re-prefills the torn one); drain (8
              requests of 96 new tokens, admitted together: drain() parks
              8 mid-generation once the last to start has emitted a count
              of tokens set from --seed, the same counts every run, their
              futures fail with UnavailableError, a second server over
              the spill directory resumes each, its preseed exact; the
              tokens before the park held to generate() as slot rows, the
              resumed ones to a geometry-matched oracle that replays each
              row from its snapshot at the columns it was served at, and
              their gaps against generate() reported);
              parked capacity (1000 conversations of 160 + 2 tokens:
              host bytes a session held to the widths, parks a second,
              ring bytes a conversation with and without the store); the
              KV handoff (prefill_handoff -> serialize_kv -> deserialize_kv
              -> decode_from_handoff on the serving phase's first 8
              requests, bf16 and int8: planes exact, tokens equal to the
              in-process continuation, blob bytes and seconds);
  6b. spec    speculative decoding, GPT-2 small target and a random
              4-layer draft (bench.py's draft widths at vocab 50257),
              gamma 4, bf16: generate() at batch 1 and 8, 128-token
              prompts, 128 new tokens, bf16 and int8 KV, equals the plain
              Generator at the same cache length token for token, with
              the random draft and with the target as its own draft
              (acceptance 1.0 in 26 steps), launching the block form
              once a target layer and the one-query kernel 5 times a
              draft layer per step (tok/s of each); the run-to-completion
              server under FLAGS_spec_decode on the serving phase's first
              8 requests: every row equals its batch-1 greedy decode at the
              runtime's cache; the speculative slot server on the churn
              trace's first 24 requests, bf16 then int8, rows held as in
              the slots phase, every step a replay, none built after
              warm-up, a graph of 32 decode-kernel nodes (4 x 5 draft +
              12 verify) and 20 traced replays that run them, the
              captured step equal to the eager one (both caches, e,
              cur, finished, ncommit, n), and a
              self-draft pass accepting every proposal;
      beam    generate(beam_size=4), batch 2, 64-token prompts, 32 new
              tokens: scores non-increasing, tokens in range, B3 launched
              12 x 32 times, each path's score equal to the sum of its
              tokens' log-probs fed back as B*K rows at the same cache;
  7. e2e      kernel against plain end to end: f32 generate() with
              FLAGS_use_flash_decode on and off gives equal tokens and
              last logits within 1e-4;
  7b. decode_int8  bench_decode at its chip configuration (bench.py:
              1096-1104: vocab 32000, GPT-2 small's widths, random weights
              from --seed; prompt 128, 128 new tokens, batches 1 and 8,
              buckets 128/256/512): the bf16 variant (amp.decorate
              O2, the tied head following the embedding) and the int8 one (f32, PTQ over 4 batches of one
              RandomState(0) prompt, frozen: 72 int8 sites) timed as
              bench.py times them (prefill and decode apart, best of 3;
              decode tok/s at batch 1 and 8, the int8/bf16 speedup at
              batch 8), B3 launched 12 x 128 a generate(); a profiled
              one-step decode(); the serving phase's 16 requests through
              register_decode (rows = batch-1 generate()); every row of a
              batch-8 generate() of the first 8 of them equals its
              batch-1 generate() with the f32 cache (the server check's
              rows) and with the int8 one (B4, f32 query); every int8
              product of a
              prefill and a step equals the exact one on the CPU and the
              LM head is the only float GEMM; the card against the port on
              the CPU over a prefill and 3 steps, free (reported) and
              with the CPU on the card's activation codes (each within
              one step of its own; logits within DECODE_PINNED_RTOL);
              16 churn
              requests through the slot loop, f32 then int8 KV (rows
              held as in the slots phase, every step a replay of a graph
              of 12 decode nodes, captured step = eager step); B3 f32
              and B4 f32-query at the served shape against their plain
              versions, timed beside them, SDPA f32 and the bound;
  8. fa_kernels  the flash-attention kernels (forward B1, backward B2:
              dQ and dK/dV) against their plain versions in f32 and bf16
              over head_dims 64/128/256, lengths 128, 200, 256, 64 and
              128 x 384, cross-attention 96 x 40 and 40 x 96 (not
              causal), causal, the three bias shapes and the square
              -1e30 target mask; then at BERT-base (B=64, N=12, S=128,
              H=64) on the strided views the model passes, with and
              without the padding bias, and at Transformer-big (B=64,
              N=16, S=64, H=64, no mask): checked in f32 and bf16 (in
              bf16 also twice: the same bits), and timed in bf16 beside
              the bound, the plain versions and SDPA;
  8b. dense   bench_serving's six variants (bench.py:824-880): the bf16
              models first, each
              built through the port's public API as bench.py builds it
              (vision LeNet; bench.py's Block(nn.Layer) of Conv2D(bias_attr
              =False), BatchNorm2D and ReLU twice with the residual add, at
              ch 64, hw 56; BertModel(BertConfig.base())), random weights
              from --seed, cast to bf16 by paddle.amp.decorate(level="O2")
              behind bench.py's _BF16Serve(nn.Layer), served one after
              another through the dense path: export_for_serving
              (torch.export; one program, or one a bucket) ->
              Server(workers=2).register -> start (one CUDA graph a
              bucket, 1..16) -> submit, under bench_serving's traffic (8
              clients, 1-4 rows a request, 8 s, seeded inputs): QPS, p50
              and p99 (against the JAX package's SLOs, 50, 100 and 250
              ms), batch rows, padding, export and warm-up time; no
              capture after warm-up; every graph and worker reads the
              loaded program's one set of weights; BERT's program holds
              one B1 operator node a layer and no other attention, LeNet's
              and the block's none, and their runs launch no hand-written
              kernel; every result has its rows and equals the eager
              decorated model on its rows at the bucket it rode within
              2^-6 of max(1, max |ref|) (the bit-equal ones are counted);
              every bucket's graph holds 12 B1 forward kernel nodes for
              BERT, none for the others, and no library attention node
              (read back through libcuda, with each bucket-16 graph's
              kernel nodes and replay time), every batch was one replay,
              and 20 replays of BERT's bucket-16 graph traced with
              torch.profiler show its B1 nodes run; then the int8
              variants (bench.py:743-760): each model in f32 (random
              weights from --seed), PostTrainingQuantization over 4
              batches of one RandomState(0) bucket-1 input,
              FLAGS_use_int8_inference on, export_for_serving(int8=True)
              (frozen: one aten._int_mm, cuBLASLt's i8 x i8 -> i32 GEMM,
              per site, 5, 2 and 73, and no float GEMM or convolution in
              the program; BERT's float layers stay f32, so its program
              holds 12 f32 B1 nodes), the same traffic and checks, every
              result equal to the eager frozen model bit for bit; every
              site's int8 product on the card, on the codes of forwards
              at buckets 1 and 16, equal to the exact product on the
              CPU; LeNet's and the block's frozen output on the card
              against the same frozen state on the CPU (within
              INT8_CARD_CPU_RTOL); max |int8 - f32| / max |f32| reported;
              B1 at the served shape (B=16, N=12, S=128, H=64, no bias)
              in bf16 and in f32 checked and timed beside its plain
              version, SDPA and its bound;
  9. train    BERT-base pretraining (random weights from --seed, f32
              masters, bf16 compute, AdamW, dropout 0.1) at batch 64 x
              seq 128 with a ragged attention mask: 3 + 20 steps, seq/s,
              loss per step (finite, descending), launches of each
              flash-attention kernel = 12 layers x steps; one seed gives
              one first loss, another seed another; then train_parity
              (f32, dropout off, batch 8: 5 steps with the kernels on
              and off) and train_profile (one step under torch.profiler:
              the bf16 step runs the tensor-core kernels, and their share
              of the device-busy time);
  9b. seq2seq  Transformer-big at bench.py's configuration (vocab 32768,
              d_model 1024, 16 heads, 6 + 6 layers, ffn 4096, random
              weights from --seed, f32 masters, bf16 compute, Adam 1e-4)
              at batch 64 x seq 64: 3 + 10 steps on bench.py's seeded
              batch, tok/s, loss per step (finite, descending), launches
              of each flash-attention kernel = 18 a step (encoder self,
              decoder self, cross), peak memory; seq2seq_profile (one
              traced step: busy against host time, idle share, launches,
              the tensor-core kernels' share); seq2seq_parity (depth
              2 + 2, f32, batch 8, kernels on against off under a source
              padding mask and the square target mask: the loss and every
              gradient, then two Adam steps with ClipGradByGlobalNorm(1.0),
              NoamDecay and label-smoothed soft labels: the losses and
              parameters);
 10. batch_probe  one short prompt decoded alone and in an 8-row batch,
              module by module: no row may diverge;
 11. fused_kernels  B5 stats/apply, B6 reduce/dx and B7 against their
              plain versions at every distinct ResNet-50 conv+BN site
              (batch 2, 224 px), at M = 49, a 5x5/s2 site and odd widths,
              in f32 and bf16, relu on and off; the same checks in bf16
              at every distinct site at the main path's batch 256, where
              two B7 launches on one input must give the same bits and
              B7 is timed beside its bound and cuDNN's conv (per site and
              weighted by the 53 sites); then
              timed at batch 256 (stem, stage-1 3x3, the [802816, 256]
              epilogue), each on tensors checked first, beside the bound,
              the plain versions, cuDNN's conv and ATen's BN;
 12. resnet   ResNet-50 NHWC training (random weights from --seed, f32
              masters, bf16 compute, Momentum, CrossEntropyLoss) at batch
              256 x 224 px: 3 + 10 steps, img/s, loss per step (finite,
              descending), launches of B7, B5 apply and B6 = 53 sites x
              steps, one seed's first loss twice; resnet_profile (one
              traced step), resnet_paths (the fused-BN-only path: B5
              stats and apply = 53 x steps; and kernels off, cuDNN + plain
              BN, timed beside kernels on) and resnet_parity (f32, batch
              8, kernels on against off);
 13. wide_deep  bench.py's Wide&Deep CTR (WideDeep() defaults: 26 slots,
              emb 16, 13 dense, hidden 400 x 3; adagrad 0.05, Adam 1e-3;
              random weights from --seed) in device-cache mode, which
              launches no hand-written kernel: cache mode against
              pull/push, a capacity that evicts against the full one and
              the device dedup against np.unique, bit for bit (6 f32-wire
              batches of 8192); the card against the port on the CPU
              (batch 1024, 3 steps: losses, every parameter's and table's
              change); one batch of 32768 through the MultiSlot file path,
              2 + 8 bf16-wire steps (finite losses that fall), host and
              in-graph (captured-step) examples/s, the idle share of a
              traced window, cache hits, misses and evictions, host prep a
              step; read-through eval equal to the flushed tables'.

 14. static_lenet  bench.py's LeNet through the static graph
              (bench_lenet_static's program text with paddle read as
              paddle_tpu_torch: Program, static.nn, SGD(0.01).minimize,
              Executor, train_from_dataset), which launches no
              hand-written kernel: 5 Executor.run steps captured against
              5 eager ones from copies of one scope, bit for bit; the
              card against the port on the CPU (batch 128, 3 steps, TF32
              off: losses and every parameter's change); 200 steps of
              batch 128 per epoch, one epoch of warm-up and two timed:
              host and in-graph (replays alone) img/s, kernel nodes a
              step read from the captured graph, no capture after the
              warm-up, the idle share of 20 traced steps; and the same
              program under Adam(3e-3) on one repeated batch: the loss
              after 30 steps under half the first.
 15. static_infer  static_lenet's trained program as a static inference
              model, which launches no hand-written kernel:
              save_inference_model of the test clone, the Predictor
              (its own scope, CUDA) against Executor.run of the test
              clone at batches 1, 16 and 128, bit for bit; static.save of
              the train program, deserialize_program + static.load into
              a fresh scope, five steps against the running program's,
              bit for bit; the executor-backed Server (buckets 1-16, 2
              workers) under bench_serving's traffic for 8 s: QPS,
              p50/p99 against LeNet's 50 ms SLO, no steady-state
              capture, every served row equal to the Predictor's on the
              same padded bucket, the bucket-16 graph's kernel nodes and
              device ms; bench.py's batch-1 latency and batch-2048 img/s
              (best of 20); the phase's laps.

The last lines are the card as nvidia-smi reports it, the kernels'
JSON record, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# the operation rate of each input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
                  "tfloat32": 495e12}

# tolerances of a kernel against its plain version on the same inputs:
#  * f32: both compute f32 softmax attention, the kernel in per-rank
#    partials merged exactly, so only the summation order differs;
#  * bf16: the kernel's output is rounded to bf16 while the plain
#    version runs in f32 on the same bf16 inputs: half a bf16 step at
#    |out| < 4 is under 1e-2.
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
# bf16 kernel against the plain version run on the bf16 tensors
# themselves, which rounds p to bf16 before PV as JAX does: the two round
# p and the output at the same points, and differ where the kernel
# rounds p against its block's running max (over chunks of 8 to 32
# columns of a cluster rank's span) instead of the global one, and where
# that moves an output across a rounding boundary.  A CPU emulation of
# the kernel's order of arithmetic (tests/test_torch_flash_decode_order.py
# ``_kernel_order``: S of 32 to 1024, head_dims 64 to 256, five seeds)
# differs from the plain version and from JAX's reference by at most
# 0.00741 of the row's largest |out| (1.9 bf16 steps, 2^-7.08); the bound
# is 2^-6, per (batch, head) row.
BF16_ROW_RTOL = 2.0 ** -6

# the served configuration: GPT-2 small, two batch buckets, two
# sequence buckets, a 256-token ring, 128 new tokens per request
BATCH_BUCKETS = (1, 8)
SEQ_BUCKETS = (128, 256)
MAX_LEN = 256
MAX_NEW = 128
REQUESTS = 16
LAYERS_CACHES = 12      # distinct caches rotated through when timing
GRID = dict(batch_buckets=BATCH_BUCKETS, seq_buckets=SEQ_BUCKETS,
            max_len=MAX_LEN, max_new_tokens=MAX_NEW)
# short prompts at sequence buckets under 128: caches of 32 and 48
# columns, the lengths the default ladder gives short prompts.  Each wave
# is one request of 8 prompts whose lengths fill one prefill bucket
SHORT_GRID = dict(batch_buckets=BATCH_BUCKETS, seq_buckets=(16, 32),
                  max_len=48, max_new_tokens=16)
SHORT_WAVES = ((4, 16), (17, 32))
SHORT_REQUESTS = 8


def log(tag, **kw):
    """One line of a phase's results, with the seconds since start."""
    kw["t_s"] = round(time.perf_counter() - _T0, 1)
    print(f"[{tag}] " + json.dumps(kw, default=str), flush=True)


class SmokeFailure(RuntimeError):
    pass


_PHASE = "start"        # the phase running, named when one fails
_PHASE_S = {}           # seconds spent in each phase, logged at the end
_PHASE_T = _T0


def _at(phase):
    global _PHASE, _PHASE_T
    now = time.perf_counter()
    _PHASE_S[_PHASE] = round(_PHASE_S.get(_PHASE, 0.0) + now - _PHASE_T, 1)
    _PHASE, _PHASE_T = phase, now


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


# -- phase 1 -----------------------------------------------------------------

def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    env = {"device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": card,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]}
    log("env", **env)
    return env


# -- phase 2 -----------------------------------------------------------------

def _sass_counts(path):
    """The tensor-core instructions in a built library's SASS (cuobjdump
    -sass): HGMMA (wgmma), HMMA (mma.sync) and, of those, HMMA_TF32 (on
    TF32 operands: B1's f32 forward)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {path}: {out.stderr}")
    lines = out.stdout.splitlines()
    counts = {op: sum(f" {op}." in ln or f" {op} " in ln for ln in lines)
              for op in ("HGMMA", "HMMA")}
    counts["HMMA_TF32"] = sum(" HMMA." in ln and ".TF32" in ln
                              for ln in lines)
    return counts


def _spill_bytes(log):
    """The largest spill-store count of any kernel in an nvcc -Xptxas -v
    log (0 for a library loaded from an earlier build)."""
    return max((int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                           log)), default=0)


def phase_build():
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    for name in report:
        _build.library(name)
    # B7's bf16 kernel runs on the tensor cores: its library holds wgmma;
    # B1's and B2's bf16 kernels too, through mma.sync (HMMA), and B1's
    # f32 forward through mma.sync on TF32 operands (split TF32)
    sass = {n: _sass_counts(_build._lib_path(n))
            for n in ("fused_conv", "flash_attention")}
    check(sass["fused_conv"]["HGMMA"] > 0,
          f"fused_conv: no HGMMA in its SASS ({sass['fused_conv']})")
    check(sass["flash_attention"]["HMMA"] + sass["flash_attention"]["HGMMA"]
          > 0, "flash_attention: no tensor-core instruction in its SASS "
          f"({sass['flash_attention']})")
    check(sass["flash_attention"]["HMMA_TF32"] > 0,
          "flash_attention: no TF32 HMMA (the f32 forward) in its SASS "
          f"({sass['flash_attention']})")
    # their accumulators and scores stay in registers at every head_dim
    spills = {n: _spill_bytes(r["log"]) for n, r in report.items()}
    for n in ("flash_attention", "flash_decode"):
        check(spills[n] == 0, f"{n} spills registers: {spills}")
    log("build", seconds=round(time.perf_counter() - t0, 3),
        sources={n: {"seconds": round(r["seconds"], 3),
                     "cached": r["cached"]} for n, r in report.items()},
        fused_conv_sass=sass["fused_conv"],
        flash_attention_sass=sass["flash_attention"],
        spill_store_bytes=spills)


# -- phase 3 -----------------------------------------------------------------

def _windows(torch, kind, B, S, g):
    dev = "cuda"
    if kind == "full":
        return (torch.zeros(B, dtype=torch.int32, device=dev),
                torch.full((B,), S, dtype=torch.int32, device=dev))
    if kind == "anywhere":
        # a slot row's window: any [start, end) in the ring, one column
        # at least
        lo = torch.randint(0, S, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        span = torch.rand(B, generator=g, device=dev)
        return lo, lo + 1 + (span * (S - lo).float()).long().clamp_max(
            S - lo - 1).int()
    lo = torch.randint(0, S // 2, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    hi = torch.randint(S // 2 + 1, S + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    if kind == "edge":
        lo[0], hi[0] = max(S - 40, 0), S   # every rank but the last empty
        if B > 1:
            lo[1], hi[1] = 17, 18      # a single valid column
    return lo, hi


def _graph_ms(torch, launch, calls, stream=None):
    """Device time of one ``launch(i)`` call: ``calls`` calls captured in
    a CUDA graph (no host launch gaps), replayed, timed with events;
    median over rounds.  With ``stream``, the warm-up and the capture run
    on it: autograd runs a backward on its forward's stream, so a
    backward whose forward ran there is captured alone."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(calls):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(calls):
            launch(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (5 * calls))
    return float(np.median(times))


def _bound(B, N, H, lo, hi, kv_dtype, q_bytes, quant):
    """Least time for one call at these inputs: each byte the function
    needs read or written once (the window's K/V rows, their scales, q
    and the output) over HBM bandwidth, against QK and PV operations
    over the inputs' peak rate."""
    cols = int((hi - lo).clamp_min(0).sum().item()) * N
    elt = {"float32": 4, "bfloat16": 2, "int8": 1}[kv_dtype]
    nbytes = 2 * cols * H * elt + 2 * B * N * H * q_bytes
    if quant:
        nbytes += 2 * cols * 4
    ops = 4 * cols * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kv_dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _row_rel_err(torch, got, want):
    """Largest error of a (batch, head) row over the row's max |want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(1e-30)
    return (err / scale).max().item()


# (rows, cache length) of the one-query checks.  256 and 1024: four
# cluster ranks of 64 and 256 columns; 32: one rank; 128, the beam's B*K
# rows: two ranks; 200: four ranks of 50 columns; 512, speculative
# generate() and the speculative server at batch 8 and 1: four ranks of
# 128; 768, the slot loop's ring: four ranks of 192 columns, three chunks
# that fill the 3-stage ring
ONE_QUERY_SHAPES = ((8, 32), (8, 128), (8, 200), (8, 256), (8, 512),
                    (1, 512), (8, 768), (8, 1024))


def phase_kernels(torch, seed):
    import torch.nn.functional as F
    from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"flash_decode": 0.0, "flash_decode_quant": 0.0}
    worst_row = {"flash_decode": 0.0, "flash_decode_quant": 0.0}
    N = 12
    for B, S in ONE_QUERY_SHAPES:
        for H in (64, 128):
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt).split(".")[-1]
                q, k, v = (torch.randn(shape, generator=g, device="cuda")
                           .to(dt) for shape in ((B, N, 1, H),
                                                 (B, N, S, H),
                                                 (B, N, S, H)))
                k8, ks = quantize_kv_rows(k)
                v8, vs = quantize_kv_rows(v)
                for kind in ("full", "ragged", "edge", "anywhere"):
                    lo, hi = _windows(torch, kind, B, S, g)
                    got = fd.flash_decode(q, k, v, lo, hi)
                    want = fd.flash_decode_plain(q.float(), k.float(),
                                                 v.float(), lo, hi)
                    gotq = fd.flash_decode_quant(q, k8, v8, ks, vs, lo, hi)
                    wantq = fd.flash_decode_quant_plain(q.float(), k8, v8,
                                                        ks, vs, lo, hi)
                    same = {"flash_decode": fd.flash_decode_plain(
                                q, k, v, lo, hi),
                            "flash_decode_quant": fd.flash_decode_quant_plain(
                                q, k8, v8, ks, vs, lo, hi)}
                    # one writer per output, merged in rank order
                    again = {"flash_decode": fd.flash_decode(q, k, v, lo, hi),
                             "flash_decode_quant": fd.flash_decode_quant(
                                 q, k8, v8, ks, vs, lo, hi)}
                    torch.cuda.synchronize()
                    for kern, o, w in (("flash_decode", got, want),
                                       ("flash_decode_quant", gotq,
                                        wantq)):
                        where = f"{kern} S={S} H={H} {name} {kind}"
                        check(torch.equal(o, again[kern]),
                              f"{where}: two launches on one input differ")
                        check(o.shape == q.shape and o.dtype == dt,
                              f"{kern} returned {o.shape} {o.dtype}")
                        check(bool(torch.isfinite(o).all()),
                              f"{where}: non-finite")
                        err = (o.float() - w).abs().max().item()
                        check(err <= ATOL[name],
                              f"{where}: max abs err {err} > {ATOL[name]}")
                        worst[kern] = max(worst[kern], err)
                        if dt == torch.bfloat16:
                            rel = _row_rel_err(torch, o, same[kern])
                            check(rel <= BF16_ROW_RTOL,
                                  f"{where}: against the bf16 plain "
                                  f"version {rel} of the row's max |out| "
                                  f"> {BF16_ROW_RTOL}")
                            worst_row[kern] = max(worst_row[kern], rel)
                log("kernels", check=f"B={B} S={S} H={H} {name}",
                    windows="full,ragged,edge,anywhere",
                    repeats_bit_for_bit=True,
                    ok=True)
    log("kernels", max_abs_err=worst, atol=ATOL,
        bf16_vs_bf16_plain_max_row_rel_err=worst_row,
        bf16_row_rtol=BF16_ROW_RTOL)
    _block_checks(torch, g, worst, worst_row)

    # timing at the served shape, rotating over one cache per layer so
    # that, as in a decode step, the cache comes from HBM, not L2
    timings = {}
    B = 8
    for S in (256, 1024):
        H = 64
        lo = torch.zeros(B, dtype=torch.int32, device="cuda")
        hi = torch.full((B,), S, dtype=torch.int32, device="cuda")
        q = torch.randn(B, N, 1, H, generator=g, device="cuda").bfloat16()
        caches = [tuple(torch.randn(B, N, S, H, generator=g,
                                    device="cuda").bfloat16()
                        for _ in range(2)) for _ in range(LAYERS_CACHES)]
        quant = [quantize_kv_rows(k) + quantize_kv_rows(v)
                 for k, v in caches]
        mask = torch.zeros(B, 1, 1, S, device="cuda").bfloat16()
        mask.masked_fill_((torch.arange(S, device="cuda") >= hi[:, None])
                          .view(B, 1, 1, S), -1e30)
        deq = [(fd.dequantize_kv(k8, ks, torch.bfloat16),
                fd.dequantize_kv(v8, vs, torch.bfloat16))
               for k8, ks, v8, vs in quant]
        n = len(caches)
        t = {
            "flash_decode": _graph_ms(torch, lambda i: fd.flash_decode(
                q, *caches[i % n], lo, hi), 2 * n),
            "flash_decode_plain": _graph_ms(torch, lambda i:
                fd.flash_decode_plain(q, *caches[i % n], lo, hi), 2 * n),
            "flash_decode_library": _graph_ms(torch, lambda i:
                F.scaled_dot_product_attention(q, *caches[i % n],
                                               attn_mask=mask), 2 * n),
            "flash_decode_quant": _graph_ms(torch, lambda i:
                fd.flash_decode_quant(q, quant[i % n][0], quant[i % n][2],
                                      quant[i % n][1], quant[i % n][3],
                                      lo, hi), 2 * n),
            "flash_decode_quant_plain": _graph_ms(torch, lambda i:
                fd.flash_decode_quant_plain(q, quant[i % n][0],
                                            quant[i % n][2], quant[i % n][1],
                                            quant[i % n][3], lo, hi), 2 * n),
            # not the same function (its inputs are pre-dequantized bf16),
            # printed beside the int8 kernel for scale only
            "sdpa_over_dequantized": _graph_ms(torch, lambda i:
                F.scaled_dot_product_attention(q, *deq[i % n],
                                               attn_mask=mask), 2 * n),
        }
        b3, b3_by, b3_bytes = _bound(B, N, H, lo, hi, "bfloat16", 2, False)
        b4, b4_by, b4_bytes = _bound(B, N, H, lo, hi, "int8", 2, True)
        t.update(flash_decode_bound=b3, flash_decode_bound_by=b3_by,
                 flash_decode_bytes=b3_bytes,
                 flash_decode_quant_bound=b4,
                 flash_decode_quant_bound_by=b4_by,
                 flash_decode_quant_bytes=b4_bytes)
        log("kernels", timing=f"B={B} N={N} S={S} H={H} bf16 q, full "
            f"window, {n} caches rotated", ms=t)
        timings[S] = t
        del caches, quant, deq
    timings[SEQ_BUCKETS[-1]].update(_block_timing(torch, g))
    return worst, timings[SEQ_BUCKETS[-1]]


# the verify block of speculative decoding: gamma + 1 = 5 queries a
# (batch, head) row, query t seeing [start, pos + t + 1)
BLOCK_T = (2, 5)
# (rows, cache length): 512 is speculative generate()'s and the
# speculative server's cache at batch 8 and 1, 768 the slot loop's ring
BLOCK_SHAPES = ((8, 256), (8, 512), (1, 512), (8, 768))
SPEC_GAMMA = 4


def _block_windows(torch, kind, B, T, S, g):
    """start [B] and per-query ends [B, T] = pos + t + 1 of a verify block:
    the whole cache, ragged starts and positions, or a block at the ring's
    end whose last queries' ends pass S (a position near C - 1, as a
    0-d device position can put it)."""
    dev = "cuda"
    if kind == "full":
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        pos = torch.full((B,), S - T, dtype=torch.int32, device=dev)
    elif kind == "ragged":
        start = torch.randint(0, S // 2, (B,), generator=g, device=dev,
                              dtype=torch.int32)
        pos = start + torch.randint(0, S // 2 - T, (B,), generator=g,
                                    device=dev, dtype=torch.int32)
    else:                                       # "ring_end"
        start = torch.randint(0, S // 2, (B,), generator=g, device=dev,
                              dtype=torch.int32)
        pos = torch.full((B,), S - 2, dtype=torch.int32, device=dev)
    end = (pos[:, None] + 1 + torch.arange(T, device=dev)).int()
    return start, end.contiguous()


def _block_checks(torch, g, worst, worst_row):
    """The block form of B3 (f32, bf16) and B4 (int8 K/V, bf16 q) against
    its plain version under the one-query limits, and bit-equal to T
    one-query launches, at T in {2, 5} and each of BLOCK_SHAPES."""
    from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    N, H = 12, 64
    for B, S in BLOCK_SHAPES:
        for T in BLOCK_T:
            for kind_dt in ("float32", "bfloat16", "int8"):
                dt = torch.float32 if kind_dt == "float32" \
                    else torch.bfloat16
                q = torch.randn(B, N, T, H, generator=g, device="cuda").to(dt)
                k, v = (torch.randn(B, N, S, H, generator=g, device="cuda")
                        .to(dt) for _ in range(2))
                if kind_dt == "int8":
                    k8, ks = quantize_kv_rows(k)
                    v8, vs = quantize_kv_rows(v)
                    run = lambda qq, st, e: fd.flash_decode_quant_block(
                        qq, k8, v8, ks, vs, st, e)
                    one = lambda qq, st, e: fd.flash_decode_quant(
                        qq, k8, v8, ks, vs, st, e)
                    want = lambda st, e: fd.flash_decode_quant_plain(
                        q.float(), k8, v8, ks, vs, st, e)
                    same = lambda st, e: fd.flash_decode_quant_plain(
                        q, k8, v8, ks, vs, st, e)
                    kern, tol = "flash_decode_quant_block", ATOL["bfloat16"]
                else:
                    run = lambda qq, st, e: fd.flash_decode_block(
                        qq, k, v, st, e)
                    one = lambda qq, st, e: fd.flash_decode(qq, k, v, st, e)
                    want = lambda st, e: fd.flash_decode_plain(
                        q.float(), k.float(), v.float(), st, e)
                    same = lambda st, e: fd.flash_decode_plain(q, k, v, st,
                                                               e)
                    kern, tol = "flash_decode_block", ATOL[kind_dt]
                for kind in ("full", "ragged", "ring_end"):
                    start, end = _block_windows(torch, kind, B, T, S, g)
                    got = run(q, start, end)
                    singles = [one(q[:, :, t:t + 1].contiguous(), start,
                                   end[:, t].contiguous()) for t in range(T)]
                    torch.cuda.synchronize()
                    where = f"{kern} B={B} T={T} S={S} {kind_dt} {kind}"
                    check(got.shape == q.shape and got.dtype == dt,
                          f"{where}: returned {got.shape} {got.dtype}")
                    check(all(torch.equal(got[:, :, t:t + 1], singles[t])
                              for t in range(T)),
                          f"{where}: a query row differs from its one-query "
                          "launch")
                    err = (got.float() - want(start, end)).abs().max().item()
                    check(err <= tol, f"{where}: max abs err {err} > {tol}")
                    worst[kern] = max(worst.get(kern, 0.0), err)
                    if dt == torch.bfloat16:
                        rel = _row_rel_err(torch, got, same(start, end))
                        check(rel <= BF16_ROW_RTOL,
                              f"{where}: {rel} of the row's max |out| "
                              f"against the bf16 plain version")
                        worst_row[kern] = max(worst_row.get(kern, 0.0), rel)
            log("kernels", check=f"block B={B} T={T} S={S}",
                dtypes="float32,bfloat16,int8",
                windows="full,ragged,ring_end",
                equals_one_query_launches_bit_for_bit=True, ok=True)
    log("kernels", block_max_abs_err={k: worst[k] for k in worst
                                      if "block" in k},
        block_bf16_max_row_rel_err={k: worst_row[k] for k in worst_row
                                    if "block" in k})


def _block_bound(B, N, H, start, end, elt, q_bytes, quant, kv_dtype):
    """Least time for one block call: the K/V rows of each (batch, head)
    row's widest window read once (and their scales), q and the output
    once, against the QK and PV operations of every query's window."""
    S_cols = (end.max(1).values - start).clamp_min(0)
    cols = int(S_cols.sum().item()) * N
    T = end.shape[1]
    nbytes = 2 * cols * H * elt + 2 * B * N * T * H * q_bytes
    if quant:
        nbytes += 2 * cols * 4
    ops = 4 * H * N * int((end - start[:, None]).clamp_min(0).sum().item())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kv_dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _block_timing(torch, g):
    """The block form at the verify block of the slot loop's 8 rows:
    T = gamma + 1 = 5 queries, S = 768, H = 64, bf16 q, the block at the
    ring's middle (windows of ~380 columns), rotating 12 caches as the
    layers do; beside its plain version, SDPA with the same causal-window
    mask (the library call) and its bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    B, N, H, S, T = 8, 12, 64, 768, SPEC_GAMMA + 1
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    pos = torch.full((B,), S // 2, dtype=torch.int32, device="cuda")
    end = (pos[:, None] + 1 + torch.arange(T, device="cuda")).int()
    q = torch.randn(B, N, T, H, generator=g, device="cuda").bfloat16()
    caches = [tuple(torch.randn(B, N, S, H, generator=g,
                                device="cuda").bfloat16() for _ in range(2))
              for _ in range(LAYERS_CACHES)]
    quant = [quantize_kv_rows(k) + quantize_kv_rows(v) for k, v in caches]
    col = torch.arange(S, device="cuda")
    valid = (col >= start[:, None, None]) & (col < end[:, :, None])
    mask = torch.zeros(B, 1, T, S, device="cuda").bfloat16() \
        .masked_fill_(~valid[:, None], -1e30)
    n = len(caches)
    t = {
        "flash_decode_block": _graph_ms(torch, lambda i: fd.flash_decode_block(
            q, *caches[i % n], start, end), 2 * n),
        "flash_decode_block_plain": _graph_ms(torch, lambda i:
            fd.flash_decode_plain(q, *caches[i % n], start, end), 2 * n),
        "flash_decode_block_library": _graph_ms(torch, lambda i:
            F.scaled_dot_product_attention(q, *caches[i % n],
                                           attn_mask=mask), 2 * n),
        "flash_decode_quant_block": _graph_ms(torch, lambda i:
            fd.flash_decode_quant_block(q, quant[i % n][0], quant[i % n][2],
                                        quant[i % n][1], quant[i % n][3],
                                        start, end), 2 * n),
        "flash_decode_quant_block_plain": _graph_ms(torch, lambda i:
            fd.flash_decode_quant_plain(q, quant[i % n][0], quant[i % n][2],
                                        quant[i % n][1], quant[i % n][3],
                                        start, end), 2 * n),
    }
    b3, b3_by, _ = _block_bound(B, N, H, start, end, 2, 2, False, "bfloat16")
    b4, b4_by, _ = _block_bound(B, N, H, start, end, 1, 2, True, "int8")
    t.update(flash_decode_block_bound=b3, flash_decode_block_bound_by=b3_by,
             flash_decode_quant_block_bound=b4,
             flash_decode_quant_block_bound_by=b4_by)
    log("kernels", timing=f"block B={B} N={N} T={T} S={S} H={H} bf16 q, "
        f"windows [0, {S // 2 + 1}..{S // 2 + T}), {n} caches rotated", ms=t)
    return t


# -- phase 4 -----------------------------------------------------------------

def _gpt2(torch, seed, dtype):
    from paddle_tpu_torch.text.models import GPTConfig, GPTModel
    model = GPTModel(GPTConfig(), device="cuda", dtype=dtype)
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    return model.eval()


def _traffic(seed, vocab, n=REQUESTS, lo=16, hi=SEQ_BUCKETS[0]):
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, n)
    return [rng.randint(0, vocab, int(n)).astype(np.int32) for n in lens]


def _serve_once(torch, model, prompts, kv, grid, one_request=False,
                tag="serving", oracle_rows=None):
    """Serve ``prompts``, one request each (or all in one request), and
    hold the launch counts and the served rows, logged under ``tag``.
    Every served row must equal its prompt's batch-1 generate() (the
    serving path's GEMMs are row-invariant: cached_linear); the rows of
    one request, which form one batch, must also equal generate() of
    that batch.  ``oracle_rows``, a list, receives each prompt's batch-1
    generate() row."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    flags.set_flags({"FLAGS_kv_cache_dtype": kv})
    steps = grid["max_new_tokens"]
    srv = serving.Server()
    srv.register_decode("gpt2", model, **grid)
    # the path's run: counts read from 0 just before it
    fd.flash_decode.launches = 0
    fd.flash_decode_quant.launches = 0
    t0 = time.perf_counter()
    srv.start()
    try:
        t_ready = time.perf_counter()
        if one_request:
            futs = [srv.submit_decode("gpt2", prompts, timeout=60)]
            served = list(futs[0].result(timeout=600)[0][:, None])
        else:
            futs = [srv.submit_decode("gpt2", [p], timeout=60)
                    for p in prompts]
            served = [f.result(timeout=600)[0] for f in futs]
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {"flash_decode": fd.flash_decode.launches,
                    "flash_decode_quant": fd.flash_decode_quant.launches}
        st = srv.stats("gpt2")
        rt = srv._models["gpt2"]
        warm_runs = len(rt._warmed)
    finally:
        srv.stop()
    layers = model.config.num_layers
    want = layers * steps * (warm_runs + st["batches"])
    live = "flash_decode_quant" if kv == "int8" else "flash_decode"
    idle = "flash_decode" if kv == "int8" else "flash_decode_quant"
    check(launches[live] == want and launches[idle] == 0,
          f"kv={kv}: launches {launches}, want {live}={want} "
          f"({layers} layers x {steps} steps x ({warm_runs} warm-up + "
          f"{st['batches']} served batches)) and {idle}=0")
    check(st["completed"] == len(futs) and st["errors"] == 0,
          f"kv={kv}: stats {st}")
    tokens = int(st["tokens"])
    tok_s = round(tokens / (t_end - t_ready), 1)
    oracle = Generator(model, seq_buckets=grid["seq_buckets"],
                       max_len=grid["max_len"])
    if one_request:
        L = max(p.size for p in prompts)
        ids = np.zeros((len(prompts), L), np.int32)
        for i, p in enumerate(prompts):
            ids[i, :p.size] = p
        batch = oracle.generate(ids, lengths=[p.size for p in prompts],
                                max_new_tokens=steps).cpu().numpy()
        check(np.array_equal(np.concatenate(served), batch),
              f"kv={kv}: the served batch differs from generate() of the "
              "same batch")
    t_oracle = time.perf_counter()
    equal = 0
    for i, (p, got) in enumerate(zip(prompts, served)):
        check(got.shape == (1, steps) and got.dtype == np.int32,
              f"kv={kv}: row {i} returned {got.shape} {got.dtype}")
        check(bool((got >= 0).all() and (got < model.config.vocab_size)
                   .all()), f"kv={kv}: row {i} token out of range")
        one = oracle.generate(p[None, :], max_new_tokens=steps)
        one = one.cpu().numpy()[0]
        if oracle_rows is not None:
            oracle_rows.append(one)
        diff = np.nonzero(one != got[0])[0]
        equal += diff.size == 0
        check(diff.size == 0,
              f"kv={kv}: row {i} (prompt {p.size}) differs from batch-1 "
              f"generate() from token {diff[:1]}")
    t_oracle = time.perf_counter() - t_oracle
    out = {"kv_cache": kv, "seq_buckets": grid["seq_buckets"],
           "caches": sorted({oracle.cache_bucket(
               oracle.prefill_bucket(p.size), steps) for p in prompts}),
           "requests": len(futs), "rows": len(prompts), "tokens": tokens,
           "batches": st["batches"], "avg_batch_rows": st["avg_batch_rows"],
           "warmup_s": round(t_ready - t0, 3),
           "serve_s": round(t_end - t_ready, 3),
           "decode_tok_per_s": tok_s,
           "ttft_p50_ms": round(st["ttft_p50_ms"], 2),
           "ttft_p99_ms": round(st["ttft_p99_ms"], 2),
           "latency_p50_ms": round(st["p50_ms"], 2),
           "latency_p99_ms": round(st["p99_ms"], 2),
           "batch1_generate_ms_per_token": round(
               t_oracle / (len(prompts) * steps) * 1e3, 3),
           "launches": launches, "launches_per_batch": layers * steps,
           "rows_equal_batch1_generate": f"{equal}/{len(prompts)}"}
    if one_request:
        out["rows_equal_generate_of_their_batch"] = True
    log(tag, **out)
    return out


def _head_row_invariance(torch, model, seed):
    """Why the tied head is padded (text/models/gpt.py): one row's bf16
    logits computed alone and inside an 8-row batch, through the padded
    head the model uses and through the embedding at its own width."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(8, model.config.hidden_size, generator=g,
                    device="cuda").bfloat16()
    V = model.config.vocab_size
    diff = {}
    with torch.inference_mode():
        for name, w in (("padded", model._lm_head),
                        ("unpadded", model.wte.weight)):
            alone = F.linear(h[:1], w)[:, :V].float()
            batch = F.linear(h, w)[:1, :V].float()
            diff[name] = (alone - batch).abs().max().item()
    check(diff["padded"] == 0.0,
          f"padded LM head is not row-independent: {diff}")
    log("serving", head_row_alone_vs_in_batch_max_abs_diff=diff)


def phase_serving(torch, model, seed):
    from paddle_tpu_torch.framework import flags
    _head_row_invariance(torch, model, seed)
    prompts = _traffic(seed, model.config.vocab_size)
    snap = flags.flags_snapshot()
    try:
        served = {kv: _serve_once(torch, model, prompts, kv, GRID)
                  for kv in ("bf16", "int8")}
        # the cost of the batch-invariant GEMMs against plain F.linear
        # ones is timed by the profile phase, by the step, in turns
        for kv in ("bf16", "int8"):
            for i, (lo, hi) in enumerate(SHORT_WAVES):
                short = _traffic(seed + 2 + i, model.config.vocab_size,
                                 SHORT_REQUESTS, lo, hi)
                _serve_once(torch, model, short, kv, SHORT_GRID,
                            one_request=True)
        return served
    finally:
        flags.flags_restore(snap)


# -- phase 5 -----------------------------------------------------------------

@contextlib.contextmanager
def _plain_serving_gemms():
    """The serving path's GEMMs as plain ``F.linear`` calls, for timing
    only: rows then depend on their batch again."""
    import torch.nn.functional as F
    from paddle_tpu_torch.nn.layer import transformer
    from paddle_tpu_torch.text.models import gpt
    names = ((transformer, "cached_linears"), (transformer, "cached_linear"),
             (transformer, "cached_ffn"), (gpt, "batch_invariant_linear"))
    saved = [getattr(m, n) for m, n in names]
    plain = {"cached_linears": lambda x, *layers: tuple(m(x)
                                                        for m in layers),
             "cached_linear": lambda x, layer: layer(x),
             "cached_ffn": lambda x, l1, mid, l2: l2(mid(l1(x))),
             "batch_invariant_linear": lambda x, w, b=None: F.linear(x, w,
                                                                     b)}
    for m, n in names:
        setattr(m, n, plain[n])
    try:
        yield
    finally:
        for (m, n), f in zip(names, saved):
            setattr(m, n, f)


# decode steps under torch.profiler (of the MAX_NEW timed untraced): the
# trace's post-processing grows with its host and device records
PROFILE_STEPS = 32


def phase_profile(torch, model, seed):
    """Where a decode step's time goes: one 8-row bf16 batch, its decode
    loop timed alone, then again under torch.profiler for the device's
    busy time and the kernel time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    gen = Generator(model, seq_buckets=SEQ_BUCKETS, max_len=MAX_LEN)
    P = SEQ_BUCKETS[0]
    ids, start = gen.pack_prompts(_traffic(seed, model.config.vocab_size)
                                  [:BATCH_BUCKETS[-1]], P)
    C = gen.cache_bucket(P, MAX_NEW)

    def decode_ms(traced):
        steps = PROFILE_STEPS if traced else MAX_NEW
        cache, logits0 = gen.prefill(ids, start, C)
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            gen.decode(cache, logits0, start, P, steps)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
        return ms, prof

    step_ms, _ = decode_ms(False)
    # the cost of the batch-invariant GEMMs: the same loop with the
    # serving path's GEMMs as plain F.linear calls (the layout before
    # them), in turns (invariant, plain, plain, invariant: one round, to
    # keep the script's time); the host clock of a shared host is noisy,
    # so the minimum of each is compared
    invariant, plain = [step_ms], []
    with _plain_serving_gemms():
        plain += [decode_ms(False)[0] for _ in range(2)]
    invariant += [decode_ms(False)[0]]
    n0 = fd.flash_decode.launches
    traced_ms, prof = decode_ms(True)
    fd_launches = fd.flash_decode.launches - n0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    out = {"batch": BATCH_BUCKETS[-1], "steps": MAX_NEW,
           "traced_steps": PROFILE_STEPS, "cache": C,
           "step_ms": round(step_ms, 3),
           "step_ms_batch_invariant_gemms": [round(x, 3) for x in invariant],
           "step_ms_plain_gemms": [round(x, 3) for x in plain],
           "batch_invariant_cost_min": round(min(invariant) / min(plain)
                                             - 1, 4),
           "batch_invariant_cost_median": round(
               float(np.median(invariant) / np.median(plain)) - 1, 4),
           "step_ms_traced": round(traced_ms, 3)}
    n = PROFILE_STEPS
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy <= 0:
        out["device_busy_ms_per_step"] = "not measured (no CUDA events)"
    else:
        fd_ms = sum(e.self_device_time_total for e in kernels
                    if "decode_cluster_kernel" in e.key) / 1e3 / n
        check(fd_ms > 0 or fd_launches == 0,
              f"profile: {fd_launches} decode kernel launches, but no "
              "device time under decode_cluster_kernel")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        out.update(
            device_busy_ms_per_step=round(busy, 4),
            device_idle_share=round(1 - busy / step_ms, 4),
            kernel_launches_per_step=round(
                sum(e.count for e in kernels) / n, 2),
            flash_decode_launches_per_step=fd_launches / n,
            flash_decode_ms_per_step=round(fd_ms, 4),
            top_kernels=[{"name": e.key[:90],
                          "calls_per_step": round(e.count / n, 2),
                          "ms_per_step": round(e.self_device_time_total
                                               / 1e3 / n, 4)}
                         for e in top])
    log("profile", **out)


# -- phase 6: the slot loop (continuous batching, captured step) -------------

# the slot server: GPT-2 small, 8 slots, 64-token prefill chunks, one ring
# of 768 columns, up to 96 new tokens (the JAX package's chip
# configuration of its churn benchmark, bench.py:1170-1200)
SLOTS, CHUNK, SLOT_CACHE, SLOT_MAX_NEW = 8, 64, 768, 96
SLOT_GRID = dict(batch_buckets=(1,), seq_buckets=(128, SLOT_CACHE),
                 max_len=SLOT_CACHE, max_new_tokens=SLOT_MAX_NEW)
# in slot mode a worker thread only waits on its rows' futures, so the
# workers bound the rows in flight: two per slot, one request each
SLOT_WORKERS = 2 * SLOTS
CHURN_REQUESTS = 48
# every token a slot row serves is held against batch-1 generate()'s
# geometry (its prefill bucket, its cache, its columns), fed the row's
# own tokens: the token must be the oracle's argmax or lie within this
# share of the oracle's largest |logit| of its top logit (a near tie).
# The chunked prefill and the 768-column ring put a row at other shapes
# and columns than generate() does, so its bf16 logits move by a rounding
# step, and with random weights a step flips a tie in about a quarter of
# the 48 rows (on an H100 at --seed 0: 12 rows, gaps 0 to 0.013 of
# max|logit|)
SLOT_TIE_RTOL = BF16_ROW_RTOL
# and near ties may make at most this share of the tokens a pass checks:
# twice the most seen on an H100 at --seed 0 (churn: 27 of 1321 tokens in
# bf16, 14 in int8; the shared-prefix pass: 4 of 96, prefix cache on and
# off), so that an error which moves logits by less than the band still
# fails by the number of tokens it flips
SLOT_TIE_SHARE = {"churn": 0.04, "prefix": 0.085}
# the shared-prefix pass (bench.py:1322-1323): 6 requests, a 256-token
# prefix and a 48-token suffix each
PREFIX_LEN, SUFFIX_LEN, PREFIX_REQUESTS, PREFIX_MAX_NEW = 256, 48, 6, 16


def _churn(seed, vocab, n=CHURN_REQUESTS):
    """The churn trace: every 5th prompt 96-127 tokens, the others 8-23;
    every 4th request wants 96 new tokens, the others 2-7."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        lp = int(rng.randint(96, 128)) if k % 5 == 0 \
            else int(rng.randint(8, 24))
        mn = SLOT_MAX_NEW if k % 4 == 1 else int(rng.randint(2, 8))
        out.append((rng.randint(1, vocab, lp).astype(np.int32), mn))
    return out


def _check_rows(torch, model, oracle, reqs, served, where, tie_share):
    """Hold every served token against batch-1 generate() fed the row's
    own tokens (teacher forcing at generate()'s prefill bucket and
    cache): each is the oracle's argmax, or within SLOT_TIE_RTOL of the
    oracle's max |logit| below its top logit, and such near ties make at
    most ``tie_share`` of the tokens.  Returns the rows equal to their
    batch-1 generate() and the near ties taken (row, token, gap
    share)."""
    ties, equal = [], 0
    for i, ((p, mn), got) in enumerate(zip(reqs, served)):
        check(got.shape == (mn,), f"{where}: row {i} shape {got.shape}")
        P = oracle.prefill_bucket(p.size)
        ids, start = oracle.pack_prompts([p], P)
        cache, logits = oracle.prefill(ids, start, oracle.cache_bucket(P,
                                                                       mn))
        start = torch.as_tensor(start, device="cuda")
        fed = torch.as_tensor(got, device="cuda").reshape(mn, 1, 1)
        rows = []
        with torch.inference_mode():
            for t in range(mn):
                lg = logits[0]
                rows.append(torch.stack([lg.max(), lg[fed[t, 0, 0]],
                                         lg.abs().max(),
                                         lg.argmax().float()]))
                if t + 1 < mn:
                    nl, cache = model.forward_cached(fed[t], cache, P + t,
                                                     start)
                    logits = nl[:, 0].float()
        stats = torch.stack(rows).cpu().numpy()
        row_ties = 0
        for t, (top, mine, scale, arg) in enumerate(stats):
            if int(arg) == int(got[t]):
                continue
            gap = float(top - mine)
            check(gap <= SLOT_TIE_RTOL * scale,
                  f"{where}: row {i} (prompt {p.size}) token {t} = "
                  f"{int(got[t])} lies {gap} below the oracle's top logit "
                  f"(token {int(arg)}), more than 2^-6 x {scale}")
            ties.append((i, t, gap / float(scale)))
            row_ties += 1
        equal += row_ties == 0
    tokens = sum(mn for _, mn in reqs)
    check(len(ties) <= tie_share * tokens,
          f"{where}: {len(ties)} near-tie tokens of {tokens}, more than "
          f"{tie_share} of them: {_tie_summary(ties)}")
    return equal, ties


def _tie_summary(ties):
    """The near ties _check_rows took: how many, in which rows, and the
    largest gap as a share of the oracle's max |logit|."""
    return {"near_tie_tokens": len(ties),
            "near_tie_rows": sorted({i for i, _, _ in ties}),
            "near_tie_max_gap_share": round(max((g for _, _, g in ties),
                                                default=0.0), 5)}


def _slot_server(torch, model, kv, prefix=False, draft=None):
    """The slot server; with ``draft``, speculative (FLAGS_spec_decode,
    gamma = SPEC_GAMMA)."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework import flags
    flags.set_flags({"FLAGS_kv_cache_dtype": kv, "FLAGS_decode_slots": SLOTS,
                     "FLAGS_prefill_chunk": CHUNK,
                     "FLAGS_prefix_cache": prefix,
                     "FLAGS_spec_decode": draft is not None})
    srv = serving.Server(serving.ServingConfig(workers=SLOT_WORKERS))
    srv.register_decode("gpt2", model, draft_layer=draft, gamma=SPEC_GAMMA,
                        **SLOT_GRID)
    srv.start()
    flags.set_flags({"FLAGS_decode_slots": 0, "FLAGS_prefix_cache": False,
                     "FLAGS_spec_decode": False})
    return srv


def _serve_churn(torch, srv, reqs):
    """Submit the whole trace at once; served rows, seconds, stats."""
    t0 = time.perf_counter()
    futs = [srv.submit_decode("gpt2", [p], max_new_tokens=mn, timeout=60)
            for p, mn in reqs]
    served = [f.result(timeout=600)[0][0] for f in futs]
    dt = time.perf_counter() - t0
    st = srv.stats("gpt2")
    tokens = sum(mn for _, mn in reqs)
    return served, {"serve_s": round(dt, 3),
                    "tok_per_s": round(tokens / dt, 1), "stats": st}


def _step_state(S, C, seed):
    """Host vectors of a full slot step: every row active at columns
    [start, pos]."""
    rng = np.random.RandomState(seed)
    pos = C - 40
    return (rng.randint(0, pos - 200, S).astype(np.int32),
            np.zeros(S, bool), np.ones(S, bool), pos)


def _step_compare(torch, gen, kv, steps=5):
    """Rule (ii): the captured step against the same step run eagerly,
    from one state, at the slot cache: planes, logits, tokens, finished
    bit-equal; the host rewrites the per-row vectors between steps."""
    from paddle_tpu_torch.text.graphs import SlotStep
    cap = gen.step_exec(SLOTS, SLOT_CACHE)
    eager = SlotStep(gen, SLOTS, SLOT_CACHE, -1)
    check(cap.captured, "slots: step_exec on CUDA returned an uncaptured "
          "step")
    g = torch.Generator(device="cuda").manual_seed(SLOT_CACHE)
    with torch.inference_mode():
        for c in cap.cache:
            for p in c:
                if p.dtype == torch.int8:
                    p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                          device="cuda"))
                elif p.shape[-1] == 1:
                    p.copy_(torch.rand(p.shape, generator=g, device="cuda")
                            * 0.02 + 1e-3)
                else:
                    p.copy_(torch.randn(p.shape, generator=g, device="cuda"))
        cap.logits.copy_(torch.randn(cap.logits.shape, generator=g,
                                     device="cuda"))
    eager.load_state(cap)
    start, fin, active, pos = _step_state(SLOTS, SLOT_CACHE, 1)
    rng = np.random.RandomState(2)
    fc = fe = fin
    for i in range(steps):
        active = rng.rand(SLOTS) < 0.8
        start = rng.randint(0, pos + i - 100, SLOTS).astype(np.int32)
        fc, tc = cap(start, fc, active, pos + i)
        fe, te = eager(start, fe, active, pos + i)
        same = (np.array_equal(tc, te) and np.array_equal(fc, fe)
                and torch.equal(cap.logits, eager.logits)
                and all(torch.equal(x, y) for a, b in zip(cap.cache,
                                                          eager.cache)
                        for x, y in zip(a, b)))
        check(same, f"slots kv={kv}: the captured step differs from the "
              f"eager step at step {i}")
    return cap, eager


def _plain_run(step):
    """One full slot step a call, at positions cycling over 8 columns."""
    start, fin, active, pos = _step_state(step.S, step.C, 3)
    return lambda i: step(start, fin, active, pos + (i % 8))


def _chrome_events(prof):
    """A trace's events from its Chrome export: the record that carries
    each kernel's grid and correlation id."""
    path = os.path.join(ROOT, "build", f"trace_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _records_by_launch(events, match):
    """Kernel records whose name holds ``match``, for each graph launch
    of a trace in launch order, by grid x: every kernel that a
    cudaGraphLaunch ran carries that call's correlation id."""
    launches = [e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and e.get("name", "").startswith("cudaGraphLaunch")]
    per = {c: {} for c in launches}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") == "kernel" and c in per \
                and match in e.get("name", ""):
            gx = e["args"]["grid"][0]
            per[c][gx] = per[c].get(gx, 0) + 1
    return [per[c] for c in launches]


def _traced_replays(per, nodes, calls, what):
    """A trace of ``calls`` replays of one graph held against the graph's
    own kernel nodes ``nodes`` (by grid x, from ``_graph_nodes``): one
    graph launch a replay, no launch showing a record the graph does not
    hold, and at least one launch showing all of them.  The launch counts
    themselves come from the graph: CUPTI drops kernel records on an
    H100 (the first replay of a slot-step trace showed 185-189 of its 196
    kernel records in three traces out of three, and a trace of 20
    replays held 638 of 640 decode records), so a trace is not a count.
    Returns the launches that showed every node."""
    over = [d for d in per if any(n > nodes.get(gx, 0)
                                  for gx, n in d.items())]
    whole = sum(d == nodes for d in per)
    check(len(per) == calls and not over and whole > 0,
          f"{what}: {len(per)} graph launches traced for {calls} replays, "
          f"{whole} with the graph's nodes {nodes}, records by launch "
          f"{per}")
    return whole


def _decode_grids(events):
    """Launches of B3/B4 (one template, decode_cluster_kernel) in a trace,
    by the grid's x extent, rows x queries a row (B*N*tq)."""
    grids = {}
    for e in events:
        if e.get("cat") == "kernel" \
                and "decode_cluster_kernel" in e.get("name", ""):
            gx = e["args"]["grid"][0]
            grids[gx] = grids.get(gx, 0) + 1
    return grids


def _graph_nodes(graph, match):
    """The kernel nodes of a captured graph whose name holds ``match``, by
    grid x, and all its kernel nodes [(name, grid x)], read back from the graph
    (``profiler.cuda_graph``): a replay runs each node once, so these are
    the launches of every replay.  A graph with a child-graph or
    conditional node fails the run."""
    from paddle_tpu_torch.profiler.cuda_graph import graph_kernel_nodes
    try:
        kernels = graph_kernel_nodes(graph)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e
    grids = {}
    for name, gx in kernels:
        if match in name:
            grids[gx] = grids.get(gx, 0) + 1
    return grids, kernels


def _step_profile(torch, run, calls=20, per_trace=None, ms_of=None):
    """Host ms per ``run(i)`` call (no profiler), then device busy ms,
    kernels and decode-kernel records per call under torch.profiler
    (and, for each ``name: regex`` of ``ms_of``, the device ms a call of
    the kernels whose name matches, as ``name``), in
    traces of ``per_trace`` calls each (default: one trace), with the
    decode records by grid (``_decode_grids``) and, for a captured step,
    by graph launch (``_records_by_launch``, held against the graph's
    nodes by ``_traced_replays``).  A trace of ~27,000 kernels (20 int8
    speculative steps) lost records on an H100 where traces of under
    ~15,000 did not, so longer steps are traced in several windows.  A
    trace is not a launch count (``_traced_replays``); a trace with no
    device time fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        run(i)
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    per_trace = per_trace or calls
    count, dev_us, grids, per_launch = {}, {}, {}, []
    for w in range(0, calls, per_trace):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(w, min(calls, w + per_trace)):
                run(i)
            torch.cuda.synchronize()
        events = _chrome_events(prof)
        per_launch += _records_by_launch(events, "decode_cluster_kernel")
        for gx, n in _decode_grids(events).items():
            grids[gx] = grids.get(gx, 0) + n
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                count[e.key] = count.get(e.key, 0) + e.count
                dev_us[e.key] = dev_us.get(e.key, 0.0) + \
                    e.self_device_time_total
    busy = sum(dev_us.values()) / 1e3 / calls
    check(busy > 0, f"torch.profiler recorded no device time over {calls} "
          "slot steps")
    # B3 and B4 are one template, decode_cluster_kernel
    fd_keys = [k for k in count if "decode_cluster_kernel" in k]
    return {"host_ms": round(host_ms, 4), "device_ms": round(busy, 4),
            "idle_share": round(max(0.0, 1 - busy / host_ms), 4),
            "kernels_per_step": round(sum(count.values()) / calls, 2),
            "decode_kernel_records": sum(count[k] for k in fd_keys),
            "decode_records_by_grid_x": grids,
            "decode_kernel_ms": round(sum(dev_us[k] for k in fd_keys)
                                      / 1e3, 4),
            "traces": -(-calls // per_trace),
            # popped by the caller (empty for eager steps)
            "decode_by_launch": per_launch,
            "top_kernels": [{"name": k[:70],
                             "calls_per_step": round(count[k] / calls, 2),
                             "ms_per_step": round(dev_us[k] / 1e3 / calls,
                                                  4)}
                            for k in sorted(dev_us, key=lambda k:
                                            -dev_us[k])[:6]],
            **{name: round(sum(us for k, us in dev_us.items()
                               if re.search(rx, k)) / 1e3 / calls, 4)
               for name, rx in (ms_of or {}).items()}}


def phase_slots(torch, model, seed):
    """Continuous-batching decode through the slot loop, bf16 then int8
    KV: the churn trace served (rows against batch-1 generate(), no step
    built after warm-up, every step a replay of the captured graph); that
    graph holds 12 decode kernel nodes, so the churn launched 12 x steps,
    and 20 of its replays traced show them run; the captured step against
    the eager one; the shared-prefix pass."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    layers = model.config.num_layers
    reqs = _churn(seed + 7, model.config.vocab_size)
    oracle = Generator(model, seq_buckets=(128, 256, 512, SLOT_CACHE),
                       max_len=SLOT_CACHE)
    snap = flags.flags_snapshot()
    out = {}
    try:
        for kv in ("bf16", "int8"):
            srv = _slot_server(torch, model, kv)
            try:
                rt = srv._models["gpt2"]
                step = rt._loop._step
                check(step.captured, f"slots kv={kv}: the loop's step is "
                      "not the captured graph")
                built = dict(rt.gen.counters)
                # the path's run: counts read from 0 just before it.  A
                # replay runs no wrapper, so the wrappers count nothing:
                # every step of the run was a replay, no eager launch
                fd.launch_counts(reset=True)
                r0 = step.replays
                served, run = _serve_churn(torch, srv, reqs)
                counts = fd.launch_counts()
                sl = run["stats"]["slot_loop"]
                check(step.replays - r0 == sl["steps"] > 0
                      and sum(counts.values()) == 0,
                      f"slots kv={kv}: {step.replays - r0} replays for "
                      f"{sl['steps']} steps, wrapper launches {counts}")
                check(sl["joined"] == sl["retired"] == len(reqs),
                      f"slots kv={kv}: {sl}")
                check(dict(rt.gen.counters) == built,
                      f"slots kv={kv}: steps built after warm-up: "
                      f"{built} -> {rt.gen.counters}")
                # (iv) the graph the churn replayed holds 12 one-query
                # decode kernel nodes (B3, or B4 under int8), grids of
                # SLOTS x heads rows, and a replay runs each once; 20
                # replays traced show them run
                heads = model.config.num_heads
                nodes, graph_kernels = _graph_nodes(step._graph,
                                                    "decode_cluster_kernel")
                n_kernels = len(graph_kernels)
                check(nodes == {SLOTS * heads: layers},
                      f"slots kv={kv}: graph decode nodes {nodes} of "
                      f"{n_kernels} kernel nodes")
                per_replay = sum(nodes.values())
                prof = _step_profile(torch, _plain_run(step))
                whole = _traced_replays(prof.pop("decode_by_launch"), nodes,
                                        20, f"slots kv={kv}")
                check(prof["decode_kernel_ms"] > 0,
                      f"slots kv={kv}: traced replays {prof}")
            finally:
                srv.stop()
            equal, ties = _check_rows(torch, model, oracle, reqs,
                                      served, f"slots kv={kv}",
                                      SLOT_TIE_SHARE["churn"])
            cap, eager = _step_compare(torch, rt.gen, kv)
            eager_prof = _step_profile(torch, _plain_run(eager))
            eager_prof.pop("decode_by_launch")
            out[kv] = {"steps": sl["steps"], "steps_replayed": sl["steps"],
                       "wrapper_launches": sum(counts.values()),
                       "decode_kernels_per_replay": per_replay,
                       "decode_kernel_launches": per_replay * sl["steps"],
                       "graph_kernel_nodes": n_kernels,
                       "traced_replays_whole": whole,
                       "chunks": sl["chunks"], "tok_per_s": run["tok_per_s"],
                       "ttft_p50_ms": sl["ttft_p50_ms"],
                       "ttft_p99_ms": sl["ttft_p99_ms"],
                       "occupancy_mean": round(
                           sl["emitted_tokens"] / (SLOTS * sl["steps"]), 4),
                       "rows_equal_batch1_generate":
                           f"{equal}/{len(reqs)}",
                       "tokens_checked": sum(mn for _, mn in reqs),
                       **_tie_summary(ties),
                       "near_tie_share_cap": SLOT_TIE_SHARE["churn"],
                       "captured_step": prof, "eager_step": eager_prof,
                       "captured_equals_eager": True}
            log("slots", kv_cache=kv, requests=len(reqs), slots=SLOTS,
                chunk=CHUNK, cache=SLOT_CACHE, **out[kv])
            del cap, eager, rt, srv, step
        # (v) the shared-prefix pass, prefix cache on and off
        rng = np.random.RandomState(seed + 11)
        prefix = rng.randint(1, model.config.vocab_size, PREFIX_LEN)
        prompts = [np.concatenate([prefix, rng.randint(
            1, model.config.vocab_size, SUFFIX_LEN)]).astype(np.int32)
            for _ in range(PREFIX_REQUESTS + 1)]
        preqs = [(p, PREFIX_MAX_NEW) for p in prompts[1:]]
        pout = {}
        for on in (True, False):
            srv = _slot_server(torch, model, "bf16", prefix=on)
            try:
                loop = srv._models["gpt2"]._loop
                srv.run_decode("gpt2", [prompts[0]],
                               max_new_tokens=PREFIX_MAX_NEW)   # publishes
                loop.reset_stats()
                served = [srv.run_decode("gpt2", [p], max_new_tokens=mn)
                          [0][0] for p, mn in preqs]
                sl = loop.stats()
            finally:
                srv.stop()
            equal, ties = _check_rows(
                torch, model, oracle, preqs, served,
                f"prefix cache {'on' if on else 'off'}",
                SLOT_TIE_SHARE["prefix"])
            pout["on" if on else "off"] = {
                "prefix_hit_tokens": sl["prefix_hit_tokens"],
                "ttft_p50_ms": sl["ttft_p50_ms"],
                "ttft_p99_ms": sl["ttft_p99_ms"], "chunks": sl["chunks"],
                "rows_equal_batch1_generate":
                    f"{equal}/{len(preqs)}",
                "tokens_checked": sum(mn for _, mn in preqs),
                **_tie_summary(ties),
                "near_tie_share_cap": SLOT_TIE_SHARE["prefix"]}
        check(pout["on"]["prefix_hit_tokens"] > 0
              and pout["off"]["prefix_hit_tokens"] == 0,
              f"prefix cache: hit tokens {pout}")
        log("slots", shared_prefix=PREFIX_LEN, suffix=SUFFIX_LEN,
            requests=PREFIX_REQUESTS, **pout)
        out["prefix"] = pout
    finally:
        flags.flags_restore(snap)
    return out


# -- phase 6a: parked sessions and the prefill -> decode KV handoff ----------

# multi-turn chat on the slots phase's server (8 slots, chunk 64, one
# 768-column ring): 16 seeded conversations of 3 turns, turn 1 of 96-127
# tokens, each later turn 16-48 new tokens, each reply 16-32 tokens (the
# session settings of bench.py:1290-1430 bench_prefix_cache)
CHAT = dict(conversations=16, turns=3, first=(96, 128), more=(16, 49),
            reply=(16, 33))
# the first 8 conversations again through the speculative slot server
SPEC_CONVERSATIONS = 8
# drain: 8 session requests of 96 new tokens, parked mid-generation.  The
# 8 are admitted together, in conversation order, and parked after the
# step at which the last row to start has emitted _drain_park_tokens(seed)
# tokens, so every run parks each row at the same count
DRAIN_REQUESTS, DRAIN_NEW = 8, 96


def _drain_park_tokens(seed):
    return int(np.random.RandomState(seed + 29).randint(4, 33))
# parked capacity (bench.py:1394-1427): conversations of 2.5 chunks (160
# tokens) and 2 new tokens each, all parked into one store.  Cut from
# bench.py's 1000 to 256 (still >= 3 x 8 slots, as its claim needs): on
# an H100 1000 took 43 s (23 parks a second, three eager 64-token
# chunks a conversation), the whole phase's budget
PARK_SESSIONS, PARK_PROMPT, PARK_NEW = 256, 2 * CHUNK + CHUNK // 2, 2
# the handoff: the serving phase's first 8 requests, at its buckets
HANDOFF_REQUESTS = 8
HANDOFF_GRID = dict(GRID, batch_buckets=(HANDOFF_REQUESTS,))


def _chat_plan(seed, vocab):
    """Each conversation's turns: the turn's new tokens and its reply
    length."""
    rng = np.random.RandomState(seed)
    plan = []
    for _ in range(CHAT["conversations"]):
        turns = []
        for t in range(CHAT["turns"]):
            lo, hi = CHAT["first"] if t == 0 else CHAT["more"]
            turns.append((rng.randint(1, vocab, int(rng.randint(lo, hi)))
                          .astype(np.int32),
                          int(rng.randint(*CHAT["reply"]))))
        plan.append(turns)
    return plan


def _chat(srv, plan, turns, trans=None, after_turn=None):
    """Serve the conversations turn by turn through
    ``submit_decode(session_id=)``: every conversation's turn t is
    submitted (all at once) and answered before turn t + 1 starts; a
    turn's prompt is the transcript so far plus the turn's new tokens.
    Returns the (prompt, max_new) and tokens of every turn served, and the
    transcripts."""
    trans = list(trans) if trans is not None \
        else [np.zeros(0, np.int32)] * len(plan)
    reqs, served = [], []
    for t in turns:
        prompts = [np.concatenate([trans[c], plan[c][t][0]])
                   for c in range(len(plan))]
        futs = [srv.submit_decode("gpt2", [p], max_new_tokens=plan[c][t][1],
                                  timeout=60, session_id=f"conv-{c}")
                for c, p in enumerate(prompts)]
        for c, (p, f) in enumerate(zip(prompts, futs)):
            got = f.result(timeout=600)[0][0]
            reqs.append((p, plan[c][t][1]))
            served.append(got)
            trans[c] = np.concatenate([p, got]).astype(np.int32)
        if after_turn is not None:
            after_turn(t)
    return reqs, served, trans


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same_bits(torch, a, b):
    """Two plane trees hold the same dtypes, shapes and bytes."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.cpu().contiguous().view(-1).view(torch.uint8),
                        y.cpu().contiguous().view(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _row_bytes(torch, planes, lo, hi, row=0):
    """Columns [lo, hi) of one row of every plane of a tree, as one CPU
    byte vector (one device-to-host copy for the card's planes)."""
    parts = [p[row:row + 1, :, lo:hi].contiguous().view(-1)
             .view(torch.uint8) for p in _leaves(planes)]
    return torch.cat(parts).cpu()


def _watch_restores(torch, loop):
    """Hold every session restore of ``loop`` to its snapshot: once a
    row's last restore block is pushed (before any chunk or step writes
    the row again), the bytes of the restored window of every plane, read
    back in one copy, equal the snapshot's columns.  Runs in the loop's
    driver thread; returns the tally {checked, bad}."""
    tally = {"checked": 0, "bad": []}
    push = loop._push_restores

    def watched(i, slot):
        pending = bool(slot.restore)
        push(i, slot)
        req = slot.req
        if not pending or slot.restore or req.planes_len < loop.T:
            return
        lc = req.planes_len
        hi = lc if lc % loop.T and lc == req.prompt.size \
            else lc // loop.T * loop.T
        with torch.inference_mode():
            got = _row_bytes(torch, loop._cache, slot.start,
                             slot.start + hi, row=i)
            want = _row_bytes(torch, req.planes, 0, hi)
        tally["checked"] += 1
        if not torch.equal(got, want):
            tally["bad"].append((req.session_id, lc, hi))

    loop._push_restores = watched
    return tally


def _session_server(torch, model, kv, store, spill="", draft=None):
    """The slot server with FLAGS_session_store on or off (spill: a
    write-through spill directory)."""
    from paddle_tpu_torch.framework import flags
    flags.set_flags({"FLAGS_session_store": store,
                     "FLAGS_session_store_dir": spill,
                     "FLAGS_session_park_after_ms": 0})
    try:
        return _slot_server(torch, model, kv, draft=draft)
    finally:
        flags.set_flags({"FLAGS_session_store": False,
                         "FLAGS_session_store_dir": ""})


def _decode_nodes(model, step, draft=None):
    """The captured step's decode kernel nodes, read from its graph: 12
    one-query nodes a plain replay; draft layers x (gamma + 1) one-query
    and 12 block (verify) nodes a speculative one, told apart by grid."""
    layers, heads = model.config.num_layers, model.config.num_heads
    nodes, kernels = _graph_nodes(step._graph, "decode_cluster_kernel")
    if draft is None:
        ok = nodes == {SLOTS * heads: layers}
    else:
        dn = draft.config.num_layers * (SPEC_GAMMA + 1)
        ok = nodes == {SLOTS * draft.config.num_heads: dn,
                       SLOTS * heads * (SPEC_GAMMA + 1): layers}
    check(ok, f"sessions: graph decode nodes {nodes} of {len(kernels)} "
          "kernel nodes")
    return nodes


def _check_turns(torch, model, oracle, reqs, served, where, tie_share,
                 hold=True):
    """``_check_rows``' rule over many rows at once: the rows of one
    generate() geometry (prefill bucket P, cache bucket C) are teacher-
    forced together, 8 a batch (the serving phase's batch bucket, where
    every served row equals its batch-1 generate(): forward_cached is
    row-invariant), each fed its own served tokens.  Every token is the
    oracle's argmax or within SLOT_TIE_RTOL of the oracle's max |logit|
    below its top logit, and such near ties make at most ``tie_share``
    of the tokens (``_tie_rule``; with ``hold=False`` nothing is held).
    Returns the rows without a near tie and the ties."""
    groups = {}
    for i, (p, mn) in enumerate(reqs):
        check(served[i].shape == (mn,),
              f"{where}: row {i} shape {served[i].shape}")
        P = oracle.prefill_bucket(p.size)
        groups.setdefault((P, oracle.cache_bucket(P, mn)), []).append(i)
    stats = {}
    for (P, C), rows in groups.items():
        for b in range(0, len(rows), 8):
            part = rows[b:b + 8]
            ids, start = oracle.pack_prompts([reqs[i][0] for i in part], P)
            cache, logits = oracle.prefill(ids, start, C)
            T = max(reqs[i][1] for i in part)
            fed = np.zeros((len(part), T), np.int64)
            for j, i in enumerate(part):
                fed[j, :reqs[i][1]] = served[i]
            fed = torch.as_tensor(fed, device="cuda")
            start = torch.as_tensor(start, device="cuda")
            per = []
            with torch.inference_mode():
                for t in range(T):
                    lg = logits
                    per.append(torch.stack(
                        [lg.max(-1).values, lg.gather(1, fed[:, t:t + 1])[:, 0],
                         lg.abs().max(-1).values, lg.argmax(-1).float()], 1))
                    if t + 1 < T:
                        nl, cache = model.forward_cached(
                            fed[:, t:t + 1].int(), cache, P + t, start)
                        logits = nl[:, 0].float()
            per = torch.stack(per, 1).cpu().numpy()
            for j, i in enumerate(part):
                stats[i] = per[j]
    return _tie_rule(stats, dict(enumerate(served)), where, tie_share, hold)


def _tie_rule(stats, served, where, tie_share, hold=True):
    """Every token ``t`` of each row ``served[i]`` is the argmax of its
    oracle (``stats[i][t]``: top logit, the served token's logit, max
    |logit|, argmax) or within SLOT_TIE_RTOL of the max |logit| below the
    top, and such near ties make at most ``tie_share`` of the tokens
    (``hold=False``: nothing is held, the gaps are only returned).
    Returns the rows without a near tie and the ties (row, token, gap
    share)."""
    ties, equal, tokens = [], 0, 0
    for i, toks in served.items():
        row_ties = 0
        for t, (top, mine, scale, arg) in enumerate(stats[i][:len(toks)]):
            tokens += 1
            if int(arg) == int(toks[t]):
                continue
            gap = float(top - mine)
            check(not hold or gap <= SLOT_TIE_RTOL * scale,
                  f"{where}: row {i} token {t} = {int(toks[t])} lies {gap} "
                  f"below the oracle's top logit (token {int(arg)}), more "
                  f"than 2^-6 x {scale}")
            ties.append((i, t, gap / float(scale)))
            row_ties += 1
        equal += row_ties == 0
    check(not hold or len(ties) <= tie_share * tokens,
          f"{where}: {len(ties)} near-tie tokens of {tokens}, more than "
          f"{tie_share} of them: {_tie_summary(ties)}")
    return equal, ties


def _chat_run(torch, model, plan, kv, store, draft=None):
    """One chat run through the slot server (store on or off): every step
    a replay of the captured step and no wrapper launch, no step built
    after warm-up, the graph's decode nodes, parks and restores counted
    (3 and 2 a conversation with the store), every restore's pull equal
    to its snapshot; TTFT of turns 2-3 (the loop's TTFT window starts
    afresh after turn 1)."""
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.profiler.metrics import LatencyWindow
    srv = _session_server(torch, model, kv, store, draft=draft)
    try:
        rt = srv._models["gpt2"]
        loop, step = rt._loop, rt._loop._step
        check(step.captured, "sessions: the loop's step is not captured")
        built = dict(rt.gen.counters)
        watch = _watch_restores(torch, loop)
        first = {}

        def after_turn(t):
            # turns 2-3's TTFT: a fresh window once turn 1 is answered
            if t == 0:
                first.update(loop.counters)
                with loop._cond:
                    loop._ttft = LatencyWindow(maxlen=512)

        fd.launch_counts(reset=True)
        r0 = step.replays
        t0 = time.perf_counter()
        reqs, served, _ = _chat(srv, plan, range(CHAT["turns"]),
                                after_turn=after_turn)
        secs = time.perf_counter() - t0
        counts = fd.launch_counts()
        sl = loop.stats()
        sig = srv.signals()
        steps, parked = sl["steps"], sl["parked"]
        n = len(plan)
        where = f"sessions kv={kv} store={'on' if store else 'off'}" \
            + (" spec" if draft is not None else "")
        check(step.replays - r0 == steps > 0 and sum(counts.values()) == 0,
              f"{where}: {step.replays - r0} replays for {steps} steps, "
              f"wrapper launches {counts}")
        check(dict(rt.gen.counters) == built,
              f"{where}: steps built after warm-up: {built} -> "
              f"{rt.gen.counters}")
        want = (3 * n, 2 * n) if store else (0, 0)
        check((parked, sl["restored"]) == want
              and watch["checked"] == sl["restored"] and not watch["bad"],
              f"{where}: parked {parked}, restored {sl['restored']} (want "
              f"{want}), restore pulls checked {watch['checked']}, "
              f"unequal {watch['bad']}")
        nodes = _decode_nodes(model, step, draft)
        verify = model.config.num_layers if draft is not None else 0
        out = {"parked": parked, "restored": sl["restored"],
               "restore_pushes": sl["restore_pushes"],
               "restore_pulls_exact": watch["checked"],
               "chunks_turn_1": first["chunks"],
               "chunks_turns_2_3": sl["chunks"] - first["chunks"],
               "steps": steps,
               "replays": steps, "wrapper_launches": 0,
               "decode_kernels_per_replay": sum(nodes.values()),
               "nodes_by_grid_x": nodes,
               # one-query launches (B3/B4) and block launches (the verify)
               "one_query_launches": steps * (sum(nodes.values()) - verify),
               "block_launches": steps * verify,
               "serve_s": round(secs, 3),
               "ttft_turns_2_3_p50_ms": sl["ttft_p50_ms"],
               "ttft_turns_2_3_p99_ms": sl["ttft_p99_ms"],
               "sessions_parked": sig.get("sessions_parked", 0),
               "session_store_bytes": sig.get("session_store_bytes", 0)}
    finally:
        srv.stop()
    return reqs, served, out


def _admit_together(loop, sids):
    """Hold the loop's admissions until every request of ``sids`` is
    pending, then admit them in ``sids``' order: the server's workers
    submit in whatever order they run, and the schedule (chunks, columns,
    activations) follows the admission order.  Returns the list that
    records (session id, start, activation, parked columns) of every
    session restore the loop installs."""
    admit, install = loop._admit, loop._install_session
    rank, held, placed = {sid: k for k, sid in enumerate(sids)}, [True], []

    def admit_together():
        if held[0]:
            if sum(r.session_id in rank for r in loop._pending) < len(sids):
                loop._cond.wait(0.002)       # called with _cond held
                return
            loop._pending = type(loop._pending)(sorted(
                loop._pending, key=lambda r: rank.get(r.session_id, -1)))
            held[0] = False
        admit()

    def install_recorded(slot, head):
        install(slot, head)
        placed.append((head.session_id, slot.start, slot.act,
                       head.planes_len))

    loop._admit = admit_together
    loop._install_session = install_recorded
    return placed


def _held_for_drain(loop, rows, tokens):
    """Hold the slot loop's thread, once ``rows`` rows generate and the one
    that started last has emitted ``tokens`` tokens, until a park request
    arrives, so that a drain lands mid-generation at the same tokens in
    every run.  Returns the event set when the hold begins."""
    step, ready = loop._decode_step, threading.Event()

    def held():
        step()
        gen = [len(s.emitted) for s in loop._slots if s.state == 2]
        if not ready.is_set() and len(gen) == rows and min(gen) >= tokens:
            ready.set()
            t0 = time.perf_counter()
            while loop._park_req is None and time.perf_counter() - t0 < 60:
                time.sleep(0.001)

    loop._decode_step = held
    return ready


def _geometry_oracle(torch, model, oracle, snaps, placed, served):
    """Each resumed row replayed at batch 1 at the columns it was served
    at: the snapshot's planes pushed into a fresh 768-column ring at the
    row's window [start, start + parked columns), the snapshot's logits
    first, then the served tokens fed one at a time at the row's
    positions.  Rows are independent in forward_cached and its GEMMs are
    row-invariant, so where the restore adds no error this oracle rounds
    as the served step did.  Returns, per row, the oracle's (top, served
    token's logit, max |logit|, argmax) of every resumed token."""
    from paddle_tpu_torch.text.generation import Generator
    ids, st = oracle.pack_prompts([np.ones(1, np.int32)], 128)
    stats = {}
    with torch.inference_mode():
        for sid, start, act, lc in placed:
            c = int(sid.split("-")[1])
            snap = snaps[c]
            check(act == start + lc and lc == len(snap.tokens),
                  f"sessions drain: {sid} resumed at start {start}, "
                  f"activation {act}, {lc} parked columns")
            cache, _ = oracle.prefill(ids, st, SLOT_CACHE)
            Generator.push_block(cache, snap.planes, 0, start)
            logits = snap.logits.to("cuda", torch.float32)[None]
            fed = served[c][len(snap.emitted):]
            begin = torch.as_tensor([start], device="cuda")
            per = []
            for t, tok in enumerate(fed):
                tok = int(tok)
                per.append([float(logits.max()), float(logits[0, tok]),
                            float(logits.abs().max()),
                            int(logits.argmax())])
                if t + 1 < len(fed):
                    nl, cache = model.forward_cached(
                        torch.tensor([[tok]], dtype=torch.int32,
                                     device="cuda"), cache, act + t, begin)
                    logits = nl[:, 0].float()
            stats[c] = per
    return stats


def _sessions_spill(torch, model, plan, oracle, tmp):
    """The bf16 chat with a write-through spill directory: turns 1-2 on
    one server, whose spilled blobs must equal its RAM snapshots byte for
    byte; one blob truncated; turns 3 on a new server over the directory,
    which restores every other session (pulls exact) and re-prefills the
    truncated one; every token held to the oracle."""
    from paddle_tpu_torch.serving.sessions import SessionSnapshot
    spill = os.path.join(tmp, "spill")
    srv = _session_server(torch, model, "bf16", True, spill)
    try:
        reqs, served, trans = _chat(srv, plan, range(2))
        store = srv.session_store
        ids = store.peek_ids()
        check(len(ids) == len(plan), f"sessions spill: parked {ids}")
        same = 0
        for sid in ids:
            with open(store._paths(sid)[0], "rb") as f:
                disk = f.read()
            same += disk == store._ram[sid].to_bytes() \
                and SessionSnapshot.from_bytes(disk).to_bytes() == disk
        check(same == len(ids), f"sessions spill: {same} of {len(ids)} "
              "spilled blobs equal their RAM snapshots")
        blob_bytes = sum(os.path.getsize(store._paths(s)[0]) for s in ids)
    finally:
        srv.stop()
    torn = store._paths("conv-0")[0]
    with open(torn, "r+b") as f:
        f.truncate(os.path.getsize(torn) // 2)
    srv = _session_server(torch, model, "bf16", True, spill)
    try:
        loop = srv._models["gpt2"]._loop
        watch = _watch_restores(torch, loop)
        r3, s3, _ = _chat(srv, plan, [2], trans=trans)
        c = dict(loop.counters)
    finally:
        srv.stop()
    check(c["restored"] == len(plan) - 1 == watch["checked"]
          and not watch["bad"] and c["parked"] == len(plan),
          f"sessions spill: the restarted server restored {c['restored']} "
          f"(want {len(plan) - 1}, one blob torn), pulls {watch}")
    equal, ties = _check_turns(torch, model, oracle, reqs + r3, served + s3,
                               "sessions spill", SLOT_TIE_SHARE["churn"])
    return {"blobs_equal_ram": same, "spilled_bytes": blob_bytes,
            "restored_after_restart": c["restored"], "torn_blobs": 1,
            "rows_without_tie": f"{equal}/{len(reqs) + len(r3)}",
            **_tie_summary(ties)}


def _sessions_drain(torch, model, plan, oracle, tmp, seed):
    """8 session requests of 96 new tokens, admitted together; drain()
    once the last row to start has emitted _drain_park_tokens(seed) tokens:
    8 parked at the same counts in every run, their futures fail with
    UnavailableError; each resubmitted to a second server over the shared
    spill directory (admitted together again) resumes: its preseed equals
    the tokens emitted before the park.  The tokens before the park are
    held to the generate() oracle (slot rows, as in the slots phase);
    the resumed ones to the geometry-matched oracle, which replays each
    row from its snapshot at the columns it was served at; near ties at
    most SLOT_TIE_SHARE["churn"] of the drain's tokens.  The resumed
    tokens' gaps against the generate() oracle, whose geometry differs,
    are reported, not held."""
    from paddle_tpu_torch.framework.enforce import UnavailableError
    from paddle_tpu_torch.serving.sessions import SessionSnapshot
    spill = os.path.join(tmp, "drain")
    prompts = [plan[c][0][0] for c in range(DRAIN_REQUESTS)]
    sids = [f"drain-{c}" for c in range(DRAIN_REQUESTS)]
    park_at = _drain_park_tokens(seed)
    srv = _session_server(torch, model, "bf16", True, spill)
    try:
        loop = srv._models["gpt2"]._loop
        _admit_together(loop, sids)
        ready = _held_for_drain(loop, DRAIN_REQUESTS, park_at)
        futs = [srv.submit_decode("gpt2", [p], max_new_tokens=DRAIN_NEW,
                                  timeout=60, session_id=sid)
                for sid, p in zip(sids, prompts)]
        check(ready.wait(120), "sessions drain: the rows never all "
              "generated")
        report = srv.drain(timeout_s=60)
        refused = 0
        for f in futs:
            try:
                f.result(timeout=60)
            except UnavailableError:
                refused += 1
        store = srv.session_store
    finally:
        srv.stop()
    check(report["parked_sessions"] == DRAIN_REQUESTS and report["drained"]
          and refused == DRAIN_REQUESTS,
          f"sessions drain: {report}, {refused} futures failed with "
          "UnavailableError")
    snaps = {}
    for c in range(DRAIN_REQUESTS):
        with open(store._paths(sids[c])[0], "rb") as f:
            snaps[c] = SessionSnapshot.from_bytes(f.read())
        s = snaps[c]
        check(s.remaining > 0 and len(s.emitted) + s.remaining == DRAIN_NEW
              and s.planes is not None and s.logits is not None,
              f"sessions drain: conversation {c} parked {len(s.emitted)} "
              f"tokens, {s.remaining} left")
    parked_at = [len(snaps[c].emitted) for c in range(DRAIN_REQUESTS)]
    check(min(parked_at) == park_at, f"sessions drain: parked after "
          f"{parked_at} tokens, the last row to start after {park_at}")
    srv = _session_server(torch, model, "bf16", True, spill)
    try:
        loop = srv._models["gpt2"]._loop
        placed = _admit_together(loop, sids)
        watch = _watch_restores(torch, loop)
        futs = [srv.submit_decode("gpt2", [p], max_new_tokens=DRAIN_NEW,
                                  timeout=60, session_id=sid)
                for sid, p in zip(sids, prompts)]
        served = [f.result(timeout=600)[0][0] for f in futs]
        c = dict(loop.counters)
    finally:
        srv.stop()
    replayed = sum(list(served[i][:len(snaps[i].emitted)])
                   == snaps[i].emitted for i in range(DRAIN_REQUESTS))
    check(c["restored"] == DRAIN_REQUESTS == watch["checked"] == len(placed)
          == replayed and not watch["bad"],
          f"sessions drain: restored {c['restored']}, pulls {watch}, "
          f"{replayed} preseeds replayed exactly")
    # each token held to its oracle's near-tie gap here, the share of
    # near ties over all the drain's tokens below (as for any slot row)
    before, b_ties = _check_turns(
        torch, model, oracle, [(p, k) for p, k in zip(prompts, parked_at)],
        [served[i][:k] for i, k in enumerate(parked_at)],
        "sessions drain before the park", 1.0)
    stats = _geometry_oracle(torch, model, oracle, snaps, placed, served)
    equal, ties = _tie_rule(
        stats, {c: served[c][len(snaps[c].emitted):] for c in stats},
        "sessions drain resumed (geometry oracle)", 1.0)
    tokens = DRAIN_REQUESTS * DRAIN_NEW
    check(len(b_ties) + len(ties) <= SLOT_TIE_SHARE["churn"] * tokens,
          f"sessions drain: {len(b_ties)} near ties before the park and "
          f"{len(ties)} after it of {tokens} tokens")
    _, g_ties = _check_turns(
        torch, model, oracle, [(p, DRAIN_NEW) for p in prompts], served,
        "sessions drain (generate() oracle)", SLOT_TIE_SHARE["churn"],
        hold=False)
    resumed_g = [g for g in g_ties if g[1] >= parked_at[g[0]]]
    return {"parked_sessions": report["parked_sessions"],
            "refused_unavailable": refused, "park_at_tokens": park_at,
            "emitted_before_park": parked_at,
            "resumed_at": [(sid, st, act) for sid, st, act, _ in placed],
            "preseeds_exact": replayed, "restored": c["restored"],
            "before_park": {"rows_without_tie": f"{before}/{DRAIN_REQUESTS}",
                            **_tie_summary(b_ties)},
            "resumed_geometry_oracle": {
                "rows_without_tie": f"{equal}/{DRAIN_REQUESTS}",
                **_tie_summary(ties)},
            "resumed_generate_oracle_reported": _tie_summary(resumed_g)}


def _sessions_capacity(torch, model, seed):
    """PARK_SESSIONS conversations of PARK_PROMPT tokens and PARK_NEW new
    tokens through one slot loop into one store: host bytes a session
    (held to the widths: every column of every plane, and 8 bytes a
    token), parks a second (submit to the last park), and the ring's
    device bytes a conversation without the store (the 8 slot rows) and
    with it (the slot rows plus the parked)."""
    from paddle_tpu_torch.serving.sessions import SessionStore
    from paddle_tpu_torch.serving.slots import SlotLoop
    from paddle_tpu_torch.text.generation import Generator
    cfg = model.config
    gen = Generator(model, seq_buckets=(128, SLOT_CACHE), max_len=SLOT_CACHE)
    store = SessionStore()
    loop = SlotLoop(gen, SLOTS, SLOT_CACHE, CHUNK, session_store=store)
    rng = np.random.RandomState(seed + 23)
    prompts = [rng.randint(1, cfg.vocab_size, PARK_PROMPT).astype(np.int32)
               for _ in range(PARK_SESSIONS)]
    try:
        loop.submit(prompts[0][:CHUNK], 1).result(timeout=600)  # warm-up
        t0 = time.perf_counter()
        futs = [loop.submit(p, PARK_NEW, session_id=f"park-{i}")
                for i, p in enumerate(prompts)]
        for f in futs:
            f.result(timeout=600)
        park_s = time.perf_counter() - t0
        ring = sum(p.numel() * p.element_size() for p in loop._step.planes())
        parked, host = len(store), store.nbytes()
    finally:
        loop.close()
    tokens = PARK_PROMPT + PARK_NEW
    # K and V of every layer, in the model's dtype
    per_token = cfg.num_layers * 2 * cfg.hidden_size \
        * model.wte.weight.element_size()
    check(parked == PARK_SESSIONS
          and host == parked * tokens * (per_token + 8),
          f"sessions capacity: {parked} parked in {host} bytes, want "
          f"{PARK_SESSIONS} x {tokens} x ({per_token} + 8)")
    del store
    return {"sessions": parked, "tokens_a_session": tokens,
            "host_bytes_per_session": host // parked,
            "host_bytes_per_token": per_token, "host_bytes": host,
            "park_s": round(park_s, 3),
            "parks_per_s": round(parked / park_s, 1),
            "ring_bytes": ring,
            "ring_bytes_per_conversation_without_store": ring // SLOTS,
            "ring_bytes_per_conversation_with_store":
                ring // (SLOTS + parked)}


def _sessions_handoff(torch, model, seed):
    """prefill_handoff -> serialize_kv -> deserialize_kv ->
    decode_from_handoff on the serving phase's first 8 requests, bf16 then
    int8 KV, at the serving phase's buckets: the tokens equal the
    in-process continuation (the same handoff decoded on the device) bit
    for bit, and the decodes launch B3 (B4) once a layer a step."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.serving.cluster.handoff import deserialize_kv
    prompts = _traffic(seed, model.config.vocab_size)[:HANDOFF_REQUESTS]
    layers = model.config.num_layers
    out = {}
    for kv in ("bf16", "int8"):
        flags.set_flags({"FLAGS_kv_cache_dtype": kv})
        srv = serving.Server()
        srv.register_decode("gpt2", model, **HANDOFF_GRID)
        srv.start()
        try:
            fd.launch_counts(reset=True)
            h = srv.prefill_handoff("gpt2", prompts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = h.to_bytes()
            ser = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = deserialize_kv(blob)
            deser = time.perf_counter() - t0
            exact = _same_bits(torch, back.cache, h.cache) \
                and _same_bits(torch, back.logits0, h.logits0)
            wire = srv.decode_from_handoff("gpt2", back)
            local = srv.decode_from_handoff("gpt2", h)   # planes in place
            counts = fd.launch_counts()
        finally:
            srv.stop()
        name = "flash_decode_quant" if kv == "int8" else "flash_decode"
        want = 2 * layers * MAX_NEW
        check(exact and np.array_equal(wire, local)
              and wire.shape == (HANDOFF_REQUESTS, MAX_NEW)
              and counts[name] == want
              and sum(counts.values()) == want,
              f"sessions handoff kv={kv}: planes exact {exact}, tokens "
              f"equal {np.array_equal(wire, local)}, launches {counts} "
              f"(want {name} {want})")
        out[kv] = {"blob_bytes": len(blob), "serialize_s": round(ser, 4),
                   "deserialize_s": round(deser, 4),
                   "prefill_s": h.meta["prefill_s"],
                   "tokens_equal_in_process": True, "launches": counts}
    return out


def phase_sessions(torch, model, seed):
    """Parked sessions on the slot server and the KV handoff: the chat in
    bf16 and int8 KV with the store on and off, the first 8 conversations
    through the speculative slot server; spill and restart; drain; parked
    capacity; the handoff."""
    import tempfile
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.text.generation import Generator
    plan = _chat_plan(seed + 13, model.config.vocab_size)
    oracle = Generator(model, seq_buckets=(128, 256, 512, SLOT_CACHE),
                       max_len=SLOT_CACHE)
    snap = flags.flags_snapshot()
    out, secs, t_phase = {}, {}, time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sessions_", dir=os.path.join(ROOT,
                                                                  "build"))
    try:
        draft = _draft_model(torch, seed + 5, model.config.vocab_size)
        for kv in ("bf16", "int8"):
            for store in (True, False):
                t0 = time.perf_counter()
                reqs, served, run = _chat_run(torch, model, plan, kv, store)
                flags.set_flags({"FLAGS_kv_cache_dtype": kv})
                equal, ties = _check_turns(
                    torch, model, oracle, reqs, served,
                    f"sessions kv={kv} store={store}",
                    SLOT_TIE_SHARE["churn"])
                run.update(rows_without_tie=f"{equal}/{len(reqs)}",
                           tokens_checked=sum(mn for _, mn in reqs),
                           **_tie_summary(ties))
                out[f"{kv}_{'on' if store else 'off'}"] = run
                secs[f"{kv}_{'on' if store else 'off'}"] = round(
                    time.perf_counter() - t0, 1)
                log("sessions", kv_cache=kv, store=store, **run)
        t0 = time.perf_counter()
        reqs, served, run = _chat_run(torch, model,
                                      plan[:SPEC_CONVERSATIONS], "bf16",
                                      True, draft=draft)
        flags.set_flags({"FLAGS_kv_cache_dtype": "bf16"})
        equal, ties = _check_turns(torch, model, oracle, reqs, served,
                                   "sessions spec", SLOT_TIE_SHARE["churn"])
        run.update(rows_without_tie=f"{equal}/{len(reqs)}",
                   **_tie_summary(ties))
        out["spec"] = run
        secs["spec"] = round(time.perf_counter() - t0, 1)
        log("sessions", path="spec", **run)
        del draft
        for name, fn in (("spill", _sessions_spill),
                         ("drain", functools.partial(_sessions_drain,
                                                     seed=seed))):
            t0 = time.perf_counter()
            out[name] = fn(torch, model, plan, oracle, tmp)
            secs[name] = round(time.perf_counter() - t0, 1)
            log("sessions", path=name, **out[name])
        t0 = time.perf_counter()
        out["capacity"] = _sessions_capacity(torch, model, seed)
        secs["capacity"] = round(time.perf_counter() - t0, 1)
        log("sessions", path="capacity", **out["capacity"])
        t0 = time.perf_counter()
        out["handoff"] = _sessions_handoff(torch, model, seed)
        secs["handoff"] = round(time.perf_counter() - t0, 1)
        log("sessions", path="handoff", **out["handoff"])
    finally:
        flags.flags_restore(snap)
        shutil.rmtree(tmp, ignore_errors=True)
    # the path's launches: a replay's decode nodes times the replays (no
    # wrapper runs in a replay), and the handoff decodes' wrapper counts
    hand = {kv: out["handoff"][kv]["launches"] for kv in ("bf16", "int8")}
    out["launches"] = {
        "flash_decode": out["bf16_on"]["one_query_launches"]
        + out["bf16_off"]["one_query_launches"]
        + out["spec"]["one_query_launches"]
        + hand["bf16"]["flash_decode"],
        "flash_decode_quant": out["int8_on"]["one_query_launches"]
        + out["int8_off"]["one_query_launches"]
        + hand["int8"]["flash_decode_quant"],
        "flash_decode_block": out["spec"]["block_launches"],
        # no int8 speculative session runs in this phase
        "flash_decode_quant_block": 0}
    check(all(out["launches"][k] > 0 for k in (
        "flash_decode", "flash_decode_quant", "flash_decode_block")),
        f"sessions: a kernel of the path never ran: {out['launches']}")
    log("sessions", launches=out["launches"], seconds=secs,
        total_s=round(time.perf_counter() - t_phase, 1))
    return out


# -- phase 6b: speculative decoding and beam search --------------------------

# the draft: bench.py:1101-1104's widths (hidden 256, 4 layers, 4 heads,
# intermediate 1024, 1024 positions) at the target's vocabulary 50257,
# since acceptance compares token ids (bench.py's pair uses 32000)
DRAFT_CFG = dict(hidden_size=256, num_layers=4, num_heads=4,
                 intermediate_size=1024, max_position_embeddings=1024)
SPEC_PROMPT, SPEC_NEW, SPEC_BATCHES = 128, 128, (1, 8)
SPEC_BUCKETS = dict(seq_buckets=(SPEC_PROMPT, 512), max_len=512)
# the run-to-completion server under FLAGS_spec_decode: the serving
# phase's grid and traffic, at a ring with the verify block's slack
# (128 + 128 + gamma + 1 columns do not fit 256)
SPEC_GRID = dict(batch_buckets=BATCH_BUCKETS, max_new_tokens=MAX_NEW,
                 **SPEC_BUCKETS)
# the speculative server takes the serving phase's first 8 requests (one
# batch of 8) and the speculative slot server the churn trace's first 24
# (cuts of 16 and 48, for the script's time); the self-draft pass 8
SPEC_REQUESTS, SPEC_CHURN, SELF_DRAFT_CHURN = 8, 24, 8
BEAM = dict(batch=2, prompt=64, new=32, beam=4)


def _draft_model(torch, seed, vocab):
    from paddle_tpu_torch.text.models import GPTConfig, GPTModel
    draft = GPTModel(GPTConfig(vocab_size=vocab, **DRAFT_CFG),
                     device="cuda", dtype=torch.bfloat16)
    draft.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    return draft.eval()


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _spec_launches_ok(counts, kv, layers, per_step_one, steps, where):
    """The verify blocks launched the block form once a target layer a
    step; the draft's one-token forwards the one-query kernel
    ``per_step_one`` times a step; the other dtype's kernels never."""
    q = "_quant" if kv == "int8" else ""
    want = {f"flash_decode{q}_block": layers * steps,
            f"flash_decode{q}": per_step_one * steps}
    check(all(counts[k] == want.get(k, 0) for k in counts),
          f"{where}: launches {counts}, want {want} (others 0)")


def _spec_generate(torch, model, draft, seed):
    """SpeculativeGenerator against the plain Generator at the same cache
    length, batch 1 and 8, 128-token prompts, 128 new tokens, bf16 and
    int8 KV: equal tokens with the random draft and with the target as
    its own draft (acceptance 1.0 in ceil(128/5) steps); decode tok/s
    of each (prefill not timed, after a short warm-up decode)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    from paddle_tpu_torch.text.speculative import SpeculativeGenerator
    layers, dlayers = model.config.num_layers, draft.config.num_layers
    G1 = SPEC_GAMMA + 1
    rng = np.random.RandomState(seed + 21)
    out = {}
    for kv in ("bf16", "int8"):
        flags.set_flags({"FLAGS_kv_cache_dtype": kv})
        plain = Generator(model, **SPEC_BUCKETS)
        gens = {name: SpeculativeGenerator(model, d, gamma=SPEC_GAMMA,
                                           **SPEC_BUCKETS)
                for name, d in (("random_draft", draft),
                                ("self_draft", model))}
        for B in SPEC_BATCHES:
            ids = rng.randint(1, model.config.vocab_size, (B, SPEC_PROMPT))
            pids, start = plain.pack_prompts(list(ids), SPEC_PROMPT)
            C = gens["self_draft"].cache_bucket(SPEC_PROMPT, SPEC_NEW)
            row = {"cache": C}

            def decode(gen, steps=SPEC_NEW):
                cache, logits0 = gen.prefill(pids, start, C)
                return _timed(torch, lambda: gen.decode(
                    cache, logits0, start, SPEC_PROMPT, steps))

            decode(plain, 8)
            want, dt = decode(plain)
            row["plain_tok_per_s"] = round(B * SPEC_NEW / dt, 1)
            for name, gen in gens.items():
                decode(gen, 8)
                fd.launch_counts(reset=True)
                got, dt = decode(gen)
                counts = fd.launch_counts()
                st = gen.last_stats
                where = f"spec generate kv={kv} B={B} {name}"
                check(torch.equal(got, want),
                      f"{where}: speculative tokens differ from greedy at "
                      f"cache {C} from token "
                      f"{(got != want).nonzero()[:1].tolist()}")
                one = (dlayers if name == "random_draft" else layers) * G1
                _spec_launches_ok(counts, kv, layers, one,
                                  st["spec_steps"], where)
                if name == "self_draft":
                    check(st["acceptance_rate"] == 1.0
                          and st["spec_steps"] == -(-SPEC_NEW // G1),
                          f"{where}: {st}")
                row[name] = {"tok_per_s": round(B * SPEC_NEW / dt, 1),
                             "acceptance_rate": st["acceptance_rate"],
                             "spec_steps": st["spec_steps"],
                             "launches": counts}
            log("spec", path="generate", kv_cache=kv, batch=B,
                prompt=SPEC_PROMPT, new_tokens=SPEC_NEW, gamma=SPEC_GAMMA,
                equals_greedy_at_same_cache=True, **row)
            out[f"{kv}_b{B}"] = row
    return out


def _spec_server(torch, model, draft, seed):
    """FLAGS_spec_decode with a draft_layer over the serving phase's
    request mix, run to completion: every served row equals its batch-1
    plain Generator decode at the runtime's cache length."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    from paddle_tpu_torch.text.speculative import SpeculativeGenerator
    flags.set_flags({"FLAGS_kv_cache_dtype": "bf16",
                     "FLAGS_spec_decode": True})
    srv = serving.Server()
    srv.register_decode("gpt2", model, draft_layer=draft, gamma=SPEC_GAMMA,
                        **SPEC_GRID)
    srv.start()
    flags.set_flags({"FLAGS_spec_decode": False})
    prompts = _traffic(seed, model.config.vocab_size)[:SPEC_REQUESTS]
    try:
        rt = srv._models["gpt2"]
        check(isinstance(rt.gen, SpeculativeGenerator),
              f"spec server: the runtime serves {type(rt.gen).__name__}")
        steps0 = rt.gen.totals["spec_steps"]
        # the path's run: counts read from 0 just before it
        fd.launch_counts(reset=True)
        t0 = time.perf_counter()
        futs = [srv.submit_decode("gpt2", [p], timeout=60) for p in prompts]
        served = [f.result(timeout=600)[0][0] for f in futs]
        dt = time.perf_counter() - t0
        counts = fd.launch_counts()
        st = srv.stats("gpt2")
        steps = rt.gen.totals["spec_steps"] - steps0
        C = rt.gen.cache_bucket(SPEC_PROMPT, MAX_NEW)
    finally:
        srv.stop()
    _spec_launches_ok(counts, "bf16", model.config.num_layers,
                      draft.config.num_layers * (SPEC_GAMMA + 1), steps,
                      "spec server")
    check(st["completed"] == len(prompts) and st["errors"] == 0,
          f"spec server: {st}")
    oracle = Generator(model, **SPEC_BUCKETS)
    for i, (p, got) in enumerate(zip(prompts, served)):
        ids, start = oracle.pack_prompts([p], SPEC_PROMPT)
        cache, logits0 = oracle.prefill(ids, start, C)
        want = oracle.decode(cache, logits0, start, SPEC_PROMPT,
                             MAX_NEW).cpu().numpy()[0]
        check(np.array_equal(got, want),
              f"spec server: row {i} (prompt {p.size}) differs from its "
              f"batch-1 greedy decode at cache {C}")
    out = {"requests": len(prompts), "cache": C, "batches": st["batches"],
           "spec_steps": steps, "tok_per_s": round(
               len(prompts) * MAX_NEW / dt, 1),
           "ttft_p50_ms": round(st["ttft_p50_ms"], 2),
           "spec_accepted": st["spec_accepted"],
           "spec_proposed": st["spec_proposed"],
           "spec_acceptance_rate": st["spec_acceptance_rate"],
           "launches": counts,
           "rows_equal_batch1_greedy": f"{len(prompts)}/{len(prompts)}"}
    log("spec", path="server", **out)
    return out


def _spec_run(step):
    """One full speculative slot step a call (every row active, commits
    of up to gamma + 1), at positions cycling over 8 columns."""
    start, fin, active, pos = _step_state(step.S, step.C, 3)
    cur = np.zeros(step.S, np.int32)
    return lambda i: step(start, fin, active, cur, pos + (i % 8), step.G1)


def _spec_step_compare(torch, gen, kv, steps=5):
    """The captured speculative step against the same step run eagerly,
    from one random state of both caches: planes, e, cur, finished,
    ncommit and n bit-equal, the host rewriting its vectors between
    steps."""
    from paddle_tpu_torch.text.graphs import SpecSlotStep
    cap = gen.step_exec(SLOTS, SLOT_CACHE)
    eager = SpecSlotStep(gen, SLOTS, SLOT_CACHE, -1)
    check(cap.captured, "spec slots: step_exec on CUDA returned an "
          "uncaptured step")
    g = torch.Generator(device="cuda").manual_seed(SLOT_CACHE)
    with torch.inference_mode():
        for p in cap.planes():
            if p.dtype == torch.int8:
                p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                      device="cuda"))
            elif p.shape[-1] == 1:
                p.copy_(torch.rand(p.shape, generator=g, device="cuda")
                        * 0.02 + 1e-3)
            else:
                p.copy_(torch.randn(p.shape, generator=g, device="cuda"))
    eager.load_state(cap)
    start, fin, active, pos = _step_state(SLOTS, SLOT_CACHE, 1)
    rng = np.random.RandomState(2)
    cur = rng.randint(0, gen._vocab_size(), SLOTS).astype(np.int32)
    oc = oe = (cur, fin)
    for i in range(steps):
        active = rng.rand(SLOTS) < 0.8
        start = rng.randint(0, pos - 100, SLOTS).astype(np.int32)
        mc = int(rng.randint(1, SPEC_GAMMA + 2))
        rc = cap(start, oc[1], active, oc[0], pos, mc)
        re = eager(start, oe[1], active, oe[0], pos, mc)
        same = (all(np.array_equal(a, b) for a, b in zip(rc, re))
                and all(torch.equal(x, y) for x, y in zip(cap.planes(),
                                                          eager.planes())))
        check(same, f"spec slots kv={kv}: the captured step differs from "
              f"the eager step at step {i}")
        oc, oe = rc[:2], re[:2]
        pos += rc[3]
    return cap, eager


def _spec_slots(torch, model, draft, seed):
    """The speculative slot server (8 slots, chunk 64, 768-column ring)
    over the churn trace's first 24 requests, bf16 then int8: tokens held
    to the teacher-forced oracle (the slots phase's rule and caps), every
    step a replay of the captured speculative step and none built after
    warm-up; the captured graph's decode kernel nodes (draft layers x 5
    + target layers), 20 replays traced showing them run; captured
    against eager; the target as its own draft
    accepts every proposal."""
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    from paddle_tpu_torch.text.graphs import CapturedSpecSlotStep
    layers, dlayers = model.config.num_layers, draft.config.num_layers
    per_replay = dlayers * (SPEC_GAMMA + 1) + layers
    reqs = _churn(seed + 7, model.config.vocab_size)[:SPEC_CHURN]
    oracle = Generator(model, seq_buckets=(128, 256, 512, SLOT_CACHE),
                       max_len=SLOT_CACHE)
    out = {}
    for kv in ("bf16", "int8"):
        srv = _slot_server(torch, model, kv, draft=draft)
        try:
            rt = srv._models["gpt2"]
            step = rt._loop._step
            check(isinstance(step, CapturedSpecSlotStep),
                  f"spec slots kv={kv}: the loop's step is "
                  f"{type(step).__name__}")
            built = dict(rt.gen.counters)
            fd.launch_counts(reset=True)
            r0 = step.replays
            served, run = _serve_churn(torch, srv, reqs)
            counts = fd.launch_counts()
            sl = run["stats"]["slot_loop"]
            check(step.replays - r0 == sl["steps"] > 0
                  and sum(counts.values()) == 0,
                  f"spec slots kv={kv}: {step.replays - r0} replays for "
                  f"{sl['steps']} steps, wrapper launches {counts}")
            check(sl["joined"] == sl["retired"] == len(reqs),
                  f"spec slots kv={kv}: {sl}")
            check(dict(rt.gen.counters) == built,
                  f"spec slots kv={kv}: steps built after warm-up: "
                  f"{built} -> {rt.gen.counters}")
            # the graph's decode kernel nodes: the draft's one-query
            # launches (grids of SLOTS x draft heads rows) and the
            # target's verify blocks (SLOTS x heads x (gamma + 1) rows),
            # told apart by grid; 20 replays traced show them run
            gd = SLOTS * draft.config.num_heads
            gv = SLOTS * model.config.num_heads * (SPEC_GAMMA + 1)
            nodes, graph_kernels = _graph_nodes(step._graph,
                                                "decode_cluster_kernel")
            n_kernels = len(graph_kernels)
            draft_n, verify_n = nodes.get(gd, 0), nodes.get(gv, 0)
            check(sum(nodes.values()) == per_replay
                  and draft_n == dlayers * (SPEC_GAMMA + 1)
                  and verify_n == layers,
                  f"spec slots kv={kv}: graph decode nodes {nodes} of "
                  f"{n_kernels} kernel nodes, want "
                  f"{dlayers * (SPEC_GAMMA + 1)} draft and {layers} verify "
                  "decode kernels a replay")
            prof = _step_profile(torch, _spec_run(step), per_trace=5)
            whole = _traced_replays(prof.pop("decode_by_launch"), nodes,
                                    20, f"spec slots kv={kv}")
            check(prof["decode_kernel_ms"] > 0,
                  f"spec slots kv={kv}: traced replays {prof}")
        finally:
            srv.stop()
        equal, ties = _check_rows(torch, model, oracle, reqs,
                                  served, f"spec slots kv={kv}",
                                  SLOT_TIE_SHARE["churn"])
        cap, eager = _spec_step_compare(torch, rt.gen, kv)
        eager_prof = _step_profile(torch, _spec_run(eager), per_trace=5)
        eager_prof.pop("decode_by_launch")
        out[kv] = {"steps": sl["steps"], "steps_replayed": sl["steps"],
                   "wrapper_launches": sum(counts.values()),
                   "decode_kernels_per_replay": sum(nodes.values()),
                   "draft_decode_kernels_per_replay": draft_n,
                   "verify_decode_kernels_per_replay": verify_n,
                   "graph_kernel_nodes": n_kernels,
                   "traced_replays_whole": whole,
                   "chunks": sl["chunks"], "tok_per_s": run["tok_per_s"],
                   "ttft_p50_ms": sl["ttft_p50_ms"],
                   "ttft_p99_ms": sl["ttft_p99_ms"],
                   "spec_accepted": sl["spec_accepted"],
                   "spec_proposed": sl["spec_proposed"],
                   "spec_acceptance_rate": sl.get("spec_acceptance_rate"),
                   "rows_equal_batch1_generate": f"{equal}/{len(reqs)}",
                   "tokens_checked": sum(mn for _, mn in reqs),
                   **_tie_summary(ties),
                   "captured_step": prof, "eager_step": eager_prof,
                   "captured_equals_eager": True}
        log("spec", path="slots", kv_cache=kv, requests=len(reqs),
            slots=SLOTS, chunk=CHUNK, cache=SLOT_CACHE, gamma=SPEC_GAMMA,
            **out[kv])
        del cap, eager, rt, srv, step
    # the target as its own draft: every proposal accepted
    srv = _slot_server(torch, model, "bf16", draft=model)
    try:
        _serve_churn(torch, srv, reqs[:SELF_DRAFT_CHURN])
        sl = srv.stats("gpt2")["slot_loop"]
    finally:
        srv.stop()
    check(sl["spec_acceptance_rate"] == 1.0,
          f"spec slots, self-draft: {sl}")
    out["self_draft"] = {k: sl[k] for k in ("spec_accepted", "spec_proposed",
                                            "spec_acceptance_rate", "steps")}
    log("spec", path="slots", self_draft=out["self_draft"])
    return out


def phase_spec(torch, model, seed):
    """Speculative decoding with the random draft (and the target as its
    own draft) through generate(), the run-to-completion server and the
    slot loop."""
    from paddle_tpu_torch.framework import flags
    draft = _draft_model(torch, seed + 5, model.config.vocab_size)
    snap = flags.flags_snapshot()
    out, secs = {}, {}
    try:
        for name, fn in (("generate", _spec_generate),
                         ("server", _spec_server), ("slots", _spec_slots)):
            t0 = time.perf_counter()
            out[name] = fn(torch, model, draft, seed)
            secs[name] = round(time.perf_counter() - t0, 1)
    finally:
        flags.flags_restore(snap)
    log("spec", seconds=secs)
    return out


def phase_beam(torch, model, seed):
    """generate(beam_size=4), batch 2, 64-token prompts, 32 new tokens,
    bf16: scores non-increasing per row, tokens in range, B3 launched once
    a layer a step; every path's score against the sum of its tokens'
    log-probs recomputed by feeding the paths as B*K rows at the same
    cache length (expected bit-equal; held to 1e-5 of max(1, |score|))."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    B, P, steps, K = BEAM["batch"], BEAM["prompt"], BEAM["new"], BEAM["beam"]
    V = model.config.vocab_size
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_kv_cache_dtype": "bf16"})
        gen = Generator(model, seq_buckets=(P, 128), max_len=128)
        ids = np.random.RandomState(seed + 31).randint(1, V, (B, P))
        fd.launch_counts(reset=True)
        (paths, scores), dt = _timed(torch, lambda: gen.generate(
            ids, max_new_tokens=steps, beam_size=K))
        counts = fd.launch_counts()
        layers = model.config.num_layers
        check(counts["flash_decode"] == layers * steps
              and sum(counts.values()) == layers * steps,
              f"beam: launches {counts}, want flash_decode = {layers} x "
              f"{steps}")
        check(tuple(paths.shape) == (B, K, steps)
              and tuple(scores.shape) == (B, K),
              f"beam: shapes {tuple(paths.shape)} {tuple(scores.shape)}")
        check(bool(torch.isfinite(scores).all())
              and bool((scores[:, 1:] <= scores[:, :-1]).all()),
              f"beam: scores not finite and non-increasing: {scores}")
        check(bool(((paths >= 0) & (paths < V)).all()),
              "beam: a path token out of range")
        # the paths fed back as B*K rows through the same cache length
        C = gen.cache_bucket(P, steps)
        pids, start = gen.pack_prompts(list(ids), P)
        start_k = np.repeat(start, K)
        with torch.inference_mode():
            cache, logits = gen.prefill(np.repeat(pids, K, axis=0), start_k,
                                        C)
            fed = paths.reshape(B * K, steps)
            st = torch.as_tensor(start_k, device="cuda")
            total = torch.zeros(B * K, device="cuda")
            for t in range(steps):
                lp = torch.log_softmax(logits, dim=-1)
                total = total + lp.gather(1, fed[:, t:t + 1].long())[:, 0]
                nl, cache = model.forward_cached(fed[:, t:t + 1], cache,
                                                 P + t, st)
                logits = nl[:, 0].float()
        total = total.reshape(B, K)
        diff = (total - scores).abs().max().item()
        check(diff <= 1e-5 * max(1.0, scores.abs().max().item()),
              f"beam: recomputed path scores differ by {diff}")
        out = {"batch": B, "beam": K, "prompt": P, "new_tokens": steps,
               "cache": C, "seconds": round(dt, 3),
               "scores": np.round(scores.cpu().numpy(), 4).tolist(),
               "recomputed_scores_bit_equal": bool(torch.equal(total,
                                                               scores)),
               "recomputed_max_abs_diff": diff, "launches": counts}
        log("beam", **out)
        return out
    finally:
        flags.flags_restore(snap)


# -- phase 7 -----------------------------------------------------------------

def phase_e2e(torch, seed):
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    model = _gpt2(torch, seed + 1, torch.float32)
    gen = Generator(model, seq_buckets=SEQ_BUCKETS, max_len=MAX_LEN)
    prompts = _traffic(seed + 1, model.config.vocab_size)[:4]
    P, steps = SEQ_BUCKETS[0], 16
    ids, start = gen.pack_prompts(prompts, P)
    runs = {}
    snap = flags.flags_snapshot()
    try:
        for on in (True, False):
            flags.set_flags({"FLAGS_use_flash_decode": on})
            before = fd.flash_decode.launches
            cache, logits0 = gen.prefill(ids, start, gen.cache_bucket(P,
                                                                      steps))
            toks = gen.decode(cache, logits0, start, P, steps)
            # the decode loop's last step again: same token, same column
            with torch.inference_mode():
                last, _ = model.forward_cached(
                    toks[:, -1:], cache, P + steps - 1,
                    torch.as_tensor(start, device="cuda"))
            torch.cuda.synchronize()
            runs[on] = (toks.cpu().numpy(), last[:, 0].float(),
                        fd.flash_decode.launches - before)
    finally:
        flags.flags_restore(snap)
    layers = model.config.num_layers
    check(runs[True][2] == layers * (steps + 1) and runs[False][2] == 0,
          f"e2e launches on/off {runs[True][2]}/{runs[False][2]}")
    check(np.array_equal(runs[True][0], runs[False][0]),
          "e2e: greedy tokens differ between kernel and plain attention")
    err = (runs[True][1] - runs[False][1]).abs().max().item()
    check(bool(torch.isfinite(runs[True][1]).all()) and err <= 1e-4,
          f"e2e: last logits differ by {err} > 1e-4")
    log("e2e", dtype="float32", prompts=len(prompts), new_tokens=steps,
        tokens_equal=True, last_logits_max_abs_err=err, atol=1e-4)


# -- phase 7b: bench_decode's int8 variant, a frozen-int8 GPT ---------------

# bench_decode's chip configuration (bench.py:1096-1104): a GPT of 32,000
# tokens at GPT-2 small's widths, 128-token prompts, 128 new tokens,
# batches 1 and 8, cache buckets (128, 256, 512) up to 512, each timing
# the best of 3.  Its int8 variant is the f32 model, PTQ-calibrated
# (abs_max) over 4 batches of one RandomState(0) prompt and frozen: not
# amp-decorated, so its layers, activations and ring cache stay f32 and
# every decode step runs B3's f32 instance (B4 with an f32 query under
# FLAGS_kv_cache_dtype=int8).  Its bf16 variant is the same weights cast
# by amp.decorate(level="O2").  Nothing is cut
DECODE_CFG = dict(vocab_size=32000, hidden_size=768, num_layers=12,
                  num_heads=12, intermediate_size=3072,
                  max_position_embeddings=1024, dropout=0.0)
DECODE = dict(prompt=128, steps=128, batches=(1, 8),
              seq_buckets=(128, 256, 512), max_len=512, reps=3)
# the frozen sites of a layer; the tied LM head (wte) stays float
DECODE_SITES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                "self_attn.out_proj", "linear1", "linear2")
# the card against the port on the CPU: the prefill and this many steps,
# fed the card's tokens.  The products are exact on both and the float
# layers between the sites round an ulp apart; an input that lands within
# an ulp of a half step is coded one step apart at the next site, which
# moves every input of the sites after it by more than an ulp, and over
# 72 sites the two runs drift apart by the quantization noise itself
# (2.1-2.6% of max |logit| on an H100, against the dense phase's 2^-6 for
# LeNet and the block).  So the drift is reported, and the check runs the
# CPU on the card's activation codes: every CPU code within one step of
# the card's, such flips at most DECODE_FLIP_SHARE of the codes (a
# quantize that rounds or scales apart moves far more), and the logits
# within DECODE_PINNED_RTOL of max |cpu logit|: only the f32 layers
# (LayerNorm, GELU, attention, epilogues, the 768-term LM head) round
# apart then, ~1e-6 of it
DECODE_CPU_STEPS = 3
DECODE_PINNED_RTOL = 1e-4
DECODE_FLIP_SHARE = 1e-3
# the slot loop's churn: the slots phase's trace, cut to 16 requests
DECODE_SLOT_REQUESTS = 16


def _decode_gpt(torch, seed):
    """bench_decode's GPT in f32, GPT-2's initialization from ``seed``."""
    from paddle_tpu_torch.text.models import GPTConfig, GPTModel
    model = GPTModel(GPTConfig(**DECODE_CFG), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    return model.eval()


def _decode_bench(torch, gen, rng, vocab):
    """bench.py's _bench_decode_one timing (bench.py:926-960) on the port:
    for each batch a warm-up generate() (kept for the checks), then the
    prefill and the decode loop timed apart, each the best of 3 fenced
    by synchronize().  Returns (record, {batch: (ids, tokens)})."""
    P0, steps = DECODE["prompt"], DECODE["steps"]
    res, runs = {}, {}

    def best(fn):
        b = out = None
        for _ in range(DECODE["reps"]):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            b = dt if b is None else min(b, dt)
        return b, out

    for B in DECODE["batches"]:
        ids = rng.randint(1, vocab, (B, P0)).astype(np.int64)
        runs[B] = (ids, gen.generate(ids, max_new_tokens=steps)
                   .cpu().numpy())
        P = gen.prefill_bucket(P0)
        C = gen.cache_bucket(P, steps)
        packed, start = gen.pack_prompts(list(ids), P)
        pre_s, (cache, logits0) = best(lambda: gen.prefill(packed, start,
                                                           C))
        dec_s, _ = best(lambda: gen.decode(cache, logits0, start, P,
                                           steps))
        res[f"batch{B}"] = {
            "cache": C, "prefill_ms": round(pre_s * 1e3, 3),
            "decode_ms": round(dec_s * 1e3, 3),
            "decode_ms_per_tok": round(dec_s * 1e3 / steps, 4),
            "prefill_fraction": round(pre_s / (pre_s + dec_s), 3),
            "tok_per_s_decode": round(B * steps / dec_s, 1),
            "tok_per_s_total": round(B * steps / (pre_s + dec_s), 1)}
    return res, runs


def _decode_rows(gen, prompts, want, where):
    """A batch generate() of the ragged ``prompts`` (right-padded, with
    their lengths), each row against ``want``, its prompt's batch-1
    generate(), token for token.  Returns the batch's tokens."""
    ids = np.zeros((len(prompts), max(p.size for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :p.size] = p
    toks = gen.generate(ids, lengths=[p.size for p in prompts],
                        max_new_tokens=DECODE["steps"]).cpu().numpy()
    for i, one in enumerate(want):
        diff = np.nonzero(one != toks[i])[0]
        check(diff.size == 0, f"decode_int8 {where}: batch row {i} differs "
              f"from its batch-1 generate() from token {diff[:1]}")
    return toks


def _decode_int8_products(torch, model, gen, runs):
    """Every ``int8_mm`` call of the frozen GPT's batch-1 prefill (bench's
    batch-1 prompt) and of one batch-8 decode step (after the batch-8
    prefill) on the card against the exact product on the CPU (f64, as
    ``_int8_products``); and the float GEMMs of both, which must be the
    LM head's alone.  Returns {"MxKxN": count}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import int8 as I8
    P, steps = DECODE["prompt"], DECODE["steps"]
    C = gen.cache_bucket(P, steps)
    ids8, toks8 = runs[8]
    p8, s8 = gen.pack_prompts(list(ids8), P)
    cache8, _ = gen.prefill(p8, s8, C)
    p1, s1 = gen.pack_prompts(list(runs[1][0]), P)
    seen, floats = [], []
    real_mm, real_linear = I8.int8_mm, F.linear

    def recording(a, w):
        out = real_mm(a, w)
        seen.append((a, w, out))
        return out

    def linear(x, w, b=None):
        floats.append(tuple(w.shape))
        return real_linear(x, w, b)

    I8.int8_mm, F.linear = recording, linear
    try:
        gen.prefill(p1, s1, C)
        n_prefill = len(seen)
        with torch.inference_mode():
            model.forward_cached(torch.as_tensor(toks8[:, :1], device="cuda"),
                                 cache8, P, torch.as_tensor(s8,
                                                            device="cuda"))
        torch.cuda.synchronize()
    finally:
        I8.int8_mm, F.linear = real_mm, real_linear
    sites = len(DECODE_SITES) * DECODE_CFG["num_layers"]
    check(n_prefill == sites and len(seen) == 2 * sites,
          f"decode_int8: {n_prefill} and {len(seen) - n_prefill} int8 "
          f"products in a prefill and a step, want {sites} each")
    check(floats == [tuple(model._lm_head.shape)] * 2,
          f"decode_int8: float GEMMs {floats}, want the LM head's alone")
    shapes = {}
    for a, w, out in seen:
        want = (a.cpu().double() @ w.cpu().double().t()).long()
        check(out.is_cuda and out.dtype == torch.int32
              and torch.equal(out.cpu().long(), want),
              f"decode_int8: the card's int8 product at {tuple(a.shape)} x "
              f"{tuple(w.shape)} differs from the exact one")
        key = f"{a.shape[0]}x{a.shape[1]}x{w.shape[0]}"
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def _decode_card_vs_cpu(torch, model, gen, runs):
    """The frozen GPT on the card against the same frozen state on the
    CPU (TF32 off): bench's batch-1 prompt's prefill, then
    DECODE_CPU_STEPS steps fed the card's greedy tokens; max |card -
    cpu| / max |cpu| of each call's logits, free (each device codes its
    own activations: reported) and pinned (the CPU takes the card's
    activation codes at every site, each within one step of its own:
    held to DECODE_PINNED_RTOL).  Returns (free, pinned, flips: codes
    the CPU would have coded a step apart, of all codes)."""
    from paddle_tpu_torch.ops import int8 as I8
    from paddle_tpu_torch.quantization import ImperativeQuantAware, freeze
    from paddle_tpu_torch.quantization.freeze import quant_signature
    from paddle_tpu_torch.text.models import GPTModel
    cpu = GPTModel(model.config, device="cpu")
    ImperativeQuantAware().quantize(cpu)        # PTQ's wrappers
    freeze(cpu)
    cpu.load_state_dict(model.state_dict())
    check(quant_signature(cpu) == quant_signature(model),
          "decode_int8: the CPU copy's frozen sites differ from the card's")
    ids, toks = runs[1]
    P = DECODE["prompt"]
    C = gen.cache_bucket(P, DECODE["steps"])
    packed, start = gen.pack_prompts(list(ids), P)
    real = I8._quantize_act

    def run(m, dev, quantize=real):
        I8._quantize_act = quantize
        try:
            with torch.inference_mode():
                st = torch.as_tensor(start, device=dev)
                lg, cache = m.forward_cached(
                    torch.as_tensor(packed, device=dev), m.init_cache(1, C),
                    0, st)
                seq = [lg.float().cpu()]
                for t in range(DECODE_CPU_STEPS):
                    lg, cache = m.forward_cached(
                        torch.as_tensor(toks[:, t:t + 1], device=dev), cache,
                        P + t, st)
                    seq.append(lg.float().cpu())
        finally:
            I8._quantize_act = real
        return seq

    codes = []

    def record(x, scale, qmax):
        q, sx = real(x, scale, qmax)
        codes.append(q.cpu())
        return q, sx

    flips = [0, 0]

    def pinned(x, scale, qmax):
        q, sx = real(x, scale, qmax)
        want = codes[flips[1]] if flips[1] < len(codes) else None
        check(want is not None and want.shape == q.shape,
              f"decode_int8: CPU site call {flips[1]} has no card codes "
              "of its shape")
        d = (q.short() - want.short()).abs()
        check(int(d.max()) <= 1, f"decode_int8: site call {flips[1]}: the "
              f"CPU codes an input {int(d.max())} steps off the card")
        flips[0] += int((d > 0).sum())
        flips[1] += 1
        return want, sx

    card = run(model, "cuda", record)
    free = run(cpu, "cpu")
    n_codes = sum(c.numel() for c in codes)
    pin = run(cpu, "cpu", pinned)
    check(flips[1] == len(codes), f"decode_int8: {flips[1]} CPU site calls "
          f"for {len(codes)} on the card")

    def errs(ref):
        return [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(card, ref)]

    free, pin = errs(free), errs(pin)
    share = flips[0] / n_codes
    check(all(np.isfinite(pin)) and max(pin) <= DECODE_PINNED_RTOL
          and share <= DECODE_FLIP_SHARE,
          f"decode_int8: the card against the CPU on one frozen state, the "
          f"CPU taking the card's codes: {pin} of max |ref| (limit "
          f"{DECODE_PINNED_RTOL}), codes a step apart {flips[0]} of "
          f"{n_codes} (limit {DECODE_FLIP_SHARE})")
    return free, pin, share


def _decode_int8_slots(torch, model, seed):
    """The frozen GPT through the slot loop (the slots phase's server: 8
    slots, chunk 64, a 768-column ring), f32 then int8 KV, on the churn
    trace's first DECODE_SLOT_REQUESTS requests: rows held to the slot-row
    rule (``_check_rows``), every step a replay with no wrapper launch,
    12 decode nodes in the graph, the captured step equal to the eager
    one.  Returns {kv: record}."""
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.text.generation import Generator
    cfg = model.config
    reqs = _churn(seed + 7, cfg.vocab_size, n=DECODE_SLOT_REQUESTS)
    oracle = Generator(model, seq_buckets=(128, 256, 512, SLOT_CACHE),
                       max_len=SLOT_CACHE)
    out = {}
    for kv in ("bf16", "int8"):
        where = f"decode_int8 slots kv={kv}"
        srv = _slot_server(torch, model, kv)
        try:
            rt = srv._models["gpt2"]
            step = rt._loop._step
            check(step.captured, f"{where}: the loop's step is not the "
                  "captured graph")
            fd.launch_counts(reset=True)
            r0 = step.replays
            served, run = _serve_churn(torch, srv, reqs)
            counts = fd.launch_counts()
            sl = run["stats"]["slot_loop"]
            check(step.replays - r0 == sl["steps"] > 0
                  and sum(counts.values()) == 0,
                  f"{where}: {step.replays - r0} replays for {sl['steps']} "
                  f"steps, wrapper launches {counts}")
            nodes, kernels = _graph_nodes(step._graph,
                                          "decode_cluster_kernel")
            check(nodes == {SLOTS * cfg.num_heads: cfg.num_layers},
                  f"{where}: graph decode nodes {nodes} of {len(kernels)} "
                  "kernel nodes")
        finally:
            srv.stop()
        equal, ties = _check_rows(torch, model, oracle, reqs, served, where,
                                  SLOT_TIE_SHARE["churn"])
        _step_compare(torch, rt.gen, kv)
        out[kv] = {"steps_replayed": sl["steps"], "chunks": sl["chunks"],
                   "decode_kernels_per_replay": sum(nodes.values()),
                   "graph_kernel_nodes": len(kernels),
                   "tok_per_s": run["tok_per_s"],
                   "ttft_p50_ms": sl["ttft_p50_ms"],
                   "rows_equal_batch1_generate": f"{equal}/{len(reqs)}",
                   "tokens_checked": sum(mn for _, mn in reqs),
                   **_tie_summary(ties), "captured_equals_eager": True}
        log("decode_int8", slots=kv, **out[kv])
        del rt, srv, step
    return out


def _decode_f32_kernels(torch, seed):
    """B3's f32 instance and B4 with an f32 query, at the served shape
    (B = 8, N = 12, cache 256, H = 64): against their plain versions over
    the kernels phase's four kinds of window (ATOL f32), then timed by
    graph replay over LAYERS_CACHES caches, full window, beside the plain
    versions, SDPA in f32 under the same window as an additive mask (B3)
    and the bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    B, N, S, H = 8, 12, 256, 64
    q = torch.randn(B, N, 1, H, generator=g, device="cuda")
    caches = [tuple(torch.randn(B, N, S, H, generator=g, device="cuda")
                    for _ in range(2)) for _ in range(LAYERS_CACHES)]
    quant = [quantize_kv_rows(k) + quantize_kv_rows(v) for k, v in caches]
    k, v = caches[0]
    k8, ks, v8, vs = quant[0]
    err = {"flash_decode": 0.0, "flash_decode_quant": 0.0}
    for kind in ("full", "ragged", "edge", "anywhere"):
        lo, hi = _windows(torch, kind, B, S, g)
        for name, got, want in (
                ("flash_decode", fd.flash_decode(q, k, v, lo, hi),
                 fd.flash_decode_plain(q, k, v, lo, hi)),
                ("flash_decode_quant",
                 fd.flash_decode_quant(q, k8, v8, ks, vs, lo, hi),
                 fd.flash_decode_quant_plain(q, k8, v8, ks, vs, lo, hi))):
            e = (got - want).abs().max().item()
            check(got.dtype == torch.float32 and got.shape == q.shape
                  and bool(torch.isfinite(got).all())
                  and e <= ATOL["float32"],
                  f"decode_int8: {name} f32 q {kind} windows: max abs err "
                  f"{e} > {ATOL['float32']}")
            err[name] = max(err[name], e)
    lo, hi = _windows(torch, "full", B, S, g)
    mask = torch.zeros(B, 1, 1, S, device="cuda").masked_fill_(
        (torch.arange(S, device="cuda") >= hi[:, None]).view(B, 1, 1, S),
        -1e30)
    n = len(caches)
    t = {"flash_decode": _graph_ms(torch, lambda i: fd.flash_decode(
            q, *caches[i % n], lo, hi), 2 * n),
         "flash_decode_plain": _graph_ms(torch, lambda i:
            fd.flash_decode_plain(q, *caches[i % n], lo, hi), 2 * n),
         "flash_decode_library": _graph_ms(torch, lambda i:
            F.scaled_dot_product_attention(q, *caches[i % n],
                                           attn_mask=mask), 2 * n),
         "flash_decode_quant": _graph_ms(torch, lambda i:
            fd.flash_decode_quant(q, quant[i % n][0], quant[i % n][2],
                                  quant[i % n][1], quant[i % n][3], lo, hi),
            2 * n),
         "flash_decode_quant_plain": _graph_ms(torch, lambda i:
            fd.flash_decode_quant_plain(q, quant[i % n][0], quant[i % n][2],
                                        quant[i % n][1], quant[i % n][3],
                                        lo, hi), 2 * n)}
    b3, b3_by, b3_bytes = _bound(B, N, H, lo, hi, "float32", 4, False)
    b4, b4_by, b4_bytes = _bound(B, N, H, lo, hi, "int8", 4, True)
    t.update(flash_decode_bound=b3, flash_decode_bound_by=b3_by,
             flash_decode_bytes=b3_bytes, flash_decode_quant_bound=b4,
             flash_decode_quant_bound_by=b4_by,
             flash_decode_quant_bytes=b4_bytes,
             flash_decode_err=err["flash_decode"],
             flash_decode_quant_err=err["flash_decode_quant"])
    log("decode_int8", timing=f"B={B} N={N} S={S} H={H} f32 q (f32 K/V; "
        f"int8 K/V for B4), full window, {n} caches rotated", ms=t)
    return t


def phase_decode_int8(torch, seed):
    """bench_decode on the port at its chip configuration: the bf16
    variant timed, then the int8 one (PTQ, freeze) through generate(),
    the decode server and the slot loop, with checks (a)-(f): batch rows
    = batch-1 generate() (f32 and int8 caches), every int8 product
    exact, the card against the CPU, served rows = batch-1 generate(),
    the slot loop's rows, replays and captured step, and B3 f32 / B4
    f32-query against their plain versions."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    from paddle_tpu_torch.quantization import PostTrainingQuantization, \
        freeze
    from paddle_tpu_torch.quantization.freeze import FrozenQuantizedLinear
    from paddle_tpu_torch.text.generation import Generator
    V, layers = DECODE_CFG["vocab_size"], DECODE_CFG["num_layers"]
    steps, batches = DECODE["steps"], DECODE["batches"]
    grid = dict(seq_buckets=DECODE["seq_buckets"], max_len=DECODE["max_len"])
    per_gen = layers * steps            # one-query launches a generate()
    bench_gens = (1 + DECODE["reps"]) * len(batches)
    seconds, launches = {}, {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    def counts_are(name, live, want):
        got = fd.launch_counts()
        check(got == {k: want if k == live else 0 for k in got},
              f"decode_int8 {name}: launches {got}, want {live}={want}")
        launches[name] = want

    f32 = _decode_gpt(torch, seed)
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_kv_cache_dtype": "bf16"})
        # bench's bf16 variant: amp.decorate of the same GPT (a second
        # one from the seed); the tied head follows the embedding
        bf16 = amp.decorate(_decode_gpt(torch, seed), level="O2",
                            dtype="bfloat16")
        check(bf16._lm_head.dtype == torch.bfloat16
              and bf16._lm_head.data_ptr() == bf16.wte.weight.data_ptr(),
              "decode_int8: amp.decorate cut the embedding off the head")
        fd.launch_counts(reset=True)
        bench = {"bf16": _decode_bench(torch, Generator(bf16, **grid),
                                       np.random.RandomState(0), V)[0]}
        counts_are("bf16_bench_generate", "flash_decode",
                   per_gen * bench_gens)
        del bf16
        lap("bf16_bench")
        # bench's int8 variant: one RandomState(0) draws the calibration
        # prompt, then each batch's prompts
        rng = np.random.RandomState(0)
        cal = torch.as_tensor(rng.randint(1, V, (batches[0],
                                                 DECODE["prompt"])),
                              device="cuda")
        PostTrainingQuantization(model=f32, data_loader=(
            (cal,) for _ in range(4)), batch_nums=4).quantize()
        model = freeze(f32)
        sites = [n for n, m in model.named_modules()
                 if isinstance(m, FrozenQuantizedLinear) and not m._dynamic]
        check(sites == [f"encoder.layers.{i}.{s}" for i in range(layers)
                        for s in DECODE_SITES]
              and isinstance(model.wte, torch.nn.Embedding),
              f"decode_int8: frozen static sites {sites}")
        lap("ptq_freeze")
        gen = Generator(model, **grid)
        # the main path's run: counts read from 0 just before it
        fd.launch_counts(reset=True)
        bench["int8"], runs = _decode_bench(torch, gen, rng, V)
        counts_are("int8_bench_generate", "flash_decode",
                   per_gen * bench_gens)
        lap("int8_bench")
        # where a frozen decode step's time goes: one-step decode() calls
        # of the batch-8 loop (f32 cache)
        P = gen.prefill_bucket(DECODE["prompt"])
        packed, start = gen.pack_prompts(list(runs[batches[-1]][0]), P)
        cache, logits0 = gen.prefill(packed, start,
                                     gen.cache_bucket(P, steps))
        profile = {"batch": batches[-1], **_step_profile(
            torch, lambda i: gen.decode(cache, logits0, start, P, 1),
            calls=8, ms_of={"int8_gemm_ms": r"i8|s8|imma|Imma"})}
        profile.pop("decode_by_launch")
        del cache, logits0
        log("decode_int8", profile=profile)
        lap("profile")
        # (d) the decode server on the serving phase's traffic; its
        # batch-1 generate() rows (f32 cache) are also (a)'s
        traffic, one = _traffic(seed, V), []
        served = _serve_once(torch, model, traffic, "bf16", GRID,
                             tag="decode_int8", oracle_rows=one)
        launches["server"] = served["launches"]["flash_decode"]
        lap("server")
        # (a) a batch-8 generate() of the traffic's first 8 prompts, each
        # row against its batch-1 generate(): (d)'s for the f32 cache,
        # new ones for the int8 cache
        eight, rows = traffic[:batches[-1]], Generator(
            model, seq_buckets=GRID["seq_buckets"], max_len=GRID["max_len"])
        fd.launch_counts(reset=True)
        toks8 = _decode_rows(rows, eight, one[:len(eight)], "f32 cache")
        counts_are("rows_f32_cache", "flash_decode", per_gen)
        fd.launch_counts(reset=True)
        flags.set_flags({"FLAGS_kv_cache_dtype": "int8"})
        one = [rows.generate(p[None, :], max_new_tokens=steps).cpu()
               .numpy()[0] for p in eight]
        toks8q = _decode_rows(rows, eight, one, "int8 cache")
        counts_are("rows_int8_cache", "flash_decode_quant",
                   per_gen * (1 + len(eight)))
        flags.set_flags({"FLAGS_kv_cache_dtype": "bf16"})
        lap("rows")
        # (b) every int8 product exact; (c) the card against the CPU
        products = _decode_int8_products(torch, model, gen, runs)
        lap("products")
        card_cpu = _decode_card_vs_cpu(torch, model, gen, runs)
        lap("card_vs_cpu")
        # (e) the slot loop
        slots = _decode_int8_slots(torch, model, seed)
        lap("slots")
    finally:
        flags.flags_restore(snap)
    # (f) B3 f32 and B4 f32-query at the served shape
    kern = _decode_f32_kernels(torch, seed)
    lap("kernels")
    b = f"batch{batches[-1]}"
    speedup = round(bench["int8"][b]["tok_per_s_decode"]
                    / bench["bf16"][b]["tok_per_s_decode"], 3)
    out = {"bench": bench, "int8_decode_speedup_maxbatch": speedup,
           "launches": launches, "products": products,
           "card_vs_cpu_free_rel_err": card_cpu[0],
           "card_vs_cpu_pinned_rel_err": card_cpu[1],
           "card_vs_cpu_pinned_rtol": DECODE_PINNED_RTOL,
           "cpu_codes_a_step_apart_share": card_cpu[2],
           "int8_cache_tokens_equal_f32_cache": round(
               float((toks8q == toks8).mean()), 4),
           "server": {k: served[k] for k in (
               "decode_tok_per_s", "ttft_p50_ms", "ttft_p99_ms", "batches",
               "rows_equal_batch1_generate")},
           "slots": slots, "kernels": kern, "profile": profile,
           "seconds": seconds}
    log("decode_int8", **{k: v for k, v in out.items()
                          if k not in ("slots", "kernels", "profile")})
    return out


# -- phase 8: flash attention kernels (B1, B2) -------------------------------

# (B, N, Sq, Sk, H, causal, bias): H 64/128/256; S 128, 256 and 200 (off
# the 64-row tile); causal with Sq = Sk and with Sq = 128 < Sk = 384; the
# three bias shapes "b11s" (B, 1, 1, Sk), "11ss" (1, 1, Sq, Sk) and
# "bnss" (B, N, Sq, Sk); then the Transformer's shapes: S = 64 (below
# the 128-row tile), cross-attention with Sq != Sk either way round,
# not causal, under a source-padding bias, and "square" (1, 1, Sq, Sk),
# generate_square_subsequent_mask's 0 / -1e30
FA_CHECKS = (
    (2, 4, 128, 128, 64, False, None),
    (2, 4, 256, 256, 128, False, "b11s"),
    (2, 4, 200, 200, 256, False, "11ss"),
    (2, 4, 128, 128, 64, True, None),
    (2, 4, 200, 200, 128, True, "bnss"),
    (2, 4, 128, 384, 64, True, "b11s"),
    (2, 4, 256, 256, 256, True, "bnss"),
    (2, 4, 128, 384, 128, False, "11ss"),
    (2, 4, 64, 64, 64, False, None),
    (2, 4, 96, 40, 64, False, "b11s"),
    (2, 4, 40, 96, 64, False, None),
    (2, 4, 64, 64, 64, False, "square"),
)
# kernel against its plain version on the same inputs, per output, as a
# share of max(1, the output's largest |value|):
#  * f32: both sum in f32 in other orders over <= 384 terms: ~1e-6;
#  * bf16: the plain version on the same bf16 tensors rounds p, ds and
#    the outputs at the kernels' points; they differ where summation
#    order moves a value across a bf16 rounding boundary, one bf16 step
#    (2^-8 of the value) per output at most: 2^-6 leaves a margin of 4.
# bf16 forward against the f32 plain version on the same inputs: 1e-2,
# half a bf16 step at |o| < 4 (ATOL above).
FA_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
# the BERT-base training shape
FA_TIME = dict(B=64, N=12, S=128, H=64)
# the Transformer-big training shape (bench.py:300-303): every one of its
# 18 attentions a step (6 encoder self, 6 decoder self, 6 cross) is
# B = 64, N = 16, Sq = Sk = 64, H = 64, without a mask
FA_SEQ2SEQ = dict(B=64, N=16, S=64, H=64)
FA_ROTATE = 4           # input sets rotated through when timing (> L2)


def _fa_inputs(torch, g, B, N, Sq, Sk, H, bias, dtype, layout="bnsh"):
    """q, k, v, dO and the bias.  ``layout`` "bnsh" makes contiguous
    (B, N, S, H) tensors; "bsnh" makes them as the model's attention
    does: ``x.view(B, S, N, H).transpose(1, 2)`` of a (B, S, N*H)
    projection, strided views the wrappers pass to the kernels uncopied.
    ``bias`` "pad" is BERT's padding mask: (B, 1, 1, Sk), 0 over each
    row's first 64..Sk keys and -1e4 after; "square" is the
    Transformer's causal target mask (1, 1, Sq, Sk) of 0 and -1e30."""
    def mk(S):
        if layout == "bnsh":
            return torch.randn(B, N, S, H, generator=g, device="cuda") \
                .to(dtype)
        return torch.randn(B, S, N * H, generator=g, device="cuda") \
            .to(dtype).view(B, S, N, H).transpose(1, 2)
    q, k, v, do = mk(Sq), mk(Sk), mk(Sk), mk(Sq)
    if bias == "pad":
        lens = torch.randint(Sk // 2, Sk + 1, (B,), generator=g,
                             device="cuda")
        return q, k, v, do, torch.where(
            torch.arange(Sk, device="cuda")[None] < lens[:, None], 0.0,
            -1e4)[:, None, None, :]
    if bias == "square":
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device="cuda").tril()
        return q, k, v, do, torch.zeros(1, 1, Sq, Sk, device="cuda") \
            .masked_fill_(~keep, -1e30)
    shape = {None: None, "b11s": (B, 1, 1, Sk), "11ss": (1, 1, Sq, Sk),
             "bnss": (B, N, Sq, Sk)}[bias]
    b = None
    if shape is not None:
        b = torch.where(torch.rand(*shape, generator=g, device="cuda") < 0.2,
                        -1e4, 0.0)
    return q, k, v, do, b


def _share_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


def _fa_bound(kind, B, N, Sq, Sk, H, elt, bias_bytes):
    """Least time of one call (ms) at these inputs: q, k, v (and dO, lse,
    dd) read once, the outputs written once, over HBM bandwidth; against
    the products the kernel does (QK^T and PV; the backward recomputes
    QK^T and does dO V^T, then dS K, or dS^T Q and P^T dO) over the
    peak rate of the instruction that does them: bf16's on the tensor
    cores; the f32 forward's TF32 on the tensor cores (its split into
    three TF32 products for each is the kernel's overhead, not the
    function's work, and is not charged); the f32 backward's f32 FMA
    rate.  Non-causal pairs: the training path's case."""
    bnh = B * N * H
    rows = B * N * Sq * 4                     # one f32 per query row
    if kind == "fwd":
        nbytes = (2 * Sq + 2 * Sk) * bnh * elt + rows
        ops = 4 * B * N * Sq * Sk * H
    elif kind == "dq":
        nbytes = (3 * Sq + 2 * Sk) * bnh * elt + 2 * rows
        ops = 6 * B * N * Sq * Sk * H
    else:
        nbytes = (2 * Sq + 4 * Sk) * bnh * elt + 2 * rows
        ops = 8 * B * N * Sq * Sk * H
    nbytes += bias_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = ("bfloat16" if elt == 2 else "tfloat32" if kind == "fwd"
            else "float32")
    t_ops = ops / PEAK_OPS_PER_S[rate] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _fa_compare(torch, fa, inputs, causal, where, worst):
    """Each kernel (forward, dQ, dK/dV) against its plain version on
    ``inputs`` = (q, k, v, dO, bias); the backward kernels take the plain
    forward's lse so that only their own error shows.  Raises on a
    disagreement beyond FA_RTOL; records the max abs error in ``worst``."""
    q, k, v, do, b = inputs
    dt = q.dtype
    name = str(dt).split(".")[-1]
    o, lse = fa.flash_fwd(q, k, v, b, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, b, causal)
    dd = fa.flash_dd(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, b, lse_ref, do, dd, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, b, lse_ref, do, dd, causal)
    want = fa.flash_bwd_reference(q, k, v, b, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    where = f"{where} {name}"
    outs = {"fwd": [(o, o_ref)], "dq": [(dq, want[0])],
            "dkv": [(dk, want[1]), (dv, want[2])]}
    for kern, pairs in outs.items():
        for got, ref in pairs:
            check(got.shape == ref.shape and got.dtype == dt,
                  f"{where}: {kern} returned {got.shape} {got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"{where}: {kern} non-finite")
            err = _share_err(got, ref)
            check(err <= FA_RTOL[name], f"{where}: {kern} error "
                  f"{err} of max(1, max|ref|) > {FA_RTOL[name]}")
            worst[kern] = max(worst[kern], (got.float() - ref.float())
                              .abs().max().item())
    lse_err = (lse - lse_ref).abs().max().item()
    check(lse_err <= 1e-4, f"{where}: lse differs by {lse_err}")
    if dt == torch.bfloat16:
        o32, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(), b,
                                        causal)
        err = (o.float() - o32).abs().max().item()
        check(err <= ATOL["bfloat16"],
              f"{where}: bf16 forward vs f32 plain {err}")


def _fa_repeat(torch, fa, inputs, where):
    """The three kernels twice on one input must give the same bits: one
    writer per output, fixed-order sums, no atomics."""
    q, k, v, do, b = inputs
    runs = []
    for _ in range(2):
        o, lse = fa.flash_fwd(q, k, v, b)
        dd = fa.flash_dd(o, do)
        runs.append((o, lse, fa.flash_bwd_dq(q, k, v, b, lse, do, dd),
                     *fa.flash_bwd_dkv(q, k, v, b, lse, do, dd)))
    torch.cuda.synchronize()
    for name, x, y in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        check(torch.equal(x, y), f"{where}: {name} differs between two "
              "launches on one input")


def _fa_model_checks(torch, fa, g, shape, bias, worst):
    """The three kernels at a model's training shape, on the strided
    views the model passes: against their plain versions in f32 and
    bf16, and twice on one bf16 input (the same bits)."""
    B, N, S, H = (shape[x] for x in "BNSH")
    where = f"B={B} N={N} S={S} H={H} bias={bias} layout=bsnh"
    for dt in (torch.float32, torch.bfloat16):
        inputs = _fa_inputs(torch, g, B, N, S, S, H, bias, dt, "bsnh")
        check(not inputs[0].is_contiguous() and all(
            fa._strided(t, dt, "") is t for t in inputs[:4]),
            f"{where}: the inputs are not the model's strided views "
            "or the wrapper would copy them")
        _fa_compare(torch, fa, inputs, False, where, worst)
        if dt == torch.bfloat16:
            _fa_repeat(torch, fa, inputs, f"{where} bfloat16")
        del inputs
    log("fa_kernels", check=where, dtypes="float32,bfloat16",
        uncopied_views=True, bf16_repeats_bit_for_bit=True, ok=True)


def _fa_timing(torch, fa, g, shape, bias):
    """Device ms of a call of each kernel at a model's training shape in
    bf16 (the model's strided views, FA_ROTATE input sets rotated: > 50
    MB of L2 between reuses), beside its plain version, its bound, and
    SDPA with the same mask: its forward, and the backward of that one
    call, which computes dQ, dK and dV together."""
    import torch.nn.functional as F
    B, N, S, H = (shape[x] for x in "BNSH")
    sets = []
    for _ in range(FA_ROTATE):
        q, k, v, do, b = _fa_inputs(torch, g, B, N, S, S, H, bias,
                                    torch.bfloat16, "bsnh")
        o, lse = fa.flash_fwd_reference(q, k, v, b)
        sets.append((q, k, v, do, b, lse, fa.flash_dd(o, do)))
    n = len(sets)
    kern = {
        "fwd": lambda i: fa.flash_fwd(*sets[i % n][:3], sets[i % n][4]),
        "dq": lambda i: fa.flash_bwd_dq(
            *sets[i % n][:3], sets[i % n][4], sets[i % n][5],
            sets[i % n][3], sets[i % n][6]),
        "dkv": lambda i: fa.flash_bwd_dkv(
            *sets[i % n][:3], sets[i % n][4], sets[i % n][5],
            sets[i % n][3], sets[i % n][6]),
    }
    plain = {
        "fwd": lambda i: fa.flash_fwd_reference(*sets[i % n][:3],
                                                sets[i % n][4]),
        "dq": lambda i: fa._bwd_plain(
            *sets[i % n][:3], sets[i % n][4], sets[i % n][5],
            sets[i % n][3], sets[i % n][6], False, None, "q"),
        "dkv": lambda i: fa._bwd_plain(
            *sets[i % n][:3], sets[i % n][4], sets[i % n][5],
            sets[i % n][3], sets[i % n][6], False, None, "kv"),
    }
    t = {}
    bias_bytes = 0 if sets[0][4] is None else sets[0][4].numel() * 4
    for key in ("fwd", "dq", "dkv"):
        t[key] = _graph_ms(torch, kern[key], 2 * n)
        t[key + "_plain"] = _graph_ms(torch, plain[key], 2 * n)
        bound, by, nbytes, ops = _fa_bound(key, B, N, S, S, H, 2,
                                           bias_bytes)
        t.update({key + "_bound": bound, key + "_bound_by": by,
                  key + "_bytes": nbytes, key + "_ops": ops})
    mask = [None if x[4] is None else x[4].to(torch.bfloat16)
            for x in sets]
    t["sdpa_fwd"] = _graph_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            *sets[i % n][:3], attn_mask=mask[i % n]), 2 * n)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [[x.detach().requires_grad_() for x in st[:3]]
                  for st in sets]
        outs = [F.scaled_dot_product_attention(*lv, attn_mask=m)
                for lv, m in zip(leaves, mask)]
    t["sdpa_bwd"] = _graph_ms(torch, lambda i: torch.autograd.grad(
        outs[i % n], leaves[i % n], sets[i % n][3], retain_graph=True),
        2 * n, stream=stream)
    t["sdpa_fwd_bwd"] = _graph_ms(torch, lambda i: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves[i % n],
                                       attn_mask=mask[i % n]),
        leaves[i % n], sets[i % n][3]), 2 * n)
    log("fa_kernels", timing=f"B={B} N={N} S={S} H={H} bf16, "
        f"{'padding bias (B,1,1,S)' if bias else 'no bias'}, "
        f"model layout, {n} input sets rotated", ms=t)
    return t


def phase_fa_kernels(torch, seed):
    """B1, B2-dQ and B2-dK/dV against their plain versions over
    FA_CHECKS in f32 and bf16, then at the BERT-base and Transformer-big
    training shapes in the models' layout: checked in f32 and bf16, and
    timed in bf16.  Returns (the worst errors, BERT's timings with its
    padding bias, {"worst", "t"} at the Transformer-big shape)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for B, N, Sq, Sk, H, causal, bias in FA_CHECKS:
        where = f"B={B} N={N} Sq={Sq} Sk={Sk} H={H} causal={causal} " \
            f"bias={bias}"
        for dt in (torch.float32, torch.bfloat16):
            _fa_compare(torch, fa, _fa_inputs(torch, g, B, N, Sq, Sk, H,
                                              bias, dt), causal, where, worst)
        log("fa_kernels", check=where, dtypes="float32,bfloat16", ok=True)
    # q, k, v and dO are transposed views of (B, S, N*H) projections,
    # read by the kernels through their strides, non-causal; BERT with
    # and without its padding bias, the Transformer without a mask
    timings = {}
    for padded in (False, True):
        bias = "pad" if padded else None
        _fa_model_checks(torch, fa, g, FA_TIME, bias, worst)
        timings[padded] = _fa_timing(torch, fa, g, FA_TIME, bias)
    s2s_worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    _fa_model_checks(torch, fa, g, FA_SEQ2SEQ, None, s2s_worst)
    s2s = {"worst": s2s_worst,
           "t": _fa_timing(torch, fa, g, FA_SEQ2SEQ, None)}
    for k, e in s2s_worst.items():
        worst[k] = max(worst[k], e)
    log("fa_kernels", max_abs_err=worst, seq2seq_max_abs_err=s2s_worst,
        rtol=FA_RTOL)
    return worst, timings[True], s2s


# -- phase 8b: dense serving of bench_serving's bf16 models -----------------

# bench.py's bench_serving on the accelerator (bench.py:824-880, 764-781,
# 692-728): lenet (vision LeNet, [None, 1, 28, 28] f32), resnet_block
# (bench.py's Block at ch 64, hw 56: [None, 64, 56, 56] f32) and bert
# (BertModel(BertConfig.base()), [None, 128] int32 ids), each cast to
# bf16 by amp.decorate(level="O2") behind bench.py's _BF16Serve; buckets
# 1..16, two workers; 8 clients sending 1-4 rows a request for 8 s,
# seeded inputs; p99 against the JAX package's SLOs (bench.py:688)
DENSE = dict(seq=128, ch=64, hw=56, buckets=(1, 2, 4, 8, 16), workers=2,
             clients=8, max_rows=4, seconds=8.0)
DENSE_MODELS = ("lenet", "resnet_block", "bert")
DENSE_SLO_P99_MS = {"lenet": 50.0, "resnet_block": 100.0, "bert": 250.0}
DENSE_REPLAYS = 20      # bucket-16 replays traced (BERT) or timed
# bert_int8's replay holds ~1,100 kernel nodes, 7x bf16 BERT's: 5 traced
# replays give the same per-replay figures at a quarter of the records
DENSE_TRACE_REPLAYS_INT8 = 5
# a served result against the eager decorated model on the same padded
# bucket: both run the same kernels (B1, cuDNN's convolutions, the same
# GEMMs) at the same shapes, so they should agree bit for bit; the limit
# is B1's bf16 one (FA_RTOL) as a share of max(1, max |ref|) of each
# output
DENSE_RTOL = 2.0 ** -6
# bench_serving's int8 half (bench.py:743-760): the same three models in
# f32, PTQ-calibrated (abs_max) over 4 batches of one RandomState(0)
# bucket-1 input, FLAGS_use_int8_inference on, exported frozen by
# export_for_serving(int8=True); the frozen sites each program must hold,
# one aten._int_mm node each: LeNet's 2 convs and 3 linears, the block's
# 2 convs, BERT-base's 6 projections a layer and the pooler
DENSE_INT8_SITES = {"lenet": 5, "resnet_block": 2, "bert": 73}
# no float product may stand in for a frozen site
FLOAT_PRODUCTS = re.compile(
    r"aten\.(mm|addmm|bmm|baddbmm|matmul|linear|convolution|_convolution|"
    r"conv2d|cudnn_convolution)\b")
# a frozen model on the card against the same frozen state on the CPU
# (TF32 off), max |diff| over max |ref|: the integer products are exact
# on both, but the f32 epilogues and BN round an ulp apart (the card
# fuses a multiply and an add), and an input that then lands on the
# other side of a half step is coded one int8 step apart at the next
# site.  Readings on an H100: LeNet 0, the block 1.1e-3 (one such flip
# into its second conv); the limit is 14x that
INT8_CARD_CPU_RTOL = 2.0 ** -6


def bench_block(ch, **kw):
    """bench.py's Block (bench.py:843-856) on the port's ``nn``: a 3x3
    conv without bias, BatchNorm2D and ReLU, twice, the input added
    before the second ReLU.  ``kw`` (``device=``) goes to every conv and
    BN; without it they land on CUDA, as bench.py's do on its chip."""
    from paddle_tpu_torch import nn

    class Block(nn.Layer):
        """One residual conv-BN-ReLU pair (the fused-conv stage)."""

        def __init__(self):
            super().__init__()
            self.c1 = nn.Conv2D(ch, ch, 3, padding=1, bias_attr=False, **kw)
            self.b1 = nn.BatchNorm2D(ch, **kw)
            self.c2 = nn.Conv2D(ch, ch, 3, padding=1, bias_attr=False, **kw)
            self.b2 = nn.BatchNorm2D(ch, **kw)
            self.relu = nn.ReLU()

        def forward(self, x):
            h = self.relu(self.b1(self.c1(x)))
            return self.relu(self.b2(self.c2(h)) + x)

    return Block()


def bf16_serve(inner):
    """bench.py's _BF16Serve (bench.py:769-781) on the port, in eval
    mode: float inputs cast to bf16 and outputs to f32 by
    ``paddle.cast``, int ids passed through."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    class _BF16Serve(nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, *xs):
            xs = [paddle.cast(x, "bfloat16")
                  if "float" in str(x.dtype) else x for x in xs]
            out = self.inner(*xs)
            if isinstance(out, (list, tuple)):
                return [paddle.cast(o, "float32") for o in out]
            return paddle.cast(out, "float32")

    model = _BF16Serve()
    model.eval()
    return model


def _bert_base(torch, seed):
    """BertModel(BertConfig.base()) on the card with random weights from
    ``seed`` (BertForPretraining.init_weights' scheme)."""
    from paddle_tpu_torch.text.models import BertConfig
    from paddle_tpu_torch.text.models.bert import BertModel
    cfg = BertConfig.base()
    model = BertModel(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Linear, torch.nn.Embedding)):
                m.weight.normal_(0.0, cfg.initializer_range, generator=g)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model, cfg


def _dense_base(torch, name, seed):
    """bench_serving's model ``name`` built through the port's public API
    as bench.py builds it (LeNet(), Block, BertModel) on the card, in f32
    with random weights from ``seed``, in eval mode: (model, input spec,
    each output's shape a row, vocabulary or None, B1 operators the
    program must hold)."""
    import paddle_tpu_torch as paddle
    paddle.seed(seed)
    torch.manual_seed(seed)
    vocab, b1 = None, 0
    if name == "lenet":
        inner = paddle.vision.models.LeNet()
        spec, shapes = ([None, 1, 28, 28], "float32"), [(10,)]
    elif name == "resnet_block":
        c, hw = DENSE["ch"], DENSE["hw"]
        inner = bench_block(c)
        spec, shapes = ([None, c, hw, hw], "float32"), [(c, hw, hw)]
    else:
        inner, cfg = _bert_base(torch, seed)
        spec = ([None, DENSE["seq"]], "int32")
        shapes = [(DENSE["seq"], cfg.hidden_size), (cfg.hidden_size,)]
        vocab, b1 = cfg.vocab_size, cfg.num_hidden_layers
    check(all(p.device.type == "cuda" for p in inner.parameters())
          and all(b.device.type == "cuda" for b in inner.buffers()),
          f"dense {name}: a parameter or buffer is off the card")
    inner.eval()
    return inner, spec, shapes, vocab, b1


def _dense_model(torch, name, seed):
    """bench_serving's bf16 variant of ``name``: the f32 model of
    ``_dense_base`` cast to bf16 by paddle.amp.decorate(level="O2")
    behind bf16_serve: (served model, input spec, output shapes a row,
    vocabulary or None, B1 operators)."""
    import paddle_tpu_torch as paddle
    inner, spec, shapes, vocab, b1 = _dense_base(torch, name, seed)
    paddle.amp.decorate(models=inner, level="O2", dtype="bfloat16")
    check(all(p.dtype == torch.bfloat16 for p in inner.parameters())
          and all(b.dtype in (torch.float32, torch.int64, torch.int32)
                  for b in inner.buffers()),
          f"dense {name}: amp.decorate O2 left a parameter outside bf16 "
          "or cast a buffer")
    return bf16_serve(inner), spec, shapes, vocab, b1


def _dense_int8_model(torch, name, seed):
    """bench_serving's int8 variant of ``name`` (bench.py:743-760): the
    f32 model of ``_dense_base``, PostTrainingQuantization over 4
    batches of one RandomState(0) bucket-1 input (abs_max; weights per
    channel); export_for_serving(int8=True) freezes it.  Returns (the
    quantized model, an f32 copy taken before calibration, input spec,
    output shapes a row, vocabulary or None, B1 operators)."""
    import copy
    from paddle_tpu_torch.quantization import PostTrainingQuantization
    model, spec, shapes, vocab, b1 = _dense_base(torch, name, seed)
    f32 = copy.deepcopy(model)
    cal = torch.from_numpy(_dense_input(np.random.RandomState(0), spec,
                                        DENSE["buckets"][0], vocab)).cuda()
    PostTrainingQuantization(model=model, data_loader=(
        (cal,) for _ in range(4)), batch_nums=4).quantize()
    return model, f32, spec, shapes, vocab, b1


def _dense_input(rng, spec, rows, vocab):
    """bench.py's request maker (_serving_traffic's gen): ids drawn
    below the vocabulary, floats N(0, 1)."""
    shape, dtype = spec
    s = (rows,) + tuple(shape[1:])
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.randint(0, vocab or 100, s).astype(dtype)
    return rng.randn(*s).astype(dtype)


def _dense_traffic(srv, name, spec, vocab, seed):
    """bench.py's _serving_traffic: DENSE["clients"] closed-loop clients,
    each sending requests of 1..max_rows rows for DENSE["seconds"];
    returns (requests, errors), a request being (input, outputs, bucket,
    batch rows)."""
    import threading
    done, errors = [], []
    lock = threading.Lock()
    deadline = time.perf_counter() + DENSE["seconds"]

    def client(i):
        rng = np.random.RandomState(seed + i)
        mine = []
        while time.perf_counter() < deadline:
            rows = int(rng.randint(1, DENSE["max_rows"] + 1))
            x = _dense_input(rng, spec, rows, vocab)
            try:
                fut = srv.submit(name, [x])
                out = fut.result(timeout=60)
            except Exception as e:   # noqa: BLE001 — recorded per client
                errors.append(f"client{i}: {type(e).__name__}: {e}")
                return
            mine.append((x, out, fut.bucket, fut.batch_rows))
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(DENSE["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return done, errors


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _reference_graph(torch, model, b, spec):
    """The eager decorated model's forward at bucket ``b`` captured as one
    CUDA graph: (input buffer, outputs, graph).  Replaying it runs the
    eager forward's kernels on the buffer's rows; ``_dense_check`` holds
    its first replay a bucket to the eager forward bit for bit."""
    shape, dtype = spec
    x = torch.zeros((b,) + tuple(shape[1:]), device="cuda",
                    dtype=getattr(torch, dtype))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        for _ in range(2):
            model(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        outs = _outputs(model(x))
    return x, outs, graph


def _dense_check(torch, name, model, done, spec, shapes, rtol=DENSE_RTOL):
    """Every served result against the eager decorated model on its own
    rows at the bucket it rode (requests of one bucket packed together,
    zero rows padding the last pass), compared on the card with one read
    back at the end: rows exact (no padding in a result), and each output
    within ``rtol`` of max(1, max |ref|) over the request's rows.  The
    reference passes replay the eager forward captured once a bucket,
    whose first pass must equal the eager forward bit for bit (the eager
    passes took ~17 s of BERT's phase).  Returns (worst share, requests
    bit-equal)."""
    passes = []          # (requests, per output: [rows] diff, [rows] |ref|)
    by_bucket = {}
    for r in done:
        by_bucket.setdefault(r[2], []).append(r)
    for b, reqs in sorted(by_bucket.items()):
        buf, ref, graph = _reference_graph(torch, model, b, spec)
        first = True
        i = 0
        while i < len(reqs):
            group, rows = [], 0
            while i < len(reqs) and rows + reqs[i][0].shape[0] <= b:
                group.append(reqs[i])
                rows += reqs[i][0].shape[0]
                i += 1
            for x, out, _, _ in group:
                n = x.shape[0]
                check([o.shape for o in out] == [(n,) + s for s in shapes],
                      f"dense {name}: a {n}-row request got "
                      f"{[o.shape for o in out]}")
            xs = np.zeros(tuple(buf.shape), group[0][0].dtype)
            xs[:rows] = np.concatenate([g[0] for g in group])
            buf.copy_(torch.from_numpy(xs))
            graph.replay()
            if first:
                with torch.no_grad():
                    eager = _outputs(model(buf))
                check(all(torch.equal(x, y) for x, y in zip(ref, eager)),
                      f"dense {name}: the captured reference at bucket {b} "
                      "differs from the eager forward")
                first = False
            stats = []
            for k, want in enumerate(ref):
                want = want[:rows].reshape(rows, -1)
                got = torch.from_numpy(np.concatenate(
                    [g[1][k] for g in group])).to(want.device).reshape(
                        rows, -1)
                # a non-finite served value makes its row's diff NaN
                stats.append(((got - want).abs().amax(1),
                              want.abs().amax(1)))
            passes.append((group, stats))
    nout = len(shapes)
    diffs = torch.stack([torch.cat([st[k][0] for _, st in passes])
                         for k in range(nout)]).cpu().numpy()
    scales = torch.stack([torch.cat([st[k][1] for _, st in passes])
                          for k in range(nout)]).cpu().numpy()
    worst, equal, off = 0.0, 0, 0
    for group, _ in passes:
        for g in group:
            n = g[0].shape[0]
            err = max(float(diffs[k, off:off + n].max()
                            / max(1.0, float(scales[k, off:off + n].max())))
                      for k in range(nout))
            check(err <= rtol, f"dense {name}: served != eager at "
                  f"bucket {g[2]}: {err} of max(1, max |ref|)")
            worst = max(worst, err)
            equal += err == 0.0
            off += n
    return worst, equal


# kernels of a library's attention (ATen's flash and memory-efficient
# SDPA, cuDNN's), by name; B1 is tc::fwd_tc_kernel
LIBRARY_ATTENTION = re.compile(r"flash|fmha|sdpa|attention|efficient", re.I)


# B1's forward kernels by (mangled) name in a graph and by (demangled)
# name in a trace: bf16 runs tc::fwd_tc_kernel, f32 tf::fwd_tf32_kernel
B1_NODE = {"bfloat16": "fwd_tc_kernel", "float32": "fwd_tf32_kernel"}
B1_RECORD = {"bfloat16": "fwd_tc_kernel<", "float32": "fwd_tf32_kernel<"}


def _dense_graphs(name, rt, layers, b1_dtype="bfloat16"):
    """Each bucket graph's kernel nodes (``_graph_nodes``): ``layers`` B1
    forward nodes of ``b1_dtype`` (12 for BERT-base, none for LeNet and
    the block) and no library attention node, so a replay launches B1
    ``layers`` times.  Returns {bucket: kernel nodes}."""
    out = {}
    match = B1_NODE[b1_dtype]
    for b, ex in sorted(rt.executables.items()):
        nodes, kernels = _graph_nodes(ex.graph, match)
        library = sorted({n for n, _ in kernels if LIBRARY_ATTENTION.search(n)
                          and match not in n})
        check(sum(nodes.values()) == layers and not library,
              f"dense {name}: bucket {b}'s graph holds B1 nodes {nodes} "
              f"(want {layers}) and library attention nodes {library}")
        out[b] = {"b1_nodes": nodes, "kernel_nodes": len(kernels)}
    return out


def _dense_trace(torch, graph, nodes, b1_dtype="bfloat16",
                 replays=DENSE_REPLAYS):
    """``replays`` replays of a captured bucket graph under
    torch.profiler: one graph launch a replay, showing the graph's B1
    nodes ``nodes`` (of ``b1_dtype``) run (``_traced_replays``), and the
    device time a replay and its top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy > 0, "dense: the traced replays show no device time")
    whole = _traced_replays(
        _records_by_launch(_chrome_events(prof), B1_RECORD[b1_dtype]),
        nodes, replays, "dense bucket graph")
    b1_ms = sum(e.self_device_time_total for e in kernels
                if B1_RECORD[b1_dtype] in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"traced_replays_whole": whole,
            "kernel_records_per_replay": sum(e.count for e in kernels)
            / replays,
            "device_ms_per_replay": round(busy / replays, 4),
            "b1_ms_per_replay": round(b1_ms / replays, 4),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": round(e.self_device_time_total / 1e3, 4)}
                            for e in top]}


def _replay_ms(torch, graph):
    """Device ms of one replay of a captured bucket graph: DENSE_REPLAYS
    replays between two CUDA events, best of 3."""
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(DENSE_REPLAYS):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / DENSE_REPLAYS)
    return min(times)


def _dense_b1_timing(torch, seed, worst, dtype="bfloat16"):
    """B1 at the served shape (B = 16, N = 12, S = 128, H = 64, no bias,
    the model's strided views) in ``dtype``: bf16 in the bf16 BERT's
    program, f32 in the int8 one's (its float layers stay f32).  Checked
    against its plain version, then timed by graph replay beside the
    plain version, SDPA and the bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    B, N, S, H = DENSE["buckets"][-1], 12, DENSE["seq"], 64
    sets = [_fa_inputs(torch, g, B, N, S, S, H, None, getattr(torch, dtype),
                       "bsnh")[:3] for _ in range(FA_ROTATE)]
    o, _ = fa.flash_fwd(*sets[0])
    o_ref, _ = fa.flash_fwd_reference(*sets[0])
    torch.cuda.synchronize()
    err = _share_err(o, o_ref)
    check(err <= FA_RTOL[dtype], f"dense B1 shape ({dtype}): error {err}")
    worst["fwd_served" + ("_f32" if dtype == "float32" else "")] = \
        (o.float() - o_ref.float()).abs().max().item()
    n = len(sets)
    bound, by, nbytes, ops = _fa_bound("fwd", B, N, S, S, H,
                                       2 if dtype == "bfloat16" else 4, 0)
    return {"ms": _graph_ms(torch, lambda i: fa.flash_fwd(*sets[i % n]),
                            2 * n),
            "plain_ms": _graph_ms(torch, lambda i: fa.flash_fwd_reference(
                *sets[i % n]), 2 * n),
            "library_ms": _graph_ms(
                torch, lambda i: F.scaled_dot_product_attention(
                    *sets[i % n]), 2 * n),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "ops": ops}


def _port_launches(reset=False):
    """Every hand-written kernel wrapper's launch count (B1/B2, B3/B4,
    B5/B6, B7), reset to 0 with ``reset``."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    return {**_fa_counts(fa, reset), **fd.launch_counts(reset),
            **_fused_counts(reset)}


def _int8_products(torch, name, model, spec, vocab, seed):
    """Each frozen site's integer product on the card against the exact
    one on the CPU, on the codes and at the shapes of the main path: an
    eager forward of the frozen model at buckets 1 and 16 records every
    ``ops.int8.int8_mm`` call (its padded operands' source rows and
    weight, and its int32 result).  The CPU product is taken in f64:
    each partial sum is an integer below 2^53 (|code| <= 128, K <= 3072),
    so it is exact, the int64 product.  Returns {(M, K, N): count}."""
    from paddle_tpu_torch.ops import int8 as I8
    seen, real = [], I8.int8_mm

    def recording(a, w):
        out = real(a, w)
        seen.append((a, w, out))
        return out

    rng = np.random.RandomState(seed + 7)
    I8.int8_mm = recording
    try:
        with torch.no_grad():
            for b in (DENSE["buckets"][0], DENSE["buckets"][-1]):
                model(torch.from_numpy(_dense_input(rng, spec, b, vocab))
                      .cuda())
    finally:
        I8.int8_mm = real
    sites = DENSE_INT8_SITES[name]
    check(len(seen) == 2 * sites, f"dense {name}_int8: {len(seen)} int8 "
          f"products in two forwards, want {2 * sites}")
    shapes = {}
    for a, w, out in seen:
        want = (a.cpu().double() @ w.cpu().double().t()).long()
        check(out.is_cuda and out.dtype == torch.int32
              and torch.equal(out.cpu().long(), want),
              f"dense {name}_int8: the card's int8 product at "
              f"{tuple(a.shape)} x {tuple(w.shape)} differs from the "
              "exact one")
        key = f"{a.shape[0]}x{a.shape[1]}x{w.shape[0]}"
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def _int8_readings(torch, name, model, f32, spec, vocab, seed):
    """At one bucket-16 input: the frozen model on the card against a copy
    on the CPU (LeNet and the block; TF32 off), max |diff| / max |cpu|,
    held to INT8_CARD_CPU_RTOL; and the quantization's cost, max |int8 -
    f32| / max |f32| against the f32 model before calibration, reported
    only.  Returns both (the first None for BERT)."""
    import copy
    x = torch.from_numpy(_dense_input(np.random.RandomState(seed + 9), spec,
                                      DENSE["buckets"][-1], vocab)).cuda()
    with torch.no_grad():
        got, ref = _outputs(model(x)), _outputs(f32(x))
        cost = max(float((g - r).abs().max() / r.abs().max())
                   for g, r in zip(got, ref))
        card_cpu = None
        if name != "bert":
            cpu = copy.deepcopy(model).to("cpu")
            want = _outputs(cpu(x.cpu()))
            card_cpu = max(float((g.cpu() - w).abs().max() / w.abs().max())
                           for g, w in zip(got, want))
            check(card_cpu <= INT8_CARD_CPU_RTOL,
                  f"dense {name}_int8: the card against the CPU on one "
                  f"frozen state: {card_cpu} of max |ref|")
    return card_cpu, cost


def _dense_serve(torch, name, seed, card, int8=False):
    """One bench_serving model through the dense path, in bf16 or int8:
    export_for_serving -> Server.register -> start (one CUDA graph a
    bucket) -> submit, under bench_serving's traffic."""
    from paddle_tpu_torch.framework.flags import (flags_restore,
                                                  flags_snapshot, set_flags)
    key = f"{name}_int8" if int8 else name
    snap = flags_snapshot()
    try:
        if int8:
            model, f32, spec, shapes, vocab, b1 = _dense_int8_model(
                torch, name, seed)
            set_flags({"FLAGS_use_int8_inference": True})
        else:
            model, spec, shapes, vocab, b1 = _dense_model(torch, name, seed)
        return _dense_serve_model(torch, key, model, spec, shapes, vocab, b1,
                                  seed, card, int8,
                                  f32 if int8 else None)
    finally:
        flags_restore(snap)


def _dense_serve_model(torch, key, model, spec, shapes, vocab, b1, seed,
                       card, int8, f32):
    """``_dense_serve``'s run of one built model: export, warm-up, the
    program's and graphs' checks, the traffic, served against eager, and
    for an int8 model its products and readings.  Returns the record."""
    from paddle_tpu_torch import serving
    name = key[:-len("_int8")] if int8 else key
    b1_dtype = "float32" if int8 else "bfloat16"
    out_dir = os.path.join(ROOT, "build", "dense")
    shutil.rmtree(out_dir, ignore_errors=True)
    prefix = os.path.join(out_dir, name)
    _port_launches(reset=True)          # the path's run: counts from 0
    t0 = time.perf_counter()
    manifest = serving.export_for_serving(model, prefix, [spec],
                                          buckets=DENSE["buckets"],
                                          int8=int8)
    export_s = time.perf_counter() - t0
    check(manifest["int8"] == int8, f"dense {key}: manifest {manifest}")
    srv = serving.Server(serving.ServingConfig(workers=DENSE["workers"],
                                               buckets=DENSE["buckets"]))
    srv.register(name, prefix, buckets=DENSE["buckets"])
    try:
        t0 = time.perf_counter()
        srv.start()
        warmup_s = time.perf_counter() - t0
        rt = srv._models[name]
        check(all(rt.executables[b].captured for b in DENSE["buckets"])
              and [e["bucket"] for e in rt.events]
              == list(DENSE["buckets"]),
              f"dense {key}: warm-up captured {rt.events}")
        # one parameter set: every graph's and every worker's predictor
        # reads the loaded program's tensors (the int8 codes and scales
        # of an int8 program are among them)
        ptrs = {p.data_ptr() for p in rt.primary._translated._params}
        held = {p.data_ptr() for ex in rt.executables.values()
                for p in ex.predictor._translated._params}
        held |= {p.data_ptr() for w in srv._workers
                 for c in w.clones[name].values()
                 for p in c._translated._params}
        check(manifest["mode"] != "poly" or held == ptrs,
              f"dense {key}: a graph or a worker holds its own copy of "
              "the weights")
        program = rt.primary._translated.program()
        nodes = [str(n.target) for n in program.graph.nodes
                 if n.op == "call_function"]
        b1_nodes = sum("flash_attention_fwd" in n for n in nodes)
        check(b1_nodes == b1 and not any(
            "scaled_dot_product" in n or "einsum" in n for n in nodes),
              f"dense {key}: the exported program holds {b1_nodes} B1 "
              f"nodes (want {b1})")
        int_mm = sum("_int_mm" in n for n in nodes)
        floats = sorted({n for n in nodes if FLOAT_PRODUCTS.search(n)})
        info = rt.primary.quant_info()
        if int8:
            sites = DENSE_INT8_SITES[name]
            check(int_mm == sites and not floats
                  and info["sites"] == sites
                  and all(p.is_cuda for p in rt.primary._translated._params),
                  f"dense {key}: the int8 program holds {int_mm} _int_mm "
                  f"nodes for {sites} sites, float products {floats}, "
                  f"sidecar {info}")
        done, errors = _dense_traffic(srv, name, spec, vocab, seed)
        st = srv.stats(name)
        launches = _port_launches()
        steady = srv.compile_events_since_warmup()
        check(not errors, f"dense {key}: client errors {errors[:4]}")
        check(not steady and st["steady_compiles"] == 0,
              f"dense {key}: steady-state captures {steady}")
        srv.assert_zero_steady_state_recompiles()
        check(st["completed"] == len(done) and len(done) > 0,
              f"dense {key}: {st['completed']} completed, {len(done)} "
              "returned")
        # every batch was one replay of its bucket's graph, and each
        # graph launches B1 once a layer (none for LeNet and the block,
        # whose wrappers launched nothing either)
        replays = {b: ex.replays for b, ex in rt.executables.items()}
        check(sum(replays.values()) == st["batches"],
              f"dense {key}: {replays} replays for {st['batches']} "
              "batches")
        check(b1 or not any(launches.values()),
              f"dense {key}: kernel wrappers launched {launches}")
        graphs = _dense_graphs(key, rt, b1, b1_dtype)
        top = DENSE["buckets"][-1]
        graph = rt.executables[top].graph
        trace = _dense_trace(
            torch, graph, graphs[top]["b1_nodes"], b1_dtype,
            DENSE_TRACE_REPLAYS_INT8 if int8 else DENSE_REPLAYS) \
            if b1 else {}
        replay_ms = _replay_ms(torch, graph)
        top_names = sorted({n for n, _ in _graph_nodes(graph, "")[1]})
    finally:
        srv.stop()
    t0 = time.perf_counter()
    # an int8 result is held to the eager frozen model bit for bit: the
    # integer products are exact at any row count
    worst_err, equal = _dense_check(torch, key, model, done, spec, shapes,
                                    0.0 if int8 else DENSE_RTOL)
    extra = {}
    if int8:
        t1 = time.perf_counter()
        products = _int8_products(torch, name, model, spec, vocab, seed)
        products_s = time.perf_counter() - t1
        card_cpu, cost = _int8_readings(torch, name, model, f32, spec, vocab,
                                        seed)
        extra = {"sites": DENSE_INT8_SITES[name], "int_mm_nodes": int_mm,
                 "products_check_s": round(products_s, 1),
                 "float_product_nodes": floats, "quant_info": info,
                 "site_products_equal_int64": products,
                 "card_vs_cpu_max_share": card_cpu,
                 "int8_vs_f32_max_share": cost,
                 "bucket16_kernel_names": top_names}
    check_s = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)
    slo = DENSE_SLO_P99_MS[name]
    out = {"model": key, "input": spec,
           "config": "int8 (PTQ abs_max, frozen; f32 float layers)" if int8
           else "bf16 (amp O2)",
           "export_mode": manifest["mode"],
           "export_s": round(export_s, 3), "warmup_s": round(warmup_s, 3),
           "buckets": list(DENSE["buckets"]), "workers": DENSE["workers"],
           "clients": DENSE["clients"], "seconds": DENSE["seconds"],
           "qps": st["qps"], "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
           "slo_p99_ms": slo, "slo_met": st["p99_ms"] <= slo,
           "completed": st["completed"], "rows": sum(
               r[0].shape[0] for r in done),
           "avg_batch_rows": st["avg_batch_rows"],
           "padding_ratio": st["padding_ratio"],
           "steady_captures": len(steady), "op_nodes": len(nodes),
           "b1_op_nodes": b1_nodes, "launches": launches,
           "batches": st["batches"], "replays_by_bucket": replays,
           "kernel_nodes_per_replay": graphs[top]["kernel_nodes"],
           "replay_ms": round(replay_ms, 4),
           "b1_kernels_per_replay": sum(graphs[top]["b1_nodes"].values()),
           "b1_launches_replayed": sum(
               sum(graphs[b]["b1_nodes"].values()) * n
               for b, n in replays.items()),
           "graph_nodes": graphs,
           "served_vs_eager_max_share": worst_err,
           "served_equal_eager": f"{equal}/{len(done)}",
           "check_s": round(check_s, 1), "card": card, **extra, **trace}
    log("dense", **out)
    return out


def _int_mm_rules(torch):
    """Which unpadded shapes the card's ``torch._int_mm`` refuses (rows
    <= 16, K or N not a multiple of 8): {case: "ok" or its error}; the
    port pads for each (``ops.int8.int8_mm``)."""
    out = {}
    for case, (m, k, n) in {"rows_16": (16, 32, 32), "rows_17": (17, 32, 32),
                            "k_9": (32, 9, 32), "n_6": (32, 32, 6)}.items():
        a = torch.ones((m, k), dtype=torch.int8, device="cuda")
        w = torch.ones((n, k), dtype=torch.int8, device="cuda")
        try:
            torch._int_mm(a, w.t())
            torch.cuda.synchronize()
            out[case] = "ok"
        except RuntimeError as e:
            out[case] = str(e).splitlines()[0][:120]
    return out


def phase_dense(torch, seed, card):
    """bench_serving's six variants served one after another through the
    dense path: the bf16 models (lenet, resnet_block, bert), then the
    int8 ones; {model: record}, the int8 ones keyed "<model>_int8"."""
    out = {}
    for int8 in (False, True):
        for name in DENSE_MODELS:
            rec = _dense_serve(torch, name, seed, card, int8)
            out[rec["model"]] = rec
            torch.cuda.empty_cache()
    log("dense", int_mm_unpadded=_int_mm_rules(torch), torch=torch.__version__)
    log("dense", summary={n: {k: r[k] for k in (
        "export_mode", "export_s", "warmup_s", "qps", "p50_ms", "p99_ms",
        "slo_met", "kernel_nodes_per_replay", "replay_ms")}
        for n, r in out.items()}, card=card)
    return out


# -- phase 9: BERT-base training ---------------------------------------------

TRAIN = dict(batch=64, seq=128, n_pred=19, warmup=3, steps=20, lr=1e-4,
             weight_decay=0.01)
PARITY = dict(batch=8, seq=128, steps=5)
# kernels-on against kernels-off f32 training from the same weights:
#  * loss per step 1e-4: forward attention agrees to ~1e-6 per output
#    (FA_RTOL), which 12 layers and 5 Adam steps move a loss of ~10 by
#    ~1e-5;
#  * every parameter but the key biases 1e-4: the H100 run measured at
#    most 2.6e-5 (linear1.weight of the last layer), and 1e-4 is 4x that
#    and a fifth of what two runs whose gradients disagree could reach
#    (Adam moves an element by up to ~lr = 1e-4 per step);
#  * the key biases 2 * lr * steps: their exact gradient is 0 (softmax
#    is invariant to a shift of all logits of a row), so what both runs
#    compute is rounding noise, and Adam's normalised step turns noise
#    into moves of up to ~lr per step either way.
PARITY_LOSS_ATOL = 1e-4
PARITY_PARAM_ATOL = 1e-4
PARITY_KEY_BIAS_ATOL = 2 * TRAIN["lr"] * PARITY["steps"]


def _bert(torch, seed, dropout=True, dtype=None):
    import dataclasses
    from paddle_tpu_torch.text.models import BertConfig, BertForPretraining
    cfg = BertConfig.base()
    if not dropout:
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
    model = BertForPretraining(cfg, device="cuda", dtype=dtype)
    return model.init_weights(torch.Generator(device="cuda")
                              .manual_seed(seed))


def _bert_batch(torch, vocab, batch, seq, n_pred, seed):
    """bench.py's BERT batch (token ids, n_pred masked positions per row
    and their labels) with a ragged attention mask: row lengths 64..128,
    masked positions inside each row."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq))
    lens = rng.randint(seq // 2, seq + 1, batch)
    pos = np.stack([rng.choice(n, size=n_pred, replace=False)
                    for n in lens])
    labels = np.take_along_axis(ids, pos, 1)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
    t = lambda x: torch.as_tensor(x, dtype=torch.int64, device="cuda")
    return (t(ids), None, t(mask), t(labels), None, t(pos))


def _train_step(torch, model, seed, dtype):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep
    return TrainStep(model, AdamW(learning_rate=TRAIN["lr"],
                                  weight_decay=TRAIN["weight_decay"]),
                     compute_dtype=dtype, seed=seed)


def _fa_counts(fa, reset=False):
    f = fa.flash_attention
    if reset:
        f.launches_fwd = f.launches_dq = f.launches_dkv = 0
    return {"flash_attention_fwd": f.launches_fwd,
            "flash_attention_dq": f.launches_dq,
            "flash_attention_dkv": f.launches_dkv}


def phase_train(torch, seed):
    """BERT-base pretraining: f32 masters, bf16 compute, AdamW, dropout
    0.1, the same ragged batch every step."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    model = _bert(torch, seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _bert_batch(torch, model.config.vocab_size, TRAIN["batch"],
                        TRAIN["seq"], TRAIN["n_pred"], seed)

    def fresh(step_seed):
        model.load_state_dict(init)
        return _train_step(torch, model, step_seed, torch.bfloat16)

    first = [fresh(s)(batch).item() for s in (1, 1, 2)]
    check(first[0] == first[1], f"same seed, first losses {first[:2]} "
          "differ")
    check(first[0] != first[2], f"seeds 1 and 2 give one first loss "
          f"{first[0]}")
    step = fresh(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _fa_counts(fa, reset=True)          # the path's run: counts from 0
    losses = [step(batch) for _ in range(TRAIN["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(batch) for _ in range(TRAIN["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _fa_counts(fa)
    losses = [float(x) for x in losses]
    n = TRAIN["warmup"] + TRAIN["steps"]
    layers = model.config.num_hidden_layers
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not descend: {losses}")
    check(all(c == layers * n for c in launches.values()),
          f"launches {launches}, want {layers} layers x {n} steps each")
    out = {"config": "BertConfig.base()", "batch": TRAIN["batch"],
           "seq": TRAIN["seq"], "masked_per_row": TRAIN["n_pred"],
           "compute_dtype": "bfloat16", "dropout": 0.1,
           "steps": n, "timed_steps": TRAIN["steps"],
           "seq_per_s": round(TRAIN["batch"] * TRAIN["steps"] / dt, 1),
           "ms_per_step": round(dt / TRAIN["steps"] * 1e3, 3),
           "first_loss_same_seed": first[:2], "first_loss_seed_2": first[2],
           "losses": [round(x, 5) for x in losses], "launches": launches,
           "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}
    log("train", **out)
    return out, step, batch


def phase_train_parity(torch, seed):
    """f32, dropout off: 5 AdamW steps with the kernels on and off."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    model = _bert(torch, seed + 1, dropout=False)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _bert_batch(torch, model.config.vocab_size, PARITY["batch"],
                        PARITY["seq"], TRAIN["n_pred"], seed + 1)
    runs = {}
    snap = flags.flags_snapshot()
    try:
        for on in (True, False):
            flags.set_flags({"FLAGS_use_pallas_kernels": on})
            model.load_state_dict(init)
            step = _train_step(torch, model, seed, None)
            before = _fa_counts(fa)
            losses = [float(step(batch)) for _ in range(PARITY["steps"])]
            after = _fa_counts(fa)
            runs[on] = (losses, {n: p.detach().clone()
                                 for n, p in model.named_parameters()},
                        {k: after[k] - before[k] for k in after})
    finally:
        flags.flags_restore(snap)
    layers = model.config.num_hidden_layers
    check(all(c == layers * PARITY["steps"] for c in runs[True][2].values())
          and not any(runs[False][2].values()),
          f"parity launches on {runs[True][2]}, off {runs[False][2]}")
    loss_err = max(abs(a - b) for a, b in zip(runs[True][0], runs[False][0]))
    diffs = {n: (runs[True][1][n] - runs[False][1][n]).abs().max().item()
             for n in runs[True][1]}
    key_bias = {n: d for n, d in diffs.items() if n.endswith("k_proj.bias")}
    rest = {n: d for n, d in diffs.items() if n not in key_bias}
    check(len(key_bias) == model.config.num_hidden_layers,
          f"parity: key biases found {sorted(key_bias)}")
    worst = max(rest, key=rest.get)
    worst_kb = max(key_bias.values())
    check(all(np.isfinite(runs[True][0])) and loss_err <= PARITY_LOSS_ATOL,
          f"parity: losses {runs[True][0]} vs {runs[False][0]}")
    check(rest[worst] <= PARITY_PARAM_ATOL,
          f"parity: {worst} differs by {rest[worst]}")
    check(worst_kb <= PARITY_KEY_BIAS_ATOL,
          f"parity: a key bias differs by {worst_kb}")
    log("train_parity", dtype="float32", batch=PARITY["batch"],
        seq=PARITY["seq"], steps=PARITY["steps"],
        losses_kernels=runs[True][0], losses_plain=runs[False][0],
        loss_max_abs_diff=loss_err, loss_atol=PARITY_LOSS_ATOL,
        param_max_abs_diff=rest[worst], param_worst=worst,
        param_atol=PARITY_PARAM_ATOL, key_bias_max_abs_diff=worst_kb,
        key_bias_atol=PARITY_KEY_BIAS_ATOL)


def phase_train_profile(torch, step, batch, phase="train_profile"):
    """Three bf16 training steps timed, then one traced with
    torch.profiler: device busy time, kernel time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {"step_ms": round(step_ms, 3), "step_ms_traced": round(traced_ms, 3)}
    if busy <= 0:
        out["device_busy_ms"] = "not measured (no CUDA events)"
    else:
        # the kernels of csrc/flash_attention.cu, by their demangled
        # names: bf16 runs the tensor-core ones (tc::fwd_tc_kernel...),
        # f32 tf::fwd_tf32_kernel and the FMA dq_kernel, dkv_kernel
        # (flash_decode.cu's are decode_*_kernel)
        fa_ev = {k: [e for e in kernels if f"::{k}_kernel<" in e.key
                     or f"::tc::{k}_tc_kernel<" in e.key]
                 for k in ("fwd", "dq", "dkv")}
        check(all(ev and all("_tc_kernel<" in e.key for e in ev)
                  for ev in fa_ev.values()),
              "the bf16 step did not run the tensor-core kernels: "
              f"{ {k: [e.key for e in ev] for k, ev in fa_ev.items()} }")
        fa_ms = {k: sum(e.self_device_time_total for e in ev) / 1e3
                 for k, ev in fa_ev.items()}
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        out.update(
            device_busy_ms=round(busy, 4),
            # against the untraced step: tracing slows the host, not the
            # device
            device_idle_share=round(1 - busy / step_ms, 4),
            kernel_launches=sum(e.count for e in kernels),
            flash_attention_ms=fa_ms,
            flash_attention_kernels=sorted(
                {e.key[:90] for ev in fa_ev.values() for e in ev}),
            flash_attention_share=round(sum(fa_ms.values()) / busy, 4),
            top_kernels=[{"name": e.key[:90], "calls": e.count,
                          "ms": round(e.self_device_time_total / 1e3, 4)}
                         for e in top])
    log(phase, **out)


# -- phase 9b: Transformer-big training (bench.py:265-327) -----------------

# bench.py's on-chip configuration of bench_transformer_big: the fluid
# Transformer-big widths, vocab 32768, a 64-row position table, batch 64
# x seq 64, Adam(1e-4), bf16 compute over f32 masters
SEQ2SEQ = dict(vocab=32768, d_model=1024, nhead=16, layers=6, ffn=4096,
               batch=64, seq=64, warmup=3, steps=10, lr=1e-4)
# kernels on against off in f32 at full width, depth cut to 2 + 2 for
# time; batch 8 as train_parity's; a source padding of 32..64 tokens a
# row, the square target mask, label smoothing 0.1 under soft-label
# cross entropy, global-norm clipping at 1.0, and a Noam schedule whose
# warm-up of 100 steps puts its first rates (3.1e-5: steps 0 and 1 both
# read Noam's step 1) near train_parity's 1e-4, so that the BERT limits
# hold for the same reasons
SEQ2SEQ_PARITY = dict(layers=2, batch=8, steps=2, warmup_steps=100,
                      clip_norm=1.0, epsilon=0.1)
# Beside BERT's absolute limits, which an element of a gradient (RMS
# ~1e-4 here, ~3e-7 in the first encoder layer's q/k weights) or of two
# Noam steps (at most ~2 x 3.1e-5) cannot reach, each leaf is held on its
# own scale, with the kernels-on run's ReLU gates pinned to the plain
# run's (ReluGates).  The limits and the H100 readings they were set
# from (sound; and with the kernel path's q scaled by 1 + 1e-4, by
# 1 + 1e-5, or its output by 1 + 1e-5, which pass BERT's limits):
#  * a gradient leaf's max|on - off| over its own max|off|, 1e-5: sound
#    2.3e-6; the three perturbations 1.8e-4, 1.8e-5, 2.4e-5 (the key
#    biases, whose exact gradient is 0, stay with the absolute limit);
#  * a leaf's change over the two steps, |change on - change off| over
#    |change off| in norm, 1e-3: sound 1.1e-4; perturbed 6.4e-3, 5.2e-4,
#    1.3e-3.  Not element by element: Adam's eps turns a gradient
#    difference dg near 0 into a move of up to ~dg / eps of a rate, so
#    the largest element barely tells a sound run from a perturbed one.
# Unpinned, one gate that rounding flips (a pre-activation within ~1e-7
# of 0) moves its layer's linear1 gradient by up to 2.1e-2 of its max,
# kernels on against off as much as f32 against f64; f32 against f64,
# the median leaf moves by 2.5e-4 under the masks (two gates flipped)
# and by 1.4e-6 without them (none).  seq2seq_parity_probe.py logs
# these readings.
SEQ2SEQ_GRAD_RTOL = 1e-5
SEQ2SEQ_CHANGE_RTOL = 1e-3


def seq2seq_lm(vocab, d_model, nhead, layers, ffn, seq, soft_label=False,
               device=None):
    """bench.py:272-293's Seq2SeqLM on the port: token and position
    embeddings shared by source and target, ``nn.Transformer`` (dropout
    0), a projection to the vocabulary and the cross entropy inside.
    Its parameters carry the JAX model's dotted names (``embed``,
    ``pos``, ``core.encoder.layers.i...``, ``proj``), so
    ``load_jax_state`` maps them name to name.  ``forward(src, tgt,
    labels, src_mask=None, tgt_mask=None, memory_mask=None)``; with
    ``soft_label`` the labels are distributions over the vocabulary."""
    import torch
    from paddle_tpu_torch import nn

    class Seq2SeqLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, d_model, device=device)
            self.pos = nn.Embedding(seq, d_model, device=device)
            self.core = nn.Transformer(
                d_model=d_model, nhead=nhead, num_encoder_layers=layers,
                num_decoder_layers=layers, dim_feedforward=ffn,
                dropout=0.0, device=device)
            self.proj = nn.Linear(d_model, vocab, device=device)
            self.loss = nn.CrossEntropyLoss(soft_label=soft_label)

        def forward(self, src, tgt, labels, src_mask=None, tgt_mask=None,
                    memory_mask=None):
            def embed(ids):
                return self.embed(ids) + self.pos(
                    torch.arange(ids.shape[1], device=ids.device))
            h = self.core(embed(src), embed(tgt), src_mask, tgt_mask,
                          memory_mask)
            logits = self.proj(h)
            V = logits.shape[-1]
            return self.loss(logits.reshape(-1, V),
                             labels.reshape(-1, V) if soft_label
                             else labels.reshape(-1))

    return Seq2SeqLM()


def _seq2seq(torch, seed, layers, soft_label=False):
    """The Transformer-big model on the card, its random weights from
    ``seed``; the count of its parameters."""
    c = SEQ2SEQ
    torch.manual_seed(seed)
    model = seq2seq_lm(c["vocab"], c["d_model"], c["nhead"], layers,
                       c["ffn"], c["seq"], soft_label=soft_label)
    return model, sum(p.numel() for p in model.parameters())


def _seq2seq_batch(torch, batch, seed):
    """bench.py:313-316's batch: source, target and label ids drawn in
    that order from np.random.RandomState(seed)."""
    c = SEQ2SEQ
    rng = np.random.RandomState(seed)
    ids = [rng.randint(0, c["vocab"], (batch, c["seq"])) for _ in range(3)]
    return tuple(torch.as_tensor(x, dtype=torch.int64, device="cuda")
                 for x in ids)


def phase_seq2seq_train(torch, seed):
    """Transformer-big at bench.py's configuration: 3 + 10 bf16 steps on
    the repeated batch, 18 launches of each flash-attention kernel a
    step."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import TrainStep
    c = SEQ2SEQ
    model, n_params = _seq2seq(torch, seed, c["layers"])
    step = TrainStep(model, Adam(learning_rate=c["lr"]),
                     compute_dtype=torch.bfloat16)
    batch = _seq2seq_batch(torch, c["batch"], seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _fa_counts(fa, reset=True)          # the path's run: counts from 0
    losses = [step(batch) for _ in range(c["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(batch) for _ in range(c["steps"])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _fa_counts(fa)
    losses = [float(x) for x in losses]
    n = c["warmup"] + c["steps"]
    per_step = 3 * c["layers"]          # encoder self, decoder self, cross
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not descend: {losses}")
    check(all(v == per_step * n for v in launches.values()),
          f"launches {launches}, want {per_step} a step x {n} steps each")
    out = {"config": "Transformer-big (bench.py:265-327)",
           "vocab": c["vocab"], "d_model": c["d_model"],
           "heads": c["nhead"], "layers": f"{c['layers']}+{c['layers']}",
           "ffn": c["ffn"], "batch": c["batch"], "seq": c["seq"],
           "parameters": n_params, "compute_dtype": "bfloat16",
           "optimizer": f"Adam({c['lr']})", "steps": n,
           "timed_steps": c["steps"],
           "tok_per_s": round(c["batch"] * c["seq"] * c["steps"] / dt, 1),
           "ms_per_step": round(dt / c["steps"] * 1e3, 3),
           "losses": [round(x, 5) for x in losses], "launches": launches,
           "launches_per_step": per_step,
           "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}
    log("seq2seq_train", **out)
    return out, step, batch


def seq2seq_parity_case(torch, seed):
    """seq2seq_parity's model (Transformer-big widths at depth 2 + 2,
    soft labels, on the card), its parameter count and its inputs: the
    batch, label-smoothed targets, a source padding of S/2..S tokens a
    row as src_mask and memory_mask, and the square target mask."""
    from paddle_tpu_torch.nn import functional as F
    c, pc = SEQ2SEQ, SEQ2SEQ_PARITY
    model, n_params = _seq2seq(torch, seed + 2, pc["layers"],
                               soft_label=True)
    src, tgt, labels = _seq2seq_batch(torch, pc["batch"], seed + 2)
    S = c["seq"]
    lens = torch.as_tensor(np.random.RandomState(seed + 3).randint(
        S // 2, S + 1, pc["batch"]), device="cuda")
    pad = torch.where(torch.arange(S, device="cuda")[None] < lens[:, None],
                      0.0, -1e4)[:, None, None, :]
    soft = F.label_smooth(F.one_hot(labels, c["vocab"]),
                          epsilon=pc["epsilon"])
    return model, n_params, (src, tgt, soft, pad,
                             model.core.generate_square_subsequent_mask(S),
                             pad)


class ReluGates:
    """Stands in for the ReLU of every feed-forward block of ``model``.
    While ``record``, it is ReLU and keeps each call's gate (h > 0); after
    ``replay()`` the calls, in the same order, pass ``h`` through the
    recorded gates and count the elements whose own gate differs.  The
    gradient is the gate either way, as ReLU's is."""

    def __init__(self, torch, model):
        self.torch, self.gates, self.i, self.flipped = torch, [], None, 0
        self.layers = [m for m in model.modules() if hasattr(m, "linear1")]
        for m in self.layers:
            check(m.activation is torch.nn.functional.relu,
                  f"{type(m).__name__} does not run ReLU")
            m.activation = self

    def replay(self):
        self.i = 0

    def __call__(self, h):
        if self.i is None:
            self.gates.append(h.detach() > 0)
            return self.torch.nn.functional.relu(h)
        gate = self.gates[self.i]
        self.i += 1
        self.flipped += int(((h.detach() > 0) != gate).sum())
        return h * gate

    def restore(self):
        for m in self.layers:
            m.activation = self.torch.nn.functional.relu


def phase_seq2seq_parity(torch, seed):
    """Transformer-big widths at depth 2 + 2 in f32, kernels on against
    off from the same weights and batch, under the source padding and
    square target masks and label-smoothed soft labels: the loss and
    every gradient of one forward and backward, then two Adam steps with
    global-norm clipping and a Noam schedule.  The plain run goes first
    and the kernels' run takes its ReLU gates, so each leaf can be held
    on its own scale (SEQ2SEQ_GRAD_RTOL)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import Adam, lr
    from paddle_tpu_torch.parallel import TrainStep
    c, pc = SEQ2SEQ, SEQ2SEQ_PARITY
    S = c["seq"]
    model, n_params, inputs = seq2seq_parity_case(torch, seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]
    runs = {}
    gates = ReluGates(torch, model)
    snap = flags.flags_snapshot()
    try:
        for on in (False, True):
            if on:
                gates.replay()
            flags.set_flags({"FLAGS_use_pallas_kernels": on})
            model.load_state_dict(init)
            before = _fa_counts(fa)
            loss = model(*inputs)
            grads = torch.autograd.grad(loss, params)
            sched = lr.NoamDecay(c["d_model"], pc["warmup_steps"])
            rates = []
            step = TrainStep(model, Adam(
                learning_rate=sched,
                grad_clip=ClipGradByGlobalNorm(pc["clip_norm"])))
            losses = []
            for _ in range(pc["steps"]):
                rates.append(sched())
                losses.append(float(step(inputs)))
                sched.step()
            after = _fa_counts(fa)
            runs[on] = (loss.item(), dict(zip(names, grads)), losses,
                        {n: p.detach().clone()
                         for n, p in model.named_parameters()},
                        {k: after[k] - before[k] for k in after})
    finally:
        flags.flags_restore(snap)
        gates.restore()
    check(gates.i == len(gates.gates),
          f"seq2seq parity: {gates.i} of {len(gates.gates)} gates replayed")
    per_run = 3 * pc["layers"] * (1 + pc["steps"])
    check(all(v == per_run for v in runs[True][4].values())
          and not any(runs[False][4].values()),
          f"seq2seq parity launches on {runs[True][4]}, off "
          f"{runs[False][4]}")
    on, off = runs[True], runs[False]
    grad_norm = torch.stack([g.float().square().sum()
                             for g in off[1].values()]).sum().sqrt().item()
    loss_err = max([abs(on[0] - off[0])]
                   + [abs(a - b) for a, b in zip(on[2], off[2])])
    check(all(np.isfinite([on[0]] + on[2])) and loss_err <= PARITY_LOSS_ATOL,
          f"seq2seq parity: losses {on[0]}, {on[2]} vs {off[0]}, {off[2]}")
    gdiff = {n: (on[1][n] - off[1][n]).abs().max().item() for n in names}
    gworst = max(gdiff, key=gdiff.get)
    check(gdiff[gworst] <= PARITY_PARAM_ATOL,
          f"seq2seq parity: gradient of {gworst} differs by "
          f"{gdiff[gworst]}")
    grel = {n: gdiff[n] / off[1][n].abs().max().item() for n in names
            if not n.endswith("k_proj.bias")}
    grel_worst = max(grel, key=grel.get)
    check(grel[grel_worst] <= SEQ2SEQ_GRAD_RTOL,
          f"seq2seq parity: gradient of {grel_worst} differs by "
          f"{grel[grel_worst]} of its max")
    pdiff = {n: (on[3][n] - off[3][n]).abs().max().item() for n in names}
    # on[3][n] - off[3][n] is the difference of the two runs' changes,
    # since both start from init
    change = {n: ((on[3][n] - off[3][n]).norm()
                  / (off[3][n] - init[n]).norm()).item()
              for n in names if not n.endswith("k_proj.bias")}
    cworst = max(change, key=change.get)
    check(change[cworst] <= SEQ2SEQ_CHANGE_RTOL,
          f"seq2seq parity: {cworst}'s change differs by {change[cworst]} "
          f"of its norm")
    key_bias = {n: d for n, d in pdiff.items() if n.endswith("k_proj.bias")}
    rest = {n: d for n, d in pdiff.items() if n not in key_bias}
    # see PARITY_KEY_BIAS_ATOL: Adam moves a zero-gradient element by up
    # to ~lr a step either way
    kb_atol = 2 * max(rates) * pc["steps"]
    check(len(key_bias) == 3 * pc["layers"],
          f"seq2seq parity: key biases found {sorted(key_bias)}")
    pworst = max(rest, key=rest.get)
    check(rest[pworst] <= PARITY_PARAM_ATOL,
          f"seq2seq parity: {pworst} differs by {rest[pworst]}")
    check(max(key_bias.values()) <= kb_atol,
          f"seq2seq parity: a key bias differs by {max(key_bias.values())}")
    out = {"dtype": "float32", "layers": f"{pc['layers']}+{pc['layers']}",
           "parameters": n_params, "batch": pc["batch"], "seq": S,
           "masks": "src/memory padding (B,1,1,S) -1e4, square tgt -1e30",
           "label_smooth": pc["epsilon"], "clip_global_norm": pc["clip_norm"],
           "grad_global_norm": grad_norm, "noam_rates": rates,
           "loss_kernels": on[0], "loss_plain": off[0],
           "step_losses_kernels": on[2], "step_losses_plain": off[2],
           "loss_max_abs_diff": loss_err, "loss_atol": PARITY_LOSS_ATOL,
           "grad_max_abs_diff": gdiff[gworst], "grad_worst": gworst,
           "grad_max_rel_diff": grel[grel_worst],
           "grad_rel_worst": grel_worst, "grad_rtol": SEQ2SEQ_GRAD_RTOL,
           "change_rel_norm_diff": change[cworst], "change_worst": cworst,
           "change_rtol": SEQ2SEQ_CHANGE_RTOL,
           "gates_pinned": gates.flipped, "gate_calls": len(gates.gates),
           "param_max_abs_diff": rest[pworst], "param_worst": pworst,
           "param_atol": PARITY_PARAM_ATOL,
           "key_bias_max_abs_diff": max(key_bias.values()),
           "key_bias_atol": kb_atol, "launches_kernels": on[4]}
    log("seq2seq_parity", **out)
    return out


# -- phase 10: batch invariance probe ----------------------------------------

def phase_batch_probe(torch, model, seed, decode_steps=4):
    """Batch invariance of the serving path.  One prompt prefilled and
    decoded alone and as row 0 of an 8-row batch at the same bucket (32)
    and cache (48), the batch's row fed the batch-1 run's tokens; every
    Linear, LayerNorm and Embedding module records its input and output
    row (the cached path's GEMMs run batch_invariant_linear, not the
    Linear modules, so a GEMM that moved would show in the LayerNorm or
    the logits after it), and so do the logits.  The first module call
    whose output row differs fails the phase, reported with whether its
    input row was equal (equal input, different output: the op itself
    depends on the batch)."""
    from torch import nn
    from paddle_tpu_torch.text.generation import Generator
    gen = Generator(model, seq_buckets=SHORT_GRID["seq_buckets"],
                    max_len=SHORT_GRID["max_len"])
    rows = _traffic(seed + 3, model.config.vocab_size, SHORT_REQUESTS,
                    *SHORT_WAVES[1])
    P = gen.prefill_bucket(max(r.size for r in rows))
    C = gen.cache_bucket(P, SHORT_GRID["max_new_tokens"])
    rec = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: rec.append((name, inp[0], out)))
        for name, m in model.named_modules()
        if isinstance(m, (nn.Linear, nn.LayerNorm, nn.Embedding))]

    def run(batch_rows, forced=None):
        ids, start = gen.pack_prompts(batch_rows, P)
        start = torch.as_tensor(start, device="cuda")
        calls, toks = [], []
        with torch.inference_mode():
            cache = model.init_cache(len(batch_rows), C)
            x = torch.as_tensor(ids, device="cuda")
            for i in range(decode_steps + 1):
                rec.clear()
                logits, cache = model.forward_cached(
                    x, cache, 0 if i == 0 else P + i - 1, start)
                last = logits[:, -1].float()
                calls.append([(n, a[0].clone(), b[0].clone())
                              for n, a, b in rec]
                             + [("logits", last[0], last[0])])
                tok = last.argmax(-1).to(torch.int32)
                if forced is not None:
                    tok[0] = forced[i]
                toks.append(tok)
                x = tok[:, None]
        return calls, [int(t[0]) for t in toks]

    try:
        alone, toks = run(rows[:1])
        batch, _ = run(rows, forced=toks)
    finally:
        for h in hooks:
            h.remove()
    first = None
    for i, (a_calls, b_calls) in enumerate(zip(alone, batch)):
        for (name, ia, oa), (_, ib, ob) in zip(a_calls, b_calls):
            if not torch.equal(oa, ob):
                first = {"call": "prefill" if i == 0 else f"decode {i}",
                         "module": name,
                         "input_row_equal": bool(torch.equal(ia, ib)),
                         "output_max_abs_diff":
                             (oa.float() - ob.float()).abs().max().item(),
                         "out_shape_alone": list(oa.shape)}
                break
        if first is not None:
            break
    logits_diff = [(a[-1][2] - b[-1][2]).abs().max().item()
                   for a, b in zip(alone, batch)]
    check(first is None, f"batch probe: the row diverges at {first}")
    log("batch_probe", prompt_len=int(rows[0].size), bucket=P, cache=C,
        batch_rows=len(rows), steps=decode_steps,
        first_divergence=first or "none",
        logits_max_abs_diff_per_call=logits_diff)


# -- phase 11: fused batch-norm and conv kernels (B5, B6, B7) ----------------

# ResNet-50's stages: (planes, blocks, stride of the first block)
R50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
FUSED_CHECK_BATCH = 2
# kernel against its plain version on the same inputs:
#  * B5 apply and B6 dx are elementwise and round x·scale + shift and
#    a·dy' + b·x + c operation by operation, as the plain version's tensor
#    ops do: equal, in f32 and after the rounding to bf16;
#  * B5 stats, B6 reduce and B7's moments sum the same f32 terms in
#    another order: within 1e-5 of Σ|terms| per channel (for the moments,
#    of E[x²]), some 170 f32 rounding steps of the terms' magnitude;
#  * B7's output: the kernel and cuDNN's f32 conv (TF32 off) sum kh·kw·Cin
#    f32 products in other orders, ~1e-6 of the output in f32: 1e-4 of
#    max(1, max|y|); in bf16 both round the f32 sum, and one near a
#    rounding boundary lands one bf16 step apart: 2^-7 of max|y|, one
#    step of the largest output.
FUSED_SUM_RTOL = 1e-5
CONV_RTOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
FUSED_TIME_BATCH = 256


def _resnet50_sites(n, hw=224):
    """Every conv+BN site of ResNet-50 at ``hw`` px, in the order the
    model runs them: (name, N, H, W, Cin, Cout, k, stride, pad), the stem
    in its space-to-depth form (4x4/s1 over 12 channels)."""
    s = (hw + 6) // 2
    sites = [("stem_s2d", n, s, s, 12, 64, 4, 1, 0)]
    h, inp = hw // 4, 64
    for stage, (planes, blocks, stride) in enumerate(R50_STAGES, 1):
        for b in range(blocks):
            st = stride if b == 0 else 1
            ho = (h + 2 - 3) // st + 1
            sites += [(f"layer{stage}.conv1", n, h, h, inp, planes, 1, 1, 0),
                      (f"layer{stage}.conv2", n, h, h, planes, planes, 3, st,
                       1),
                      (f"layer{stage}.conv3", n, ho, ho, planes, planes * 4,
                       1, 1, 0)]
            if b == 0:
                sites.append((f"layer{stage}.down", n, h, h, inp,
                              planes * 4, 1, st, 0))
            inp, h = planes * 4, ho
    return sites


def _distinct(sites):
    seen, out = set(), []
    for site in sites:
        if site[1:] not in seen:
            seen.add(site[1:])
            out.append(site)
    return out


def _sum_check(where, got, want, l1):
    """|got − want| ≤ FUSED_SUM_RTOL·l1 per channel (l1: Σ|terms|)."""
    err = (got - want).abs()
    ok = bool((err <= FUSED_SUM_RTOL * l1 + 1e-30).all())
    check(ok, f"{where}: error {(err / l1.clamp_min(1e-30)).max().item()} "
          f"of Σ|terms| > {FUSED_SUM_RTOL}")
    return err.max().item()


def _bn_compare(torch, fb, x2d, g, where, worst):
    """B5 stats/apply and B6 reduce/dx on ``x2d`` against their plain
    versions, relu on and off; records the worst absolute errors."""
    C = x2d.shape[1]
    dt = x2d.dtype
    dy = torch.randn(x2d.shape, generator=g, device="cuda").to(dt)
    sc, sh, a, b, c = (torch.randn(C, generator=g, device="cuda")
                       for _ in range(5))
    xf = x2d.float()
    m = x2d.shape[0]
    mean, var = fb.bn_moments(x2d)
    wm, wv = fb.moments_plain(x2d)
    ex2 = (xf * xf).sum(0) / m
    worst["bn_stats"] = max(worst["bn_stats"],
                            _sum_check(f"{where} B5 stats mean", mean, wm,
                                       xf.abs().sum(0) / m),
                            _sum_check(f"{where} B5 stats var", var, wv, ex2))
    for relu in (False, True):
        w = f"{where} relu={relu}"
        y = fb.bn_apply(x2d, sc, sh, relu)
        check(y.dtype == dt and torch.equal(
            y, fb.apply_plain(x2d, sc, sh, relu)),
            f"{w}: B5 apply differs from its plain version")
        sdyx, sdy = fb.bn_bwd_reduce(x2d, dy, sc, sh, relu)
        wdyx, wdy = fb.bwd_reduce_plain(x2d, dy, sc, sh, relu)
        d = fb._gate(xf, sc, sh, relu, dy.float())
        worst["bn_bwd_reduce"] = max(
            worst["bn_bwd_reduce"],
            _sum_check(f"{w} B6 reduce Σdy'x", sdyx, wdyx,
                       (d * xf).abs().sum(0)),
            _sum_check(f"{w} B6 reduce Σdy'", sdy, wdy, d.abs().sum(0)))
        dx = fb.bn_bwd_dx(x2d, dy, sc, sh, a, b, c, relu)
        check(dx.dtype == dt and torch.equal(
            dx, fb.bwd_dx_plain(x2d, dy, sc, sh, a, b, c, relu)),
            f"{w}: B6 dx differs from its plain version")
    torch.cuda.synchronize()


def _conv_compare(torch, fc, fb, site, dt, g, worst, inputs=None):
    """B7 on ``site`` (random inputs, or ``inputs`` = (x, w)) against its
    plain version, then the BN kernels on its output."""
    name, n, h, w, cin, cout, k, s, p = site
    if inputs is None:
        x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(dt)
        wt = (torch.randn(cout, cin, k, k, generator=g, device="cuda")
              / (cin * k * k) ** 0.5).to(dt)
    else:
        x, wt = inputs
    y, mean, var = fc.conv_stats(x, wt, s, p)
    yw, mw, vw = fc.conv_stats_plain(x, wt, s, p)
    torch.cuda.synchronize()
    key = str(dt).split(".")[-1]
    where = f"{name} N={n} {h}x{w}x{cin}->{cout} k={k} s={s} p={p} {key}"
    check(y.shape == yw.shape and y.dtype == dt, f"{where}: B7 returned "
          f"{tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y).all()), f"{where}: B7 non-finite")
    scale = yw.float().abs().max().item()
    tol = CONV_RTOL[key] * (max(1.0, scale) if key == "float32" else scale)
    err = (y.float() - yw.float()).abs().max().item()
    check(err <= tol, f"{where}: B7 y error {err} > {tol}")
    # the moments from the f32 results
    yf = torch.nn.functional.conv2d(
        x.float().permute(0, 3, 1, 2), wt.float(), None, s, p) \
        .permute(0, 2, 3, 1).reshape(-1, cout)
    m = yf.shape[0]
    ex2 = (yf * yf).sum(0) / m
    _sum_check(f"{where} B7 mean", mean, mw, yf.abs().sum(0) / m)
    _sum_check(f"{where} B7 var", var, vw, ex2)
    worst["conv_stats"] = max(worst["conv_stats"], err)
    # the BN kernels at the site's epilogue shape, on the conv output
    _bn_compare(torch, fb, y.reshape(-1, cout), g, where, worst)


def _bn_bound(kind, m, c, elt):
    """Least time (ms) of one BN pass over [m, c]: activation bytes read
    and written once (per-channel vectors negligible but counted) over
    HBM, against its operations over the inputs' peak rate."""
    mc = m * c
    nbytes, ops = {
        "bn_stats": (mc * elt + 2 * c * 4, 3 * mc),
        "bn_apply": (2 * mc * elt + 2 * c * 4, 3 * mc),
        "bn_bwd_reduce": (2 * mc * elt + 4 * c * 4, 6 * mc),
        "bn_bwd_dx": (3 * mc * elt + 5 * c * 4, 8 * mc),
    }[kind]
    peak = PEAK_OPS_PER_S["bfloat16" if elt == 2 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _conv_bound(n, h, w, cin, cout, k, s, p, elt):
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m = n * ho * wo
    nbytes = (n * h * w * cin + cout * cin * k * k + m * cout) * elt \
        + 2 * cout * 4
    ops = 2 * m * cout * k * k * cin + 3 * m * cout
    peak = PEAK_OPS_PER_S["bfloat16" if elt == 2 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _bn_timings(torch, fb, g, n, hw, C, prefix, worst):
    """B5/B6 at the [n·hw·hw, C] bf16 epilogue with relu: each kernel
    checked against its plain version on the tensors it is timed on
    (:func:`_bn_compare`), then each kernel and its plain version by
    CUDA-graph replay, its bound, and the library yardsticks on the
    channels-last NCHW view: var_mean for B5 stats, ATen's batch norm
    forward (statistics and normalize, no ReLU) for B5 apply, its
    backward with the dgamma/dbeta mask (the two sums, no ReLU gate) for
    B6 reduce and with dx as well for B6 dx."""
    import torch.nn.functional as F
    M, bf = n * hw * hw, torch.bfloat16
    x2d = torch.randn(M, C, generator=g, device="cuda").to(bf)
    _bn_compare(torch, fb, x2d, g, f"batch {n} [{M}, {C}] bf16", worst)
    dy = torch.randn(M, C, generator=g, device="cuda").to(bf)
    sc, sh, a, b, c = (torch.randn(C, generator=g, device="cuda")
                       for _ in range(5))
    kern = {"bn_stats": lambda i: fb.bn_moments(x2d),
            "bn_apply": lambda i: fb.bn_apply(x2d, sc, sh, True),
            "bn_bwd_reduce": lambda i: fb.bn_bwd_reduce(x2d, dy, sc, sh,
                                                        True),
            "bn_bwd_dx": lambda i: fb.bn_bwd_dx(x2d, dy, sc, sh, a, b, c,
                                                True)}
    plain = {"bn_stats": lambda i: fb.moments_plain(x2d),
             "bn_apply": lambda i: fb.apply_plain(x2d, sc, sh, True),
             "bn_bwd_reduce": lambda i: fb.bwd_reduce_plain(x2d, dy, sc, sh,
                                                            True),
             "bn_bwd_dx": lambda i: fb.bwd_dx_plain(x2d, dy, sc, sh, a, b,
                                                    c, True)}
    t = {}
    for key in kern:
        t[key] = _graph_ms(torch, kern[key], 2)
        t[key + "_plain"] = _graph_ms(torch, plain[key], 2)
        bound, by, nbytes, ops = _bn_bound(key, M, C, 2)
        t.update({key + "_bound": bound, key + "_bound_by": by,
                  key + "_bytes": nbytes, key + "_ops": ops})
    xc = x2d.view(n, hw, hw, C).permute(0, 3, 1, 2)
    dyc = dy.view(n, hw, hw, C).permute(0, 3, 1, 2)
    gam, bet = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
    rm, rv = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
    t["bn_stats_library"] = _graph_ms(
        torch, lambda i: torch.var_mean(x2d, 0, correction=0), 2)
    t["bn_apply_library"] = _graph_ms(torch, lambda i: F.batch_norm(
        xc, rm, rv, gam, bet, training=True), 2)
    _, smean, sinv = torch.ops.aten.native_batch_norm(
        xc, gam, bet, rm, rv, True, 0.1, 1e-5)
    for key, mask in (("bn_bwd_reduce", [False, True, True]),
                      ("bn_bwd_dx", [True, True, True])):
        t[key + "_library"] = _graph_ms(
            torch, lambda i: torch.ops.aten.native_batch_norm_backward(
                dyc, xc, gam, rm, rv, smean, sinv, True, 1e-5, mask), 2)
    return {prefix + k: v for k, v in t.items()}


def phase_fused_kernels(torch, seed):
    """B5 stats/apply, B6 reduce/dx and B7 against their plain versions
    at every distinct ResNet-50 conv+BN site (batch 2, 224 px), the
    stage-4 3x3 site at batch 1 (M = 49: no multiple of any tile), a
    5x5/s2 site and Cin/Cout off the vector widths, in f32 and bf16; the
    same in bf16 at every distinct site at batch 256, the main path's;
    then timed at batch 256 (B7 at the stem and the stage-1 3x3 conv,
    B5/B6 at the stem's and stage 1's BN epilogues), each on tensors it
    is first checked on, beside the bound, the plain versions and the
    library."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    all_sites = _resnet50_sites(FUSED_CHECK_BATCH)
    check(len(all_sites) == 53, f"{len(all_sites)} ResNet-50 sites, want 53")
    sites = _distinct(all_sites) + [
        ("layer4.conv2_batch1", 1, 7, 7, 512, 512, 3, 1, 1),
        ("5x5_s2", 2, 17, 17, 32, 48, 5, 2, 2),
        ("odd_widths", 2, 9, 9, 20, 36, 3, 1, 1)]
    worst = {"conv_stats": 0.0, "bn_stats": 0.0, "bn_bwd_reduce": 0.0}
    for site in sites:
        for dt in (torch.float32, torch.bfloat16):
            _conv_compare(torch, fc, fb, site, dt, g, worst)
        log("fused_kernels", check=site[0], shape=list(site[1:]),
            dtypes="float32,bfloat16", relu="on,off", ok=True)
    log("fused_kernels", sites=len(sites), resnet50_sites=len(all_sites),
        max_abs_err=worst, sum_rtol=FUSED_SUM_RTOL, conv_rtol=CONV_RTOL,
        apply_and_dx="bit-equal to the plain versions")

    # the same checks at the main path's own batch (bf16, every distinct
    # site): the reductions' depth and B7's row tiling are the step's;
    # then two launches on the same input must give the same bits, and
    # B7 is timed at the site beside its bound and cuDNN's conv
    n = FUSED_TIME_BATCH
    bf = torch.bfloat16
    worst_main = {k: 0.0 for k in worst}
    all_main = _resnet50_sites(n)
    main_sites = _distinct(all_main)
    per_site = []
    for site in main_sites:
        name, _, h, w, cin, cout, k, s, p = site
        x = torch.randn(n, h, w, cin, generator=g, device="cuda").to(bf)
        wt = (torch.randn(cout, cin, k, k, generator=g, device="cuda")
              / (cin * k * k) ** 0.5).to(bf)
        _conv_compare(torch, fc, fb, site, bf, g, worst_main, (x, wt))
        first, again = fc.conv_stats(x, wt, s, p), fc.conv_stats(x, wt, s, p)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{name} batch {n}: two B7 launches on one input differ")
        del first, again
        xc = x.permute(0, 3, 1, 2)           # channels-last NCHW view
        bound, by, _, ops = _conv_bound(*site[1:], 2)
        ms = _graph_ms(torch, lambda i: fc.conv_stats(x, wt, s, p), 2)
        per_site.append({
            "site": name, "shape": list(site[1:]),
            "sites": sum(t[1:] == site[1:] for t in all_main),
            "ms": ms, "bound_ms": bound, "bound_by": by,
            "library_ms": _graph_ms(
                torch, lambda i: F.conv2d(xc, wt, None, s, p), 2),
            "tflops": ops / ms / 1e9})
        del x, wt, xc
    weighted = {key: sum(r[key] * r["sites"] for r in per_site)
                for key in ("ms", "bound_ms", "library_ms")}
    check(sum(r["sites"] for r in per_site) == RESNET_SITES,
          "per-site multiplicities do not add up to 53")
    log("fused_kernels", check=f"batch {n}", sites=len(main_sites),
        dtypes="bfloat16", relu="on,off", max_abs_err=worst_main,
        repeat="bit-equal", ok=True)
    log("fused_kernels", timing=f"B7 bf16 at each distinct site, batch {n}"
        " (cuDNN: F.conv2d on the channels-last view, no statistics)",
        per_site=per_site, weighted_by_sites_ms=weighted)

    # timing at the main path's batch-256 shapes, bf16, each kernel first
    # checked on the tensors it is timed on
    t = {}
    convs = {"stem_s2d": (n, 115, 115, 12, 64, 4, 1, 0),
             "stage1_3x3": (n, 56, 56, 64, 64, 3, 1, 1)}
    for key, (nn_, h, w, cin, cout, k, s, p) in convs.items():
        x = torch.randn(nn_, h, w, cin, generator=g, device="cuda").to(bf)
        wt = (torch.randn(cout, cin, k, k, generator=g, device="cuda")
              * 0.05).to(bf)
        _conv_compare(torch, fc, fb, (f"timed {key}", nn_, h, w, cin, cout,
                                      k, s, p), bf, g, worst_main, (x, wt))
        xc = x.permute(0, 3, 1, 2)           # channels-last NCHW view
        t[f"{key}_conv_stats"] = _graph_ms(
            torch, lambda i: fc.conv_stats(x, wt, s, p), 2)
        t[f"{key}_conv_stats_plain"] = _graph_ms(
            torch, lambda i: fc.conv_stats_plain(x, wt, s, p), 2)
        # the library yardstick: cuDNN's conv alone (no statistics)
        t[f"{key}_conv_library"] = _graph_ms(
            torch, lambda i: F.conv2d(xc, wt, None, s, p), 2)
        bound, by, nbytes, ops = _conv_bound(nn_, h, w, cin, cout, k, s, p, 2)
        t.update({f"{key}_conv_stats_bound": bound,
                  f"{key}_conv_stats_bound_by": by,
                  f"{key}_conv_stats_bytes": nbytes,
                  f"{key}_conv_stats_ops": ops})
        del x, wt, xc
    # the BN epilogues of the stem ([n·112·112, 64]) and of stage 1
    # ([n·56·56, 256]; the kernels line's shape)
    t.update(_bn_timings(torch, fb, g, n, 112, 64, "stem_epilogue_",
                         worst_main))
    t.update(_bn_timings(torch, fb, g, n, 56, 256, "", worst_main))
    log("fused_kernels", timing=f"batch {n}, bf16: B7 at the s2d stem "
        f"[{n},115,115,12] 4x4 and stage-1 [{n},56,56,64] 3x3; B5/B6 with "
        f"relu at the stem's [{n * 112 * 112}, 64] (stem_epilogue_*) and "
        f"stage 1's [{n * 56 * 56}, 256] epilogues", ms=t,
        max_abs_err_main_batch=worst_main)
    t["b7_sites_weighted"] = weighted
    return {k: max(worst[k], worst_main[k]) for k in worst}, t


# -- phase 12: ResNet-50 training --------------------------------------------

# bench.py's ResNet-50 step at lr 0.01 where bench.py has 0.1: on the
# repeated batch of random images lr 0.1 lowers the loss for 10 steps and
# then diverges in every path, kernels on and off alike (PR 3's second
# chip run: 7.09 -> 5.45 at step 10, then 7.54, 7.55, 9.34 with the
# kernels; 7.09 -> 5.48, then 6.83, 7.27, 8.84 with cuDNN and the plain
# BN).  A step's time does not depend on the rate.
RESNET = dict(batch=256, hw=224, classes=1000, warmup=3, steps=10, lr=0.01,
              momentum=0.9)
RESNET_SITES = 53
RESNET_PARITY = dict(batch=8, steps=3)
# kernels on against off (cuDNN conv, plain BN) in f32, from the same
# weights, one training-mode forward and backward:
#  * loss: 1e-3.  The two paths differ by f32 summation order (~1e-6 of
#    each conv output), which 53 conv+BN sites carry to the logits as
#    ~1e-5 relative; the loss (~7) moves by ~1e-4;
#  * running statistics after the forward: 1e-3 of max(1, |ref|) (they
#    are the batch moments of each site: ~1e-5 relative);
#  * gradients: 1e-1 of each tensor's L2 norm.  A ReLU gate is
#    discontinuous: where a pre-activation lies within ~1e-5 of 0 (tens of
#    the ~10^7 ReLU inputs of a batch-8 step) the two paths can gate it
#    differently, and that element's gradient flows upstream in one path
#    only.  The CPU parity test (tests/test_torch_resnet.py) measured a
#    single such flip moving a stem gradient by 4% of its max, and this
#    phase run on the CPU (the kernels' plain versions against the plain
#    path, batch 4 at 64 px) gave a median of 2.2% and a worst of 3.0% of
#    the norm; hence a norm limit, not an elementwise one.  Each kernel's
#    backward is held elementwise in fused_kernels.
RESNET_LOSS_ATOL = 1e-3
RESNET_STATS_RTOL = 1e-3
RESNET_GRAD_L2_RTOL = 1e-1


def _resnet(torch, seed):
    """ResNet-50 NHWC with random f32 weights from ``seed``."""
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(data_format="NHWC", device="cuda")
    return model.init_weights(torch.Generator(device="cuda")
                              .manual_seed(seed))


def _resnet_batch(torch, batch, seed):
    """bench.py's ResNet-50 batch: N(0, 1) NHWC f32 images and labels in
    [0, 1000), drawn on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch, RESNET["hw"], RESNET["hw"], 3, generator=g,
                    device="cuda")
    y = torch.randint(0, RESNET["classes"], (batch,), generator=g,
                      device="cuda")
    return x, y


def _resnet_step(torch, model, bf16=True):
    """bench.py's step (at RESNET's learning rate): Momentum(momentum 0.9),
    cross entropy, bf16 compute over the f32 masters (f32 throughout
    without ``bf16``)."""
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel import TrainStep
    opt = Momentum(parameters=model.parameters(),
                   learning_rate=RESNET["lr"], momentum=RESNET["momentum"])
    return TrainStep(model, opt, loss_fn=CrossEntropyLoss(),
                     compute_dtype=torch.bfloat16 if bf16 else None)


def _fused_counts(reset=False):
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    out = fb.launch_counts(reset)
    out["conv_stats"] = fc.conv_stats.launches
    if reset:
        fc.conv_stats.launches = 0
    return out


def _fused_flags(flags, conv, bn):
    flags.set_flags({"FLAGS_use_pallas_fused_conv": conv,
                     "FLAGS_use_pallas_fused_bn": bn})


def _timed_steps(torch, step, batch, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step((batch[0],), batch[1]) for _ in range(n)]
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def phase_resnet_train(torch, seed):
    """The main path: ResNet-50 NHWC, Momentum, TrainStep with
    CrossEntropyLoss, bf16 compute over f32 masters, batch 256 at 224 px
    (halved while it does not fit), the same batch every step."""
    model = _resnet(torch, seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch_n = RESNET["batch"]
    while True:
        try:
            batch = _resnet_batch(torch, batch_n, seed)
            first = []
            for _ in range(2):
                model.load_state_dict(init)
                first.append(float(_resnet_step(torch, model)(
                    (batch[0],), batch[1])))
            break
        except torch.cuda.OutOfMemoryError:
            check(batch_n > 8, "ResNet-50 does not fit at batch 8")
            batch_n //= 2
            log("resnet_train", out_of_memory=True, halving_to=batch_n)
            torch.cuda.empty_cache()
    check(first[0] == first[1], f"same seed, first losses {first} differ")
    model.load_state_dict(init)
    step = _resnet_step(torch, model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _fused_counts(reset=True)             # the path's run: counts from 0
    losses, _ = _timed_steps(torch, step, batch, RESNET["warmup"])
    timed, dt = _timed_steps(torch, step, batch, RESNET["steps"])
    launches = _fused_counts()
    losses = [float(x) for x in losses + timed]
    n = RESNET["warmup"] + RESNET["steps"]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    want = {"conv_stats": RESNET_SITES * n, "bn_apply": RESNET_SITES * n,
            "bn_bwd_reduce": RESNET_SITES * n, "bn_bwd_dx": RESNET_SITES * n,
            "bn_moments": 0}
    check(launches == want, f"launches {launches}, want {want} "
          f"({RESNET_SITES} sites x {n} steps)")
    out = {"config": "resnet50(data_format='NHWC')", "batch": batch_n,
           "image": RESNET["hw"], "compute_dtype": "bfloat16",
           "optimizer": f"Momentum(lr={RESNET['lr']}, momentum=0.9)",
           "steps": n,
           "timed_steps": RESNET["steps"],
           "img_per_s": round(batch_n * RESNET["steps"] / dt, 1),
           "ms_per_step": round(dt / RESNET["steps"] * 1e3, 3),
           "first_loss_same_seed": first, "losses": [round(x, 5)
                                                      for x in losses],
           "launches": launches,
           "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 2)}
    log("resnet_train", **out)
    return out, model, step, batch, init


def phase_resnet_profile(torch, step, batch):
    """One bf16 ResNet-50 step traced with torch.profiler: device busy
    time, idle share against the untraced step, kernel time by name and
    the share of the fused kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, dt = _timed_steps(torch, step, batch, 2)
    step_ms = dt / 2 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _timed_steps(torch, step, batch, 1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {"step_ms": round(step_ms, 3)}
    if busy <= 0:
        out["device_busy_ms"] = "not measured (no CUDA events)"
    else:
        # the kernels of csrc/fused_conv.cu and csrc/fused_bn.cu by their
        # demangled names (conv_stats: the bf16 tensor-core kernel and
        # the f32 one)
        names = {"conv_stats": "::conv_stats_",
                 "bn_apply": "(anonymous namespace)::apply_kernel<",
                 "bn_bwd_reduce": "(anonymous namespace)::bwd_reduce_kernel<",
                 "bn_bwd_dx": "(anonymous namespace)::bwd_dx_kernel<",
                 "reduce_partials": "bn::reduce_partials_kernel("}
        fused = {k: sum(e.self_device_time_total for e in kernels
                        if v in e.key) / 1e3 for k, v in names.items()}
        check(fused["conv_stats"] > 0, "resnet_profile: no B7 kernel time "
              f"among the traced kernels {[e.key[:60] for e in kernels]}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        out.update(
            device_busy_ms=round(busy, 3),
            device_idle_share=round(max(0.0, 1 - busy / step_ms), 4),
            kernel_launches=sum(e.count for e in kernels),
            fused_ms=fused,
            conv_stats_share=round(fused["conv_stats"] / busy, 4),
            fused_share=round(sum(fused.values()) / busy, 4),
            top_kernels=[{"name": e.key[:90], "calls": e.count,
                          "ms": round(e.self_device_time_total / 1e3, 3)}
                         for e in top])
    log("resnet_profile", **out)
    return out


def phase_resnet_paths(torch, model, init, batch):
    """The JAX package's other configurations of this path, from the
    main path's weights and batch: fused conv off with fused BN on (B5
    stats and apply, B6), then both off (cuDNN conv, plain BN), then the
    kernels-on path again; 3 warm-up and 10 timed steps each, as the main
    path, so that
    their loss trajectories on the repeated batch compare with it.  Counts
    read from 0 just before each."""
    from paddle_tpu_torch.framework import flags
    snap = flags.flags_snapshot()
    out = {}
    try:
        for name, conv, bn in (("bn_path", False, True),
                               ("kernels_off", False, False),
                               ("kernels_on", True, True)):
            _fused_flags(flags, conv, bn)
            model.load_state_dict(init)
            step = _resnet_step(torch, model)
            _fused_counts(reset=True)
            warm, _ = _timed_steps(torch, step, batch, RESNET["warmup"])
            timed, dt = _timed_steps(torch, step, batch, RESNET["steps"])
            launches = _fused_counts()
            losses = [float(x) for x in warm + timed]
            check(all(np.isfinite(losses)), f"{name}: losses {losses}")
            n = RESNET["warmup"] + RESNET["steps"]
            want = {"kernels_off": dict.fromkeys(launches, 0),
                    "bn_path": {"conv_stats": 0,
                                **dict.fromkeys(("bn_moments", "bn_apply",
                                                 "bn_bwd_reduce",
                                                 "bn_bwd_dx"),
                                                RESNET_SITES * n)},
                    "kernels_on": {"conv_stats": RESNET_SITES * n,
                                   "bn_moments": 0,
                                   **dict.fromkeys(("bn_apply",
                                                    "bn_bwd_reduce",
                                                    "bn_bwd_dx"),
                                                   RESNET_SITES * n)}}[name]
            check(launches == want, f"{name}: launches {launches}, want "
                  f"{want}")
            out[name] = {"ms_per_step": round(dt / RESNET["steps"] * 1e3,
                                              3),
                         "losses": [round(x, 5) for x in losses],
                         "launches": launches}
    finally:
        flags.flags_restore(snap)
    log("resnet_paths", batch=batch[0].shape[0], **out)
    return out


def phase_resnet_parity(torch, seed):
    """f32, batch 8 at 224 px: one training-mode forward and backward and
    then 3 Momentum steps from the same weights, kernels on against off
    (cuDNN conv and the plain BN)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.nn import CrossEntropyLoss
    model = _resnet(torch, seed + 1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    x, y = _resnet_batch(torch, RESNET_PARITY["batch"], seed + 1)
    runs = {}
    snap = flags.flags_snapshot()
    try:
        for on in (True, False):
            _fused_flags(flags, on, on)
            model.load_state_dict(init)
            model.train()
            before = _fused_counts()
            loss = CrossEntropyLoss()(model(x), y)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            stats = {n: b.clone() for n, b in model.named_buffers()}
            model.load_state_dict(init)
            step = _resnet_step(torch, model, bf16=False)
            losses = [float(step((x,), y))
                      for _ in range(RESNET_PARITY["steps"])]
            after = _fused_counts()
            runs[on] = (float(loss), grads, stats, losses,
                        after["conv_stats"] - before["conv_stats"])
    finally:
        flags.flags_restore(snap)
    check(runs[True][4] == RESNET_SITES * (1 + RESNET_PARITY["steps"])
          and runs[False][4] == 0,
          f"parity: B7 launches on {runs[True][4]}, off {runs[False][4]}")
    loss_err = abs(runs[True][0] - runs[False][0])
    check(loss_err <= RESNET_LOSS_ATOL,
          f"parity: first losses {runs[True][0]} vs {runs[False][0]}")
    names = [n for n, _ in model.named_parameters()]
    grad_rel = {n: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                for n, a, b in zip(names, runs[True][1], runs[False][1])}
    worst_g = max(grad_rel, key=grad_rel.get)
    check(grad_rel[worst_g] <= RESNET_GRAD_L2_RTOL,
          f"parity: gradient of {worst_g} differs by {grad_rel[worst_g]} "
          "of its norm")
    stat_err = {n: ((runs[True][2][n] - runs[False][2][n]).abs()
                    / runs[False][2][n].abs().clamp_min(1.0)).max().item()
                for n in runs[True][2]}
    worst_s = max(stat_err, key=stat_err.get)
    check(stat_err[worst_s] <= RESNET_STATS_RTOL,
          f"parity: running statistic {worst_s} differs by "
          f"{stat_err[worst_s]}")
    for on in (True, False):
        ls = runs[on][3]
        check(all(np.isfinite(ls)) and ls[-1] < ls[0],
              f"parity: kernels {'on' if on else 'off'} losses {ls}")
    log("resnet_parity", dtype="float32", batch=RESNET_PARITY["batch"],
        first_loss_kernels=runs[True][0], first_loss_plain=runs[False][0],
        loss_abs_diff=loss_err, loss_atol=RESNET_LOSS_ATOL,
        grad_worst=worst_g, grad_l2_rel_diff=grad_rel[worst_g],
        grad_median_l2_rel_diff=float(np.median(list(grad_rel.values()))),
        grad_l2_rtol=RESNET_GRAD_L2_RTOL, stats_worst=worst_s,
        stats_rel_diff=stat_err[worst_s], stats_rtol=RESNET_STATS_RTOL,
        losses_kernels=runs[True][3], losses_plain=runs[False][3])


def _fused_kernel_records(worst, t, resnet, paths):
    """The kernels line's entries of B5-B7: times at the batch-256 shapes
    (B7 at the stage-1 3x3 conv, B5/B6 at the [802816, 256] epilogue);
    launches of the main path's run (B5 stats: of the fused-BN path's)."""
    src = "paddle_tpu_torch/csrc/"
    rows = (
        ("bn_stats", "fused_bn.cu", "fused_bn.py:60", "bn_moments",
         paths["bn_path"]["launches"], "bn_stats_library"),
        ("bn_apply", "fused_bn.cu", "fused_bn.py:73", "bn_apply",
         resnet["launches"], "bn_apply_library"),
        ("bn_bwd_reduce", "fused_bn.cu", "fused_bn.py:114", "bn_bwd_reduce",
         resnet["launches"], "bn_bwd_reduce_library"),
        ("bn_bwd_dx", "fused_bn.cu", "fused_bn.py:136", "bn_bwd_dx",
         resnet["launches"], "bn_bwd_dx_library"),
        ("conv_stats", "fused_conv.cu", "fused_conv.py:128", "conv_stats",
         resnet["launches"], "stage1_3x3_conv_library"),
    )
    out = []
    for name, file, line, count, launches, lib in rows:
        key = "stage1_3x3_conv_stats" if name == "conv_stats" else name
        out.append({
            "name": name, "route": "cuda", "source": src + file,
            "replaces": f"paddle_tpu/ops/pallas/{line}",
            "launches": launches[count],
            # apply and dx are checked bit-equal to their plain versions
            "max_abs_err": worst.get(name, 0.0),
            "ms": t[key], "plain_ms": t[key + "_plain"],
            "bound_ms": t[key + "_bound"], "bound_by": t[key + "_bound_by"],
            # var_mean (stats); ATen's batch norm forward (apply, which
            # also takes the statistics) and backward (reduce: dgamma and
            # dbeta; dx: dx as well); cuDNN's conv computes no statistics
            "library_ms": t[lib]})
    return out


# -- main --------------------------------------------------------------------

# -- phase 13: Wide&Deep CTR over the PS tables (bench.py:330-396) ----------

# bench.py's on-chip bench_wide_deep: WideDeep() defaults (26 slots,
# emb_dim 16, 13 dense features, hidden 400 x 3), adagrad at 0.05 on both
# sparse tables, Adam 1e-3 on the dense side, batch 32768, the device
# cache at 2^20 rows, the bf16 feature wire; one batch read through the
# MultiSlot file path, 2 warm-up and 8 timed step_async steps
WIDE_DEEP = dict(batch=32768, files=4, capacity=1 << 20, lr=1e-3,
                 sparse_lr=0.05, warmup=2, steps=8)
# the mode checks (f32 wire): 6 seeded batches of 8192 at full width,
# cache against pull/push, a capacity that evicts, the device dedup
WD_MODES = dict(batch=8192, steps=6)
# the card against the port on the CPU: full width, batch 1024, 3 steps
WD_CPU = dict(batch=1024, steps=3)
# Limits of the card against the CPU.  The losses: rtol 1e-4 (the GEMMs
# sum in other orders; JAX's cache-against-pull/push limit is 2e-4).
# Each dense parameter's and each table's change over the run, held in
# norm: |change card - change cpu| <= 1e-3 |change cpu|.  Not element by
# element: the first Adam and adagrad steps move an element by about
# lr x sign(g), so a gradient element within rounding of 0 can move by 2
# lr on one device and not on the other (seq2seq_parity above finds the
# same for Adam's eps).
WD_CPU_LOSS_RTOL = 1e-4
WD_CPU_CHANGE_RTOL = 1e-3


def _wd_model(torch, seed, device, **kw):
    from paddle_tpu_torch.rec.wide_deep import WideDeep
    torch.manual_seed(seed)
    return WideDeep(sparse_lr=WIDE_DEEP["sparse_lr"], device=device, **kw)


def _wd_batches(seed, n, batch):
    from paddle_tpu_torch.rec.wide_deep import synthetic_ctr_batch
    return [synthetic_ctr_batch(batch, seed=seed * 1000 + 7 + s)
            for s in range(n)]


def _wd_run(torch, seed, batches, device="cuda", state=None, **kw):
    """One trainer over ``batches`` (f32 wire): the losses, the dense
    parameters and both tables' rows of every id seen after flush()."""
    from paddle_tpu_torch.rec.wide_deep import WideDeepTrainer
    m = _wd_model(torch, seed, device)
    if state is not None:
        m.load_state_dict(state)
    t = WideDeepTrainer(m, lr=WIDE_DEEP["lr"], feature_wire_dtype="float32",
                        device=device, **kw)
    losses = [t.step(*b) for b in batches]
    t.flush()
    t.close()
    uniq = np.unique(np.concatenate([b[0].ravel() for b in batches]))
    return {"losses": losses, "trainer": t, "uniq": uniq,
            "params": {n: p.detach().cpu().numpy()
                       for n, p in m.named_parameters()},
            "rows": [m.client.pull_sparse(k, uniq) for k in (0, 1)]}


def _wd_same(a, b):
    return a["losses"] == b["losses"] \
        and all(np.array_equal(x, y) for x, y in zip(a["rows"], b["rows"])) \
        and all(np.array_equal(a["params"][n], b["params"][n])
                for n in a["params"])


def _wd_modes(torch, seed):
    """Cache against pull/push, an evicting capacity against the full one,
    the device dedup against the host np.unique: all bit for bit."""
    from paddle_tpu_torch.framework import flags
    batches = _wd_batches(seed, WD_MODES["steps"], WD_MODES["batch"])
    cache = _wd_run(torch, seed, batches)
    pull = _wd_run(torch, seed, batches, device_cache=False)
    check(_wd_same(cache, pull),
          f"wide_deep: cache mode {cache['losses']} against pull/push "
          f"{pull['losses']}: not bit for bit (rows equal "
          f"{[np.array_equal(x, y) for x, y in zip(cache['rows'], pull['rows'])]})")
    per_batch = max(len(np.unique(b[0])) for b in batches)
    cap = int(per_batch * 1.25)
    check(cap < len(cache["uniq"]), f"wide_deep: capacity {cap} holds "
          f"the run's {len(cache['uniq'])} ids")
    evict = _wd_run(torch, seed, batches, cache_capacity=cap)
    ev = evict["trainer"]._slot_dir.evictions
    check(ev > 0 and _wd_same(evict, cache),
          f"wide_deep: capacity {cap}: {ev} evictions, losses "
          f"{evict['losses']} against {cache['losses']}")
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_wide_deep_device_dedup": True})
        dedup = _wd_run(torch, seed, batches)
    finally:
        flags.flags_restore(snap)
    check(_wd_same(dedup, cache), f"wide_deep: device dedup losses "
          f"{dedup['losses']} against {cache['losses']}")
    return {"batches": len(batches), "batch": WD_MODES["batch"],
            "losses": [round(x, 6) for x in cache["losses"]],
            "cache_equals_pullpush_bits": True,
            "evicting_capacity": cap, "run_ids": len(cache["uniq"]),
            "evictions": ev, "evicting_equals_full_bits": True,
            "device_dedup_equals_host_bits": True}


def _wd_change_err(after_card, after_cpu, before):
    """|change card - change cpu| / |change cpu|, in norm."""
    d_cpu = after_cpu.astype(np.float64) - before
    d_card = after_card.astype(np.float64) - before
    return float(np.linalg.norm(d_card - d_cpu)
                 / max(np.linalg.norm(d_cpu), 1e-30))


def _wd_against_cpu(torch, seed):
    """The card's trainer against the port's on the CPU: the same dense
    init (the CPU model's weights loaded into the card's), the same
    tables' seeds and batches, TF32 off, the f32 wire."""
    from paddle_tpu_torch.distributed.ps import SparseTable
    batches = _wd_batches(seed + 1, WD_CPU["steps"], WD_CPU["batch"])
    cpu = _wd_run(torch, seed, batches, device="cpu")
    init = _wd_model(torch, seed, "cpu").state_dict()
    card = _wd_run(torch, seed, batches, state=init)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    before = {n: v.numpy().astype(np.float64) for n, v in init.items()}
    param_err = {n: _wd_change_err(card["params"][n], cpu["params"][n],
                                   before[n]) for n in before}
    # the tables' first rows: a fresh table pulled batch by batch draws
    # the rows the runs' first misses drew
    fresh = []
    for d in (1, 16):
        table = SparseTable(dim=d, optimizer="adagrad")
        for b in batches:
            table.pull(np.unique(b[0]))
        fresh.append(table.pull(cpu["uniq"]).astype(np.float64))
    row_err = [_wd_change_err(a, b, f)
               for a, b, f in zip(card["rows"], cpu["rows"], fresh)]
    max_abs = max(float(np.abs(a - b).max())
                  for a, b in zip(card["rows"], cpu["rows"]))
    check(loss_err <= WD_CPU_LOSS_RTOL, f"wide_deep: card losses "
          f"{card['losses']} against the CPU's {cpu['losses']}")
    worst = max(max(param_err.values()), max(row_err))
    check(worst <= WD_CPU_CHANGE_RTOL,
          f"wide_deep: card against CPU change errors: params {param_err}, "
          f"rows {row_err}")
    return {"batch": WD_CPU["batch"], "steps": WD_CPU["steps"],
            "losses_card": [round(x, 7) for x in card["losses"]],
            "loss_rel_err": loss_err,
            "param_change_rel_err": {n: float(f"{e:.3g}")
                                     for n, e in param_err.items()},
            "row_change_rel_err": row_err, "row_max_abs_diff": max_abs,
            "limits": {"loss_rtol": WD_CPU_LOSS_RTOL,
                       "change_rtol": WD_CPU_CHANGE_RTOL}}


def _wd_data(seed, tmp):
    """bench.py's data path: write_ctr_files -> ctr_dataset ->
    load_into_memory -> local_shuffle -> batch_from_feed, one batch."""
    from paddle_tpu_torch.rec.wide_deep import (batch_from_feed, ctr_dataset,
                                                write_ctr_files)
    files = write_ctr_files(tmp, WIDE_DEEP["batch"], n_files=WIDE_DEEP["files"],
                            seed=seed)
    ds = ctr_dataset(files, batch_size=WIDE_DEEP["batch"])
    ds.load_into_memory()
    ds.set_shuffle_seed(seed)
    ds.local_shuffle()
    return batch_from_feed(next(iter(ds)))


def _wd_idle(torch, run):
    """``run()`` traced with torch.profiler: device busy time over the
    wall time of the run (kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    if busy <= 0:
        return {"device_idle_share": "not measured (no CUDA events)"}
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    return {"traced_wall_s": round(wall, 4), "device_busy_s": round(busy, 4),
            "device_idle_share": round(1 - busy / wall, 4),
            "device_ops": sum(e.count for e in ev),
            "top_device_ops": [{"name": e.key[:60], "calls": e.count,
                                "ms": round(e.self_device_time_total / 1e3,
                                            3)} for e in top]}


def phase_wide_deep(torch, seed, card):
    """bench.py's Wide&Deep CTR at full width on the card in device-cache
    mode: the bf16-wire run (finite losses that fall, host and in-graph
    examples/s, idle share, cache counts, host prep a step), read-through
    eval against the flushed tables, the mode checks and the CPU
    parity."""
    import tempfile
    from paddle_tpu_torch.rec.wide_deep import WideDeepTrainer
    out, t_phase = {}, time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["modes"] = _wd_modes(torch, seed)
    out["modes"]["s"] = round(time.perf_counter() - t0, 1)
    log("wide_deep", check="modes", **out["modes"])
    t0 = time.perf_counter()
    out["cpu"] = _wd_against_cpu(torch, seed)
    out["cpu"]["s"] = round(time.perf_counter() - t0, 1)
    log("wide_deep", check="card_against_cpu", **out["cpu"])
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ctr_", dir=os.path.join(ROOT, "build"))
    try:
        ids, dense, label = _wd_data(seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    data_s = time.perf_counter() - t0
    m = _wd_model(torch, seed, "cuda")
    t = WideDeepTrainer(m, lr=WIDE_DEEP["lr"],
                        cache_capacity=WIDE_DEEP["capacity"],
                        feature_wire_dtype="bfloat16")
    check(t._use_cache, "wide_deep: the trainer is not in device-cache mode")
    B, n = WIDE_DEEP["batch"], WIDE_DEEP["steps"]
    losses = [t.step(ids, dense, label) for _ in range(WIDE_DEEP["warmup"])]
    prep = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = []
    for _ in range(n):
        pending.append(t.step_async(ids, dense, label))
        prep.append(t.last_prep_s)
    losses += [float(x) for x in pending]
    host_s = time.perf_counter() - t0

    def traced():
        for _ in range(n):
            t.step_async(ids, dense, label)
    idle = _wd_idle(torch, traced)
    sec = t.in_graph_step_s(ids, dense, label)
    losses.append(t.step(ids, dense, label))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"wide_deep: bf16-wire losses {losses}")
    d = t._slot_dir
    sub = slice(0, 4096)
    m.eval()
    with torch.no_grad():
        through = m(ids[sub], dense[sub]).cpu()
        t.flush()
        for emb in (m.wide_emb, m.deep_emb):
            emb._cache_read = None
        host = m(ids[sub], dense[sub]).cpu()
    check(torch.equal(through, host), "wide_deep: the read-through eval "
          f"differs from the flushed tables' by "
          f"{float((through - host).abs().max())}")
    out["train"] = {
        "card": card, "batch": B, "unique_ids": len(np.unique(ids)),
        "losses": [round(x, 6) for x in losses],
        "host_examples_per_s": round(B * n / host_s, 1),
        "in_graph_step_ms": round(sec * 1e3, 4),
        "in_graph_examples_per_s": round(B / sec, 1),
        "host_prep_s_per_step": round(float(np.mean(prep)), 5),
        "host_s_per_step": round(host_s / n, 5),
        "cache_hit_rate": round(d.hit_rate, 5), "cache_hits": d.hits,
        "cache_misses": d.misses, "cache_evictions": d.evictions,
        "tier_hits": dict(t.tier_hits), "data_path_s": round(data_s, 2),
        "read_through_eval_equal_bits": True,
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
        **idle}
    log("wide_deep", check="train", **out["train"])
    log("wide_deep", total_s=round(time.perf_counter() - t_phase, 1))
    del t, m
    return out


# bench.py's LeNet (bench_lenet_static): batch 128, 200 steps of seeded
# N(0, 1) images with random labels, SGD(0.01); one epoch of warm-up,
# then two timed epochs, the best kept
LENET = dict(batch=128, steps=200, lr=0.01, timed=2, trace_steps=20)
LENET_OPS = ["conv2d", "relu", "max_pool", "conv2d", "relu", "max_pool",
             "flatten_contiguous_range", "linear", "relu", "linear", "relu",
             "linear", "softmax_with_cross_entropy", "backward", "sgd"]
LENET_EQ_STEPS = 5                  # captured against eager, bit for bit
LENET_CPU = dict(batch=128, steps=3)
# the card against the port on the CPU, TF32 off, set at ten times the
# card's readings (H100, 700 W): losses within 1.01e-7 relative (cuDNN's
# and the CPU's f32 sums differ in order only); each parameter's change
# over the 3 SGD steps within 3.1e-6 of its norm, worst the first conv's
# weight, whose gradient sums 128 x 28 x 28 products an element
LENET_CPU_LOSS_RTOL = 1e-6
LENET_CPU_CHANGE_RTOL = 3e-5
# bench's SGD(0.01) takes the loss of one repeated batch of 128 only to
# 0.86 of its start in 30 steps on the CPU, Adam(3e-3) to 0.07
# (``static_lenet_probe.py --cpu-fit``)
LENET_FIT = dict(steps=30, lr=3e-3)


def _lenet_program(paddle, static, optimizer):
    """bench_lenet_static's program, paddle read as paddle_tpu_torch;
    ``optimizer(paddle)`` minimizes the loss.  Returns (main, startup,
    loss, test, logits): ``test`` is the test clone taken before
    ``minimize``, as a Paddle user takes it."""
    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(main, startup):
            img = static.data("img", [None, 1, 28, 28], "float32")
            label = static.data("label", [None], "int64")
            h = static.nn.conv2d(img, 6, 5, padding=2, act="relu")
            h = paddle.nn.functional.max_pool2d(h, 2, 2)
            h = static.nn.conv2d(h, 16, 5, act="relu")
            h = paddle.nn.functional.max_pool2d(h, 2, 2)
            h = paddle.flatten(h, start_axis=1)
            h = static.nn.fc(h, 120, activation="relu")
            h = static.nn.fc(h, 84, activation="relu")
            logits = static.nn.fc(h, 10)
            loss = paddle.nn.functional.cross_entropy(logits, label)
            test = main.clone(for_test=True)
            optimizer(paddle).minimize(loss)
    finally:
        paddle.disable_static()
    return main, startup, loss, test, logits


def _lenet_stacks(seed, steps, batch):
    """bench.py's epoch: N(0, 1) images, then labels, from one RNG."""
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(steps, batch, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (steps, batch)).astype("int64")}


def _lenet_feeds(seed, steps, batch):
    st = _lenet_stacks(seed, steps, batch)
    return [{k: v[i] for k, v in st.items()} for i in range(steps)]


def _scope_copy(torch, static, src, names, device):
    sc = static.Scope()
    for n in names:
        sc.set_var(n, src.find_var(n).detach().to(device).clone())
    return sc


def _lenet_captured_vs_eager(torch, static, main, loss, init, names, seed):
    """``LENET_EQ_STEPS`` Executor.run steps from two copies of one scope,
    captured and not (use_program_cache=False): every loss and every
    persistable bit for bit."""
    exe = static.Executor()
    cap = _scope_copy(torch, static, init, names, "cuda")
    eag = _scope_copy(torch, static, init, names, "cuda")
    feeds = _lenet_feeds(seed + 10, LENET_EQ_STEPS, LENET["batch"])
    a = [exe.run(main, feed=f, fetch_list=[loss], scope=cap)[0]
         for f in feeds]
    b = [exe.run(main, feed=f, fetch_list=[loss], scope=eag,
                 use_program_cache=False)[0] for f in feeds]
    check(len(exe.compile_events) == 1 and exe.captured_graphs(main),
          f"static_lenet: {len(exe.compile_events)} captures in "
          f"{LENET_EQ_STEPS} runs of one key")
    loss_diff = [float(abs(x - y)) for x, y in zip(a, b)]
    differ = [n for n in names
              if not torch.equal(cap.find_var(n), eag.find_var(n))]
    check(all(np.array_equal(x, y) for x, y in zip(a, b)) and not differ,
          f"static_lenet: captured run differs from eager: loss diffs "
          f"{loss_diff}, persistables {differ}")
    return {"steps": LENET_EQ_STEPS, "replays": LENET_EQ_STEPS - 1,
            "losses": [float(x) for x in a], "equal_bits": True,
            "persistables": len(names)}


def _lenet_against_cpu(torch, static, main, loss, init, names, seed):
    """The card's Executor (captured) against the port's on the CPU from
    one scope's copies: 3 steps at batch 128, TF32 off."""
    feeds = _lenet_feeds(seed + 1, LENET_CPU["steps"], LENET_CPU["batch"])
    runs = {}
    for dev in ("cuda", "cpu"):
        sc = _scope_copy(torch, static, init, names, dev)
        exe = static.Executor(None if dev == "cuda" else "cpu")
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=sc)[0]) for f in feeds]
        runs[dev] = (losses, {n: sc.find_var(n).cpu().numpy()
                              for n in main._parameters})
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    before = {n: init.find_var(n).cpu().numpy().astype(np.float64)
              for n in main._parameters}
    change_err = {n: _wd_change_err(runs["cuda"][1][n], runs["cpu"][1][n],
                                    before[n]) for n in before}
    out = {"batch": LENET_CPU["batch"], "steps": LENET_CPU["steps"],
           "losses_card": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
           "loss_rel_err": loss_err,
           "param_change_rel_err": {n: float(f"{e:.3g}")
                                    for n, e in change_err.items()},
           "limits": {"loss_rtol": LENET_CPU_LOSS_RTOL,
                      "change_rtol": LENET_CPU_CHANGE_RTOL}}
    log("static_lenet", check="card_against_cpu", **out)
    check(loss_err <= LENET_CPU_LOSS_RTOL, f"static_lenet: card losses "
          f"{runs['cuda'][0]} against the CPU's {runs['cpu'][0]}")
    check(max(change_err.values()) <= LENET_CPU_CHANGE_RTOL,
          f"static_lenet: card against CPU change errors {change_err}")
    return out


def _lenet_fit(torch, paddle, static, seed):
    """The program under Adam(3e-3) on one repeated batch: the loss after
    ``LENET_FIT['steps']`` steps under half the first, all finite."""
    main, startup, loss, _, _ = _lenet_program(
        paddle, static, lambda p: p.optimizer.Adam(
            learning_rate=LENET_FIT["lr"]))
    exe = static.Executor()
    sc = static.Scope()
    exe.run(startup, scope=sc)
    feed = _lenet_feeds(seed + 2, 1, LENET["batch"])[0]
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=sc)[0])
              for _ in range(LENET_FIT["steps"] + 1)]
    check(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
          f"static_lenet: Adam on one batch, losses {losses}")
    return {"optimizer": f"Adam({LENET_FIT['lr']})",
            "first": losses[0], "last": losses[-1],
            "ratio": losses[-1] / losses[0], "captures": len(
                exe.compile_events)}


def phase_static_lenet(torch, seed, card):
    """bench.py's LeNet through the static Program and Executor on the
    card: the captured-against-eager and card-against-CPU checks, then
    bench's epochs (warm-up + 2 timed), the in-graph rate, the kernel
    nodes a step, the idle share, and the fit check.  Returns the record
    and (main, test clone, logits, loss, the trained scope)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.profiler.cuda_graph import graph_kernel_nodes
    t_phase = time.perf_counter()
    B, n = LENET["batch"], LENET["steps"]
    main, startup, loss, test, logits = _lenet_program(
        paddle, static, lambda p: p.optimizer.SGD(learning_rate=LENET["lr"]))
    ops = [op.type for op in main.global_block().ops]
    check(ops == LENET_OPS, f"static_lenet: recorded ops {ops}")
    names = [v.name for v in main.list_vars() if v.persistable]
    paddle.seed(seed)
    init = static.Scope()
    static.Executor().run(startup, scope=init)
    out = {"card": card, "captured_vs_eager": _lenet_captured_vs_eager(
        torch, static, main, loss, init, names, seed)}
    log("static_lenet", check="captured_vs_eager", **out["captured_vs_eager"])
    out["cpu"] = _lenet_against_cpu(torch, static, main, loss, init, names,
                                    seed)

    stacks = {k: torch.from_numpy(v).cuda()
              for k, v in _lenet_stacks(seed, n, B).items()}
    exe = static.Executor()
    sc = _scope_copy(torch, static, init, names, "cuda")

    def epoch(data=stacks):
        return exe.train_from_dataset(main, dataset=data, fetch_list=[loss],
                                      scope=sc)[loss.name]

    t0 = time.perf_counter()
    losses = [epoch()]
    warm_s = time.perf_counter() - t0
    exe.mark_warmup()
    best = None
    for _ in range(LENET["timed"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(epoch())
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    captures = exe.compile_events_since_warmup()
    check(not captures, f"static_lenet: captures after warm-up {captures}")
    check(all(np.isfinite(x).all() and x.shape == (n,) for x in losses),
          "static_lenet: non-finite or misshapen epoch losses")
    graphs = exe.captured_graphs(main)
    check(len(graphs) == 1, f"static_lenet: {len(graphs)} graphs")
    nodes = graph_kernel_nodes(graphs[0])
    times = []
    for _ in range(2):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            graphs[0].replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    graph_s = min(times)
    trace = {k: v[:LENET["trace_steps"]] for k, v in stacks.items()}
    idle = _wd_idle(torch, lambda: epoch(trace))
    kinds = {}
    for name, _ in nodes:
        short = re.sub(r"^_Z\d+", "", name)[:48]
        kinds[short] = kinds.get(short, 0) + 1
    out["train"] = {
        "batch": B, "steps": n, "warmup_epoch_s": round(warm_s, 4),
        "best_epoch_s": round(best, 5),
        "host_img_per_s": round(B * n / best, 1),
        "in_graph_step_ms": round(graph_s / n * 1e3, 5),
        "in_graph_img_per_s": round(B * n / graph_s, 1),
        "kernel_nodes_per_step": len(nodes),
        # the feeds' slices into the graph's buffers, the fetch out
        "copies_per_step_outside_graph": len(stacks) + 1,
        "captures_after_warmup": len(captures),
        "captures_total": len(exe.compile_events),
        "epoch_mean_losses": [round(float(x.mean()), 6) for x in losses],
        "trace_steps": LENET["trace_steps"], **idle,
        "kernel_nodes_by_name": kinds}
    log("static_lenet", check="train", **out["train"])
    out["fit"] = _lenet_fit(torch, paddle, static, seed)
    log("static_lenet", check="fit", **out["fit"])
    log("static_lenet", total_s=round(time.perf_counter() - t_phase, 1))
    return out, (main, test, logits, loss, sc)


# phase 15: static_lenet's trained program as a static inference model.
# The Predictor against Executor.run of the test clone at these batches,
# three runs each (eager, capture, replay); five train steps after a
# static.save / deserialize_program + static.load round trip; the
# served model under bench_serving's traffic (DENSE: buckets 1-16, 2
# workers, 8 clients of 1-4 rows, 8 s) against LeNet's SLO; bench.py's
# inference timing (_infer_lat_ms, best of 20) at batch 1 and 2048
STATIC_INFER = dict(batches=(1, 16, 128), runs=3, train_steps=5,
                    max_batch=2048, lat_iters=20)
STATIC_INFER_SPEC = ([None, 1, 28, 28], "float32")


def _static_served_check(inference, model_dir, done):
    """Every served request against a second Predictor of the same
    directory on its own rows at the bucket it rode (requests of one
    bucket packed together, zero rows padding the last pass): bit for
    bit.  Returns the passes run."""
    ref = inference.create_predictor(inference.Config(model_dir))
    by_bucket = {}
    for r in done:
        by_bucket.setdefault(r[2], []).append(r)
    passes = 0
    for b, reqs in sorted(by_bucket.items()):
        i = 0
        while i < len(reqs):
            group, rows = [], 0
            while i < len(reqs) and rows + reqs[i][0].shape[0] <= b:
                group.append(reqs[i])
                rows += reqs[i][0].shape[0]
                i += 1
            xs = np.zeros((b, 1, 28, 28), np.float32)
            xs[:rows] = np.concatenate([g[0] for g in group])
            want = ref.run([xs])[0]
            passes += 1
            off = 0
            for x, out, _, _ in group:
                n = x.shape[0]
                check(out[0].shape == (n, 10) and np.array_equal(
                    out[0], want[off:off + n]),
                      f"static_infer: a {n}-row request served at bucket "
                      f"{b} differs from the Predictor's rows")
                off += n
    return passes


def phase_static_infer(torch, seed, card, lenet):
    """static_lenet's trained LeNet as a static inference model on the
    card: save_inference_model of the test clone, the Predictor against
    Executor.run bit for bit, a saved train program's next steps against
    the running one's bit for bit, the executor-backed Server under
    bench_serving's traffic (every row against the Predictor, bit for
    bit; no steady-state capture; the bucket-16 graph's nodes and device
    ms), and bench.py's batch-1 latency and batch-2048 rate."""
    from paddle_tpu_torch import inference, serving, static
    t_phase = time.perf_counter()
    main, test, logits, loss, sc = lenet
    laps = {}
    out = {"card": card}
    out_dir = os.path.join(ROOT, "build", "static_infer")
    shutil.rmtree(out_dir, ignore_errors=True)
    model_dir = os.path.join(out_dir, "lenet")

    t0 = time.perf_counter()
    exe = static.Executor()
    with static.scope_guard(sc):
        fetches = static.save_inference_model(model_dir, ["img"], [logits],
                                              exe, main_program=test)
    pred = inference.create_predictor(inference.Config(model_dir))
    ops = [op.type for op in pred._program.global_block().ops]
    check(fetches == [logits.name] and pred.get_input_names() == ["img"]
          and ops == LENET_OPS[:12] and pred._exe.device.type == "cuda"
          and pred._scope is not sc,
          f"static_infer: loaded program {ops}, feeds "
          f"{pred.get_input_names()}, device {pred._exe.device}")
    laps["save_load"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    rng = np.random.RandomState(seed + 20)
    for b in STATIC_INFER["batches"]:
        x = rng.randn(b, 1, 28, 28).astype("float32")
        feed = {"img": x, "label": np.zeros(b, "int64")}
        want = [exe.run(test, feed=feed, fetch_list=[logits], scope=sc)[0]
                for _ in range(STATIC_INFER["runs"])]
        got = [pred.run([x])[0] for _ in range(STATIC_INFER["runs"])]
        check(want[0].shape == (b, 10) and np.isfinite(want[0]).all()
              and all(np.array_equal(y, want[0]) for y in want + got),
              f"static_infer: at batch {b} the Predictor's logits differ "
              "from Executor.run's of the test clone (eager, captured, "
              "replayed)")
    out["predictor_vs_executor"] = {
        "batches": list(STATIC_INFER["batches"]),
        "runs_each": STATIC_INFER["runs"], "equal_bits": True,
        "predictor_captures": len(pred._exe.compile_events),
        "executor_captures": len(exe.compile_events)}
    laps["predictor_vs_executor"] = round(time.perf_counter() - t0, 2)
    log("static_infer", check="predictor_vs_executor",
        **out["predictor_vs_executor"])

    t0 = time.perf_counter()
    names = [v.name for v in main.list_vars() if v.persistable]
    prefix = os.path.join(out_dir, "train")
    with static.scope_guard(sc):
        static.save(main, prefix)
    feeds = _lenet_feeds(seed + 30, STATIC_INFER["train_steps"],
                         LENET["batch"])
    running = _scope_copy(torch, static, sc, names, "cuda")
    exe_a = static.Executor()
    la = [exe_a.run(main, feed=f, fetch_list=[loss], scope=running)[0]
          for f in feeds]
    prog = static.deserialize_program(static.load_from_file(
        prefix + ".pdmodel"))
    loaded = static.Scope()
    with static.scope_guard(loaded):
        static.load(prog, prefix)
    exe_b = static.Executor()
    lb = [exe_b.run(prog, feed=f, fetch_list=[loss.name], scope=loaded)[0]
          for f in feeds]
    differ = [n for n in names if not torch.equal(
        running.find_var(n), loaded.find_var(n).to(
            running.find_var(n).device))]
    check(all(np.array_equal(x, y) for x, y in zip(la, lb)) and not differ
          and [op.type for op in prog.global_block().ops] == LENET_OPS,
          f"static_infer: the reloaded train program's steps differ: "
          f"losses {la} against {lb}, persistables {differ}")
    out["train_round_trip"] = {
        "steps": len(feeds), "losses": [float(x) for x in lb],
        "equal_bits": True, "persistables": len(names),
        "captures": len(exe_b.compile_events)}
    laps["train_round_trip"] = round(time.perf_counter() - t0, 2)
    log("static_infer", check="train_round_trip", **out["train_round_trip"])

    t0 = time.perf_counter()
    name = "lenet_static"
    srv = serving.Server(serving.ServingConfig(workers=DENSE["workers"],
                                               buckets=DENSE["buckets"]))
    srv.register(name, model_dir, buckets=DENSE["buckets"],
                 input_specs=[STATIC_INFER_SPEC])
    try:
        srv.start()
        warmup_s = time.perf_counter() - t0
        rt = srv._models[name]
        sexe = rt.primary._exe
        check(rt.backend == "executor" and len(sexe.compile_events) ==
              len(DENSE["buckets"]) and all(
                  rt.executables[b].captured for b in DENSE["buckets"]),
              f"static_infer: warm-up captured {sexe.compile_events}")
        t1 = time.perf_counter()
        done, errors = _dense_traffic(srv, name, STATIC_INFER_SPEC, None,
                                      seed)
        laps["traffic"] = round(time.perf_counter() - t1, 2)
        st = srv.stats(name)
        steady = srv.compile_events_since_warmup()
        check(not errors, f"static_infer: client errors {errors[:4]}")
        check(not steady and st["steady_compiles"] == 0
              and st["backend"] == "executor",
              f"static_infer: steady-state captures {steady}")
        srv.assert_zero_steady_state_recompiles()
        check(st["completed"] == len(done) and len(done) > 0,
              f"static_infer: {st['completed']} completed, {len(done)} "
              "returned")
        graphs = {e.feeds[0].shape[0]: e.graph
                  for e in sexe._cache.values() if e.graph is not None}
        top = DENSE["buckets"][-1]
        check(sorted(graphs) == list(DENSE["buckets"]),
              f"static_infer: graphs for buckets {sorted(graphs)}")
        nodes = _graph_nodes(graphs[top], "")[1]
        replay_ms = _replay_ms(torch, graphs[top])
    finally:
        srv.stop()
    laps["serve"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    passes = _static_served_check(inference, model_dir, done)
    laps["served_check"] = round(time.perf_counter() - t0, 2)
    kinds = {}
    for kname, _ in nodes:
        short = re.sub(r"^_Z\d+", "", kname)[:48]
        kinds[short] = kinds.get(short, 0) + 1
    slo = DENSE_SLO_P99_MS["lenet"]
    out["serve"] = {
        "model": name, "input": STATIC_INFER_SPEC,
        "buckets": list(DENSE["buckets"]), "workers": DENSE["workers"],
        "clients": DENSE["clients"], "seconds": DENSE["seconds"],
        "warmup_s": round(warmup_s, 3), "qps": st["qps"],
        "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"], "slo_p99_ms": slo,
        "slo_met": st["p99_ms"] <= slo, "completed": st["completed"],
        "rows": sum(r[0].shape[0] for r in done),
        "batches": st["batches"], "avg_batch_rows": st["avg_batch_rows"],
        "padding_ratio": st["padding_ratio"],
        "steady_captures": len(steady),
        "kernel_nodes_per_replay": len(nodes),
        "replay_ms": round(replay_ms, 4),
        "served_equal_predictor": f"{len(done)}/{len(done)}",
        "check_passes": passes, "kernel_nodes_by_name": kinds}
    log("static_infer", check="serve", **out["serve"])

    t0 = time.perf_counter()
    x1 = rng.randn(1, 1, 28, 28).astype("float32")
    xm = rng.randn(STATIC_INFER["max_batch"], 1, 28, 28).astype("float32")
    for x in (x1, xm):
        for _ in range(2):              # eager, then the capture
            pred.run([x])
    b1_ms = _infer_lat_ms(pred, x1, STATIC_INFER["lat_iters"])
    bm_ms = _infer_lat_ms(pred, xm, STATIC_INFER["lat_iters"])
    laps["latency"] = round(time.perf_counter() - t0, 2)
    out["latency"] = {
        "batch1_ms": round(b1_ms, 4), "max_batch": STATIC_INFER["max_batch"],
        "max_batch_ms": round(bm_ms, 4),
        "max_batch_img_per_s": round(STATIC_INFER["max_batch"] / bm_ms * 1e3,
                                     1),
        "iters": STATIC_INFER["lat_iters"]}
    log("static_infer", check="latency", **out["latency"])
    shutil.rmtree(out_dir, ignore_errors=True)
    out["laps_s"] = laps
    log("static_infer", laps_s=laps,
        total_s=round(time.perf_counter() - t_phase, 1))
    return out


def _infer_lat_ms(predictor, x, iters):
    """bench.py's ``_infer_lat_ms``: best of ``iters`` single runs through
    ``Predictor.run`` (feeds in, the fetches' numpy copy out, which
    fences the run)."""
    best = None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = predictor.run([x])
        float(np.asarray(out[0]).ravel()[0])
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch")):
        print(f"chip_smoke: no paddle_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32 here
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _at("env")
    env = phase_env(torch)
    _at("build")
    phase_build()
    _at("kernels")
    worst, timing = phase_kernels(torch, args.seed)
    _at("fa_kernels")
    fa_worst, fa_timing, fa_s2s = phase_fa_kernels(torch, args.seed)
    _at("dense")
    dense = phase_dense(torch, args.seed, env["nvidia_smi"])
    _at("dense_b1_timing")
    dense_t = _dense_b1_timing(torch, args.seed, fa_worst)
    log("dense", b1_timing="B=16 N=12 S=128 H=64 bf16, no bias, model "
        "layout", ms=dense_t)
    dense_t32 = _dense_b1_timing(torch, args.seed, fa_worst, "float32")
    log("dense", b1_timing="B=16 N=12 S=128 H=64 f32 (bert_int8), no "
        "bias, model layout", ms=dense_t32)
    model = _gpt2(torch, args.seed, torch.bfloat16)
    _at("serving")
    served = phase_serving(torch, model, args.seed)
    _at("profile")
    phase_profile(torch, model, args.seed)
    _at("slots")
    slots = phase_slots(torch, model, args.seed)
    _at("sessions")
    sessions = phase_sessions(torch, model, args.seed)
    _at("spec")
    spec = phase_spec(torch, model, args.seed)
    _at("beam")
    beam = phase_beam(torch, model, args.seed)
    _at("batch_probe")
    phase_batch_probe(torch, model, args.seed)
    del model
    _at("e2e")
    phase_e2e(torch, args.seed)
    _at("decode_int8")
    dec = phase_decode_int8(torch, args.seed)
    torch.cuda.empty_cache()
    _at("train")
    trained, step, batch = phase_train(torch, args.seed)
    _at("train_profile")
    phase_train_profile(torch, step, batch)
    del step, batch
    _at("train_parity")
    phase_train_parity(torch, args.seed)
    torch.cuda.empty_cache()
    _at("seq2seq_train")
    s2s_trained, step, batch = phase_seq2seq_train(torch, args.seed)
    _at("seq2seq_profile")
    phase_train_profile(torch, step, batch, "seq2seq_profile")
    del step, batch
    torch.cuda.empty_cache()
    _at("seq2seq_parity")
    phase_seq2seq_parity(torch, args.seed)
    torch.cuda.empty_cache()
    _at("fused_kernels")
    fused_worst, fused_t = phase_fused_kernels(torch, args.seed)
    torch.cuda.empty_cache()
    _at("resnet_train")
    resnet, rmodel, rstep, rbatch, rinit = phase_resnet_train(torch,
                                                              args.seed)
    _at("resnet_profile")
    phase_resnet_profile(torch, rstep, rbatch)
    del rstep
    _at("resnet_paths")
    paths = phase_resnet_paths(torch, rmodel, rinit, rbatch)
    del rmodel, rbatch, rinit
    torch.cuda.empty_cache()
    _at("resnet_parity")
    phase_resnet_parity(torch, args.seed)
    torch.cuda.empty_cache()
    _at("wide_deep")
    phase_wide_deep(torch, args.seed, env["nvidia_smi"])
    torch.cuda.empty_cache()
    _at("static_lenet")
    _, lenet = phase_static_lenet(torch, args.seed, env["nvidia_smi"])
    _at("static_infer")
    phase_static_infer(torch, args.seed, env["nvidia_smi"], lenet)
    del lenet
    _at("records")
    # checked last, so that a failure still prints every path's trajectory
    check(resnet["losses"][-1] < resnet["losses"][0],
          f"ResNet-50 loss did not descend: {resnet['losses']}")
    fa_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    fa_kernels = [
        {"name": f"flash_attention_{k}", "route": "cuda", "source": fa_src,
         "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
         "launches": trained["launches"][f"flash_attention_{k}"],
         "max_abs_err": fa_worst[k], "ms": fa_timing[k],
         "plain_ms": fa_timing[k + "_plain"],
         "bound_ms": fa_timing[k + "_bound"],
         "bound_by": fa_timing[k + "_bound_by"],
         # SDPA with the same mask: its forward; its backward is one
         # call computing dQ, dK and dV together, listed for both
         "library_ms": fa_timing["sdpa_fwd" if k == "fwd" else "sdpa_bwd"]}
        for k, line in (("fwd", 67), ("dq", 192), ("dkv", 232))]
    # B1 on the dense serving path: launches of that path's run (the
    # wrapper's: export check, warm-up and capture), a replay's read from
    # the bucket graphs, and the replays' (per replay x replays); timed
    # at the served shape
    fa_kernels.append({
        "name": "flash_attention_fwd_served", "route": "cuda",
        "source": fa_src,
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:67",
        "launches": dense["bert"]["launches"]["flash_attention_fwd"],
        "launches_per_replay": dense["bert"]["b1_kernels_per_replay"],
        "launches_replayed": dense["bert"]["b1_launches_replayed"],
        "max_abs_err": fa_worst["fwd_served"], "ms": dense_t["ms"],
        "plain_ms": dense_t["plain_ms"], "bound_ms": dense_t["bound_ms"],
        "bound_by": dense_t["bound_by"],
        "library_ms": dense_t["library_ms"]})
    # B1's f32 kernel inside the exported bert_int8 program (its float
    # layers stay f32), timed at the same served shape in f32
    fa_kernels.append({
        "name": "flash_attention_fwd_served_f32", "route": "cuda",
        "source": fa_src,
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:67",
        "launches": dense["bert_int8"]["launches"]["flash_attention_fwd"],
        "launches_per_replay": dense["bert_int8"]["b1_kernels_per_replay"],
        "launches_replayed": dense["bert_int8"]["b1_launches_replayed"],
        "max_abs_err": fa_worst["fwd_served_f32"], "ms": dense_t32["ms"],
        "plain_ms": dense_t32["plain_ms"], "bound_ms": dense_t32["bound_ms"],
        "bound_by": dense_t32["bound_by"],
        "library_ms": dense_t32["library_ms"]})
    # the Transformer-big path: launches of seq2seq_train's run (18 a
    # step), timed at its shape (B=64, N=16, S=64, H=64, bf16, no mask)
    s2s_t = fa_s2s["t"]
    fa_kernels += [
        {"name": f"flash_attention_{k}_seq2seq", "route": "cuda",
         "source": fa_src,
         "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
         "launches": s2s_trained["launches"][f"flash_attention_{k}"],
         "max_abs_err": fa_s2s["worst"][k], "ms": s2s_t[k],
         "plain_ms": s2s_t[k + "_plain"], "bound_ms": s2s_t[k + "_bound"],
         "bound_by": s2s_t[k + "_bound_by"],
         "library_ms": s2s_t["sdpa_fwd" if k == "fwd" else "sdpa_bwd"]}
        for k, line in (("fwd", 67), ("dq", 192), ("dkv", 232))]
    src = "paddle_tpu_torch/csrc/flash_decode.cu"
    gen_b8 = spec["generate"]
    kernels = [
        {"name": "flash_decode", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas/flash_decode.py:68",
         "launches": served["bf16"]["launches"]["flash_decode"],
         # the wrappers' counts of the other paths that launch B3, and
         # the slot paths' launches a replay from device traces
         "launches_by_path": {
             "serving": served["bf16"]["launches"]["flash_decode"],
             "spec_server_draft": spec["server"]["launches"][
                 "flash_decode"],
             "spec_generate_draft_b8": gen_b8["bf16_b8"]["random_draft"][
                 "launches"]["flash_decode"],
             "beam": beam["launches"]["flash_decode"],
             "slot_step_per_replay": slots["bf16"][
                 "decode_kernels_per_replay"],
             "spec_slot_step_draft_per_replay": spec["slots"]["bf16"][
                 "draft_decode_kernels_per_replay"],
             "sessions": sessions["launches"]["flash_decode"]},
         "max_abs_err": worst["flash_decode"],
         "ms": timing["flash_decode"],
         "plain_ms": timing["flash_decode_plain"],
         "bound_ms": timing["flash_decode_bound"],
         "bound_by": timing["flash_decode_bound_by"],
         "library_ms": timing["flash_decode_library"]},
        {"name": "flash_decode_quant", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas/flash_decode.py:159",
         "launches": served["int8"]["launches"]["flash_decode_quant"],
         "launches_by_path": {
             "serving": served["int8"]["launches"]["flash_decode_quant"],
             "spec_generate_draft_b8": gen_b8["int8_b8"]["random_draft"][
                 "launches"]["flash_decode_quant"],
             "slot_step_per_replay": slots["int8"][
                 "decode_kernels_per_replay"],
             "spec_slot_step_draft_per_replay": spec["slots"]["int8"][
                 "draft_decode_kernels_per_replay"],
             "sessions": sessions["launches"]["flash_decode_quant"]},
         "max_abs_err": worst["flash_decode_quant"],
         "ms": timing["flash_decode_quant"],
         "plain_ms": timing["flash_decode_quant_plain"],
         "bound_ms": timing["flash_decode_quant_bound"],
         "bound_by": timing["flash_decode_quant_bound_by"],
         # no single PyTorch call attends over int8 rows with scales
         "library_ms": None},
        # the verify block: B3/B4's query-block form (the same kernel
        # template and TPU kernels), at T = 5, S = 768; launches of the
        # speculative server's run (one a target layer a spec step)
        {"name": "flash_decode_block", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas/flash_decode.py:68",
         "launches": spec["server"]["launches"]["flash_decode_block"],
         "launches_by_path": {
             "spec_server": spec["server"]["launches"]["flash_decode_block"],
             "spec_generate_b8": gen_b8["bf16_b8"]["random_draft"][
                 "launches"]["flash_decode_block"],
             "spec_slot_step_per_replay": spec["slots"]["bf16"][
                 "verify_decode_kernels_per_replay"],
             "sessions": sessions["launches"]["flash_decode_block"]},
         "max_abs_err": worst["flash_decode_block"],
         "ms": timing["flash_decode_block"],
         "plain_ms": timing["flash_decode_block_plain"],
         "bound_ms": timing["flash_decode_block_bound"],
         "bound_by": timing["flash_decode_block_bound_by"],
         "library_ms": timing["flash_decode_block_library"]},
        {"name": "flash_decode_quant_block", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas/flash_decode.py:159",
         "launches": gen_b8["int8_b8"]["random_draft"]["launches"][
             "flash_decode_quant_block"],
         "launches_by_path": {
             "spec_generate_b8": gen_b8["int8_b8"]["random_draft"][
                 "launches"]["flash_decode_quant_block"],
             "spec_slot_step_per_replay": spec["slots"]["int8"][
                 "verify_decode_kernels_per_replay"],
             "sessions": sessions["launches"]["flash_decode_quant_block"]},
         "max_abs_err": worst["flash_decode_quant_block"],
         "ms": timing["flash_decode_quant_block"],
         "plain_ms": timing["flash_decode_quant_block_plain"],
         "bound_ms": timing["flash_decode_quant_block_bound"],
         "bound_by": timing["flash_decode_quant_block_bound_by"],
         "library_ms": None},
    ]
    # B3's f32 instance and B4 with an f32 query on bench_decode's int8
    # path (decode_int8): launches of its runs by path, the graph's nodes
    # a slot replay, timed at the served shape in f32
    dk, dl = dec["kernels"], dec["launches"]
    for name, line, runs, library in (
            ("flash_decode", 68, ("int8_bench_generate", "rows_f32_cache",
                                  "server"), dk["flash_decode_library"]),
            # no single PyTorch call attends over int8 rows with scales
            ("flash_decode_quant", 159, ("rows_int8_cache",), None)):
        kv = "int8" if name == "flash_decode_quant" else "bf16"
        kernels.append({
            "name": (f"{name}_served_f32q" if kv == "int8"
                     else f"{name}_served_f32"),
            "route": "cuda", "source": src,
            "replaces": f"paddle_tpu/ops/pallas/flash_decode.py:{line}",
            "launches": dl[runs[0]],
            "launches_by_path": {
                **{r: dl[r] for r in runs},
                "slot_step_per_replay": dec["slots"][kv][
                    "decode_kernels_per_replay"],
                "slot_replays": dec["slots"][kv]["steps_replayed"]},
            "max_abs_err": dk[f"{name}_err"], "ms": dk[name],
            "plain_ms": dk[f"{name}_plain"], "bound_ms": dk[f"{name}_bound"],
            "bound_by": dk[f"{name}_bound_by"], "library_ms": library})
    kernels += fa_kernels + _fused_kernel_records(fused_worst, fused_t,
                                                  resnet, paths)
    _at("done")
    log("done", seconds=round(time.perf_counter() - t0, 1),
        phase_seconds=_PHASE_S)
    print(env["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:
        # the phase and the check that failed, on a line of their own
        log("failed", phase=_PHASE, check=f"{type(e).__name__}: {e}"[:4000])
        raise
