#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own line; any failure raises and the script
exits non-zero without printing a result:

  1. env      the card (torch and nvidia-smi), torch and CUDA versions;
  2. build    nvcc builds every kernel source of the port; the fused
              conv library's SASS (cuobjdump) holds HGMMA, the tensor
              cores' wgmma, and the flash-attention library's HMMA
              (mma.sync, its bf16 kernels); the flash-attention and
              flash-decode libraries spill no register (nvcc -Xptxas -v);
  3. kernels  each decode kernel (B3, B4: one cluster launch a call)
              against its plain PyTorch version on the card at cache
              lengths 32, 200, 256 and 1024, head_dims 64 and 128, f32
              and bf16, full, ragged and edge windows; two launches on
              one input give the same bits; then its time at the served
              shape and at S = 1024 beside the plain version, a library
              call and the card's bound;
  4. serving  GPT-2 small (random bf16 weights from --seed) served
              through Server.register_decode/start/submit_decode, once
              with the bf16 KV cache and once with the int8 one: every
              served row equals a batch-1 generate() of its prompt, and
              each kernel's launch count equals layers x decode steps x
              batches; the bf16 traffic again with plain F.linear GEMMs
              and with the batch-invariant ones, in turns, for the
              served tok/s of each; then one 8-prompt request per wave at short
              sequence buckets (16, 32), whose caches of 32 and 48
              columns are shorter than the kernel's 64-column span:
              launch counts again, and every row equals generate() of the
              same batch and its own batch-1 generate();
  5. profile  one 8-row decode loop timed, then traced with
              torch.profiler: device busy time, kernel launches a step
              and kernel time by name; the decode kernel's time
              (decode_cluster_kernel) must be > 0 when the traced loop
              launched it;
  6. e2e      kernel against plain end to end: f32 generate() with
              FLAGS_use_flash_decode on and off gives equal tokens and
              last logits within 1e-4;
  7. fa_kernels  the flash-attention kernels (forward B1, backward B2:
              dQ and dK/dV) against their plain versions in f32 and bf16
              over head_dims 64/128/256, lengths 128, 200, 256 and
              128 x 384, causal, and the three bias shapes; then at
              BERT-base (B=64, N=12, S=128, H=64) on the strided views
              the model passes, with and without the padding bias:
              checked in f32 and bf16 (in bf16 also twice: the same
              bits), and timed in bf16 beside the bound, the plain
              versions and SDPA;
  8. train    BERT-base pretraining (random weights from --seed, f32
              masters, bf16 compute, AdamW, dropout 0.1) at batch 64 x
              seq 128 with a ragged attention mask: 3 + 20 steps, seq/s,
              loss per step (finite, descending), launches of each
              flash-attention kernel = 12 layers x steps; one seed gives
              one first loss, another seed another; then train_parity
              (f32, dropout off, batch 8: 5 steps with the kernels on
              and off) and train_profile (one step under torch.profiler:
              the bf16 step runs the tensor-core kernels, and their share
              of the device-busy time);
  9. batch_probe  one short prompt decoded alone and in an 8-row batch,
              module by module: no row may diverge;
 10. fused_kernels  B5 stats/apply, B6 reduce/dx and B7 against their
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
 11. resnet   ResNet-50 NHWC training (random weights from --seed, f32
              masters, bf16 compute, Momentum, CrossEntropyLoss) at batch
              256 x 224 px: 3 + 10 steps, img/s, loss per step (finite,
              descending), launches of B7, B5 apply and B6 = 53 sites x
              steps, one seed's first loss twice; resnet_profile (one
              traced step), resnet_paths (the fused-BN-only path: B5
              stats and apply = 53 x steps; and kernels off, cuDNN + plain
              BN, timed beside kernels on) and resnet_parity (f32, batch
              8, kernels on against off).

The last lines are the card as nvidia-smi reports it, the kernels'
JSON record, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# the operation rate of each input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

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


def log(phase, **kw):
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


class SmokeFailure(RuntimeError):
    pass


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
    -sass): HGMMA (wgmma) and HMMA (mma.sync)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {path}: {out.stderr}")
    lines = out.stdout.splitlines()
    return {op: sum(f" {op}." in ln or f" {op} " in ln for ln in lines)
            for op in ("HGMMA", "HMMA")}


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
    # B1's and B2's bf16 kernels too, through mma.sync (HMMA)
    sass = {n: _sass_counts(_build._lib_path(n))
            for n in ("fused_conv", "flash_attention")}
    check(sass["fused_conv"]["HGMMA"] > 0,
          f"fused_conv: no HGMMA in its SASS ({sass['fused_conv']})")
    check(sass["flash_attention"]["HMMA"] + sass["flash_attention"]["HGMMA"]
          > 0, "flash_attention: no tensor-core instruction in its SASS "
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
    lo = torch.randint(0, S // 2, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    hi = torch.randint(S // 2 + 1, S + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    if kind == "edge":
        lo[0], hi[0] = max(S - 40, 0), S   # every rank but the last empty
        lo[1], hi[1] = 17, 18          # a single valid column
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


def phase_kernels(torch, seed):
    import torch.nn.functional as F
    from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"flash_decode": 0.0, "flash_decode_quant": 0.0}
    worst_row = {"flash_decode": 0.0, "flash_decode_quant": 0.0}
    B, N = 8, 12
    # 256 and 1024: four cluster ranks of 64 and 256 columns; 32: one
    # rank; 200: four ranks of 50 columns
    for S in (32, 200, 256, 1024):
        for H in (64, 128):
            for dt in (torch.float32, torch.bfloat16):
                name = str(dt).split(".")[-1]
                q, k, v = (torch.randn(shape, generator=g, device="cuda")
                           .to(dt) for shape in ((B, N, 1, H),
                                                 (B, N, S, H),
                                                 (B, N, S, H)))
                k8, ks = quantize_kv_rows(k)
                v8, vs = quantize_kv_rows(v)
                for kind in ("full", "ragged", "edge"):
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
                log("kernels", check=f"S={S} H={H} {name}",
                    windows="full,ragged,edge", repeats_bit_for_bit=True,
                    ok=True)
    log("kernels", max_abs_err=worst, atol=ATOL,
        bf16_vs_bf16_plain_max_row_rel_err=worst_row,
        bf16_row_rtol=BF16_ROW_RTOL)

    # timing at the served shape, rotating over one cache per layer so
    # that, as in a decode step, the cache comes from HBM, not L2
    timings = {}
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
    return worst, timings[SEQ_BUCKETS[-1]]


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
                check_rows=True):
    """Serve ``prompts``, one request each (or all in one request), and
    hold the launch counts and the served rows.  Every served row must
    equal its prompt's batch-1 generate() (the serving path's GEMMs are
    row-invariant: batch_invariant_linear); the rows of one request, which
    form one batch, must also equal generate() of that batch.  Without
    ``check_rows`` (a timing run) only the counts are held."""
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
    if not check_rows:
        return {"decode_tok_per_s": tok_s, "serve_s": round(t_end - t_ready,
                                                            3)}
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
        diff = np.nonzero(one.cpu().numpy()[0] != got[0])[0]
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
    log("serving", **out)
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
        # the served throughput of the batch-invariant GEMMs against plain
        # F.linear ones (the layout before them), the same bf16 traffic in
        # turns (invariant above, then plain, invariant, plain)
        tok_s = {"batch_invariant": [served["bf16"]["decode_tok_per_s"]],
                 "plain": []}
        for kind in ("plain", "batch_invariant", "plain"):
            with (_plain_serving_gemms() if kind == "plain"
                  else contextlib.nullcontext()):
                tok_s[kind].append(_serve_once(
                    torch, model, prompts, "bf16", GRID,
                    check_rows=False)["decode_tok_per_s"])
        log("serving", kv_cache="bf16", decode_tok_per_s=tok_s,
            batch_invariant_cost=round(
                float(np.mean(tok_s["plain"]) /
                      np.mean(tok_s["batch_invariant"])) - 1, 4))
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
    names = ((transformer, "pad_rows"), (transformer, "rows_linear"),
             (transformer, "batch_invariant_linear"),
             (gpt, "batch_invariant_linear"))
    saved = [getattr(m, n) for m, n in names]
    plain = {"pad_rows": lambda x: (x.reshape(-1, x.shape[-1]),
                                    x.numel() // x.shape[-1]),
             "rows_linear": lambda x, w, b=None: F.linear(x, w, b),
             "batch_invariant_linear": lambda x, w, b=None: F.linear(x, w,
                                                                     b)}
    for m, n in names:
        setattr(m, n, plain[n])
    try:
        yield
    finally:
        for (m, n), f in zip(names, saved):
            setattr(m, n, f)


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
        cache, logits0 = gen.prefill(ids, start, C)
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if traced
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            gen.decode(cache, logits0, start, P, MAX_NEW)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / MAX_NEW * 1e3
        return ms, prof

    step_ms, _ = decode_ms(False)
    # the cost of the batch-invariant GEMMs: the same loop with the
    # serving path's GEMMs as plain F.linear calls (the layout before
    # them), in turns (invariant, plain, plain, invariant) three times;
    # the host clock of a shared host is noisy, so the minimum of each
    # is compared
    invariant, plain = [step_ms], []
    for i in range(3):
        with _plain_serving_gemms():
            plain += [decode_ms(False)[0] for _ in range(2)]
        invariant += [decode_ms(False)[0] for _ in range(2 if i < 2 else 1)]
    n0 = fd.flash_decode.launches
    traced_ms, prof = decode_ms(True)
    fd_launches = fd.flash_decode.launches - n0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    out = {"batch": BATCH_BUCKETS[-1], "steps": MAX_NEW, "cache": C,
           "step_ms": round(step_ms, 3),
           "step_ms_batch_invariant_gemms": [round(x, 3) for x in invariant],
           "step_ms_plain_gemms": [round(x, 3) for x in plain],
           "batch_invariant_cost_min": round(min(invariant) / min(plain)
                                             - 1, 4),
           "batch_invariant_cost_median": round(
               float(np.median(invariant) / np.median(plain)) - 1, 4),
           "step_ms_traced": round(traced_ms, 3)}
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / MAX_NEW
    if busy <= 0:
        out["device_busy_ms_per_step"] = "not measured (no CUDA events)"
    else:
        fd_ms = sum(e.self_device_time_total for e in kernels
                    if "decode_cluster_kernel" in e.key) / 1e3 / MAX_NEW
        check(fd_ms > 0 or fd_launches == 0,
              f"profile: {fd_launches} decode kernel launches, but no "
              "device time under decode_cluster_kernel")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        out.update(
            device_busy_ms_per_step=round(busy, 4),
            device_idle_share=round(1 - busy / step_ms, 4),
            kernel_launches_per_step=round(
                sum(e.count for e in kernels) / MAX_NEW, 2),
            flash_decode_launches_per_step=fd_launches / MAX_NEW,
            flash_decode_ms_per_step=round(fd_ms, 4),
            top_kernels=[{"name": e.key[:90],
                          "calls_per_step": round(e.count / MAX_NEW, 2),
                          "ms_per_step": round(e.self_device_time_total
                                               / 1e3 / MAX_NEW, 4)}
                         for e in top])
    log("profile", **out)


# -- phase 6 -----------------------------------------------------------------

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


# -- phase 7: flash attention kernels (B1, B2) -------------------------------

# (B, N, Sq, Sk, H, causal, bias): H 64/128/256; S 128, 256 and 200 (off
# the 64-row tile); causal with Sq = Sk and with Sq = 128 < Sk = 384; the
# three bias shapes "b11s" (B, 1, 1, Sk), "11ss" (1, 1, Sq, Sk) and
# "bnss" (B, N, Sq, Sk)
FA_CHECKS = (
    (2, 4, 128, 128, 64, False, None),
    (2, 4, 256, 256, 128, False, "b11s"),
    (2, 4, 200, 200, 256, False, "11ss"),
    (2, 4, 128, 128, 64, True, None),
    (2, 4, 200, 200, 128, True, "bnss"),
    (2, 4, 128, 384, 64, True, "b11s"),
    (2, 4, 256, 256, 256, True, "bnss"),
    (2, 4, 128, 384, 128, False, "11ss"),
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
FA_ROTATE = 4           # input sets rotated through when timing (> L2)


def _fa_inputs(torch, g, B, N, Sq, Sk, H, bias, dtype, layout="bnsh"):
    """q, k, v, dO and the bias.  ``layout`` "bnsh" makes contiguous
    (B, N, S, H) tensors; "bsnh" makes them as the model's attention
    does: ``x.view(B, S, N, H).transpose(1, 2)`` of a (B, S, N*H)
    projection, strided views the wrappers pass to the kernels uncopied.
    ``bias`` "pad" is BERT's padding mask: (B, 1, 1, Sk), 0 over each
    row's first 64..Sk keys and -1e4 after."""
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
    inputs' peak rate.  Non-causal pairs: the training path's case."""
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
    t_ops = ops / PEAK_OPS_PER_S["bfloat16" if elt == 2 else "float32"] * 1e3
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


def phase_fa_kernels(torch, seed):
    """B1, B2-dQ and B2-dK/dV against their plain versions over
    FA_CHECKS in f32 and bf16, then at the BERT-base training shape in
    the model's layout: checked in f32 and bf16, and timed in bf16."""
    import torch.nn.functional as F
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

    # the BERT-base training shape, as the model gives it to the kernels:
    # q, k, v and dO are transposed views of (B, S, N*H) projections,
    # read by the kernels through their strides, non-causal, with and
    # without the padding bias.  Checked in f32 and bf16, then timed in
    # bf16, rotating over FA_ROTATE input sets (> 50 MB of L2 between
    # reuses)
    B, N, S, H = (FA_TIME[x] for x in "BNSH")
    timings = {}
    for padded in (False, True):
        bias = "pad" if padded else None
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
        for key in ("fwd", "dq", "dkv"):
            t[key] = _graph_ms(torch, kern[key], 2 * n)
            t[key + "_plain"] = _graph_ms(torch, plain[key], 2 * n)
            bias_bytes = 0 if sets[0][4] is None else sets[0][4].numel() * 4
            bound, by, nbytes, ops = _fa_bound(key, B, N, S, S, H, 2,
                                               bias_bytes)
            t.update({key + "_bound": bound, key + "_bound_by": by,
                      key + "_bytes": nbytes, key + "_ops": ops})
        # the library yardstick (never called by the port): SDPA with the
        # same additive mask, forward; and the backward of that one call,
        # which computes dQ, dK and dV together
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
            f"{'padding bias (B,1,1,S)' if padded else 'no bias'}, "
            f"model layout, {n} input sets rotated", ms=t)
        timings[padded] = t
        del sets, leaves, outs
    log("fa_kernels", max_abs_err=worst, rtol=FA_RTOL)
    return worst, timings[True]


# -- phase 8: BERT-base training ---------------------------------------------

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


def phase_train_profile(torch, step, batch):
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
        # f32 the FMA ones (fwd_kernel...; flash_decode.cu's are
        # decode_*_kernel)
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
    log("train_profile", **out)


# -- phase 9: batch invariance probe -----------------------------------------

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


# -- phase 10: fused batch-norm and conv kernels (B5, B6, B7) ----------------

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


# -- phase 11: ResNet-50 training --------------------------------------------

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
    env = phase_env(torch)
    phase_build()
    worst, timing = phase_kernels(torch, args.seed)
    fa_worst, fa_timing = phase_fa_kernels(torch, args.seed)
    model = _gpt2(torch, args.seed, torch.bfloat16)
    served = phase_serving(torch, model, args.seed)
    phase_profile(torch, model, args.seed)
    phase_batch_probe(torch, model, args.seed)
    del model
    phase_e2e(torch, args.seed)
    trained, step, batch = phase_train(torch, args.seed)
    phase_train_profile(torch, step, batch)
    del step, batch
    phase_train_parity(torch, args.seed)
    torch.cuda.empty_cache()
    fused_worst, fused_t = phase_fused_kernels(torch, args.seed)
    torch.cuda.empty_cache()
    resnet, rmodel, rstep, rbatch, rinit = phase_resnet_train(torch,
                                                              args.seed)
    phase_resnet_profile(torch, rstep, rbatch)
    del rstep
    paths = phase_resnet_paths(torch, rmodel, rinit, rbatch)
    del rmodel, rbatch, rinit
    torch.cuda.empty_cache()
    phase_resnet_parity(torch, args.seed)
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
    src = "paddle_tpu_torch/csrc/flash_decode.cu"
    kernels = [
        {"name": "flash_decode", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas/flash_decode.py:68",
         "launches": served["bf16"]["launches"]["flash_decode"],
         "max_abs_err": worst["flash_decode"],
         "ms": timing["flash_decode"],
         "plain_ms": timing["flash_decode_plain"],
         "bound_ms": timing["flash_decode_bound"],
         "bound_by": timing["flash_decode_bound_by"],
         "library_ms": timing["flash_decode_library"]},
        {"name": "flash_decode_quant", "route": "cuda", "source": src,
         "replaces": "paddle_tpu/ops/pallas/flash_decode.py:159",
         "launches": served["int8"]["launches"]["flash_decode_quant"],
         "max_abs_err": worst["flash_decode_quant"],
         "ms": timing["flash_decode_quant"],
         "plain_ms": timing["flash_decode_quant_plain"],
         "bound_ms": timing["flash_decode_quant_bound"],
         "bound_by": timing["flash_decode_quant_bound_by"],
         # no single PyTorch call attends over int8 rows with scales
         "library_ms": None},
    ] + fa_kernels + _fused_kernel_records(fused_worst, fused_t, resnet,
                                           paths)
    log("done", seconds=round(time.perf_counter() - t0, 1))
    print(env["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
