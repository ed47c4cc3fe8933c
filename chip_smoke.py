#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``paddle_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own line; any failure raises and the script
exits non-zero without printing a result:

  1. env      the card (torch and nvidia-smi), torch and CUDA versions;
  2. build    nvcc builds every kernel source of the serving path;
  3. kernels  each kernel against its plain PyTorch version on the card,
              then its time beside the plain version, a library call and
              the card's bound;
  4. serving  GPT-2 small (random bf16 weights from --seed) served
              through Server.register_decode/start/submit_decode, once
              with the bf16 KV cache and once with the int8 one: every
              served row equals a batch-1 generate() of its prompt, and
              each kernel's launch count equals layers x decode steps x
              batches; then one 8-prompt request per wave at short
              sequence buckets (16, 32), whose caches of 32 and 48
              columns are no multiple of the kernel's 64-column split:
              launch counts again, and the rows equal generate() of the
              same batch;
  5. profile  one 8-row decode loop timed, then traced with
              torch.profiler: device busy time and kernel time by name;
  6. e2e      kernel against plain end to end: f32 generate() with
              FLAGS_use_flash_decode on and off gives equal tokens and
              last logits within 1e-4.

The last lines are the card as nvidia-smi reports it, the kernels'
JSON record, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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
#  * f32: both compute f32 softmax attention, the kernel in split
#    partials merged exactly, so only the summation order differs;
#  * bf16: the kernel's output is rounded to bf16 while the plain
#    version runs in f32 on the same bf16 inputs: half a bf16 step at
#    |out| < 4 is under 1e-2.
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
# bf16 kernel against the plain version run on the bf16 tensors
# themselves, which rounds p to bf16 before PV as JAX does: the two round
# p and the output at the same points, and differ where the kernel
# rounds p against its split's max instead of the global one, and where
# that moves an output across a rounding boundary.  A CPU emulation of
# the kernel's rounding over these shapes differs from the plain version
# by at most 2^-7 of the row's largest |out|; the bound is twice that,
# per (batch, head) row.
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

def phase_build():
    from paddle_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    report = _build.build()
    for name in report:
        _build.library(name)
    log("build", seconds=round(time.perf_counter() - t0, 3),
        sources={n: {"seconds": round(r["seconds"], 3),
                     "cached": r["cached"]} for n, r in report.items()})


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
        lo[0], hi[0] = max(S - 40, 0), S   # every split but the last empty
        lo[1], hi[1] = 17, 18          # a single valid column
    return lo, hi


def _graph_ms(torch, launch, calls):
    """Device time of one ``launch(i)`` call: ``calls`` calls captured in
    a CUDA graph (no host launch gaps), replayed, timed with events;
    median over rounds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(calls):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    # 256 and 1024 on the split grid; 32 and 200 off it (the last split
    # masks its columns past S)
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
                    torch.cuda.synchronize()
                    for kern, o, w in (("flash_decode", got, want),
                                       ("flash_decode_quant", gotq,
                                        wantq)):
                        where = f"{kern} S={S} H={H} {name} {kind}"
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
                    windows="full,ragged,edge", ok=True)
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


def _serve_once(torch, model, prompts, kv, grid, one_request=False):
    """Serve ``prompts``, one request each (or all in one request), and
    hold the launch counts and the served rows.  Single-prompt requests
    must equal each prompt's batch-1 generate(); the rows of one request,
    which form one batch, must equal generate() of that batch, and their
    agreement with batch-1 generate() is measured, not required (on the
    card a row may move with its batch's GEMM shapes: ROADMAP queue C)."""
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
        check(one_request or diff.size == 0,
              f"kv={kv}: request {i} (prompt {p.size}) differs from "
              f"batch-1 generate() from token {diff[:1]}")
    t_oracle = time.perf_counter() - t_oracle
    tokens = int(st["tokens"])
    out = {"kv_cache": kv, "seq_buckets": grid["seq_buckets"],
           "caches": sorted({oracle.cache_bucket(
               oracle.prefill_bucket(p.size), steps) for p in prompts}),
           "requests": len(futs), "rows": len(prompts), "tokens": tokens,
           "batches": st["batches"], "avg_batch_rows": st["avg_batch_rows"],
           "warmup_s": round(t_ready - t0, 3),
           "serve_s": round(t_end - t_ready, 3),
           "decode_tok_per_s": round(tokens / (t_end - t_ready), 1),
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

def phase_profile(torch, model, seed):
    """Where a decode step's time goes: one 8-row bf16 batch, its decode
    loop timed alone, then again under torch.profiler for the device's
    busy time and the kernel time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    traced_ms, prof = decode_ms(True)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    out = {"batch": BATCH_BUCKETS[-1], "steps": MAX_NEW, "cache": C,
           "step_ms": round(step_ms, 3),
           "step_ms_traced": round(traced_ms, 3)}
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / MAX_NEW
    if busy <= 0:
        out["device_busy_ms_per_step"] = "not measured (no CUDA events)"
    else:
        fd = sum(e.self_device_time_total for e in kernels
                 if "decode_split_kernel" in e.key
                 or "decode_merge_kernel" in e.key) / 1e3 / MAX_NEW
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        out.update(
            device_busy_ms_per_step=round(busy, 4),
            device_idle_share=round(1 - busy / step_ms, 4),
            kernel_launches_per_step=round(
                sum(e.count for e in kernels) / MAX_NEW, 2),
            flash_decode_ms_per_step=round(fd, 4),
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
    model = _gpt2(torch, args.seed, torch.bfloat16)
    served = phase_serving(torch, model, args.seed)
    phase_profile(torch, model, args.seed)
    del model
    phase_e2e(torch, args.seed)
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
    ]
    log("done", seconds=round(time.perf_counter() - t0, 1))
    print(env["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
