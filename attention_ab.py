#!/usr/bin/env python3
"""Before and after: the port's attention kernels of this checkout beside
those of another checkout, on one card, in one process.

    python3 attention_ab.py --other DIR [--seed 0] [--rounds 2]

DIR holds another checkout of the repository (an earlier commit, unpacked
with ``git archive``).  Each checkout's ``flash_attention`` and
``flash_decode`` libraries are built from its own ``csrc`` by its own
``_build.py``; the C interfaces are the same, so this checkout's wrappers
launch either one once it is swapped into ``_build._LIBS``.  Each time
is a CUDA-graph replay (``chip_smoke._graph_ms``), taken in turns (other,
this, this, other) ``--rounds`` times, at the main paths' shapes:

  * B1 f32 (``flash_fwd`` on f32 tensors): the served shape of the int8
    BERT program (B = 16, N = 12, S = 128, H = 64, no bias), BERT-base's
    training shape with its padding bias (B = 64) and Transformer-big's
    causal self-attention (B = 64, N = 16, S = 64), all on the models'
    strided views, beside SDPA's f32 forward on the same inputs;
  * the B3/B4 block form at the verify block of the slot loop (B = 8,
    N = 12, S = 768, H = 64, T = 5, bf16 q; chip_smoke._block_timing's
    inputs);
  * B3/B4 one-query launches at the served decode shape (B = 8, S = 256).

Each time stands beside its bound (chip_smoke's formulas) and the card's
name and power limit.  The script also checks that the two checkouts'
decode launches (one-query and block form) give the same bits on the
same inputs, and that each B1 f32 kernel stays within the f32 limit of
its plain version.  Prints one JSON line per measurement and a summary,
and writes them to chiprun_out/attention_ab.json.  Needs a CUDA card; it
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import threading

import numpy as np

NAMES = ("flash_attention", "flash_decode")


def _other_build(root):
    """The other checkout's ``_build`` module, loaded under another name:
    it builds that checkout's sources into that checkout's ``_build``."""
    path = os.path.join(root, "paddle_tpu_torch", "ops", "kernels",
                        "_build.py")
    spec = importlib.util.spec_from_file_location("_other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _libraries(other_root):
    """Both checkouts' libraries, built together."""
    from paddle_tpu_torch.ops.kernels import _build
    other = _other_build(other_root)
    t = threading.Thread(target=other.build, args=(NAMES,))
    t.start()
    _build.build(NAMES)
    t.join()
    return {"this": {n: _build.library(n) for n in NAMES},
            "other": {n: other.library(n) for n in NAMES}}


def _b1_cases(torch, cs, g):
    """(name, input sets, bias bytes, causal, shape) of B1 f32."""
    out = []
    for name, (B, N, S, bias, causal) in {
            "b1_f32_served": (16, 12, 128, None, False),
            "b1_f32_bert_train_pad": (64, 12, 128, "pad", False),
            "b1_f32_seq2seq_causal": (64, 16, 64, None, True)}.items():
        sets = [cs._fa_inputs(torch, g, B, N, S, S, 64, bias, torch.float32,
                              "bsnh") for _ in range(cs.FA_ROTATE)]
        sets = [(x[0], x[1], x[2], x[4]) for x in sets]
        nb = 0 if sets[0][3] is None else sets[0][3].numel() * 4
        out.append((name, sets, nb, causal, (B, N, S, 64)))
    return out


def _decode_inputs(torch, g):
    """chip_smoke's timing inputs: the block form's (S = 768, T = 5, the
    block at the ring's middle) and the one-query served shape's (S =
    256, full window), 12 caches each, bf16 and int8."""
    from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
    B, N, H = 8, 12, 64
    out = {}
    for key, S, T in (("block", 768, 5), ("one", 256, 1)):
        start = torch.zeros(B, dtype=torch.int32, device="cuda")
        if T > 1:
            end = (S // 2 + 1 + torch.arange(T, device="cuda")).int() \
                .expand(B, T).contiguous()
        else:
            end = torch.full((B,), S, dtype=torch.int32, device="cuda")
        q = torch.randn(B, N, T, H, generator=g, device="cuda").bfloat16()
        caches = [tuple(torch.randn(B, N, S, H, generator=g,
                                    device="cuda").bfloat16()
                        for _ in range(2)) for _ in range(12)]
        quant = [quantize_kv_rows(k) + quantize_kv_rows(v)
                 for k, v in caches]
        out[key] = (q, start, end, caches, quant)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    import chip_smoke as cs
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    smi = cs.phase_env(torch)["nvidia_smi"]
    libs = _libraries(args.other)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    b1 = _b1_cases(torch, cs, g)
    dec = _decode_inputs(torch, g)

    def use(which):
        _build._LIBS.update(libs[which])

    def b1_call(sets, causal):
        n = len(sets)
        return lambda i: fa.flash_fwd(*sets[i % n], causal=causal)

    def dec_call(key, quant):
        q, start, end, caches, qc = dec[key]
        n = len(caches)
        if key == "block":
            if quant:
                return lambda i: fd.flash_decode_quant_block(
                    q, qc[i % n][0], qc[i % n][2], qc[i % n][1],
                    qc[i % n][3], start, end)
            return lambda i: fd.flash_decode_block(q, *caches[i % n],
                                                   start, end)
        if quant:
            return lambda i: fd.flash_decode_quant(
                q, qc[i % n][0], qc[i % n][2], qc[i % n][1], qc[i % n][3],
                start, end)
        return lambda i: fd.flash_decode(q, *caches[i % n], start, end)

    # as chip_smoke times them: twice through the rotated inputs
    calls = {name: b1_call(sets, causal)
             for name, sets, _, causal, _ in b1}
    ncalls = {name: 2 * len(sets) for name, sets, *_ in b1}
    for key, pre in (("block", "b3_block"), ("one", "b3")):
        for k, quant in ((pre, False), (pre.replace("b3", "b4"), True)):
            calls[k] = dec_call(key, quant)
            ncalls[k] = 2 * len(dec[key][3])

    # the same bits from both checkouts' decode kernels; B1 f32 of each
    # within the f32 limit of its plain version
    outs, errs = {}, {}
    for which in ("other", "this"):
        use(which)
        outs[which] = {k: c(0) for k, c in calls.items()
                       if not k.startswith("b1")}
        for name, sets, _, causal, _ in b1:
            o, _ = calls[name](0)
            ref, _ = fa.flash_fwd_reference(*sets[0], causal=causal)
            errs[f"{which}:{name}"] = cs._share_err(o, ref)
        torch.cuda.synchronize()
    same = {k: bool(torch.equal(outs["other"][k], outs["this"][k]))
            for k in outs["this"]}
    cs.check(all(same.values()), f"decode bits differ: {same}")
    cs.check(all(e <= cs.FA_RTOL["float32"] for e in errs.values()),
             f"B1 f32 errors {errs}")

    times = {k: {"other": [], "this": []} for k in calls}
    lib_ms = {name: [] for name, *_ in b1}
    for _ in range(args.rounds):
        for which in ("other", "this", "this", "other"):
            use(which)
            for k, c in calls.items():
                times[k][which].append(cs._graph_ms(torch, c, ncalls[k]))
            if which == "this":
                for name, sets, _, causal, _ in b1:
                    n = len(sets)
                    lib_ms[name].append(cs._graph_ms(
                        torch, lambda i: F.scaled_dot_product_attention(
                            *sets[i % n][:3], attn_mask=sets[i % n][3],
                            is_causal=causal), 2 * n))
    use("this")

    bounds = {}
    for name, sets, nb, causal, (B, N, S, H) in b1:
        bound, by, nbytes, ops = cs._fa_bound("fwd", B, N, S, S, H, 4, nb)
        bounds[name] = {"bound_ms": bound, "bound_by": by,
                        "bytes": nbytes, "ops": ops}
    q, start, end, _, _ = dec["block"]
    for k, quant, elt, kv in (("b3_block", False, 2, "bfloat16"),
                              ("b4_block", True, 1, "int8")):
        bound, by, nbytes = cs._block_bound(8, 12, 64, start, end, elt, 2,
                                            quant, kv)
        bounds[k] = {"bound_ms": bound, "bound_by": by, "bytes": nbytes}
    q, start, end, _, _ = dec["one"]
    for k, kv, quant in (("b3", "bfloat16", False), ("b4", "int8", True)):
        bound, by, nbytes = cs._bound(8, 12, 64, start, end, kv, 2, quant)
        bounds[k] = {"bound_ms": bound, "bound_by": by, "bytes": nbytes}

    rows = []
    for k in calls:
        row = {"kernel": k, "other_ms": times[k]["other"],
               "this_ms": times[k]["this"],
               "other_median_ms": float(np.median(times[k]["other"])),
               "this_median_ms": float(np.median(times[k]["this"])),
               **bounds[k]}
        if k in lib_ms:
            row["sdpa_f32_ms"] = lib_ms[k]
            row["max_err_share"] = {w: errs[f"{w}:{k}"]
                                    for w in ("other", "this")}
        else:
            row["same_bits_as_other"] = same[k]
        rows.append(row)
        print(json.dumps(row))
    summary = {"card": smi, "other": args.other, "rounds": args.rounds,
               "order": "other, this, this, other",
               "speedup": {r["kernel"]: r["other_median_ms"]
                           / r["this_median_ms"] for r in rows}}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "attention_ab.json"), "w") as f:
        json.dump({"rows": rows, **summary}, f, indent=1)
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
