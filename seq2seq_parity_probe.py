"""Readings behind chip_smoke.py's seq2seq_parity limits, on a CUDA card.

Part 1, ReLU gates free: the gradients of seq2seq_parity's model and
inputs (Transformer-big widths at depth 2 + 2) with the flash-attention
kernels on (f32), off (f32) and off in f64, with and without the masks.
For each pair of runs it logs the ReLU gates that differ, layer by
layer, and the largest over the leaves of max|a - b| / max|b| (the key
biases, whose exact gradient is 0, left out).

Part 2, gates pinned: phase_seq2seq_parity itself, sound and with the
kernel path perturbed (q scaled by 1 + 1e-4 or 1 + 1e-5, the output by
1 + 1e-5), each check that would fail recorded instead of raised.

Run from the repo root: ``python3 seq2seq_parity_probe.py``.  Each
reading is one ``[probe_...]`` JSON line.
"""
import copy
import sys

import numpy as np

import chip_smoke as cs


def _grads(torch, model, inputs, dtype, kernels):
    """Gradients (f64 copies) and each feed-forward block's ReLU gates
    of one forward and backward."""
    from paddle_tpu_torch.framework import flags
    flags.set_flags({"FLAGS_use_pallas_kernels": kernels})
    gates = {}
    hooks = [m.linear1.register_forward_hook(
        lambda mod, i, out, n=n: gates.__setitem__(n, out.detach() > 0))
        for n, m in model.named_modules() if hasattr(m, "linear1")]
    try:
        loss = model(*(x.to(dtype) if x.is_floating_point() else x
                       for x in inputs))
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        for h in hooks:
            h.remove()
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, (g.double() for g in grads))), gates


def gates_free(torch):
    from paddle_tpu_torch.framework import flags
    model, _, inputs = cs.seq2seq_parity_case(torch, 0)
    model64 = copy.deepcopy(model).double()
    snap = flags.flags_snapshot()
    try:
        for masks in (True, False):
            x = inputs if masks else inputs[:3]
            runs = {"on": _grads(torch, model, x, torch.float32, True),
                    "off": _grads(torch, model, x, torch.float32, False),
                    "f64": _grads(torch, model64, x, torch.float64, False)}
            for a, b in (("on", "off"), ("on", "f64"), ("off", "f64")):
                (ga, gates_a), (gb, gates_b) = runs[a], runs[b]
                rel = {n: ((ga[n] - gb[n]).abs().max()
                           / gb[n].abs().max()).item()
                       for n in gb if not n.endswith("k_proj.bias")}
                worst = max(rel, key=rel.get)
                cs.log("probe_gates_free", masks=masks, pair=f"{a}/{b}",
                       gates_differing={n: int((gates_a[n] != gates_b[n])
                                               .sum()) for n in gates_a},
                       leaf_max_rel=rel[worst], leaf=worst,
                       median_leaf_max_rel=float(np.median(
                           list(rel.values()))))
    finally:
        flags.flags_restore(snap)


def gates_pinned(torch):
    import paddle_tpu_torch.nn.layer.transformer as tr
    from paddle_tpu_torch.framework.flags import flag
    base, check, failed = tr.attention_bnsh, cs.check, []
    perturbed = {
        "sound": None,
        "q x (1 + 1e-4)": lambda q, k, v, **kw: base(q * (1 + 1e-4), k, v,
                                                      **kw),
        "q x (1 + 1e-5)": lambda q, k, v, **kw: base(q * (1 + 1e-5), k, v,
                                                      **kw),
        "out x (1 + 1e-5)": lambda q, k, v, **kw: base(q, k, v, **kw)
        * (1 + 1e-5)}
    cs.check = lambda ok, msg: ok or failed.append(msg)
    try:
        for name, fn in perturbed.items():
            def attention(q, k, v, fn=fn, **kw):
                if fn is None or not flag("use_pallas_kernels"):
                    return base(q, k, v, **kw)
                return fn(q, k, v, **kw)
            tr.attention_bnsh = attention
            failed.clear()
            cs.phase_seq2seq_parity(torch, 0)
            cs.log("probe_gates_pinned", perturbation=name,
                   failed_checks=list(failed))
    finally:
        tr.attention_bnsh, cs.check = base, check


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("seq2seq_parity_probe: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    gates_free(torch)
    gates_pinned(torch)


if __name__ == "__main__":
    main()
