"""The CUDA flash-decode kernels' order of arithmetic, emulated on the CPU.

The kernels of ``csrc/flash_decode.cu`` run only on the card
(tests/test_torch_kernels_gpu.py and chip_smoke.py hold them against the
plain versions there).  ``_kernel_order`` is a pure-torch emulation of
where they split, round and merge; it is held against JAX's
``decode_attention_reference`` here, so that the limits the card's
checks use are shown to cover where the kernels round.  Tolerances: f32
and int8 KV atol 1e-6 (summation order only); bf16 2^-6 of each (batch,
head) row's largest |out| (chip_smoke.py's BF16_ROW_RTOL).
"""
import importlib
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_port_util  # noqa: F401  (TF32 off, thread count)
from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows

# the pallas package re-exports a function under the module's name
jfd = importlib.import_module("paddle_tpu.ops.pallas.flash_decode")
ATOL = 1e-6
# the worst bf16 row error seen, quoted at chip_smoke.py's BF16_ROW_RTOL
BF16_ROW_RTOL = 2.0 ** -6

# csrc/flash_decode.cu: a cluster of C = min(4, ceil(S / 64)) ranks per
# (batch, head) row, rank r over columns [r*span, (r+1)*span) with span =
# ceil(S / C); a rank walks its live rows in chunks of 8192 / (2*H*elt)
# rows (one ring stage of K + V) with an online softmax, p rounded to V's
# dtype against the running max; rank 0 merges in rank order.
_SPLIT_COLS, _MAX_CLUSTER, _STAGE_BYTES = 64, 4, 8192


def _kernel_order(q, k, v, lo, hi, k_scale=None, v_scale=None):
    """A pure-torch emulation of the kernels' arithmetic, f32 throughout
    but where they round.  With scales, k/v are int8 rows and each chunk's
    scales are read as the kernel's bulk copy lands them: widened to
    4-row boundaries of the flat scale tensor (the widening is NaN past
    its end, so a wrong index shows)."""
    B, N, _, H = q.shape
    S = k.shape[2]
    quant = k_scale is not None
    C = min(_MAX_CLUSTER, -(-S // _SPLIT_COLS))
    span = -(-S // C)
    chunk = min(_STAGE_BYTES // (2 * H * k.element_size()), span)
    scale = torch.tensor(1.0 / math.sqrt(H), dtype=torch.float32)
    neg = torch.tensor(-1e30, dtype=torch.float32)
    qf, kf, vf = q.float()[:, :, 0], k.float(), v.float()
    flat = {}
    if quant:
        for nm, sc in (("k", k_scale), ("v", v_scale)):
            f = sc.reshape(-1)
            flat[nm] = torch.cat([f, torch.full((3,), float("nan"))])
    out = torch.empty(B, N, H)
    for b in range(B):
        for n in range(N):
            parts = []
            for r in range(C):
                a = max(int(lo[b]), 0, r * span)
                e = min(int(hi[b]), S, (r + 1) * span)
                m, l, acc = neg, torch.zeros(()), torch.zeros(H)
                for c0 in range(a, e, chunk):
                    rows = slice(c0, min(c0 + chunk, e))
                    kr, vr = kf[b, n, rows], vf[b, n, rows]
                    if quant:
                        g0 = (b * N + n) * S + c0
                        a4, cnt = g0 & ~3, rows.stop - rows.start
                        e4 = (g0 + cnt + 3) & ~3
                        off = g0 - a4
                        ks = flat["k"][a4:e4][off:off + cnt]
                        vs = flat["v"][a4:e4][off:off + cnt]
                    # int8: a row's scale multiplies the dot product of
                    # its integers, and p before the PV product
                    s = (kr * qf[b, n]).sum(-1)
                    s = (s * ks if quant else s) * scale
                    m_new = torch.maximum(m, s.max())
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    l = l * alpha + p.sum()
                    pv = p * vs if quant else p.to(v.dtype).float()
                    acc = acc * alpha + (pv[:, None] * vr).sum(0)
                    m = m_new
                parts.append((m, l, acc))
            g = neg
            for m, _, _ in parts:
                g = torch.maximum(g, m)
            l_tot, o = torch.zeros(()), torch.zeros(H)
            for m, l, acc in parts:
                w = torch.exp(m - g)
                l_tot = l_tot + l * w
                o = o + acc * w
            out[b, n] = o / (l_tot if l_tot != 0 else 1.0)
    return out[:, :, None].to(q.dtype)


# (B, N, S, H, start, end), None = the full cache: the CASES rows of
# tests/test_torch_flash_decode.py, then cache lengths off the 64-column
# span (32: one rank; 200: four ranks of 50) and S = 1024 (four ranks of
# 256 columns: 4 to 64 chunks a rank, every rank but the last empty in
# row 0), and an odd S whose scales start off 16 bytes
ORDER_CASES = {
    "full": (2, 2, 256, 64, None, None),
    "windowed": (2, 2, 256, 64, [3, 100], [200, 256]),
    "empty_splits": (2, 2, 256, 64, [130, 0], [256, 40]),
    "single_column": (2, 2, 256, 64, [17, 0], [18, 256]),
    "h128": (1, 2, 256, 128, [5], [250]),
    "s32": (3, 2, 32, 64, [0, 20, 31], [32, 25, 32]),
    "s200": (2, 2, 200, 64, [3, 0], [200, 150]),
    "s1024": (2, 2, 1024, 64, [990, 5], [1024, 1023]),
    "s1024_h256": (1, 2, 1024, 256, [3], [1021]),
    "s201_off4": (2, 3, 201, 64, [5, 1], [199, 198]),
}


def _order_case(name, seed):
    B, N, S, H, start, end = ORDER_CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32)
               for shape in ((B, N, 1, H), (B, N, S, H), (B, N, S, H)))
    lo = np.zeros(B, np.int32) if start is None else np.asarray(start,
                                                                 np.int32)
    hi = np.full(B, S, np.int32) if end is None else np.asarray(end,
                                                                np.int32)
    return q, k, v, lo, hi


def _j(a):
    return jnp.asarray(a)


def _close(port, want):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(ORDER_CASES))
def test_kernel_order_matches_jax_reference(name):
    """f32: within ATOL of JAX's reference; bf16: within 2^-6 of each
    (batch, head) row's max |out| of JAX's reference on the same bf16
    inputs; int8 KV (f32 q): within ATOL of the reference over the
    dequantized cache."""
    q, k, v, lo, hi = _order_case(name, seed=3)
    got = _kernel_order(*(torch.from_numpy(a) for a in (q, k, v, lo, hi)))
    ref = jfd.decode_attention_reference(_j(q), _j(k), _j(v), _j(lo),
                                         _j(hi))
    _close(got, ref)

    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = _kernel_order(tq, tk, tv, torch.from_numpy(lo),
                        torch.from_numpy(hi)).float()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref = torch.from_numpy(np.asarray(jfd.decode_attention_reference(
        jq, jk, jv, _j(lo), _j(hi)), np.float32))
    err = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
    assert torch.isfinite(got).all()
    assert err.max().item() <= BF16_ROW_RTOL, err.max().item()

    k8, ks = quantize_kv_rows(torch.from_numpy(k))
    v8, vs = quantize_kv_rows(torch.from_numpy(v))
    got = _kernel_order(torch.from_numpy(q), k8, v8, torch.from_numpy(lo),
                        torch.from_numpy(hi), ks, vs)
    jk8, jks, jv8, jvs = (jnp.asarray(t.numpy()) for t in (k8, ks, v8, vs))
    ref = jfd.decode_attention_reference(
        _j(q), jfd.dequantize_kv(jk8, jks), jfd.dequantize_kv(jv8, jvs),
        _j(lo), _j(hi))
    _close(got, ref)


def test_kernel_order_row_without_valid_column_is_zero():
    """The kernels' guard: a row whose window holds no column gives 0,
    where the plain versions give the uniform softmax of the -1e30 mask
    (test_torch_flash_decode.py::test_row_without_valid_column_is_finite)."""
    q, k, v, _, _ = _order_case("full", seed=0)
    lo, hi = np.asarray([10, 0], np.int32), np.asarray([10, 256], np.int32)
    got = _kernel_order(*(torch.from_numpy(a) for a in (q, k, v, lo, hi)))
    assert (got[0] == 0).all()
    ref = jfd.decode_attention_reference(_j(q), _j(k), _j(v), _j(lo),
                                         _j(hi))
    _close(got[1:], np.asarray(ref)[1:])
