"""The port's CUDA kernels on the card (flash-decode B3/B4,
flash-attention B1/B2, fused batch norm B5/B6, fused conv B7), against
their plain PyTorch versions on the same inputs, and the dense serving
path on the card (bf16 and int8: cuBLASLt's int8 GEMM against the exact
product).

Imports neither JAX nor the JAX package, so it runs on the machine with
the card, where JAX is not installed (its conftest is skipped there)::

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Here, without a card, every test skips: a CUDA kernel has no CPU mode.
Tolerances of the decode kernels (the flash-attention ones are stated at
``FA_TOL``): f32 atol 1e-5 (summation order of the cluster merge); bf16
atol 1e-2 (the kernel rounds its output to bf16, the plain version runs
in f32 on the same bf16 inputs: half a bf16 step at |out| < 4), and 2^-6
of each (batch, head) row's largest |out| against the plain version run
on the bf16 tensors themselves, which rounds at the kernel's points
(chip_smoke.py states the reasons).
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
from paddle_tpu_torch.ops.kernels import flash_decode as fd
from paddle_tpu_torch.profiler.cuda_graph import (graph_kernel_nodes,
                                                  kernel_node_grids)

pytestmark = pytest.mark.gpu

# (B, N, S, H, start, end): None = the full cache
CASES = {
    "full": (2, 2, 256, 64, None, None),
    "windowed": (2, 2, 256, 64, [3, 100], [200, 256]),
    "empty_splits": (2, 2, 256, 64, [130, 0], [256, 40]),
    "single_column": (2, 2, 256, 64, [17, 0], [18, 256]),
    "h128": (1, 2, 256, 128, [5], [250]),
    # S = 1024: four cluster ranks of 256 columns, each walking its span
    # in chunks through the three-stage ring (4 to 64 chunks by dtype and
    # head_dim); row 1's window leaves every rank but the last empty
    "h256_s1024": (2, 3, 1024, 256, [0, 700], [1024, 701]),
    "s1024": (2, 2, 1024, 64, [3, 990], [1021, 1024]),
    # cache lengths that are no multiple of the 64-column span: one rank
    # of 32 or 16 columns, four ranks of 50
    "s200": (2, 2, 200, 64, [3, 0], [200, 150]),
    "s32": (3, 2, 32, 64, [0, 20, 31], [32, 25, 32]),
    "s16_h128": (2, 2, 16, 128, [0, 9], [16, 10]),
    # odd S: the int8 scales of a window start and end off a 4-row (16-
    # byte) boundary of the scale tensor in every (batch, head) row
    "s201_off4": (2, 3, 201, 64, [5, 1], [199, 198]),
    # bench_decode's served shape (B = 8, N = 12, cache 256, H = 64),
    # which its int8 variant runs in f32: generate()'s windows [0, pos +
    # 1) at decode positions 128 to 255, and ragged starts
    "served": (8, 12, 256, 64, [0] * 8,
               [129, 150, 177, 200, 223, 240, 255, 256]),
    "served_ragged": (8, 12, 256, 64, [0, 3, 17, 40, 64, 77, 90, 99],
                      [256, 129, 200, 255, 131, 190, 240, 222]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-decode kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _case(name, dev, dtype=torch.float32, seed=0):
    B, N, S, H, start, end = CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(dev, dtype)
               for shape in ((B, N, 1, H), (B, N, S, H), (B, N, S, H)))
    lo = None if start is None else torch.tensor(start, dtype=torch.int32,
                                                 device=dev)
    hi = None if end is None else torch.tensor(end, dtype=torch.int32,
                                               device=dev)
    return q, k, v, lo, hi


def _assert_rows_close(got, want, rtol=2.0 ** -6):
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    assert bool((err <= rtol * scale).all()), (err / scale).max().item()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_plain_versions(cuda, name, dtype, atol):
    q, k, v, lo, hi = _case(name, cuda, dtype)
    n0, nq0 = fd.flash_decode.launches, fd.flash_decode_quant.launches
    got = fd.flash_decode(q, k, v, lo, hi)
    want = fd.flash_decode_plain(q.float(), k.float(), v.float(), lo, hi)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        _assert_rows_close(got, fd.flash_decode_plain(q, k, v, lo, hi))
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    got = fd.flash_decode_quant(q, k8, v8, ks, vs, lo, hi)
    want = fd.flash_decode_quant_plain(q.float(), k8, v8, ks, vs, lo, hi)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        _assert_rows_close(got, fd.flash_decode_quant_plain(q, k8, v8, ks, vs,
                                                            lo, hi))
    assert (fd.flash_decode.launches - n0,
            fd.flash_decode_quant.launches - nq0) == (1, 1)


@pytest.mark.parametrize("name", ["full", "s1024", "s201_off4", "served"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_repeat_bit_for_bit(cuda, name, dtype):
    """Two launches on one input give the same bits: one writer per
    output, sums in a fixed order (the cluster merges in rank order)."""
    q, k, v, lo, hi = _case(name, cuda, dtype, seed=1)
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    runs = [(fd.flash_decode(q, k, v, lo, hi),
             fd.flash_decode_quant(q, k8, v8, ks, vs, lo, hi))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_give_zero_for_a_row_without_valid_column(cuda, dtype):
    """Every rank of row 0's clusters is empty: the kernels' l_tot == 0
    guard gives 0 there (the plain versions give the uniform softmax of
    the -1e30 mask); row 1 agrees with the plain version."""
    q, k, v, _, _ = _case("full", cuda, dtype)
    lo = torch.tensor([10, 0], dtype=torch.int32, device=cuda)
    hi = torch.tensor([10, 256], dtype=torch.int32, device=cuda)
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    for got, want in (
            (fd.flash_decode(q, k, v, lo, hi),
             fd.flash_decode_plain(q.float(), k.float(), v.float(), lo,
                                   hi)),
            (fd.flash_decode_quant(q, k8, v8, ks, vs, lo, hi),
             fd.flash_decode_quant_plain(q.float(), k8, v8, ks, vs, lo,
                                         hi))):
        assert bool(torch.isfinite(got).all())
        assert bool((got[0] == 0).all())
        torch.testing.assert_close(got[1].float(), want[1], rtol=0,
                                   atol=1e-5 if dtype == torch.float32
                                   else 1e-2)


def test_wrappers_raise_on_a_start_off_16_bytes(cuda):
    """q, k, v and the scales are read in 16-byte pieces from 16-byte
    boundaries: a contiguous tensor starting elsewhere raises (no copy,
    no fallback)."""
    q, k, v, lo, hi = _case("windowed", cuda)

    def shifted(t, elems):
        buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
        out = buf[elems:].view_as(t)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    for args in ((shifted(q, 1), k, v), (q, shifted(k, 2), v),
                 (q, k, shifted(v, 3))):
        with pytest.raises(ValueError, match="16-byte"):
            fd.flash_decode(*args, lo, hi)
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    with pytest.raises(ValueError, match="16-byte"):
        fd.flash_decode_quant(q, shifted(k8, 8), v8, ks, vs, lo, hi)
    with pytest.raises(ValueError, match="16-byte"):
        fd.flash_decode_quant(q, k8, v8, ks, shifted(vs, 1), lo, hi)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, k, v, lo, hi = _case("windowed", cuda)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k.bfloat16(), v, lo, hi)          # mixed dtype
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                        v, lo, hi)                           # strided
    with pytest.raises(ValueError):
        fd.flash_decode(q[..., :32], k[..., :32].contiguous(),
                        v[..., :32].contiguous(), lo, hi)     # head_dim 32
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.cpu(), v, lo, hi)                # mixed device
    k8, ks = quantize_kv_rows(k)
    with pytest.raises(TypeError):
        fd.flash_decode_quant(q, k, v, ks, ks, lo, hi)        # not int8
    with pytest.raises(ValueError):
        fd.flash_decode_quant(q, k8, k8, ks[:, :, :128], ks, lo, hi)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_on_cuda_launches_the_kernel_at_any_cache_length(
        cuda, kv):
    """cached_attention takes the kernel for a windowed decode step on
    CUDA whatever the cache length (here 32, no multiple of 128)."""
    from paddle_tpu_torch.nn.functional.attention import cached_attention
    q, k, v, lo, hi = _case("s32", cuda)
    n0, nq0 = fd.flash_decode.launches, fd.flash_decode_quant.launches
    if kv == "int8":
        k8, ks = quantize_kv_rows(k)
        v8, vs = quantize_kv_rows(v)
        got = cached_attention(q, k8, v8, window=(lo, hi), k_scale=ks,
                               v_scale=vs)
        want = fd.flash_decode_quant_plain(q, k8, v8, ks, vs, lo, hi)
    else:
        got = cached_attention(q, k, v, window=(lo, hi))
        want = fd.flash_decode_plain(q, k, v, lo, hi)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert (fd.flash_decode.launches - n0,
            fd.flash_decode_quant.launches - nq0) \
        == ((0, 1) if kv == "int8" else (1, 0))


# -- flash attention (B1 forward, B2 dQ and dK/dV) ----------------------------
# (B, N, Sq, Sk, H, causal, bias shape or None)
FA_CASES = {
    "s128_h64": (2, 2, 128, 128, 64, False, None),
    "s200_causal": (2, 2, 200, 200, 64, True, None),
    "cross_causal": (1, 2, 128, 384, 64, True, None),
    "h128_pad_bias": (2, 2, 256, 256, 128, False, (2, 1, 1, 256)),
    "h256_shared_bias": (1, 2, 128, 128, 256, False, (1, 1, 128, 128)),
    "full_bias_causal": (2, 2, 128, 128, 64, True, (2, 2, 128, 128)),
    "ragged_77": (1, 3, 77, 77, 64, False, (1, 1, 1, 77)),
    # the Transformer's shapes (chip_smoke.py FA_CHECKS): S = 64 below the
    # 128-row tile, cross-attention with Sq != Sk either way round (not
    # causal, under a source-padding bias), and the square target mask
    # of 0 / -1e30 (generate_square_subsequent_mask)
    "s64_n4": (2, 4, 64, 64, 64, False, None),
    "cross_96x40_pad_bias": (2, 4, 96, 40, 64, False, (2, 1, 1, 40)),
    "cross_40x96": (2, 4, 40, 96, 64, False, None),
    "s64_square_mask": (2, 4, 64, 64, 64, False, "square"),
    # the model's strided views of (B, S, N*H) projections ("bsnh"): the
    # int8 BERT program's served f32 shape, BERT's padding row (B, 1, 1,
    # Sk) of 0 and -1e4 ("pad"), Transformer-big's causal S = 64; and
    # ragged, causal cross and biased shapes at every head_dim (the f32
    # forward's split-TF32 tiles and column blocks)
    "served_bsnh": (16, 12, 128, 128, 64, False, None, "bsnh"),
    "bert_pad_bias_bsnh": (8, 12, 128, 128, 64, False, "pad", "bsnh"),
    "seq2seq_causal_bsnh": (4, 16, 64, 64, 64, True, None, "bsnh"),
    "h128_full_bias_s200": (2, 2, 200, 200, 128, False, (2, 2, 200, 200)),
    "h256_causal_cross_pad": (1, 2, 77, 200, 256, True, "pad"),
    "h64_causal_cross": (2, 3, 64, 96, 64, True, None),
    "ragged_17x33_h128": (2, 2, 17, 33, 128, False, (2, 1, 1, 33)),
    "ragged_77_h256_shared_bias": (1, 3, 77, 77, 256, False, (1, 1, 77, 77)),
    # bench.py's moe workload: GPT training at hidden 512, 8 heads, seq
    # 128, batch 32 in f32, under GPTModel's additive causal bias (1, 1,
    # S, S) of 0 and -1e4 ("gpt"), not the kernels' causal path
    "gpt_causal_bias_bsnh": (32, 8, 128, 128, 64, False, "gpt", "bsnh"),
}


# the bf16 tensor-core kernels (mma.sync on 16-row fragments, 64-row
# blocks, key steps of 64, or 32 at H = 256) at lengths that are no
# multiple of 16 or 64, every head_dim, the three bias shapes
FA_TC_CASES = {
    "sq1": (2, 3, 1, 1, 64, False, None),
    "sq1_sk200_pad_bias": (2, 2, 1, 200, 128, False, (2, 1, 1, 200)),
    "s17_causal": (2, 2, 17, 17, 64, True, None),
    "s17_h256_full_bias": (1, 2, 17, 17, 256, False, (1, 2, 17, 17)),
    "s200_h128_causal_shared_bias": (2, 2, 200, 200, 128, True,
                                     (1, 1, 200, 200)),
    "s200_h256_causal_pad_bias": (2, 2, 200, 200, 256, True, (2, 1, 1, 200)),
    "cross_causal_128x384_pad_bias": (2, 2, 128, 384, 64, True,
                                      (2, 1, 1, 384)),
    "cross_causal_128x384_h256": (1, 2, 128, 384, 256, True, None),
    "cross_17x200_h128_full_bias": (1, 3, 17, 200, 128, False,
                                    (1, 3, 17, 200)),
}


def _fa_case(name, dev, dtype, seed=0):
    B, N, Sq, Sk, H, causal, bshape, *layout = \
        {**FA_CASES, **FA_TC_CASES}[name]
    rng = np.random.RandomState(seed)
    if layout == ["bsnh"]:
        t = lambda B, N, S, H: torch.from_numpy(rng.randn(B, S, N * H).astype(
            np.float32)).view(B, S, N, H).transpose(1, 2)
    else:
        t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    q, k, v = t(B, N, Sq, H), t(B, N, Sk, H), t(B, N, Sk, H)
    do = t(B, N, Sq, H)
    bias = None
    if bshape in ("square", "gpt"):
        fill = -1e30 if bshape == "square" else -1e4
        bias = torch.from_numpy(np.triu(np.full((1, 1, Sq, Sk), fill,
                                                np.float32), 1)).to(dev)
    elif bshape == "pad":
        lens = rng.randint(Sk // 2, Sk + 1, B)
        bias = torch.from_numpy(np.where(
            np.arange(Sk)[None] < lens[:, None], 0.0, -1e4).astype(
                np.float32)[:, None, None]).to(dev)
    elif bshape is not None:
        bias = torch.from_numpy(np.where(rng.rand(*bshape) < 0.2, -1e4,
                                         0.0).astype(np.float32)).to(dev)
    if layout == ["bsnh"]:       # the same strided views on the card
        return ([x.transpose(1, 2).contiguous().to(dev, dtype)
                 .transpose(1, 2) for x in (q, k, v, do)], bias, causal)
    return ([x.to(dev, dtype) for x in (q, k, v, do)], bias, causal)


def _max_rel(got, want):
    """Largest |got - want| over max(1, max |want|)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1.0)).item()


# f32: both sum in f32, in other orders, over <= 384 terms: ~1e-6 of the
# largest value; bf16 against the plain version on the same bf16 inputs,
# which rounds p, ds and the outputs at the kernels' points: they differ
# where summation order moves a value across a bf16 rounding boundary,
# one bf16 step (2^-8 of the value) at most per output: 2^-6 of the
# tensor's largest |value| leaves a margin of 4.
FA_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FA_CASES))
def test_flash_attention_kernels_match_plain_versions(cuda, name, dtype):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    (q, k, v, do), bias, causal = _fa_case(name, cuda, dtype)
    n0 = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dq,
          fa.flash_attention.launches_dkv)
    o, lse = fa.flash_fwd(q, k, v, bias, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, causal)
    dd = fa.flash_dd(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, bias, lse_ref, do, dd, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, bias, lse_ref, do, dd, causal)
    want = fa.flash_bwd_reference(q, k, v, bias, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    tol = FA_TOL[dtype]
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == q.shape[:3]
    assert _max_rel(o, o_ref) <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(torch.isfinite(got).all())
        assert _max_rel(got, ref) <= tol
    if dtype == torch.bfloat16:     # against f32 plain on the same inputs
        o32, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(),
                                        bias, causal)
        torch.testing.assert_close(o.float(), o32, atol=1e-2, rtol=0)
    n1 = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dq,
          fa.flash_attention.launches_dkv)
    assert tuple(b - a for a, b in zip(n0, n1)) == (1, 1, 1)


def _fa_run(q, k, v, do, bias, causal):
    """The three kernels on one input: o, lse (forward), and dQ, dK, dV
    from the plain forward's lse."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    o, lse = fa.flash_fwd(q, k, v, bias, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, causal)
    dd = fa.flash_dd(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, bias, lse_ref, do, dd, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, bias, lse_ref, do, dd, causal)
    return (o, lse, dq, dk, dv), (o_ref, lse_ref, dd)


@pytest.mark.parametrize("name", list(FA_TC_CASES))
def test_flash_attention_tensor_core_kernels_match_plain_versions(cuda,
                                                                  name):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    (q, k, v, do), bias, causal = _fa_case(name, cuda, torch.bfloat16)
    (o, lse, dq, dk, dv), (o_ref, lse_ref, _) = _fa_run(q, k, v, do, bias,
                                                        causal)
    want = fa.flash_bwd_reference(q, k, v, bias, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    tol = FA_TOL[torch.bfloat16]
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert _max_rel(o, o_ref) <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert bool(torch.isfinite(got).all())
        assert _max_rel(got, ref) <= tol
    o32, _ = fa.flash_fwd_reference(q.float(), k.float(), v.float(), bias,
                                    causal)
    torch.testing.assert_close(o.float(), o32, atol=1e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["s200_h256_causal_pad_bias",
                                  "cross_causal_128x384_pad_bias",
                                  "h128_pad_bias", "s128_h64",
                                  "gpt_causal_bias_bsnh"])
def test_flash_attention_tensor_core_kernels_repeat_bit_for_bit(cuda, name,
                                                                dtype):
    """One writer per output, fixed-order sums, no atomics: two launches
    on one input give the same bits (f32: the split-TF32 forward and the
    FMA backward)."""
    (q, k, v, do), bias, causal = _fa_case(name, cuda, dtype, seed=3)
    first, _ = _fa_run(q, k, v, do, bias, causal)
    again, _ = _fa_run(q, k, v, do, bias, causal)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["served_bsnh", "bert_pad_bias_bsnh",
                                  "seq2seq_causal_bsnh", "h128_full_bias_s200",
                                  "h256_causal_cross_pad",
                                  "gpt_causal_bias_bsnh"])
def test_flash_attention_f32_backward_takes_the_kernel_forward(cuda, name):
    """The f32 backward kernels (B2, FMA) fed the f32 forward kernel's o
    and lse (split TF32) stay within their limit of the plain backward on
    the plain forward's."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    (q, k, v, do), bias, causal = _fa_case(name, cuda, torch.float32, seed=1)
    o, lse = fa.flash_fwd(q, k, v, bias, causal)
    dd = fa.flash_dd(o, do)
    dq = fa.flash_bwd_dq(q, k, v, bias, lse, do, dd, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, bias, lse, do, dd, causal)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, causal)
    want = fa.flash_bwd_reference(q, k, v, bias, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        assert _max_rel(got, ref) <= FA_TOL[torch.float32]


def test_flash_attention_bf16_misaligned_views_are_copied_not_misread(cuda):
    """A bf16 view whose rows are 8-byte but not 16-byte aligned is
    copied by the wrapper (same result as an aligned copy); handed to
    the launch function directly, it is refused, never read."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    B, N, S, H = 2, 2, 77, 64
    rng = np.random.RandomState(4)
    wide = torch.from_numpy(rng.randn(B, S, N * H + 4).astype(np.float32)) \
        .to(cuda, torch.bfloat16)
    view = wide[..., 4:].view(B, S, N, H).transpose(1, 2)   # 8-byte start
    assert view.data_ptr() % 16 == 8
    aligned = view.contiguous()
    got, _ = fa.flash_fwd(view, view, view)
    want, _ = fa.flash_fwd(aligned, aligned, aligned)
    assert torch.equal(got, want)
    o = torch.empty_like(aligned)
    lse = torch.empty(B, N, S, device=cuda)
    dims = fa._dims(B, N, S, S, H, view, view, view, None, o, None, None)
    rc = _build.library("flash_attention").flash_attn_fwd_launch(
        view.data_ptr(), view.data_ptr(), view.data_ptr(), None,
        o.data_ptr(), lse.data_ptr(), ctypes.addressof(dims), 0.125, 0, 1,
        fa._stream())
    assert rc != 0


def test_flash_attention_autograd_and_dispatch_on_cuda(cuda):
    """attention_bnsh on CUDA sends forward and backward through the
    kernels (no sequence-length gate), and a trainable mask runs plain."""
    from paddle_tpu_torch.nn.functional.attention import attention_bnsh
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    (q, k, v, do), bias, _ = _fa_case("h128_pad_bias", cuda, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = fa.flash_attention.launches_fwd, fa.flash_attention.launches_dkv
    out = attention_bnsh(*leaves, attn_mask=bias)
    out.backward(do)
    assert (fa.flash_attention.launches_fwd - n0[0],
            fa.flash_attention.launches_dkv - n0[1]) == (1, 1)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias)
    want = fa.flash_bwd_reference(q, k, v, bias, o_ref, lse_ref, do)
    assert _max_rel(out.detach(), o_ref) <= 1e-5
    for t, ref in zip(leaves, want):
        assert _max_rel(t.grad, ref) <= 1e-5
    trainable = bias.clone().requires_grad_()
    attention_bnsh(q, k, v, attn_mask=trainable)
    assert fa.flash_attention.launches_fwd - n0[0] == 1


def test_flash_attention_raises_on_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    (q, k, v, _), _, _ = _fa_case("s128_h64", cuda, torch.float32)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention(k[:, :, :100], q[:, :, :50], q[:, :, :50],
                           causal=True)                       # Sq > Sk
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, bias=torch.zeros(3, 1, 1, 128,
                                                     device=cuda))


# -- fused batch norm (B5, B6) and the fused conv (B7) -----------------------
#
# Tolerances, each kernel against its plain version on the same inputs:
#  * B5 apply and B6 dx are elementwise and round x·scale + shift and
#    a·dy' + b·x + c operation by operation, as the plain version's tensor
#    ops do: the results are equal, in f32 and after the rounding to bf16;
#  * B5 stats and B6 reduce sum the same f32 terms in another order:
#    rtol 1e-5, atol 1e-5 on the moments, 1e-4 on the raw sums of M terms;
#  * B7 sums kh·kw·Cin f32 products in another order than cuDNN's f32 conv
#    (TF32 off): 1e-4 of max(1, max|y|) in f32; in bf16 both round the
#    f32 result, and a value near a rounding boundary may land one bf16
#    step apart: 2^-7 of max|y|, one step of the largest output.  Its
#    moments come from the f32 accumulator in both: rtol 1e-4, atol 1e-5.

BN_CASES = {
    "m512_c64": (512, 64),
    "m1000_c256": (1000, 256),      # M no multiple of a row chunk
    "m96_c12": (96, 12),            # C no multiple of the vector width
    "m64_c2048": (64, 2048),        # more than one column tile in f32
}

CONV_CASES = {   # N, H, W, Cin, Cout, k, stride, pad
    "3x3_s1": (2, 8, 8, 16, 32, 3, 1, 1),
    "3x3_s2": (2, 9, 9, 16, 24, 3, 2, 1),
    "1x1_s1": (2, 8, 8, 64, 64, 1, 1, 0),
    "1x1_s2": (2, 8, 8, 32, 64, 1, 2, 0),
    "5x5_s1": (2, 6, 6, 8, 16, 5, 1, 2),
    "s2d_stem": (2, 11, 11, 12, 64, 4, 1, 0),
    "odd_widths": (1, 7, 5, 20, 36, 3, 1, 1),   # Cin, Cout off the vectors
    "cin4_cout6": (2, 5, 5, 4, 6, 3, 1, 1),
    "cin3": (2, 9, 9, 3, 10, 3, 1, 1),          # element loads
    # the bf16 tensor-core tile's edges: a K loop longer than the ring,
    # a full 128-wide column tile and a ragged one, stride 2 at Cin 64,
    # the real s2d stem, M = 49 (no multiple of the 128-row tile)
    "k_past_ring": (2, 8, 8, 128, 128, 3, 1, 1),
    "cout192": (2, 8, 8, 64, 192, 1, 1, 0),
    "3x3_s2_cin64": (2, 16, 16, 64, 64, 3, 2, 1),
    "stem_115": (2, 115, 115, 12, 64, 4, 1, 0),
    "m49": (1, 7, 7, 512, 512, 1, 1, 0),
}


def _bn_inputs(dev, M, C, dtype, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
    x = (t(M, C) * 2 + 0.5).to(dtype)
    return (x, t(M, C).to(dtype), t(C), t(C) * 0.5, t(C), t(C), t(C))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(BN_CASES))
def test_fused_bn_kernels_match_plain_versions(cuda, name, dtype, relu):
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    x, dy, scale, shift, a, b, c = _bn_inputs(cuda, *BN_CASES[name], dtype)
    n0 = fb.launch_counts()
    mean, var = fb.bn_moments(x)
    y = fb.bn_apply(x, scale, shift, relu)
    sdyx, sdy = fb.bn_bwd_reduce(x, dy, scale, shift, relu)
    dx = fb.bn_bwd_dx(x, dy, scale, shift, a, b, c, relu)
    torch.cuda.synchronize()
    assert {k: v - n0[k] for k, v in fb.launch_counts().items()} == {
        "bn_moments": 1, "bn_apply": 1, "bn_bwd_reduce": 1, "bn_bwd_dx": 1}
    want_m, want_v = fb.moments_plain(x)
    torch.testing.assert_close(mean, want_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(var, want_v, rtol=1e-5, atol=1e-5)
    want_dyx, want_dy = fb.bwd_reduce_plain(x, dy, scale, shift, relu)
    torch.testing.assert_close(sdyx, want_dyx, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sdy, want_dy, rtol=1e-5, atol=1e-4)
    assert y.dtype == dtype and dx.dtype == dtype
    assert torch.equal(y, fb.apply_plain(x, scale, shift, relu))
    assert torch.equal(dx, fb.bwd_dx_plain(x, dy, scale, shift, a, b, c,
                                           relu))


def test_fused_bn_moments_large_offset_stay_finite(cuda):
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(256, 128) * 0.01 + 3000.0)
                         .astype(np.float32)).to(cuda)
    y, _, var = fb.fused_bn_act(x, torch.ones(128, device=cuda),
                                torch.zeros(128, device=cuda), 1e-5, True)
    assert bool(torch.isfinite(y).all()) and bool((var >= 0).all())


def _conv_inputs(dev, N, H, W, Cin, Cout, k, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, H, W, Cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(Cout, Cin, k, k)
                          / np.sqrt(Cin * k * k)).astype(np.float32))
    return x.to(dev, dtype), w.to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CONV_CASES))
def test_conv_stats_kernel_matches_plain_version(cuda, name, dtype):
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    torch.backends.cudnn.allow_tf32 = False
    N, H, W, Cin, Cout, k, s, p = CONV_CASES[name]
    x, w = _conv_inputs(cuda, N, H, W, Cin, Cout, k, dtype)
    n0 = fc.conv_stats.launches
    y, mean, var = fc.conv_stats(x, w, s, p)
    want, want_m, want_v = fc.conv_stats_plain(x, w, s, p)
    torch.cuda.synchronize()
    assert fc.conv_stats.launches - n0 == 1
    assert y.shape == want.shape and y.dtype == dtype
    scale = want.float().abs().max().item()
    atol = 1e-4 * max(1.0, scale) if dtype == torch.float32 \
        else scale * 2.0 ** -7
    torch.testing.assert_close(y.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(mean, want_m, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var, want_v, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["stem_115", "cout192", "m49"])
def test_conv_stats_kernel_repeats_bit_for_bit(cuda, name, dtype):
    """Fixed-order sums, no atomics: two launches, the same bits."""
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    N, H, W, Cin, Cout, k, s, p = CONV_CASES[name]
    x, w = _conv_inputs(cuda, N, H, W, Cin, Cout, k, dtype, seed=5)
    first, again = fc.conv_stats(x, w, s, p), fc.conv_stats(x, w, s, p)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_fused_ops_autograd_on_cuda_match_the_cpu(cuda):
    """fused_bn_act and fused_conv_bn_act on the card (every kernel) give
    the values and gradients the plain versions give on the CPU.  Without
    the ReLU: its gate is discontinuous, and an input within rounding of
    0 may be gated differently by the card's and the CPU's sums (the
    kernel tests above hold the gated passes bit-exact on one device)."""
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    torch.backends.cudnn.allow_tf32 = False
    x, w = _conv_inputs("cpu", 2, 8, 8, 16, 32, 3, torch.float32)
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.rand(32).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.randn(32).astype(np.float32) * 0.1)

    def run(dev, fn):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, w, g, b)]
        out, mean, var = fn(*leaves)
        cot = torch.from_numpy(np.random.RandomState(4).randn(
            *out.shape).astype(np.float32)).to(dev)
        ((out * cot).sum() + (mean * mean).sum() + var.sum()).backward()
        return [None if t is None else t.detach().cpu()
                for t in [out] + [v.grad for v in leaves]]

    conv = lambda x_, w_, g_, b_: fc.fused_conv_bn_act(x_, w_, g_, b_, 1, 1,
                                                       1e-5, False)
    bn = lambda x_, w_, g_, b_: fb.fused_bn_act(x_.reshape(-1, 16),
                                                w_[:16, 0, 0, 0] + 1.0,
                                                b_[:16], 1e-5, False)
    for fn in (conv, bn):
        for got, want in zip(run(cuda, fn), run("cpu", fn)):
            if got is None:
                assert want is None
                continue
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    from paddle_tpu_torch.ops.kernels import fused_conv as fc
    x = torch.zeros(16, 8, device=cuda)
    with pytest.raises(TypeError):
        fb.bn_moments(x.half())
    with pytest.raises(ValueError):
        fb.bn_apply(x, torch.ones(4, device=cuda), torch.ones(4, device=cuda),
                    True)
    with pytest.raises(ValueError, match="multiple of 8"):
        fb.fused_bn_act(x[:13], torch.ones(8, device=cuda),
                        torch.zeros(8, device=cuda))
    xc = torch.zeros(2, 8, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        fc.conv_stats(xc, torch.zeros(8, 4, 7, 7, device=cuda), 2, 3)
    with pytest.raises(ValueError):
        fc.conv_stats(xc, torch.zeros(8, 4, 3, 3, device=cuda), 3, 1)
    with pytest.raises(TypeError):
        fc.conv_stats(xc.half(), torch.zeros(8, 4, 3, 3, device=cuda).half())


# -- the slot loop's captured step (text/graphs.py) ---------------------------

def _slot_model(dev):
    """12 layers, as GPT-2 small, at a narrow width (head_dim 64), bf16."""
    from paddle_tpu_torch.text.models import GPTConfig, GPTModel
    model = GPTModel(GPTConfig.tiny(vocab_size=512, hidden_size=128,
                                    layers=12, heads=2, seq=1024),
                     device=dev, dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    return model.eval()


def _slot_steps(dev, kv, C, S=8, model=None):
    """A captured step and the same step run eagerly, from one random
    state (planes and logits), of ``model`` (default ``_slot_model``)."""
    from paddle_tpu_torch.framework.flags import flags_restore, \
        flags_snapshot, set_flags
    from paddle_tpu_torch.text.generation import Generator
    from paddle_tpu_torch.text.graphs import CapturedSlotStep, SlotStep
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_kv_cache_dtype": kv})
        gen = Generator(_slot_model(dev) if model is None else model,
                        device=dev, seq_buckets=(C,), max_len=C)
        cap = gen.step_exec(S, C)
        eager = SlotStep(gen, S, C, -1)
    finally:
        flags_restore(snap)
    assert isinstance(cap, CapturedSlotStep) and cap.captured
    g = torch.Generator(device=dev).manual_seed(C)
    with torch.inference_mode():
        for c in cap.cache:
            for p in c:
                if p.dtype == torch.int8:
                    p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                          device=dev))
                elif p.shape[-1] == 1:
                    p.copy_(torch.rand(p.shape, generator=g, device=dev)
                            * 0.02 + 1e-3)
                else:
                    p.copy_(torch.randn(p.shape, generator=g, device=dev))
        cap.logits.copy_(torch.randn(cap.logits.shape, generator=g,
                                     device=dev))
    eager.load_state(cap)
    return gen, cap, eager


def _assert_same_state(a, b):
    assert torch.equal(a.logits, b.logits)
    for ca, cb in zip(a.cache, b.cache):
        for x, y in zip(ca, cb):
            assert torch.equal(x, y)


def _traced_decode_kernels(fn):
    """The decode-kernel records (decode_cluster_kernel) by name that a
    torch.profiler trace of the device holds while ``fn()`` runs; the
    trace must hold device events.  A trace shows which kernels ran, not
    how often: CUPTI drops records on an H100, so launch counts come from
    the captured graph's nodes (``profiler.cuda_graph``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert kernels, "the profiler recorded no device event"
    return {e.key: e.count for e in kernels
            if "decode_cluster_kernel" in e.key}


@pytest.mark.parametrize("C", [64, 200, 768])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_slot_step_equals_eager_step(cuda, kv, C):
    """Five steps from one state, the host rewriting start, active and pos
    between them: planes, logits, tokens and finished bit-equal.  The
    eager step's wrapper counts advance by 12 (one launch a layer); a
    replay runs no wrapper and counts itself; the graph holds 12 decode
    kernel nodes of 8 x 2 rows (one a layer, run once a replay), and a
    trace of the device shows the kernel of the cache's dtype run."""
    _, cap, eager = _slot_steps(cuda, kv, C)
    rng = np.random.RandomState(C)
    live = "flash_decode_quant" if kv == "int8" else "flash_decode"
    fin_c = fin_e = np.zeros(8, bool)
    for i in range(5):
        pos = C - 5 + i
        start = rng.randint(0, pos + 1, 8).astype(np.int32)
        active = rng.rand(8) < 0.7
        n0, r0 = fd.launch_counts(), cap.replays
        fin_c, tok_c = cap(start, fin_c, active, pos)
        n1 = fd.launch_counts()
        fin_e, tok_e = eager(start, fin_e, active, pos)
        n2 = fd.launch_counts()
        np.testing.assert_array_equal(tok_c, tok_e)
        np.testing.assert_array_equal(fin_c, fin_e)
        _assert_same_state(cap, eager)
        assert n1 == n0 and cap.replays == r0 + 1
        assert {k: n2[k] - n1[k] for k in n2} == {
            name: 12 if name == live else 0 for name in n2}
    assert kernel_node_grids(cap._graph, "decode_cluster_kernel") == \
        {8 * 2: 12}
    traced = _traced_decode_kernels(
        lambda: [cap(start, fin_c, active, C - 1) for _ in range(3)])
    # the int8 cache runs the kernel's int8 instantiation (B4)
    assert traced and all(("signed char" in k) == (kv == "int8")
                          for k in traced), traced


def _frozen_slot_model(dev):
    """``_slot_model``'s 12 layers in f32, PTQ-calibrated over one seeded
    64-token prompt and frozen, as bench_decode's int8 variant: 72 int8
    sites, f32 float layers and cache."""
    from paddle_tpu_torch.quantization import (PostTrainingQuantization,
                                               freeze)
    from paddle_tpu_torch.text.models import GPTConfig, GPTModel
    model = GPTModel(GPTConfig.tiny(vocab_size=512, hidden_size=128,
                                    layers=12, heads=2, seq=1024),
                     device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    cal = torch.from_numpy(np.random.RandomState(0).randint(1, 512, (1, 64)))
    PostTrainingQuantization(model=model.eval(), data_loader=(
        (cal.to(dev),) for _ in range(4)), batch_nums=4).quantize()
    return freeze(model)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_slot_step_with_frozen_sites_equals_eager_step(cuda, kv):
    """The slot step of a frozen-int8 GPT (f32 layers; B3's f32 instance,
    or B4 with an f32 query under the int8 cache): the graph captures
    each site's quantize, padded _int_mm and epilogue, and five replays
    equal the eager step bit for bit; the eager step runs one int8
    product a site (72), the replay none through Python; the graph
    holds 12 decode kernel nodes."""
    from paddle_tpu_torch.ops import int8 as I8
    _, cap, eager = _slot_steps(cuda, kv, 256,
                                model=_frozen_slot_model(cuda))
    rng = np.random.RandomState(7)
    real, calls = I8.int8_mm, []

    def counting(a, w):
        calls.append(a.shape[0])
        return real(a, w)

    fin_c = fin_e = np.zeros(8, bool)
    I8.int8_mm = counting
    try:
        for i in range(5):
            pos = 200 + i
            start = rng.randint(0, pos + 1, 8).astype(np.int32)
            active = rng.rand(8) < 0.7
            fin_c, tok_c = cap(start, fin_c, active, pos)
            assert calls == []
            fin_e, tok_e = eager(start, fin_e, active, pos)
            assert calls == [8] * 72
            del calls[:]
            np.testing.assert_array_equal(tok_c, tok_e)
            np.testing.assert_array_equal(fin_c, fin_e)
            _assert_same_state(cap, eager)
    finally:
        I8.int8_mm = real
    assert cap.logits.dtype == torch.float32
    assert kernel_node_grids(cap._graph, "decode_cluster_kernel") == \
        {8 * 2: 12}


def test_captured_slot_step_reads_activation_logits(cuda):
    """A replay after the slot loop wrote a row's activation logits
    (``set_logits``) reads them: the row's token is their argmax."""
    _, cap, eager = _slot_steps(cuda, "bf16", 200)
    row = torch.full((cap.logits.shape[1],), -1.0, device=cuda)
    row[321] = 5.0
    for step in (cap, eager):
        step.set_logits(3, row)
    active = np.zeros(8, bool)
    active[3] = True
    start = np.full(8, 100, np.int32)
    fin = np.zeros(8, bool)
    _, tok_c = cap(start, fin, active, 150)
    _, tok_e = eager(start, fin, active, 150)
    assert tok_c[3] == tok_e[3] == 321
    np.testing.assert_array_equal(tok_c, tok_e)
    _assert_same_state(cap, eager)


# -- parked sessions on the captured step's planes (serving/slots.py) --------

@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_session_restore_push_then_row_pull_is_exact(cuda, kv):
    """A session's host planes (130 columns: two whole 64-column blocks
    and a tail) pushed into a row of the captured step's own planes as the
    slot loop restores them (whole blocks, then the tail as a 64-wide
    overlap slice ending at the transcript's edge), a replay over the
    restored window, then a pull of the row's window: the pull equals the
    snapshot bit for bit, and the replay equals the eager step's."""
    from paddle_tpu_torch.serving.slots import SlotLoop
    gen, cap, eager = _slot_steps(cuda, kv, 768)
    T, L, row, base = 64, 130, 5, 300
    g = torch.Generator().manual_seed(7)
    snap = []
    for c in cap.cache:
        planes = []
        for p in c:
            shape = (1, p.shape[1], L, p.shape[3])
            if p.dtype == torch.int8:
                planes.append(torch.randint(-127, 128, shape, generator=g,
                                            dtype=torch.int8))
            else:
                planes.append(torch.rand(shape, generator=g).to(p.dtype))
        snap.append(tuple(planes))
    bases = [(j * T, base + j * T) for j in range(L // T)] \
        + [(L - T, base + L - T)]
    for lo, at in bases:
        gen.push_block(cap.cache, SlotLoop._host_block(snap, lo, lo + T),
                       row, at)
    got = gen.pull_row(cap.cache, row, base, L)
    for c, sc in zip(got, snap):
        for p, q in zip(c, sc):
            assert p.device.type == "cpu" and torch.equal(p, q)
    eager.load_state(cap)
    active = np.zeros(8, bool)
    active[row] = True
    start = np.full(8, base, np.int32)
    fin = np.zeros(8, bool)
    _, tok_c = cap(start, fin, active, base + L)
    _, tok_e = eager(start, fin, active, base + L)
    np.testing.assert_array_equal(tok_c, tok_e)
    _assert_same_state(cap, eager)
    again = gen.pull_row(cap.cache, row, base, L)
    assert all(torch.equal(p, q) for c, sc in zip(again, snap)
               for p, q in zip(c, sc))


@pytest.mark.parametrize("spec", [False, True])
def test_mid_generation_resume_writes_the_graph_inputs(cuda, spec):
    """A session row parked mid-generation and resumed: the resumed row's
    activation writes the snapshot's logits into the captured graph's
    own logits buffer (plain loop) or its next token into the step's
    packed input (speculative loop), so the first token after the
    replayed preseed is that logits' argmax (that token); the preseed
    replays exactly."""
    import threading
    from paddle_tpu_torch.framework.flags import flags_restore, \
        flags_snapshot, set_flags
    from paddle_tpu_torch.serving.sessions import SessionStore
    from paddle_tpu_torch.serving.slots import SlotLoop
    from paddle_tpu_torch.text.generation import Generator
    from paddle_tpu_torch.text.speculative import SpeculativeGenerator
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_kv_cache_dtype": "bf16"})
        if spec:
            target, draft = _spec_pair(cuda)
            gen = SpeculativeGenerator(target, draft, gamma=4,
                                       seq_buckets=(256,), max_len=256)
        else:
            gen = Generator(_slot_model(cuda), seq_buckets=(256,),
                            max_len=256)
        store = SessionStore()
        loop = SlotLoop(gen, 2, 256, 64, session_store=store)
    finally:
        flags_restore(snap)
    assert loop._step.captured
    step, reached = loop._decode_step, threading.Event()

    def held_step():
        step()
        if loop.counters["steps"] == 3:
            reached.set()
            while loop._park_req is None:
                threading.Event().wait(0.001)

    seen = {}
    activate = loop._activate

    def recording_activate():
        activate()
        i = 0
        if loop._slots[i].state == 2 and "row" not in seen:
            seen["row"] = loop._step.logits[i].clone() if not spec \
                else int(loop._cur[i])

    def recording_step():
        # the first replay after the activation: the packed input it read
        fresh = "row" in seen and "inp" not in seen
        step()
        if fresh:
            seen["inp"] = int(loop._step._inp_host[3 * loop.S])

    prompt = np.random.RandomState(0).randint(1, 512, 70)
    loop._decode_step = held_step
    try:
        fut = loop.submit(prompt, 40, session_id="s")
        assert reached.wait(120)
        assert loop.park_sessions(timeout=60) == 1
        with pytest.raises(Exception, match="parked"):
            fut.result(timeout=60)
        parked = store.take("s")
        n = len(parked.emitted)
        assert parked.remaining == 40 - n and n >= 3
        loop._decode_step = recording_step
        loop._activate = recording_activate
        got = loop.submit(prompt, 40, session_id="s",
                          snapshot=parked).result(timeout=120)
        assert loop.counters["restored"] == 1
        assert list(got[:n]) == parked.emitted
        if spec:
            assert seen["row"] == seen["inp"] == parked.cur == got[n]
        else:
            assert torch.equal(seen["row"].cpu(), parked.logits)
            assert int(parked.logits.argmax()) == int(got[n])
    finally:
        loop.close()


# -- the verify block: B3/B4's query-block form -------------------------------

def _block_ends(T, S, start, dev, seed):
    """Per-query ends [3, T] of a verify block: row 0 pos + t + 1 at pos
    = S - 2, the later ends past the cache's end (as at a ring's end);
    row 1 ends drawn at random (repeated, falling back); row 2 one end
    for every query, 3 columns past its start, so that all cluster ranks
    but one have an empty window."""
    rng = np.random.RandomState(seed)
    ends = np.stack([S - 1 + np.arange(T),
                     rng.randint(int(start[1]) + 1, S + 1, T),
                     np.full(T, int(start[2]) + 3)])
    return torch.from_numpy(ends.astype(np.int32)).to(dev)


@pytest.mark.parametrize("S", [256, 768])
@pytest.mark.parametrize("T", [1, 2, 5, 8, 12])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_block_form_equals_single_query_launches(cuda, kind, T, S):
    """Each query row of one block launch equals a one-query launch with
    its window, bit for bit, over ends that run past the cache's end, ends
    that repeat and fall back, and one end that leaves all ranks but one
    empty; and the block stays within the one-query limits of its plain
    version."""
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    B, N, H = 3, 4, 64
    rng = np.random.RandomState(S + T)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(cuda, dtype)
               for shape in ((B, N, T, H), (B, N, S, H), (B, N, S, H)))
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    start = torch.tensor([0, 37, S // 2], dtype=torch.int32, device=cuda)
    end = _block_ends(T, S, start.cpu().numpy(), cuda, S * T)
    if kind == "int8":
        fn = lambda qq, e: fd.flash_decode_quant_block(qq, k8, v8, ks, vs,
                                                       start, e)
        one = lambda qq, e: fd.flash_decode_quant(qq, k8, v8, ks, vs, start,
                                                  e)
        plain = fd.flash_decode_quant_plain(q.float(), k8, v8, ks, vs,
                                            start, end)
        counter = fd.flash_decode_quant_block
    else:
        fn = lambda qq, e: fd.flash_decode_block(qq, k, v, start, e)
        one = lambda qq, e: fd.flash_decode(qq, k, v, start, e)
        plain = fd.flash_decode_plain(q.float(), k.float(), v.float(),
                                      start, end)
        counter = fd.flash_decode_block
    n0 = counter.launches
    got = fn(q, end)
    assert counter.launches == n0 + 1
    assert got.shape == q.shape and got.dtype == dtype
    for t in range(T):
        ref = one(q[:, :, t:t + 1].contiguous(), end[:, t].contiguous())
        assert torch.equal(got[:, :, t:t + 1], ref), t
    atol = 1e-5 if kind == "f32" else 1e-2
    torch.testing.assert_close(got.float(), plain, atol=atol, rtol=0)


def test_block_form_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros(2, 2, 3, 64, device=cuda)
    k = torch.zeros(2, 2, 64, 64, device=cuda)
    start = torch.zeros(2, dtype=torch.int32, device=cuda)
    end = torch.ones(2, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="end must be"):
        fd.flash_decode_block(q, k, k, start, end[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode_block(q.transpose(1, 2).contiguous().transpose(1, 2),
                              k, k, start, end)
    with pytest.raises(ValueError, match="1, H"):
        fd.flash_decode(q, k, k, start, end[:, 0].contiguous())


# -- speculative decoding on the card -----------------------------------------

def _spec_pair(dev):
    """The 12-layer narrow target of the slot tests and a 4-layer draft,
    bf16."""
    from paddle_tpu_torch.text.models import GPTConfig, GPTModel
    draft = GPTModel(GPTConfig.tiny(vocab_size=512, hidden_size=128,
                                    layers=4, heads=2, seq=1024),
                     device=dev, dtype=torch.bfloat16)
    draft.init_weights(torch.Generator(device=dev).manual_seed(1))
    return _slot_model(dev), draft.eval()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_spec_decode_equals_greedy_at_the_same_cache(cuda, kv):
    """Speculative tokens equal greedy tokens at the same cache length,
    bit for bit (the verify block rounds as the step does), and a
    self-draft accepts every proposal."""
    from paddle_tpu_torch.framework.flags import flags_restore, \
        flags_snapshot, set_flags
    from paddle_tpu_torch.text.generation import Generator
    from paddle_tpu_torch.text.speculative import SpeculativeGenerator
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_kv_cache_dtype": kv})
        target, draft = _spec_pair(cuda)
        ids = np.random.RandomState(0).randint(1, 512, (4, 40))
        lens = np.array([40, 33, 7, 21])
        for d in (draft, target):
            spec = SpeculativeGenerator(target, d, gamma=4,
                                        seq_buckets=(64, 128), max_len=128)
            plain = Generator(target, seq_buckets=(64, 128), max_len=128)
            P = plain.prefill_bucket(40)
            C = spec.cache_bucket(P, 48)
            pids, st = plain.pack_prompts(
                [ids[b, :lens[b]] for b in range(4)], P)
            want = plain.decode(*plain.prefill(pids, st, C), st, P, 48)
            got = spec.decode(*spec.prefill(pids, st, C), st, P, 48)
            assert torch.equal(got, want)
            if d is target:
                assert spec.last_stats["acceptance_rate"] == 1.0
                assert spec.last_stats["spec_steps"] == -(-48 // 5)
    finally:
        flags_restore(snap)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_captured_spec_step_equals_eager_step(cuda, kv):
    """The captured speculative step against the same step run eagerly,
    from one state, the host rewriting its vectors between steps: both
    caches' planes, e, cur, finished, ncommit and n bit-equal; a replay
    runs no wrapper, and the graph holds 4 x 5 + 12 = 32 decode kernel
    nodes (the draft's 5 one-token forwards over 8 x 2 rows, one verify
    block over 8 x 2 x 5), which a device trace shows run."""
    from paddle_tpu_torch.framework.flags import flags_restore, \
        flags_snapshot, set_flags
    from paddle_tpu_torch.text.graphs import CapturedSpecSlotStep, \
        SpecSlotStep
    from paddle_tpu_torch.text.speculative import SpeculativeGenerator
    S, C = 8, 768
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_kv_cache_dtype": kv})
        target, draft = _spec_pair(cuda)
        gen = SpeculativeGenerator(target, draft, gamma=4,
                                   seq_buckets=(C,), max_len=C)
        cap = gen.step_exec(S, C)
        eager = SpecSlotStep(gen, S, C, -1)
    finally:
        flags_restore(snap)
    assert isinstance(cap, CapturedSpecSlotStep) and cap.captured
    g = torch.Generator(device=cuda).manual_seed(C)
    with torch.inference_mode():
        for p in cap.planes():
            if p.dtype == torch.int8:
                p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                                      device=cuda))
            elif p.shape[-1] == 1:
                p.copy_(torch.rand(p.shape, generator=g, device=cuda)
                        * 0.02 + 1e-3)
            else:
                p.copy_(torch.randn(p.shape, generator=g, device=cuda))
    eager.load_state(cap)
    rng = np.random.RandomState(1)
    cur = rng.randint(0, 512, S).astype(np.int32)
    fin = np.zeros(S, bool)
    pos = C - 60
    out_c = out_e = (cur, fin)
    for i in range(5):
        start = rng.randint(0, pos - 100, S).astype(np.int32)
        active = rng.rand(S) < 0.8
        mc = int(rng.randint(1, 6))
        n0, r0 = fd.launch_counts(), cap.replays
        rc = cap(start, out_c[1], active, out_c[0], pos, mc)
        assert fd.launch_counts() == n0 and cap.replays == r0 + 1
        re = eager(start, out_e[1], active, out_e[0], pos, mc)
        for a, b in zip(rc, re):
            np.testing.assert_array_equal(a, b)
        assert 1 <= rc[3] <= mc
        for x, y in zip(cap.planes(), eager.planes()):
            assert torch.equal(x, y)
        out_c, out_e = rc[:2], re[:2]
        pos += rc[3]
    assert kernel_node_grids(cap._graph, "decode_cluster_kernel") == \
        {8 * 2: 4 * 5, 8 * 2 * 5: 12}
    traced = _traced_decode_kernels(
        lambda: [cap(start, out_c[1], active, out_c[0], pos, 5)
                 for _ in range(3)])
    assert traced, traced


# -- B1 as a registered operator, and the dense serving path ------------------
#
# The flash-attention kernels are reached through torch.library operators
# (``paddle_tpu_torch::flash_attention_fwd``, ``_dq``, ``_dkv``), so that a
# ``torch.export`` program holds one operator node per attention call and a
# loaded, captured program still launches the hand-written kernel.

def _tiny_bert(dev, dtype, layers=2):
    """A BERT of ``layers`` layers at head_dim 64 (hidden 128, 2 heads),
    seeded, eval."""
    from paddle_tpu_torch.text.models import BertConfig
    from paddle_tpu_torch.text.models.bert import BertModel
    torch.manual_seed(0)
    m = BertModel(BertConfig.tiny(hidden_size=128, layers=layers, heads=2,
                                  seq=128), device=dev, dtype=dtype)
    return m.eval()


def _op_nodes(program, name):
    return [n for n in program.graph.nodes if n.op == "call_function"
            and name in str(n.target)]


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_op_equals_the_ctypes_launch(cuda, dtype, B):
    """The operator's CUDA implementation is the wrapper's launch: the same
    bits as calling the launch directly, at the served shape."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    rng = np.random.RandomState(B)
    q, k, v = (torch.from_numpy(rng.randn(B, 128, 12 * 64).astype(np.float32))
               .to(cuda, dtype).view(B, 128, 12, 64).transpose(1, 2)
               for _ in range(3))
    n0 = fa.flash_attention.launches_fwd
    o, lse = torch.ops.paddle_tpu_torch.flash_attention_fwd(
        q, k, v, None, False, 0.125)
    o2, lse2 = fa._launch_fwd(q, k, v, None, False, 0.125)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_fwd - n0 == 2
    assert o.stride() == o2.stride() and torch.equal(o, o2)
    assert torch.equal(lse, lse2)


def test_flash_attention_op_gradients_equal_the_direct_kernel_calls(cuda):
    """The training path is unchanged: gradients through the operator's
    registered autograd are the dQ and dK/dV kernels' bits, f32 and bf16."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, v, do), bias, causal = _fa_case("h128_pad_bias", cuda, dtype)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fa.flash_attention(*leaves, bias=bias, causal=causal).backward(do)
        o, lse = fa._launch_fwd(q, k, v, bias, causal, 1 / 128 ** 0.5)
        dd = fa.flash_dd(o, do)
        dq = fa.flash_bwd_dq(q, k, v, bias, lse, do, dd, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, bias, lse, do, dd, causal)
        torch.cuda.synchronize()
        for t, want in zip(leaves, (dq, dk, dv)):
            assert torch.equal(t.grad, want), dtype


def test_bert_export_holds_one_b1_operator_a_layer(cuda, tmp_path):
    """jit.save of a 12-layer bf16 BERT on the card: after the save/load
    round trip the program holds one flash-attention forward node a layer
    (12) and no SDPA or other attention call; the loaded program equals
    the eager module bit for bit."""
    from paddle_tpu_torch import jit
    m = _tiny_bert(cuda, torch.bfloat16, layers=12)
    jit.save(m, str(tmp_path / "b"), input_spec=[([None, 128], "int32")])
    tl = jit.load(str(tmp_path / "b"))
    assert len(_op_nodes(tl.program(), "flash_attention_fwd")) == 12
    assert not _op_nodes(tl.program(), "scaled_dot_product")
    assert not _op_nodes(tl.program(), "einsum")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (4, 128)).astype(np.int32)).to(cuda)
    with torch.no_grad():
        want = m(ids)
    for a, b in zip(tl(ids), want):
        assert torch.equal(a, b)


def test_captured_bucket_replay_equals_the_eager_loaded_program(cuda,
                                                                tmp_path):
    """Every bucket's captured graph of a 12-layer BERT holds 12 B1
    forward kernel nodes and no library attention node, and returns the
    eager loaded program's bits; the graphs and the workers' clones read
    the one parameter set of the loaded program; a replay runs no wrapper
    (the launch counts stay) and start() records one capture a bucket,
    none after."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    m = _tiny_bert(cuda, torch.bfloat16, layers=12)
    prefix = str(tmp_path / "bert")
    buckets = (1, 2, 4, 8, 16)
    man = serving.export_for_serving(m, prefix, [([None, 128], "int32")],
                                     buckets=buckets)
    assert man["mode"] in ("poly", "per_bucket")
    srv = serving.Server(serving.ServingConfig(workers=2))
    srv.register("bert", prefix, buckets=buckets)
    srv.start()
    try:
        rt = srv._models["bert"]
        assert [e["bucket"] for e in rt.events] == list(buckets)
        ptrs = [p.data_ptr() for p in rt.primary._translated._params]
        for w in srv._workers:
            for clone in w.clones["bert"].values():
                if man["mode"] == "poly":
                    assert [p.data_ptr() for p in
                            clone._translated._params] == ptrs
        rng = np.random.RandomState(1)
        for b in buckets:
            ex = rt.executables[b]
            assert ex.captured
            assert sum(kernel_node_grids(ex.graph, "fwd_tc_kernel")
                       .values()) == 12
            assert not [n for n, _ in graph_kernel_nodes(ex.graph)
                        if "fwd_tc_kernel" not in n and any(
                            w in n.lower() for w in ("flash", "fmha",
                                                     "attention", "sdpa"))]
            ids = rng.randint(0, 128, (b, 128)).astype(np.int32)
            n0, r0 = fa.flash_attention.launches_fwd, ex.replays
            got = ex.dispatch([ids]).fence()
            assert fa.flash_attention.launches_fwd == n0
            assert ex.replays == r0 + 1
            want = rt.predictors[b]._translated(torch.from_numpy(ids))
            for g, w_ in zip(got, want):
                assert np.array_equal(g, w_.float().cpu().numpy())
        out = srv.run("bert", [rng.randint(0, 128, (3, 128))])
        assert out[0].shape == (3, 128, 128) and out[1].shape == (3, 128)
        srv.assert_zero_steady_state_recompiles()
    finally:
        srv.stop()


def test_lenet_bucket_replay_equals_the_eager_loaded_program(cuda,
                                                             tmp_path):
    """bench_serving's lenet in bf16 (LeNet(), amp.decorate O2 behind the
    _BF16Serve layer): the bucket-16 captured graph returns the eager
    loaded program's bits; no kernel wrapper launched in the export, the
    captures or the replays (so no graph holds a hand-written kernel),
    and start() captures each bucket once, none after."""
    import paddle_tpu_torch as paddle
    from chip_smoke import _port_launches, bf16_serve
    from paddle_tpu_torch import serving
    paddle.seed(0)
    inner = paddle.vision.models.LeNet()
    assert all(p.device.type == "cuda" for p in inner.parameters())
    paddle.amp.decorate(models=inner, level="O2", dtype="bfloat16")
    prefix = str(tmp_path / "lenet")
    buckets = (1, 2, 4, 8, 16)
    _port_launches(reset=True)
    serving.export_for_serving(bf16_serve(inner), prefix,
                               [([None, 1, 28, 28], "float32")],
                               buckets=buckets)
    srv = serving.Server(serving.ServingConfig(workers=2))
    srv.register("lenet", prefix, buckets=buckets)
    srv.start()
    try:
        rt = srv._models["lenet"]
        assert [e["bucket"] for e in rt.events] == list(buckets)
        ex = rt.executables[16]
        assert ex.captured
        assert graph_kernel_nodes(ex.graph)
        x = np.random.RandomState(1).randn(16, 1, 28, 28).astype(np.float32)
        r0 = ex.replays
        got = ex.dispatch([x]).fence()
        assert ex.replays == r0 + 1
        want = rt.predictors[16]._translated(torch.from_numpy(x))
        assert got[0].dtype == np.float32 and got[0].shape == (16, 10)
        assert np.array_equal(got[0], want.cpu().numpy())
        out = srv.run("lenet", [x[:3]])
        assert out[0].shape == (3, 10)
        assert not any(_port_launches().values())
        srv.assert_zero_steady_state_recompiles()
    finally:
        srv.stop()


# -- int8 sites: i8 x i8 -> i32 products through cuBLASLt (torch._int_mm),
# padded to its rules (more than 16 rows, K and N multiples of 8) ----------

# (rows, K, N): LeNet's awkward sites at buckets 1 and 16 (the fc layers'
# rows; conv1's K = 9 and N = 6; conv2's K = 150; fc3's N = 10)
INT8_SHAPES = [(1, 400, 120), (16, 120, 84), (1, 84, 10), (16, 84, 10),
               (784, 9, 6), (12544, 9, 6), (100, 150, 16), (17, 16, 8)]


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_mm_equals_the_exact_product(cuda, m, k, n):
    """The int8 GEMM route on the card equals the int64 product on the
    CPU, bit for bit, at shapes cuBLASLt refuses unpadded."""
    from paddle_tpu_torch.ops import int8 as I8
    rng = np.random.RandomState(m * k + n)
    a = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (n, k)).astype(np.int8))
    got = I8.int8_mm(a.to(cuda), w.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu().long(), a.long() @ w.long().t())


def test_int8_conv_route_equals_the_exact_product(cuda):
    """conv2d_int8's im2col and GEMM on the card against the int64 conv
    of the same codes on the CPU (conv1 and conv2 of LeNet, a strided,
    padded and grouped conv), through the dequantize epilogue with unit
    scales, which is exact below 2^24."""
    from paddle_tpu_torch.ops import int8 as I8
    rng = np.random.RandomState(5)
    for (b, c, hw, o, kk, kw) in [
            (16, 1, 28, 6, 3, dict(padding=1)),
            (1, 6, 14, 16, 5, dict()),
            (2, 4, 9, 8, 3, dict(stride=(2, 2), padding=2, groups=2))]:
        g = kw.get("groups", 1)
        x = rng.randint(-127, 128, (b, c, hw, hw)).astype(np.float32)
        w = rng.randint(-127, 128, (o, c // g, kk, kk)).astype(np.int8)
        got = I8.conv2d_int8(torch.from_numpy(x).to(cuda),
                             torch.from_numpy(w).to(cuda),
                             torch.tensor(127.0, device=cuda),
                             torch.full((o,), 127.0, device=cuda),
                             stride=kw.get("stride", (1, 1)),
                             padding=kw.get("padding", 0), groups=g)
        want = torch.nn.functional.conv2d(
            torch.from_numpy(x).double(), torch.from_numpy(w).double(),
            stride=kw.get("stride", 1), padding=kw.get("padding", 0),
            groups=g)
        assert torch.equal(got.cpu().double(), want), (b, c, hw, o, kk)


def test_int8_lenet_bucket_replay_equals_the_eager_frozen_model(cuda,
                                                                tmp_path):
    """bench_serving's lenet_int8 (LeNet(), PTQ over 4 batches of one
    bucket-1 input, FLAGS_use_int8_inference, export_for_serving(int8=
    True)): the program holds one aten._int_mm node per site (5) and no
    float product; each bucket's captured graph returns the eager frozen
    model's bits; the graphs and the workers' clones read one set of the
    loaded int8 buffers; no kernel wrapper launched and no capture after
    warm-up."""
    import paddle_tpu_torch as paddle
    from chip_smoke import FLOAT_PRODUCTS, _port_launches
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.framework.flags import (flags_restore,
                                                  flags_snapshot, set_flags)
    from paddle_tpu_torch.quantization import PostTrainingQuantization
    paddle.seed(0)
    m = paddle.vision.models.LeNet()
    cal = torch.from_numpy(np.random.RandomState(0).randn(1, 1, 28, 28)
                           .astype(np.float32)).to(cuda)
    PostTrainingQuantization(model=m, data_loader=((cal,) for _ in
                                                   range(4))).quantize()
    prefix = str(tmp_path / "lenet")
    buckets = (1, 2, 4, 8, 16)
    snap = flags_snapshot()
    set_flags({"FLAGS_use_int8_inference": True})
    _port_launches(reset=True)
    try:
        man = serving.export_for_serving(
            m, prefix, [([None, 1, 28, 28], "float32")], buckets=buckets,
            int8=True)
        assert man["int8"] and man["mode"] == "poly"
        srv = serving.Server(serving.ServingConfig(workers=2))
        srv.register("lenet", prefix, buckets=buckets)
        srv.start()
        try:
            rt = srv._models["lenet"]
            assert rt.primary.quant_info()["sites"] == 5
            nodes = [str(n.target) for n in rt.primary._translated.program()
                     .graph.nodes if n.op == "call_function"]
            assert sum("_int_mm" in n for n in nodes) == 5
            assert not [n for n in nodes if FLOAT_PRODUCTS.search(n)]
            ptrs = [p.data_ptr() for p in rt.primary._translated._params]
            assert any(p.dtype == torch.int8
                       for p in rt.primary._translated._params)
            for w in srv._workers:
                for clone in w.clones["lenet"].values():
                    assert [p.data_ptr() for p in
                            clone._translated._params] == ptrs
            rng = np.random.RandomState(1)
            for b in buckets:
                ex = rt.executables[b]
                assert ex.captured and graph_kernel_nodes(ex.graph)
                x = rng.randn(b, 1, 28, 28).astype(np.float32)
                got = ex.dispatch([x]).fence()
                with torch.no_grad():
                    want = m(torch.from_numpy(x).to(cuda))
                assert np.array_equal(got[0], want.cpu().numpy())
            assert srv.run("lenet", [x[:3]])[0].shape == (3, 10)
            assert not any(_port_launches().values())
            srv.assert_zero_steady_state_recompiles()
        finally:
            srv.stop()
    finally:
        flags_restore(snap)


# -- Wide&Deep on the card (no hand-written kernel: its step is gathers,
# GEMMs, the loss, Adam and scatters) ----------------------------------------

def _wide_deep(cuda, seed=17, **kw):
    from paddle_tpu_torch.rec.wide_deep import WideDeep, WideDeepTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(seed)
    m = WideDeep(hidden=(32,), emb_dim=4, device=cuda)
    return m, WideDeepTrainer(m, feature_wire_dtype="float32", **kw)


def _ctr_batches(n=6, batch=128, vocab=50_000):
    from paddle_tpu_torch.rec.wide_deep import synthetic_ctr_batch
    return [synthetic_ctr_batch(batch, vocab=vocab, seed=s) for s in range(n)]


def _tables(m, batches):
    uniq = np.unique(np.concatenate([b[0].ravel() for b in batches]))
    return [m.client.pull_sparse(t, uniq) for t in (0, 1)]


def test_wide_deep_cache_mode_equals_pullpush_on_the_card(cuda):
    """Six f32-wire steps in cache mode (rows, rule and scatter on the
    card) and in pull/push mode (rule on the host table) from the same
    init: losses, dense parameters and flushed rows bit for bit (the
    device rule is the host rule's operations with IEEE square roots)."""
    out = []
    for cached in (True, False):
        m, t = _wide_deep(cuda, device_cache=cached)
        losses = [t.step(*b) for b in _ctr_batches()]
        t.flush()
        out.append((losses, _tables(m, _ctr_batches()),
                    {n: p.detach().cpu() for n, p in m.named_parameters()}))
    (la, ta, pa), (lb, tb, pb) = out
    assert la == lb
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(x, y)
    assert all(torch.equal(pa[n], pb[n]) for n in pa)


def test_wide_deep_captured_step_equals_eager_step(cuda):
    """in_graph_step_s's CUDA graph: one replay on the trainer's state
    equals one eager fused step on a clone of the same state, bit for bit
    (parameters, Adam moments, both arenas, the loss); capturing moves
    none of the trainer's own state."""
    from paddle_tpu_torch.rec.wide_deep import _clone_tree
    m, t = _wide_deep(cuda)
    batches = _ctr_batches(3)
    for b in batches[:2]:
        t.step(*b)
    before = _clone_tree(t._state())
    cap = t.capture_step(*batches[2])
    after = t._state()
    flat = lambda tree: [x for v in tree.values()  # noqa: E731
                         for x in (flat(v) if isinstance(v, dict) else [v])]
    # the capture's prep filled this batch's misses; nothing else moved
    assert all(torch.equal(a, b) for a, b in zip(flat(before["params"]),
                                                 flat(after["params"])))
    cap.load(after)
    cap.replay(1)
    eager = _clone_tree(after)
    for p in eager["params"].values():
        p.requires_grad_(True)
    loss = t._fused_cached(eager, *cap.args)
    assert torch.equal(cap.loss_sum, loss)
    assert all(torch.equal(a, b) for a, b in zip(flat(cap.state),
                                                 flat(eager)))
    assert t.in_graph_step_s(*batches[2]) > 0


def test_wide_deep_async_push_grads_equal_sync_push(cuda):
    """Async push copies each step's row gradients to pinned host memory
    behind an event and the drain thread pushes them: with a flush after
    every step, the pushed gradients, tables, losses and dense parameters
    equal sync push's bit for bit."""
    out = []
    for kw in (dict(async_push=True), dict(device_cache=False)):
        m, t = _wide_deep(cuda, **kw)
        pushed, real = [], m.client.push_sparse

        def spy(tid, ids, grads, real=real, pushed=pushed):
            pushed.append((tid, np.array(ids), np.array(grads)))
            return real(tid, ids, grads)

        m.client.push_sparse = spy
        losses = []
        for b in _ctr_batches(4):
            losses.append(t.step(*b))
            t.flush()
        t.close()
        out.append((losses, pushed, _tables(m, _ctr_batches(4)),
                    [p.detach().cpu() for p in m.parameters()]))
    (la, pa, ta, wa), (lb, pb, tb, wb) = out
    assert la == lb and len(pa) == len(pb) == 8
    for (i, ia, ga), (j, ib, gb) in zip(pa, pb):
        assert i == j
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ga, gb)
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(wa, wb))


# -- the static graph: one captured CUDA graph per program and feed signature

@contextlib.contextmanager
def _static_program():
    """Static mode with a fresh Scope and Program pair, all restored."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.scope_guard(static.Scope()), \
                static.program_guard(main, startup):
            yield paddle, static, main, startup
    finally:
        paddle.disable_static()


def _static_lenet(paddle, static, lr=0.01):
    img = static.data("img", [None, 1, 28, 28], "float32")
    label = static.data("label", [None], "int64")
    h = static.nn.conv2d(img, 6, 5, padding=2, act="relu")
    h = paddle.nn.functional.max_pool2d(h, 2, 2)
    h = static.nn.conv2d(h, 16, 5, act="relu")
    h = paddle.nn.functional.max_pool2d(h, 2, 2)
    h = paddle.flatten(h, start_axis=1)
    h = static.nn.fc(h, 120, activation="relu")
    h = static.nn.fc(h, 84, activation="relu")
    loss = paddle.nn.functional.cross_entropy(static.nn.fc(h, 10), label)
    paddle.optimizer.SGD(learning_rate=lr).minimize(loss)
    return loss


def _lenet_feed(seed, batch=32):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (batch,)).astype("int64")}


def test_static_captured_run_equals_eager_run(cuda):
    """Five runs of LeNet from two copies of one scope, captured (one
    capture, four replays) and eager: every loss and persistable bit for
    bit."""
    with _static_program() as (paddle, static, main, startup):
        loss = _static_lenet(paddle, static)
        exe = static.Executor()
        exe.run(startup)
        names = [v.name for v in main.list_vars() if v.persistable]
        other = static.Scope()
        for n in names:
            other.set_var(n, static.global_scope().find_var(n).clone())
        feeds = [_lenet_feed(k) for k in range(5)]
        a = [exe.run(main, feed=f, fetch_list=[loss])[0] for f in feeds]
        b = [exe.run(main, feed=f, fetch_list=[loss], scope=other,
                     use_program_cache=False)[0] for f in feeds]
        assert len(exe.compile_events) == 1
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        for n in names:
            assert torch.equal(static.global_scope().find_var(n),
                               other.find_var(n)), n


def test_static_steady_state_makes_no_capture(cuda):
    """Runs and train_from_dataset of one key replay one graph; a new
    program version recaptures once, on its second run."""
    from paddle_tpu_torch.profiler.cuda_graph import graph_kernel_nodes
    with _static_program() as (paddle, static, main, startup):
        loss = _static_lenet(paddle, static)
        exe = static.Executor()
        exe.run(startup)
        for k in range(2):
            exe.run(main, feed=_lenet_feed(k), fetch_list=[loss])
        exe.mark_warmup()
        for k in range(3):
            exe.run(main, feed=_lenet_feed(k), fetch_list=[loss])
        stacks = {n: np.stack([_lenet_feed(k)[n] for k in range(5)])
                  for n in ("img", "label")}
        out = exe.train_from_dataset(main, dataset=stacks,
                                     fetch_list=[loss], chunk_steps=2)
        assert out[loss.name].shape == (5,)
        assert exe.compile_events_since_warmup() == []
        graphs = exe.captured_graphs(main)
        assert len(graphs) == 1 and len(graph_kernel_nodes(graphs[0])) > 20
        main._version += 1
        exe.run(main, feed=_lenet_feed(0), fetch_list=[loss])
        assert exe.compile_events_since_warmup() == []
        exe.run(main, feed=_lenet_feed(1), fetch_list=[loss])
        assert len(exe.compile_events_since_warmup()) == 1


def test_static_program_with_a_random_op_is_not_captured(cuda):
    from paddle_tpu_torch.framework.enforce import UnimplementedError
    with _static_program() as (paddle, static, main, startup):
        x = static.data("x", [None, 8], "float32")
        y = paddle.nn.functional.dropout(static.nn.fc(x, 4), p=0.5)
        exe = static.Executor()
        exe.run(startup)
        feed = {"x": np.ones((2, 8), "float32")}
        with pytest.raises(UnimplementedError, match="A13"):
            exe.run(main, feed=feed, fetch_list=[y])
        out = exe.run(main, feed=feed, fetch_list=[y],
                      use_program_cache=False)[0]
        assert out.shape == (2, 4) and exe.compile_events == []


def _static_lenet_model(tmp_path, steps=2):
    """LeNet trained ``steps`` SGD steps, its test clone (taken before
    ``minimize``) saved as a static inference model in ``tmp_path``.
    Returns (executor, test clone, logits, scope)."""
    with _static_program() as (paddle, static, main, startup):
        img = static.data("img", [None, 1, 28, 28], "float32")
        label = static.data("label", [None], "int64")
        h = static.nn.conv2d(img, 6, 5, padding=2, act="relu")
        h = paddle.nn.functional.max_pool2d(h, 2, 2)
        h = static.nn.conv2d(h, 16, 5, act="relu")
        h = paddle.nn.functional.max_pool2d(h, 2, 2)
        h = paddle.flatten(h, start_axis=1)
        h = static.nn.fc(h, 84, activation="relu")
        logits = static.nn.fc(h, 10)
        loss = paddle.nn.functional.cross_entropy(logits, label)
        test = main.clone(for_test=True)
        paddle.optimizer.SGD(learning_rate=0.01).minimize(loss)
        exe = static.Executor()
        exe.run(startup)
        for k in range(steps):
            exe.run(main, feed=_lenet_feed(k), fetch_list=[loss])
        static.save_inference_model(str(tmp_path), ["img"], [logits], exe,
                                    main_program=test)
        return exe, test, logits, static.global_scope()


def test_static_predictor_equals_executor_run(cuda, tmp_path):
    """The static Predictor of a saved LeNet on the card (its own scope)
    against Executor.run of the test clone: three runs at each batch
    (eager, capture, replay) on both sides, bit for bit."""
    from paddle_tpu_torch import inference
    exe, test, logits, scope = _static_lenet_model(tmp_path)
    pred = inference.create_predictor(inference.Config(str(tmp_path)))
    assert pred._exe.device.type == "cuda" and pred._scope is not scope
    for b in (1, 8, 32):
        feed = _lenet_feed(100 + b, b)
        want = [exe.run(test, feed=feed, fetch_list=[logits], scope=scope)[0]
                for _ in range(3)]
        got = [pred.run([feed["img"]])[0] for _ in range(3)]
        for x in want[1:] + got:
            np.testing.assert_array_equal(x, want[0])
    assert len(pred._exe.compile_events) == 3


def test_static_server_two_workers_serves_every_row(cuda, tmp_path):
    """An executor-backed Server with 2 workers under 8 concurrent
    clients: every served row equals a second Predictor's on the same
    request padded to the bucket it rode, bit for bit (the workers'
    clones take turns on each bucket's graph), and no capture after the
    warm-up."""
    import threading

    from paddle_tpu_torch import inference, serving
    _static_lenet_model(tmp_path)
    srv = serving.Server(serving.ServingConfig(workers=2))
    srv.register("lenet", str(tmp_path), buckets=(1, 2, 4, 8),
                 input_specs=[([None, 1, 28, 28], "float32")])
    done, errors = [], []

    def client(i):
        rng = np.random.RandomState(i)
        mine = []
        try:
            for _ in range(25):
                x = rng.randn(int(rng.randint(1, 5)), 1, 28, 28).astype(
                    "float32")
                fut = srv.submit("lenet", [x])
                mine.append((x, fut.result(timeout=60)[0], fut.bucket))
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(repr(e))
        done.extend(mine)

    srv.start()
    try:
        assert srv.stats("lenet")["backend"] == "executor"
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        assert srv.compile_events_since_warmup() == []
        srv.assert_zero_steady_state_recompiles()
        assert srv.stats("lenet")["completed"] == len(done) == 200
    finally:
        srv.stop()
    ref = inference.create_predictor(inference.Config(str(tmp_path)))
    for x, got, bucket in done:
        xs = np.zeros((bucket, 1, 28, 28), np.float32)
        xs[:len(x)] = x
        np.testing.assert_array_equal(got, ref.run([xs])[0][:len(x)])


# -- GPT-MoE training (bench.py's moe workload) --------------------------------

@contextlib.contextmanager
def _no_tf32():
    """f32 means f32: the routed = dense-control identity needs exact f32
    products (x * 1 + sums of 0), which TF32's rounding of x breaks."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _gpt_moe(dev, dispatch="routed", layers=2, top_k=2, seed=0,
             moe_every=2):
    from paddle_tpu_torch.text.models import GPTMoEConfig, GPTMoEModel
    cfg = GPTMoEConfig.tiny(vocab_size=128, hidden_size=128, layers=layers,
                            heads=2, seq=64, experts=4, top_k=top_k,
                            capacity_factor=1.25, moe_every=moe_every)
    cfg.dropout = 0.0
    m = GPTMoEModel(cfg, dispatch=dispatch, device=dev)
    return m.init_weights(torch.Generator(device=dev).manual_seed(seed))


def test_embedding_gradient_repeats_bit_for_bit_on_the_card(cuda):
    """The port's lookup adds each id's gradient rows in one order: two
    backwards give the same bits (torch's own CUDA embedding backward
    does not), and equal torch's within rounding."""
    from paddle_tpu_torch.nn.functional.common import embedding
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 128, (32, 128))).to(cuda)
    w = torch.from_numpy(rng.randn(128, 512).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(32, 128, 512).astype(np.float32)) \
        .to(cuda)
    grads = []
    for _ in range(2):
        leaf = w.clone().requires_grad_()
        grads.append(torch.autograd.grad(embedding(ids, leaf), leaf, g)[0])
    assert torch.equal(grads[0], grads[1])
    leaf = w.clone().requires_grad_()
    want = torch.autograd.grad(torch.nn.functional.embedding(ids, leaf),
                               leaf, g)[0]
    torch.testing.assert_close(grads[0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_gpt_moe_routed_equals_dense_control_on_the_card(cuda, top_k):
    """2 TrainStep steps (AdamW) of a GPT-MoE and its dense-dispatch
    control from one seed, f32 with TF32 off, through B1/B2: losses and
    every parameter bit-equal; the kernels ran."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep, make_mesh
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (4, 64))).to(cuda)
    runs = []
    with _no_tf32():
        for dispatch in ("routed", "dense"):
            m = _gpt_moe(cuda, dispatch, top_k=top_k)
            step = TrainStep(m, AdamW(learning_rate=1e-3),
                             mesh=make_mesh({"ep": 1}))
            n0 = fa.flash_attention.launches_dkv
            losses = [step((ids, ids)).item() for _ in range(2)]
            runs.append((losses, dict(m.named_parameters()),
                         fa.flash_attention.launches_dkv - n0))
    (lr, pr, nr), (ld, pd, nd) = runs
    assert lr == ld and np.isfinite(lr).all()
    assert nr == nd == 2 * 2
    for n in pr:
        assert torch.equal(pr[n], pd[n]), n


def test_gpt_moe_forward_on_the_card_matches_the_cpu(cuda):
    """A one-layer GPTMoEModel (its block MoE) on the card, TF32 off,
    against the same weights on the CPU: the same experts for every
    token, logits within 1e-4 of max |logit| (f32 GEMMs in other orders
    and B1's split-TF32 forward, ~1e-6 a product)."""
    from paddle_tpu_torch.nn.layer.moe import moe_layers
    from paddle_tpu_torch.text.models import GPTMoEModel
    with _no_tf32():
        card = _gpt_moe(cuda, layers=1, moe_every=1)
        cpu = GPTMoEModel(card.config, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        ids = np.random.RandomState(1).randint(0, 128, (4, 64))
        probs, logits = {}, {}

        def keep_probs(name):
            def hook(mod, args, out):
                probs[name] = mod.gate(args[0]).float().softmax(-1).cpu()
            return hook
        for name, m in (("card", card), ("cpu", cpu)):
            h = moe_layers(m)[0].register_forward_hook(keep_probs(name))
            with torch.no_grad():
                logits[name] = m(torch.from_numpy(ids).to(
                    m.wte.weight.device)).cpu()
            h.remove()
    top = [probs[n].sort(dim=-1, descending=True, stable=True)[1][..., :2]
           for n in ("card", "cpu")]
    assert torch.equal(top[0], top[1])
    err = (logits["card"] - logits["cpu"]).abs().max() \
        / logits["cpu"].abs().max()
    assert err.item() <= 1e-4
