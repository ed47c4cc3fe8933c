"""The port's CUDA kernels on the card (flash-decode B3/B4,
flash-attention B1/B2, fused batch norm B5/B6, fused conv B7), against
their plain PyTorch versions on the same inputs.

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
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
from paddle_tpu_torch.ops.kernels import flash_decode as fd

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


@pytest.mark.parametrize("name", ["full", "s1024", "s201_off4"])
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
    B, N, Sq, Sk, H, causal, bshape = {**FA_CASES, **FA_TC_CASES}[name]
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    q, k, v = t(B, N, Sq, H), t(B, N, Sk, H), t(B, N, Sk, H)
    do = t(B, N, Sq, H)
    bias = None
    if bshape is not None:
        bias = torch.from_numpy(np.where(rng.rand(*bshape) < 0.2, -1e4,
                                         0.0).astype(np.float32)).to(dev)
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


@pytest.mark.parametrize("name", ["s200_h256_causal_pad_bias",
                                  "cross_causal_128x384_pad_bias",
                                  "h128_pad_bias", "s128_h64"])
def test_flash_attention_tensor_core_kernels_repeat_bit_for_bit(cuda, name):
    """One writer per output, fixed-order sums, no atomics: two launches
    on one input give the same bits."""
    (q, k, v, do), bias, causal = _fa_case(name, cuda, torch.bfloat16,
                                           seed=3)
    first, _ = _fa_run(q, k, v, do, bias, causal)
    again, _ = _fa_run(q, k, v, do, bias, causal)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


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
