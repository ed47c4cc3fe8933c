"""Flash attention of the PyTorch port against the JAX package's Pallas
kernel, on the CPU in f32.

JAX runs ``flash_attention_fn`` in interpret mode (as
``tests/test_pallas_flash.py`` does) and its gradients through the
kernel's custom VJP; the port runs ``flash_attention`` on CPU tensors,
where the autograd function computes the kernels' plain versions.  The
cases are those of ``tests/test_pallas_flash.py`` at S = 128 (the TPU
kernel's smallest block) unless a case needs more.  Tolerances are JAX's
own: outputs atol 2e-5 / rtol 1e-5, gradients atol 5e-4 / rtol 1e-4 (f32
sums over up to 384 keys in other orders and block splits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional.attention import \
    scaled_dot_product_attention as jax_sdpa
from paddle_tpu.ops.pallas import flash_attention as fa_jax
from paddle_tpu.ops.pallas.flash_attention import (_flash_bwd_call,
                                                   _flash_fwd_call,
                                                   flash_attention_fn)
from paddle_tpu.ops.pallas.flash_attention import supports as jax_supports
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.nn.functional.attention import (
    attention_bnsh, scaled_dot_product_attention)
from paddle_tpu_torch.ops.kernels import flash_attention as fa

FWD = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=5e-4, rtol=1e-4)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _mask(seed, shape):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(*shape) < 0.2, -1e9, 0.0).astype(np.float32)


def _port(q, k, v, bias=None, causal=False, w=None):
    """Port output and, with weights ``w``, the grads of (out * w).sum()."""
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    b = None if bias is None else torch.from_numpy(bias)
    out = fa.flash_attention(*t, bias=b, causal=causal)
    if w is None:
        return out.detach().numpy(), None
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in t]


def _jax(q, k, v, bias=None, causal=False, w=None):
    f = lambda q, k, v: flash_attention_fn(
        q, k, v, None if bias is None else jnp.asarray(bias), causal=causal)
    out = np.asarray(f(q, k, v))
    if w is None:
        return out, None
    g = jax.grad(lambda *a: (f(*a) * w).sum(), argnums=(0, 1, 2))(q, k, v)
    return out, [np.asarray(x) for x in g]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H", [64, 128])
def test_forward_matches_jax_kernel(causal, H):
    q, k, v = _arrays(H + causal, *[(1, 2, 128, H)] * 3)
    np.testing.assert_allclose(_port(q, k, v, causal=causal)[0],
                               _jax(q, k, v, causal=causal)[0], **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_kernel(causal):
    q, k, v, w = _arrays(3, *[(1, 2, 128, 64)] * 4)
    o, g = _port(q, k, v, causal=causal, w=w)
    jo, jg = _jax(q, k, v, causal=causal, w=w)
    np.testing.assert_allclose(o, jo, **FWD)
    for name, a, b in zip("qkv", g, jg):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)


@pytest.mark.parametrize("mask_shape", [(2, 1, 1, 128), (2, 2, 128, 128),
                                        (1, 1, 128, 128)])
def test_bias_variants_match_jax_kernel(mask_shape):
    q, k, v = _arrays(4, *[(2, 2, 128, 64)] * 3)
    bias = _mask(5, mask_shape)
    np.testing.assert_allclose(_port(q, k, v, bias)[0],
                               _jax(q, k, v, bias)[0], **FWD)


def test_bias_grads_match_jax_kernel_and_bias_gets_none():
    q, k, v, w = _arrays(6, *[(1, 2, 128, 64)] * 4)
    bias = _arrays(7, (1, 2, 128, 128))[0]
    _, g = _port(q, k, v, bias, causal=True, w=w)
    _, jg = _jax(q, k, v, bias, causal=True, w=w)
    for name, a, b in zip("qkv", g, jg):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)
    tb = torch.from_numpy(bias).requires_grad_()
    fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                       bias=tb).sum().backward()
    assert tb.grad is None       # JAX returns zeros; the port no gradient


def test_cross_attention_lengths():
    q, k, v = _arrays(8, (1, 2, 128, 64), (1, 2, 384, 64), (1, 2, 384, 64))
    np.testing.assert_allclose(_port(q, k, v)[0], _jax(q, k, v)[0], **FWD)


def test_causal_cross_lengths_bottom_right_and_sq_gt_sk_raises():
    q, k, v, w = _arrays(9, (1, 2, 128, 64), (1, 2, 256, 64),
                         (1, 2, 256, 64), (1, 2, 128, 64))
    o, g = _port(q, k, v, causal=True, w=w)
    jo, jg = _jax(q, k, v, causal=True, w=w)
    np.testing.assert_allclose(o, jo, **FWD)
    for name, a, b in zip("qkv", g, jg):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD)
    with pytest.raises(ValueError):
        flash_attention_fn(k, q, q, causal=True)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fa.flash_attention(*(torch.from_numpy(x) for x in (k, q, q)),
                           causal=True)


@pytest.mark.parametrize("causal,bias_shape", [(False, (2, 1, 1, 128)),
                                               (True, (2, 2, 128, 128))])
def test_plain_versions_match_jax_calls_on_jax_lse(causal, bias_shape):
    """flash_fwd_reference against _flash_fwd_call (o and lse), and
    flash_bwd_reference against _flash_bwd_call fed the JAX lse."""
    B, N, S, H = 2, 2, 128, 64
    q, k, v, do = _arrays(10, *[(B, N, S, H)] * 4)
    bias = _arrays(11, bias_shape)[0]
    r3 = lambda x: jnp.asarray(x.reshape(B * N, S, H))
    scale = 1.0 / np.sqrt(H)
    jo, jlse = _flash_fwd_call(r3(q), r3(k), r3(v), jnp.asarray(bias), N,
                               scale, causal, 128, 128)
    jdq, jdk, jdv = _flash_bwd_call(r3(q), r3(k), r3(v), jnp.asarray(bias),
                                    jo, jlse, r3(do), N, scale, causal, 128,
                                    128)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    tb = torch.from_numpy(bias)
    o, lse = fa.flash_fwd_reference(*t[:3], tb, causal, scale)
    np.testing.assert_allclose(o.numpy().reshape(B * N, S, H),
                               np.asarray(jo), **FWD)
    jlse = np.asarray(jlse)[:, 0, :]                 # one of 8 sublanes
    np.testing.assert_allclose(lse.numpy().reshape(B * N, S), jlse, **FWD)
    grads = fa.flash_bwd_reference(
        *t[:3], tb, torch.from_numpy(np.array(jo).reshape(B, N, S, H)),
        torch.from_numpy(jlse.reshape(B, N, S)), t[3], causal, scale)
    for name, a, b in zip("qkv", grads, (jdq, jdk, jdv)):
        np.testing.assert_allclose(a.numpy().reshape(B * N, S, H),
                                   np.asarray(b), err_msg=f"d{name}", **GRAD)



# -- the f32 forward kernel's arithmetic: split TF32 ---------------------------

def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, at the 13th bit from the bottom of the f32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, split=True):
    """a @ b as the kernel's tensor-core products form it: each operand
    split into hi = tf32(x) and lo = tf32(x - hi), the three products
    lo hi + hi lo + hi hi summed in f32, the small terms first (lo lo is
    dropped); ``split`` False: one TF32 product, hi hi."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    return (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + ah @ bh


def _fwd_tf32(q, k, v, bias, causal, split=True):
    """The f32 forward kernel's algorithm on (B, N, S, H) CPU tensors:
    key tiles of 32, the scores' depth in chunks of 16 columns whose
    products are added in f32, an online softmax in f32 with the finite
    causal mask, each tile's P V added to the accumulator, o = acc / l."""
    B, N, Sq, H = q.shape
    Sk = k.shape[2]
    scale = 1.0 / np.sqrt(H)
    m = torch.full((B, N, Sq, 1), -np.inf)
    l = torch.zeros(B, N, Sq, 1)
    acc = torch.zeros(B, N, Sq, H)
    keep = torch.ones(Sq, Sk, dtype=torch.bool).tril(Sk - Sq)
    for k0 in range(0, Sk, 32):
        kt, vt = k[:, :, k0:k0 + 32], v[:, :, k0:k0 + 32]
        s = torch.zeros(B, N, Sq, kt.shape[2])
        for h0 in range(0, H, 16):
            s = s + _mm_tf32(q[..., h0:h0 + 16],
                             kt[..., h0:h0 + 16].transpose(-1, -2), split)
        s = s * scale
        if bias is not None:
            s = s + bias[..., k0:k0 + 32]
        if causal:
            s = s.masked_fill(~keep[:, k0:k0 + 32], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32(p, vt, split)
        m = m_new
    return acc / l


@pytest.mark.parametrize("H,causal", [(64, False), (128, True),
                                      (256, False)])
def test_split_tf32_forward_meets_the_f32_limit(H, causal):
    """The f32 forward kernel's split-TF32 arithmetic, emulated, against
    JAX's Pallas kernel (interpret mode) under a padding bias: within the
    kernel's f32 limit, 1e-5 of max(1, max|ref|), which one TF32 pass
    (~4e-4) misses.  On the card the tensor cores' adder truncates where
    this emulation rounds, which the kernel bounds by summing at most 16
    columns (scores) or 32 keys (P V) there; the card's kernel is held to
    the same limit in tests/test_torch_kernels_gpu.py."""
    B, N, S = 1, 2, 128
    q, k, v = _arrays(20 + H, *[(B, N, S, H)] * 3)
    bias = np.zeros((B, 1, 1, S), np.float32)
    bias[..., 100:] = -1e4
    want = _jax(q, k, v, bias, causal)[0]
    limit = 1e-5 * max(1.0, np.abs(want).max())
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    err = {split: np.abs(_fwd_tf32(*t, causal, split).numpy() - want).max()
           for split in (True, False)}
    assert err[True] <= limit, err
    assert err[False] > limit, err

def test_supports_gate_matches_jax():
    shapes = [((2, 4, 256, 64), (2, 4, 256, 64), None, False),
              ((2, 4, 200, 64), (2, 4, 256, 64), None, False),
              ((2, 4, 256, 80), (2, 4, 256, 80), None, False),
              ((2, 4, 256, 64), (2, 4, 256, 64), (2, 1, 1, 256), False),
              ((2, 4, 256, 64), (2, 4, 256, 64), (3, 1, 1, 256), False),
              ((2, 4, 128, 64), (2, 4, 256, 64), None, True),
              ((2, 4, 256, 64), (2, 4, 128, 64), None, True),
              ((2, 4, 128, 256), (2, 4, 128, 256), (1, 4, 128, 128), False)]
    for qs, ks, bs, causal in shapes:
        assert fa.supports(qs, ks, bs, causal=causal) == \
            jax_supports(qs, ks, bs, causal=causal), (qs, ks, bs, causal)


def test_sdpa_layout_and_cpu_dispatch_stay_plain():
    """scaled_dot_product_attention takes (B, S, N, H) as JAX's does; on
    CPU tensors the dispatch never reaches a kernel wrapper's launch."""
    q, k, v = _arrays(12, *[(2, 64, 2, 64)] * 3)
    mask = _mask(13, (2, 1, 1, 64))
    want = np.asarray(jax_sdpa(*(jnp.asarray(x) for x in (q, k, v)),
                               attn_mask=jnp.asarray(mask))._value)
    n0 = fa.flash_attention.launches_fwd
    snap = tflags.flags_snapshot()
    try:
        for on in (True, False):
            tflags.set_flags({"FLAGS_use_pallas_kernels": on})
            got = scaled_dot_product_attention(
                *(torch.from_numpy(x) for x in (q, k, v)),
                attn_mask=torch.from_numpy(mask))
            np.testing.assert_allclose(got.numpy(), want, **FWD)
    finally:
        tflags.flags_restore(snap)
    assert fa.flash_attention.launches_fwd == n0
    # the JAX Tensor wrapper and attention_bnsh agree on (B, N, S, H)
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    np.testing.assert_allclose(
        attention_bnsh(*t, attn_mask=torch.from_numpy(mask)).numpy(),
        np.asarray(fa_jax(*(jnp.asarray(x.numpy()) for x in t),
                          bias=jnp.asarray(mask))._value), **FWD)


def _views(dtype):
    """Named (B, N, S, H) = (2, 2, 8, 64) views of one buffer and whether
    the kernels read them in place (16-byte start and strides)."""
    B, N, S, H = 2, 2, 8, 64
    buf = torch.arange(B * S * (N * H + 8) + 8, dtype=torch.float32).to(dtype)
    bsnh = lambda w: w.view(B, S, N, H).transpose(1, 2)
    wide = buf[:B * S * (N * H + 8)].view(B, S, N * H + 8)
    flat = buf[:B * N * S * H]
    return {
        # the model's heads of a (B, S, N*H) projection: kept
        "bert_heads": (bsnh(buf[:B * S * N * H].view(B, S, N * H)), False),
        # a row stride of N*H + 8 elements: 16-byte multiple in both
        "padded_rows": (bsnh(wide[..., :N * H]), False),
        # a start 4 elements in: 16 bytes in f32, 8 in bf16
        "start_4": (bsnh(wide[..., 4:4 + N * H]), dtype == torch.bfloat16),
        # contiguous, but 2 elements into the buffer: never 16-byte aligned
        "contiguous_start_2": (buf[2:2 + B * N * S * H].view(B, N, S, H),
                               True),
        # head_dim strided
        "head_dim_strided": (flat.view(B, N, H, S).transpose(2, 3), True),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["bert_heads", "padded_rows", "start_4",
                                  "contiguous_start_2", "head_dim_strided"])
def test_strided_copies_what_the_kernels_cannot_read_and_keeps_the_rest(
        name, dtype):
    """The wrappers' layout rule: head_dim contiguous and the start and
    other strides multiples of 16 bytes (4 f32, 8 bf16: the tensor-core
    kernels copy 16-byte rows).  Anything else is copied into fresh,
    aligned memory (a contiguous tensor whose start is misaligned too,
    where ``contiguous()`` would hand the same memory back)."""
    t, copied = _views(dtype)[name]
    got = fa._strided(t, dtype, "q")
    assert (got is not t) == copied
    assert got.stride(-1) == 1 and got.data_ptr() % 16 == 0
    assert all(s % (16 // got.element_size()) == 0
               for s in got.stride()[:-1])
    assert torch.equal(got, t)
    if copied:
        assert got.is_contiguous() and got.data_ptr() != t.data_ptr()


def test_strided_raises_on_a_dtype_other_than_q():
    t, _ = _views(torch.float32)["bert_heads"]
    with pytest.raises(TypeError, match="dtype"):
        fa._strided(t, torch.bfloat16, "k")
