"""Flash decoding in the PyTorch port against the JAX package.

On the CPU the port's ``flash_decode`` / ``flash_decode_quant`` compute
their plain PyTorch versions; they are held against JAX's Pallas
kernels run in interpret mode (``flash_decode_fn``,
``flash_decode_quant_fn``) and against ``decode_attention_reference``.
The split block 128 gives the JAX kernel two splits at S=256, so the
windowed cases leave whole splits empty.  Tolerance: f32 atol 1e-6 —
both sides compute the same f32 softmax attention and differ only in
summation order (1.5e-7 measured at S=256).  The CUDA kernels
themselves run only on the card (tests/test_torch_kernels_gpu.py and
chip_smoke.py hold them against the same plain versions there);
tests/test_torch_flash_decode_order.py emulates their order of
arithmetic on the CPU.
"""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import torch_port_util  # noqa: F401  (TF32 off, thread count)
from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
from paddle_tpu_torch.ops.kernels import flash_decode as tfd

# the pallas package re-exports a function under the module's name
jfd = importlib.import_module("paddle_tpu.ops.pallas.flash_decode")
ATOL = 1e-6

# (B, N, S, H, start, end): None = the full cache
CASES = {
    "full": (2, 2, 256, 64, None, None),
    "windowed": (2, 2, 256, 64, [3, 100], [200, 256]),
    "empty_splits": (2, 2, 256, 64, [130, 0], [256, 40]),
    "single_column": (2, 2, 256, 64, [17, 0], [18, 256]),
    "h128": (1, 2, 256, 128, [5], [250]),
}


def _case(name, seed=0):
    B, N, S, H, start, end = CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32)
               for shape in ((B, N, 1, H), (B, N, S, H), (B, N, S, H)))
    lo = None if start is None else np.asarray(start, np.int32)
    hi = None if end is None else np.asarray(end, np.int32)
    return q, k, v, lo, hi


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(port, want, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_decode_matches_jax_kernel(name):
    q, k, v, lo, hi = _case(name)
    got = tfd.flash_decode(_t(q), _t(k), _t(v), _t(lo), _t(hi))
    assert got.shape == q.shape and got.dtype == torch.float32
    want = jfd.flash_decode_fn(_j(q), _j(k), _j(v), _j(lo), _j(hi),
                               block_k=128)
    _close(got, want)
    ref = jfd.decode_attention_reference(_j(q), _j(k), _j(v), _j(lo),
                                         _j(hi))
    _close(got, ref)
    _close(tfd.decode_attention_reference(_t(q), _t(k), _t(v), _t(lo),
                                          _t(hi)), ref)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_decode_quant_matches_jax_kernel(name):
    q, k, v, lo, hi = _case(name, seed=1)
    k8, ks = quantize_kv_rows(torch.from_numpy(k))
    v8, vs = quantize_kv_rows(torch.from_numpy(v))
    got = tfd.flash_decode_quant(_t(q), k8, v8, ks, vs, _t(lo), _t(hi))
    assert got.shape == q.shape and got.dtype == torch.float32
    jk8, jks, jv8, jvs = (jnp.asarray(t.numpy()) for t in (k8, ks, v8, vs))
    want = jfd.flash_decode_quant_fn(_j(q), jk8, jv8, jks, jvs, _j(lo),
                                     _j(hi), block_k=128)
    _close(got, want)
    ref = jfd.decode_attention_reference(
        _j(q), jfd.dequantize_kv(jk8, jks), jfd.dequantize_kv(jv8, jvs),
        _j(lo), _j(hi))
    _close(got, ref)
    np.testing.assert_array_equal(tfd.dequantize_kv(k8, ks).numpy(),
                                  np.asarray(jfd.dequantize_kv(jk8, jks)))


def test_row_without_valid_column_is_finite():
    """A row with no valid column at all: the finite -1e30 mask gives a
    uniform softmax (never NaN) in both plain versions.  (The kernels,
    JAX's split kernel and the port's cluster kernel, return 0 there
    instead; a decode step never has such a row, since its own column is
    always valid.)"""
    q, k, v, _, _ = _case("full")
    lo = np.asarray([10, 0], np.int32)
    hi = np.asarray([10, 256], np.int32)
    got = tfd.flash_decode(_t(q), _t(k), _t(v), _t(lo), _t(hi))
    assert torch.isfinite(got).all()
    ref = jfd.decode_attention_reference(_j(q), _j(k), _j(v), _j(lo),
                                         _j(hi))
    _close(got, ref)


def test_bf16_plain_version_casts_like_jax():
    """bf16 inputs: probabilities rounded to V's dtype before the PV
    product, output in q's dtype, as the JAX reference does.  atol 1e-2
    is one bf16 step at |out| < 2."""
    q, k, v, lo, hi = _case("windowed", seed=2)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tfd.flash_decode(tq, tk, tv, _t(lo), _t(hi))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref = jfd.decode_attention_reference(jq, jk, jv, _j(lo), _j(hi))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=1e-2,
                               rtol=0)


@pytest.mark.parametrize("q_shape,k_shape", [
    ((2, 4, 1, 64), (2, 4, 256, 64)),
    ((2, 4, 1, 128), (2, 4, 128, 128)),
    ((2, 4, 1, 256), (2, 4, 384, 256)),
    ((2, 4, 2, 64), (2, 4, 256, 64)),      # two query rows
    ((2, 4, 1, 16), (2, 4, 256, 16)),      # GPTConfig.tiny head_dim
    ((2, 4, 1, 64), (2, 4, 200, 64)),      # S not a multiple of 128
    ((2, 4, 1, 64), (3, 4, 256, 64)),      # batch mismatch
    ((2, 4, 1, 64), (2, 4, 256, 128)),     # head_dim mismatch
    ((4, 1, 64), (4, 256, 64)),            # rank 3
])
def test_shape_gate_matches_jax(q_shape, k_shape):
    assert tfd.supports_decode(q_shape, k_shape) \
        == jfd.supports_decode(q_shape, k_shape)


def test_cpu_calls_do_not_count_as_launches():
    q, k, v, lo, hi = _case("windowed")
    before = (tfd.flash_decode.launches, tfd.flash_decode_quant.launches)
    tfd.flash_decode(_t(q), _t(k), _t(v), _t(lo), _t(hi))
    k8, ks = quantize_kv_rows(torch.from_numpy(k))
    tfd.flash_decode_quant(_t(q), k8, k8, ks, ks, _t(lo), _t(hi))
    assert (tfd.flash_decode.launches,
            tfd.flash_decode_quant.launches) == before
