"""Transformer layers of the PyTorch port against the JAX package:
``ring_block_write`` (including a block that wraps the ring),
``quantize_kv_rows`` / ``dequantize_kv_rows`` and one ring-cache
MultiHeadAttention step (prefill block, then a decode step), in f32 on
the CPU.  Tolerance of the MHA step: atol 1e-5 — the projections
are f32 matmuls whose summation order differs between XLA and torch
(a few 1e-7 per product at width 128)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.nn.layer import transformer as jtr
from torch_port_util import jax_params
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.nn.layer import transformer as ttr


@pytest.mark.parametrize("C,T,pos", [
    (16, 1, 5),      # the decode write
    (16, 1, 15),     # last column
    (16, 6, 0),      # the prefill fill
    (16, 3, 13),     # ends exactly at the boundary
    (16, 4, 14),     # wraps: columns 14, 15, 0, 1
    (16, 16, 9),     # a full ring, rotated
])
def test_ring_block_write_matches_jax(C, T, pos):
    rng = np.random.RandomState(C * 100 + T * 10 + pos)
    plane = rng.randn(2, 3, C, 8).astype(np.float32)
    new = rng.randn(2, 3, T, 8).astype(np.float32)
    want = np.asarray(jtr.ring_block_write(plane, new, pos))
    port_plane = torch.from_numpy(plane.copy())
    got = ttr.ring_block_write(port_plane, torch.from_numpy(new), pos)
    assert got.data_ptr() == port_plane.data_ptr()      # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_block_write_refuses_oversized_block():
    with pytest.raises(ValueError):
        ttr.ring_block_write(torch.zeros(1, 4, 8), torch.zeros(1, 5, 8), 0)


def test_quantize_kv_rows_matches_jax_and_rounds_half_to_even():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 5, 64).astype(np.float32)
    # a row whose max is 127 has scale 1: x/scale hits exact halves
    x[0, 0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    q, s = ttr.quantize_kv_rows(torch.from_numpy(x))
    jq, js = jtr.quantize_kv_rows(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.shape == (2, 3, 5, 1)
    assert q[0, 0, 0, :6].tolist() == [127, 0, 2, 2, 0, -4]
    np.testing.assert_array_equal(
        ttr.dequantize_kv_rows(q, s).numpy(),
        np.asarray(jtr.dequantize_kv_rows(jq, js)))


def _mask(start, row, C):
    """The additive validity mask GPTModel.forward_cached builds."""
    col = np.arange(C)
    valid = (col[None, None, None, :] <= row[None, None, :, None]) \
        & (col[None, None, None, :] >= start[:, None, None, None])
    return np.where(valid, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_ring_cache_attention_step_matches_jax(kv_dtype):
    E, N, B, C, T = 128, 2, 2, 16, 6
    paddle.seed(5)
    jm = jtr.MultiHeadAttention(E, N)
    jm.eval()
    tm = ttr.MultiHeadAttention(E, N, device="cpu")
    load_jax_state(tm, jax_params(jm))
    tm.eval()
    rng = np.random.RandomState(6)
    start = np.asarray([0, 4], np.int32)
    prefill = rng.randn(B, T, E).astype(np.float32)
    step = rng.randn(B, 1, E).astype(np.float32)
    jsnap = jflags.flags_snapshot()
    tsnap = tflags.flags_snapshot()
    try:
        jflags.set_flags({"FLAGS_kv_cache_dtype": kv_dtype})
        tflags.set_flags({"FLAGS_kv_cache_dtype": kv_dtype})
        jcache = jm.gen_ring_cache(B, C)
        tcache = tm.gen_ring_cache(B, C, device="cpu")
        assert type(tcache).__name__ == type(jcache).__name__
        with torch.inference_mode():
            for x, pos in ((prefill, 0), (step, T)):
                row = pos + np.arange(x.shape[1])
                mask = _mask(start, row, C)
                window = None
                if x.shape[1] == 1:
                    window = (start, np.full((B,), pos + 1, np.int32))
                jout, jcache = jm(
                    paddle.to_tensor(x), None, None, paddle.to_tensor(mask),
                    jcache, cache_position=pos,
                    decode_window=None if window is None else tuple(
                        paddle.to_tensor(w) for w in window))
                tout, tcache = tm(
                    torch.from_numpy(x), attn_mask=torch.from_numpy(mask),
                    cache=tcache, cache_position=pos,
                    decode_window=None if window is None else tuple(
                        torch.from_numpy(w) for w in window))
                np.testing.assert_allclose(tout.numpy(), jout.numpy(),
                                           atol=1e-5, rtol=0)
    finally:
        jflags.flags_restore(jsnap)
        tflags.flags_restore(tsnap)
    for tp, jp in zip(tcache, jcache):
        jp = np.asarray(jp.numpy())
        if kv_dtype == "int8" and jp.dtype == np.int8:
            # one int8 level of slack: a row value that lands within a
            # rounding of a half step may quantize to its neighbour
            assert np.abs(tp.numpy().astype(np.int32)
                          - jp.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(tp.numpy(), jp, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_decode_step_window_alone_equals_its_mask(kv_dtype):
    """A decode step passes only its [start, end) window (no dense mask);
    the plain path builds the mask from it, and gives exactly what the
    mask GPTModel.forward_cached builds for a multi-token block gives."""
    from paddle_tpu_torch.nn.functional.attention import cached_attention
    B, N, C, H = 3, 2, 40, 64
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(B, N, 1, H).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(B, N, C, H).astype(np.float32))
            for _ in range(2))
    start = np.asarray([0, 7, 29], np.int32)
    pos = 29
    window = (torch.from_numpy(start),
              torch.full((B,), pos + 1, dtype=torch.int32))
    mask = torch.from_numpy(_mask(start, np.asarray([pos]), C))
    scales = {}
    if kv_dtype == "int8":
        k, ks = ttr.quantize_kv_rows(k)
        v, vs = ttr.quantize_kv_rows(v)
        scales = dict(k_scale=ks, v_scale=vs)
    got = cached_attention(q, k, v, window=window, **scales)
    want = cached_attention(q, k, v, attn_mask=mask, **scales)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("lead", [(1, 1), (3, 1), (8, 1), (1, 32), (8, 32),
                                  (5, 40)])
def test_batch_invariant_linear_rows_do_not_depend_on_their_batch(lead):
    """Each output row of batch_invariant_linear equals, bit for bit, the
    row computed alone, whatever the batch and sequence shape around it
    (the serving path's GEMMs); and it is the same function as F.linear
    up to f32 summation order."""
    from paddle_tpu_torch.nn.functional import batch_invariant_linear
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(48, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(48).astype(np.float32))
    x = torch.from_numpy(rng.randn(*lead, 64).astype(np.float32))
    out = batch_invariant_linear(x, w, b)
    assert out.shape == (*lead, 48)
    flat, rows = out.reshape(-1, 48), x.reshape(-1, 64)
    for i in {0, rows.shape[0] // 2, rows.shape[0] - 1}:
        alone = batch_invariant_linear(rows[i:i + 1], w, b)
        assert torch.equal(flat[i:i + 1], alone), i
    torch.testing.assert_close(out, torch.nn.functional.linear(x, w, b),
                               rtol=1e-5, atol=1e-5)
