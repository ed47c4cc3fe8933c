"""GPT of the PyTorch port against the JAX package, on the CPU in f32.

The weights are drawn by the JAX model from a seed and carried across by
``load_jax_state``.  Tolerances: logits atol 1e-4 — the two frameworks
sum the f32 matmuls of 2 layers and a 128-wide tied head in different
orders; int8-KV logits atol 1e-3 — on top of that, a K/V value that
lands within a rounding of a half step quantizes to the neighbouring
int8 level on one side (1/127 of its row's max).  Greedy tokens must be
equal.  The model is ``GPTConfig.tiny(hidden_size=128, heads=2)``, the
width whose head_dim (64) the kernels take.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
from paddle_tpu.text.generation import Generator as JaxGenerator
from torch_port_util import KERNEL_TINY, gpt_pair, jax_params, prompts
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.framework.enforce import InvalidArgumentError
from paddle_tpu_torch.text.generation import Generator
from paddle_tpu_torch.text.models import GPTConfig, GPTModel

V = KERNEL_TINY["vocab_size"]
BUCKETS = dict(seq_buckets=(8, 16, 32), max_len=64)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(11, **KERNEL_TINY)


def test_bridge_key_set_and_round_trip(pair):
    jm, pm = pair
    params = jax_params(jm)
    sd = pm.state_dict()
    assert set(sd) == set(params)
    linear = {f"{n}.weight" for n, m in pm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    assert linear and all(".self_attn." in n or ".linear" in n
                          for n in linear)
    for name, want in params.items():
        got = sd[name].numpy()
        np.testing.assert_array_equal(got.T if name in linear else got,
                                      want)
    # the tied head reads the bridged embedding
    assert pm._lm_head.data_ptr() == pm.wte.weight.data_ptr()


def test_bridge_is_strict(pair):
    jm, _ = pair
    params = jax_params(jm)
    fresh = GPTModel(GPTConfig.tiny(**KERNEL_TINY), device="cpu")
    missing = dict(params)
    missing.pop("encoder.norm.bias")
    with pytest.raises(InvalidArgumentError, match="encoder.norm.bias"):
        load_jax_state(fresh, missing)
    with pytest.raises(InvalidArgumentError, match="extra"):
        load_jax_state(fresh, {**params, "extra.weight": np.zeros(3)})
    wrong = dict(params)
    wrong["wpe.weight"] = params["wpe.weight"][:-1]
    with pytest.raises(InvalidArgumentError, match="wpe.weight"):
        load_jax_state(fresh, wrong)


def test_forward_logits_match_jax(pair):
    jm, pm = pair
    ids = np.random.RandomState(1).randint(0, V, (2, 12)).astype(np.int64)
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.inference_mode():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _cached_logits(jm, pm, rows, steps=3):
    """Prefill left-padded rows, then ``steps`` single-token decode
    steps; returns [(port logits, jax logits)] for every call."""
    gen = Generator(pm, device="cpu", **BUCKETS)
    P = gen.prefill_bucket(max(len(r) for r in rows))
    C = gen.cache_bucket(P, steps)
    ids, start = gen.pack_prompts(rows, P)
    feed = np.random.RandomState(2).randint(0, V, (steps, len(rows), 1))
    out = []
    tcache = pm.init_cache(len(rows), C)
    jcache = jm.init_cache(len(rows), C)
    calls = [(ids, 0)] + [(feed[i].astype(np.int32), P + i)
                          for i in range(steps)]
    with torch.inference_mode():
        for x, pos in calls:
            tl, tcache = pm.forward_cached(torch.from_numpy(x), tcache, pos,
                                           torch.from_numpy(start))
            jl, jcache = jm.forward_cached(paddle.to_tensor(x), jcache, pos,
                                           paddle.to_tensor(start))
            out.append((tl.numpy(), np.asarray(jl.numpy())))
    return out


def test_forward_cached_prefill_and_decode_match_jax(pair):
    jm, pm = pair
    rows = prompts(3, (5, 11, 1), V)
    for got, want in _cached_logits(jm, pm, rows):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_forward_cached_int8_kv_matches_jax(pair):
    jm, pm = pair
    rows = prompts(4, (7, 16), V)
    jsnap, tsnap = jflags.flags_snapshot(), tflags.flags_snapshot()
    try:
        jflags.set_flags({"FLAGS_kv_cache_dtype": "int8"})
        tflags.set_flags({"FLAGS_kv_cache_dtype": "int8"})
        results = _cached_logits(jm, pm, rows)
    finally:
        jflags.flags_restore(jsnap)
        tflags.flags_restore(tsnap)
    for got, want in results:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_greedy_generate_tokens_match_jax(pair):
    jm, pm = pair
    rows = prompts(5, (3, 14, 9, 1), V)
    L = max(len(r) for r in rows)
    ids = np.zeros((len(rows), L), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    lens = np.asarray([len(r) for r in rows], np.int64)
    got = Generator(pm, device="cpu", **BUCKETS).generate(
        ids, lengths=lens, max_new_tokens=8)
    want = JaxGenerator(jm, **BUCKETS).generate(
        ids, lengths=lens, max_new_tokens=8).numpy()
    assert got.dtype == torch.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the model-level entry point runs the same decode
    np.testing.assert_array_equal(
        pm.generate(ids[1:2, :14], max_new_tokens=8).numpy(),
        np.asarray(want)[1:2])


def test_generate_with_eos_freezes_finished_rows(pair):
    jm, pm = pair
    rows = prompts(6, (4, 10), V)
    ids = np.zeros((2, 10), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    lens = np.asarray([4, 10], np.int64)
    free = Generator(pm, device="cpu", **BUCKETS).generate(
        ids, lengths=lens, max_new_tokens=6).numpy()
    eos = int(free[0, 2])
    got = Generator(pm, device="cpu", **BUCKETS).generate(
        ids, lengths=lens, max_new_tokens=6, eos_token_id=eos).numpy()
    want = JaxGenerator(jm, **BUCKETS).generate(
        ids, lengths=lens, max_new_tokens=6, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[0, 2:] == eos).all()
