"""The port's beam search (ops/decode.py, ``generate(beam_size=)``) on the
CPU against the JAX package.

``beam_search_step`` (log-probs and probabilities, seeded inputs and
forced ties, finished beams), ``gather_tree`` and ``beam_parent_gather``
equal the JAX functions on the same numpy inputs; ``generate(beam_size=3)``
on bridged tiny GPT weights gives JAX's paths, and its scores within
1e-5 (the two packages' log_softmax round differently in the last bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import decode as jdecode
from paddle_tpu.text.generation import Generator as JaxGenerator
from torch_port_util import gpt_pair
from paddle_tpu_torch.framework.enforce import InvalidArgumentError
from paddle_tpu_torch.ops.decode import (beam_parent_gather,
                                         beam_search_step, gather_tree)
from paddle_tpu_torch.text.generation import Generator

V = 64
BUCKETS = dict(seq_buckets=(8, 16, 32), max_len=64)


def _step_inputs(seed, B, K, Vs, ties):
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, Vs, (B, K)).astype(np.int32)
    pre[0, 1] = 3                                   # a finished beam
    scores = rng.randn(B, K).astype(np.float32)
    logits = rng.randn(B, K, Vs).astype(np.float32)
    if ties:
        # equal candidates across and within beams: top-k order decides
        scores[:] = 0.0
        logits = np.round(logits, 0)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return pre, scores, logits, probs.astype(np.float32)


@pytest.mark.parametrize("accumulated", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_beam_search_step_matches_jax(accumulated, ties):
    B, K, Vs = 3, 4, 11
    pre, scores, logits, probs = _step_inputs(7 + ties, B, K, Vs, ties)
    x = np.log(probs) if accumulated else probs
    got = beam_search_step(torch.as_tensor(pre), torch.as_tensor(scores),
                           torch.as_tensor(x), beam_size=K, end_id=3,
                           is_accumulated=accumulated)
    want = jdecode._beam_search_step_fn(
        jnp.asarray(pre), jnp.asarray(scores), jnp.asarray(x), beam_size=K,
        end_id=3, is_accumulated=accumulated)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    # the finished beam proposes only the end token at its own score
    tok, sc, par = (t.numpy() for t in got)
    hit = (par[0] == 1)
    assert (tok[0][hit] == 3).all()


def test_gather_tree_and_parent_gather_match_jax():
    rng = np.random.RandomState(3)
    T, B, K = 6, 2, 3
    ids = rng.randint(0, 50, (T, B, K)).astype(np.int32)
    parents = rng.randint(0, K, (T, B, K)).astype(np.int32)
    np.testing.assert_array_equal(
        gather_tree(torch.as_tensor(ids), torch.as_tensor(parents)).numpy(),
        np.asarray(jdecode._gather_tree_fn(jnp.asarray(ids),
                                           jnp.asarray(parents))))
    x = rng.randn(B * K, 4, 5).astype(np.float32)
    par = parents[0]
    np.testing.assert_array_equal(
        beam_parent_gather(torch.as_tensor(x), torch.as_tensor(par)).numpy(),
        np.asarray(jdecode.beam_parent_gather(jnp.asarray(x),
                                              jnp.asarray(par))))


def test_generate_beam_matches_jax():
    jm, pm = gpt_pair(31, vocab_size=V, hidden_size=32, layers=2, heads=2,
                      seq=64)
    ids = np.random.RandomState(2).randint(2, V, (2, 6)).astype(np.int64)
    lens = np.array([6, 4])
    paths, scores = Generator(pm, device="cpu", **BUCKETS).generate(
        ids, lengths=lens, max_new_tokens=7, beam_size=3)
    jpaths, jscores = JaxGenerator(jm, **BUCKETS).generate(
        ids, lengths=lens, max_new_tokens=7, beam_size=3)
    assert tuple(paths.shape) == (2, 3, 7) and paths.dtype == torch.int32
    assert tuple(scores.shape) == (2, 3)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths.numpy()))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores.numpy()),
                               rtol=0, atol=1e-5)
    # the best beam leads, and beam 1's score follows
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()


def test_beam_scores_are_path_log_probs():
    """A path's score is the f32 sum of its tokens' log-probs: the paths
    fed back through the same cache length as B*K rows give the same
    number, bit for bit (the recomputation chip_smoke.py makes on the
    card)."""
    _, pm = gpt_pair(33, vocab_size=V, hidden_size=32, layers=2, heads=2,
                     seq=64)
    gen = Generator(pm, device="cpu", **BUCKETS)
    ids = np.random.RandomState(4).randint(2, V, (2, 5)).astype(np.int64)
    K, steps = 3, 6
    P = gen.prefill_bucket(5)
    C = gen.cache_bucket(P, steps)
    pids, start = gen.pack_prompts(list(ids), P)
    cache, logits0 = gen.prefill(pids, start, C)
    paths, scores = gen.decode(cache, logits0, start, P, steps,
                               beam_size=K)
    start_k = np.repeat(start, K)
    cache, logits = gen.prefill(np.repeat(pids, K, axis=0), start_k, C)
    fed = paths.reshape(-1, steps)
    total = torch.zeros(fed.shape[0])
    with torch.inference_mode():
        for t in range(steps):
            lp = torch.log_softmax(logits, dim=-1)
            total = total + lp.gather(1, fed[:, t:t + 1].long())[:, 0]
            nl, cache = pm.forward_cached(fed[:, t:t + 1], cache, P + t,
                                          torch.as_tensor(start_k))
            logits = nl[:, 0].float()
    assert torch.equal(total.reshape(2, K), scores)


def test_beam_validation():
    _, pm = gpt_pair(35, vocab_size=V, hidden_size=32, layers=2, heads=2,
                     seq=64)
    gen = Generator(pm, device="cpu", **BUCKETS)
    with pytest.raises(InvalidArgumentError, match="beam_size"):
        gen.generate(np.ones((1, 3), np.int64), max_new_tokens=2,
                     beam_size=0)
    # beam 1 is greedy decode
    np.testing.assert_array_equal(
        gen.generate(np.ones((1, 3), np.int64), max_new_tokens=4,
                     beam_size=1).numpy(),
        gen.generate(np.ones((1, 3), np.int64), max_new_tokens=4).numpy())
