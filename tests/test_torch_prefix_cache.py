"""The port's prefix KV cache (serving/prefix_cache.py) on the CPU.

The trie's bookkeeping follows the JAX package's
``test_prefix_trie_dedup_pin_and_lru_eviction`` step by step, on both
packages' caches side by side, and ends with the same stats.  Through
the slot loop, a prefix hit gives the tokens of the same loop with the
cache off (and of the JAX loop with its cache on), and counts its hit
tokens; eviction pressure keeps the tokens too.  A speculative loop
publishes and restores the planes of both caches: a self-draft keeps
accepting every proposal across prefix hits.
"""
import numpy as np
import pytest

from paddle_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from paddle_tpu.serving.slots import SlotLoop as JaxSlotLoop
from paddle_tpu.text.generation import Generator as JaxGenerator
from paddle_tpu.text.speculative import \
    SpeculativeGenerator as JaxSpeculativeGenerator
from torch_port_util import gpt_pair
from paddle_tpu_torch.serving.prefix_cache import PrefixCache
from paddle_tpu_torch.serving.slots import SlotLoop
from paddle_tpu_torch.text.generation import Generator
from paddle_tpu_torch.text.speculative import SpeculativeGenerator

V = 64
TINY = dict(vocab_size=V, hidden_size=32, layers=2, heads=2, seq=128)
S, C, T = 4, 128, 8


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(23, **TINY)


def test_prefix_trie_dedup_pin_and_lru_eviction():
    caches = [PrefixCache(block_tokens=4, block_nbytes=1 << 20,
                          hbm_budget_mb=3.0),            # budget: 3 blocks
              JaxPrefixCache(block_tokens=4, block_nbytes=1 << 20,
                             hbm_budget_mb=3.0)]
    stats = []
    for pc in caches:
        a = list(range(1, 9))                            # blocks A0, A1
        fetched = []

        def fetch_tag(tag):
            def _f(j):
                fetched.append((tag, j))
                return (tag, j)
            return _f

        assert pc.publish(a, fetch_tag("a")) == 2
        # same first block, different second: only ONE fetch runs
        b = a[:4] + [9, 9, 9, 9]
        assert pc.publish(b, fetch_tag("b")) == 1
        assert fetched == [("a", 0), ("a", 1), ("b", 1)]
        assert len(pc) == 3 and pc.nbytes() == 3 << 20

        blocks, pin = pc.lookup(a + [5], max_blocks=2)
        assert blocks == [("a", 0), ("a", 1)]
        st = pc.stats()
        assert st["hits"] == 1 and st["hit_tokens"] == 8

        # over-budget publish with the chain pinned: only the UNPINNED
        # leaf ("b", 1) may evict; the pinned chain survives
        pc.publish([7] * 8, fetch_tag("c"))
        assert pc.lookup(a, max_blocks=2)[0] == [("a", 0), ("a", 1)]
        pc.release(pc.lookup(a, max_blocks=2)[1])    # rebalance the pin
        assert pc.lookup(b)[0] == [("a", 0)]         # ("b", 1) evicted
        for _ in range(3):
            pc.release(pin)                          # idempotent-ish unpin
        assert pc.stats()["evictions"] >= 1
        # max_blocks clamp: a full-prompt lookup must leave a suffix token
        blocks, pin2 = pc.lookup(a, max_blocks=(len(a) - 1) // 4)
        assert len(blocks) == 1
        pc.release(pin2)
        assert pc.lookup([8] * 8)[0] == [] and pc.stats()["misses"] == 1
        stats.append(pc.stats())
        pc.clear()
        assert len(pc) == 0 and pc.stats()["blocks"] == 0
    port, jax_ = stats
    assert {k: port[k] for k in jax_} == jax_
    assert caches[0].stats()["evictions_clear"] == port["blocks"]


def _shared_prefix_prompts(seed, prefix_len=24, suffix_len=6, n=4):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, V, prefix_len)
    return [np.concatenate([prefix, rng.randint(1, V, suffix_len)])
            .astype(np.int32) for _ in range(n)]


def _serve(loop, prompts, max_new=3):
    """One seeding request publishes the shared prefix, then the rest run
    one at a time (each joins a loop whose prefix is cached)."""
    return [np.asarray(loop.submit(p, max_new).result(timeout=120))
            for p in prompts]


def test_prefix_hit_tokens_equal_cache_off_and_jax(pair):
    jm, pm = pair
    prompts = _shared_prefix_prompts(5)
    gen = Generator(pm, device="cpu", seq_buckets=(16,), max_len=C)
    pc = PrefixCache(T, gen.block_nbytes(T))
    on = SlotLoop(gen, S, C, T, prefix_cache=pc)
    off = SlotLoop(Generator(pm, device="cpu", seq_buckets=(16,),
                             max_len=C), S, C, T)
    jgen = JaxGenerator(jm, seq_buckets=(16,), max_len=C)
    jpc = JaxPrefixCache(T, 1)
    jon = JaxSlotLoop(jgen, S, C, T, prefix_cache=jpc)
    try:
        got, want, jgot = (_serve(lp, prompts) for lp in (on, off, jon))
        for a, b, c in zip(got, want, jgot):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        # 30-token prompts: 3 cached blocks of 8 per hit, 3 later requests
        assert on.counters["prefix_hit_tokens"] == 3 * 24
        assert on.counters["restore_pushes"] == 3 * 3
        assert on.counters["prefix_hit_tokens"] \
            == jon.counters["prefix_hit_tokens"]
        assert pc.stats()["hit_tokens"] == 72
        assert off.counters["prefix_hit_tokens"] == 0
        sig = on.signals()
        assert sig["prefix_cache_blocks"] == len(pc) > 0
        assert sig["prefix_cache_bytes"] == len(pc) * pc.block_nbytes
        # block bytes: every plane, one row x T columns
        assert pc.block_nbytes == 2 * 2 * (2 * T * 16 * 4)
    finally:
        for lp in (on, off, jon):
            lp.close()


def test_spec_prefix_hit_restores_both_caches(pair):
    """A self-draft speculative loop (gamma 2) with the prefix cache on:
    tokens equal the same loop with the cache off and the JAX
    speculative loop with its cache on, the hits are counted, and the
    draft accepts every proposal (a restore that missed the draft's
    planes would make it propose from stale rows)."""
    jm, pm = pair

    def spec():
        return SpeculativeGenerator(pm, pm, device="cpu", gamma=2,
                                    seq_buckets=(16,), max_len=C)

    prompts = _shared_prefix_prompts(7)
    gen = spec()
    # one block is both caches' planes, the draft's as wide as the target's
    assert gen.block_nbytes(T) == 2 * Generator(
        pm, device="cpu", seq_buckets=(16,), max_len=C).block_nbytes(T)
    pc = PrefixCache(T, gen.block_nbytes(T))
    on = SlotLoop(gen, S, C, T, prefix_cache=pc)
    off = SlotLoop(spec(), S, C, T)
    jon = JaxSlotLoop(JaxSpeculativeGenerator(jm, jm, gamma=2,
                                              seq_buckets=(16,), max_len=C),
                      S, C, T, prefix_cache=JaxPrefixCache(T, 1))
    try:
        got, want, jgot = (_serve(lp, prompts, max_new=6)
                           for lp in (on, off, jon))
        for a, b, c in zip(got, want, jgot):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert on.counters["prefix_hit_tokens"] == 3 * 24 \
            == jon.counters["prefix_hit_tokens"]
        st = on.stats()
        assert st["spec_proposed"] > 0
        assert st["spec_acceptance_rate"] == 1.0
        assert st["spec_accepted"] == off.stats()["spec_accepted"] \
            == jon.stats()["spec_accepted"]
    finally:
        for lp in (on, off, jon):
            lp.close()


def test_prefix_eviction_pressure_keeps_tokens(pair):
    _, pm = pair
    gen = Generator(pm, device="cpu", seq_buckets=(16,), max_len=C)
    nbytes = gen.block_nbytes(T)
    # a budget of two blocks against prompts of three cacheable blocks
    pc = PrefixCache(T, nbytes, hbm_budget_mb=2 * nbytes / (1 << 20))
    on = SlotLoop(gen, S, C, T, prefix_cache=pc)
    off = SlotLoop(Generator(pm, device="cpu", seq_buckets=(16,),
                             max_len=C), S, C, T)
    prompts = []
    for seed in (31, 32, 33):
        ps = _shared_prefix_prompts(seed, n=3)
        prompts += [ps[0], ps[1], ps[0][:20], ps[2]]
    try:
        got, want = (_serve(lp, prompts) for lp in (on, off))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        st = pc.stats()
        assert st["evictions"] > 0 and st["blocks"] <= 2
        assert on.counters["prefix_hit_tokens"] > 0
    finally:
        on.close()
        off.close()
