"""The port's slot decode loop (serving/slots.py) on the CPU.

Randomized join/leave churn through the port's SlotLoop emits, token for
token, what the JAX package's SlotLoop emits on the same weights and what
the port's batch-1 ``generate()`` emits, with no step built after
warm-up; plus the int8-KV variant, the speculative loop (f32 and int8)
against the JAX speculative SlotLoop and generate(), eos retirement,
bounded-ring resets, the occupancy accounting, the constructor guards
(a speculative loop builds, a session store takes a parked turn), the
FLAGS surface, the slot-mode Server against the JAX one, the off path,
and the tensor
``cache_position`` of ``forward_cached`` against its int path, bit for
bit.  The trace and the wave submission follow
``tests/test_slot_decode.py``.
"""
import random

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.framework.flags import flags_restore as jflags_restore
from paddle_tpu.framework.flags import flags_snapshot as jflags_snapshot
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.serving.slots import SlotLoop as JaxSlotLoop
from paddle_tpu.text.generation import Generator as JaxGenerator
from paddle_tpu.text.speculative import \
    SpeculativeGenerator as JaxSpeculativeGenerator
from torch_port_util import gpt_pair
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.framework.enforce import (InvalidArgumentError,
                                                OutOfRangeError,
                                                PreconditionNotMetError)
from paddle_tpu_torch.framework.flags import (flags_restore, flags_snapshot,
                                              set_flags)
from paddle_tpu_torch.serving.sessions import SessionStore
from paddle_tpu_torch.serving.slots import SlotLoop
from paddle_tpu_torch.text.generation import Generator
from paddle_tpu_torch.text.speculative import SpeculativeGenerator

V = 64
TINY = dict(vocab_size=V, hidden_size=32, layers=2, heads=2, seq=64)
BUCKETS = dict(seq_buckets=(8, 16, 32), max_len=64)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(21, **TINY)


def _gen(pm):
    return Generator(pm, device="cpu", **BUCKETS)


def _trace(rng, n, max_lp=20, max_mn=10):
    """Mixed short/long prompts and generation lengths, so rows join and
    retire at staggered token boundaries (test_slot_decode.py)."""
    reqs = []
    for k in range(n):
        lp = rng.randint(max_lp // 2, max_lp) if k % 4 == 0 \
            else rng.randint(1, max(2, max_lp // 3))
        mn = max_mn if k % 3 == 1 else rng.randint(1, max(2, max_mn // 2))
        reqs.append(([rng.randrange(V) for _ in range(lp)], mn))
    return reqs


def _run_churn(loop, reqs, waves=3):
    """Submit in waves, later waves joining while earlier rows decode."""
    futs = []
    per = -(-len(reqs) // waves)
    for w in range(waves):
        futs += [loop.submit(p, mn)
                 for p, mn in reqs[w * per:(w + 1) * per]]
        futs[w * per].result(timeout=120)
    return [np.asarray(f.result(timeout=120)).reshape(-1) for f in futs]


def _run_queued(loop, reqs):
    """Queue the whole trace before the loop's thread admits any of it, so
    both loops run one schedule (rows still join as others retire) and their
    acceptance counters can be compared."""
    with loop._cond:
        futs = [loop.submit(p, mn) for p, mn in reqs]
    return [np.asarray(f.result(timeout=120)).reshape(-1) for f in futs]


def _generate(oracle, p, mn, eos=None):
    return oracle.generate(np.asarray([p], np.int32), max_new_tokens=mn,
                           eos_token_id=eos).numpy()[0]


def _assert_equal_generate(oracle, reqs, outs):
    for (p, mn), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _generate(oracle, p, mn))


def test_churn_matches_jax_slot_loop_and_generate(pair):
    jm, pm = pair
    gen = _gen(pm)
    loop = SlotLoop(gen, slots=4, cache_len=64, chunk=8)
    built = dict(gen.counters), len(gen._steps)
    jloop = JaxSlotLoop(JaxGenerator(jm, **BUCKETS), slots=4, cache_len=64,
                        chunk=8)
    oracle = _gen(pm)
    try:
        for trial in range(4):
            reqs = _trace(random.Random(500 + trial), 12)
            outs = _run_churn(loop, reqs)
            jouts = _run_churn(jloop, reqs)
            for got, want in zip(outs, jouts):
                np.testing.assert_array_equal(got, want)
            _assert_equal_generate(oracle, reqs, outs)
        # nothing was built (on the card: captured) after warm-up
        assert (dict(gen.counters), len(gen._steps)) == built
        assert gen.counters["steps_built"] == 1
        assert loop.counters["joined"] == loop.counters["retired"] == 48
        assert not loop._step.captured
    finally:
        loop.close()
        jloop.close()


def test_churn_int8_kv_matches_generate(pair):
    _, pm = pair
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_kv_cache_dtype": "int8"})
        gen = _gen(pm)
        loop = SlotLoop(gen, slots=4, cache_len=64, chunk=8)
        assert loop._cache[0].k.dtype == torch.int8
        try:
            reqs = _trace(random.Random(900), 10)
            outs = _run_churn(loop, reqs)
            _assert_equal_generate(_gen(pm), reqs, outs)
            assert gen.counters["steps_built"] == 1
        finally:
            loop.close()
    finally:
        flags_restore(snap)


def test_spec_churn_matches_jax_spec_loop_and_generate(pair):
    """The speculative slot loop (a bad draft, gamma 2), f32 then int8
    KV: the churn's tokens equal the JAX speculative SlotLoop's and the
    port's batch-1 generate(), with JAX's acceptance counters, and no
    step is built after warm-up.  (f32 and int8 in one test: the file
    stays at 12 tests, ROADMAP queue C.)"""
    jm, pm = pair
    jd, pd = gpt_pair(101, vocab_size=V, hidden_size=16, layers=1, heads=2,
                      seq=64)
    snap, jsnap = flags_snapshot(), jflags_snapshot()
    try:
        for kv, seed in (("bf16", 600), ("int8", 601)):
            set_flags({"FLAGS_kv_cache_dtype": kv})
            jset_flags({"FLAGS_kv_cache_dtype": kv})
            gen = SpeculativeGenerator(pm, pd, device="cpu", gamma=2,
                                       **BUCKETS)
            loop = SlotLoop(gen, slots=4, cache_len=64, chunk=8)
            jloop = JaxSlotLoop(JaxSpeculativeGenerator(
                jm, jd, gamma=2, **BUCKETS), slots=4, cache_len=64, chunk=8)
            try:
                assert loop._cache[0][0].k.dtype == (
                    torch.int8 if kv == "int8" else torch.float32)
                assert not loop._step.captured
                reqs = _trace(random.Random(seed), 12)
                outs, jouts = (_run_queued(lp, reqs) for lp in (loop, jloop))
                for got, want in zip(outs, jouts):
                    np.testing.assert_array_equal(got, want)
                _assert_equal_generate(_gen(pm), reqs, outs)
                st, jst = loop.stats(), jloop.stats()
                for k in ("spec_accepted", "spec_proposed",
                          "spec_acceptance_rate", "steps", "chunks"):
                    assert st[k] == jst[k], k
                assert gen.counters["steps_built"] == 1
            finally:
                loop.close()
                jloop.close()
    finally:
        flags_restore(snap)
        jflags_restore(jsnap)


def test_eos_early_retirement_pads_with_eos(pair):
    _, pm = pair
    oracle = _gen(pm)
    prompt = [5, 9, 2]
    eos = int(_generate(oracle, prompt, 8)[2])     # the 3rd greedy token
    loop = SlotLoop(_gen(pm), slots=2, cache_len=64, chunk=8,
                    eos_token_id=eos)
    try:
        got = np.asarray(loop.submit(prompt, 8).result(timeout=120))
        want = _generate(oracle, prompt, 8, eos=eos)
        np.testing.assert_array_equal(got, want)
        assert (got[2:] == eos).all()
        assert loop.counters["steps"] == 3          # retired at eos
    finally:
        loop.close()


def test_bounded_ring_session_reset_and_rejection(pair):
    _, pm = pair
    loop = SlotLoop(_gen(pm), slots=2, cache_len=32, chunk=8)
    try:
        # a prompt + continuation that can NEVER fit C=32 fails at submit
        with pytest.raises(OutOfRangeError):
            loop.submit(list(range(1, 25)), 12)
        # enough sequential traffic to exhaust the ring at least once
        rng = random.Random(11)
        reqs = [([rng.randrange(V) for _ in range(6)], 6)
                for _ in range(8)]
        outs = [np.asarray(loop.submit(p, mn).result(timeout=120))
                for p, mn in reqs]
        _assert_equal_generate(_gen(pm), reqs, outs)
        assert loop.counters["session_resets"] >= 1
    finally:
        loop.close()


def test_occupancy_signals_and_counters(pair):
    _, pm = pair
    loop = SlotLoop(_gen(pm), slots=4, cache_len=64, chunk=8,
                    model="sigtest")
    try:
        futs = [loop.submit([3, 1, 4, 1, 5], 6) for _ in range(6)]
        for f in futs:
            f.result(timeout=120)
        sig = loop.signals()
        assert sig["slots_joined_total"] == 6
        assert sig["slots_retired_total"] == 6
        assert 0.0 < sig["decode_slot_occupancy_ratio"] <= 1.0
        assert sig["slot_steps_total"] > 0 and sig["slot_pending"] == 0
        st = loop.stats()
        assert st["ttft_p50_ms"] > 0 and st["ttft_p99_ms"] > 0
        assert st["emitted_tokens"] == 36 and st["chunks"] == 6
        loop.reset_stats()
        st = loop.stats()
        assert st["joined"] == st["steps"] == 0 and "ttft_p50_ms" not in st
    finally:
        loop.close()


def test_slot_loop_constructor_guards(pair):
    _, pm = pair
    gen = _gen(pm)
    with pytest.raises(InvalidArgumentError):
        SlotLoop(gen, slots=0, cache_len=64, chunk=8)
    # a session store is accepted, and a turn with a session id parks
    # its transcript and KV columns into it
    store = SessionStore()
    parking = SlotLoop(gen, slots=2, cache_len=64, chunk=8,
                       session_store=store)
    try:
        prompt = list(range(1, 11))
        got = parking.submit(prompt, 3, session_id="conv-1") \
            .result(timeout=60)
        np.testing.assert_array_equal(got, _generate(_gen(pm), prompt, 3))
        snap = store.take("conv-1")
        assert snap.tokens == prompt + [int(t) for t in got]
        assert snap.remaining == 0 and snap.planes[0].k.shape == (
            1, 2, 13, 16)
        assert parking.counters["parked"] == 1
        # the snapshot is a copy: serving on over its row changes nothing
        kept = [p.clone() for c in snap.planes for p in c]
        parking.submit(list(range(20, 40)), 5).result(timeout=60)
        assert all(torch.equal(p, q) for p, q in
                   zip(kept, [p for c in snap.planes for p in c]))
    finally:
        parking.close()

    # a speculative generator builds its loop (the speculative step)
    spec = SlotLoop(SpeculativeGenerator(pm, pm, device="cpu", gamma=2,
                                         **BUCKETS), slots=2, cache_len=64,
                    chunk=8)
    try:
        assert spec._spec and spec._gamma == 2
        got = spec.submit([1, 2], 5).result(timeout=60)
        np.testing.assert_array_equal(got, _generate(_gen(pm), [1, 2], 5))
        assert spec.stats()["spec_acceptance_rate"] == 1.0   # self-draft
    finally:
        spec.close()
    loop = SlotLoop(gen, slots=2, cache_len=64, chunk=8)
    try:
        with pytest.raises(InvalidArgumentError):
            loop.submit([], 4)              # empty prompt
        with pytest.raises(InvalidArgumentError):
            loop.submit([1, 2], 0)          # max_new < 1
        # a session id is accepted and ignored
        got = loop.submit([1, 2], 3, session_id="conv-1").result(timeout=60)
        np.testing.assert_array_equal(got, _generate(_gen(pm), [1, 2], 3))
        # the step (and its planes) is the loop's until it closes
        with pytest.raises(PreconditionNotMetError, match="another slot"):
            SlotLoop(gen, slots=2, cache_len=64, chunk=8)
    finally:
        loop.close()
    again = SlotLoop(gen, slots=2, cache_len=64, chunk=8)
    try:
        assert again._step is loop._step
        got = again.submit([1, 2], 3).result(timeout=60)
        np.testing.assert_array_equal(got, _generate(_gen(pm), [1, 2], 3))
    finally:
        again.close()


def test_flags_validation_and_snapshot_restore():
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_decode_slots": 8, "FLAGS_prefill_chunk": 32,
                   "FLAGS_prefix_cache": True,
                   "FLAGS_prefix_cache_hbm_mb": 0.5})
        assert _flags.flag("decode_slots") == 8
        assert _flags.flag("prefill_chunk") == 32
        assert _flags.flag("prefix_cache") is True
        for bad in ({"FLAGS_decode_slots": -1}, {"FLAGS_decode_slots": 257},
                    {"FLAGS_prefill_chunk": 0},
                    {"FLAGS_prefill_chunk": 4097},
                    {"FLAGS_prefix_cache_hbm_mb": -1.0}):
            with pytest.raises(ValueError):
                set_flags(bad)
        # failed sets never clobber the last valid values
        assert _flags.flag("decode_slots") == 8
        assert _flags.flag("prefill_chunk") == 32
        assert _flags.flag("prefix_cache_hbm_mb") == 0.5
    finally:
        flags_restore(snap)
    # the JAX package's defaults
    jsnap = jflags_snapshot()
    for name in ("decode_slots", "prefill_chunk", "prefix_cache",
                 "prefix_cache_hbm_mb"):
        assert _flags._REGISTRY[name].default == jsnap[name], name


def test_server_slot_mode_matches_jax_server(pair):
    """FLAGS_decode_slots swaps the run-to-completion path for the slot
    loop behind the same submit surface: served tokens equal the JAX
    slot-mode Server's and batch-1 generate()'s, and the slot accounting
    reaches stats() and signals()."""
    jm, pm = pair
    slot_flags = {"FLAGS_decode_slots": 4, "FLAGS_prefill_chunk": 8}
    grid = dict(batch_buckets=(1, 2), seq_buckets=(8, 16),
                max_new_tokens=4, max_len=32)
    rows = [np.random.RandomState(3).randint(1, V, int(n))
            for n in (3, 7, 12, 1, 9, 5)]
    snap = flags_snapshot()
    try:
        set_flags(slot_flags)
        srv = serving.Server(serving.ServingConfig(workers=2),
                             device="cpu")
        srv.register_decode("gpt", pm, **grid)
        srv.start()
        try:
            rt = srv._models["gpt"]
            assert rt.slots == 4 and rt._loop is not None
            assert rt._slot_cache == 32 and rt.max_prompt == 24
            built = dict(rt.gen.counters)
            futs = [srv.submit_decode("gpt", [p], max_new_tokens=4)
                    for p in rows]
            served = [f.result(timeout=120)[0][0] for f in futs]
            assert dict(rt.gen.counters) == built
            st = srv.stats("gpt")
            sig = srv.signals()
        finally:
            srv.stop()
        assert not rt._loop._thread.is_alive()        # stop() closed it
    finally:
        flags_restore(snap)
    assert st["slot_loop"]["joined"] == 6 and st["completed"] == 6
    assert sig["slots_joined_total"] == sig["slots_retired_total"] == 6
    assert 0.0 < sig["decode_slot_occupancy_ratio"] <= 1.0
    oracle = Generator(pm, device="cpu", seq_buckets=(8, 16), max_len=32)
    for p, got in zip(rows, served):
        np.testing.assert_array_equal(got, _generate(oracle, p, 4))
    jsnap = jflags_snapshot()
    try:
        jset_flags(slot_flags)
        jsrv = jserving.Server(jserving.ServingConfig(workers=1))
        jsrv.register_decode("gpt", jm, **grid)
        jsrv.start()
        try:
            jserved = [jsrv.run_decode("gpt", [p], max_new_tokens=4)[0][0]
                       for p in rows]
        finally:
            jsrv.stop()
    finally:
        jflags_restore(jsnap)
    np.testing.assert_array_equal(np.stack(served), np.stack(jserved))


def test_slot_mode_off_keeps_run_to_completion(pair):
    _, pm = pair
    assert _flags.flag("decode_slots") == 0
    srv = serving.Server(serving.ServingConfig(workers=2), device="cpu")
    srv.register_decode("gpt", pm, batch_buckets=(1,), seq_buckets=(8,),
                        max_new_tokens=3, max_len=32)
    srv.start()
    try:
        rt = srv._models["gpt"]
        assert rt.slots == 0 and rt._loop is None
        p = np.arange(1, 5)
        out = srv.run_decode("gpt", [p])[0]
        assert "slot_loop" not in srv.stats("gpt")
        assert "decode_slot_occupancy_ratio" not in srv.signals()
    finally:
        srv.stop()
    oracle = Generator(pm, device="cpu", seq_buckets=(8,), max_len=32)
    np.testing.assert_array_equal(out[0], _generate(oracle, p, 3))


def test_forward_cached_tensor_position_equals_int_path(pair):
    """A 0-d int32 tensor ``cache_position`` gives the int path's logits
    and planes bit for bit, bf16 and int8 KV, at decode steps (t = 1)
    and chunks (t = 8), a block that wraps the 16-column ring included.
    (One test, not a parametrized grid: with at most as many tests as
    tests/test_datasets_zoo.py, xdist's loadfile queue runs this file
    after that one; ROADMAP queue C.)"""
    _, pm = pair
    snap = flags_snapshot()
    try:
        for kv in ("bf16", "int8"):
            set_flags({"FLAGS_kv_cache_dtype": kv})
            for t, pos in ((1, 5), (1, 15), (8, 3), (8, 12)):
                _assert_tensor_position_equal(pm, t, pos)
    finally:
        flags_restore(snap)


def _assert_tensor_position_equal(pm, t, pos):
    rng = np.random.RandomState(7 + pos)
    B, C = 3, 16
    ids = torch.as_tensor(rng.randint(1, V, (B, t)), dtype=torch.int32)
    start = torch.as_tensor([0, 2, 4], dtype=torch.int32)
    with torch.inference_mode():
        base = pm.init_cache(B, C)
        for c in base:
            for p in c:
                p.copy_(torch.as_tensor(
                    rng.randint(-3, 4, tuple(p.shape))).to(p.dtype))
        outs = []
        for cp in (pos, torch.tensor(pos, dtype=torch.int32)):
            cache = [type(c)(*(p.clone() for p in c)) for c in base]
            outs.append(pm.forward_cached(ids, cache, cp, start))
    (li, ci), (lt, ct) = outs
    assert torch.equal(li, lt), (t, pos)
    for a, b in zip(ci, ct):
        for x, y in zip(a, b):
            assert torch.equal(x, y), (t, pos)


def test_concurrent_submitters_stress(pair):
    """More submitting threads than cores, with a short switch interval:
    every future resolves to its row's generate() tokens, and the loop's
    join/retire accounting loses no update."""
    import sys
    import threading
    _, pm = pair
    loop = SlotLoop(_gen(pm), slots=4, cache_len=64, chunk=8)
    reqs = _trace(random.Random(77), 24)
    got = [None] * len(reqs)
    errors = []

    def client(k):
        try:
            for j in range(k, len(reqs), 8):
                p, mn = reqs[j]
                got[j] = np.asarray(loop.submit(p, mn).result(timeout=120))
        except Exception as e:   # noqa: BLE001 — recorded per client
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        loop.close()
    assert errors == []
    _assert_equal_generate(_gen(pm), reqs, got)
    sig = loop.signals()
    assert sig["slots_joined_total"] == sig["slots_retired_total"] == 24
    assert sig["slot_pending"] == 0
