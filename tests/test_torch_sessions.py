"""The port's parked sessions (serving/sessions.py, checkpoint/atomic.py
and the slot loop's session branch) on the CPU.

Mirrors ``tests/test_prefix_session.py`` and the atomic cases of
``tests/test_fault_tolerance.py``: atomic writes and corrupt-file
detection (each package reads the other's checkpoint pickle); session
snapshots round-trip bit for bit in f32, bf16 and int8 with scales, and
give the JAX serializer's bytes for the same payload, each package
reading the other's blob; the store's spill, corruption and migration;
a parked turn restores with the tokens of a full re-prefill (plain,
speculative and int8 KV), port against port, and equal to the JAX
SlotLoop's on the same transcripts; drain-parks mid-generation and the
resumed turn; the Server with drain and spill; the off path; the
serving exports.
"""
import os
import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.checkpoint.atomic import \
    atomic_pickle_save as jax_atomic_pickle_save
from paddle_tpu.checkpoint.atomic import \
    verified_pickle_load as jax_verified_pickle_load
from paddle_tpu.framework.flags import flags_restore as jflags_restore
from paddle_tpu.framework.flags import flags_snapshot as jflags_snapshot
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.serving.sessions import SessionSnapshot as JaxSnapshot
from paddle_tpu.serving.sessions import SessionStore as JaxSessionStore
from paddle_tpu.serving.slots import SlotLoop as JaxSlotLoop
from paddle_tpu.text.generation import Generator as JaxGenerator
from paddle_tpu.text.speculative import \
    SpeculativeGenerator as JaxSpeculativeGenerator
from torch_port_util import gpt_pair
from paddle_tpu_torch import serving
from paddle_tpu_torch.checkpoint.atomic import (CheckpointCorruptError,
                                                atomic_pickle_save,
                                                atomic_write_bytes,
                                                verified_pickle_load)
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.framework.enforce import UnavailableError
from paddle_tpu_torch.framework.flags import (flags_restore, flags_snapshot,
                                              set_flags)
from paddle_tpu_torch.serving.sessions import SessionSnapshot, SessionStore
from paddle_tpu_torch.serving.slots import SlotLoop
from paddle_tpu_torch.text.generation import Generator
from paddle_tpu_torch.text.speculative import SpeculativeGenerator

V = 64
TINY = dict(vocab_size=V, hidden_size=32, layers=2, heads=2, seq=64)
DRAFT = dict(vocab_size=V, hidden_size=16, layers=1, heads=2, seq=64)
BUCKETS = dict(seq_buckets=(8, 16, 32), max_len=64)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(21, **TINY)


def _want(oracle, p, mn):
    return oracle.generate(np.asarray([p], np.int32),
                           max_new_tokens=mn).numpy()[0]


# -- host-side layer ----------------------------------------------------------

def test_atomic_write_and_corrupt_detection_cross_package(tmp_path):
    p = str(tmp_path / "f.bin")
    atomic_write_bytes(p, b"old-contents")
    digest = atomic_write_bytes(p, b"new-contents")
    assert open(p, "rb").read() == b"new-contents"
    import hashlib
    assert digest == hashlib.sha256(b"new-contents").hexdigest()
    assert os.listdir(str(tmp_path)) == ["f.bin"]       # no temp debris

    w = np.arange(4.0)
    mine, theirs = str(tmp_path / "m.pdparams"), str(tmp_path / "j.pdparams")
    digest, size = atomic_pickle_save({"w": torch.from_numpy(w), "n": 3},
                                      mine)
    jdigest, _ = jax_atomic_pickle_save({"w": w, "n": 3}, theirs)
    assert os.path.getsize(mine) == size
    ok = verified_pickle_load(mine, expect_sha256=digest)
    assert torch.equal(ok["w"], torch.from_numpy(w)) and ok["n"] == 3
    # each package reads the other's file
    assert np.array_equal(jax_verified_pickle_load(
        mine, expect_sha256=digest, return_numpy=True)["w"], w)
    assert np.array_equal(verified_pickle_load(
        theirs, expect_sha256=jdigest, return_numpy=True)["w"], w)
    with open(mine, "r+b") as f:
        f.seek(5)
        orig = f.read(2)
        f.seek(5)
        f.write(bytes(b ^ 0xFF for b in orig))   # guaranteed different
    with pytest.raises(CheckpointCorruptError):
        verified_pickle_load(mine, expect_sha256=digest)


def _snapshot_pair(seed):
    """The same snapshot payload for both packages: f32, bf16 and int8 +
    f32 scale planes (a plain cache of two layers) and f32 logits."""
    rng = np.random.RandomState(seed)
    f32 = rng.randn(1, 2, 9, 4).astype(np.float32)
    bf = rng.randn(1, 2, 9, 4).astype(np.float32)
    q = rng.randint(-127, 128, (1, 2, 9, 4)).astype(np.int8)
    sc = rng.rand(1, 2, 9, 1).astype(np.float32)
    logits = rng.randn(V).astype(np.float32)
    kw = dict(session_id="conv-1", model="gpt", tokens=list(range(9)),
              remaining=2, emitted=[5, 6], cur=None, kv_dtype="int8",
              spec=False, t_park=123.5, meta={"k": "v"})
    jax_planes = [(f32, np.asarray(jnp.asarray(bf, jnp.bfloat16))),
                  (q, q[:, ::-1].copy(), sc, sc * 2)]
    t = torch.from_numpy
    port_planes = [(t(f32), t(bf).to(torch.bfloat16)),
                   (t(q), t(q[:, ::-1].copy()), t(sc), t(sc * 2))]
    return (SessionSnapshot(planes=port_planes, logits=t(logits), **kw),
            JaxSnapshot(planes=jax_planes, logits=logits, **kw))


def test_session_snapshot_roundtrip_bit_exact_and_jax_bytes():
    snap, jsnap = _snapshot_pair(0)
    blob, jblob = snap.to_bytes(), jsnap.to_bytes()
    assert blob == jblob                    # the same bytes as JAX's writer
    back = SessionSnapshot.from_bytes(jblob)   # and each reads the other's
    jback = JaxSnapshot.from_bytes(blob)
    assert back.tokens == list(range(9)) and back.emitted == [5, 6]
    assert (back.remaining, back.kv_dtype, back.t_park, back.meta) \
        == (2, "int8", 123.5, {"k": "v"})
    assert isinstance(back.planes, list) and isinstance(back.planes[0],
                                                        tuple)
    for c, jc in zip(back.planes, jsnap.planes):
        for p, jp in zip(c, jc):
            assert str(p.dtype).split(".")[1] == str(jp.dtype)
            assert p.shape == jp.shape
    assert back.planes[0][1].dtype == torch.bfloat16
    for c, oc in zip(back.planes, snap.planes):
        for p, op in zip(c, oc):
            assert torch.equal(p, op)       # bit-exact, bf16 included
    assert torch.equal(back.logits, snap.logits)
    assert back.nbytes() == snap.nbytes() == jsnap.nbytes()
    assert back.to_bytes() == blob
    assert jback.to_bytes() == blob
    assert np.asarray(jback.planes[1][2]).tobytes() \
        == snap.planes[1][2].numpy().tobytes()


def test_session_store_spill_corrupt_and_migration(tmp_path):
    d = str(tmp_path / "spill")

    def mk(sid, t_park, tok=5):
        return SessionSnapshot(session_id=sid, model="gpt",
                               tokens=[tok] * 4, t_park=t_park,
                               planes=[torch.ones((2, 2))])

    store = SessionStore(spill_dir=d, park_after_ms=0)   # write-through
    store.put(mk("s1", 10.0))
    blob_path, man_path = store._paths("s1")
    assert os.path.exists(blob_path) and os.path.exists(man_path)
    assert "s1" in store and len(store) == 1 and store.nbytes() > 0
    # the JAX store names the files alike and reads the port's spill
    assert JaxSessionStore(spill_dir=d)._paths("s1") == (blob_path,
                                                         man_path)
    assert JaxSessionStore(spill_dir=d).peek_ids() == ["s1"]

    # a fresh store over the same dir (a restarted server) finds it
    store2 = SessionStore(spill_dir=d, park_after_ms=0)
    assert store2.peek_ids() == ["s1"]
    got = store2.take("s1")
    assert got is not None and got.tokens == [5] * 4
    assert not os.path.exists(blob_path)          # take removes every copy
    assert store2.take("s1") is None

    # a torn spill is a miss, never a crash, and the wreck is swept
    store2.put(mk("s2", 11.0))
    bp, _ = store2._paths("s2")
    fresh = SessionStore(spill_dir=d, park_after_ms=0)   # disk-only view
    with open(bp, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"\xff\xff\xff")
    assert fresh.take("s2") is None
    assert not os.path.exists(bp)

    # lazy spill: parks stay in RAM until they age past park_after_ms
    lazy = SessionStore(spill_dir=str(tmp_path / "lazy"), park_after_ms=1)
    lazy.put(mk("old", 1.0))                     # ancient: spilled next put
    lazy.put(mk("new", 0.0))                     # stamped now: stays hot
    assert os.path.exists(lazy._paths("old")[0])
    assert not os.path.exists(lazy._paths("new")[0])
    assert lazy.take("old").tokens == [5] * 4

    # migration transport: export moves, import keeps the newer t_park
    ram = SessionStore()
    ram.put(mk("s3", 20.0, tok=1))
    blob = ram.export_bytes("s3")
    assert blob is not None and "s3" not in ram
    dst = SessionStore()
    dst.put(mk("s3", 30.0, tok=2))                # fresher local turn
    assert dst.import_bytes(blob) is None         # stale replay loses
    assert dst.take("s3").tokens == [2] * 4
    dst.put(mk("s3", 10.0, tok=3))                # now the import is newer
    assert dst.import_bytes(blob) == "s3"
    assert dst.take("s3").tokens == [1] * 4 and len(dst) == 0


def test_session_flags_surface_and_jax_defaults():
    snap = flags_snapshot()
    assert _flags.flag("session_store") is False
    try:
        set_flags({"FLAGS_session_store": True,
                   "FLAGS_session_store_dir": "/tmp/x",
                   "FLAGS_session_park_after_ms": 250,
                   "FLAGS_drain_timeout_s": 5.0})
        assert _flags.flag("session_park_after_ms") == 250
        for bad in ({"FLAGS_session_park_after_ms": -5},
                    {"FLAGS_drain_timeout_s": 0.0},
                    {"FLAGS_router_stale_after_s": -1.0}):
            with pytest.raises(ValueError):
                set_flags(bad)
        assert _flags.flag("session_park_after_ms") == 250  # no clobber
    finally:
        flags_restore(snap)
    assert _flags.flag("session_store") is False
    jsnap = jflags_snapshot()
    for name in ("session_store", "session_store_dir",
                 "session_park_after_ms", "drain_timeout_s",
                 "router_stale_after_s"):
        assert _flags._REGISTRY[name].default == jsnap[name], name


# -- the slot loop ------------------------------------------------------------

def _turns(loop, store, trials=2):
    """turn 1 parks, turn 2 takes the snapshot, restores the planes and
    answers; interleaved with one-shot churn so restores land in
    occupied, shifted slots.  Returns every turn's (transcript, max_new,
    tokens)."""
    out = []
    for trial in range(trials):
        rng = random.Random(333 + trial)
        sid = f"conv-{trial}"
        transcript = [rng.randrange(1, V) for _ in range(10)]
        noise = [loop.submit([rng.randrange(1, V)
                              for _ in range(rng.randint(1, 9))],
                             rng.randint(1, 4)) for _ in range(3)]
        for turn in range(3):
            mn = rng.randint(2, 5)
            snap = store.take(sid)
            assert (snap is not None) == (turn > 0)  # parked between turns
            got = np.asarray(loop.submit(transcript, mn, session_id=sid,
                                         snapshot=snap).result(timeout=120))
            out.append((list(transcript), mn, got.reshape(-1)[:mn]))
            transcript = transcript + [int(t) for t in got.reshape(-1)[:mn]] \
                + [rng.randrange(1, V) for _ in range(2)]
        for f in noise:
            f.result(timeout=120)
    return out


def _roundtrip(pm, jax_loop, make_gen, kv="bf16"):
    """The port's turns equal a full re-prefill (batch-1 generate() of the
    grown transcript) token for token, and the JAX SlotLoop's turns on the
    same transcripts; both loops park and restore."""
    snap, jsnap = flags_snapshot(), jflags_snapshot()
    try:
        set_flags({"FLAGS_kv_cache_dtype": kv})
        jset_flags({"FLAGS_kv_cache_dtype": kv})
        store = SessionStore()
        loop = SlotLoop(make_gen(), slots=4, cache_len=64, chunk=8,
                        session_store=store)
        try:
            got = _turns(loop, store)
            c = dict(loop.counters)
        finally:
            loop.close()
        oracle = Generator(pm, device="cpu", **BUCKETS)
        for transcript, mn, toks in got:
            np.testing.assert_array_equal(toks,
                                          _want(oracle, transcript, mn))
        # 3 turns x 2 conversations: 6 parks, 4 restores; each restore
        # pushes one whole 8-column block at least
        assert c["parked"] == 6 and c["restored"] == 4
        assert c["restore_pushes"] >= 4
        jstore = JaxSessionStore()
        jloop = jax_loop(jstore)
        try:
            jgot = _turns(jloop, jstore)
            assert jloop.counters["restored"] == 4
        finally:
            jloop.close()
        for (t, mn, toks), (jt, jmn, jtoks) in zip(got, jgot):
            assert (t, mn) == (jt, jmn)
            np.testing.assert_array_equal(toks, jtoks)
    finally:
        flags_restore(snap)
        jflags_restore(jsnap)


def test_turn_park_restore_bit_identical_plain(pair):
    jm, pm = pair
    _roundtrip(pm, lambda st: JaxSlotLoop(
        JaxGenerator(jm, **BUCKETS), slots=4, cache_len=64, chunk=8,
        session_store=st), lambda: Generator(pm, device="cpu", **BUCKETS))


def test_turn_park_restore_bit_identical_speculative(pair):
    jm, pm = pair
    jd, pd = gpt_pair(101, **DRAFT)
    _roundtrip(pm, lambda st: JaxSlotLoop(
        JaxSpeculativeGenerator(jm, jd, gamma=3, **BUCKETS), slots=4,
        cache_len=64, chunk=8, session_store=st),
        lambda: SpeculativeGenerator(pm, pd, device="cpu", gamma=3,
                                     **BUCKETS))


def test_turn_park_restore_bit_identical_int8_kv(pair):
    jm, pm = pair
    _roundtrip(pm, lambda st: JaxSlotLoop(
        JaxGenerator(jm, **BUCKETS), slots=4, cache_len=64, chunk=8,
        session_store=st), lambda: Generator(pm, device="cpu", **BUCKETS),
        kv="int8")


def test_drain_parks_mid_generation_and_resumes(pair):
    """park_sessions() mid-stream: the generating row snapshots with
    budget left, its future fails retryably, and the turn submitted again
    with the snapshot replays the emitted tokens and finishes with the
    tokens of an uninterrupted run.  The driver is held after its third
    step until the park request is in, so the park lands mid-stream."""
    _, pm = pair
    oracle = Generator(pm, device="cpu", **BUCKETS)
    store = SessionStore()
    loop = SlotLoop(Generator(pm, device="cpu", **BUCKETS), slots=2,
                    cache_len=64, chunk=8, session_store=store)
    step, reached = loop._decode_step, threading.Event()

    def held_step():
        step()
        if loop.counters["steps"] == 3:
            reached.set()
            while loop._park_req is None:
                threading.Event().wait(0.001)

    loop._decode_step = held_step
    prompt = [5, 9, 2, 33, 17, 8]
    try:
        fut = loop.submit(prompt, 24, session_id="drainee")
        assert reached.wait(30)
        assert loop.park_sessions(timeout=30.0) == 1
        with pytest.raises(UnavailableError) as ei:
            fut.result(timeout=30)
        assert ei.value.retry_after_s is not None
        snap = store.take("drainee")
        assert snap.remaining == 21 and len(snap.emitted) == 3
        assert snap.logits is not None and snap.logits.shape == (V,)
        want = _want(oracle, prompt, 24)
        np.testing.assert_array_equal(snap.emitted, want[:3])
        loop._decode_step = step
        got = np.asarray(loop.submit(prompt, 24, session_id="drainee",
                                     snapshot=snap).result(timeout=120))
        np.testing.assert_array_equal(got.reshape(-1), want)
        assert loop.counters["restored"] == 1
        assert store.take("drainee") is not None  # parked again at the end
    finally:
        loop.close()


# -- the server ---------------------------------------------------------------

GRID = dict(batch_buckets=(1, 2), seq_buckets=(8, 16, 32), max_new_tokens=4,
            max_len=64)


def _server(pm):
    srv = serving.Server(serving.ServingConfig(workers=2), device="cpu")
    srv.register_decode("gpt", pm, **GRID)
    return srv.start()


def test_server_sessions_end_to_end_with_drain_and_spill(pair, tmp_path):
    """FLAGS_session_store with a spill dir and the prefix cache: two turns
    equal the oracle and the JAX server's, drain() refuses new work and
    leaves the conversation parked, and a SECOND server over the same
    spill dir restores it and continues with the oracle's tokens."""
    jm, pm = pair
    oracle = Generator(pm, device="cpu", **BUCKETS)
    flags = {"FLAGS_decode_slots": 4, "FLAGS_prefill_chunk": 8,
             "FLAGS_session_store": True,
             "FLAGS_session_store_dir": str(tmp_path / "sessions"),
             "FLAGS_prefix_cache": True}
    rng = np.random.RandomState(9)
    p1 = rng.randint(1, V, 6).astype(np.int32)
    tail2, tail3 = rng.randint(1, V, 3), rng.randint(1, V, 2)
    snap = flags_snapshot()
    try:
        set_flags(flags)
        srv = _server(pm)
        try:
            assert srv.session_store is not None and not srv.draining
            got1 = srv.submit_decode("gpt", [p1], max_new_tokens=4,
                                     session_id="conv").result(
                                         timeout=120)[0][0]
            p2 = np.concatenate([p1, got1, tail2]).astype(np.int32)
            got2 = srv.submit_decode("gpt", [p2], max_new_tokens=4,
                                     session_id="conv").result(
                                         timeout=120)[0][0]
            st = srv.stats("gpt")
            with pytest.raises(Exception):   # one prompt per session
                srv.submit_decode("gpt", [p1, p2], session_id="conv")
            report = srv.drain(timeout_s=30.0)
            assert report["drained"] and report["pending"] == 0
            assert srv.draining and "conv" in srv.session_store
            with pytest.raises(UnavailableError) as ei:
                srv.submit_decode("gpt", [p1])
            assert ei.value.retry_after_s == _flags.flag(
                "router_stale_after_s")
            sig = srv.signals()
        finally:
            srv.stop()
        srv2 = _server(pm)           # a restart over the same spill dir
        try:
            p3 = np.concatenate([p2, got2, tail3]).astype(np.int32)
            got3 = srv2.submit_decode("gpt", [p3], max_new_tokens=4,
                                      session_id="conv").result(
                                          timeout=120)[0][0]
            restored = srv2.stats("gpt")["slot_loop"]["restored"]
            srv2.assert_zero_steady_state_recompiles()
        finally:
            srv2.stop()
    finally:
        flags_restore(snap)
    for p, got in ((p1, got1), (p2, got2), (p3, got3)):
        np.testing.assert_array_equal(got, _want(oracle, p, 4))
    assert st["slot_loop"]["restored"] == 1 and st["slot_loop"]["parked"] == 2
    assert st["sessions_parked"] == 1 and st["session_store_bytes"] > 0
    assert sig["sessions_parked"] == 1 and sig["draining"]
    assert restored == 1
    # the JAX server, on the same turns
    jsnap = jflags_snapshot()
    try:
        jset_flags(dict(flags, FLAGS_session_store_dir=str(tmp_path / "j")))
        jsrv = __import__("paddle_tpu").serving.Server(
            __import__("paddle_tpu").serving.ServingConfig(workers=1))
        jsrv.register_decode("gpt", jm, **GRID)
        jsrv.start()
        try:
            jgot = [jsrv.submit_decode("gpt", [p], max_new_tokens=4,
                                       session_id="conv").result(
                                           timeout=120)[0][0]
                    for p in (p1, p2, p3)]
        finally:
            jsrv.stop()
    finally:
        jflags_restore(jsnap)
    np.testing.assert_array_equal(np.stack(jgot),
                                  np.stack([got1, got2, got3]))


def test_session_off_path_is_inert(pair):
    """Defaults (no store): no store is built, a session id is validated
    and then ignored, and the accounting shows no session keys."""
    _, pm = pair
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_decode_slots": 2, "FLAGS_prefill_chunk": 8})
        srv = _server(pm)
        try:
            assert srv.session_store is None
            rt = srv._models["gpt"]
            assert rt.session_store is None and rt._loop._sessions is None
            out = srv.submit_decode("gpt", [np.arange(1, 5)],
                                    max_new_tokens=3,
                                    session_id="ignored").result(
                                        timeout=120)[0]
            assert out.shape == (1, 3)
            assert rt._loop.counters["parked"] == 0
            assert srv.park_sessions() == 0
            sig, st = srv.signals(), srv.stats("gpt")
            assert "sessions_parked" not in sig
            assert "sessions_parked" not in st
            assert "prefix_cache_blocks" not in sig
        finally:
            srv.stop()
    finally:
        flags_restore(snap)


def test_serving_exports():
    from paddle_tpu_torch.serving import (  # noqa: F401
        Batch, BucketLadder, DecodeModelSpec, DecodeRequest, KVHandoff,
        ModelSpec, Request, RequestQueue, Server, ServingConfig,
        SessionSnapshot, SessionStore, cluster, deserialize_kv,
        deserialize_session, export_for_serving, pack_fifo, pad_to_bucket,
        serialize_kv, serialize_session)
    assert set(serving.__all__) >= {
        "BucketLadder", "pad_to_bucket", "Batch", "Request", "RequestQueue",
        "pack_fifo", "SessionStore", "SessionSnapshot", "KVHandoff"}
    assert serving.cluster.KVHandoff is KVHandoff
