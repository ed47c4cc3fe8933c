"""The port's prefill -> decode KV handoff (serving/cluster/handoff.py and
the Server's ``prefill_handoff`` / ``decode_from_handoff``) on the CPU.

Mirrors ``tests/test_kv_handoff.py``: the blob round trip is bit-exact in
f32, bf16 and int8 with scales, gives the JAX serializer's bytes for the
same payload, and each package reads the other's blob; a bad blob is
refused; prefill -> bytes -> decode equals the in-process continuation,
``submit_decode`` and the JAX server's handoff, in the model's dtype and
with int8 KV.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.framework.flags import flags_restore as jflags_restore
from paddle_tpu.framework.flags import flags_snapshot as jflags_snapshot
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.serving.cluster import KVHandoff as JaxKVHandoff
from paddle_tpu.serving.cluster import deserialize_kv as jax_deserialize_kv
from paddle_tpu.serving.cluster import serialize_kv as jax_serialize_kv
from torch_port_util import gpt_pair, prompts
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.enforce import (InvalidArgumentError,
                                                PreconditionNotMetError)
from paddle_tpu_torch.framework.flags import (flags_restore, flags_snapshot,
                                              set_flags)
from paddle_tpu_torch.serving.cluster import handoff
from paddle_tpu_torch.serving.cluster import (KVHandoff, deserialize_kv,
                                              serialize_kv)
from paddle_tpu_torch.text.generation import Generator

V = 64
TINY = dict(vocab_size=V, hidden_size=32, layers=2, heads=2, seq=64)
GRID = dict(batch_buckets=(1, 2), seq_buckets=(8, 16), max_new_tokens=4,
            max_len=32)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(21, **TINY)


def _server(pm):
    srv = serving.Server(serving.ServingConfig(workers=1), device="cpu")
    srv.register_decode("gpt", pm, **GRID)
    return srv.start()


def _jax_server(jm):
    srv = jserving.Server(jserving.ServingConfig(workers=1))
    srv.register_decode("gpt", jm, **GRID)
    srv.start()
    return srv


def _equal_planes(a, b):
    for c, c2 in zip(a.cache, b.cache):
        assert len(c) == len(c2)
        for p, p2 in zip(c, c2):
            assert torch.equal(p.cpu(), p2.cpu())


def test_roundtrip_bit_exact_f32_bf16_and_jax_bytes():
    rng = np.random.RandomState(0)
    f32 = rng.randn(1, 2, 8, 4).astype(np.float32)
    bf = rng.randn(1, 2, 8, 4).astype(np.float32)
    logits = rng.randn(1, V).astype(np.float32)
    meta = {"model": "m", "rows": 1, "max_new": 4}
    t = torch.from_numpy
    h = KVHandoff(cache=[(t(f32), t(f32 * 2)),
                         (t(bf).to(torch.bfloat16),
                          t(bf + 1).to(torch.bfloat16))],
                  logits0=t(logits), start=np.array([3], np.int32), pos=8,
                  meta=meta)
    jh = JaxKVHandoff(cache=[(f32, f32 * 2),
                             (jnp.asarray(bf, jnp.bfloat16),
                              jnp.asarray(bf + 1, jnp.bfloat16))],
                      logits0=logits, start=np.array([3], np.int32), pos=8,
                      meta=meta)
    blob = serialize_kv(h)
    assert blob == jax_serialize_kv(jh)       # JAX's bytes, bf16 included
    for back in (deserialize_kv(blob), KVHandoff.from_bytes(
            jax_serialize_kv(jh))):
        _equal_planes(back, h)
        assert back.cache[1][0].dtype == torch.bfloat16
        assert torch.equal(back.logits0, h.logits0)
        assert back.pos == 8 and list(back.start) == [3]
        assert back.meta == meta
    jback = jax_deserialize_kv(blob)           # JAX reads the port's blob
    assert str(jback.cache[1][0].dtype) == "bfloat16"
    assert np.asarray(jback.cache[1][1]).tobytes() \
        == h.cache[1][1].view(torch.int16).numpy().tobytes()
    assert h.nbytes() == deserialize_kv(blob).nbytes()


def test_roundtrip_int8_scale_planes_bit_exact_and_jax_bytes():
    rng = np.random.RandomState(1)
    k = rng.randint(-128, 128, (2, 2, 8, 4)).astype(np.int8)
    ks = rng.rand(2, 2, 8, 1).astype(np.float32)
    planes = (k, k[::-1].copy(), ks, ks * 2)
    h = KVHandoff(cache=[tuple(torch.from_numpy(p) for p in planes)],
                  logits0=None, start=np.array([0, 2], np.int32), pos=4)
    blob = h.to_bytes()
    assert blob == jax_serialize_kv(JaxKVHandoff(
        cache=[planes], logits0=None, start=np.array([0, 2], np.int32),
        pos=4))
    h2 = deserialize_kv(blob)
    assert h2.logits0 is None and len(h2.cache[0]) == 4
    _equal_planes(h2, h)
    assert h2.cache[0][0].dtype == torch.int8


def test_bad_blob_rejected():
    good = KVHandoff(cache=[(torch.ones(1, 1, 2, 2),)], logits0=None,
                     start=[0], pos=2).to_bytes()
    for bad in (b"not a handoff", good[:-3],
                good.replace(b'"version": 1', b'"version": 7')):
        with pytest.raises(InvalidArgumentError):
            deserialize_kv(bad)


def test_wire_and_device_transfer_equal_continuation_and_jax(pair):
    """prefill -> serialize -> deserialize -> decode equals the in-process
    continuation (the device handoff), submit_decode of the same prompts,
    batch-1 generate(), and the JAX server's wire handoff; and the port's
    blob decodes on the JAX server to the same tokens."""
    jm, pm = pair
    ps = prompts(3, (5, 11), V)
    oracle = Generator(pm, device="cpu", seq_buckets=(8, 16), max_len=32)
    want = np.concatenate([oracle.generate(p[None, :], max_new_tokens=4)
                           .numpy() for p in ps])
    srv = _server(pm)
    try:
        before = handoff.stats()
        h = srv.prefill_handoff("gpt", ps, 4)
        assert h.meta["rows"] == 2 and h.pos == 16
        blob = h.to_bytes()
        h2 = deserialize_kv(blob)
        assert h2.cache[0][0].device.type == "cpu" and h2.pos == h.pos
        _equal_planes(h2, h)
        got = srv.decode_from_handoff("gpt", blob)
        device = srv.decode_from_handoff("gpt", h)   # in-process
        served = srv.submit_decode("gpt", ps).result(timeout=120)[0]
        srv.assert_zero_steady_state_recompiles()
        after = handoff.stats()
    finally:
        srv.stop()
    assert got.dtype == np.int32 and got.shape == (2, 4)
    for other in (device, served, want):
        np.testing.assert_array_equal(got, other)
    assert after["wire_bytes"] - before["wire_bytes"] == len(blob)
    assert after["legs"] - before["legs"] >= 2
    jsrv = _jax_server(jm)
    try:
        jblob = jsrv.prefill_handoff("gpt", ps, 4).to_bytes()
        jgot = jsrv.decode_from_handoff("gpt", jblob)
        jport = jsrv.decode_from_handoff("gpt", blob)
    finally:
        jsrv.stop()
    np.testing.assert_array_equal(np.asarray(jgot), got)
    np.testing.assert_array_equal(np.asarray(jport), got)


def test_int8_kv_handoff_equals_continuation_and_jax(pair):
    """int8 ring caches (int8 rows + f32 scale planes): 4 planes a layer
    cross the wire and the continuation equals the in-process one and
    the JAX server's int8 handoff."""
    jm, pm = pair
    ps = prompts(4, (7, 3), V)
    snap, jsnap = flags_snapshot(), jflags_snapshot()
    try:
        set_flags({"FLAGS_kv_cache_dtype": "int8"})
        jset_flags({"FLAGS_kv_cache_dtype": "int8"})
        srv = _server(pm)
        try:
            h = srv.prefill_handoff("gpt", ps, 4)
            assert len(h.cache[0]) == 4 and h.cache[0][0].dtype == torch.int8
            blob = h.to_bytes()
            assert str(jax_deserialize_kv(blob).cache[0][0].dtype) == "int8"
            got = srv.decode_from_handoff("gpt", blob)
            device = srv.decode_from_handoff("gpt", h)
            served = srv.submit_decode("gpt", ps).result(timeout=120)[0]
        finally:
            srv.stop()
        jsrv = _jax_server(jm)
        try:
            jgot = jsrv.decode_from_handoff(
                "gpt", jsrv.prefill_handoff("gpt", ps, 4).to_bytes())
        finally:
            jsrv.stop()
    finally:
        flags_restore(snap)
        jflags_restore(jsnap)
    np.testing.assert_array_equal(got, device)
    np.testing.assert_array_equal(got, served)
    np.testing.assert_array_equal(np.asarray(jgot), got)


def test_handoff_respects_max_new_rows_and_preconditions(pair):
    _, pm = pair
    unstarted = serving.Server(device="cpu")
    unstarted.register_decode("gpt", pm, **GRID)
    with pytest.raises(PreconditionNotMetError):
        unstarted.prefill_handoff("gpt", [np.array([1, 2], np.int32)])
    srv = _server(pm)
    try:
        ps = prompts(5, (2, 9), V)
        h = srv.prefill_handoff("gpt", ps, 2)
        assert h.meta["rows"] == 2 and h.meta["max_new"] == 2
        got = srv.decode_from_handoff("gpt", h.to_bytes())
        assert got.shape == (2, 2)
        np.testing.assert_array_equal(
            got, srv.submit_decode("gpt", ps, 2).result(timeout=120)[0])
        one = srv.decode_from_handoff(
            "gpt", srv.prefill_handoff("gpt", ps[:1], 4))
        assert one.shape == (1, 4)
        with pytest.raises(InvalidArgumentError):
            srv.decode_from_handoff("gpt", b"not a handoff")
        wrong = srv.prefill_handoff("gpt", ps, 2)
        wrong.meta["model"] = "other"
        with pytest.raises(InvalidArgumentError):
            srv.decode_from_handoff("gpt", wrong)
        srv.request_drain()
        with pytest.raises(Exception, match="draining"):
            srv.prefill_handoff("gpt", ps)
    finally:
        srv.stop()
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_decode_slots": 2, "FLAGS_prefill_chunk": 8})
        slot = _server(pm)
        try:
            with pytest.raises(PreconditionNotMetError, match="slots"):
                slot.prefill_handoff("gpt", ps)
        finally:
            slot.stop()
    finally:
        flags_restore(snap)
