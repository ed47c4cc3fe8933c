"""The PyTorch port's decode serving engine on the CPU.

Served greedy tokens equal the port's batch-1 ``generate()`` of the same
prompt (the admission oracle of the JAX engine's own tests) and the JAX
engine's served tokens for the same weights; validation errors keep the
JAX engine's classes; registration guards and strict mode behave alike.
"""
import threading

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from torch_port_util import KERNEL_TINY, gpt_pair, prompts
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.enforce import (InvalidArgumentError,
                                                NotFoundError,
                                                OutOfRangeError,
                                                PreconditionNotMetError)
from paddle_tpu_torch.framework.flags import (flags_restore, flags_snapshot,
                                              set_flags)
from paddle_tpu_torch.text.generation import Generator

V = KERNEL_TINY["vocab_size"]
GRID = dict(batch_buckets=(1, 2), seq_buckets=(8, 16), max_new_tokens=4,
            max_len=32)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(21, **KERNEL_TINY)


def _server(m, **kw):
    srv = serving.Server(serving.ServingConfig(workers=2), device="cpu")
    srv.register_decode("gpt", m, **{**GRID, **kw})
    return srv


def test_served_tokens_match_batch1_generate_and_jax_server(pair):
    jm, pm = pair
    rows = prompts(1, (3, 7, 12, 1, 9), V)
    srv = _server(pm)
    srv.start()
    try:
        futs = [srv.submit_decode("gpt", [p], max_new_tokens=4)
                for p in rows]
        served = [f.result(timeout=60)[0][0] for f in futs]
        st = srv.stats("gpt")
    finally:
        srv.stop()
    oracle = Generator(pm, device="cpu", seq_buckets=(8, 16), max_len=32)
    for p, got in zip(rows, served):
        assert got.shape == (4,) and got.dtype == np.int32
        want = oracle.generate(p[None, :].astype(np.int64),
                               max_new_tokens=4).numpy()[0]
        np.testing.assert_array_equal(got, want)
    assert st["completed"] == 5 and st["errors"] == 0
    assert st["tokens"] == 20 and st["steady_compiles"] == 0
    assert st["ttft_p99_ms"] > 0 and st["device"] == "cpu"
    jsrv = jserving.Server(jserving.ServingConfig(workers=1))
    jsrv.register_decode("gpt", jm, **GRID)
    jsrv.start()
    try:
        jserved = [jsrv.run_decode("gpt", [p], max_new_tokens=4)[0][0]
                   for p in rows]
    finally:
        jsrv.stop()
    np.testing.assert_array_equal(np.stack(served), np.stack(jserved))


def test_concurrent_multi_row_requests(pair):
    _, pm = pair
    srv = _server(pm)
    srv.start()
    errors = []

    def client(i):
        rng = np.random.RandomState(100 + i)
        try:
            for _ in range(3):
                n = int(rng.randint(1, 3))
                ps = [rng.randint(1, V, rng.randint(1, 16))
                      for _ in range(n)]
                mn = int(rng.randint(1, 5))
                out = srv.run_decode("gpt", ps, max_new_tokens=mn)[0]
                if out.shape != (n, mn):
                    raise AssertionError(f"shape {out.shape} != ({n}, {mn})")
        except Exception as e:   # noqa: BLE001 — recorded per client
            errors.append(f"client{i}: {type(e).__name__}: {e}")

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        st = srv.stats("gpt")
        assert st["completed"] == 9 and st["errors"] == 0
        assert st["qps"] > 0 and st["p99_ms"] > 0
    finally:
        srv.stop()


def test_submit_decode_validation(pair):
    _, pm = pair
    srv = _server(pm, seq_buckets=(8,))
    srv.start()
    try:
        with pytest.raises(InvalidArgumentError):
            srv.submit_decode("gpt", [])                      # no prompts
        with pytest.raises(InvalidArgumentError):
            srv.submit_decode("gpt", [np.zeros((2, 2), np.int64)])  # 2-D
        with pytest.raises(InvalidArgumentError):
            srv.submit_decode("gpt", [np.zeros(0, np.int64)])  # empty
        with pytest.raises(InvalidArgumentError):
            srv.submit_decode("gpt", [np.ones(3, np.float32)])  # float
        with pytest.raises(OutOfRangeError):
            srv.submit_decode("gpt", [np.ones(9, np.int64)])  # > bucket 8
        with pytest.raises(InvalidArgumentError):
            srv.submit_decode("gpt", [np.ones(3, np.int64)],
                              max_new_tokens=5)               # > warmed 4
        with pytest.raises(OutOfRangeError):
            srv.submit_decode("gpt", [np.ones(2, np.int64)] * 3)  # rows
        with pytest.raises(NotFoundError):
            srv.submit_decode("nope", [np.ones(2, np.int64)])
    finally:
        srv.stop()
    with pytest.raises(PreconditionNotMetError):
        srv.submit_decode("gpt", [np.ones(2, np.int64)])      # stopped


def test_registration_guards(pair):
    _, pm = pair
    srv = serving.Server(device="cpu")
    srv.register_decode("gpt", pm, batch_buckets=(1,), seq_buckets=(8,),
                        max_new_tokens=4, max_len=32)
    with pytest.raises(InvalidArgumentError):
        srv.register_decode("gpt", pm)             # duplicate name
    with pytest.raises(InvalidArgumentError):
        srv.register_decode("other")               # no layer
    # no room for max_new under max_len: refused at start(), not traffic
    bad = serving.Server(device="cpu")
    bad.register_decode("tight", pm, batch_buckets=(1,), seq_buckets=(8,),
                        max_new_tokens=8, max_len=8)
    with pytest.raises(PreconditionNotMetError):
        bad.start()
    with pytest.raises(PreconditionNotMetError):
        serving.Server(device="cpu").start()       # nothing registered
    srv.start()
    try:
        with pytest.raises(PreconditionNotMetError):
            srv.register_decode("late", pm)        # after start()
    finally:
        srv.stop()


def test_strict_mode_vs_escape_hatch(pair):
    _, pm = pair
    srv = _server(pm, batch_buckets=(1,))
    srv.start()
    try:
        rt = srv._models["gpt"]
        rt._warmed.discard((1, 16, 32))    # a hole in the warmed grid
        with pytest.raises(PreconditionNotMetError):
            srv.run_decode("gpt", [np.ones(12, np.int64)])
        snap = flags_snapshot()
        try:
            set_flags({"FLAGS_serving_strict": False})
            out = srv.run_decode("gpt", [np.ones(12, np.int64)])[0]
            assert out.shape == (1, 4)
            assert srv.stats("gpt")["steady_compiles"] == 1
            evs = srv.compile_events_since_warmup()
            assert [(e["kind"], e["bucket"]) for e in evs] == [
                ("serving_cold_batch", 1)]
            with pytest.raises(PreconditionNotMetError,
                               match="steady-state"):
                srv.assert_zero_steady_state_recompiles()
        finally:
            flags_restore(snap)
    finally:
        srv.stop()
