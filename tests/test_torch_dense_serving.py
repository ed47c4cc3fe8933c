"""The port's dense serving path on the CPU: export_for_serving ->
Server.register -> start -> submit/run, against the JAX package's Server
on the same seeded requests and bridged weights, and the JAX serving
tests' invariants (tests/test_serving.py) on the port.

Tolerances: a tiny BERT (2 layers, hidden 32, seq 32) in f32 served by
both packages at tests/test_torch_bert.py's tiny-width limits (atol 2e-5,
rtol 1e-4); an MLP served against its eager module at the JAX serving
tests' limits (rtol 1e-5, atol 1e-6: the padded bucket's GEMM may sum in
another order than the request's own rows).  On the CPU nothing is
captured: warm-up runs each bucket once and records one capture event a
bucket, so the zero-steady-state check holds here too.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jax_serving
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.enforce import (InvalidArgumentError,
                                                NotFoundError,
                                                OutOfRangeError,
                                                PreconditionNotMetError,
                                                UnavailableError,
                                                UnimplementedError)
from paddle_tpu_torch.static import InputSpec
from torch_port_util import bert_model_pair, gpt_pair, prompts

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=32)
SEQ = 32
BUCKETS = (1, 2, 4)
TOL = dict(atol=2e-5, rtol=1e-4)
MLP_TOL = dict(rtol=1e-5, atol=1e-6)


def _server(workers=2, **kw):
    return serving.Server(serving.ServingConfig(workers=workers, **kw),
                          device="cpu")


def _export_mlp(tmp_path, name="m", in_dim=6, out_dim=3, buckets=BUCKETS):
    torch.manual_seed(len(name) + in_dim)
    net = torch.nn.Sequential(torch.nn.Linear(in_dim, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, out_dim)).eval()
    prefix = str(tmp_path / name)
    manifest = serving.export_for_serving(
        net, prefix, [InputSpec([None, in_dim])], buckets=buckets)
    return net, prefix, manifest


def _eager(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _serve_stream(srv, reqs):
    """Start ``srv``, serve ``reqs`` (one model input each) and stop it:
    [(outputs, bucket, batch rows)] and the server's stats and events."""
    srv.start()
    try:
        futs = [srv.submit("bert", [x]) for x in reqs]
        got = [(f.result(timeout=60), getattr(f, "bucket", None),
                getattr(f, "batch_rows", None)) for f in futs]
        return got, srv.stats("bert"), srv.compile_events_since_warmup()
    finally:
        srv.stop()


def test_served_bert_stream_matches_the_jax_server(tmp_path):
    """Six mixed-row requests through the JAX package's Server, then the
    same through the port's: each result against its JAX counterpart,
    rows exact, one warm-up capture a bucket and none after."""
    jm, pm = bert_model_pair(0, TINY)
    spec = [([None, SEQ], "int32")]
    buckets = (1, 2)      # each JAX bucket is one more program to compile
    jman = jax_serving.export_for_serving(jm, str(tmp_path / "jax"), spec,
                                          buckets=buckets)
    man = serving.export_for_serving(pm, str(tmp_path / "port"), spec,
                                     buckets=buckets)
    # torch.export keeps the batch symbolic through BERT; JAX's export
    # falls back to one program a bucket (ROADMAP queue C)
    assert man["mode"] == "poly" and jman["mode"] == "per_bucket"
    assert man["input_specs"] == jman["input_specs"]
    rng = np.random.RandomState(0)
    reqs = [rng.randint(0, TINY["vocab_size"], (rows, SEQ)).astype(np.int32)
            for rows in (1, 2, 2, 1, 1, 2)]
    jsrv = jax_serving.Server(jax_serving.ServingConfig(
        workers=1, batch_timeout_ms=1.0))
    jsrv.register("bert", str(tmp_path / "jax"), buckets=buckets)
    want, _, _ = _serve_stream(jsrv, reqs)
    srv = _server(workers=2, batch_timeout_ms=1.0)
    srv.register("bert", str(tmp_path / "port"), buckets=buckets)
    got, st, steady = _serve_stream(srv, reqs)
    for x, (g, bucket, rows), (w, _, _) in zip(reqs, got, want):
        assert [o.shape for o in g] == [(len(x), SEQ, 32), (len(x), 32)]
        assert bucket in buckets and len(x) <= rows <= bucket
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, **TOL)
    assert st["completed"] == len(reqs) and st["errors"] == 0
    assert st["backend"] == "jit" and st["captured"] is False
    assert [(e["kind"], e["bucket"]) for e in srv._models["bert"].events] \
        == [("serving_capture", b) for b in buckets]
    assert steady == []


@pytest.mark.parametrize("depth", [1, 2])
def test_serving_e2e_mixed_rows(tmp_path, depth):
    """test_serving.py:137 on the port, at pipeline depth 1 and 2: every
    result has its own rows and matches the eager model."""
    net, prefix, manifest = _export_mlp(tmp_path, "e2e")
    assert manifest["mode"] == "poly"
    srv = _server(batch_timeout_ms=1.0, pipeline_depth=depth)
    srv.register("e2e", prefix, buckets=BUCKETS)
    srv.start()
    try:
        rng = np.random.RandomState(depth)
        xs = [rng.randn(int(rng.randint(1, 5)), 6).astype("float32")
              for _ in range(24)]
        futs = [srv.submit("e2e", [x]) for x in xs]
        for f, x in zip(futs, xs):
            out = f.result(timeout=60)
            assert out[0].shape == (len(x), 3)
            np.testing.assert_allclose(out[0], _eager(net, x), **MLP_TOL)
        st = srv.stats("e2e")
        assert st["completed"] == 24 and st["errors"] == 0
        assert st["steady_compiles"] == 0
        assert sorted(e["bucket"] for e in srv._models["e2e"].events) == \
            list(BUCKETS)
        srv.assert_zero_steady_state_recompiles()
    finally:
        srv.stop()


def test_serving_continuous_batching_coalesces(tmp_path):
    _, prefix, _ = _export_mlp(tmp_path, "co")
    srv = _server(workers=1, batch_timeout_ms=250.0)
    srv.register("co", prefix, buckets=BUCKETS)
    srv.start()
    try:
        futs = [srv.submit("co", [np.random.randn(1, 6).astype("float32")])
                for _ in range(4)]
        for f in futs:
            f.result(timeout=60)
        st = srv.stats("co")
        assert st["completed"] == 4
        assert st["batches"] < 4          # coalesced, not one by one
        assert st["avg_batch_rows"] > 1.0
    finally:
        srv.stop()


class _Eye(torch.nn.Module):
    """Reads its batch size as a Python int (torch.eye(int(n))): the
    export specializes the batch dim, so export_for_serving falls back
    to one program a bucket."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 2)

    def forward(self, x):
        eye = torch.eye(int(x.shape[0]))
        return self.fc(x) + eye[:, :1] * 0


def test_serving_per_bucket_fallback(tmp_path):
    torch.manual_seed(0)
    m = _Eye().eval()
    prefix = str(tmp_path / "mk")
    manifest = serving.export_for_serving(
        m, prefix, [InputSpec([None, 4])], buckets=(1, 2))
    assert manifest["mode"] == "per_bucket"
    assert (tmp_path / "mk.b1.pdmodel").exists()
    assert (tmp_path / "mk.b2.pdmodel").exists()
    srv = _server(workers=1)
    srv.register("mask", prefix, buckets=(1, 2))
    srv.start()
    try:
        assert srv.stats("mask")["backend"] == "jit_per_bucket"
        for rows in (1, 2, 1):
            xv = np.random.randn(rows, 4).astype("float32")
            np.testing.assert_allclose(srv.run("mask", [xv])[0],
                                       _eager(m, xv), **MLP_TOL)
        srv.assert_zero_steady_state_recompiles()
    finally:
        srv.stop()


def test_dense_and_decode_models_in_one_registry(tmp_path):
    """Two dense tenants and a decode model on one Server: shared
    scheduler and workers, each admitted and correct; submit() refuses the
    decode model and submit_decode() the dense one."""
    net_a, prefix_a, _ = _export_mlp(tmp_path, "a", in_dim=5, out_dim=2)
    net_b, prefix_b, _ = _export_mlp(tmp_path, "b", in_dim=7, out_dim=4,
                                     buckets=(1, 2))
    _, gpt = gpt_pair(1)
    srv = _server()
    srv.register("a", prefix_a, buckets=BUCKETS)
    srv.register("b", prefix_b, buckets=(1, 2))
    srv.register_decode("gpt", gpt, batch_buckets=(1, 2), seq_buckets=(16,),
                        max_len=32, max_new_tokens=4)
    with pytest.raises(InvalidArgumentError, match="already registered"):
        srv.register("a", prefix_a)
    srv.start()
    try:
        assert sorted(srv.models()) == ["a", "b", "gpt"]
        xa = np.random.randn(3, 5).astype("float32")
        xb = np.random.randn(2, 7).astype("float32")
        fa_, fb = srv.submit("a", [xa]), srv.submit("b", [xb])
        fg = srv.submit_decode("gpt", prompts(2, [5, 9], 64))
        np.testing.assert_allclose(fa_.result(60)[0], _eager(net_a, xa),
                                   **MLP_TOL)
        np.testing.assert_allclose(fb.result(60)[0], _eager(net_b, xb),
                                   **MLP_TOL)
        assert fg.result(60)[0].shape == (2, 4)
        with pytest.raises(InvalidArgumentError, match="decode model"):
            srv.submit("gpt", [xa])
        with pytest.raises(InvalidArgumentError, match="not a decode"):
            srv.submit_decode("a", prompts(3, [4], 64))
        assert set(srv.stats()) == {"a", "b", "gpt"}
        assert srv.signals()["steady_compiles"] == 0
        srv.assert_zero_steady_state_recompiles()
        with pytest.raises(PreconditionNotMetError):
            srv.register("c", prefix_a)      # the registry is sealed
    finally:
        srv.stop()


def test_serving_submit_validation(tmp_path):
    _, prefix, _ = _export_mlp(tmp_path, "val")
    srv = _server(workers=1)
    srv.register("val", prefix, buckets=(1, 2))
    with pytest.raises(PreconditionNotMetError):
        srv.submit("val", [np.zeros((1, 6), "float32")])   # not started
    srv.start()
    try:
        with pytest.raises(NotFoundError):
            srv.submit("nope", [np.zeros((1, 6), "float32")])
        with pytest.raises(InvalidArgumentError, match="takes 1 inputs"):
            srv.submit("val", [np.zeros((1, 6), "float32")] * 2)
        with pytest.raises(InvalidArgumentError, match="served shape"):
            srv.submit("val", [np.zeros((1, 7), "float32")])
        with pytest.raises(InvalidArgumentError, match="0 rows"):
            srv.submit("val", [np.zeros((0, 6), "float32")])
        with pytest.raises(OutOfRangeError):
            srv.submit("val", [np.zeros((3, 6), "float32")])  # > max bucket
        # dtype is pinned, not trusted: float64 requests serve as float32
        out = srv.run("val", [np.zeros((1, 6), "float64")])
        assert out[0].dtype == np.float32
        srv.assert_zero_steady_state_recompiles()
    finally:
        srv.stop()


def test_serving_strict_refuses_a_late_bucket(tmp_path):
    """A bucket that lost its executable fails in strict mode; otherwise
    it is built at steady state and recorded, and the check fails."""
    _, prefix, _ = _export_mlp(tmp_path, "strict")
    srv = _server(workers=1)
    srv.register("strict", prefix, buckets=(1, 2))
    srv.start()
    try:
        srv._models["strict"].executables.pop(2)   # a lost bucket
        with pytest.raises(PreconditionNotMetError, match="no warm-up"):
            srv.submit("strict",
                       [np.zeros((2, 6), "float32")]).result(timeout=60)
        snap = tflags.flags_snapshot()
        try:
            tflags.set_flags({"FLAGS_serving_strict": False})
            assert srv.run("strict", [np.zeros((2, 6), "float32")])[0] \
                .shape == (2, 3)
        finally:
            tflags.flags_restore(snap)
        assert srv.stats("strict")["steady_compiles"] == 1
        evs = srv.compile_events_since_warmup()
        assert len(evs) == 1 and evs[0]["kind"] == "serving_recapture"
        with pytest.raises(PreconditionNotMetError,
                           match="steady-state recompile"):
            srv.assert_zero_steady_state_recompiles()
    finally:
        srv.stop()


def test_serving_stop_without_drain_fails_pending(tmp_path):
    _, prefix, _ = _export_mlp(tmp_path, "drain")
    srv = _server(workers=1, batch_timeout_ms=500.0)
    srv.register("drain", prefix, buckets=BUCKETS)
    srv.start()
    try:
        fut = srv.submit("drain", [np.zeros((1, 6), "float32")])
        srv.stop(drain=False)
        # either it slipped into a batch before the drain or it failed —
        # never hangs, never leaks a pending future
        try:
            assert fut.result(timeout=10)[0].shape == (1, 3)
        except UnavailableError:
            pass
        with pytest.raises(PreconditionNotMetError):
            srv.submit("drain", [np.zeros((1, 6), "float32")])
    finally:
        srv.stop()


def test_unported_serving_options_raise(tmp_path):
    """The graph-lint admission gate is not ported; an int8 export of a
    model with no quantized site raises, as the JAX package's freeze
    does."""
    net, prefix, _ = _export_mlp(tmp_path, "lint")
    snap = tflags.flags_snapshot()
    srv = _server(workers=1)
    srv.register("lint", prefix, buckets=(1,))
    try:
        tflags.set_flags({"FLAGS_graph_lint": "warn"})
        with pytest.raises(UnimplementedError, match="graph-lint"):
            srv.start()
    finally:
        srv.stop()
        tflags.flags_restore(snap)
    with pytest.raises(ValueError, match="no Quantized"):
        serving.export_for_serving(net, str(tmp_path / "q"),
                                   [InputSpec([None, 6])], int8=True)
