"""bench.py's bench_serving models on the port, against the JAX package
on the CPU: LeNet (``vision.models``) and bench.py's residual Block
(``chip_smoke.bench_block``, bench.py:843-856) at bench.py's CPU widths
(ch 8, hw 8), built in both packages, the JAX weights (BN's running
statistics drawn away from their defaults) carried across with
``load_jax_state``; then exported (``export_for_serving``) and served
(``Server.register``/``start``/``submit``) by each package on the same
seeded requests, one server after the other, in f32 and in bench.py's
bf16 form (``amp.decorate`` O2 behind ``_BF16Serve``,
``chip_smoke.bf16_serve`` on the port).

Tolerances: eager f32 rtol 1e-5 / atol 1e-6 (the JAX package's own eager
limits); served f32 atol 2e-5 / rtol 1e-4 (tests/test_torch_dense_
serving.py's); served bf16 against JAX's served bf16 within 2^-6 of
max(1, max |ref|) of each request (chip_smoke.py's DENSE_RTOL: a bf16
conv or GEMM may sum in another order than XLA's and round one step
apart).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from chip_smoke import DENSE_RTOL, bench_block, bf16_serve
from paddle_tpu import nn as jnn
from paddle_tpu import serving as jserving
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.vision.models import LeNet
from torch_port_util import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CH, HW = 8, 8                       # bench.py's CPU branch (bench.py:836)
BUCKETS = (1, 2)                    # each JAX bucket is a program to build
EAGER_TOL = dict(rtol=1e-5, atol=1e-6)
SERVED_TOL = dict(atol=2e-5, rtol=1e-4)
SPECS = {"lenet": ([None, 1, 28, 28], "float32"),
         "resnet_block": ([None, CH, HW, HW], "float32")}
ROWS = (1, 2, 1, 2, 1)              # the requests' rows: batches of <= 4


def _jax_block():
    """bench.py's Block (bench.py:843-856) in the JAX package."""
    class Block(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.c1 = jnn.Conv2D(CH, CH, 3, padding=1, bias_attr=False)
            self.b1 = jnn.BatchNorm2D(CH)
            self.c2 = jnn.Conv2D(CH, CH, 3, padding=1, bias_attr=False)
            self.b2 = jnn.BatchNorm2D(CH)
            self.relu = jnn.ReLU()

        def forward(self, x):
            h = self.relu(self.b1(self.c1(x)))
            return self.relu(self.b2(self.c2(h)) + x)

    return Block()


def _jax_bf16_serve(inner):
    """bench.py's _BF16Serve (bench.py:769-781) in the JAX package."""
    class _BF16Serve(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = inner

        def forward(self, *xs):
            xs = [jpaddle.cast(x, "bfloat16")
                  if "float" in str(x.dtype) else x for x in xs]
            return jpaddle.cast(self.inner(*xs), "float32")

    m = _BF16Serve()
    m.eval()
    return m


def _pair(name, seed=0):
    """The model ``name`` in both packages in eval mode, the port's on the
    CPU carrying the JAX weights; BN's parameters and running statistics
    are drawn from ``seed`` first, so that the eval BN does some work."""
    jpaddle.seed(seed)
    if name == "lenet":
        jm, pm = jpaddle.vision.models.LeNet(), LeNet(device="cpu")
    else:
        jm, pm = _jax_block(), bench_block(CH, device="cpu")
        rng = np.random.RandomState(seed + 1)
        for bn in (jm.b1, jm.b2):
            bn.weight.set_value(rng.uniform(0.5, 1.5, CH).astype("float32"))
            bn.bias.set_value(rng.randn(CH).astype("float32") * 0.1)
            bn._mean.set_value(rng.randn(CH).astype("float32") * 0.1)
            bn._variance.set_value(rng.uniform(0.5, 2.0, CH)
                                   .astype("float32"))
    assert list(pm.state_dict()) == list(jm.state_dict())
    load_jax_state(pm, jax_params(jm))
    jm.eval()
    pm.eval()
    return jm, pm


def _requests(name, seed):
    rng = np.random.RandomState(seed)
    shape = SPECS[name][0][1:]
    return [rng.randn(rows, *shape).astype(np.float32) for rows in ROWS]


@pytest.mark.parametrize("name", ["lenet", "resnet_block"])
def test_eager_model_matches_jax(name):
    """The f32 eager forward of each model at batch 3 against JAX's."""
    jm, pm = _pair(name, seed=2)
    x = np.random.RandomState(3).randn(3, *SPECS[name][0][1:]) \
        .astype(np.float32)
    want = jm(jpaddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((3, 10) if name == "lenet"
                                       else (3, CH, HW, HW))
    np.testing.assert_allclose(got, want, **EAGER_TOL)


def _serve(srv, name, reqs):
    """Start ``srv``, send ``reqs`` one model input each, and stop it:
    (outputs, stats, steady-state captures)."""
    srv.start()
    try:
        futs = [srv.submit(name, [x]) for x in reqs]
        outs = [f.result(timeout=120)[0] for f in futs]
        return outs, srv.stats(name), srv.compile_events_since_warmup()
    finally:
        srv.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["lenet", "resnet_block"])
def test_served_model_matches_the_jax_server(tmp_path, name, dtype):
    """export_for_serving -> Server.register -> start -> submit in both
    packages, in f32 and in bench.py's bf16 form: the same manifest
    specs, one poly program in the port, each result with its own rows
    and against the JAX server's on the same request, one capture event
    a bucket at warm-up and none after, every request completed."""
    jm, pm = _pair(name)
    if dtype == "bfloat16":
        jpaddle.amp.decorate(models=jm, level="O2", dtype="bfloat16")
        import paddle_tpu_torch as paddle
        paddle.amp.decorate(models=pm, level="O2", dtype="bfloat16")
        assert {b.dtype for b in pm.buffers()} <= {torch.float32}
        jm, pm = _jax_bf16_serve(jm), bf16_serve(pm)
    spec = [SPECS[name]]
    jman = jserving.export_for_serving(jm, str(tmp_path / "jax"), spec,
                                       buckets=BUCKETS)
    man = serving.export_for_serving(pm, str(tmp_path / "port"), spec,
                                     buckets=BUCKETS)
    assert man["mode"] == "poly" and man["input_specs"] == \
        jman["input_specs"]
    reqs = _requests(name, seed=4)
    jsrv = jserving.Server(jserving.ServingConfig(workers=1,
                                                  batch_timeout_ms=1.0))
    jsrv.register(name, str(tmp_path / "jax"), buckets=BUCKETS)
    want, jst, _ = _serve(jsrv, name, reqs)
    srv = serving.Server(serving.ServingConfig(workers=2,
                                               batch_timeout_ms=1.0),
                         device="cpu")
    srv.register(name, str(tmp_path / "port"), buckets=BUCKETS)
    got, st, steady = _serve(srv, name, reqs)
    assert st["completed"] == jst["completed"] == len(reqs)
    assert st["errors"] == 0 and steady == []
    assert [(e["kind"], e["bucket"]) for e in srv._models[name].events] \
        == [("serving_capture", b) for b in BUCKETS]
    for x, g, w in zip(reqs, got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert g.shape[0] == len(x)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **SERVED_TOL)
        else:
            err = np.abs(g - w).max() / max(1.0, np.abs(w).max())
            assert err <= DENSE_RTOL, err


def test_bf16_serve_casts_floats_and_passes_ids():
    """chip_smoke.bf16_serve is bench.py's _BF16Serve: an nn.Layer in
    eval mode whose inner model sees bf16 floats and untouched int ids,
    and whose outputs (one or a list) come back in f32."""
    import paddle_tpu_torch as paddle

    class Probe(paddle.nn.Layer):
        def forward(self, x, ids):
            self.seen = (x.dtype, ids.dtype)
            return [x * 2, ids.float()]

    m = bf16_serve(Probe())
    assert isinstance(m, paddle.nn.Layer) and not m.training
    x = torch.tensor([[1.0, 1.0 + 2.0 ** -10]])
    out = m(x, torch.tensor([[3, 4]], dtype=torch.int32))
    assert m.inner.seen == (torch.bfloat16, torch.int32)
    assert [o.dtype for o in out] == [torch.float32, torch.float32]
    assert out[0].tolist() == [[2.0, 2.0]]       # rounded through bf16
    one = bf16_serve(paddle.nn.ReLU())(torch.tensor([-1.0, 3.0]))
    assert one.dtype == torch.float32 and one.tolist() == [0.0, 3.0]


def test_top_level_reaches_the_ported_subpackages():
    """After ``import paddle_tpu_torch as paddle`` alone, with JAX and the
    JAX package unimportable, bench.py's names resolve:
    paddle.amp.decorate, paddle.vision.models.LeNet, paddle.serving,
    paddle.jit, paddle.inference, paddle.text, paddle.distributed,
    paddle.profiler, paddle.cast, paddle.ParamAttr and nn.Layer."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import paddle_tpu_torch as paddle\n"
            "assert callable(paddle.amp.decorate)\n"
            "assert paddle.vision.models.LeNet and paddle.serving.Server\n"
            "assert paddle.jit.save and paddle.inference.Config\n"
            "assert paddle.text and paddle.distributed and paddle.profiler\n"
            "assert paddle.cast and paddle.ParamAttr and paddle.nn.Layer\n"
            "assert paddle.nn.Sequential and paddle.nn.LayerList\n"
            "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "ok"
