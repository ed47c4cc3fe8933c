"""bench_serving's int8 half on the port, against the JAX package on the
CPU: ``save_int8_model`` and its ``jit.load`` round trip, the
Predictor's choice of the int8 program behind FLAGS_use_int8_inference
(``quant_info()``), and LeNet, bench.py's residual block (ch 8, hw 8)
and a 2-layer tiny BERT (seq 32) PTQ-calibrated as bench.py does
(bench.py:743-760), frozen, and served through export_for_serving(int8=
True) -> Server.register/start/submit by each package, one after the
other, on one carried frozen state (JAX's, through ``load_jax_state``).

Tolerances: the loaded int8 program against the eager frozen model, bit
for bit (the same operations); served int8 results against JAX's
server's within SERVED_RTOL of max(1, max |ref|) of each request.  The
codes, scales and integer products are the JAX package's, but the float
layers between the sites (the f32 epilogues, BN, pooling, attention,
LayerNorm, GELU) round an ulp apart from XLA's, and an input that then
sits within an ulp of a half step is coded one step apart at the next
site: a difference of one int8 step of that site's input scale, times
its weights.  Readings over these requests, all three models: 0 to
2.8e-7 of max(1, max |ref|); the limit leaves room for such a flip.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from chip_smoke import FLOAT_PRODUCTS, bench_block
from paddle_tpu import quantization as jq
from paddle_tpu import serving as jserving
from paddle_tpu.framework.flags import flags_restore as jflags_restore
from paddle_tpu.framework.flags import flags_snapshot as jflags_snapshot
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.text.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.models.bert import BertModel as JaxBertModel
from paddle_tpu_torch import inference, jit, serving
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.framework.flags import (flags_restore, flags_snapshot,
                                              set_flags)
from paddle_tpu_torch.static import InputSpec
from paddle_tpu_torch.text.models import BertConfig
from paddle_tpu_torch.text.models.bert import BertModel
from paddle_tpu_torch.vision.models import LeNet
from test_torch_bench_serving import _jax_block
from torch_port_util import jax_params

BUCKETS = (1, 2)
SEQ = 32                            # bench.py's CPU BERT (bench.py:837)
SERVED_RTOL = 2.0 ** -10
SPECS = {"lenet": ([None, 1, 28, 28], "float32"),
         "resnet_block": ([None, 8, 8, 8], "float32"),
         "bert": ([None, SEQ], "int32")}
ROWS = (1, 2, 1, 2)


def _input(rng, name, rows, vocab=128):
    shape, dtype = SPECS[name]
    if dtype == "int32":
        return rng.randint(0, vocab, (rows,) + tuple(shape[1:])) \
            .astype(np.int32)
    return rng.randn(rows, *shape[1:]).astype(np.float32)


def _ptq(model, name, package):
    """bench.py's calibration: 4 batches of one RandomState(0) bucket-1
    input."""
    cal = _input(np.random.RandomState(0), name, BUCKETS[0])
    wrap = jpaddle.to_tensor if package is jq else (lambda a: a)
    package.PostTrainingQuantization(
        model=model, data_loader=((wrap(cal),) for _ in range(4)),
        batch_nums=4).quantize()
    return model


def _lenet_int8(seed=0):
    torch.manual_seed(seed)
    return _ptq(LeNet(device="cpu").eval(), "lenet", pq)


def _eager(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return [o.numpy() for o in (out if isinstance(out, (list, tuple))
                                else [out])]


def test_save_int8_model_round_trip(tmp_path):
    """save_int8_model freezes a PTQ'd LeNet and writes <p>.int8.pdmodel
    and <p>.quant.json with the JAX package's keys; the loaded program
    holds one aten._int_mm node per site and no float product, and
    equals the eager frozen model bit for bit at batches 1 and 3; saving
    the frozen model again freezes nothing more."""
    m = _lenet_int8()
    prefix = str(tmp_path / "lenet")
    spec = [InputSpec([None, 1, 28, 28])]
    assert pq.save_int8_model(m, prefix, input_spec=spec) == prefix + ".int8"
    info = pq.load_quant_sidecar(prefix)
    assert set(info) == {"int8", "signature", "sites", "weight_bits",
                         "format"}
    assert info["int8"] and info["sites"] == 5 and info["weight_bits"] == 8
    assert info["format"] == "torch_export"
    assert info["signature"] == pq.quant_signature(m)
    tl = jit.load(prefix + ".int8", device="cpu")
    nodes = [str(n.target) for n in tl.program().graph.nodes
             if n.op == "call_function"]
    assert sum("_int_mm" in n for n in nodes) == 5
    assert not [n for n in nodes if FLOAT_PRODUCTS.search(n)]
    rng = np.random.RandomState(1)
    for rows in (1, 3):
        x = _input(rng, "lenet", rows)
        assert np.array_equal(tl(torch.from_numpy(x)).numpy(),
                              _eager(m, x)[0])
    pq.save_int8_model(m, prefix, input_spec=spec)
    assert pq.load_quant_sidecar(prefix) == info
    assert pq.load_quant_sidecar(str(tmp_path / "none")) is None


def test_predictor_selects_the_int8_program_behind_the_flag(tmp_path):
    """A float export and its int8 sibling at one prefix: with the flag off
    the Predictor runs the float program and quant_info() is None; with
    it on, by directory or prefix, it runs the int8 one and returns the
    sidecar; a '.int8' prefix, and an int8-only export, load as int8
    with the flag off; clones share the loaded program."""
    m = _lenet_int8()
    float_model = LeNet(device="cpu").eval()
    float_model.load_state_dict(
        {k: v for k, v in m.state_dict().items()
         if k in float_model.state_dict()}, strict=False)
    spec = [InputSpec([None, 1, 28, 28])]
    prefix = str(tmp_path / "lenet")
    jit.save(float_model, prefix, input_spec=spec)
    pq.save_int8_model(m, prefix, input_spec=spec)
    only = tmp_path / "only"          # the int8 artifact alone
    only.mkdir()
    for f in ("lenet.int8.pdmodel", "lenet.int8.pdiparams",
              "lenet.quant.json"):
        shutil.copy(tmp_path / f, only / f)
    x = _input(np.random.RandomState(2), "lenet", 2)
    frozen, dense = _eager(m, x)[0], _eager(float_model, x)[0]

    def predictor(path):
        cfg = inference.Config(path)
        cfg.disable_gpu()
        return inference.create_predictor(cfg)

    snap = flags_snapshot()
    try:
        for path in (str(tmp_path), prefix):
            p = predictor(path)
            assert p.quant_info() is None
            assert np.array_equal(p.run([x])[0], dense)
        for path in (prefix + ".int8", str(only), str(only / "lenet")):
            p = predictor(path)
            assert p.quant_info()["sites"] == 5
            assert np.array_equal(p.run([x])[0], frozen)
        set_flags({"FLAGS_use_int8_inference": True})
        for path in (str(tmp_path), prefix):
            p = predictor(path)
            assert p.quant_info() == pq.load_quant_sidecar(prefix)
            assert np.array_equal(p.run([x])[0], frozen)
            c = p.clone()
            assert c._translated is p._translated
            assert c.quant_info() == p.quant_info()
    finally:
        flags_restore(snap)
    assert not np.array_equal(frozen, dense)


def _pair(name, seed=0):
    """The model in both packages, the port's carrying JAX's weights, each
    PTQ-calibrated and frozen, then the port's carrying JAX's frozen
    state."""
    jpaddle.seed(seed)
    if name == "lenet":
        jm, pm = jpaddle.vision.models.LeNet(), LeNet(device="cpu")
    elif name == "resnet_block":
        jm, pm = _jax_block(), bench_block(8, device="cpu")
    else:
        fields = dict(num_hidden_layers=2, max_position_embeddings=SEQ)
        jm = JaxBertModel(JaxBertConfig.tiny(seq=SEQ))
        pm = BertModel(BertConfig.tiny(seq=SEQ), device="cpu")
        assert pm.config.num_hidden_layers == fields["num_hidden_layers"]
    load_jax_state(pm, jax_params(jm))
    jm.eval()
    pm.eval()
    jq.freeze(_ptq(jm, name, jq))
    pq.freeze(_ptq(pm, name, pq))
    load_jax_state(pm, jax_params(jm))
    assert pq.quant_signature(pm) == jq.quant_signature(jm)
    return jm, pm


def _serve(srv, name, reqs):
    srv.start()
    try:
        futs = [srv.submit(name, [x]) for x in reqs]
        outs = [f.result(timeout=120) for f in futs]
        return outs, srv.stats(name), srv.compile_events_since_warmup()
    finally:
        srv.stop()


@pytest.mark.parametrize("name", ["lenet", "resnet_block", "bert"])
def test_int8_served_matches_the_jax_server(tmp_path, name):
    """export_for_serving(int8=True) -> Server.register -> start -> submit
    in both packages under FLAGS_use_int8_inference, on one frozen state:
    the int8 manifest, the sidecar's site count (5, 2, 13), one capture
    event a bucket and none after, every request completed with its own
    rows, each result within SERVED_RTOL of JAX's server's, and the
    port's equal to its eager frozen model."""
    jm, pm = _pair(name)
    spec = [SPECS[name]]
    jsnap, snap = jflags_snapshot(), flags_snapshot()
    try:
        jset_flags({"FLAGS_use_int8_inference": True})
        set_flags({"FLAGS_use_int8_inference": True})
        jman = jserving.export_for_serving(jm, str(tmp_path / "jax"), spec,
                                           buckets=BUCKETS, int8=True)
        man = serving.export_for_serving(pm, str(tmp_path / "port"), spec,
                                         buckets=BUCKETS, int8=True)
        assert man["int8"] and jman["int8"] and man["mode"] == "poly"
        assert man["input_specs"] == jman["input_specs"]
        assert os.path.isfile(tmp_path / "port.int8.pdmodel")
        rng = np.random.RandomState(4)
        reqs = [_input(rng, name, rows) for rows in ROWS]
        jsrv = jserving.Server(jserving.ServingConfig(workers=1,
                                                      batch_timeout_ms=1.0))
        jsrv.register(name, str(tmp_path / "jax"), buckets=BUCKETS)
        want, jst, _ = _serve(jsrv, name, reqs)
        srv = serving.Server(serving.ServingConfig(workers=2,
                                                   batch_timeout_ms=1.0),
                             device="cpu")
        srv.register(name, str(tmp_path / "port"), buckets=BUCKETS)
        got, st, steady = _serve(srv, name, reqs)
    finally:
        jflags_restore(jsnap)
        flags_restore(snap)
    sites = {"lenet": 5, "resnet_block": 2, "bert": 13}[name]
    assert srv._models[name].primary.quant_info()["sites"] == sites
    assert st["completed"] == jst["completed"] == len(reqs)
    assert st["errors"] == 0 and steady == []
    assert [(e["kind"], e["bucket"]) for e in srv._models[name].events] \
        == [("serving_capture", b) for b in BUCKETS]
    for x, g, w in zip(reqs, got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == np.float32 and a.shape == b.shape
            assert a.shape[0] == len(x)
            err = np.abs(a - b).max() / max(1.0, np.abs(b).max())
            assert err <= SERVED_RTOL, err
        for a, b in zip(g, _eager(pm, x)):
            assert np.array_equal(a, b)
