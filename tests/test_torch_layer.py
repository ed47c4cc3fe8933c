"""The port's Paddle ``nn`` machinery (``nn.Layer``, the containers,
``Conv2D``/``BatchNorm2D`` parameter attributes) against the JAX
package's on the CPU: the same layer trees built in both, names and
``state_dict`` keys compared as lists, weights carried across by
``load_jax_state`` or ``set_state_dict``, the same seeded numpy inputs
through both.  Tolerances: an f32 forward rtol 1e-5 / atol 1e-6 (the
JAX package's own eager limits); a weight set by an initializer, a dtype
or a name exactly.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.framework.enforce import PreconditionNotMetError
from torch_port_util import jax_params

F32 = dict(rtol=1e-5, atol=1e-6)


def _tree(m, **kw):
    """One layer tree in package ``m`` (JAX's or the port's ``nn``):
    every container, a conv, a BN, a Linear and a parameter of its own."""

    class Net(m.Layer):
        def __init__(self):
            super().__init__()
            self.body = m.Sequential(
                m.Conv2D(2, 4, 3, padding=1, **kw), m.BatchNorm2D(4, **kw),
                m.ReLU())
            self.heads = m.LayerList([m.Linear(4, 3, **kw),
                                      m.Linear(3, 2, **kw)])
            self.extra = m.LayerDict(collections.OrderedDict(
                [("pool", m.MaxPool2D(2, 2)), ("act", m.ReLU())]))
            self.scale = self.create_parameter(
                [2], default_initializer=m.initializer.Constant(2.0), **kw)

        def forward(self, x):
            h = self.extra["pool"](self.body(x))
            h = h.mean(axis=[2, 3]) if hasattr(h, "_value") \
                else h.mean(dim=(2, 3))
            for layer in self.heads:
                h = layer(h)
            return self.extra["act"](h) * self.scale

    return Net()


def _pair(seed=0):
    jpaddle.seed(seed)
    jm = _tree(jnn)
    pm = _tree(nn, device="cpu")
    load_jax_state(pm, jax_params(jm))
    return jm, pm


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jrun(jm, x):
    return jm(jpaddle.to_tensor(x)).numpy()


def _prun(pm, x):
    with torch.no_grad():
        return pm(torch.from_numpy(x)).numpy()


def test_layer_names_and_state_dict_keys_match_jax():
    """named_parameters, named_buffers, state_dict (parameters first, then
    the persistable buffers), named_sublayers, children and full_name are
    the JAX package's, name for name and in order; the forward agrees."""
    jm, pm = _pair()
    assert [n for n, _ in pm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert [n for n, _ in pm.named_buffers()] == \
        [n for n, _ in jm.named_buffers()]
    assert list(pm.state_dict()) == list(jm.state_dict())
    assert list(pm.state_dict(include_sublayers=False)) == \
        list(jm.state_dict(include_sublayers=False)) == ["scale"]
    assert list(pm.state_dict(structured_name_prefix="net.")) == \
        list(jm.state_dict(structured_name_prefix="net."))
    assert [n for n, _ in pm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert [type(l).__name__ for l in pm.sublayers(include_self=True)] == \
        [type(l).__name__ for l in jm.sublayers(include_self=True)]
    assert len(list(pm.children())) == len(list(jm.children())) == 3
    assert pm.full_name() == jm.full_name() == "net"
    assert isinstance(pm.parameters(), list) and len(pm.parameters()) == \
        len(jm.parameters())
    assert len(pm.parameters(include_sublayers=False)) == 1
    x = _x(1, 2, 2, 6, 6)
    np.testing.assert_allclose(_prun(pm, x), _jrun(jm, x), **F32)


def test_set_state_dict_takes_jax_values_and_names_what_is_off():
    """set_state_dict copies values by name (JAX tensors, numpy arrays or
    torch tensors) and returns the missing and unexpected names as JAX's
    does; a shape that differs raises before the tensor is written."""
    jpaddle.seed(3)
    jb = jnn.Sequential(jnn.Conv2D(2, 3, 3), jnn.BatchNorm2D(3))
    pb = nn.Sequential(nn.Conv2D(2, 3, 3, device="cpu"),
                       nn.BatchNorm2D(3, device="cpu"))
    sd = dict(jb.state_dict())
    sd["1._mean"] = jpaddle.to_tensor(_x(2, 3))
    jb.set_state_dict({"1._mean": sd["1._mean"]})
    part = {k: v for k, v in sd.items() if k != "1.bias"}
    part["ghost"] = np.zeros(3, np.float32)
    jmiss, jextra = jb.set_state_dict(part)
    pmiss, pextra = pb.set_state_dict(part)
    assert (pmiss, pextra) == (jmiss, jextra) == (["1.bias"], ["ghost"])
    for name, t in pb.state_dict().items():
        if name != "1.bias":
            np.testing.assert_array_equal(t.numpy(), np.asarray(
                jb.state_dict()[name].numpy()), err_msg=name)
    pb.set_state_dict({"1.bias": torch.full((3,), 0.25)})
    assert torch.equal(pb[1].bias, torch.full((3,), 0.25))
    with pytest.raises(ValueError, match="1.weight"):
        pb.set_state_dict({"1.weight": np.ones(4, np.float32)})


def test_forward_hooks_match_jax():
    """A pre-hook that scales the input and a post-hook that shifts the
    output change the forward as in JAX; removed, they change nothing."""
    jm, pm = _pair(5)
    x = _x(6, 2, 2, 6, 6)
    handles = []
    for m in (jm, pm):
        handles.append(m.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2.0,)))
        handles.append(m.register_forward_post_hook(
            lambda layer, inputs, out: out + 1.0))
    hooked = _jrun(jm, x)
    np.testing.assert_allclose(_prun(pm, x), hooked, **F32)
    for h in handles:
        h.remove()
    plain = _jrun(jm, x)
    assert not np.allclose(plain, hooked)
    np.testing.assert_allclose(_prun(pm, x), plain, **F32)


def test_train_eval_reach_every_sublayer_and_bn_matches_jax():
    """train()/eval() set every sublayer's flag; a train-mode forward
    normalizes with the batch statistics and moves the running ones as
    JAX's does, an eval-mode forward reads them."""
    jm, pm = _pair(7)
    for m in (jm, pm):
        m.eval()
    assert not any(l.training for l in pm.sublayers(include_self=True))
    for m in (jm, pm):
        m.train()
    assert all(l.training for l in pm.sublayers(include_self=True))
    x = _x(8, 4, 2, 6, 6)
    np.testing.assert_allclose(_prun(pm, x), _jrun(jm, x), **F32)
    jbn, pbn = jm.body[1], pm.body[1]
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(pbn, name).numpy(),
                                   getattr(jbn, name).numpy(), **F32)
    for m in (jm, pm):
        m.eval()
    np.testing.assert_allclose(_prun(pm, x), _jrun(jm, x), **F32)


def test_containers_match_jax():
    """Each container's indexing, slicing, length, iteration, mutation
    and child names against JAX's."""
    for kind in ("sequential", "layerlist", "layerdict", "parameterlist"):
        _containers_match_jax(kind)


def _containers_match_jax(kind):
    def build(m, **kw):
        if kind == "sequential":
            a = m.Sequential(m.Linear(4, 4, **kw), m.ReLU(),
                             m.Linear(4, 2, **kw))
            b = m.Sequential(collections.OrderedDict(
                [("fc", m.Linear(2, 2, **kw)), ("act", m.ReLU())]))
            c = m.Sequential(("first", m.Linear(2, 3, **kw)))
            return [a, b, c, a[1:], a[-1]]
        if kind == "layerlist":
            ll = m.LayerList([m.Linear(2, 2, **kw)])
            ll.append(m.Linear(2, 3, **kw))
            ll.insert(0, m.ReLU())
            ll.extend([m.Linear(3, 1, **kw)])
            return [ll, ll[-1], ll[1:3]]
        if kind == "layerdict":
            ld = m.LayerDict({"a": m.Linear(2, 2, **kw)})
            ld.update([("b", m.ReLU()), ("c", m.Linear(2, 1, **kw))])
            ld["d"] = m.ReLU()
            ld.pop("b")
            return [ld]
        w = [m.Linear(2, 2, **kw).weight for _ in range(2)]
        pl = m.ParameterList(w[:1])
        pl.append(w[1])
        return [pl]

    jpaddle.seed(11)
    jouts = build(jnn)
    pouts = build(nn, device="cpu")
    for j, p in zip(jouts, pouts):
        assert type(p).__name__ == type(j).__name__
        if hasattr(j, "__len__"):
            assert len(p) == len(j)
        assert [n for n, _ in p.named_parameters()] == \
            [n for n, _ in j.named_parameters()]
        assert list(p.state_dict()) == list(j.state_dict())
    if kind == "layerdict":
        (j,), (p,) = jouts, pouts
        assert list(p.keys()) == list(j.keys()) == ["a", "c", "d"]
        assert list(p) == list(j) and ("b" in p) == ("b" in j) is False
    if kind == "sequential":
        a, pa = jouts[0], pouts[0]
        load_jax_state(pa, jax_params(a))
        x = _x(12, 3, 4)
        np.testing.assert_allclose(_prun(pa, x), _jrun(a, x), **F32)
        assert type(pa["1"]).__name__ == type(pa[1]).__name__ == "ReLU"


def test_conv2d_weight_attr_initializer_matches_jax():
    """Conv2D(2, 3, 3, weight_attr=ParamAttr(initializer=Constant(0.5)))
    holds 0.5 everywhere and a zero bias, as JAX's does, and computes what
    JAX's computes; bias_attr=False gives no bias in both; an initializer
    or a name alone is taken as JAX takes it."""
    pc = nn.Conv2D(2, 3, 3, weight_attr=nn.ParamAttr(
        initializer=nn.initializer.Constant(0.5)), device="cpu")
    jc = jnn.Conv2D(2, 3, 3, weight_attr=jpaddle.ParamAttr(
        initializer=jnn.initializer.Constant(0.5)))
    assert torch.equal(pc.weight, torch.full((3, 2, 3, 3), 0.5))
    assert torch.equal(pc.bias, torch.zeros(3))
    np.testing.assert_array_equal(pc.weight.detach().numpy(),
                                  jc.weight.numpy())
    x = _x(13, 2, 2, 5, 5)
    np.testing.assert_allclose(_prun(pc, x), _jrun(jc, x), **F32)
    pn = nn.Conv2D(2, 3, 3, bias_attr=False,
                   weight_attr=nn.initializer.Constant(-1.0), device="cpu")
    jn = jnn.Conv2D(2, 3, 3, bias_attr=False,
                    weight_attr=jnn.initializer.Constant(-1.0))
    assert pn.bias is None and jn.bias is None
    assert list(pn.state_dict()) == list(jn.state_dict()) == ["weight"]
    np.testing.assert_allclose(_prun(pn, x), _jrun(jn, x), **F32)
    frozen = nn.Conv2D(2, 3, 3, bias_attr=nn.ParamAttr(
        initializer=nn.initializer.Constant(0.1), trainable=False),
        device="cpu")
    assert not frozen.bias.requires_grad and frozen.weight.requires_grad
    assert torch.allclose(frozen.bias, torch.full((3,), 0.1))


@pytest.mark.parametrize("attr", ["bias_attr", "weight_attr"])
def test_batchnorm2d_without_a_parameter_matches_jax(attr):
    """BatchNorm2D(3, bias_attr=False) has no bias (weight_attr=False no
    weight) and the state_dict keys of JAX's layer.  JAX's functional
    reads both parameters and raises on the missing one, so the forward
    is held to JAX's layer with that parameter at its identity value
    (bias zeros, weight ones), in eval and in train mode."""
    pbn = nn.BatchNorm2D(3, device="cpu", **{attr: False})
    jbn = jnn.BatchNorm2D(3, **{attr: False})
    name = attr.split("_")[0]
    assert getattr(pbn, name) is None and getattr(jbn, name) is None
    assert list(pbn.state_dict()) == list(jbn.state_dict())
    jpaddle.seed(14)
    ref = jnn.BatchNorm2D(3)
    other = "weight" if name == "bias" else "bias"
    getattr(ref, other).set_value(_x(15, 3))
    ref._mean.set_value(_x(16, 3))
    ref._variance.set_value(np.abs(_x(17, 3)) + 0.5)
    state = {k: v for k, v in jax_params(ref).items()
             if not k.startswith(name)}
    pbn.set_state_dict(state)
    x = _x(18, 4, 3, 5, 5)
    for mode in ("eval", "train"):
        getattr(pbn, mode)()
        getattr(ref, mode)()
        np.testing.assert_allclose(_prun(pbn, x), _jrun(ref, x), **F32)
    np.testing.assert_allclose(pbn._mean.numpy(), ref._mean.numpy(), **F32)
    with pytest.raises(AttributeError):
        jbn(jpaddle.to_tensor(x))


def test_create_parameter_matches_jax():
    """Layer.create_parameter: the attribute's initializer, else the
    default one, else zeros for a bias and Xavier-uniform (within JAX's
    bound) for a weight; attr=False gives None; dtype names as JAX's."""
    pl, jl = nn.Layer(), jnn.Layer()
    kw = dict(device="cpu")
    for args in (dict(shape=[2, 3], attr=nn.ParamAttr(
                     initializer=nn.initializer.Constant(0.75))),
                 dict(shape=[4], is_bias=True),
                 dict(shape=[3], default_initializer=nn.initializer.Constant(
                     -2.0)),
                 dict(shape=[2, 2], dtype="bfloat16",
                      default_initializer=nn.initializer.Constant(1.5))):
        jargs = dict(args)
        if "attr" in jargs:
            jargs["attr"] = jpaddle.ParamAttr(
                initializer=jnn.initializer.Constant(0.75))
        if "default_initializer" in jargs:
            jargs["default_initializer"] = jnn.initializer.Constant(
                args["default_initializer"].value)
        p, j = pl.create_parameter(**args, **kw), jl.create_parameter(**jargs)
        assert isinstance(p, torch.nn.Parameter)
        assert tuple(p.shape) == tuple(j.shape)
        assert str(p.dtype).split(".")[-1] == str(j.dtype).split(".")[-1]
        np.testing.assert_array_equal(p.float().detach().numpy(),
                                      np.asarray(j.numpy(), np.float32))
    w = pl.create_parameter([40, 60], **kw)
    bound = np.sqrt(6.0 / 100)
    assert 0.8 * bound < float(w.detach().abs().max()) <= bound
    assert pl.create_parameter([3], attr=False, **kw) is None
    assert jl.create_parameter([3], attr=False) is None


def test_dtype_casts_and_amp_o2_match_jax():
    """astype/to cast every float parameter and buffer as JAX's Layer.to
    does; amp.decorate(level="O2") casts only the parameters (BN's
    running statistics stay f32), and the bf16 block rounds as JAX's:
    the eval BN upcasts to f32 and casts back to the input's dtype."""
    jpaddle.seed(19)
    mk = [lambda m, **kw: m.Sequential(
        m.Conv2D(3, 3, 3, padding=1, bias_attr=False, **kw),
        m.BatchNorm2D(3, **kw), m.ReLU()) for _ in range(2)]
    j1, p1 = mk[0](jnn), mk[0](nn, device="cpu")
    j1.astype("bfloat16")
    p1.astype("bfloat16")
    assert [str(t.dtype) for t in p1.state_dict().values()] == \
        ["torch.bfloat16"] * 5
    assert {str(t.dtype) for t in j1.state_dict().values()} == {"bfloat16"}
    p1.to(dtype="float32")
    assert {t.dtype for t in p1.state_dict().values()} == {torch.float32}
    j2, p2 = mk[1](jnn), mk[1](nn, device="cpu")
    j2[1]._mean.set_value(_x(20, 3))
    j2[1]._variance.set_value(np.abs(_x(21, 3)) + 0.5)
    load_jax_state(p2, jax_params(j2))
    jpaddle.amp.decorate(models=j2, level="O2", dtype="bfloat16")
    paddle.amp.decorate(models=p2, level="O2", dtype="bfloat16")
    assert {p.dtype for p in p2.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in p2.buffers()} == {torch.float32}
    for m in (j2, p2):
        m.eval()
    x = _x(22, 2, 3, 6, 6)
    want = j2(jpaddle.cast(jpaddle.to_tensor(x), "bfloat16"))
    with torch.no_grad():
        got = p2(paddle.cast(torch.from_numpy(x), "bfloat16"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.numpy(), np.float32))


def test_port_layers_are_layers_and_default_to_the_card(monkeypatch):
    """The port's layers are nn.Layers, as JAX's are; Linear keeps
    torch's [out, in] weight.  Without a card, Conv2D, BatchNorm2D and
    LeNet refuse to build unless the caller passes device="cpu", as
    Linear does."""
    layers = [nn.Conv2D(2, 3, 3, device="cpu"),
              nn.BatchNorm2D(3, device="cpu"), nn.ReLU(), nn.MaxPool2D(2),
              nn.Sequential(), nn.LayerList(), nn.LayerDict(),
              nn.Linear(4, 2, device="cpu"), nn.Embedding(5, 2, device="cpu"),
              nn.LayerNorm(4, device="cpu"), nn.Dropout(0.1),
              nn.AdaptiveAvgPool2D(1), nn.CrossEntropyLoss(),
              paddle.vision.models.LeNet(device="cpu")]
    assert all(isinstance(l, nn.Layer) for l in layers)
    assert layers[7].weight.shape == (2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: nn.Conv2D(2, 3, 3), lambda: nn.BatchNorm2D(3),
                 lambda: paddle.vision.models.LeNet()):
        with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
            make()


def test_clear_gradients_drops_every_gradient():
    """clear_gradients leaves every parameter without a gradient, as
    JAX's clear_grad does."""
    _, pm = _pair(23)
    pm(torch.from_numpy(_x(24, 2, 2, 6, 6))).sum().backward()
    assert all(p.grad is not None for p in pm.parameters())
    pm.clear_gradients()
    assert all(p.grad is None for p in pm.parameters())
