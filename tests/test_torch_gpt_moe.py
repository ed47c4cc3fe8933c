"""GPT-MoE and causal-LM GPT training of the PyTorch port against the JAX
package, on the CPU in f32.

Weights are drawn by the JAX model from a seed and carried across by
``load_jax_state``.  The JAX ``TrainStep`` runs on a one-device mesh
(the suite gives JAX 8 CPU devices, over which a default step would
shard the batch); the port's on the one-device mesh ``make_mesh``
builds over the CPU.  Every parity check first asserts that both
packages sent each token to the same experts.  Tolerances: logits atol
1e-4 (``tests/test_torch_gpt.py``'s: other f32 summation orders over 2
layers and a tied head); losses atol 2e-5 and parameters atol 1e-4
after 3 AdamW steps (``tests/test_torch_train_step.py``'s BERT
trajectory), the key biases excepted (their exact gradient is 0, and
Adam's normalised step moves rounding noise by up to lr a step); the
load buffers of the last step exactly.  The routed path equals the
dense-dispatch control bit for bit, and greedy tokens are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.layer import moe as jmoe
from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import TrainStep as JaxTrainStep
from paddle_tpu.parallel.mesh import make_mesh as jax_make_mesh
from paddle_tpu.text.generation import Generator as JaxGenerator
from paddle_tpu.text.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.text.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu.text.models.gpt import GPTMoEConfig as JaxGPTMoEConfig
from paddle_tpu.text.models.gpt import GPTMoEModel as JaxGPTMoEModel
from torch_port_util import jax_params, linear_weight_names
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.framework.enforce import UnimplementedError
from paddle_tpu_torch.nn.layer import moe as tmoe
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.text.generation import Generator
from paddle_tpu_torch.text.models import (GPTConfig, GPTModel, GPTMoEConfig,
                                          GPTMoEModel)

CPU = torch.device("cpu")
V = 64
TINY = dict(vocab_size=V, hidden_size=16, layers=2, heads=2, seq=32,
            experts=8, top_k=2, capacity_factor=1.25)
BUCKETS = dict(seq_buckets=(8, 16), max_len=32)


def _cfgs(tiny):
    jc, tc = JaxGPTMoEConfig.tiny(**tiny), GPTMoEConfig.tiny(**tiny)
    jc.dropout = tc.dropout = 0.0
    return jc, tc


def _moe_pair(seed, **over):
    jc, tc = _cfgs(dict(TINY, **over))
    paddle.seed(seed)
    jm = JaxGPTMoEModel(jc)
    pm = GPTMoEModel(tc, device="cpu")
    load_jax_state(pm, jax_params(jm))
    return jm, pm


def _dense_pair(seed):
    cfg = {k: TINY[k] for k in ("vocab_size", "hidden_size", "layers",
                                "heads", "seq")}
    jc, tc = JaxGPTConfig.tiny(**cfg), GPTConfig.tiny(**cfg)
    jc.dropout = tc.dropout = 0.0
    paddle.seed(seed)
    jm = JaxGPTModel(jc)
    pm = GPTModel(tc, device="cpu")
    load_jax_state(pm, jax_params(jm))
    return jm, pm


def _expert_ids(layers, inputs, gate_weight, k):
    """The top-k expert ids each MoE layer chose for its captured input."""
    return [np.asarray(tmoe.top_k_gating(
        torch.from_numpy(np.asarray(x)).reshape(-1, x.shape[-1]),
        gate_weight(m), k)[1]) for m, x in zip(layers, inputs)]


def _same_routing(jm, pm, ids):
    """Eager forwards of both models on ``ids``: each MoE layer's input
    captured by a pre-hook, gated by its own package's gate weight."""
    seen = {"jax": [], "port": []}
    jl, pl = jmoe.moe_layers(jm), tmoe.moe_layers(pm)
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen["jax"].append(np.asarray(a[0]._value)))
        for m in jl]
    hooks += [m.register_forward_pre_hook(
        lambda m, a: seen["port"].append(a[0].detach().numpy()))
        for m in pl]
    jm(paddle.to_tensor(ids))
    with torch.no_grad():
        pm(torch.from_numpy(ids))
    for h in hooks:
        h.remove()
    k = pm.config.moe_top_k
    want = [np.asarray(jmoe.top_k_gating(
        jnp.asarray(x).reshape(-1, x.shape[-1]), m.gate.weight._value, k)[1])
        for m, x in zip(jl, seen["jax"])]
    got = _expert_ids(pl, seen["port"], lambda m: m.gate.weight.t(), k)
    assert len(got) == len(want) == pm.config.num_layers // 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bridge_and_loss_match_jax():
    """loss = cross entropy + aux_weight * the summed aux losses."""
    jm, pm = _moe_pair(0)
    params = jax_params(jm)
    assert set(pm.state_dict()) == set(params)
    np.testing.assert_array_equal(
        pm.encoder.layers[1].moe.gate.weight.detach().numpy().T,
        params["encoder.layers.1.moe.gate.weight"])
    np.testing.assert_array_equal(
        pm.encoder.layers[1].moe.experts.w1.detach().numpy(),
        params["encoder.layers.1.moe.experts.w1"])
    assert pm._lm_head.data_ptr() == pm.wte.weight.data_ptr()
    ids = np.random.RandomState(0).randint(0, V, (8, 16)).astype(np.int64)
    jm.eval()
    pm.eval()
    _same_routing(jm, pm, ids)
    want = float(jm(paddle.to_tensor(ids), paddle.to_tensor(ids)).numpy())
    jaux = float(np.asarray(jm.moe_aux_loss()))
    with torch.no_grad():
        t = torch.from_numpy(ids)
        got = float(pm(t, t))
        aux = float(pm.moe_aux_loss())
        logits = pm(t)
    np.testing.assert_allclose(
        logits.numpy(), jm(paddle.to_tensor(ids)).numpy(), atol=1e-4,
        rtol=0)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5)
    assert aux >= 1.0 - 1e-5
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    ce = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, V), t[:, 1:].reshape(-1))
    np.testing.assert_allclose(got, float(ce) + 1e-2 * aux, rtol=1e-6)
    assert float(tmoe.total_aux_loss(pm)) == aux
    assert float(tmoe.total_aux_loss(GPTModel(GPTConfig.tiny(),
                                              device="cpu"))) == 0.0


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_train_step_trajectory_matches_jax(kind):
    """3 AdamW steps (bench.py's rule: lr 1e-3, weight decay 0.01) on one
    batch of next-token prediction: the MoE model and the dense
    causal-LM GPT."""
    jm, pm = _moe_pair(1) if kind == "moe" else _dense_pair(1)
    ids = np.random.RandomState(1).randint(0, V, (8, 32)).astype(np.int64)
    if kind == "moe":
        _same_routing(jm, pm, ids)
    jstep = JaxTrainStep(jm, JaxAdamW(learning_rate=1e-3,
                                      parameters=jm.parameters()),
                         mesh=jax_make_mesh({"ep": 1},
                                            devices=jax.devices()[:1]))
    tstep = TrainStep(pm, AdamW(learning_rate=1e-3),
                      mesh=tmesh.make_mesh({"ep": 1}, devices=[CPU]),
                      device="cpu")
    losses = []
    for step in range(3):
        want = float(jstep((jnp.asarray(ids), jnp.asarray(ids))).numpy())
        losses.append(float(tstep((ids, ids))))
        np.testing.assert_allclose(losses[-1], want, atol=2e-5, rtol=0,
                                   err_msg=f"step {step + 1}")
    assert losses[-1] < losses[0]
    jstep.sync_to_layer()
    final = jax_params(jm)
    linear = linear_weight_names(pm)
    for n, p in pm.named_parameters():
        if n.endswith("k_proj.bias"):
            continue        # exact gradient 0: Adam moves noise by lr
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if n in linear else got, final[n],
                                   atol=1e-4, rtol=0, err_msg=n)
    for n, b in pm.named_buffers():
        if n.endswith("_moe_load") or n.endswith("_moe_dropped"):
            np.testing.assert_array_equal(b.numpy(), final[n], err_msg=n)


@pytest.mark.parametrize("k", [1, 2])
def test_routed_trajectory_equals_dense_control_bit_for_bit(k):
    """3 TrainStep steps of a 4-layer GPT-MoE and its dense-dispatch
    control from one init: losses and every parameter bit-equal."""
    _, tc = _cfgs(dict(TINY, layers=4, top_k=k))
    runs = []
    for dispatch in ("routed", "dense"):
        torch.manual_seed(0)
        m = GPTMoEModel(tc, dispatch=dispatch, device="cpu")
        m.init_weights(torch.Generator().manual_seed(k))
        step = TrainStep(m, AdamW(learning_rate=1e-3), device="cpu")
        ids = np.random.RandomState(0).randint(0, V, (8, 32))
        runs.append(([float(step((ids, ids))) for _ in range(3)],
                     dict(m.named_parameters())))
    (lr, pr), (ld, pd) = runs
    assert lr == ld and lr[-1] < lr[0]
    for n in pr:
        assert torch.equal(pr[n], pd[n]), n


def test_generate_tokens_match_jax_and_the_dense_control():
    jm, pm = _moe_pair(2, experts=4)
    jm.eval()
    ids = np.random.RandomState(0).randint(1, V, (2, 12)).astype(np.int64)
    _same_routing(jm, pm, ids)
    want = np.asarray(JaxGenerator(jm, **BUCKETS).generate(
        ids, max_new_tokens=8).numpy())
    got = Generator(pm, device="cpu", **BUCKETS).generate(
        ids, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    dense = GPTMoEModel(pm.config, dispatch="dense", device="cpu")
    dense.load_state_dict(pm.state_dict())
    np.testing.assert_array_equal(
        Generator(dense, device="cpu", **BUCKETS).generate(
            ids, max_new_tokens=8).numpy(), got)


def test_moe_encoder_layer_ring_cache_contract():
    paddle.seed(0)
    jblk = jmoe.MoEEncoderLayer(16, 2, 32, 4, dropout=0.0, top_k=2,
                                capacity_factor=1.25)
    blk = tmoe.MoEEncoderLayer(16, 2, 32, 4, dropout=0.0, top_k=2,
                               capacity_factor=1.25, device="cpu")
    load_jax_state(blk, jax_params(jblk))
    cache = blk.gen_ring_cache(2, 8)
    x = np.random.RandomState(0).randn(2, 1, 16).astype(np.float32)
    with torch.no_grad():
        out, new_cache = blk(torch.from_numpy(x), None, cache=cache,
                             cache_position=0)
    jout, jcache = jblk(paddle.to_tensor(x), None,
                        cache=jblk.gen_ring_cache(2, 8),
                        cache_position=paddle.to_tensor(np.int32(0)))
    assert tuple(out.shape) == (2, 1, 16)
    assert new_cache.k.shape == cache.k.shape == (2, 2, 8, 8)
    np.testing.assert_allclose(out.numpy(), jout.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(new_cache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5, rtol=0)
    # the full forward keeps TransformerEncoderLayer's contract too
    full = blk(torch.from_numpy(np.repeat(x, 3, axis=1)))
    assert full.shape == (2, 3, 16)
    assert tuple(blk.gen_cache(full).k.shape) == (2, 2, 0, 8)


def test_transformer_encoder_list_form():
    blocks = [tnn.TransformerEncoderLayer(16, 2, 32, device="cpu"),
              tmoe.MoEEncoderLayer(16, 2, 32, 4, device="cpu")]
    enc = tnn.TransformerEncoder(blocks)
    assert enc.num_layers == 2
    assert all(a is b for a, b in zip(enc.layers, blocks))
    assert tnn.TransformerEncoder(tuple(blocks), 2).layers[1] is blocks[1]
    with pytest.raises(ValueError, match="num_layers=3"):
        tnn.TransformerEncoder(blocks, 3)
    # the single-layer form still clones, with fresh parameters
    one = tnn.TransformerEncoder(blocks[0], 3)
    assert one.num_layers == 3 and one.layers[0] is blocks[0]
    assert one.layers[1] is not blocks[0] and not torch.equal(
        one.layers[1].linear1.weight, blocks[0].linear1.weight)


def test_config_resolves_flags_at_construction():
    snap = tflags.flags_snapshot()
    try:
        tflags.set_flags({"FLAGS_moe_top_k": 1,
                          "FLAGS_moe_capacity_factor": 2.0})
        cfg = GPTMoEConfig.tiny(vocab_size=32, hidden_size=16, layers=2,
                                heads=2, seq=32, experts=4)
        assert cfg.moe_top_k is None and cfg.moe_capacity_factor is None
        m = GPTMoEModel(cfg, device="cpu")
    finally:
        tflags.flags_restore(snap)
    assert m.config.moe_top_k == 1 and m.config.moe_capacity_factor == 2.0
    assert m.encoder.layers[1].moe.top_k == 1
    assert m.encoder.layers[1].moe.capacity_factor == 2.0
    assert isinstance(m.encoder.layers[0], tnn.TransformerEncoderLayer)
    assert len(tmoe.moe_layers(m)) == 1
    with pytest.raises(ValueError, match="moe_every"):
        GPTMoEModel(GPTMoEConfig.tiny(moe_every=0), device="cpu")


def test_mesh_rules_one_device_mesh_accepted_two_device_mesh_raises():
    for axes in ({"ep": 8}, {"dp": 2, "mp": 4}, {"ep": 1, "dp": -1},
                 {"mp": 2, "ep": 4}, {"ep": 1}):
        got = tmesh.make_mesh(axes, devices=[CPU] * 8)
        want = jax_make_mesh(axes, devices=jax.devices()[:8])
        assert got.shape == dict(want.shape), axes
        assert got.axis_names == tuple(want.axis_names)
    one = tmesh.make_mesh({"ep": 1}, devices=["cpu"])
    assert one.shape == {"dp": 1} and one.size == 1
    with pytest.raises(ValueError, match="need 4 devices"):
        tmesh.make_mesh({"dp": 4}, devices=[CPU] * 2)
    two = tmesh.make_mesh({"ep": 2}, devices=[CPU, CPU])
    assert not tmesh.has_mesh()
    with tmesh.MeshGuard(two):
        assert tmesh.get_mesh() is two and tmesh.mesh_axis_size("ep") == 2
        # a layer built under the guard routes over its expert axis
        assert tmoe.MoELayer(8, 16, 4, device="cpu").n_shards == 2
    assert not tmesh.has_mesh()
    m = GPTMoEModel(GPTMoEConfig.tiny(**TINY), device="cpu", mesh=one)
    step = TrainStep(m, AdamW(), mesh=one, device="cpu")
    ids = np.ones((2, 8), np.int64)
    assert np.isfinite(float(step((ids, ids))))
    with pytest.raises(UnimplementedError, match="A12"):
        TrainStep(m, AdamW(), mesh=two, device="cpu")
    with pytest.raises(UnimplementedError, match="A11"):
        GPTMoEModel(GPTMoEConfig.tiny(**TINY), device="cpu",
                    mesh=two)(torch.from_numpy(ids))


def test_ordered_lookup_gradient_equals_the_embedding_gradient():
    """The port's embedding lookup (``_OrderedLookup``, on every device:
    its table gradient added in one fixed order) gives torch's embedding
    gradient, repeated ids included."""
    from paddle_tpu_torch.nn.functional.common import _OrderedLookup
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 16, (4, 32)))
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 32, 8).astype(np.float32))
    w1 = w.clone().requires_grad_()
    w2 = w.clone().requires_grad_()
    out = _OrderedLookup.apply(ids, w1)
    torch.testing.assert_close(out, torch.nn.functional.embedding(ids, w),
                               rtol=0, atol=0)
    out.backward(g)
    torch.nn.functional.embedding(ids, w2).backward(g)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-6, atol=1e-6)
