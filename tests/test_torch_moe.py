"""MoE routing and layers of the PyTorch port against the JAX package, on
the CPU in f32.

Weights are drawn by the JAX layer from a seed and carried across by
``load_jax_state``; inputs are seeded numpy arrays.  Every parity check
first asserts that both packages chose the same experts, so that a
failure names a routing flip before it compares floats.  Tolerances:
the dispatch plan (slots, counts, drops) and the expert ids exactly;
gate probabilities and gates rtol 1e-5 (the JAX tests' own for softmax
sums); the layer's output atol 1e-5 and every gradient atol 1e-5 (the
two frameworks sum f32 products of width <= 32 in other orders, which
moves a value of order 1 by ~1e-7); the aux loss rtol 1e-6.  The routed
path and the dense-dispatch control of the port agree bit for bit,
forward and backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.functional import functional_call, layer_state
from paddle_tpu.nn.layer import moe as jmoe
from paddle_tpu.ops import routing as JR
from torch_port_util import jax_params
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.framework.enforce import (InvalidArgumentError,
                                                UnimplementedError)
from paddle_tpu_torch.nn.layer import moe as tmoe
from paddle_tpu_torch.ops import routing as TR
from paddle_tpu_torch.parallel.mesh import make_mesh
from paddle_tpu_torch.profiler.metrics import default_registry

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_capacity_layout_and_wire_bytes_match_jax():
    for args in ((32, 2, 8, 1.0), (32, 2, 8, 1.25), (4, 2, 64, 1.25),
                 (1, 1, 128, 0.5), (4096, 2, 16, 1.25), (4096, 2, 16, 1.0)):
        assert TR.moe_capacity(*args) == JR.moe_capacity(*args), args
    for args in ((8, 4, 16, 1), (8, 4, 16, 8), (16, 640, 512, 4)):
        assert TR.moe_a2a_wire_bytes(*args) == JR.moe_a2a_wire_bytes(*args)
    for args in ((64, 16, 1, 8), (64, 16, 4, 8, 2, 3)):
        assert TR.a2a_wire_bytes(*args) == JR.a2a_wire_bytes(*args)
    for vocab, n in ((10, 1), (10, 4), (1000, 8)):
        assert TR.rows_per_shard(vocab, n) == JR.rows_per_shard(vocab, n)
        assert TR.storage_table_rows(vocab, n) \
            == JR.storage_table_rows(vocab, n)
        ids = np.arange(vocab)
        rps = TR.rows_per_shard(vocab, n)
        np.testing.assert_array_equal(
            TR.storage_index(_t(ids), rps).numpy(),
            np.asarray(JR.storage_index(jnp.asarray(ids), rps)))
    octave = lambda m: 1 << (m - 1).bit_length()           # noqa: E731
    assert TR.pad_requests(37, 8, octave) == JR.pad_requests(37, 8, octave)


def test_expert_dispatch_plan_and_pack_match_jax():
    """pos (slots and -1 drops), pre-drop counts and drops, exactly; a
    sentinel never consumes cap; pack_by_owner's send buffer too."""
    rng = np.random.RandomState(0)
    cases = [(rng.randint(0, 8, (4, 24)), 8, 4),
             (rng.randint(0, 16, (1, 512)), 16, 40),
             (np.asarray([[0, -1, 0, -1, 0, 0]]), 2, 4),
             (np.where(rng.rand(2, 30) < 0.2, -1, rng.randint(0, 4, (2, 30))),
              4, 3)]
    for eids, E, cap in cases:
        eids = eids.astype(np.int32)
        want = JR.expert_dispatch_plan(jnp.asarray(eids), n_experts=E,
                                       cap=cap)
        got = TR.expert_dispatch_plan(_t(eids), n_experts=E, cap=cap)
        for name in ("pos", "counts", "dropped"):
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == np.int32, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert (got.pos.numpy()[eids < 0] == -1).all()
    ids = rng.randint(-1, 40, 64).astype(np.int32)
    want = JR.pack_by_owner(jnp.asarray(ids), n_shards=4, rps=10, cap=6)
    got = TR.pack_by_owner(_t(ids), n_shards=4, rps=10, cap=6)
    for name in ("send_ids", "pos", "counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert bool(got.overflow) == bool(want.overflow)


def test_local_experts_matches_jax_and_masks_drops():
    rng = np.random.RandomState(1)
    E, cap, D, S = 4, 3, 8, 10
    eids = rng.randint(0, E, (1, S)).astype(np.int32)
    x = rng.randn(S, D).astype(np.float32)
    w = rng.randn(E, D, D).astype(np.float32)
    jplan = JR.expert_dispatch_plan(jnp.asarray(eids), n_experts=E, cap=cap)
    want = np.asarray(JR.local_experts(
        jnp.asarray(x), jplan.pos, [jnp.asarray(w)],
        lambda rows, w: jnp.einsum("emd,edh->emh", rows, w),
        n_experts=E, cap=cap))
    plan = TR.expert_dispatch_plan(_t(eids), n_experts=E, cap=cap)
    got = TR.local_experts(_t(x), plan.pos, [_t(w)], torch.bmm,
                           n_experts=E, cap=cap).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    pos = plan.pos.numpy()[0]
    assert (pos < 0).any()
    for t in range(S):
        if pos[t] < 0:
            assert not got[t].any()
        else:
            np.testing.assert_allclose(got[t], x[t] @ w[eids[0, t]],
                                       atol=1e-5)


def test_gating_matches_jax_and_breaks_ties_to_the_lower_expert():
    rng = np.random.RandomState(3)
    x = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(8, 4).astype(np.float32)
    for k in (1, 2):
        jp, je, jg = jmoe.top_k_gating(jnp.asarray(x), jnp.asarray(w), k)
        tp, te, tg = tmoe.top_k_gating(_t(x), _t(w), k)
        assert te.dtype == torch.int32 and te.shape == (16, k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5)
    # exact ties: equal logits everywhere, and a tie between the top two
    logits = np.zeros((3, 6), np.float32)
    logits[1, [2, 4]] = 1.0
    logits[2, [5, 1, 3]] = [2.0, 2.0, 1.0]
    for k in (1, 2):
        _, je, jg = jmoe.gate_from_logits(jnp.asarray(logits), k)
        _, te, tg = tmoe.gate_from_logits(_t(logits), k)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(
        tmoe.gate_from_logits(_t(logits), 2)[1].numpy(),
        [[0, 1], [2, 4], [1, 5]])
    with pytest.raises(InvalidArgumentError, match="k in"):
        tmoe.gate_from_logits(torch.zeros(4, 4), 3)


def test_load_balance_loss_matches_jax():
    rng = np.random.RandomState(4)
    E, G, u, k = 4, 2, 8, 2
    probs = np.asarray(jax.nn.softmax(jnp.asarray(rng.randn(G * u, E),
                                                  jnp.float32)))
    eids = rng.randint(0, E, (G * u, k)).astype(np.int32)
    want = float(jmoe.load_balance_loss(jnp.asarray(probs),
                                        jnp.asarray(eids), G))
    got = float(tmoe.load_balance_loss(_t(probs), _t(eids), G))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    uniform = torch.full((64, 8), 1.0 / 8)
    spread = (torch.arange(64) % 8)[:, None]
    np.testing.assert_allclose(
        float(tmoe.load_balance_loss(uniform, spread, 1)), 1.0, rtol=1e-6)
    collapsed = torch.zeros(64, 8)
    collapsed[:, 0] = 1.0
    np.testing.assert_allclose(float(tmoe.load_balance_loss(
        collapsed, torch.zeros(64, 1, dtype=torch.int32), 1)), 8.0,
        rtol=1e-6)


def _layer_pair(k, dispatch="routed", d=16, h=32, e=8, cf=1.25, seed=0):
    paddle.seed(seed)
    jm = jmoe.MoELayer(d, h, e, top_k=k, capacity_factor=cf, mesh=None,
                       axis="ep")
    pm = tmoe.MoELayer(d, h, e, top_k=k, capacity_factor=cf, mesh=None,
                       axis="ep", dispatch=dispatch, device="cpu")
    load_jax_state(pm, jax_params(jm))
    return jm, pm


def _jax_value_and_grads(jm, x, ct):
    p, b = layer_state(jm)[:2]

    def loss(p, x):
        out, _ = functional_call(jm, p, b, (x,), training=False,
                                 mutable_buffers=True)
        return jnp.vdot(out, ct) + jm.aux_loss(), out

    (val, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(p, x)
    return float(val), np.asarray(out), np.asarray(gx), \
        {n: np.asarray(g) for n, g in gp.items()}


def _port_value_and_grads(pm, x, ct):
    xt = _t(x).requires_grad_()
    out = pm(xt)
    val = (out * _t(ct)).sum() + pm.aux_loss()
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(val, [xt] + list(pm.parameters()))
    return val.item(), out.detach().numpy(), grads[0].numpy(), \
        {n: g.numpy() for n, g in zip(names, grads[1:])}


@pytest.mark.parametrize("k", [1, 2])
def test_layer_output_and_every_gradient_match_jax(k):
    jm, pm = _layer_pair(k)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 16).astype(np.float32)
    ct = rng.randn(64, 16).astype(np.float32)
    _, je, _ = jmoe.top_k_gating(jnp.asarray(x), jm.gate.weight._value, k)
    _, te, _ = tmoe.top_k_gating(_t(x), pm.gate.weight.detach().t(), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    jv, jout, jgx, jgp = _jax_value_and_grads(jm, jnp.asarray(x),
                                              jnp.asarray(ct))
    tv, tout, tgx, tgp = _port_value_and_grads(pm, x, ct)
    assert float(pm._moe_dropped) > 0       # cap 20 of 64 * k: some drop
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tgx, jgx, atol=1e-5, rtol=0)
    assert set(tgp) == set(jgp)
    for n, g in tgp.items():
        want = jgp[n].T if n == "gate.weight" else jgp[n]
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=0, err_msg=n)
    jm(paddle.to_tensor(x))                 # eager: a concrete aux loss
    np.testing.assert_allclose(float(pm.aux_loss()),
                               float(np.asarray(jm.aux_loss())), rtol=1e-6)


def test_routed_equals_dense_control_bit_for_bit():
    """Forward, aux loss and every gradient, at top-k 1 and 2, with drops
    (cf 1.25 over 64 tokens) and without (cf 8)."""
    rng = np.random.RandomState(5)
    x = rng.randn(64, 16).astype(np.float32)
    ct = rng.randn(64, 16).astype(np.float32)
    for k, cf in ((1, 1.25), (2, 1.25), (2, 8.0)):
        _, routed = _layer_pair(k, "routed", cf=cf, seed=k)
        _, dense = _layer_pair(k, "dense", cf=cf, seed=k)
        r = _port_value_and_grads(routed, x, ct)
        d = _port_value_and_grads(dense, x, ct)
        assert r[0] == d[0], (k, cf)
        assert np.array_equal(r[1], d[1]) and np.array_equal(r[2], d[2])
        for n in r[3]:
            assert np.array_equal(r[3][n], d[3][n]), (k, cf, n)
        assert torch.equal(routed._moe_load, dense._moe_load)


def test_drop_counting_and_load_buffers():
    """cap = ceil(0.25 * 16 / 4) = 1 slot an expert: 12 of 16 drop, the
    load ratios sum to E, at most 4 rows of the combine are non-zero;
    JAX's buffers hold the same values."""
    jm, pm = _layer_pair(1, d=8, h=16, e=4, cf=0.25, seed=2)
    x = np.random.RandomState(2).randn(16, 8).astype(np.float32)
    jm(paddle.to_tensor(x))
    out = pm(_t(x)).detach().numpy()
    assert float(pm._moe_dropped) == 12.0
    assert pm._moe_load.shape == (4,)
    np.testing.assert_allclose(float(pm._moe_load.sum()), 4.0, rtol=1e-6)
    np.testing.assert_array_equal(pm._moe_load.numpy(),
                                  np.asarray(jm._moe_load._value))
    assert float(np.asarray(jm._moe_dropped._value)) == 12.0
    assert (np.abs(out).sum(axis=1) > 0).sum() <= 4
    assert pm.capacity_for(16) == jm.capacity_for(16) == 1
    assert pm.wire_bytes(16) == jm.wire_bytes(16) == 0


def test_validation_errors():
    kw = dict(device="cpu")
    with pytest.raises(InvalidArgumentError, match="top_k"):
        tmoe.MoELayer(8, 16, 8, top_k=3, **kw)
    with pytest.raises(InvalidArgumentError, match="capacity_factor"):
        tmoe.MoELayer(8, 16, 8, capacity_factor=0.0, **kw)
    with pytest.raises(InvalidArgumentError, match="dispatch"):
        tmoe.MoELayer(8, 16, 8, dispatch="magic", **kw)
    with pytest.raises(InvalidArgumentError, match="activation"):
        tmoe.MoELayer(8, 16, 8, activation="tanh", **kw)
    two = make_mesh({"ep": 2}, devices=[CPU, CPU])
    with pytest.raises(InvalidArgumentError, match="divide"):
        tmoe.MoELayer(8, 16, 3, mesh=two, axis="ep", **kw)
    m = tmoe.MoELayer(8, 16, 4, top_k=1, mesh=two, axis="ep", **kw)
    with pytest.raises(InvalidArgumentError, match="divisible"):
        m(torch.zeros(3, 8))
    with pytest.raises(UnimplementedError, match="A11"):
        m(torch.zeros(4, 8))
    with pytest.raises(InvalidArgumentError, match="width"):
        tmoe.MoELayer(8, 16, 4, **kw)(torch.zeros(2, 6))
    mesh = dict(mesh=two, axis="ep")
    for call in (lambda: TR.all_to_all_experts(None, None, [], None,
                                               n_experts=4, cap=1, **mesh),
                 lambda: TR.all_to_all_gather([], None, rps=1, **mesh),
                 lambda: TR.all_to_all_set([], None, [], rps=1, **mesh),
                 lambda: TR.all_to_all_apply_rule(
                     None, {}, None, None, opt="adam", hyper={}, rps=1,
                     **mesh)):
        with pytest.raises(UnimplementedError, match="A11"):
            call()


def test_publish_moe_metrics_into_the_registry():
    _, pm = _layer_pair(1, d=8, h=16, e=4, cf=0.25, seed=2)
    pm(_t(np.random.RandomState(2).randn(16, 8).astype(np.float32)))
    reg = default_registry()
    c = reg.get("moe_tokens_dropped_total")
    h = reg.get("moe_expert_load_ratio")
    assert c.kind == "counter" and h.kind == "histogram"
    assert {"moe_tokens_dropped_total", "moe_expert_load_ratio"} \
        <= {d["name"] for d in reg.describe()}
    before_c = c.labels(model="t_moe").value
    before_h = h.labels(model="t_moe").count
    dropped, loads = tmoe.publish_moe_metrics(pm, model="t_moe")
    assert dropped == 12.0 and len(loads) == 4
    assert c.labels(model="t_moe").value == before_c + 12.0
    assert h.labels(model="t_moe").count == before_h + 4
    snap = reg.snapshot()["moe_expert_load_ratio"]["model=t_moe"]
    assert snap["count"] == before_h + 4
    # an identical re-declaration returns the family, a conflicting one
    # raises
    assert reg.counter("moe_tokens_dropped_total", labels=("model",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("moe_tokens_dropped_total", labels=("model",))


def test_moe_flags_defaults_validators_and_resolution():
    snap = tflags.flags_snapshot()
    try:
        assert tflags.flag("moe_top_k") == 2
        assert tflags.flag("moe_capacity_factor") == 1.25
        assert tflags.flag("moe_axis") == "ep"
        for bad in ({"FLAGS_moe_top_k": 3}, {"FLAGS_moe_top_k": 0},
                    {"FLAGS_moe_capacity_factor": 0.0},
                    {"FLAGS_moe_axis": "xx"}):
            with pytest.raises(ValueError):
                tflags.set_flags(bad)
        tflags.set_flags({"FLAGS_moe_top_k": 1,
                          "FLAGS_moe_capacity_factor": 2.0,
                          "FLAGS_moe_axis": "dp"})
        m = tmoe.MoELayer(8, 16, 8, device="cpu")
        assert (m.top_k, m.capacity_factor, m.axis) == (1, 2.0, "dp")
    finally:
        tflags.flags_restore(snap)
    assert tflags.flag("moe_top_k") == 2
