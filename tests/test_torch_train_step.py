"""Training of the PyTorch port against the JAX package, on the CPU in
f32: the optimizer rules, the LR schedules, the GradScaler state machine
and a 5-step TrainStep trajectory of a tiny BERT; Momentum and a 3-step
TrainStep(loss_fn=CrossEntropyLoss()) trajectory of a small conv net with
batch norm; then the port's own TrainStep contracts (sentinel, seeding,
options not ported yet).

Tolerances: one optimizer update atol 1e-6 on parameters of |p| < 4 and
rtol 1e-5 on the moments (the same f32 formula; the port's foreach ops
may fuse a multiply-add that XLA rounds twice, one f32 ulp per step).
The BERT trajectory: losses atol 2e-5 per step and parameters atol 1e-4
after step 5 — the gradients agree to ~1e-6 (test_torch_bert.py) and
Adam's normalised step turns such differences in near-zero gradients
into differences of up to lr in single elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.amp import GradScaler as JaxGradScaler
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import TrainStep as JaxTrainStep
from paddle_tpu.parallel.mesh import make_mesh
from torch_port_util import (bert_batch, bert_pair, jax_params,
                             linear_weight_names, no_dropout)
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.framework.enforce import UnimplementedError
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.text.models import BertConfig, BertForPretraining

TINY = no_dropout(dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=256,
                       max_position_embeddings=64))


def _decay(name):
    return not (name.endswith("bias") or "norm" in name)


@pytest.mark.parametrize("kind", ["adamw", "adamw_decay_fn", "adam_l2"])
def test_optimizer_updates_match_jax_rules(kind):
    rng = np.random.RandomState(31)
    shapes = {"enc.linear.weight": (8, 6), "enc.linear.bias": (6,),
              "enc.norm.weight": (6,), "emb.weight": (10, 6)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    hp = dict(learning_rate=1e-2, beta1=0.9, beta2=0.999, epsilon=1e-8)
    if kind == "adam_l2":
        jopt, topt_cls, kw = JaxAdam(**hp, weight_decay=0.1), Adam, \
            dict(weight_decay=0.1)
    else:
        kw = dict(weight_decay=0.05, apply_decay_param_fun=(
            _decay if kind == "adamw_decay_fn" else None))
        jopt, topt_cls = JaxAdamW(**hp, **kw), AdamW
    tparams = {n: torch.from_numpy(v.copy()).requires_grad_()
               for n, v in params.items()}
    topt = topt_cls(**hp, parameters=list(tparams.items()), **kw)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jopt.functional_state(jp)
    for t, g in enumerate(grads, start=1):
        jp, jstate = jopt.functional_apply(
            jp, {n: jnp.asarray(v) for n, v in g.items()}, jstate, t)
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n])
        topt.step()
    sd = topt.state_dict()
    assert sd["@step"] == 3
    for n, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=0, err_msg=n)
        for s in ("moment1", "moment2"):
            np.testing.assert_allclose(sd[f"{n}_{s}"].numpy(),
                                       np.asarray(jstate[s][n]), rtol=1e-5,
                                       atol=1e-9, err_msg=f"{n} {s}")


def test_bert_schedule_matches_jax():
    """Linear warm-up into a polynomial decay, BERT's schedule."""
    j = jlr.LinearWarmup(jlr.PolynomialDecay(1e-4, 20, end_lr=0.0), 5, 0.0,
                         1e-4)
    t = tlr.LinearWarmup(tlr.PolynomialDecay(1e-4, 20, end_lr=0.0), 5, 0.0,
                         1e-4)
    got, want = [], []
    for _ in range(30):
        got.append(t())
        want.append(j())
        t.step()
        j.step()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    opt = AdamW(learning_rate=t)
    assert opt.get_lr() == t() and opt.state_dict()["LR_Scheduler"] == \
        t.state_dict()


def test_grad_scaler_backoff_matches_jax():
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    j, t = JaxGradScaler(**kw), GradScaler(**kw)
    pattern = [False, False, False, True, True, False, True, False, True,
               True, True, True, False, False, False, False]
    for bad in pattern:
        j.on_step_result(bad)
        t.on_step_result(bad)
        assert t.get_loss_scaling() == j.get_loss_scaling()
        assert t.state_dict() == j.state_dict()
    assert GradScaler(enable=False).get_loss_scaling() == 1.0


def _tiny_jax_train_step(jm, accumulate):
    opt = JaxAdamW(learning_rate=1e-3, weight_decay=0.01,
                   parameters=jm.parameters(),
                   apply_decay_param_fun=_decay)
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return JaxTrainStep(jm, opt, mesh=mesh, accumulate_steps=accumulate)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_bert_train_step_trajectory_matches_jax(accumulate):
    jm, pm = bert_pair(32, TINY)
    jstep = _tiny_jax_train_step(jm, accumulate)
    tstep = TrainStep(pm, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                apply_decay_param_fun=_decay),
                      accumulate_steps=accumulate, device="cpu")
    batch = bert_batch(33, TINY, 4, 32, 5)
    jbatch = tuple(None if x is None else jnp.asarray(x) for x in batch)
    for step in range(5):
        want = float(jstep(jbatch).numpy())
        got = float(tstep(batch))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                   err_msg=f"step {step + 1}")
    jstep.sync_to_layer()
    final = jax_params(jm)
    linear = linear_weight_names(pm)
    for n, p in pm.named_parameters():
        if n.endswith("k_proj.bias"):
            # its exact gradient is 0 (a key bias shifts every logit of a
            # row alike); both packages get rounding noise there, which
            # Adam's normalised step turns into +-lr per step
            continue
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if n in linear else got, final[n],
                                   atol=1e-4, rtol=0, err_msg=n)
    assert tstep.optimizer.state_dict()["@step"] == 5


class _MSELinear(torch.nn.Linear):
    """A Linear whose forward returns its squared error against a label,
    as a layer that TrainStep trains returns its loss."""

    def forward(self, x, y):
        return ((super().forward(x) - y) ** 2).mean()


def _linear_step(sentinel, scaler=None, seed=0):
    torch.manual_seed(0)
    net = _MSELinear(4, 1)
    opt = Adam(learning_rate=0.1, parameters=list(net.named_parameters()))
    step = TrainStep(net, opt, sentinel=sentinel, grad_scaler=scaler,
                     seed=seed, device="cpu")
    return net, opt, step


def test_sentinel_skips_a_poisoned_step_and_commits_nothing():
    scaler = GradScaler(init_loss_scaling=8.0, decr_every_n_nan_or_inf=1)
    net, opt, step = _linear_step(True, scaler)
    x, y = torch.ones(2, 4), torch.zeros(2, 1)
    step(x, y)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    moments = {k: v.clone() for k, v in opt.state_dict().items()
               if k != "@step"}
    loss = step(torch.full((2, 4), float("nan")), y)
    assert not np.isfinite(float(loss))
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, before[k], atol=0, rtol=0)
    sd = opt.state_dict()
    for k, v in moments.items():
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0)
    assert step.skipped_steps == 1 and sd["@step"] == 2
    assert scaler.get_loss_scaling() == 4.0        # backed off
    step(x, y)                                     # trains on
    assert opt.state_dict()["@step"] == 3
    assert not torch.equal(net.weight.detach(), before["weight"])
    # without the sentinel the NaN is committed
    net2, _, step2 = _linear_step(False)
    step2(torch.full((2, 4), float("nan")), y)
    assert not bool(torch.isfinite(net2.weight).all())


def test_train_step_seed_fixes_dropout_masks():
    cfg = dict(TINY, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    batch = bert_batch(34, cfg, 2, 16, 3)

    def first_loss(seed):
        m = BertForPretraining(BertConfig(**cfg), device="cpu")
        m.init_weights(torch.Generator().manual_seed(0))
        return float(TrainStep(m, AdamW(learning_rate=1e-3), seed=seed,
                               device="cpu")(batch))

    assert first_loss(7) == first_loss(7)
    assert first_loss(7) != first_loss(8)


def test_bf16_compute_keeps_f32_masters():
    m = BertForPretraining(BertConfig(**TINY), device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    step = TrainStep(m, AdamW(learning_rate=1e-3), device="cpu",
                     compute_dtype=torch.bfloat16)
    batch = bert_batch(35, TINY, 2, 16, 3)
    w0 = m.cls.transform.weight.detach().clone()
    losses = [float(step(batch)) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert not torch.equal(m.cls.transform.weight, w0)


@pytest.mark.parametrize("option", [dict(mesh=object()), "two_device_mesh",
                                    dict(zero=1), dict(remat=True),
                                    dict(localsgd_k=4),
                                    dict(dgc_sparsity=0.9)])
def test_options_of_later_slices_raise(option):
    """Options of later slices raise.  A mesh is refused unless it is a
    port ``Mesh`` of one device, the step's: an ``object()`` and a mesh
    over two devices."""
    if option == "two_device_mesh":
        from paddle_tpu_torch.parallel import make_mesh
        option = dict(mesh=make_mesh({"dp": 2}, devices=["cpu", "cpu"]))
    net = torch.nn.Linear(2, 1)
    with pytest.raises(UnimplementedError, match="later slice"):
        TrainStep(net, Adam(), device="cpu", **option)



@pytest.mark.parametrize("nesterov,wd", [(False, None), (True, None),
                                         (False, 0.01), (True, 0.01)])
def test_momentum_update_matches_jax_rule(nesterov, wd):
    """Momentum against JAX's ``_momentum_rule`` (through its
    functional_apply, which adds the coupled L2 term): 3 updates."""
    from paddle_tpu.optimizer.optimizer import Momentum as JaxMomentum
    from paddle_tpu_torch.optimizer import Momentum
    rng = np.random.RandomState(41)
    shapes = {"conv.weight": (4, 3, 3, 3), "bn.bias": (4,), "fc.weight": (4, 5)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    hp = dict(learning_rate=0.1, momentum=0.9, use_nesterov=nesterov,
              weight_decay=wd)
    jopt = JaxMomentum(**hp)
    tparams = {n: torch.from_numpy(v.copy()).requires_grad_()
               for n, v in params.items()}
    topt = Momentum(**hp, parameters=list(tparams.items()))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jstate = jopt.functional_state(jp)
    for t, g in enumerate(grads, start=1):
        jp, jstate = jopt.functional_apply(
            jp, {n: jnp.asarray(v) for n, v in g.items()}, jstate, t)
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n])
        topt.step()
    sd = topt.state_dict()
    for n, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=0, err_msg=n)
        np.testing.assert_allclose(sd[f"{n}_velocity"].numpy(),
                                   np.asarray(jstate["velocity"][n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


def _conv_nets():
    """The same small NHWC conv net (conv, BN, ReLU, pooling, classifier)
    in both packages, with the JAX weights carried across."""
    import paddle_tpu as paddle
    from paddle_tpu_torch import nn as pnn
    paddle.seed(7)
    jn = paddle.nn
    jm = jn.Sequential(
        jn.Conv2D(3, 8, 3, padding=1, bias_attr=False, data_format="NHWC"),
        jn.BatchNorm2D(8, data_format="NHWC"), jn.ReLU(),
        jn.AdaptiveAvgPool2D(1, data_format="NHWC"), jn.Flatten(),
        jn.Linear(8, 10))
    pm = torch.nn.Sequential(
        pnn.Conv2D(3, 8, 3, padding=1, bias_attr=False, data_format="NHWC",
                   device="cpu"),
        pnn.BatchNorm2D(8, data_format="NHWC", device="cpu"), pnn.ReLU(),
        pnn.AdaptiveAvgPool2D(1, data_format="NHWC"), torch.nn.Flatten(),
        torch.nn.Linear(8, 10))
    load_jax_state(pm, jax_params(jm))
    return jm, pm


def test_momentum_train_step_with_loss_fn_matches_jax():
    """TrainStep(layer, Momentum, loss_fn=CrossEntropyLoss()): the first
    loss agrees to 1e-5 (one f32 forward); the next two, after Momentum
    updates and BN running-stat updates, to 1e-4, and the loss descends;
    the running statistics agree after 3 steps to 1e-5."""
    import paddle_tpu as paddle
    from paddle_tpu.optimizer.optimizer import Momentum as JaxMomentum
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    jm, pm = _conv_nets()
    rng = np.random.RandomState(8)
    x = rng.randn(4, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, (4,)).astype(np.int64)
    jstep = JaxTrainStep(
        jm, JaxMomentum(learning_rate=0.1, momentum=0.9,
                        parameters=jm.parameters()),
        loss_fn=paddle.nn.CrossEntropyLoss(),
        mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    tstep = TrainStep(pm, Momentum(learning_rate=0.1, momentum=0.9),
                      loss_fn=CrossEntropyLoss(), device="cpu")
    want = [float(jstep((jnp.asarray(x),), jnp.asarray(y)).numpy())
            for _ in range(3)]
    got = [float(tstep((x,), y)) for _ in range(3)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < got[0]
    jstep.sync_to_layer()
    jbuf = jax_params(jm)
    for n, b in pm.named_buffers():
        np.testing.assert_allclose(b.numpy(), jbuf[n], atol=1e-5, err_msg=n)
