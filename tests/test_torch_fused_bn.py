"""The port's fused batch norm (``ops/kernels/fused_bn.py``: B5, B6 and
``fused_bn_act``) and ``nn.functional.batch_norm`` against the JAX
package on the CPU, where the port runs the kernels' plain versions and
JAX its Pallas kernels in interpret mode.  Inputs come from numpy seeds.

JAX's ``fused_bn_act`` is called directly: under this suite's eight CPU
devices JAX's ``batch_norm`` never takes its fused branch.

Tolerances (the JAX tests' tests/test_pallas_fused_bn.py, where both
sides compute in f32): mean atol 1e-5, var rtol 1e-4 atol 1e-5, y 1e-4;
gradients 1e-4 (both sides evaluate the same coefficient form in f32 and
differ in summation order only, tighter than JAX's own 2e-3 against
XLA's autodiff); the per-channel coefficient math is elementwise and is
held to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import fused_bn as jfb
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.kernels import fused_bn as tfb


def _inputs(seed, m=256, c=128, offset=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, c) + offset).astype(np.float32)
    g = (rng.rand(c) + 0.5).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("relu", [True, False])
def test_fused_bn_act_forward_matches_jax(relu):
    x, g, b = _inputs(0, 512, 128)
    y, m, v = jfb.fused_bn_act(jnp.asarray(x), jnp.asarray(g),
                               jnp.asarray(b), 1e-5, relu)
    ty, tm, tv = tfb.fused_bn_act(torch.from_numpy(x), torch.from_numpy(g),
                                  torch.from_numpy(b), 1e-5, relu)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("relu", [True, False])
def test_fused_bn_act_grads_with_stat_cotangents_match_jax(relu):
    """dx, dgamma and dbeta of a loss on y and on the returned mean and
    var (the cotangents fold into the coefficient form)."""
    import jax
    x, g, b = _inputs(2, 256, 64)
    cot = np.random.RandomState(3).randn(256, 64).astype(np.float32)

    def jloss(x_, g_, b_):
        y, m, v = jfb.fused_bn_act(x_, g_, b_, 1e-5, relu)
        return jnp.sum(y * cot) + jnp.sum(m * m) + jnp.sum(v)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(b))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    y, m, v = tfb.fused_bn_act(*leaves, 1e-5, relu)
    ((y * torch.from_numpy(cot)).sum() + (m * m).sum() + v.sum()).backward()
    for t, w, name in zip(leaves, want, ("dx", "dgamma", "dbeta")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_fused_bn_large_offset_stays_finite_as_in_jax():
    """var = max(E[x²] − mean², 0): data far from 0 stays finite."""
    x, _, _ = _inputs(1, 256, 128, offset=3000.0)
    x = (x - 3000.0) * 0.01 + 3000.0
    ones, zeros = np.ones(128, np.float32), np.zeros(128, np.float32)
    _, _, jv = jfb.fused_bn_act(jnp.asarray(x), jnp.asarray(ones),
                                jnp.asarray(zeros), 1e-5, True)
    ty, _, tv = tfb.fused_bn_act(torch.from_numpy(x), torch.from_numpy(ones),
                                 torch.from_numpy(zeros), 1e-5, True)
    assert bool(torch.isfinite(ty).all()) and bool((tv >= 0).all())
    assert np.isfinite(np.asarray(jv)).all()


def test_m_without_a_tile_raises_as_in_jax():
    x = np.zeros((13, 128), np.float32)
    ones, zeros = np.ones(128, np.float32), np.zeros(128, np.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        jfb.fused_bn_act(jnp.asarray(x), jnp.asarray(ones),
                         jnp.asarray(zeros), 1e-5, True)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfb.fused_bn_act(torch.from_numpy(x), torch.from_numpy(ones),
                         torch.from_numpy(zeros), 1e-5, True)


@pytest.mark.parametrize("relu", [True, False])
def test_each_kernel_plain_version_matches_the_jax_kernel(relu):
    """B5 stats/apply and B6 reduce/dx one by one, on the same inputs."""
    x, g, b = _inputs(4, 512, 64)
    rng = np.random.RandomState(5)
    dy = rng.randn(512, 64).astype(np.float32)
    sc, sh, a, bb, cc = (rng.randn(64).astype(np.float32) for _ in range(5))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jm, jv = jfb._moments(jx, 64)
    tm, tv = tfb.moments_plain(tx)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    t = {k: torch.from_numpy(v) for k, v in dict(
        dy=dy, sc=sc, sh=sh, a=a, b=bb, c=cc).items()}
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    np.testing.assert_allclose(
        tfb.apply_plain(tx, t["sc"], t["sh"], relu).numpy(),
        np.asarray(jfb._apply(jx, j["sc"], j["sh"], 64, relu)), atol=1e-6)
    got = tfb.bwd_reduce_plain(tx, t["dy"], t["sc"], t["sh"], relu)
    want = jfb.bn_bwd_reduce(jx, j["dy"], j["sc"], j["sh"], relu)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)
    np.testing.assert_allclose(
        tfb.bwd_dx_plain(tx, t["dy"], t["sc"], t["sh"], t["a"], t["b"],
                         t["c"], relu).numpy(),
        np.asarray(jfb.bn_bwd_dx(jx, j["dy"], j["sc"], j["sh"], j["a"],
                                 j["b"], j["c"], relu)), atol=1e-5)


@pytest.mark.parametrize("stats_cts", [False, True])
def test_bn_dx_coeffs_match_jax(stats_cts):
    rng = np.random.RandomState(6)
    v = [np.abs(rng.randn(32)).astype(np.float32) + 0.1 for _ in range(7)]
    extra = (v[5], v[6]) if stats_cts else (None, None)
    want = jfb.bn_dx_coeffs(*(jnp.asarray(a) for a in v[:5]), 1000,
                            *(None if a is None else jnp.asarray(a)
                              for a in extra))
    got = tfb.bn_dx_coeffs(*(torch.from_numpy(a) for a in v[:5]), 1000,
                           *(None if a is None else torch.from_numpy(a)
                             for a in extra))
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_batch_norm_matches_jax_train_and_eval(fused, data_format):
    """F.batch_norm in training (batch statistics, running update with
    Paddle's momentum and the biased variance) and in eval, with the
    fused path on or off in the port (JAX runs its plain path here)."""
    rng = np.random.RandomState(7)
    shape = (4, 6, 6, 16) if data_format == "NHWC" else (4, 16, 6, 6)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    g, b = _inputs(8, 8, 16)[1:]
    rm = rng.randn(16).astype(np.float32)
    rv = (rng.rand(16) + 0.5).astype(np.float32)
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    jy = paddle.nn.functional.batch_norm(
        paddle.to_tensor(x), jrm, jrv, paddle.to_tensor(g),
        paddle.to_tensor(b), training=True, momentum=0.9,
        data_format=data_format)
    je = paddle.nn.functional.batch_norm(
        paddle.to_tensor(x), jrm, jrv, paddle.to_tensor(g),
        paddle.to_tensor(b), training=False, data_format=data_format)
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_use_pallas_fused_bn": fused})
        ty = PF.batch_norm(torch.from_numpy(x), trm, trv,
                           torch.from_numpy(g), torch.from_numpy(b),
                           training=True, momentum=0.9,
                           data_format=data_format)
    finally:
        flags.flags_restore(snap)
    te = PF.batch_norm(torch.from_numpy(x), trm, trv, torch.from_numpy(g),
                       torch.from_numpy(b), training=False,
                       data_format=data_format)
    np.testing.assert_allclose(ty.numpy(), jy.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(trm.numpy(), jrm.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(trv.numpy(), jrv.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(te.numpy(), je.numpy(), rtol=1e-5, atol=1e-5)


def test_flags_default_on_and_legacy_env_vars(monkeypatch):
    """Both gates ship ON in the port (the JAX package ships them OFF);
    the legacy PADDLE_TPU_PALLAS_* variables still turn them on."""
    assert flags.get_flags(["FLAGS_use_pallas_fused_bn",
                            "FLAGS_use_pallas_fused_conv"]) == {
        "FLAGS_use_pallas_fused_bn": True,
        "FLAGS_use_pallas_fused_conv": True}
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_use_pallas_fused_bn": False,
                         "FLAGS_use_pallas_fused_conv": False})
        assert not flags.fused_bn_enabled()
        assert not flags.fused_conv_enabled()
        monkeypatch.setenv("PADDLE_TPU_PALLAS_BN", "1")
        monkeypatch.setenv("PADDLE_TPU_PALLAS_CONV", "1")
        assert flags.fused_bn_enabled() and flags.fused_conv_enabled()
    finally:
        flags.flags_restore(snap)
