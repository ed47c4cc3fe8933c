"""The port's fused conv (``ops/kernels/fused_conv.py``: B7 and
``fused_conv_bn_act``), the s2d stem reorg, the eligibility gates and
the conv/pooling functionals against the JAX package on the CPU, where
the port runs the kernels' plain versions and JAX its Pallas kernels in
interpret mode.  Inputs come from numpy seeds.

Tolerances: tests/test_pallas_fused_conv.py holds JAX's kernel to XLA at
mean/var 1e-4, y 1e-3 and gradients 2e-3.  Here both sides compute in
f32 and differ in the order of the conv's and the reductions' sums
only: mean/var 1e-5, y 1e-4, gradients 1e-4; the plain conv functionals
1e-5.  The s2d reorg moves values and is held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import fused_conv as jfc
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.kernels import fused_conv as tfc


def _inputs(n=2, h=8, cin=4, cout=8, k=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, cin).astype(np.float32)
    w = (rng.randn(cout, cin, k, k) * 0.1).astype(np.float32)
    g = (rng.rand(cout) + 0.5).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, g, b


# the five sites of tests/test_pallas_fused_conv.py::test_forward_matches_xla
CASES = [(3, 1, 1, True), (1, 1, 0, False), (3, 2, 1, True),
         (1, 2, 0, True), (5, 1, 2, True)]


@pytest.mark.parametrize("k,stride,pad,relu", CASES)
def test_fused_conv_bn_act_forward_matches_jax(k, stride, pad, relu):
    x, w, g, b = _inputs(k=k)
    y, m, v = jfc.fused_conv_bn_act(*(jnp.asarray(a) for a in (x, w, g, b)),
                                    stride, pad, 1e-5, relu)
    ty, tm, tv = tfc.fused_conv_bn_act(
        *(torch.from_numpy(a) for a in (x, w, g, b)), stride, pad, 1e-5,
        relu)
    assert tuple(ty.shape) == tuple(y.shape)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("k,stride,pad,relu", CASES[:3])
def test_fused_conv_bn_act_vjp_matches_jax(k, stride, pad, relu):
    """dX, dW, dgamma, dbeta through the custom backward, a loss on y and
    on the returned mean and var."""
    x, w, g, b = _inputs(k=k, seed=2)
    y0 = tfc.fused_conv_bn_act(*(torch.from_numpy(a) for a in (x, w, g, b)),
                               stride, pad, 1e-5, relu)[0]
    cot = np.random.RandomState(3).randn(*y0.shape).astype(np.float32)

    def jloss(*args):
        y, m, v = jfc.fused_conv_bn_act(*args, stride, pad, 1e-5, relu)
        return jnp.sum(y * cot) + jnp.sum(m * m) + jnp.sum(v)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, g, b)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, g, b)]
    y, m, v = tfc.fused_conv_bn_act(*leaves, stride, pad, 1e-5, relu)
    ((y * torch.from_numpy(cot)).sum() + (m * m).sum() + v.sum()).backward()
    for t, wnt, name in zip(leaves, want, ("dx", "dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (5, 1, 2), (4, 1, 0)])
def test_conv_stats_plain_version_matches_the_jax_kernel(k, stride, pad):
    """B7 alone: the conv and its moments from the f32 accumulator."""
    x, w, _, _ = _inputs(cin=12, cout=16, k=k, seed=4)
    y, m, v, _ = jfc._conv_stats(jnp.asarray(x), jnp.asarray(w), stride,
                                 pad)
    ty, tm, tv = tfc.conv_stats(torch.from_numpy(x), torch.from_numpy(w),
                                stride, pad)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=1e-5,
                               atol=1e-5)


def _im2col_k_order(x, kh, kw, stride, pad, cpad, kpad):
    """[M, kpad]: each output pixel's input taps in the bf16 kernel's K
    order, k = (u·kw + v)·cpad + c, zero in the padded places."""
    n, h, w, cin = x.shape
    ho, wo = tfc.out_hw(h, w, kh, kw, stride, pad)
    xp = torch.nn.functional.pad(x, (0, cpad - cin, pad, pad, pad, pad))
    taps = [xp[:, u:u + stride * (ho - 1) + 1:stride,
               v:v + stride * (wo - 1) + 1:stride, :]
            for u in range(kh) for v in range(kw)]
    a = torch.stack(taps, 3).reshape(n * ho * wo, kh * kw * cpad)
    return torch.nn.functional.pad(a, (0, kpad - a.shape[1]))


@pytest.mark.parametrize("n,h,cin,cout,k,stride,pad", [
    (2, 11, 12, 64, 4, 1, 0),    # the s2d stem: four taps in a K step
    (1, 7, 20, 36, 3, 1, 1),     # Cin and Cout off the vector widths
    (2, 9, 64, 24, 3, 2, 1),     # stride 2, one tap a K step
    (2, 6, 3, 8, 5, 1, 2),       # Cin 3, 25 taps
    (1, 6, 136, 16, 1, 2, 0),    # a tap longer than one K step
])
def test_bf16_weight_layout_and_k_order_rebuild_the_conv(n, h, cin, cout, k,
                                                         stride, pad):
    """The bf16 kernel's operands as the wrapper lays them out (the weight
    by ``weight_kmajor``, the input gathered in the kernel's K order): a
    plain product of the two is the conv of ``conv_stats_plain``."""
    x, w, _, _ = _inputs(n=n, h=h, cin=cin, cout=cout, k=k, seed=13)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    wk = tfc.weight_kmajor(w)
    cpad = -(-cin // tfc.CIN_ALIGN) * tfc.CIN_ALIGN
    assert wk.shape == (cout, -(-k * k * cpad // tfc.K_STEP) * tfc.K_STEP)
    assert wk.is_contiguous()
    a = _im2col_k_order(x, k, k, stride, pad, cpad, wk.shape[1])
    want = tfc.conv_stats_plain(x, w, stride, pad)[0]
    got = (a.double() @ wk.double().T).reshape(want.shape)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_stem_s2d_reorg_equals_jax_exactly():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    w7 = rng.randn(8, 3, 7, 7).astype(np.float32)
    np.testing.assert_array_equal(
        tfc.stem_s2d_input(torch.from_numpy(x)).numpy(),
        np.asarray(jfc.stem_s2d_input(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tfc.stem_s2d_weight(torch.from_numpy(w7)).numpy(),
        np.asarray(jfc.stem_s2d_weight(jnp.asarray(w7))))


SUPPORT_CASES = [
    ((256, 56, 56, 64), (64, 64, 1, 1), 1, 0, 1, 1, True),
    ((256, 56, 56, 64), (256, 64, 3, 3), 1, 1, 1, 1, True),
    ((256, 28, 28, 128), (128, 128, 3, 3), 1, 1, 1, 1, True),
    ((2, 8, 8, 4), (8, 4, 3, 3), 1, 1, 1, 1, False),      # NCHW
    ((2, 8, 8, 4), (8, 2, 3, 3), 1, 1, 1, 2, True),       # groups
    ((2, 8, 8, 4), (8, 4, 3, 3), 1, 1, 2, 1, True),       # dilation
    ((2, 224, 224, 3), (64, 3, 7, 7), 2, 3, 1, 1, True),  # 7x7 direct
    ((2, 8, 8, 4), (8, 4, 3, 3), 3, 1, 1, 1, True),       # stride 3
    ((1, 5, 5, 4), (8, 4, 3, 3), 2, 1, 1, 1, True),       # M % 8
    ((2, 8, 8, 4), (8, 4, 3, 3), (1, 2), 1, 1, 1, True),  # uneven stride
    ((2, 8, 8, 4), (8, 4, 3, 3), 1, (1, 2), 1, 1, True),  # uneven pad
    ((2, 8, 8, 4), (8, 4, 3, 3), 1, (1, 1), 1, 1, True),
    ((2, 9, 9, 16), (24, 16, 5, 5), 2, 2, 1, 1, True),
]


@pytest.mark.parametrize("case", SUPPORT_CASES)
def test_supports_matches_jax(case):
    xs, ws, s, p, d, gr, cl = case
    assert tfc.supports(xs, ws, s, p, d, gr, channel_last=cl) == \
        jfc.supports(xs, ws, s, p, d, gr, channel_last=cl)


def test_supports_drops_the_tpu_vmem_cap():
    """A site whose per-image working set exceeds the TPU's 12 MB VMEM
    cap: JAX declines it, the CUDA kernel (tiled in shared memory) takes
    it.  The other dropped clause, the device count, is the TPU's too."""
    xs, ws = (8, 224, 224, 64), (64, 64, 3, 3)
    assert not jfc.supports(xs, ws, 1, 1)
    assert tfc.supports(xs, ws, 1, 1)


@pytest.mark.parametrize("xs,ws", [
    ((256, 224, 224, 3), (64, 3, 7, 7)), ((256, 225, 225, 3), (64, 3, 7, 7)),
    ((256, 224, 224, 3), (64, 3, 3, 3)), ((2, 32, 32, 3), (64, 3, 7, 7)),
    ((1, 2, 2, 3), (64, 3, 7, 7))])
def test_stem_supported_matches_jax(xs, ws):
    assert tfc.stem_supported(xs, ws) == jfc.stem_supported(xs, ws)


@pytest.mark.parametrize("data_format,padding,stride", [
    ("NHWC", 1, 1), ("NCHW", 1, 2), ("NHWC", "SAME", 2), ("NHWC", "VALID", 1),
    ("NCHW", [0, 1, 1, 2], 1), ("NHWC", (2, 1), 1)])
def test_conv2d_matches_jax(data_format, padding, stride):
    rng = np.random.RandomState(9)
    shape = (2, 9, 9, 4) if data_format == "NHWC" else (2, 4, 9, 9)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    want = paddle.nn.functional.conv2d(
        paddle.to_tensor(x), paddle.to_tensor(w), paddle.to_tensor(b),
        stride=stride, padding=padding, data_format=data_format).numpy()
    got = PF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), stride=stride, padding=padding,
                    data_format=data_format).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_pooling_matches_jax(data_format):
    rng = np.random.RandomState(10)
    shape = (2, 9, 7, 4) if data_format == "NHWC" else (2, 4, 9, 7)
    x = rng.randn(*shape).astype(np.float32)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    F = paddle.nn.functional
    np.testing.assert_array_equal(
        PF.max_pool2d(tx, 3, 2, 1, data_format=data_format).numpy(),
        F.max_pool2d(jx, 3, 2, 1, data_format=data_format).numpy())
    for out in ((1, 1), (3, 3), (2, 7)):
        np.testing.assert_allclose(
            PF.adaptive_avg_pool2d(tx, out, data_format).numpy(),
            F.adaptive_avg_pool2d(jx, out, data_format).numpy(),
            rtol=1e-6, atol=1e-6, err_msg=str(out))


@pytest.mark.parametrize("fused", [True, False])
def test_conv_bn_act_matches_jax(fused):
    """F.conv_bn_act with the port's gate on and off against JAX's plain
    composition: output, running statistics and gradients."""
    x, w, g, b = _inputs(n=4, cin=4, cout=8, seed=11)
    rng = np.random.RandomState(12)
    rm, rv = rng.randn(8).astype(np.float32), (rng.rand(8) + 0.5) \
        .astype(np.float32)
    jargs = [paddle.to_tensor(a) for a in (x, w, g, b)]
    for t in jargs:
        t.stop_gradient = False
    jrm, jrv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    jy = paddle.nn.functional.conv_bn_act(
        *jargs, jrm, jrv, stride=2, padding=1, act="relu")
    paddle.mean(jy * jy).backward()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, g, b)]
    trm, trv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_use_pallas_fused_conv": fused})
        assert PF.conv_bn_fusable(leaves[0], leaves[1], 2, 1, 1, 1,
                                  "NHWC") is fused
        ty = PF.conv_bn_act(*leaves, trm, trv, stride=2, padding=1,
                            act="relu")
    finally:
        flags.flags_restore(snap)
    (ty * ty).mean().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(trm.numpy(), jrm.numpy(), atol=1e-5)
    np.testing.assert_allclose(trv.numpy(), jrv.numpy(), atol=1e-5)
    for t, j, name in zip(leaves, jargs, ("dx", "dw", "dgamma", "dbeta")):
        np.testing.assert_allclose(t.grad.numpy(), j.grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
