"""The port's ``quantization/`` and ``ops/int8.py`` against the JAX
package on the CPU: the fake quant-dequant ops and their straight-through
gradient, int8 weight storage, the QAT swap and one QAT step, PTQ on
LeNet from bridged weights, the frozen linear and conv sites on one
carried frozen state (``load_jax_state`` transposes a frozen linear's
codes), ``quant_signature`` and the freeze pass's contracts.

Tolerances: int8 codes and int32 accumulators are equal; the fake-QDQ
outputs and the calibrated scales rtol 1e-6 (the same f32 operations in
the same order); a QAT step's outputs rtol 1e-5 / atol 1e-6 and each
gradient within 1e-5 of its max |ref| (the f32 conv and GEMM sum in
another order than XLA's, a bias gradient sums thousands of terms that
cancel: reading 6e-7 of its max; no fake-quant input lands within that
of a half step here); a frozen
site's output against JAX's on the same frozen state within 1e-6 of
max |ref|: the codes and the accumulator are equal and the epilogue is
the same f32 operations (readings: 0 to 1.2e-7), far inside the JAX
package's own frozen-against-simulation bound of 1e-2
(tests/test_int8_freeze.py:67-80).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from chip_smoke import bench_block
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as jq
from paddle_tpu.ops import int8 as jint8
from paddle_tpu.quantization import functional as jqf
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.ops import int8 as pint8
from paddle_tpu_torch.quantization.functional import _QdqSTE
from paddle_tpu_torch.text.models import BertConfig
from paddle_tpu_torch.text.models.bert import BertModel
from paddle_tpu_torch.vision.models import LeNet
from test_torch_bench_serving import _jax_block
from torch_port_util import jax_params

QMAX = 127.0
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-5
FROZEN_RTOL = 1e-6


def _codes(out, scale):
    """The int8 grid index of each quant-dequant output."""
    return np.rint(np.asarray(out) / (np.asarray(scale) / QMAX))


def _sites(model, kinds):
    return sum(isinstance(m, kinds) for m in (
        model.sublayers() if hasattr(model, "sublayers")
        else model.modules()))


@pytest.mark.parametrize("kind", ["abs_max", "channel_wise",
                                  "moving_average"])
def test_fake_qdq_and_its_gradient_match_jax(kind):
    """Each fake quant-dequant op against JAX's raw function on the same
    input: codes equal, outputs and scales rtol 1e-6, and the
    straight-through gradient of sum(out * g) equal to JAX's custom_vjp
    (the moving average threads its state over three training steps,
    then quantizes a 4x larger input at the collected scale, so that
    values clip and the gradient's mask bites)."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 4, 3, 3).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    if kind == "abs_max":
        jfn = lambda v: jqf._fake_qdq_abs_max_fn(v)               # noqa: E731
        pfn = pq.fake_quantize_dequantize_abs_max
    elif kind == "channel_wise":
        jfn = lambda v: jqf._fake_qdq_channel_fn(v, quant_axis=0)  # noqa
        pfn = lambda v: pq.fake_channel_wise_quantize_dequantize_abs_max(
            v, quant_axis=0)                                       # noqa
    else:
        js = [jnp.float32(1.0)] * 3
        ps = [torch.tensor(1.0)] * 3
        for k in range(3):
            xk = rng.randn(*x.shape).astype(np.float32) * (k + 1)
            _, *js = jqf._fake_qdq_moving_fn(jnp.asarray(xk), *js)
            _, *ps = pq.fake_quantize_dequantize_moving_average_abs_max(
                torch.from_numpy(xk), *ps)
            for a, b in zip(ps, js):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6)
        x = x * 4.0
        jfn = lambda v: jqf._fake_qdq_moving_fn(                   # noqa
            v, *js, is_test=True)[:2]
        pfn = lambda v: pq.fake_quantize_dequantize_moving_average_abs_max(
            v, *ps, is_test=True)[:2]                              # noqa
    jout, jscale = jfn(jnp.asarray(x))
    jgrad = jax.grad(lambda v: jnp.sum(jfn(v)[0] * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pout, pscale = pfn(xt)
    (pout * torch.from_numpy(g)).sum().backward()
    shape = (-1, 1, 1, 1) if kind == "channel_wise" else ()
    assert np.array_equal(
        _codes(pout.detach().numpy(), pscale.detach().numpy().reshape(shape)),
        _codes(jout, np.asarray(jscale).reshape(shape)))
    np.testing.assert_allclose(pscale.detach().numpy(), np.asarray(jscale),
                               rtol=1e-6)
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               rtol=1e-6)
    assert np.array_equal(xt.grad.numpy(), np.asarray(jgrad))
    if kind == "moving_average":
        assert 0 < (xt.grad.numpy() == 0).mean() < 0.5   # some values clip
    # the scale's own gradient is zero, as JAX's custom_vjp gives it
    s = torch.tensor(1.0, requires_grad=True)
    _QdqSTE.apply(xt.detach(), s, QMAX).sum().backward()
    assert s.grad.item() == 0.0


def test_weight_int8_codes_match_jax():
    """quantize_weight_int8 and dequantize_weight: per channel along a
    conv's axis 0 and a linear's output axis (1 in JAX's [in, out], 0 in
    the port's [out, in]), and per tensor; codes and dequantized values
    equal."""
    rng = np.random.RandomState(1)
    conv = rng.randn(8, 3, 3, 3).astype(np.float32)
    lin = (rng.randn(16, 8) * np.logspace(-2, 0, 8)).astype(np.float32)
    cases = [(conv, False, 0, 0), (lin, True, 1, 0), (lin, True, None, None)]
    for jw, flip, jaxis, paxis in cases:
        pw = jw.T if flip else jw
        jqw, js = jq.quantize_weight_int8(jpaddle.to_tensor(jw),
                                          quant_axis=jaxis)
        pqw, ps = pq.quantize_weight_int8(torch.from_numpy(pw),
                                          quant_axis=paxis)
        assert pqw.dtype == torch.int8
        jqn, jdn = jqw.numpy(), jq.dequantize_weight(jqw, js).numpy()
        assert np.array_equal(pqw.numpy(), jqn.T if flip else jqn)
        assert np.array_equal(ps.numpy().reshape(-1),
                              js.numpy().reshape(-1))
        pdn = pq.dequantize_weight(pqw, ps).numpy()
        assert np.array_equal(pdn, jdn.T if flip else jdn)


def test_qat_swaps_and_one_step_match_jax():
    """ImperativeQuantAware swaps LeNet's 5 sites and a 2-layer BERT's 13
    (6 a layer through the plain-module encoder, and the pooler) as JAX's
    does; one training-mode QAT forward and backward of LeNet from
    bridged weights matches JAX's: outputs, the moving-average buffers
    and every gradient (a linear's transposed)."""
    qkinds = (pq.QuantizedConv2D, pq.QuantizedLinear)
    jpaddle.seed(3)
    jm, pm = jpaddle.vision.models.LeNet(), LeNet(device="cpu")
    load_jax_state(pm, jax_params(jm))
    jq.ImperativeQuantAware().quantize(jm)
    pq.ImperativeQuantAware().quantize(pm)
    assert _sites(pm, qkinds) == _sites(
        jm, (jq.QuantizedConv2D, jq.QuantizedLinear)) == 5
    jb = jpaddle.text.models.bert.BertModel(
        jpaddle.text.models.bert.BertConfig.tiny())
    pb = BertModel(BertConfig.tiny(), device="cpu")
    jq.ImperativeQuantAware().quantize(jb)
    pq.ImperativeQuantAware().quantize(pb)
    assert _sites(pb, qkinds) == _sites(
        jb, (jq.QuantizedConv2D, jq.QuantizedLinear)) == 13
    assert isinstance(pb.encoder.layers[1].self_attn.v_proj,
                      pq.QuantizedLinear)
    rng = np.random.RandomState(4)
    x = rng.randn(4, 1, 28, 28).astype(np.float32)
    g = rng.randn(4, 10).astype(np.float32)
    jm.train()
    pm.train()
    jout = jm(jpaddle.to_tensor(x))
    jpaddle.sum(jout * jpaddle.to_tensor(g)).backward()
    pout = pm(torch.from_numpy(x))
    (pout * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(pout.detach().numpy(), jout.numpy(),
                               **STEP_TOL)
    jstate = dict(jm.named_buffers())
    for name, b in pm.named_buffers():
        np.testing.assert_allclose(b.numpy(), jstate[name].numpy(),
                                   rtol=1e-6)
    jparams = dict(jm.named_parameters())
    for name, p in pm.named_parameters():
        want = jparams[name].grad.numpy()
        got = p.grad.numpy()
        if name.startswith("fc.") and name.endswith("weight"):
            got = got.T
        assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max()


def _ptq(model, cal, package):
    """bench.py's PTQ (bench.py:743-760): 4 batches of one input."""
    if package is jq:
        batches = ((jpaddle.to_tensor(cal),) for _ in range(4))
    else:
        batches = ((cal,) for _ in range(4))
    ptq = package.PostTrainingQuantization(model=model, data_loader=batches,
                                           batch_nums=4)
    ptq.quantize()
    return ptq


def _frozen_pair(jm, pm, shape, seed=0):
    """PTQ both (pm carries jm's weights), freeze both, then carry JAX's
    frozen state into the port's: (JAX's PTQ, the port's PTQ)."""
    load_jax_state(pm, jax_params(jm))
    jm.eval()
    pm.eval()
    cal = np.random.RandomState(seed).randn(1, *shape).astype(np.float32)
    jptq, pptq = _ptq(jm, cal, jq), _ptq(pm, cal, pq)
    jq.freeze(jm)
    pq.freeze(pm)
    load_jax_state(pm, jax_params(jm))
    return jptq, pptq


def test_ptq_lenet_matches_jax():
    """PTQ on LeNet from bridged weights: every site's calibrated input
    and output scale against JAX's (rtol 1e-6), 5 frozen sites, and on
    the carried frozen state the same quant_signature and outputs within
    FROZEN_RTOL of max |ref|."""
    jpaddle.seed(5)
    jm, pm = jpaddle.vision.models.LeNet(), LeNet(device="cpu")
    jptq, pptq = _frozen_pair(jm, pm, (1, 28, 28))
    assert sorted(pptq._scales) == sorted(jptq._scales) == [
        "fc.0", "fc.1", "fc.2", "features.0", "features.3"]
    for name in jptq._scales:
        np.testing.assert_allclose(pptq._scales[name], jptq._scales[name],
                                   rtol=1e-6)
        np.testing.assert_allclose(pptq._out_scales[name],
                                   jptq._out_scales[name], rtol=1e-6)
    frozen = (pq.FrozenQuantizedConv2D, pq.FrozenQuantizedLinear)
    assert _sites(pm, frozen) == 5
    assert pm.fc[2].weight_int8.shape == (10, 84)      # torch's [out, in]
    assert pq.quant_signature(pm) == jq.quant_signature(jm)
    x = np.random.RandomState(6).randn(3, 1, 28, 28).astype(np.float32)
    want = jm(jpaddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= FROZEN_RTOL * np.abs(want).max()


def test_block_signature_and_the_freeze_pass_contracts():
    """bench.py's residual block (ch 8, hw 8) through PTQ and freeze in
    both packages: the same quant_signature on the carried state; a
    second freeze pass finds nothing (idempotent); freezing a model with
    no quantized site raises."""
    jpaddle.seed(7)
    jm, pm = _jax_block(), bench_block(8, device="cpu")
    _frozen_pair(jm, pm, (8, 8, 8))
    assert isinstance(pm.c1, pq.FrozenQuantizedConv2D)
    assert not any(n.endswith("c1.weight") for n, _ in pm.named_parameters())
    assert pq.quant_signature(pm) == jq.quant_signature(jm)
    p = pq.QuantizationFreezePass()
    p.apply(pm)
    assert p.frozen_sites == 0
    with pytest.raises(ValueError, match="no Quantized"):
        pq.freeze(bench_block(8, device="cpu"))


FROZEN_CASES = {
    # (layer kwargs, ImperativeQuantAware kwargs, out-scale collected and
    # folded)
    "linear_per_tensor": ("linear", {}, dict(weight_quantize_type="abs_max"),
                          False),
    "linear_per_channel_folded": ("linear", {}, {}, True),
    "linear_dynamic": ("linear", {}, dict(activation_quantize_type="abs_max"),
                       False),
    "conv_stride_padding": ("conv", dict(stride=2, padding=2), {}, False),
    "conv_groups": ("conv", dict(groups=2, padding=1),
                    dict(weight_quantize_type="abs_max"), False),
}


def _qat_converged(model, x, steps=8):
    model.train()
    for _ in range(steps):
        model(x)
    model.eval()


@pytest.mark.parametrize("case", list(FROZEN_CASES))
def test_frozen_site_matches_jax(case):
    """One frozen linear or conv site, QAT-calibrated in each package and
    frozen, then run on JAX's frozen state carried across: the same
    layout flags, int8 input codes and int32 accumulator equal to JAX's
    (its quantizer, then its lax product at int32), and the output
    within FROZEN_RTOL of max |ref|."""
    kind, layer_kw, qat_kw, fold = FROZEN_CASES[case]
    rng = np.random.RandomState(8)
    jpaddle.seed(8)
    if kind == "linear":
        jl, pl = jnn.Linear(16, 8), pnn.Linear(16, 8, device="cpu")
        x = rng.randn(32, 16).astype(np.float32)
    else:
        jl = jnn.Conv2D(4, 6 if "groups" not in layer_kw else 4, 3,
                        **layer_kw)
        pl = pnn.Conv2D(4, jl.weight.shape[0], 3, device="cpu", **layer_kw)
        x = rng.randn(2, 4, 9, 9).astype(np.float32)
    jm, pm = jnn.Sequential(jl), pnn.Sequential(pl)
    load_jax_state(pm, jax_params(jm))
    for pkg, m, xx in ((jq, jm, jpaddle.to_tensor(x)),
                       (pq, pm, torch.from_numpy(x))):
        pkg.ImperativeQuantAware(**qat_kw).quantize(m)
        if fold:
            pkg.ImperativeCalcOutScale().calc_out_scale(m)
        _qat_converged(m, xx)
        pkg.freeze(m, fold_out_scales=fold)
    load_jax_state(pm, jax_params(jm))
    js, ps = jm[0], pm[0]
    flags = ("_per_channel", "_dynamic", "_has_out_scale")
    assert [getattr(ps, f) for f in flags] == [getattr(js, f) for f in flags]
    assert ps._has_out_scale == fold
    # the input codes and the integer accumulator
    xs = jnp.asarray(x)
    s = jnp.max(jnp.abs(xs)) if js._dynamic else js.input_scale._value
    jxq, _ = jint8._quantize_act(xs, s, QMAX)
    pxq, _ = pint8._quantize_act(torch.from_numpy(x), torch.from_numpy(
        np.asarray(s)), QMAX)
    assert np.array_equal(pxq.numpy(), np.asarray(jxq))
    w = ps.weight_int8
    if kind == "linear":
        jacc = np.asarray(jint8.matmul_int8(jxq, js.weight_int8._value))
        pacc = pint8.int8_mm(pxq, w).numpy()
    else:
        dn = jax.lax.conv_dimension_numbers(
            jxq.shape, js.weight_int8._value.shape, ("NCHW", "OIHW", "NCHW"))
        jacc = np.asarray(jax.lax.conv_general_dilated(
            jxq, js.weight_int8._value, window_strides=(js._stride,) * 2
            if isinstance(js._stride, int) else js._stride,
            padding=[(js._padding, js._padding)] * 2,
            dimension_numbers=dn, feature_group_count=js._groups,
            preferred_element_type=jnp.int32)).transpose(0, 2, 3, 1)
        rows, (ho, wo) = pint8._im2col(
            pxq.permute(0, 2, 3, 1), (3, 3), (ps._stride,) * 2, ps._padding,
            (1, 1))
        g = ps._groups
        w2 = torch.block_diag(*w.reshape(g, w.shape[0] // g, -1).unbind(0))
        pacc = pint8.int8_mm(rows, w2).reshape(x.shape[0], ho, wo, -1) \
            .numpy()
    assert pacc.dtype == np.int32 and np.array_equal(pacc, jacc)
    want = jm(jpaddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FROZEN_RTOL * np.abs(want).max()
