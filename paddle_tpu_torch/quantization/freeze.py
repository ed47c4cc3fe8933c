"""Quantization freeze pass: QAT/PTQ models to deployable int8 programs.

Counterpart of ``paddle_tpu/quantization/freeze.py``
(quantization_pass.py:1045's QuantizationFreezePass over the imperative
model).  Each ``QuantizedLinear``/``QuantizedConv2D``, bare or under an
out-scale collector, becomes a Frozen* layer holding int8 weights and
f32 scales (buffers ``weight_int8``, ``weight_scale``, ``input_scale``,
``out_scale``) whose forward is one int8 primitive of ``ops/int8.py``:
quantize at the input scale, one i8 x i8 -> i32 GEMM, the fused
dequantize (and, folded, requantize) epilogue.  ``jit.save`` of a frozen
model exports a program whose products are ``aten._int_mm`` nodes,
which the Predictor serves under ``FLAGS_use_int8_inference``.

A frozen linear's ``weight_int8`` is [out, in], torch's layout; the
JAX package stores it [in, out] (``framework/bridge.py`` transposes).
With the collected scales the frozen output equals the fake-QDQ
simulation up to float associativity: both round at the same two
points (the input at s_x, the weight at s_w).
"""
from __future__ import annotations

import hashlib
import json
import os

import torch

from ..nn.functional.conv import _pair
from ..nn.layer.layers import Layer
from . import functional as QF
from .quant_layers import (FakeChannelWiseQuantDequantAbsMax,
                           FakeQuantMovingAverage, QuantizedConv2D,
                           QuantizedLinear)

ARTIFACT_FORMAT = "torch_export"


def _static_input_scale(fq):
    """Collected input scale of an activation quantizer, or None when it
    is dynamic (per-batch abs-max)."""
    if isinstance(fq, FakeQuantMovingAverage):
        return fq.scale.detach().float().reshape(()).clone()
    return None


def _weight_quant(fq, weight, bits):
    """(int8 codes, f32 scales, per_channel) from the weight quantizer's
    configuration."""
    if isinstance(fq, FakeChannelWiseQuantDequantAbsMax):
        q, s = QF.quantize_weight_int8(weight, quant_axis=fq._quant_axis,
                                       bit_length=bits)
        return q, s, True
    q, s = QF.quantize_weight_int8(weight, quant_axis=None, bit_length=bits)
    return q, s, False


class _FrozenSite(Layer):
    """The state of a frozen site.  The collected out-scale is always
    recorded in ``out_scale``; it enters the epilogue as a requantize
    step only when folded (``fold_out_scale``)."""

    def __init__(self, qlayer, weight_bits, activation_bits, out_scale,
                 fold_out_scale):
        super().__init__()
        self._weight_bits = int(weight_bits)
        self._activation_bits = int(activation_bits)
        w_q, s_w, self._per_channel = _weight_quant(
            qlayer._fake_quant_weight, qlayer.weight, weight_bits)
        dev = w_q.device
        self.register_buffer("weight_int8", w_q)
        self.register_buffer("weight_scale", s_w.reshape(-1))
        s_x = _static_input_scale(qlayer._fake_quant_input)
        self._dynamic = s_x is None
        self.register_buffer("input_scale", torch.ones((), device=dev)
                             if s_x is None else s_x.to(dev))
        self.bias = qlayer.bias
        self._has_out_scale = out_scale is not None and fold_out_scale
        self.register_buffer("out_scale", torch.tensor(
            0.0 if out_scale is None else float(out_scale),
            dtype=torch.float32, device=dev))

    def _int8_args(self):
        return dict(bias=self.bias,
                    out_scale=self.out_scale if self._has_out_scale
                    else None,
                    bits=self._activation_bits, dynamic=self._dynamic)


class FrozenQuantizedLinear(_FrozenSite):
    """A frozen linear site: int8 weight [out, in], per-channel or
    per-tensor scales; forward = ``ops.int8.linear_int8``."""

    def __init__(self, qlayer: QuantizedLinear, weight_bits=8,
                 activation_bits=8, out_scale=None, fold_out_scale=False):
        super().__init__(qlayer, weight_bits, activation_bits, out_scale,
                         fold_out_scale)

    def forward(self, x):
        from ..ops import int8 as I8
        return I8.linear_int8(x, self.weight_int8, self.input_scale,
                              self.weight_scale, **self._int8_args())


class FrozenQuantizedConv2D(_FrozenSite):
    """A frozen conv2d site: int8 OIHW weight, per-output-channel (or
    per-tensor) scales; forward = ``ops.int8.conv2d_int8``."""

    def __init__(self, qlayer: QuantizedConv2D, weight_bits=8,
                 activation_bits=8, out_scale=None, fold_out_scale=False):
        super().__init__(qlayer, weight_bits, activation_bits, out_scale,
                         fold_out_scale)
        self._stride = qlayer._stride
        self._padding = qlayer._padding
        self._dilation = qlayer._dilation
        self._groups = qlayer._groups
        self._data_format = qlayer._data_format

    def forward(self, x):
        from ..ops import int8 as I8
        return I8.conv2d_int8(
            x, self.weight_int8, self.input_scale, self.weight_scale,
            stride=_pair(self._stride), padding=self._padding,
            dilation=_pair(self._dilation), groups=int(self._groups),
            channel_last=self._data_format == "NHWC", **self._int8_args())


_FROZEN = ((QuantizedLinear, FrozenQuantizedLinear),
           (QuantizedConv2D, FrozenQuantizedConv2D))
FROZEN_SITES = (FrozenQuantizedLinear, FrozenQuantizedConv2D)


def _collected_out_scale(wrapper):
    """The out-scale a collector observed, or None when it never saw a
    training or calibration forward (its state still at the initial 1.0):
    folding an unobserved scale would clip every output to [-1, 1]."""
    if float(wrapper._out_scale.state) == 1.0:
        return None
    return float(wrapper._out_scale.scale)


class QuantizationFreezePass:
    """quantization_pass.py:1045 parity over the imperative model.

    ``apply(model)`` swaps every fake-quantized site for its frozen int8
    form in place (idempotent: frozen layers are left alone), recording
    the collected out-scales (from an enclosing ImperativeCalcOutScale
    collector or PTQ calibration); ``frozen_sites`` counts the rewrites.
    ``fold_out_scales=True`` also requantizes each site's output onto its
    out-scale int8 grid in the epilogue: one rounding more than the
    fake-quant simulation, so the default only records it."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 fold_out_scales=False):
        self._weight_bits = int(weight_bits)
        self._activation_bits = int(activation_bits)
        self._fold_out_scales = bool(fold_out_scales)
        self.frozen_sites = 0

    def _freeze_one(self, layer, out_scale=None):
        if out_scale is None:
            # PTQ records the observed output scale on the site itself;
            # QAT sites get theirs from the enclosing collector
            out_scale = getattr(layer, "_frozen_out_scale", None)
        for cls, fcls in _FROZEN:
            if isinstance(layer, cls):
                self.frozen_sites += 1
                return fcls(layer, weight_bits=self._weight_bits,
                            activation_bits=self._activation_bits,
                            out_scale=out_scale,
                            fold_out_scale=self._fold_out_scales)
        return None

    def apply(self, model):
        self._walk(model)
        return model

    def _walk(self, layer):
        from .qat import _OutScaleWrapper
        for name, child in list(layer.named_children()):
            if isinstance(child, _OutScaleWrapper):
                frozen = self._freeze_one(
                    child._inner, out_scale=_collected_out_scale(child))
                if frozen is not None:
                    # the collector's scale now lives in the frozen site,
                    # so the wrapper goes too
                    setattr(layer, name, frozen)
                else:
                    self._walk(child)
                continue
            frozen = self._freeze_one(child)
            if frozen is not None:
                setattr(layer, name, frozen)
            else:
                self._walk(child)


def freeze(model, weight_bits=8, activation_bits=8, fold_out_scales=False):
    """Freeze a QAT- or PTQ-calibrated model to int8 execution, in place.
    Raises when the model has no fake-quantized site (run
    ImperativeQuantAware or PostTrainingQuantization first)."""
    p = QuantizationFreezePass(weight_bits=weight_bits,
                               activation_bits=activation_bits,
                               fold_out_scales=fold_out_scales)
    p.apply(model)
    if p.frozen_sites == 0:
        raise ValueError(
            "freeze: no QuantizedLinear/QuantizedConv2D sites found — "
            "quantize the model (QAT or PTQ) before freezing")
    model.eval()
    return model


def _frozen_sites(model):
    """(name, site) of every frozen site below ``model``, in the order of
    the JAX package's ``named_sublayers()``."""
    return [(n, m) for n, m in model.named_modules()
            if n and isinstance(m, FROZEN_SITES)]


def quant_signature(model):
    """sha1 over each frozen site's name, bits, layout flags and scales:
    the JAX package's digest (freeze.py:240-255), byte for byte."""
    h = hashlib.sha1()
    for name, sub in _frozen_sites(model):
        h.update(name.encode())
        h.update(bytes([sub._weight_bits, sub._activation_bits,
                        sub._per_channel, sub._dynamic,
                        sub._has_out_scale]))
        for t in (sub.weight_scale, sub.input_scale, sub.out_scale):
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def save_int8_model(model, path, input_spec=None, **configs):
    """Freeze (if not frozen yet) and export the int8 artifact beside a
    float export: ``<path>.int8.pdmodel`` (``jit.save``) and
    ``<path>.quant.json``, the sidecar the Predictor reads.  Returns the
    ``<path>.int8`` prefix.  The Predictor picks the ``.int8`` sibling
    when ``FLAGS_use_int8_inference`` is on."""
    from .. import jit
    if not _frozen_sites(model):
        freeze(model)
    model.eval()
    jit.save(model, path + ".int8", input_spec=input_spec, **configs)
    with open(path + ".quant.json", "w") as f:
        json.dump({"int8": True, "signature": quant_signature(model),
                   "sites": len(_frozen_sites(model)), "weight_bits": 8,
                   "format": ARTIFACT_FORMAT}, f)
    return path + ".int8"


def load_quant_sidecar(prefix):
    """The ``<prefix>.quant.json`` sidecar, or None."""
    p = prefix + ".quant.json"
    if not os.path.isfile(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
