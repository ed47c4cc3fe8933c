"""Imperative quantization-aware training (QAT).

Counterpart of ``paddle_tpu/quantization/qat.py``:
``ImperativeQuantAware.quantize`` swaps a model's Conv2D and Linear
sublayers for fake-quantized ones, ``ImperativeCalcOutScale`` wraps the
activation-producing sublayers in out-scale collectors.

The walk goes through ``named_children()``: the port's BERT and its
transformer layers are plain ``torch.nn.Module``s, not ``Layer``s, and a
site is reached through them, through ``Sequential``s and through
``LayerList``s alike.  A site is any ``torch.nn.Linear`` (the port's
``Linear`` and BERT's pooler) or the port's ``Conv2D``.
"""
from __future__ import annotations

from torch import nn

from ..framework.place import module_device
from ..nn.layer.conv import Conv2D
from ..nn.layer.layers import Layer
from .quant_layers import (MovingAverageAbsMaxScale, QuantizedConv2D,
                           QuantizedLinear)


class ImperativeQuantAware:
    """Swap the quantizable sublayers of a model for fake-quantized
    versions (qat.py:54); training then proceeds as usual, the fake-quant
    ops carrying straight-through gradients."""

    _QUANTIZABLE = ((Conv2D, "Conv2D", QuantizedConv2D),
                    (nn.Linear, "Linear", QuantizedLinear))

    def __init__(self, weight_bits=8, activation_bits=8, moving_rate=0.9,
                 quantizable_layer_type=("Conv2D", "Linear"),
                 weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max",
                 weight_preprocess_layer=None, act_preprocess_layer=None,
                 weight_quantize_layer=None, act_quantize_layer=None):
        self._weight_bits = weight_bits
        self._activation_bits = activation_bits
        self._moving_rate = moving_rate
        self._types = set(quantizable_layer_type)
        self._weight_qt = weight_quantize_type
        self._act_qt = activation_quantize_type

    def _wrap(self, layer):
        for cls, name, qcls in self._QUANTIZABLE:
            if isinstance(layer, cls) and name in self._types:
                return qcls(layer, weight_bits=self._weight_bits,
                            activation_bits=self._activation_bits,
                            moving_rate=self._moving_rate,
                            weight_quantize_type=self._weight_qt,
                            activation_quantize_type=self._act_qt)
        return None

    def quantize(self, model):
        """In place: replace each quantizable sublayer (qat.py:241)."""
        self._walk(model)
        return model

    def _walk(self, layer):
        for name, child in list(layer.named_children()):
            q = self._wrap(child)
            if q is not None:
                setattr(layer, name, q)
            else:
                self._walk(child)

    def save_quantized_model(self, layer, path, input_spec=None, **config):
        from .. import jit
        layer.eval()
        jit.save(layer, path, input_spec=input_spec, **config)


class ImperativeCalcOutScale:
    """Attach out-scale collectors after activation-producing layers
    (qat.py:299), the already-swapped QuantizedConv2D/QuantizedLinear
    included, so that ``quantize(model)`` then ``calc_out_scale(model)``
    leaves each int8 site with an out-scale for its requantize
    epilogue."""

    _OUT_SCALE_TYPES = ("ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU",
                        "GELU", "Hardswish", "Hardsigmoid", "Sigmoid",
                        "Softmax", "Tanh", "Swish", "Mish",
                        "Conv2D", "Conv2DTranspose", "Linear",
                        "QuantizedConv2D", "QuantizedLinear",
                        "BatchNorm", "BatchNorm1D", "BatchNorm2D",
                        "BatchNorm3D", "SyncBatchNorm", "LayerNorm",
                        "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
                        "AdaptiveMaxPool2D")

    def __init__(self, moving_rate=0.9):
        self._moving_rate = moving_rate

    def calc_out_scale(self, model):
        self._walk(model, module_device(model))
        return model

    def _walk(self, layer, device):
        for name, child in list(layer.named_children()):
            if isinstance(child, _OutScaleWrapper):
                continue                      # idempotent: already collected
            if type(child).__name__ in self._OUT_SCALE_TYPES:
                setattr(layer, name, _OutScaleWrapper(
                    child, self._moving_rate, device))
            else:
                self._walk(child, device)


class _OutScaleWrapper(Layer):
    """A sublayer and the collector of its output's scale, on the model's
    device."""

    def __init__(self, inner, moving_rate, device=None):
        super().__init__()
        self._inner = inner
        self._out_scale = MovingAverageAbsMaxScale(moving_rate=moving_rate,
                                                   device=device)

    def forward(self, *args, **kwargs):
        return self._out_scale(self._inner(*args, **kwargs))
