"""QAT layer wrappers (quant_nn parity).

Counterpart of ``paddle_tpu/quantization/quant_layers.py``:
``FakeQuantAbsMax``, ``FakeChannelWiseQuantDequantAbsMax``,
``FakeQuantMovingAverage``, ``MovingAverageAbsMaxScale``,
``QuantizedLinear`` and ``QuantizedConv2D``.  The moving-average
quantizers keep ``scale``, ``accum`` and ``state`` as buffers on the
wrapped layer's device and update them in training mode only.

The port's ``Linear`` stores its weight as torch does, [out, in], where
the JAX package's is [in, out]: its per-output-channel weight axis is 0
here and 1 there.  The scales and codes are the same values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..nn import functional as F
from ..nn.layer.layers import Layer
from . import functional as QF


def _state_buffers(layer, device):
    for name in ("scale", "accum", "state"):
        layer.register_buffer(name, torch.ones((), dtype=torch.float32,
                                               device=device))


class FakeQuantAbsMax(Layer):
    """Per-tensor abs-max fake quant (quant_nn.py:131)."""

    def __init__(self, name=None, quant_bits=8, dtype="float32"):
        super().__init__()
        self._quant_bits = quant_bits

    def forward(self, x):
        return QF.fake_quantize_dequantize_abs_max(
            x, bit_length=self._quant_bits)[0]


class FakeChannelWiseQuantDequantAbsMax(Layer):
    """Per-channel abs-max fake quant for weights (quant_nn.py:213)."""

    def __init__(self, name=None, quant_bits=8, quant_axis=0,
                 dtype="float32"):
        super().__init__()
        self._quant_bits = quant_bits
        self._quant_axis = quant_axis

    def forward(self, x):
        return QF.fake_channel_wise_quantize_dequantize_abs_max(
            x, bit_length=self._quant_bits, quant_axis=self._quant_axis)[0]


class FakeQuantMovingAverage(Layer):
    """Moving-average abs-max fake quant for activations (quant_nn.py:33)."""

    def __init__(self, name=None, moving_rate=0.9, quant_bits=8,
                 dtype="float32", *, device=None):
        super().__init__()
        self._moving_rate = moving_rate
        self._quant_bits = quant_bits
        _state_buffers(self, device)

    def forward(self, x):
        out, scale, accum, state = \
            QF.fake_quantize_dequantize_moving_average_abs_max(
                x, self.scale, self.accum, self.state,
                moving_rate=self._moving_rate, bit_length=self._quant_bits,
                is_test=not self.training)
        if self.training:
            with torch.no_grad():
                self.scale.copy_(scale)
                self.accum.copy_(accum)
                self.state.copy_(state)
        return out


class MovingAverageAbsMaxScale(Layer):
    """Out-scale collector (quant_nn.py:481): passes its input through and
    tracks its moving-average abs-max in the ``scale`` buffer."""

    def __init__(self, name=None, moving_rate=0.9, dtype="float32", *,
                 device=None):
        super().__init__()
        self._moving_rate = moving_rate
        _state_buffers(self, device)

    def forward(self, x):
        scale, accum, state = QF.moving_average_abs_max_scale(
            x, self.accum, self.state, moving_rate=self._moving_rate,
            is_test=not self.training)
        if self.training:
            with torch.no_grad():
                self.scale.copy_(scale)
                self.accum.copy_(accum)
                self.state.copy_(state)
        return x


def _make_weight_quantizer(kind, bits, quant_axis):
    if kind == "channel_wise_abs_max":
        return FakeChannelWiseQuantDequantAbsMax(quant_bits=bits,
                                                 quant_axis=quant_axis)
    return FakeQuantAbsMax(quant_bits=bits)


def _make_act_quantizer(kind, bits, moving_rate, device):
    if kind == "moving_average_abs_max":
        return FakeQuantMovingAverage(moving_rate=moving_rate,
                                      quant_bits=bits, device=device)
    return FakeQuantAbsMax(quant_bits=bits)


class QuantizedLinear(Layer):
    """Linear with fake-quantized weight and input (quant_nn.py:412).
    Wraps any ``torch.nn.Linear`` (the port's ``Linear`` is one)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max"):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        # torch's [out, in] storage: the output channel axis is 0
        self._fake_quant_weight = _make_weight_quantizer(
            weight_quantize_type, weight_bits, quant_axis=0)
        self._fake_quant_input = _make_act_quantizer(
            activation_quantize_type, activation_bits, moving_rate,
            layer.weight.device)

    def forward(self, x):
        qx = self._fake_quant_input(x)
        qw = self._fake_quant_weight(self.weight)
        return TF.linear(qx, qw, self.bias)


class QuantizedConv2D(Layer):
    """Conv2D with fake-quantized weight and input (quant_nn.py:323)."""

    def __init__(self, layer, weight_bits=8, activation_bits=8,
                 moving_rate=0.9, weight_quantize_type="channel_wise_abs_max",
                 activation_quantize_type="moving_average_abs_max"):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self._stride = layer._stride
        self._padding = layer._padding
        self._dilation = layer._dilation
        self._groups = layer._groups
        self._data_format = layer._data_format
        self._fake_quant_weight = _make_weight_quantizer(
            weight_quantize_type, weight_bits, quant_axis=0)
        self._fake_quant_input = _make_act_quantizer(
            activation_quantize_type, activation_bits, moving_rate,
            layer.weight.device)

    def forward(self, x):
        qx = self._fake_quant_input(x)
        qw = self._fake_quant_weight(self.weight)
        return F.conv2d(qx, qw, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)
