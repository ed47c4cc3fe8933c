"""Convolution layers, kept to Conv2D.

Counterpart of ``paddle_tpu/nn/layer/conv.py``.  The weight is OIHW
[out, in/groups, kh, kw], as Paddle stores it (the weight bridge copies
it as it is).  Both parameters are built by ``Layer.create_parameter``:
``weight_attr``/``bias_attr`` name their initializer (a ``ParamAttr``,
an initializer or a name), else the weight is Kaiming normal (std
sqrt(2 / fan_in)) from the port's generator of its device
(``paddle_tpu_torch.seed`` seeds it) and the bias zeros;
``bias_attr=False`` gives no bias.  The layer lands on CUDA unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import math

import torch

from ...framework.place import DeviceLike, resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2D(padding_mode={padding_mode!r}) is not ported")
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size, kernel_size)
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        dev = resolve_device(device)
        self.add_parameter("weight", self.create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            attr=weight_attr, dtype=dtype,
            default_initializer=I.KaimingNormal(), device=dev))
        self.add_parameter("bias", self.create_parameter(
            [out_channels], attr=bias_attr, dtype=dtype, is_bias=True,
            device=dev))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Redraw the weight (Kaiming normal) from ``generator`` and zero
        the bias."""
        fan_in = self._in_channels // self._groups * math.prod(
            self._kernel_size)
        self.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                            generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
