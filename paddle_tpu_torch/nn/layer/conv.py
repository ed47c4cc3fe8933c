"""Convolution layers, kept to Conv2D.

Counterpart of ``paddle_tpu/nn/layer/conv.py``.  The weight is OIHW
[out, in/groups, kh, kw], as Paddle stores it (the weight bridge copies
it as it is), drawn from Kaiming normal (std sqrt(2 / fan_in)) with the
default generator of its device; ``bias_attr=False`` gives no bias, else
a zero bias.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F


class Conv2D(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 device=None, dtype=None):
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
        fk = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups, *self._kernel_size), **fk))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(out_channels, **fk))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
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
