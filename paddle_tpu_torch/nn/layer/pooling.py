"""Pooling layers, kept to MaxPool2D and AdaptiveAvgPool2D.

Counterpart of ``paddle_tpu/nn/layer/pooling.py``.
"""
from __future__ import annotations

from torch import nn

from .. import functional as F


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.return_mask, self.ceil_mode = return_mask, ceil_mode
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
