"""Normalization layers, kept to BatchNorm2D.

Counterpart of ``paddle_tpu/nn/layer/norm.py``.  Parameters ``weight``
(ones) and ``bias`` (zeros); persistent f32 buffers ``_mean`` (zeros) and
``_variance`` (ones), updated in place in training with Paddle's
momentum convention (``nn/functional/norm.py``).  Train mode normalizes
with the batch statistics, eval mode with the running ones.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F


class BatchNorm2D(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = nn.Parameter(torch.ones(num_features, **fk))
        self.bias = nn.Parameter(torch.zeros(num_features, **fk))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")
