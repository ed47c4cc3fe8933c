"""Normalization layers, kept to BatchNorm2D and LayerNorm.

Counterpart of ``paddle_tpu/nn/layer/norm.py``.  BatchNorm2D: parameters
``weight`` (ones) and ``bias`` (zeros); persistent f32 buffers ``_mean``
(zeros) and ``_variance`` (ones), updated in place in training with
Paddle's momentum convention (``nn/functional/norm.py``).  Train mode
normalizes with the batch statistics, eval mode with the running ones.
LayerNorm takes Paddle's signature over ``torch.nn.LayerNorm`` and lands
on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.place import DeviceLike, resolve_device
from .. import functional as F
from .common import no_param_attrs


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


class LayerNorm(nn.LayerNorm):
    """Normalization over the trailing ``normalized_shape`` dims with a
    ``weight`` (ones) and a ``bias`` (zeros)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=None):
        no_param_attrs("LayerNorm", weight_attr=weight_attr,
                       bias_attr=bias_attr)
        super().__init__(normalized_shape, eps=epsilon,
                         device=resolve_device(device), dtype=dtype)
