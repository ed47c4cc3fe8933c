"""Normalization layers, kept to BatchNorm2D and LayerNorm.

Counterpart of ``paddle_tpu/nn/layer/norm.py``.  BatchNorm2D: parameters
``weight`` (ones) and ``bias`` (zeros), built by
``Layer.create_parameter`` from ``weight_attr``/``bias_attr`` (False
gives none: the functional then skips that term); persistent f32
buffers ``_mean`` (zeros) and ``_variance`` (ones), updated in place in
training with Paddle's momentum convention (``nn/functional/norm.py``).
Train mode normalizes with the batch statistics, eval mode with the
running ones.  LayerNorm takes Paddle's signature over
``torch.nn.LayerNorm``.  Both land on CUDA unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.place import DeviceLike, resolve_device
from .. import functional as F
from .. import initializer as I
from .common import no_param_attrs
from .layers import Layer


class BatchNorm2D(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.add_parameter("weight", self.create_parameter(
            [num_features], attr=weight_attr, dtype=dtype,
            default_initializer=I.Constant(1.0), device=dev))
        self.add_parameter("bias", self.create_parameter(
            [num_features], attr=bias_attr, dtype=dtype, is_bias=True,
            device=dev))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class LayerNorm(nn.LayerNorm, Layer):
    """Normalization over the trailing ``normalized_shape`` dims with a
    ``weight`` (ones) and a ``bias`` (zeros)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=None):
        no_param_attrs("LayerNorm", weight_attr=weight_attr,
                       bias_attr=bias_attr)
        super().__init__(normalized_shape, eps=epsilon,
                         device=resolve_device(device), dtype=dtype)
