"""Activation functionals, kept to relu.

Counterpart of ``paddle_tpu/nn/functional/activation.py``.  The JAX
package's ``relu`` also completes the conv → BN → ReLU handshake of its
layers; the port's ResNet calls ``conv_bn_act`` with the ReLU fused
explicitly instead (``vision/models/resnet.py``).  ``relu`` is the
registered op ``relu`` (``framework/primitive.py``).
"""
from __future__ import annotations

import torch

from ...framework.primitive import Primitive

_relu = Primitive("relu", torch.relu)


def relu(x, name=None):
    return _relu(x)
