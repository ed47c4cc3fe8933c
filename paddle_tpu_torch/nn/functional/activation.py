"""Activation functionals, kept to relu.

Counterpart of ``paddle_tpu/nn/functional/activation.py``.  The JAX
package's ``relu`` also completes the conv → BN → ReLU handshake of its
layers; the port's ResNet calls ``conv_bn_act`` with the ReLU fused
explicitly instead (``vision/models/resnet.py``).
"""
from __future__ import annotations

import torch


def relu(x, name=None):
    return torch.relu(x)
