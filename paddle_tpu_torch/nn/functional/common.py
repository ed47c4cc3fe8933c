"""Common functionals.

Counterpart of ``paddle_tpu/nn/functional/common.py``, kept to dropout.
"""
from __future__ import annotations

import torch

from ...framework.random import current_generator


def dropout(x, p=0.5, training=True, generator=None):
    """Upscale-in-train dropout: each element kept with probability
    ``1 - p`` and divided by it.  The mask is drawn from ``generator``,
    by default the active generator of ``x``'s device
    (``framework.random.current_generator``)."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    g = generator if generator is not None else current_generator(x.device)
    keep = torch.rand(x.shape, generator=g, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
