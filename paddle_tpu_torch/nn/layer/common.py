"""Common layers.

Counterpart of ``paddle_tpu/nn/layer/common.py``, kept to ``Dropout``.
"""
from __future__ import annotations

from torch import nn

from ..functional.common import dropout


class Dropout(nn.Module):
    """Upscale-in-train dropout drawing from the active generator of its
    input's device (``framework.random``), so a ``TrainStep`` owns the
    masks of its steps."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return dropout(x, self.p, training=self.training)

    def extra_repr(self):
        return f"p={self.p}"
