"""Loss layers, kept to CrossEntropyLoss with hard labels.

Counterpart of ``paddle_tpu/nn/layer/loss.py``.
"""
from __future__ import annotations

from torch import nn

from ..functional.loss import cross_entropy
from ...framework.enforce import UnimplementedError


class CrossEntropyLoss(nn.Module):
    """Softmax cross entropy over the last axis with hard labels
    (``nn.functional.cross_entropy``); soft labels, class weights and
    another axis are not ported."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        if weight is not None or soft_label or axis != -1 \
                or not use_softmax:
            raise UnimplementedError(
                "CrossEntropyLoss is ported for hard labels over the last "
                "axis without class weights")
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return cross_entropy(input, label, ignore_index=self.ignore_index,
                             reduction=self.reduction)
