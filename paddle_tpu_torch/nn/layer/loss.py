"""Loss layers, kept to CrossEntropyLoss.

Counterpart of ``paddle_tpu/nn/layer/loss.py``.
"""
from __future__ import annotations

from ..functional.loss import cross_entropy
from ...framework.enforce import UnimplementedError
from .layers import Layer


class CrossEntropyLoss(Layer):
    """Cross entropy over the last axis with hard or soft labels
    (``nn.functional.cross_entropy``); class weights, another axis and
    ``use_softmax=False`` are not ported."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        if weight is not None or axis != -1 or not use_softmax:
            raise UnimplementedError(
                "CrossEntropyLoss is ported over the last axis with the "
                "softmax and without class weights (ROADMAP A9)")
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = bool(soft_label)

    def forward(self, input, label):
        return cross_entropy(input, label, ignore_index=self.ignore_index,
                             reduction=self.reduction,
                             soft_label=self.soft_label)
