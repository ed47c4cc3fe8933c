"""Loss functionals.

Counterpart of ``paddle_tpu/nn/functional/loss.py``, kept to the softmax
cross entropy of the training paths, with hard or soft labels.
"""
from __future__ import annotations

import torch

from ...framework.enforce import UnimplementedError
from ...framework.primitive import Primitive


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Cross entropy over the last axis, in f32.

    Hard labels (JAX ``_softmax_ce_hard_fn``): labels equal to
    ``ignore_index`` contribute 0; ``"mean"`` divides by the number of
    valid labels, or by 1 when there is none, so an all-ignored batch
    gives 0, not NaN.  A label with a trailing axis of 1 is squeezed.

    Soft labels (``soft_label=True``, JAX ``_softmax_ce_soft_fn``): a
    distribution over the last axis, e.g. ``label_smooth(one_hot(y))``;
    the loss of a row is ``-sum(label * log p)``, ``"mean"`` averages
    over the rows.

    Class weights, another axis and ``use_softmax=False`` are not
    ported.  The registered op ``softmax_with_cross_entropy``."""
    if weight is not None or axis not in (-1, input.ndim - 1) \
            or not use_softmax:
        raise UnimplementedError(
            "cross_entropy is ported over the last axis with the softmax "
            "and without class weights (ROADMAP A9)")
    return _softmax_ce(input, label, ignore_index=ignore_index,
                       reduction=reduction, soft_label=soft_label)


def _softmax_ce_fn(input, label, ignore_index=-100, reduction="mean",
                   soft_label=False):
    logp = torch.log_softmax(input.float(), dim=-1)
    if soft_label:
        return _reduce(-(label.float() * logp).sum(-1), reduction)
    squeeze = label.ndim == logp.ndim
    if squeeze:
        label = label.squeeze(-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    if reduction == "mean":
        return nll.sum() / valid.sum().clamp_min(1).to(nll.dtype)
    if reduction == "sum":
        return nll.sum()
    return nll[..., None] if squeeze else nll


_softmax_ce = Primitive("softmax_with_cross_entropy", _softmax_ce_fn)
