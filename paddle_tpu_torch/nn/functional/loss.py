"""Loss functionals.

Counterpart of ``paddle_tpu/nn/functional/loss.py``, kept to the hard-
label cross entropy the training path uses.
"""
from __future__ import annotations

import torch


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross entropy over the last axis with hard labels, in f32
    (JAX ``_softmax_ce_hard_fn``).  Labels equal to ``ignore_index``
    contribute 0; ``"mean"`` divides by the number of valid labels, or by
    1 when there is none, so an all-ignored batch gives 0, not NaN.  A
    label with a trailing axis of 1 is squeezed."""
    logp = torch.log_softmax(input.float(), dim=-1)
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
