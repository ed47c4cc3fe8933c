"""Gradient clipping.

Counterpart of ``paddle_tpu/nn/clip.py`` (Paddle's ClipGradByValue,
ClipGradByNorm, ClipGradByGlobalNorm and ``clip_grad_norm_``).  A clip
takes ``(param, grad)`` pairs and returns new pairs, as the JAX
package's ``_dygraph_clip`` does; ``Optimizer(grad_clip=)`` applies it
before the update rule.  The rules of JAX's ``functional_clip``: norms
summed from f32 squares, the scale ``min(clip_norm / max(norm, 1e-12),
1)`` applied in f32 and cast back to the gradient's dtype, and a
parameter with ``need_clip = False`` left as it is and out of the
global norm.  The scale stays a device tensor: nothing is read back to
the host.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def _scale(clip_norm, norm):
    return torch.clamp_max(clip_norm / torch.clamp_min(norm, 1e-12), 1.0)


def _sq_norm(grads):
    """Sum over ``grads`` of their f32 sums of squares, as a 0-d f32
    device tensor (per-tensor norms in one foreach launch)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.stack(norms).square().sum()


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to [min, max]; ``min`` defaults to
    ``-max``."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _dygraph_clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if _clipped(p, g)
                 else g) for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled so that its own L2 norm is at most
    ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = g.float().square().sum().sqrt()
                g = _scaled(g, _scale(self.clip_norm, norm))
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by one factor, so that their joint
    L2 norm is at most ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _dygraph_clip(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        scale = _scale(self.clip_norm, _sq_norm(grads).sqrt())
        return [(p, _scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so that their joint
    ``norm_type`` norm is at most ``max_norm``; returns that norm before
    the scaling (a 0-d f32 tensor).  ``need_clip`` is not consulted, and
    ``error_if_nonfinite`` is accepted and ignored, as in the JAX
    package (checking it would read the norm back to the host)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.stack([g.float().abs().pow(norm_type).sum()
                             for g in grads]).sum() ** (1.0 / norm_type)
    scale = _scale(float(max_norm), total)
    with torch.no_grad():
        for g in grads:
            g.copy_(_scaled(g, scale))
    return total
