"""Normalization functionals, kept to batch norm.

Counterpart of ``paddle_tpu/nn/functional/norm.py``.  Paddle's running
statistics follow ``momentum·old + (1 − momentum)·batch`` with the
*biased* batch variance (:func:`_running_update`); ``torch.nn``'s batch
norm weighs the other way and keeps an unbiased running variance, so it
is not used.  The running buffers are updated in place, under
``torch.no_grad()``.

Channels-last training (``data_format`` "NHWC"/"NLC"...) with M = N·H·W
a multiple of 8 runs the fused batch-norm kernels (``fused_bn_act``: B5
forward, B6 backward) under ``FLAGS_use_pallas_fused_bn``; everything
else runs the plain f32 formulas.
"""
from __future__ import annotations

import torch

from ...framework.flags import fused_bn_enabled
from ...ops.kernels.fused_bn import fused_bn_act


def _bn_axes(ndim, data_format):
    ch = 1 if data_format.startswith("NC") else ndim - 1
    return ch, tuple(i for i in range(ndim) if i != ch)


@torch.no_grad()
def _running_update(rmean, rvar, mean, var, momentum):
    """THE running-stat convention of every BN path, in place:
    momentum·old + (1 − momentum)·batch-stat."""
    rmean.copy_(momentum * rmean + (1 - momentum) * mean.to(rmean.dtype))
    rvar.copy_(momentum * rvar + (1 - momentum) * var.to(rvar.dtype))


def _bn_shape(x, ch):
    shape = [1] * x.ndim
    shape[ch] = x.shape[ch]
    return shape


def _bn_train(x, gamma, beta, rmean, rvar, momentum, eps, data_format):
    ch, axes = _bn_axes(x.ndim, data_format)
    c = x.shape[ch]
    if ch == x.ndim - 1 and fused_bn_enabled() \
            and (x.numel() // max(c, 1)) % 8 == 0:
        y, mean, var = fused_bn_act(x.reshape(-1, c), gamma.float(),
                                    beta.float(), float(eps), False)
        _running_update(rmean, rvar, mean.detach(), var.detach(), momentum)
        return y.reshape(x.shape)
    xf = x.float()
    mean = xf.mean(axes)
    var = xf.var(axes, correction=0)
    shape = _bn_shape(x, ch)
    inv = torch.rsqrt(var + eps)
    out = (xf - mean.reshape(shape)) * inv.reshape(shape)
    out = out * gamma.float().reshape(shape) + beta.float().reshape(shape)
    _running_update(rmean, rvar, mean.detach(), var.detach(), momentum)
    return out.to(x.dtype)


def _bn_eval(x, gamma, beta, rmean, rvar, eps, data_format):
    ch, _ = _bn_axes(x.ndim, data_format)
    shape = _bn_shape(x, ch)
    inv = torch.rsqrt(rvar.float() + eps)
    out = (x.float() - rmean.float().reshape(shape)) * inv.reshape(shape)
    out = out * gamma.float().reshape(shape) + beta.float().reshape(shape)
    return out.to(x.dtype)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch norm over every axis but the channel one; in training the
    batch statistics normalize and ``running_mean``/``running_var`` are
    updated in place, in eval (or with ``use_global_stats``) the running
    ones normalize."""
    if use_global_stats:
        training = False
    if training:
        return _bn_train(x, weight, bias, running_mean, running_var,
                         float(momentum), float(epsilon), data_format)
    return _bn_eval(x, weight, bias, running_mean, running_var,
                    float(epsilon), data_format)
