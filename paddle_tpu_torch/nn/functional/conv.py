"""Convolution functionals: conv2d and the fused conv+BN(+ReLU) site.

Counterpart of ``paddle_tpu/nn/functional/conv.py`` (``conv2d``,
``conv_bn_fusable``, ``conv_bn_act``).  Weights follow Paddle: OIHW (out,
in/groups, kh, kw); data is NCHW or NHWC.  An NHWC conv passes
``x.permute(0, 3, 1, 2)`` to ``torch.nn.functional.conv2d``: a
channels-last view that cuDNN reads without a copy, and permutes its
result back the same way.

``conv_bn_act`` runs a train-mode conv → BN (→ ReLU) site through the
fused kernels (``ops/kernels/fused_conv.py``: B7, B5 apply, B6) when
``FLAGS_use_pallas_fused_conv`` is on and the site is eligible
(``conv_bn_fusable``), including the space-to-depth form of the 7x7
stem (``s2d=True``); otherwise the plain composition.  The running
statistics update once either way.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from ...framework.flags import fused_conv_enabled
from ...ops.kernels import fused_conv
from . import activation
from .norm import _running_update, batch_norm

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")


def _pair(v):
    if isinstance(v, int):
        return (int(v), int(v))
    v = tuple(int(x) for x in v)
    return v * 2 if len(v) == 1 else v


def _pads(padding, hw, kernel, stride, dilation):
    """Paddle's padding forms as ((top, bottom), (left, right)): an int,
    (ph, pw), [t, b, l, r], [[t, b], [l, r]], or "SAME"/"VALID" (SAME
    pads as XLA does: the total split low-first, the extra one high)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        out = []
        for size, k, s, d in zip(hw, kernel, stride, dilation):
            total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1
                        - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    padding = list(padding)
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return ((padding[0],) * 2, (padding[1],) * 2)
    if len(padding) == 4:
        return ((padding[0], padding[1]), (padding[2], padding[3]))
    return tuple((int(p[0]), int(p[1])) for p in padding)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-d convolution of NCHW or NHWC ``x`` with an OIHW ``weight``; the
    output keeps x's layout and dtype."""
    channel_last = data_format in _CHANNEL_LAST
    xc = x.permute(0, 3, 1, 2) if channel_last else x
    stride, dilation = _pair(stride), _pair(dilation)
    (pt, pb), (pl, pr) = _pads(padding, xc.shape[2:], weight.shape[2:],
                               stride, dilation)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = (0, 0)
    out = F.conv2d(xc, weight.to(x.dtype), None, stride, pad, dilation,
                   int(groups))
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1) if channel_last else out


def _int(v):
    return int(v[0]) if isinstance(v, (tuple, list)) else int(v)


def conv_bn_fusable(x, weight, stride, padding, dilation, groups,
                    data_format, s2d=False):
    """One static check deciding the fused-vs-plain branch of a site."""
    if not fused_conv_enabled():
        return False
    if s2d:
        return fused_conv.stem_supported(tuple(x.shape), tuple(weight.shape))
    return fused_conv.supports(tuple(x.shape), tuple(weight.shape), stride,
                               padding, dilation, groups,
                               channel_last=data_format == "NHWC")


def conv_bn_act(x, weight, gamma, beta, running_mean, running_var,
                momentum=0.9, epsilon=1e-5, stride=1, padding=0, dilation=1,
                groups=1, data_format="NHWC", act=None, training=True,
                s2d=False, name=None):
    """conv2d → batch_norm → activation of one site: through the fused
    kernels when ``FLAGS_use_pallas_fused_conv`` is on and the site is
    eligible (``s2d=True`` reorganizes the 7x7/s2 stem into the equal
    4x4/s1 conv over 12 channels first), otherwise the plain composition.
    Running statistics update with the shared momentum convention either
    way."""
    if training and act in (None, "relu") and conv_bn_fusable(
            x, weight, stride, padding, dilation, groups, data_format, s2d):
        stride, padding = _int(stride), _int(padding)
        if s2d:
            x = fused_conv.stem_s2d_input(x)
            weight = fused_conv.stem_s2d_weight(weight)
            stride, padding = 1, 0
        y, mean, var = fused_conv.fused_conv_bn_act(
            x, weight, gamma.float(), beta.float(), stride, padding,
            float(epsilon), act == "relu")
        _running_update(running_mean, running_var, mean.detach(),
                        var.detach(), float(momentum))
        return y
    y = conv2d(x, weight, None, stride, padding, dilation, groups,
               data_format)
    y = batch_norm(y, running_mean, running_var, gamma, beta,
                   training=training, momentum=momentum, epsilon=epsilon,
                   data_format=data_format)
    return y if act is None else getattr(activation, act)(y)
