"""Pooling functionals: max_pool2d and adaptive_avg_pool2d.

Counterpart of ``paddle_tpu/nn/functional/pooling.py`` for the 2-d
forms, NCHW or NHWC.  An NHWC input is pooled through its channels-last
NCHW view (no copy).  Max pooling pads with −inf, as the JAX
``reduce_window`` does; adaptive average pooling splits each spatial
axis into uniform bins when the size divides, else into the JAX
package's [floor(o·n/out), ceil((o+1)·n/out)) buckets.  Max pooling
takes padding up to half the window, as torch's pooling does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework.primitive import Primitive

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC", "NLC")


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(x)
                                                             for x in v)


def _max_pool_fn(x, kernel=(1, 1), stride=(1, 1), padding=(0, 0),
                 channel_last=False):
    xc = x.permute(0, 3, 1, 2) if channel_last else x
    out = F.max_pool2d(xc, kernel, stride, padding)
    return out.permute(0, 2, 3, 1) if channel_last else out


_max_pool = Primitive("max_pool", _max_pool_fn)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """The registered op ``max_pool``."""
    if return_mask or ceil_mode:
        raise NotImplementedError(
            "max_pool2d(return_mask=True / ceil_mode=True) is not ported")
    kernel = _pair(kernel_size)
    return _max_pool(x, kernel=kernel,
                     stride=kernel if stride is None else _pair(stride),
                     padding=_pair(padding),
                     channel_last=data_format in _CHANNEL_LAST)


def _adaptive_axis(x, ax, osz):
    isz = x.shape[ax]
    if isz % osz == 0:
        shape = list(x.shape)
        shape[ax:ax + 1] = [osz, isz // osz]
        return x.reshape(shape).mean(ax + 1)
    segs = [x.narrow(ax, (o * isz) // osz,
                     -(-((o + 1) * isz) // osz) - (o * isz) // osz)
            .mean(ax, keepdim=True) for o in range(osz)]
    return torch.cat(segs, ax)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    out = _pair(output_size)
    axes = (1, 2) if data_format == "NHWC" else (2, 3)
    for ax, osz in zip(axes, out):
        x = _adaptive_axis(x, ax, osz)
    return x
