"""Elementwise, reduction and matmul ops, as registered ops.

Counterpart of the part of ``paddle_tpu/ops/math.py`` that the static
programs use, under the JAX package's op names (``elementwise_add``,
``reduce_mean``, ``matmul_v2``...), so a recorded program names the same
op types in both packages.  Eagerly each is the torch call it wraps.
The rest of ``paddle_tpu.ops`` is ROADMAP A8.
"""
from __future__ import annotations

import torch

from ..framework.primitive import Primitive

_add = Primitive("elementwise_add", lambda x, y: x + y)
_sub = Primitive("elementwise_sub", lambda x, y: x - y)
_mul = Primitive("elementwise_mul", lambda x, y: x * y)
_div = Primitive("elementwise_div", lambda x, y: x / y)
_neg = Primitive("neg", torch.neg)


def add(x, y, name=None):
    return _add(x, y)


def subtract(x, y, name=None):
    return _sub(x, y)


def multiply(x, y, name=None):
    return _mul(x, y)


def divide(x, y, name=None):
    return _div(x, y)


def neg(x, name=None):
    return _neg(x)


def _matmul_fn(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


_matmul = Primitive("matmul_v2", _matmul_fn)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return _matmul(x, y, transpose_x=bool(transpose_x),
                   transpose_y=bool(transpose_y))


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _reduce(pname, fn):
    def run(x, axis=None, keepdim=False):
        if axis is None:
            out = fn(x)
            return out.reshape([1] * x.ndim) if keepdim else out
        return fn(x, dim=axis, keepdim=keepdim)
    p = Primitive(pname, run)

    def f(x, axis=None, keepdim=False, name=None):
        return p(x, axis=_axes(axis), keepdim=bool(keepdim))
    f.__name__ = pname
    return f


sum = _reduce("reduce_sum", torch.sum)
mean = _reduce("reduce_mean", torch.mean)


def _cmp(pname, fn):
    p = Primitive(pname, fn)

    def f(x, y, name=None):
        return p(x, y)
    f.__name__ = pname
    return f


equal = _cmp("equal", torch.eq)
not_equal = _cmp("not_equal", torch.ne)
greater_than = _cmp("greater_than", torch.gt)
greater_equal = _cmp("greater_equal", torch.ge)
less_than = _cmp("less_than", torch.lt)
less_equal = _cmp("less_equal", torch.le)
