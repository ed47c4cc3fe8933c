"""Shape ops: reshape, flatten and cast, as registered ops.

Counterpart of ``reshape`` (``reshape2``), ``flatten``
(``flatten_contiguous_range``) and ``cast`` of
``paddle_tpu/ops/manipulation.py``.  A reshape takes Paddle's shape
forms: -1 for the one inferred dim, 0 to keep the input's dim.
"""
from __future__ import annotations

from ..framework.dtype import convert_dtype
from ..framework.primitive import Primitive


def _reshape_fn(x, shape=()):
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return x.reshape(shape)


_reshape = Primitive("reshape2", _reshape_fn)


def reshape(x, shape, name=None):
    return _reshape(x, shape=tuple(int(d) for d in shape))


_flatten = Primitive("flatten_contiguous_range",
                     lambda x, start=0, stop=-1: x.flatten(start, stop))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return _flatten(x, start=int(start_axis), stop=int(stop_axis))


_cast = Primitive("cast", lambda x, dtype=None: x.to(dtype))


def cast(x, dtype):
    return _cast(x, dtype=convert_dtype(dtype))
