"""Operators and methods of static ``Variable``s.

Counterpart of ``paddle_tpu/ops/patch.py`` as ``paddle_tpu/static``
applies it to ``Variable``: ``+ - * / @``, unary minus, the comparisons
and ``astype``, plus the methods the static programs use (``sum``,
``mean``, ``reshape``, ``flatten``...).  Each records the op it names.
"""
from __future__ import annotations

from ..ops import manipulation, math as m


def apply_patches(T):
    T.__add__ = lambda s, o: m.add(s, o)
    T.__radd__ = lambda s, o: m.add(o, s)
    T.__sub__ = lambda s, o: m.subtract(s, o)
    T.__rsub__ = lambda s, o: m.subtract(o, s)
    T.__mul__ = lambda s, o: m.multiply(s, o)
    T.__rmul__ = lambda s, o: m.multiply(o, s)
    T.__truediv__ = lambda s, o: m.divide(s, o)
    T.__rtruediv__ = lambda s, o: m.divide(o, s)
    T.__matmul__ = lambda s, o: m.matmul(s, o)
    T.__rmatmul__ = lambda s, o: m.matmul(o, s)
    T.__neg__ = lambda s: m.neg(s)
    T.__eq__ = lambda s, o: m.equal(s, o)
    T.__ne__ = lambda s, o: m.not_equal(s, o)
    T.__lt__ = lambda s, o: m.less_than(s, o)
    T.__le__ = lambda s, o: m.less_equal(s, o)
    T.__gt__ = lambda s, o: m.greater_than(s, o)
    T.__ge__ = lambda s, o: m.greater_equal(s, o)
    for name in ("add", "subtract", "multiply", "divide", "matmul", "sum",
                 "mean"):
        setattr(T, name, getattr(m, name))
    for name in ("reshape", "flatten"):
        setattr(T, name, getattr(manipulation, name))
    T.astype = T.cast = lambda s, dtype: manipulation.cast(s, dtype)
