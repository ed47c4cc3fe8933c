"""``ParamAttr``: how a layer names and initializes a parameter.

Counterpart of ``ParamAttr`` in ``paddle_tpu/nn/layer/layers.py``.  The
static layers (``static/nn.py``) read its name, initializer and
``trainable``; ``learning_rate``, ``regularizer`` and ``need_clip`` are
kept for the signature and not read.
"""
from __future__ import annotations

from .. import initializer as I


class ParamAttr:
    """python/paddle/fluid/param_attr.py parity."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """``None`` → defaults, a string → a name, an initializer → that
        initializer, ``False`` → no parameter (returns False)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, bool):
            return ParamAttr() if attr else False
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")
