"""Common layers: Linear, Embedding and Dropout.

Counterpart of ``paddle_tpu/nn/layer/common.py``.  ``Linear`` and
``Embedding`` take Paddle's signatures and initializers (Xavier-uniform
weights, zero bias) and subclass ``torch.nn.Linear``/``Embedding``, so
``framework/bridge.py`` transposes a ``Linear`` weight (torch stores it
[out, in], Paddle [in, out]) and copies an ``Embedding`` table as it
is.  Both land on CUDA unless the caller passes ``device="cpu"``.
Parameter attributes (``weight_attr``/``bias_attr``) and sparse
embedding gradients are not ported.

All three are ``Layer``s (``isinstance(layer, nn.Layer)`` holds, as in
the JAX package): ``Linear(nn.Linear, Layer)`` takes torch's storage and
forward from ``torch.nn.Linear``, first in its bases, and Paddle's names
(``state_dict`` order, ``sublayers``, ``astype``...) from ``Layer``,
whose ``__init__`` ``torch.nn.Linear`` reaches through ``super()``;
``Embedding`` likewise.
"""
from __future__ import annotations

from torch import nn

from ...framework.enforce import UnimplementedError
from ...framework.place import DeviceLike, resolve_device
from ..functional.common import dropout, embedding
from .layers import Layer


def no_param_attrs(layer, **attrs):
    """Refuse parameter attributes: the port builds parameters with the
    layer's default initializer only."""
    given = sorted(k for k, v in attrs.items() if v is not None)
    if given:
        raise UnimplementedError(
            f"{layer}({', '.join(given)}=...) is not ported: parameters "
            "take the layer's default initializer (ROADMAP A9)")


class Linear(nn.Linear, Layer):
    """``y = x W^T + b`` with ``W`` [out_features, in_features]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=None):
        no_param_attrs("Linear", weight_attr=weight_attr,
                       bias_attr=bias_attr)
        super().__init__(in_features, out_features,
                         device=resolve_device(device), dtype=dtype)

    def reset_parameters(self):
        nn.init.xavier_uniform_(self.weight)
        nn.init.zeros_(self.bias)


class Embedding(nn.Embedding, Layer):
    """A lookup table [num_embeddings, embedding_dim]; ids equal to
    ``padding_idx`` look up zeros (``nn.functional.embedding``)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 device: DeviceLike = None, dtype=None):
        no_param_attrs("Embedding", weight_attr=weight_attr)
        if sparse:
            raise UnimplementedError(
                "Embedding(sparse=True) is not ported: its gradient would "
                "be a SelectedRows (ROADMAP A5)")
        super().__init__(num_embeddings, embedding_dim,
                         padding_idx=padding_idx,
                         device=resolve_device(device), dtype=dtype)

    def reset_parameters(self):
        nn.init.xavier_uniform_(self.weight)
        self._fill_padding_idx_with_zero()

    def forward(self, x):
        return embedding(x, self.weight, padding_idx=self.padding_idx)


class Dropout(Layer):
    """Upscale-in-train dropout drawing from the active generator of its
    input's device (``framework.random``), so a ``TrainStep`` owns the
    masks of its steps."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return dropout(x, self.p, training=self.training)

    def extra_repr(self):
        return f"p={self.p}"
