"""Containers: Sequential, LayerList, ParameterList and LayerDict.

Counterpart of ``paddle_tpu/nn/layer/container.py``.  Children are named
as the JAX package names them: by position (``"0"``, ``"1"``...) or by
the given key, so ``Sequential(Conv2D(...), ...)``'s first weight is
``0.weight`` and a model's ``features.0.weight``.
"""
from __future__ import annotations

import collections

from .layers import Layer


class Sequential(Layer):
    """Runs its sublayers in order.  Takes layers, (name, layer) pairs or
    one OrderedDict of them."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, (list, tuple)) and len(layer) == 2:
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        if isinstance(idx, str):
            return self._modules[idx]
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    """A list of sublayers named by position."""

    def __init__(self, sublayers=None):
        super().__init__()
        for i, layer in enumerate(sublayers or ()):
            self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx if idx >= 0 else len(self) + idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, l in enumerate(layers):
            self.add_sublayer(str(i), l)
        return self

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    """A list of parameters named by position."""

    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or ()):
            self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __setitem__(self, idx, p):
        self.add_parameter(str(idx), p)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, p):
        self.add_parameter(str(len(self)), p)
        return self


class LayerDict(Layer):
    """An ordered mapping of names to sublayers."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)
