"""Weight initializers.

Counterpart of ``paddle_tpu/nn/initializer/__init__.py`` (``Constant``,
``Uniform``, ``Normal``, ``XavierUniform``, ``XavierNormal``,
``KaimingUniform``, ``KaimingNormal``, ``Assign``).  An initializer is
called with ``(shape, dtype, device, generator)`` and returns a new
tensor; random ones draw in f32 from ``generator``, by default the
active generator of ``device`` (``framework/random.py``), then cast.
Fans follow Paddle's layouts: a 2-d shape is a Linear weight [in, out],
a longer one a conv weight [out, in, k...].  The two packages draw
different numbers from one seed; tests carry weights across instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.random import current_generator

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "XavierUniform",
           "XavierNormal", "KaimingUniform", "KaimingNormal", "Assign"]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        raise NotImplementedError

    @staticmethod
    def _draw(kind, shape, device, generator, a, b):
        """f32 draws: uniform on [a, b) or normal with mean a, std b."""
        dev = torch.device(device)
        g = generator if generator is not None else current_generator(dev)
        out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
        if kind == "uniform":
            return out.uniform_(a, b, generator=g)
        return out.normal_(a, b, generator=g)


def _dtype(dtype):
    return convert_dtype(dtype) or torch.float32


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        return self._draw("uniform", shape, device, generator, self.low,
                          self.high).to(_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        return self._draw("normal", shape, device, generator, self.mean,
                          self.std).to(_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape):
        fi, fo = _fans(shape)
        return self.gain * math.sqrt(
            6.0 / ((self.fan_in or fi) + (self.fan_out or fo)))

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        lim = self.limit(shape)
        return self._draw("uniform", shape, device, generator, -lim,
                          lim).to(_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, shape):
        fi, fo = _fans(shape)
        return self.gain * math.sqrt(
            2.0 / ((self.fan_in or fi) + (self.fan_out or fo)))

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        return self._draw("normal", shape, device, generator, 0.0,
                          self.std(shape)).to(_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def limit(self, shape):
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return gain * math.sqrt(3.0 / (self.fan_in or _fans(shape)[0]))

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        lim = self.limit(shape)
        return self._draw("uniform", shape, device, generator, -lim,
                          lim).to(_dtype(dtype))


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def std(self, shape):
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return gain / math.sqrt(self.fan_in or _fans(shape)[0])

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        return self._draw("normal", shape, device, generator, 0.0,
                          self.std(shape)).to(_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, shape, dtype=None, device="cpu", generator=None):
        return torch.as_tensor(self.value.reshape(tuple(shape))).to(
            device=device, dtype=_dtype(dtype))
