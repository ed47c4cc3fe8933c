"""Seeded random generators.

Counterpart of ``paddle_tpu/framework/random.py`` (``paddle.seed`` and
the default generator).  JAX hands out PRNG keys; here randomness comes
from ``torch.Generator``s, one per device, made from the seed that
:func:`seed` sets.  Code that must own its randomness (``TrainStep``:
one stream per step, reproducible from its ``seed``) makes its own
generator and activates it with :func:`use_generator`; dropout draws
from the active generator of its tensor's device.  The two packages give
different numbers from the same seed: a test that compares them turns
dropout off or feeds both the same noise.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

_LOCK = threading.Lock()
_SEED = 0                                        # guarded-by: _LOCK
_DEFAULTS: Dict[torch.device, torch.Generator] = {}   # guarded-by: _LOCK
_ACTIVE = threading.local()      # per thread: stack of active generators


def seed(value: int) -> int:
    """paddle.seed parity: reseed every device's default generator."""
    global _SEED
    with _LOCK:
        _SEED = int(value)
        for gen in _DEFAULTS.values():
            gen.manual_seed(_SEED)
    return _SEED


def default_generator(device) -> torch.Generator:
    """The default generator of ``device``, made on first use from the
    current seed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        gen = _DEFAULTS.get(dev)
        if gen is None:
            gen = _DEFAULTS[dev] = torch.Generator(device=dev).manual_seed(
                _SEED)
        return gen


@contextlib.contextmanager
def use_generator(generator: torch.Generator):
    """Make ``generator`` the one random ops on its device draw from, in
    this thread, for the body of the ``with``."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append(generator)
    try:
        yield generator
    finally:
        stack.pop()


def current_generator(device) -> torch.Generator:
    """The innermost active generator on ``device`` (see
    :func:`use_generator`), else the device's default generator."""
    dev = torch.device(device)
    for gen in reversed(getattr(_ACTIVE, "stack", ())):
        if gen.device.type == dev.type and (
                dev.index is None or gen.device.index in (None, dev.index)):
            return gen
    return default_generator(dev)

