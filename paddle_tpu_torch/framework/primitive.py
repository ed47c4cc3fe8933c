"""The op registry and the static recorder.

Counterpart of ``paddle_tpu/framework/primitive.py``.  An op is a plain
torch function registered under Paddle's op type (``conv2d``,
``elementwise_add``, ``softmax_with_cross_entropy``...): tensors come in
as positional arguments, everything else as keyword attributes.  Called
eagerly, a :class:`Primitive` runs its function and nothing more: the
training and serving paths pay one read of the mode flag.  In static
mode (``framework.core.enable_static``), a call with a static
``Variable`` operand, or with an ``nn.Parameter`` (which the recorder
registers into the program and seeds into the global scope, as the JAX
recorder does), appends an ``Operator`` to the current block instead;
the block infers its output shapes on ``meta`` tensors.  A parameter's
var is named by its ``static_name`` attribute, which the recorder sets
when the caller has not (a torch tensor's ``name`` is read-only).  Ops
that draw random numbers are marked ``random``: the Executor refuses to
capture a program that holds one.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from . import core

_PRIMS: Dict[str, "Primitive"] = {}


class Primitive:
    """A registered op: ``fn(*tensors, **attrs) -> tensor | tuple`` (a
    tuple for several outputs)."""

    def __init__(self, name: str, fn: Callable, random: bool = False):
        self.name = name
        self.fn = fn
        self.random = random
        _PRIMS[name] = self

    def __call__(self, *args, **attrs):
        if core._state.static_mode and _records(args):
            return self._append_static(args, attrs)
        return self.fn(*args, **attrs)

    def _append_static(self, args, attrs):
        """Record the call into the current block (``Block.append_op``,
        which runs InferShape)."""
        from ..static.executor import global_scope
        from ..static.program import Variable, current_block, unique_name
        block = current_block()
        inputs = []
        for a in args:
            if isinstance(a, Variable):
                inputs.append(a)
            elif isinstance(a, torch.nn.Parameter):
                # an eager parameter in a static program: a persistable
                # var, its value seeded into the global scope (a copy, so
                # training the program leaves the module as it was)
                name = getattr(a, "static_name", None)
                if name is None:
                    name = a.static_name = unique_name("param")
                if not block.has_var(name):
                    block.create_var(
                        name=name, shape=list(a.shape), dtype=a.dtype,
                        persistable=True, stop_gradient=not a.requires_grad,
                        trainable=a.requires_grad)
                    block.program._parameters.append(name)
                    global_scope().set_var(name, a.detach().clone())
                inputs.append(block.var(name))
            else:
                inputs.append(block.append_const(_literal(a)))
        stop = not (torch.is_grad_enabled() and any(
            isinstance(a, Variable) and not a.stop_gradient for a in args))
        return block.append_op(self.name, inputs, attrs,
                               out_stop_gradient=stop)


def _records(args) -> bool:
    from ..static.program import Variable
    return any(isinstance(a, (Variable, torch.nn.Parameter)) for a in args)


def _literal(a) -> torch.Tensor:
    """A literal operand as a CPU tensor: Python and numpy floats become
    f32, as JAX's weak types and its 32-bit default make them."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    t = torch.as_tensor(np.asarray(a))
    return t.float() if t.dtype == torch.float64 else t


def primitive(name: str, random: bool = False):
    """Decorator: register a torch function as an op."""
    def deco(fn):
        return Primitive(name, fn, random=random)
    return deco


def get_primitive(name: str) -> Primitive:
    return _PRIMS[name]
