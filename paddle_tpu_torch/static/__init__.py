"""paddle.static: the static graph, as far as training runs on it.

Counterpart of ``paddle_tpu/static/__init__.py``: ``Program``,
``program_guard``, ``data``, the layer functions ``nn.fc``, ``nn.conv2d`` and
``nn.pool2d``, ``append_backward``/``gradients``, ``Executor`` (one
captured CUDA graph per program and feed signature), ``Scope``, the
persistables on disk, and ``InputSpec`` (the signature ``jit.save``
and ``serving.export_for_serving`` export against).  Not ported
(ROADMAP A13): ``save_inference_model``/``load_inference_model``,
``CompiledProgram``, random ops in captured programs, control flow, the
other ``static.nn`` layers and the extras of ``api_extra.py``.
"""
from __future__ import annotations

from .program import (  # noqa: F401
    Block, Operator, Program, Variable, default_main_program,
    default_startup_program, program_guard, reset_default_programs)
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .io import (  # noqa: F401
    load_persistables, load_vars, save_persistables, save_vars)
from .patch import apply_patches as _apply_patches
from . import nn  # noqa: F401

_apply_patches(Variable)


class InputSpec:
    """paddle.static.InputSpec parity (signature for jit.save)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def data(name, shape, dtype="float32", lod_level=0):
    """paddle.static.data parity: declare a feed Variable in the default
    main program (None or -1 marks a dynamic dim)."""
    return default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, stop_gradient=True,
        is_data=True)
