"""paddle.static: the static graph, its training and its inference
models.

Counterpart of ``paddle_tpu/static/__init__.py``: ``Program`` (with
``_prune``), ``program_guard``, ``data``, the layer functions ``nn.fc``,
``nn.conv2d`` and ``nn.pool2d``, ``append_backward``/``gradients``,
``Executor`` (one captured CUDA graph per program, scope and feed
signature, and ``set_cache_extra_key``), ``Scope``, the persistables on
disk, ``save_inference_model``/``load_inference_model``, the
serialize and program-state family of ``api_extra.py``
(``serialize_program`` ... ``save``/``load``, ``get_program_state``,
``load_program_state``, ``set_program_state``), and ``InputSpec`` (the
signature ``jit.save`` and ``serving.export_for_serving`` export
against).  Files are the port's own format (``static/io.py``).  Not
ported (ROADMAP A13): ``CompiledProgram``, random ops in captured
programs, control flow, the other ``static.nn`` layers and the rest of
``api_extra.py`` (``py_func``, ``Print``, the place helpers).
"""
from __future__ import annotations

from .program import (  # noqa: F401
    Block, Operator, Program, Variable, default_main_program,
    default_startup_program, program_guard, reset_default_programs)
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from .backward import append_backward, gradients  # noqa: F401
from .io import (  # noqa: F401
    load_inference_model, load_params, load_persistables, load_vars,
    save_inference_model, save_params, save_persistables, save_vars)
from .api_extra import (  # noqa: F401
    deserialize_persistables, deserialize_program, get_program_state, load,
    load_from_file, load_program_state, save, save_to_file,
    serialize_persistables, serialize_program, set_program_state)
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
