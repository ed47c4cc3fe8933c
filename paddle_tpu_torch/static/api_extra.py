"""Programs and their state as bytes and files: the serialize and
program-state family of ``paddle_tpu/static/api_extra.py``.

``serialize_program``/``deserialize_program`` (a whole program, train
programs included: their ``@backward`` and ``@optimize`` ops are rebuilt
from their attrs), ``serialize_persistables``/``deserialize_persistables``,
``save_to_file``/``load_from_file``, ``save``/``load`` (``<prefix>.pdmodel``
and ``<prefix>.pdiparams``), and ``get_program_state``,
``load_program_state``, ``set_program_state``.  The bytes are the port's
own format (``static/io.py``), read with ``weights_only=True``.  Loading
writes into the global scope, in place where a tensor of the same shape
and dtype is there.  The rest of that file (``py_func``, ``Print``, the
place helpers, ``create_global_var``) is not ported (ROADMAP A13).
"""
from __future__ import annotations

import numpy as np
import torch

from .executor import global_scope
from .io import (_dumps, _loads, assign, persistables_blob, program_bytes,
                 program_from_bytes)
from .program import Program, default_main_program

__all__ = ["serialize_program", "deserialize_program",
           "serialize_persistables", "deserialize_persistables",
           "save_to_file", "load_from_file", "save", "load",
           "get_program_state", "load_program_state", "set_program_state"]


def serialize_program(feed_vars=None, fetch_vars=None, program=None) -> bytes:
    """The whole ``program`` (default: the main program) as bytes."""
    return program_bytes(program or default_main_program())


def deserialize_program(data: bytes) -> Program:
    return program_from_bytes(data)


def serialize_persistables(feed_vars=None, fetch_vars=None,
                           program=None) -> bytes:
    """The global scope's values of ``program``'s persistables as
    bytes."""
    return _dumps(persistables_blob(program or default_main_program()))


def deserialize_persistables(program, data: bytes, executor=None):
    scope = global_scope()
    for name, val in _loads(data, "persistables").items():
        assign(scope, name, val)


def save_to_file(path: str, content: bytes):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def save(program, model_prefix, protocol=4):
    """``<model_prefix>.pdmodel`` (the program) and
    ``<model_prefix>.pdiparams`` (its persistables)."""
    save_to_file(model_prefix + ".pdmodel", serialize_program(program=program))
    save_to_file(model_prefix + ".pdiparams",
                 serialize_persistables(program=program))


def load(program, model_prefix, executor=None, var_list=None):
    """Write ``<model_prefix>.pdiparams`` (only ``var_list``'s names when
    given) into the global scope."""
    set_program_state(program, load_program_state(model_prefix, var_list))


def get_program_state(program=None) -> dict:
    """{name: numpy array} of ``program``'s persistables in the global
    scope."""
    return {k: v.numpy() for k, v in persistables_blob(
        program or default_main_program()).items()}


def load_program_state(model_path, var_list=None) -> dict:
    """{name: numpy array} read from ``<model_path>.pdiparams``; apply it
    with :func:`set_program_state`."""
    path = model_path + ".pdiparams"
    blob = _loads(load_from_file(path), path)
    if var_list is not None:
        wanted = {v.name if hasattr(v, "name") else str(v)
                  for v in var_list}
        blob = {k: v for k, v in blob.items() if k in wanted}
    return {k: v.numpy() for k, v in blob.items()}


def set_program_state(program, state_dict):
    """Write ``state_dict`` into the global scope, each value in the
    dtype of ``program``'s var of that name."""
    scope = global_scope()
    block = program.global_block() if program is not None else None
    for name, val in state_dict.items():
        t = val if isinstance(val, torch.Tensor) else torch.from_numpy(
            np.array(val))
        if block is not None and block.has_var(name):
            t = t.to(block.var(name).dtype)
        assign(scope, name, t)
