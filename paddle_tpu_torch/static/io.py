"""Persistables on disk: save_vars, load_vars, save_persistables,
load_persistables.

Counterpart of those four in ``paddle_tpu/static/io.py``.  A file is a
``torch.save`` of a ``{name: tensor}`` dict (CPU copies of the scope's
values); the JAX package pickles numpy arrays, and neither package reads
the other's files.  Loading writes into a scope tensor of the same shape
and dtype in place, so a program captured over it keeps its storage; a
value of another shape replaces the scope's entry.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .executor import global_scope
from .program import default_main_program


def _wanted(program, vars, predicate):
    if vars is not None:
        return {v.name if hasattr(v, "name") else str(v) for v in vars}
    if predicate is not None:
        program = program or default_main_program()
        return {v.name for v in program.list_vars() if predicate(v)}
    return None


def save_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None):
    """Save the scope's values of ``vars`` (or of the program's vars that
    ``predicate`` accepts, or of all of them) to ``dirname/filename``."""
    program = main_program or default_main_program()
    scope = global_scope()
    names = _wanted(program, vars, predicate)
    if names is None:
        names = {v.name for v in program.list_vars()}
    blob = {}
    for name in sorted(names):
        val = scope.find_var(name)
        if val is not None:
            blob[name] = (val.detach().cpu().clone()
                          if isinstance(val, torch.Tensor)
                          else torch.as_tensor(np.asarray(val)))
    os.makedirs(dirname, exist_ok=True)
    torch.save(blob, os.path.join(dirname, filename or "__vars__"))


def load_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None):
    """Restore the requested subset (``vars`` or ``predicate``; all the
    file holds when neither is given) into the global scope."""
    scope = global_scope()
    blob = torch.load(os.path.join(dirname, filename or "__vars__"),
                      weights_only=True)
    wanted = _wanted(main_program, vars, predicate)
    for name, val in blob.items():
        if wanted is not None and name not in wanted:
            continue
        cur = scope.find_var(name)
        if isinstance(cur, torch.Tensor) and cur.shape == val.shape \
                and cur.dtype == val.dtype:
            cur.copy_(val)
        else:
            scope.set_var(name, val)


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    """Save every persistable var's scope value."""
    save_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable,
              filename=filename or "__persistables__")


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    load_vars(executor, dirname, main_program,
              filename=filename or "__persistables__")
