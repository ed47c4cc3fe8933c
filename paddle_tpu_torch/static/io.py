"""Static programs and their persistables on disk: save_vars, load_vars,
save_persistables, load_persistables (and the ``_params`` aliases),
save_inference_model and load_inference_model.

Counterpart of ``paddle_tpu/static/io.py``.  The format is the port's
own, and neither package reads the other's files (ROADMAP C):

- persistables are a ``torch.save`` of a ``{name: tensor}`` dict (CPU
  copies of the scope's values);
- a program is a ``torch.save`` of a dict under :data:`PROGRAM_MAGIC`:
  its vars (shape, dtype name, flags), its ops (registered name, input
  and output names, attrs), its parameters and its feed and fetch names.

Both load with ``weights_only=True``, so reading a file runs no code of
its own; the JAX package pickles numpy arrays, which such a load
refuses.  A program holds plain attrs only: an attr that is a callable
(an ``@init`` op's initializer: those ops live in startup programs)
raises, naming the op, and the ``@const`` ops' per-device copies are
not written.  Of the ops that carry their own function, ``@backward``
and ``@optimize`` are rebuilt from their attrs on load
(``static/backward.py`` ``make_backward_fn``,
``optimizer.rebuild_optimizer``, with the optimizer's lr hook), so a
train program saves whole; any other must be pruned away first, as
``save_inference_model`` does.

Loading writes into a scope tensor of the same shape and dtype in place,
so a program captured over it keeps its storage; a value of another
shape replaces the scope's entry.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import List

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.enforce import InvalidArgumentError
from .executor import global_scope
from .program import Operator, Program, Variable, default_main_program

PROGRAM_MAGIC = "paddle_tpu_torch.program.v1"
_REBUILT = ("@backward", "@optimize")


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def _plain(op, key, value):
    """``value`` as written to disk: tensors as CPU copies, containers
    walked; a callable raises, naming the op."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(op, key, v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(op, key, v) for k, v in value.items()}
    if callable(value):
        raise InvalidArgumentError(
            f"op {op.type!r}: attr {key!r} is a callable ({value!r}), "
            "which a program file cannot hold; @init ops belong to startup "
            "programs, which are not saved")
    return value


def _program_to_dict(program: Program) -> dict:
    ops = []
    for op in program.global_block().ops:
        if op._fn is not None and op.prim not in _REBUILT:
            raise InvalidArgumentError(
                f"op {op.type!r} carries its own function; prune to the "
                "inference subgraph before saving (save_inference_model "
                "does)")
        ops.append({"prim": op.prim, "type": op.type,
                    "inputs": list(op.input_names),
                    "outputs": list(op.output_names),
                    "attrs": {k: _plain(op, k, v) for k, v in op.attrs.items()
                              if k != "_on"}})
    vars_ = {name: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype),
                    "persistable": v.persistable, "is_data": v.is_data,
                    "stop_gradient": v.stop_gradient,
                    "trainable": v.trainable}
             for name, v in program.global_block().vars.items()}
    return {"magic": PROGRAM_MAGIC, "ops": ops, "vars": vars_,
            "parameters": list(program._parameters),
            "feed_names": list(program._feed_names),
            "fetch_names": list(program._fetch_names)}


def _program_from_dict(d) -> Program:
    from ..optimizer.optimizer import (lr_hook, make_update_fn,
                                       rebuild_optimizer)
    from .backward import make_backward_fn
    p = Program()
    b = p.global_block()
    for name, meta in d["vars"].items():
        b.create_var(name=name, shape=meta["shape"],
                     dtype=convert_dtype(meta["dtype"]),
                     persistable=meta["persistable"],
                     stop_gradient=meta["stop_gradient"],
                     is_data=meta["is_data"], trainable=meta["trainable"])
    for o in d["ops"]:
        attrs, fn = o["attrs"], None
        if o["prim"] == "@backward":
            fn = make_backward_fn(list(b.ops[:attrs["n_fwd_ops"]]),
                                  attrs["param_names"], attrs["ext_names"],
                                  attrs["loss_name"])
        elif o["prim"] == "@optimize":
            opt = rebuild_optimizer(attrs["optimizer"], attrs["config"])
            fn = make_update_fn(opt, attrs["param_names"])
            # the learning rate var is the op's last input
            p._pre_run_hooks.append(lr_hook(opt, o["inputs"][-1]))
        b.ops.append(Operator(b, o["prim"], o["inputs"], o["outputs"],
                              attrs, fn=fn, type_name=o["type"]))
    p._parameters = list(d["parameters"])
    p._feed_names = list(d["feed_names"])
    p._fetch_names = list(d["fetch_names"])
    return p


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes, what: str):
    """A ``torch.save`` blob read with ``weights_only=True``; a file of
    another format (the JAX package's pickles) raises
    :class:`InvalidArgumentError`."""
    try:
        return torch.load(io.BytesIO(data), map_location="cpu",
                          weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise InvalidArgumentError(
            f"{what} is not a paddle_tpu_torch file (the port reads only "
            f"its own torch.save format, ROADMAP C): {type(e).__name__} "
            f"{str(e)[:200]}") from None


def program_bytes(program: Program) -> bytes:
    return _dumps(_program_to_dict(program))


def program_from_bytes(data: bytes, what="program") -> Program:
    d = _loads(data, what)
    if not isinstance(d, dict) or d.get("magic") != PROGRAM_MAGIC:
        raise InvalidArgumentError(
            f"{what} is not a paddle_tpu_torch program (magic "
            f"{PROGRAM_MAGIC!r} missing)")
    return _program_from_dict(d)


def _cpu_copy(val):
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().clone()
    return torch.as_tensor(np.asarray(val))


def persistables_blob(program: Program, scope=None) -> dict:
    """{name: CPU copy} of ``program``'s persistables that ``scope`` (the
    global one by default) holds."""
    scope = scope or global_scope()
    blob = {}
    for v in program.list_vars():
        if v.persistable:
            val = scope.find_var(v.name)
            if val is not None:
                blob[v.name] = _cpu_copy(val)
    return blob


def assign(scope, name, value):
    """Write ``value`` (a tensor or an array) into ``scope``: in place
    where the scope holds a tensor of the same shape and dtype, else as
    the new value."""
    val = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    cur = scope.find_var(name)
    if isinstance(cur, torch.Tensor) and cur.shape == val.shape \
            and cur.dtype == val.dtype:
        cur.copy_(val)
    else:
        scope.set_var(name, val)


def _wanted(program, vars, predicate):
    if vars is not None:
        return {v.name if hasattr(v, "name") else str(v) for v in vars}
    if predicate is not None:
        program = program or default_main_program()
        return {v.name for v in program.list_vars() if predicate(v)}
    return None


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _write(path, data: bytes):
    with open(path, "wb") as f:
        f.write(data)


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
            blob[name] = _cpu_copy(val)
    os.makedirs(dirname, exist_ok=True)
    _write(os.path.join(dirname, filename or "__vars__"), _dumps(blob))


def load_vars(executor=None, dirname=None, main_program=None, vars=None,
              predicate=None, filename=None):
    """Restore the requested subset (``vars`` or ``predicate``; all the
    file holds when neither is given) into the global scope."""
    path = os.path.join(dirname, filename or "__vars__")
    blob = _loads(_read(path), path)
    wanted = _wanted(main_program, vars, predicate)
    scope = global_scope()
    for name, val in blob.items():
        if wanted is None or name in wanted:
            assign(scope, name, val)


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    """Save every persistable var's scope value."""
    save_vars(executor, dirname, main_program,
              predicate=lambda v: v.persistable,
              filename=filename or "__persistables__")


save_params = save_persistables


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    load_vars(executor, dirname, main_program,
              filename=filename or "__persistables__")


load_params = load_persistables


def save_inference_model(dirname, feeded_var_names: List[str], target_vars,
                         executor=None, main_program=None,
                         model_filename=None, params_filename=None):
    """Prune ``main_program`` to the subgraph that computes
    ``target_vars`` from ``feeded_var_names`` (``Program._prune``) and
    save it (``__model__``) with the global scope's values of its
    persistables (``__params__``).  Returns the fetch names."""
    program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in target_vars]
    pruned = program._prune(list(feeded_var_names), fetch_names)
    os.makedirs(dirname, exist_ok=True)
    _write(os.path.join(dirname, model_filename or "__model__"),
           program_bytes(pruned))
    _write(os.path.join(dirname, params_filename or "__params__"),
           _dumps(persistables_blob(pruned)))
    return fetch_names


def load_inference_model(dirname, executor=None, model_filename=None,
                         params_filename=None, scope=None):
    """(program, feed names, fetch vars) of a ``save_inference_model``
    directory, its parameters written into ``scope`` (the global one by
    default; the Predictor passes its own)."""
    path = os.path.join(dirname, model_filename or "__model__")
    program = program_from_bytes(_read(path), path)
    path = os.path.join(dirname, params_filename or "__params__")
    scope = scope or global_scope()
    for name, val in _loads(_read(path), path).items():
        assign(scope, name, val)
    block = program.global_block()
    return (program, list(program._feed_names),
            [block.var(n) for n in program._fetch_names])
