"""Static-graph IR: Program, Block, Operator, Variable.

Counterpart of ``paddle_tpu/static/program.py``.  An ``Operator`` names a
registered op (``framework/primitive.py``) with its input and output
variable names and its attributes, so a program is a list of op
applications that the Executor replays.  InferShape runs at append time,
as in the reference: the op's torch function runs on ``meta`` tensors
(JAX uses ``jax.eval_shape``), probed with two sizes for the dynamic
dims so that an output dim that follows them is recorded as -1.

Three macro ops are no registered op: ``@init`` (a parameter's
initializer, in the startup program), ``@const`` (a literal operand)
and ``@backward``/``@optimize`` (``static/backward.py``,
``optimizer/optimizer.py``), each carrying its own function.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.dtype import convert_dtype
from ..framework.primitive import get_primitive

_var_counter = [0]


def unique_name(prefix):
    _var_counter[0] += 1
    return f"{prefix}_{_var_counter[0]}"


class Variable:
    """A symbolic tensor of a block: name, shape (None or -1 for a
    dynamic dim) and dtype; its value lives in a Scope at run time.
    ``static/patch.py`` gives it the arithmetic operators."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=True, is_data=False,
                 trainable=False):
        self.block = block
        self.name = name or unique_name("var")
        self.shape = list(shape) if shape is not None else []
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable
        self.op = None

    @property
    def ndim(self):
        return len(self.shape)

    def dim(self):
        return self.ndim

    @property
    def size(self):
        return int(np.prod([d if d and d > 0 else 1 for d in self.shape]))

    def numel(self):
        return self.size

    def has_dynamic_dims(self):
        return any(d is None or d < 0 for d in self.shape)

    def meta(self, dyn=1):
        """A ``meta`` tensor of this shape, dynamic dims set to ``dyn``."""
        shape = [d if d is not None and d >= 0 else dyn for d in self.shape]
        return torch.empty(shape, dtype=self.dtype, device="meta")

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={str(self.dtype).replace('torch.', '')})")


class Operator:
    """One op of a block.  ``prim`` is the registered op's name or a macro
    op's (``@init``...); ``fn`` overrides the registry for macro ops."""

    def __init__(self, block, prim: str, inputs: List[str], outputs: List[str],
                 attrs: Dict[str, Any], fn=None, type_name=None):
        self.block = block
        self.prim = prim
        self.type = type_name or prim
        self.input_names = list(inputs)
        self.output_names = list(outputs)
        self.attrs = dict(attrs)
        self._fn = fn

    def run(self, ins, device):
        """The op's outputs, a tuple, on ``device``."""
        if self._fn is not None:
            out = self._fn(*ins)
        elif self.prim == "@init":
            out = self.attrs["initializer"](
                self.attrs["shape"], self.attrs["dtype"], device=device)
        elif self.prim == "@const":
            # one device copy per device, made before any capture reads it
            cache = self.attrs.setdefault("_on", {})
            out = cache.get(device)
            if out is None:
                out = cache[device] = self.attrs["value"].to(device)
        else:
            out = get_primitive(self.prim).fn(*ins, **self.attrs)
        return out if isinstance(out, tuple) else (out,)

    @property
    def random(self):
        return self._fn is None and self.prim[0] != "@" and \
            get_primitive(self.prim).random

    def __repr__(self):
        return (f"{{Op {self.type}: ({', '.join(self.input_names)}) -> "
                f"({', '.join(self.output_names)})}}")


class Block:
    """Ordered ops and a var map."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def var(self, name) -> Variable:
        v = self.vars.get(name)
        if v is None:
            if self.parent_idx >= 0:
                return self.program.block(self.parent_idx).var(name)
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name):
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def create_var(self, name=None, shape=None, dtype="float32",
                   persistable=False, stop_gradient=True, **kw) -> Variable:
        v = Variable(self, name=name, shape=shape, dtype=dtype,
                     persistable=persistable, stop_gradient=stop_gradient,
                     **{k: kw[k] for k in ("is_data", "trainable") if k in kw})
        self.vars[v.name] = v
        return v

    def create_parameter(self, name=None, shape=None, dtype="float32",
                         initializer=None, trainable=True):
        """A persistable parameter var; its initializer runs as an
        ``@init`` op of the startup program."""
        v = self.create_var(name=name or unique_name("param"), shape=shape,
                            dtype=dtype, persistable=True,
                            stop_gradient=not trainable, trainable=trainable)
        self.program._parameters.append(v.name)
        if initializer is not None:
            self.append_init(v, initializer)
        return v

    def append_init(self, var, initializer):
        """An ``@init`` op of the program's startup program (the default
        one when none is set) that sets ``var`` with ``initializer``."""
        startup = self.program._startup or default_startup_program()
        sb = startup.global_block()
        sb.vars[var.name] = var
        sb.ops.append(Operator(sb, "@init", [], [var.name], {
            "initializer": initializer, "shape": list(var.shape),
            "dtype": var.dtype}, type_name="init"))

    def append_const(self, value: torch.Tensor) -> Variable:
        """A literal operand: an ``@const`` op holding ``value``."""
        cv = self.create_var(shape=list(value.shape), dtype=value.dtype)
        self.ops.append(Operator(self, "@const", [], [cv.name],
                                 {"value": value}, type_name="const"))
        return cv

    def append_op(self, prim: str, inputs: Sequence[Variable],
                  attrs: Dict[str, Any], out_stop_gradient=None):
        """Append a registered op and infer its outputs' shapes."""
        fn = get_primitive(prim).fn

        def infer(dyn):
            out = fn(*[v.meta(dyn) for v in inputs], **attrs)
            return out if isinstance(out, tuple) else (out,)

        outs = infer(2)
        shapes = [list(o.shape) for o in outs]
        if any(v.has_dynamic_dims() for v in inputs):
            probe = infer(3)
            shapes = [[-1 if a != b else a for a, b in zip(s, p.shape)]
                      for s, p in zip(shapes, probe)]
        if out_stop_gradient is None:
            out_stop_gradient = all(v.stop_gradient for v in inputs)
        ovs = [self.create_var(name=unique_name(f"{prim}.out"), shape=s,
                               dtype=o.dtype, stop_gradient=out_stop_gradient)
               for s, o in zip(shapes, outs)]
        op = Operator(self, prim, [v.name for v in inputs],
                      [o.name for o in ovs], attrs)
        self.ops.append(op)
        for o in ovs:
            o.op = op
        return ovs[0] if len(ovs) == 1 else tuple(ovs)

    def all_parameters(self):
        return [self.vars[n] for n in self.program._parameters
                if n in self.vars]


class Program:
    """A list of blocks (one in this port) with its parameters.  ``_uid``
    and ``_version`` (bumped by the backward and optimizer passes) key
    the Executor's cache."""

    _UID = [0]

    def __init__(self):
        Program._UID[0] += 1
        self._uid = Program._UID[0]
        self.blocks = [Block(self, 0)]
        self._parameters: List[str] = []
        self._version = 0
        self._startup: Optional[Program] = None
        # what save_inference_model pruned the program to
        self._feed_names: List[str] = []
        self._fetch_names: List[str] = []
        # callables(scope) the Executor runs before each run: they refresh
        # scope-held hyperparameters (the optimizer's learning rate), so
        # a schedule reaches a captured program as data
        self._pre_run_hooks: List = []

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx) -> Block:
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def current_block(self) -> Block:
        return self.blocks[-1]

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test=False):
        """A copy with new vars and ops (a new uid); ``for_test`` turns
        ``training`` attrs off and dropout into the identity."""
        p = Program()
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nb.vars[name] = Variable(
                    nb, name=name, shape=v.shape, dtype=v.dtype,
                    persistable=v.persistable, stop_gradient=v.stop_gradient,
                    is_data=v.is_data, trainable=v.trainable)
            nb.ops = [Operator(nb, op.prim, op.input_names, op.output_names,
                               _copy_attrs(op.attrs), fn=op._fn,
                               type_name=op.type) for op in b.ops]
            p.blocks.append(nb)
        p._parameters = list(self._parameters)
        p._startup = self._startup
        p._pre_run_hooks = list(self._pre_run_hooks)
        p._feed_names = list(self._feed_names)
        p._fetch_names = list(self._fetch_names)
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "training" in op.attrs:
                        op.attrs["training"] = False
                    if op.prim == "dropout":
                        op.attrs["p"] = 0.0
        return p

    def _prune(self, feed_names, fetch_names):
        """The inference subgraph of ``fetch_names`` fed at
        ``feed_names``: walking back from the fetches, every op with a
        needed output is kept and its inputs become needed; a feed is
        never produced, so the walk stops there.  The copy keeps only the
        vars its ops, feeds and fetches name."""
        feeds = set(feed_names)
        needed = set(fetch_names)
        kept = []
        for op in reversed(self.global_block().ops):
            if any(o in needed and o not in feeds for o in op.output_names):
                kept.append(op)
                needed.update(op.input_names)
        kept.reverse()
        pruned = self.clone()
        pb = pruned.global_block()
        pb.ops = [Operator(pb, op.prim, op.input_names, op.output_names,
                           _copy_attrs(op.attrs), fn=op._fn,
                           type_name=op.type) for op in kept]
        used = feeds | set(fetch_names)
        for op in kept:
            used.update(op.input_names + op.output_names)
        pb.vars = {n: v for n, v in pb.vars.items() if n in used}
        pruned._parameters = [n for n in self._parameters if n in used]
        if not any(op.prim == "@optimize" for op in kept):
            pruned._pre_run_hooks = []      # the optimizer's lr refresh
        pruned._feed_names = list(feed_names)
        pruned._fetch_names = list(fetch_names)
        return pruned

    def __repr__(self):
        lines = [f"Program(blocks={len(self.blocks)})"]
        lines += ["  " + repr(op) for op in self.global_block().ops]
        return "\n".join(lines)


def _copy_attrs(attrs):
    """Deep copies of plain attrs; tensors and callables are shared."""
    return {k: v if isinstance(v, torch.Tensor) or callable(v) or k == "_on"
            else copy.deepcopy(v) for k, v in attrs.items()}


# -- the default programs ------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    prev_m, prev_s = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    main_program._startup = _startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = prev_m, prev_s


def current_block() -> Block:
    return _main_program.current_block()
