"""paddle.jit save and load of the port: programs made by ``torch.export``.

Counterpart of ``save``, ``load`` and ``TranslatedLayer`` in
``paddle_tpu/jit/__init__.py``.  The JAX package serializes the jitted
eval forward as StableHLO, with the parameters as trailing arguments; the
port exports the eval forward with ``torch.export`` in the same shape:

  * the parameters and buffers are explicit trailing inputs of the
    program, so every program made from one model, and every clone of a
    loaded one, reads one set of weights;
  * a ``None`` dim of an ``InputSpec`` is a symbolic dim
    (``torch.export.Dim``, at least 1); a leading ``None`` is one batch
    dim shared by every input, another ``None`` a dim of its own.  Each
    is traced at size 2, since ``torch.export`` specializes a dim it
    traces at size 1;
  * ``<path>.pdmodel`` holds the program (``torch.export.save``) and a
    JSON record of the device it was exported on; ``<path>.pdiparams``
    the parameters (``torch.save``).  This is the port's own format; it
    does not read the JAX package's files.

A program runs on the device type it was exported on: the port's
dispatch between a kernel and its plain version is decided while the
forward is traced (a CUDA tensor takes the flash-attention operator, a
CPU one plain attention), so a program exported on the CPU and moved to
the card would run the plain version there.  ``load`` refuses that.

``to_static``, ``StaticFunction``, dy2static and the persistent compile
cache are not ported (ROADMAP A13).
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch
from torch.utils import _pytree

from ..framework.enforce import InvalidArgumentError
from ..framework.place import DeviceLike, module_device, resolve_device
# the attention operators must be registered before a program that calls
# them is loaded
from ..ops.kernels import flash_attention as _fa  # noqa: F401
from ..static import InputSpec

__all__ = ["save", "load", "TranslatedLayer"]

_META = "paddle_tpu_torch.json"
_TRACE_BATCH = 2        # the size a symbolic dim is traced at

_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "float64": torch.float64, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32,
           "int16": torch.int16, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise InvalidArgumentError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


class _Program(torch.nn.Module):
    """The exported callable: ``forward(*inputs, *params)`` runs the
    layer's forward on ``params`` (``torch.func.functional_call``).  The
    layer is kept out of the module's children, so that ``torch.export``
    lifts nothing of it: every weight is an input."""

    def __init__(self, layer, names):
        super().__init__()
        self.__dict__["layer"] = layer
        self.names = list(names)

    def forward(self, *args):
        n = len(args) - len(self.names)
        return torch.func.functional_call(
            self.layer, dict(zip(self.names, args[n:])), tuple(args[:n]),
            strict=True)


def _weights(layer):
    named = list(layer.named_parameters()) + list(layer.named_buffers())
    return [n for n, _ in named], [t.detach() for _, t in named]


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save parity: export ``layer``'s eval forward at
    ``input_spec`` (InputSpecs or ``(shape, dtype)`` pairs) and write
    ``<path>.pdmodel`` and ``<path>.pdiparams``."""
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (shapes to export)")
    device = module_device(layer) or torch.device("cpu")
    batch = torch.export.Dim("batch", min=1)
    examples, dyn = [], []
    for i, s in enumerate(input_spec):
        shape, dtype = (s.shape, s.dtype) if isinstance(s, InputSpec) \
            else (list(s[0]), s[1])
        dims, sizes = {}, []
        for j, d in enumerate(shape):
            if d is None or int(d) < 0:
                dims[j] = batch if j == 0 else torch.export.Dim(
                    f"d{i}_{j}", min=1)
                sizes.append(_TRACE_BATCH)
            else:
                sizes.append(int(d))
        examples.append(torch.zeros(sizes, dtype=to_torch_dtype(dtype),
                                    device=device))
        dyn.append(dims or None)
    names, params = _weights(layer)
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            exported = torch.export.export(
                _Program(layer, names), (*examples, *params),
                dynamic_shapes=(tuple(dyn + [None] * len(params)),))
    finally:
        layer.train(was_training)
    meta = {"device": device.type, "num_inputs": len(examples),
            "params": names}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(exported, f, extra_files={_META: json.dumps(meta)})
    torch.save([p.cpu() for p in params], path + ".pdiparams")


class TranslatedLayer:
    """dygraph/io.py TranslatedLayer parity: a loaded program and its
    parameters on one device, inference only."""

    def __init__(self, program, params, device):
        self._program = program
        self._params = params
        self._module = program.module()
        self.device = device
        self.training = False

    @property
    def num_inputs(self):
        return len(self._program.graph_signature.user_inputs) \
            - len(self._params)

    @property
    def num_outputs(self):
        return len(self._program.graph_signature.user_outputs)

    def input_specs(self):
        """``[(shape, dtype)]`` of the program's inputs, as it was
        exported: a symbolic dim is ``None``."""
        names = self._program.graph_signature.user_inputs[:self.num_inputs]
        nodes = {n.name: n for n in self._program.graph.nodes
                 if n.op == "placeholder"}
        out = []
        for name in names:
            val = nodes[name].meta["val"]
            out.append(([int(d) if isinstance(d, int) else None
                         for d in val.shape], val.dtype))
        return out

    def program(self):
        """The ``torch.export.ExportedProgram``: the inspection surface
        (the counterpart of the JAX package's ``mlir_module``)."""
        return self._program

    def __call__(self, *args):
        arrs = [a.to(self.device) if torch.is_tensor(a)
                else torch.as_tensor(np.asarray(a), device=self.device)
                for a in args]
        with torch.no_grad():
            out = self._module(*arrs, *self._params)
        outs = _pytree.tree_leaves(out)
        return outs[0] if len(outs) == 1 else outs

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")


def load(path, device: DeviceLike = None, **configs) -> TranslatedLayer:
    """paddle.jit.load parity: the program at ``path`` and its parameters
    on ``device`` (default CUDA), which must be of the device type the
    program was exported on."""
    dev = resolve_device(device)
    extra = {_META: ""}
    with open(path + ".pdmodel", "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    meta = json.loads(extra[_META])
    if meta["device"] != dev.type:
        raise InvalidArgumentError(
            f"{path}: the program was exported on {meta['device']} and "
            f"cannot run on {dev}: export it on the device that serves it "
            "(kernel dispatch is fixed when the forward is traced)")
    params: List[torch.Tensor] = torch.load(path + ".pdiparams",
                                            map_location=dev,
                                            weights_only=True)
    return TranslatedLayer(program, params, dev)
