"""Weight bridge from the JAX package's functional state to a port module.

``paddle_tpu``'s ``layer_state(layer)`` gives flat ``{dotted name:
array}`` dicts of the parameters (``[0]``: ``encoder.layers.0.self_attn.
q_proj.weight``, ``conv1.weight``...) and of the buffers (``[1]``:
BatchNorm's ``bn1._mean``, ``bn1._variance``...).  The port's modules
carry the same dotted names, so the bridge maps name to name.  The one
layout that differs is ``Linear``'s weight: Paddle stores it ``[in,
out]``, torch ``[out, in]``, so those are transposed; Conv2D weights
(OIHW in both), Embedding, LayerNorm and BatchNorm tensors copy as they
are.  A frozen int8 model (``quantization.freeze``) carries across the
same way: ``weight_int8``, ``weight_scale``, ``input_scale`` and
``out_scale`` of each frozen site are buffers of the same names, and a
frozen linear's int8 codes are transposed as its float weight is.  The
port's model is frozen first with the settings of the JAX one (per
channel or per tensor, dynamic, a folded out-scale), so that both hold
the same sites; the bridge then overwrites their codes and scales, and
a per-channel site meeting a per-tensor one fails on the scales'
shapes.  A GPT-MoE model carries across the same way: each MoE layer's
gate is a ``Linear`` (transposed), its stacked expert arrays
(``experts.w1`` [E, D, H] ...) copy as they are, and its drop and load
buffers are buffers of the same names.  A tied parameter (BERT's MLM
decoder weight is the word embedding)
appears once in ``layer_state``, under its first name, as it does in
``named_parameters()``; its other names are skipped here.

``load_jax_program_state`` carries a JAX static program's scope into the
port's scope for the same program: parameters by their position in
``Program._parameters`` (both packages name them from process-wide
counters, so the names differ), then each optimizer op's accumulators,
step and learning rate.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .enforce import InvalidArgumentError

__all__ = ["load_jax_state", "load_jax_program_state"]


def load_jax_state(module: nn.Module, params: Mapping) -> nn.Module:
    """Copy ``params`` (numpy arrays keyed by the JAX dotted names: the
    parameters of ``layer_state(layer)[0]`` and, in the same mapping, the
    buffers of ``[1]``, such as BatchNorm's ``_mean``/``_variance``) into
    ``module``'s parameters and persistent buffers, in place.  Strict:
    every name on either side must be matched and every shape must agree,
    or :class:`InvalidArgumentError` is raised before anything is
    written."""
    sd = module.state_dict()             # detached views of the storage
    own = {n: t for n, t in sd.items() if n not in _tied_aliases(module, sd)}
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise InvalidArgumentError(
            f"load_jax_state: names missing from params {missing}, "
            f"unknown names in params {extra}")
    from ..quantization.freeze import FrozenQuantizedLinear
    # the module itself may be a Linear: its weight is named "weight"
    linear = {f"{n}.weight".lstrip(".") for n, m in module.named_modules()
              if isinstance(m, nn.Linear)}
    linear |= {f"{n}.weight_int8".lstrip(".")
               for n, m in module.named_modules()
               if isinstance(m, FrozenQuantizedLinear)}
    staged = {}
    for name, dst in own.items():
        src = np.asarray(params[name])
        if src.dtype.name == "bfloat16" \
                or np.issubdtype(src.dtype, np.floating):
            # torch.from_numpy takes no bf16; copy_ casts to dst's dtype
            src = src.astype(np.float32)
        if name in linear:
            src = src.T                  # Paddle [in, out] -> torch [out, in]
        if tuple(src.shape) != tuple(dst.shape):
            raise InvalidArgumentError(
                f"load_jax_state: {name} has shape {tuple(src.shape)} "
                f"(after layout), the module wants {tuple(dst.shape)}")
        staged[name] = src
    with torch.no_grad():
        for name, dst in own.items():
            # np.array keeps a 0-d scale 0-d (ascontiguousarray makes it 1-d)
            dst.copy_(torch.from_numpy(np.array(staged[name], order="C")))
    return module


def _tied_aliases(module: nn.Module, sd) -> set:
    """Names under which ``module`` registers a parameter or buffer that
    an earlier name already holds (the names ``named_parameters()``
    drops).  Each must share its first name's storage in ``sd``."""
    first, aliases = {}, set()
    named = list(module.named_parameters(remove_duplicate=False)) \
        + list(module.named_buffers(remove_duplicate=False))
    for name, t in named:
        if id(t) not in first:
            first[id(t)] = name
            continue
        src = first[id(t)]
        if name in sd and src in sd \
                and sd[name].data_ptr() != sd[src].data_ptr():
            raise InvalidArgumentError(
                f"load_jax_state: {name} is registered as {src} but does "
                "not share its storage")
        aliases.add(name)
    return aliases


def _optimize_ops(program):
    return [op for op in program.global_block().ops if op.prim == "@optimize"]


def load_jax_program_state(jax_program, jax_scope, program, scope):
    """Copy the values of ``jax_program``'s persistables into ``scope``
    under ``program``'s names.  ``jax_scope`` maps the JAX names to
    numpy arrays (the caller reads them out of the JAX scope; the port
    imports no JAX).  Parameters pair by
    position in ``_parameters``; the ``@optimize`` ops pair in order, and
    with them their accumulators (``<param>_<state>_0``), step and
    learning rate.  Strict: every persistable of both programs must be
    paired and every shape must agree, or :class:`InvalidArgumentError`
    is raised before anything is written.  A scope tensor of the same
    shape and dtype is written in place."""
    def value(name):
        v = jax_scope.get(name)
        if v is None:
            raise InvalidArgumentError(
                f"load_jax_program_state: {name} has no value in the JAX "
                "scope")
        return np.asarray(v)

    if len(jax_program._parameters) != len(program._parameters):
        raise InvalidArgumentError(
            f"load_jax_program_state: {len(jax_program._parameters)} JAX "
            f"parameters against {len(program._parameters)}")
    pairs = dict(zip(jax_program._parameters, program._parameters))
    jops, pops = _optimize_ops(jax_program), _optimize_ops(program)
    if [op.type for op in jops] != [op.type for op in pops]:
        raise InvalidArgumentError(
            f"load_jax_program_state: optimizer ops {[o.type for o in jops]}"
            f" against {[o.type for o in pops]}")
    for jop, pop in zip(jops, pops):
        jp, pp = jop.attrs["param_names"], pop.attrs["param_names"]
        if [pairs.get(n) for n in jp] != list(pp):
            raise InvalidArgumentError(
                "load_jax_program_state: the optimizers update other "
                f"parameters ({jp} against {pp})")
        for sname in jop.attrs["state_names"]:
            pairs.update({f"{a}_{sname}_0": f"{b}_{sname}_0"
                          for a, b in zip(jp, pp)})
        pairs.update(zip(jop.input_names[-2:], pop.input_names[-2:]))
    theirs = {v.name for v in jax_program.list_vars() if v.persistable}
    ours = {v.name for v in program.list_vars() if v.persistable}
    if theirs != set(pairs) or ours != set(pairs.values()):
        raise InvalidArgumentError(
            "load_jax_program_state: unpaired persistables: JAX "
            f"{sorted(theirs ^ set(pairs))}, port "
            f"{sorted(ours ^ set(pairs.values()))}")
    block = program.global_block()
    staged = {}
    for jn, pn in pairs.items():
        src, var = value(jn), block.var(pn)
        if list(src.shape) != [int(d) for d in var.shape]:
            raise InvalidArgumentError(
                f"load_jax_program_state: {jn} has shape {list(src.shape)}, "
                f"{pn} wants {var.shape}")
        staged[pn] = torch.from_numpy(np.array(src)).to(var.dtype)
    for pn, t in staged.items():
        cur = scope.find_var(pn)
        if isinstance(cur, torch.Tensor) and cur.shape == t.shape \
                and cur.dtype == t.dtype:
            cur.copy_(t)
        else:
            scope.set_var(pn, t)
    return scope
