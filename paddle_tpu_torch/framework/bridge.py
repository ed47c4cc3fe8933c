"""Weight bridge from the JAX package's functional state to a port module.

``paddle_tpu``'s ``layer_state(layer)`` gives flat ``{dotted name:
array}`` dicts of the parameters (``[0]``: ``encoder.layers.0.self_attn.
q_proj.weight``, ``conv1.weight``...) and of the buffers (``[1]``:
BatchNorm's ``bn1._mean``, ``bn1._variance``...).  The port's modules
carry the same dotted names, so the bridge maps name to name.  The one
layout that differs is ``Linear``'s weight: Paddle stores it ``[in,
out]``, torch ``[out, in]``, so those are transposed; Conv2D weights
(OIHW in both), Embedding, LayerNorm and BatchNorm tensors copy as they
are.  A tied parameter (BERT's MLM decoder weight is the word embedding)
appears once in ``layer_state``, under its first name, as it does in
``named_parameters()``; its other names are skipped here.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from .enforce import InvalidArgumentError

__all__ = ["load_jax_state"]


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
    # the module itself may be a Linear: its weight is named "weight"
    linear = {f"{n}.weight".lstrip(".") for n, m in module.named_modules()
              if isinstance(m, nn.Linear)}
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
            dst.copy_(torch.from_numpy(np.ascontiguousarray(staged[name])))
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
