"""Dtype names.

Counterpart of ``paddle_tpu/framework/dtype.py``'s ``convert_dtype``:
Paddle's dtype strings (``"float32"``, ``"int64"``, ``"paddle.bf16"``...),
numpy dtypes and ``torch.dtype``s all map to a ``torch.dtype``.  Unlike
the JAX package, 64-bit types stay 64-bit: torch computes in int64 and
float64 on both devices, so nothing is narrowed.
"""
from __future__ import annotations

import numpy as np
import torch

_ALIASES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
    "float32": torch.float32, "fp32": torch.float32, "float": torch.float32,
    "float64": torch.float64, "fp64": torch.float64,
    "double": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int": torch.int32, "int64": torch.int64, "long": torch.int64,
    "uint8": torch.uint8, "bool": torch.bool, "complex64": torch.complex64,
}


def convert_dtype(dtype):
    """A ``torch.dtype`` for ``dtype`` (a string, a numpy dtype or type,
    or a ``torch.dtype``); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key.startswith("paddle."):
            key = key.split(".", 1)[1]
        if key not in _ALIASES:
            raise TypeError(f"unsupported dtype {dtype!r}")
        return _ALIASES[key]
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _ALIASES[name]
