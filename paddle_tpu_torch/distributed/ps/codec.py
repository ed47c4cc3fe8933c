"""Row-block wire codecs for the PS RPC path.

Counterpart of ``paddle_tpu/distributed/ps/codec.py``, copied: the wire
is numpy only, so the two packages' peers decode each other's blocks.

Reference parity: the reference ships gradient/value compression knobs on
its sends (DistributedStrategy fp16 allreduce + the PSLib accessor's
compress options); here the worker↔pserver hop (DCN) carries row blocks
as bf16 (2 bytes/elem) or int8 + per-row scale (~1 byte/elem) instead of
f32.  Encoding is pure numpy bit-twiddling — no ml_dtypes dependency on
the wire, so any peer can decode.

bf16: round-to-nearest-even truncation of the f32 high half; exact for the
first 8 mantissa bits — the precision of a bf16 matmul on the card, so
pulls lose nothing a bf16 compute path would have kept.
int8: symmetric per-row max-abs quantization with an f32 scale column.
"""
from __future__ import annotations

import numpy as np

MODES = ("none", "bf16", "int8")


def encode_rows(arr: np.ndarray, mode: str):
    """np.float32 [n, d] → wire object (dict for compressed modes)."""
    if mode == "none":
        return np.asarray(arr, np.float32)
    arr = np.ascontiguousarray(arr, np.float32)
    if mode == "bf16":
        u = arr.view(np.uint32).astype(np.uint64)
        # round-to-nearest-even on the dropped half (the f32→bf16 rule of torch and XLA);
        # uint64 intermediate so the carry can't wrap a negative value's
        # sign bit away (0xFFFFxxxx + 0x8000 overflows uint32 → +0.0)
        rounded = u + 0x7FFF + ((u >> 16) & 1)
        # exp=0xFF (Inf/NaN) must pass through unrounded: the carry would
        # turn Inf into NaN space, and truncation could strip a low-bits
        # NaN payload down to Inf — force the quiet bit on NaNs instead
        exp_ones = (u & 0x7F800000) == 0x7F800000
        is_nan = exp_ones & ((u & 0x007FFFFF) != 0)
        passthru = u | np.where(is_nan, np.uint64(0x00400000),
                                np.uint64(0))
        rounded = np.where(exp_ones, passthru, rounded)
        return {"codec": "bf16", "shape": arr.shape,
                "data": (rounded >> 16).astype(np.uint16)}
    if mode == "int8":
        flat = arr.reshape(len(arr), -1) if arr.ndim > 1 else arr[:, None]
        scale = np.abs(flat).max(axis=1, keepdims=True) / 127.0
        safe = np.where(scale == 0, 1.0, scale)
        q = np.clip(np.rint(flat / safe), -127, 127).astype(np.int8)
        return {"codec": "int8", "shape": arr.shape,
                "data": q, "scale": scale.astype(np.float32)}
    raise ValueError(f"unknown row codec {mode!r}")


def decode_rows(obj) -> np.ndarray:
    """Inverse of encode_rows; passes plain arrays through."""
    if not isinstance(obj, dict):
        return np.asarray(obj, np.float32)
    codec = obj["codec"]
    if codec == "bf16":
        u = obj["data"].astype(np.uint32) << 16
        return u.view(np.float32).reshape(obj["shape"])
    if codec == "int8":
        return (obj["data"].astype(np.float32) *
                obj["scale"]).reshape(obj["shape"])
    raise ValueError(f"unknown row codec {codec!r}")
