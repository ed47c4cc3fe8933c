"""Flag registry of the port.

Counterpart of ``paddle_tpu/framework/flags.py``: the same
``set_flags``/``get_flags``/``flag`` surface, the same ``FLAGS_xxx``
environment seeding and the same names, defaults and validators for the
flags the decode-serving and training paths read.  Three defaults
differ on purpose:

* ``use_flash_decode`` is ON here.  The JAX package ships it OFF because
  the kernel was never measured on a TPU; that records a missing
  measurement, not a decision, and the CUDA kernel is the port's decode
  path.
* ``use_pallas_fused_bn`` and ``use_pallas_fused_conv`` are ON here.  The
  JAX package ships them OFF from v5e measurements (an opaque kernel
  between XLA's conv and its epilogue broke XLA's own fusion there); those
  numbers carry no weight on the card, and the CUDA kernels B5-B7 are the
  port's ResNet path.  As in the JAX package, the legacy environment
  variables ``PADDLE_TPU_PALLAS_BN=1`` and ``PADDLE_TPU_PALLAS_CONV=1``
  turn them on too (:func:`fused_bn_enabled`, :func:`fused_conv_enabled`).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "value", "default", "doc", "validator")

    def __init__(self, name, default, doc="", validator=None):
        self.name = name
        self.default = default
        self.doc = doc
        self.validator = validator
        self.value = self._from_env(default)

    def _from_env(self, default):
        raw = os.environ.get("FLAGS_" + self.name)
        if raw is None:
            return default
        if isinstance(default, bool):
            return raw.lower() in ("1", "true", "yes", "on")
        if isinstance(default, int):
            return int(raw)
        if isinstance(default, float):
            return float(raw)
        return raw


def define_flag(name: str, default: Any, doc: str = "",
                validator: Optional[Callable[[Any], bool]] = None) -> None:
    if name in _REGISTRY:
        raise ValueError(f"flag {name!r} is already registered")
    _REGISTRY[name] = _Flag(name, default, doc, validator)


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise ValueError(f"unknown flag {name!r}")
    return key


def set_flags(flags: Dict[str, Any]) -> None:
    """paddle.set_flags parity."""
    for name, value in flags.items():
        f = _REGISTRY[_key(name)]
        if f.validator is not None and not f.validator(value):
            raise ValueError(f"invalid value {value!r} for flag {name!r}")
        f.value = value


def get_flags(flags) -> Dict[str, Any]:
    """paddle.get_flags parity."""
    if isinstance(flags, str):
        flags = [flags]
    return {name: _REGISTRY[_key(name)].value for name in flags}


def flag(name: str) -> Any:
    return _REGISTRY[name].value


def flags_snapshot() -> Dict[str, Any]:
    """Every flag's current value; pair with :func:`flags_restore`."""
    return {name: f.value for name, f in _REGISTRY.items()}


def flags_restore(snapshot: Dict[str, Any]) -> None:
    for name, value in snapshot.items():
        _REGISTRY[name].value = value


def _int_list(v) -> bool:
    return all(int(b) > 0 for b in str(v).split(",") if b.strip())


# ---- Serving engine ---------------------------------------------------------
define_flag("serving_buckets", "1,2,4,8,16,32,64",
            "Default batch-bucket ladder: pending requests batch into the "
            "smallest bucket that holds them and pad up.",
            validator=_int_list)
define_flag("serving_workers", 2,
            "Serving worker threads per Server.",
            validator=lambda v: int(v) >= 1)
define_flag("serving_queue_capacity", 1024,
            "Bound on requests pending in the serving queue; submit past "
            "it blocks up to its timeout then raises UnavailableError.",
            validator=lambda v: int(v) >= 1)
define_flag("serving_batch_timeout_ms", 2.0,
            "How long the batcher holds a non-full batch open for more "
            "arrivals before dispatching what it has.",
            validator=lambda v: float(v) >= 0)
define_flag("serving_strict", True,
            "A batch whose (batch, prompt, cache) bucket was not run at "
            "warm-up fails instead of running cold.")

# ---- Autoregressive decoding --------------------------------------------------
define_flag("use_flash_decode", True,
            "Route single-query cached attention on CUDA tensors through "
            "the flash-decoding CUDA kernels (ops/kernels/flash_decode.py).")
define_flag("decode_buckets", "16,32,64,128,256,512,1024",
            "Sequence-length bucket ladder: prompts pad (left) to the "
            "smallest bucket, KV-cache lengths round up to the smallest "
            "bucket holding prompt + max_new_tokens.",
            validator=_int_list)
define_flag("decode_max_len", 1024,
            "Hard ceiling on KV-cache length (prompt + generated tokens).",
            validator=lambda v: int(v) >= 1)
define_flag("kv_cache_dtype",
            os.environ.get("PADDLE_TPU_KV_CACHE_DTYPE", "bf16").lower()
            or "bf16",
            "Storage of the decode KV ring cache: 'bf16' (the model's own "
            "dtype planes) or 'int8' (int8 rows + per-(token, head) f32 "
            "scale planes, dequantized inside the flash-decode kernel).",
            validator=lambda v: str(v).lower() in ("bf16", "int8"))

# ---- Kernels and training -------------------------------------------------
define_flag("use_pallas_kernels", True,
            "Route non-cached attention on CUDA tensors through the flash-"
            "attention CUDA kernels (ops/kernels/flash_attention.py), "
            "forward and backward; a trainable mask runs plain attention.")
define_flag("train_sentinel",
            os.environ.get("PADDLE_TPU_SENTINEL", "").lower()
            in ("1", "true", "yes", "on"),
            "Numerics sentinel of TrainStep: a step whose loss or any "
            "gradient is non-finite commits nothing (parameters and "
            "optimizer moments keep their values) and backs off the "
            "GradScaler.")
define_flag("use_pallas_fused_bn", True,
            "Route channels-last train-mode batch norm on CUDA tensors "
            "through the fused batch-norm CUDA kernels (ops/kernels/"
            "fused_bn.py: B5 forward, B6 backward) when M is a multiple "
            "of 8.")
define_flag("use_pallas_fused_conv", True,
            "Route eligible NHWC conv+BN(+ReLU) training sites through the "
            "fused conv CUDA kernel and the batch-norm epilogue kernels "
            "(ops/kernels/fused_conv.py: B7, then B5 apply; B6 backward), "
            "with the space-to-depth 7x7 stem.")


def fused_bn_enabled() -> bool:
    """FLAGS_use_pallas_fused_bn, or the legacy PADDLE_TPU_PALLAS_BN=1."""
    return bool(flag("use_pallas_fused_bn")) or \
        os.environ.get("PADDLE_TPU_PALLAS_BN", "0") == "1"


def fused_conv_enabled() -> bool:
    """FLAGS_use_pallas_fused_conv, or the legacy PADDLE_TPU_PALLAS_CONV=1."""
    return bool(flag("use_pallas_fused_conv")) or \
        os.environ.get("PADDLE_TPU_PALLAS_CONV", "0") == "1"
