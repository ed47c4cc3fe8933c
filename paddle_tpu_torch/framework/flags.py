"""Flag registry of the port.

Counterpart of ``paddle_tpu/framework/flags.py``: the same
``set_flags``/``get_flags``/``flag`` surface, the same ``FLAGS_xxx``
environment seeding and the same names, defaults and validators for the
flags the serving and training paths read.  Three defaults
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
            "A batch whose bucket was not warmed at start() fails instead "
            "of running cold: a dense model's bucket without a captured "
            "graph, a decode model's (batch, prompt, cache) bucket that "
            "did not run.")
define_flag("serving_pipeline_depth", 2,
            "Batches a serving worker keeps in flight on the device "
            "before fencing the oldest: the host staging and H2D of batch "
            "N+1 overlap the replay of batch N (dense models).  1 "
            "disables pipelining.",
            validator=lambda v: int(v) >= 1)
define_flag("serving_metrics_window", 2048,
            "Sliding-window size (completed requests) of the per-model "
            "serving latency window behind the p50/p99 of stats().",
            validator=lambda v: int(v) >= 16)
define_flag("graph_lint",
            os.environ.get("PADDLE_TPU_GRAPH_LINT", "off").lower() or "off",
            "Graph-lint tri-state of the JAX package ('off', 'warn', "
            "'error').  The analysis passes are not ported (ROADMAP A13): "
            "a dense model's warm-up raises unless this is 'off'.",
            validator=lambda v: str(v).lower() in ("off", "warn", "error"))
define_flag("use_int8_inference",
            os.environ.get("PADDLE_TPU_INT8", "").lower()
            in ("1", "true", "yes", "on"),
            "Serve frozen int8 inference programs: a Predictor whose "
            "model has a '.int8' sibling export (quantization."
            "save_int8_model) loads that one instead.")

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

define_flag("spec_decode",
            os.environ.get("PADDLE_TPU_SPEC_DECODE", "").lower()
            in ("1", "true", "yes", "on"),
            "Serve decode models through draft/target speculative "
            "decoding (text/speculative.py) when the DecodeModelSpec "
            "carries a draft layer: the draft proposes FLAGS_spec_gamma "
            "tokens a step, the target verifies them in one forward, and "
            "greedy acceptance keeps the longest agreeing prefix, so the "
            "served tokens are plain greedy decode's.  Off by default: the "
            "draft is then ignored (one branch at decode-runtime load).  "
            "generate(draft_model=...) opts in regardless of the flag.  "
            "Seeded by PADDLE_TPU_SPEC_DECODE.")
define_flag("spec_gamma", 4,
            "Tokens the draft proposes a speculative step (gamma): each "
            "step runs gamma+1 draft forwards and one gamma+1-wide target "
            "verify forward and commits 1..gamma+1 tokens.  Per-call "
            "override: SpeculativeGenerator(gamma=...).",
            validator=lambda v: 1 <= int(v) <= 16)
define_flag("decode_slots",
            int(os.environ.get("PADDLE_TPU_DECODE_SLOTS", "0") or 0),
            "Slot count S of the iteration-level continuous-batching "
            "decode loop (serving/slots.py): one single-token step per "
            "(S, cache bucket), captured as one CUDA graph on the card, in "
            "which requests occupy slots, finished rows retire at token "
            "boundaries and queued requests join by restarting a row's "
            "validity window.  0 (default) keeps the run-to-completion "
            "decode path.  Seeded by PADDLE_TPU_DECODE_SLOTS.",
            validator=lambda v: 0 <= int(v) <= 256)
define_flag("prefill_chunk",
            int(os.environ.get("PADDLE_TPU_PREFILL_CHUNK", "16") or 16),
            "Chunk width T of the chunked prefill under the slot decode "
            "loop (FLAGS_decode_slots > 0): a joining prompt is split into "
            "ceil(len/T) LEFT-padded chunks interleaved with decode steps. "
            " Seeded by PADDLE_TPU_PREFILL_CHUNK.",
            validator=lambda v: 1 <= int(v) <= 4096)
define_flag("prefix_cache", False,
            "Radix-trie prefix KV cache under the slot decode loop "
            "(serving/prefix_cache.py): activated rows publish their "
            "prompt's T-column cache blocks into a token-prefix trie, and a "
            "joining request restores the longest cached prefix, "
            "chunk-prefilling only the rest.  Needs FLAGS_decode_slots > 0.")
define_flag("prefix_cache_hbm_mb", 256.0,
            "Device-memory budget (MiB) of the prefix KV cache; "
            "least-recently-used unpinned leaf blocks evict until the "
            "cache fits.  0 = unbounded.",
            validator=lambda v: float(v) >= 0.0)
define_flag("session_store", False,
            "Parked-session KV store (serving/sessions.py): a decode "
            "request carrying a session id parks its ring-cache row as a "
            "host-RAM snapshot at turn end, and the follow-up turn "
            "restores the snapshot into a slot and decodes from the "
            "committed position instead of re-prefilling the whole "
            "history.  Graceful drain parks in-flight session rows "
            "instead of waiting them out.  Off (default) = session ids "
            "are ignored; off-path is one Python branch.  Needs "
            "FLAGS_decode_slots > 0.")
define_flag("session_store_dir", "",
            "Optional disk-spill directory for parked sessions (empty = "
            "host RAM only).  Snapshots write under the sha256-verified "
            "atomic-manifest discipline; a directory shared between "
            "servers lets any of them restore a session another parked "
            "there.")
define_flag("session_park_after_ms", 0,
            "Age (ms) a RAM-parked session must reach before it spills "
            "to FLAGS_session_store_dir.  0 (default) writes through to "
            "disk at park time, the mode that survives a killed process, "
            "since a lazily-spilled snapshot still in RAM dies with it.  "
            "Ignored when the spill directory is unset.",
            validator=lambda v: int(v) >= 0)
define_flag("drain_timeout_s",
            float(os.environ.get("PADDLE_TPU_DRAIN_TIMEOUT_S", "30.0")),
            "Graceful-drain budget: how long a retiring server may take "
            "to finish queued batches and slot-loop rows before "
            "Server.drain() reports work still pending.",
            validator=lambda v: float(v) > 0)
define_flag("router_stale_after_s",
            float(os.environ.get("PADDLE_TPU_ROUTER_STALE_AFTER_S",
                                 "10.0")),
            "Router-side eviction threshold: a replica whose heartbeat "
            "is older than this is evicted from dispatch.  A draining "
            "Server's refusals carry it as their retry_after_s hint.",
            validator=lambda v: float(v) > 0)

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

# ---- Wide&Deep CTR over the parameter server (rec/wide_deep.py) -------------
define_flag("wide_deep_device_dedup",
            os.environ.get("PADDLE_TPU_WD_DEDUP", "").lower()
            in ("1", "true", "yes", "on"),
            "Wide&Deep cached-mode id dedup runs ON THE DEVICE (a static-"
            "cap sort-based unique: argsort, boundary flags, cumsum; "
            "rec/wide_deep.py sort_unique_static) instead of host "
            "np.unique over the full B*S id block; the host resolves only "
            "the deduped prefix against the hot-row cache.  The steps are "
            "bit-identical either way (np.unique also sorts).  Off by "
            "default.  Seeded by PADDLE_TPU_WD_DEDUP.")
define_flag("sharded_embedding",
            os.environ.get("PADDLE_TPU_SHARDED_EMB", "").lower()
            in ("1", "true", "yes", "on"),
            "Row-partition the CTR deep-leg embedding table over a mesh "
            "axis with an all-to-all lookup.  Not ported (ROADMAP A12: it "
            "needs torch.distributed and four cards): WideDeepTrainer "
            "raises while this is on.  Seeded by PADDLE_TPU_SHARDED_EMB.")
