"""KV-cache handoff between prefill and decode, and the session blob.

Counterpart of ``paddle_tpu/serving/cluster/handoff.py``.  A prefill's
product is exactly the decode's working set: the per-layer ring-cache
planes (``(k, v)`` in the model's dtype, or int8 ``(k, v, k_scale,
v_scale)``), the next-token logits, and the validity-window metadata
(``cache_position`` to resume at, per-row ``start`` offsets).  Two
transports:

  * **device**: both sides share one process: the handoff is the device
    tensors themselves (:meth:`KVHandoff.device` moves host planes onto a
    ``torch.device``; a mesh is not ported);
  * **wire**: the planes serialize to one contiguous blob, the JAX
    package's format byte for byte: magic, a length-prefixed JSON header,
    then the raw row-major bytes of every plane.  bf16 planes move as
    their raw 2-byte storage (``view(torch.int16)``; numpy has no
    bfloat16) under the dtype name ``"bfloat16"``, so the same payload
    gives the same bytes in both packages, each reads the other's blob,
    and a deserialized cache is byte-identical to the one serialized.

The session snapshot blob (``serialize_session``) follows the same
discipline over an arbitrary list/tuple tree of planes.  Deserialized
planes are CPU tensors.

Not ported: the ``kv_handoff_*`` metrics and the protocol registration
wait for ``profiler/``'s registry and ``analysis/protocol/`` (ROADMAP
A13); :func:`stats` keeps the same counts.
"""
from __future__ import annotations

import io
import json
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Tuple

import numpy as np
import torch

from ...framework.enforce import InvalidArgumentError

__all__ = ["KVHandoff", "serialize_kv", "deserialize_kv",
           "serialize_session", "deserialize_session"]

_MAGIC = b"PTKV1\n"
_SS_MAGIC = b"PTSS1\n"

# dtype names of the wire header (numpy's names; "bfloat16" as ml_dtypes
# spells it)
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}

# the counts the JAX package publishes as kv_handoff_bytes_total (by
# transport) and kv_handoff_seconds
_lock = threading.Lock()
_stats = {"wire_bytes": 0, "device_bytes": 0, "session_bytes": 0,
          "legs": 0, "seconds": 0.0}                  # guarded-by: _lock


def _record(transport, nbytes, t0):
    with _lock:
        if transport is not None:
            _stats[f"{transport}_bytes"] += int(nbytes)
        _stats["legs"] += 1
        _stats["seconds"] += time.monotonic() - t0


def stats() -> dict:
    """Bytes moved by transport (``wire``, ``device``, ``session``) and
    the legs (serialize, deserialize, device moves) with their seconds."""
    with _lock:
        return dict(_stats)


def _raw(plane) -> Tuple[bytes, list, str]:
    """A plane's exact storage bytes, row-major, with its shape and dtype
    name."""
    if torch.is_tensor(plane):
        t = plane.detach().cpu().contiguous()
        name = _NAMES.get(t.dtype)
        if name is None:
            raise InvalidArgumentError(
                f"KV plane dtype {t.dtype} has no wire name")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), list(t.shape), name
    a = np.ascontiguousarray(np.asarray(plane))
    return a.tobytes(), list(a.shape), str(a.dtype)


def _nbytes(plane) -> int:
    if torch.is_tensor(plane):
        return plane.numel() * plane.element_size()
    return int(np.asarray(plane).nbytes)


def _taker(blob: bytes, off: int):
    """A reader of consecutive planes from ``blob`` starting at ``off``:
    each call copies one plane's bytes into a fresh CPU tensor."""
    pos = [off]

    def take(meta):
        dt = _DTYPES.get(meta["dtype"])
        if dt is None:
            raise InvalidArgumentError(
                f"unknown plane dtype {meta['dtype']!r} in the blob")
        shape = tuple(meta["shape"])
        n = int(np.prod(shape, dtype=np.int64)) \
            * torch.empty((), dtype=dt).element_size()
        if pos[0] + n > len(blob):
            raise InvalidArgumentError(
                "truncated blob: a plane runs past its end")
        raw = np.frombuffer(blob, np.uint8, count=n, offset=pos[0]).copy()
        pos[0] += n
        return torch.from_numpy(raw).view(dt).reshape(shape)

    return take


def _header(blob: bytes, magic: bytes, what: str):
    if not blob.startswith(magic):
        raise InvalidArgumentError(
            f"not a {what} blob (bad magic); refusing to parse")
    off = len(magic)
    if len(blob) < off + 4:
        raise InvalidArgumentError(f"truncated {what} blob")
    (hlen,) = struct.unpack_from("<I", blob, off)
    off += 4
    try:
        header = json.loads(blob[off:off + hlen].decode())
    except ValueError as e:
        raise InvalidArgumentError(f"{what} blob header: {e}") from e
    if header.get("version") != 1:
        raise InvalidArgumentError(
            f"{what} version {header.get('version')!r} is not supported "
            "(this build speaks version 1)")
    return header, off + hlen


@dataclass
class KVHandoff:
    """One prefill result in flight to a decode.

    ``cache`` is the Generator-shape plane list (one tuple of 2 or 4
    planes per attention layer), ``logits0`` the [B, V] next-token logits,
    ``start`` the per-row first-valid-column offsets and ``pos`` the
    ``cache_position`` decode resumes at (the prompt bucket the prefill
    ran).  ``meta`` carries request context (model name, rows, max_new,
    buckets)."""

    cache: List[Tuple[Any, ...]]
    logits0: Any
    start: Any
    pos: int
    meta: dict = field(default_factory=dict)

    def nbytes(self) -> int:
        n = sum(_nbytes(p) for c in self.cache for p in c)
        return n + (_nbytes(self.logits0) if self.logits0 is not None else 0)

    def to_bytes(self) -> bytes:
        return serialize_kv(self)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "KVHandoff":
        return deserialize_kv(blob)

    def device(self, device) -> "KVHandoff":
        """Every plane and the logits on ``device`` (the decode side's
        ingest step), metered as the device transport."""
        t0 = time.monotonic()
        dev = torch.device(device)

        def put(p):
            return (p if torch.is_tensor(p) else
                    torch.from_numpy(np.ascontiguousarray(p))).to(dev)

        out = KVHandoff(cache=[tuple(put(p) for p in c) for c in self.cache],
                        logits0=None if self.logits0 is None
                        else put(self.logits0),
                        start=np.asarray(self.start, np.int32).reshape(-1),
                        pos=int(self.pos), meta=dict(self.meta))
        _record("device", out.nbytes(), t0)
        return out


def serialize_kv(h: KVHandoff) -> bytes:
    """One contiguous blob: magic + length-prefixed JSON header + raw
    row-major plane bytes (layer-major, plane order, then logits).  The
    payload is the planes' exact storage bytes, so the round trip is
    bit-exact."""
    t0 = time.monotonic()
    planes_meta, buf = [], io.BytesIO()
    for c in h.cache:
        layer_meta = []
        for p in c:
            raw, shape, name = _raw(p)
            layer_meta.append({"shape": shape, "dtype": name})
            buf.write(raw)
        planes_meta.append(layer_meta)
    logits_meta = None
    if h.logits0 is not None:
        raw, shape, name = _raw(h.logits0)
        logits_meta = {"shape": shape, "dtype": name}
        buf.write(raw)
    start = np.asarray(h.start.cpu() if torch.is_tensor(h.start)
                       else h.start, np.int32).reshape(-1)
    header = json.dumps({
        "version": 1, "planes": planes_meta, "logits": logits_meta,
        "start": start.tolist(), "pos": int(h.pos),
        "meta": dict(h.meta),
    }).encode()
    out = _MAGIC + struct.pack("<I", len(header)) + header + buf.getvalue()
    _record("wire", len(out), t0)
    return out


def deserialize_kv(blob: bytes) -> KVHandoff:
    """Inverse of :func:`serialize_kv`; the planes come back as CPU
    tensors (:meth:`KVHandoff.device` moves them to the card)."""
    t0 = time.monotonic()
    header, off = _header(blob, _MAGIC, "KV handoff")
    take = _taker(blob, off)
    cache = [tuple(take(m) for m in layer) for layer in header["planes"]]
    logits = take(header["logits"]) if header["logits"] is not None \
        else None
    h = KVHandoff(cache=cache, logits0=logits,
                  start=np.asarray(header["start"], np.int32),
                  pos=int(header["pos"]), meta=dict(header.get("meta") or {}))
    _record(None, 0, t0)
    return h


def _encode_tree(tree, buf) -> Any:
    """Descriptor of a list/tuple tree of planes, appending each leaf's raw
    bytes to ``buf``.  Container kinds are part of the descriptor (a slot
    cache is a LIST of per-layer TUPLEs; the speculative pair is a tuple
    of two such lists)."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "c": [_encode_tree(x, buf) for x in tree]}
    raw, shape, name = _raw(tree)
    buf.write(raw)
    return {"shape": shape, "dtype": name}


def _decode_tree(desc, take) -> Any:
    if desc is None:
        return None
    if "t" in desc:
        kids = [_decode_tree(d, take) for d in desc["c"]]
        return kids if desc["t"] == "list" else tuple(kids)
    return take(desc)


def serialize_session(payload: dict) -> bytes:
    """Parked-session snapshot wire format (magic ``PTSS1\\n``): the
    :func:`serialize_kv` discipline over an arbitrary list/tuple tree of
    planes, with the scalar session state (tokens, resume payload,
    budget) in the header.  ``payload['planes']`` and
    ``payload['logits']`` are plane trees (or None); every other value
    must be JSON-serializable.  Bit-exact round trip."""
    t0 = time.monotonic()
    buf = io.BytesIO()
    header_doc = {"version": 1}
    for k, v in payload.items():
        header_doc[k] = _encode_tree(v, buf) if k in ("planes", "logits") \
            else v
    header = json.dumps(header_doc).encode()
    out = _SS_MAGIC + struct.pack("<I", len(header)) + header \
        + buf.getvalue()
    _record("session", len(out), t0)
    return out


def deserialize_session(blob: bytes) -> dict:
    """Inverse of :func:`serialize_session`; plane leaves come back as CPU
    tensors with the original container structure."""
    t0 = time.monotonic()
    header, off = _header(blob, _SS_MAGIC, "session snapshot")
    take = _taker(blob, off)
    out = {k: _decode_tree(v, take) if k in ("planes", "logits") else v
           for k, v in header.items() if k != "version"}
    _record(None, 0, t0)
    return out
