"""Parked-session KV store: multi-turn conversations without re-prefill.

Counterpart of ``paddle_tpu/serving/sessions.py``.  A multi-turn chat
spends most of its life idle between turns.  Keeping its ring-cache
planes in a decode slot for that time wastes the scarcest resource
(slot memory on the card); re-prefilling the whole history on the next
turn wastes the second scarcest (prefill compute).  The store takes a
third road:

  * **park**: when a turn completes (or the server drains), the slot
    loop pulls the row's valid columns to host RAM as a
    :class:`SessionSnapshot`: the token transcript, the resume payload
    (next-token logits for the plain loop, committed next token for the
    speculative loop), the remaining budget, and the KV planes as CPU
    tensors (bf16 and int8 + scales as their exact storage);
  * **restore**: the next turn looks the session up, pushes the
    snapshot's planes back into a joining row's validity window (token
    positions are relative to the row's start, so the columns are
    portable across slot rows and window shifts) and chunk-prefills
    only the NEW turn's tokens.  On the CPU in f32 decoding continues
    bit-identically to a full re-prefill of the whole history;
  * **spill**: with ``FLAGS_session_store_dir`` set, snapshots write to
    disk under the sha256 atomic-manifest discipline
    (``checkpoint/atomic.py``), so a torn write is detected (treated as
    absent: the turn falls back to a plain prefill) and a server
    restarted over the same directory finds its parked sessions.
    ``park_after_ms == 0`` writes through at park time; ``> 0`` keeps
    hot sessions in RAM and spills the idle ones lazily.

``export_bytes`` / ``import_bytes`` move a session between stores (the
JAX package's router migrates through them; the router is not ported
yet, ROADMAP A4).

Not ported: the ``session_*`` metrics and the protocol registration wait
for ``profiler/``'s registry and ``analysis/protocol/`` (ROADMAP A13);
``len()`` and ``nbytes()`` give the same numbers.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.atomic import (CheckpointCorruptError, atomic_write_bytes,
                                 sha256_file)
from ..framework.enforce import InvalidArgumentError
from .cluster.handoff import deserialize_session, serialize_session

__all__ = ["SessionSnapshot", "SessionStore"]


def _tree_nbytes(tree) -> int:
    if tree is None:
        return 0
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(x) for x in tree)
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)


def _cpu_f32(x) -> torch.Tensor:
    return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))) \
        .detach().to("cpu", torch.float32)


@dataclass
class SessionSnapshot:
    """One parked conversation, complete enough to resume exactly.

    ``tokens`` is the committed transcript (prompt ++ emitted so far);
    ``planes`` the KV tree for columns ``[0, len(tokens))`` in relative
    position, as CPU tensors (None when the transcript was shorter than
    one chunk: the restore then re-prefills).  ``remaining > 0`` marks a
    mid-generation park (drain): the restore resumes decoding with that
    budget; ``remaining == 0`` is a completed turn awaiting a follow-up.
    ``logits`` (plain loop, f32 [V]) / ``cur`` (speculative loop) carry
    the resume payload a final prefill chunk would otherwise produce."""

    session_id: str
    model: str
    tokens: List[int]
    remaining: int = 0
    emitted: List[int] = field(default_factory=list)
    planes: Any = None
    logits: Optional[torch.Tensor] = None
    cur: Optional[int] = None
    kv_dtype: str = "bfloat16"
    spec: bool = False
    t_park: float = 0.0
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.logits is not None:
            self.logits = _cpu_f32(self.logits)

    def nbytes(self) -> int:
        n = _tree_nbytes(self.planes)
        if self.logits is not None:
            n += _tree_nbytes(self.logits)
        return n + 8 * len(self.tokens)

    def to_payload(self) -> dict:
        # the JAX package's key order: the header bytes are compared
        return {
            "session_id": self.session_id, "model": self.model,
            "tokens": [int(t) for t in self.tokens],
            "remaining": int(self.remaining),
            "emitted": [int(t) for t in self.emitted],
            "cur": None if self.cur is None else int(self.cur),
            "kv_dtype": self.kv_dtype, "spec": bool(self.spec),
            "t_park": float(self.t_park), "meta": dict(self.meta),
            "planes": self.planes, "logits": self.logits,
        }

    @classmethod
    def from_payload(cls, p: dict) -> "SessionSnapshot":
        return cls(session_id=p["session_id"], model=p["model"],
                   tokens=[int(t) for t in p["tokens"]],
                   remaining=int(p.get("remaining", 0)),
                   emitted=[int(t) for t in p.get("emitted", ())],
                   planes=p.get("planes"), logits=p.get("logits"),
                   cur=p.get("cur"),
                   kv_dtype=p.get("kv_dtype", "bfloat16"),
                   spec=bool(p.get("spec", False)),
                   t_park=float(p.get("t_park", 0.0)),
                   meta=dict(p.get("meta") or {}))

    def to_bytes(self) -> bytes:
        return serialize_session(self.to_payload())

    @classmethod
    def from_bytes(cls, blob: bytes) -> "SessionSnapshot":
        try:
            return cls.from_payload(deserialize_session(blob))
        except (KeyError, TypeError, ValueError) as e:
            raise InvalidArgumentError(
                f"malformed session snapshot: {e!r}") from e


class SessionStore:
    """Host-RAM session snapshots with optional sha256-manifested disk
    spill.  Thread-safe; a snapshot has exactly one consumer (``take``
    removes it from RAM and disk: the restoring slot either completes the
    turn, which parks again, or fails, which re-prefills next time)."""

    def __init__(self, spill_dir: str = "", park_after_ms: int = 0):
        self._dir = str(spill_dir or "")
        self._park_after_ms = int(park_after_ms)
        self._ram: Dict[str, SessionSnapshot] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._ram_bytes = 0                         # guarded-by: _lock
        self._disk_bytes: Dict[str, int] = {}       # guarded-by: _lock
        if self._dir:
            os.makedirs(self._dir, exist_ok=True)
            self._scan_disk()

    # -- naming / manifests --------------------------------------------------
    def _stem(self, sid: str) -> str:
        return hashlib.sha256(sid.encode()).hexdigest()[:32]

    def _paths(self, sid: str):
        stem = self._stem(sid)
        return (os.path.join(self._dir, stem + ".ptss"),
                os.path.join(self._dir, stem + ".json"))

    def _scan_disk(self):
        for name in os.listdir(self._dir):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._dir, name)) as f:
                    man = json.load(f)
                self._disk_bytes[man["session_id"]] = int(man["bytes"])
            except (OSError, ValueError, KeyError):
                continue

    # -- spill ---------------------------------------------------------------
    def _spill_locked(self, sid: str, snap: SessionSnapshot,
                      drop_ram: bool) -> None:
        blob = snap.to_bytes()
        blob_path, man_path = self._paths(sid)
        digest = atomic_write_bytes(blob_path, blob)
        man = json.dumps({"session_id": sid,
                          "file": os.path.basename(blob_path),
                          "sha256": digest, "bytes": len(blob),
                          "t_park": snap.t_park}).encode()
        atomic_write_bytes(man_path, man)
        self._disk_bytes[sid] = len(blob)
        if drop_ram and sid in self._ram:
            self._ram_bytes -= self._ram.pop(sid).nbytes()

    def _drop_disk_locked(self, sid: str) -> None:
        blob_path, man_path = self._paths(sid)
        for p in (blob_path, man_path):
            try:
                os.unlink(p)
            except OSError:
                pass
        self._disk_bytes.pop(sid, None)

    def _load_disk_locked(self, sid: str) -> Optional[SessionSnapshot]:
        blob_path, man_path = self._paths(sid)
        try:
            with open(man_path) as f:
                man = json.load(f)
            if sha256_file(blob_path) != man["sha256"]:
                raise CheckpointCorruptError(
                    f"session spill {os.path.basename(blob_path)} does "
                    "not match its manifest digest")
            with open(blob_path, "rb") as f:
                return SessionSnapshot.from_bytes(f.read())
        except (OSError, ValueError, KeyError, CheckpointCorruptError,
                InvalidArgumentError):
            # a torn or missing spill is a miss, never a crash: the turn
            # falls back to a plain re-prefill
            self._drop_disk_locked(sid)
            return None

    def _sweep_locked(self) -> None:
        if not self._dir or self._park_after_ms <= 0:
            return
        now = time.time()
        idle = [sid for sid, s in self._ram.items()
                if (now - s.t_park) * 1000.0 >= self._park_after_ms]
        for sid in idle:
            self._spill_locked(sid, self._ram[sid], drop_ram=True)

    # -- public API ----------------------------------------------------------
    def put(self, snap: SessionSnapshot) -> None:
        """Park a snapshot.  Write-through mode (``park_after_ms == 0``
        with a spill dir) persists immediately AND keeps the RAM copy
        hot: the disk blob survives the process, the RAM copy is the fast
        path.  Lazy mode spills older parks on each put."""
        with self._lock:
            sid = snap.session_id
            if sid in self._ram:
                self._ram_bytes -= self._ram[sid].nbytes()
            snap.t_park = snap.t_park or time.time()
            self._ram[sid] = snap
            self._ram_bytes += snap.nbytes()
            if self._dir and self._park_after_ms == 0:
                self._spill_locked(sid, snap, drop_ram=False)
            else:
                self._sweep_locked()

    def take(self, sid: str) -> Optional[SessionSnapshot]:
        """Claim a parked session for restore (removes every copy)."""
        with self._lock:
            snap = self._ram.pop(sid, None)
            if snap is not None:
                self._ram_bytes -= snap.nbytes()
            elif self._dir:
                snap = self._load_disk_locked(sid)
            if self._dir:
                self._drop_disk_locked(sid)
        return snap

    def peek_ids(self) -> List[str]:
        with self._lock:
            return sorted(set(self._ram) | set(self._disk_bytes))

    def __contains__(self, sid: str) -> bool:
        with self._lock:
            return sid in self._ram or sid in self._disk_bytes

    def __len__(self) -> int:
        with self._lock:
            return len(set(self._ram) | set(self._disk_bytes))

    def nbytes(self) -> int:
        """Bytes held: host-RAM snapshots plus spilled blobs."""
        with self._lock:
            return self._ram_bytes + sum(self._disk_bytes.values())

    # -- migration transport -------------------------------------------------
    def export_bytes(self, sid: str) -> Optional[bytes]:
        """Move semantics: serialize-and-remove, for migration off a
        draining server."""
        snap = self.take(sid)
        return None if snap is None else snap.to_bytes()

    def import_bytes(self, blob: bytes) -> Optional[str]:
        """Ingest a migrated session.  Keep-newer: an already-parked copy
        with a later ``t_park`` wins (a stale migration replay must not
        clobber a fresher turn)."""
        snap = SessionSnapshot.from_bytes(blob)
        with self._lock:
            prev = self._ram.get(snap.session_id)
            if prev is not None and prev.t_park > snap.t_park:
                return None
        self.put(snap)
        return snap.session_id
