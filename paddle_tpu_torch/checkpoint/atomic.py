"""Atomic, checksummed file writes: the durability primitives of every
checkpoint and session-spill path.

Counterpart of ``paddle_tpu/checkpoint/atomic.py``.  On a posix/local
filesystem the contract is

    write temp (same dir) -> flush -> fsync(file) -> os.replace -> fsync(dir)

so a crash at ANY point leaves either the old file or the new file, never
a torn hybrid.  The directory fsync makes the rename itself durable.
Every payload also carries a sha256 so the LOADER can tell a complete
file from a corrupt one: rename atomicity protects against crashes
mid-write, checksums against everything else (partial copies, bit rot,
a temp file mistaken for real data).

The pickle format is the JAX package's checkpoint format (a magic-tagged
pickle of a nested dict whose tensor leaves are numpy arrays), so either
package's loader reads either writer's file.  Tensors of a dtype numpy
has no name for (bfloat16) are refused on save.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, Tuple

import numpy as np
import torch

from ..framework.enforce import InvalidArgumentError

__all__ = ["fsync_dir", "sha256_file", "atomic_write_bytes",
           "atomic_pickle_save", "verified_pickle_load",
           "CheckpointCorruptError"]

# the JAX package's checkpoint magic (paddle_tpu/framework/io_state.py)
_MAGIC = "paddle_tpu.checkpoint.v1"


def fsync_dir(path: str) -> None:
    """Durably commit a directory's entries (rename targets)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms/filesystems without dir-open support
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def atomic_write_bytes(path: str, data: bytes, durable: bool = True) -> str:
    """Write ``data`` to ``path`` atomically; returns the sha256 hexdigest.

    The temp file lives in the SAME directory as the target: os.replace
    is only atomic within a filesystem, and a same-dir temp keeps any
    debris local to the target's directory."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.",
                               dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            if durable:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if durable:
        fsync_dir(d)
    return hashlib.sha256(data).hexdigest()


def _to_saveable(obj: Any):
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            raise InvalidArgumentError(
                "a bfloat16 tensor has no numpy dtype in the checkpoint "
                "format; cast it to float32 first")
        return {"__tensor__": True, "data": obj.detach().cpu().numpy(),
                "name": None, "stop_gradient": not obj.requires_grad}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def _from_saveable(obj: Any, return_numpy: bool):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            data = obj["data"]
            return data if return_numpy else torch.from_numpy(
                np.array(data))
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


def atomic_pickle_save(obj: Any, path: str, protocol: int = 4,
                       durable: bool = True) -> Tuple[str, int]:
    """Serialize ``obj`` in the checkpoint format and commit it
    atomically.  Returns (sha256, byte size)."""
    payload = pickle.dumps({"magic": _MAGIC, "obj": _to_saveable(obj)},
                           protocol=protocol)
    return atomic_write_bytes(path, payload, durable=durable), len(payload)


def verified_pickle_load(path: str, expect_sha256: str = None,
                         return_numpy: bool = False) -> Any:
    """Load a checkpoint payload, verifying its checksum first when one is
    given.  Tensor leaves come back as CPU tensors (numpy arrays with
    ``return_numpy``).  Raises :class:`CheckpointCorruptError` on a
    mismatch, so callers can tell a corrupt file (fall back to an older
    one) from an IO error."""
    if expect_sha256 is not None:
        actual = sha256_file(path)
        if actual != expect_sha256:
            raise CheckpointCorruptError(
                f"checksum mismatch for {path}: "
                f"expected {expect_sha256[:12]}…, got {actual[:12]}…")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if isinstance(payload, dict) and payload.get("magic") == _MAGIC:
        payload = payload["obj"]
    return _from_saveable(payload, return_numpy)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but fails verification (torn write, bit
    rot, truncation).  Loaders treat it as "checkpoint absent" and fall
    back to the previous complete one."""
