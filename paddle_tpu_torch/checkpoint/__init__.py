"""Atomic, checksummed writes (``atomic.py``), the durability contract
of the session store's disk spill."""
from .atomic import (  # noqa: F401
    CheckpointCorruptError, atomic_pickle_save, atomic_write_bytes,
    fsync_dir, sha256_file, verified_pickle_load)
