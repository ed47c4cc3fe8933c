"""Batch buckets: the static-shape discipline of continuous batching.

Counterpart of ``paddle_tpu/serving/bucketing.py``.  Every formed batch
pads up to the smallest bucket of a fixed ladder that holds it, warm-up
runs every bucket once, and steady state replays only those shapes.
The ladder defaults to FLAGS_serving_buckets (``"1,2,4,8,16,32,64"``);
geometric spacing bounds padding waste at <2x worst case.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..framework import flags as _flags
from ..framework.enforce import InvalidArgumentError, OutOfRangeError


class BucketLadder:
    """Sorted, de-duplicated set of batch buckets."""

    def __init__(self, buckets: Sequence[int]):
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] <= 0:
            raise InvalidArgumentError(
                f"bucket ladder needs positive sizes, got {list(buckets)}")
        self._buckets = bs

    @classmethod
    def from_flag(cls, spec=None) -> "BucketLadder":
        """Parse ``spec`` (or FLAGS_serving_buckets) — "1,2,4,8"-style."""
        raw = spec if spec is not None else _flags.flag("serving_buckets")
        if isinstance(raw, (list, tuple)):
            return cls(raw)
        return cls([int(b) for b in str(raw).split(",") if b.strip()])

    @property
    def buckets(self) -> List[int]:
        return list(self._buckets)

    @property
    def max_rows(self) -> int:
        return self._buckets[-1]

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket holding ``rows``; OutOfRange past the ladder."""
        for b in self._buckets:
            if rows <= b:
                return b
        raise OutOfRangeError(
            f"{rows} rows exceed the largest serving bucket "
            f"{self._buckets[-1]} (ladder {self._buckets})")

    def __iter__(self):
        return iter(self._buckets)

    def __len__(self):
        return len(self._buckets)

    def __contains__(self, b):
        return int(b) in self._buckets

    def __repr__(self):
        return f"BucketLadder({self._buckets})"


def pad_to_bucket(arrs: Sequence[np.ndarray], rows: int,
                  bucket: int) -> List[np.ndarray]:
    """Pad each array's leading dim from ``rows`` up to ``bucket`` with
    zeros (host-side, before the H2D copy).  Zero padding is safe for the
    per-example inference contract: padded rows are sliced away before
    results are returned, and no served output row depends on another
    row's input."""
    if bucket == rows:
        return list(arrs)
    out = []
    for a in arrs:
        pad = np.zeros((bucket - rows,) + a.shape[1:], dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out
