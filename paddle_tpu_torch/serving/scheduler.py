"""Request queue + continuous batcher.

Counterpart of ``paddle_tpu/serving/scheduler.py`` (``Request``,
``Batch``, ``pack_fifo``, ``RequestQueue``), without the metrics
registry, the tracing hooks and the per-tenant admission classes.
Requests stream into per-model FIFO queues; whenever a worker can take
work the scheduler packs the oldest requests into one batch, padded to a
ladder bucket.  While the workers are busy arrivals accumulate, so the
next batch is bigger.  Host-side lock-and-condvar concurrency only.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..framework.enforce import UnavailableError


@dataclass
class Request:
    """One client request: ``rows`` examples for one model."""

    model: str
    inputs: Tuple[np.ndarray, ...]
    rows: int
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.perf_counter)


@dataclass
class Batch:
    """A scheduler-formed batch: FIFO requests totalling ``rows`` rows,
    to be padded up to ``bucket`` rows at execution."""

    model: str
    requests: list
    rows: int
    bucket: int


def pack_fifo(pending, max_rows: int) -> Tuple[list, int]:
    """Pop requests FIFO while they fit in ``max_rows`` total rows.
    Always takes at least the head request (callers pre-validate that a
    single request fits the ladder)."""
    taken: List = []
    rows = 0
    while pending and (not taken or rows + pending[0].rows <= max_rows):
        r = pending.popleft()
        taken.append(r)
        rows += r.rows
    return taken, rows


class RequestQueue:
    """Bounded multi-model FIFO with condition-variable handoff.

    ``put`` applies backpressure (blocks up to its timeout, then raises
    UnavailableError); ``next_batch`` blocks until work exists, holds the
    batch open up to ``batch_timeout_s`` for more arrivals, then packs
    FIFO up to the model's bucket ceiling."""

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._cond = threading.Condition()
        self._pending: "OrderedDict[str, deque]" = OrderedDict()  # guarded-by: _cond
        self._depth = 0                                           # guarded-by: _cond
        self._closed = False                                      # guarded-by: _cond

    # -- producer ------------------------------------------------------------
    def put(self, req, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while not self._closed and self._depth >= self._capacity:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise UnavailableError(
                        f"serving queue full ({self._capacity} pending); "
                        "backpressure timeout expired")
                self._cond.wait(remaining)
            if self._closed:
                raise UnavailableError("serving queue is closed")
            self._pending.setdefault(req.model, deque()).append(req)
            self._depth += 1
            self._cond.notify_all()

    # -- consumer (scheduler thread) -----------------------------------------
    def _oldest_model(self) -> Optional[str]:
        best, best_t = None, None
        for name, dq in self._pending.items():
            if dq and (best_t is None or dq[0].t_enqueue < best_t):
                best, best_t = name, dq[0].t_enqueue
        return best

    def next_batch(self, max_rows_of, bucket_of,
                   batch_timeout_s: float) -> Optional[Batch]:
        """Form the next batch, or None once closed and drained.
        ``max_rows_of(model)`` bounds the pack; ``bucket_of(model, rows)``
        maps packed rows to the ladder bucket."""
        with self._cond:
            while True:
                model = self._oldest_model()
                if model is not None:
                    break
                if self._closed:
                    return None
                self._cond.wait(0.1)
            # hold the batch open for stragglers: arrivals within the
            # window ride this batch instead of paying their own
            dq = self._pending[model]
            limit = max_rows_of(model)
            if batch_timeout_s > 0:
                deadline = dq[0].t_enqueue + batch_timeout_s
                while (sum(r.rows for r in dq) < limit
                       and not self._closed):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            taken, rows = pack_fifo(dq, limit)
            self._depth -= len(taken)
            self._cond.notify_all()
        return Batch(model=model, requests=taken, rows=rows,
                     bucket=bucket_of(model, rows))

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return self._depth

    def drain(self) -> list:
        """Pop everything still pending (stop without serving them)."""
        with self._cond:
            out: List = []
            for dq in self._pending.values():
                out.extend(dq)
                dq.clear()
            self._depth = 0
            self._cond.notify_all()
            return out
