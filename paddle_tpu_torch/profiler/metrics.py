"""Latency window and rate meter behind ``Server.stats()``.

Counterpart of ``LatencyWindow`` and ``RateMeter`` in
``paddle_tpu/profiler/metrics.py`` (same nearest-rank percentiles and
monotonic-clock rate), without the metrics registry they publish to.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class LatencyWindow:
    """Sliding window of the last ``maxlen`` latency samples (seconds)."""

    def __init__(self, maxlen: int = 2048):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=int(maxlen))   # guarded-by: _lock
        self._count = 0                                # guarded-by: _lock
        self._max = 0.0                                # guarded-by: _lock

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        with self._lock:
            self._buf.append(s)
            self._count += 1
            self._max = max(self._max, s)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile ``p`` in [0, 100] over the window;
        None while empty."""
        with self._lock:
            data = sorted(self._buf)
        if not data:
            return None
        rank = max(0, min(len(data) - 1,
                          int(round(p / 100.0 * len(data) + 0.5)) - 1))
        return data[rank]

    def snapshot(self) -> Dict[str, float]:
        """{count, p50_ms, p99_ms, max_ms} (zeros while empty)."""
        p50, p99 = self.percentile(50), self.percentile(99)
        with self._lock:
            count, mx = self._count, self._max
        return {"count": count,
                "p50_ms": 0.0 if p50 is None else p50 * 1e3,
                "p99_ms": 0.0 if p99 is None else p99 * 1e3,
                "max_ms": mx * 1e3}


class RateMeter:
    """Completed count over monotonic time since creation or reset()."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()                    # guarded-by: _lock
        self._n = 0                                    # guarded-by: _lock

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += int(n)

    def reset(self) -> None:
        with self._lock:
            self._t0 = time.monotonic()
            self._n = 0

    def rate(self) -> float:
        with self._lock:
            dt = time.monotonic() - self._t0
            n = self._n
        return n / dt if dt > 0 else 0.0
