"""Typed metrics registry, and the latency window and rate meter behind
``Server.stats()``.

Counterpart of ``paddle_tpu/profiler/metrics.py``:

* :class:`MetricsRegistry` holds typed metric families with label sets,
  :class:`Counter`, :class:`Gauge` and :class:`Histogram` (fixed bucket
  bounds), each with its labelled children; :func:`default_registry` is
  the process-wide one the subsystems publish into (the MoE layers'
  ``moe_tokens_dropped_total`` and ``moe_expert_load_ratio``,
  ``nn/layer/moe.py``).  Registration is idempotent for an identical
  re-declaration and raises for a conflicting one.
* :class:`LatencyWindow` and :class:`RateMeter`: the same nearest-rank
  percentiles and monotonic-clock rate.

Not ported yet (ROADMAP A13): the mirror of each update into the
``utils.monitor`` stats (the port has no ``utils/``), the Prometheus text
exposition and ``serve_metrics``, ``write_textfile``, ``dump`` and the
``merge_*`` federation helpers.
"""
from __future__ import annotations

import re
import sys
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "LatencyWindow", "RateMeter"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Prometheus-conventional latency buckets (seconds)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Metric:
    """One metric family: fixed label names, per-label-set children."""

    kind = "untyped"

    def __init__(self, name: str, doc: str, labels: Sequence[str],
                 module: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for lb in labels:
            if not _LABEL_RE.match(lb):
                raise ValueError(f"invalid label name {lb!r} on {name!r}")
        self.name = name
        self.doc = " ".join(str(doc).split())
        self.label_names = tuple(labels)
        self.module = module
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}  # guarded-by: _lock

    def labels(self, *values, **kw):
        """The child of one label-value set (created on first use)."""
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            try:
                values = tuple(str(kw[k]) for k in self.label_names)
            except KeyError as e:
                raise ValueError(
                    f"metric {self.name!r} takes labels "
                    f"{self.label_names}, got {sorted(kw)}") from e
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes {len(self.label_names)} "
                f"label(s) {self.label_names}, got {len(values)}")
        with self._lock:
            ch = self._children.get(values)
            if ch is None:
                ch = self._make_child()
                self._children[values] = ch
            return ch

    def _default_child(self):
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.label_names}: "
                "use .labels(...)")
        return self.labels()

    def _make_child(self):
        raise NotImplementedError

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def describe(self) -> dict:
        return {"name": self.name, "type": self.kind,
                "labels": list(self.label_names), "module": self.module,
                "doc": self.doc}


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0                              # guarded-by: _lock

    def inc(self, amount: float = 1.0) -> None:
        a = float(amount)
        if a < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += a

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Counter(_Metric):
    """Monotonically increasing count (requests served, rows routed)."""

    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0                              # guarded-by: _lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += float(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value that can go both ways (queue depth)."""

    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds):
        self._lock = threading.Lock()
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self._sum = 0.0                          # guarded-by: _lock
        self._count = 0                          # guarded-by: _lock

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self):
        """(cumulative bucket counts aligned to bounds + [+Inf], sum,
        count)."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return cum, s, n

    def raw(self):
        """(per-bucket counts aligned to bounds + [+Inf], sum, count)."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate, q in [0, 1]; None while
        empty."""
        cum, _, n = self.snapshot()
        if n == 0:
            return None
        rank = q * n
        lo = 0.0
        for i, b in enumerate(self._bounds):
            if cum[i] >= rank:
                prev = cum[i - 1] if i else 0
                inb = cum[i] - prev
                frac = (rank - prev) / inb if inb else 1.0
                return lo + (b - lo) * min(1.0, max(0.0, frac))
            lo = b
        return self._bounds[-1] if self._bounds else 0.0


class Histogram(_Metric):
    """Distribution with fixed bucket boundaries (latency, load ratios)."""

    kind = "histogram"

    def __init__(self, name, doc, labels, module,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, doc, labels, module)
        bs = sorted(float(b) for b in buckets)
        if not bs or len(set(bs)) != len(bs):
            raise ValueError(f"invalid histogram buckets {buckets!r}")
        self.buckets = tuple(bs)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def quantile(self, q: float) -> Optional[float]:
        return self._default_child().quantile(q)


class MetricsRegistry:
    """Typed metric families keyed by name.  Registration is idempotent
    for an identical (type, labels, buckets) re-declaration, so a module
    reload does not fail, and raises for a conflicting one."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}         # guarded-by: _lock

    def _register(self, cls, name, doc, labels, module, **kw):
        if module is None:
            module = sys._getframe(2).f_globals.get("__name__", "?")
        with self._lock:
            prev = self._metrics.get(name)
            if prev is not None:
                same = (type(prev) is cls
                        and prev.label_names == tuple(labels)
                        and getattr(prev, "buckets", None)
                        == (tuple(sorted(float(b) for b in kw["buckets"]))
                            if "buckets" in kw else None))
                if not same:
                    raise ValueError(
                        f"metric {name!r} is already registered as "
                        f"{prev.kind}{prev.label_names}; re-registration "
                        "with a different type/labels/buckets would "
                        "silently fork the family")
                return prev
            m = cls(name, doc, labels, module, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, doc: str = "",
                labels: Sequence[str] = (),
                module: Optional[str] = None) -> Counter:
        return self._register(Counter, name, doc, labels, module)

    def gauge(self, name: str, doc: str = "",
              labels: Sequence[str] = (),
              module: Optional[str] = None) -> Gauge:
        return self._register(Gauge, name, doc, labels, module)

    def histogram(self, name: str, doc: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  module: Optional[str] = None) -> Histogram:
        return self._register(Histogram, name, doc, labels, module,
                              buckets=buckets)

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def describe(self) -> List[dict]:
        """Inventory rows: name, type, labels, owning module, doc."""
        return [m.describe() for m in self.collect()]

    def snapshot(self) -> dict:
        """{name: {labels-repr: value, or for a histogram {count, sum,
        p50, p99}}}."""
        out = {}
        for m in self.collect():
            fam = {}
            for values, ch in m.children():
                key = ",".join(f"{k}={v}" for k, v in
                               zip(m.label_names, values)) or ""
                if m.kind == "histogram":
                    _, s, n = ch.snapshot()
                    fam[key] = {"count": n, "sum": round(s, 6),
                                "p50": ch.quantile(0.5),
                                "p99": ch.quantile(0.99)}
                else:
                    fam[key] = ch.value
            out[m.name] = fam
        return out


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem publishes into."""
    return _default


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
