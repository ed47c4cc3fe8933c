"""In-process serving engine for autoregressive decode models.

Counterpart of the decode half of ``paddle_tpu/serving/server.py``
(``ServingConfig`` and ``Server`` with ``register_decode``, ``start``,
``submit_decode``, ``run_decode``, ``stop``, ``stats`` and
``signals``).  Requests stream into a bounded queue; a scheduler
thread packs them FIFO into batch buckets; worker threads run each
batch's prefill and decode loop on the server's device and resolve the
requests' futures with their own rows.  ``start`` warms every (batch bucket x prefill bucket) pair before
a single request is admitted.  Under ``FLAGS_decode_slots > 0`` the
workers hand each row to the model's slot loop (serving/slots.py)
instead, which admits and retires rows at token boundaries.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..framework import flags as _flags
from ..framework.enforce import (InvalidArgumentError, NotFoundError,
                                 PreconditionNotMetError, UnavailableError)
from ..framework.place import DeviceLike, resolve_device
from .decode import DecodeModelSpec, DecodeRequest, _DecodeRuntime
from .scheduler import Batch, RequestQueue

__all__ = ["ServingConfig", "Server"]


@dataclass
class ServingConfig:
    """Server-wide knobs; None fields fall back to FLAGS_serving_*."""

    workers: Optional[int] = None
    queue_capacity: Optional[int] = None
    batch_timeout_ms: Optional[float] = None
    buckets: Optional[Sequence[int]] = None


class _Worker(threading.Thread):
    """One serving thread: runs whole batches (prefill + decode loop)
    synchronously and slices the generated rows back per request."""

    def __init__(self, server: "Server", idx: int):
        super().__init__(name=f"serving-worker-{idx}", daemon=True)
        self._server = server

    def _execute(self, batch: Batch):
        rt = self._server._models[batch.model]
        toks = rt.execute(batch)
        now = time.perf_counter()
        off = 0
        for r in batch.requests:
            if r.future.done():         # a slot row failed it already
                off += r.rows
                continue
            r.future.set_result([toks[off:off + r.rows, :r.max_new]])
            rt.latency.observe(now - r.t_enqueue)
            if r.t_first is not None:
                rt.ttft.observe(r.t_first - r.t_enqueue)
            off += r.rows
        rt.rate.add(len(batch.requests))
        rt.bump(completed=len(batch.requests), batches=1, rows=batch.rows,
                padded_rows=batch.bucket - batch.rows,
                tokens=sum(r.rows * r.max_new for r in batch.requests))

    def _fail(self, batch: Batch, exc: Exception):
        rt = self._server._models[batch.model]
        for r in batch.requests:
            if not r.future.done():
                r.future.set_exception(exc)
        rt.bump(errors=len(batch.requests))

    def run(self):
        q = self._server._dispatch_q
        while True:
            batch = q.get()
            if batch is None:
                return
            try:
                self._execute(batch)
            except Exception as e:   # noqa: BLE001 — fail the batch, not the server
                self._fail(batch, e)


class Server:
    """In-process decode serving engine on one device.

    Lifecycle::

        srv = serving.Server()                    # device defaults to cuda
        srv.register_decode("gpt2", model, batch_buckets=(1, 8),
                            seq_buckets=(128, 256), max_len=256,
                            max_new_tokens=128)
        srv.start()                               # warm every bucket pair
        fut = srv.submit_decode("gpt2", [prompt]) # prompt: 1-D int array
        ids = fut.result()[0]                     # [rows, max_new] int32
        srv.stop()
    """

    def __init__(self, config: Optional[ServingConfig] = None, *,
                 device: DeviceLike = None):
        self._config = config or ServingConfig()
        self.device = resolve_device(device)
        self._models: Dict[str, _DecodeRuntime] = {}
        self._specs: List[DecodeModelSpec] = []
        self._queue: Optional[RequestQueue] = None
        self._dispatch_q: Optional[queue.Queue] = None
        self._scheduler: Optional[threading.Thread] = None
        self._workers: List[_Worker] = []
        self._started = False
        self._stopped = False

    # -- registry ------------------------------------------------------------
    def register_decode(self, spec_or_name, layer=None, **kw
                        ) -> DecodeModelSpec:
        """Register an autoregressive-decode model (a DecodeModelSpec, or
        name + live layer + DecodeModelSpec kwargs).  Warm-up runs every
        (batch-bucket x prompt-bucket) pair; traffic goes through
        :meth:`submit_decode`."""
        if self._started:
            raise PreconditionNotMetError(
                "register_decode() after start(): the warm-up contract "
                "admits no un-warmed model — build a new Server")
        if isinstance(spec_or_name, DecodeModelSpec):
            spec = spec_or_name
        else:
            if layer is None:
                raise InvalidArgumentError(
                    "register_decode(name, layer, ...)")
            kw.setdefault("batch_buckets", self._config.buckets)
            spec = DecodeModelSpec(name=str(spec_or_name), layer=layer,
                                   **kw)
        if spec.name in {s.name for s in self._specs}:
            raise InvalidArgumentError(
                f"model {spec.name!r} is already registered")
        self._specs.append(spec)
        return spec

    def models(self) -> List[str]:
        return [s.name for s in self._specs]

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Server":
        """Load and warm every registered model, then open the doors
        (scheduler + worker threads)."""
        if self._started:
            raise PreconditionNotMetError("Server already started")
        if not self._specs:
            raise PreconditionNotMetError("no models registered")
        for spec in self._specs:
            rt = _DecodeRuntime(spec, self.device)
            rt.load()
            rt.warmup()
            rt.rate.reset()              # QPS clock starts with traffic
            self._models[spec.name] = rt
        n_workers = self._config.workers \
            or int(_flags.flag("serving_workers"))
        cap = self._config.queue_capacity \
            or int(_flags.flag("serving_queue_capacity"))
        self._queue = RequestQueue(cap)
        self._dispatch_q = queue.Queue(maxsize=n_workers)
        self._workers = [_Worker(self, i) for i in range(n_workers)]
        for w in self._workers:
            w.start()
        self._scheduler = threading.Thread(
            target=self._schedule_loop, name="serving-scheduler",
            daemon=True)
        self._scheduler.start()
        self._started = True
        return self

    def _schedule_loop(self):
        timeout_ms = self._config.batch_timeout_ms
        if timeout_ms is None:
            timeout_ms = float(_flags.flag("serving_batch_timeout_ms"))
        while True:
            batch = self._queue.next_batch(
                lambda m: self._models[m].ladder.max_rows,
                lambda m, rows: self._models[m].ladder.bucket_for(rows),
                timeout_ms / 1e3)
            if batch is None:
                break
            self._dispatch_q.put(batch)      # bounded: backpressure makes
        for _ in self._workers:              # queued requests batch bigger
            self._dispatch_q.put(None)

    def stop(self, drain: bool = True) -> None:
        """Stop accepting traffic; ``drain`` serves what is queued first,
        otherwise pending futures fail with UnavailableError."""
        if not self._started or self._stopped:
            self._stopped = True
            return
        if not drain:
            for r in self._queue.drain():
                if not r.future.done():
                    r.future.set_exception(UnavailableError(
                        "server stopped before this request was served"))
        self._queue.close()
        self._scheduler.join(timeout=30)
        for w in self._workers:
            w.join(timeout=30)
        for rt in self._models.values():
            rt.close()                  # the slot loops' driver threads
        self._stopped = True

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    # -- traffic -------------------------------------------------------------
    def _runtime(self, model: str) -> _DecodeRuntime:
        rt = self._models.get(model)
        if rt is None or not rt.admitted:
            raise NotFoundError(
                f"model {model!r} is not admitted (registered: "
                f"{self.models()})")
        return rt

    def submit_decode(self, model: str, prompts,
                      max_new_tokens: Optional[int] = None,
                      timeout: Optional[float] = 5.0) -> Future:
        """Enqueue one decode request: ``prompts`` is a list of 1-D int
        token arrays (variable lengths — they left-pad to the prompt
        bucket at execution).  Resolves to ``[ids]`` where ids is an
        int32 array [len(prompts), max_new_tokens] of generated tokens.
        Blocks up to ``timeout`` under backpressure, then raises
        UnavailableError."""
        if not self._started or self._stopped:
            raise PreconditionNotMetError(
                "Server is not serving (start() it / already stopped)")
        rt = self._runtime(model)
        arrs, max_new = rt.validate(list(prompts), max_new_tokens)
        rt.ladder.bucket_for(len(arrs))      # raises OutOfRange early
        req = DecodeRequest(model=model, prompts=arrs, rows=len(arrs),
                            max_new=max_new)
        rt.bump(requests=1)
        try:
            self._queue.put(req, timeout=timeout)
        except UnavailableError:
            rt.bump(errors=1)
            raise
        return req.future

    def run_decode(self, model: str, prompts,
                   max_new_tokens: Optional[int] = None,
                   timeout: Optional[float] = 60.0):
        """Synchronous convenience: submit_decode + wait."""
        return self.submit_decode(model, prompts, max_new_tokens) \
            .result(timeout=timeout)

    # -- observability -------------------------------------------------------
    def stats(self, model: Optional[str] = None) -> dict:
        """Serving health snapshot: per-model qps, latency and
        time-to-first-token percentiles, padding and steady-state cold
        batches, or all models."""
        if model is None:
            return {name: self.stats(name) for name in self._models}
        rt = self._runtime(model)
        with rt._mlock:
            c = dict(rt.counters)
        lat = rt.latency.snapshot()
        ttft = rt.ttft.snapshot()
        loop = rt._loop.stats() if rt._loop is not None else None
        rows = max(1, c["rows"])
        return {
            "model": model, "backend": rt.backend,
            "device": str(self.device),
            "buckets": rt.ladder.buckets,
            "requests": c["requests"], "completed": c["completed"],
            "errors": c["errors"], "batches": c["batches"],
            "tokens": c["tokens"],
            "qps": round(rt.rate.rate(), 2),
            "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
            "max_ms": lat["max_ms"],
            "ttft_p50_ms": ttft["p50_ms"], "ttft_p99_ms": ttft["p99_ms"],
            "avg_batch_rows": round(c["rows"] / max(1, c["batches"]), 2),
            "padding_ratio": round(c["padded_rows"] /
                                   (rows + c["padded_rows"]), 4),
            "queue_depth": self._queue.depth() if self._queue else 0,
            "steady_compiles": c["steady_compiles"],
            **({"slot_loop": loop} if loop is not None else {}),
            **(rt.spec_stats(loop) or {}),
        }

    def signals(self) -> dict:
        """This process's load snapshot: queue depth, average batch
        occupancy and steady-state cold batches summed over models, and,
        for slot-mode models (FLAGS_decode_slots), the token-level slot
        accounting: occupancy is the max over them, the join/retire
        counters and prefix-cache sizes sum."""
        out = {"queue_depth": self._queue.depth() if self._queue else 0}
        rows = batches = steady = 0
        for rt in self._models.values():
            with rt._mlock:
                c = dict(rt.counters)
            rows += c["rows"]
            batches += c["batches"]
            steady += c["steady_compiles"]
        out["batch_occupancy_rows"] = round(rows / batches, 3) \
            if batches else 0.0
        out["steady_compiles"] = steady
        slot = [s for s in (rt.slot_signals()
                            for rt in self._models.values())
                if s is not None]
        if slot:
            out["decode_slot_occupancy_ratio"] = max(
                s["decode_slot_occupancy_ratio"] for s in slot)
            out["slots_joined_total"] = sum(
                s["slots_joined_total"] for s in slot)
            out["slots_retired_total"] = sum(
                s["slots_retired_total"] for s in slot)
            for k in ("prefix_cache_blocks", "prefix_cache_bytes"):
                if any(k in s for s in slot):
                    out[k] = sum(s.get(k, 0) for s in slot)
        out["models"] = self.models()
        return out
