"""In-process serving engine: dense models and autoregressive decode.

Counterpart of ``paddle_tpu/serving/server.py`` (``ModelSpec``,
``export_for_serving``, ``ServingConfig`` and ``Server`` with
``register``, ``register_decode``, ``start``, ``submit``, ``run``,
``submit_decode``, ``run_decode``, ``stop``, ``stats``, ``signals`` and
the steady-state compile check).  Requests stream into a bounded queue;
a scheduler thread packs them FIFO into batch buckets; worker threads
run each batch on the server's device and resolve the requests' futures
with their own rows.

Dense models (``register``/``submit``) are ``jit.save`` programs or
static ``save_inference_model`` directories, loaded through
``inference.Predictor``.  The JAX package compiles one
executable per (model, bucket) ahead of time; the port captures one CUDA
graph per (model, bucket) at ``start()`` (:class:`_BucketGraph`), and a
batch is copied into the graph's input buffers, replayed, and its
outputs copied out before the graph runs again.  A worker keeps up to
``FLAGS_serving_pipeline_depth`` batches in flight and fences the
oldest.  After warm-up no graph is captured: a bucket without one fails
under ``FLAGS_serving_strict``, or is captured and recorded as a
steady-state capture (``compile_events_since_warmup``).  On the CPU
nothing is captured: warm-up runs each bucket once and a batch runs the
program eagerly through the worker's ``Predictor.clone()``.

A static inference model (backend ``"executor"``; its ``input_specs``
name the feeds' shapes and dtypes) runs through the Predictor's static
``Executor``: warm-up runs each bucket twice, since the Executor captures
an entry on its second run, and marks the Executor's steady state; a
batch runs synchronously through the worker's clone (the Executor's
numpy copy of the fetches fences it), the clones taking turns on each
bucket's graph under the entry's lock.  The zero-capture check reads the
Executor's ``compile_events_since_warmup()``.

Decode models (``register_decode``/``submit_decode``): ``start`` warms
every (batch bucket x prefill bucket) pair before a single request is
admitted.  Under ``FLAGS_decode_slots > 0`` the workers hand each row to
the model's slot loop (serving/slots.py) instead, which admits and
retires rows at token boundaries.  Under ``FLAGS_session_store`` the
server builds one session store at ``start`` (serving/sessions.py) and
``submit_decode(session_id=)`` names a conversation; ``drain`` parks the
live ones.  ``prefill_handoff`` / ``decode_from_handoff`` split a
decode into its prefill and its decode across a KV handoff.

``export_for_serving(int8=True)`` exports a frozen int8 program
(``quantization.save_int8_model``: ``<prefix>.int8.pdmodel`` and the
``quant.json`` sidecar), which the Predictor loads, and the bucket
graphs capture, as any other program.

Not ported: the graph-lint admission gate (``FLAGS_graph_lint`` must be
"off"), tracing spans, tenants and the cluster router.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.enforce import (InvalidArgumentError, NotFoundError,
                                 PreconditionNotMetError, UnavailableError,
                                 UnimplementedError)
from ..framework.place import DeviceLike, module_device, resolve_device
from ..profiler.metrics import LatencyWindow, RateMeter
from .bucketing import BucketLadder, pad_to_bucket
from .decode import DecodeModelSpec, DecodeRequest, _DecodeRuntime
from .scheduler import Batch, Request, RequestQueue

__all__ = ["ModelSpec", "export_for_serving", "ServingConfig", "Server"]


# ---------------------------------------------------------------------------
# Deploy artifact contract
# ---------------------------------------------------------------------------

@dataclass
class ModelSpec:
    """One served dense model: a ``jit.save`` prefix (``m`` for
    ``m.pdmodel``; with a ``<prefix>.serving.json`` manifest from
    :func:`export_for_serving`) or a static ``save_inference_model``
    directory, and its bucket ladder (default FLAGS_serving_buckets).
    ``input_specs`` (``[(shape, dtype), ...]`` or ``InputSpec``s, a None
    leading dim) is required for a static directory, whose feeds carry
    no shape to bucket on."""

    name: str
    path: str
    buckets: Optional[Sequence[int]] = None
    input_specs: Optional[Sequence] = None


def _manifest_path(prefix: str) -> str:
    return prefix + ".serving.json"


def _dtype_name(dtype) -> str:
    from ..jit import to_torch_dtype
    return str(to_torch_dtype(dtype)).split(".")[-1]


def export_for_serving(layer, prefix: str, input_spec, buckets=None,
                       int8: bool = False) -> dict:
    """Export ``layer`` for the serving engine and write the
    ``<prefix>.serving.json`` manifest the registry discovers.

    Tries one export with a symbolic batch dim first ("poly": one program
    serves every bucket), and runs the loaded program at every bucket of
    the ladder: ``torch.export`` may have specialized the batch dim, and
    bucket 1 is where that shows.  If either fails it writes one export
    per bucket, ``<prefix>.b<k>`` ("per_bucket").  The program is
    exported on ``layer``'s device and serves there.  With ``int8`` each
    export is a frozen int8 one (``quantization.save_int8_model``, which
    freezes a QAT- or PTQ-calibrated ``layer`` in place first), written
    as ``<prefix>.int8`` (``<prefix>.b<k>.int8``) beside its
    ``quant.json``; the Predictor's int8 path loads it."""
    from .. import jit as _jit
    from ..static import InputSpec
    ladder = BucketLadder.from_flag(buckets)
    device = module_device(layer) or torch.device("cpu")

    def norm(spec):
        if isinstance(spec, InputSpec):
            return list(spec.shape), spec.dtype
        shape, dtype = spec
        return list(shape), dtype

    rests = [(list(shape[1:]), dtype)
             for shape, dtype in map(norm, input_spec)]

    def save(pfx, lead):
        spec = [InputSpec([lead] + rest, dtype=dtype)
                for rest, dtype in rests]
        if int8:
            from ..quantization import save_int8_model
            save_int8_model(layer, pfx, input_spec=spec)
        else:
            _jit.save(layer, pfx, input_spec=spec)

    def verify(pfx):
        tl = _jit.load(pfx + (".int8" if int8 else ""), device=device)
        for b in ladder:
            outs = tl(*[torch.zeros([b] + rest,
                                    dtype=_jit.to_torch_dtype(dtype),
                                    device=device) for rest, dtype in rests])
            for o in outs if isinstance(outs, list) else [outs]:
                if o.shape[0] != b:
                    raise PreconditionNotMetError(
                        f"poly export returned batch {o.shape[0]} at "
                        f"bucket {b}")

    mode = "poly"
    try:
        save(prefix, None)
        verify(prefix)
    except Exception:   # noqa: BLE001 — any failure: one export per bucket
        mode = "per_bucket"
        for b in ladder:
            save(f"{prefix}.b{b}", b)
    manifest = {"mode": mode, "buckets": ladder.buckets, "int8": bool(int8),
                "input_specs": [[[None] + rest, _dtype_name(dtype)]
                                for rest, dtype in rests]}
    with open(_manifest_path(prefix), "w") as f:
        json.dump(manifest, f)
    return manifest


# ---------------------------------------------------------------------------
# One served dense model
# ---------------------------------------------------------------------------

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.float16: np.float16, torch.int64: np.int64,
          torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
          torch.uint8: np.uint8, torch.bool: np.bool_}


class _Done:
    """A batch already computed (the CPU's eager run)."""

    def __init__(self, outs):
        self._outs = outs

    def fence(self):
        return self._outs


class _InFlight:
    """A replayed batch: its outputs' pinned host copies and the event
    recorded after them."""

    def __init__(self, outs, done):
        self._outs, self._done = outs, done

    def fence(self):
        self._done.synchronize()
        return [o.numpy() for o in self._outs]


class _EagerBucket:
    """One bucket on the CPU: nothing is captured; a batch runs the
    program eagerly through the worker's clone of the bucket's
    predictor."""

    captured = False

    def __init__(self, predictor, templates, bucket):
        self.predictor = predictor
        predictor.clone().run([np.zeros((bucket,) + rest, dt)
                               for rest, dt in templates])

    def dispatch(self, padded, clone):
        return _Done(clone.run(padded))


class _BucketGraph:
    """One (model, bucket) as a captured CUDA graph.

    The graph owns its input buffers (zeros of the bucket's shapes) and
    its outputs (bf16 ones widened to f32 inside the graph, exactly, for
    numpy).  Capture follows warm-up runs on a side stream; a failed
    capture raises.  The graph reads the weights of the predictor's
    loaded program, shared by every graph and clone of the model.

    Every worker replays on the model's serving stream under the graph's
    lock: a batch's input copies, the replay and the copies of its
    outputs into fresh pinned host buffers are enqueued together, and
    stream order keeps the next batch's input copies behind them.  The
    returned :class:`_InFlight` is fenced by its event.  ``replays``
    counts the replays."""

    captured = True

    def __init__(self, predictor, templates, bucket, stream):
        dev = predictor.device
        self.predictor = predictor
        self.stream = stream
        self.lock = threading.Lock()
        with torch.no_grad():
            self.inputs = [torch.zeros((bucket,) + rest, dtype=dt,
                                       device=dev)
                           for rest, dt in templates]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                predictor.run_async(self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        # kept beside its executable, so that its kernel nodes can be read
        # back (profiler.cuda_graph); thread-local, so that a worker
        # replaying another bucket meanwhile does not invalidate a
        # steady-state capture
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            outs = predictor.run_async(self.inputs)
            self.outputs = [o.float() if o.dtype == torch.bfloat16 else o
                            for o in outs]
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.replays = 0

    def dispatch(self, padded, clone=None):
        staged = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                  for a in padded]
        with self.lock, torch.cuda.stream(self.stream):
            for dst, src in zip(self.inputs, staged):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
            self.replays += 1
            host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    .copy_(o, non_blocking=True) for o in self.outputs]
            done = torch.cuda.Event()
            done.record(self.stream)
        return _InFlight(host, done)


class _ExecutorBucket(_EagerBucket):
    """One bucket of a static inference model: warm-up runs it twice on
    CUDA, so that the Executor's entry is captured before traffic (once
    on the CPU, where nothing is captured); a batch runs synchronously
    through the worker's clone."""

    def __init__(self, predictor, templates, bucket):
        self.captured = predictor.device.type == "cuda"
        self.predictor = predictor
        for _ in range(2 if self.captured else 1):
            predictor.clone().run([np.zeros((bucket,) + rest, dt)
                                   for rest, dt in templates])


class _ModelRuntime:
    """A loaded dense model: its predictors, bucket ladder, one
    executable per bucket (a :class:`_BucketGraph` on CUDA, an
    :class:`_EagerBucket` on the CPU, an :class:`_ExecutorBucket` for a
    static inference model), the warm-up and steady-state capture
    events, and serving metrics."""

    kind = "dense"

    def __init__(self, spec: ModelSpec, device):
        self.spec = spec
        self.name = spec.name
        self.device = device
        self.site = f"serving:{spec.name}"
        self.ladder = BucketLadder.from_flag(spec.buckets)
        self.backend = None       # "jit" | "jit_per_bucket" | "executor"
        self.primary = None
        self.predictors: Dict[int, object] = {}      # bucket -> Predictor
        self.executables: Dict[int, object] = {}     # bucket -> executable
        self.templates: List[tuple] = []             # (rest, torch dtype)
        self.np_dtypes: List[np.dtype] = []
        self.n_inputs = 0
        self.stream = None
        self.events: List[dict] = []   # captures (warm-up and steady)
        self.admitted = False
        self.latency = LatencyWindow(
            int(_flags.flag("serving_metrics_window")))
        self.rate = RateMeter()
        self._build_lock = threading.Lock()
        self._mlock = threading.Lock()
        self.counters = {"requests": 0, "completed": 0,  # guarded-by: _mlock
                         "errors": 0, "batches": 0, "rows": 0,
                         "padded_rows": 0, "steady_compiles": 0}

    def bump(self, **kw):
        with self._mlock:
            for k, v in kw.items():
                self.counters[k] += v

    # -- loading -------------------------------------------------------------
    def _predictor(self, path):
        from ..inference import Config, Predictor
        cfg = Config(path)
        if self.device.type == "cpu":
            cfg.disable_gpu()
        else:
            cfg.enable_use_gpu(device_id=self.device.index or 0)
        return Predictor(cfg)

    def load(self):
        from ..jit import to_torch_dtype
        manifest = None
        mpath = _manifest_path(self.spec.path)
        if os.path.isfile(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        if manifest is not None and manifest.get("mode") == "per_bucket":
            self.backend = "jit_per_bucket"
            buckets = [b for b in manifest["buckets"] if b in self.ladder]
            if not buckets:
                raise PreconditionNotMetError(
                    f"serving model {self.name!r}: per-bucket export "
                    f"{manifest['buckets']} shares no bucket with the "
                    f"requested ladder {self.ladder.buckets}")
            self.ladder = BucketLadder(buckets)
            for b in self.ladder:
                self.predictors[b] = self._predictor(f"{self.spec.path}.b{b}")
            self.primary = self.predictors[self.ladder.buckets[0]]
            specs = [(shape, to_torch_dtype(dt))
                     for shape, dt in manifest["input_specs"]]
        else:
            self.primary = self._predictor(self.spec.path)
            if self.primary._translated is None:
                self.backend = "executor"
                specs = self._specs_of_executor(manifest)
            else:
                self.backend = "jit"
                specs = self.primary._translated.input_specs()
                lead = {shape[0] for shape, _ in specs}
                if len(lead) == 1 and None not in lead:
                    # a fixed-batch export without per-bucket siblings:
                    # the ladder collapses to the one batch it can run
                    self.ladder = BucketLadder([lead.pop()])
            self.predictors = {b: self.primary for b in self.ladder}
        for i, (shape, dt) in enumerate(specs):
            if any(d is None for d in shape[1:]):
                raise PreconditionNotMetError(
                    f"serving model {self.name!r}: input {i} has a "
                    f"non-leading symbolic dim {shape} — only the batch "
                    "dim may be dynamic under bucketed serving")
            if dt not in _NUMPY:
                raise PreconditionNotMetError(
                    f"serving model {self.name!r}: input {i} is {dt}, "
                    "which has no numpy dtype to serve from")
            self.templates.append((tuple(int(d) for d in shape[1:]), dt))
            self.np_dtypes.append(np.dtype(_NUMPY[dt]))
        self.n_inputs = len(self.templates)

    def _specs_of_executor(self, manifest):
        """(shape, torch dtype) of each feed of a static inference model,
        from ``ModelSpec.input_specs`` (or a manifest's)."""
        from ..jit import to_torch_dtype
        from ..static import InputSpec
        specs = self.spec.input_specs
        if specs is None and manifest is not None:
            specs = manifest.get("input_specs")
        if specs is None:
            raise PreconditionNotMetError(
                f"serving model {self.name!r} is executor-backed (a static "
                "save_inference_model dir): register it with input_specs="
                "[(shape, dtype), ...]; its feeds carry no shape to bucket "
                "on")
        out = []
        for s in specs:
            shape, dtype = (s.shape, s.dtype) if isinstance(s, InputSpec) \
                else s
            out.append((list(shape), to_torch_dtype(dtype)))
        feeds = self.primary.get_input_names()
        if len(out) != len(feeds):
            raise InvalidArgumentError(
                f"serving model {self.name!r}: {len(out)} input_specs for "
                f"{len(feeds)} feeds ({feeds})")
        return out

    def executor_events(self):
        """A static model's Executor's captures since the warm-up."""
        if self.backend != "executor":
            return []
        return [dict(e, model=self.name)
                for e in self.primary._exe.compile_events_since_warmup()]

    def steady_events(self, mark):
        """Captures after the warm-up mark, the Executor's included."""
        return self.events[mark:] + self.executor_events()

    # -- warm-up: one graph per bucket ---------------------------------------
    def _build(self, bucket):
        if self.backend == "executor":
            return _ExecutorBucket(self.predictors[bucket],
                                   [(r, np.dtype(n)) for (r, _), n in
                                    zip(self.templates, self.np_dtypes)],
                                   bucket)
        if self.device.type == "cuda":
            return _BucketGraph(self.predictors[bucket].clone(),
                                self.templates, bucket, self.stream)
        return _EagerBucket(self.predictors[bucket],
                            [(r, np.dtype(n)) for (r, _), n in
                             zip(self.templates, self.np_dtypes)], bucket)

    def _event(self, kind, bucket):
        self.events.append({"site": self.site, "kind": kind,
                            "bucket": bucket, "model": self.name,
                            "graph": self.device.type == "cuda"})

    def warmup(self):
        if str(_flags.flag("graph_lint")).lower() != "off":
            raise UnimplementedError(
                f"serving model {self.name!r}: the graph-lint admission "
                "gate is not ported (ROADMAP A13); set FLAGS_graph_lint="
                "'off'")
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
        for b in self.ladder:
            self.executables[b] = self._build(b)
            self._event("serving_capture", b)
        if self.backend == "executor":
            self.primary._exe.mark_warmup()
        self.admitted = True

    def late_compile(self, bucket):
        """A bucket without a warm-up executable reached a worker.
        Strict mode refuses; otherwise capture it now, recorded as a
        steady-state capture so the zero-capture check visibly fails."""
        if bool(_flags.flag("serving_strict")):
            raise PreconditionNotMetError(
                f"serving model {self.name!r}: bucket {bucket} has no "
                "warm-up graph (FLAGS_serving_strict=True refuses "
                "steady-state captures — extend the bucket ladder and "
                "re-warm instead)")
        with self._build_lock:
            ex = self.executables.get(bucket)
            if ex is None:
                ex = self._build(bucket)
                self._event("serving_recapture", bucket)
                self.bump(steady_compiles=1)
                self.executables[bucket] = ex
        return ex

    def slot_signals(self):
        return None

    def close(self):
        self.executables.clear()


# ---------------------------------------------------------------------------
# Worker: decode batches synchronously, dense batches pipelined
# ---------------------------------------------------------------------------

class _Worker(threading.Thread):
    """One serving thread.  A decode batch runs whole (prefill + decode
    loop) and its rows go back per request.  A dense batch is staged
    (concatenate, pad to its bucket), handed to the bucket's executable
    without waiting, and fenced only when more than the pipeline depth
    are in flight or the queue runs dry: the host staging of batch N+1
    overlaps the device's work on batch N.  Each worker holds its own
    ``Predictor.clone()`` of every dense model's predictors (the CPU's
    eager path runs through them)."""

    def __init__(self, server: "Server", idx: int, depth: int):
        super().__init__(name=f"serving-worker-{idx}", daemon=True)
        self._server = server
        self.clones = {name: {b: p.clone() for b, p in rt.predictors.items()}
                       for name, rt in server._models.items()
                       if rt.kind == "dense"}
        self._depth = max(1, int(depth))
        self._inflight: deque = deque()

    def _execute(self, batch: Batch):
        rt = self._server._models[batch.model]
        if rt.kind == "decode":
            self._execute_decode(rt, batch)
            return
        host = [np.concatenate([r.inputs[i] for r in batch.requests], axis=0)
                if len(batch.requests) > 1 else batch.requests[0].inputs[i]
                for i in range(rt.n_inputs)]
        padded = pad_to_bucket(host, batch.rows, batch.bucket)
        ex = rt.executables.get(batch.bucket)
        if ex is None:
            ex = rt.late_compile(batch.bucket)
        pending = ex.dispatch(padded, self.clones[batch.model][batch.bucket])
        self._inflight.append((batch, pending))
        while len(self._inflight) > self._depth:
            self._fence_oldest()

    def _execute_decode(self, rt, batch):
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

    def _fence_oldest(self):
        batch, pending = self._inflight.popleft()
        try:
            outs = pending.fence()
        except Exception as e:   # noqa: BLE001 — fail this batch only
            self._fail(batch, e)
            return
        self._complete(batch, outs)

    def _drain(self):
        while self._inflight:
            self._fence_oldest()

    def _complete(self, batch: Batch, outs):
        """Resolve each request with exactly its rows (copied out of the
        batch's buffers: padding never leaks, and no result pins them).
        The future carries ``bucket`` and ``batch_rows``, the batch the
        request rode (what the JAX package records on its trace span)."""
        rt = self._server._models[batch.model]
        now = time.perf_counter()
        off = 0
        for r in batch.requests:
            r.future.bucket, r.future.batch_rows = batch.bucket, batch.rows
            r.future.set_result([o[off:off + r.rows].copy() for o in outs])
            rt.latency.observe(now - r.t_enqueue)
            off += r.rows
        rt.rate.add(len(batch.requests))
        rt.bump(completed=len(batch.requests), batches=1, rows=batch.rows,
                padded_rows=batch.bucket - batch.rows)

    def _fail(self, batch: Batch, exc: Exception):
        rt = self._server._models[batch.model]
        for r in batch.requests:
            if not r.future.done():
                r.future.set_exception(exc)
        rt.bump(errors=len(batch.requests))

    def run(self):
        q = self._server._dispatch_q
        while True:
            try:
                batch = q.get(timeout=0.02)
            except queue.Empty:
                # the queue ran dry: latency beats pipelining, fence now
                self._drain()
                continue
            if batch is None:
                self._drain()
                return
            try:
                self._execute(batch)
            except Exception as e:   # noqa: BLE001 — fail the batch only
                self._fail(batch, e)
            if q.empty():
                self._drain()


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

@dataclass
class ServingConfig:
    """Server-wide knobs; None fields fall back to FLAGS_serving_*."""

    workers: Optional[int] = None
    queue_capacity: Optional[int] = None
    batch_timeout_ms: Optional[float] = None
    pipeline_depth: Optional[int] = None
    buckets: Optional[Sequence[int]] = None


class Server:
    """In-process serving engine on one device, for dense and decode
    models side by side.

    Lifecycle::

        srv = serving.Server()                    # device defaults to cuda
        srv.register("bert", prefix, buckets=(1, 2, 4, 8, 16))
        srv.register_decode("gpt2", model, batch_buckets=(1, 8),
                            seq_buckets=(128, 256), max_len=256,
                            max_new_tokens=128)
        srv.start()              # load, capture every bucket, warm decode
        out = srv.submit("bert", [ids]).result()  # ids: [rows, 128] numpy
        fut = srv.submit_decode("gpt2", [prompt]) # prompt: 1-D int array
        ids = fut.result()[0]                     # [rows, max_new] int32
        srv.stop()

    ``prefix`` is a :func:`export_for_serving` (or ``jit.save``) prefix,
    exported on the server's device.  After ``start`` no dense bucket is
    captured again: :meth:`assert_zero_steady_state_recompiles` is the
    check.
    """

    def __init__(self, config: Optional[ServingConfig] = None, *,
                 device: DeviceLike = None):
        self._config = config or ServingConfig()
        self.device = resolve_device(device)
        self._models: Dict[str, object] = {}
        self._specs: List[object] = []
        self._queue: Optional[RequestQueue] = None
        self._dispatch_q: Optional[queue.Queue] = None
        self._scheduler: Optional[threading.Thread] = None
        self._workers: List[_Worker] = []
        self._warmup_marks: Dict[str, int] = {}
        self._started = False
        self._stopped = False
        self._draining = False
        self._session_store = None      # FLAGS_session_store, at start()

    @property
    def draining(self) -> bool:
        return self._draining

    # -- registry ------------------------------------------------------------
    def _add_spec(self, spec):
        if spec.name in {s.name for s in self._specs}:
            raise InvalidArgumentError(
                f"model {spec.name!r} is already registered")
        self._specs.append(spec)
        return spec

    def register(self, spec_or_name, path: Optional[str] = None,
                 **kw) -> ModelSpec:
        """Register a dense model (a ModelSpec, or name + path + ModelSpec
        kwargs).  Must happen before start()."""
        if self._started:
            raise PreconditionNotMetError(
                "register() after start(): the warm-up contract admits "
                "no un-warmed model — build a new Server")
        if isinstance(spec_or_name, ModelSpec):
            spec = spec_or_name
        else:
            if path is None:
                raise InvalidArgumentError("register(name, path, ...)")
            kw.setdefault("buckets", self._config.buckets)
            spec = ModelSpec(name=str(spec_or_name), path=path, **kw)
        return self._add_spec(spec)

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
        return self._add_spec(spec)

    def models(self) -> List[str]:
        return [s.name for s in self._specs]

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Server":
        """Load and warm every registered model (dense: capture every
        bucket), mark the capture record, then open the doors (scheduler
        + worker threads)."""
        if self._started:
            raise PreconditionNotMetError("Server already started")
        if not self._specs:
            raise PreconditionNotMetError("no models registered")
        if bool(_flags.flag("session_store")):
            # one store per server: every slot-mode decode model parks
            # into and restores from it
            from .sessions import SessionStore
            self._session_store = SessionStore(
                spill_dir=str(_flags.flag("session_store_dir")),
                park_after_ms=int(_flags.flag("session_park_after_ms")))
        for spec in self._specs:
            rt = (_DecodeRuntime if isinstance(spec, DecodeModelSpec)
                  else _ModelRuntime)(spec, self.device)
            if rt.kind == "decode":
                rt.session_store = self._session_store
            rt.load()
            rt.warmup()
            rt.rate.reset()              # QPS clock starts with traffic
            self._models[spec.name] = rt
        # the zero-capture invariant is measured from here: a capture
        # after this mark is a steady-state one
        self._warmup_marks = {name: len(rt.events)
                              for name, rt in self._models.items()}
        n_workers = self._config.workers \
            or int(_flags.flag("serving_workers"))
        cap = self._config.queue_capacity \
            or int(_flags.flag("serving_queue_capacity"))
        depth = self._config.pipeline_depth \
            or int(_flags.flag("serving_pipeline_depth"))
        self._queue = RequestQueue(cap)
        self._dispatch_q = queue.Queue(maxsize=max(1, n_workers * depth))
        self._workers = [_Worker(self, i, depth) for i in range(n_workers)]
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
            rt.close()          # slot loops' threads, dense graphs
        self._stopped = True

    # -- graceful drain ------------------------------------------------------
    def request_drain(self) -> None:
        """Flip to drain mode: new submissions fail with UnavailableError
        (``retry_after_s`` = FLAGS_router_stale_after_s) while everything
        already admitted runs to completion.  Idempotent."""
        self._draining = True

    def _reject_if_draining(self) -> None:
        if self._draining:
            raise UnavailableError(
                "server is draining (graceful retirement in progress)",
                retry_after_s=float(_flags.flag("router_stale_after_s")))

    def pending_requests(self) -> int:
        """Requests admitted but not yet completed or failed, summed over
        models: 0 means every admitted request was answered."""
        n = 0
        for rt in self._models.values():
            with rt._mlock:
                c = rt.counters
                n += c["requests"] - c["completed"] - c["errors"]
        return n

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful drain: stop admitting (:meth:`request_drain`), park
        the live sessions (their futures fail with a retryable
        UnavailableError; the turn submitted again, here or to a server
        sharing the spill directory, resumes from the snapshot), then
        wait until the queue is empty and every admitted request has
        resolved.  Returns a report; ``drained`` False means the timeout
        (FLAGS_drain_timeout_s) expired with work pending."""
        if timeout_s is None:
            timeout_s = float(_flags.flag("drain_timeout_s"))
        t0 = time.monotonic()
        self.request_drain()
        if not self._started or self._stopped:
            return {"drained": True, "pending": 0, "queue_depth": 0,
                    "waited_s": 0.0, "parked_sessions": 0}
        parked = self.park_sessions(timeout_s=float(timeout_s))
        deadline = t0 + max(0.0, float(timeout_s))
        while True:
            pending = self.pending_requests()
            qdepth = self._queue.depth()
            done = pending <= 0 and qdepth == 0
            if done or time.monotonic() >= deadline:
                return {"drained": done, "pending": max(0, int(pending)),
                        "queue_depth": int(qdepth),
                        "waited_s": round(time.monotonic() - t0, 3),
                        "parked_sessions": parked}
            time.sleep(min(0.02, max(0.001, timeout_s / 50.0)))

    def park_sessions(self, timeout_s: float = 30.0) -> int:
        """Park every live slot-loop conversation into the session store
        (none without FLAGS_session_store); returns the sessions parked."""
        if self._session_store is None:
            return 0
        return sum(rt._loop.park_sessions(timeout=timeout_s)
                   for rt in self._models.values()
                   if getattr(rt, "_loop", None) is not None)

    @property
    def session_store(self):
        """The server's session store (None without
        FLAGS_session_store)."""
        return self._session_store

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    # -- traffic -------------------------------------------------------------
    def _runtime(self, model: str):
        rt = self._models.get(model)
        if rt is None or not rt.admitted:
            raise NotFoundError(
                f"model {model!r} is not admitted (registered: "
                f"{self.models()})")
        return rt

    def _serving(self):
        if not self._started or self._stopped:
            raise PreconditionNotMetError(
                "Server is not serving (start() it / already stopped)")
        self._reject_if_draining()

    def _put(self, rt, req, timeout):
        rt.bump(requests=1)
        try:
            self._queue.put(req, timeout=timeout)
        except UnavailableError:
            rt.bump(errors=1)
            raise
        return req.future

    def submit(self, model: str, inputs,
               timeout: Optional[float] = 5.0) -> Future:
        """Enqueue one request of ``rows`` examples (rows = leading dim)
        for a dense model; returns a Future resolving to one numpy array
        per output with exactly ``rows`` rows (padding never leaks).
        Inputs are cast to the served dtypes.  Blocks up to ``timeout``
        under backpressure, then raises UnavailableError."""
        self._serving()
        rt = self._runtime(model)
        if rt.kind == "decode":
            raise InvalidArgumentError(
                f"model {model!r} is a decode model: use "
                "submit_decode(model, prompts, max_new_tokens=...)")
        if len(inputs) != rt.n_inputs:
            raise InvalidArgumentError(
                f"model {model!r} takes {rt.n_inputs} inputs, got "
                f"{len(inputs)}")
        arrs, rows = [], None
        for i, (a, (rest, _), dt) in enumerate(zip(inputs, rt.templates,
                                                    rt.np_dtypes)):
            a = np.asarray(a, dtype=dt)      # dtype pinned: shape-stable
            if a.ndim != len(rest) + 1 or tuple(a.shape[1:]) != rest:
                raise InvalidArgumentError(
                    f"model {model!r} input {i}: got shape "
                    f"{list(a.shape)}, served shape is [rows, "
                    f"{', '.join(map(str, rest))}]")
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise InvalidArgumentError(
                    f"model {model!r}: inconsistent request rows "
                    f"({rows} vs {a.shape[0]} at input {i})")
            arrs.append(a)
        if rows == 0:
            raise InvalidArgumentError("empty request (0 rows)")
        rt.ladder.bucket_for(rows)           # raises OutOfRange early
        return self._put(rt, Request(model=model, inputs=tuple(arrs),
                                     rows=rows), timeout)

    def run(self, model: str, inputs, timeout: Optional[float] = 60.0):
        """Synchronous convenience: submit + wait."""
        return self.submit(model, inputs).result(timeout=timeout)

    def submit_decode(self, model: str, prompts,
                      max_new_tokens: Optional[int] = None,
                      timeout: Optional[float] = 5.0,
                      session_id: Optional[str] = None) -> Future:
        """Enqueue one decode request: ``prompts`` is a list of 1-D int
        token arrays (variable lengths — they left-pad to the prompt
        bucket at execution).  Resolves to ``[ids]`` where ids is an
        int32 array [len(prompts), max_new_tokens] of generated tokens.
        Blocks up to ``timeout`` under backpressure, then raises
        UnavailableError.

        ``session_id`` (FLAGS_session_store) names the conversation:
        single-prompt requests only, with ``prompts[0]`` the FULL
        transcript so far (history + new turn); the slot loop restores
        the parked KV columns and prefills only the rest."""
        self._serving()
        rt = self._runtime(model)
        if rt.kind != "decode":
            raise InvalidArgumentError(
                f"model {model!r} is not a decode model: use submit()")
        arrs, max_new = rt.validate(list(prompts), max_new_tokens)
        if session_id is not None and len(arrs) != 1:
            raise InvalidArgumentError(
                f"session_id={session_id!r} requires exactly one prompt "
                f"(one conversation = one row), got {len(arrs)}")
        rt.ladder.bucket_for(len(arrs))      # raises OutOfRange early
        return self._put(rt, DecodeRequest(
            model=model, prompts=arrs, rows=len(arrs), max_new=max_new,
            session_id=None if session_id is None else str(session_id)),
            timeout)

    def run_decode(self, model: str, prompts,
                   max_new_tokens: Optional[int] = None,
                   timeout: Optional[float] = 60.0):
        """Synchronous convenience: submit_decode + wait."""
        return self.submit_decode(model, prompts, max_new_tokens) \
            .result(timeout=timeout)

    # -- disaggregated serving ----------------------------------------------
    def _decode_runtime(self, model: str):
        self._serving()
        rt = self._runtime(model)
        if rt.kind != "decode":
            raise InvalidArgumentError(
                f"model {model!r} is not a decode model: the KV handoff "
                "splits a decode")
        return rt

    def prefill_handoff(self, model: str, prompts,
                        max_new_tokens: Optional[int] = None):
        """Run ONLY the prefill and return the KVHandoff (device planes,
        logits, validity metadata) a decode resumes from; ``.to_bytes()``
        serializes it."""
        return self._decode_runtime(model).prefill_handoff(prompts,
                                                           max_new_tokens)

    def decode_from_handoff(self, model: str, handoff):
        """Resume generation from a KVHandoff or its serialized bytes;
        returns int32 ids [rows, max_new], the tokens ``submit_decode``
        gives the same prompts."""
        rt = self._decode_runtime(model)
        if isinstance(handoff, (bytes, bytearray, memoryview)):
            from .cluster.handoff import deserialize_kv
            handoff = deserialize_kv(bytes(handoff))
        return rt.decode_from_handoff(handoff)

    # -- observability -------------------------------------------------------
    def compile_events_since_warmup(self) -> List[dict]:
        """Captures (dense buckets) and cold batches (decode) recorded
        after the warm-up mark — the steady-state window must keep this
        empty."""
        out = []
        for name, mark in self._warmup_marks.items():
            rt = self._models[name]
            out.extend(rt.steady_events(mark) if rt.kind == "dense"
                       else rt.events[mark:])
        return out

    def assert_zero_steady_state_recompiles(self) -> None:
        evs = self.compile_events_since_warmup()
        if evs:
            raise PreconditionNotMetError(
                f"steady-state recompile(s) detected ({len(evs)}): "
                + "; ".join(f"{e['site']} {e['kind']} "
                            f"{e.get('bucket', e.get('feeds'))}"
                            for e in evs[:4]))

    def stats(self, model: Optional[str] = None) -> dict:
        """Serving health snapshot: per-model qps, latency percentiles,
        padding and steady-state captures or cold batches (decode: time
        to first token too), or all models."""
        if model is None:
            return {name: self.stats(name) for name in self._models}
        rt = self._runtime(model)
        with rt._mlock:
            c = dict(rt.counters)
        lat = rt.latency.snapshot()
        rows = max(1, c["rows"])
        out = {
            "model": model, "backend": rt.backend,
            "device": str(self.device),
            "buckets": rt.ladder.buckets,
            "requests": c["requests"], "completed": c["completed"],
            "errors": c["errors"], "batches": c["batches"],
            "qps": round(rt.rate.rate(), 2),
            "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
            "max_ms": lat["max_ms"],
            "avg_batch_rows": round(c["rows"] / max(1, c["batches"]), 2),
            "padding_ratio": round(c["padded_rows"] /
                                   (rows + c["padded_rows"]), 4),
            "queue_depth": self._queue.depth() if self._queue else 0,
            "steady_compiles": c["steady_compiles"] + (
                len(rt.executor_events()) if rt.kind == "dense" else 0),
        }
        if rt.kind == "dense":
            out["captured"] = self.device.type == "cuda"
            return out
        ttft = rt.ttft.snapshot()
        loop = rt._loop.stats() if rt._loop is not None else None
        out.update(tokens=c["tokens"], ttft_p50_ms=ttft["p50_ms"],
                   ttft_p99_ms=ttft["p99_ms"],
                   **({"slot_loop": loop} if loop is not None else {}),
                   **(rt.spec_stats(loop) or {}),
                   **self._session_keys())
        return out

    def _session_keys(self) -> dict:
        if self._session_store is None:
            return {}
        return {"sessions_parked": len(self._session_store),
                "session_store_bytes": self._session_store.nbytes()}

    def signals(self) -> dict:
        """This process's load snapshot: queue depth, average batch
        occupancy and steady-state captures or cold batches summed over
        models, and, for slot-mode models (FLAGS_decode_slots), the
        token-level slot accounting: occupancy is the max over them, the
        join/retire counters and prefix-cache sizes sum."""
        out = {"queue_depth": self._queue.depth() if self._queue else 0}
        rows = batches = steady = 0
        for rt in self._models.values():
            with rt._mlock:
                c = dict(rt.counters)
            rows += c["rows"]
            batches += c["batches"]
            steady += c["steady_compiles"] + (
                len(rt.executor_events()) if rt.kind == "dense" else 0)
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
        out.update(self._session_keys())
        out["models"] = self.models()
        out["draining"] = self._draining
        return out
