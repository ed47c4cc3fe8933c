"""Scope and Executor: running static programs.

Counterpart of ``paddle_tpu/static/executor.py``.  A ``Scope`` maps
names to tensors.  ``Executor.run`` replays a program's ops over its
feeds and the scope's persistables; startup programs (``@init`` ops)
run once, eagerly.  The JAX Executor compiles the whole block with XLA;
here, on the card, the first run of a key (program uid and version,
scope, feed names, shapes and dtypes) replays the ops eagerly, and the
second captures the replay as one ``torch.cuda.CUDAGraph`` over static
feed buffers and the scope's own persistable tensors, which every later
run replays: the feeds are copied into the buffers, the graph replays,
the fetches are copied out.  A capture is a compile event
(``compile_events``); a steady state makes none.  The fetch set of a
key grows to the union of the fetch lists seen, as in JAX, so
alternating fetch lists share one capture after the first new name.

The parameter and optimizer updates write into the scope's tensors in
place, so the graph's storage and the scope's are one.  Replays run
cuDNN's deterministic algorithms, so a run repeats bit for bit and a
captured run equals an eager one.  A tensor that replaces one in the
scope (``Scope.set_var``) is copied into the bound storage before the
next replay.  On the CPU (``Executor("cpu")``) and
with ``use_program_cache=False`` every run replays eagerly.  A program
holding a random op (dropout) is refused a capture; there is no silent
eager path.

``set_cache_extra_key`` adds a token to every key (the Predictor passes
its model's quantization signature, ``quant:<sig>``), so programs that
differ only in it never share a capture.  Runs are thread-safe: one
lock guards the cache, and each entry's lock is held from the copy of
the feeds into its buffers to the copy of its fetches out, so two
Predictor clones serving one program take turns on its graph.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework.enforce import (InvalidArgumentError,
                                 PreconditionNotMetError, UnimplementedError)
from ..framework.place import place_device
from .backward import grads_of
from .program import Program, Variable, default_main_program


class Scope:
    """Name → tensor, with a parent chain."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, torch.Tensor] = {}
        self._parent = parent
        self._kids: List["Scope"] = []

    def new_scope(self):
        s = Scope(self)
        self._kids.append(s)
        return s

    def drop_kids(self):
        self._kids.clear()

    def find_var(self, name):
        if name in self._vars:
            return self._vars[name]
        if self._parent is not None:
            return self._parent.find_var(name)
        return None

    def set_var(self, name, value):
        self._vars[name] = value

    def var_names(self):
        return list(self._vars)

    def __contains__(self, name):
        return self.find_var(name) is not None


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    prev = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = prev


def _as_tensor(value, dtype, device):
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    return t.to(device=device, dtype=dtype)


def _collect_persistables(program, scope, names, device):
    """The scope's tensors of ``names`` on ``device``; a value that is not
    a tensor of the var's dtype on the device is converted once and put
    back into the scope, so the updates land in the scope's storage."""
    block = program.global_block()
    vals = []
    for n in names:
        v = scope.find_var(n)
        if v is None:
            raise PreconditionNotMetError(
                f"persistable {n!r} not initialized: run the startup "
                "program first (exe.run(paddle.static."
                "default_startup_program()))")
        dtype = block.var(n).dtype
        if not (isinstance(v, torch.Tensor) and v.device == device
                and v.dtype == dtype):
            v = _as_tensor(v, dtype, device)
            scope.set_var(n, v)
        vals.append(v)
    return vals


# cuDNN's deterministic switch is process-wide: every eager replay and
# capture sets it and restores it under this lock, so two threads never
# restore each other's setting mid-run.  A graph replay reads no switch
# (its kernels were chosen at capture); the Server captures at warm-up,
# before its workers start.  An eager cuDNN call in another thread while
# a replay here holds the switch on runs deterministically too.
_CUDNN_LOCK = threading.Lock()


def _backward_at(ops):
    """Index of a backward op whose forward segment is every op before
    it (the replay then differentiates what it just ran), else None."""
    for i, op in enumerate(ops):
        if op.prim == "@backward" and op.attrs["n_fwd_ops"] == i:
            return i
    return None


def _run_ops(ops, env, device):
    for op in ops:
        try:
            ins = [env[n] for n in op.input_names]
        except KeyError as e:
            raise PreconditionNotMetError(
                f"variable {e.args[0]!r} has no value (not fed, not "
                f"initialized in scope), needed by {op.type}") from None
        env.update(zip(op.output_names, op.run(ins, device)))


def replay(ops, env, device):
    """Run ``ops`` in order over ``env`` (name → tensor)."""
    start = _backward_at(ops)
    with torch.no_grad():
        if start is None:
            _run_ops(ops, env, device)
            return
        bw = ops[start]
        names = bw.attrs["param_names"]
        held = [env[n] for n in names]
        leaves = [t.detach().requires_grad_(True) for t in held]
        env.update(zip(names, leaves))
        with torch.enable_grad():
            _run_ops(ops[:start], env, device)
            grads = grads_of(env[bw.attrs["loss_name"]], leaves)
        env.update(zip(names, held))
        env.update(zip(bw.output_names, grads))
        _run_ops(ops[start + 1:], env, device)


class _Entry:
    """One key of the Executor's cache: the fetch union and, once
    captured, the graph with its static feed buffers, the bound
    persistables and its fetch outputs."""

    def __init__(self, program, feed_names, union, device, capture):
        self.program = program
        self.feed_names = feed_names
        self.union = union
        self.device = device
        self.capture = capture
        block = program.global_block()
        self.persist_names = [n for n, v in block.vars.items()
                              if v.persistable]
        produced = {n for op in block.ops for n in op.output_names}
        self.written = [n for n in self.persist_names if n in produced]
        self.runs = 0
        self.graph = None
        self.feeds = self.persist = self.outs = None
        # held from the feeds' copy in to the fetches' copy out
        self.lock = threading.Lock()

    def replay(self, feed_vals, persist):
        env = dict(zip(self.feed_names, feed_vals))
        held = dict(zip(self.persist_names, persist))
        env.update(held)
        # cuDNN's deterministic algorithms: with its default choice two
        # eager runs of LeNet's conv weight gradients differ in the last
        # bits on the card, and a replay could not equal the eager run
        cudnn = torch.backends.cudnn
        with _CUDNN_LOCK:
            prev, cudnn.deterministic = cudnn.deterministic, True
            try:
                replay(self.program.global_block().ops, env, self.device)
            finally:
                cudnn.deterministic = prev
        for n in self.written:
            if env[n] is not held[n]:
                held[n].copy_(env[n])
        return [env[n].detach() for n in self.union]

    def bind(self, scope):
        """Point the scope at the graph's persistables, copying in any
        tensor that replaced one since the capture."""
        for n, bound in zip(self.persist_names, self.persist):
            cur = scope.find_var(n)
            if cur is bound:
                continue
            if cur is None or tuple(np.shape(cur)) != tuple(bound.shape):
                raise InvalidArgumentError(
                    f"persistable {n!r} of a captured program is missing "
                    f"or changed shape (captured {tuple(bound.shape)})")
            bound.copy_(_as_tensor(cur, bound.dtype, bound.device))
            scope.set_var(n, bound)


class Executor:
    """executor.py parity.  ``place``: None (the card; raises without
    one), a ``CPUPlace``/``CUDAPlace``, ``"cpu"``, ``"gpu"``..."""

    def __init__(self, place=None):
        self.device = place_device(place)
        self._cache: Dict[tuple, _Entry] = {}
        self.compile_events: List[dict] = []
        self._warmup_mark = 0
        self._train_stats = {"chunks": 0, "max_chunk_bytes": 0}
        self._cache_extra_key: Optional[str] = None
        self._lock = threading.Lock()           # guards _cache

    def set_cache_extra_key(self, key):
        """Fold ``key`` into every cache key (None: the plain key).  The
        Predictor passes a model's quantization signature here, so an int8
        program and a float one never share a capture."""
        self._cache_extra_key = None if key is None else str(key)

    # -- compile events ------------------------------------------------------
    def mark_warmup(self):
        """Start the steady-state window of
        :meth:`compile_events_since_warmup`."""
        self._warmup_mark = len(self.compile_events)

    def compile_events_since_warmup(self) -> List[dict]:
        return self.compile_events[self._warmup_mark:]

    def captured_graphs(self, program) -> list:
        """The CUDA graphs captured for ``program``."""
        return [e.graph for e in self._cache.values()
                if e.program is program and e.graph is not None]

    # -- startup programs ----------------------------------------------------
    def _run_eager(self, program: Program, scope: Scope):
        block = program.global_block()
        env = {n: v for n, v in ((n, scope.find_var(n)) for n in block.vars)
               if v is not None}
        replay(block.ops, env, self.device)
        for n, var in block.vars.items():
            if var.persistable and n in env:
                scope.set_var(n, env[n])

    # -- runs ----------------------------------------------------------------
    def _feeds(self, program, feed):
        block = program.global_block()
        names = sorted(feed)
        vals = []
        for n in names:
            v = feed[n]
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.asarray(v))
            if block.has_var(n) and t.dtype != block.var(n).dtype:
                t = t.to(block.var(n).dtype)
            vals.append(t)
        return names, vals

    def _entry(self, program, scope, feed_names, feed_vals, fetch_names,
               use_program_cache):
        key = (program._uid, program._version, id(scope),
               tuple((n, tuple(v.shape), v.dtype)
                     for n, v in zip(feed_names, feed_vals)),
               self._cache_extra_key)
        entry = self._cache.get(key) if use_program_cache else None
        if entry is None or not set(fetch_names) <= set(entry.union):
            union = list(entry.union) if entry else []
            union += [n for n in fetch_names if n not in union]
            capture = use_program_cache and self.device.type == "cuda"
            if capture:
                rand = [op.type for op in program.global_block().ops
                        if op.random]
                if rand:
                    raise UnimplementedError(
                        f"a program holding random ops {rand} cannot be "
                        "captured: random ops in captured programs are not "
                        "ported (ROADMAP A13); run it with "
                        "use_program_cache=False")
            entry = _Entry(program, feed_names, union, self.device, capture)
            if use_program_cache:
                self._cache[key] = entry
        return entry

    def _capture(self, entry, scope, feed_vals):
        entry.persist = _collect_persistables(
            entry.program, scope, entry.persist_names, self.device)
        entry.feeds = [v.to(self.device).clone() for v in feed_vals]
        torch.cuda.synchronize(self.device)
        # kept beside its executable, so that its kernel nodes can be
        # read back (profiler/cuda_graph.py)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            entry.outs = entry.replay(entry.feeds, entry.persist)
        graph.instantiate()
        entry.graph = graph
        self.compile_events.append({
            "site": f"executor:{entry.program._uid}", "kind": "capture",
            "feeds": [(n, tuple(v.shape)) for n, v in
                      zip(entry.feed_names, feed_vals)],
            "fetches": list(entry.union)})

    def _step(self, entry, scope, feed_vals):
        """One run of ``entry``: eager, or the capture's replay."""
        if entry.graph is None and entry.capture and entry.runs:
            self._capture(entry, scope, feed_vals)
        entry.runs += 1
        if entry.graph is None:
            persist = _collect_persistables(entry.program, scope,
                                            entry.persist_names, self.device)
            return entry.replay([v.to(self.device) for v in feed_vals],
                                persist)
        entry.bind(scope)
        for buf, v in zip(entry.feeds, feed_vals):
            buf.copy_(v)
        entry.graph.replay()
        return entry.outs

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        program = program or default_main_program()
        scope = scope or global_scope()
        if any(op.prim == "@init" for op in program.global_block().ops):
            self._run_eager(program, scope)
            return []
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        feed_names, feed_vals = self._feeds(program, feed or {})
        with self._lock:
            entry = self._entry(program, scope, feed_names, feed_vals,
                                fetch_names, use_program_cache)
        with entry.lock:
            for hook in program._pre_run_hooks:
                hook(scope)
            outs = self._step(entry, scope, feed_vals)
            picked = [outs[entry.union.index(n)] for n in fetch_names]
            if return_numpy:
                return [t.cpu().numpy() for t in picked]
            # copies enqueued before the lock is let go: on one stream, the
            # next replay of this entry writes its outputs after them
            return [t.clone() for t in picked]

    # -- dataset-driven training --------------------------------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100, epochs=1,
                           chunk_steps=256):
        """Run one step per dataset element, ``epochs`` times.

        ``dataset``: an iterable of feed dicts {var_name: array}, or a
        dict of stacked arrays {var_name: [steps, ...]} (tensors already
        on the card stay there).  Each chunk of ``chunk_steps`` steps is
        uploaded once; each step copies its slice into the captured
        graph's feed buffers on the device and replays, and writes its
        fetches into a device buffer read once per chunk.  A tail chunk
        runs only its own steps.  Returns {fetch_name: [epochs * steps,
        ...] numpy}."""
        program = program or default_main_program()
        scope = scope or global_scope()
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        chunk_steps = max(1, int(chunk_steps))
        chunks = _host_chunks(dataset, chunk_steps)
        first = next(chunks, None)
        if first is None:
            raise ValueError("train_from_dataset: empty dataset")
        chunks = list(itertools.chain([first], chunks))
        feed_names = sorted(first)
        block = program.global_block()
        for hook in program._pre_run_hooks:
            hook(scope)
        self._train_stats = {"chunks": 0, "max_chunk_bytes": 0}
        got: Dict[str, list] = {n: [] for n in fetch_names}
        entry = None
        for ep in range(epochs):
            for chunk in chunks:
                dev = [_as_tensor(chunk[n], block.var(n).dtype
                                  if block.has_var(n) else None, self.device)
                       for n in feed_names]
                self._train_stats["max_chunk_bytes"] = max(
                    self._train_stats["max_chunk_bytes"],
                    sum(t.numel() * t.element_size() for t in dev))
                bufs = None
                for i in range(len(dev[0])):
                    vals = [t[i] for t in dev]
                    if entry is None:
                        with self._lock:
                            entry = self._entry(program, scope, feed_names,
                                                vals, fetch_names, True)
                        pos = [entry.union.index(n) for n in fetch_names]
                    with entry.lock:
                        outs = self._step(entry, scope, vals)
                        if bufs is None:
                            bufs = [torch.empty((len(dev[0]),) + tuple(
                                outs[p].shape), dtype=outs[p].dtype,
                                device=self.device) for p in pos]
                        for b, p in zip(bufs, pos):
                            b[i].copy_(outs[p])
                self._train_stats["chunks"] += 1
                for n, b in zip(fetch_names, bufs or []):
                    got[n].append(b.cpu().numpy())
            if debug and fetch_names:
                print(f"[train_from_dataset] epoch {ep}: {fetch_names[0]} "
                      f"mean={np.mean(got[fetch_names[0]][-1]):.6f}")
        return {n: np.concatenate(v) if v else np.array([])
                for n, v in got.items()}

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """train_from_dataset over a program without optimizer ops."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period, epochs=1)

    def close(self):
        self._cache.clear()


def _host_chunks(dataset, chunk_steps):
    """Chunks {name: stacked [<= chunk_steps, ...]} of ``dataset``."""
    if isinstance(dataset, dict):
        if not dataset:
            return iter(())
        host = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in dataset.items()}
        n = len(next(iter(host.values())))
        return ({k: v[s:s + chunk_steps] for k, v in host.items()}
                for s in range(0, n, chunk_steps))

    def stacked():
        buf: Dict[str, list] = {}
        count = 0
        for feed in dataset:
            for k, v in feed.items():
                buf.setdefault(k, []).append(np.asarray(
                    v.cpu() if isinstance(v, torch.Tensor) else v))
            count += 1
            if count == chunk_steps:
                yield {k: np.stack(vs) for k, vs in buf.items()}
                buf, count = {}, 0
        if count:
            yield {k: np.stack(vs) for k, vs in buf.items()}
    return stacked()
