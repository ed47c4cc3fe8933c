"""Multi-server sharded PS client + communicator modes.

Reference parity:
- table sharding across pservers: distribute_transpiler.py:256 splits
  params into blocks round-robin across endpoints; here sparse rows route
  by ``id % n_servers`` (the same key-block idea without the static block
  table) and each dense table lives on ``table_id % n_servers``.
- communicator modes: operators/distributed/communicator.h —
  AsyncCommunicator (:195, queued sends drained by a thread),
  HalfAsyncCommunicator (:268, batch-merge k steps before sending),
  GeoCommunicator (:340, train on a local copy, ship per-row deltas every
  k steps).

Counterpart of ``paddle_tpu/distributed/ps/sharded.py``, copied (pure
Python).  All of it is host-side: the card only ever sees the dense
step; pulls/pushes overlap it from threads.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List

import numpy as np

from .service import PsClient


class ShardedPsClient:
    """Fan-out client over N PsServers with id-hash routing; same interface
    as PsClient so trainers are shard-agnostic."""

    def __init__(self, endpoints: List[str], compress: str = "none"):
        if not endpoints:
            raise ValueError("ShardedPsClient needs at least one endpoint")
        self._clients = [PsClient(ep, compress=compress) for ep in endpoints]
        self.n = len(self._clients)
        self._dims: Dict[int, int] = {}

    @staticmethod
    def _run_sharded(fns):
        """Run one thunk per shard in parallel; re-raise the FIRST shard
        failure with its server index (a dead thread must not surface as an
        unrelated KeyError downstream)."""
        errs = []

        def wrap(s, fn):
            try:
                fn()
            except Exception as e:
                errs.append((s, e))

        threads = [threading.Thread(target=wrap, args=(s, fn))
                   for s, fn in enumerate(fns)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            s, e = errs[0]
            raise RuntimeError(f"PS shard {s} failed: {e}") from e

    # -- routing --------------------------------------------------------------
    def _route(self, ids):
        ids = np.asarray(ids)
        shard = (ids % self.n).astype(np.int64)
        return ids, shard

    def create_table(self, table_id: int, kind: str = "sparse", **config):
        if "dim" in config:
            self._dims[table_id] = int(config["dim"])
        if kind == "sparse":
            for c in self._clients:
                c.create_table(table_id, kind, **config)
        else:
            self._clients[table_id % self.n].create_table(table_id, kind,
                                                          **config)

    def pull_sparse(self, table_id: int, ids) -> np.ndarray:
        ids, shard = self._route(ids)
        flat = ids.reshape(-1)
        fshard = shard.reshape(-1)
        if flat.size == 0:
            dim = self._dims.get(table_id, 0)
            return np.zeros(ids.shape + (dim,), np.float32)
        results: Dict[int, np.ndarray] = {}
        idxs: Dict[int, np.ndarray] = {}

        def pull_one(s):
            def go():
                sel = np.nonzero(fshard == s)[0]
                idxs[s] = sel
                if sel.size:
                    results[s] = self._clients[s].pull_sparse(
                        table_id, flat[sel] // self.n)
            return go

        self._run_sharded([pull_one(s) for s in range(self.n)])
        out = None
        for s, sel in idxs.items():
            if not sel.size:
                continue
            vals = results[s]
            if out is None:
                out = np.empty((flat.size,) + vals.shape[1:], vals.dtype)
            out[sel] = vals
        return out.reshape(ids.shape + out.shape[1:])

    def push_sparse(self, table_id: int, ids, grads):
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return
        grads = np.asarray(grads)
        grads = grads.reshape(ids.size, -1) if grads.size != ids.size \
            else grads.reshape(ids.size)
        shard = (ids % self.n).astype(np.int64)

        def push_one(s):
            def go():
                sel = np.nonzero(shard == s)[0]
                if sel.size:
                    self._clients[s].push_sparse(
                        table_id, ids[sel] // self.n, grads[sel])
            return go

        self._run_sharded([push_one(s) for s in range(self.n)])

    def export_rows(self, table_id: int, ids):
        """Shard-routed pull-with-state (accelerator row-cache fill)."""
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return (np.zeros((0, self._dims.get(table_id, 0)), np.float32),
                    {})
        shard = (ids % self.n).astype(np.int64)
        rows_parts: Dict[int, tuple] = {}

        def export_one(s):
            def go():
                sel = np.nonzero(shard == s)[0]
                if sel.size:
                    rows_parts[s] = (sel, self._clients[s].export_rows(
                        table_id, ids[sel] // self.n))
            return go

        self._run_sharded([export_one(s) for s in range(self.n)])
        rows = None
        state: Dict[str, np.ndarray] = {}
        for s, (sel, (r, st)) in rows_parts.items():
            if rows is None:
                # size from the first returned part (a fresh client attached
                # to running pservers has no _dims entry)
                rows = np.empty((ids.size,) + r.shape[1:], np.float32)
            rows[sel] = r
            for k, v in st.items():
                if k not in state:
                    state[k] = np.empty((ids.size,) + v.shape[1:],
                                        np.float32)
                state[k][sel] = v
        return rows, state

    def import_rows(self, table_id: int, ids, rows, state=None):
        """Shard-routed raw writeback (cache eviction)."""
        ids = np.asarray(ids).reshape(-1)
        rows = np.asarray(rows, np.float32)
        shard = (ids % self.n).astype(np.int64)
        state = state or {}

        def import_one(s):
            def go():
                sel = np.nonzero(shard == s)[0]
                if sel.size:
                    self._clients[s].import_rows(
                        table_id, ids[sel] // self.n, rows[sel],
                        {k: np.asarray(v)[sel] for k, v in state.items()})
            return go

        self._run_sharded([import_one(s) for s in range(self.n)])

    def pull_dense(self, table_id: int) -> np.ndarray:
        return self._clients[table_id % self.n].pull_dense(table_id)

    def push_dense(self, table_id: int, grads):
        self._clients[table_id % self.n].push_dense(table_id, grads)

    def table_size(self, table_id: int) -> int:
        return sum(c.table_size(table_id) for c in self._clients)

    # -- liveness/barrier fan-out --------------------------------------------
    def start_heartbeat(self, worker_id: int, interval: float = 1.0):
        for c in self._clients:
            c.start_heartbeat(worker_id, interval)

    def stop_heartbeat(self):
        for c in self._clients:
            c.stop_heartbeat()

    def barrier(self, worker_id: int, expected: int, name: str = None,
                timeout: float = 60.0):
        # server 0 coordinates (BarrierTable lives on one pserver)
        return self._clients[0].barrier(worker_id, expected, name, timeout)

    def stop_server(self):
        for c in self._clients:
            try:
                c.stop_server()
            except Exception:
                pass

    def close(self):
        for c in self._clients:
            c.close()


class Communicator:
    """Push-side communicator (communicator.h): decouples trainer steps
    from RPC. Modes:

    sync       — push inline, blocking (SyncCommunicator)
    async      — queue, drained one push at a time (AsyncCommunicator :195)
    half_async — queue, drained with id-merge across up to
                 ``max_merge_var_num`` queued steps so hot rows send one
                 summed gradient (HalfAsyncCommunicator :268)
    geo        — not push-grads at all: every ``k_steps`` ship row DELTAS
                 of a locally-trained copy (GeoCommunicator :340), applied
                 server-side as plain additive updates
    """

    def __init__(self, client, mode="async", max_merge_var_num=4,
                 send_queue_size=16):
        if mode not in ("sync", "async", "half_async"):
            raise ValueError(
                f"Communicator mode {mode!r}: expected sync/async/"
                "half_async (geo mode is GeoCommunicator — it ships row "
                "deltas, not gradients)")
        self.client = client
        self.mode = mode
        self.max_merge = int(max_merge_var_num)
        self._q = queue.Queue(maxsize=int(send_queue_size))
        self._err = None
        self._thread = None
        if mode in ("async", "half_async"):
            self._thread = threading.Thread(target=self._drain, daemon=True)
            self._thread.start()

    def push_sparse(self, table_id, ids, grads):
        if self._err is not None:
            raise self._err
        if self.mode == "sync":
            self.client.push_sparse(table_id, ids, grads)
            return
        self._q.put((table_id, np.asarray(ids), np.asarray(grads)))

    def flush(self):
        if self._thread is not None:
            self._q.join()
        if self._err is not None:
            raise self._err

    def _drain(self):
        while True:
            batch = [self._q.get()]
            if self.mode == "half_async":
                # merge more queued pushes for the same table (batch-merge)
                while len(batch) < self.max_merge:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    batch.append(nxt)
            try:
                by_table: Dict[int, list] = {}
                for tid, ids, grads in batch:
                    n = ids.size
                    ids = ids.reshape(-1)
                    grads = (grads.reshape(n, -1) if grads.size != n
                             else grads.reshape(n))
                    by_table.setdefault(tid, []).append((ids, grads))
                for tid, items in by_table.items():
                    ids = np.concatenate([i for i, _ in items])
                    grads = np.concatenate([g for _, g in items])
                    if self.mode == "half_async":
                        # sum duplicate ids so the server applies one update
                        uniq, inv = np.unique(ids, return_inverse=True)
                        merged = np.zeros((uniq.size,) + grads.shape[1:],
                                          grads.dtype)
                        np.add.at(merged, inv, grads)
                        ids, grads = uniq, merged
                    self.client.push_sparse(tid, ids, grads)
            except Exception as e:       # surface on next push/flush
                self._err = e
            finally:
                for _ in batch:
                    self._q.task_done()


class GeoCommunicator:
    """GeoCommunicator (:340): the worker trains a LOCAL row cache; every
    ``k_steps`` the per-row delta (local - base) ships to the server and
    fresh rows are pulled back. Converges like async SGD with much less
    RPC; the reference's SparseGeoTable applies deltas additively, which
    is exactly push with a raw-delta optimizer ("sum")."""

    def __init__(self, client, table_id, dim, k_steps=4):
        self.client = client
        self.table_id = table_id
        self.k = int(k_steps)
        self.dim = dim
        self._local: Dict[int, np.ndarray] = {}
        self._base: Dict[int, np.ndarray] = {}
        self._step = 0

    def pull(self, ids):
        ids = np.asarray(ids).reshape(-1)
        missing = [i for i in ids.tolist() if i not in self._local]
        if missing:
            rows = self.client.pull_sparse(self.table_id,
                                           np.asarray(missing))
            for i, r in zip(missing, rows):
                self._local[i] = np.array(r, np.float32)
                self._base[i] = np.array(r, np.float32)
        return np.stack([self._local[i] for i in ids.tolist()])

    def apply_local(self, ids, grads, lr=0.05):
        """Local SGD on the cached rows (DeltaSGD of geo mode)."""
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads).reshape(ids.size, -1)
        for i, g in zip(ids.tolist(), grads):
            self._local[i] = self._local[i] - lr * g
        self._step += 1
        if self._step % self.k == 0:
            self._ship_deltas()

    def _ship_deltas(self):
        ids, deltas = [], []
        for i, v in self._local.items():
            d = v - self._base[i]
            if np.any(d):
                ids.append(i)
                deltas.append(-d)      # push() applies -lr*grad; raw "sum"
        if not ids:
            return
        # server table must use optimizer="sum" (raw additive) for geo
        self.client.push_sparse(self.table_id, np.asarray(ids),
                                np.stack(deltas))
        fresh = self.client.pull_sparse(self.table_id, np.asarray(ids))
        for i, r in zip(ids, fresh):
            self._local[i] = np.array(r, np.float32)
            self._base[i] = np.array(r, np.float32)
