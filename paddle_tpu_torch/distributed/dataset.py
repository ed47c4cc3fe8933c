"""Industrial file-based datasets: InMemoryDataset / QueueDataset.

Reference parity: paddle/fluid/framework/data_set.h:43 (DatasetImpl,
GlobalShuffle :205), data_feed.h:305 (InMemoryDataFeed/MultiSlotDataFeed),
data_feed.proto (MultiSlotDesc: slot name/type/is_dense/shape), and the
Python wrappers python/paddle/distributed/fleet/dataset/dataset.py
(DatasetBase/InMemoryDataset/QueueDataset) + fluid DatasetFactory.

The MultiSlot text format, per line, slot-by-slot in declared order:
``<n> v1 ... vn`` — n values for that slot (uint64 ids for sparse slots,
floats for dense ones).

Counterpart of ``paddle_tpu/distributed/dataset.py``, copied (numpy
only): the same files, slots and seed give the same feed dicts.  The
parsed records batch into feed dicts that feed the PS trainer
(``rec/wide_deep.py``) — host-side Python/numpy does the parsing (the
reference's parsing threads are C++ for Python-2-era speed; numpy
vectorized parsing holds the same role here).

Global shuffle redistributes records PEER-TO-PEER (data_set.cc
GlobalShuffle parity: trainers send record batches to each other over
RPC): every worker runs a lightweight exchange server, endpoints
rendezvous through the fleet TCP store, and the buckets travel
worker→worker directly — the store carries only O(world) metadata
(endpoints + barrier keys), never the records, so the shuffle scales
with the slowest LINK instead of funneling the whole dataset through
one store socket.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import threading
from typing import List, Optional

import numpy as np


class _ShuffleExchange:
    """Per-process record-exchange server for global_shuffle: accepts
    (tag, src, blob) deliveries from peer workers (the worker→worker RPC
    leg of data_set.cc GlobalShuffle; message framing shared with
    ps/service.py).  Tags scope deliveries to one shuffle round, so an
    early sender from the next round can never pollute this one.

    Hardening: the socket binds to THIS worker's interface (the
    PADDLE_CURRENT_ENDPOINT host) rather than 0.0.0.0, and every
    delivery must carry an HMAC-SHA256 over the blob keyed by the
    per-round secret distributed through the fleet store rendezvous —
    a blob is never unpickled before its MAC verifies, so a stranger on
    the network cannot inject records (or pickles) into the shuffle."""

    def __init__(self):
        import socket
        from .ps.service import _send_msg, _recv_msg
        self._send_msg, self._recv_msg = _send_msg, _recv_msg
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        local_only = bool(os.getenv("PADDLE_TPU_SHUFFLE_LOCAL"))
        if local_only:
            # loopback bind must advertise loopback — anything else points
            # peers at an address this socket does not listen on
            host = "127.0.0.1"
        else:
            # advertise THIS worker's real host: the launchers communicate
            # it via PADDLE_CURRENT_ENDPOINT (fleet/launch.py); POD_IP and
            # loopback are fallbacks for hand-rolled single-host setups
            cur = os.getenv("PADDLE_CURRENT_ENDPOINT", "")
            host = cur.rsplit(":", 1)[0] if ":" in cur else \
                os.getenv("POD_IP", "127.0.0.1")
        try:
            # bind the advertised interface only — not every interface
            self._sock.bind((host, 0))
        except OSError:
            # the advertised name may not resolve to a local interface
            # (NAT / container port-maps): fall back to wildcard but keep
            # advertising the routable name
            self._sock.bind(("0.0.0.0", 0))
        self._sock.listen(64)
        self.endpoint = f"{host}:{self._sock.getsockname()[1]}"
        self._cv = threading.Condition()
        self._inbox: dict = {}       # tag -> [records...]
        self._got: dict = {}         # tag -> count of deliveries
        self._want: dict = {}        # tag -> expected deliveries
        self._keys: dict = {}        # tag -> round HMAC key (bytes)
        self._dead: "collections.deque" = __import__(
            "collections").deque(maxlen=64)   # discarded round tags
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        import hmac as _hmac
        import hashlib
        try:
            msg = self._recv_msg(conn)
            if msg is None:
                return
            with self._cv:
                if msg.get("tag") in self._dead:
                    # a straggler delivering for an aborted round must not
                    # re-create the inbox discard() just cleaned
                    self._send_msg(conn, {"ok": True, "stale": True})
                    return
                key = self._keys.get(msg.get("tag"))
            if key is None:
                # expect() always precedes endpoint publication, so a
                # legitimate peer can never beat the key registration
                self._send_msg(conn, {"ok": False, "err": "unknown round"})
                return
            want = _hmac.new(key, msg.get("blob", b""),
                             hashlib.sha256).digest()
            if not _hmac.compare_digest(want, msg.get("mac", b"")):
                self._send_msg(conn, {"ok": False, "err": "bad mac"})
                return
            # only now is the blob trusted enough to unpickle
            records = pickle.loads(msg["blob"])
            with self._cv:
                if msg["tag"] in self._dead:
                    self._send_msg(conn, {"ok": True, "stale": True})
                    return
                self._inbox.setdefault(msg["tag"], []).extend(records)
                self._got[msg["tag"]] = self._got.get(msg["tag"], 0) + 1
                self._cv.notify_all()
            self._send_msg(conn, {"ok": True})
        finally:
            conn.close()

    def expect(self, tag, n_deliveries, key):
        with self._cv:
            self._want[tag] = n_deliveries
            self._keys[tag] = key

    def collect(self, tag, timeout=300.0):
        import time
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._got.get(tag, 0) < self._want.get(tag, 0):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"global_shuffle: got {self._got.get(tag, 0)}/"
                        f"{self._want.get(tag, 0)} peer deliveries for "
                        f"round {tag}")
                self._cv.wait(left)
            out = self._inbox.pop(tag, [])
            self._got.pop(tag, None)
            self._want.pop(tag, None)
            self._keys.pop(tag, None)
        return out

    def discard(self, tag):
        """Drop all state for an aborted round — peers' deliveries must
        not pin a shard's worth of records in the process-lifetime
        singleton when a round fails (elastic retries re-shuffle under a
        fresh tag).  The tag joins a dead-list so a straggler delivering
        AFTER this cleanup is rejected instead of re-creating the inbox."""
        with self._cv:
            self._dead.append(tag)
            self._inbox.pop(tag, None)
            self._got.pop(tag, None)
            self._want.pop(tag, None)
            self._keys.pop(tag, None)


_exchange_singleton: List[Optional[_ShuffleExchange]] = [None]
_round_lock = threading.Lock()
_round_counter = [0]


def _shuffle_exchange() -> _ShuffleExchange:
    if _exchange_singleton[0] is None:
        _exchange_singleton[0] = _ShuffleExchange()
    return _exchange_singleton[0]


def _next_shuffle_round() -> int:
    """Process-wide monotonic round id: two datasets shuffling in one
    process (train + eval) must never share a tag/prefix — per-instance
    counters would both start at 0 and cross-pollute inboxes.  All
    workers shuffle the same datasets in the same program order, so the
    counter agrees across the gang."""
    with _round_lock:
        _round_counter[0] += 1
        return _round_counter[0]


def _ship_bucket(endpoint, tag, src, records, key):
    import hmac as _hmac
    import hashlib
    import socket
    from .ps.service import _send_msg, _recv_msg
    host, port = endpoint.rsplit(":", 1)
    blob = pickle.dumps(records, protocol=pickle.HIGHEST_PROTOCOL)
    mac = _hmac.new(key, blob, hashlib.sha256).digest()
    with socket.create_connection((host, int(port)), timeout=60) as s:
        _send_msg(s, {"tag": tag, "src": src, "blob": blob, "mac": mac})
        out = _recv_msg(s)
    if out is None or not out.get("ok"):
        raise RuntimeError(
            f"shuffle delivery to {endpoint} failed"
            f"{': ' + out['err'] if out and 'err' in out else ''}")

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset"]


class _Slot:
    __slots__ = ("name", "dtype", "is_dense", "shape")

    def __init__(self, name, dtype="uint64", is_dense=False, shape=(1,)):
        self.name = name
        self.dtype = dtype
        self.is_dense = is_dense
        self.shape = tuple(shape)


class DatasetBase:
    """dataset.py DatasetBase parity: slot/file/batch configuration."""

    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.filelist: List[str] = []
        self.pipe_command = "cat"
        self.use_var_names: List[str] = []
        self._slots: List[_Slot] = []
        self.queue_num = None
        self.drop_last = False

    # -- 2.0 style ----------------------------------------------------------
    def init(self, batch_size=1, thread_num=1, use_var=None, pipe_command="cat",
             input_type=0, fs_name="", fs_ugi="", download_cmd="cat",
             queue_num=None, **kwargs):
        self.set_batch_size(batch_size)
        self.set_thread(thread_num)
        if use_var:
            self.set_use_var(use_var)
        self.set_pipe_command(pipe_command)
        self.queue_num = queue_num
        return self

    # -- fluid setters ------------------------------------------------------
    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = max(1, int(thread_num))

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_pipe_command(self, pipe_command):
        self.pipe_command = pipe_command

    def set_use_var(self, var_list):
        """Declare the slots from static Variables (name/dtype/shape/
        lod_level) or plain names (sparse uint64 slots)."""
        self.use_var_names = []
        self._slots = []
        for v in var_list:
            if isinstance(v, str):
                self.use_var_names.append(v)
                self._slots.append(_Slot(v))
                continue
            name = v.name
            dtype = str(getattr(v, "dtype", "int64") or "int64")
            lod = getattr(v, "lod_level", 0)
            dense = (lod == 0 and "float" in dtype)
            shape = [d for d in (getattr(v, "shape", None) or [1])
                     if d not in (None, -1)]
            self.use_var_names.append(name)
            self._slots.append(_Slot(
                name, "float" if "float" in dtype else "uint64",
                is_dense=dense, shape=shape or (1,)))
        return self

    def set_slots(self, slots):
        """Explicit slot config: [{'name','type','is_dense','shape'}, ...]
        (data_feed.proto MultiSlotDesc analogue)."""
        self._slots = [_Slot(s["name"], s.get("type", "uint64"),
                             s.get("is_dense", False),
                             s.get("shape", (1,))) for s in slots]
        self.use_var_names = [s.name for s in self._slots]
        return self

    # -- parsing ------------------------------------------------------------
    def _read_lines(self, path):
        if self.pipe_command and self.pipe_command != "cat":
            # pipe_command parity: each file streams through the user's
            # preprocessor (data_feed.h pipe reader)
            proc = subprocess.Popen(
                f"{self.pipe_command} < {path}", shell=True,
                stdout=subprocess.PIPE, text=True)
            for line in proc.stdout:
                yield line
            proc.wait()
        else:
            with open(path) as f:
                yield from f

    def _parse_file(self, path):
        """One MultiSlot text file -> list of records
        (record = tuple of np arrays, one per slot in declared order)."""
        if not self._slots:
            raise ValueError("no slots declared: call set_use_var / "
                             "set_slots before loading")
        records = []
        for line in self._read_lines(path):
            toks = line.split()
            if not toks:
                continue
            pos = 0
            rec = []
            for slot in self._slots:
                n = int(toks[pos])
                pos += 1
                vals = toks[pos:pos + n]
                pos += n
                if slot.dtype == "float":
                    rec.append(np.asarray(vals, np.float32))
                else:
                    rec.append(np.asarray(vals, np.int64))
            records.append(tuple(rec))
        return records

    def _parse_all(self, filelist):
        """Multi-threaded parse (data_set.cc CreateReaders thread pool)."""
        if len(filelist) <= 1 or self.thread_num <= 1:
            out = []
            for p in filelist:
                out.extend(self._parse_file(p))
            return out
        results = [None] * len(filelist)

        def work(i, p):
            results[i] = self._parse_file(p)

        threads = []
        for i, p in enumerate(filelist):
            t = threading.Thread(target=work, args=(i, p), daemon=True)
            t.start()
            threads.append(t)
            while len([x for x in threads if x.is_alive()]) >= self.thread_num:
                threads[0].join(0.01)
                threads = [x for x in threads if x.is_alive()]
        for t in threads:
            t.join()
        out = []
        for r in results:
            out.extend(r or [])
        return out

    # -- batching -----------------------------------------------------------
    def _batches_from(self, records):
        """Yield feed dicts {slot_name: ndarray}. Sparse slots with equal
        per-record counts stack densely; ragged ones pad and add a
        ``<name>.lens`` entry (the lengths-based LoD carrier)."""
        B = self.batch_size
        for i in range(0, len(records), B):
            chunk = records[i:i + B]
            if len(chunk) < B and self.drop_last:
                continue
            feed = {}
            for si, slot in enumerate(self._slots):
                cols = [r[si] for r in chunk]
                lens = [len(c) for c in cols]
                if slot.is_dense or len(set(lens)) == 1:
                    feed[slot.name] = np.stack(cols)
                else:
                    m = max(lens)
                    pad = np.zeros((len(chunk), m), cols[0].dtype)
                    for j, c in enumerate(cols):
                        pad[j, :len(c)] = c
                    feed[slot.name] = pad
                    feed[slot.name + ".lens"] = np.asarray(lens, np.int64)
            yield feed


class InMemoryDataset(DatasetBase):
    """data_set.h DatasetImpl<InMemoryDataFeed> parity: load, shuffle
    (locally or across the fleet), iterate."""

    def __init__(self):
        super().__init__()
        self._records: List[tuple] = []
        self._loaded = False
        self._preload_thread: Optional[threading.Thread] = None
        self._seed: Optional[int] = None     # None = unseeded; 0 is a seed

    # -- loading ------------------------------------------------------------
    def load_into_memory(self):
        self._records = self._parse_all(self.filelist)
        self._loaded = True

    def preload_into_memory(self, thread_num=None):
        if thread_num:
            self.set_thread(thread_num)
        self._preload_thread = threading.Thread(
            target=self.load_into_memory, daemon=True)
        self._preload_thread.start()

    def wait_preload_done(self):
        if self._preload_thread is not None:
            self._preload_thread.join()
            self._preload_thread = None

    def release_memory(self):
        self._records = []
        self._loaded = False

    def get_memory_data_size(self, fleet=None):
        n = len(self._records)
        if fleet is not None:
            return int(fleet.util.all_reduce(np.asarray(n), "sum"))
        return n

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)

    # -- shuffling ----------------------------------------------------------
    def set_shuffle_seed(self, seed):
        self._seed = int(seed)

    def local_shuffle(self):
        rng = np.random.RandomState(self._seed)
        rng.shuffle(self._records)

    _EXCHANGE_TIMEOUT = 300.0

    def global_shuffle(self, fleet=None, thread_num=12):
        """DatasetImpl::GlobalShuffle (data_set.cc:205): redistribute
        records across all workers by hash — PEER-TO-PEER, as the
        reference sends record batches trainer→trainer over RPC.  The
        fleet TCP store carries only endpoints and barriers (O(world)
        metadata); record bytes travel on direct worker sockets.

        The port has no ``fleet`` package yet (ROADMAP A12): ``fleet`` is
        any object with ``worker_num()``, ``worker_index()`` and a
        ``_role_maker._ensure_store()`` whose store offers ``set``/``get``/
        ``barrier``/``delete_prefix``/``_restart_generation`` (the JAX
        package's fleet, or a stand-in)."""
        self.local_shuffle()
        if fleet is None:
            return
        # accept the fleet module facade or a Fleet instance
        if not hasattr(fleet, "_role_maker") and hasattr(fleet, "_fleet"):
            fleet = fleet._fleet
        rm = fleet._role_maker
        world = fleet.worker_num()
        me = fleet.worker_index()
        if world <= 1:
            return
        store = rm._ensure_store()
        # per-worker stream: identical seeds across workers would correlate
        # the destination pattern and skew the redistribution
        base = 0 if self._seed is None else self._seed
        rng = np.random.RandomState(base + 12345 + me * 9973)
        dest = rng.randint(0, world, size=len(self._records))
        buckets = [[] for _ in range(world)]
        for r, d in zip(self._records, dest):
            buckets[d].append(r)
        # round scoping: restart generation (a store surviving an elastic
        # gang restart must never serve the dead gang's buckets) × a
        # process-wide monotonic round id (two datasets shuffling in one
        # process must not share a tag)
        rgen = store._restart_generation()
        gen = _next_shuffle_round()
        pre = f"__gshuf/{rgen}/{gen}"
        tag = f"{rgen}/{gen}"

        srv = _shuffle_exchange()
        try:
            # per-round delivery key, derived at the fleet-store
            # rendezvous: worker 0 mints it, everyone reads it through
            # the store before publishing an endpoint — so every
            # delivery a worker can receive is HMAC-checkable, and the
            # store itself still carries only O(world) metadata
            if me == 0:
                import secrets as _secrets
                store.set(f"{pre}/key", _secrets.token_hex(16).encode())
            round_key = store.get(f"{pre}/key")
            srv.expect(tag, world - 1, round_key)
            store.set(f"{pre}/ep/{me}", srv.endpoint.encode())
            store.barrier(f"{pre}/ep", world)
            eps = {d: store.get(f"{pre}/ep/{d}").decode()
                   for d in range(world) if d != me}

            # ship each outgoing bucket directly to its owner (parallel
            # senders ≙ the reference's send_request_table thread pool)
            errs = []

            def ship(d):
                try:
                    _ship_bucket(eps[d], tag, me, buckets[d], round_key)
                except Exception as e:       # surfaced after join
                    errs.append((d, e))

            senders = [threading.Thread(target=ship, args=(d,),
                                        daemon=True) for d in eps]
            for t in senders:
                t.start()
            for t in senders:
                t.join()
            if errs:
                raise RuntimeError(
                    f"global_shuffle: peer sends failed: {errs}")

            mine = list(buckets[me])
            mine.extend(srv.collect(tag, timeout=self._EXCHANGE_TIMEOUT))
        except BaseException:
            # aborted round: peers' deliveries must not leak in the
            # process-lifetime inbox
            srv.discard(tag)
            raise
        rng2 = np.random.RandomState(base + 777 + me)
        rng2.shuffle(mine)
        self._records = mine
        # everyone holds their records before anyone proceeds/cleans up
        store.barrier(f"{pre}/done", world)
        if me == 0:
            store.delete_prefix(pre + "/")

    # -- iteration ----------------------------------------------------------
    def __iter__(self):
        if not self._loaded:
            raise RuntimeError("call load_into_memory() first")
        return self._batches_from(self._records)

    def __len__(self):
        B = self.batch_size
        n = len(self._records)
        return n // B if self.drop_last else (n + B - 1) // B


class QueueDataset(DatasetBase):
    """data_set.h DatasetImpl<MultiSlotDataFeed> parity: streaming reads,
    no memory residency, no shuffle (the reference raises the same way)."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams from files; local_shuffle is only "
            "supported by InMemoryDataset (data_set.cc parity)")

    def global_shuffle(self, fleet=None, thread_num=12):
        raise NotImplementedError(
            "QueueDataset streams from files without memory residency, so "
            "there is nothing host-side to redistribute; the reference's "
            "queue-feed global shuffle happens on the PS side of its "
            "pipeline, a stage this design deliberately keeps out of the "
            "data path (records go file→feed→device). Pre-shard the FILE "
            "LIST across workers (set_filelist with per-worker splits) "
            "for the same statistical effect, or use InMemoryDataset for "
            "true record-level global shuffle (data_set.cc parity)")

    def __iter__(self):
        def gen():
            buf = []
            for path in self.filelist:
                buf.extend(self._parse_file(path))
                while len(buf) >= self.batch_size:
                    yield next(iter(self._batches_from(
                        buf[:self.batch_size])))
                    buf = buf[self.batch_size:]
            if buf and not self.drop_last:
                yield next(iter(self._batches_from(buf)))
        return gen()
