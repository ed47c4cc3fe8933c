"""Parameter-server RPC service: pull/push over TCP.

Reference parity: the brpc/grpc PS service —
paddle/fluid/distributed/service/server.h:50 (PSServer hosting tables),
operators/distributed/ RPCServer/RPCClient + parameter_send/parameter_recv
(sparse-table pull/push messages), listen_and_serv_op.cc's serving loop.

Counterpart of ``paddle_tpu/distributed/ps/service.py``, copied (pure
Python over numpy; the same wire format).  The card never blocks on this
path — workers batch pull/push of HOST-side sparse tables around the dense
device step, so the RPC is a host-to-host side channel, exactly the
HeterPS split.  Wire format is
length-prefixed pickles over a socket; one thread per connection.  This is
deliberately minimal but REAL: multiple worker processes can share one table
server (tests/test_torch_ps_service.py serves one over a socket).
"""
from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Dict, Optional

import numpy as np

from .table import SparseTable, DenseTable
from .codec import encode_rows, decode_rows

_LEN = struct.Struct("!Q")


def _send_msg(sock: socket.socket, obj):
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket):
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    body = _recv_exact(sock, n)
    return None if body is None else pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class PsServer:
    """Hosts tables; serves pull/push/barrier (server.h:50 + listen_and_serv).

    Thread-per-connection; table mutations are serialized by a lock (the
    reference's per-shard mutexes collapse to one — host python, not the
    hot path)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 heartbeat_timeout: float = 10.0):
        self._tables: Dict[int, object] = {}
        self._lock = threading.RLock()  # _handle -> create_table re-enters
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.endpoint = "%s:%d" % self._sock.getsockname()[:2]
        self._running = False
        self._threads = []
        self._barrier_count = 0
        self._barrier_waiters = []
        # worker liveness (heart_beat_monitor.h:51): workers that stop
        # beating past the timeout are evicted — barriers no longer wait
        # for them, so one dead trainer cannot hang the job
        self._hb_timeout = heartbeat_timeout
        self._hb_last: Dict[int, float] = {}
        self._hb_dead: set = set()
        self._barrier_cv = threading.Condition()
        self._barrier_arrived: Dict[str, set] = {}

    def create_table(self, table_id: int, kind: str = "sparse", **kw):
        with self._lock:
            if table_id not in self._tables:
                self._tables[table_id] = (SparseTable(**kw) if kind == "sparse"
                                          else DenseTable(**kw))
        return self._tables[table_id]

    # -- serving loop ---------------------------------------------------------
    def start(self):
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        try:
            while True:
                msg = _recv_msg(conn)
                if msg is None:
                    break
                reply = self._handle(msg)
                _send_msg(conn, reply)
        finally:
            conn.close()

    # -- worker liveness ------------------------------------------------------
    def _alive_workers(self, expected):
        import time
        now = time.monotonic()
        alive = set()
        for w in range(expected):
            if w in self._hb_dead:
                continue
            last = self._hb_last.get(w)
            if last is None or now - last <= self._hb_timeout:
                alive.add(w)
            else:
                self._hb_dead.add(w)       # evict (HeartBeatMonitor::Run)
        return alive

    def _barrier(self, name, worker_id, expected, timeout):
        """Block until every LIVE worker arrives (barrier_table semantics
        with heart_beat_monitor eviction). State is refcounted: when the
        last waiter leaves a completed barrier its entry is dropped, so a
        restarted worker reusing the same name sequence gets a FRESH
        barrier instead of sailing through on stale arrivals."""
        import time
        deadline = time.monotonic() + timeout
        with self._barrier_cv:
            st = self._barrier_arrived.setdefault(
                name, {"arrived": set(), "inside": 0})
            st["arrived"].add(worker_id)
            st["inside"] += 1
            self._barrier_cv.notify_all()
            try:
                while True:
                    alive = self._alive_workers(expected)
                    if alive - st["arrived"] == set():
                        self._barrier_cv.notify_all()
                        return {"ok": True, "alive": sorted(alive)}
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return {"ok": False, "error": "barrier timeout",
                                "waiting_for": sorted(alive - st["arrived"])}
                    self._barrier_cv.wait(min(left, 0.25))
            finally:
                st["inside"] -= 1
                if st["inside"] == 0:
                    self._barrier_arrived.pop(name, None)

    def _handle(self, msg):
        op = msg["op"]
        if op == "heartbeat":
            import time
            wid = int(msg["worker_id"])
            self._hb_last[wid] = time.monotonic()
            # a worker that resumes beating (long GC / compile pause)
            # rejoins — eviction is not a death sentence
            self._hb_dead.discard(wid)
            return {"ok": True}
        if op == "barrier":
            return self._barrier(msg.get("name", ""), int(msg["worker_id"]),
                                 int(msg["expected"]),
                                 float(msg.get("timeout", 60.0)))
        with self._lock:
            if op == "create_table":
                self.create_table(msg["table_id"], msg.get("kind", "sparse"),
                                  **msg.get("config", {}))
                return {"ok": True}
            table = self._tables.get(msg.get("table_id"))
            if op == "pull_sparse":
                # codec'd reply when the client asks (DCN row compression)
                vals = table.pull(msg["ids"])
                return {"ok": True,
                        "values": encode_rows(vals, msg.get("codec", "none"))}
            if op == "push_sparse":
                table.push(msg["ids"], decode_rows(msg["grads"]))
                return {"ok": True}
            if op == "export_rows":
                # ALWAYS full precision: exported rows+state become the
                # cache's master copy (lossy codecs are for gradient pushes
                # and read-only pulls; quantizing an adagrad accumulator to
                # 0 would blow the device cache's update to lr*g*1e8)
                rows, state = table.export_rows(msg["ids"])
                return {"ok": True, "rows": rows, "state": state}
            if op == "import_rows":
                table.import_rows(
                    msg["ids"], decode_rows(msg["rows"]),
                    {k: decode_rows(v)
                     for k, v in (msg.get("state") or {}).items()})
                return {"ok": True}
            if op == "pull_dense":
                return {"ok": True, "values": table.pull()}
            if op == "push_dense":
                table.push(msg["grads"])
                return {"ok": True}
            if op == "table_size":
                return {"ok": True, "size": len(table)}
            if op == "stop":
                # release the bound port immediately (the accept loop wakes
                # on the OSError) so a later init_server on this fixed
                # endpoint doesn't hit EADDRINUSE; the live conn still gets
                # the reply below
                self._running = False
                try:
                    self._sock.close()
                except OSError:
                    pass
                return {"ok": True}
        raise ValueError(f"unknown PS op {op}")

    def stop(self):
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass


class PsClient:
    """Worker-side stub (RPCClient + Communicator's synchronous send path —
    the async aggregation threads of communicator.h:195 are unnecessary
    here because pushes batch per train step already)."""

    def __init__(self, endpoint: str, compress: str = "none"):
        from .codec import MODES
        if compress not in MODES:
            raise ValueError(f"compress must be one of {MODES}")
        self._endpoint = endpoint
        self._codec = compress
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=60)
        self._lock = threading.Lock()
        self._hb_thread = None
        self._hb_stop = threading.Event()
        self._barrier_seq = 0

    def _call(self, **msg):
        with self._lock:
            _send_msg(self._sock, msg)
            out = _recv_msg(self._sock)
        if out is None or not out.get("ok"):
            raise RuntimeError(f"PS call failed: {msg.get('op')}: "
                               f"{(out or {}).get('error', 'conn closed')}")
        return out

    def _call_fresh(self, timeout=90.0, **msg):
        """Blocking ops (barrier) and side-channel ops (heartbeat) use their
        own connection so the pull/push socket never stalls behind them."""
        host, port = self._endpoint.rsplit(":", 1)
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as s:
            _send_msg(s, msg)
            out = _recv_msg(s)
        if out is None or not out.get("ok"):
            raise RuntimeError(f"PS call failed: {msg.get('op')}: "
                               f"{(out or {}).get('error', 'conn closed')}")
        return out

    # -- liveness (heart_beat_monitor.h worker side) -------------------------
    def start_heartbeat(self, worker_id: int, interval: float = 1.0):
        if self._hb_thread is not None:
            return
        self._hb_stop = threading.Event()   # restartable after stop_heartbeat

        def beat():
            while not self._hb_stop.wait(interval):
                try:
                    self._call_fresh(op="heartbeat", worker_id=worker_id,
                                     timeout=10.0)
                except Exception:
                    return          # server gone: trainer notices on RPC
        self._call_fresh(op="heartbeat", worker_id=worker_id, timeout=10.0)
        self._hb_thread = threading.Thread(target=beat, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self):
        self._hb_stop.set()
        self._hb_thread = None

    def barrier(self, worker_id: int, expected: int, name: str = None,
                timeout: float = 60.0):
        """Job-wide barrier that only waits for LIVE workers; returns the
        list of workers it synchronized with."""
        self._barrier_seq += 1
        name = name or f"b{self._barrier_seq}"
        out = self._call_fresh(op="barrier", worker_id=worker_id,
                               expected=expected, name=name,
                               timeout=timeout + 5.0)
        return out["alive"]

    def create_table(self, table_id: int, kind: str = "sparse", **config):
        self._call(op="create_table", table_id=table_id, kind=kind,
                   config=config)

    def pull_sparse(self, table_id: int, ids) -> np.ndarray:
        return decode_rows(self._call(op="pull_sparse", table_id=table_id,
                                      ids=np.asarray(ids),
                                      codec=self._codec)["values"])

    def push_sparse(self, table_id: int, ids, grads):
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        self._call(op="push_sparse", table_id=table_id, ids=ids,
                   grads=encode_rows(np.asarray(grads, np.float32)
                                     .reshape(ids.size, -1), self._codec))

    def export_rows(self, table_id: int, ids):
        """(rows, state) pull-with-state for accelerator row caches.
        Always full precision — see the server-side rationale."""
        out = self._call(op="export_rows", table_id=table_id,
                         ids=np.asarray(ids))
        return np.asarray(out["rows"]), {k: np.asarray(v)
                                         for k, v in out["state"].items()}

    def import_rows(self, table_id: int, ids, rows, state=None):
        """Raw writeback of optimized rows (+ state) — cache eviction.
        Always full precision: these are the master values, not deltas."""
        self._call(op="import_rows", table_id=table_id, ids=np.asarray(ids),
                   rows=np.asarray(rows, np.float32),
                   state={k: np.asarray(v, np.float32)
                          for k, v in (state or {}).items()})

    def pull_dense(self, table_id: int) -> np.ndarray:
        return self._call(op="pull_dense", table_id=table_id)["values"]

    def push_dense(self, table_id: int, grads):
        self._call(op="push_dense", table_id=table_id,
                   grads=np.asarray(grads))

    def table_size(self, table_id: int) -> int:
        return self._call(op="table_size", table_id=table_id)["size"]

    def stop_server(self):
        try:
            self._call(op="stop")
        except Exception:
            pass

    def close(self):
        self._sock.close()


class LocalPsEndpoint:
    """In-process 'client' over a table dict — single-trainer fast path (no
    sockets), same interface as PsClient.  ≙ running trainer+pserver in one
    process for tests (test_dist_base local mode)."""

    def __init__(self):
        import threading
        self._tables: Dict[int, object] = {}
        # async-communicator mode pushes from a drain thread while the
        # trainer pulls: serialize table access so a pull can never see a
        # torn (half-applied) row update
        self._lock = threading.RLock()

    def create_table(self, table_id: int, kind: str = "sparse", **config):
        with self._lock:
            if table_id not in self._tables:
                self._tables[table_id] = (SparseTable(**config)
                                          if kind == "sparse"
                                          else DenseTable(**config))

    def pull_sparse(self, table_id, ids):
        with self._lock:
            return self._tables[table_id].pull(np.asarray(ids))

    def push_sparse(self, table_id, ids, grads):
        with self._lock:
            self._tables[table_id].push(np.asarray(ids), np.asarray(grads))

    def export_rows(self, table_id, ids):
        with self._lock:
            return self._tables[table_id].export_rows(np.asarray(ids))

    def import_rows(self, table_id, ids, rows, state=None):
        with self._lock:
            self._tables[table_id].import_rows(np.asarray(ids), rows, state)

    def pull_dense(self, table_id):
        return self._tables[table_id].pull()

    def push_dense(self, table_id, grads):
        self._tables[table_id].push(np.asarray(grads))

    def table_size(self, table_id):
        return len(self._tables[table_id])

    def close(self):
        pass
