"""Device-resident hot-row cache over a host PS table.

Counterpart of ``paddle_tpu/distributed/ps/device_cache.py``.  Reference
parity: the HeterPS / PSGPU pipeline —
paddle/fluid/framework/fleet/ps_gpu_wrapper.h (BuildGPUPS keeps the pass's
hot sparse rows in GPU HBM), framework/trainer.h:281 PSGPUTrainer, and
framework/device_worker.h HeterBoxWorker: dense + hot sparse on the
accelerator, the full table on host/pserver, writeback at pass end.

A steady-state software cache: rows AND their optimizer state live in
device arenas ([capacity+1, dim] torch tensors; the last slot is a
scratch row that absorbs padding writes).  Per step the host resolves
batch ids to slots (LRU, numpy-vectorized), ships ONLY the miss block,
and the train step scatters misses in, gathers, computes, and applies
the sparse optimizer rule on the device, in place.  Steady state with a
hot working set moves zero row bytes over the wire; evictions gather the
displaced rows once and write them back to the host table raw
(import_rows), exactly PSGPU's EndPass writeback.

Slot bookkeeping is factored into :class:`SlotDirectory` so several tables
over the SAME id space (Wide&Deep's wide + deep tables) resolve ids→slots
once and share one LRU — each table then only moves its own rows.

The device rules mirror SparseTable._apply_rule (table.py) — sgd /
adagrad / ftrl share state layout with the host table, so rows migrate
between cache and table mid-training without losing accumulator state.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ...framework.place import DeviceLike, resolve_device
from .table import _STATE_SPEC

# rules the cache can run on the device; state names match _STATE_SPEC
DEVICE_RULES = ("sgd", "adagrad", "ftrl")


def _pad_to_bucket(n: int, bucket: int = 1024) -> int:
    """Round up to a bucket multiple: few distinct miss-block shapes
    across steps with ≤bucket wasted rows (vs power-of-two padding's
    up-to-2× inflation)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def pad_adaptive(n: int) -> int:
    """Eighth-octave padding for shapes that feed the fused step:
    grain = 2^(⌈log2 n⌉-3) ≤ n/4, so at most 8 distinct shapes per
    doubling of n and ≤25% padding waste — the compromise between
    power-of-two (1 shape/octave, up to 2× waste) and fine buckets (tiny
    waste, a new shape whenever n drifts)."""
    if n <= 8:
        return 8
    grain = 1 << max(3, n.bit_length() - 3)
    return ((n + grain - 1) // grain) * grain


def _sqrt(x):
    """IEEE f32 square root on every device: the root in f64 rounds to the
    correctly rounded f32 root (53 ≥ 2·24 + 2 bits), while torch's
    vectorized CPU ``sqrt`` may land one ulp off.  numpy's ``sqrt`` (the
    host table's) and CUDA's ``sqrtf`` are correctly rounded too."""
    return torch.sqrt(x.double()).float()


def apply_rule_device(opt: str, rows, state, grads, *, lr, eps=1e-8,
                      l1=0.0, l2=0.0, lr_power=-0.5):
    """Vectorized device sparse-optimizer update: ([U,D] rows, state dict,
    [U,D] grads) → (new_rows, new_state), new tensors.  The operations and
    their order are SparseTable._apply_rule's (FTRL's square-root branch
    included), so a row trained here equals one the host table trains."""
    g = grads.float()
    p = rows.float()
    if opt == "sgd":
        return p - lr * g, state
    if opt == "adagrad":
        acc = state["acc"] + g * g
        return p - lr * g / (_sqrt(acc) + eps), {"acc": acc}
    if opt == "ftrl":
        sq = state["sq"]
        new_acc = sq + g * g
        if lr_power == -0.5:
            sigma = (_sqrt(new_acc) - _sqrt(sq)) / lr
            y = 2.0 * l2 + _sqrt(new_acc) / lr
        else:
            sigma = (new_acc ** -lr_power - sq ** -lr_power) / lr
            y = 2.0 * l2 + new_acc ** -lr_power / lr
        lin = state["lin"] + g - sigma * p
        x = torch.sign(lin) * l1 - lin
        new_p = torch.where(lin.abs() > l1, x / y, torch.zeros_like(x))
        return new_p, {"sq": new_acc, "lin": lin}
    raise ValueError(f"device cache cannot run rule {opt!r}; "
                     f"supported: {DEVICE_RULES}")


class Resolution(NamedTuple):
    """One step's id→slot resolution (shared across co-located tables)."""
    uniq: np.ndarray          # [U] int64 ids
    slots: np.ndarray         # [U] int64 cache slots
    miss_idx: np.ndarray      # indices into uniq that were misses
    victim_slots: np.ndarray  # slots being reused this step ([0] if none)
    victim_ids: np.ndarray    # the ids formerly in those slots (≥0 only)


class SlotDirectory:
    """Host-side LRU id→slot map for a device cache of ``capacity`` rows.

    Tables over the same id space share ONE directory (resolve once per
    step); each table moves its own rows for the resolved miss/victim sets.
    """

    def __init__(self, capacity: int):
        self.cap = int(capacity)
        self._slot_of: Dict[int, int] = {}
        self._slot_id = np.full(self.cap, -1, np.int64)
        self._last_use = np.zeros(self.cap, np.int64)
        self._n_used = 0
        self._tick = 0
        self._rng_evict = np.random.RandomState(0)   # sampled-LRU candidates
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def resolve(self, uniq: np.ndarray) -> Resolution:
        """Assign every unique id a slot; evict the coldest non-batch slots
        when full.  Call ONCE per step, before any cache fill.

        If the step later fails before the miss rows reach the device
        arena, call :meth:`rollback` with the returned Resolution — the
        miss ids re-miss on retry instead of hitting never-filled slots.
        """
        self._tick += 1
        uniq = np.asarray(uniq, np.int64).ravel()
        get = self._slot_of.get
        slots = np.fromiter((get(i, -1) for i in uniq.tolist()),
                            np.int64, len(uniq))
        miss_i = np.nonzero(slots < 0)[0]
        n_miss = len(miss_i)
        self.hits += len(uniq) - n_miss
        self.misses += n_miss
        # stamp hits NOW: anything at the current tick is batch-protected,
        # which lets eviction test protection in O(1) per candidate
        self._last_use[slots[slots >= 0]] = self._tick
        victims = np.empty(0, np.int64)
        victim_ids = np.empty(0, np.int64)
        if n_miss:
            new_slots, victims, victim_ids = self._allocate(n_miss)
            for i, s in zip(miss_i.tolist(), new_slots.tolist()):
                self._slot_of[int(uniq[i])] = s
                self._slot_id[s] = uniq[i]
            slots[miss_i] = new_slots
        return Resolution(uniq, slots, miss_i, victims, victim_ids)

    def rollback(self, res: Resolution):
        """Undo a resolution whose miss rows never reached the arenas.

        MUST be called before any arena scatter for this resolution (the
        trainer fills every table, then scatters, so a fill failure leaves
        all arenas untouched).  Miss ids are forgotten (they re-miss and
        re-pull on retry) and the evicted victims are RE-INSTATED: their
        arena rows are still intact, so tables whose writeback had not run
        yet lose nothing — and for tables already written back, the cache
        copy is identical to the host copy, consistent either way."""
        for i in res.miss_idx.tolist():
            rid = int(res.uniq[i])
            s = self._slot_of.pop(rid, None)
            if s is not None:
                self._slot_id[s] = -1
                self._last_use[s] = 0
        for s, rid in zip(res.victim_slots.tolist(),
                          res.victim_ids.tolist()):
            self._slot_of[int(rid)] = s
            self._slot_id[s] = rid
            self._last_use[s] = self._tick - 1   # unprotected, still warm
        # reclaim fresh slots handed to the rolled-back misses: fresh
        # allocations are the arena tail, so retries reuse them instead of
        # burning new slots on every failed attempt
        while self._n_used > 0 and self._slot_id[self._n_used - 1] < 0:
            self._n_used -= 1

    def _allocate(self, k: int):
        free = self.cap - self._n_used
        take = min(k, free)
        out = np.empty(k, np.int64)
        victims = np.empty(0, np.int64)
        victim_ids = np.empty(0, np.int64)
        if take:
            # fresh slots are handed out sequentially: the never-used region
            # is exactly [_n_used, cap)
            out[:take] = np.arange(self._n_used, self._n_used + take)
            self._n_used += take
            # stamp immediately: protected from this call's own eviction
            self._last_use[out[:take]] = self._tick
        if take < k:
            reused = self._pick_victims(k - take)
            ids_of = self._slot_id[reused].copy()
            out[take:] = reused
            self._last_use[reused] = self._tick
            # writeback pair: only slots that still hold a live id (a slot
            # rolled back or evicted earlier keeps id -1, no writeback)
            ok = ids_of >= 0
            victims, victim_ids = reused[ok], ids_of[ok]
            for rid in victim_ids.tolist():
                del self._slot_of[int(rid)]
            self._slot_id[reused] = -1
            self.evictions += int(ok.sum())
        return out, victims, victim_ids

    def _pick_victims(self, k: int) -> np.ndarray:
        """k distinct unprotected slots (``_last_use < tick``), coldest
        first.  Sampled eviction: steady-state misses must not pay an
        O(capacity) scan per step (the full arena is 2^20 slots; a batch
        evicts dozens), so try a bounded random sample first — the
        sampled-LRU policy of production caches — and fall back to the
        exact full scan only when the sample can't cover k."""
        tick = self._tick
        sample_n = max(4 * k, 4096)
        if sample_n < self.cap:
            cand = np.unique(self._rng_evict.randint(0, self.cap, sample_n))
            cand = cand[self._last_use[cand] < tick]
            if len(cand) >= k:
                order = np.argpartition(self._last_use[cand], k - 1)[:k]
                return cand[order].astype(np.int64)
        cand = np.nonzero(self._last_use < tick)[0]
        if len(cand) < k:
            raise RuntimeError(
                f"device-cache capacity {self.cap} cannot hold one batch's "
                f"unique ids ({self.cap - len(cand) + k} needed); raise "
                f"capacity above the per-batch unique-id count")
        order = np.argpartition(self._last_use[cand], k - 1)[:k]
        return cand[order].astype(np.int64)

    def items(self):
        """(ids [n], slots [n]) of everything currently cached."""
        n = len(self._slot_of)
        ids = np.fromiter(self._slot_of.keys(), np.int64, n)
        slots = np.fromiter(self._slot_of.values(), np.int64, n)
        return ids, slots

    def lookup(self, uniq: np.ndarray) -> np.ndarray:
        """Slots of ``uniq`` (-1 where absent): no LRU update, no
        allocation."""
        get = self._slot_of.get
        return np.fromiter((get(i, -1) for i in uniq.tolist()),
                           np.int64, len(uniq))

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class DeviceEmbeddingCache:
    """Per-table device arenas + host-table data movement over a (possibly
    shared) SlotDirectory.  The arenas (``{"rows", "state"}`` of torch
    tensors on ``device``) belong to the caller's train step, which
    updates them in place; this class fills misses and writes evictions
    back."""

    def __init__(self, client, table_id: int, dim: int,
                 capacity: int = 1 << 20, optimizer: str = "adagrad",
                 lr: float = 0.05, eps: float = 1e-8, l1: float = 0.0,
                 l2: float = 0.0, lr_power: float = -0.5,
                 miss_bucket: int = 1024,
                 directory: Optional[SlotDirectory] = None, *,
                 device: DeviceLike = None):
        if optimizer not in DEVICE_RULES:
            raise ValueError(
                f"device cache rule {optimizer!r} not in {DEVICE_RULES}")
        self.device = resolve_device(device)
        self.client = client
        self.table_id = int(table_id)
        self.dim = int(dim)
        self.directory = directory if directory is not None \
            else SlotDirectory(capacity)
        self.cap = self.directory.cap
        self.opt = optimizer
        self.hyper = dict(lr=lr, eps=eps, l1=l1, l2=l2, lr_power=lr_power)
        self.miss_bucket = int(miss_bucket)
        self._state_names = _STATE_SPEC[optimizer]
        # idempotent: no-op when the embedding layer already created it
        client.create_table(self.table_id, "sparse", dim=dim,
                            optimizer=optimizer, lr=lr, eps=eps, l1=l1,
                            l2=l2, lr_power=lr_power)

    # -- device arenas -------------------------------------------------------
    def init_arenas(self):
        """Fresh device arenas: [cap+1, dim] rows + per-rule state (+1 is
        the scratch slot that absorbs padded scatter/gather traffic)."""
        def zeros():
            return torch.zeros((self.cap + 1, self.dim), dtype=torch.float32,
                               device=self.device)
        return {"rows": zeros(),
                "state": {k: zeros() for k in self._state_names}}

    # -- per-step data movement ---------------------------------------------
    def fill(self, res: Resolution, arenas):
        """Move this table's rows for an already-resolved step: write the
        victim rows back to the host table, pull the miss block.

        Returns (miss_slots [M_pad] int32, miss_rows [M_pad, D] f32,
        miss_state dict) as numpy, or (None, None, None) when the step had
        no misses.  Padded entries of miss_slots point at the scratch slot
        (index cap)."""
        if len(res.victim_slots):
            self._writeback(res.victim_slots, res.victim_ids, arenas)
        n_miss = len(res.miss_idx)
        if not n_miss:
            return None, None, None
        rows, state = self.client.export_rows(self.table_id,
                                              res.uniq[res.miss_idx])
        m_pad = _pad_to_bucket(n_miss, self.miss_bucket)
        miss_rows = np.zeros((m_pad, self.dim), np.float32)
        miss_rows[:n_miss] = rows
        miss_state = {}
        for k in self._state_names:
            buf = np.zeros((m_pad, self.dim), np.float32)
            buf[:n_miss] = state[k]
            miss_state[k] = buf
        miss_slots = np.full(m_pad, self.cap, np.int64)     # scratch
        miss_slots[:n_miss] = res.slots[res.miss_idx]
        return miss_slots.astype(np.int32), miss_rows, miss_state

    def scatter(self, arenas, miss_slots, miss_rows, miss_state):
        """Write a filled miss block (``fill``'s numpy output) into the
        arenas, in place on the device."""
        sl = torch.from_numpy(miss_slots).to(self.device).long()
        arenas["rows"][sl] = torch.from_numpy(miss_rows).to(self.device)
        for k, v in miss_state.items():
            arenas["state"][k][sl] = torch.from_numpy(v).to(self.device)

    def prepare(self, uniq: np.ndarray, arenas=None):
        """Single-table convenience: resolve + fill in one call.
        Returns (slots [U] int32, miss_slots, miss_rows, miss_state).
        On any failure the resolution is rolled back, so the directory
        never maps ids to never-filled slots."""
        res = self.directory.resolve(uniq)
        try:
            if len(res.victim_slots) and arenas is None:
                raise RuntimeError(
                    "cache full: prepare() needs the current device arenas "
                    "to write evicted rows back")
            miss_slots, miss_rows, miss_state = self.fill(res, arenas)
        except Exception:
            self.directory.rollback(res)
            raise
        return res.slots.astype(np.int32), miss_slots, miss_rows, miss_state

    def _gather_host(self, arenas, slots):
        """Rows and state of ``slots`` from the arenas, as numpy (one
        device gather and one copy to the host each)."""
        sl = torch.from_numpy(np.asarray(slots, np.int64)).to(self.device)
        rows = arenas["rows"][sl].cpu().numpy()
        state = {k: arenas["state"][k][sl].cpu().numpy()
                 for k in self._state_names}
        return rows, state

    def _writeback(self, victim_slots, victim_ids, arenas):
        if not len(victim_ids):
            return
        rows_back, state_back = self._gather_host(arenas, victim_slots)
        self.client.import_rows(self.table_id, victim_ids, rows_back,
                                state_back)

    def read_rows(self, uniq: np.ndarray, arenas) -> np.ndarray:
        """Non-mutating read of CURRENT values: cached ids gather from the
        device arena, cold ids pull from the host table.  No LRU update,
        no slot allocation — the eval/serving read path while a trainer
        owns the cache."""
        uniq = np.asarray(uniq, np.int64).ravel()
        slots = self.directory.lookup(uniq)
        out = np.empty((len(uniq), self.dim), np.float32)
        hit = slots >= 0
        if hit.any():
            out[hit] = self._gather_host(arenas, slots[hit])[0]
        cold = ~hit
        if cold.any():
            out[cold] = self.client.pull_sparse(self.table_id, uniq[cold])
        return out

    # -- barriers ------------------------------------------------------------
    def writeback_all(self, arenas):
        """Flush every cached row (+state) to the host table — PSGPU's
        EndPass.  Call before eval/save/shutdown."""
        ids, slots = self.directory.items()
        if not len(ids):
            return
        rows, state = self._gather_host(arenas, slots)
        self.client.import_rows(self.table_id, ids, rows, state)

    # directory passthroughs (for stats consumers)
    @property
    def hit_rate(self):
        return self.directory.hit_rate

    @property
    def hits(self):
        return self.directory.hits

    @property
    def misses(self):
        return self.directory.misses

    @property
    def evictions(self):
        return self.directory.evictions
