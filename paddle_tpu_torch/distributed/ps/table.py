"""Host-resident parameter-server tables.

Reference parity: the PS table stack —
paddle/fluid/distributed/table/table.h:32 (Table with pull/push sparse+dense
and an Accessor), operators/distributed/large_scale_kv.h (SSD-able sparse
embedding storage with lazy row init), and the per-row optimizers the
accessors apply on push: sgd/adagrad/adam plus the CTR family —
ftrl (operators/optimizers/ftrl_op.h SparseFTRLFunctor), proximal_gd
(proximal_gd_op.h:47), proximal_adagrad (proximal_adagrad_op.h:50),
decayed_adagrad (decayed_adagrad_op.h:63), dpsgd (dpsgd_op.h:68, the
CCS16 DP-SGD rule).

Counterpart of ``paddle_tpu/distributed/ps/table.py``, copied (numpy
only): the same ``RandomState(seed)`` draws give the same lazily created
rows, so a table of either package reproduces the other's.

The dense compute (gather, MLP, loss, dense grads) runs on the card;
these tables keep the 100B-parameter-scale sparse embeddings in HOST memory
(the HeterPS pattern: "dense on the accelerator, sparse tables on
hosts").  Storage is a flat numpy ARENA ([capacity, dim] plus parallel
per-slot optimizer-state arrays) with an id→slot dict, so pull is one fancy
gather and push is one vectorized rule application over the touched block —
the vectorized-accessor layout the reference gets from its per-shard Eigen
kernels, instead of a per-row python loop.  Rows are created lazily on
first pull (large_scale_kv.h's init-on-miss).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# slot-state layout per optimizer rule: name -> per-slot array of row shape
_STATE_SPEC = {
    "sum": (),
    "sgd": (),
    "adagrad": ("acc",),
    "adam": ("m", "v"),
    "ftrl": ("sq", "lin"),
    "proximal_gd": (),
    "proximal_adagrad": ("moment",),
    "decayed_adagrad": ("moment",),
    "dpsgd": (),
}


class SparseTable:
    """id → embedding-row store with a server-side per-row optimizer.

    ≙ CommonSparseTable (distributed/table/common_sparse_table.h) +
    large_scale_kv.h ValueBlock: hash index, lazy init, vectorized rule on
    push.
    """

    def __init__(self, dim: int, optimizer: str = "sgd", lr: float = 0.01,
                 initializer: str = "uniform", init_scale: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: Optional[float] = None,
                 l1: float = 0.0, l2: float = 0.0, lr_power: float = -0.5,
                 decay: float = 0.95, clip: float = 10.0, sigma: float = 1.0,
                 batch_size: float = 16.0, seed: int = 0):
        if optimizer not in _STATE_SPEC:
            raise ValueError(f"unknown sparse optimizer {optimizer}")
        self.dim = int(dim)
        self.opt = optimizer
        self.lr = float(lr)
        if eps is None:
            # per-rule defaults matching the dense optimizer classes
            # (DecayedAdagrad epsilon=1e-6; the adam/adagrad family 1e-8)
            eps = 1e-6 if optimizer == "decayed_adagrad" else 1e-8
        self.beta1, self.beta2, self.eps = beta1, beta2, float(eps)
        self.l1, self.l2, self.lr_power = float(l1), float(l2), float(lr_power)
        self.decay = float(decay)
        self.clip, self.sigma, self.batch_size = (float(clip), float(sigma),
                                                  float(batch_size))
        self._index: Dict[int, int] = {}
        self._n = 0
        self._arena = np.empty((0, self.dim), np.float32)
        self._slot_state: Dict[str, np.ndarray] = {
            k: np.empty((0, self.dim), np.float32)
            for k in _STATE_SPEC[optimizer]}
        self._step = 0
        self._rng = np.random.RandomState(seed)
        self._init = initializer
        self._scale = init_scale

    # -- storage ------------------------------------------------------------
    def _grow(self, need: int):
        cap = len(self._arena)
        if self._n + need <= cap:
            return
        new_cap = max(1024, cap * 2, self._n + need)
        grown = np.empty((new_cap, self.dim), np.float32)
        grown[:self._n] = self._arena[:self._n]
        self._arena = grown
        for k, st in self._slot_state.items():
            g = np.zeros((new_cap, self.dim), np.float32)
            g[:self._n] = st[:self._n]
            self._slot_state[k] = g

    def _init_block(self, k: int) -> np.ndarray:
        if self._init == "zeros":
            return np.zeros((k, self.dim), np.float32)
        return self._rng.uniform(-self._scale, self._scale,
                                 (k, self.dim)).astype(np.float32)

    def _slots_of(self, ids: np.ndarray, create: bool) -> np.ndarray:
        """Vectorized-ish id→slot resolution; -1 for absent (create=False)."""
        idx = self._index
        get = idx.get
        slots = np.fromiter((get(i, -1) for i in ids.tolist()),
                            np.int64, len(ids))
        if create:
            miss = np.nonzero(slots < 0)[0]
            if len(miss):
                # dedupe: repeated new ids in one call share ONE slot
                new_ids = np.unique(ids[miss])
                k = len(new_ids)
                self._grow(k)
                base = self._n
                self._arena[base:base + k] = self._init_block(k)
                for st in self._slot_state.values():
                    st[base:base + k] = 0.0
                for j, rid in enumerate(new_ids.tolist()):
                    idx[int(rid)] = base + j
                self._n = base + k
                slots[miss] = np.fromiter(
                    (idx[int(i)] for i in ids[miss].tolist()),
                    np.int64, len(miss))
        return slots

    # -- pull / push ---------------------------------------------------------
    def pull(self, ids: np.ndarray) -> np.ndarray:
        """[n] ids → [n, dim] rows (rows created on first touch)."""
        ids = np.asarray(ids, np.int64).ravel()
        slots = self._slots_of(ids, create=True)
        return self._arena[slots]

    def push(self, ids: np.ndarray, grads: np.ndarray):
        """Apply the server-side rule to the pushed rows.

        Duplicate ids within one push are sum-merged first (the reference
        merges SelectedRows before the accessor runs, table.h:32 Push).
        """
        self._step += 1
        ids = np.asarray(ids, np.int64).ravel()
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        if len(uniq) != len(ids):
            merged = np.zeros((len(uniq), self.dim), np.float32)
            np.add.at(merged, inv, grads)
            ids, grads = uniq, merged
        # "sum" accepts deltas for unseen ids (SparseGeoTable accumulates);
        # the optimizer rules touch only rows that exist
        slots = self._slots_of(ids, create=(self.opt == "sum"))
        live = slots >= 0
        if not live.all():
            slots, grads = slots[live], grads[live]
        if len(slots) == 0:
            return
        self._apply_rule(slots, grads)

    def _apply_rule(self, s: np.ndarray, g: np.ndarray):
        P, lr, st = self._arena, self.lr, self._slot_state
        opt = self.opt
        if opt == "sum":
            P[s] -= g
        elif opt == "sgd":
            P[s] -= lr * g
        elif opt == "adagrad":
            acc = st["acc"][s] + g * g
            st["acc"][s] = acc
            P[s] -= lr * g / (np.sqrt(acc) + self.eps)
        elif opt == "adam":
            t = self._step
            bc1 = 1 - self.beta1 ** t
            bc2 = 1 - self.beta2 ** t
            m = self.beta1 * st["m"][s] + (1 - self.beta1) * g
            v = self.beta2 * st["v"][s] + (1 - self.beta2) * g * g
            st["m"][s], st["v"][s] = m, v
            P[s] -= lr * (m / bc1) / (np.sqrt(v / bc2) + self.eps)
        elif opt == "ftrl":
            # ftrl_op.h SparseFTRLFunctor, vectorized
            p, sq = P[s], st["sq"][s]
            new_acc = sq + g * g
            if self.lr_power == -0.5:
                sigma = (np.sqrt(new_acc) - np.sqrt(sq)) / lr
                y = 2.0 * self.l2 + np.sqrt(new_acc) / lr
            else:
                sigma = (new_acc ** -self.lr_power -
                         sq ** -self.lr_power) / lr
                y = 2.0 * self.l2 + new_acc ** -self.lr_power / lr
            lin = st["lin"][s] + g - sigma * p
            st["lin"][s] = lin
            x = np.sign(lin) * self.l1 - lin
            P[s] = np.where(np.abs(lin) > self.l1, x / y, 0.0)
            st["sq"][s] = new_acc
        elif opt == "proximal_gd":
            # proximal_gd_op.h:47
            P[s] = self._prox_shrink(P[s] - lr * g, lr)
        elif opt == "proximal_adagrad":
            # proximal_adagrad_op.h:50
            m = st["moment"][s] + g * g
            st["moment"][s] = m
            # eps guard (deviation from proximal_adagrad_op.h:51, which
            # divides by bare sqrt and NaNs on zero-grad/zero-moment elems)
            lr_eff = lr / (np.sqrt(m) + self.eps)
            P[s] = self._prox_shrink(P[s] - lr_eff * g, lr_eff)
        elif opt == "decayed_adagrad":
            # decayed_adagrad_op.h:63
            m = self.decay * st["moment"][s] + (1 - self.decay) * g * g
            st["moment"][s] = m
            P[s] -= lr * g / (np.sqrt(m) + self.eps)
        elif opt == "dpsgd":
            # dpsgd_op.h:68 applied PER ROW (the per-row-accessor contract:
            # a row's update must not depend on which other ids share the
            # push call — ShardedPsClient splits pushes by id%shards):
            # clip each row's l2 norm, one noise sample per row
            norm = np.sqrt(np.sum(g * g, axis=1, keepdims=True))
            scale = np.maximum(norm / self.clip, 1.0)
            noise = self._rng.normal(
                0.0, self.sigma, (len(g), 1)).astype(np.float32)
            P[s] -= lr * (g / scale + noise / self.batch_size)

    def _prox_shrink(self, prox, lr_eff):
        """sign(prox)·max(|prox| − lr·l1, 0)/(1 + lr·l2) — with l1 == 0 this
        reduces exactly to the reference's else-branch prox/(1+lr·l2), so one
        formula serves both (proximal_gd_op.h:47-56)."""
        return (np.sign(prox) *
                np.maximum(np.abs(prox) - lr_eff * self.l1, 0.0) /
                (1.0 + lr_eff * self.l2))

    # -- raw row access (device-cache writeback / checkpoint shards) ---------
    def export_rows(self, ids: np.ndarray):
        """(rows [n,D], state dict of [n,D]) for ids; missing ids get freshly
        initialized rows — the pull-with-state used by accelerator row caches
        (HeterPS pulls value+opt state into the GPU cache, heter_ps/)."""
        ids = np.asarray(ids, np.int64).ravel()
        slots = self._slots_of(ids, create=True)
        return (self._arena[slots],
                {k: v[slots] for k, v in self._slot_state.items()})

    def import_rows(self, ids: np.ndarray, rows: np.ndarray,
                    state: Optional[Dict[str, np.ndarray]] = None):
        """Store raw row values (+ optimizer state) — the cache-eviction
        writeback: values were already optimized elsewhere, no rule applied."""
        ids = np.asarray(ids, np.int64).ravel()
        slots = self._slots_of(ids, create=True)
        self._arena[slots] = np.asarray(rows, np.float32)
        if state:
            for k, v in state.items():
                self._slot_state[k][slots] = np.asarray(v, np.float32)

    # -- introspection / checkpoint ------------------------------------------
    def __len__(self):
        return self._n

    def state_dict(self):
        spec = _STATE_SPEC[self.opt]
        return {"dim": self.dim, "opt": self.opt, "lr": self.lr,
                "step": self._step,
                "rows": {k: self._arena[s].copy()
                         for k, s in self._index.items()},
                "state": {k: tuple(self._slot_state[n][s].copy()
                                   for n in spec)
                          for k, s in self._index.items()} if spec else {}}

    def load_state_dict(self, sd):
        self.dim = sd["dim"]
        self._step = sd["step"]
        n = len(sd["rows"])
        # raw slot assignment: saved values land directly in the arena — no
        # _init_block draws, so the table RNG stays where a never-
        # checkpointed run would have it (restore must not perturb the
        # lazy-init stream)
        names = _STATE_SPEC[self.opt]
        cap = max(n, 1)
        self._arena = np.empty((cap, self.dim), np.float32)
        self._slot_state = {k: np.zeros((cap, self.dim), np.float32)
                            for k in names}
        self._index, self._n = {}, n
        for i, (k, v) in enumerate(sd["rows"].items()):
            self._index[int(k)] = i
            self._arena[i] = np.asarray(v, np.float32)
        for k, tup in sd.get("state", {}).items():
            i = self._index[int(k)]
            for name, arr in zip(names, tup):
                self._slot_state[name][i] = np.asarray(arr, np.float32)


class DenseTable:
    """Flat dense parameter block with SGD-on-push (≙ common_dense_table)."""

    def __init__(self, shape, lr: float = 0.01, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.value = (rng.standard_normal(shape) *
                      0.01).astype(np.float32)
        self.lr = float(lr)

    def pull(self) -> np.ndarray:
        return self.value.copy()

    def push(self, grad: np.ndarray):
        self.value -= self.lr * np.asarray(grad, np.float32)
