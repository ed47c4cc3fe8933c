"""DistributedEmbedding: host-table embedding with device-side compute.

Counterpart of ``paddle_tpu/distributed/ps/embedding.py``.  Reference
parity: the sparse-table lookup path — lookup_sparse_table ops +
parameter_prefetch (operators/distributed/parameter_prefetch.cc pulls rows
for the batch's ids from pservers) and parameter_send's sparse push of
SelectedRows grads.

Per step (the HeterPS split):
  1. host: unique the batch ids, PULL only those rows from the table,
  2. device: one gather ( + the rest of the dense model) on the card,
  3. backward: the pulled row-block is a leaf tensor with
     ``requires_grad``, so autograd leaves a dense [U, D] grad on it
     (U = unique ids in batch — small),
  4. host: PUSH (ids, row grads) — the server applies its per-row rule.
So the device only ever sees O(batch) rows of the (unbounded) table.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...framework.place import DeviceLike, resolve_device
from .device_cache import pad_adaptive


def _pad_rows(rows: np.ndarray, dim: int) -> np.ndarray:
    """Zero rows up to ``pad_adaptive(len(rows))`` (the fused step's
    eighth-octave shape grain)."""
    n = len(rows)
    n_pad = pad_adaptive(n)
    if n_pad == n:
        return rows
    return np.concatenate([rows, np.zeros((n_pad - n, dim), np.float32)])


class DistributedEmbedding(nn.Module):
    """Embedding whose weights live in a PS table (local or remote client).
    It holds no parameter: its rows are pulled per forward onto
    ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, client, table_id: int, dim: int,
                 optimizer: str = "adagrad", lr: float = 0.05,
                 init_scale: float = 0.01, *, device: DeviceLike = None,
                 **table_kw):
        super().__init__()
        self.device = resolve_device(device)
        self.client = client
        self.table_id = int(table_id)
        self.dim = int(dim)
        self.optimizer = optimizer
        self.lr = float(lr)
        self.table_kw = dict(table_kw)
        client.create_table(self.table_id, "sparse", dim=dim,
                            optimizer=optimizer, lr=lr,
                            init_scale=init_scale, **table_kw)
        self._pending: List[Tuple[np.ndarray, torch.Tensor]] = []
        # set by a trainer that owns a device cache of this table: a
        # function uniq ids -> current rows (numpy)
        self._cache_read = None

    def pull_padded_rows(self, uniq):
        """Host pull + eighth-octave padding (device_cache.pad_adaptive):
        the [U_pad, D] block the fused step takes, so a drifting unique
        count changes its shape at most 8 times per doubling at ≤25%
        padding.  Shared by the eager forward and the fused trainer."""
        rows = self.client.pull_sparse(self.table_id, uniq)       # host
        return _pad_rows(np.asarray(rows, np.float32), self.dim)

    def forward(self, ids):
        ids_np = ids.detach().cpu().numpy() if torch.is_tensor(ids) \
            else np.asarray(ids)
        uniq, inv = np.unique(ids_np, return_inverse=True)
        if self._cache_read is not None:
            # a trainer-owned device cache holds the authoritative rows
            # (host table stale until flush).  Eval reads through it; an
            # eager TRAINING forward would fork the parameter state between
            # the cache and the push path, so refuse loudly.
            if self.training:
                raise RuntimeError(
                    "DistributedEmbedding is bound to a trainer's device "
                    "cache; train through the trainer, or call .eval() "
                    "for read-through inference")
            rows = _pad_rows(self._cache_read(uniq), self.dim)
            w_rows = torch.from_numpy(rows).to(self.device)
        else:
            rows = self.pull_padded_rows(uniq)
            w_rows = torch.from_numpy(rows).to(self.device) \
                .requires_grad_(True)                              # leaf
            if self.training:
                self._pending.append((uniq, w_rows))
        inv_t = torch.from_numpy(inv.reshape(ids_np.shape).astype(np.int64)) \
            .to(self.device)
        return F.embedding(inv_t, w_rows)                          # device

    def flush_grads(self):
        """Push accumulated row grads to the table (the per-step
        parameter_send).  Call after backward, before/at optimizer.step."""
        for uniq, w_rows in self._pending:
            if w_rows.grad is not None:
                grads = w_rows.grad[:len(uniq)].cpu().numpy()
                self.client.push_sparse(self.table_id, uniq, grads)
        self._pending.clear()

    def table_size(self):
        return self.client.table_size(self.table_id)
