"""Wide&Deep CTR model over parameter-server sparse embeddings.

Counterpart of ``paddle_tpu/rec/wide_deep.py``.  Reference parity:
BASELINE workload 5 — the DistributedStrategy + sparse embedding CTR
configuration the reference serves with its PS stack
(fluid.layers.embedding(is_sparse=True, is_distributed=True) pulled through
lookup_sparse_table / parameter_prefetch).  Model shape follows the classic
Wide&Deep CTR recipe (Cheng et al., 2016): a wide linear part over the raw
sparse slots plus a deep MLP over slot embeddings and dense features.

The sparse side is two host tables (dim-1 wide weights, dim-D deep
embeddings) behind DistributedEmbedding; everything dense — gathers, MLP,
loss, backward, Adam — runs on the card.  In device-cache mode (the
default) the hot rows and their optimizer state live on the card too
(``distributed/ps/device_cache.py``) and one fused step applies the sparse
rule there.  No hand-written kernel is on this path: the step is gathers,
three GEMM layers, the BCE loss, Adam and scatters, as plain PyTorch
operations (the JAX step is plain XLA).
"""
from __future__ import annotations

import queue as queue_mod
import threading
import time

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..distributed.ps import DistributedEmbedding, LocalPsEndpoint
from ..distributed.ps.device_cache import (DEVICE_RULES,
                                           DeviceEmbeddingCache,
                                           SlotDirectory, apply_rule_device,
                                           pad_adaptive)
from ..framework.bridge import load_jax_state
from ..framework.enforce import (InvalidArgumentError,
                                 PreconditionNotMetError, UnimplementedError)
from ..framework.flags import flag
from ..framework.place import DeviceLike, resolve_device
from ..nn import Linear, ReLU


class WideDeep(nn.Module):
    """Wide&Deep CTR: ``wide_emb`` (table 0, dim 1) and ``deep_emb``
    (table 1, dim ``emb_dim``) over one PS client, the MLP ``dnn`` and the
    wide linear ``wide_dense``, all on ``device`` (CUDA unless
    ``device="cpu"``)."""

    def __init__(self, client=None, emb_dim: int = 16, num_slots: int = 26,
                 dense_dim: int = 13, hidden=(400, 400, 400),
                 sparse_lr: float = 0.05, sparse_optimizer: str = "adagrad",
                 *, device: DeviceLike = None, **table_kw):
        super().__init__()
        dev = resolve_device(device)
        client = client or LocalPsEndpoint()
        self.client = client
        self.num_slots = num_slots
        self.wide_emb = DistributedEmbedding(client, table_id=0, dim=1,
                                             optimizer=sparse_optimizer,
                                             lr=sparse_lr, device=dev,
                                             **table_kw)
        self.deep_emb = DistributedEmbedding(client, table_id=1, dim=emb_dim,
                                             optimizer=sparse_optimizer,
                                             lr=sparse_lr, device=dev,
                                             **table_kw)
        layers = []
        in_dim = num_slots * emb_dim + dense_dim
        for h in hidden:
            layers += [Linear(in_dim, h, device=dev), ReLU()]
            in_dim = h
        layers.append(Linear(in_dim, 1, device=dev))
        self.dnn = nn.Sequential(*layers)
        self.wide_dense = Linear(dense_dim, 1, device=dev)

    @property
    def device(self) -> torch.device:
        return self.wide_dense.weight.device

    def forward(self, sparse_ids, dense_x):
        if not torch.is_tensor(dense_x):
            dense_x = torch.from_numpy(np.asarray(dense_x, np.float32))
        dense_x = dense_x.to(self.device)
        # wide: sum of per-slot scalar weights + linear over dense feats
        wide = self.wide_emb(sparse_ids).squeeze(-1).sum(-1, keepdim=True)
        wide = wide + self.wide_dense(dense_x)
        # deep: slot embeddings concat dense feats -> MLP
        deep_g = self.deep_emb(sparse_ids)
        deep_in = deep_g.reshape(deep_g.shape[0], -1)
        deep = self.dnn(torch.cat([deep_in, dense_x], dim=-1))
        return wide + deep

    def flush_sparse_grads(self):
        self.wide_emb.flush_grads()
        self.deep_emb.flush_grads()


class _DenseCore(nn.Module):
    """The dense compute of WideDeep as a pure layer over pulled rows:
    (wide_rows [U1,1], deep_rows [U2,D], wide_inv [B,S], deep_inv [B,S],
    dense_x [B,F]) -> logits [B,1].  Shares the model's modules, so its
    parameter names are the model's dense ones."""

    def __init__(self, wd: WideDeep):
        super().__init__()
        self.dnn = wd.dnn
        self.wide_dense = wd.wide_dense

    def forward(self, wide_rows, deep_rows, wide_inv, deep_inv, dense_x):
        wide_g = torch.nn.functional.embedding(wide_inv, wide_rows)
        wide = wide_g.squeeze(-1).sum(-1, keepdim=True) + \
            self.wide_dense(dense_x)
        deep_g = torch.nn.functional.embedding(deep_inv, deep_rows)
        deep_in = deep_g.reshape(deep_g.shape[0], -1)
        deep = self.dnn(torch.cat([deep_in, dense_x], dim=-1))
        return wide + deep


def sort_unique_static(ids_flat, cap):
    """Static-cap sort-based unique on the DEVICE (the replacement for the
    host np.unique every cached-mode step pays over the full B*S id
    block): a stable argsort, boundary flags, segment ids by cumsum, then
    one segment-sum for per-unique occurrence counts.

    Returns ``(uniq [cap], inv [N], count, counts [cap])`` — ``uniq`` is
    sorted-unique padded to ``cap`` (entries past ``count`` are
    meaningless; compare count on the host and re-run at a bigger octave
    when it overflows), ``inv`` maps each input position to its unique
    slot exactly like ``np.unique(return_inverse=True)`` (np.unique also
    sorts, so the two paths produce bit-identical gathers), and
    ``counts`` is the occupancy histogram."""
    order = torch.argsort(ids_flat, stable=True)
    s = ids_flat[order]
    flags_ = torch.cat([torch.ones(1, dtype=torch.int64, device=s.device),
                        (s[1:] != s[:-1]).long()])
    seg = torch.cumsum(flags_, 0) - 1            # unique index, sorted order
    count = seg[-1] + 1
    uniq = torch.zeros(cap, dtype=s.dtype, device=s.device)
    uniq[seg.clamp(0, cap - 1)] = s
    inv = torch.empty_like(seg)
    inv[order] = seg
    counts = torch.zeros(cap, dtype=torch.int64, device=s.device)
    keep = seg < cap
    counts.index_add_(0, seg[keep], torch.ones_like(seg[keep]))
    return uniq, inv, count, counts


def bce_with_logits_mean(x, labels):
    """Numerically stable mean BCE-with-logits (the JAX package's formula,
    term for term)."""
    loss = torch.clamp_min(x, 0) - x * labels + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


def make_adam_update(lr, b1=0.9, b2=0.999, eps=1e-8):
    """Functional Adam over a {name: tensor} dict with bias correction —
    the dense-side update of the CTR trainer's step.  ``t`` is a device
    int32 scalar, so the update reads nothing back to the host (a CUDA
    graph can hold it)."""
    def adam_update(params, adam, gp):
        t = adam["t"] + 1
        tf = t.float()
        corr = torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        new_m = {k: b1 * adam["m"][k] + (1 - b1) * gp[k] for k in gp}
        new_v = {k: b2 * adam["v"][k] + (1 - b2) * gp[k] ** 2 for k in gp}
        new_p = {k: params[k] - lr * corr * new_m[k] /
                 (torch.sqrt(new_v[k]) + eps) for k in gp}
        return new_p, {"m": new_m, "v": new_v, "t": t}
    return adam_update


def _copy_tree(dst, src):
    """In-place copy of a nested dict of tensors (the step's commit)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v)
        else:
            dst[k].copy_(v)


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


class WideDeepTrainer:
    """The PS CTR train loop at two service levels:

    **device-cache mode** (default when the sparse rule runs on the device
    and the client supports export/import_rows): the HeterPS/PSGPU design
    (framework/fleet/ps_gpu_wrapper.h, trainer.h:281 PSGPUTrainer) — hot
    embedding rows and their optimizer state live in device arenas
    (DeviceEmbeddingCache); per step the host ships only batch INDICES plus
    the miss block, and one fused step gathers rows, runs the dense
    forward, backward and Adam, and applies the sparse rule on the device,
    in place.  Steady state moves zero row bytes over the wire, and
    ``step_async`` keeps the device queue full (the host prepares batch
    N+1 while the card runs batch N).

    **pull/push mode** (``device_cache=False`` or a table rule the device
    can't run): pull → fused dense forward/backward/Adam → push, the
    Communicator+DeviceWorker loop (communicator.h:195) with three
    host↔device transfers per step; ``async_push`` drains the pushes on a
    thread.

    The dense parameters are the model's own: the step updates them in
    place, so eval and ``state_dict`` always see the trained weights.

    Cache-mode contracts:
    - Host tables hold stale rows until ``flush()`` (PSGPU EndPass
      semantics); eager ``model(...)`` eval stays correct anyway — the
      embeddings read THROUGH the cache while one is bound.
    - ``feature_wire_dtype`` ("float32" default — the same numerics as
      pull/push mode) is the H2D dtype for dense features.  Pass
      "bfloat16" to halve the hot-path wire bytes.  Labels always travel
      f32.
    - ``device`` (CUDA unless ``device="cpu"``) must be the model's."""

    def __init__(self, model: WideDeep, lr: float = 1e-3,
                 async_push: bool = False, device_cache: bool = None,
                 cache_capacity: int = 1 << 20,
                 feature_wire_dtype="float32",
                 sharded_embedding: bool = None,
                 sharded_vocab: int = None, mesh=None, *,
                 device: DeviceLike = None):
        sharded = (bool(flag("sharded_embedding"))
                   if sharded_embedding is None else bool(sharded_embedding))
        if sharded or mesh is not None:
            raise UnimplementedError(
                "the mesh-sharded deep table (FLAGS_sharded_embedding, "
                "mesh=) is not ported: it needs torch.distributed and four "
                "cards (ROADMAP A12)")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise InvalidArgumentError(
                f"WideDeepTrainer on {self.device}, its model on "
                f"{model.device}")
        self.model = model
        self.lr = float(lr)
        self._async_push = bool(async_push)
        self._push_queue = None
        self._push_thread = None
        self._push_err = []
        we, de = model.wide_emb, model.deep_emb
        can_cache = (we.optimizer in DEVICE_RULES and
                     hasattr(model.client, "export_rows"))
        if device_cache is None:
            # async_push explicitly asks for the a_sync pull/push contract
            # (host tables at most one step stale) — honor it over the cache
            device_cache = can_cache and not self._async_push
        elif device_cache and not can_cache:
            raise ValueError(
                f"device_cache: rule {we.optimizer!r} must be in "
                f"{DEVICE_RULES} and the client needs export/import_rows")
        elif device_cache and self._async_push:
            raise ValueError(
                "device_cache and async_push are mutually exclusive: the "
                "cache applies sparse updates on the device (no pushes to "
                "drain) and host tables stay stale until flush()")
        self._use_cache = bool(device_cache)
        if self._async_push:
            # a_sync communicator parity (communicator.h AsyncCommunicator):
            # sparse pushes drain on a background thread, overlapping the
            # next step's pull+compute; embeddings may be read one step
            # stale, and a failed push surfaces on the NEXT step()/flush()
            self._push_queue = queue_mod.Queue(maxsize=4)
            # the closure captures only the queue + error list (NOT self):
            # the trainer must stay collectable; close() retires the thread
            q, errs = self._push_queue, self._push_err

            def drain():
                while True:
                    item = q.get()
                    try:
                        if item is None:
                            return
                        # one item = one step's pushes for BOTH tables, so
                        # a step's sparse updates apply atomically wrt
                        # flush boundaries
                        for emb, uniq, grads, ready in item:
                            if ready is not None:
                                ready.synchronize()
                            emb.client.push_sparse(emb.table_id, uniq,
                                                   grads.numpy())
                    except Exception as e:
                        errs.append(e)
                    finally:
                        q.task_done()

            self._push_thread = threading.Thread(target=drain, daemon=True)
            self._push_thread.start()

        self._core = _DenseCore(model)
        # the trainer's dense state: the model's own parameters (updated in
        # place) and the functional Adam moments
        self._params = dict(self._core.named_parameters())
        self._adam = {
            "m": {k: torch.zeros_like(v) for k, v in self._params.items()},
            "v": {k: torch.zeros_like(v) for k, v in self._params.items()},
            "t": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        self._adam_update = make_adam_update(self.lr)
        self.tier_hits = {"cache_arena": 0, "host_ps": 0}
        self.last_prep_s = 0.0

        if self._use_cache:
            self._feature_wire_dtype = (
                torch.bfloat16 if str(feature_wire_dtype) in
                ("bfloat16", "bf16") else torch.float32)
            # ONE slot directory: both tables share the id space, so ids
            # resolve to slots once per step
            self._slot_dir = SlotDirectory(cache_capacity)
            # device-dedup state (FLAGS_wide_deep_device_dedup): the
            # octave cap of sort_unique_static
            self._dedup_cap = None

            def mk_cache(emb):
                kw = {k: v for k, v in emb.table_kw.items()
                      if k in ("eps", "l1", "l2", "lr_power")}
                return DeviceEmbeddingCache(
                    model.client, emb.table_id, emb.dim,
                    optimizer=emb.optimizer, lr=emb.lr,
                    directory=self._slot_dir, device=self.device, **kw)
            self._w_cache, self._d_cache = mk_cache(we), mk_cache(de)
            self._w_ar = self._w_cache.init_arenas()
            self._d_ar = self._d_cache.init_arenas()
            self._opt_name = we.optimizer
            # eager eval reads THROUGH the cache (host tables are stale
            # until flush — PSGPU EndPass semantics)
            we._cache_read = lambda u: self._w_cache.read_rows(u, self._w_ar)
            de._cache_read = lambda u: self._d_cache.read_rows(u, self._d_ar)

    # -- the fused steps -----------------------------------------------------
    def _dense_grads(self, params, w_rows, d_rows, inv, dense, labels):
        """Loss and gradients of the dense core: w.r.t. every dense
        parameter and both row blocks (no ``.grad`` is written)."""
        w_rows = w_rows.detach().requires_grad_(True)
        d_rows = d_rows.detach().requires_grad_(True)
        with torch.enable_grad():
            out = functional_call(self._core, params,
                                  (w_rows, d_rows, inv, inv, dense))
            loss = bce_with_logits_mean(out, labels)
            grads = torch.autograd.grad(
                loss, [*params.values(), w_rows, d_rows])
        gp = dict(zip(params, grads[:-2]))
        return loss.detach(), gp, grads[-2], grads[-1]

    def _adam_commit(self, params, adam, gp):
        with torch.no_grad():
            new_p, new_adam = self._adam_update(params, adam, gp)
            _copy_tree(params, new_p)
            _copy_tree(adam, new_adam)

    def _rule_and_scatter(self, ar, slots, rows, grads, hyper):
        st = {k: ar["state"][k][slots] for k in ar["state"]}
        new_rows, new_st = apply_rule_device(self._opt_name, rows, st, grads,
                                             **hyper)
        ar["rows"][slots] = new_rows
        for k in ar["state"]:
            ar["state"][k][slots] = new_st[k]

    def _fused_cached(self, state, slots, inv, dense_w, labels):
        """One cached-mode step on ``state`` (params, adam, w_ar, d_ar),
        all in place on the device: gather both tables' rows, the dense
        forward and backward, Adam, the sparse rule on the gathered rows
        and their scatter into both arenas.  Returns the loss (a device
        scalar).  Reads nothing back to the host, so a CUDA graph can
        capture it."""
        dense32 = dense_w.float()
        lab32 = labels.float()
        w_ar, d_ar = state["w_ar"], state["d_ar"]
        w_rows = w_ar["rows"][slots]
        d_rows = d_ar["rows"][slots]
        loss, gp, gw, gd = self._dense_grads(state["params"], w_rows, d_rows,
                                             inv, dense32, lab32)
        self._adam_commit(state["params"], state["adam"], gp)
        # the arenas and the row gradients carry no autograd history
        self._rule_and_scatter(w_ar, slots, w_rows, gw, self._w_cache.hyper)
        self._rule_and_scatter(d_ar, slots, d_rows, gd, self._d_cache.hyper)
        return loss

    def _state(self):
        return {"params": self._params, "adam": self._adam,
                "w_ar": self._w_ar, "d_ar": self._d_ar}

    # -- async push ----------------------------------------------------------
    def _raise_push_errors(self):
        if self._push_err:
            errs = list(self._push_err)
            del self._push_err[:]
            raise errs[0]

    def _host_copy(self, grads, n):
        """Start the copy of ``grads[:n]`` to the host and return (host
        tensor, event to wait on): a drain thread must wait on the stream
        that produced the gradients, and must read a copy, never the
        device buffer (on the CPU ``.cpu()`` would return the tensor
        itself)."""
        if grads.device.type == "cuda":
            host = torch.empty((n,) + tuple(grads.shape[1:]),
                               dtype=grads.dtype, pin_memory=True)
            host.copy_(grads[:n], non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            return host, ready
        return grads[:n].clone(), None

    def _push_both(self, we, de, uniq, gw, gd):
        n = len(uniq)
        if self._async_push:
            self._push_queue.put(((we, uniq) + self._host_copy(gw, n),
                                  (de, uniq) + self._host_copy(gd, n)))
        else:
            we.client.push_sparse(we.table_id, uniq, gw[:n].cpu().numpy())
            de.client.push_sparse(de.table_id, uniq, gd[:n].cpu().numpy())

    def close(self):
        """Retire the drain thread (idempotent)."""
        if self._push_thread is not None:
            self._push_queue.put(None)
            self._push_thread.join(timeout=5)
            self._push_thread = None

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    # -- steps ---------------------------------------------------------------
    def step(self, sparse_ids, dense_x, labels) -> float:
        return float(self.step_async(sparse_ids, dense_x, labels))

    def step_async(self, sparse_ids, dense_x, labels):
        """One train step WITHOUT fencing on the loss: returns the device
        scalar, so the host can prepare batch N+1 while the card runs batch
        N.  Fence with float(loss) or flush()."""
        if self._use_cache:
            return self._step_cached(sparse_ids, dense_x, labels)
        return self._step_pullpush(sparse_ids, dense_x, labels)

    def _dedup_device(self, ids):
        """Sort-based unique + segment-sum on the DEVICE
        (FLAGS_wide_deep_device_dedup): the card dedups the B*S id block at
        an octave cap; the host reads back only the deduped prefix (plus
        one count scalar) for slot resolution, instead of running
        np.unique over the full block every step.  Cap overflow re-runs
        one octave up.  Returns (uniq np [count], inv device [B*S])."""
        flat = torch.from_numpy(np.ascontiguousarray(ids.reshape(-1),
                                                     np.int64)).to(self.device)
        n = flat.numel()
        if self._dedup_cap is None:
            # seed the octave from a one-time host count
            u0 = len(np.unique(ids))
            self._dedup_cap = pad_adaptive(min(max(2 * u0, 16), n))
        while True:
            cap = min(self._dedup_cap, n)
            uniq_dev, inv_dev, count_dev, _counts = sort_unique_static(flat,
                                                                       cap)
            count = int(count_dev)           # one scalar to the host
            if count <= cap or cap >= n:
                break
            # overflow: grow to the octave holding count (strictly > cap)
            self._dedup_cap = pad_adaptive(min(count, n))
        return uniq_dev[:count].cpu().numpy(), inv_dev

    def _prep_cached(self, sparse_ids):
        """Host side of a cached-mode step: id dedup, slot resolution,
        miss fill/scatter, octave-padded slot vector, wire-compressed
        inverse map.  Returns device (slots, inv)."""
        t0 = time.perf_counter()
        ids = np.asarray(sparse_ids)
        if flag("wide_deep_device_dedup"):
            # np.unique also sorts, so both paths produce identical
            # (uniq, inv) and the step numerics are bit-identical
            uniq, inv = self._dedup_device(ids)
        else:
            uniq, inv = np.unique(ids, return_inverse=True)
        # ONE id→slot resolution for both tables, then per-table row moves.
        # A failure before the miss rows land in BOTH arenas rolls the
        # resolution back, so a retried step re-misses instead of hitting
        # never-filled slots (the victims fill() already wrote back stay in
        # the host table — consistent either way).
        res = self._slot_dir.resolve(uniq)
        try:
            w_fill = self._w_cache.fill(res, self._w_ar)
            d_fill = self._d_cache.fill(res, self._d_ar)
        except Exception:
            # rollback is only valid pre-scatter (arenas untouched); a
            # fill failure is cleanly retryable
            self._slot_dir.rollback(res)
            raise
        if w_fill[0] is not None:
            self._w_cache.scatter(self._w_ar, *w_fill)
        if d_fill[0] is not None:
            self._d_cache.scatter(self._d_ar, *d_fill)
        # tier attribution: the arena for hits, the host PS for misses
        n_miss = len(res.miss_idx)
        self.tier_hits["cache_arena"] += len(uniq) - n_miss
        self.tier_hits["host_ps"] += n_miss
        # eighth-octave-pad the slot vector (≤8 shapes per doubling of U);
        # padding points at the scratch slot
        u = len(uniq)
        u_pad = pad_adaptive(u)
        slots_p = np.full(u_pad, self._slot_dir.cap, np.int32)
        slots_p[:u] = res.slots
        slots_dev = torch.from_numpy(slots_p).to(self.device).long()
        if torch.is_tensor(inv):                 # device dedup: on the card
            inv_dev = inv.reshape(ids.shape)
        elif u_pad <= 65536:
            # wire compression: the inverse map crosses as uint16 bits
            # (torch has no uint16 copy), widened on the device
            inv16 = inv.reshape(ids.shape).astype(np.uint16).view(np.int16)
            inv_dev = torch.from_numpy(inv16).to(self.device).long() & 0xFFFF
        else:
            inv_dev = torch.from_numpy(inv.reshape(ids.shape)
                                       .astype(np.int32)).to(self.device) \
                .long()
        self.last_prep_s = time.perf_counter() - t0
        return slots_dev, inv_dev

    def _wire(self, dense_x, labels, dtype=torch.float32):
        """Dense features in ``dtype`` (bf16 is rounded on the host, so
        half the bytes cross) and f32 labels, on the device."""
        dense = torch.from_numpy(np.ascontiguousarray(dense_x, np.float32))
        lab = torch.from_numpy(np.ascontiguousarray(labels, np.float32))
        return dense.to(dtype).to(self.device), lab.to(self.device)

    def _step_cached(self, sparse_ids, dense_x, labels):
        slots_dev, inv_dev = self._prep_cached(sparse_ids)
        dense_w, lab_w = self._wire(dense_x, labels,
                                    self._feature_wire_dtype)
        return self._fused_cached(self._state(), slots_dev, inv_dev,
                                  dense_w, lab_w)

    def capture_step(self, sparse_ids, dense_x, labels):
        """The cached-mode fused step for this batch, captured once as a
        CUDA graph over CLONES of the trainer's state (the trainer's own
        state does not move).  The batch is prepared first, as a step
        would (misses fill the arenas).  Returns a :class:`CapturedStep`
        whose state starts equal to the trainer's."""
        if not self._use_cache:
            raise RuntimeError("in-graph probe needs device-cache mode")
        if self.device.type != "cuda":
            raise PreconditionNotMetError(
                "capture_step captures a CUDA graph: it needs the card")
        slots_dev, inv_dev = self._prep_cached(sparse_ids)
        dense_w, lab_w = self._wire(dense_x, labels,
                                    self._feature_wire_dtype)
        return CapturedStep(self, slots_dev, inv_dev, dense_w, lab_w)

    def in_graph_step_s(self, sparse_ids, dense_x, labels, k_small=2,
                        k_large=6, reps=2):
        """Device seconds per cached-mode fused step: the step captured
        once as a CUDA graph on clones of the trainer's state, then the
        DELTA of ``k_small`` and ``k_large`` back-to-back replays (best of
        ``reps`` each, timed by CUDA events), so launch and host costs
        fall out.  Each replay advances the clones (the loss rides an
        accumulator), so no step repeats a finished one."""
        cap = self.capture_step(sparse_ids, dense_x, labels)
        times = {}
        for k in (k_small, k_large):
            best = None
            for _ in range(reps):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                cap.replay(k)
                t1.record()
                t1.synchronize()
                dt = t0.elapsed_time(t1) / 1e3
                best = dt if best is None else min(best, dt)
            times[k] = best
        return (times[k_large] - times[k_small]) / (k_large - k_small)

    def _step_pullpush(self, sparse_ids, dense_x, labels):
        if self._async_push:
            # surface background push failures BEFORE advancing dense
            # state for this batch
            self._raise_push_errors()
        ids = np.asarray(sparse_ids)
        we, de = self.model.wide_emb, self.model.deep_emb
        # one unique/inverse shared by both tables (same id space)
        uniq, inv = np.unique(ids, return_inverse=True)
        dev = self.device
        w_rows = torch.from_numpy(we.pull_padded_rows(uniq)).to(dev)
        d_rows = torch.from_numpy(de.pull_padded_rows(uniq)).to(dev)
        inv_dev = torch.from_numpy(inv.reshape(ids.shape).astype(np.int64)) \
            .to(dev)
        dense, lab = self._wire(dense_x, labels)
        loss, gp, gw, gd = self._dense_grads(self._params, w_rows, d_rows,
                                             inv_dev, dense, lab)
        self._adam_commit(self._params, self._adam, gp)
        self._push_both(we, de, uniq, gw, gd)
        return loss

    def flush(self):
        """Barrier before eval/save: drain pending async pushes, or in
        device-cache mode write every cached row back to the host table
        (PSGPU EndPass)."""
        if self._use_cache:
            self._w_cache.writeback_all(self._w_ar)
            self._d_cache.writeback_all(self._d_ar)
        if self._push_queue is not None:
            self._push_queue.join()
        self._raise_push_errors()

    def sync_params(self):
        """The JAX trainer points its eager model at the updated arrays
        here.  The port's step updates the model's parameters in place,
        so the model is always in sync and there is nothing to do."""


class CapturedStep:
    """One cached-mode fused step captured as a CUDA graph over static
    clones of a trainer's state (``state``), its batch (``args``: slots,
    inverse map, dense features, labels on the device) fixed.
    ``replay(k)`` runs k steps back to back on the clones and adds each
    loss to ``loss_sum``; ``load(state)`` copies a state tree into the
    clones."""

    def __init__(self, trainer: WideDeepTrainer, slots, inv, dense, labels,
                 warmup: int = 2):
        self.state = _clone_tree(trainer._state())
        for p in self.state["params"].values():
            p.requires_grad_(True)
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=trainer.device)
        self.args = args = (slots, inv, dense, labels)

        def body():
            self.loss_sum.add_(trainer._fused_cached(self.state, *args))

        # autograd and the allocator warm up on a side stream before the
        # capture, as torch.cuda.graphs asks
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                body()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()
        self.load(trainer._state())

    def load(self, state):
        """Copy ``state`` (params, adam, w_ar, d_ar) into the clones and
        zero the loss sum."""
        with torch.no_grad():
            _copy_tree(self.state, state)
            self.loss_sum.zero_()

    def replay(self, k: int = 1):
        for _ in range(k):
            self.graph.replay()


def load_jax_wide_deep(model: WideDeep, jax_model) -> WideDeep:
    """Carry a JAX ``paddle_tpu.rec.wide_deep.WideDeep``'s state into the
    port's ``model`` of the same widths, so both compute the same thing:
    the dense weights through :func:`load_jax_state` (the JAX layer's
    ``named_parameters()`` as numpy: Linear weights transposed, strict on
    names and shapes), and both sparse tables through
    ``SparseTable.state_dict()``/``load_state_dict``, plus each table's
    lazy-init RNG state, so ids first pulled later draw the same rows.
    The JAX model's client must be in-process (``LocalPsEndpoint``); the
    port model's too."""
    params = {n: np.asarray(p.numpy())
              for n, p in jax_model.named_parameters()}
    load_jax_state(_DenseCore(model), params)
    theirs = getattr(jax_model.client, "_tables", None)
    ours = getattr(model.client, "_tables", None)
    if theirs is None or ours is None:
        raise InvalidArgumentError(
            "load_jax_wide_deep needs both models on in-process "
            "LocalPsEndpoint clients")
    for emb in (model.wide_emb, model.deep_emb):
        src, dst = theirs[emb.table_id], ours[emb.table_id]
        if (src.dim, src.opt) != (dst.dim, dst.opt):
            raise InvalidArgumentError(
                f"table {emb.table_id}: JAX (dim {src.dim}, {src.opt}) "
                f"against the port's (dim {dst.dim}, {dst.opt})")
        dst.load_state_dict(src.state_dict())
        dst._rng.set_state(src._rng.get_state())
    return model


def synthetic_ctr_batch(batch: int, num_slots: int = 26, dense_dim: int = 13,
                        vocab: int = 1_000_000, seed: int = 0):
    """Criteo-shaped synthetic batch: 26 categorical slots (slot-offset id
    space), 13 dense features, clicked/not label correlated with features."""
    rng = np.random.RandomState(seed)
    # power-lawish ids per slot, offset so slots never collide
    ids = (rng.zipf(1.5, size=(batch, num_slots)) % (vocab // num_slots))
    ids = ids + np.arange(num_slots) * (vocab // num_slots)
    dense = rng.standard_normal((batch, dense_dim)).astype(np.float32)
    logit = 0.5 * dense[:, 0] - 0.3 * dense[:, 1] + \
        0.1 * (ids[:, 0] % 7 - 3)
    label = (logit + rng.standard_normal(batch) >
             0).astype(np.float32)[:, None]
    return ids.astype(np.int64), dense, label


def write_ctr_files(dirname, n_examples, n_files=4, num_slots: int = 26,
                    dense_dim: int = 13, vocab: int = 1_000_000, seed=0):
    """Write synthetic CTR data as MultiSlot text files (data_feed.proto
    format): 26 single-id sparse slots, one dense slot, one label slot.
    Returns the filelist."""
    import os
    os.makedirs(dirname, exist_ok=True)
    per = n_examples // n_files
    files = []
    for fi in range(n_files):
        ids, dense, label = synthetic_ctr_batch(per, num_slots, dense_dim,
                                                vocab, seed=seed + fi)
        path = os.path.join(dirname, f"ctr_{fi:03d}.txt")
        with open(path, "w") as f:
            for r in range(per):
                parts = [f"1 {ids[r, s]}" for s in range(num_slots)]
                parts.append(f"{dense_dim} " +
                             " ".join(f"{v:.5f}" for v in dense[r]))
                parts.append(f"1 {int(label[r, 0])}")
                f.write(" ".join(parts) + "\n")
        files.append(path)
    return files


def ctr_dataset(filelist, batch_size, num_slots: int = 26,
                dense_dim: int = 13, kind="InMemoryDataset"):
    """An InMemoryDataset/QueueDataset over CTR MultiSlot files, slot
    schema matching write_ctr_files."""
    from ..distributed.dataset import InMemoryDataset, QueueDataset
    ds = (InMemoryDataset if kind == "InMemoryDataset" else QueueDataset)()
    ds.init(batch_size=batch_size, thread_num=4)
    slots = [{"name": f"C{s}", "type": "uint64"} for s in range(num_slots)]
    slots.append({"name": "dense", "type": "float", "is_dense": True,
                  "shape": (dense_dim,)})
    slots.append({"name": "label", "type": "uint64"})
    ds.set_slots(slots)
    ds.set_filelist(list(filelist))
    return ds


def batch_from_feed(feed, num_slots: int = 26):
    """Compose a dataset feed dict into (ids, dense, label) trainer arrays."""
    ids = np.concatenate([feed[f"C{s}"] for s in range(num_slots)], axis=1)
    dense = feed["dense"].astype(np.float32)
    label = feed["label"].astype(np.float32)
    return ids.astype(np.int64), dense, label


__all__ = ["WideDeep", "WideDeepTrainer", "CapturedStep",
           "synthetic_ctr_batch", "write_ctr_files", "ctr_dataset",
           "batch_from_feed", "load_jax_wide_deep", "sort_unique_static",
           "bce_with_logits_mean", "make_adam_update"]
