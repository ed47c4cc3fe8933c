"""Static-cap owner bucketing for Mixture-of-Experts dispatch on one device.

Counterpart of the expert half of ``paddle_tpu/ops/routing.py``: the
layout helpers of a row-partitioned table (``rows_per_shard``,
``storage_table_rows``, ``storage_index``, ``pad_requests``), the
static-shape owner bucketing (``pack_by_owner``), the MoE dispatch plan
built on it (``moe_capacity``, ``expert_dispatch_plan``), the meshless
expert application (``local_experts``) and the ring models of the
all-to-all wire bytes.

Layout contract, as in the JAX package: a table of ``vocab`` rows over
``n`` shards stores ``rps = ceil(vocab / n)`` real rows plus one scratch
row a shard; logical id ``i`` lives on shard ``i // rps``.  Bucketing is
static-shape: requests are grouped by owner into an ``[n * cap]`` send
buffer whose one extra tail slot absorbs every dropped or sentinel write,
so no write needs a select against a real slot.  MoE routes token rows
with owner = expert (``rps = 1``): each group's assignments fill at most
``cap`` slots an expert, in arrival order, and the rest drop.

Ties and order follow the JAX package exactly: the owner sort is stable
(``torch.argsort(stable=True)``, as ``jnp.argsort`` is), and an
assignment's rank within its owner is its position minus the first
position of its owner in the sorted order (``torch.searchsorted(side=
"left")``).  So the plan is a pure function of the ids, the same on the
CPU and the card, and the routed and dense-dispatch paths drop the same
assignments.

The movers between devices (``all_to_all_experts`` and the embedding
movers ``all_to_all_gather``/``_set``/``_apply_rule``) need more than
one device and raise :class:`UnimplementedError` (ROADMAP A11).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..framework.enforce import UnimplementedError

__all__ = [
    "PackPlan", "rows_per_shard", "storage_table_rows", "storage_index",
    "pad_requests", "pack_by_owner", "all_to_all_gather", "all_to_all_set",
    "all_to_all_apply_rule", "a2a_wire_bytes",
    "ExpertPlan", "moe_capacity", "expert_dispatch_plan",
    "all_to_all_experts", "local_experts", "moe_a2a_wire_bytes",
]


def rows_per_shard(vocab: int, n_shards: int) -> int:
    """Real rows each shard owns for a ``vocab``-row table."""
    return max(1, -(-int(vocab) // int(n_shards)))


def storage_table_rows(vocab: int, n_shards: int) -> int:
    """Global row count of the storage array (with the scratch rows)."""
    return (rows_per_shard(vocab, n_shards) + 1) * int(n_shards)


def storage_index(ids, rps: int):
    """Logical id -> row of the ``[(rps + 1) * n, D]`` storage array
    (numpy arrays or tensors; ids must be >= 0)."""
    owner = ids // rps
    return owner * (rps + 1) + (ids - owner * rps)


def pad_requests(n: int, n_shards: int, pad) -> int:
    """Octave-pad a request count (``pad`` is the octave function) and
    round it up to a multiple of the shard count."""
    base = max(int(n_shards), int(pad(max(1, n))))
    return -(-base // n_shards) * n_shards


class PackPlan(NamedTuple):
    """Static-shape owner bucketing of a request slice (leading batch
    dimensions ``...`` as given)."""

    send_ids: Optional[torch.Tensor]  # [..., n*cap] int32 by owner, -1 pad
    pos: torch.Tensor                 # [..., u] int32 slot (-1 = dropped)
    counts: torch.Tensor              # [..., n] int32 per-owner requests
    overflow: Optional[torch.Tensor]  # bool: some owner's count > cap


def pack_by_owner(ids, *, n_shards: int, rps: int, cap: int,
                  with_send: bool = True) -> PackPlan:
    """Group the requests ``ids [..., u]`` by owner shard along the last
    axis into ``[..., n * cap]`` send buffers.  Sentinel ids (< 0) never
    consume cap.  ``with_send=False`` skips the send buffer and the
    overflow flag (``send_ids`` and ``overflow`` are None): the MoE plan
    counts its drops from ``pos``."""
    ids = ids.to(torch.int32)
    u = ids.shape[-1]
    valid = ids >= 0
    # sentinels sort after every real owner, so the grouped prefix is dense
    owner = torch.where(valid, torch.div(ids, rps, rounding_mode="floor"),
                        torch.full_like(ids, n_shards))
    order = torch.argsort(owner, dim=-1, stable=True)
    so = torch.gather(owner, -1, order).contiguous()
    first = torch.searchsorted(so, so, side="left").to(torch.int32)
    rank = torch.arange(u, dtype=torch.int32, device=ids.device) - first
    ok = (so < n_shards) & (rank < cap)
    # the +1 tail slot absorbs every dropped write.  On the card the
    # writes that land there collide and their order is unspecified;
    # the slot is sliced off, so nothing reads it
    tail = n_shards * cap
    slot = torch.where(ok, so * cap + rank, torch.full_like(so, tail))
    send = None
    if with_send:
        send = torch.full(ids.shape[:-1] + (tail + 1,), -1,
                          dtype=torch.int32, device=ids.device)
        send.scatter_(-1, slot.long(), torch.gather(ids, -1, order))
        send = send[..., :-1]
    pos = torch.full_like(ids, -1).scatter_(
        -1, order, torch.where(ok, slot, torch.full_like(slot, -1)))
    counts = torch.zeros(ids.shape[:-1] + (n_shards,), dtype=torch.int32,
                         device=ids.device).scatter_add_(
        -1, owner.clamp(0, n_shards - 1).long(), valid.to(torch.int32))
    overflow = (counts.max() > cap) if with_send else None
    return PackPlan(send, pos, counts, overflow)


def _scatter_to_slots(values, pos, n_slots):
    """Place row ``i`` of ``values`` at slot ``pos[i]`` of an
    ``[n_slots, ...]`` buffer of zeros (``pos`` -1: dropped).  Every
    dropped row is written to one extra tail slot, which is sliced off;
    kept slots are unique, so each receives exactly one row."""
    buf = values.new_zeros((n_slots + 1,) + tuple(values.shape[1:]))
    slot = torch.where(pos >= 0, pos, torch.full_like(pos, n_slots))
    return buf.index_put((slot.long(),), values)[:-1]


def _needs_mesh(name):
    raise UnimplementedError(
        f"ops.routing.{name} moves rows between devices and is not ported "
        "yet (ROADMAP A11): this slice runs MoE on one device, through "
        "local_experts")


def all_to_all_gather(arrays: Sequence, ids, *, mesh, axis: str, rps: int,
                      cap: Optional[int] = None):
    """Routed multi-array row lookup over a mesh axis: not ported."""
    _needs_mesh("all_to_all_gather")


def all_to_all_set(arrays: Sequence, ids, rows: Sequence, *, mesh,
                   axis: str, rps: int, cap: Optional[int] = None):
    """Routed row import over a mesh axis: not ported."""
    _needs_mesh("all_to_all_set")


def all_to_all_apply_rule(table, state: dict, ids, grads, *, opt: str,
                          hyper: dict, mesh, axis: str, rps: int,
                          cap: Optional[int] = None):
    """Routed sparse-optimizer update over a mesh axis: not ported."""
    _needs_mesh("all_to_all_apply_rule")


def moe_capacity(tokens_per_group: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Static slot count a (group, expert): ``ceil(cf * tokens * k /
    E)``, at least 1.  1.0 is the exactly balanced budget, 1.25 the usual
    head-room."""
    t = int(tokens_per_group) * int(top_k)
    return max(1, -(-int(t * float(capacity_factor)) // int(n_experts)))


class ExpertPlan(NamedTuple):
    """A group's static dispatch plan, a pure function of the expert
    ids, shared by the routed path and the dense-dispatch control."""

    pos: torch.Tensor      # [G, S] slot in the group's [E*cap] buffer
    counts: torch.Tensor   # [G, E] pre-drop demand per expert
    dropped: torch.Tensor  # [G] int32 assignments past capacity


def expert_dispatch_plan(expert_ids, *, n_experts: int,
                         cap: int) -> ExpertPlan:
    """Owner-bucket each group's assignments ``expert_ids [G, S]``
    (entries in ``[0, E)``; sentinels < 0 never consume cap) into
    ``[E * cap]`` slots: :func:`pack_by_owner` with owner = expert
    (``rps = 1``), over the groups at once."""
    eids = torch.as_tensor(expert_ids).to(torch.int32)
    plan = pack_by_owner(eids, n_shards=int(n_experts), rps=1, cap=int(cap),
                         with_send=False)
    kept = (plan.pos >= 0).sum(-1, dtype=torch.int32)
    valid = (eids >= 0).sum(-1, dtype=torch.int32)
    return ExpertPlan(plan.pos, plan.counts, valid - kept)


def all_to_all_experts(x_dup, pos, expert_params: Sequence, expert_fn, *,
                       mesh, axis: str, n_experts: int, cap: int):
    """Routed expert application over a mesh axis (two all-to-alls):
    not ported."""
    _needs_mesh("all_to_all_experts")


def local_experts(x_dup, pos, expert_params: Sequence, expert_fn, *,
                  n_experts: int, cap: int):
    """Expert application on one device: scatter the assignment rows
    ``x_dup [S, D]`` to their slots (``pos`` from
    :func:`expert_dispatch_plan`, one group), run ``expert_fn(rows [E,
    cap, D], *expert_params)`` over the stacked experts, gather the
    results back in assignment order; a dropped assignment reads zeros."""
    E = int(n_experts)
    p = pos.reshape(-1)
    buf = _scatter_to_slots(x_dup, p, E * cap)
    rows = buf.reshape((E, cap) + tuple(buf.shape[1:]))
    out = expert_fn(rows, *expert_params)
    flat = out.reshape((E * cap,) + tuple(out.shape[2:]))
    got = flat[p.clamp(0, E * cap - 1).long()]
    keep = (p >= 0).reshape((-1,) + (1,) * (got.ndim - 1))
    return torch.where(keep, got, torch.zeros((), dtype=got.dtype,
                                              device=got.device))


def moe_a2a_wire_bytes(n_experts: int, cap: int, dim: int, n_shards: int,
                       itemsize: int = 4) -> int:
    """Ring-model bytes a device sends in one MoE layer's two
    all-to-alls (tokens out, results back): each leg moves the ``[E,
    cap, D]`` buffer, of which ``(n - 1) / n`` crosses the wire; 0 on one
    shard."""
    n = int(n_shards)
    if n <= 1:
        return 0
    leg = int(n_experts) * int(cap) * int(dim) * int(itemsize)
    return int(2 * leg * (n - 1) / n)


def a2a_wire_bytes(n_requests: int, dim: int, n_shards: int, cap: int,
                   itemsize: int = 4, n_planes: int = 1) -> int:
    """Ring-model bytes a device sends in one routed gather: the ids out
    and their row planes back; 0 on one shard."""
    n = int(n_shards)
    if n <= 1:
        return 0
    buf_ids = n * cap * 4
    buf_rows = n * cap * dim * itemsize * n_planes
    return int((buf_ids + buf_rows) * (n - 1) / n)
