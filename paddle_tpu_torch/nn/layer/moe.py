"""Mixture-of-Experts layers on one device.

Counterpart of ``paddle_tpu/nn/layer/moe.py``:

* top-k softmax gating (k in {1, 2}) over a gate projection; k = 2
  renormalizes the chosen pair (GShard), k = 1 keeps the raw top-1
  probability (Switch).  Ties go to the lower expert index, as
  ``lax.top_k`` breaks them: ``torch.topk`` promises no order on ties,
  so the top k come from a stable descending sort;
* capacity-factor dispatch: each routing group parks at most ``cap =
  ceil(cf * tokens * k / E)`` assignments on one expert, in arrival
  order, and the rest drop (the token keeps its residual) and are
  counted (``ops/routing.py``);
* the expert FFNs as stacked parameters (``experts.w1 [E, D, H]``,
  ``b1 [E, H]``, ``w2 [E, H, D]``, ``b2 [E, D]``), applied as batched
  matmuls over ``[E, cap, D]`` slot rows;
* the auxiliary load-balance loss, ``E * sum_e mean-gate_e *
  fraction-routed_e`` per group, computed lazily from the last forward's
  gating outputs and added to the model loss (``total_aux_loss``).

``dispatch="routed"`` scatters the assignment rows into the expert
slots and gathers the results back (``ops.routing.local_experts``);
``dispatch="dense"`` is the GShard dense-dispatch control, which
multiplies every token against every (expert, slot) through a one-hot
mask built from the same plan.  The two give the same bits, forward and
backward: a slot holds at most one token, and ``x * 1 + sum of 0`` is
exact in f32, as long as the matmuls run in f32 (TF32 off on the card).
The JAX package needs two more primitives for that contract, because
XLA's fusion reassociates across shapes: a GELU whose backward is an
explicit elementwise formula (``_exact_gelu``, kept here as a
``torch.autograd.Function``), and an optimization barrier around the
dispatch (``_isolate``), which is dropped here: eager PyTorch runs each
operation as written and fuses nothing across it.

On a mesh whose expert axis has more than one device the routed path
needs the all-to-all, which is not ported (ROADMAP A11): its forward
raises.  Each forward writes its drop count and per-expert load ratios
into the ``_moe_dropped``/``_moe_load`` buffers, in place (``TrainStep``
passes buffers through ``torch.func.functional_call``, where rebinding
an attribute would be lost); :func:`publish_moe_metrics` flushes them
into the typed registry.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ...framework import flags as _flags
from ...framework.enforce import InvalidArgumentError, UnimplementedError
from ...framework.place import DeviceLike, module_device, resolve_device
from ...ops import routing as _routing
from ...profiler.metrics import default_registry as _registry
from .common import Dropout, Linear
from .layers import Layer
from .norm import LayerNorm
from .transformer import MultiHeadAttention

__all__ = [
    "MoELayer", "MoEEncoderLayer", "ExpertFFN", "top_k_gating",
    "load_balance_loss", "moe_layers", "total_aux_loss",
    "publish_moe_metrics", "moe_axis", "moe_top_k", "moe_capacity_factor",
]

MOE_DROPPED = _registry().counter(
    "moe_tokens_dropped_total",
    "Token-to-expert assignments dropped past the per-expert capacity "
    "(the routed token keeps its residual); flushed from the layers' "
    "counters by nn.layer.moe.publish_moe_metrics.",
    labels=("model",))
MOE_LOAD = _registry().histogram(
    "moe_expert_load_ratio",
    "Per-expert routed load as a multiple of the balanced share (1.0 = "
    "perfectly balanced; above capacity_factor implies drops); one "
    "observation per expert per publish_moe_metrics flush.",
    labels=("model",),
    buckets=(0.1, 0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 2.0, 3.0, 5.0))

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


class _ExactGelu(torch.autograd.Function):
    """Exact (erf) GELU whose backward is the explicit elementwise
    ``Phi(x) + x * phi(x)``, the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (0.5 * (1.0 + torch.erf(x * _SQRT_HALF)))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        phi = 0.5 * (1.0 + torch.erf(x * _SQRT_HALF))
        dens = torch.exp(-0.5 * x * x) * _INV_SQRT_2PI
        return g * (phi + x * dens)


def _exact_gelu(x):
    return _ExactGelu.apply(x)


def moe_axis() -> str:
    return str(_flags.flag("moe_axis"))


def moe_top_k() -> int:
    return int(_flags.flag("moe_top_k"))


def moe_capacity_factor() -> float:
    return float(_flags.flag("moe_capacity_factor"))


def gate_from_logits(logits, k: int):
    """Softmax and top-k over gate logits ``[U, E]``.  Returns ``(probs
    [U, E] f32, expert_ids [U, k] int32, gates [U, k] f32)``; ties break
    toward the lower expert index."""
    if int(k) not in (1, 2):
        raise InvalidArgumentError(
            f"top-k gating supports k in {{1, 2}}, got {k} "
            "(FLAGS_moe_top_k)")
    probs = torch.softmax(logits.float(), dim=-1)
    vals, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, eids = vals[:, :int(k)], eids[:, :int(k)]
    gates = vals / vals.sum(-1, keepdim=True) if int(k) > 1 else vals
    return probs, eids.to(torch.int32), gates


def top_k_gating(x2d, gate_w, k: int, mesh=None):
    """:func:`gate_from_logits` over ``x2d [U, D] @ gate_w [D, E]`` in
    f32 (``gate_w`` in Paddle's [in, out] layout).  ``mesh`` is accepted
    for the JAX signature; one device needs no pinning."""
    logits = torch.matmul(x2d.float(), gate_w.float())
    return gate_from_logits(logits, k)


def load_balance_loss(probs, expert_ids, n_groups: int):
    """``E * mean_g sum_e fraction-routed_{g,e} * mean-gate_{g,e}``:
    1.0 at a perfectly uniform assignment, E when every token goes to one
    expert.  Pre-capacity fractions: the loss shapes the gate, the
    capacity enforces the budget."""
    U, E = probs.shape
    G = int(n_groups)
    mean_gate = probs.float().reshape(G, U // G, E).mean(1)          # [G, E]
    onehot = F.one_hot(expert_ids.reshape(G, -1).long(), E).float()
    frac = onehot.mean(1)                                            # [G, E]
    return float(E) * (frac * mean_gate).sum(-1).mean()


class ExpertFFN(Layer):
    """The expert bank: one two-layer FFN per expert, stored as stacked
    parameters ``w1 [E, D, H]``, ``b1 [E, H]``, ``w2 [E, H, D]``, ``b2
    [E, D]`` (Xavier-uniform weights, zero biases)."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: str = "gelu", *, device: DeviceLike = None,
                 dtype=None):
        super().__init__()
        if activation not in ("gelu", "relu"):
            raise InvalidArgumentError(
                f"unsupported MoE expert activation {activation!r}")
        self.num_experts = int(num_experts)
        self.d_model = int(d_model)
        self.d_hidden = int(d_hidden)
        self.activation = activation
        E, D, H = self.num_experts, self.d_model, self.d_hidden
        kw = dict(dtype=dtype, device=device)
        self.w1 = self.create_parameter([E, D, H], **kw)
        self.b1 = self.create_parameter([E, H], is_bias=True, **kw)
        self.w2 = self.create_parameter([E, H, D], **kw)
        self.b2 = self.create_parameter([E, D], is_bias=True, **kw)

    def stack_fn(self):
        """``(rows [e, m, D], w1, b1, w2, b2) -> [e, m, D]``: independent
        of other experts and other rows, so the routed slots and the
        dense control's compute the same rows."""
        act = _exact_gelu if self.activation == "gelu" else torch.relu

        def fn(rows, w1, b1, w2, b2):
            h = act(torch.bmm(rows, w1) + b1[:, None, :].to(rows.dtype))
            return torch.bmm(h, w2) + b2[:, None, :].to(rows.dtype)
        return fn

    def raw_params(self):
        return (self.w1, self.b1, self.w2, self.b2)


class MoELayer(Layer):
    """Top-k gated, capacity-dispatched expert FFN: ``forward(x [..., D])
    -> [..., D]``.  Dropped assignments contribute zero; the surrounding
    residual is their passthrough.  ``dispatch`` is ``"routed"`` (scatter
    to the expert slots and gather back) or ``"dense"`` (the GShard
    one-hot control).  Lands on CUDA unless the caller passes
    ``device="cpu"``."""

    def __init__(self, d_model: int, d_hidden: Optional[int] = None,
                 num_experts: int = 8, top_k: Optional[int] = None,
                 capacity_factor: Optional[float] = None, mesh=None,
                 axis: Optional[str] = None, activation: str = "gelu",
                 dispatch: str = "routed", annotate: bool = True,
                 gate_attr=None, *, device: DeviceLike = None, dtype=None):
        super().__init__()
        if dispatch not in ("routed", "dense"):
            raise InvalidArgumentError(
                f"MoELayer dispatch must be 'routed' or 'dense', "
                f"got {dispatch!r}")
        self.d_model = int(d_model)
        self.d_hidden = int(d_hidden if d_hidden is not None
                            else 4 * d_model)
        self.num_experts = int(num_experts)
        self.top_k = int(top_k if top_k is not None else moe_top_k())
        self.capacity_factor = float(
            capacity_factor if capacity_factor is not None
            else moe_capacity_factor())
        if self.top_k not in (1, 2):
            raise InvalidArgumentError(
                f"MoE top_k must be 1 or 2, got {self.top_k}")
        if self.capacity_factor <= 0:
            raise InvalidArgumentError(
                f"MoE capacity_factor must be > 0, "
                f"got {self.capacity_factor}")
        if self.num_experts < 1:
            raise InvalidArgumentError("num_experts must be >= 1")
        self.dispatch = dispatch
        self.axis = axis or moe_axis()
        self.mesh = mesh
        if self.mesh is None:
            from ...parallel.mesh import get_mesh, has_mesh
            if has_mesh():
                self.mesh = get_mesh()
        n = 1
        if self.mesh is not None:
            n = int(self.mesh.shape.get(self.axis, 1))
        if n > 1 and self.num_experts % n:
            raise InvalidArgumentError(
                f"num_experts ({self.num_experts}) must divide by the "
                f"{self.axis!r} axis size ({n}): each shard owns a whole "
                "number of experts")
        self.n_shards = n
        dev = resolve_device(device)
        self.gate = Linear(self.d_model, self.num_experts,
                           weight_attr=gate_attr, bias_attr=False,
                           device=dev, dtype=dtype)
        self.experts = ExpertFFN(self.num_experts, self.d_model,
                                 self.d_hidden, activation, device=dev,
                                 dtype=dtype)
        self._aux = None
        self._aux_in = None
        self.register_buffer("_moe_dropped",
                             torch.zeros((), dtype=torch.float32, device=dev))
        self.register_buffer("_moe_load",
                             torch.zeros((self.num_experts,),
                                         dtype=torch.float32, device=dev))

    def capacity_for(self, n_tokens: int) -> int:
        """Slot count a (group, expert) for an ``n_tokens`` forward."""
        return _routing.moe_capacity(n_tokens // self.n_shards,
                                     self.top_k, self.num_experts,
                                     self.capacity_factor)

    def _dense_rows(self, x_dup, pos, cap):
        """The dense-dispatch control: one-hot every assignment against
        the ``[E * cap]`` slots of its group and multiply tokens in and
        results out.  Its slot buffers, and so the expert inputs, outputs
        and every gradient, equal the routed path's bit for bit."""
        E, G = self.num_experts, self.n_shards
        D = x_dup.shape[-1]
        slots = E * cap
        xg = x_dup.reshape(G, -1, D)
        onehot = (pos[..., None] == torch.arange(
            slots, dtype=pos.dtype, device=pos.device)).to(x_dup.dtype)
        buf = torch.einsum("gts,gtd->gsd", onehot, xg)       # [G, slots, D]
        ebuf = buf.reshape(G, E, cap, D).transpose(0, 1) \
            .reshape(E, G * cap, D)
        y = self.experts.stack_fn()(ebuf, *self.experts.raw_params())
        ybuf = y.reshape(E, G, cap, D).transpose(0, 1).reshape(G, slots, D)
        out = torch.einsum("gts,gsd->gtd", onehot, ybuf)     # [G, S, D]
        return out.reshape(-1, D)

    def forward(self, x):
        D = x.shape[-1]
        if D != self.d_model:
            raise InvalidArgumentError(
                f"MoELayer(d_model={self.d_model}) got inputs of "
                f"width {D}")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, D)
        U = x2.shape[0]
        n, k, E = self.n_shards, self.top_k, self.num_experts
        if U % n:
            raise InvalidArgumentError(
                f"MoE routing over axis {self.axis!r} (size {n}) needs "
                f"the token count ({U}) divisible by the axis size: pad "
                "the batch to a multiple")
        if n > 1 and self.dispatch == "routed":
            raise UnimplementedError(
                f"MoELayer over a {n}-device {self.axis!r} axis needs the "
                "all-to-all expert exchange, which is not ported yet "
                "(ROADMAP A11): use a one-device mesh")
        probs, eids, gates = top_k_gating(x2, self.gate.weight.t(), k)
        cap = self.capacity_for(U)
        plan = _routing.expert_dispatch_plan(
            eids.reshape(n, (U // n) * k), n_experts=E, cap=cap)
        x_dup = x2.repeat_interleave(k, dim=0)               # [U*k, D]
        if self.dispatch == "dense":
            rows = self._dense_rows(x_dup, plan.pos, cap)
        else:
            rows = _routing.local_experts(
                x_dup, plan.pos, self.experts.raw_params(),
                self.experts.stack_fn(), n_experts=E, cap=cap)
        out = (rows.reshape(U, k, D) * gates[..., None].to(rows.dtype)) \
            .sum(1)
        # the aux loss is computed on first use (aux_loss), so a forward
        # whose caller never asks for it (inference) does not pay for it
        self._aux_in = (probs, eids, n)
        self._aux = None
        with torch.no_grad():
            self._moe_dropped.copy_(plan.dropped.sum())
            self._moe_load.copy_(plan.counts.sum(0).float() * float(E)
                                 / float(U * k))
        return out.reshape(tuple(lead) + (D,)).to(x.dtype)

    def aux_loss(self):
        """The load-balance loss of the last forward (None before one)."""
        if self._aux is None and self._aux_in is not None:
            probs, eids, n = self._aux_in
            self._aux = load_balance_loss(probs, eids, n)
        return self._aux

    def wire_bytes(self, n_tokens: int, itemsize: int = 4) -> int:
        """Ring-model bytes a device sends in this layer's two
        all-to-alls for an ``n_tokens`` forward: 0 on one shard."""
        return _routing.moe_a2a_wire_bytes(
            self.num_experts, self.capacity_for(n_tokens), self.d_model,
            self.n_shards, itemsize)

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"experts={self.num_experts}, top_k={self.top_k}, "
                f"capacity_factor={self.capacity_factor}, "
                f"axis={self.axis!r}, shards={self.n_shards}, "
                f"dispatch={self.dispatch!r}")


class MoEEncoderLayer(Layer):
    """TransformerEncoderLayer with its FFN replaced by a
    :class:`MoELayer`: the same attention, norm and cache contract (the
    ring cache of incremental decode included)."""

    def __init__(self, d_model, nhead, dim_feedforward, num_experts,
                 dropout=0.1, activation="gelu", attn_dropout=None,
                 act_dropout=None, normalize_before=True, top_k=None,
                 capacity_factor=None, mesh=None, axis=None,
                 dispatch="routed", annotate=True, *,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **fk)
        self.moe = MoELayer(d_model, dim_feedforward, num_experts,
                            top_k=top_k, capacity_factor=capacity_factor,
                            mesh=mesh, axis=axis, activation=activation,
                            dispatch=dispatch, annotate=annotate, **fk)
        self.norm1 = LayerNorm(d_model, 1e-5, **fk)
        self.norm2 = LayerNorm(d_model, 1e-5, **fk)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, src, src_mask=None, cache=None, cache_position=None,
                decode_window=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache,
                                        cache_position=cache_position,
                                        decode_window=decode_window)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        # a dropped assignment returns a zero row: the residual add is
        # the capacity overflow's passthrough
        src = residual + self.dropout2(self.moe(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)

    def gen_ring_cache(self, batch, max_len, dtype=torch.float32,
                       device=None):
        return self.self_attn.gen_ring_cache(batch, max_len, dtype, device)


def moe_layers(layer) -> Sequence[MoELayer]:
    """Every MoELayer of a model (the model itself included), in
    traversal order."""
    return [m for m in layer.modules() if isinstance(m, MoELayer)]


def total_aux_loss(layer):
    """Sum of the MoE layers' load-balance losses of the last forward (a
    0-d zero when the model has none or none has run)."""
    terms = [t for t in (m.aux_loss() for m in moe_layers(layer))
             if t is not None]
    if not terms:
        return torch.zeros((), dtype=torch.float32,
                           device=module_device(layer) or "cpu")
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def publish_moe_metrics(layer, model: str = "moe"):
    """Flush the layers' drop and load buffers into the registry:
    ``moe_tokens_dropped_total{model}`` grows by the summed drops and
    ``moe_expert_load_ratio{model}`` gets one observation per expert.
    Returns ``(dropped_total, load_ratios)``."""
    dropped = 0.0
    loads = []
    for m in moe_layers(layer):
        dropped += float(m._moe_dropped)
        loads.extend(m._moe_load.tolist())
    if dropped:
        MOE_DROPPED.labels(model=model).inc(dropped)
    h = MOE_LOAD.labels(model=model)
    for v in loads:
        h.observe(float(v))
    return dropped, loads
