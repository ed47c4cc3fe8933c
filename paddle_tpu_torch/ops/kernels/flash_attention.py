"""Flash attention: blockwise softmax attention with its backward.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``.  Layout is
(B, N, S, H).  The forward keeps an online softmax over tiles of keys, so
the (Sq, Sk) score matrix never reaches device memory, and returns the
output and the f32 row logsumexp ``lse`` (B, N, Sq); the backward
recomputes ``p = exp(s - lse)`` per tile:

    dd = rowsum(dO * O)          ds = p * (dO V^T - dd) * scale
    dQ = ds K      dK = ds^T Q   dV = p^T dO

An optional additive ``bias`` broadcasts as (Bb in {1, B}, Nb in {1, N},
1 or Sq, Sk); causal masking is bottom-right aligned (query row i sees
keys <= i + Sk - Sq) with the finite -1e30.  The bias gets no gradient.

Each kernel is a registered operator (``torch.library.custom_op``):
``paddle_tpu_torch::flash_attention_fwd`` (kernel B1,
``csrc/flash_attention.cu``; returns o and lse),
``paddle_tpu_torch::flash_attention_dq`` and
``paddle_tpu_torch::flash_attention_dkv`` (B2).  The CUDA implementation
of each launches its kernel and counts the launch in
``flash_attention.launches_fwd``, ``launches_dq`` or ``launches_dkv``;
the CPU implementation is the plain version, which is also what the
kernels are held against.  A fake implementation gives each output's
shape, dtype and strides, so ``torch.export`` (``jit.save``) traces an
attention call to one operator node, which a loaded program calls again
(the ``ctypes`` launch itself cannot run on fake tensors).
:func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` call the
operators; :func:`flash_attention` calls the forward one, whose gradient
(``register_autograd``) calls the two backward ones.

The dtype picks the kernel: bf16 runs the tensor-core kernels
(``mma.sync``, p and ds rounded to bf16 where they become operands,
exactly as the plain versions round them); f32 runs the forward on the
tensor cores in split TF32 (each f32 operand taken as two TF32 halves,
three products summed in f32) and the backward as f32 FMAs.  On
CUDA nothing falls back: a head_dim the kernels are not built for (64,
128, 256) or a dtype other than f32/bf16 raises, and a view whose start
or strides are not 16-byte aligned is copied first.
The kernels take any Sq and Sk; :func:`supports` keeps the TPU kernel's
gate (S a multiple of 128) for comparison with the JAX package only.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import _build

_HEAD_DIMS = (64, 128, 256)   # one kernel instance per head_dim
_NEG_INF = -1e30             # finite mask value: exp(s - lse) underflows
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COUNT_LOCK = threading.Lock()   # counters' += is a read-modify-write


def supports(q_shape, k_shape, bias_shape=None, block: int = 128,
             causal: bool = False) -> bool:
    """The TPU kernel's shape gate: (B, N, S, H) with both S multiples of
    ``block``, H in {64, 128, 256}, Sq <= Sk when causal and a bias
    broadcastable over batch and heads.  The CUDA kernels do not need
    the S condition and do not consult it."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    Sq, H = q_shape[-2], q_shape[-1]
    Sk = k_shape[-2]
    if Sq % block or Sk % block:
        return False
    if causal and Sq > Sk:
        return False
    if H not in _HEAD_DIMS:
        return False
    if bias_shape is not None:
        if len(bias_shape) != 4 or bias_shape[-1] != Sk:
            return False
        if bias_shape[-2] not in (1, Sq):
            return False
        if bias_shape[0] not in (1, q_shape[0]):
            return False
        if bias_shape[1] not in (1, q_shape[1]):
            return False
    return True


# -- plain versions -----------------------------------------------------------

def _logits(q, k, bias, causal, scale):
    """f32 scaled logits (B, N, Sq, Sk) with bias and the causal mask."""
    s = torch.einsum("bnsh,bnth->bnst", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_reference(q, k, v, bias=None, causal=False, scale=None):
    """The kernel's forward in one dense pass: f32 logits and softmax
    state, p = exp(s - m) rounded to V's dtype before PV, the l == 0
    guard.  Returns (o in q's dtype, lse f32 (B, N, Sq))."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = _logits(q, k, bias, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bnst,bnth->bnsh", p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_reference(q, k, v, bias, o, lse, do, causal=False,
                        scale=None):
    """The backward kernels' formulas in one dense pass: p = exp(s - lse)
    from f32 logits, dd = rowsum(dO * O), ds = p (dP - dd) scale; p
    rounded to dO's dtype before dV, ds to K's before dQ and to Q's
    before dK.  Returns (dq, dk, dv) in the inputs' dtypes."""
    return _bwd_plain(q, k, v, bias, lse, do, flash_dd(o, do), causal,
                      scale)


def _bwd_plain(q, k, v, bias, lse, do, dd, causal, scale, parts="qkv"):
    """The backward from lse and dd; ``parts`` picks which of dq ("q"),
    dk ("k") and dv ("v") to compute (the plain version of each kernel
    computes only its own).  Returns a tuple in that order."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    p = torch.exp(_logits(q, k, bias, causal, scale) - lse[..., None])
    dof = do.float()
    out = []
    if "q" in parts or "k" in parts:
        dp = torch.einsum("bnsh,bnth->bnst", dof, v.float())
        ds = p * (dp - dd[..., None]) * scale
    if "q" in parts:
        out.append(torch.einsum("bnst,bnth->bnsh", ds.to(k.dtype).float(),
                                k.float()).to(q.dtype))
    if "k" in parts:
        out.append(torch.einsum("bnst,bnsh->bnth", ds.to(q.dtype).float(),
                                q.float()).to(k.dtype))
    if "v" in parts:
        out.append(torch.einsum("bnst,bnsh->bnth", p.to(do.dtype).float(),
                                dof).to(v.dtype))
    return tuple(out)


def flash_dd(o, do):
    """dd = rowsum(dO * O) in f32, (B, N, Sq): one torch reduction, as
    XLA computed it outside the Pallas kernels."""
    return (do.float() * o.float()).sum(-1).contiguous()


# -- kernel wrappers ----------------------------------------------------------

def _bias4(bias, B, N, Sq, Sk):
    """The bias as a 4-d tensor broadcast to (B, N, Sq, Sk) (stride 0 on
    its broadcast dims), or None; raises on a shape that does not
    broadcast as the TPU kernel's bias does."""
    if bias is None:
        return None
    while bias.ndim < 4:
        bias = bias[None]
    Bb, Nb, Sb, Kb = bias.shape
    if Bb not in (1, B) or Nb not in (1, N) or Sb not in (1, Sq) \
            or Kb != Sk:
        raise ValueError(f"flash_attention: bias {tuple(bias.shape)} does "
                         f"not broadcast to {(B, N, Sq, Sk)}")
    return bias.expand(B, N, Sq, Sk)


def _strided(t, dtype, name):
    """``t`` in the layout the kernels read: head_dim contiguous, the
    other strides and the start multiples of 16 bytes (f32: 4 elements,
    bf16: 8; the tensor-core kernels copy 16-byte pieces of rows with
    cp.async, the f32 backward loads 4 floats in one access).  A tensor in another
    layout is copied into fresh memory, contiguous and aligned."""
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} has dtype {t.dtype}, "
                        f"q has {dtype}")
    align = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % align for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _bhsd_empty(B, N, S, H, like):
    """An output (B, N, S, H) stored as (B, S, N, H): its heads merge
    back to (B, S, N*H) without a copy."""
    return torch.empty((B, S, N, H), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _dims(B, N, Sq, Sk, H, *tensors, bias=None):
    """The kernels' int64 dims array: sizes, then (batch, head, seq)
    strides of q, k, v, dO, o/dQ, dK, dV (zeros for an absent one), then
    the bias strides."""
    vals = [B, N, Sq, Sk, H]
    for t in tensors:
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    vals += [0, 0, 0, 0] if bias is None else list(bias.stride())
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _shapes(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes (B, N, S, H) q, k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, N, Sq, H = q.shape
    if tuple(k.shape[:2]) != (B, N) or k.shape[-1] != H:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    Sk = k.shape[2]
    if causal and Sq > Sk:
        raise ValueError(
            f"causal flash attention requires Sq <= Sk, got {Sq} > {Sk} "
            "(use the plain attention path)")
    return B, N, Sq, Sk, H


def _prepare(q, k, v, bias, causal):
    """Validate what the kernels take; returns the shapes, q/k/v in a
    layout the kernels read and the bias broadcast to (B, N, Sq, Sk) f32."""
    B, N, Sq, Sk, H = _shapes(q, k, v, causal)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype} is not one the "
                        f"kernels take {tuple(_DTYPE_CODE)}")
    if H not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {H} is not one the "
                         f"kernels are built for {_HEAD_DIMS}; set "
                         "FLAGS_use_pallas_kernels=False to run plain "
                         "attention")
    if q.device.index != torch.cuda.current_device() \
            or k.device != q.device or v.device != q.device \
            or (bias is not None and bias.device != q.device):
        raise ValueError("flash_attention: tensors must all be on the "
                         "current CUDA device")
    q, k, v = (_strided(t, q.dtype, n) for t, n in ((q, "q"), (k, "k"),
                                                    (v, "v")))
    b4 = _bias4(None if bias is None else bias.float(), B, N, Sq, Sk)
    return (B, N, Sq, Sk, H), q, k, v, b4


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _launch_fwd(q, k, v, bias, causal, scale):
    """Launch B1 on CUDA tensors: (o (B, N, Sq, H) stored as (B, Sq, N, H),
    lse f32 (B, N, Sq))."""
    (B, N, Sq, Sk, H), q, k, v, b4 = _prepare(q, k, v, bias, causal)
    o = _bhsd_empty(B, N, Sq, H, q)
    lse = torch.empty((B, N, Sq), dtype=torch.float32, device=q.device)
    dims = _dims(B, N, Sq, Sk, H, q, k, v, None, o, None, None, bias=b4)
    _check("flash_attention forward",
           _build.library("flash_attention").flash_attn_fwd_launch(
               q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(b4),
               o.data_ptr(), lse.data_ptr(), ctypes.addressof(dims), scale,
               int(causal), _DTYPE_CODE[q.dtype], _stream()))
    with _COUNT_LOCK:
        flash_attention.launches_fwd += 1
    return o, lse


def _bwd_launch(fn, name, q, k, v, bias, lse, do, dd, causal, scale, outs):
    (B, N, Sq, Sk, H), q, k, v, b4 = _prepare(q, k, v, bias, causal)
    do = _strided(do.to(q.dtype), q.dtype, "dO")
    if tuple(do.shape) != (B, N, Sq, H):
        raise ValueError(f"flash_attention: dO {tuple(do.shape)} does not "
                         f"match q {(B, N, Sq, H)}")
    # the kernels index lse and dd as contiguous f32 (B*N, Sq)
    lse, dd = (t.float().contiguous() for t in (lse, dd))
    if tuple(lse.shape) != (B, N, Sq) or tuple(dd.shape) != (B, N, Sq):
        raise ValueError(f"flash_attention: lse {tuple(lse.shape)} and dd "
                         f"{tuple(dd.shape)} must be {(B, N, Sq)}")
    grads = {"dq": None, "dk": None, "dv": None}
    for o in outs:
        grads[o] = _bhsd_empty(B, N, Sk if o != "dq" else Sq, H, q)
    dims = _dims(B, N, Sq, Sk, H, q, k, v, do, grads["dq"], grads["dk"],
                 grads["dv"], bias=b4)
    _check(name, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(b4),
                    do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                    *(grads[o].data_ptr() for o in outs),
                    ctypes.addressof(dims), scale, int(causal),
                    _DTYPE_CODE[q.dtype], _stream()))
    return [grads[o] for o in outs]


# -- the registered operators -------------------------------------------------
#
# One operator per kernel.  CUDA: the launch (or an error: nothing falls
# back).  CPU: the plain version, made contiguous so that its strides are
# the fake implementation's.  Fake: shapes, dtypes and the strides each
# device's implementation returns (CUDA stores o, dQ, dK and dV as
# (B, S, N, H)).

def _like_out(q, B, N, S, H):
    if q.device.type == "cuda":
        return _bhsd_empty(B, N, S, H, q)
    return q.new_empty((B, N, S, H))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch_fwd(q, k, v, bias, causal, scale)


@_fwd_op.register_kernel("cpu")
def _fwd_cpu(q, k, v, bias, causal, scale):
    _shapes(q, k, v, causal)
    o, lse = flash_fwd_reference(q, k, v, bias, causal, scale)
    return o.contiguous(), lse.contiguous()


@_fwd_op.register_fake
def _fwd_fake(q, k, v, bias, causal, scale):
    B, N, Sq, _, H = _shapes(q, k, v, causal)
    return (_like_out(q, B, N, Sq, H),
            q.new_empty((B, N, Sq), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_dq",
                         mutates_args=(), device_types="cuda")
def _dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor], lse: torch.Tensor,
           do: torch.Tensor, dd: torch.Tensor, causal: bool,
           scale: float) -> torch.Tensor:
    lib = _build.library("flash_attention")
    dq, = _bwd_launch(lib.flash_attn_dq_launch, "flash_attention dQ", q, k,
                      v, bias, lse, do, dd, causal, scale, ("dq",))
    with _COUNT_LOCK:
        flash_attention.launches_dq += 1
    return dq


@_dq_op.register_kernel("cpu")
def _dq_cpu(q, k, v, bias, lse, do, dd, causal, scale):
    return _bwd_plain(q, k, v, bias, lse, do, dd, causal, scale,
                      "q")[0].contiguous()


@_dq_op.register_fake
def _dq_fake(q, k, v, bias, lse, do, dd, causal, scale):
    B, N, Sq, _, H = _shapes(q, k, v, causal)
    return _like_out(q, B, N, Sq, H)


@torch.library.custom_op("paddle_tpu_torch::flash_attention_dkv",
                         mutates_args=(), device_types="cuda")
def _dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], lse: torch.Tensor,
            do: torch.Tensor, dd: torch.Tensor, causal: bool,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = _build.library("flash_attention")
    dk, dv = _bwd_launch(lib.flash_attn_dkv_launch, "flash_attention dK/dV",
                         q, k, v, bias, lse, do, dd, causal, scale,
                         ("dk", "dv"))
    with _COUNT_LOCK:
        flash_attention.launches_dkv += 1
    return dk, dv


@_dkv_op.register_kernel("cpu")
def _dkv_cpu(q, k, v, bias, lse, do, dd, causal, scale):
    dk, dv = _bwd_plain(q, k, v, bias, lse, do, dd, causal, scale, "kv")
    return dk.contiguous(), dv.contiguous()


@_dkv_op.register_fake
def _dkv_fake(q, k, v, bias, lse, do, dd, causal, scale):
    B, N, _, Sk, H = _shapes(q, k, v, causal)
    return _like_out(k, B, N, Sk, H), _like_out(k, B, N, Sk, H)


def _fwd_setup(ctx, inputs, output):
    q, k, v, bias, causal, scale = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, bias, o, lse)
    ctx.causal, ctx.scale = causal, scale


def _fwd_backward(ctx, do, _dlse):
    q, k, v, bias, o, lse = ctx.saved_tensors
    args = (q, k, v, bias, lse, do, flash_dd(o, do), ctx.causal, ctx.scale)
    dq = _dq_op(*args)
    dk, dv = _dkv_op(*args)
    # the bias is not differentiable here (JAX returns zeros for it)
    return dq, dk, dv, None, None, None


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


# -- entry points -------------------------------------------------------------

def flash_fwd(q, k, v, bias=None, causal=False, scale=None):
    """Kernel B1: returns (o (B, N, Sq, H), on CUDA stored as (B, Sq, N,
    H), lse f32 (B, N, Sq)); on CPU tensors the plain version."""
    return _fwd_op(q, k, v, bias, bool(causal), _scale(q, scale))


def flash_bwd_dq(q, k, v, bias, lse, do, dd, causal=False, scale=None):
    """Kernel B2, dQ: one block per query tile sweeping the key tiles; on
    CPU tensors the plain version."""
    return _dq_op(q, k, v, bias, lse, do, dd, bool(causal), _scale(q, scale))


def flash_bwd_dkv(q, k, v, bias, lse, do, dd, causal=False, scale=None):
    """Kernel B2, dK and dV: one block per key tile sweeping the query
    tiles; on CPU tensors the plain version."""
    return tuple(_dkv_op(q, k, v, bias, lse, do, dd, bool(causal),
                         _scale(q, scale)))


def flash_attention(q, k, v, bias=None, causal=False, scale=None):
    """Flash attention on (B, N, S, H) tensors of one dtype (f32 or bf16
    on CUDA), with an optional additive ``bias`` (f32 or q's dtype) and
    bottom-right ``causal`` masking; ``scale`` defaults to 1/sqrt(H).
    Differentiable in q, k and v.  Returns (B, N, Sq, H) in q's dtype."""
    return flash_fwd(q, k, v, bias, causal, scale)[0]


flash_attention.launches_fwd = 0
flash_attention.launches_dq = 0
flash_attention.launches_dkv = 0
