"""Flash-decoding: single-query attention over a long cached context.

Counterpart of ``paddle_tpu/ops/pallas/flash_decode.py``.  The decode
step issues ONE query row per sequence against the whole KV ring cache;
the CUDA kernels (``csrc/flash_decode.cu``) take each (sequence*head)
row in one thread-block cluster of up to 4 blocks, each over a span of
the cached context.  A block brings the live rows of its span into
shared memory with Hopper bulk copies (a 3-stage ring of 8 KB chunks),
computes a partial attention with an online softmax, and rank 0 of the
cluster merges the partials exactly, in rank order, in its shared
memory:

    g = max_r m_r,   out = sum_r acc_r e^(m_r - g) / sum_r l_r e^(m_r - g)

One launch per call, no scratch in device memory, no atomics.

Row ``b``'s valid cache columns are ``[start[b], end[b])`` (the ring is
left-padded per row); columns outside it are never read (the plain
versions mask them with the finite ``-1e30``).  Layout: q ``(B, N, 1,
H)``, k/v ``(B, N, S, H)``.

``flash_decode`` and ``flash_decode_quant`` launch their kernel on CUDA
tensors and count each launch in their ``launches`` attribute.  On CPU
tensors they compute the plain PyTorch version instead, which is also
what the kernels are held against.  On CUDA they never fall back: an
input the kernel does not take raises.  The kernels take any cache
length S and head_dim in {64, 128, 256}; ``supports_decode`` keeps the
TPU kernel's gate, which also asks S % 128 == 0, for comparison with
the JAX package only.
"""
from __future__ import annotations

import math
import threading

import torch

from . import _build

_HEAD_DIMS = (64, 128, 256)  # one kernel instance per head_dim
_NEG_INF = -1e30            # finite mask value: exp(s - m) underflows to 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# serving workers launch from several threads; the counters' += is a
# read-modify-write
_COUNT_LOCK = threading.Lock()


def supports_decode(q_shape, k_shape, block: int = 128) -> bool:
    """The TPU kernel's shape gate: (B, N, 1, H) query vs (B, N, S, H)
    cache with S a multiple of ``block`` and H in {64, 128, 256}.  The
    CUDA kernels do not need the S condition and do not consult it."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    if q_shape[-2] != 1:
        return False                      # single-query decode only
    if q_shape[0] != k_shape[0] or q_shape[1] != k_shape[1]:
        return False
    if q_shape[-1] != k_shape[-1] or q_shape[-1] not in _HEAD_DIMS:
        return False
    return k_shape[-2] % block == 0


# -- plain versions -----------------------------------------------------------

def _window(start, end, B, S, device):
    lo = torch.zeros(B, dtype=torch.int32, device=device) if start is None \
        else torch.as_tensor(start, dtype=torch.int32, device=device)
    hi = torch.full((B,), S, dtype=torch.int32, device=device) \
        if end is None \
        else torch.as_tensor(end, dtype=torch.int32, device=device)
    return lo, hi


def decode_attention_reference(q, k, v, start=None, end=None):
    """One masked softmax attention over the full cache, f32 logits and
    accumulation, probabilities cast to q's dtype before the PV product
    (the numerics contract of ``decode_attention_reference`` in JAX).
    Returns ``(B, N, Sq, H)`` in q's dtype."""
    B, N, Sq, H = q.shape
    S = k.shape[2]
    logits = torch.einsum("bnsh,bnth->bnst", q.float(), k.float()) \
        * (1.0 / math.sqrt(H))
    lo, hi = _window(start, end, B, S, q.device)
    col = torch.arange(S, dtype=torch.int32, device=q.device)
    valid = (col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None])
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,bnth->bnsh", probs.float(),
                        v.float()).to(q.dtype)


def dequantize_kv(q8, scales, dtype=torch.float32):
    """Dequantize int8 KV rows with their per-(token, head) scales."""
    return (q8.float() * scales).to(dtype)


def flash_decode_plain(q, k, v, start=None, end=None):
    """The plain version of :func:`flash_decode`."""
    return decode_attention_reference(q, k, v, start, end)


def flash_decode_quant_plain(q, k, v, k_scale, v_scale, start=None,
                             end=None):
    """The plain version of :func:`flash_decode_quant`: attention in f32
    over the dequantized cache (the int8 kernel keeps p in f32 too),
    cast to q's dtype."""
    out = decode_attention_reference(
        q.float(), dequantize_kv(k, k_scale), dequantize_kv(v, v_scale),
        start, end)
    return out.to(q.dtype)


# -- kernel wrappers ----------------------------------------------------------

def _check_cuda(name, q, tensors):
    """Validate what the kernel takes; raise on anything else."""
    dev = q.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are on {dev}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    for tname, t, dtypes in tensors:
        # q is read, and k, v and the scales are bulk-copied, in 16-byte
        # pieces from 16-byte boundaries
        align = t.element_size() if tname in ("start", "end") else 16
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {tname} has dtype {t.dtype}, "
                            f"the kernel takes {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {tname} must start on a "
                             f"{align}-byte boundary")


def _shapes(name, q, k, v):
    """What the kernels take: q (B, N, 1, H), k and v (B, N, S, H) with
    S >= 1 and H in {64, 128, 256}."""
    if q.ndim != 4 or k.ndim != 4 or q.shape[-2] != 1:
        raise ValueError(f"{name} takes a (B, N, 1, H) query, "
                         f"got {tuple(q.shape)}")
    B, N, _, H = q.shape
    if tuple(k.shape[:2]) != (B, N) or k.shape[-1] != H or k.shape[2] < 1 \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)}")
    if H not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {H} is not one the kernel is "
                         f"built for {_HEAD_DIMS}; set "
                         "FLAGS_use_flash_decode=False to run plain "
                         "attention")
    return B, N, k.shape[2], H


def _launch(name, fn, q, ptrs, B, N, S, H):
    out = torch.empty_like(q)
    rc = fn(*ptrs, out.data_ptr(), B * N, N, S, H, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    return out


def flash_decode(q, k, v, start=None, end=None):
    """Flash decoding.  q ``(B, N, 1, H)``; k/v ``(B, N, S, H)`` of q's
    dtype (f32 or bf16); ``start``/``end`` int32 ``[B]`` bound the valid
    cache window per row (defaults: the full cache).  Returns ``(B, N,
    1, H)`` in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, start, end)
    B, N, S, H = _shapes("flash_decode", q, k, v)
    lo, hi = _window(start, end, B, S, q.device)
    _check_cuda("flash_decode", q,
                [("q", q, tuple(_DTYPE_CODE)), ("k", k, (q.dtype,)), ("v", v, (q.dtype,)),
                 ("start", lo, (torch.int32,)), ("end", hi, (torch.int32,))])
    lib = _build.library("flash_decode")
    out = _launch("flash_decode", lib.flash_decode_launch, q,
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), lo.data_ptr(),
                   hi.data_ptr()], B, N, S, H)
    with _COUNT_LOCK:
        flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_quant(q, k, v, k_scale, v_scale, start=None, end=None):
    """Flash decoding over an int8-quantized KV ring cache.  q ``(B, N,
    1, H)`` f32 or bf16; k/v ``(B, N, S, H)`` int8 rows; ``k_scale`` /
    ``v_scale`` ``(B, N, S, 1)`` f32 per-(token, head) scales.  The
    dequantization happens inside the kernel as rows are loaded, so the
    cache streams at one byte per element.  Returns ``(B, N, 1, H)`` in
    q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_quant_plain(q, k, v, k_scale, v_scale, start,
                                        end)
    B, N, S, H = _shapes("flash_decode_quant", q, k, v)
    if tuple(k_scale.shape) != (B, N, S, 1) \
            or tuple(v_scale.shape) != (B, N, S, 1):
        raise ValueError("flash_decode_quant: scales must be "
                         f"{(B, N, S, 1)}, got {tuple(k_scale.shape)} and "
                         f"{tuple(v_scale.shape)}")
    lo, hi = _window(start, end, B, S, q.device)
    _check_cuda("flash_decode_quant", q,
                [("q", q, tuple(_DTYPE_CODE)), ("k", k, (torch.int8,)),
                 ("v", v, (torch.int8,)),
                 ("k_scale", k_scale, (torch.float32,)),
                 ("v_scale", v_scale, (torch.float32,)),
                 ("start", lo, (torch.int32,)), ("end", hi, (torch.int32,))])
    lib = _build.library("flash_decode")
    out = _launch("flash_decode_quant", lib.flash_decode_quant_launch, q,
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   k_scale.data_ptr(), v_scale.data_ptr(), lo.data_ptr(),
                   hi.data_ptr()], B, N, S, H)
    with _COUNT_LOCK:
        flash_decode_quant.launches += 1
    return out


flash_decode_quant.launches = 0
