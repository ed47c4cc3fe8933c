"""Attention functionals.

Counterpart of ``paddle_tpu/nn/functional/attention.py``.  Layout is
(B, N, S, H) inside, (B, S, N, H) at ``scaled_dot_product_attention``.
On CUDA tensors the non-cached attention (``attention_bnsh``, the
training path) runs the flash-attention kernels forward and backward;
a decode step with a contiguous validity window, and speculative
decoding's verify block with one window per query, the flash-decoding
kernels.  Prefill (``cached_attention`` with Tq > 1 under a mask), CPU
tensors and a trainable mask run the plain masked attention
(``_sdpa_fn`` / ``_sdpa_mask_fn``: f32 logits and softmax, probabilities
cast to q's dtype).
"""
from __future__ import annotations

import math

import torch

from ...framework.flags import flag
from ...ops.kernels import flash_attention as _fa
from ...ops.kernels import flash_decode as _fd

_NEG_INF = -1e30    # finite: a fully-masked row gets a uniform softmax,
                    # where -inf would give NaN and poison the cache


def _causal_keep(sq, sk, device):
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril(sk - sq)


def _sdpa_fn(q, k, v, scale=None, causal=False):
    """q, k, v: (B, N, S, H)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnsh,bnth->bnst", q.float(), k.float()) * s
    if causal:
        keep = _causal_keep(logits.shape[-2], logits.shape[-1], q.device)
        logits = logits.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,bnth->bnsh", probs.float(),
                        v.float()).to(q.dtype)


def _sdpa_mask_fn(q, k, v, mask, scale=None, causal=False):
    """:func:`_sdpa_fn` with an additive f32 ``mask`` broadcast against
    the (B, N, Sq, Sk) logits."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bnsh,bnth->bnst", q.float(), k.float()) * s
    logits = logits + mask.float()
    if causal:
        keep = _causal_keep(logits.shape[-2], logits.shape[-1], q.device)
        logits = logits.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnst,bnth->bnsh", probs.float(),
                        v.float()).to(q.dtype)


def _use_flash_decode(q, window):
    """Dispatch gate for the decode step: FLAGS_use_flash_decode, a
    contiguous [start, end) window (the kernel masks a window, not an
    arbitrary dense mask) and tensors on CUDA.  The TPU gate's S % 128
    condition is not asked: the kernels take any cache length, and a
    shape they do not take raises there instead of running plain."""
    return window is not None and q.is_cuda and flag("use_flash_decode")


def _window_mask(window, S, device):
    """The additive (B, 1, Tq, S) mask of a [start, end) window: ``end``
    is [B] (Tq = 1) or one end per query [B, Tq]."""
    start, end = window
    end = end.reshape(end.shape[0], -1)
    col = torch.arange(S, dtype=torch.int32, device=device)
    valid = (col >= start[:, None, None]) & (col < end[:, :, None])
    return torch.zeros(valid.shape, dtype=torch.float32, device=device) \
        .masked_fill_(~valid, _NEG_INF)[:, None]


def cached_attention(q, k, v, attn_mask=None, window=None, k_scale=None,
                     v_scale=None):
    """Incremental attention: (B, N, Tq, H) new-token queries over the
    full (B, N, S, H) KV ring cache.

    ``attn_mask`` is the additive validity+causality mask the caller built
    from cache_position and per-row start offsets; ``window`` is the
    ``(start[B], end)`` contiguous form of the same validity that a
    decode step (Tq == 1, ``end[B]``) or a verify block (one end per
    query, ``end[B, Tq]``) passes instead.  On CUDA the flash-decoding
    kernels take a windowed step or block (the block form computes each
    query as the step would; it raises on a shape it does not take);
    otherwise the plain masked attention runs, under the mask built from
    the window when no ``attn_mask`` was given.  With
    ``k_scale``/``v_scale`` (FLAGS_kv_cache_dtype=int8) k/v are int8 row
    planes: the kernel dequantizes inside its loop, the plain path
    dequantizes the cache first.
    """
    if _use_flash_decode(q, window):
        start, end = window
        if end.ndim == 2:                    # a verify block
            q = q.contiguous()
            if k_scale is not None:
                return _fd.flash_decode_quant_block(q, k, v, k_scale,
                                                    v_scale, start, end)
            return _fd.flash_decode_block(q, k, v, start, end)
        if k_scale is not None:
            return _fd.flash_decode_quant(q, k, v, k_scale, v_scale,
                                          start, end)
        return _fd.flash_decode(q, k, v, start, end)
    if k_scale is not None:
        from ..layer.transformer import dequantize_kv_rows
        k = dequantize_kv_rows(k, k_scale, dtype=q.dtype)
        v = dequantize_kv_rows(v, v_scale, dtype=q.dtype)
    if attn_mask is None and window is not None:
        attn_mask = _window_mask(window, k.shape[2], q.device)
    if attn_mask is not None:
        return _sdpa_mask_fn(q, k, v, attn_mask)
    return _sdpa_fn(q, k, v)


def _use_flash_attention(q, mask):
    """Dispatch gate of the non-cached attention: FLAGS_use_pallas_kernels,
    tensors on CUDA and no trainable mask (the kernel's bias gets no
    gradient).  The TPU gate's Sk >= 1024 crossover (MIN_SEQ_FOR_FLASH,
    measured on a v5e) and its S % 128 condition are not asked: the
    kernels take any length, and a shape they do not take raises there
    instead of running plain."""
    return q.is_cuda and flag("use_pallas_kernels") \
        and not (mask is not None and mask.requires_grad)


def attention_bnsh(q, k, v, attn_mask=None, is_causal=False):
    """(B, N, S, H) attention of the non-cached MultiHeadAttention."""
    if _use_flash_attention(q, attn_mask):
        return _fa.flash_attention(q, k, v, bias=attn_mask,
                                   causal=bool(is_causal))
    if attn_mask is not None:
        return _sdpa_mask_fn(q, k, v, attn_mask, causal=bool(is_causal))
    return _sdpa_fn(q, k, v, causal=bool(is_causal))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """Attention over (B, S, N, H) inputs (paddle-incubate's layout),
    through :func:`attention_bnsh`; dropout applies to the output, drawn
    from ``generator`` (default: the active one, see
    ``framework.random``)."""
    out = attention_bnsh(query.transpose(1, 2), key.transpose(1, 2),
                         value.transpose(1, 2), attn_mask=attn_mask,
                         is_causal=is_causal)
    if dropout_p and training:
        from .common import dropout
        out = dropout(out, dropout_p, training=training, generator=generator)
    return out.transpose(1, 2)
