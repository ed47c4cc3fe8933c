"""Transformer layers with the static-shape KV ring cache.

Counterpart of ``paddle_tpu/nn/layer/transformer.py`` (MultiHeadAttention
with its ring-cache decode path, TransformerEncoderLayer and
TransformerEncoder), written as ``torch.nn.Module``s.  Parameter names
match the JAX package's dotted paths one to one (``q_proj.weight``,
``linear1.bias``, ``norm2.weight``...), so the weight bridge maps name
to name.

The cached (serving) forward multiplies in fixed row chunks
(``pad_rows``, ``rows_linear``, ``batch_invariant_linear`` in
``nn/functional/common.py``): a row's projections then do not depend on
the rows batched with it, so a served row equals its batch-1
``generate()`` bit for bit, as the JAX package's rows are across pack
compositions.  The training forward keeps plain ``nn.Linear`` calls.
"""
from __future__ import annotations

import collections
import copy

import torch
import torch.nn.functional as F
from torch import nn

from ...framework.flags import flag
from ..functional.attention import attention_bnsh, cached_attention
from ..functional.common import (batch_invariant_linear, dropout, pad_rows,
                                 rows_linear)
from .common import Dropout


def ring_block_write(plane, new, pos, axis=None):
    """Write a ``T``-wide token block into a ``C``-long ring-buffer plane
    at the (already wrapped) position ``pos`` and return the plane.

    The write is IN PLACE: the cache planes belong to one generate call,
    and updating them in place keeps a decode step from copying the whole
    cache (the JAX form returns a new array and relies on XLA to alias
    it).  Columns ``(pos + arange(T)) % C`` receive the block, so a block
    crossing the ring boundary wraps to column 0; a block that does not
    wrap (every decode step's write) is one contiguous copy, without the
    launches that building the index would cost.  Shapes: ``plane [...,
    C, L]``, ``new [..., T, L]``; ``axis`` defaults to ``ndim - 2``.
    """
    ax = plane.ndim - 2 if axis is None else int(axis)
    C, T = plane.shape[ax], new.shape[ax]
    if T > C:
        raise ValueError(
            f"ring block of {T} tokens cannot fit a cache of length {C}")
    pos = int(pos) % C
    new = new.to(plane.dtype)
    if pos + T <= C:
        plane.narrow(ax, pos, T).copy_(new)
    else:
        idx = (pos + torch.arange(T, device=plane.device)) % C
        plane.index_copy_(ax, idx, new)
    return plane


def quantize_kv_rows(x):
    """Per-(token, head) symmetric int8 quantization of a K/V block
    ``[B, N, T, H]``: one f32 scale per head-row.  Returns (int8 rows
    ``[B, N, T, H]``, f32 scales ``[B, N, T, 1]``).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-9)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv_rows(q, scale, dtype=None):
    """Inverse of :func:`quantize_kv_rows`."""
    out = q.float() * scale
    return out if dtype is None else out.to(dtype)


class MultiHeadAttention(nn.Module):
    # static-shape decode cache: (B, N, max_len, H) ring buffers written
    # at an explicit cache_position
    RingCache = collections.namedtuple("RingCache", ["k", "v"])
    # int8 ring cache (FLAGS_kv_cache_dtype=int8): int8 rows plus
    # per-(token, head) f32 scale planes (B, N, max_len, 1)
    QuantRingCache = collections.namedtuple(
        "QuantRingCache", ["k", "v", "k_scale", "v_scale"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, device=None,
                 dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        fk = dict(device=device, dtype=dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.q_proj = nn.Linear(embed_dim, embed_dim, **fk)
        self.k_proj = nn.Linear(embed_dim, embed_dim, **fk)
        self.v_proj = nn.Linear(embed_dim, embed_dim, **fk)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **fk)

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim) \
            .transpose(1, 2)                                 # B N S H

    def _merge_heads(self, x):
        b, n, s, h = x.shape
        return x.transpose(1, 2).reshape(b, s, n * h)

    def gen_ring_cache(self, batch, max_len, dtype=torch.float32,
                       device=None):
        """Zero-initialized ring cache (B, N, max_len, H); under
        ``FLAGS_kv_cache_dtype=int8`` int8 rows plus f32 scale planes."""
        rows = (batch, self.num_heads, max_len, self.head_dim)
        if str(flag("kv_cache_dtype")).lower() == "int8":
            scales = (batch, self.num_heads, max_len, 1)
            return self.QuantRingCache(
                torch.zeros(rows, dtype=torch.int8, device=device),
                torch.zeros(rows, dtype=torch.int8, device=device),
                torch.zeros(scales, dtype=torch.float32, device=device),
                torch.zeros(scales, dtype=torch.float32, device=device))
        return self.RingCache(torch.zeros(rows, dtype=dtype, device=device),
                              torch.zeros(rows, dtype=dtype, device=device))

    def _forward_ring(self, query, attn_mask, cache, cache_position,
                      decode_window):
        """Project the new tokens, write their K/V into the ring at
        ``cache_position`` and attend the new queries over the whole cache
        under the caller's validity mask.  Returns (out, cache)."""
        # the three projections share one row-padded copy of the input
        xp, n = pad_rows(query)
        q, k_new, v_new = (
            self._split_heads(rows_linear(xp, p.weight, p.bias)[:n]
                              .reshape(*query.shape[:-1], -1))
            for p in (self.q_proj, self.k_proj, self.v_proj))
        if isinstance(cache, self.QuantRingCache):
            kq, ks = quantize_kv_rows(k_new)
            vq, vs = quantize_kv_rows(v_new)
            cache = self.QuantRingCache(
                ring_block_write(cache.k, kq, cache_position),
                ring_block_write(cache.v, vq, cache_position),
                ring_block_write(cache.k_scale, ks, cache_position),
                ring_block_write(cache.v_scale, vs, cache_position))
            out = cached_attention(q, cache.k, cache.v, attn_mask=attn_mask,
                                   window=decode_window,
                                   k_scale=cache.k_scale,
                                   v_scale=cache.v_scale)
        else:
            cache = self.RingCache(
                ring_block_write(cache.k, k_new, cache_position),
                ring_block_write(cache.v, v_new, cache_position))
            out = cached_attention(q, cache.k, cache.v, attn_mask=attn_mask,
                                   window=decode_window)
        if self.dropout:
            out = dropout(out, self.dropout, training=self.training)
        return batch_invariant_linear(self._merge_heads(out),
                                      self.out_proj.weight,
                                      self.out_proj.bias), cache

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, cache_position=None, decode_window=None):
        if cache is not None:
            return self._forward_ring(query, attn_mask, cache,
                                      cache_position, decode_window)
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = attention_bnsh(q, k, v, attn_mask=attn_mask)
        # dropout on the attention OUTPUT, as the JAX layer does: the
        # flash kernels need no dropout of their own
        if self.dropout:
            out = dropout(out, self.dropout, training=self.training)
        return self.out_proj(self._merge_heads(out))


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **fk)
        self.linear1 = nn.Linear(d_model, dim_feedforward, **fk)
        self.dropout = Dropout(act_dropout)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **fk)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, **fk)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, **fk)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)     # gelu: exact (erf)

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
        if cache is None:
            src = self.linear2(self.dropout(self.activation(
                self.linear1(src))))
        else:
            # the FFN stays row-padded from linear1's input to linear2's
            # output: one padding copy for both GEMMs
            hp, n = pad_rows(src)
            h = rows_linear(hp, self.linear1.weight, self.linear1.bias)
            h = rows_linear(self.dropout(self.activation(h)),
                            self.linear2.weight, self.linear2.bias)
            src = h[:n].reshape(src.shape)
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_ring_cache(self, batch, max_len, dtype=torch.float32,
                       device=None):
        return self.self_attn.gen_ring_cache(batch, max_len, dtype, device)


def _fresh_clone(layer):
    """A deep copy with freshly initialized parameters (Paddle's clone
    re-initializes; a plain deepcopy would start every layer equal)."""
    new = copy.deepcopy(layer)
    for m in new.modules():
        if m is not new and hasattr(m, "reset_parameters"):
            m.reset_parameters()
    return new


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer if i == 0 else _fresh_clone(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None, cache_position=None,
                decode_window=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, new_cache = mod(output, src_mask, cache[i],
                                        cache_position=cache_position,
                                        decode_window=decode_window)
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_ring_cache(self, batch, max_len, dtype=torch.float32,
                       device=None):
        """Per-layer ring caches for incremental decode."""
        return [layer.gen_ring_cache(batch, max_len, dtype, device)
                for layer in self.layers]
