"""Transformer layers with the incremental and ring KV caches.

Counterpart of ``paddle_tpu/nn/layer/transformer.py``: MultiHeadAttention
(with Paddle's incremental ``Cache``, the cross-attention's
``StaticCache`` and the static-shape ring cache of the decode path),
TransformerEncoderLayer/Encoder, TransformerDecoderLayer/Decoder and the
encoder-decoder ``Transformer``, written as ``torch.nn.Module``s.
Parameter names match the JAX package's dotted paths one to one
(``q_proj.weight``, ``cross_attn.k_proj.bias``, ``norm3.weight``...),
so the weight bridge maps name to name.

The cached (serving) forward multiplies in fixed row chunks
(``cached_linears``, ``cached_linear`` and ``cached_ffn`` in
``nn/functional/common.py``): a row's projections then do not depend on
the rows batched with it, so a served row equals its batch-1
``generate()`` bit for bit, as the JAX package's rows are across pack
compositions.  A frozen int8 site computes its own exact product on the
real rows (the same helpers).  The training forward calls the
projections as modules.

Every projection and LayerNorm is the port's Paddle-signature ``Linear``
(Xavier-uniform weight, zero bias) and ``LayerNorm``, so one init rule
holds for a whole model, and every layer lands on CUDA unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import collections
import copy

import torch
import torch.nn.functional as F
from torch import nn

from ...framework.enforce import UnimplementedError
from ...framework.flags import flag
from ...framework.place import DeviceLike, module_device, resolve_device
from ..functional.attention import attention_bnsh, cached_attention
from ..functional.common import (cached_ffn, cached_linear, cached_linears,
                                 dropout)
from .common import Dropout, Linear, no_param_attrs
from .norm import LayerNorm


def ring_block_write(plane, new, pos, axis=None):
    """Write a ``T``-wide token block into a ``C``-long ring-buffer plane
    at the (already wrapped) position ``pos`` and return the plane.

    The write is IN PLACE: the cache planes belong to one generate call,
    and updating them in place keeps a decode step from copying the whole
    cache (the JAX form returns a new array and relies on XLA to alias
    it).  Columns ``(pos + arange(T)) % C`` receive the block, so a block
    crossing the ring boundary wraps to column 0; a block that does not
    wrap (every decode step's write) is one contiguous copy, without the
    launches that building the index would cost.  ``pos`` may also be a
    device tensor: a 0-d one (the position) or a 1-D int64 one of ``T``
    columns (the ring index, see ``ring_index``); then the columns are
    written through the index and nothing is read back to the host, so
    the write can be captured in a CUDA graph.  Shapes: ``plane [...,
    C, L]``, ``new [..., T, L]``; ``axis`` defaults to ``ndim - 2``.
    """
    ax = plane.ndim - 2 if axis is None else int(axis)
    C, T = plane.shape[ax], new.shape[ax]
    if T > C:
        raise ValueError(
            f"ring block of {T} tokens cannot fit a cache of length {C}")
    new = new.to(plane.dtype)
    if torch.is_tensor(pos):
        idx = pos if pos.ndim == 1 else ring_index(pos, T, C)
        plane.index_copy_(ax, idx, new)
        return plane
    pos = int(pos) % C
    if pos + T <= C:
        plane.narrow(ax, pos, T).copy_(new)
    else:
        idx = (pos + torch.arange(T, device=plane.device)) % C
        plane.index_copy_(ax, idx, new)
    return plane


def ring_index(pos, T, C):
    """The ring columns ``(pos + arange(T)) % C`` of a block written at
    the 0-d device tensor ``pos``, as the int64 index ``index_copy_``
    takes, built on ``pos``'s device."""
    return (pos.long() + torch.arange(T, device=pos.device)) % C


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
    # Paddle's incremental self-attention cache: the K/V of every token
    # so far, (B, N, t, H), grown by concatenation a step
    Cache = collections.namedtuple("Cache", ["k", "v"])
    # the cross-attention's projected memory K/V, used as it is
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])
    # static-shape decode cache: (B, N, max_len, H) ring buffers written
    # at an explicit cache_position
    RingCache = collections.namedtuple("RingCache", ["k", "v"])
    # int8 ring cache (FLAGS_kv_cache_dtype=int8): int8 rows plus
    # per-(token, head) f32 scale planes (B, N, max_len, 1)
    QuantRingCache = collections.namedtuple(
        "QuantRingCache", ["k", "v", "k_scale", "v_scale"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device: DeviceLike = None, dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if need_weights:
            raise UnimplementedError(
                "MultiHeadAttention(need_weights=True) is not ported: the "
                "flash kernels never form the attention weights, and the "
                "JAX package returns none either")
        no_param_attrs("MultiHeadAttention", weight_attr=weight_attr,
                       bias_attr=bias_attr)
        fk = dict(device=resolve_device(device), dtype=dtype)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, **fk)
        self.k_proj = Linear(self.kdim, embed_dim, **fk)
        self.v_proj = Linear(self.vdim, embed_dim, **fk)
        self.out_proj = Linear(embed_dim, embed_dim, **fk)

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim) \
            .transpose(1, 2)                                 # B N S H

    def _merge_heads(self, x):
        b, n, s, h = x.shape
        return x.transpose(1, 2).reshape(b, s, n * h)

    def gen_cache(self, key, value=None, type=None):
        """``type=StaticCache``: the projected K/V of ``key`` (the
        memory) and ``value`` (default ``key``), (B, N, S, H).
        Otherwise an empty incremental ``Cache`` (B, N, 0, H) in
        ``key``'s dtype and device."""
        if type == MultiHeadAttention.StaticCache:
            value = key if value is None else value
            return self.StaticCache(self._split_heads(self.k_proj(key)),
                                    self._split_heads(self.v_proj(value)))
        empty = (key.shape[0], self.num_heads, 0, self.head_dim)
        return self.Cache(
            torch.zeros(empty, dtype=key.dtype, device=key.device),
            torch.zeros(empty, dtype=key.dtype, device=key.device))

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
        q, k_new, v_new = (
            self._split_heads(t) for t in cached_linears(
                query, self.q_proj, self.k_proj, self.v_proj))
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
        return cached_linear(self._merge_heads(out), self.out_proj), cache

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, cache_position=None, decode_window=None):
        """Attention of ``query`` over ``key``/``value`` (default: the
        query itself).  With a ``StaticCache`` the cached memory K/V
        stand for key and value; with a ``Cache`` the new K/V are
        appended to it on the sequence axis and ``(out, cache)`` is
        returned; any other cache is a ring cache (the decode path,
        ``(out, cache)`` too)."""
        if cache is not None \
                and not isinstance(cache, (self.Cache, self.StaticCache)):
            return self._forward_ring(query, attn_mask, cache,
                                      cache_position, decode_window)
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if cache is not None:
                k = torch.cat([cache.k, k], dim=2)
                v = torch.cat([cache.v, v], dim=2)
                cache = self.Cache(k, v)
        out = attention_bnsh(q, k, v, attn_mask=attn_mask)
        # dropout on the attention OUTPUT, as the JAX layer does: the
        # flash kernels need no dropout of their own
        if self.dropout:
            out = dropout(out, self.dropout, training=self.training)
        out = self.out_proj(self._merge_heads(out))
        return (out, cache) if isinstance(cache, self.Cache) else out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, device: DeviceLike = None,
                 dtype=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **fk)
        self.linear1 = Linear(d_model, dim_feedforward, **fk)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **fk)
        self.norm1 = LayerNorm(d_model, 1e-5, **fk)
        self.norm2 = LayerNorm(d_model, 1e-5, **fk)
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
            src = cached_ffn(src, self.linear1,
                             lambda h: self.dropout(self.activation(h)),
                             self.linear2)
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
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, the others fresh clones), or, when ``encoder_layer`` is a
    list or tuple, those built blocks as they are (a heterogeneous stack
    such as GPTMoEModel's dense and MoE blocks; ``num_layers``, if
    given, must equal its length)."""

    def __init__(self, encoder_layer, num_layers=None, norm=None):
        super().__init__()
        if isinstance(encoder_layer, (list, tuple)):
            layers = list(encoder_layer)
            if num_layers is not None and int(num_layers) != len(layers):
                raise ValueError(
                    f"TransformerEncoder got {len(layers)} layers but "
                    f"num_layers={num_layers}")
        else:
            layers = [encoder_layer if i == 0 else _fresh_clone(encoder_layer)
                      for i in range(num_layers)]
        self.layers = nn.ModuleList(layers)
        self.num_layers = len(layers)
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


class TransformerDecoderLayer(nn.Module):
    """Self-attention over the target, cross-attention over the encoder's
    ``memory`` and the feed-forward block, each in a residual with its
    LayerNorm after it (post-norm) or before it (``normalize_before``).
    With a ``cache`` (``gen_cache``) the forward returns ``(tgt,
    (incremental Cache, StaticCache))``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        no_param_attrs("TransformerDecoderLayer", weight_attr=weight_attr,
                       bias_attr=bias_attr)
        fk = dict(device=resolve_device(device), dtype=dtype)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **fk)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **fk)
        self.linear1 = Linear(d_model, dim_feedforward, **fk)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **fk)
        self.norm1 = LayerNorm(d_model, 1e-5, **fk)
        self.norm2 = LayerNorm(d_model, 1e-5, **fk)
        self.norm3 = LayerNorm(d_model, 1e-5, **fk)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                              cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental, cache[1]))

    def gen_cache(self, memory):
        """(an empty incremental ``Cache``, the ``StaticCache`` of
        ``memory``'s projected K/V)."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(memory, memory,
                                          MultiHeadAttention.StaticCache))


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer if i == 0 else _fresh_clone(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One ``(Cache, StaticCache)`` a layer; ``do_zip`` regroups them
        as (the incremental caches, the static caches)."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(nn.Module):
    """The encoder-decoder Transformer: ``decoder(tgt, encoder(src))``.
    A final LayerNorm ends each stack only under ``normalize_before``.
    Lands on CUDA unless the caller passes ``device="cpu"``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *,
                 device: DeviceLike = None, dtype=None):
        super().__init__()
        no_param_attrs("Transformer", weight_attr=weight_attr,
                       bias_attr=bias_attr)
        fk = dict(device=resolve_device(device), dtype=dtype)
        layer_args = (d_model, nhead, dim_feedforward, dropout, activation,
                      attn_dropout, act_dropout, normalize_before)

        def final_norm():
            return LayerNorm(d_model, 1e-5, **fk) \
                if normalize_before else None

        self.encoder = custom_encoder if custom_encoder is not None \
            else TransformerEncoder(
                TransformerEncoderLayer(*layer_args, **fk),
                num_encoder_layers, final_norm())
        self.decoder = custom_decoder if custom_decoder is not None \
            else TransformerDecoder(
                TransformerDecoderLayer(*layer_args, **fk),
                num_decoder_layers, final_norm())
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The additive causal mask of a target of ``length`` tokens: f32
        (length, length), 0 on and below the diagonal and -1e30 above,
        on the module's device."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=module_device(self)).tril()
        return torch.zeros(keep.shape, dtype=torch.float32,
                           device=keep.device).masked_fill_(~keep, -1e30)
