"""GPT-style decoder-only LM (causal transformer).

Counterpart of ``paddle_tpu/text/models/gpt.py`` (``GPTConfig`` and
``GPTModel``).  The default config is GPT-2 small.  ``forward_cached``
is the incremental step over the static-shape KV ring cache that
``text.generation`` drives.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...framework.place import DeviceLike, resolve_device
from ...nn.functional.common import batch_invariant_linear
from ...nn.functional.loss import cross_entropy
from ...nn.layer.common import Dropout
from ...nn.layer.transformer import (TransformerEncoder,
                                     TransformerEncoderLayer, ring_index)

_NEG_INF = -1e30    # finite mask value: see nn/functional/attention.py
_HEAD_ALIGN = 128   # LM-head rows are padded to a multiple of this


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    dropout: float = 0.1

    @classmethod
    def tiny(cls, vocab_size=128, hidden_size=32, layers=2, heads=2, seq=64):
        return cls(vocab_size=vocab_size, hidden_size=hidden_size,
                   num_layers=layers, num_heads=heads,
                   intermediate_size=hidden_size * 4,
                   max_position_embeddings=seq)


class GPTModel(nn.Module):
    """Decoder-only LM with a tied LM head.  ``device`` defaults to CUDA
    and raises without a card; pass ``device="cpu"`` to run on the
    host."""

    def __init__(self, cfg: GPTConfig = None, *, device: DeviceLike = None,
                 dtype: torch.dtype = None, **kwargs):
        super().__init__()
        cfg = cfg or GPTConfig(**kwargs)
        fk = dict(device=resolve_device(device), dtype=dtype)
        self.config = cfg
        # The tied LM head reads the embedding through a zero-padded
        # block of rows (a multiple of 128) that shares its storage.  At
        # the unaligned width 50257 cuBLAS picks different kernels for
        # different batch sizes, and one row's logits move by a bf16 ulp
        # with the batch it rides; at an aligned width they do not
        # (chip_smoke.py measures both).  The serving path also multiplies
        # it in fixed row chunks (batch_invariant_linear).  Row-independent
        # logits are what makes a served decode equal a batch-1
        # generate() token for token.
        rows = -(-cfg.vocab_size // _HEAD_ALIGN) * _HEAD_ALIGN
        head = torch.zeros((rows, cfg.hidden_size), **fk)
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                _weight=head[:cfg.vocab_size])
        self.wte.reset_parameters()      # _weight skips the default init
        self.register_buffer("_lm_head", head, persistent=False)
        self.wpe = nn.Embedding(cfg.max_position_embeddings,
                                cfg.hidden_size, **fk)
        self.drop = Dropout(cfg.dropout)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.dropout, activation="gelu", normalize_before=True,
            **fk)
        self.encoder = TransformerEncoder(
            layer, cfg.num_layers,
            norm=nn.LayerNorm(cfg.hidden_size, eps=1e-5, **fk))

    @torch.no_grad()
    def _tie_weights(self):
        """Point the embedding back at the first rows of a zero-padded
        head block of its own dtype and device.  ``amp.decorate`` calls
        this after it casts the parameters, which gives the embedding
        storage of its own; the Parameter object stays the same."""
        w = self.wte.weight
        head = w.new_zeros(self._lm_head.shape)
        head[:self.config.vocab_size] = w
        w.data = head[:self.config.vocab_size]
        self._lm_head = head

    def _logits(self, h, rows_invariant=False):
        if self._lm_head.data_ptr() != self.wte.weight.data_ptr():
            raise RuntimeError(
                "the LM head no longer shares the embedding's storage "
                "(the model was copied with .to()/.cuda()); build it with "
                "the device and dtype it should run in, or cast it with "
                "amp.decorate")
        head = batch_invariant_linear if rows_invariant else F.linear
        return head(h, self._lm_head)[..., :self.config.vocab_size]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """GPT-2's initialization drawn from ``generator`` (on the
        model's device): N(0, std) for embeddings and Linear weights,
        zero biases, unit LayerNorm scales."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def forward(self, input_ids, labels=None):
        b, s = input_ids.shape
        dev = input_ids.device
        pos = torch.arange(s, device=dev)[None, :]
        h = self.drop(self.wte(input_ids) + self.wpe(pos))
        causal = torch.full((s, s), -1e4, dtype=torch.float32,
                            device=dev).triu(1)
        h = self.encoder(h, causal[None, None])
        logits = self._logits(h)
        if labels is None:
            return logits
        return cross_entropy(
            logits[:, :-1].reshape(-1, self.config.vocab_size),
            labels[:, 1:].reshape(-1))

    # -- incremental decoding (static-shape KV ring cache) -------------------
    def init_cache(self, batch, max_len, dtype=None):
        """Per-layer zero ring caches [batch, heads, max_len, head_dim] on
        the model's device, in the model's dtype unless given."""
        w = self.wte.weight
        return self.encoder.gen_ring_cache(
            batch, max_len, w.dtype if dtype is None else dtype, w.device)

    def forward_cached(self, input_ids, cache, cache_position,
                       start_positions, verify=False):
        """One incremental step over the ring cache.

        ``input_ids`` [B, T]: the LEFT-padded prompt at prefill, one token
        per row at decode; ``cache_position`` is the cache column the
        first new token writes, an int or a 0-d int32 tensor on the
        model's device; ``start_positions`` int32 [B] is each row's first
        valid cache column.  Token positions and the additive
        validity+causality mask derive from those two.  With a tensor
        position nothing is read back to the host (the slot loop's step
        is captured in a CUDA graph, ``text/graphs.py``) and the result
        is the int path's, bit for bit.  The cache planes are updated in
        place.  ``verify`` marks a block of ``T`` tokens as speculative
        decoding's verify block: its attention takes one window per
        query, ``[start, pos + t + 1)``, which on the card runs each
        query through the decode kernel exactly as a one-token step at
        that position would (text/speculative.py); the chunked prefill
        keeps the masked path.  Returns (logits [B, T, V], cache).
        """
        b, t = input_ids.shape
        dev = input_ids.device
        C = cache[0].k.shape[2]
        start = start_positions
        if torch.is_tensor(cache_position):
            pos = cache_position.to(torch.int32)
            ring = ring_index(pos, t, C)
        else:
            pos = int(cache_position)
            ring = pos % C
        row = pos + torch.arange(t, dtype=torch.int32, device=dev)
        pos_ids = (row[None, :] - start[:, None]).clamp(
            0, self.config.max_position_embeddings - 1)
        h = self.drop(self.wte(input_ids) + self.wpe(pos_ids))
        mask = window = None
        if verify:
            # each query's window ends after its own column, exactly the
            # window of a one-token step at pos + t
            window = (start, (row + 1)[None, :].expand(b, t).contiguous())
        elif t == 1:
            # decode step: validity is the contiguous [start, pos+1)
            # window; the kernel takes it as is, and the plain path
            # builds its mask from it only when it runs
            end = (pos + 1).expand(b).contiguous() if torch.is_tensor(pos) \
                else torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
            window = (start, end)
        else:
            # valid key col j for query row i: start_b <= j <= pos + i
            col = torch.arange(C, dtype=torch.int32, device=dev)
            valid = ((col[None, None, None, :] <= row[None, None, :, None])
                     & (col[None, None, None, :]
                        >= start[:, None, None, None]))
            mask = torch.zeros(valid.shape, dtype=torch.float32,
                               device=dev).masked_fill_(~valid, _NEG_INF)
        h, new_cache = self.encoder(h, mask, cache=cache,
                                    cache_position=ring,
                                    decode_window=window)
        return self._logits(h, rows_invariant=True), new_cache

    def generate(self, input_ids, lengths=None, max_new_tokens=32,
                 beam_size=1, eos_token_id=None, draft_model=None):
        """Greedy (or beam) decoding through ``text.generation`` (prefill,
        then one step per token over the ring cache); with
        ``draft_model``, speculative decoding (text/speculative.py)."""
        from ..generation import generate as _generate
        return _generate(self, input_ids, draft_model=draft_model,
                         lengths=lengths, max_new_tokens=max_new_tokens,
                         beam_size=beam_size, eos_token_id=eos_token_id)
