"""Autoregressive greedy decoding over a static-shape KV ring cache.

Counterpart of ``paddle_tpu/text/generation.py`` (``Generator`` and
``generate()``, greedy with eos).  The shape discipline is the same:

  * prompts pad LEFT to a prefill bucket ``P`` (FLAGS_decode_buckets),
    so row ``b``'s valid cache window is the contiguous ``[P - len_b,
    pos)`` and the last prefill column is the last prompt token of
    every row;
  * the ring cache length ``C`` is the smallest bucket holding ``P`` plus
    the new tokens, capped by FLAGS_decode_max_len;
  * prefill runs the padded prompt once and fills the cache; decode then
    runs one ``forward_cached`` step per token (the JAX package's
    ``lax.scan`` becomes a Python loop; PyTorch runs eagerly).

Model contract: ``layer.init_cache(batch, max_len)`` and
``layer.forward_cached(input_ids, cache, cache_position,
start_positions)`` (``text.models.GPTModel``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.enforce import InvalidArgumentError, OutOfRangeError
from ..framework.place import DeviceLike, module_device, resolve_device
from ..serving.bucketing import BucketLadder

__all__ = ["Generator", "generate"]


class Generator:
    """Greedy incremental decoding for one model on one device."""

    def __init__(self, layer, seq_buckets: Optional[Sequence[int]] = None,
                 max_len: Optional[int] = None,
                 device: DeviceLike = None):
        if not hasattr(layer, "forward_cached") \
                or not hasattr(layer, "init_cache"):
            raise InvalidArgumentError(
                f"{type(layer).__name__} does not implement the "
                "incremental-decoding contract (init_cache + "
                "forward_cached) — see text.models.GPTModel")
        self.device = resolve_device(device)
        on = module_device(layer)
        if on is not None and on != self.device:
            raise InvalidArgumentError(
                f"the model lives on {on}, the generator on {self.device}")
        layer.eval()
        self._layer = layer
        self._max_len = int(max_len if max_len is not None
                            else _flags.flag("decode_max_len"))
        spec = seq_buckets if seq_buckets is not None \
            else _flags.flag("decode_buckets")
        ladder = BucketLadder.from_flag(spec)
        # cache lengths cap at max_len; max_len itself is the top bucket
        self._seq_buckets = sorted(
            {b for b in ladder.buckets if b <= self._max_len}
            | {self._max_len})

    @property
    def seq_buckets(self):
        return list(self._seq_buckets)

    # -- bucketing -----------------------------------------------------------
    def prefill_bucket(self, length: int) -> int:
        """Smallest sequence bucket holding ``length`` prompt tokens."""
        for b in self._seq_buckets:
            if length <= b:
                return b
        raise OutOfRangeError(
            f"prompt length {length} exceeds the largest decode bucket "
            f"{self._seq_buckets[-1]} (FLAGS_decode_buckets / "
            "FLAGS_decode_max_len)")

    def cache_bucket(self, prefill: int, steps: int) -> int:
        """Smallest sequence bucket holding prefill + generated tokens."""
        need = int(prefill) + int(steps)
        for b in self._seq_buckets:
            if need <= b:
                return b
        raise OutOfRangeError(
            f"prompt bucket {prefill} + {steps} new tokens = {need} "
            f"exceeds FLAGS_decode_max_len={self._max_len}")

    # -- the two phases ------------------------------------------------------
    def prefill(self, ids, start, cache_len):
        """Run LEFT-padded int32 prompts ``ids [B, P]`` with per-row pad
        offsets ``start [B]`` into a fresh ring cache of ``cache_len``
        columns; returns (cache, next-token logits [B, V] f32)."""
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(ids, np.int32),
                                  device=self.device)
            start = torch.as_tensor(np.asarray(start, np.int32),
                                    device=self.device)
            cache = self._layer.init_cache(ids.shape[0], int(cache_len))
            logits, cache = self._layer.forward_cached(ids, cache, 0, start)
            # left-padding: the last column is the last prompt token of
            # EVERY row
            return cache, logits[:, -1, :].float()

    def decode(self, cache, logits0, start, pos0, steps,
               eos_token_id=None):
        """Greedy decoding from a prefill result: ``steps`` tokens per row,
        returned as int32 [B, steps] on the generator's device."""
        # end == -1 encodes "no eos": argmax tokens are always >= 0, so
        # the finished mask never trips
        end = -1 if eos_token_id is None else int(eos_token_id)
        with torch.inference_mode():
            start = torch.as_tensor(np.asarray(start, np.int32),
                                    device=self.device)
            logits = logits0
            finished = torch.zeros(logits.shape[0], dtype=torch.bool,
                                   device=self.device)
            toks = []
            for i in range(int(steps)):
                tok = logits.argmax(dim=-1).to(torch.int32)
                tok = torch.where(finished, end, tok)
                finished = finished | (tok == end)
                nlogits, cache = self._layer.forward_cached(
                    tok[:, None], cache, int(pos0) + i, start)
                logits = nlogits[:, 0].float()
                toks.append(tok)
            return torch.stack(toks, dim=1)

    # -- host-side prep + the public call ------------------------------------
    def pack_prompts(self, prompts, bucket):
        """LEFT-pad variable-length int prompts to [rows, bucket]; returns
        (ids int32, start int32 [rows]) — start[b] = bucket - len_b is
        row b's first valid cache column."""
        rows = len(prompts)
        ids = np.zeros((rows, bucket), np.int32)
        start = np.empty((rows,), np.int32)
        for i, p in enumerate(prompts):
            p = np.asarray(p).reshape(-1).astype(np.int32)
            if p.size == 0:
                raise InvalidArgumentError("empty prompt (0 tokens)")
            if p.size > bucket:
                raise OutOfRangeError(
                    f"prompt of {p.size} tokens exceeds bucket {bucket}")
            ids[i, bucket - p.size:] = p
            start[i] = bucket - p.size
        return ids, start

    def generate(self, input_ids, lengths=None, max_new_tokens=32,
                 eos_token_id=None):
        """Greedy decoding of a batch of prompts.

        ``input_ids`` [B, L] (right-padded; ``lengths`` [B] gives the true
        prompt lengths, default L).  Returns generated ids int32
        [B, max_new_tokens] on the generator's device."""
        ids_np = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                            else input_ids)
        if ids_np.ndim != 2:
            raise InvalidArgumentError(
                f"input_ids must be [batch, length], got {ids_np.shape}")
        B, L = ids_np.shape
        steps = int(max_new_tokens)
        if steps < 1:
            raise InvalidArgumentError("max_new_tokens must be >= 1")
        if lengths is None:
            lens = np.full((B,), L, np.int64)
        else:
            lens = np.asarray(lengths.cpu() if torch.is_tensor(lengths)
                              else lengths).reshape(-1).astype(np.int64)
        if lens.shape[0] != B or (lens < 1).any() or (lens > L).any():
            raise InvalidArgumentError(
                f"lengths must be [batch] in [1, {L}], got {lens}")
        max_pos = getattr(getattr(self._layer, "config", None),
                          "max_position_embeddings", None)
        if max_pos is not None and int(lens.max()) + steps > int(max_pos):
            raise OutOfRangeError(
                f"prompt ({int(lens.max())}) + max_new_tokens ({steps}) "
                f"exceeds max_position_embeddings={max_pos}")
        P = self.prefill_bucket(int(lens.max()))
        C = self.cache_bucket(P, steps)
        ids, start = self.pack_prompts(
            [ids_np[b, :lens[b]] for b in range(B)], P)
        cache, logits0 = self.prefill(ids, start, C)
        return self.decode(cache, logits0, start, P, steps,
                           eos_token_id=eos_token_id)

    __call__ = generate


def generate(layer, input_ids, **kwargs):
    """Module-level convenience: build (and memoize on the layer) a
    Generator on the layer's own device, then decode."""
    gen = getattr(layer, "_paddle_tpu_torch_generator", None)
    if gen is None or gen._layer is not layer:
        gen = Generator(layer, device=module_device(layer))
        layer._paddle_tpu_torch_generator = gen
    return gen.generate(input_ids, **kwargs)
