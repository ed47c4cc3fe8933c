"""Autoregressive greedy and beam decoding over a static-shape KV ring
cache.

Counterpart of ``paddle_tpu/text/generation.py`` (``Generator`` and
``generate()``: greedy with eos, beam search, and, with a draft model,
speculative decoding through ``text/speculative.py``).  The shape
discipline is the same:

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
        # the slot loop's steps (step_exec), memoized per key;
        # steps_built counts step builds (on CUDA: graph captures), as
        # the JAX package's ledger counts generate_step compiles
        self._steps = {}
        self.counters = {"steps_built": 0}

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

    def decode(self, cache, logits0, start, pos0, steps, beam_size=1,
               eos_token_id=None):
        """Greedy decoding from a prefill result: ``steps`` tokens per row,
        returned as int32 [B, steps] on the generator's device.  With
        ``beam_size`` K > 1, beam search: (paths int32 [B, K, steps],
        scores f32 [B, K])."""
        # end == -1 encodes "no eos": argmax tokens are always >= 0, so
        # the finished mask never trips
        end = -1 if eos_token_id is None else int(eos_token_id)
        beam = int(beam_size)
        if beam < 1:
            raise InvalidArgumentError(f"beam_size must be >= 1, got {beam}")
        with torch.inference_mode():
            start = torch.as_tensor(np.asarray(start, np.int32),
                                    device=self.device)
            if beam > 1:
                return self._beam_decode(cache, logits0, start, int(pos0),
                                         int(steps), beam, end)
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

    def _beam_decode(self, cache, logits0, start, pos0, steps, K, end):
        """Beam search over ``K`` beam rows per prompt row, as the JAX
        package's ``beam_decode``: the prefill cache repeats K times, only
        beam 0 is live at the first step, and every step selects with
        :func:`ops.decode.beam_search_step`, reorders the cache rows by
        the parents, and runs one ``B*K``-row forward."""
        from ..ops.decode import (beam_parent_gather, beam_search_step,
                                  gather_tree)
        B = logits0.shape[0]
        cache = [type(c)(*(p.repeat_interleave(K, dim=0) for p in c))
                 for c in cache]
        start_k = start.repeat_interleave(K)
        logp = torch.log_softmax(logits0.float(), dim=-1)
        V = logp.shape[-1]
        logp = logp[:, None, :].expand(B, K, V)
        scores = torch.where(torch.arange(K, device=self.device) > 0,
                             -1e9, 0.0).float().expand(B, K)
        pre = torch.full((B, K), end - 1, dtype=torch.int32,
                         device=self.device)             # != end: all live
        all_ids, all_parents = [], []
        for i in range(steps):
            pre, scores, parents = beam_search_step(
                pre, scores, logp, beam_size=K, end_id=end,
                is_accumulated=True)
            cache = [type(c)(*(beam_parent_gather(p, parents) for p in c))
                     for c in cache]
            nlogits, cache = self._layer.forward_cached(
                pre.reshape(B * K, 1), cache, pos0 + i, start_k)
            logp = torch.log_softmax(nlogits[:, 0].float(), dim=-1) \
                .reshape(B, K, V)
            all_ids.append(pre)
            all_parents.append(parents)
        paths = gather_tree(torch.stack(all_ids), torch.stack(all_parents))
        return paths.permute(1, 2, 0).contiguous(), scores

    # -- slot-loop programs (serving/slots.py) -------------------------------
    def _vocab_size(self):
        return int(self._layer.config.vocab_size)

    def _build_step(self, end):
        """ONE greedy token step over the slot rows: the body of
        :meth:`decode`'s loop, hoisted so the HOST owns the loop and
        requests retire and join between steps.  Inactive rows are fed
        token 0 and their logits pass through unchanged, so a freshly
        activated row is never clobbered; their cache write is NOT masked
        per row: the slot loop guarantees every column a step writes for
        an inactive row is dead (serving/slots.py, dead-column
        discipline).  ``pos`` is a 0-d int32 tensor, so the step reads
        nothing back to the host and can be captured (text/graphs.py).
        Returns (cache, logits, finished, tok)."""
        fwd = self._layer.forward_cached

        def step(cache, logits, start, finished, active, pos):
            tok = logits.argmax(dim=-1).to(torch.int32)
            tok = torch.where(finished, end, tok)
            finished = finished | (tok == end)
            # inactive rows may carry garbage argmax (end == -1 included)
            # — clamp their fed token; their write lands in a dead column
            fed = torch.where(active, tok, 0)
            nlogits, cache = fwd(fed[:, None], cache, pos, start)
            nlog = torch.where(active[:, None], nlogits[:, 0].float(),
                               logits)
            return cache, nlog, finished, tok

        return step

    def step_exec(self, S, C, eos_token_id=None):
        """The slot loop's step over ``S`` slots at cache length ``C``:
        on CUDA one captured CUDA graph (text/graphs.py
        ``CapturedSlotStep``), on the CPU the same step run eagerly
        (``SlotStep``).  Memoized per (S, C, eos, KV dtype), as the JAX
        package keeps one executable per key; the step owns its cache
        planes, so one slot loop at a time holds it
        (``SlotStep.claim``)."""
        from .graphs import CapturedSlotStep, SlotStep
        end = -1 if eos_token_id is None else int(eos_token_id)
        # the cache storage dtype is part of the step: flipping
        # FLAGS_kv_cache_dtype builds a new one instead of serving stale
        # planes
        key = (int(S), int(C), end,
               str(_flags.flag("kv_cache_dtype")).lower())
        step = self._steps.get(key)
        if step is None:
            self.counters["steps_built"] += 1
            cls = CapturedSlotStep if self.device.type == "cuda" \
                else SlotStep
            step = self._steps[key] = cls(self, S, C, end)
        return step

    def prefill_chunk(self, cache, ids, start, rowidx, pos):
        """One prefill chunk of the slot loop: the ``T`` prompt tokens
        ``ids`` of ONE joining row at the block position ``pos``, run at
        batch 1 over the row's view of each plane (``p[i:i+1]``), so its
        K/V block lands in the slot cache in place and no other row is
        touched.  Rows are independent in forward_cached and its GEMMs
        are row-invariant, so this equals the row's lane of a batched
        prefill.  Returns the chunk's last-column logits f32 [V]; the
        final chunk's are the row's activation logits."""
        i = int(rowidx)
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(ids, np.int32),
                                  device=self.device).reshape(1, -1)
            start = torch.as_tensor(np.asarray(start, np.int32),
                                    device=self.device).reshape(1)
            sub = [type(c)(*(p[i:i + 1] for p in c)) for c in cache]
            logits, _ = self._layer.forward_cached(ids, sub, int(pos),
                                                   start)
            return logits[0, -1, :].float()

    @staticmethod
    def pull_block(cache, rowidx, base, T):
        """A copy of one ``T``-column block of one slot row, every plane
        (the live planes may change after it)."""
        i, b = int(rowidx), int(base)
        with torch.inference_mode():
            return [type(c)(*(p[i:i + 1, :, b:b + T].clone() for p in c))
                    for c in cache]

    @staticmethod
    def push_block(cache, block, rowidx, base):
        """Write a block of :meth:`pull_block` into one slot row at column
        ``base``, every plane, in place.  The block is only read, so one
        cached prefix block restores into many rows."""
        i, b = int(rowidx), int(base)
        with torch.inference_mode():
            for c, blk in zip(cache, block):
                for p, q in zip(c, blk):
                    p[i:i + 1, :, b:b + q.shape[2]].copy_(q)

    @staticmethod
    def pull_row(cache, rowidx, base=0, length=None):
        """A host copy of one slot row's columns ``[base, base + length)``
        (default: the whole ring), every plane, as CPU tensors: a session
        park's snapshot.  The JAX package pulls the full-width row and
        slices the window on the host; this slices on the device before
        the copy, which moves the same bytes.  Always a copy, on the CPU
        too: the live planes change after it."""
        i, b = int(rowidx), int(base)
        with torch.inference_mode():
            return [type(c)(*(p[i:i + 1, :, b:(p.shape[2] if length is None
                                               else b + int(length))]
                              .to("cpu", copy=True) for p in c))
                    for c in cache]

    def init_slot_cache(self, S, C):
        """Zero planes for a fresh slot session (validity windows make
        the values unobservable; zeros match the prefill's fresh cache)."""
        with torch.inference_mode():
            return self._layer.init_cache(int(S), int(C))

    def block_nbytes(self, T):
        """Device bytes of one T-column single-row block of the slot
        cache, every plane (the prefix cache's unit of account)."""
        ring = self._layer.init_cache(1, 1)
        return sum(p.element_size() * p.numel() // p.shape[2] * T
                   for c in ring for p in c)

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
                 beam_size=1, eos_token_id=None):
        """Greedy (or beam) decoding of a batch of prompts.

        ``input_ids`` [B, L] (right-padded; ``lengths`` [B] gives the true
        prompt lengths, default L).  Greedy returns generated ids int32
        [B, max_new_tokens] on the generator's device; beam returns
        (ids int32 [B, beam_size, max_new_tokens], scores f32 [B,
        beam_size])."""
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
                           beam_size=beam_size, eos_token_id=eos_token_id)

    __call__ = generate


def generate(layer, input_ids, draft_model=None, **kwargs):
    """Module-level convenience: build (and memoize on the layer) a
    Generator on the layer's own device, then decode.  With
    ``draft_model`` (a smaller layer with the same init_cache /
    forward_cached contract and vocabulary) the call runs draft/target
    speculative decoding instead: the tokens of plain greedy decode, at
    up to gamma+1 tokens per target forward (text/speculative.py)."""
    if draft_model is not None:
        from .speculative import SpeculativeGenerator
        gen = getattr(layer, "_paddle_tpu_torch_spec_generator", None)
        if gen is None or gen._layer is not layer \
                or gen._draft is not draft_model:
            gen = SpeculativeGenerator(layer, draft_model,
                                       device=module_device(layer))
            layer._paddle_tpu_torch_spec_generator = gen
        return gen.generate(input_ids, **kwargs)
    gen = getattr(layer, "_paddle_tpu_torch_generator", None)
    if gen is None or gen._layer is not layer:
        gen = Generator(layer, device=module_device(layer))
        layer._paddle_tpu_torch_generator = gen
    return gen.generate(input_ids, **kwargs)
