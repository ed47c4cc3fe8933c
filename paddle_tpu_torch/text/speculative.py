"""Draft/target speculative decoding.

Counterpart of ``paddle_tpu/text/speculative.py``.  Plain ``generate()``
pays one full target forward per token.  Speculative decoding commits
up to ``gamma + 1`` tokens per target forward without changing the
output:

  * a small **draft** model proposes ``gamma`` tokens from its own ring
    cache (``gamma + 1`` one-token forwards: the extra one writes the
    last proposal's K/V, so the draft cache is a valid committed prefix
    at any acceptance count);
  * the **target** scores all ``gamma + 1`` positions in ONE verify
    forward (``forward_cached(verify=True)``);
  * **greedy acceptance** keeps the longest prefix on which the draft's
    proposals equal the target's own argmax, and commits the target's
    token at the first disagreement: every emitted token is the
    target's greedy choice over the committed prefix;
  * **rejection rewinds the position**: stale K/V beyond the committed
    length lie outside every later window and are overwritten by the
    next block;
  * batched rows advance in **lockstep** (the acceptance of a step is
    the minimum over rows), so the position stays one scalar.

Bit equality with greedy decode on the card.  A greedy step attends one
query through the decode kernel (B3/B4); the verify block attends its
``gamma + 1`` queries through the kernel's block form, each query row
with the window end ``pos + t + 1`` and the same split of the same
cache length that a one-token step at that position uses, so it rounds
as the step does.  The rest of the forward is row-invariant (row-padded
GEMMs, row-wise LayerNorm and int8 quantization).  At the same cache
length speculative tokens therefore equal greedy tokens bit for bit,
and a self-draft accepts every proposal.  On the CPU the verify runs
the plain masked attention, as the JAX package's does.

The host owns the loop (PyTorch runs eagerly): each speculative step
reads back one scalar, the accepted count.  The slot loop's step
(``serving/slots.py``) runs the same body on the device as one captured
CUDA graph (``text/graphs.py``).

Not ported: the JAX package's metrics registry counters and traced
draft/verify spans (they wait with the rest of ``profiler/``,
ROADMAP A13); ``last_stats`` carries the same numbers.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.enforce import InvalidArgumentError
from ..framework.place import DeviceLike, module_device
from .generation import Generator

__all__ = ["SpeculativeGenerator"]


def _param_bytes(layer):
    return sum(p.numel() * p.element_size() for p in layer.parameters())


class SpeculativeGenerator(Generator):
    """Draft/target speculative decoding for one model pair.

    The Generator contract holds: ``prefill(ids, start, C)`` returns
    ``(caches, next-token logits)`` and ``decode(...)`` generated ids
    ``[B, steps]``; the cache payload is the (target, draft) pair.
    Greedy only: ``beam_size > 1`` raises (beam search re-scores whole
    beams; there is no draft shortcut to verify against)."""

    def __init__(self, layer, draft, seq_buckets: Optional[Sequence[int]]
                 = None, max_len: Optional[int] = None,
                 gamma: Optional[int] = None, device: DeviceLike = None):
        if not hasattr(draft, "forward_cached") \
                or not hasattr(draft, "init_cache"):
            raise InvalidArgumentError(
                f"draft {type(draft).__name__} does not implement the "
                "incremental-decoding contract (init_cache + "
                "forward_cached) — see text.models.GPTModel")
        tv = getattr(getattr(layer, "config", None), "vocab_size", None)
        dv = getattr(getattr(draft, "config", None), "vocab_size", None)
        if tv is not None and dv is not None and int(tv) != int(dv):
            raise InvalidArgumentError(
                f"draft vocab ({dv}) must match the target vocab ({tv}): "
                "acceptance compares token ids")
        g = int(gamma if gamma is not None else _flags.flag("spec_gamma"))
        if g < 1:
            raise InvalidArgumentError(f"gamma must be >= 1, got {g}")
        super().__init__(layer, seq_buckets=seq_buckets, max_len=max_len,
                         device=device)
        on = module_device(draft)
        if on is not None and on != self.device:
            raise InvalidArgumentError(
                f"the draft lives on {on}, the generator on {self.device}")
        draft.eval()
        self._draft = draft
        self._gamma = g
        self.last_stats = None
        # acceptance over every decode() since construction (serving
        # workers decode from several threads)
        self._totals_lock = threading.Lock()
        self.totals = {"accepted": 0, "proposed": 0, "spec_steps": 0}
        db, tb = _param_bytes(draft), _param_bytes(layer)
        self._draft_fraction = db / max(db + tb, 1)

    @property
    def gamma(self) -> int:
        return self._gamma

    def cache_bucket(self, prefill: int, steps: int) -> int:
        """The verify block overshoots the requested steps by up to gamma
        tokens (plus the draft's back-fill token), so the cache leaves
        that slack: the rewind moves the position, but the block's write
        must land inside the ring."""
        return super().cache_bucket(prefill, int(steps) + self._gamma + 1)

    # -- the two phases ------------------------------------------------------
    def prefill(self, ids, start, cache_len):
        """The joint prefill: the target and the draft consume the same
        left-padded prompt, so both caches share positions.  Returns
        ((target cache, draft cache), the target's next-token logits)."""
        t_cache, logits = super().prefill(ids, start, cache_len)
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(ids, np.int32),
                                  device=self.device)
            start = torch.as_tensor(np.asarray(start, np.int32),
                                    device=self.device)
            d_cache = self._draft.init_cache(ids.shape[0], int(cache_len))
            _, d_cache = self._draft.forward_cached(ids, d_cache, 0, start)
        return (t_cache, d_cache), logits

    def _spec_body(self, caches, cur, start, finished, pos, end,
                   live=None, max_commit=None):
        """One speculative step on the device: propose, verify, accept.
        ``pos`` is an int or a 0-d int32 tensor; ``live`` masks the rows
        that may pace the lockstep acceptance (finished rows never do);
        ``max_commit`` clamps the commit count.  Returns (caches, cur
        for the next step, finished, e [B, gamma+1] (the block with eos
        freezing), ncommit, n), the last two 0-d tensors."""
        gamma = self._gamma
        G1 = gamma + 1
        t_cache, d_cache = caches
        # propose: iteration i feeds token i of the block and writes its
        # K/V, so the last proposal's row is back-filled too
        fed, tok = [], cur
        for i in range(G1):
            fed.append(tok)
            lg, d_cache = self._draft.forward_cached(tok[:, None], d_cache,
                                                     pos + i, start)
            tok = lg[:, 0].float().argmax(dim=-1).to(torch.int32)
        v_in = torch.stack(fed, dim=1)                      # [B, G1]
        # verify: one gamma+1-wide target forward at pos
        v_logits, t_cache = self._layer.forward_cached(
            v_in, t_cache, pos, start, verify=True)
        # the greedy step's argmax: over the f32 logits, the first of ties
        g = v_logits.float().argmax(dim=-1).to(torch.int32)
        # accept: the longest prefix on which the draft agreed with the
        # target's argmax; lockstep = the minimum over rows
        match = (v_in[:, 1:] == g[:, :-1]).to(torch.int32)
        n_row = torch.cumprod(match, dim=1).sum(dim=1)
        quiet = finished if live is None else finished | ~live
        n = torch.where(quiet, gamma, n_row).min().to(torch.int32)
        ncommit = n + 1
        if max_commit is not None:
            ncommit = torch.minimum(ncommit, max_commit)
        # the target's token at the first uncommitted position (clamped:
        # a zero max_commit only occurs in a warm-up)
        at = (ncommit - 1).clamp_min(0).long().expand(v_in.shape[0])
        cur_next = g.gather(1, at[:, None])[:, 0]
        # emit: eos freezes rows as the greedy loop does (every position
        # after an eos, or on a finished row, reads eos)
        is_end = (v_in == end).to(torch.int32)
        before = torch.cumsum(is_end, dim=1) - is_end
        e = torch.where(finished[:, None] | (before > 0),
                        torch.full_like(v_in, end), v_in)
        col = torch.arange(G1, device=v_in.device)
        finished = finished | ((e == end) & (col[None, :] < ncommit)).any(1)
        cur_next = torch.where(finished, end, cur_next)
        return (t_cache, d_cache), cur_next, finished, e, ncommit, n

    def decode(self, cache, logits0, start, pos0, steps, beam_size=1,
               eos_token_id=None):
        """Speculative decoding from a prefill result: tokens int32 [B,
        steps], those of plain greedy decode of the target at the same
        cache length.  Sets ``last_stats`` (accepted, proposed,
        spec_steps, acceptance_rate, draft_fraction)."""
        if int(beam_size) != 1:
            raise InvalidArgumentError(
                "speculative decoding is greedy-only (beam search "
                "re-scores whole beams — use beam_size=1 or drop the "
                "draft model)")
        end = -1 if eos_token_id is None else int(eos_token_id)
        steps = int(steps)
        G1 = self._gamma + 1
        with torch.inference_mode():
            start = torch.as_tensor(np.asarray(start, np.int32),
                                    device=self.device)
            B = logits0.shape[0]
            cur = logits0.argmax(dim=-1).to(torch.int32)
            finished = torch.zeros(B, dtype=torch.bool, device=self.device)
            buf = torch.empty((B, steps + G1), dtype=torch.int32,
                              device=self.device)
            pos, out_pos, accepted, nsteps = int(pos0), 0, 0, 0
            while out_pos < steps:
                cache, cur, finished, e, ncommit, n = self._spec_body(
                    cache, cur, start, finished, pos, end)
                buf[:, out_pos:out_pos + G1] = e
                k = int(n) + 1          # the step's one read-back
                pos += k
                out_pos += k
                accepted += k - 1
                nsteps += 1
            toks = buf[:, :steps].clone()
        proposed = nsteps * self._gamma
        with self._totals_lock:
            self.totals["accepted"] += accepted
            self.totals["proposed"] += proposed
            self.totals["spec_steps"] += nsteps
        rate = accepted / proposed if proposed else 0.0
        self.last_stats = {
            "gamma": self._gamma, "accepted": accepted,
            "proposed": proposed, "spec_steps": nsteps,
            "acceptance_rate": round(rate, 4),
            "draft_fraction": round(self._draft_fraction, 4)}
        return toks

    # -- slot-loop programs (serving/slots.py) -------------------------------
    def _build_step(self, end):
        """ONE speculative step over the slot rows, the decode loop's body
        hoisted so the host owns the loop.  ``active`` keeps empty and
        prefilling rows from pacing the lockstep acceptance (they report
        gamma, as finished rows do); ``max_commit`` clamps the commit so
        the stride lands exactly on the host's next activation
        (committing fewer tokens than accepted is exact: the next token
        is the target's argmax at the clamped position).  Inactive rows
        are fed token 0; their block write is not masked per row (the
        slot loop's dead-column discipline).  Returns (caches, cur,
        finished, e, ncommit, n), all on the device."""

        def step(caches, cur, start, finished, active, pos, max_commit):
            cur_safe = torch.where(active, cur, 0)
            return self._spec_body(caches, cur_safe, start, finished, pos,
                                   end, live=active, max_commit=max_commit)

        return step

    def step_exec(self, S, C, eos_token_id=None):
        """The slot loop's speculative step over ``S`` slots at cache
        length ``C``: on CUDA one captured CUDA graph
        (``CapturedSpecSlotStep``), on the CPU run eagerly
        (``SpecSlotStep``); memoized per (S, C, eos, KV dtype, gamma)."""
        from .graphs import CapturedSpecSlotStep, SpecSlotStep
        end = -1 if eos_token_id is None else int(eos_token_id)
        key = (int(S), int(C), end,
               str(_flags.flag("kv_cache_dtype")).lower(), self._gamma)
        step = self._steps.get(key)
        if step is None:
            self.counters["steps_built"] += 1
            cls = CapturedSpecSlotStep if self.device.type == "cuda" \
                else SpecSlotStep
            step = self._steps[key] = cls(self, S, C, end)
        return step

    def prefill_chunk(self, cache, ids, start, rowidx, pos):
        """One JOINT prefill chunk: the target and the draft both take the
        joining row's ``T`` prompt tokens at the block position, so the
        two caches stay position-aligned.  Returns the target's
        last-column logits f32 [V]."""
        t_cache, d_cache = cache
        logits = super().prefill_chunk(t_cache, ids, start, rowidx, pos)
        i = int(rowidx)
        with torch.inference_mode():
            ids = torch.as_tensor(np.asarray(ids, np.int32),
                                  device=self.device).reshape(1, -1)
            start = torch.as_tensor(np.asarray(start, np.int32),
                                    device=self.device).reshape(1)
            sub = [type(c)(*(p[i:i + 1] for p in c)) for c in d_cache]
            self._draft.forward_cached(ids, sub, int(pos), start)
        return logits

    # the prefix cache moves blocks of BOTH caches: a restored row must
    # decode against a draft cache of its own prefix, or acceptance breaks
    @staticmethod
    def pull_block(cache, rowidx, base, T):
        return tuple(Generator.pull_block(c, rowidx, base, T) for c in cache)

    @staticmethod
    def push_block(cache, block, rowidx, base):
        for c, b in zip(cache, block):
            Generator.push_block(c, b, rowidx, base)

    # a session park pulls the target's and the draft's planes together
    @staticmethod
    def pull_row(cache, rowidx, base=0, length=None):
        return tuple(Generator.pull_row(c, rowidx, base, length)
                     for c in cache)

    def init_slot_cache(self, S, C):
        """Zero (target, draft) planes for a fresh slot session."""
        with torch.inference_mode():
            return (self._layer.init_cache(int(S), int(C)),
                    self._draft.init_cache(int(S), int(C)))

    def block_nbytes(self, T):
        ring = self._draft.init_cache(1, 1)
        return super().block_nbytes(T) + sum(
            p.element_size() * p.numel() // p.shape[2] * T
            for c in ring for p in c)
