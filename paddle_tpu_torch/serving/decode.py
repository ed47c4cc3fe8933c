"""Batched autoregressive decode through the serving engine.

Counterpart of ``paddle_tpu/serving/decode.py`` (``DecodeModelSpec``,
``DecodeRequest`` and ``_DecodeRuntime``: the run-to-completion path and,
under ``FLAGS_decode_slots > 0``, the slot loop of serving/slots.py).
Request rows pack into the batch-bucket ladder; prompt lengths pad
(left) to the FLAGS_decode_buckets sequence ladder; the KV-cache length
rounds up to the smallest bucket holding prompt-bucket + max_new_tokens.
Warm-up runs every (batch-bucket x prefill-bucket) pair once, and under
FLAGS_serving_strict a batch outside that warmed set fails instead of
running cold.

Left-padding makes results batch-invariant: a row's attention window is
``[P - len, pos)`` whatever rows share its batch, so a served greedy
decode equals a batch-1 ``generate()`` of the same prompt token for token
(the admission oracle).

A spec with a ``draft_layer`` serves through speculative decoding under
``FLAGS_spec_decode`` (text/speculative.py; in slot mode the slot loop's
speculative step): the served tokens stay those of plain greedy decode.
The JAX package's acceptance metrics and traced draft/verify spans wait
with the rest of ``profiler/`` (ROADMAP A13); ``Server.stats()`` carries
the acceptance counters.

Sessions (FLAGS_session_store): a single-prompt request with a
``session_id`` takes its conversation's snapshot from the store the
Server injects and hands it to the slot loop, which restores the parked
columns instead of prefilling them and parks the row again when the
turn ends.  Disaggregated serving: ``prefill_handoff`` runs only the
prefill and returns a :class:`~.cluster.handoff.KVHandoff`, and
``decode_from_handoff`` resumes decoding from one (or its bytes), on the
buckets ``submit_decode`` would use.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.enforce import (InvalidArgumentError, OutOfRangeError,
                                 PreconditionNotMetError)
from ..profiler.metrics import LatencyWindow, RateMeter
from .bucketing import BucketLadder

__all__ = ["DecodeModelSpec", "DecodeRequest"]


@dataclass
class DecodeModelSpec:
    """One served decode model: a live layer implementing the
    init_cache/forward_cached contract (text.models.GPTModel).

    ``draft_layer`` makes the spec a draft/target pair: under
    ``FLAGS_spec_decode`` the runtime serves through speculative decoding
    with ``gamma`` proposals a step (default FLAGS_spec_gamma).  With the
    flag off the draft is ignored."""

    name: str
    layer: Any
    batch_buckets: Optional[Sequence[int]] = None
    seq_buckets: Optional[Sequence[int]] = None
    max_new_tokens: int = 16
    max_len: Optional[int] = None
    eos_token_id: Optional[int] = None
    draft_layer: Any = None
    gamma: Optional[int] = None


@dataclass
class DecodeRequest:
    """One client decode request: ``rows`` prompts (variable lengths),
    each to be continued by up to ``max_new`` tokens."""

    model: str
    prompts: List[np.ndarray]
    rows: int
    max_new: int
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.perf_counter)
    # when the batch's prefill logits were ready: the first token is
    # their argmax (time to first token = t_first - t_enqueue)
    t_first: Optional[float] = None
    # conversation identity (FLAGS_session_store): single-prompt requests
    # only; the slot loop parks/restores the KV columns under this key
    session_id: Optional[str] = None


class _DecodeRuntime:
    """Serving-side runtime for one decode model: a Generator, the bucket
    plan, metrics and the strict steady-state discipline."""

    backend = "decode"
    kind = "decode"

    def __init__(self, spec: DecodeModelSpec, device):
        self.spec = spec
        self.name = spec.name
        self.device = device
        self.events: List[dict] = []        # cold batches after warm-up
        self.ladder = BucketLadder.from_flag(
            spec.batch_buckets if spec.batch_buckets is not None
            else _flags.flag("serving_buckets"))
        self.steps = int(spec.max_new_tokens)
        self.admitted = False
        self.gen = None
        self._warmed = set()                # {(B, P, C)}
        self._loop = None                   # the SlotLoop in slot mode
        self._spec_base = None              # acceptance totals at warm-up
        # injected by the Server before warmup (FLAGS_session_store); the
        # prefix cache is built per runtime in _warmup_slots
        self.session_store = None
        self.prefix_cache = None
        self.latency = LatencyWindow()
        self.ttft = LatencyWindow()
        self.rate = RateMeter()
        self._mlock = threading.Lock()
        self.counters = {"requests": 0, "completed": 0,  # guarded-by: _mlock
                         "errors": 0, "batches": 0, "rows": 0,
                         "padded_rows": 0, "tokens": 0,
                         "steady_compiles": 0}

    def bump(self, **kw):
        with self._mlock:
            for k, v in kw.items():
                self.counters[k] += v

    # -- loading + warm-up ---------------------------------------------------
    def load(self):
        from ..text.generation import Generator
        kw = dict(seq_buckets=self.spec.seq_buckets,
                  max_len=self.spec.max_len, device=self.device)
        if self.spec.draft_layer is not None \
                and bool(_flags.flag("spec_decode")):
            from ..text.speculative import SpeculativeGenerator
            self.gen = SpeculativeGenerator(self.spec.layer,
                                            self.spec.draft_layer,
                                            gamma=self.spec.gamma, **kw)
        else:
            self.gen = Generator(self.spec.layer, **kw)
        # every prompt bucket must leave room for max_new_tokens in some
        # cache bucket — refuse at registration time, not under traffic
        self._plan = []
        for p in self.gen.seq_buckets:
            try:
                c = self.gen.cache_bucket(p, self.steps)
            except OutOfRangeError:
                continue                # prompts this long are rejected
            self._plan.append((p, c))
        if not self._plan:
            raise PreconditionNotMetError(
                f"decode model {self.name!r}: no sequence bucket leaves "
                f"room for max_new_tokens={self.steps} under "
                f"max_len={self.gen._max_len}")
        self.max_prompt = max(p for p, _ in self._plan)
        # iteration-level slot mode (FLAGS_decode_slots): one step loop
        # at the LARGEST cache bucket replaces the run-to-completion
        # grid; prompts chunk to FLAGS_prefill_chunk instead of
        # prefill-bucketing
        self.slots = int(_flags.flag("decode_slots"))
        self.chunk_width = int(_flags.flag("prefill_chunk"))
        if self.slots:
            self._slot_cache = max(c for _, c in self._plan)
            gamma = self.gen.gamma if self.speculative else 0
            span = self._slot_cache - self.steps - gamma
            T = self.chunk_width
            # largest admissible prompt: its chunk-padded span plus the
            # full token budget must fit ONE ring session
            self.max_prompt = (span // T) * T
            if self.max_prompt < 1:
                raise PreconditionNotMetError(
                    f"decode model {self.name!r}: slot cache "
                    f"{self._slot_cache} leaves no room for a prompt "
                    f"chunk (chunk={T}, max_new_tokens={self.steps}, "
                    f"gamma={gamma})")

    def _warmup_slots(self):
        """Slot-mode warm-up: build (on the card: capture) the step and
        the chunk program, the prefix cache under FLAGS_prefix_cache, and
        the SlotLoop; run one dummy request end to end so every dispatch
        path is warm; then zero the loop's accounting and drop the
        dummy's prefix blocks."""
        from .prefix_cache import PrefixCache
        from .slots import SlotLoop
        S, C, T = self.slots, self._slot_cache, self.chunk_width
        if bool(_flags.flag("prefix_cache")):
            self.prefix_cache = PrefixCache(
                T, self.gen.block_nbytes(T),
                hbm_budget_mb=float(_flags.flag("prefix_cache_hbm_mb")))
        self._loop = SlotLoop(self.gen, S, C, T,
                              eos_token_id=self.spec.eos_token_id,
                              model=self.name,
                              prefix_cache=self.prefix_cache,
                              session_store=self.session_store)
        self._loop.submit(np.zeros((1,), np.int32), 1).result(timeout=600)
        self._loop.reset_stats()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self.admitted = True

    def warmup(self):
        """Run every (batch-bucket x prefill-bucket) pair once on zeros:
        prefill, then the full decode length.  These are the shapes
        steady-state traffic may use.  In slot mode, build and warm the
        slot loop instead."""
        if self.slots:
            self._warmup_slots()
            return
        eos = self.spec.eos_token_id
        for B in self.ladder:
            for P, C in self._plan:
                ids = np.zeros((B, P), np.int32)
                start = np.full((B,), P - 1, np.int32)
                cache, logits0 = self.gen.prefill(ids, start, C)
                self.gen.decode(cache, logits0, start, P, self.steps,
                                eos_token_id=eos)
                self._warmed.add((B, P, C))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.speculative:
            # acceptance counts from here: the warm-up's are not traffic
            self._spec_base = dict(self.gen.totals)
        self.admitted = True

    # -- traffic -------------------------------------------------------------
    def validate(self, prompts, max_new):
        if not prompts:
            raise InvalidArgumentError("empty decode request (0 prompts)")
        out = []
        for i, p in enumerate(prompts):
            a = np.asarray(p)
            if a.ndim != 1 or a.size == 0 \
                    or not np.issubdtype(a.dtype, np.integer):
                raise InvalidArgumentError(
                    f"decode prompt {i} must be a non-empty 1-D int "
                    f"array, got shape {a.shape} dtype {a.dtype}")
            if a.size > self.max_prompt:
                raise OutOfRangeError(
                    f"decode prompt {i} has {a.size} tokens; the largest "
                    f"admissible prompt bucket is {self.max_prompt} "
                    f"(max_new_tokens={self.steps}, ladder "
                    f"{self.gen.seq_buckets})")
            out.append(a.astype(np.int32))
        mn = self.steps if max_new is None else int(max_new)
        if mn < 1 or mn > self.steps:
            raise InvalidArgumentError(
                f"max_new_tokens must be in [1, {self.steps}] "
                f"(the engine's warmed decode length), got {mn}")
        return out, mn

    def execute(self, batch):
        """Run one packed batch through prefill + decode; returns
        generated tokens [bucket, steps] as numpy (padding rows included
        — the worker slices per request).  In slot mode the rows go
        through the slot loop instead: each row is its own slot tenancy
        (joins at a token boundary, retires when done), and the worker's
        [bucket, steps] contract is assembled from the per-row futures."""
        if self._loop is not None:
            return self._execute_slots(batch)
        prompts = [p for r in batch.requests for p in r.prompts]
        # pad rows up to the batch bucket with 1-token dummy prompts
        prompts += [np.zeros((1,), np.int32)] * (batch.bucket - batch.rows)
        P = self.gen.prefill_bucket(max(p.size for p in prompts))
        C = self.gen.cache_bucket(P, self.steps)
        B = batch.bucket
        self._guard(B, P, C)
        ids, start = self.gen.pack_prompts(prompts, P)
        cache, logits0 = self.gen.prefill(ids, start, C)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # one fence per batch:
        t_first = time.perf_counter()             # the first token is ready
        for r in batch.requests:
            r.t_first = t_first
        toks = self.gen.decode(cache, logits0, start, P, self.steps,
                               eos_token_id=self.spec.eos_token_id)
        return toks.cpu().numpy()

    def _snapshot(self, sid):
        """The session's parked snapshot, if this model parked it."""
        if sid is None or self.session_store is None:
            return None
        snap = self.session_store.take(sid)
        if snap is not None and snap.model != self.name:
            # a key collision across models: put the snapshot back
            # untouched and prefill plainly
            self.session_store.put(snap)
            snap = None
        return snap

    def _execute_slots(self, batch):
        futs = []
        for r in batch.requests:
            sid = r.session_id
            snap = self._snapshot(sid)
            for p in r.prompts:
                try:
                    futs.append(self._loop.submit(
                        p, r.max_new, session_id=sid, snapshot=snap))
                except (InvalidArgumentError, OutOfRangeError):
                    if snap is None:
                        raise
                    # a malformed snapshot must not fail the turn: fall
                    # back to the plain prefill (the same tokens)
                    futs.append(self._loop.submit(p, r.max_new,
                                                  session_id=sid))
                snap = None             # one snapshot, one restore
        out = np.zeros((batch.bucket, self.steps), np.int32)
        row = 0
        for r in batch.requests:
            err = None
            for _ in range(len(r.prompts)):
                try:
                    got = futs[row].result(timeout=600)
                    out[row, :got.size] = got
                except Exception as e:   # noqa: BLE001 — per-request
                    err = e              # isolation: one row's failure
                row += 1                 # must not fail its batch-mates
            if err is not None and not r.future.done():
                r.future.set_exception(err)
        return out

    def _guard(self, B, P, C):
        """The warm-up discipline of the run-to-completion grid (batches
        and handoff legs alike): a (batch, prompt, cache) point outside
        the warmed set fails under FLAGS_serving_strict, else runs cold
        and is recorded."""
        if (B, P, C) in self._warmed:
            return
        if bool(_flags.flag("serving_strict")):
            raise PreconditionNotMetError(
                f"decode model {self.name!r}: (batch={B}, prompt="
                f"{P}, cache={C}) was not warmed "
                "(FLAGS_serving_strict=True refuses steady-state "
                "cold shapes — extend the ladders and re-warm)")
        self.bump(steady_compiles=1)
        self.events.append({"site": f"serving:{self.name}",
                            "kind": "serving_cold_batch", "bucket": B,
                            "prompt": P, "cache": C,
                            "model": self.name, "graph": False})
        self._warmed.add((B, P, C))

    # -- disaggregated serving: prefill -> handoff -> decode -----------------
    def _no_slots(self):
        if self._loop is not None:
            raise PreconditionNotMetError(
                f"decode model {self.name!r}: the KV handoff rides the "
                "run-to-completion path; set FLAGS_decode_slots=0")

    def prefill_handoff(self, prompts, max_new_tokens=None):
        """Run ONLY the prefill of ``prompts`` at the buckets
        ``submit_decode`` would use, and return the KVHandoff a decode
        resumes from: the device planes (the model's dtype, or int8 +
        scales), next-token logits, per-row validity offsets and the
        cache position."""
        from .cluster.handoff import KVHandoff
        self._no_slots()
        arrs, mn = self.validate(list(prompts), max_new_tokens)
        rows = len(arrs)
        B = self.ladder.bucket_for(rows)
        padded = arrs + [np.zeros((1,), np.int32)] * (B - rows)
        P = self.gen.prefill_bucket(max(p.size for p in padded))
        C = self.gen.cache_bucket(P, self.steps)
        self._guard(B, P, C)
        ids, start = self.gen.pack_prompts(padded, P)
        t0 = time.monotonic()
        cache, logits0 = self.gen.prefill(ids, start, C)
        return KVHandoff(cache=cache, logits0=logits0,
                         start=np.asarray(start, np.int32), pos=P,
                         meta={"model": self.name, "rows": rows,
                               "max_new": mn, "batch": B,
                               "prompt_bucket": P, "cache_bucket": C,
                               "prefill_s": round(time.monotonic() - t0,
                                                  6)})

    def decode_from_handoff(self, handoff):
        """Resume decoding from a prefill's handoff: planes that arrived
        serialized (on the host) move to the runtime's device first, then
        the decode runs from the carried cache position and windows.
        Returns int32 ids [rows, max_new], the tokens ``submit_decode``
        gives the same prompts."""
        self._no_slots()
        cache = handoff.cache
        if not cache:
            raise InvalidArgumentError("empty KV handoff (no planes)")
        if handoff.meta.get("model", self.name) != self.name:
            raise InvalidArgumentError(
                f"KV handoff of model {handoff.meta['model']!r} sent to "
                f"{self.name!r}")
        if not all(torch.is_tensor(x) and x.device == self.device
                   for x in (cache[0][0], handoff.logits0)):
            handoff = handoff.device(self.device)
            cache = handoff.cache
        # the wire carries each layer's planes as a tuple: the model reads
        # them by name (k, v, k_scale, v_scale)
        from ..nn.layer.transformer import MultiHeadAttention as _MHA
        kinds = {2: _MHA.RingCache, 4: _MHA.QuantRingCache}
        cache = [kinds[len(c)](*c) for c in cache]
        B = int(handoff.logits0.shape[0])
        C = int(cache[0][0].shape[2])
        self._guard(B, int(handoff.pos), C)
        toks = self.gen.decode(cache, handoff.logits0, handoff.start,
                               int(handoff.pos), self.steps,
                               eos_token_id=self.spec.eos_token_id)
        rows = int(handoff.meta.get("rows", B))
        mn = int(handoff.meta.get("max_new", self.steps))
        return toks.cpu().numpy()[:rows, :mn]

    @property
    def speculative(self):
        return getattr(self.gen, "_draft", None) is not None

    def spec_stats(self, loop_stats=None):
        """Acceptance of the served traffic (since warm-up): the slot
        loop's counters in slot mode (read from ``loop_stats``, the
        loop's ``stats()`` where the caller has them), the generator's
        otherwise; None for a plain runtime."""
        if not self.speculative:
            return None
        if self._loop is not None:
            st = loop_stats or self._loop.stats()
            acc, prop = st["spec_accepted"], st["spec_proposed"]
        else:
            tot, base = dict(self.gen.totals), self._spec_base or {}
            acc = tot["accepted"] - base.get("accepted", 0)
            prop = tot["proposed"] - base.get("proposed", 0)
        return {"spec_accepted": acc, "spec_proposed": prop,
                "spec_acceptance_rate": round(acc / prop, 4) if prop
                else 0.0}

    def slot_signals(self):
        """Token-level slot accounting for Server.signals(), or None on
        the run-to-completion path."""
        return None if self._loop is None else self._loop.signals()

    def close(self):
        if self._loop is not None:
            self._loop.close()
