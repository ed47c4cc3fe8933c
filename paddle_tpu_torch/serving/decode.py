"""Batched autoregressive decode through the serving engine.

Counterpart of ``paddle_tpu/serving/decode.py`` (``DecodeModelSpec``,
``DecodeRequest`` and the run-to-completion path of ``_DecodeRuntime``).
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
    init_cache/forward_cached contract (text.models.GPTModel)."""

    name: str
    layer: Any
    batch_buckets: Optional[Sequence[int]] = None
    seq_buckets: Optional[Sequence[int]] = None
    max_new_tokens: int = 16
    max_len: Optional[int] = None
    eos_token_id: Optional[int] = None


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


class _DecodeRuntime:
    """Serving-side runtime for one decode model: a Generator, the bucket
    plan, metrics and the strict steady-state discipline."""

    backend = "decode"

    def __init__(self, spec: DecodeModelSpec, device):
        self.spec = spec
        self.name = spec.name
        self.device = device
        self.ladder = BucketLadder.from_flag(
            spec.batch_buckets if spec.batch_buckets is not None
            else _flags.flag("serving_buckets"))
        self.steps = int(spec.max_new_tokens)
        self.admitted = False
        self.gen = None
        self._warmed = set()                # {(B, P, C)}
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
        self.gen = Generator(self.spec.layer,
                             seq_buckets=self.spec.seq_buckets,
                             max_len=self.spec.max_len, device=self.device)
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

    def warmup(self):
        """Run every (batch-bucket x prefill-bucket) pair once on zeros:
        prefill, then the full decode length.  These are the shapes
        steady-state traffic may use."""
        eos = self.spec.eos_token_id
        for B in self.ladder:
            for P, C in self._plan:
                ids = np.zeros((B, P), np.int32)
                start = np.full((B,), P - 1, np.int32)
                cache, logits0 = self.gen.prefill(ids, start, C)
                self.gen.decode(cache, logits0, start, P, self.steps, eos)
                self._warmed.add((B, P, C))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
        — the worker slices per request)."""
        prompts = [p for r in batch.requests for p in r.prompts]
        # pad rows up to the batch bucket with 1-token dummy prompts
        prompts += [np.zeros((1,), np.int32)] * (batch.bucket - batch.rows)
        P = self.gen.prefill_bucket(max(p.size for p in prompts))
        C = self.gen.cache_bucket(P, self.steps)
        B = batch.bucket
        cold = (B, P, C) not in self._warmed
        if cold:
            if bool(_flags.flag("serving_strict")):
                raise PreconditionNotMetError(
                    f"decode model {self.name!r}: (batch={B}, prompt="
                    f"{P}, cache={C}) was not warmed "
                    "(FLAGS_serving_strict=True refuses steady-state "
                    "cold shapes — extend the ladders and re-warm)")
            self.bump(steady_compiles=1)
            self._warmed.add((B, P, C))
        ids, start = self.gen.pack_prompts(prompts, P)
        cache, logits0 = self.gen.prefill(ids, start, C)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # one fence per batch:
        t_first = time.perf_counter()             # the first token is ready
        for r in batch.requests:
            r.t_first = t_first
        toks = self.gen.decode(cache, logits0, start, P, self.steps,
                               self.spec.eos_token_id)
        return toks.cpu().numpy()
