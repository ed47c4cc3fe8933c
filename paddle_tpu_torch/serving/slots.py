"""Iteration-level continuous batching: the slot-based decode loop.

Counterpart of ``paddle_tpu/serving/slots.py``, for the plain and the
speculative Generator.
The run-to-completion decode path (serving/decode.py ``execute``) runs
every batch to its last step: a 5-token request waits on its 500-token
neighbor and arrivals queue until the whole batch drains.  This module
hoists the token loop onto the HOST (Orca-style iteration-level
scheduling) over the Generator's two slot programs per (slot count,
cache length):

  * ``step_exec(S, C)``: one greedy token step for all ``S`` slot rows
    (or one speculative propose/verify/accept step under a draft pair),
    one captured CUDA graph on the card (text/graphs.py);
  * ``prefill_chunk``: one Sarathi-style prefill chunk, ``T``
    prompt tokens of ONE joining row, interleaved between decode steps
    so long prompts never stall the running rows' token cadence.

The scheduling invariants that make slot reuse token-exact against a
per-request ``generate()`` of the same prompt:

  * **scalar lockstep position**: every dispatch writes at the shared
    ``pos``; a joining request is a row whose validity window restarts
    (``start[s]`` moves), never a new graph or a cache copy;
  * **dead-column garbage discipline**: the step does NOT mask its cache
    write per row (a per-row blend would copy whole planes every step).
    A step therefore writes garbage into inactive rows' lanes of the
    written column, which is safe because every such column is DEAD: it
    lies inside the row's pending chunk window ``[act-Pb, act)``
    (rewritten by the row's own chunks, scheduled after the last garbage
    write, see ``_dispatch_chunks``), below the row's ``start`` (never
    visible), or at ``>= act`` where the row's own steps rewrite it
    before any commit exposes it;
  * **planned-activation chunk schedule**: a prompt of ``Lp`` tokens
    left-pads into ``n = ceil(Lp/T)`` chunks.  Columns are PER-ROW state,
    so the prompt block is free to end wherever the row starts
    generating: admission at position ``a`` plans the activation at
    ``act = max(Pb, a + n)`` (``Pb = n*T``; the ``Pb`` floor keeps the
    left-padded block at non-negative columns), and the chunks write
    ``[act-Pb, act)``.  Chunk ``k`` dispatches in the iteration at which
    ``pos > act - n + k``: one chunk per iteration over the last ``n``
    iterations before activation, so a long prompt costs ``n``
    iterations of everyone's token cadence, not ``Lp``, AND the chunk
    rewrite of each column lands strictly after the last decode step
    that could garbage it (chunk ``k`` covers ``[act-Pb+kT,
    act-Pb+(k+1)T)`` and every step from that iteration on writes
    columns ``>= act-n+k+1``; overlap would need ``k >= n``).  The row
    activates exactly when the shared ``pos`` reaches ``act``;
  * **speculative strides** commit 1..gamma+1 tokens a step; the host
    clamps a step's commit (``max_commit``) so the position lands
    exactly on the nearest planned activation;
  * **bounded ring sessions**: the validity window compares absolute
    columns, so ``pos`` must stay inside ``[0, C)``: a request admits
    only if ``act + max_new`` (+ gamma, the verify block's overshoot)
    fits, and when the FIFO head cannot fit the loop drains and restarts
    the session at ``pos = 0``.

Host-side lock-and-condvar concurrency exactly like scheduler.py; the
driver thread owns every device dispatch.  Token-level occupancy
accounting (an EWMA of generating rows over ``S``, joined/retired
counters, a TTFT window) feeds ``Server.stats()`` and ``signals()``.

Parked sessions (serving/sessions.py): with a session store, a row that
carries a ``session_id`` parks its transcript and KV columns into the
store when it retires (before its future resolves), and a later turn
submitted with the snapshot restores those columns into a joining row
and chunk-prefills only the new tokens; ``park_sessions`` parks every
live session row mid-generation (a server's graceful drain).  Without a
store a ``session_id`` is ignored.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.enforce import (InvalidArgumentError, OutOfRangeError,
                                 UnavailableError)
from ..profiler.metrics import LatencyWindow

__all__ = ["SlotLoop", "SlotRequest"]

_EMPTY, _PREFILL, _GEN = 0, 1, 2


@dataclass
class SlotRequest:
    """One row of slot-loop work: a prompt to continue by ``max_new``
    tokens.  ``future`` resolves to int32 [max_new] generated ids.

    The restore fields are filled by ``SlotLoop.submit`` when a session
    snapshot rides along: ``prompt`` then holds the VIRTUAL prompt (the
    transcript a full re-prefill would run), ``preseed`` the tokens the
    parked turn already emitted (they count against ``max_new`` and are
    replayed into the result), ``planes``/``planes_len`` the host KV
    tree covering the leading ``planes_len`` transcript tokens, and
    ``resume_logits``/``resume_cur`` the activation payload of a
    mid-generation resume (plain / speculative loop)."""

    prompt: np.ndarray
    max_new: int
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)
    session_id: Optional[str] = None
    preseed: List[int] = field(default_factory=list)
    planes: Any = None
    planes_len: int = 0
    resume_logits: Optional[torch.Tensor] = None
    resume_cur: Optional[int] = None
    snapshot: Any = None                # the original (re-parked on drain)


class _Slot:
    __slots__ = ("state", "req", "chunks", "next_chunk", "act",
                 "start", "emitted", "_act_logits", "restore", "pin")

    def __init__(self):
        self.state = _EMPTY
        self.req: Optional[SlotRequest] = None
        self.chunks: List[np.ndarray] = []
        self.next_chunk = 0
        self.act = 0                    # planned activation position
        self.start = 0
        self.emitted: List[int] = []
        self.restore: List[tuple] = []  # pending (block, base) pushes
        self.pin = None                 # prefix-cache pin held until pushed


class SlotLoop:
    """The iteration-level decode loop for one Generator.  ``submit``
    enqueues a request and returns a Future; a dedicated driver thread
    admits requests into free slots at token boundaries, interleaves
    prefill chunks, retires finished rows, and keeps the occupancy/TTFT
    accounting.  Unit-testable without a Server; serving/decode.py wires
    it behind FLAGS_decode_slots."""

    def __init__(self, gen, slots: int, cache_len: int, chunk: int,
                 eos_token_id: Optional[int] = None,
                 model: str = "decode", prefix_cache=None,
                 session_store=None):
        if slots < 1:
            raise InvalidArgumentError(
                f"slot loop needs >= 1 slot, got {slots}")
        self._gen = gen
        self.S = int(slots)
        self.C = int(cache_len)
        self.T = int(chunk)
        self._end = -1 if eos_token_id is None else int(eos_token_id)
        self._model = model
        self._spec = getattr(gen, "_draft", None) is not None
        self._gamma = int(gen.gamma) if self._spec else 0
        # built once here (on the card: captured); every later dispatch
        # is a plain call, so steady traffic builds nothing.  The step
        # owns the cache planes: this loop holds it until close()
        self._step = gen.step_exec(self.S, self.C, eos_token_id)
        self._step.claim(self)
        self._prefix = prefix_cache
        self._sessions = session_store
        # the KV storage of the step's planes (part of its key): a
        # snapshot restores only into the storage it was parked from
        self._kv_dtype = str(_flags.flag("kv_cache_dtype")).lower()
        self._park_req = None           # guarded-by: _cond (drain handshake)
        self._cond = threading.Condition()
        self._pending: "deque[SlotRequest]" = deque()       # guarded-by: _cond
        self._slots = [_Slot() for _ in range(self.S)]  # driver-thread-owned
        self._closed = False                                # guarded-by: _cond
        self._dead: Optional[BaseException] = None          # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None     # guarded-by: _cond
        # device/host loop state (driver-thread-owned after start)
        self._reset_session()
        self.counters = {"joined": 0, "retired": 0, "steps": 0,
                         "chunks": 0, "session_resets": 0,
                         "emitted_tokens": 0, "parked": 0, "restored": 0,
                         "prefix_hit_tokens": 0, "restore_pushes": 0}
        self._occupancy = 0.0               # EWMA of generating/S
        self._ttft = LatencyWindow(maxlen=512)
        self._accepted = self._proposed = 0   # speculative acceptance

    # -- session state -------------------------------------------------------
    def _reset_session(self):
        """Fresh ring session: position 0, zero planes and logits (the
        step owns them, text/graphs.py), neutral per-row vectors."""
        self.pos = 0
        self._step.reset()
        self._cache = self._step.cache
        self._start = np.zeros((self.S,), np.int32)
        self._finished = np.ones((self.S,), bool)
        self._active = np.zeros((self.S,), bool)
        # the speculative step's input: each row's next token
        self._cur = np.zeros((self.S,), np.int32)

    def _need(self, prompt_len: int, max_new: int) -> int:
        """Ring columns a request consumes: padded chunk span + its own
        token budget (+ the speculative verify block's overshoot)."""
        n_chunks = -(-int(prompt_len) // self.T)
        return n_chunks * self.T + int(max_new) + self._gamma

    def _min_need(self, req: "SlotRequest") -> int:
        """Minimum ring columns ``req`` can ever consume (admitted at
        ``pos = 0``): the plane-restore path needs only the transcript
        itself (restored columns are exact, never chunk-padded), the
        plain path the padded chunk span."""
        budget = req.max_new - len(req.preseed)
        if req.planes_len >= self.T:
            return req.prompt.size + budget + self._gamma
        return self._need(req.prompt.size, budget)

    def _planes_fit(self, planes, n) -> bool:
        """The snapshot's plane tree has this loop's cache structure, and
        each plane this loop's dtype, heads and head width over ``n``
        columns of one row."""
        def fits(tree, ref):
            if torch.is_tensor(ref):
                return (torch.is_tensor(tree) and tree.dtype == ref.dtype
                        and tuple(tree.shape) == (1, ref.shape[1], n,
                                                  ref.shape[3]))
            return (isinstance(tree, (list, tuple)) and len(tree) == len(ref)
                    and all(fits(a, b) for a, b in zip(tree, ref)))
        return fits(planes, self._cache)

    def _prepare_restore(self, req: "SlotRequest", snap) -> None:
        """Fold a session snapshot into the request.  Any mismatch
        (transcript not a prefix of the prompt, wrong loop flavor, wrong
        KV storage, missing, sub-chunk or misshapen planes) quietly
        degrades, first to a plane-less restore, then to a plain submit,
        which give the tokens of the full re-prefill: a snapshot can make
        the turn cheaper, never wrong."""
        p = req.prompt
        toks = np.asarray(snap.tokens, np.int32)
        if snap.remaining > 0:
            # mid-generation park (drain): the client resubmitted the
            # ORIGINAL request; the transcript extends its prompt by the
            # tokens already emitted: resume, replaying those
            if toks.size != p.size + len(snap.emitted) \
                    or not np.array_equal(toks[:p.size], p):
                return
            req.prompt = toks
            req.preseed = list(snap.emitted)[:req.max_new]
        else:
            # completed turn: the follow-up prompt must extend the
            # transcript (history ++ new turn), leaving a real suffix
            if toks.size >= p.size \
                    or not np.array_equal(p[:toks.size], toks):
                return
        req.snapshot = snap
        if (snap.planes is None or toks.size < self.T
                or bool(snap.spec) != self._spec
                or snap.kv_dtype != self._kv_dtype
                or not self._planes_fit(snap.planes, int(toks.size))):
            return                      # plane-less: plain chunks
        if snap.remaining > 0:
            if self._spec and snap.cur is None:
                return
            if not self._spec and (snap.logits is None or
                                   snap.logits.numel()
                                   != self._step.logits.shape[1]):
                return
            req.resume_logits = None if snap.logits is None \
                else snap.logits.reshape(-1)
            req.resume_cur = None if snap.cur is None else int(snap.cur)
        req.planes = snap.planes
        req.planes_len = int(toks.size)

    # -- producer ------------------------------------------------------------
    def submit(self, prompt, max_new: int, session_id: Optional[str] = None,
               snapshot=None) -> Future:
        """Enqueue a request; with ``snapshot`` (a SessionSnapshot of the
        same session, taken from the store) the row restores the parked
        columns instead of prefilling them."""
        p = np.asarray(prompt).reshape(-1).astype(np.int32)
        if p.size == 0:
            raise InvalidArgumentError("empty prompt (0 tokens)")
        mn = int(max_new)
        if mn < 1:
            raise InvalidArgumentError("max_new must be >= 1")
        req = SlotRequest(prompt=p, max_new=mn, session_id=session_id)
        if snapshot is not None:
            self._prepare_restore(req, snapshot)
        if len(req.preseed) >= mn:
            # the parked turn already emitted the whole budget: resolve
            # without touching a slot (deterministic replay)
            req.future.set_result(np.asarray(req.preseed[:mn], np.int32))
            return req.future
        if self._min_need(req) > self.C:
            raise OutOfRangeError(
                f"prompt of {p.size} tokens + max_new {mn} can never fit "
                f"the slot cache (need {self._min_need(req)} columns, "
                f"C={self.C}, chunk={self.T}, gamma={self._gamma})")
        with self._cond:
            if self._closed:
                raise UnavailableError("slot loop is closed")
            if self._dead is not None:
                raise UnavailableError(
                    f"slot loop died: {self._dead!r}")
            self._pending.append(req)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drive, name=f"slot-loop-{self._model}",
                    daemon=True)
                self._thread.start()
            self._cond.notify_all()
        return req.future

    def close(self):
        """Stop the driver once in-flight work drains; pending requests
        not yet admitted fail with UnavailableError."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=30)
        if t is None or not t.is_alive():
            self._step.release(self)

    # -- the driver loop -----------------------------------------------------
    def _drive(self):
        try:
            if self._gen.device.type == "cuda":
                torch.cuda.set_device(self._gen.device)
            while True:
                with self._cond:
                    while (not self._pending
                           and all(s.state == _EMPTY
                                   for s in self._slots)):
                        # nothing live to park: ack a drain's handshake
                        self._ack_park()
                        if self._closed:
                            return
                        self._cond.wait(0.05)
                    if self._closed and not self._any_live():
                        self._fail_pending(UnavailableError(
                            "slot loop closed before this request was "
                            "admitted"))
                        return
                    park, self._park_req = self._park_req, None
                    if park is not None:
                        self._do_park(park)
                    self._admit()
                self._dispatch_chunks()
                self._activate()
                if not any(s.state == _GEN for s in self._slots):
                    self._fast_forward()
                    continue
                self._decode_step()
        except Exception as e:   # noqa: BLE001 — fail the rows, not the host
            with self._cond:
                self._dead = e
                self._ack_park()
                for s in self._slots:
                    if s.req is not None and not s.req.future.done():
                        s.req.future.set_exception(e)
                    s.state, s.req = _EMPTY, None
                self._fail_pending(e)

    def _any_live(self) -> bool:
        return bool(self._pending) or any(s.state != _EMPTY
                                          for s in self._slots)

    def _fail_pending(self, exc):
        while self._pending:
            r = self._pending.popleft()
            if not r.future.done():
                r.future.set_exception(exc)

    # -- admission (FIFO, no starvation) -------------------------------------
    def _plan_act(self, prompt_len: int) -> int:
        """The planned activation position for a prompt admitted NOW:
        one chunk dispatches per loop iteration and the shared ``pos``
        advances at most one token boundary per iteration, so the
        earliest exact meeting point is ``pos + n`` chunks out, floored
        at ``Pb`` so the left-padded block stays at columns >= 0."""
        n_chunks = -(-int(prompt_len) // self.T)
        return max(n_chunks * self.T, self.pos + n_chunks)

    def _plan_act_req(self, req: "SlotRequest") -> int:
        """Planned activation for a request admitted NOW, by mode.  A
        plane-restore row prefills only its uncached suffix (``n_s``
        chunks; none for a mid-generation resume), floored at the
        transcript length so the restored block stays at columns >= 0:
        restored columns are exact, never chunk-padded."""
        if req.planes_len >= self.T:
            return max(req.prompt.size, self.pos + self._suffix_chunks(req))
        return self._plan_act(req.prompt.size)

    def _suffix_chunks(self, req: "SlotRequest") -> int:
        """Chunks of a restored row: the tokens past the last whole
        restored block, in T-wide chunks."""
        ls = req.prompt.size - (req.planes_len // self.T) * self.T \
            if req.planes_len < req.prompt.size else 0
        return -(-ls // self.T)

    @staticmethod
    def _host_block(planes, lo, hi):
        """Columns ``[lo, hi)`` of a host plane tree, same structure."""
        if isinstance(planes, (list, tuple)):
            kids = [SlotLoop._host_block(p, lo, hi) for p in planes]
            return kids if isinstance(planes, list) else tuple(kids)
        return planes[:, :, lo:hi]

    def _admit(self):
        """Move pending FIFO heads into empty slots at the current token
        boundary.  Strict FIFO: if the head does not fit the remaining
        ring columns, nothing behind it jumps the line; the loop drains
        and restarts the session instead."""
        for slot in self._slots:
            if not self._pending or slot.state != _EMPTY:
                continue
            head = self._pending[0]
            if self._plan_act_req(head) + head.max_new \
                    - len(head.preseed) + self._gamma > self.C:
                if all(s.state == _EMPTY for s in self._slots) \
                        and self.pos > 0:
                    # whole loop idle: restart the ring session (windows
                    # restart, planes stay; stale columns are invisible)
                    self.pos = 0
                    self.counters["session_resets"] += 1
                else:
                    break                        # drain first
            # installed before it leaves the queue: a failing install
            # fails the request with the loop instead of losing it
            self._install(slot, head)
            self._pending.popleft()

    def _install(self, slot: "_Slot", head: "SlotRequest"):
        """Stage one admitted request into a slot row: pick the restore
        source (session planes, else a prefix-cache hit, else none), queue
        the restore block pushes, and plan the chunks.  All three paths
        meet the same activation at ``slot.act`` and give the tokens of
        the plain full prefill of ``head.prompt``."""
        slot.restore = []
        slot.pin = None
        if head.planes_len >= self.T:
            self._install_session(slot, head)
        else:
            self._install_prefill(slot, head)
        slot.req = head
        slot.next_chunk = 0
        slot.emitted = list(head.preseed)
        slot.state = _PREFILL
        self.counters["joined"] += 1

    def _install_session(self, slot: "_Slot", head: "SlotRequest"):
        """The session-snapshot restore (host planes): whole T-blocks of
        the parked columns are pushed, the tokens past them re-run as
        chunks (recomputed K/V equal the parked ones)."""
        p, lp, lc = head.prompt, int(head.prompt.size), head.planes_len
        n_s = self._suffix_chunks(head)
        slot.act = max(lp, self.pos + n_s)
        slot.start = slot.act - lp
        for j in range(lc // self.T):
            slot.restore.append(
                (self._host_block(head.planes, j * self.T, (j + 1) * self.T),
                 slot.start + j * self.T))
        if lc % self.T and lc == lp:
            # mid-generation resume: no suffix chunk recomputes the
            # partial tail block, so restore it as a T-wide overlap slice
            # ending exactly at the transcript's edge
            slot.restore.append(
                (self._host_block(head.planes, lc - self.T, lc),
                 slot.start + lc - self.T))
        suffix = p[lp - n_s * self.T:] if n_s else p[:0]
        slot.chunks = [suffix[k * self.T:(k + 1) * self.T]
                       for k in range(n_s)]
        self.counters["restored"] += 1

    def _install_prefill(self, slot: "_Slot", head: "SlotRequest"):
        """A prefix-cache hit (device blocks) or the plain full prefill."""
        p = head.prompt
        lp = int(p.size)
        blocks, pin = ([], None)
        if self._prefix is not None and lp > self.T:
            # clamp so >= 1 true suffix token remains: the final chunk's
            # last column must be the last prompt token (it produces the
            # activation logits)
            blocks, pin = self._prefix.lookup(
                p.tolist(), max_blocks=(lp - 1) // self.T)
        if blocks:
            # -- prefix-cache hit (device blocks) -------------------------
            lhit = len(blocks) * self.T
            ls = lp - lhit
            n_s = -(-ls // self.T)
            slot.act = max(lp, self.pos + n_s)
            slot.start = slot.act - lp
            slot.restore = [(b, slot.start + j * self.T)
                            for j, b in enumerate(blocks)]
            slot.pin = pin
            # overlap-repeat: the first suffix chunk re-feeds the last
            # n_s*T - ls cached tokens (recomputed K/V equal the restored
            # ones, so rewriting restored columns is free)
            suffix = p[lp - n_s * self.T:]
            slot.chunks = [suffix[k * self.T:(k + 1) * self.T]
                           for k in range(n_s)]
            self.counters["prefix_hit_tokens"] += lhit
        else:
            if pin:
                self._prefix.release(pin)
            # -- plain path: full left-padded chunked prefill -------------
            n_chunks = -(-lp // self.T)
            pb = n_chunks * self.T
            padded = np.zeros((pb,), np.int32)
            padded[pb - lp:] = p
            slot.chunks = [padded[k * self.T:(k + 1) * self.T]
                           for k in range(n_chunks)]
            slot.act = self._plan_act(lp)
            slot.start = slot.act - lp

    # -- chunked prefill -----------------------------------------------------
    def _dispatch_chunks(self):
        """One chunk per prefilling slot per iteration, scheduled over the
        LAST ``n`` iterations before the row activates: chunk ``k``
        dispatches once ``pos > act - n + k``.  That late placement is
        load-bearing: the step writes unmasked garbage into inactive
        rows' lanes (dead-column discipline, module docstring), and
        dispatching chunk ``k`` only after the step at ``act - n + k``
        guarantees the chunk's column block is rewritten strictly after
        the last step that could garbage it.  Chunk writes carry their
        own column base, independent of ``pos``."""
        for i, slot in enumerate(self._slots):
            if slot.state != _PREFILL:
                continue
            self._push_restores(i, slot)
            if slot.restore:
                # chunks READ restored columns through attention: hold
                # them until every pending push has dispatched
                continue
            n = len(slot.chunks)
            while (slot.next_chunk < n
                   and slot.act - n + slot.next_chunk < self.pos):
                base = slot.act - n * self.T + slot.next_chunk * self.T
                logits = self._gen.prefill_chunk(
                    self._cache, slot.chunks[slot.next_chunk],
                    [slot.start], i, base)
                slot.next_chunk += 1
                self.counters["chunks"] += 1
                if slot.next_chunk == n:
                    # final chunk: its last column is the last prompt
                    # token; these are the row's activation logits
                    slot._act_logits = logits

    def _push_restores(self, i: int, slot: "_Slot"):
        """Dispatch every push-eligible restore block of one row.  A block
        ``[base, base+T)`` is eligible once ``base + T <= pos``: every
        later step writes columns ``>= pos``, so the pushed columns can
        never be garbaged again.  The prefix-cache pin releases when the
        last block is pushed: from then on the restored columns live in
        the row, not the trie."""
        while slot.restore and slot.restore[0][1] + self.T <= self.pos:
            block, base = slot.restore.pop(0)
            self._gen.push_block(self._cache, block, i, base)
            self.counters["restore_pushes"] += 1
        if not slot.restore and slot.pin is not None:
            self._prefix.release(slot.pin)
            slot.pin = None

    # -- activation ----------------------------------------------------------
    def _activate(self):
        for i, slot in enumerate(self._slots):
            if slot.state != _PREFILL \
                    or slot.next_chunk < len(slot.chunks) \
                    or slot.restore \
                    or self.pos != slot.act:
                continue
            self._start[i] = slot.start
            self._finished[i] = False
            self._active[i] = True
            if not slot.chunks:
                # mid-generation resume: no chunk produced the activation
                # payload; the snapshot carried the values the loop held
                # for this row when it parked
                if self._spec:
                    self._cur[i] = slot.req.resume_cur
                else:
                    self._step.set_logits(i, slot.req.resume_logits)
            elif self._spec:
                # the first committed token: the target's argmax over the
                # final chunk's logits
                self._cur[i] = int(slot._act_logits.argmax())
            else:
                self._step.set_logits(i, slot._act_logits)
            slot._act_logits = None
            slot.state = _GEN
            self._publish_prefix(i, slot)

    def _fast_forward(self):
        """No generating rows: the position counter is host state, so jump
        it to the EARLIEST planned activation instead of running empty
        steps (never past it: a later row's window must still start
        exactly at its own ``act``)."""
        acts = [s.act for s in self._slots if s.state == _PREFILL]
        if acts:
            self.pos = max(self.pos, min(acts))

    # -- one decode iteration ------------------------------------------------
    def _decode_step(self):
        gen_slots = [i for i, s in enumerate(self._slots)
                     if s.state == _GEN]
        ratio = len(gen_slots) / self.S
        with self._cond:
            self._occupancy = ratio if self.counters["steps"] == 0 \
                else 0.9 * self._occupancy + 0.1 * ratio
            # counted before the step retires rows: a caller woken by a
            # retiring row's future reads this step already counted
            self.counters["steps"] += 1
        if self._spec:
            self._spec_step(gen_slots)
        else:
            self._plain_step(gen_slots)

    def _plain_step(self, gen_slots):
        self._finished, tok = self._step(self._start, self._finished,
                                         self._active, self.pos)
        self.pos += 1
        for i in gen_slots:
            slot = self._slots[i]
            self._emit(slot, [int(tok[i])])
            if self._finished[i] or len(slot.emitted) >= slot.req.max_new:
                self._retire(i)

    def _spec_step(self, gen_slots):
        # clamp the stride so the commit lands exactly on the nearest
        # activation: a prefilling row's window must start the moment the
        # position reaches its planned column (every remaining PREFILL
        # act is > pos here: rows AT pos activated in this iteration)
        boundaries = [s.act - self.pos
                      for s in self._slots if s.state == _PREFILL]
        mc = min([self._gamma + 1] + [b for b in boundaries if b > 0])
        self._cur, self._finished, e, k, n = self._step(
            self._start, self._finished, self._active, self._cur,
            self.pos, mc)
        self.pos += k
        with self._cond:
            self._accepted += n
            self._proposed += self._gamma
        for i in gen_slots:
            slot = self._slots[i]
            self._emit(slot, [int(t) for t in e[i, :k]])
            if self._finished[i] or len(slot.emitted) >= slot.req.max_new:
                self._retire(i)

    def _emit(self, slot, toks):
        if not slot.emitted:
            self._ttft.observe(time.monotonic() - slot.req.t_submit)
        take = slot.req.max_new - len(slot.emitted)
        slot.emitted.extend(toks[:take])
        self.counters["emitted_tokens"] += min(len(toks), take)

    def _publish_prefix(self, i: int, slot: "_Slot"):
        """Publish the activated row's prompt blocks into the prefix trie.
        Dedup lives in the trie: the pulls run only for blocks not
        already cached, so a hot shared prefix is pulled once.  A pull is
        a copy on the device's stream, ordered before the row's later
        column writes."""
        if self._prefix is None:
            return
        slot_start = slot.start
        self._prefix.publish(
            slot.req.prompt.tolist(),
            lambda j: self._gen.pull_block(self._cache, i,
                                           slot_start + j * self.T, self.T))

    def _park(self, i: int, slot: "_Slot", remaining: int):
        """Snapshot one session row into the store: the row's transcript
        columns ``[start, start + Lc)`` pulled to the host (relative
        positions ``[0, Lc)``; every emitted token's K/V is in the cache,
        the step feeds a token where it emits it), plus the resume
        payload.  Called at turn retire (``remaining == 0``: the
        follow-up turn restores instead of re-prefilling) and at a drain
        (``remaining > 0``)."""
        from .sessions import SessionSnapshot
        req = slot.req
        tokens = req.prompt.tolist() \
            + [int(t) for t in slot.emitted[len(req.preseed):]]
        lc = len(tokens)
        planes = logits = cur = None
        if lc >= self.T:
            planes = self._gen.pull_row(self._cache, i, slot.start, lc)
        if remaining > 0:
            if self._spec:
                cur = int(self._cur[i])
            else:
                with torch.inference_mode():
                    logits = self._step.logits[i].to("cpu", copy=True)
        self._sessions.put(SessionSnapshot(
            session_id=req.session_id, model=self._model, tokens=tokens,
            remaining=int(remaining),
            emitted=[int(t) for t in slot.emitted], planes=planes,
            logits=logits, cur=cur, kv_dtype=self._kv_dtype,
            spec=self._spec))
        self.counters["parked"] += 1

    def _free(self, i):
        slot = self._slots[i]
        slot.state, slot.req = _EMPTY, None
        slot.emitted = []
        slot.restore = []
        self._finished[i] = True
        self._active[i] = False
        self._cur[i] = 0

    def _retire(self, i):
        slot = self._slots[i]
        req = slot.req
        out = np.full((req.max_new,), self._end, np.int32)
        out[:len(slot.emitted)] = slot.emitted
        if req.session_id is not None and self._sessions is not None:
            # park BEFORE the future resolves and the slot frees: a new
            # admission could reuse this row and overwrite the columns
            # the snapshot needs
            self._park(i, slot, remaining=0)
        # eos freeze: every position after finish reads eos, exactly the
        # run-to-completion decode's padding
        req.future.set_result(out)
        self._free(i)
        self.counters["retired"] += 1

    # -- drain-time parking --------------------------------------------------
    def park_sessions(self, timeout: float = 30.0) -> int:
        """Park every session-tagged row and pending request (a graceful
        drain's fast path: a conversation leaves as a snapshot in
        milliseconds instead of decoding to completion).  Generating rows
        snapshot mid-stream (``remaining > 0``) and their futures fail
        with a retryable UnavailableError: the turn, submitted again,
        resumes from the snapshot (or re-prefills) with the same tokens.
        Rows without a session keep decoding.  Thread-safe; the driver
        thread does the pulls (it owns every dispatch).  Returns the
        number of sessions parked."""
        if self._sessions is None:
            return 0
        evt = threading.Event()
        out = [0]
        with self._cond:
            if self._dead is not None or self._thread is None \
                    or not self._any_live():
                return 0
            self._park_req = (evt, out)
            self._cond.notify_all()
        evt.wait(timeout)
        return out[0]

    def _ack_park(self):
        """Release a waiting ``park_sessions`` (caller holds _cond)."""
        if self._park_req is not None:
            self._park_req[0].set()
            self._park_req = None

    def _do_park(self, park):
        """Driver-thread half of :meth:`park_sessions` (called with the
        condition held, between dispatch rounds)."""
        evt, out = park
        try:
            exc = UnavailableError(
                "session parked for drain; submit the turn again",
                retry_after_s=0.05)
            for i, slot in enumerate(self._slots):
                if slot.req is None or slot.req.session_id is None:
                    continue
                if slot.state == _GEN:
                    self._park(i, slot, remaining=slot.req.max_new
                               - len(slot.emitted))
                elif slot.state == _PREFILL:
                    # nothing committed yet: put the original snapshot
                    # back (if one rode in); the turn submitted again
                    # restores or re-prefills from scratch
                    if slot.req.snapshot is not None:
                        self._sessions.put(slot.req.snapshot)
                    if slot.pin is not None:
                        self._prefix.release(slot.pin)
                        slot.pin = None
                out[0] += 1
                if not slot.req.future.done():
                    slot.req.future.set_exception(exc)
                self._free(i)
            keep: "deque[SlotRequest]" = deque()
            while self._pending:
                r = self._pending.popleft()
                if r.session_id is None:
                    keep.append(r)
                    continue
                if r.snapshot is not None:
                    self._sessions.put(r.snapshot)
                if not r.future.done():
                    r.future.set_exception(exc)
                out[0] += 1
            self._pending = keep
        finally:
            evt.set()

    def reset_stats(self):
        """Zero the loop-local accounting (the runtime calls this right
        after its warm-up round trip, so steady-state counters start
        clean)."""
        with self._cond:
            for k in self.counters:
                self.counters[k] = 0
            self._occupancy = 0.0
            self._ttft = LatencyWindow(maxlen=512)
            self._accepted = self._proposed = 0

    # -- observability -------------------------------------------------------
    def signals(self) -> dict:
        """Token-level load snapshot for Server.signals(): the occupancy
        EWMA plus joined/retired counters and queue backlog."""
        with self._cond:
            c = dict(self.counters)
            pending = len(self._pending)
            occ = self._occupancy
        out = {"decode_slot_occupancy_ratio": round(occ, 4),
               "slots_joined_total": c["joined"],
               "slots_retired_total": c["retired"],
               "slot_steps_total": c["steps"],
               "slot_pending": pending}
        if self._sessions is not None:
            out["sessions_parked"] = len(self._sessions)
            out["session_store_bytes"] = self._sessions.nbytes()
        if self._prefix is not None:
            out["prefix_cache_blocks"] = len(self._prefix)
            out["prefix_cache_bytes"] = self._prefix.nbytes()
        return out

    def stats(self) -> dict:
        with self._cond:
            c = dict(self.counters)
            occ = self._occupancy
            ttft = self._ttft.snapshot()
            acc, prop = self._accepted, self._proposed
        out = {"slots": self.S, "cache": self.C, "chunk": self.T,
               "occupancy_ewma": round(occ, 4), **c}
        if ttft["count"]:
            out["ttft_p50_ms"] = round(ttft["p50_ms"], 3)
            out["ttft_p99_ms"] = round(ttft["p99_ms"], 3)
        if self._spec:
            out["spec_accepted"] = acc
            out["spec_proposed"] = prop
            if prop:
                out["spec_acceptance_rate"] = round(acc / prop, 4)
        return out
