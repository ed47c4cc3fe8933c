"""The slot loop's decode step, eager and as one captured CUDA graph.

The JAX package compiles ONE step executable per (slot count, cache
bucket) (``Generator.step_exec``) and the slot loop calls it once per
token.  Run eagerly on the card, the same step is bound by its host
launches (~220 for GPT-2 small, each a Python call).  Its counterpart
here is one ``torch.cuda.CUDAGraph`` per (S, C, eos, KV dtype): the
step's launches are recorded once and replayed with one call.

A graph reads and writes fixed addresses, so the step owns its state:

  * the slot cache planes and the logits [S, V] f32, updated in place by
    every step (the slot loop's chunks, block pushes and activations
    write into the same tensors);
  * one int32 input vector ``[start | finished | active | pos]`` (3S + 1
    values), filled from a pinned host buffer with one copy a step;
  * one int32 output ``[tok; finished]`` [2, S], read back with one copy
    a step, as the JAX loop reads ``np.asarray(tok)``.

The step takes its position as a 0-d device tensor
(``GPTModel.forward_cached``), so nothing in it reads back to the host.
A failed capture or replay raises: there is no eager fallback.

A replay launches the recorded kernels without running their Python
wrappers, so the wrappers' launch counts (``ops/kernels``) see the
capture only; the captured step counts its replays, and a profiler
trace of the device counts the kernels they launch.
"""
from __future__ import annotations

import weakref

import torch

from ..framework.enforce import PreconditionNotMetError

__all__ = ["SlotStep", "CapturedSlotStep"]


class SlotStep:
    """The slot loop's greedy token step over ``S`` rows at cache length
    ``C``, run eagerly (the CPU's step; on the card the reference the
    captured step is held against).  ``step(start, finished, active,
    pos)`` takes the host's per-row vectors and position and returns
    (finished bool [S], tok int32 [S]) as numpy."""

    captured = False

    def __init__(self, gen, S, C, end):
        self.S, self.C = int(S), int(C)
        self._owner = None
        self.device = gen.device
        self._fn = gen._build_step(int(end))
        cuda = self.device.type == "cuda"
        with torch.inference_mode():
            self.cache = gen.init_slot_cache(self.S, self.C)
            self.logits = torch.zeros((self.S, gen._vocab_size()),
                                      dtype=torch.float32,
                                      device=self.device)
            self._inp = torch.zeros(3 * self.S + 1, dtype=torch.int32,
                                    device=self.device)
            self._out = torch.zeros((2, self.S), dtype=torch.int32,
                                    device=self.device)
        self._inp_host = torch.zeros(3 * self.S + 1, dtype=torch.int32,
                                     pin_memory=cuda)
        self._out_host = torch.zeros((2, self.S), dtype=torch.int32,
                                     pin_memory=cuda)

    def _body(self):
        S, inp = self.S, self._inp
        _, nlog, fin, tok = self._fn(
            self.cache, self.logits, inp[:S], inp[S:2 * S].bool(),
            inp[2 * S:3 * S].bool(), inp[3 * S])
        self.logits.copy_(nlog)
        self._out[0].copy_(tok)
        self._out[1].copy_(fin)

    def _run(self):
        self._body()

    def __call__(self, start, finished, active, pos):
        S = self.S
        h = self._inp_host.numpy()
        h[:S] = start
        h[S:2 * S] = finished
        h[2 * S:3 * S] = active
        h[3 * S] = pos
        with torch.inference_mode():
            self._inp.copy_(self._inp_host, non_blocking=True)
            self._run()
            self._out_host.copy_(self._out, non_blocking=True)
        if self.device.type == "cuda":
            # the pinned buffers are reused next step: fence both copies
            torch.cuda.current_stream(self.device).synchronize()
        out = self._out_host.numpy()
        return out[1].astype(bool), out[0].copy()

    def claim(self, loop):
        """Hold this step (its planes are one loop's state) for ``loop``;
        raises while another live loop holds it."""
        owner = self._owner() if self._owner is not None else None
        if owner is not None and owner is not loop:
            raise PreconditionNotMetError(
                f"the slot step (S={self.S}, C={self.C}) is held by another "
                "slot loop of this Generator; close that loop first")
        self._owner = weakref.ref(loop)

    def release(self, loop):
        if self._owner is not None and self._owner() is loop:
            self._owner = None

    def set_logits(self, i, row):
        """Write slot ``i``'s activation logits ([V] f32) into the
        logits the next step reads."""
        with torch.inference_mode():
            self.logits[int(i)].copy_(row)

    def reset(self):
        """Zero the planes and logits in place (a fresh session)."""
        with torch.inference_mode():
            for c in self.cache:
                for p in c:
                    p.zero_()
            self.logits.zero_()

    def load_state(self, other):
        """Copy another step's planes and logits into this one's."""
        with torch.inference_mode():
            for c, o in zip(self.cache, other.cache):
                for p, q in zip(c, o):
                    p.copy_(q)
            self.logits.copy_(other.logits)


class CapturedSlotStep(SlotStep):
    """:class:`SlotStep` as one CUDA graph: warmed up on a side stream
    (the kernels build and cuBLAS sets up there), captured once, then
    replayed per call on the caller's current stream.  ``replays``
    counts the replays."""

    captured = True

    def __init__(self, gen, S, C, end):
        super().__init__(gen, S, C, end)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        # the warm-up runs the step with no row active: it writes column
        # 0 of every row, which reset() clears below
        with torch.inference_mode(), torch.cuda.stream(side):
            for _ in range(2):
                self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        # thread-local: a serving thread using the card meanwhile does not
        # invalidate this capture
        with torch.inference_mode(), torch.cuda.graph(
                self._graph, stream=side, capture_error_mode="thread_local"):
            self._body()
        torch.cuda.synchronize(self.device)
        self.replays = 0
        self.reset()

    def _run(self):
        self._graph.replay()
        self.replays += 1
