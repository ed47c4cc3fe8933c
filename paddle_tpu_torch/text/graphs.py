"""The slot loop's decode steps, eager and as one captured CUDA graph.

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
  * one int32 output ``[tok; finished]`` (2S values), read back with one
    copy a step, as the JAX loop reads ``np.asarray(tok)``.

The step takes its position as a 0-d device tensor
(``GPTModel.forward_cached``), so nothing in it reads back to the host.
A failed capture or replay raises: there is no eager fallback.

A replay launches the recorded kernels without running their Python
wrappers, so the wrappers' launch counts (``ops/kernels``) see the
capture only; the captured step counts its replays, and a profiler
trace of the device counts the kernels they launch.

The speculative step (``SpecSlotStep``, ``CapturedSpecSlotStep``: one
graph per (S, C, eos, KV dtype, gamma)) follows the same discipline
over the (target, draft) cache pair: gamma+1 draft steps, one verify
block, greedy acceptance, all on the device.  It keeps no logits: the
host hands in each row's next token ``cur``, in one packed input
``[start | finished | active | cur | pos | max_commit]`` (4S + 2
values), and reads back ``[e (S x (gamma+1)); cur; finished; ncommit;
n]`` with one copy.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from ..framework.enforce import PreconditionNotMetError

__all__ = ["SlotStep", "CapturedSlotStep", "SpecSlotStep",
           "CapturedSpecSlotStep"]


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
        n_in, n_out = self._io_sizes()
        with torch.inference_mode():
            self.cache = gen.init_slot_cache(self.S, self.C)
            self._init_state(gen)
            self._inp = torch.zeros(n_in, dtype=torch.int32,
                                    device=self.device)
            self._out = torch.zeros(n_out, dtype=torch.int32,
                                    device=self.device)
        self._inp_host = torch.zeros(n_in, dtype=torch.int32,
                                     pin_memory=cuda)
        self._out_host = torch.zeros(n_out, dtype=torch.int32,
                                     pin_memory=cuda)

    def _io_sizes(self):
        """int32 values in: [start | finished | active | pos]; out:
        [tok; finished]."""
        return 3 * self.S + 1, 2 * self.S

    def _init_state(self, gen):
        self.logits = torch.zeros((self.S, gen._vocab_size()),
                                  dtype=torch.float32, device=self.device)

    def _body(self):
        S, inp = self.S, self._inp
        _, nlog, fin, tok = self._fn(
            self.cache, self.logits, inp[:S], inp[S:2 * S].bool(),
            inp[2 * S:3 * S].bool(), inp[3 * S])
        self.logits.copy_(nlog)
        self._out[:S].copy_(tok)
        self._out[S:].copy_(fin)

    def _run(self):
        self._body()

    def _exchange(self, *parts):
        """Pack the host's vectors and scalars, in order, into the pinned
        input, run the step, and return the pinned output as numpy."""
        h = self._inp_host.numpy()
        i = 0
        for part in parts:
            n = np.size(part)
            h[i:i + n] = part
            i += n
        with torch.inference_mode():
            self._inp.copy_(self._inp_host, non_blocking=True)
            self._run()
            self._out_host.copy_(self._out, non_blocking=True)
        if self.device.type == "cuda":
            # the pinned buffers are reused next step: fence both copies
            torch.cuda.current_stream(self.device).synchronize()
        return self._out_host.numpy()

    def __call__(self, start, finished, active, pos):
        S = self.S
        out = self._exchange(start, finished, active, pos)
        return out[S:].astype(bool), out[:S].copy()

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

    def planes(self):
        """Every cache plane the step owns."""
        return [p for c in self.cache for p in c]

    def _state(self):
        return self.planes() + [self.logits]

    def reset(self):
        """Zero the planes and logits in place (a fresh session)."""
        with torch.inference_mode():
            for p in self._state():
                p.zero_()

    def load_state(self, other):
        """Copy another step's planes and logits into this one's."""
        with torch.inference_mode():
            for p, q in zip(self._state(), other._state()):
                p.copy_(q)


class SpecSlotStep(SlotStep):
    """The slot loop's speculative step over ``S`` rows at cache length
    ``C`` (``SpeculativeGenerator._build_step``), run eagerly.
    ``step(start, finished, active, cur, pos, max_commit)`` returns
    (cur int32 [S], finished bool [S], e int32 [S, gamma+1], ncommit,
    n) as numpy and ints."""

    def __init__(self, gen, S, C, end):
        self.G1 = gen.gamma + 1
        super().__init__(gen, S, C, end)

    def _io_sizes(self):
        """int32 values in: [start | finished | active | cur | pos |
        max_commit]; out: [e (S x G1); cur; finished; ncommit; n]."""
        return 4 * self.S + 2, self.S * self.G1 + 2 * self.S + 2

    def _init_state(self, gen):
        pass                         # no logits: the host passes cur

    def _body(self):
        S, G1, inp, out = self.S, self.G1, self._inp, self._out
        _, cur, fin, e, ncommit, n = self._fn(
            self.cache, inp[3 * S:4 * S], inp[:S], inp[S:2 * S].bool(),
            inp[2 * S:3 * S].bool(), inp[4 * S], inp[4 * S + 1])
        k = S * G1
        out[:k].copy_(e.reshape(-1))
        out[k:k + S].copy_(cur)
        out[k + S:k + 2 * S].copy_(fin)
        out[k + 2 * S].copy_(ncommit)
        out[k + 2 * S + 1].copy_(n)

    def __call__(self, start, finished, active, cur, pos, max_commit):
        S, G1 = self.S, self.G1
        out = self._exchange(start, finished, active, cur, pos, max_commit)
        k = S * G1
        return (out[k:k + S].copy(), out[k + S:k + 2 * S].astype(bool),
                out[:k].reshape(S, G1).copy(), int(out[k + 2 * S]),
                int(out[k + 2 * S + 1]))

    def planes(self):
        """Every plane of both caches, the target's first."""
        return [p for part in self.cache for c in part for p in c]

    def _state(self):
        return self.planes()


class _Captured:
    """A step as one CUDA graph: warmed up on a side stream (the kernels
    build and cuBLAS sets up there), captured once, then replayed per
    call on the caller's current stream.  ``replays`` counts the
    replays."""

    captured = True

    def _capture(self):
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        # the warm-up runs the step with no row active: it writes the
        # first columns of every row, which reset() clears below
        with torch.inference_mode(), torch.cuda.stream(side):
            for _ in range(2):
                self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        # the captured graph is kept beside its executable so that its
        # kernel nodes can be read back (``raw_cuda_graph``)
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        # thread-local: a serving thread using the card meanwhile does not
        # invalidate this capture
        with torch.inference_mode(), torch.cuda.graph(
                self._graph, stream=side, capture_error_mode="thread_local"):
            self._body()
        self._graph.instantiate()
        torch.cuda.synchronize(self.device)
        self.replays = 0
        self.reset()

    def _run(self):
        self._graph.replay()
        self.replays += 1


class CapturedSlotStep(_Captured, SlotStep):
    """:class:`SlotStep` as one CUDA graph."""

    def __init__(self, gen, S, C, end):
        SlotStep.__init__(self, gen, S, C, end)
        self._capture()


class CapturedSpecSlotStep(_Captured, SpecSlotStep):
    """:class:`SpecSlotStep` as one CUDA graph."""

    def __init__(self, gen, S, C, end):
        SpecSlotStep.__init__(self, gen, S, C, end)
        self._capture()
