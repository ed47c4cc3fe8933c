"""The single-device train step.

Counterpart of ``paddle_tpu/parallel/train_step.py`` (``TrainStep``) on
one device.  One call runs forward, loss, backward and the optimizer
update over the layer's f32 master parameters.  The loss is
``loss_fn(layer(*inputs), label)`` when a ``loss_fn`` is given (e.g.
``nn.CrossEntropyLoss()``), else the layer's own output from
``layer(*inputs[, label])``.  Buffers (BatchNorm's running statistics)
are passed as they are, never cast, and a layer updates them in place
once per forward (once per step without accumulation).  The options:

* ``compute_dtype``: the masters are cast inside the step
  (``torch.func.functional_call`` over cast copies, as JAX's
  ``_cast_compute``), so the forward and backward run in that dtype and
  the gradients land in f32 on the masters; float inputs are cast too;
* ``accumulate_steps=k``: the batch splits into k microbatches along its
  first axis, their gradients and losses are averaged, the optimizer
  runs once;
* ``grad_scaler``: the loss is scaled before the backward and the
  gradients unscaled after it;
* the numerics sentinel (``sentinel=True`` or ``FLAGS_train_sentinel``):
  a step whose loss or any gradient is non-finite commits nothing (the
  parameters and the optimizer moments keep their values; the step count
  advances) and reports to the ``grad_scaler``;
* ``seed``: dropout in step t draws from a generator seeded from
  (seed, t), the same for every microbatch of the step, so two
  TrainSteps with one seed draw the same masks.

Not in this slice: ``mesh``, ``zero``, ``localsgd``, ``dgc``, pipeline
layers and ``remat`` raise :class:`UnimplementedError`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.enforce import InvalidArgumentError, UnimplementedError
from ..framework.flags import flag
from ..framework.place import DeviceLike, module_device, resolve_device
from ..framework.random import use_generator

# the values under which each option of later slices is off
_NOT_PORTED = {"mesh": (None,), "remat": (False,), "zero": (0,),
               "localsgd_k": (0, 1), "dgc_sparsity": (0.0,)}


class TrainStep:
    """``loss = loss_fn(layer(*inputs), label)`` (or ``layer(*inputs[,
    label])`` without a ``loss_fn``), its gradient and one optimizer
    update per call.  Returns the step's f32 loss (the mean over
    microbatches) as a 0-d tensor."""

    def __init__(self, layer, optimizer, loss_fn=None, *, mesh=None,
                 remat: bool = False, zero: int = 0,
                 accumulate_steps: int = 1, seed: int = 0,
                 compute_dtype=None, localsgd_k: int = 0,
                 dgc_sparsity: float = 0.0, sentinel: bool = None,
                 grad_scaler=None, device: DeviceLike = None):
        given = dict(mesh=mesh, remat=remat, zero=zero,
                     localsgd_k=localsgd_k, dgc_sparsity=dgc_sparsity)
        for name, off in _NOT_PORTED.items():
            if given[name] not in off:
                raise UnimplementedError(
                    f"TrainStep({name}={given[name]!r}) is not ported yet: "
                    "this slice of paddle_tpu_torch trains on one device, "
                    "and a later slice ports it")
        if int(accumulate_steps) < 1:
            raise InvalidArgumentError("accumulate_steps must be >= 1")
        self.device = resolve_device(device)
        on = module_device(layer)
        if on is not None and on != self.device:
            raise InvalidArgumentError(
                f"TrainStep runs on {self.device} but the layer's "
                f"parameters are on {on}")
        self.layer = layer
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.accumulate_steps = int(accumulate_steps)
        self.seed = int(seed)
        self.compute_dtype = compute_dtype
        self.grad_scaler = grad_scaler
        self.sentinel = bool(flag("train_sentinel")) if sentinel is None \
            else bool(sentinel)
        self.skipped_steps = 0
        self._host_step = 0
        self._gen = torch.Generator(device=self.device)
        optimizer._bind(layer)
        # named_parameters lists a tied parameter once; functional_call
        # ties its other names to the value given for the first
        self._params = dict(layer.named_parameters())
        self._buffers = dict(layer.named_buffers())

    def _to_device(self, x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _loss_of(self, inputs, label):
        params = self._params
        cd = self.compute_dtype
        if cd is not None:
            params = {n: p.to(cd) if p.is_floating_point() else p
                      for n, p in params.items()}
            inputs = tuple(x.to(cd) if x is not None and x.is_floating_point()
                           else x for x in inputs)
        state = {**params, **self._buffers}
        if self.loss_fn is None:
            args = inputs if label is None else inputs + (label,)
            out = torch.func.functional_call(self.layer, state, args)
            loss = out[0] if isinstance(out, (tuple, list)) else out
        else:
            out = torch.func.functional_call(self.layer, state, inputs)
            if isinstance(out, (tuple, list)):
                out = out[0]
            loss = self.loss_fn(out, label)
        return loss.float().mean()

    def _split(self, x):
        k = self.accumulate_steps
        if x is None:
            return [None] * k
        if x.shape[0] % k:
            raise InvalidArgumentError(
                f"batch of {x.shape[0]} does not split into "
                f"accumulate_steps={k} microbatches")
        return list(x.chunk(k))

    def __call__(self, inputs, label=None):
        if not isinstance(inputs, (tuple, list)):
            inputs = (inputs,)
        inputs = tuple(self._to_device(x) for x in inputs)
        label = self._to_device(label)
        self._host_step += 1
        self.layer.train()
        scaler = self.grad_scaler if (self.grad_scaler is not None
                                      and self.grad_scaler.is_enable()) \
            else None
        scale = scaler.get_loss_scaling() if scaler is not None else 1.0
        params = list(self._params.values())
        k = self.accumulate_steps
        micro = zip(zip(*(self._split(x) for x in inputs)),
                    self._split(label))
        grads, loss = None, None
        for mb_in, mb_lb in micro:
            # one stream per step, the same for each of its microbatches
            self._gen.manual_seed(self.seed * 1_000_003 + self._host_step)
            with use_generator(self._gen):
                mb_loss = self._loss_of(tuple(mb_in), mb_lb)
            g = torch.autograd.grad(mb_loss * scale if scaler else mb_loss,
                                    params, allow_unused=True)
            g = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(params, g)]
            if grads is None:
                grads, loss = g, mb_loss.detach()
            else:
                torch._foreach_add_(grads, g)
                loss = loss + mb_loss.detach()
        if k > 1:
            torch._foreach_div_(grads, float(k))
            loss = loss / k
        if scaler is not None:
            torch._foreach_mul_(grads, 1.0 / scale)
        finite = True
        if self.sentinel:
            # one device-to-host read per step
            finite = bool(torch.stack(
                [torch.isfinite(loss)]
                + [torch.isfinite(g).all() for g in grads]).all())
        if finite:
            for p, g in zip(params, grads):
                p.grad = g
            self.optimizer.step()
            for p in params:
                p.grad = None
        else:
            # skip-step: nothing is committed, the step count moves on
            self.optimizer._step_count += 1
            self.skipped_steps += 1
        if self.sentinel and scaler is not None:
            scaler.on_step_result(not finite)
        return loss
