"""Optimizers: the base class, Momentum, Adam and AdamW.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``.  ``step()`` updates
every parameter that has a gradient, in place, with f32 moments; the
update rules are the JAX package's ``_adam_rule`` and ``_adamw_rule``,
with their scalars rounded to f32 as JAX computes them:

    m = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g^2
    p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

with ``wd`` the decoupled decay of AdamW (0 for Adam, whose
``weight_decay`` is the coupled L2 term added to the gradient) and ``t``
the step count.  Parameters are named: pass ``model.named_parameters()``
for names that ``apply_decay_param_fun`` and ``state_dict`` can use (a
``TrainStep`` names them from its layer either way).

``Momentum`` is the JAX package's ``_momentum_rule`` with an f32
velocity: ``v = mu v + g``, then ``p = p - lr v``, or with Nesterov
``p = p - lr (g + mu v)``; its ``weight_decay`` is the coupled L2 term
added to the gradient.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..framework.enforce import UnimplementedError
from .lr import LRScheduler


def _named(parameters) -> List[Tuple[str, torch.Tensor]]:
    out = []
    for i, p in enumerate(parameters or ()):
        if isinstance(p, tuple):
            out.append((str(p[0]), p[1]))
        else:
            out.append((f"param_{i}", p))
    return out


def _f32(x) -> float:
    return float(np.float32(x))


def adam_update(params, grads, m, v, lr, beta1, beta2, eps, t, wd=0.0):
    """One Adam(W) update over lists of tensors, in place on ``params``
    (any float dtype, updated through f32) and the f32 moments ``m`` and
    ``v``.  ``wd`` is the decoupled decay (0: Adam)."""
    one = np.float32(1.0)
    b1, b2 = np.float32(beta1), np.float32(beta2)
    bc1 = float(one - b1 ** np.float32(t))
    bc2 = float(one - b2 ** np.float32(t))
    grads = [g.float() for g in grads]
    pf = [p if p.dtype == torch.float32 else p.float() for p in params]
    torch._foreach_mul_(m, float(b1))
    torch._foreach_add_(m, grads, alpha=float(one - b1))
    torch._foreach_mul_(v, float(b2))
    torch._foreach_addcmul_(v, grads, grads, value=float(one - b2))
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, _f32(eps))
    upd = torch._foreach_div(m, bc1)
    torch._foreach_div_(upd, denom)
    if wd:
        torch._foreach_add_(upd, pf, alpha=_f32(wd))
    torch._foreach_mul_(upd, _f32(lr))
    torch._foreach_sub_(pf, upd)
    for p, f in zip(params, pf):
        if f is not p:
            p.copy_(f)


def momentum_update(params, grads, velocity, lr, mu, nesterov=False):
    """One momentum update over lists of tensors, in place on ``params``
    (any float dtype, updated through f32) and the f32 ``velocity``."""
    grads = [g.float() for g in grads]
    pf = [p if p.dtype == torch.float32 else p.float() for p in params]
    torch._foreach_mul_(velocity, _f32(mu))
    torch._foreach_add_(velocity, grads)
    if nesterov:
        step = torch._foreach_mul(velocity, _f32(mu))
        torch._foreach_add_(step, grads)
    else:
        step = velocity
    torch._foreach_sub_(pf, torch._foreach_mul(step, _f32(lr)))
    for p, f in zip(params, pf):
        if f is not p:
            p.copy_(f)


class Optimizer:
    """paddle.optimizer.Optimizer parity (the eager path)."""

    _state_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if grad_clip is not None:
            raise UnimplementedError(
                "grad_clip is not ported yet: a later slice of "
                "paddle_tpu_torch ports nn.clip")
        self._lr = learning_rate
        self._params = _named(parameters)
        self._weight_decay = float(weight_decay) if weight_decay else 0.0
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    def parameters(self):
        return [p for _, p in self._params]

    def _bind(self, module: torch.nn.Module):
        """Name the parameters after ``module``'s dotted paths (all of its
        parameters when none were given)."""
        if not self._params:
            self._params = list(module.named_parameters())
            return
        names = {id(p): n for n, p in module.named_parameters()}
        self._params = [(names.get(id(p), n), p) for n, p in self._params]

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return self._lr()
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # -- stepping ------------------------------------------------------------
    def _state(self, name, pname, p):
        acc = self._accumulators.setdefault(name, {})
        if pname not in acc:
            acc[pname] = torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
        return acc[pname]

    @torch.no_grad()
    def step(self):
        pg = [(n, p, p.grad) for n, p in self._params
              if p.requires_grad and p.grad is not None]
        if not pg:
            return
        self._step_count += 1
        self._apply(pg)

    def _apply(self, pg):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for _, p in self._params:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state ---------------------------------------------------------------
    def state_dict(self):
        sd = {f"{pname}_{name}": val
              for name, acc in self._accumulators.items()
              for pname, val in acc.items()}
        sd["@step"] = self._step_count
        if isinstance(self._lr, LRScheduler):
            sd["LR_Scheduler"] = self._lr.state_dict()
        return sd

    def set_state_dict(self, state):
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        for name in self._state_names:
            for pname, p in self._params:
                key = f"{pname}_{name}"
                if key in state:
                    self._state(name, pname, p).copy_(
                        torch.as_tensor(state[key]))

    set_dict = set_state_dict


class Momentum(Optimizer):
    _state_names = ["velocity"]

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = bool(use_nesterov)

    def _apply(self, pg):
        grads = [g for _, _, g in pg]
        if self._weight_decay:
            # coupled L2: grad += wd * param
            grads = [g.float() + self._weight_decay * p.float()
                     for (_, p, _), g in zip(pg, grads)]
        momentum_update([p for _, p, _ in pg], grads,
                        [self._state("velocity", n, p) for n, p, _ in pg],
                        self.get_lr(), self._momentum, self._nesterov)


class Adam(Optimizer):
    _state_names = ["moment1", "moment2"]

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _update(self, pg, wd):
        if not pg:
            return
        adam_update([p for _, p, _ in pg], [g for _, _, g in pg],
                    [self._state("moment1", n, p) for n, p, _ in pg],
                    [self._state("moment2", n, p) for n, p, _ in pg],
                    self.get_lr(), self._beta1, self._beta2, self._eps,
                    self._step_count, wd)

    def _apply(self, pg):
        if self._weight_decay:
            # coupled L2: grad += wd * param
            pg = [(n, p, g + self._weight_decay * p.to(g.dtype))
                  for n, p, g in pg]
        self._update(pg, 0.0)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = float(weight_decay)
        self._apply_decay_fn = apply_decay_param_fun

    def _apply(self, pg):
        """Decay every parameter unless ``apply_decay_param_fun`` (called
        with its name) says otherwise."""
        fn = self._apply_decay_fn or (lambda n: True)
        self._update([x for x in pg if fn(x[0])], self._wd)
        self._update([x for x in pg if not fn(x[0])], 0.0)
