"""Optimizers: the base class, SGD, Momentum, Adam and AdamW.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``.  ``step()`` updates
every parameter that has a gradient, in place, with f32 moments; the
update rules are the JAX package's ``_adam_rule`` and ``_adamw_rule``,
with their scalars rounded to f32 as JAX computes them:

    m = b1 m + (1 - b1) g            v = b2 v + (1 - b2) g^2
    p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

with ``wd`` the decoupled decay of AdamW (0 for Adam, whose
``weight_decay`` is the coupled L2 term added to the gradient) and ``t``
the step count.  A ``grad_clip`` (``nn.clip``) scales the gradients
before the rule.  Parameters are named: pass ``model.named_parameters()``
for names that ``apply_decay_param_fun`` and ``state_dict`` can use (a
``TrainStep`` names them from its layer either way).

``Momentum`` is the JAX package's ``_momentum_rule`` with an f32
velocity: ``v = mu v + g``, then ``p = p - lr v``, or with Nesterov
``p = p - lr (g + mu v)``; its ``weight_decay`` is the coupled L2 term
added to the gradient.  ``SGD`` is ``_sgd_rule``: ``p = p - lr g``.

In static mode ``minimize(loss)`` appends the program's backward op
(``static/backward.py``) and one ``@optimize`` op, as the JAX package's
``_minimize_static`` does.  Its accumulators (``<param>_<state>_0``,
f32 zeros), its step (int32) and its learning rate (f32) are
persistable vars, set by the startup program and seeded into the
global scope at once; the learning rate is
refreshed before each run (``Program._pre_run_hooks``), so a scheduler
reaches a captured program as data.  The update (``make_update_fn``)
writes into the scope's parameter, accumulator and step tensors in
place, with the step and the learning rate read as device scalars: the
same rules, in the JAX package's order of operations.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..framework import core
from ..framework.enforce import UnimplementedError
from ..nn.initializer import Constant
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
    (any float dtype, updated through f32) and the f32 ``velocity``;
    ``lr`` a float or a 0-d tensor."""
    grads = [g.float() for g in grads]
    pf = [p if p.dtype == torch.float32 else p.float() for p in params]
    torch._foreach_mul_(velocity, _f32(mu))
    torch._foreach_add_(velocity, grads)
    if nesterov:
        step = torch._foreach_mul(velocity, _f32(mu))
        torch._foreach_add_(step, grads)
    else:
        step = velocity
    torch._foreach_sub_(pf, torch._foreach_mul(
        step, lr if isinstance(lr, torch.Tensor) else _f32(lr)))
    for p, f in zip(params, pf):
        if f is not p:
            p.copy_(f)


def sgd_update(params, grads, lr):
    """``p -= lr * g`` over lists, in place; ``lr`` a float or a 0-d
    tensor."""
    torch._foreach_sub_(params, torch._foreach_mul(
        [g.to(p.dtype) for p, g in zip(params, grads)], lr))


def _adam_static(params, grads, m, v, lr, t, beta1, beta2, eps, wd=0.0):
    """``adam_update`` with the learning rate and the f32 step ``t`` as
    device scalars, in the order of ``_adam_rule`` (lr (m / bc1) /
    (sqrt(v / bc2) + eps)) and ``_adamw_rule`` (lr ((m / bc1) / (sqrt(v
    / bc2) + eps) + wd p))."""
    one = np.float32(1.0)
    b1, b2 = np.float32(beta1), np.float32(beta2)
    bc1 = 1.0 - torch.pow(float(b1), t)
    bc2 = 1.0 - torch.pow(float(b2), t)
    grads = [g.float() for g in grads]
    torch._foreach_mul_(m, float(b1))
    torch._foreach_add_(m, grads, alpha=float(one - b1))
    torch._foreach_mul_(v, float(b2))
    torch._foreach_addcmul_(v, grads, grads, value=float(one - b2))
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, _f32(eps))
    upd = torch._foreach_div(m, bc1)
    if wd:
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=_f32(wd))
        torch._foreach_mul_(upd, lr)
    else:
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
    torch._foreach_sub_(params, upd)


def make_update_fn(opt, param_names):
    """The ``@optimize`` op's function over (params, grads, accumulators
    by state, step, lr): the step advances, then ``opt._static_update``
    updates every tensor in place; returns the written tensors."""
    def update_fn(*arrs):
        k = len(param_names)
        params, grads = list(arrs[:k]), list(arrs[k:2 * k])
        state = {s: list(arrs[2 * k + i * k:2 * k + (i + 1) * k])
                 for i, s in enumerate(opt._state_names)}
        step, lr = arrs[-2], arrs[-1]
        step.add_(1)
        if opt._grad_clip is not None:
            grads = [g for _, g in opt._grad_clip(list(zip(params, grads)))]
        if opt._weight_decay:
            # coupled L2: grad += wd * param
            grads = [g + opt._weight_decay * p.to(g.dtype)
                     for p, g in zip(params, grads)]
        opt._static_update(param_names, params, grads, state, step, lr)
        return tuple(params + [t for s in opt._state_names
                               for t in state[s]] + [step])
    return update_fn


def lr_hook(opt, lr_name):
    """The pre-run hook that refreshes the scope's learning rate var
    from ``opt`` (``Program._pre_run_hooks``), in place."""
    def hook(scope):
        scope.find_var(lr_name).fill_(_f32(opt.get_lr()))
    return hook


def rebuild_optimizer(class_name, config):
    """The optimizer of a loaded ``@optimize`` op: the class built with
    the saved learning rate, then its saved scalars, grad clip and decay
    names set (``Optimizer._export_config``)."""
    import sys

    from ..nn import clip as clip_mod
    cls = getattr(sys.modules[__name__], class_name)
    opt = cls(learning_rate=config["_lr"])
    for k, v in config.items():
        if k not in ("_grad_clip_spec", "_decay_param_names"):
            setattr(opt, k, v)
    spec = config.get("_grad_clip_spec")
    if spec is not None:
        ccls = getattr(clip_mod, spec["class"])
        clip = ccls.__new__(ccls)
        vars(clip).update(spec["args"])
        opt._grad_clip = clip
    names = config.get("_decay_param_names")
    if names is not None:
        opt._apply_decay_fn = lambda n, keep=frozenset(names): n in keep
    return opt


class Optimizer:
    """paddle.optimizer.Optimizer parity (the eager path)."""

    _state_names: List[str] = []

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._grad_clip = grad_clip
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
        if self._grad_clip is not None:
            # before the update rule and its coupled L2 term, as JAX's
            # Optimizer._collect and _functional_grads apply it
            clipped = self._grad_clip([(p, g) for _, p, g in pg])
            pg = [(n, p, g) for (n, _, _), (p, g) in zip(pg, clipped)]
        self._step_count += 1
        self._apply(pg)

    def _apply(self, pg):
        raise NotImplementedError

    def _static_update(self, names, params, grads, state, step, lr):
        raise UnimplementedError(
            f"{type(self).__name__} has no static update")

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """In static mode, append the backward op and the ``@optimize``
        op to the loss's program; returns (None, [(param, grad)]).
        Eagerly, backward (when the loss has a graph) and ``step()``."""
        if core.in_static_mode() and not isinstance(loss, torch.Tensor):
            return self._minimize_static(loss, parameters, no_grad_set)
        if loss.requires_grad:
            loss.backward()
        self.step()
        return None, [(p, p.grad) for _, p in self._params]

    def _minimize_static(self, loss, parameters=None, no_grad_set=None):
        from ..static.backward import append_backward
        from ..static.executor import global_scope
        from ..static.program import Operator
        block = loss.block
        program = block.program
        pgs = append_backward(loss, parameter_list=parameters,
                              no_grad_set=no_grad_set)
        param_names = [p.name for p, _ in pgs]
        scope = global_scope()

        def persistable(name, shape, dtype, value):
            # set by the startup program, as in the reference, and seeded
            # into the global scope now, as in the JAX package, so that a
            # program of eager parameters runs without a startup
            if not block.has_var(name):
                var = block.create_var(name=name, shape=shape, dtype=dtype,
                                       persistable=True)
                block.append_init(var, Constant(value))
                scope.set_var(name, Constant(value)(shape, dtype))

        acc_names = []
        for sname in self._state_names:
            for p, _ in pgs:
                acc_names.append(f"{p.name}_{sname}_0")
                persistable(acc_names[-1], p.shape, "float32", 0.0)
        step_name = f"@optimizer_step_{id(self)}"
        lr_name = f"@optimizer_lr_{id(self)}"
        persistable(step_name, [], "int32", 0)
        persistable(lr_name, [], "float32", _f32(self.get_lr()))
        program._pre_run_hooks.append(lr_hook(self, lr_name))
        # the attrs carry what rebuilds the op's function and its lr hook
        # when a saved train program is loaded (static/io.py)
        op = Operator(block, prim="@optimize",
                      inputs=param_names + [g.name for _, g in pgs]
                      + acc_names + [step_name, lr_name],
                      outputs=param_names + acc_names + [step_name],
                      attrs={"optimizer": type(self).__name__,
                             "config": self._export_config(param_names),
                             "param_names": list(param_names),
                             "state_names": list(self._state_names)},
                      fn=make_update_fn(self, param_names),
                      type_name=type(self).__name__.lower())
        block.ops.append(op)
        program._version += 1
        return None, pgs

    def _export_config(self, param_names):
        """What :func:`rebuild_optimizer` needs: every scalar attribute
        the update rule reads, the learning rate's value now (a loaded
        program trains at the rate it was saved with), the grad clip's
        class and scalars, and AdamW's decay choice as the names it
        decays."""
        cfg = {k: v for k, v in vars(self).items()
               if isinstance(v, (int, float, bool, str))}
        cfg["_lr"] = _f32(self.get_lr())
        if self._grad_clip is not None:
            cfg["_grad_clip_spec"] = {
                "class": type(self._grad_clip).__name__,
                "args": {k: v for k, v in vars(self._grad_clip).items()
                         if isinstance(v, (int, float, bool, str))}}
        fn = getattr(self, "_apply_decay_fn", None)
        if fn is not None:
            cfg["_decay_param_names"] = [n for n in param_names if fn(n)]
        return cfg

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


class SGD(Optimizer):
    """``p = p - lr g`` (``g`` with the coupled L2 term when
    ``weight_decay`` is set)."""

    def _apply(self, pg):
        grads = [g for _, _, g in pg]
        if self._weight_decay:
            grads = [g + self._weight_decay * p.to(g.dtype)
                     for (_, p, _), g in zip(pg, grads)]
        sgd_update([p for _, p, _ in pg], grads, _f32(self.get_lr()))

    def _static_update(self, names, params, grads, state, step, lr):
        sgd_update(params, grads, lr)


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

    def _static_update(self, names, params, grads, state, step, lr):
        momentum_update(params, grads, state["velocity"], lr,
                        self._momentum, self._nesterov)


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

    def _static_update(self, names, params, grads, state, step, lr):
        _adam_static(params, grads, state["moment1"], state["moment2"], lr,
                     step.float(), self._beta1, self._beta2, self._eps)


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

    def _static_update(self, names, params, grads, state, step, lr):
        fn = self._apply_decay_fn or (lambda n: True)
        for decay in (True, False):
            idx = [i for i, n in enumerate(names) if bool(fn(n)) == decay]
            if idx:
                pick = lambda xs: [xs[i] for i in idx]  # noqa: E731
                _adam_static(pick(params), pick(grads),
                             pick(state["moment1"]), pick(state["moment2"]),
                             lr, step.float(), self._beta1, self._beta2,
                             self._eps, self._wd if decay else 0.0)
