"""Static autodiff: ``append_backward`` and ``gradients``.

Counterpart of ``paddle_tpu/static/backward.py``: one ``backward`` macro
op differentiates the whole forward segment before it, and writes a
``<param>@GRAD`` var for each parameter.  The gradient is
``torch.autograd.grad`` of the loss (summed when it is not a scalar)
with the parameters as leaves.  When the Executor replays a program
whose backward op follows its forward segment directly (what
``append_backward`` and ``Optimizer.minimize`` build), it runs that
segment with the leaves in place and the backward op differentiates the
replay it just ran; the op's own function (:func:`make_backward_fn`)
replays the segment itself, for a backward op anywhere else.
"""
from __future__ import annotations

import torch

from ..framework.enforce import UnimplementedError
from .program import Operator, Variable


def _segment_io(ops, param_names):
    """External inputs of the op segment: names read before any op of the
    segment wrote them, parameters excluded."""
    produced = set()
    ext = []
    for op in ops:
        for n in op.input_names:
            if n not in produced and n not in param_names and n not in ext:
                ext.append(n)
        produced.update(op.output_names)
    return ext


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    checkpoints=None):
    """Append the backward op of ``loss``; returns ``[(param_var,
    grad_var)]``."""
    if checkpoints:
        raise UnimplementedError(
            "append_backward(checkpoints=...) is not ported (ROADMAP A13)")
    block = loss.block
    program = block.program
    if parameter_list:
        param_names = [p if isinstance(p, str) else p.name
                       for p in parameter_list]
    else:
        param_names = [n for n in program._parameters
                       if block.has_var(n) and block.var(n).trainable]
    no_grad = {n if isinstance(n, str) else n.name
               for n in (no_grad_set or set())}
    param_names = [n for n in param_names if n not in no_grad]
    if not param_names:
        raise ValueError("append_backward: no trainable parameters found")

    fwd_ops = list(block.ops)
    ext_names = _segment_io(fwd_ops, set(param_names))
    grad_vars = []
    for n in param_names:
        pv = block.var(n)
        grad_vars.append(block.create_var(name=n + "@GRAD", shape=pv.shape,
                                          dtype=pv.dtype,
                                          stop_gradient=True))
    op = Operator(block, prim="@backward",
                  inputs=param_names + ext_names,
                  outputs=[g.name for g in grad_vars],
                  attrs={"param_names": list(param_names),
                         "ext_names": list(ext_names),
                         "loss_name": loss.name,
                         "n_fwd_ops": len(fwd_ops)},
                  fn=make_backward_fn(fwd_ops, param_names, ext_names,
                                      loss.name),
                  type_name="backward")
    block.ops.append(op)
    program._version += 1
    return [(block.var(n), g) for n, g in zip(param_names, grad_vars)]


def grads_of(loss, leaves):
    """d ``loss`` / d ``leaves``; a leaf the loss does not reach gets
    zeros."""
    loss = loss.sum() if loss.ndim else loss
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads))


def make_backward_fn(fwd_ops, param_names, ext_names, loss_name):
    """The backward op's function: the forward segment replayed with the
    parameters as leaves, then :func:`grads_of`."""
    def grad_fn(*arrs):
        k = len(param_names)
        device = arrs[0].device
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in arrs[:k]]
            env = dict(zip(ext_names, arrs[k:]))
            env.update(zip(param_names, leaves))
            for op in fwd_ops:
                outs = op.run([env[n] for n in op.input_names], device)
                env.update(zip(op.output_names, outs))
            return grads_of(env[loss_name], leaves)
    return grad_fn


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradients of ``targets[0]`` with respect to ``inputs``."""
    if target_gradients is not None:
        raise UnimplementedError(
            "gradients(target_gradients=...) is not ported (ROADMAP A13)")
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    pgs = append_backward(targets[0], parameter_list=[v.name for v in inputs],
                          no_grad_set=no_grad_set)
    return [g for _, g in pgs]
