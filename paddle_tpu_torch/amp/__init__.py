"""Mixed precision: the dynamic loss scaler and ``decorate``.

Counterpart of ``paddle_tpu/amp/__init__.py`` (``GradScaler``,
``decorate``).  With bf16 compute, scaling is unnecessary (bf16 has
f32's exponent range); the dynamic-scale state machine (grow every
``incr_every_n_steps`` good steps, back off after
``decr_every_n_nan_or_inf`` bad ones) is kept for fp16 use, and
``TrainStep`` drives it through :meth:`on_step_result`.
"""
from __future__ import annotations

import torch

from ..framework.enforce import UnimplementedError


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable or self._scale == 1.0:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        """Divide every parameter's gradient by the scale and record
        whether any is non-finite."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        found = False
        for p in optimizer.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
                found = found or not bool(torch.isfinite(p.grad).all())
        self._found_inf = found

    def step(self, optimizer):
        """Unscale, step the optimizer unless a gradient is non-finite,
        then update the scale."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update_scale()

    def update(self):
        pass  # folded into step()

    def on_step_result(self, found_inf: bool):
        """Drive the dynamic-scale state machine from outside
        ``step()``: ``TrainStep``'s numerics sentinel reports each step's
        verdict here."""
        self._found_inf = bool(found_inf)
        self._update_scale()

    def _update_scale(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]


AmpScaler = GradScaler


def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate parity for models.

    ``level="O2"`` casts every floating parameter of ``models`` (one
    module or a list) to bf16 (``dtype`` "bfloat16"/"bf16") or f16, in
    place, LayerNorm's included, as the JAX package does.  Buffers keep
    their dtype, except where a module ties a parameter to one: each
    submodule with a ``_tie_weights`` method re-ties them after the cast
    (GPT's padded LM head follows its embedding into bf16).
    ``level="O1"`` returns the models unchanged.  The JAX package's O2
    optimizer keeps f32 master weights; the port's
    ``Optimizer`` has none yet, so passing ``optimizers`` raises
    (ROADMAP A5)."""
    if optimizers is not None:
        raise UnimplementedError(
            "amp.decorate(optimizers=...): the port's optimizers keep no "
            "f32 master weights of O2 parameters yet (ROADMAP A5)")
    if level == "O2" and models is not None:
        dt = torch.bfloat16 if dtype in ("bfloat16", "bf16") \
            else torch.float16
        targets = models if isinstance(models, (list, tuple)) else [models]
        with torch.no_grad():
            for m in targets:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(dt)
                # a parameter that shares storage with a buffer (GPT's
                # padded tied head) has just been given its own
                for sub in m.modules():
                    if hasattr(sub, "_tie_weights"):
                        sub._tie_weights()
    return models
