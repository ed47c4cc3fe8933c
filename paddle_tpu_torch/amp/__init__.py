"""Mixed precision: the dynamic loss scaler.

Counterpart of ``paddle_tpu/amp/__init__.py`` (``GradScaler``).  With
bf16 compute, scaling is unnecessary (bf16 has f32's exponent range);
the dynamic-scale state machine (grow every ``incr_every_n_steps`` good
steps, back off after ``decr_every_n_nan_or_inf`` bad ones) is kept for
fp16 use, and ``TrainStep`` drives it through :meth:`on_step_result`.
"""
from __future__ import annotations

import torch


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
