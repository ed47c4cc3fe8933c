"""Learning-rate schedulers.

Counterpart of ``paddle_tpu/optimizer/lr.py``, kept to the base class
and the two schedules BERT pretraining uses (linear warm-up into a
polynomial decay).  Host-side scalars: the optimizer reads the current
value at every step.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            print(f"Epoch {self.last_epoch}: lr set to {self.last_lr}")

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]

    set_dict = set_state_dict


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / float(self.decay_steps)) or 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate \
            if isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate.base_lr if self.lr_sched \
            else float(learning_rate)
        super().__init__(base, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * \
                self.last_epoch / float(self.warmup_steps) + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_sched.get_lr()
        return self.base_lr
