"""The PyTorch port's learning-rate schedulers against the JAX package's:
each of the twelve schedules beyond BERT's three over 30 steps, the
rate before every ``step()`` equal to JAX's (rtol 1e-12: the same host
float formulas), the same ``last_epoch`` and ``state_dict``, and a
scheduler restored from that state dict reading the same rate.
``ReduceOnPlateau`` is fed a fixed metric sequence with plateaus.
"""
import math

import numpy as np
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.optimizer import lr as tlr

CASES = {
    "NoamDecay": dict(d_model=512, warmup_steps=8, learning_rate=2.0),
    "PiecewiseDecay": dict(boundaries=[5, 12, 20],
                           values=[0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.3),
    "StepDecay": dict(learning_rate=0.5, step_size=7, gamma=0.5),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[3, 10, 22],
                           gamma=0.3),
    "LambdaDecay": dict(learning_rate=0.5,
                        lr_lambda=lambda e: 0.95 ** e + 0.01 * (e % 3)),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=12, eta_min=0.01),
    "ReduceOnPlateau": dict(learning_rate=0.5, factor=0.5, patience=2,
                            cooldown=1, min_lr=0.02),
    "OneCycleLR": dict(max_learning_rate=0.4, total_steps=25),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.3,
                     step_size_up=4, step_size_down=6, mode="triangular2"),
}

# a loss that falls, stalls, falls again and stalls
METRICS = [5.0 - 0.5 * min(i, 4) - 0.3 * max(0, min(i - 12, 3))
           + 1e-6 * (i % 2) for i in range(30)]


@pytest.mark.parametrize("name", list(CASES))
def test_scheduler_matches_jax_over_30_steps(name):
    kw = CASES[name]
    j, t = getattr(jlr, name)(**kw), getattr(tlr, name)(**kw)
    got, want = [], []
    for i in range(30):
        got.append(t())
        want.append(j())
        if name == "ReduceOnPlateau":
            t.step(METRICS[i])
            j.step(METRICS[i])
        else:
            t.step()
            j.step()
        assert t.last_epoch == j.last_epoch
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert all(math.isfinite(x) for x in got)
    assert len(set(got)) > 1            # the schedule moved
    assert t.state_dict() == j.state_dict()
    fresh = getattr(tlr, name)(**kw)
    fresh.set_state_dict(t.state_dict())
    assert fresh() == t() and fresh.last_epoch == t.last_epoch
    opt = Adam(learning_rate=t)
    assert opt.get_lr() == t()
    assert opt.state_dict()["LR_Scheduler"] == t.state_dict()
