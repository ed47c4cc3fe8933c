"""The port's static updates and dataset training against
``paddle_tpu.static`` on the CPU: the MLP of tests/test_static.py under
SGD, Momentum, Adam and AdamW ``minimize``, an LR scheduler whose step
changes the next update, an eager parameter trained in a static
program, and ``train_from_dataset`` with a tail chunk (against JAX's and
against a loop of ``run()``).

Static mode is turned on only through ``static_modes()``, which restores
both packages' process-global state; the last test fails if either
package was left in static mode.  Tolerances: rtol 1e-5 / atol 1e-6 on
losses and persistables (f32), as in tests/test_torch_static.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import static
from torch_port_util import (either_static, mlp, scope_values, static_modes,
                             static_pair_state)

RTOL, ATOL = 1e-5, 1e-6

OPTIMIZERS = {
    "sgd": lambda p: p.optimizer.SGD(learning_rate=0.1),
    "momentum": lambda p: p.optimizer.Momentum(learning_rate=0.05,
                                               momentum=0.9),
    "adam": lambda p: p.optimizer.Adam(learning_rate=0.01),
    "adamw": lambda p: p.optimizer.AdamW(learning_rate=0.01,
                                         weight_decay=0.1),
}


def _batch(seed, n=16):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 16).astype("float32"),
            "y": rng.randint(0, 4, (n,)).astype("int64")}


def _persistables(main):
    return [v.name for v in main.list_vars() if v.persistable]


def _executors(j):
    return j[1].Executor(), static.Executor("cpu")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_mlp_static_update_matches_jax(name):
    """Four steps of the MLP: losses, then every persistable (parameters,
    accumulators, step, learning rate)."""
    with static_modes() as (j, t):
        losses = [mlp(s[0], s[1], OPTIMIZERS[name])[0] for s in (j, t)]
        assert t[2].global_block().ops[-1].type == name
        static_pair_state(j, t)
        exes = _executors(j)
        for step in range(4):
            got = [exe.run(s[2], feed=_batch(step), fetch_list=[loss])[0]
                   for exe, s, loss in zip(exes, (j, t), losses)]
            np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)
        names = [_persistables(s[2]) for s in (j, t)]
        assert len(names[0]) == len(names[1])
        for a, b in zip(scope_values(j[1], names[0]),
                        scope_values(t[1], names[1])):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_lr_scheduler_step_changes_the_next_update():
    """LR is a scope var refreshed before each run: a scheduler's step
    reaches the next update (w = 1, x = 1, grad 1: w -= lr)."""
    with static_modes() as (j, t):
        ws, scheds = [], []
        for pkg, st, main, _ in (j, t):
            x = st.data("x", [1], "float32")
            if pkg is paddle:
                w = torch.nn.Parameter(torch.ones(1))
                w.static_name = "w_lr"
            else:
                from paddle_tpu.framework.tensor import Parameter
                w = Parameter(jpaddle.to_tensor(np.ones(1, "float32"))._value,
                              name="w_lr")
                w.stop_gradient = False
            loss = pkg.sum(pkg.multiply(w, x))
            sched = pkg.optimizer.lr.StepDecay(learning_rate=1.0,
                                               step_size=1, gamma=0.1)
            pkg.optimizer.SGD(learning_rate=sched).minimize(loss)
            scheds.append(sched)
        feed = {"x": np.ones(1, "float32")}
        for exe, s, sched in zip(_executors(j), (j, t), scheds):
            got = []
            for _ in range(3):
                exe.run(s[2], feed=feed)
                got.append(float(scope_values(s[1], ["w_lr"])[0][0]))
                sched.step()
            ws.append(got)
        np.testing.assert_allclose(ws[1], [0.0, -0.1, -0.11], atol=1e-6)
        np.testing.assert_allclose(ws[1], ws[0], rtol=RTOL, atol=ATOL)


def test_eager_parameter_in_a_static_program_matches_jax():
    """tests/test_static.py's static-against-dygraph case: an eager
    parameter used in a static program is registered and trained there,
    and the module's own tensor is left as it was."""
    init = np.random.RandomState(5).randn(16, 4).astype("float32") * 0.1
    with static_modes() as (j, t):
        losses = []
        for pkg, st, main, _ in (j, t):
            x = st.data("x", [None, 16], "float32")
            y = st.data("y", [None], "int64")
            if pkg is paddle:
                w = torch.nn.Parameter(torch.tensor(init))
                w.static_name = "w_static"
            else:
                from paddle_tpu.framework.tensor import Parameter
                w = Parameter(jpaddle.to_tensor(init)._value, name="w_static")
                w.stop_gradient = False
            loss = pkg.nn.functional.cross_entropy(pkg.matmul(x, w), y)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            losses.append(loss)
        assert t[2]._parameters == ["w_static"]
        got = [[exe.run(s[2], feed=_batch(k, 8), fetch_list=[loss])[0]
                for k in range(3)]
               for exe, s, loss in zip(_executors(j), (j, t), losses)]
        np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)
        final = [scope_values(s[1], ["w_static"])[0] for s in (j, t)]
        np.testing.assert_allclose(final[1], final[0], rtol=RTOL, atol=ATOL)
        assert not np.allclose(final[1], init)
        np.testing.assert_array_equal(w.detach().numpy(), init)


def test_train_from_dataset_with_a_tail_chunk():
    """Five steps in chunks of 2 (a tail chunk of 1): the losses and the
    parameters against JAX's train_from_dataset, and bit for bit against
    a loop of the port's run()."""
    feeds = [_batch(10 + k, 8) for k in range(5)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    results = []
    for mode in ("dataset", "run"):
        jpaddle.seed(7)                      # the same JAX initial weights
        with static_modes() as (j, t):
            losses = [mlp(s[0], s[1], OPTIMIZERS["momentum"])[0]
                      for s in (j, t)]
            static_pair_state(j, t)
            jexe, texe = _executors(j)
            if mode == "dataset":
                want = jexe.train_from_dataset(
                    j[2], dataset=feeds, fetch_list=[losses[0]],
                    chunk_steps=2)[losses[0].name]
                got = texe.train_from_dataset(
                    t[2], dataset=stacked, fetch_list=[losses[1]],
                    chunk_steps=2)[losses[1].name]
                assert texe._train_stats["chunks"] == 3
                assert got.shape == want.shape == (5,)
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
                for a, b in zip(scope_values(j[1], j[2]._parameters),
                                scope_values(t[1], t[2]._parameters)):
                    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
            else:
                got = np.array([texe.run(t[2], feed=f,
                                         fetch_list=[losses[1]])[0]
                                for f in feeds])
            results.append((got, scope_values(t[1], _persistables(t[2]))))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_array_equal(a, b)


def test_no_package_left_in_static_mode():
    """Runs last in this file: nothing above leaked static mode."""
    assert not either_static()
