"""The port's static graph against ``paddle_tpu.static`` on the CPU: the
recorded LeNet program (bench.py's), InferShape with dynamic dims, three
LeNet training steps from the same weights, the static backward, the
test clone, persistables on disk, the switch, the top-level ops, the
initializers and the guards.

Static mode is process-global in both packages (so are the default
programs and the global scope): every test that turns it on does so
through ``static_modes()``, which restores all of it, and the last test
of the file fails if either package was left in static mode.

Tolerances (f32 on the CPU): losses and parameters rtol 1e-5 / atol
1e-6, as the port's other f32 parity tests; gradients rtol 1e-5 / atol
1e-6 of the same inputs and weights.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu_torch import static
from paddle_tpu_torch.framework.enforce import (PreconditionNotMetError,
                                                UnimplementedError)
from torch_port_util import (either_static, lenet, mlp, scope_values,
                             static_modes, static_pair_state)

RTOL, ATOL = 1e-5, 1e-6


def _sgd(lr):
    return lambda pkg: pkg.optimizer.SGD(learning_rate=lr)


def test_lenet_program_records_the_jax_op_types_and_shapes():
    with static_modes() as (j, t):
        lenet(j[0], j[1], _sgd(0.01))
        lenet(t[0], t[1], _sgd(0.01))
        jops, tops = j[2].global_block().ops, t[2].global_block().ops
        assert [op.type for op in tops] == [op.type for op in jops] == [
            "conv2d", "relu", "max_pool", "conv2d", "relu", "max_pool",
            "flatten_contiguous_range", "linear", "relu", "linear", "relu",
            "linear", "softmax_with_cross_entropy", "backward", "sgd"]
        jv, tv = j[2].global_block().vars, t[2].global_block().vars
        assert len(jv) == len(tv)
        # op outputs pair in order; the parameters by position
        for jo, to in zip(jops[:13], tops[:13]):
            for a, b in zip(jo.output_names + jo.input_names,
                            to.output_names + to.input_names):
                assert jv[a].shape == tv[b].shape, (a, b)
        assert [jv[n].shape for n in j[2]._parameters] == \
            [tv[n].shape for n in t[2]._parameters]
        assert tv[tops[12].output_names[0]].shape == []
        assert tv[tops[11].output_names[0]].shape == [-1, 10]


def test_infer_shape_with_dynamic_dims():
    with static_modes() as (j, t):
        shapes = []
        for pkg, st, *_ in (j, t):
            x = st.data("x", [4, 8], "float32")
            w = st.data("w", [8, 3], "float32")
            out = pkg.matmul(x, w)
            y = st.data("y", [None, 2, 6], "float32")
            h = y.reshape([-1, 12])
            fc = st.nn.fc(y, 5, num_flatten_dims=1)
            z = (h + 1.0) * h
            shapes.append([out.shape, h.shape, fc.shape, z.shape,
                           y.mean().shape])
        assert shapes[0] == shapes[1]
        assert shapes[1][:4] == [[4, 3], [-1, 12], [-1, 5], [-1, 12]]
        # one program runs at two batch sizes
        exe = static.Executor("cpu")
        exe.run(t[3])
        for bs in (4, 16):
            res = exe.run(t[2], feed={
                "x": np.zeros((4, 8), "float32"),
                "w": np.zeros((8, 3), "float32"),
                "y": np.zeros((bs, 2, 6), "float32")}, fetch_list=[fc])[0]
            assert res.shape == (bs, 5)


def _lenet_batch(seed, batch):
    rng = np.random.RandomState(seed)
    return {"img": rng.randn(batch, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (batch,)).astype("int64")}


def test_lenet_three_steps_match_jax():
    """bench.py's LeNet at batch 4, the JAX weights carried across: the
    losses of three Executor.run steps and every persistable after."""
    with static_modes() as (j, t):
        jl, _ = lenet(j[0], j[1], _sgd(0.01))
        tl, _ = lenet(t[0], t[1], _sgd(0.01))
        static_pair_state(j, t)
        jexe, texe = j[1].Executor(), static.Executor("cpu")
        for step in range(3):
            feed = _lenet_batch(step, 4)
            a = jexe.run(j[2], feed=feed, fetch_list=[jl])[0]
            b = texe.run(t[2], feed=feed, fetch_list=[tl])[0]
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        for a, b in zip(scope_values(j[1], j[2]._parameters),
                        scope_values(t[1], t[2]._parameters)):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        # the step counters advanced alike
        steps = [[n for n in m.global_block().vars if "step" in n]
                 for m in (j[2], t[2])]
        assert [int(v) for v in scope_values(j[1], steps[0])] == \
            [int(v) for v in scope_values(t[1], steps[1])] == [3]


def test_append_backward_and_gradients_match_jax():
    with static_modes() as (j, t):
        grads = []
        feed = {"x": np.random.RandomState(1).randn(6, 16).astype("float32")}
        for pkg, st, main, _ in (j, t):
            x = st.data("x", [None, 16], "float32")
            h = st.nn.fc(x, 8, activation="relu")
            loss = st.nn.fc(h, 4).mean()
            pgs = st.append_backward(loss)
            assert [g.name for _, g in pgs] == [p.name + "@GRAD"
                                                for p, _ in pgs]
            assert all(list(g.shape) == list(p.shape) for p, g in pgs)
            # a second backward op, with respect to the feed: it follows
            # the first, so it replays its segment itself
            gx = st.gradients(loss, x)
            grads.append((main, loss, [g for _, g in pgs] + gx))
        static_pair_state(j, t)
        got = [exe.run(m, feed=feed, fetch_list=[loss] + gs)
               for exe, (m, loss, gs) in zip(
                   (j[1].Executor(), static.Executor("cpu")), grads)]
        assert len(got[1]) == 6 and got[1][5].shape == (6, 16)
        for a, b in zip(*got):
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)

    # gradients() of an eager parameter registered by the recorder
    with static_modes() as (j, t):
        init = np.array([1.0, -2.0, 0.5], "float32")
        outs = []
        for pkg, st, main, _ in (j, t):
            if pkg is paddle:
                w = torch.nn.Parameter(torch.tensor(init))
                w.static_name = "w_g"
            else:
                from paddle_tpu.framework.tensor import Parameter
                w = Parameter(jpaddle.to_tensor(init)._value, name="w_g")
                w.stop_gradient = False
            loss = pkg.sum(pkg.multiply(w, w))
            g = st.gradients(loss, main.global_block().var("w_g"))
            exe = st.Executor() if pkg is jpaddle else st.Executor("cpu")
            outs.append(exe.run(main, feed={}, fetch_list=g)[0])
        np.testing.assert_allclose(outs[1], 2 * init, rtol=1e-6)
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6)


def test_clone_for_test_fetches_the_loss_and_moves_no_parameter():
    with static_modes() as (j, t):
        mains, losses, tests = [], [], []
        for pkg, st, main, _ in (j, t):
            loss, _ = mlp(pkg, st)
            tests.append(main.clone(for_test=True))
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            mains.append(main)
            losses.append(loss)
        assert tests[1]._uid != t[2]._uid
        assert [op.type for op in tests[1].global_block().ops] == \
            [op.type for op in tests[0].global_block().ops]
        static_pair_state(j, t)
        rng = np.random.RandomState(2)
        feed = {"x": rng.randn(8, 16).astype("float32"),
                "y": rng.randint(0, 4, (8,)).astype("int64")}
        got = []
        for exe, st, main, test_prog, loss in zip(
                (j[1].Executor(), static.Executor("cpu")), (j[1], t[1]),
                mains, tests, losses):
            exe.run(main, feed=feed, fetch_list=[loss])
            before = scope_values(st, main._parameters)
            test_loss = exe.run(test_prog, feed=feed, fetch_list=[loss])[0]
            for a, b in zip(before, scope_values(st, main._parameters)):
                np.testing.assert_array_equal(a, b)
            got.append(test_loss)
        np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


def test_save_and_load_persistables_round_trip(tmp_path):
    """Save after two steps, step once, load, step once again: the last
    step repeats bit for bit."""
    with static_modes() as (_, t):
        loss, _ = mlp(t[0], t[1], lambda p: p.optimizer.Adam(
            learning_rate=0.01))
        exe = static.Executor("cpu")
        exe.run(t[3])
        rng = np.random.RandomState(3)
        feed = {"x": rng.randn(8, 16).astype("float32"),
                "y": rng.randint(0, 4, (8,)).astype("int64")}
        for _ in range(2):
            exe.run(t[2], feed=feed, fetch_list=[loss])
        names = [v.name for v in t[2].list_vars() if v.persistable]
        assert len(names) == 4 * 3 + 2           # params, moments, step, lr
        static.save_persistables(exe, str(tmp_path), t[2])
        first = exe.run(t[2], feed=feed, fetch_list=[loss])[0]
        after = scope_values(t[1], names)
        static.load_persistables(exe, str(tmp_path), t[2])
        again = exe.run(t[2], feed=feed, fetch_list=[loss])[0]
        np.testing.assert_array_equal(again, first)
        for a, b in zip(after, scope_values(t[1], names)):
            np.testing.assert_array_equal(a, b)


def test_switch_and_top_level_ops_match_jax():
    from paddle_tpu_torch.framework.dtype import convert_dtype
    assert paddle.in_dygraph_mode() and not paddle.in_static_mode()
    paddle.enable_static()
    try:
        assert paddle.in_static_mode() and not paddle.in_dygraph_mode()
    finally:
        paddle.disable_static()
    assert paddle.in_dygraph_mode()
    assert convert_dtype("paddle.float32") is torch.float32
    assert convert_dtype(np.int64) is convert_dtype("long") is torch.int64
    assert convert_dtype(torch.bfloat16) is torch.bfloat16
    with pytest.raises(TypeError):
        convert_dtype("float8")
    rng = np.random.RandomState(4)
    a = rng.randn(2, 3, 4).astype("float32")
    b = rng.randn(4, 5).astype("float32")
    cases = [
        (lambda p, x, y: p.flatten(x, start_axis=1), (a, b)),
        (lambda p, x, y: p.reshape(x, [2, -1]), (a, b)),
        (lambda p, x, y: p.mean(x, axis=1), (a, b)),
        (lambda p, x, y: p.mean(x), (a, b)),
        (lambda p, x, y: p.matmul(x, y), (a, b)),
        (lambda p, x, y: p.add(p.multiply(x, x), p.divide(x, 2.0)), (a, b)),
    ]
    for fn, (x, y) in cases:
        want = np.asarray(fn(jpaddle, jpaddle.to_tensor(x),
                             jpaddle.to_tensor(y)).numpy())
        got = fn(paddle, torch.tensor(x), torch.tensor(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_initializers_match_jax():
    from paddle_tpu.nn import initializer as JI

    from paddle_tpu_torch.nn import initializer as I
    from paddle_tpu_torch.nn.layer.layers import ParamAttr
    g = torch.Generator().manual_seed(0)
    assert torch.equal(I.Constant(0.5)([2, 3]), torch.full((2, 3), 0.5))
    val = np.arange(6, dtype="float32")
    np.testing.assert_array_equal(
        I.Assign(val)([2, 3]).numpy(), np.asarray(JI.Assign(val)([2, 3])))
    uniform = (lambda m: m.XavierUniform(), lambda m: m.KaimingUniform(),
               lambda m: m.Uniform(-0.3, 0.2))
    normal = (lambda m: m.XavierNormal(), lambda m: m.KaimingNormal(),
              lambda m: m.Normal(0.1, 0.05))
    for shape in ([400, 120], [16, 6, 5, 5]):
        for make in uniform + normal:
            ours = make(I)(shape, "float32", generator=g).double()
            theirs = np.asarray(make(JI)(shape, "float32"), np.float64)
            assert ours.dtype == torch.float64 and list(ours.shape) == shape
            # the same distribution, to sampling error (>= 2400 draws)
            np.testing.assert_allclose(float(ours.std()), theirs.std(),
                                       rtol=0.08)
            np.testing.assert_allclose(float(ours.mean()), theirs.mean(),
                                       atol=0.1 * theirs.std())
            if make in uniform:
                np.testing.assert_allclose(
                    [float(ours.min()), float(ours.max())],
                    [theirs.min(), theirs.max()], rtol=0.05)
    a = I.XavierUniform()([4, 4], generator=torch.Generator().manual_seed(1))
    b = I.XavierUniform()([4, 4], generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert ParamAttr._to_attr(False) is False
    assert ParamAttr._to_attr("w").name == "w"
    assert isinstance(ParamAttr._to_attr(I.Constant(1.0)).initializer,
                      I.Constant)


def test_guards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
        static.Executor()
    with pytest.raises(PreconditionNotMetError):
        static.Executor(paddle.CUDAPlace(0))
    assert static.Executor(paddle.CPUPlace()).device.type == "cpu"
    with static_modes() as (_, t):
        x = t[1].data("x", [None, 4], "float32")
        with pytest.raises(UnimplementedError, match="A13"):
            t[1].nn.batch_norm(x)
        with pytest.raises(UnimplementedError, match="A13"):
            t[1].append_backward(x.mean(), checkpoints=[x])
        # a startup program that was not run
        loss, _ = mlp(t[0], t[1], _sgd(0.1))
        with pytest.raises(PreconditionNotMetError, match="startup"):
            static.Executor("cpu").run(t[2], feed={
                "x": np.zeros((2, 16), "float32"),
                "y": np.zeros(2, "int64")}, fetch_list=[loss])


def test_no_package_left_in_static_mode():
    """Runs last in this file: nothing above leaked static mode."""
    assert not either_static()
