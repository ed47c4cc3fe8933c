"""The port's static inference-model format, program serialization and
program state against ``paddle_tpu.static`` on the CPU: ``_prune``,
``save_inference_model``/``load_inference_model`` and the static
``Predictor`` (LeNet and an fc program, each package reading its own
files), the serialize and program-state family, saved train programs
that continue bit for bit, the Executor's extra cache key with the
Config's quantization signature, Predictor clones on four threads, and
the executor-backed ``Server``.

Static mode is turned on only through ``static_modes()``, which restores
both packages' process-global state; the last test fails if either
package was left in static mode.  Every Future and thread wait has a
timeout, and every Server is stopped in a ``finally``.  Tolerances: rtol
1e-5 / atol 1e-6 (f32), ROADMAP's static-program limit; port against
port is bit for bit.
"""
import concurrent.futures
import sys

import numpy as np
import pytest
import torch

from paddle_tpu import inference as jinference
import paddle_tpu_torch as paddle
from paddle_tpu_torch import inference, serving, static
from paddle_tpu_torch.framework.enforce import (InvalidArgumentError,
                                                PreconditionNotMetError,
                                                UnimplementedError)
from torch_port_util import (either_static, lenet, scope_values,
                             static_modes, static_pair_state)

RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 60
LENET_OPS = ["conv2d", "relu", "max_pool", "conv2d", "relu", "max_pool",
             "flatten_contiguous_range", "linear", "relu", "linear", "relu",
             "linear"]


def _sgd(pkg):
    return pkg.optimizer.SGD(learning_rate=0.01)


def _fc(pkg, st):
    x = st.data("x", [None, 8], "float32")
    return st.nn.fc(x, 3)


def _lenet_logits(pkg, st):
    return lenet(pkg, st, _sgd)[1]


PROGRAMS = {"lenet": (_lenet_logits, "img", (1, 28, 28)),
            "fc": (_fc, "x", (8,))}


def _images(seed, batch, rest):
    return np.random.RandomState(seed).randn(batch, *rest).astype("float32")


def _cpu_predictor(path):
    cfg = inference.Config(path)
    cfg.disable_gpu()
    return inference.create_predictor(cfg)


def _persistables(main):
    return [v.name for v in main.list_vars() if v.persistable]


def test_prune_matches_jax():
    """LeNet's train program pruned to its logits: JAX's op types, the
    feed and fetch names, and only the vars those ops name."""
    with static_modes() as (j, t):
        pruned = []
        for s in (j, t):
            logits = _lenet_logits(s[0], s[1])
            pruned.append(s[2]._prune(["img"], [logits.name]))
            assert pruned[-1]._fetch_names == [logits.name]
        assert [op.type for op in pruned[1].global_block().ops] == \
            [op.type for op in pruned[0].global_block().ops] == LENET_OPS
        assert pruned[1]._feed_names == pruned[0]._feed_names == ["img"]
        assert pruned[1]._parameters == t[2]._parameters
        names = set(pruned[1].global_block().vars)
        assert "label" not in names and not any("@" in n for n in names)
        # the original keeps everything
        assert len(t[2].global_block().ops) == len(LENET_OPS) + 3
        clone = pruned[1].clone()
        assert clone._feed_names == ["img"] and clone._fetch_names == \
            pruned[1]._fetch_names


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_inference_model_matches_jax(name, tmp_path):
    """Each package saves its own inference model of one program and
    weights and loads it: the port's load_inference_model + Executor.run
    and its Predictor (CPU) against JAX's, at batches 1 and 5; and the
    port refuses the JAX package's files."""
    build, feed, rest = PROGRAMS[name]
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    with static_modes() as (j, t):
        outs = [build(s[0], s[1]) for s in (j, t)]
        static_pair_state(j, t)
        for s, out, d, exe in zip((j, t), outs, dirs,
                                  (j[1].Executor(), static.Executor("cpu"))):
            s[1].save_inference_model(d, [feed], [out], exe,
                                      main_program=s[2])
        jpred = jinference.create_predictor(jinference.Config(dirs[0]))
        tpred = _cpu_predictor(dirs[1])
        assert tpred.get_input_names() == [feed]
        assert tpred.get_output_names() == [outs[1].name]
        # the Predictor's weights live in its own scope
        prog, feeds, fetches = static.load_inference_model(dirs[1])
        assert feeds == [feed] and [v.name for v in fetches] == \
            [outs[1].name]
        assert tpred._scope is not static.global_scope()
        exe = static.Executor("cpu")
        for batch in (1, 5):
            x = _images(batch, batch, rest)
            want = jpred.run([x])[0]
            got = exe.run(prog, feed={feed: x}, fetch_list=fetches)[0]
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(tpred.run([x])[0], got)
            h = tpred.get_input_handle(feed)
            h.reshape(x.shape)
            h.copy_from_cpu(x)
            dev = tpred.run_async()[0]
            assert isinstance(dev, torch.Tensor)
            np.testing.assert_array_equal(
                tpred.get_output_handle(outs[1].name).copy_to_cpu(), got)
        with pytest.raises(InvalidArgumentError, match="ROADMAP C"):
            static.load_inference_model(dirs[0])
        with pytest.raises(InvalidArgumentError, match="ROADMAP C"):
            _cpu_predictor(dirs[0])


def test_program_state_round_trips(tmp_path):
    """serialize_program/deserialize_program, the persistables as bytes,
    save/load, and get/load/set_program_state; no @const device copy is
    written, and a startup program's initializer is refused by name."""
    with static_modes() as (_, t):
        x = static.data("x", [None, 8], "float32")
        y = static.nn.fc(x, 4) * 2.0
        loss = paddle.mean(y)
        paddle.optimizer.Adam(learning_rate=0.01).minimize(loss)
        exe = static.Executor("cpu")
        exe.run(t[3])
        feed = {"x": _images(3, 4, (8,))}
        exe.run(t[2], feed=feed, fetch_list=[loss])
        const = [op for op in t[2].global_block().ops if op.prim == "@const"]
        assert const and "_on" in const[0].attrs
        data = static.serialize_program(program=t[2])
        prog = static.deserialize_program(data)
        assert [op.type for op in prog.global_block().ops] == \
            [op.type for op in t[2].global_block().ops]
        assert all("_on" not in op.attrs for op in prog.global_block().ops)
        assert {n: (v.shape, v.dtype) for n, v in
                prog.global_block().vars.items()} == {
            n: (v.shape, v.dtype) for n, v in t[2].global_block().vars.items()}
        assert prog._parameters == t[2]._parameters
        with pytest.raises(InvalidArgumentError, match="init"):
            static.serialize_program(program=t[3])

        names = _persistables(t[2])
        saved = scope_values(t[1], names)
        held = [static.global_scope().find_var(n) for n in names]
        blob = static.serialize_persistables(program=t[2])
        state = static.get_program_state(t[2])
        prefix = str(tmp_path / "m")
        static.save(t[2], prefix)
        assert static.load_from_file(prefix + ".pdmodel") == data

        def perturb():
            exe.run(t[2], feed=feed, fetch_list=[loss])
            assert not np.array_equal(scope_values(t[1], names[:1])[0],
                                      saved[0])

        def restored():
            for n, h, want in zip(names, held, saved):
                cur = static.global_scope().find_var(n)
                assert cur is h, n              # written in place
                np.testing.assert_array_equal(cur.numpy(), want)

        perturb()
        static.deserialize_persistables(t[2], blob)
        restored()
        perturb()
        static.set_program_state(t[2], state)
        restored()
        perturb()
        static.load(prog, prefix)
        restored()
        sub = static.load_program_state(prefix, var_list=names[:2])
        assert sorted(sub) == sorted(names[:2])
        for n, want in zip(names, saved):
            np.testing.assert_array_equal(
                static.load_program_state(prefix)[n], want)


TRAIN = {
    "momentum": lambda p: p.optimizer.Momentum(learning_rate=0.3,
                                               momentum=0.9),
    "adam": lambda p: p.optimizer.Adam(learning_rate=0.01),
    # port only: the grad clip and AdamW's decay choice rebuilt from attrs
    "adamw_clip": lambda p: p.optimizer.AdamW(
        learning_rate=0.01, weight_decay=0.1,
        grad_clip=p.nn.ClipGradByGlobalNorm(0.5),
        apply_decay_param_fun=_first_param_only(p)),
}


def _first_param_only(pkg):
    main = pkg.static.default_main_program()
    return lambda n: n == main._parameters[0]


def _train_program(pkg, st, optimizer):
    """tests/test_static.py's train-program round trip: fc 16 (relu), fc
    2, cross entropy."""
    x = st.data("x", [None, 4], "float32")
    y = st.data("y", [None], "int64")
    h = st.nn.fc(x, 16, activation="relu")
    loss = pkg.nn.functional.cross_entropy(st.nn.fc(h, 2), y)
    optimizer(pkg).minimize(loss)
    return loss


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_saved_train_program_continues(name, tmp_path):
    """One step, static.save, then five steps of the running program and
    five of deserialize_program + static.load in a fresh scope: the same
    losses and persistables bit for bit; against JAX's round trip of the
    same program (Momentum and Adam), losses within tolerance."""
    rs = np.random.RandomState(0)
    X = rs.randn(64, 4).astype("float32")
    feed = {"x": X, "y": (X.sum(1) > 0).astype("int64")}
    runs = {}
    with static_modes() as (j, t):
        sides = (j, t) if name != "adamw_clip" else (t,)
        losses = {id(s): _train_program(s[0], s[1], TRAIN[name])
                  for s in sides}
        if len(sides) == 2:
            static_pair_state(j, t)
        else:
            static.Executor("cpu").run(t[3])
        for s in sides:
            port = s is t
            exe = static.Executor("cpu") if port else s[1].Executor()
            loss = losses[id(s)]
            exe.run(s[2], feed=feed, fetch_list=[loss.name])
            prefix = str(tmp_path / ("port" if port else "jax"))
            s[1].save(s[2], prefix)
            prog = s[1].deserialize_program(
                open(prefix + ".pdmodel", "rb").read())
            fresh = s[1].Scope()
            with s[1].scope_guard(fresh):
                exe2 = static.Executor("cpu") if port else s[1].Executor()
                s[1].load(prog, prefix, exe2)
                runs[(port, "loaded")] = [
                    float(np.asarray(exe2.run(prog, feed=feed, fetch_list=[
                        loss.name])[0])) for _ in range(5)]
                if port:
                    after = scope_values(s[1], _persistables(prog))
            if port:
                runs[(port, "running")] = [
                    float(exe.run(s[2], feed=feed,
                                  fetch_list=[loss.name])[0])
                    for _ in range(5)]
                for a, b in zip(after, scope_values(s[1],
                                                    _persistables(prog))):
                    np.testing.assert_array_equal(a, b)
    assert runs[(True, "loaded")] == runs[(True, "running")]
    assert runs[(True, "loaded")][-1] < runs[(True, "loaded")][0]
    if (False, "loaded") in runs:
        np.testing.assert_allclose(runs[(True, "loaded")],
                                   runs[(False, "loaded")], rtol=RTOL,
                                   atol=ATOL)


def test_cache_extra_key_and_quant_signature(tmp_path):
    """set_cache_extra_key splits the in-process cache (None restores the
    plain key); Config.set_quant_signature survives set_model and reaches
    the static Predictor's Executor as quant:<sig>; the persistent compile
    cache still raises with its ROADMAP item."""
    with static_modes() as (_, t):
        out = _fc(t[0], t[1])
        exe = static.Executor("cpu")
        exe.run(t[3])
        feed = {"x": _images(0, 2, (8,))}
        want = exe.run(t[2], feed=feed, fetch_list=[out])[0]
        keys = []
        for key in ("quant:abc", None, "quant:abc", "quant:def"):
            exe.set_cache_extra_key(key)
            np.testing.assert_array_equal(
                exe.run(t[2], feed=feed, fetch_list=[out])[0], want)
            keys.append(len(exe._cache))
        assert keys == [2, 2, 2, 3]
        assert {k[-1] for k in exe._cache} == {None, "quant:abc",
                                               "quant:def"}
        static.save_inference_model(str(tmp_path), ["x"], [out], exe,
                                    main_program=t[2])
    cfg = inference.Config(str(tmp_path))
    cfg.set_quant_signature("s8w8")
    cfg.set_model(str(tmp_path))
    assert cfg.quant_signature() == "s8w8"
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    np.testing.assert_array_equal(pred.run([feed["x"]])[0], want)
    assert [k[-1] for k in pred._exe._cache] == ["quant:s8w8"]
    assert _cpu_predictor(str(tmp_path))._exe._cache_extra_key is None
    with pytest.raises(UnimplementedError, match="A4"):
        cfg.set_optim_cache_dir(str(tmp_path / "cache"))


def test_predictor_clones_on_four_threads_agree(tmp_path):
    """Four clones of one static Predictor, each on its own thread with
    its own batch size, 20 runs each under a short switch interval: every
    result equals the single-threaded run on the same input."""
    with static_modes() as (_, t):
        out = _fc(t[0], t[1])
        exe = static.Executor("cpu")
        exe.run(t[3])
        static.save_inference_model(str(tmp_path), ["x"], [out], exe,
                                    main_program=t[2])
    pred = _cpu_predictor(str(tmp_path))
    inputs = {k: [_images(10 * k + i, k, (8,)) for i in range(20)]
              for k in (1, 2, 3, 4)}
    want = {k: [pred.run([x])[0] for x in xs] for k, xs in inputs.items()}

    def worker(k):
        clone = pred.clone()
        assert clone._exe is pred._exe and clone._feeds is not pred._feeds
        return [clone.run([x])[0] for x in inputs[k]]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futs = {k: pool.submit(worker, k) for k in inputs}
            got = {k: f.result(timeout=TIMEOUT) for k, f in futs.items()}
    finally:
        sys.setswitchinterval(interval)
    for k in inputs:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b)


def _fc_dir(tmp_path):
    with static_modes() as (_, t):
        out = _fc(t[0], t[1])
        exe = static.Executor("cpu")
        exe.run(t[3])
        xd = _images(0, 2, (8,))
        ref = exe.run(t[2], feed={"x": xd}, fetch_list=[out])[0]
        static.save_inference_model(str(tmp_path), ["x"], [out], exe,
                                    main_program=t[2])
    return xd, ref


def test_executor_backed_server(tmp_path):
    """JAX tests/test_serving.py's executor case on the port: a static
    directory served through Predictor clones on two workers, rows for 2,
    1, 4 and 3 requests, the "executor" backend, no steady-state
    capture."""
    xd, ref = _fc_dir(tmp_path)
    srv = serving.Server(serving.ServingConfig(workers=2), device="cpu")
    srv.register("fc", str(tmp_path), buckets=(1, 2, 4),
                 input_specs=[([None, 8], "float32")])
    srv.start()
    try:
        st = srv.stats("fc")
        assert st["backend"] == "executor" and st["steady_compiles"] == 0
        for rows in (2, 1, 4, 3):
            got = srv.submit("fc", [xd[:1].repeat(rows, axis=0)]) \
                .result(timeout=TIMEOUT)
            np.testing.assert_allclose(got[0], np.repeat(ref[:1], rows, 0),
                                       rtol=RTOL, atol=ATOL)
        assert srv.compile_events_since_warmup() == []
        srv.assert_zero_steady_state_recompiles()
        assert srv.stats("fc")["completed"] == 4
    finally:
        srv.stop()


def test_executor_backed_server_requires_input_specs(tmp_path):
    _fc_dir(tmp_path)
    srv = serving.Server(device="cpu")
    srv.register("nospec", str(tmp_path))
    try:
        with pytest.raises(PreconditionNotMetError, match="input_specs"):
            srv.start()
    finally:
        srv.stop()


def test_no_package_left_in_static_mode():
    """Runs last in this file: nothing above leaked static mode."""
    assert not either_static()
