"""What cuDNN's algorithm choice costs bench.py's LeNet on the static
Executor, on a CUDA card.

The Executor replays its programs with cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic``), which a captured run needs to
equal an eager one bit for bit.  This probe runs chip_smoke.py's
static_lenet training (batch 128, 200 steps an epoch, SGD 0.01, TF32
off) under four settings of (deterministic, benchmark), in turns, the
first again at the end: a warm-up epoch, the best of two timed epochs
on the host clock, 200 replays of the captured graph timed by CUDA
events (best of three), the graph's kernel nodes, and a trace of 20
steps (idle share, the largest device ops).  The deterministic setting
is forced inside the Executor's replay, so only the algorithm choice
differs between the turns.

``--cpu-fit`` instead runs, on the host, the question behind the
phase's fit check: how far 30 steps on one repeated batch of 128
(``np.random.RandomState(0)``, the CPU generator at seed 0) take the
loss under bench's SGD(0.01) and under Adam(3e-3).

Run from the repo root: ``python3 static_lenet_probe.py [--cpu-fit]``.
Each reading is one ``[probe_static_lenet]`` or
``[probe_static_lenet_cpu_fit]`` JSON line.
"""
import json
import sys
import time

import chip_smoke as cs

TURNS = ((True, False), (False, False), (True, True), (False, True),
         (True, False))


def _turn(torch, paddle, static, executor, det, bench):
    from paddle_tpu_torch.profiler.cuda_graph import graph_kernel_nodes
    plain = executor.replay

    def replay(ops, env, device):
        c = torch.backends.cudnn
        prev = (c.deterministic, c.benchmark)
        c.deterministic, c.benchmark = det, bench
        try:
            plain(ops, env, device)
        finally:
            c.deterministic, c.benchmark = prev

    executor.replay = replay
    try:
        main, startup, loss = cs._lenet_program(
            paddle, static, lambda p: p.optimizer.SGD(
                learning_rate=cs.LENET["lr"]))
        B, n = cs.LENET["batch"], cs.LENET["steps"]
        exe, sc = static.Executor(), static.Scope()
        paddle.seed(0)
        exe.run(startup, scope=sc)
        stacks = {k: torch.from_numpy(v).cuda()
                  for k, v in cs._lenet_stacks(0, n, B).items()}

        def epoch(data=stacks):
            exe.train_from_dataset(main, dataset=data, fetch_list=[loss],
                                   scope=sc)

        epoch()
        best = None
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        graph = exe.captured_graphs(main)[0]
        times = []
        for _ in range(3):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(n):
                graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / n)
        idle = cs._wd_idle(torch, lambda: epoch(
            {k: v[:cs.LENET["trace_steps"]] for k, v in stacks.items()}))
        print("[probe_static_lenet] " + json.dumps({
            "deterministic": det, "benchmark": bench,
            "host_img_per_s": round(B * n / best, 1),
            "in_graph_step_ms": round(min(times), 5),
            "kernel_nodes": len(graph_kernel_nodes(graph)),
            "device_idle_share": idle.get("device_idle_share"),
            "top_device_ops": idle.get("top_device_ops", [])[:4]}),
            flush=True)
    finally:
        executor.replay = plain


def cpu_fit():
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    for name, make in (("SGD(0.01)", lambda p: p.optimizer.SGD(
            learning_rate=0.01)), ("Adam(3e-3)", lambda p: p.optimizer.Adam(
                learning_rate=3e-3))):
        paddle.seed(0)
        main, startup, loss = cs._lenet_program(paddle, static, make)
        exe, sc = static.Executor("cpu"), static.Scope()
        exe.run(startup, scope=sc)
        rng = np.random.RandomState(0)
        feed = {"img": rng.randn(128, 1, 28, 28).astype("float32"),
                "label": rng.randint(0, 10, 128)}
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=sc)[0]) for _ in range(31)]
        print("[probe_static_lenet_cpu_fit] " + json.dumps({
            "optimizer": name, "first": losses[0], "after_30": losses[-1],
            "ratio": losses[-1] / losses[0]}), flush=True)
    return 0


def main():
    if "--cpu-fit" in sys.argv[1:]:
        return cpu_fit()
    import torch
    if not torch.cuda.is_available():
        print("static_lenet_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import executor
    print(cs.phase_env(torch)["nvidia_smi"])
    for det, bench in TURNS:
        _turn(torch, paddle, static, executor, det, bench)
    return 0


if __name__ == "__main__":
    sys.exit(main())
