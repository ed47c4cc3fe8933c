"""The PyTorch port stands alone: no file of ``paddle_tpu_torch`` and
neither ``chip_smoke.py`` nor ``attention_ab.py`` imports JAX, the JAX package or ``ml_dtypes`` (the
card's machine has none of them), the package imports with all three
made unimportable, and its entry points refuse to run on the CPU unless
the caller asks for it."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.enforce import PreconditionNotMetError
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import TrainStep
from paddle_tpu_torch.text.generation import Generator
from paddle_tpu_torch.text.models import (BertConfig, BertForPretraining,
                                          GPTConfig, GPTModel)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")


def _port_sources():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    out = [os.path.join(ROOT, f) for f in ("attention_ab.py",
                                            "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20 and all(map(os.path.exists, files[:2]))
    for new in ("quantization/ptq.py", "quantization/freeze.py",
                "ops/int8.py", "static/api_extra.py", "ops/routing.py",
                "nn/layer/moe.py", "parallel/mesh.py",
                "profiler/metrics.py"):
        assert os.path.join(ROOT, "paddle_tpu_torch", new) in files
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f))
                                             & set(BANNED))
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_package_imports_with_jax_unimportable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes'):\n"
            "    sys.modules[m] = None\n"
            "import paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.text, paddle_tpu_torch.framework.bridge\n"
            "import paddle_tpu_torch.ops.kernels.flash_decode\n"
            "import paddle_tpu_torch.ops.kernels.flash_attention\n"
            "import paddle_tpu_torch.ops.kernels.fused_bn\n"
            "import paddle_tpu_torch.ops.kernels.fused_conv\n"
            "from paddle_tpu_torch.vision.models import resnet50\n"
            "from paddle_tpu_torch.nn import CrossEntropyLoss\n"
            "from paddle_tpu_torch.optimizer import Momentum\n"
            "import paddle_tpu_torch.optimizer, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.parallel, paddle_tpu_torch.nn\n"
            "from paddle_tpu_torch.text.models import BertForPretraining\n"
            "import paddle_tpu_torch.jit, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.static, paddle_tpu_torch.profiler.cuda_graph\n"
            "from paddle_tpu_torch.serving import export_for_serving\n"
            "from paddle_tpu_torch.amp import decorate\n"
            "import paddle_tpu_torch.checkpoint, "
            "paddle_tpu_torch.serving.sessions, "
            "paddle_tpu_torch.serving.cluster.handoff\n"
            "from paddle_tpu_torch.serving import SessionStore, KVHandoff\n"
            "import paddle_tpu_torch.distributed, paddle_tpu_torch.rec\n"
            "from paddle_tpu_torch.distributed.ps import (DeviceEmbeddingCache,"
            " PsServer, ShardedPsClient)\n"
            "from paddle_tpu_torch.distributed import InMemoryDataset\n"
            "from paddle_tpu_torch.rec.wide_deep import (WideDeepTrainer, "
            "load_jax_wide_deep)\n"
            "import paddle_tpu_torch.static.executor, "
            "paddle_tpu_torch.static.backward, paddle_tpu_torch.static.io\n"
            "import paddle_tpu_torch.static.api_extra\n"
            "from paddle_tpu_torch.static import (deserialize_program, "
            "load_inference_model, save_inference_model)\n"
            "from paddle_tpu_torch.static import (Executor, Program, data, "
            "nn, program_guard)\n"
            "from paddle_tpu_torch.framework.bridge import "
            "load_jax_program_state\n"
            "from paddle_tpu_torch.optimizer import SGD\n"
            "from paddle_tpu_torch import enable_static, flatten, matmul\n"
            "from paddle_tpu_torch.nn import Layer, LayerList, Sequential\n"
            "from paddle_tpu_torch.vision.models import LeNet\n"
            "import paddle_tpu_torch.quantization, paddle_tpu_torch.ops.int8\n"
            "from paddle_tpu_torch.quantization import (freeze, "
            "PostTrainingQuantization, save_int8_model)\n"
            "from paddle_tpu_torch.ops.int8 import conv2d_int8, linear_int8\n"
            "from paddle_tpu_torch.nn.functional.common import (cached_ffn, "
            "cached_linear, cached_linears)\n"
            "from paddle_tpu_torch.text.models import GPTMoEModel\n"
            "from paddle_tpu_torch.nn.layer.moe import publish_moe_metrics\n"
            "from paddle_tpu_torch.ops.routing import expert_dispatch_plan\n"
            "from paddle_tpu_torch.parallel import make_mesh, MeshGuard\n"
            "from paddle_tpu_torch.profiler import default_registry\n"
            "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig.tiny()
    with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
        GPTModel(cfg)
    with pytest.raises(PreconditionNotMetError):
        GPTModel(cfg, device="cuda")
    m = GPTModel(cfg, device="cpu")
    with pytest.raises(PreconditionNotMetError):
        Generator(m)
    with pytest.raises(PreconditionNotMetError):
        serving.Server()
    # the session and handoff entry points are the Server's: on the CPU
    # only when the caller asks for it
    srv = serving.Server(device="cpu")
    srv.register_decode("gpt", m, batch_buckets=(1,), seq_buckets=(8,),
                        max_new_tokens=2, max_len=16)
    srv.start()
    try:
        h = srv.prefill_handoff("gpt", [np.ones(3, np.int64)])
        assert h.cache[0][0].device.type == "cpu"
        assert srv.decode_from_handoff("gpt", h.to_bytes()).shape == (1, 2)
    finally:
        srv.stop()
    out = Generator(m, device="cpu", seq_buckets=(8,), max_len=16) \
        .generate(np.ones((1, 3), np.int64), max_new_tokens=2)
    assert out.device.type == "cpu" and out.shape == (1, 2)


def test_training_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BertConfig.tiny()
    with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
        BertForPretraining(cfg)
    with pytest.raises(PreconditionNotMetError):
        BertForPretraining(cfg, device="cuda")
    m = BertForPretraining(cfg, device="cpu")
    with pytest.raises(PreconditionNotMetError):
        TrainStep(m, AdamW())
    step = TrainStep(m, AdamW(), device="cpu")
    ids = np.ones((2, 8), np.int64)
    loss = step((ids, None, None, ids[:, :2], None,
                 np.zeros((2, 2), np.int64)))
    assert loss.device.type == "cpu" and np.isfinite(float(loss))


def test_moe_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from paddle_tpu_torch.nn import MoELayer
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.text.models import GPTMoEConfig, GPTMoEModel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTMoEConfig.tiny(experts=4)
    for make in (lambda **kw: GPTMoEModel(cfg, **kw),
                 lambda **kw: MoELayer(16, 32, 4, **kw)):
        with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
            make()
        with pytest.raises(PreconditionNotMetError):
            make(device="cuda")
        assert all(p.device.type == "cpu"
                   for p in make(device="cpu").parameters())
    with pytest.raises(PreconditionNotMetError, match="devices="):
        make_mesh({"ep": 1})
    mesh = make_mesh({"ep": 1}, devices=["cpu"])
    m = GPTMoEModel(cfg, device="cpu")
    with pytest.raises(PreconditionNotMetError):
        TrainStep(m, AdamW(), mesh=mesh)
    step = TrainStep(m, AdamW(), mesh=mesh, device="cpu")
    ids = np.ones((2, 8), np.int64)
    loss = step((ids, ids))
    assert loss.device.type == "cpu" and np.isfinite(float(loss))


def test_resnet_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18, resnet50
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
        resnet50(data_format="NHWC")
    m = resnet18(data_format="NHWC", num_classes=4, device="cpu")
    opt = Momentum(learning_rate=0.1, momentum=0.9)
    with pytest.raises(PreconditionNotMetError):
        TrainStep(m, opt, loss_fn=CrossEntropyLoss())
    step = TrainStep(m, opt, loss_fn=CrossEntropyLoss(), device="cpu")
    loss = step((np.random.RandomState(0).randn(2, 16, 16, 3)
                 .astype(np.float32),), np.array([0, 3]))
    assert loss.device.type == "cpu" and np.isfinite(float(loss))


def test_dense_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch,
                                                          tmp_path):
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = torch.nn.Linear(4, 2)
    prefix = str(tmp_path / "m")
    jit.save(net, prefix, input_spec=[InputSpec([None, 4])])
    with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
        jit.load(prefix)
    with pytest.raises(PreconditionNotMetError):
        inference.create_predictor(inference.Config(prefix))
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    out = inference.create_predictor(cfg).run([np.ones((3, 4), "float32")])
    assert out[0].shape == (3, 2)
    assert jit.load(prefix, device="cpu").device.type == "cpu"


def test_seq2seq_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models import LeNet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: nn.Transformer(64, 4, 1, 1, 128, **kw),
                 lambda **kw: nn.TransformerDecoderLayer(16, 2, 32, **kw),
                 lambda **kw: nn.TransformerEncoderLayer(16, 2, 32, **kw),
                 lambda **kw: nn.MultiHeadAttention(16, 2, kdim=8, vdim=12,
                                                    **kw),
                 lambda **kw: nn.Linear(8, 4, **kw),
                 lambda **kw: nn.Embedding(16, 8, **kw),
                 lambda **kw: nn.LayerNorm(8, **kw),
                 lambda **kw: nn.Conv2D(2, 3, 3, **kw),
                 lambda **kw: nn.BatchNorm2D(3, **kw),
                 lambda **kw: LeNet(**kw)):
        with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
            make()
        with pytest.raises(PreconditionNotMetError):
            make(device="cuda")
        assert all(p.device.type == "cpu"
                   for p in make(device="cpu").parameters())
    m = nn.Transformer(64, 4, 1, 1, 128, dropout=0.0, device="cpu")
    assert m.generate_square_subsequent_mask(4).device.type == "cpu"
    out = m(torch.randn(2, 6, 64), torch.randn(2, 5, 64))
    assert out.shape == (2, 5, 64) and bool(torch.isfinite(out).all())


def test_wide_deep_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from paddle_tpu_torch.distributed.ps import (DeviceEmbeddingCache,
                                                 DistributedEmbedding,
                                                 LocalPsEndpoint)
    from paddle_tpu_torch.rec.wide_deep import (WideDeep, WideDeepTrainer,
                                                synthetic_ctr_batch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: WideDeep(hidden=(8,), emb_dim=4, **kw),
                 lambda **kw: DistributedEmbedding(LocalPsEndpoint(), 0, 4,
                                                   **kw),
                 lambda **kw: DeviceEmbeddingCache(LocalPsEndpoint(), 0, 4,
                                                   capacity=16, **kw)):
        with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
            make()
        with pytest.raises(PreconditionNotMetError):
            make(device="cuda")
    m = WideDeep(hidden=(8,), emb_dim=4, device="cpu")
    assert all(p.device.type == "cpu" for p in m.parameters())
    # the trainer does not follow its model to the CPU by itself
    with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
        WideDeepTrainer(m)
    t = WideDeepTrainer(m, device="cpu")
    assert t._w_ar["rows"].device.type == "cpu"
    loss = t.step_async(*synthetic_ctr_batch(8, vocab=1_000, seed=0))
    assert loss.device.type == "cpu" and np.isfinite(float(loss))


def test_static_executor_needs_cuda_unless_asked_for_cpu(monkeypatch):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import static
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for place in (None, "gpu", "cuda", paddle.CUDAPlace(0)):
        with pytest.raises(PreconditionNotMetError):
            static.Executor(place)
    for place in ("cpu", paddle.CPUPlace()):
        assert static.Executor(place).device.type == "cpu"


def test_static_predictor_and_server_need_cuda_unless_asked_for_cpu(
        monkeypatch, tmp_path):
    """A save_inference_model directory: the static Predictor needs CUDA
    unless its Config asks for the CPU, and so does the executor-backed
    Server."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, static
    main, startup = static.Program(), static.Program()
    paddle.enable_static()
    try:
        with static.scope_guard(static.Scope()), \
                static.program_guard(main, startup):
            out = static.nn.fc(static.data("x", [None, 4], "float32"), 2)
            exe = static.Executor("cpu")
            exe.run(startup)
            static.save_inference_model(str(tmp_path), ["x"], [out], exe,
                                        main_program=main)
    finally:
        paddle.disable_static()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PreconditionNotMetError):
        inference.create_predictor(inference.Config(str(tmp_path)))
    cfg = inference.Config(str(tmp_path))
    cfg.disable_gpu()
    p = inference.create_predictor(cfg)
    assert p._exe.device.type == "cpu"
    assert p.run([np.ones((2, 4), np.float32)])[0].shape == (2, 2)
    srv = serving.Server(device="cpu")
    srv.register("fc", str(tmp_path), buckets=(1, 2),
                 input_specs=[([None, 4], "float32")])
    srv.start()
    try:
        got = srv.submit("fc", [np.ones((2, 4), np.float32)]).result(
            timeout=60)
        assert got[0].shape == (2, 2)
        assert srv.stats("fc")["backend"] == "executor"
    finally:
        srv.stop()


def test_int8_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch,
                                                         tmp_path):
    """PTQ runs on the model's device, and a default-built model needs the
    card; export_for_serving(int8=True) exports on the model's device;
    the int8 Predictor, like the float one, needs CUDA unless its Config
    asks for the CPU, with or without FLAGS_use_int8_inference; so does
    the Generator of a frozen GPT."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.framework.flags import (flags_restore,
                                                  flags_snapshot, set_flags)
    from paddle_tpu_torch.quantization import (FrozenQuantizedLinear,
                                               PostTrainingQuantization)
    from paddle_tpu_torch.vision.models import LeNet
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PreconditionNotMetError, match="device='cpu'"):
        LeNet()
    m = LeNet(device="cpu")
    cal = np.zeros((1, 1, 28, 28), np.float32) + 0.5
    PostTrainingQuantization(model=m, data_loader=((cal,) for _ in
                                                   range(4))).quantize()
    prefix = str(tmp_path / "lenet")
    man = serving.export_for_serving(m, prefix,
                                     [([None, 1, 28, 28], "float32")],
                                     buckets=(1, 2), int8=True)
    assert man["int8"] and isinstance(m.fc[0], FrozenQuantizedLinear)
    assert m.fc[0].weight_int8.device.type == "cpu"
    snap = flags_snapshot()
    try:
        for on in (False, True):
            set_flags({"FLAGS_use_int8_inference": on})
            with pytest.raises(PreconditionNotMetError):
                inference.create_predictor(inference.Config(prefix))
            cfg = inference.Config(prefix)
            cfg.disable_gpu()
            p = inference.create_predictor(cfg)
            assert p.quant_info()["sites"] == 5
            assert p.run([cal])[0].shape == (1, 10)
    finally:
        flags_restore(snap)
    with pytest.raises(PreconditionNotMetError):
        serving.Server().register("lenet", prefix)
    # a frozen GPT decodes on the CPU only when the Generator asks for it
    from paddle_tpu_torch.quantization import freeze
    gpt = GPTModel(GPTConfig.tiny(), device="cpu")
    ids = np.ones((1, 3), np.int64)
    PostTrainingQuantization(model=gpt, data_loader=((ids,) for _ in
                                                     range(4))).quantize()
    freeze(gpt)
    with pytest.raises(PreconditionNotMetError):
        Generator(gpt)
    out = Generator(gpt, device="cpu", seq_buckets=(8,), max_len=16) \
        .generate(ids, max_new_tokens=2)
    assert out.device.type == "cpu" and out.shape == (1, 2)


def test_attention_ab_needs_cuda_and_its_helpers_exist(monkeypatch):
    """attention_ab.py (the attention kernels of this checkout timed
    against another checkout's) refuses to run without a card, and every
    name it takes from chip_smoke.py and the port exists, so that a change
    to those helpers cannot leave it broken unseen."""
    import importlib

    import attention_ab
    import chip_smoke
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_decode as fd
    tree = ast.parse(open(attention_ab.__file__).read())
    mods = {"cs": chip_smoke, "_build": _build, "fa": fa, "fd": fd}
    used = {(n.value.id, n.attr) for n in ast.walk(tree)
            if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id in mods}
    assert {("cs", "_graph_ms"), ("cs", "_fa_bound"), ("_build", "_LIBS"),
            ("fd", "flash_decode_quant_block")} <= used
    assert [u for u in sorted(used) if not hasattr(mods[u[0]], u[1])] == []
    assert isinstance(_build._LIBS, dict)
    imports = [(n.module, a.name) for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.level == 0
               and n.module.startswith("paddle_tpu_torch")
               for a in n.names]
    assert len(imports) >= 4
    for module, name in imports:
        assert hasattr(importlib.import_module(module), name), (module, name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert attention_ab.main(["--other", ROOT]) == 1
