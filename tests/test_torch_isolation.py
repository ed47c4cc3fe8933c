"""The PyTorch port stands alone: no file of ``paddle_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, the package imports
with JAX made unimportable, and its entry points refuse to run on the
CPU unless the caller asks for it."""
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
BANNED = ("jax", "jaxlib", "paddle_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
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
    assert len(files) > 20 and os.path.exists(files[0])
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f))
                                             & set(BANNED))
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_package_imports_with_jax_unimportable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'paddle_tpu'):\n"
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
