"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU as its own tests run it (Pallas kernels in interpret
mode), and the port runs with ``device="cpu"``, where every kernel
wrapper computes its plain PyTorch version.
"""
import contextlib

import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.functional import layer_state
from paddle_tpu.text.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.text.models.bert import BertForPretraining as JaxBert
from paddle_tpu.text.models.bert import BertModel as JaxBertModel
from paddle_tpu.text.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.text.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.text.models import (BertConfig, BertForPretraining,
                                          GPTConfig, GPTModel)
from paddle_tpu_torch.text.models.bert import BertModel

# f32 comparisons: no TF32 anywhere (a no-op on the CPU, stated anyway)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# several pytest workers share the host and the shapes here are tiny: one
# intra-op thread, so torch starts no OpenMP pool in a worker that later
# runs tests which fork
torch.set_num_threads(1)

# the kernel-path width: head_dim 64 passes supports_decode
KERNEL_TINY = dict(vocab_size=128, hidden_size=128, layers=2, heads=2,
                   seq=64)


def jax_params(layer):
    """``layer_state(layer)``'s parameters and buffers (BatchNorm's running
    statistics) as one dict of numpy arrays (the bridge's input)."""
    params, buffers = layer_state(layer)[:2]
    return {k: np.asarray(v) for k, v in {**params, **buffers}.items()}


def gpt_pair(seed, **tiny):
    """A JAX GPTModel drawn from ``seed`` and the port's GPTModel on the
    CPU carrying the same weights, both in eval mode."""
    paddle.seed(seed)
    jm = JaxGPTModel(JaxGPTConfig.tiny(**tiny))
    jm.eval()
    pm = GPTModel(GPTConfig.tiny(**tiny), device="cpu")
    load_jax_state(pm, jax_params(jm))
    pm.eval()
    return jm, pm


def prompts(seed, lengths, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, int(n)).astype(np.int32) for n in lengths]


def bert_pair(seed, cfg_fields):
    """A JAX BertForPretraining drawn from ``seed`` and the port's on the
    CPU carrying the same weights; ``cfg_fields`` are BertConfig fields
    (both packages' BertConfig take the same ones)."""
    paddle.seed(seed)
    jm = JaxBert(JaxBertConfig(**cfg_fields))
    pm = BertForPretraining(BertConfig(**cfg_fields), device="cpu")
    load_jax_state(pm, jax_params(jm))
    return jm, pm


def bert_model_pair(seed, cfg_fields):
    """A JAX BertModel (encoder + pooler) drawn from ``seed`` and the
    port's on the CPU carrying the same weights, both in eval mode."""
    paddle.seed(seed)
    jm = JaxBertModel(JaxBertConfig(**cfg_fields))
    jm.eval()
    pm = BertModel(BertConfig(**cfg_fields), device="cpu")
    load_jax_state(pm, jax_params(jm))
    return jm, pm.eval()


def bert_batch(seed, cfg_fields, batch, seq, n_pred, ragged=True):
    """Seeded BERT pretraining inputs as bench.py draws them: token ids,
    ``n_pred`` distinct masked positions per row and their labels, NSP
    labels, token types and (``ragged``) a 1/0 attention mask whose rows
    keep between seq/2 and seq tokens."""
    rng = np.random.RandomState(seed)
    V = cfg_fields.get("vocab_size", 30522)
    ids = rng.randint(0, V, (batch, seq)).astype(np.int64)
    pos = np.stack([rng.choice(seq, n_pred, replace=False)
                    for _ in range(batch)]).astype(np.int64)
    labels = np.take_along_axis(ids, pos, 1)
    types = (np.arange(seq)[None, :] >= seq // 2).astype(np.int64) \
        .repeat(batch, 0)
    mask = None
    if ragged:
        lens = rng.randint(seq // 2, seq + 1, batch)
        mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
    nsp = rng.randint(0, 2, (batch,)).astype(np.int64)
    return ids, types, mask, labels, nsp, pos


def no_dropout(cfg_fields):
    return dict(cfg_fields, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)


def jax_bert_loss_and_grads(jm, batch):
    """Eager JAX loss and ``{name: grad}`` of a training-mode forward
    (zeros for a parameter the loss does not reach)."""
    jm.train()
    args = [None if x is None else paddle.to_tensor(x) for x in batch]
    for p in jm.parameters():
        p.clear_grad()
    loss = jm(*args)
    loss.backward()
    return float(loss.numpy()), {
        n: np.zeros(p.shape, np.float32) if p.grad is None
        else np.asarray(p.grad._value) for n, p in jm.named_parameters()}


def linear_weight_names(module):
    return {f"{n}.weight" for n, m in module.named_modules()
            if isinstance(m, torch.nn.Linear)}



# -- static graph (tests/test_torch_static*.py) --------------------------------

@contextlib.contextmanager
def static_modes():
    """Both packages in static mode, each under a fresh Scope and a fresh
    (main, startup) Program pair entered with program_guard; every piece
    of that process-global state is restored on the way out.  Yields
    ``(jax_side, port_side)``, each ``(paddle, static, main, startup)``."""
    import paddle_tpu.static as jstatic

    import paddle_tpu_torch as tpaddle
    import paddle_tpu_torch.static as tstatic
    from paddle_tpu.framework import core as jcore
    from paddle_tpu_torch.framework import core as tcore
    prev = (jcore.in_static_mode(), tcore.in_static_mode())
    sides = []
    try:
        with contextlib.ExitStack() as stack:
            for pkg, static, core in ((paddle, jstatic, jcore),
                                      (tpaddle, tstatic, tcore)):
                core.enable_static()
                main, startup = static.Program(), static.Program()
                stack.enter_context(static.scope_guard(static.Scope()))
                stack.enter_context(static.program_guard(main, startup))
                sides.append((pkg, static, main, startup))
            yield tuple(sides)
    finally:
        for on, core in zip(prev, (jcore, tcore)):
            (core.enable_static if on else core.disable_static)()


def either_static():
    """True if either package is in static mode."""
    from paddle_tpu.framework import core as jcore
    from paddle_tpu_torch.framework import core as tcore
    return jcore.in_static_mode() or tcore.in_static_mode()


def lenet(paddle, static, optimizer=None):
    """bench.py's LeNet program (``bench_lenet_static``) for either
    package; ``optimizer(paddle)`` makes the optimizer to minimize with.
    Returns (loss, logits)."""
    img = static.data("img", [None, 1, 28, 28], "float32")
    label = static.data("label", [None], "int64")
    h = static.nn.conv2d(img, 6, 5, padding=2, act="relu")
    h = paddle.nn.functional.max_pool2d(h, 2, 2)
    h = static.nn.conv2d(h, 16, 5, act="relu")
    h = paddle.nn.functional.max_pool2d(h, 2, 2)
    h = paddle.flatten(h, start_axis=1)
    h = static.nn.fc(h, 120, activation="relu")
    h = static.nn.fc(h, 84, activation="relu")
    logits = static.nn.fc(h, 10)
    loss = paddle.nn.functional.cross_entropy(logits, label)
    if optimizer is not None:
        optimizer(paddle).minimize(loss)
    return loss, logits


def mlp(paddle, static, optimizer=None):
    """The MLP program of tests/test_static.py (``_mlp_program``).
    Returns (loss, logits)."""
    x = static.data("x", [None, 16], "float32")
    y = static.data("y", [None], "int64")
    h = static.nn.fc(x, 32, activation="relu")
    logits = static.nn.fc(h, 4)
    loss = paddle.nn.functional.cross_entropy(logits, y)
    if optimizer is not None:
        optimizer(paddle).minimize(loss)
    return loss, logits


def static_pair_state(jax_side, port_side):
    """Carry the JAX program's scope into the port's (after running the
    port's startup on the CPU)."""
    from paddle_tpu_torch.framework.bridge import load_jax_program_state
    jm, tm = jax_side[2], port_side[2]
    port_side[1].Executor("cpu").run(port_side[3])
    names = [v.name for v in jm.list_vars() if v.persistable]
    load_jax_program_state(jm, dict(zip(names, scope_values(jax_side[1],
                                                            names))),
                           tm, port_side[1].global_scope())


def scope_values(static, names):
    """numpy copies of the global scope's values of ``names``."""
    vals = [static.global_scope().find_var(n) for n in names]
    return [np.array(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for v in vals]
