"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU as its own tests run it (Pallas kernels in interpret
mode), and the port runs with ``device="cpu"``, where every kernel
wrapper computes its plain PyTorch version.
"""
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

