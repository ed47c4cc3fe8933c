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
from paddle_tpu.text.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.text.models.gpt import GPTModel as JaxGPTModel
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.text.models import GPTConfig, GPTModel

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
    """``layer_state(layer)[0]`` as numpy arrays (the bridge's input)."""
    return {k: np.asarray(v) for k, v in layer_state(layer)[0].items()}


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
