"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Mirrors ``paddle_tpu``'s layout module for module.  Entry points run on
the GPU unless the caller passes ``device="cpu"``.  The decode attention
of the serving path, the attention of the BERT training path (forward
and backward) and the conv+BN(+ReLU) sites of the ResNet training path
run through hand-written CUDA kernels (``ops/kernels``, sources in
``csrc/``) built with ``nvcc`` on first use.
"""
from . import framework  # noqa: F401
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.random import seed  # noqa: F401
