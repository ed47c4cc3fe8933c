"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Mirrors ``paddle_tpu``'s layout module for module.  Entry points run on
the GPU unless the caller passes ``device="cpu"``.  The decode attention
of the serving path, the attention of the BERT training path (forward
and backward) and the conv+BN(+ReLU) sites of the ResNet training path
run through hand-written CUDA kernels (``ops/kernels``, sources in
``csrc/``) built with ``nvcc`` on first use.  ``enable_static()`` turns
on static-graph mode (``static``): registered ops then record into a
``Program`` that an ``Executor`` runs.

``import paddle_tpu_torch as paddle`` reaches the subpackages of the JAX
package's ``_SUBPACKAGES`` that are ported (``paddle.amp``,
``paddle.jit``, ``paddle.quantization``, ``paddle.serving``,
``paddle.vision``...), so code
written against ``paddle`` (``paddle.amp.decorate``, ``paddle.cast``,
``nn.Layer``) runs unchanged.
"""
from . import framework  # noqa: F401
from .framework.core import (disable_static, enable_static,  # noqa: F401
                             in_dygraph_mode, in_static_mode)
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.place import CPUPlace, CUDAPlace  # noqa: F401
from .framework.random import seed  # noqa: F401
from .ops.manipulation import cast, flatten, reshape  # noqa: F401
from .ops.math import (add, divide, matmul, mean, multiply,  # noqa: F401
                       subtract, sum)
from . import nn, optimizer, static  # noqa: F401,E402
from . import (amp, distributed, inference, jit,  # noqa: F401,E402
               profiler, quantization, serving, text, vision)
from .nn.layer.layers import ParamAttr  # noqa: F401,E402
