"""The port's ResNet (``vision/models/resnet.py``) against the JAX
package's on the CPU: ResNet-18, NHWC, 10 classes, 48x48 images, batch
2, the same weights and running statistics carried across by the
bridge.  One training-mode forward and backward: logits, the cross
entropy, every gradient and the updated running statistics, with the
fused gates on in both packages (the port's plain kernel versions, JAX's
Pallas kernels in interpret mode, both through the s2d stem) and off in
both.  Inputs come from numpy seeds.

48x48 and not 32x32: at 32x32 the last stage normalizes 2 values per
channel (1x1 spatial, batch 2), where BN's output d/sqrt(d² + eps) turns
a 1e-5 input difference into 1e-2 once |d| nears sqrt(eps); at 48x48 it
normalizes 8.  The images' seed is one whose ReLU inputs keep clear of
0: a ReLU gate is discontinuous, and at 64x64 with data seed 0 one
residual sum lies 1.7e-6 from 0, where the two paths' 1e-5 differences
flip its gate and move every gradient upstream of it by up to 0.1; at
48x48 seeds 0..7 all agree to 1.4e-5 of max|g| (fused against plain).

Tolerances: logits and loss 1e-4 (f32 on both sides; the sums of the
convs and of the batch statistics differ in order, ~1e-6 per layer over
20 layers); gradients 1e-4 of max(1, max|g|) per tensor (the backward
adds one such error per layer again); running statistics 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import resnet18 as jax_resnet18
from paddle_tpu.vision.models import resnet50 as jax_resnet50
from torch_port_util import jax_params, linear_weight_names
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.nn import CrossEntropyLoss
from paddle_tpu_torch.vision.models import resnet18, resnet50

FUSED = ("FLAGS_use_pallas_fused_conv", "FLAGS_use_pallas_fused_bn")


def _set_jax(on):
    paddle.set_flags({k: on for k in FUSED})


@pytest.mark.parametrize("fused", [True, False])
def test_resnet18_nhwc_train_forward_backward_matches_jax(fused):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 48, 48, 3).astype(np.float32)
    y = rng.randint(0, 10, (2,)).astype(np.int64)
    paddle.seed(1)
    jm = jax_resnet18(data_format="NHWC", num_classes=10)
    pm = resnet18(data_format="NHWC", num_classes=10, device="cpu")
    load_jax_state(pm, jax_params(jm))
    jm.train()
    pm.train()
    snap = flags.flags_snapshot()
    try:
        _set_jax(fused)
        flags.set_flags({k: fused for k in FUSED})
        jlogits = jm(paddle.to_tensor(x))
        jloss = paddle.nn.CrossEntropyLoss()(jlogits, paddle.to_tensor(y))
        jloss.backward()
        logits = pm(torch.from_numpy(x))
        loss = CrossEntropyLoss()(logits, torch.from_numpy(y))
        loss.backward()
    finally:
        _set_jax(False)
        flags.flags_restore(snap)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), rtol=1e-4,
                               atol=1e-4)
    linear = linear_weight_names(pm)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    for n, p in pm.named_parameters():
        got = p.grad.numpy().T if n in linear else p.grad.numpy()
        scale = max(1.0, float(np.abs(jgrads[n]).max()))
        np.testing.assert_allclose(got, jgrads[n], rtol=0,
                                   atol=1e-4 * scale, err_msg=n)
    jbuf = jax_params(jm)
    for n, b in pm.named_buffers():
        np.testing.assert_allclose(b.numpy(), jbuf[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)


def test_resnet50_state_names_and_shapes_match_jax():
    """Every parameter and running statistic of ResNet-50 carries the JAX
    package's dotted name and (after the bridge's layout) shape: conv1,
    bn1, layerN.i.convK/bnK, layerN.0.downsample.0/1, fc."""
    paddle.seed(2)
    jm = jax_resnet50(data_format="NHWC")
    pm = resnet50(data_format="NHWC", device="cpu")
    want = jax_params(jm)
    sd = pm.state_dict()
    assert set(sd) == set(want)
    linear = linear_weight_names(pm)
    for n, t in sd.items():
        shape = tuple(reversed(t.shape)) if n in linear else tuple(t.shape)
        assert shape == want[n].shape, n
    assert sum(1 for n in sd if n.endswith("downsample.0.weight")) == 4
    assert sum(1 for n in sd if n.endswith("._mean")) == 53
