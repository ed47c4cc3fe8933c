"""Cross entropy of the PyTorch port against the JAX package, on the
CPU in f32 (atol and rtol 1e-6: the same log-softmax and mean, summed in other
orders), and the GPT loss on a batch whose labels are all ignored: JAX
divides by max(count, 1) and gives 0, where torch's own cross entropy
gives 0/0 = NaN."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from torch_port_util import gpt_pair
from paddle_tpu_torch.nn.functional import cross_entropy


@pytest.mark.parametrize("ignored", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(ignored, reduction):
    rng = np.random.RandomState(41)
    logits = rng.randn(12, 17).astype(np.float32) * 3
    labels = rng.randint(0, 17, (12,)).astype(np.int64)
    labels[rng.rand(12) < ignored] = -100
    want = np.asarray(JF.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        reduction=reduction).numpy())
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        reduction=reduction).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    if reduction == "none":        # a trailing label axis of 1 is squeezed
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels[:, None]),
                            reduction="none").numpy()
        np.testing.assert_allclose(got[:, 0], want, atol=1e-6, rtol=0)


def test_gpt_loss_on_an_all_ignored_batch_is_zero_as_in_jax():
    jm, pm = gpt_pair(42, vocab_size=64, hidden_size=32, layers=1, heads=2,
                      seq=16)
    ids = np.random.RandomState(43).randint(0, 64, (2, 8)).astype(np.int64)
    labels = np.full_like(ids, -100)
    want = float(jm(paddle.to_tensor(ids),
                    labels=paddle.to_tensor(labels)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert want == 0.0 and got.item() == 0.0
    # and on a live batch the two losses agree
    labels[:, ::2] = ids[:, ::2]
    want = float(jm(paddle.to_tensor(ids),
                    labels=paddle.to_tensor(labels)).numpy())
    with torch.no_grad():
        got = pm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, atol=1e-5)
