"""BERT pretraining of the PyTorch port against the JAX package, on the
CPU in f32: the loss and every parameter gradient of one training-mode
forward and backward, with the JAX model's weights carried across by
``load_jax_state`` (Linear weights and their gradients transposed) and
dropout off (the two packages draw different masks).

Tolerances: loss atol 1e-5; gradients atol 2e-5 and rtol 1e-4 at the
tiny widths, atol 1e-4 at BERT-base widths — the frameworks sum f32
matmuls in other orders, and the tied word embedding sums two
gradients (the embedding lookup and the MLM decoder).
"""
import numpy as np
import pytest
import torch

from torch_port_util import (bert_batch, bert_pair, jax_bert_loss_and_grads,
                             jax_params, linear_weight_names, no_dropout)
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.framework.enforce import InvalidArgumentError
from paddle_tpu_torch.text.models import BertConfig, BertForPretraining

TINY = no_dropout(dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=2, intermediate_size=256,
                       max_position_embeddings=64))
# BertConfig.base() widths at one layer
BASE_1L = no_dropout(dict(BertConfig.base().__dict__, num_hidden_layers=1))


def _port_loss_and_grads(pm, batch):
    pm.train()
    pm.zero_grad()
    loss = pm(*[None if x is None else torch.from_numpy(x) for x in batch])
    loss.backward()
    return loss.item(), {n: torch.zeros_like(p).numpy() if p.grad is None
                         else p.grad.numpy()
                         for n, p in pm.named_parameters()}


def _compare(jm, pm, batch, atol, rtol):
    jl, jg = jax_bert_loss_and_grads(jm, batch)
    tl, tg = _port_loss_and_grads(pm, batch)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert set(tg) == set(jg)
    linear = linear_weight_names(pm)
    for name, want in jg.items():
        got = tg[name].T if name in linear else tg[name]
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def tiny_pair():
    return bert_pair(21, TINY)


def test_bridge_skips_the_tied_decoder_and_stays_strict(tiny_pair):
    jm, pm = tiny_pair
    params = jax_params(jm)
    assert "cls.decoder_weight" not in params
    assert "cls.decoder_weight" in pm.state_dict()
    assert pm.cls.decoder_weight is pm.bert.embeddings.word_embeddings.weight
    np.testing.assert_array_equal(
        pm.cls.decoder_weight.detach().numpy(),
        params["bert.embeddings.word_embeddings.weight"])
    fresh = BertForPretraining(BertConfig(**TINY), device="cpu")
    with pytest.raises(InvalidArgumentError, match="cls.decoder_weight"):
        load_jax_state(fresh, {**params, "cls.decoder_weight":
                               params["bert.embeddings.word_embeddings."
                                      "weight"]})
    short = dict(params)
    short.pop("cls.decoder_bias")
    with pytest.raises(InvalidArgumentError, match="cls.decoder_bias"):
        load_jax_state(fresh, short)


@pytest.mark.parametrize("masked", [True, False])
def test_tiny_loss_and_every_gradient_match_jax(tiny_pair, masked):
    """With masked positions (the gather before the vocab projection)
    and NSP labels, and without (MLM over every position, no mask)."""
    jm, pm = tiny_pair
    ids, types, mask, labels, nsp, pos = bert_batch(22, TINY, 4, 32, 5)
    if masked:
        batch = (ids, types, mask, labels, nsp, pos)
    else:
        full = np.where(np.random.RandomState(23).rand(*ids.shape) < 0.3,
                        ids, -100)
        batch = (ids, None, None, full, None, None)
    _compare(jm, pm, batch, atol=2e-5, rtol=1e-4)


def test_base_widths_one_layer_loss_and_gradients_match_jax():
    """BERT-base widths (30522-row tied decoder, 12 heads of 64, FFN
    3072) at one layer, batch 1 x seq 128, 19 masked positions, a
    ragged attention mask."""
    jm, pm = bert_pair(24, BASE_1L)
    batch = bert_batch(25, BASE_1L, 1, 128, 19)
    _compare(jm, pm, batch, atol=1e-4, rtol=1e-4)
