"""BERT for pretraining (masked LM + next-sentence prediction).

Counterpart of ``paddle_tpu/text/models/bert.py`` (``BertConfig``,
``BertEmbeddings``, ``BertPooler``, ``BertModel``,
``BertPretrainingHeads``, ``BertForPretraining``), built from the port's
``TransformerEncoder``.  Parameter names match the JAX package's dotted
paths, so ``framework.bridge.load_jax_state`` maps name to name.  The MLM
decoder weight is the word embedding itself (tied): the JAX package lists
it once, as ``bert.embeddings.word_embeddings.weight``, and so does
``named_parameters()`` here.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...framework.place import DeviceLike, resolve_device
from ...nn.functional.loss import cross_entropy
from ...nn.layer.common import Dropout
from ...nn.layer.transformer import (TransformerEncoder,
                                     TransformerEncoderLayer)


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    pad_token_id: int = 0

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls, vocab_size=128, hidden_size=32, layers=2, heads=2, seq=64):
        return cls(vocab_size=vocab_size, hidden_size=hidden_size,
                   num_hidden_layers=layers, num_attention_heads=heads,
                   intermediate_size=hidden_size * 4,
                   max_position_embeddings=seq)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **fk)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **fk)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **fk)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-12, **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                               device=device, dtype=dtype)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig = None, with_pool=True, *,
                 device: DeviceLike = None, dtype: torch.dtype = None,
                 **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        fk = dict(device=resolve_device(device), dtype=dtype)
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, **fk)
        layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob, act_dropout=0.0,
            **fk)
        self.encoder = TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = BertPooler(cfg, **fk) if with_pool else None

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None:
            # [B, S] 1/0 mask -> additive f32 [B, 1, 1, S]: the bias of
            # the flash-attention kernels
            attention_mask = (1.0 - attention_mask[:, None, None, :]
                              .float()) * -1e4
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(emb, attention_mask)
        if self.pooler is not None:
            return seq, self.pooler(seq)
        return seq


class BertPretrainingHeads(nn.Module):
    def __init__(self, cfg: BertConfig, embedding_weights, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size, **fk)
        self.activation = getattr(F, cfg.hidden_act)   # gelu: exact (erf)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-12, **fk)
        self.decoder_weight = embedding_weights          # tied
        self.decoder_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **fk))
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2, **fk)

    def forward(self, sequence_output, pooled_output, masked_positions=None):
        if masked_positions is not None:
            # only the masked rows reach the vocab projection; a plain
            # index gather (the JAX package's one-hot matmul was for the
            # TPU's matrix unit)
            idx = masked_positions.long()[..., None].expand(
                -1, -1, sequence_output.shape[-1])
            sequence_output = sequence_output.gather(1, idx)
        h = self.layer_norm(self.activation(self.transform(sequence_output)))
        logits = F.linear(h, self.decoder_weight, self.decoder_bias)
        return logits, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Module):
    """MLM + NSP pretraining wrapper; ``forward`` returns the loss when
    ``masked_lm_labels`` are given, else (MLM logits, NSP logits).
    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` to run on the host."""

    def __init__(self, cfg: BertConfig = None, *, device: DeviceLike = None,
                 dtype: torch.dtype = None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        dev = resolve_device(device)
        self.config = cfg
        self.bert = BertModel(cfg, device=dev, dtype=dtype)
        self.cls = BertPretrainingHeads(
            cfg, self.bert.embeddings.word_embeddings.weight, device=dev,
            dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = None):
        """Random weights drawn from ``generator`` (on the model's
        device): N(0, initializer_range) for embeddings and Linear
        weights, zero biases, unit LayerNorm scales."""
        std = self.config.initializer_range if std is None else std
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls.decoder_bias.zero_()
        return self

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None,
                masked_positions=None):
        seq, pooled = self.bert(input_ids, token_type_ids,
                                attention_mask=attention_mask)
        logits, nsp = self.cls(seq, pooled, masked_positions)
        if masked_lm_labels is None:
            return logits, nsp
        loss = cross_entropy(logits.reshape(-1, self.config.vocab_size),
                             masked_lm_labels.reshape(-1), ignore_index=-100)
        if next_sentence_label is not None:
            loss = loss + cross_entropy(nsp, next_sentence_label.reshape(-1))
        return loss
