"""ERNIE/BERT-class pretraining model: embeddings, a post-LN transformer
encoder, pooler, the MLM + NSP heads and the pretraining criterion
(counterpart of paddle_tpu/text/ernie.py).

Parameter names match the JAX package's ``parameters_dict`` names, so
``paddle_tpu_torch.convert.from_jax_params`` is a renaming-free copy, and
``Layer.set_state_dict`` takes the JAX model's ``state_dict()`` (as numpy
arrays).  The MLM decoder is tied to ``word_embeddings.weight``.
``ErnieForSequenceClassification`` puts a dropout and a Linear classifier
on the pooled output (the fine-tuning head); ``Bert*`` are aliases.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from .. import nn as pnn
from ..nn.layer.base import Layer, Parameter


class ErnieConfig:
    """ERNIE-1.0-base defaults."""

    def __init__(self, vocab_size=18000, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, max_position_embeddings=513,
                 type_vocab_size=2, initializer_range=0.02, pad_token_id=0,
                 enable_recompute=False, recompute_policy=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.pad_token_id = pad_token_id
        # per-layer recompute of the encoder in training, under an
        # autograd.checkpoint_policy name (e.g. "dots_saveable" keeps the
        # matrix products and recomputes the rest)
        self.enable_recompute = enable_recompute
        self.recompute_policy = recompute_policy


class ErnieEmbeddings(Layer):
    def __init__(self, config: ErnieConfig, generator=None):
        super().__init__()
        std = config.initializer_range
        self.word_embeddings = pnn.Embedding(
            config.vocab_size, config.hidden_size, std=std, generator=generator)
        self.position_embeddings = pnn.Embedding(
            config.max_position_embeddings, config.hidden_size, std=std,
            generator=generator)
        self.token_type_embeddings = pnn.Embedding(
            config.type_vocab_size, config.hidden_size, std=std,
            generator=generator)
        self.layer_norm = pnn.LayerNorm(config.hidden_size)
        self.dropout = pnn.Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, dtype=torch.int64, device=input_ids.device).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErniePooler(Layer):
    def __init__(self, hidden_size, generator=None):
        super().__init__()
        self.dense = pnn.Linear(hidden_size, hidden_size, generator=generator)

    def forward(self, hidden_states):
        return torch.tanh(self.dense(hidden_states[:, 0]))


def padding_mask(input_ids, pad_token_id):
    """Additive fp32 (b, 1, 1, s) mask: -1e4 at padded keys, else 0."""
    pad = (input_ids == pad_token_id)[:, None, None, :]
    return torch.where(pad, -1e4, 0.0).to(torch.float32)


class ErnieModel(Layer):
    """Embeddings + N-layer transformer encoder + pooler.  Built on
    ``device`` (default: the current device, CUDA unless ``set_device``
    says otherwise; it must exist)."""

    def __init__(self, config: Optional[ErnieConfig] = None, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        dev = resolve_device(device)
        config = config or ErnieConfig(**kwargs)
        self.config = config
        self.embeddings = ErnieEmbeddings(config, generator)
        enc_layer = pnn.TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob, act_dropout=0.0,
            generator=generator)
        self.encoder = pnn.TransformerEncoder(
            enc_layer, config.num_hidden_layers,
            enable_recompute=config.enable_recompute,
            recompute_policy=config.recompute_policy, generator=generator)
        self.pooler = ErniePooler(config.hidden_size, generator)
        self.to(dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is None:
            attention_mask = padding_mask(input_ids, self.config.pad_token_id)
        elif attention_mask.dim() == 2:
            attention_mask = torch.where(
                attention_mask[:, None, None, :] == 0, -1e4, 0.0).to(
                    torch.float32)
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(emb, src_mask=attention_mask)
        return seq_out, self.pooler(seq_out)


class ErnieLMHead(Layer):
    """MLM head whose decoder is the tied word-embedding matrix."""

    def __init__(self, config: ErnieConfig, embedding_weights: Parameter,
                 generator=None):
        super().__init__()
        self.transform = pnn.Linear(config.hidden_size, config.hidden_size,
                                    generator=generator)
        self.activation = getattr(pnn.functional, config.hidden_act)
        self.layer_norm = pnn.LayerNorm(config.hidden_size)
        # tied: the same Parameter object, listed once by named_parameters()
        self.decoder_weight = embedding_weights
        self.decoder_bias = Parameter(torch.zeros(
            config.vocab_size, dtype=embedding_weights.dtype,
            device=embedding_weights.device))

    def forward(self, hidden_states, masked_positions=None):
        if masked_positions is not None:
            idx = masked_positions.long()[..., None].expand(
                -1, -1, hidden_states.shape[-1])
            hidden_states = torch.gather(hidden_states, 1, idx)
        x = self.layer_norm(self.activation(self.transform(hidden_states)))
        return torch.matmul(x, self.decoder_weight.t()) + self.decoder_bias


class ErniePretrainingHeads(Layer):
    def __init__(self, config: ErnieConfig, embedding_weights, generator=None):
        super().__init__()
        self.predictions = ErnieLMHead(config, embedding_weights, generator)
        self.seq_relationship = pnn.Linear(config.hidden_size, 2,
                                           generator=generator)

    def forward(self, sequence_output, pooled_output, masked_positions=None):
        return (self.predictions(sequence_output, masked_positions),
                self.seq_relationship(pooled_output))


class ErnieForPretraining(Layer):
    """MLM + NSP model: returns ``(mlm_logits, nsp_logits)``.  Built on
    ``device`` (default: the current device, CUDA unless ``set_device``
    says otherwise; it must exist)."""

    def __init__(self, config: Optional[ErnieConfig] = None, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        dev = resolve_device(device)
        self.ernie = ErnieModel(config, device="cpu", generator=generator,
                                **kwargs)
        self.cls = ErniePretrainingHeads(
            self.ernie.config,
            self.ernie.embeddings.word_embeddings.weight, generator)
        self.to(dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_positions=None):
        seq_out, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                     attention_mask)
        return self.cls(seq_out, pooled, masked_positions)


class ErniePretrainingCriterion(Layer):
    """Masked-LM cross-entropy (labels of -1 ignored) plus NSP
    cross-entropy, each a mean, as the JAX package's criterion."""

    def __init__(self, vocab_size):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels,
                masked_lm_weights=None):
        F = pnn.functional
        mlm = F.cross_entropy(
            prediction_scores.reshape(-1, self.vocab_size),
            masked_lm_labels.reshape(-1), ignore_index=-1, reduction="mean")
        nsp = F.cross_entropy(seq_relationship_score,
                              next_sentence_labels.reshape(-1),
                              reduction="mean")
        return mlm + nsp


class ErnieForSequenceClassification(Layer):
    """Sentence classification: ``classifier(dropout(pooled))``, logits of
    ``num_classes``; the dropout is ``hidden_dropout_prob`` unless
    ``dropout`` is given.  Built on ``device`` (default: the current
    device) from ``generator``, both keyword-only."""

    def __init__(self, config: Optional[ErnieConfig] = None, num_classes=2,
                 dropout=None, *, device=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        dev = resolve_device(device)
        self.ernie = ErnieModel(config, device="cpu", generator=generator,
                                **kwargs)
        cfg = self.ernie.config
        self.dropout = pnn.Dropout(dropout if dropout is not None
                                   else cfg.hidden_dropout_prob)
        self.classifier = pnn.Linear(cfg.hidden_size, num_classes,
                                     generator=generator)
        self.to(dev)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.classifier(self.dropout(pooled))


# BERT aliases (same architecture family)
BertConfig = ErnieConfig
BertModel = ErnieModel
BertForPretraining = ErnieForPretraining
