"""Transformer encoder layers (counterpart of
paddle_tpu/nn/layer/transformer.py).

Attention feeds the projection outputs in (batch, seq, heads*head_dim)
layout straight to the packed flash-attention kernel; the split-head
``_attend`` path is the plain route.  The post-LN sublayer tail
``LN(residual + dropout(out))`` goes to the fused residual + LayerNorm
kernel.  The decoder, the incremental-decode cache and recompute wait for
later slices.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ...core import flags
from ...ops import attention as attn_ops
from ...ops.kernels import layer_norm as _fln
from .. import functional as F
from .common import Dropout, Linear
from .norm import LayerNorm


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around scaled-dot-product attention (self or
    cross attention, no cache)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.k_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.v_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = key if value is None else value
        qp = self.q_proj(query)
        kp = self.k_proj(key)
        vp = self.v_proj(value)
        out = attn_ops.flash_attention_packed(
            qp, kp, vp, self.num_heads, attn_mask=attn_mask,
            dropout_p=self.dropout, training=self.training)
        if out is not None:
            return self.out_proj(out)
        return self._attend(self._split_heads(qp), self._split_heads(kp),
                            self._split_heads(vp), attn_mask)

    def _attend(self, q, k, v, attn_mask):
        out = attn_ops.flash_attention(q, k, v, attn_mask=attn_mask,
                                       dropout_p=self.dropout,
                                       training=self.training)
        b, h, s, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))


def _sublayer_epilogue(layer, out, residual, norm, dropout_layer):
    """src = norm(residual + dropout(out)), the post-LN sublayer tail.  With
    ``use_fused_layer_norm`` on, post-LN goes to kernel C (its plain version
    on CPU tensors); otherwise the composition runs."""
    rate = float(dropout_layer.p) if layer.training else 0.0
    if (not layer.normalize_before
            and flags.get_flag("use_fused_layer_norm")
            and len(norm.normalized_shape) == 1):
        return _fln.fused_residual_dropout_layer_norm(
            out, residual, norm.weight, norm.bias, dropout_rate=rate,
            epsilon=norm.epsilon)
    src = residual + dropout_layer(out)
    if not layer.normalize_before:
        src = norm(src)
    return src


class TransformerEncoderLayer(nn.Module):
    """Self attention + FFN; ``normalize_before`` toggles pre-/post-LN."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            generator=generator)
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        out = self.self_attn(src, src, src, attn_mask=src_mask)
        src = _sublayer_epilogue(self, out, residual, self.norm1,
                                 self.dropout1)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        return _sublayer_epilogue(self, src, residual, self.norm2,
                                  self.dropout2)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer``; the copies' Linear
    weights are drawn anew, as the JAX package re-initialises its deep
    copies."""

    def __init__(self, encoder_layer, num_layers, norm=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [encoder_layer]
        for _ in range(num_layers - 1):
            layer = copy.deepcopy(encoder_layer)
            for m in layer.modules():
                if isinstance(m, Linear):
                    m.reset_parameters(generator)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        output = src
        for layer in self.layers:
            output = layer(output, src_mask=src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output
