"""Attention ops: the plain reference and the flash-attention dispatch
(counterpart of paddle_tpu/ops/attention.py).

Both dispatchers keep the JAX dispatch's gates that express semantics (the
flag, a key-position mask, equal q/k/v shapes, and a head layout or shape
the kernel takes) and drop its "backend is TPU" gate: on a CUDA tensor the
kernel runs, and a shape it cannot take raises there.  A mask that is not a
key-position mask takes the plain ``scaled_dot_product_attention``, as the
JAX package takes its jnp reference there; a packed head layout that the
packed kernel refuses returns None, and the caller takes the split-head
route.  Inputs of ``scaled_dot_product_attention`` and ``flash_attention``
follow the (batch, heads, seq, head_dim) convention.
"""
from __future__ import annotations

import math

import torch

from ..core import flags
from ..core import random as _random
from .kernels import flash_attention as fa
from .kernels import flash_attention_packed as fap


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None, training=True):
    """Reference attention: (b, h, s, d) -> (b, h, s, d).

    ``attn_mask`` is additive (float, broadcastable to (b, h, sq, sk)) or
    boolean (True = keep).  Scores and softmax are fp32; the probabilities
    are cast to q's dtype before the product with v.  Training-mode dropout
    drops probabilities with the plain dropout op (a mask from the active
    generator), as the JAX package draws one from its key stream.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if is_causal:
        sq, sk = s.shape[-2], s.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~causal, -1e30)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            s = s.masked_fill(~attn_mask, -1e30)
        else:
            s = s + attn_mask.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        # imported here: nn imports this module while it initialises
        from ..nn.functional.common import dropout
        p = dropout(p, dropout_p)
    return torch.matmul(p, v)


def _as_padding_bias(attn_mask, b, s, device=None):
    """If ``attn_mask`` is a key-position-only mask -- shape broadcastable
    to (b, 1, 1, s) -- return the equivalent additive fp32 (b, s) bias; else
    None.  This is the BERT/ERNIE padding-mask shape the kernel streams
    instead of an O(s^2) score mask."""
    if attn_mask is None:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    if attn_mask.dim() != 4 or attn_mask.shape[1] != 1 or attn_mask.shape[2] != 1:
        return None
    if attn_mask.shape[0] not in (1, b) or attn_mask.shape[3] != s:
        return None
    m = attn_mask[:, 0, 0, :]
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, -1e30)
    return m.to(torch.float32).expand(b, s).contiguous()


def flash_attention_packed(q, k, v, num_heads, attn_mask=None,
                           dropout_p=0.0, is_causal=False, scale=None,
                           training=True):
    """Packed-layout dispatch: q/k/v are (batch, seq, heads*head_dim), the
    projection output.  Returns (batch, seq, heads*head_dim), or None when
    the semantics or the head layout do not fit the packed kernel (the
    caller then takes the split-head path)."""
    b, s, packed = q.shape
    if not (flags.get_flag("use_flash_attention")
            and q.shape == k.shape == v.shape
            and fap.head_layout_ok(num_heads, packed // num_heads)):
        return None
    bias = _as_padding_bias(attn_mask, b, s, q.device)
    if bias is None:
        return None
    rate = float(dropout_p) if training else 0.0
    seed = _random.draw_seed() if rate > 0.0 else None
    return fap.flash_attention_packed(q, k, v, num_heads, bias=bias,
                                      sm_scale=scale, causal=is_causal,
                                      dropout_rate=rate, seed=seed)


def flash_attention(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
                    scale=None, training=True):
    """(b, h, s, d) dispatch: the flash-attention kernel where the JAX
    package runs its Pallas kernel (flag on, equal q/k/v shapes,
    ``supported(s, d)``, a key-position mask), with one dropout seed drawn
    when training drops; every other case runs the plain reference, as in
    the JAX package."""
    b, h, s, d = q.shape
    if (flags.get_flag("use_flash_attention")
            and q.shape == k.shape == v.shape and fa.supported(s, d)):
        bias = _as_padding_bias(attn_mask, b, s, q.device)
        if bias is not None:
            rate = float(dropout_p) if training else 0.0
            seed = _random.draw_seed() if rate > 0.0 else None
            return fa.flash_attention(q, k, v, bias=bias, sm_scale=scale,
                                      causal=is_causal, dropout_rate=rate,
                                      seed=seed)
    return scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                        dropout_p=dropout_p,
                                        is_causal=is_causal, scale=scale,
                                        training=training)
