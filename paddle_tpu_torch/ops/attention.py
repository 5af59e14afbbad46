"""Attention ops: the plain reference and the flash-attention dispatch
(counterpart of paddle_tpu/ops/attention.py).

``flash_attention_packed`` keeps the JAX dispatch's gates that express
semantics (a key-position mask, equal q/k/v shapes, a packed head layout)
and drops its "backend is TPU" gate: on a CUDA tensor the kernel runs.  A
mask that is not a key-position mask takes the plain
``scaled_dot_product_attention``, as the JAX package takes its jnp
reference there.  Inputs of ``scaled_dot_product_attention`` and
``flash_attention`` follow the (batch, heads, seq, head_dim) convention.
"""
from __future__ import annotations

import math

import torch

from ..core import flags
from ..core import random as _random
from .kernels import flash_attention_packed as fap

_BHSD_NOT_PORTED = (
    "the (batch, heads, seq, head_dim) flash-attention kernel "
    "(paddle_tpu/ops/pallas/flash_attention.py) is not ported yet "
    "(ROADMAP.md, Queue 2 row 3); set the flag use_flash_attention off to "
    "take the plain path")


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
    the semantics do not fit the packed kernel (the caller then takes the
    split-head path)."""
    b, s, packed = q.shape
    hd = packed // num_heads
    if not (flags.get_flag("use_flash_attention")
            and q.shape == k.shape == v.shape):
        return None
    bias = _as_padding_bias(attn_mask, b, s, q.device)
    if bias is None:
        return None
    if not fap.head_layout_ok(num_heads, hd):
        if q.device.type == "cuda":
            raise NotImplementedError(
                f"flash_attention_packed: head layout (num_heads="
                f"{num_heads}, head_dim={hd}) needs {_BHSD_NOT_PORTED}")
        return None
    rate = float(dropout_p) if training else 0.0
    seed = _random.draw_seed() if rate > 0.0 else None
    return fap.flash_attention_packed(q, k, v, num_heads, bias=bias,
                                      sm_scale=scale, causal=is_causal,
                                      dropout_rate=rate, seed=seed)


def flash_attention(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False,
                    scale=None, training=True):
    """(b, h, s, d) dispatch.  Where the JAX package would run its bhsd
    kernel, a CUDA tensor raises until that kernel is ported; every other
    case runs the plain reference, as in the JAX package."""
    b, h, s, d = q.shape
    if (flags.get_flag("use_flash_attention") and q.device.type == "cuda"
            and q.shape == k.shape == v.shape and d % 64 == 0
            and s % 128 == 0
            and _as_padding_bias(attn_mask, b, s, q.device) is not None):
        raise NotImplementedError(f"flash_attention: {_BHSD_NOT_PORTED}")
    return scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                        dropout_p=dropout_p,
                                        is_causal=is_causal, scale=scale,
                                        training=training)
