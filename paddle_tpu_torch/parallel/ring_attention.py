"""Sequence parallelism: ring attention and Ulysses all-to-all
(counterpart of paddle_tpu/parallel/ring_attention.py).

The sequence dim is split over the ``sp`` mesh dim, each rank holding
``s / sp`` positions, and attention reaches across the splits either by

* **ring attention**: the K/V blocks go round the sp ring
  (``collective.ppermute``, n - 1 steps) while each rank keeps its
  queries, merging each block into fp32 running max / normaliser /
  output (the streaming-softmax recurrence), causal by global position;
  or
* **Ulysses**: an all-to-all swaps the sequence split for a head split,
  attention runs on whole sequences for ``heads / sp`` heads, and a second
  all-to-all swaps back (``heads % sp == 0``).

Both are per-rank functions over this rank's shard; the backward is
autograd's through the differentiable collectives (ppermute's transpose
permutes back, the all-to-all's is the inverse all-to-all).  Neither
function reaches a Pallas kernel in the JAX package: the blockwise math
here is plain torch.  ``MultiHeadAttention`` with ``seq_axis`` set uses
``ulysses_to_heads`` / ``ulysses_to_seq`` on its packed (b, s, h*d)
projections and runs the port's attention kernel between them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import collective as _coll
from . import mesh as _mesh

__all__ = ["ring_attention", "ulysses_attention", "ulysses_to_heads",
           "ulysses_to_seq"]


def ring_attention(q, k, v, *, axis: str = _mesh.SP_AXIS,
                   causal: bool = False, scale: Optional[float] = None):
    """Blockwise attention over a sequence split on ``axis``.

    q, k, v: [batch, heads, s_local, head_dim], this rank's positions
    ``[r * s_local, (r + 1) * s_local)``.  Returns [batch, heads, s_local,
    head_dim] in q's dtype; the softmax statistics are fp32.  The running
    max only shifts the exponent (the result does not depend on it), so
    it is taken without gradient."""
    n = _mesh.mesh_axis_size(axis)
    me = _coll.axis_index(axis)
    s_local, d = q.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf = q.float() * scale
    q_pos = me * s_local + torch.arange(s_local, device=q.device)
    o = torch.zeros(q.shape[:-1] + (d,), dtype=torch.float32,
                    device=q.device)
    m = torch.full(q.shape[:-1], -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    ring = [(j, (j + 1) % n) for j in range(n)]
    kk, vv = k, v
    for i in range(n):
        owner = (me - i) % n
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kk.float())
        if causal:
            k_pos = owner * s_local + torch.arange(s_local, device=q.device)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        # a row with every key masked so far: exp against 0, factor 0
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                vv.float())
        m = m_new
        if i < n - 1:
            kk = _coll.ppermute(kk, ring, group=axis)
            vv = _coll.ppermute(vv, ring, group=axis)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _exact_attention(q, k, v, causal, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq = s.shape[-2]
        keep = torch.ones((sq, sq), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ulysses_attention(q, k, v, *, axis: str = _mesh.SP_AXIS,
                      causal: bool = False, scale: Optional[float] = None,
                      attn_fn=None):
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses pattern).

    q, k, v: [batch, heads, s_local, head_dim] with heads % sp == 0.
    Swaps the sequence split for a head split, runs ``attn_fn(q, k, v)``
    (default: exact softmax attention in fp32) on whole sequences with
    heads / sp heads, and swaps back."""
    n = _mesh.mesh_axis_size(axis)
    if q.shape[1] % n:
        raise ValueError(f"heads {q.shape[1]} not divisible by sp degree {n}")

    def fwd(x):  # [b, h, s/n, d] -> [b, h/n, s, d]
        return _coll.all_to_all(x, group=axis, split_axis=1, concat_axis=2)

    qh, kh, vh = fwd(q), fwd(k), fwd(v)
    if attn_fn is None:
        sc = scale if scale is not None else 1.0 / math.sqrt(qh.shape[-1])
        out = _exact_attention(qh, kh, vh, causal, sc)
    else:
        out = attn_fn(qh, kh, vh)
    return _coll.all_to_all(out, group=axis, split_axis=2, concat_axis=1)


def ulysses_to_heads(x, axis: str = _mesh.SP_AXIS):
    """[b, s/sp, heads*d] (this rank's positions, every head) ->
    [b, s, (heads/sp)*d] (every position, this rank's heads)."""
    return _coll.all_to_all(x, group=axis, split_axis=2, concat_axis=1)


def ulysses_to_seq(x, axis: str = _mesh.SP_AXIS):
    """The inverse of ``ulysses_to_heads``."""
    return _coll.all_to_all(x, group=axis, split_axis=1, concat_axis=2)
