"""Sequence ops: the LoD (ragged) op family on dense tensors (counterpart
of paddle_tpu/ops/sequence.py; ref operators/sequence_ops/).

As in the JAX package, a ragged batch is one of two dense forms:

* padded: ``(x [B, T, ...], lengths [B])``, the form every op here takes;
  masks derive from the lengths;
* segment ids: ``(values [N, ...], segment_ids [N])``, for flattened token
  streams; the ``segment_*`` reductions cover the LoD-level pools.

``sequence_pad`` / ``sequence_unpad`` convert between the two.  Plain
torch: no Pallas kernel lies behind these ops in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import dtype as _dtype
from ._util import as_tensor, index as _index

__all__ = [
    "sequence_mask", "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_pad", "sequence_unpad", "sequence_expand",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
]


def _trail(t, ndim):
    """``t`` ([B] or [B, T]) with singleton dims up to rank ``ndim``."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.dim()))


def sequence_mask(lengths, maxlen: Optional[int] = None, dtype="bool"):
    """[B] lengths -> [B, maxlen] mask (ref sequence_mask_op.cc).  ``maxlen``
    is required, as in the JAX package (a runtime max would make the
    output's shape depend on the data)."""
    lengths = as_tensor(lengths)
    if maxlen is None:
        raise ValueError(
            "maxlen must be given (the reference's runtime max(lengths) "
            "would make the output shape depend on the data)")
    m = torch.arange(int(maxlen), device=lengths.device)[None, :] \
        < lengths[:, None]
    return m if dtype == "bool" else m.to(_dtype.exact_dtype(dtype))


def _mask_for(x, lengths):
    return _trail(sequence_mask(lengths, x.shape[1]), x.dim())


def sequence_pool(x, lengths, pool_type: str = "sum", pad_value: float = 0.0):
    """Pool over the time axis within each length (ref sequence_pool_op.h).
    ``pool_type``: sum, mean, sqrt, max, first or last; an empty sequence
    gives ``pad_value``."""
    x = as_tensor(x)
    lengths = as_tensor(lengths, like=x)
    m = _mask_for(x, lengths)
    n = _trail(lengths, x.dim() - 1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if pool_type == "sum":
        out = torch.where(m, x, zero).sum(dim=1)
    elif pool_type == "mean":
        out = torch.where(m, x, zero).sum(dim=1) / torch.clamp(n, min=1)
    elif pool_type == "sqrt":
        out = torch.where(m, x, zero).sum(dim=1) / torch.sqrt(
            torch.clamp(n, min=1).to(x.dtype))
    elif pool_type == "max":
        out = torch.where(m, x, torch.full((), float("-inf"), dtype=x.dtype,
                                           device=x.device)).amax(dim=1)
    elif pool_type == "first":
        out = x[:, 0]
    elif pool_type == "last":
        idx = torch.clamp(lengths - 1, min=0).long()
        out = torch.take_along_dim(
            x, _trail(idx, x.dim()), dim=1)[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    empty = _trail(lengths == 0, out.dim())
    return torch.where(empty, torch.full((), pad_value, dtype=out.dtype,
                                         device=x.device), out)


def sequence_first_step(x, lengths):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths):
    return sequence_pool(x, lengths, "last")


def sequence_softmax(x, lengths):
    """Softmax over time within each length (ref sequence_softmax_op.h);
    padded steps give 0, an all-padding row all zeros."""
    x = as_tensor(x)
    m = _mask_for(x, as_tensor(lengths, like=x)).expand(x.shape)
    z = torch.where(m, x, torch.full((), float("-inf"), dtype=x.dtype,
                                     device=x.device))
    zmax = z.amax(dim=1, keepdim=True)
    zmax = torch.where(torch.isfinite(zmax), zmax, torch.zeros_like(zmax))
    e = torch.where(m, torch.exp(x - zmax), torch.zeros_like(x))
    return e / torch.clamp(e.sum(dim=1, keepdim=True), min=1e-30)


def sequence_reverse(x, lengths):
    """Reverse each sequence's valid prefix; padding stays in place (ref
    sequence_reverse_op.h)."""
    x = as_tensor(x)
    lengths = as_tensor(lengths, like=x).long()
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    L = lengths[:, None]
    src = torch.where(pos < L, L - 1 - pos, pos)
    return torch.take_along_dim(x, _trail(src, x.dim()), dim=1)


def sequence_pad(values, segment_ids, batch: int, maxlen: int,
                 pad_value: float = 0.0):
    """Segment-id stream [N, ...] -> (padded [batch, maxlen, ...], lengths
    [batch]) (ref sequence_pad_op.cc).  ``segment_ids`` ascend (LoD order);
    elements past ``maxlen`` are dropped and the lengths clamped."""
    values = as_tensor(values)
    seg = _index(as_tensor(segment_ids, like=values))
    first = torch.searchsorted(seg, torch.arange(batch, device=seg.device))
    pos = torch.arange(seg.shape[0], device=seg.device) - first[seg]
    out = torch.full((batch, maxlen) + tuple(values.shape[1:]), pad_value,
                     dtype=values.dtype, device=values.device)
    keep = pos < maxlen
    out[seg[keep], pos[keep]] = values[keep]
    counts = torch.zeros(batch, dtype=torch.int64, device=seg.device)
    counts.index_add_(0, seg, torch.ones_like(seg))
    return out, torch.clamp(counts, max=maxlen)


def sequence_unpad(x, lengths):
    """(padded [B, T, ...], lengths) -> (values [B*T, ...], segment_ids
    [B*T], valid mask [B*T]) (ref sequence_unpad_op.cc).  The stream keeps
    the padding rows, marked invalid in the mask, as in the JAX package."""
    x = as_tensor(x)
    B, T = x.shape[0], x.shape[1]
    seg = torch.arange(B, device=x.device).repeat_interleave(T)
    mask = sequence_mask(as_tensor(lengths, like=x), T).reshape(-1)
    return x.reshape((B * T,) + tuple(x.shape[2:])), seg, mask


def sequence_expand(x, lengths, ref_lengths, maxlen: int):
    """Tile sequence i of ``x`` ``ref_lengths[i]`` times along time, cut or
    padded to ``maxlen`` (ref sequence_expand_op.cc, y's LoD at level 0);
    returns (out, new lengths)."""
    x = as_tensor(x)
    reps = as_tensor(ref_lengths, like=x).long()
    src_len = as_tensor(lengths, like=x).long()
    pos = torch.arange(maxlen, device=x.device)[None, :]
    total = src_len[:, None] * reps[:, None]
    src = torch.where(pos < total,
                      pos % torch.clamp(src_len[:, None], min=1),
                      torch.zeros_like(pos))
    out = torch.take_along_dim(x, _trail(src, x.dim()), dim=1)
    valid = _trail(pos < total, x.dim())
    out = torch.where(valid, out, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    return out, torch.clamp(total[:, 0], max=maxlen)


def sequence_slice(x, lengths, offset, length):
    """Steps [offset, offset + length) of each sequence, moved to t = 0
    (ref sequence_slice_op.h); returns (y, new lengths)."""
    x = as_tensor(x)
    T = x.shape[1]
    offset = as_tensor(offset, like=x).reshape(-1).long()
    length = as_tensor(length, like=x).reshape(-1).long()
    pos = torch.arange(T, device=x.device)[None, :]
    src = torch.clamp(pos + offset[:, None], 0, T - 1)
    y = torch.take_along_dim(x, _trail(src, x.dim()), dim=1)
    valid = _trail(pos < length[:, None], x.dim())
    y = torch.where(valid, y, torch.zeros((), dtype=x.dtype, device=x.device))
    lengths = as_tensor(lengths, like=x).long()
    return y, torch.minimum(length, torch.clamp(lengths - offset, min=0))


# ----------------------------------------------------- segment reductions --
def _segment(values, segment_ids, num_segments, reduce):
    values = as_tensor(values)
    seg = _index(as_tensor(segment_ids, like=values))
    shape = (int(num_segments),) + tuple(values.shape[1:])
    if reduce == "sum":
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.index_add_(0, seg, values)
    # an empty segment holds the reduction's identity, as jax.ops.segment_*
    if values.is_floating_point():
        fill = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(values.dtype)
        fill = info.min if reduce == "amax" else info.max
    out = torch.full(shape, fill, dtype=values.dtype, device=values.device)
    idx = _trail(seg, values.dim()).expand(values.shape)
    return out.scatter_reduce_(0, idx, values, reduce, include_self=True)


def segment_sum(values, segment_ids, num_segments: int):
    return _segment(values, segment_ids, num_segments, "sum")


def segment_mean(values, segment_ids, num_segments: int):
    s = segment_sum(values, segment_ids, num_segments)
    seg = as_tensor(segment_ids, like=s)
    n = segment_sum(torch.ones(seg.shape, dtype=torch.float32,
                               device=s.device), seg, num_segments)
    return s / _trail(torch.clamp(n, min=1.0), s.dim())


def segment_max(values, segment_ids, num_segments: int):
    return _segment(values, segment_ids, num_segments, "amax")


def segment_min(values, segment_ids, num_segments: int):
    return _segment(values, segment_ids, num_segments, "amin")
