"""Chunk evaluation: precision, recall and F1 over the label chunks of a
tagging (counterpart of paddle_tpu/ops/chunk.py; ref chunk_eval_op.h).

The module is ``chunking``, not ``chunk``: importing a submodule named
``chunk`` would bind it over manipulation's ``chunk`` op in the
``ops`` namespace, as ``paddle_tpu.ops.chunk`` does in the JAX package.

The reference's begin / end predicates depend only on (previous, current)
tag pairs, so the parse is elementwise over the batch: each chunk's end
comes from a reverse running minimum, and a chunk is correct when both
taggings begin it at one position with one type and end it at one index.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ._util import as_tensor

__all__ = ["chunk_eval"]

_SCHEMES = {
    # scheme: (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_bounds(labels, lengths, num_chunk_types, scheme):
    """(begins, type, end index) at each position of a (B, T) tagging."""
    ntag, t_begin, t_inside, t_end, t_single = _SCHEMES[scheme]
    other = num_chunk_types          # ref: other_chunk_type = num_chunk_types
    B, T = labels.shape
    tag = labels % ntag
    typ = labels // ntag
    pos = torch.arange(T, device=labels.device)
    valid = pos[None, :] < lengths[:, None]
    typ = torch.where(valid, typ, torch.full_like(typ, other))

    def shift(t, fill, right):
        pad = torch.full((B, 1), fill, dtype=t.dtype, device=t.device)
        return torch.cat([pad, t[:, :-1]], 1) if right else \
            torch.cat([t[:, 1:], pad], 1)

    prev_tag, prev_typ = shift(tag, -1, True), shift(typ, other, True)
    # ChunkBegin(prev, cur), chunk_eval_op.h:103
    same_type_begin = ((tag == t_begin)
                       | ((tag == t_inside) & ((prev_tag == t_end)
                                               | (prev_tag == t_single)))
                       | ((tag == t_end) & ((prev_tag == t_end)
                                            | (prev_tag == t_single)))
                       | (tag == t_single))
    beg = torch.where(prev_typ == other, typ != other,
                      (typ != other) & ((typ != prev_typ) | same_type_begin))
    begins = beg & valid

    # ChunkEnd(cur, next): a chunk ends at i when the (i, i + 1) step
    # closes it, or the sequence ends
    nxt_tag, nxt_typ = shift(tag, -1, False), shift(typ, other, False)
    nxt_begins = (nxt_tag == t_begin) | (nxt_tag == t_single)
    same_type_end = torch.where(
        (tag == t_begin) | (tag == t_inside), nxt_begins,
        (tag == t_end) | (tag == t_single))
    end_trans = (typ != other) & ((nxt_typ == other) | (nxt_typ != typ)
                                  | same_type_end)
    last_valid = pos[None, :] == (lengths[:, None] - 1)
    ends = (typ != other) & valid & (end_trans | last_valid)

    # the end of the chunk covering position i: the first j >= i that ends
    idx = torch.where(ends, pos[None, :].expand(B, T),
                      torch.full((B, T), T + 1, device=labels.device,
                                 dtype=torch.int64))
    end_idx = torch.flip(torch.cummin(torch.flip(idx, [1]), 1).values, [1])
    return begins, typ, end_idx


def chunk_eval(inference, label, lengths=None, chunk_scheme: str = "IOB",
               num_chunk_types: int = 1,
               excluded_chunk_types: Optional[Sequence[int]] = None
               ) -> Tuple:
    """Compare the chunks of the ``inference`` and ``label`` taggings.

    inference, label: (B, T) tag ids, ``type * num_tag_types + tag``, Other
    = ``num_chunk_types * num_tag_types``; lengths (B,) valid steps
    (default T).  Returns (precision, recall, f1, num_infer, num_label,
    num_correct) as 0-d tensors (the reference op's six outputs; the
    counts int64, int32 in the JAX package)."""
    if chunk_scheme not in _SCHEMES:
        raise ValueError(f"unknown chunk_scheme {chunk_scheme!r}; one of "
                         f"{sorted(_SCHEMES)}")
    inference = as_tensor(inference).long()
    label = as_tensor(label, like=inference).long()
    B, T = inference.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int64,
                             device=inference.device)
    else:
        lengths = as_tensor(lengths, like=inference).long()
    bi, ti, ei = _chunk_bounds(inference, lengths, num_chunk_types,
                               chunk_scheme)
    bl, tl, el = _chunk_bounds(label, lengths, num_chunk_types, chunk_scheme)
    if excluded_chunk_types:
        excl = torch.as_tensor(list(excluded_chunk_types),
                               device=inference.device)
        keep_i, keep_l = ~torch.isin(ti, excl), ~torch.isin(tl, excl)
    else:
        keep_i = keep_l = torch.ones_like(bi)
    num_infer = (bi & keep_i).sum()
    num_label = (bl & keep_l).sum()
    num_correct = (bi & bl & (ti == tl) & (ei == el) & keep_i).sum()
    nc = num_correct.float()
    zero = torch.zeros((), device=inference.device)
    precision = torch.where(num_infer > 0, nc / num_infer, zero)
    recall = torch.where(num_label > 0, nc / num_label, zero)
    f1 = torch.where(num_correct > 0,
                     2 * precision * recall / (precision + recall), zero)
    return precision, recall, f1, num_infer, num_label, num_correct
