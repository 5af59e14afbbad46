"""Sequence distance and CTC decoding (counterpart of paddle_tpu/ops/ctc.py;
ref edit_distance_op.cc and ctc_align_op.cu).

``edit_distance`` is the Levenshtein recurrence with the whole batch's DP
row as the carry of a loop over hypothesis positions; greedy CTC decoding
collapses repeats, drops blanks and left-packs what stays with a running
count, in the dense padded layout the LoD ops use.
"""
from __future__ import annotations

import torch

from ._util import as_tensor

__all__ = ["edit_distance", "ctc_greedy_decoder"]


def edit_distance(hyps, refs, hyp_lengths=None, ref_lengths=None,
                  normalized: bool = True):
    """Batched Levenshtein distance: hyps (B, Lh) and refs (B, Lr) int
    tokens, padded past their lengths.  ``normalized`` divides by the
    reference's length.  Returns (distances (B, 1) float32, sequence_num
    (1,) int64) -- the reference op's (Out, SequenceNum); int32 in the JAX
    package."""
    hyps = as_tensor(hyps).long()
    refs = as_tensor(refs, like=hyps).long()
    B, Lh = hyps.shape
    Lr = refs.shape[1]
    dev = hyps.device
    hyp_lengths = (torch.full((B,), Lh, dtype=torch.int64, device=dev)
                   if hyp_lengths is None
                   else as_tensor(hyp_lengths, like=hyps).long())
    ref_lengths = (torch.full((B,), Lr, dtype=torch.int64, device=dev)
                   if ref_lengths is None
                   else as_tensor(ref_lengths, like=hyps).long())
    row = torch.arange(Lr + 1, dtype=torch.float32,
                       device=dev).expand(B, Lr + 1)
    for i in range(Lh):
        sub = (hyps[:, i, None] != refs).float()
        new = [torch.full((B,), i + 1.0, device=dev)]
        for j in range(Lr):
            new.append(torch.minimum(torch.minimum(row[:, j + 1] + 1.0,
                                                   new[-1] + 1.0),
                                     row[:, j] + sub[:, j]))
        new = torch.stack(new, dim=1)
        # rows past each hypothesis's length stay frozen
        row = torch.where((i < hyp_lengths)[:, None], new, row)
    d = torch.gather(row, 1, ref_lengths[:, None])[:, 0]
    # an empty reference: the distance is the hypothesis's length
    empty = ref_lengths == 0
    d = torch.where(empty, hyp_lengths.float(), d)
    if normalized:
        d = torch.where(empty, (hyp_lengths > 0).float(),
                        d / torch.clamp(ref_lengths.float(), min=1.0))
    return d[:, None], torch.tensor([B], dtype=torch.int64, device=dev)


def ctc_greedy_decoder(probs, blank: int, input_lengths=None,
                       padding_value: int = 0):
    """Best-path CTC decoding: the argmax at each step, repeats collapsed,
    blanks dropped.  probs (B, T, C); input_lengths (B,) valid steps
    (default T).  Returns (decoded (B, T) int64 padded with
    ``padding_value``, lengths (B,) int64); int32 in the JAX package."""
    probs = as_tensor(probs)
    B, T, _ = probs.shape
    dev = probs.device
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.int64, device=dev)
    else:
        input_lengths = as_tensor(input_lengths, like=probs).long()
    path = torch.argmax(probs, dim=-1)                              # (B, T)
    valid = torch.arange(T, device=dev)[None, :] < input_lengths[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=path.dtype, device=dev),
                      path[:, :-1]], dim=1)
    keep = valid & (path != blank) & (path != prev)
    pos = torch.cumsum(keep.long(), dim=1) - 1
    lengths = keep.sum(dim=1)
    # dropped tokens go to a spare column that is cut off afterwards
    out = torch.full((B, T + 1), padding_value, dtype=torch.int64,
                     device=dev)
    out.scatter_(1, torch.where(keep, pos, torch.full_like(pos, T)), path)
    return out[:, :T], lengths
