"""Lowerings of paddle_tpu/static/ops_tail3.py that the layers DSL emits
(counterpart of that module; the rest waits for a later slice):
``prroi_pool``, ``filter_by_instag`` and ``chunk_eval``."""
from __future__ import annotations

import torch

from .ops import _one
from .registry import register_op


def _hat_integral(a, b, i):
    """The integral of max(0, 1-|x-i|) over [a, b], closed form (PrRoI's
    bilinear weight)."""
    lo1, hi1 = torch.maximum(a, i - 1.0), torch.minimum(b, i)
    rise = 0.5 * ((hi1 - (i - 1.0)) ** 2 - (lo1 - (i - 1.0)) ** 2)
    rise = torch.where(hi1 - lo1 > 0, rise, torch.zeros_like(rise))
    lo2, hi2 = torch.maximum(a, i), torch.minimum(b, i + 1.0)
    fall = 0.5 * (((i + 1.0) - lo2) ** 2 - ((i + 1.0) - hi2) ** 2)
    fall = torch.where(hi2 - lo2 > 0, fall, torch.zeros_like(fall))
    return rise + fall


@register_op("prroi_pool")
def _prroi_pool(ins, attrs, op):
    """ref prroi_pool_op.h (PrRoI pooling): the exact integral of the
    bilinearly interpolated feature surface over each bin, over the bin's
    area; ``BatchRoINums`` holds per-image RoI counts."""
    x = _one(ins, "X")                       # (N, C, H, W)
    rois = _one(ins, "ROIs").float()         # (R, 4) x1 y1 x2 y2
    counts = _one(ins, "BatchRoINums")
    scale = attrs.get("spatial_scale", 1.0)
    ph, pw = attrs["pooled_height"], attrs["pooled_width"]
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    if counts is None:
        roi_batch = torch.zeros((R,), dtype=torch.long, device=dev)
    else:
        roi_batch = torch.repeat_interleave(
            torch.arange(N, device=dev), counts.reshape(-1).long(),
            output_size=R)
    ii = torch.arange(H, dtype=torch.float32, device=dev)
    jj = torch.arange(W, dtype=torch.float32, device=dev)
    gy = torch.arange(ph, dtype=torch.float32, device=dev)
    gx = torch.arange(pw, dtype=torch.float32, device=dev)
    outs = []
    for r in range(R):
        x1, y1, x2, y2 = (rois[r] * scale).unbind()
        bw = torch.clamp_min((x2 - x1) / pw, 1e-9)
        bh = torch.clamp_min((y2 - y1) / ph, 1e-9)
        wy = _hat_integral((y1 + gy * bh)[:, None],
                           (y1 + (gy + 1) * bh)[:, None], ii[None, :])
        wx = _hat_integral((x1 + gx * bw)[:, None],
                           (x1 + (gx + 1) * bw)[:, None], jj[None, :])
        pooled = torch.einsum("ph,qw,chw->cpq", wy, wx, x[roi_batch[r]])
        outs.append(pooled / (bw * bh))
    return {"Out": [torch.stack(outs)]}


@register_op("filter_by_instag")
def _filter_by_instag(ins, attrs, op):
    """ref filter_by_instag_op.cc, dense: rows whose tags miss the filter
    tags are zeroed; LossWeight is the 0/1 keep mask, IndexMap the
    identity of the kept positions."""
    x = _one(ins, "Ins")          # (B, D)
    tags = _one(ins, "Ins_tag")   # (B, Lt) padded with -1
    ftags = _one(ins, "Filter_tag").reshape(-1)
    keep = ((tags[:, :, None] == ftags[None, None, :])
            & (tags[:, :, None] >= 0)).any(dim=2).any(dim=1)
    w = keep.to(x.dtype)
    idx = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return {"Out": [x * w[:, None]], "LossWeight": [w[:, None]],
            "IndexMap": [torch.stack([idx, idx], dim=1)]}


@register_op("chunk_eval")
def _chunk_eval(ins, attrs, op):
    """ref metrics chunk_eval_op.h (IOB/IOE/IOBES/plain chunk P/R/F1)."""
    from ..ops.chunking import chunk_eval

    p, r, f1, ni, nl, nc = chunk_eval(
        _one(ins, "Inference"), _one(ins, "Label"), _one(ins, "SeqLength"),
        chunk_scheme=attrs.get("chunk_scheme", "IOB"),
        num_chunk_types=attrs.get("num_chunk_types", 1),
        excluded_chunk_types=attrs.get("excluded_chunk_types"))
    return {"Precision": [p], "Recall": [r], "F1-Score": [f1],
            "NumInferChunks": [ni], "NumLabelChunks": [nl],
            "NumCorrectChunks": [nc]}
