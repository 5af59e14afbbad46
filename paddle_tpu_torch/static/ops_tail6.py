"""Static-op long tail, batch 6 (counterpart of
paddle_tpu/static/ops_tail6.py): the RCNN / FPN detection training tail —
``generate_proposals`` (top-k, BoxCoder decode, clip, min-size filter,
NMS), ``rpn_target_assign`` (anchor fg / bg sampling), ``matrix_nms``,
``box_decoder_and_assign``, ``distribute_fpn_proposals`` /
``collect_fpn_proposals``.

The contracts are the JAX package's: static shapes, valid entries first,
zero / -1 padding, counts under an optional output slot.  Top-k and the
score orders are stable sorts, so ties keep index order as ``lax.top_k``
and ``jnp.argsort`` do.

Greedy NMS (``greedy_nms_mask``) is the JAX package's result — box i is
kept unless a kept, higher-ranked box overlaps it above the threshold —
computed without a loop over boxes: the keep vector is the fixed point of
``keep = valid & ~any(kept earlier box overlapping)``, whose first t
entries are final after t sweeps.  Each sweep is one masked reduction
over the (n, n) overlap matrix; the sweeps run in groups of eight between
host checks, so a call reads the device a few times, not once a box.
``rpn_target_assign`` draws from the Executor's per-op CPU generator.
"""
from __future__ import annotations

import math

import torch

from ..core import random as _random
from .ops import _one
from .registry import register_op

_SWEEPS_PER_CHECK = 8


def iou_xyxy(a, b, normalized=True):
    """Pairwise IoU of (n, 4) x (m, 4) corner boxes."""
    off = 0.0 if normalized else 1.0
    area_a = (a[:, 2] - a[:, 0] + off).clamp_min(0) \
        * (a[:, 3] - a[:, 1] + off).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0] + off).clamp_min(0) \
        * (b[:, 3] - b[:, 1] + off).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + off).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(
        1e-10)


def _stable_desc(scores):
    """Indices ordering ``scores`` high to low, ties by index."""
    return torch.sort(scores, descending=True, stable=True).indices


def greedy_nms_mask(boxes, scores, thresh, max_out, class_ids=None,
                    valid=None, normalized=True):
    """Greedy NMS over score-sorted boxes: (order, keep mask in that
    order) with at most ``max_out`` kept (the JAX package's result, by the
    fixed-point sweep of the module docstring).  ``class_ids`` restricts
    suppression to same-class pairs; ``valid`` drops rows first."""
    n = boxes.shape[0]
    order = _stable_desc(scores)
    b = boxes[order]
    over = iou_xyxy(b, b, normalized=normalized) > thresh
    over &= torch.ones((n, n), dtype=torch.bool,
                       device=b.device).tril(diagonal=-1)
    if class_ids is not None:
        c = class_ids[order]
        over &= c[:, None] == c[None, :]
    v = torch.ones((n,), dtype=torch.bool, device=b.device) \
        if valid is None else valid[order]
    keep = v
    for sweep in range(n):
        prev = keep
        keep = v & ~(over & keep[None, :]).any(dim=1)
        if (sweep + 1) % _SWEEPS_PER_CHECK == 0 and torch.equal(keep, prev):
            break
    kept_rank = torch.cumsum(keep.long(), 0) - 1
    return order, keep & (kept_rank < max_out)


def _compact(mask, values, size, fill):
    """``values`` at the True entries of ``mask``, packed to the front of
    a ``size``-long tensor filled with ``fill``."""
    out = torch.full((size,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    tgt = torch.cumsum(mask.long(), 0) - 1
    sel = mask & (tgt < size)
    out[tgt[sel]] = values[sel]
    return out


@register_op("generate_proposals")
def _generate_proposals(ins, attrs, op):
    """ref detection/generate_proposals_op.cc (RPN stage).  Scores
    (N, A, H, W), BboxDeltas (N, 4A, H, W), Anchors / Variances
    (H, W, A, 4) or (A*H*W, 4), ImInfo (N, 3)."""
    scores, deltas = _one(ins, "Scores"), _one(ins, "BboxDeltas")
    im_info = _one(ins, "ImInfo").float()
    anchors = _one(ins, "Anchors").reshape(-1, 4).float()
    variances = _one(ins, "Variances")
    variances = (variances.reshape(-1, 4).float() if variances is not None
                 else torch.ones_like(anchors))
    pre_n = int(attrs.get("pre_nms_topN", 6000))
    post_n = int(attrs.get("post_nms_topN", 1000))
    nms_thresh = float(attrs.get("nms_thresh", 0.7))
    min_size = float(attrs.get("min_size", 0.1))
    N, A, H, W = scores.shape
    M = A * H * W
    # (N, A, H, W) -> (N, H, W, A): flat index i is anchor row i
    sc = scores.permute(0, 2, 3, 1).reshape(N, M).float()
    dl = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, M, 4).float()
    pre_n = min(pre_n if pre_n > 0 else M, M)
    post_n = min(post_n, pre_n)
    kclip = math.log(1000.0 / 16.0)
    rois_all, probs_all, counts = [], [], []
    for i in range(N):
        idx = _stable_desc(sc[i])[:pre_n]
        top_sc = sc[i][idx]
        anc, var, d = anchors[idx], variances[idx], dl[i][idx]
        # BoxCoder (generate_proposals_op.cc:69): +1 widths, var-scaled
        aw = anc[:, 2] - anc[:, 0] + 1.0
        ah = anc[:, 3] - anc[:, 1] + 1.0
        acx, acy = anc[:, 0] + 0.5 * aw, anc[:, 1] + 0.5 * ah
        cx = var[:, 0] * d[:, 0] * aw + acx
        cy = var[:, 1] * d[:, 1] * ah + acy
        w = torch.exp(torch.clamp_max(var[:, 2] * d[:, 2], kclip)) * aw
        h = torch.exp(torch.clamp_max(var[:, 3] * d[:, 3], kclip)) * ah
        props = torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                             cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], -1)
        info = im_info[i]
        hi = torch.stack([info[1] - 1, info[0] - 1, info[1] - 1,
                          info[0] - 1])
        props = torch.minimum(props.clamp_min(0.0), hi)
        # min-size filter at the original image scale (FilterBoxes,
        # generate_proposals_op.cc:161)
        ms = max(min_size, 1.0)
        keep_sz = (((props[:, 2] - props[:, 0]) / info[2] + 1.0 >= ms)
                   & ((props[:, 3] - props[:, 1]) / info[2] + 1.0 >= ms))
        sc_f = torch.where(keep_sz, top_sc,
                           torch.full_like(top_sc, -math.inf))
        order, keep = greedy_nms_mask(props, sc_f, nms_thresh, post_n)
        osc = sc_f[order]
        okeep = keep & torch.isfinite(osc)
        rois_all.append(_compact(okeep, props[order], post_n, 0.0))
        probs_all.append(_compact(okeep, osc, post_n, 0.0)[:, None])
        counts.append(okeep.sum())
    counts = torch.stack(counts)
    return {"RpnRois": [torch.stack(rois_all)],
            "RpnRoiProbs": [torch.stack(probs_all)],
            "RpnRoisNum": [counts], "RpnRoisLod": [torch.cumsum(counts, 0)]}


def _rank(keyed):
    """Each entry's position when ``keyed`` is sorted ascending (stable)."""
    return torch.argsort(torch.argsort(keyed, stable=True), stable=True)


@register_op("rpn_target_assign")
def _rpn_target_assign(ins, attrs, op):
    """ref rpn_target_assign_op.cc: per image, anchors >= pos_overlap IoU
    with some gt (plus each gt's best anchor) are foreground, < neg_overlap
    background; subsample to rpn_batch_size_per_im at rpn_fg_fraction.
    Anchor (A, 4), GtBoxes (N, G, 4) (rows with w <= 0 are padding);
    per-image padded index rows + counts."""
    anchors = _one(ins, "Anchor").float()
    gt = _one(ins, "GtBoxes").float()
    if gt.ndim == 2:
        gt = gt[None]
    batch = int(attrs.get("rpn_batch_size_per_im", 256))
    pos_th = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_th = float(attrs.get("rpn_negative_overlap", 0.3))
    fg_cap = int(batch * float(attrs.get("rpn_fg_fraction", 0.5)))
    use_random = bool(attrs.get("use_random", True))
    A = anchors.shape[0]
    dev = anchors.device
    arange = torch.arange(A, dtype=torch.int32, device=dev)
    two = torch.full((A,), 2.0, device=dev)
    outs = {k: [] for k in ("loc", "score", "lbl", "tbox", "gtidx", "nfg",
                            "nsc")}
    for gt_i in gt:
        valid_gt = gt_i[:, 2] > gt_i[:, 0]
        iou = iou_xyxy(anchors, gt_i, normalized=False)
        iou = torch.where(valid_gt[None, :], iou, torch.zeros_like(iou))
        a2g_max, a2g_arg = iou.max(dim=1)
        g2a_max = iou.max(dim=0).values
        is_best = ((iou == g2a_max[None, :]) & (g2a_max[None, :] > 0)
                   & valid_gt[None, :]).any(dim=1)
        fg = (a2g_max >= pos_th) | is_best
        bg = (a2g_max < neg_th) & ~fg
        if use_random:
            gen = _random.current_generator()
            rf = torch.rand((A,), generator=gen).to(dev)
            rb = torch.rand((A,), generator=gen).to(dev)
        else:
            rf = rb = arange.float() / A
        fg_sel = fg & (_rank(torch.where(fg, rf, two)) < fg_cap)
        n_fg = fg_sel.sum()
        bg_sel = bg & (_rank(torch.where(bg, rb, two)) < batch - n_fg)
        score_sel = fg_sel | bg_sel
        loc_index = _compact(fg_sel, arange, batch, -1)
        score_index = _compact(score_sel, arange, batch, -1)
        lbl = torch.zeros((batch + 1,), dtype=torch.int32, device=dev)
        pos = torch.cumsum(score_sel.long(), 0) - 1
        lbl[torch.where(fg_sel, pos, torch.full_like(pos, batch))
            .clamp_max(batch)] = 1
        lbl = lbl[:batch]
        gt_of_fg = _compact(fg_sel, a2g_arg.to(torch.int32), batch, -1)
        # TargetBBox carries the matched gt boxes (the reference's {-1, 4}
        # contract, rpn_target_assign_op.cc:76)
        tbox = torch.where((gt_of_fg >= 0)[:, None],
                           gt_i[gt_of_fg.clamp_min(0).long()],
                           torch.zeros((), device=dev))
        for k, v in (("loc", loc_index), ("score", score_index),
                     ("lbl", lbl), ("tbox", tbox), ("gtidx", gt_of_fg),
                     ("nfg", n_fg), ("nsc", score_sel.sum())):
            outs[k].append(v)
    st = {k: torch.stack(v) for k, v in outs.items()}
    return {"LocationIndex": [st["loc"]], "ScoreIndex": [st["score"]],
            "TargetLabel": [st["lbl"]], "TargetBBox": [st["tbox"]],
            "MatchedGtIndex": [st["gtidx"]],
            "BBoxInsideWeight": [(st["loc"] >= 0).float()[..., None]
                                 .expand(st["tbox"].shape)],
            "ForegroundNumber": [st["nfg"]], "ScoreNumber": [st["nsc"]]}


@register_op("matrix_nms")
def _matrix_nms(ins, attrs, op):
    """ref matrix_nms_op.cc: parallel soft-NMS — each box's score decays
    by the min over higher-ranked boxes of decay(iou, max_iou), one (k, k)
    matrix a class.  BBoxes (N, M, 4), Scores (N, C, M); Out
    (N, keep_top_k, 6) rows [class, score, x1, y1, x2, y2] zero-padded +
    RoisNum."""
    bboxes = _one(ins, "BBoxes").float()
    scores = _one(ins, "Scores").float()
    score_th = float(attrs.get("score_threshold", 0.05))
    post_th = float(attrs.get("post_threshold", 0.0))
    nms_top_k = int(attrs.get("nms_top_k", 400))
    keep_top_k = int(attrs.get("keep_top_k", 200))
    use_gaussian = bool(attrs.get("use_gaussian", False))
    sigma = float(attrs.get("gaussian_sigma", 2.0))
    background = int(attrs.get("background_label", 0))
    normalized = bool(attrs.get("normalized", True))
    N, C, M = scores.shape
    k = min(nms_top_k if nms_top_k > 0 else M, M)
    dev = scores.device
    tri = torch.ones((k, k), dtype=torch.bool, device=dev).tril(-1)
    cls = torch.arange(C, dtype=torch.float32,
                       device=dev)[:, None].expand(C, k).reshape(-1)
    keep_k = C * k if keep_top_k <= 0 else min(keep_top_k, C * k)
    outs, counts = [], []
    for n in range(N):
        bs, dss = [], []
        for c in range(C):
            idx = _stable_desc(scores[n, c])[:k]
            top_sc = scores[n, c][idx]
            b = bboxes[n][idx]
            iou_l = torch.where(tri, iou_xyxy(b, b, normalized=normalized),
                                torch.zeros((), device=dev))
            iou_max = iou_l.max(dim=1).values
            if use_gaussian:
                # ref matrix_nms_op.cc:83: exp((max_iou^2 - iou^2) * sigma)
                decay = torch.exp((iou_max[None, :] ** 2 - iou_l ** 2)
                                  * sigma)
            else:
                decay = (1.0 - iou_l) / (1.0 - iou_max[None, :]).clamp_min(
                    1e-10)
            decay = torch.where(tri, decay, torch.ones((), device=dev))
            ds = decay.min(dim=1).values * top_sc
            keep = (top_sc > score_th) & (ds > post_th)
            bs.append(b)
            dss.append(torch.where(keep, ds, torch.zeros_like(ds)))
        flat_ds = torch.stack(dss).reshape(-1)
        if 0 <= background < C:
            flat_ds = torch.where(cls == background,
                                  torch.zeros_like(flat_ds), flat_ds)
        fidx = _stable_desc(flat_ds)[:keep_k]
        top_ds = flat_ds[fidx]
        out = torch.cat([cls[fidx, None], top_ds[:, None],
                         torch.stack(bs).reshape(-1, 4)[fidx]], dim=1)
        valid = top_ds > 0
        outs.append(torch.where(valid[:, None], out,
                                torch.zeros((), device=dev)))
        counts.append(valid.sum())
    counts = torch.stack(counts)
    return {"Out": [torch.stack(outs)], "Index": [torch.zeros_like(counts)],
            "RoisNum": [counts]}


@register_op("box_decoder_and_assign")
def _box_decoder_and_assign(ins, attrs, op):
    """ref box_decoder_and_assign_op.h: decode per-class deltas against
    shared priors (+1 widths, one 4-variance), then give each roi the box
    of its argmax non-background class."""
    prior = _one(ins, "PriorBox").float()       # (R, 4)
    pvar = _one(ins, "PriorBoxVar").float()     # (4,)
    target = _one(ins, "TargetBox").float()     # (R, C*4)
    score = _one(ins, "BoxScore").float()       # (R, C)
    clip = float(attrs.get("box_clip", 4.135166556742356))
    R, C = score.shape
    t = target.reshape(R, C, 4)
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx, pcy = prior[:, 0] + 0.5 * pw, prior[:, 1] + 0.5 * ph
    cx = pvar[0] * t[:, :, 0] * pw[:, None] + pcx[:, None]
    cy = pvar[1] * t[:, :, 1] * ph[:, None] + pcy[:, None]
    w = torch.exp(torch.clamp_max(pvar[2] * t[:, :, 2], clip)) * pw[:, None]
    h = torch.exp(torch.clamp_max(pvar[3] * t[:, :, 3], clip)) * ph[:, None]
    dec = torch.stack([cx - w / 2, cy - h / 2,
                       cx + w / 2 - 1.0, cy + h / 2 - 1.0], dim=-1)
    sc = score
    if C > 1:
        sc = score.clone()
        sc[:, 0] = -math.inf
    best = sc.argmax(dim=1)
    return {"DecodeBox": [dec.reshape(R, C * 4)],
            "OutputAssignBox": [dec[torch.arange(R, device=dec.device),
                                    best]]}


_FPN_EPS = 1e-6


@register_op("distribute_fpn_proposals")
def _distribute_fpn_proposals(ins, attrs, op):
    """ref distribute_fpn_proposals_op.h: route each roi to FPN level
    floor(refer_level + log2(sqrt(area)/refer_scale)), clipped to
    [min_level, max_level].  FpnRois (R, 4) -> per-level (R, 4)
    zero-padded + per-level counts + RestoreIndex."""
    rois = _one(ins, "FpnRois").float()
    min_l, max_l = int(attrs["min_level"]), int(attrs["max_level"])
    refer_l, refer_s = int(attrs["refer_level"]), int(attrs["refer_scale"])
    R = rois.shape[0]
    dev = rois.device
    valid = (rois[:, 2] > rois[:, 0]) | (rois[:, 3] > rois[:, 1])
    # BBoxArea(rois, normalized=false): +1 widths
    area = (rois[:, 2] - rois[:, 0] + 1).clamp_min(0) \
        * (rois[:, 3] - rois[:, 1] + 1).clamp_min(0)
    lvl = torch.floor(torch.log2(torch.sqrt(area) / refer_s + _FPN_EPS)) \
        + refer_l
    lvl = lvl.clamp(min_l, max_l).to(torch.int32)
    lvl = torch.where(valid, lvl, torch.full_like(lvl, -1))
    arange = torch.arange(R, dtype=torch.int32, device=dev)
    outs, counts = [], []
    restore = torch.full((R + 1,), -1, dtype=torch.int32, device=dev)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    for level in range(min_l, max_l + 1):
        mask = lvl == level
        outs.append(_compact(mask, rois, R, 0.0))
        tgt = torch.cumsum(mask.long(), 0) - 1
        # row r of this level sits at offset + r of the by-level order;
        # RestoreIndex maps it back to its original position
        pos = torch.where(mask, offset + tgt, torch.full_like(tgt, R))
        restore[pos] = torch.where(mask, arange, restore[pos])
        n = mask.sum()
        counts.append(n)
        offset = offset + n
    return {"MultiFpnRois": outs,
            "MultiLevelRoIsNum": [torch.stack(counts)],
            "RestoreIndex": [restore[:R, None]]}


@register_op("collect_fpn_proposals")
def _collect_fpn_proposals(ins, attrs, op):
    """ref collect_fpn_proposals_op.h: concat per-level rois + scores and
    keep the global top post_nms_topN by score; MultiLevelRoIsNum masks
    each level's padding."""
    rois_list = ins.get("MultiLevelRois", [])
    scores_list = ins.get("MultiLevelScores", [])
    counts = _one(ins, "MultiLevelRoIsNum")
    all_rois = torch.cat([r.reshape(-1, 4) for r in rois_list], 0)
    all_scores = torch.cat([s.reshape(-1) for s in scores_list], 0).float()
    if counts is not None:
        m = torch.cat([torch.arange(r.reshape(-1, 4).shape[0],
                                    device=all_rois.device) < counts[i]
                       for i, r in enumerate(rois_list)])
        all_scores = torch.where(m, all_scores,
                                 torch.full_like(all_scores, -math.inf))
    k = min(int(attrs.get("post_nms_topN", 1000)), all_scores.shape[0])
    idx = _stable_desc(all_scores)[:k]
    valid = torch.isfinite(all_scores[idx])
    sel = torch.where(valid[:, None], all_rois[idx],
                      torch.zeros((), dtype=all_rois.dtype,
                                  device=all_rois.device))
    return {"FpnRois": [sel], "RoisNum": [valid.sum()]}
