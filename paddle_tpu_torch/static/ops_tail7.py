"""Static-op long tail, batch 7 (counterpart of
paddle_tpu/static/ops_tail7.py): the TDM index ops ``tdm_child`` /
``tdm_sampler``, the text-matching pair ``match_matrix_tensor`` /
``sequence_topk_avg_pooling``, ``retinanet_target_assign``,
``deformable_psroi_pooling``, the Faster R-CNN proposal-target layer
``generate_proposal_labels``, ``retinanet_detection_output`` and
``roi_perspective_transform``.

Everything keeps the JAX package's static shapes and padded + count
contract.  ``tdm_sampler`` and ``generate_proposal_labels`` draw from the
Executor's per-op CPU generator (repeatable for a fixed seed, not
``jax.random``'s draws).  ``retinanet_detection_output``'s per-class NMS
is one class-aware greedy pass (ops_tail6's ``greedy_nms_mask``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ..core import random as _random
from .ops import _one
from .ops_tail6 import _stable_desc, greedy_nms_mask, iou_xyxy
from .registry import register_op


def _gen():
    return _random.current_generator()


# =========================================================================
# TDM (tree-based deep match) index ops
# =========================================================================

@register_op("tdm_child")
def _tdm_child(ins, attrs, op):
    """ref tdm_child_op.h: TreeInfo rows are [item_id, layer_id,
    ancestor_id, child_0..child_{n-1}]; each input node's child ids and a
    leaf mask (the child's item_id != 0); nodes with id 0 or no first
    child give zeros."""
    x, info = _one(ins, "X"), _one(ins, "TreeInfo")
    n = int(attrs.get("child_nums", 1))
    ids = x.reshape(-1).long()
    children = info[ids, 3:3 + n].long()
    has_child = (ids != 0) & (info[ids, 3] != 0)
    children = torch.where(has_child[:, None], children,
                           torch.zeros_like(children))
    is_item = (info[children.reshape(-1), 0] != 0).to(torch.int32)
    mask = torch.where(has_child[:, None], is_item.reshape(children.shape),
                       torch.zeros((), dtype=torch.int32, device=x.device))
    out_shape = tuple(x.shape) + (n,)
    return {"Child": [children.to(torch.int32).reshape(out_shape)],
            "LeafMask": [mask.reshape(out_shape)]}


@register_op("tdm_sampler")
def _tdm_sampler(ins, attrs, op):
    """ref tdm_sampler_op.h: per item and tree layer, the positive ancestor
    (Travel[i, layer]) plus neg_samples_num_list[layer] uniform negatives
    from the layer's node list (Layer sliced by layer_offset_lod), never
    the positive (draw from n-1, shift past the positive's slot)."""
    x = _one(ins, "X")
    travel = _one(ins, "Travel").long()
    layer = _one(ins, "Layer").reshape(-1).long()
    negs = [int(v) for v in attrs["neg_samples_num_list"]]
    offsets = [int(v) for v in attrs["layer_offset_lod"]]
    out_pos = bool(attrs.get("output_positive", True))
    ids = x.reshape(-1).long()
    M = ids.shape[0]
    dev = x.device
    outs, labels, masks = [], [], []
    for li, neg in enumerate(negs):
        lo, hi = offsets[li], offsets[li + 1]
        layer_n = hi - lo
        pos = travel[ids, li]
        valid = (pos != 0).long()
        if out_pos:
            outs.append(pos[:, None])
            labels.append(torch.ones((M, 1), dtype=torch.int64, device=dev))
            masks.append(valid[:, None])
        if neg > 0:
            draw = torch.randint(0, max(layer_n - 1, 1), (M, neg),
                                 generator=_gen()).to(dev)
            pos_slot = (layer[lo:hi][None, :] == pos[:, None]).to(
                torch.int8).argmax(dim=1)
            draw = torch.where(draw >= pos_slot[:, None], draw + 1, draw)
            draw = draw.clamp(0, layer_n - 1)
            outs.append(layer[lo + draw])
            labels.append(torch.zeros((M, neg), dtype=torch.int64,
                                      device=dev))
            masks.append(valid[:, None].expand(M, neg))
    msk = torch.cat(masks, dim=1)
    return {"Out": [(torch.cat(outs, dim=1) * msk).to(torch.int32)],
            "Labels": [(torch.cat(labels, dim=1) * msk).to(torch.int32)],
            "Mask": [msk.to(torch.int32)]}


# =========================================================================
# text matching contrib pair
# =========================================================================

def _len_mask(n, lengths, device):
    return torch.arange(n, device=device)[None, :] \
        < lengths.reshape(-1).long()[:, None]


@register_op("match_matrix_tensor")
def _match_matrix_tensor(ins, attrs, op):
    """ref match_matrix_tensor_op.cc: out[b, t, i, j] = x_i . W_t . y_j.
    X (B, Lx, D), Y (B, Ly, D), W (D, dim_t, D); lengths mask the pads."""
    x, y, w = (_one(ins, "X").float(), _one(ins, "Y").float(),
               _one(ins, "W").float())
    xlen, ylen = _one(ins, "XLength"), _one(ins, "YLength")
    tmp = torch.einsum("bid,dte->bite", x, w)
    out = torch.einsum("bite,bje->btij", tmp, y)
    if xlen is not None:
        out = out * _len_mask(x.shape[1], xlen, x.device)[:, None, :, None]
    if ylen is not None:
        out = out * _len_mask(y.shape[1], ylen, y.device)[:, None, None, :]
    return {"Out": [out], "Tmp": [tmp]}


@register_op("sequence_topk_avg_pooling")
def _sequence_topk_avg_pooling(ins, attrs, op):
    """ref sequence_topk_avg_pooling_op.h: for each row of a (row x col)
    score grid per (batch, channel), the average of its top-k column
    scores for every k in ``topks``.  X (B, C, R, Cl) + RowLength /
    ColLength -> Out (B, R, C * len(topks))."""
    x = _one(ins, "X").float()
    row_len, col_len = _one(ins, "RowLength"), _one(ins, "ColLength")
    topks = [int(v) for v in attrs["topks"]]
    B, C, R, Cl = x.shape
    max_k = min(max(topks), Cl)
    neg = -1e30
    if col_len is not None:
        x = torch.where(_len_mask(Cl, col_len, x.device)[:, None, None, :],
                        x, torch.full((), neg, device=x.device))
    top = torch.sort(x, dim=-1, descending=True).values[..., :max_k]
    top = torch.where(top <= neg / 2, torch.zeros_like(top), top)
    csum = torch.cumsum(top, dim=-1)
    feats = [csum[..., min(k, max_k) - 1] / float(k) for k in topks]
    out = torch.stack(feats, dim=2).permute(0, 3, 1, 2) \
        .reshape(B, R, C * len(topks))
    if row_len is not None:
        out = out * _len_mask(R, row_len, x.device)[..., None]
    return {"Out": [out], "pos": [torch.zeros((B, R, 1), dtype=torch.int32,
                                              device=x.device)]}


# =========================================================================
# RetinaNet target assign (the no-subsample rpn variant)
# =========================================================================

def _pack(mask, values, size, fill):
    out = torch.full((size,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    tgt = torch.cumsum(mask.long(), 0) - 1
    out[tgt[mask]] = values[mask]
    return out


@register_op("retinanet_target_assign")
def _retinanet_target_assign(ins, attrs, op):
    """ref retinanet_target_assign_op.cc: rpn_target_assign without the
    fg / bg subsampling: fg = IoU >= positive_overlap (plus each gt's best
    anchor), bg = IoU < negative_overlap; TargetLabel is the matched gt's
    class at foreground slots, 0 elsewhere."""
    anchors = _one(ins, "Anchor").float()
    gt = _one(ins, "GtBoxes").float()
    gt_labels = _one(ins, "GtLabels")
    pos_th = float(attrs.get("positive_overlap", 0.5))
    neg_th = float(attrs.get("negative_overlap", 0.4))
    if gt.ndim == 2:
        gt, gt_labels = gt[None], gt_labels[None]
    A = anchors.shape[0]
    arange = torch.arange(A, dtype=torch.int32, device=anchors.device)
    res = {k: [] for k in ("loc", "score", "lbl", "tbox", "nfg", "nsc")}
    for gt_i, lbl_i in zip(gt, gt_labels):
        valid_gt = gt_i[:, 2] > gt_i[:, 0]
        iou = iou_xyxy(anchors, gt_i, normalized=False)
        iou = torch.where(valid_gt[None, :], iou, torch.zeros_like(iou))
        a2g_max, a2g_arg = iou.max(dim=1)
        g2a_max = iou.max(dim=0).values
        is_best = ((iou == g2a_max[None, :]) & (g2a_max[None, :] > 0)
                   & valid_gt[None, :]).any(dim=1)
        fg = (a2g_max >= pos_th) | is_best
        bg = (a2g_max < neg_th) & ~fg
        score_sel = fg | bg
        cls = lbl_i.reshape(-1).to(torch.int32)[a2g_arg]
        lbl = torch.zeros((A + 1,), dtype=torch.int32, device=anchors.device)
        pos = torch.cumsum(score_sel.long(), 0) - 1
        lbl[torch.where(fg, pos, torch.full_like(pos, A))] = torch.where(
            fg, cls, lbl[torch.where(fg, pos, torch.full_like(pos, A))])
        res["loc"].append(_pack(fg, arange, A, -1))
        res["score"].append(_pack(score_sel, arange, A, -1))
        res["lbl"].append(lbl[:A])
        res["tbox"].append(_pack(fg, gt_i[a2g_arg], A, 0.0))
        res["nfg"].append(fg.sum())
        res["nsc"].append(score_sel.sum())
    st = {k: torch.stack(v) for k, v in res.items()}
    return {"LocationIndex": [st["loc"]], "ScoreIndex": [st["score"]],
            "TargetLabel": [st["lbl"]], "TargetBBox": [st["tbox"]],
            "BBoxInsideWeight": [(st["loc"] >= 0).float()[..., None]
                                 .expand(st["tbox"].shape)],
            "ForegroundNumber": [st["nfg"]], "ScoreNumber": [st["nsc"]]}


# =========================================================================
# deformable PS-RoI pooling
# =========================================================================

def _pair_attr(attrs, name, default):
    v = attrs.get(name, default)
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


@register_op("deformable_psroi_pooling")
def _deformable_psroi_pooling(ins, attrs, op):
    """ref deformable_psroi_pooling_op.h: position-sensitive RoI pooling
    where each part's sampling window shifts by a learned offset (Trans
    (R, 2*num_classes, part_h, part_w) scaled by trans_std).  Input
    (N, C, H, W) with C = output_dim * group_h * group_w, ROIs (R, 5)
    [batch_idx, x1, y1, x2, y2]; the kernel's sampling (w = wstart +
    iw*sub_bin, samples outside (-0.5, dim-0.5) skipped, the rest clamped
    to [0, dim-1])."""
    x = _one(ins, "Input").float()
    rois = _one(ins, "ROIs").float()
    trans = _one(ins, "Trans")
    no_trans = bool(attrs.get("no_trans", trans is None))
    spatial_scale = float(attrs.get("spatial_scale", 1.0))
    out_dim = int(attrs["output_dim"])
    group_h, group_w = _pair_attr(attrs, "group_size", 1)
    pooled_h = int(attrs.get("pooled_height",
                             _pair_attr(attrs, "pooled_size", 1)[0]))
    pooled_w = int(attrs.get("pooled_width",
                             _pair_attr(attrs, "pooled_size", 1)[1]))
    part_h_n, part_w_n = _pair_attr(attrs, "part_size",
                                    (pooled_h, pooled_w))
    spp = int(attrs.get("sample_per_part", 4))
    trans_std = float(attrs.get("trans_std", 0.1))
    _N, _C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    num_classes = 1
    if trans is not None and not no_trans:
        num_classes = max(int(trans.shape[1]) // 2, 1)
    each = max(out_dim // num_classes, 1)
    trans_r = (None if trans is None else trans.float().reshape(
        R, 2 * num_classes, part_h_n, part_w_n))
    PH, PW = torch.meshgrid(torch.arange(pooled_h, device=dev),
                            torch.arange(pooled_w, device=dev),
                            indexing="ij")
    part_h = (PH * part_h_n) // pooled_h
    part_w = (PW * part_w_n) // pooled_w
    d = torch.arange(out_dim, device=dev)
    class_id = d // each
    gh = ((PH * group_h) // pooled_h).clamp(0, group_h - 1)
    gw = ((PW * group_w) // pooled_w).clamp(0, group_w - 1)
    cidx = (d[:, None, None] * group_h + gh[None]) * group_w + gw[None]
    ar = torch.arange(spp, device=dev, dtype=torch.float32)
    outs = []
    for r in range(R):
        roi = rois[r]
        x1 = torch.round(roi[1]) * spatial_scale - 0.5
        y1 = torch.round(roi[2]) * spatial_scale - 0.5
        x2 = (torch.round(roi[3]) + 1.0) * spatial_scale - 0.5
        y2 = (torch.round(roi[4]) + 1.0) * spatial_scale - 0.5
        rw = torch.clamp_min(x2 - x1, 0.1)
        rh = torch.clamp_min(y2 - y1, 0.1)
        bin_w, bin_h = rw / pooled_w, rh / pooled_h
        sub_w, sub_h = bin_w / spp, bin_h / spp
        if no_trans or trans_r is None:
            off_x = torch.zeros((out_dim, pooled_h, pooled_w), device=dev)
            off_y = torch.zeros((out_dim, pooled_h, pooled_w), device=dev)
        else:
            cid = class_id[:, None, None]
            tr = trans_r[r]
            off_x = tr[cid * 2, part_h[None], part_w[None]] * trans_std * rw
            off_y = tr[cid * 2 + 1, part_h[None], part_w[None]] \
                * trans_std * rh
        sx = (x1 + PW[None, ..., None, None] * bin_w
              + off_x[..., None, None] + ar[None, None, None, None, :] * sub_w)
        sy = (y1 + PH[None, ..., None, None] * bin_h
              + off_y[..., None, None] + ar[None, None, None, :, None] * sub_h)
        inside = ((sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5)
                  & (sy <= H - 0.5))
        sx = sx.clamp(0.0, W - 1.0)
        sy = sy.clamp(0.0, H - 1.0)
        x0, y0 = torch.floor(sx).long(), torch.floor(sy).long()
        x1i, y1i = (x0 + 1).clamp_max(W - 1), (y0 + 1).clamp_max(H - 1)
        fx, fy = sx - x0, sy - y0
        feat = x[int(roi[0])]
        c5 = cidx[:, :, :, None, None]
        val = (feat[c5, y0, x0] * ((1 - fy) * (1 - fx))
               + feat[c5, y0, x1i] * ((1 - fy) * fx)
               + feat[c5, y1i, x0] * (fy * (1 - fx))
               + feat[c5, y1i, x1i] * (fy * fx))
        val = val * inside
        cnt = inside.sum(dim=(-2, -1)).clamp_min(1)
        outs.append(val.sum(dim=(-2, -1)) / cnt)
    out = torch.stack(outs)
    return {"Output": [out], "TopCount": [torch.ones_like(out)]}


# =========================================================================
# Faster R-CNN proposal-target layer
# =========================================================================

def _rank(keyed):
    return torch.argsort(torch.argsort(keyed, stable=True), stable=True)


@register_op("generate_proposal_labels")
def _generate_proposal_labels(ins, attrs, op):
    """ref detection/generate_proposal_labels_op.cc (the proposal-target
    layer): per image, append the gt boxes to the rpn proposals, match
    them against gt by IoU, sample batch_size_per_im rois at fg_fraction
    (fg first, then bg) and emit per-class regression targets (BoxToDelta
    with bbox_reg_weights, bbox_util.h:54) in the (B, 4*class_nums)
    one-hot-slot layout.  RpnRois (N, R, 4) zero-padded + RpnRoisNum,
    GtBoxes (N, G, 4) (w <= 0 rows are padding), GtClasses / IsCrowd
    (N, G); outputs (N, batch_size_per_im, ...) + RoisNum."""
    rpn_rois = _one(ins, "RpnRois").float()
    gt_classes, is_crowd = _one(ins, "GtClasses"), _one(ins, "IsCrowd")
    gt_boxes = _one(ins, "GtBoxes").float()
    im_info = _one(ins, "ImInfo").float()
    rois_num_in = _one(ins, "RpnRoisNum")
    if rpn_rois.ndim == 2:
        rpn_rois, gt_boxes = rpn_rois[None], gt_boxes[None]
        gt_classes = gt_classes[None]
        if is_crowd is not None:
            is_crowd = is_crowd[None]
    batch = int(attrs.get("batch_size_per_im", 256))
    fg_th = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    class_nums = int(attrs.get("class_nums", 81))
    use_random = bool(attrs.get("use_random", True))
    is_cascade = bool(attrs.get("is_cascade_rcnn", False))
    is_cls_agnostic = bool(attrs.get("is_cls_agnostic", False))
    weights = [float(v) for v in attrs.get("bbox_reg_weights",
                                           [0.1, 0.1, 0.2, 0.2])]
    N, R, _ = rpn_rois.shape
    G = gt_boxes.shape[1]
    M = G + R
    fg_cap = int(float(attrs.get("fg_fraction", 0.25)) * batch)
    take = min(batch, M)
    dev = rpn_rois.device
    if rois_num_in is None:
        rois_num_in = torch.full((N,), R, dtype=torch.int64, device=dev)
    crowd = is_crowd if is_crowd is not None else torch.zeros_like(
        gt_classes)
    arM = torch.arange(M, device=dev)
    two = torch.full((M,), 2.0, device=dev)
    bidx = torch.arange(batch, device=dev)
    row_ok = bidx < take
    res = {k: [] for k in ("rois", "lbl", "tgt", "w", "n")}
    for i in range(N):
        gt_i, info = gt_boxes[i], im_info[i]
        scale = info[2]
        rois_orig = rpn_rois[i] / scale
        valid_roi = torch.arange(R, device=dev) < rois_num_in.reshape(-1)[i]
        valid_gt = gt_i[:, 2] > gt_i[:, 0]
        if is_cascade:
            valid_gt = torch.zeros_like(valid_gt)
            degen = ((rois_orig[:, 2] - rois_orig[:, 0] + 1 <= 0)
                     | (rois_orig[:, 3] - rois_orig[:, 1] + 1 <= 0))
            valid_roi = valid_roi & ~degen
        allb = torch.cat([gt_i, rois_orig], 0)
        valid = torch.cat([valid_gt, valid_roi])
        iou = iou_xyxy(allb, gt_i, normalized=False)
        iou = torch.where(valid_gt[None, :], iou, torch.zeros_like(iou))
        max_iou, arg = iou.max(dim=1)
        crowd_row = torch.cat([crowd[i].reshape(-1).bool(),
                               torch.zeros((R,), dtype=torch.bool,
                                           device=dev)])
        neg1 = torch.full_like(max_iou, -1.0)
        max_iou = torch.where(crowd_row | ~valid, neg1, max_iou)
        fg = max_iou >= fg_th
        bg = (max_iou >= bg_lo) & (max_iou < bg_hi)
        if is_cascade:
            fg_sel, bg_sel = fg, bg
        else:
            if use_random:
                rf = torch.rand((M,), generator=_gen()).to(dev)
                rb = torch.rand((M,), generator=_gen()).to(dev)
            else:
                rf = rb = arM.float() / M
            fg_sel = fg & (_rank(torch.where(fg, rf, two)) < fg_cap)
            bg_sel = bg & (_rank(torch.where(bg, rb, two))
                           < batch - fg_sel.sum())
        sel = fg_sel | bg_sel
        # fg first, then bg (the reference's order); rows past the
        # candidate pool stay empty
        order_key = torch.where(
            fg_sel, 0.0, torch.where(bg_sel, 1.0, 2.0)) * (M + 1.0) + arM
        order = torch.zeros((batch,), dtype=torch.int64, device=dev)
        order[:take] = torch.argsort(order_key, stable=True)[:take]
        sel_o = sel[order] & row_ok
        # rois back in the scaled image frame (roi_align crops there)
        zero = torch.zeros((), device=dev)
        rois_out = torch.where(sel_o[:, None], allb[order] * scale, zero)
        is_fg_row = fg_sel[order] & row_ok
        lbl = gt_classes[i].reshape(-1).to(torch.int32)[arg[order]]
        lbl = torch.where(is_fg_row & sel_o, lbl, torch.zeros_like(lbl))
        ex, gtm = allb[order], gt_i[arg[order]]
        ex_w = ex[:, 2] - ex[:, 0] + 1.0
        ex_h = ex[:, 3] - ex[:, 1] + 1.0
        gw = gtm[:, 2] - gtm[:, 0] + 1.0
        gh = gtm[:, 3] - gtm[:, 1] + 1.0
        delta = torch.stack([
            ((gtm[:, 0] + 0.5 * gw) - (ex[:, 0] + 0.5 * ex_w)) / ex_w
            / weights[0],
            ((gtm[:, 1] + 0.5 * gh) - (ex[:, 1] + 0.5 * ex_h)) / ex_h
            / weights[1],
            torch.log((gw / ex_w).clamp_min(1e-10)) / weights[2],
            torch.log((gh / ex_h).clamp_min(1e-10)) / weights[3]], dim=1)
        slot = torch.where(is_fg_row,
                           torch.ones_like(lbl) if is_cls_agnostic else lbl,
                           torch.full_like(lbl, class_nums))
        slot = slot.clamp_max(class_nums - 1).long()
        tgt = torch.zeros((batch, class_nums, 4), device=dev)
        tgt[bidx, slot] = torch.where(is_fg_row[:, None], delta, zero)
        w_in = torch.zeros((batch, class_nums, 4), device=dev)
        w_in[bidx, slot] = torch.where(is_fg_row[:, None],
                                       torch.ones((), device=dev), zero)
        res["rois"].append(rois_out)
        res["lbl"].append(lbl[:, None])
        res["tgt"].append(tgt.reshape(batch, -1))
        res["w"].append(w_in.reshape(batch, -1))
        res["n"].append(sel_o.sum())
    st = {k: torch.stack(v) for k, v in res.items()}
    return {"Rois": [st["rois"]], "LabelsInt32": [st["lbl"]],
            "BboxTargets": [st["tgt"]], "BboxInsideWeights": [st["w"]],
            "BboxOutsideWeights": [st["w"]], "RoisNum": [st["n"]]}


# =========================================================================
# RetinaNet detection output
# =========================================================================

@register_op("retinanet_detection_output")
def _retinanet_detection_output(ins, attrs, op):
    """ref detection/retinanet_detection_output_op.cc: per FPN level keep
    the nms_top_k highest (anchor, class) scores above score_threshold
    (the highest level unthresholded), decode them against the level's
    anchors (+1 widths, no variances), clip to the original image; across
    levels one class-aware greedy NMS and keep_top_k detections.
    BBoxes[l] (N, A_l, 4), Scores[l] (N, A_l, C), Anchors[l] (A_l, 4);
    Out (N, keep_top_k, 6) rows [label, score, x1, y1, x2, y2] zero-padded
    (labels 1-based) + RoisNum."""
    bboxes = [b.float() for b in ins.get("BBoxes", [])]
    scores = [s.float() for s in ins.get("Scores", [])]
    anchors = [a.float() for a in ins.get("Anchors", [])]
    im_info = _one(ins, "ImInfo").float()
    score_th = float(attrs.get("score_threshold", 0.05))
    nms_top_k = int(attrs.get("nms_top_k", 1000))
    nms_th = float(attrs.get("nms_threshold", 0.3))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    C = scores[0].shape[-1]
    L = len(bboxes)

    def decode_level(dl, sc, anc, info, threshold):
        k = min(nms_top_k, anc.shape[0] * C)
        flat = sc.reshape(-1)
        flat = torch.where(flat > threshold, flat,
                           torch.full_like(flat, -math.inf))
        idx = _stable_desc(flat)[:k]
        top_sc = flat[idx]
        a, c = idx // C, (idx % C).float()
        anc_s, d = anc[a], dl[a]
        aw = anc_s[:, 2] - anc_s[:, 0] + 1.0
        ah = anc_s[:, 3] - anc_s[:, 1] + 1.0
        cx = d[:, 0] * aw + anc_s[:, 0] + aw / 2
        cy = d[:, 1] * ah + anc_s[:, 1] + ah / 2
        w, h = torch.exp(d[:, 2]) * aw, torch.exp(d[:, 3]) * ah
        box = torch.stack([cx - w / 2, cy - h / 2,
                           cx + w / 2 - 1.0, cy + h / 2 - 1.0], -1) / info[2]
        imh = torch.round(info[0] / info[2])
        imw = torch.round(info[1] / info[2])
        box = torch.minimum(box.clamp_min(0.0),
                            torch.stack([imw - 1, imh - 1, imw - 1,
                                         imh - 1]))
        valid = torch.isfinite(top_sc)
        return box, torch.where(valid, top_sc, torch.zeros_like(top_sc)), \
            c, valid

    outs, counts = [], []
    for i in range(im_info.shape[0]):
        parts = [decode_level(bboxes[li][i], scores[li][i], anchors[li],
                              im_info[i], score_th if li < L - 1 else 0.0)
                 for li in range(L)]
        box = torch.cat([p[0] for p in parts], 0)
        sc = torch.cat([p[1] for p in parts], 0)
        cls = torch.cat([p[2] for p in parts], 0)
        valid = torch.cat([p[3] for p in parts], 0)
        n = box.shape[0]
        order, keep = greedy_nms_mask(box, sc, nms_th, n, class_ids=cls,
                                      valid=valid, normalized=False)
        b_o, s_o, c_o = box[order], sc[order], cls[order]
        ds = torch.where(keep, s_o, torch.zeros_like(s_o))
        kk = min(keep_top_k, n)
        fidx = _stable_desc(ds)[:kk]
        top_sc = ds[fidx]
        out = torch.cat([c_o[fidx][:, None] + 1.0, top_sc[:, None],
                         b_o[fidx]], dim=1)
        ok = top_sc > 0
        out = torch.where(ok[:, None], out, torch.zeros_like(out))
        if kk < keep_top_k:
            out = tF.pad(out, (0, 0, 0, keep_top_k - kk))
        outs.append(out)
        counts.append(ok.sum())
    return {"Out": [torch.stack(outs)], "RoisNum": [torch.stack(counts)]}


# =========================================================================
# RoI perspective transform (EAST-style OCR)
# =========================================================================

@register_op("roi_perspective_transform")
def _roi_perspective_transform(ins, attrs, op):
    """ref detection/roi_perspective_transform_op.cc: warp each quad ROI
    (8 coords, clockwise from top-left) into a (H_t, W_t) grid through the
    quad->rect perspective matrix, sampling the input bilinearly; source
    points outside the quad or the image give 0 with a 0 mask.  ROIs
    (R, 9): [batch_idx, x0 y0 x1 y1 x2 y2 x3 y3] times spatial_scale."""
    x = _one(ins, "X").float()
    rois = _one(ins, "ROIs").float()
    th, tw = int(attrs["transformed_height"]), int(attrs["transformed_width"])
    spatial_scale = float(attrs.get("spatial_scale", 1.0))
    _N, _C, H, W = x.shape
    dev = x.device
    ow = torch.arange(tw, dtype=torch.float32, device=dev)[None, :]
    oh = torch.arange(th, dtype=torch.float32, device=dev)[:, None]
    eps = 1e-4
    outs, masks, mats = [], [], []
    for roi in rois:
        rx, ry = roi[1::2] * spatial_scale, roi[2::2] * spatial_scale
        x0, x1, x2, x3 = rx[0], rx[1], rx[2], rx[3]
        y0, y1, y2, y3 = ry[0], ry[1], ry[2], ry[3]
        len1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
        len2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
        len3 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
        len4 = torch.sqrt((x3 - x0) ** 2 + (y3 - y0) ** 2)
        est_h, est_w = (len2 + len4) / 2.0, (len1 + len3) / 2.0
        norm_h = max(2, th)
        norm_w = torch.clamp_min(torch.clamp_max(torch.round(
            est_w * (norm_h - 1) / est_h.clamp_min(1e-5)) + 1, float(tw)),
            2.0).float()
        dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
        dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
        den = dx1 * dy2 - dx2 * dy1 + 1e-5
        m6 = (dx3 * dy2 - dx2 * dy3) / den / (norm_w - 1)
        m7 = (dx1 * dy3 - dx3 * dy1) / den / (norm_h - 1)
        m8 = torch.ones((), device=dev)
        m3 = (y1 - y0 + m6 * (norm_w - 1) * y1) / (norm_w - 1)
        m4 = (y3 - y0 + m7 * (norm_h - 1) * y3) / (norm_h - 1)
        m0 = (x1 - x0 + m6 * (norm_w - 1) * x1) / (norm_w - 1)
        m1 = (x3 - x0 + m7 * (norm_h - 1) * x3) / (norm_h - 1)
        m2, m5 = x0, y0
        mats.append(torch.stack([m0, m1, m2, m3, m4, m5, m6, m7, m8]))
        wq = m6 * ow + m7 * oh + m8
        in_w = (m0 * ow + m1 * oh + m2) / wq
        in_h = (m3 * ow + m4 * oh + m5) / wq
        # in_quad: on an edge, or an odd ray-crossing count (the
        # kernel's 1e-4 comparators)
        on_edge = torch.zeros_like(in_w, dtype=torch.bool)
        n_cross = torch.zeros_like(in_w, dtype=torch.int32)
        for i in range(4):
            xs, ys = rx[i], ry[i]
            xe, ye = rx[(i + 1) % 4], ry[(i + 1) % 4]
            horiz = (ys - ye).abs() < eps
            on_h = (horiz & ((in_h - ys).abs() < eps)
                    & ((in_h - ye).abs() < eps)
                    & (in_w > torch.minimum(xs, xe) - eps)
                    & (in_w < torch.maximum(xs, xe) + eps))
            ix = (in_h - ys) * (xe - xs) / torch.where(
                horiz, torch.ones((), device=dev), ye - ys) + xs
            on_e = (~horiz & ((ix - in_w).abs() < eps)
                    & (in_h > torch.minimum(ys, ye) - eps)
                    & (in_h < torch.maximum(ys, ye) + eps))
            on_edge = on_edge | on_h | on_e
            in_band = (~horiz & ~(in_h < torch.minimum(ys, ye) + eps)
                       & ~(in_h > torch.maximum(ys, ye) + eps))
            n_cross = n_cross + (in_band & (ix - in_w > eps)).to(torch.int32)
        in_roi = on_edge | (n_cross % 2 == 1)
        # the image band is strict here: this kernel's bilinear
        # interpolation uses GT_E comparators
        inside = (in_roi & (in_w > -0.5) & (in_w < W - 0.5)
                  & (in_h > -0.5) & (in_h < H - 0.5))
        iw, ih = in_w.clamp(0.0, W - 1.0), in_h.clamp(0.0, H - 1.0)
        w0, h0 = torch.floor(iw).long(), torch.floor(ih).long()
        w1, h1 = (w0 + 1).clamp_max(W - 1), (h0 + 1).clamp_max(H - 1)
        fw, fh = iw - w0, ih - h0
        feat = x[int(roi[0])]
        val = (feat[:, h0, w0] * ((1 - fh) * (1 - fw))[None]
               + feat[:, h0, w1] * ((1 - fh) * fw)[None]
               + feat[:, h1, w0] * (fh * (1 - fw))[None]
               + feat[:, h1, w1] * (fh * fw)[None])
        outs.append(torch.where(inside[None], val, torch.zeros((),
                                                                device=dev)))
        masks.append(inside.to(torch.int32)[None])
    return {"Out": [torch.stack(outs)], "Mask": [torch.stack(masks)],
            "TransformMatrix": [torch.stack(mats)],
            "Out2InIdx": [torch.zeros((1,), dtype=torch.int32, device=dev)],
            "Out2InWeights": [torch.zeros((1,), device=dev)]}
