"""Detection / vision ops (counterpart of paddle_tpu/ops/vision.py; ref
paddle/fluid/operators/detection/: iou_similarity, box_coder, box_clip,
anchor_generator, prior_box, density_prior_box, yolo_box, yolov3_loss,
multiclass_nms, roi_align, deformable_conv, psroi_pool).

Plain torch compositions, as they are jnp / lax ones in the JAX package (no
Pallas kernel lies behind them).  The JAX package's static-shape contract
is kept: fixed-size padded outputs plus a valid count where the reference
returns ragged lists (``multiclass_nms`` gives ``(dets[keep_top_k, 6],
num_valid)``, padding rows with label -1), and RoIAlign samples a fixed
grid.

Where the JAX package maps a function over classes or images
(``jax.vmap``), the port batches those dims into every tensor op instead:
greedy NMS is one loop over candidate positions whose every iteration
covers all images and classes at once, never a Python loop over classes
or images.  Ops that create boxes from sizes alone (``anchor_generator``,
``prior_box``, ``density_prior_box``) build them on the current device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..core.device import resolve_device
from ._util import as_tensor

__all__ = [
    "iou_similarity", "box_coder", "box_clip", "anchor_generator",
    "prior_box", "yolo_box", "yolo_loss", "multiclass_nms", "roi_align",
    "density_prior_box", "deformable_conv", "psroi_pool",
]


# ------------------------------------------------------------------- boxes --
def _iou(x, y, off, eps):
    """IoU of x [..., N, 4] against y [..., M, 4] -> [..., N, M]."""
    area_x = (x[..., 2] - x[..., 0] + off) * (x[..., 3] - x[..., 1] + off)
    area_y = (y[..., 2] - y[..., 0] + off) * (y[..., 3] - y[..., 1] + off)
    lt = torch.maximum(x[..., :, None, :2], y[..., None, :, :2])
    rb = torch.minimum(x[..., :, None, 2:], y[..., None, :, 2:])
    wh = torch.clamp(rb - lt + off, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_x[..., :, None] + area_y[..., None, :]
                               - inter, min=eps)


def iou_similarity(x, y, box_normalized: bool = True, eps: float = 1e-10):
    """Pairwise IoU between two box sets (ref iou_similarity_op.cc).

    x: [N, 4], y: [M, 4] in (x1, y1, x2, y2). Returns [N, M]; +1 on the
    extents of integer-coordinate (not normalized) boxes, as the reference.
    """
    x = as_tensor(x)
    y = as_tensor(y, like=x)
    return _iou(x, y, 0.0 if box_normalized else 1.0, eps)


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True, axis: int = 0):
    """Encode / decode boxes against priors (ref box_coder_op.cc).

    encode: target [N, 4] vs priors [M, 4] -> [N, M, 4] offsets.
    decode: target [N, M, 4] (or [N, 4] broadcast) offsets -> boxes
    [N, M, 4].  prior_box_var: None | [M, 4] | 4-list of floats.
    """
    target_box = as_tensor(target_box)
    prior_box = as_tensor(prior_box, like=target_box)
    off = 0.0 if box_normalized else 1.0
    pw = prior_box[:, 2] - prior_box[:, 0] + off
    ph = prior_box[:, 3] - prior_box[:, 1] + off
    pcx = prior_box[:, 0] + 0.5 * pw
    pcy = prior_box[:, 1] + 0.5 * ph
    if prior_box_var is None:
        var = torch.ones((4,), dtype=target_box.dtype,
                         device=target_box.device).expand(prior_box.shape)
    else:
        var = torch.as_tensor(prior_box_var, dtype=target_box.dtype,
                              device=target_box.device)
        if var.dim() == 1:
            var = var[None, :].expand(prior_box.shape)

    if code_type == "encode_center_size":
        tw = target_box[:, 2] - target_box[:, 0] + off
        th = target_box[:, 3] - target_box[:, 1] + off
        tcx = target_box[:, 0] + 0.5 * tw
        tcy = target_box[:, 1] + 0.5 * th
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        dw = torch.log(torch.abs(tw[:, None] / pw[None, :]))
        dh = torch.log(torch.abs(th[:, None] / ph[None, :]))
        out = torch.stack([dx, dy, dw, dh], dim=-1)
        return out / var[None, :, :]
    if code_type == "decode_center_size":
        if target_box.dim() == 2:
            target_box = target_box[:, None, :]
        # ref box_coder_op.h:138 -- axis 0: priors indexed by the column
        # dim; axis 1: by the row dim
        expect = target_box.shape[1] if axis == 0 else target_box.shape[0]
        if prior_box.shape[0] != expect:
            raise ValueError(
                f"decode with axis={axis} needs {expect} priors (target dim "
                f"{1 if axis == 0 else 0} of {tuple(target_box.shape)}); "
                f"got {prior_box.shape[0]}")
        if axis == 0:
            t = target_box * var[None, :, :]
            pw_b, ph_b, pcx_b, pcy_b = (v[None, :]
                                        for v in (pw, ph, pcx, pcy))
        else:
            t = target_box * var[:, None, :]
            pw_b, ph_b, pcx_b, pcy_b = (v[:, None]
                                        for v in (pw, ph, pcx, pcy))
        cx = t[..., 0] * pw_b + pcx_b
        cy = t[..., 1] * ph_b + pcy_b
        w = torch.exp(t[..., 2]) * pw_b
        h = torch.exp(t[..., 3]) * ph_b
        return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                            cx + 0.5 * w - off, cy + 0.5 * h - off], dim=-1)
    raise ValueError(f"unknown code_type {code_type!r}")


def box_clip(input, im_info):
    """Clip boxes to image bounds (ref box_clip_op.cc).  input: [..., 4];
    im_info: (h, w), read as ``im_info[0]`` and ``im_info[1]`` as the JAX
    package does."""
    input = as_tensor(input)
    h, w = (torch.as_tensor(v, dtype=input.dtype, device=input.device)
            for v in (im_info[0], im_info[1]))

    def clip(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi - 1)

    return torch.stack([clip(input[..., 0], w), clip(input[..., 1], h),
                        clip(input[..., 2], w), clip(input[..., 3], h)],
                       dim=-1)


# ----------------------------------------------------------------- anchors --
def _grid(n, offset, step, dev):
    return (torch.arange(n, dtype=torch.float32, device=dev) + offset) * step


def _corners(cx, cy, ws, hs):
    """Boxes [H, W, P, 4] centred on the (H, W) grid of cx / cy (each
    [..., P] after broadcasting), of widths ws and heights hs."""
    return torch.stack([cx - 0.5 * ws, cy - 0.5 * hs,
                        cx + 0.5 * ws, cy + 0.5 * hs], dim=-1)


def anchor_generator(feature_hw: Tuple[int, int],
                     anchor_sizes: Sequence[float] = (64., 128., 256., 512.),
                     aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                     stride: Sequence[float] = (16., 16.),
                     variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                     offset: float = 0.5):
    """RPN-style anchors (ref anchor_generator_op.cc).

    Returns (anchors [H, W, A, 4] xyxy in input-image coords,
             variances [H, W, A, 4]); A = len(sizes) * len(ratios), ratio
    major as in the reference's loops.
    """
    dev = resolve_device()
    H, W = feature_hw
    sizes = torch.as_tensor(anchor_sizes, dtype=torch.float32, device=dev)
    ratios = torch.as_tensor(aspect_ratios, dtype=torch.float32, device=dev)
    r = torch.repeat_interleave(ratios, sizes.shape[0])
    s = sizes.repeat(ratios.shape[0])
    aw = s / torch.sqrt(r)
    ah = s * torch.sqrt(r)
    cxg, cyg = torch.meshgrid(_grid(W, offset, stride[0], dev),
                              _grid(H, offset, stride[1], dev),
                              indexing="xy")
    anchors = _corners(cxg[..., None], cyg[..., None], aw, ah)
    var = torch.as_tensor(variances, dtype=torch.float32,
                          device=dev).expand(anchors.shape)
    return anchors, var


def expand_aspect_ratios(aspect_ratios, flip: bool):
    """ref prior_box_op.cc ExpandAspectRatios: 1.0 always first, near-
    duplicates (within 1e-6) dropped, flip appends reciprocals (also
    deduped)."""
    out = [1.0]

    def _add(v):
        if all(abs(v - e) > 1e-6 for e in out):
            out.append(v)

    for a in aspect_ratios:
        _add(float(a))
        if flip:
            _add(1.0 / float(a))
    return out


def _cell_centres(feature_hw, image_hw, steps, offset, dev):
    """The (H, W) grid of cell centres, normalized, and the steps."""
    H, W = feature_hw
    img_h, img_w = image_hw
    step_w = steps[0] or img_w / W
    step_h = steps[1] or img_h / H
    cxg, cyg = torch.meshgrid(_grid(W, offset, step_w, dev) / img_w,
                              _grid(H, offset, step_h, dev) / img_h,
                              indexing="xy")
    return cxg, cyg, step_w, step_h


def prior_box(feature_hw: Tuple[int, int], image_hw: Tuple[int, int],
              min_sizes: Sequence[float], max_sizes: Sequence[float] = (),
              aspect_ratios: Sequence[float] = (1.0,), flip: bool = False,
              clip: bool = False, steps: Sequence[float] = (0.0, 0.0),
              offset: float = 0.5,
              variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2)):
    """SSD prior boxes (ref prior_box_op.cc / layers/detection.py).

    Returns (boxes [H, W, P, 4] normalized xyxy, variances [H, W, P, 4]).
    """
    dev = resolve_device()
    img_h, img_w = image_hw
    ratios = expand_aspect_ratios(aspect_ratios, flip)
    if max_sizes and len(max_sizes) != len(min_sizes):
        raise ValueError("max_sizes must pair 1:1 with min_sizes "
                         f"(got {len(max_sizes)} vs {len(min_sizes)})")
    ws, hs = [], []
    for i, ms in enumerate(min_sizes):
        for ar in ratios:
            ws.append(ms * (ar ** 0.5))
            hs.append(ms / (ar ** 0.5))
        if max_sizes:  # ref: one extra sqrt(min * max) prior per min size
            ws.append((ms * max_sizes[i]) ** 0.5)
            hs.append((ms * max_sizes[i]) ** 0.5)
    ws = torch.tensor(ws, dtype=torch.float32, device=dev) / img_w
    hs = torch.tensor(hs, dtype=torch.float32, device=dev) / img_h
    cxg, cyg, _, _ = _cell_centres(feature_hw, image_hw, steps, offset, dev)
    boxes = _corners(cxg[..., None], cyg[..., None], ws, hs)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.as_tensor(variances, dtype=torch.float32,
                          device=dev).expand(boxes.shape)
    return boxes, var


# -------------------------------------------------------------------- yolo --
def _yolo_grid(x, anchors, class_num, downsample_ratio, scale_x_y):
    """Shared decode of the YOLO head tensor x [N, A * (5 + C), H, W]."""
    N, CC, H, W = x.shape
    A = len(anchors) // 2
    C = class_num
    if CC != A * (5 + C):
        raise ValueError(
            f"yolo head has {CC} channels but {len(anchors) // 2} anchors x "
            f"(5+{C}) classes needs {A * (5 + C)}")
    x = x.reshape(N, A, 5 + C, H, W)
    anc = torch.as_tensor(anchors, dtype=torch.float32,
                          device=x.device).reshape(A, 2)
    gxg, gyg = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=x.device),
        torch.arange(H, dtype=torch.float32, device=x.device),
        indexing="xy")                                       # [H, W]
    bias = 0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(x[:, :, 0]) * scale_x_y - bias + gxg) / W
    cy = (torch.sigmoid(x[:, :, 1]) * scale_x_y - bias + gyg) / H
    input_w = downsample_ratio * W
    input_h = downsample_ratio * H
    bw = torch.exp(x[:, :, 2]) * anc[None, :, 0, None, None] / input_w
    bh = torch.exp(x[:, :, 3]) * anc[None, :, 1, None, None] / input_h
    obj = torch.sigmoid(x[:, :, 4])
    cls = torch.sigmoid(x[:, :, 5:])                          # [N, A, C, H, W]
    return cx, cy, bw, bh, obj, cls


def yolo_box(x, img_size, anchors: Sequence[int], class_num: int,
             conf_thresh: float = 0.01, downsample_ratio: int = 32,
             clip_bbox: bool = True, scale_x_y: float = 1.0):
    """Decode one YOLO head to boxes and scores (ref yolo_box_op.cc).

    x: [N, A * (5 + C), H, W]; img_size: [N, 2] (h, w).
    Returns (boxes [N, A * H * W, 4] xyxy in image coords,
             scores [N, A * H * W, C]); rows under ``conf_thresh`` are
    zeroed (the static-shape stand-in for the reference's filtering).
    """
    x = as_tensor(x)
    img_size = as_tensor(img_size, like=x)
    N, _, H, W = x.shape
    cx, cy, bw, bh, obj, cls = _yolo_grid(x, anchors, class_num,
                                          downsample_ratio, scale_x_y)
    img_h = img_size[:, 0].to(torch.float32)[:, None, None, None]
    img_w = img_size[:, 1].to(torch.float32)[:, None, None, None]
    x1 = (cx - bw / 2) * img_w
    y1 = (cy - bh / 2) * img_h
    x2 = (cx + bw / 2) * img_w
    y2 = (cy + bh / 2) * img_h
    if clip_bbox:
        x1 = torch.minimum(torch.clamp(x1, min=0.0), img_w - 1)
        y1 = torch.minimum(torch.clamp(y1, min=0.0), img_h - 1)
        x2 = torch.minimum(torch.clamp(x2, min=0.0), img_w - 1)
        y2 = torch.minimum(torch.clamp(y2, min=0.0), img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)             # [N, A, H, W, 4]
    conf = obj[..., None]                                     # [N, A, H, W, 1]
    scores = cls.permute(0, 1, 3, 4, 2) * conf                # [N, A, H, W, C]
    keep = (conf > conf_thresh).to(boxes.dtype)
    boxes = boxes * keep
    scores = scores * keep
    M = boxes.shape[1] * H * W
    return boxes.reshape(N, M, 4), scores.reshape(N, M, class_num)


def _bce(logit, target):
    """BCE with logits as the JAX package writes it; ``torch.maximum``
    splits the gradient at a tie as ``jnp.maximum`` does."""
    return (torch.maximum(logit, torch.zeros_like(logit)) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def yolo_loss(x, gt_box, gt_label, anchors: Sequence[int],
              anchor_mask: Sequence[int], class_num: int,
              ignore_thresh: float = 0.7, downsample_ratio: int = 32,
              gt_score=None, use_label_smooth: bool = False,
              scale_x_y: float = 1.0):
    """YOLOv3 training loss for one head (ref yolov3_loss_op.cc / .h).

    x: [N, len(mask) * (5 + C), H, W]; gt_box: [N, B, 4] (cx, cy, w, h,
    normalized to [0, 1]); gt_label: [N, B] int; rows with w <= 0 are
    padding.  Returns the per-image loss [N], in fp32 whatever x's dtype.

    A gt's responsible anchor is the global-argmax-IoU anchor over ALL
    anchors (shape-only IoU); the gt counts at this head only if that
    anchor is in ``anchor_mask``.  Objectness of unmatched predictions is
    trained toward 0 except where their IoU with any gt exceeds
    ``ignore_thresh``.  Targets are dense tensors written by scatters;
    where two gts of an image land on one (anchor, cell), the later gt's
    targets are written, as the JAX package's sequential scatter leaves
    them (the class targets of both are set), so the result does not
    depend on the order a device applies the writes in.
    """
    x = as_tensor(x).to(torch.float32)
    dev = x.device
    gt_box = as_tensor(gt_box, like=x).to(device=dev, dtype=torch.float32)
    gt_label = as_tensor(gt_label, like=x).to(dev)
    N, _, H, W = x.shape
    mask = [int(m) for m in anchor_mask]
    A = len(mask)
    C = class_num
    xr = x.reshape(N, A, 5 + C, H, W)
    anc_all = torch.as_tensor(anchors, dtype=torch.float32,
                              device=dev).reshape(-1, 2)
    mask_arr = torch.as_tensor(mask, device=dev)
    anc = anc_all[mask_arr]
    input_w = float(downsample_ratio * W)
    input_h = float(downsample_ratio * H)
    B = gt_box.shape[1]
    valid = gt_box[:, :, 2] > 0                               # [N, B]
    if gt_score is None:
        gt_score = valid.to(torch.float32)
    else:
        gt_score = as_tensor(gt_score, like=x).to(
            device=dev, dtype=torch.float32) * valid

    # ---- responsible-anchor assignment (shape-only IoU, centred boxes) ----
    gw = gt_box[:, :, 2] * input_w                            # pixels
    gh = gt_box[:, :, 3] * input_h
    inter = (torch.minimum(gw[..., None], anc_all[None, None, :, 0])
             * torch.minimum(gh[..., None], anc_all[None, None, :, 1]))
    union = gw[..., None] * gh[..., None] + \
        anc_all[None, None, :, 0] * anc_all[None, None, :, 1] - inter
    best_anchor = torch.argmax(inter / torch.clamp(union, min=1e-10), dim=-1)
    in_head = best_anchor[..., None] == mask_arr[None, None, :]  # [N, B, A]
    local_anchor = torch.argmax(in_head.to(torch.int32), dim=-1)
    assigned = valid & in_head.any(dim=-1)                    # [N, B]

    gi = torch.clamp((gt_box[:, :, 0] * W).to(torch.int64), 0, W - 1)
    gj = torch.clamp((gt_box[:, :, 1] * H).to(torch.int64), 0, H - 1)

    tx = gt_box[:, :, 0] * W - gi
    ty = gt_box[:, :, 1] * H - gj
    la = anc[local_anchor]                                    # [N, B, 2]
    tw = torch.log(torch.clamp(gw / torch.clamp(la[..., 0], min=1e-6),
                               min=1e-9))
    th = torch.log(torch.clamp(gh / torch.clamp(la[..., 1], min=1e-6),
                               min=1e-9))
    box_scale = 2.0 - gt_box[:, :, 2] * gt_box[:, :, 3]      # small boxes up

    # one flat cell index a gt; unassigned rows and rows a later assigned
    # gt of the image overwrites go to a dump slot past the end
    bidx = torch.arange(N, device=dev)[:, None]
    cell = ((bidx * A + local_anchor) * H + gj) * W + gi      # [N, B]
    later = torch.triu(torch.ones(B, B, dtype=torch.bool, device=dev), 1)
    overwritten = ((cell[:, :, None] == cell[:, None, :]) & later[None]
                   & assigned[:, None, :]).any(dim=-1)
    dump = N * A * H * W
    slot = torch.where(assigned & ~overwritten, cell, dump).reshape(-1)

    def scat(vals):
        t = torch.zeros(dump + 1, dtype=torch.float32, device=dev)
        t[slot] = vals.reshape(-1).to(torch.float32)
        return t[:dump].reshape(N, A, H, W)

    obj_mask = scat(gt_score)                                 # positive weight
    t_x, t_y = scat(tx), scat(ty)
    t_w, t_h = scat(tw), scat(th)
    t_scale = scat(box_scale)
    # class targets straight in the head's (N, A, C, H, W) layout; a gt
    # sets its own class whatever other gts do at its cell
    cls_idx = torch.clamp(gt_label.to(torch.int64), 0, C - 1)
    cls_dump = N * A * C * H * W
    cls_slot = torch.where(
        assigned, (((bidx * A + local_anchor) * C + cls_idx) * H + gj) * W
        + gi, cls_dump).reshape(-1)
    t_cls = torch.zeros(cls_dump + 1, dtype=torch.float32, device=dev)
    t_cls[cls_slot] = 1.0
    t_cls = t_cls[:cls_dump].reshape(N, A, C, H, W)

    # ---- ignore mask: predictions overlapping any gt beyond thresh ----
    masked_anchors = [float(v) for i in mask
                      for v in (anchors[2 * i], anchors[2 * i + 1])]
    cx, cy, bw, bh, _, _ = _yolo_grid(x, masked_anchors, C,
                                      downsample_ratio, scale_x_y)
    pb = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    gb = torch.stack([gt_box[:, :, 0] - gt_box[:, :, 2] / 2,
                      gt_box[:, :, 1] - gt_box[:, :, 3] / 2,
                      gt_box[:, :, 0] + gt_box[:, :, 2] / 2,
                      gt_box[:, :, 1] + gt_box[:, :, 3] / 2], -1)  # [N, B, 4]
    ious = _iou(pb.reshape(N, -1, 4), gb, 0.0, 1e-10)         # [N, AHW, B]
    ious = torch.where(valid[:, None, :], ious, 0.0)
    best_iou = ious.amax(dim=-1).reshape(N, A, H, W)
    ignore = (best_iou > ignore_thresh) & (obj_mask <= 0)

    # ---- loss terms: BCE with logits as the reference, all fp32 ----
    obj = obj_mask
    lx = _bce(xr[:, :, 0], t_x) * t_scale * obj
    ly = _bce(xr[:, :, 1], t_y) * t_scale * obj
    lw = torch.abs(xr[:, :, 2] - t_w) * t_scale * obj
    lh = torch.abs(xr[:, :, 3] - t_h) * t_scale * obj
    pos = _bce(xr[:, :, 4], torch.ones_like(obj)) * obj
    neg = _bce(xr[:, :, 4], torch.zeros_like(obj)) * \
        ((obj_mask <= 0) & ~ignore).to(torch.float32)
    if use_label_smooth:
        smooth = 1.0 / max(C, 1)
        t_cls = t_cls * (1 - 2 * smooth) + smooth
    lcls = (_bce(xr[:, :, 5:], t_cls) * obj[:, :, None]).sum(dim=2)
    return (lx + ly + lw + lh + pos + neg).sum(dim=(1, 2, 3)) + \
        lcls.sum(dim=(1, 2, 3))


# --------------------------------------------------------------------- nms --
def _nms(boxes, scores, iou_threshold, score_threshold, top_k, normalized):
    """Greedy NMS over the ``top_k`` highest-scoring candidates of every
    leading index at once: boxes [..., M, 4], scores [..., M].  Returns
    (keep [..., top_k] bool, order [..., top_k] indices into M).

    Candidate i is kept when its score passes ``score_threshold`` and no
    kept candidate before it overlaps it beyond ``iou_threshold``: one
    loop over the ``top_k`` positions, each step covering every leading
    index.  The order is a stable descending sort, as ``jnp.argsort`` of
    the negated scores."""
    order = torch.sort(-scores, dim=-1, stable=True).indices[..., :top_k]
    b = torch.gather(boxes, -2, order[..., None].expand(
        *order.shape, 4))
    s = torch.gather(scores, -1, order)
    K = order.shape[-1]
    earlier = torch.tril(torch.ones(K, K, dtype=torch.bool,
                                    device=scores.device), -1)
    over = (_iou(b, b, 0.0 if normalized else 1.0, 1e-10)
            > iou_threshold) & earlier
    passes = s > score_threshold
    keep = passes.clone()
    for i in range(K):
        suppressed = (over[..., i, :] & keep).any(dim=-1)
        keep[..., i] = passes[..., i] & ~suppressed
    return keep, order


def _multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold, normalized, background_label):
    """``multiclass_nms`` over a leading batch dim: bboxes [N, M, 4] or
    [N, M, C, 4], scores [N, C, M] -> (dets [N, keep_top_k, 6],
    num_valid [N] int32)."""
    N, C, M = scores.shape
    top_k = min(nms_top_k, M)
    if bboxes.dim() == 3:
        per_class_boxes = bboxes[:, None].expand(N, C, M, 4)
    else:
        per_class_boxes = bboxes.permute(0, 2, 1, 3)          # [N, C, M, 4]
    keep, order = _nms(per_class_boxes, scores, nms_threshold,
                       score_threshold, top_k, normalized)
    cls_ids = torch.arange(C, device=scores.device)[:, None].expand(C, top_k)
    sel_scores = torch.gather(scores, 2, order)               # [N, C, top_k]
    sel_boxes = torch.gather(per_class_boxes, 2,
                             order[..., None].expand(N, C, top_k, 4))
    if background_label >= 0:
        keep = keep & (cls_ids != background_label)
    flat_scores = torch.where(keep, sel_scores,
                              float("-inf")).reshape(N, -1)
    flat_boxes = sel_boxes.reshape(N, -1, 4)
    flat_cls = cls_ids.reshape(-1)
    k = min(keep_top_k, flat_scores.shape[1])
    srt = torch.sort(flat_scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = srt.values[:, :k], srt.indices[:, :k]
    out_valid = torch.isfinite(top_scores)
    label = torch.where(out_valid, flat_cls[top_idx], -1).to(torch.float32)
    dets = torch.cat([
        label[..., None],
        torch.where(out_valid, top_scores, 0.0)[..., None],
        torch.where(out_valid[..., None],
                    torch.gather(flat_boxes, 1,
                                 top_idx[..., None].expand(N, k, 4)), 0.0),
    ], dim=-1)
    if k < keep_top_k:
        pad = torch.zeros((N, keep_top_k - k, 6), dtype=dets.dtype,
                          device=dets.device)
        pad[..., 0] = -1.0
        dets = torch.cat([dets, pad], dim=1)
    return dets, out_valid.sum(dim=1).to(torch.int32)


def multiclass_nms(bboxes, scores, score_threshold: float = 0.05,
                   nms_top_k: int = 400, keep_top_k: int = 100,
                   nms_threshold: float = 0.45, normalized: bool = True,
                   background_label: int = -1):
    """Per-class NMS (ref multiclass_nms_op.cc), single image.

    bboxes: [M, 4] (shared across classes) or [M, C, 4]; scores: [C, M].
    Returns (dets [keep_top_k, 6] = (label, score, x1, y1, x2, y2) sorted
    by score, padded with label -1, and num_valid, an int32 scalar).
    """
    scores = as_tensor(scores)
    bboxes = as_tensor(bboxes, like=scores)
    dets, num = _multiclass_nms(bboxes[None], scores[None], score_threshold,
                                nms_top_k, keep_top_k, nms_threshold,
                                normalized, background_label)
    return dets[0], num[0]


# --------------------------------------------------------------- roi align --
def roi_align(input, rois, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = False):
    """RoIAlign (ref roi_align_op.cc / .cu), batch-size-1 feature map.

    input: [C, H, W]; rois: [R, 4] xyxy in input-image coords.  Returns
    [R, C, out_h, out_w]: bilinear samples on a fixed grid, averaged per
    bin, samples outside [-1, H] x [-1, W] counting zero.

    As in the JAX package, ``sampling_ratio=-1`` samples a fixed 2 x 2 per
    bin, where the reference derives ceil(roi_h / pooled_h) samples per
    ROI: outputs differ from the reference for ROIs larger than twice the
    output grid; pass an explicit ``sampling_ratio`` where that matters.
    """
    input = as_tensor(input)
    rois = as_tensor(rois, like=input).to(device=input.device,
                                          dtype=torch.float32)
    C, H, W = input.shape
    R = rois.shape[0]
    if isinstance(output_size, int):
        out_h = out_w = output_size
    else:
        out_h, out_w = output_size
    ratio = sampling_ratio if sampling_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    box = rois * spatial_scale - off
    x1, y1, x2, y2 = box[:, 0], box[:, 1], box[:, 2], box[:, 3]
    floor = 1e-6 if aligned else 1.0
    bin_w = torch.clamp(x2 - x1, min=floor) / out_w
    bin_h = torch.clamp(y2 - y1, min=floor) / out_h
    dev = input.device
    sy = y1[:, None] + (torch.arange(out_h * ratio, device=dev) + 0.5) \
        * bin_h[:, None] / ratio                              # [R, oh r]
    sx = x1[:, None] + (torch.arange(out_w * ratio, device=dev) + 0.5) \
        * bin_w[:, None] / ratio                              # [R, ow r]
    yy = sy[:, :, None].expand(R, out_h * ratio, out_w * ratio)
    xx = sx[:, None, :].expand(R, out_h * ratio, out_w * ratio)
    in_img = (yy >= -1.0) & (yy <= H) & (xx >= -1.0) & (xx <= W)
    yy_c = torch.clamp(yy, 0.0, H - 1)
    xx_c = torch.clamp(xx, 0.0, W - 1)
    y0 = torch.floor(yy_c)
    x0 = torch.floor(xx_c)
    y1i = torch.clamp(y0 + 1, 0, H - 1).to(torch.int64)
    x1i = torch.clamp(x0 + 1, 0, W - 1).to(torch.int64)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    ly = torch.clamp(yy_c - y0, 0.0, 1.0)
    lx = torch.clamp(xx_c - x0, 0.0, 1.0)
    v = (input[:, y0i, x0i] * ((1 - ly) * (1 - lx))
         + input[:, y0i, x1i] * ((1 - ly) * lx)
         + input[:, y1i, x0i] * (ly * (1 - lx))
         + input[:, y1i, x1i] * (ly * lx))                    # [C, R, ...]
    v = torch.where(in_img, v, 0.0).transpose(0, 1)
    return v.reshape(R, C, out_h, ratio, out_w, ratio).mean(dim=(3, 5))


def density_prior_box(feature_hw, image_hw, densities, fixed_sizes,
                      fixed_ratios=(1.0,), clip: bool = False,
                      steps=(0.0, 0.0), offset: float = 0.5,
                      variances=(0.1, 0.1, 0.2, 0.2), flatten_to_2d=False):
    """Density prior boxes (ref density_prior_box_op.cc): per (density d,
    fixed_size s, ratio r), a d x d grid of shifted centres inside each
    feature cell carrying an s sqrt(r) x s / sqrt(r) box.

    Returns (boxes [H, W, P, 4] normalized xyxy, variances [...]) or the
    flattened (N, 4) pair when ``flatten_to_2d``.
    """
    dev = resolve_device()
    img_h, img_w = image_hw
    if len(densities) != len(fixed_sizes):
        raise ValueError("densities must pair 1:1 with fixed_sizes")
    ws, hs, sx, sy = [], [], [], []
    for dens, size in zip(densities, fixed_sizes):
        for ratio in fixed_ratios:
            bw = size * (ratio ** 0.5)
            bh = size / (ratio ** 0.5)
            shift = 1.0 / dens
            for di in range(dens):
                for dj in range(dens):
                    # centre shift within the cell, in step units
                    sx.append((dj + 0.5) * shift - 0.5)
                    sy.append((di + 0.5) * shift - 0.5)
                    ws.append(bw)
                    hs.append(bh)
    cxg, cyg, step_w, step_h = _cell_centres(feature_hw, image_hw, steps,
                                             offset, dev)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    ws, hs = f32(ws) / img_w, f32(hs) / img_h
    sx = f32(sx) * step_w / img_w
    sy = f32(sy) * step_h / img_h
    boxes = _corners(cxg[..., None] + sx, cyg[..., None] + sy, ws, hs)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.as_tensor(variances, dtype=torch.float32,
                          device=dev).expand(boxes.shape)
    if flatten_to_2d:
        return boxes.reshape(-1, 4), var.reshape(-1, 4)
    return boxes, var


def _bilinear_sample(x, ys, xs):
    """Bilinear samples of x (N, G, Cg, H, W) at float coords ys / xs
    (N, G, L); zero outside.  Returns (N, G, Cg, L)."""
    N, G, Cg, H, W = x.shape
    flat = x.reshape(N, G, Cg, H * W)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    out = 0.0
    for dy, wgt_y in ((0, 1.0 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1.0 - wx), (1, wx)):
            yy = y0 + dy
            xx = x0 + dx
            inb = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            yc = torch.clamp(yy, 0, H - 1).to(torch.int64)
            xc = torch.clamp(xx, 0, W - 1).to(torch.int64)
            idx = (yc * W + xc)[:, :, None, :].expand(N, G, Cg, -1)
            v = torch.gather(flat, 3, idx)
            w = torch.where(inb, wgt_y * wgt_x, 0.0)[:, :, None, :]
            out = out + v * w
    return out


def deformable_conv(x, offset, weight, mask=None, stride=1, padding=0,
                    dilation=1, groups: int = 1, deformable_groups: int = 1,
                    bias=None):
    """Deformable convolution v2 (v1 when ``mask`` is None; ref
    deformable_conv_op.cu / deformable_conv_v1_op.cu): the offset-shifted
    bilinear samples gathered into an im2col tensor, then one product.

    Shapes: x (N, C, H, W); offset (N, 2 dg kh kw, Ho, Wo);
    mask (N, dg kh kw, Ho, Wo); weight (out_c, C / groups, kh, kw).
    """
    x = as_tensor(x)
    offset = as_tensor(offset, like=x)
    weight = as_tensor(weight, like=x)
    N, C, H, W = x.shape
    out_c, cpg, kh, kw = weight.shape
    sh, sw = (stride, stride) if isinstance(stride, int) else tuple(stride)
    ph, pw = (padding, padding) if isinstance(padding, int) \
        else tuple(padding)
    dh, dw = (dilation, dilation) if isinstance(dilation, int) \
        else tuple(dilation)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = deformable_groups
    K = kh * kw
    dev = x.device

    def f32(n, step, start):
        return (torch.arange(n, device=dev) * step - start).to(torch.float32)

    base_y = (f32(Ho, sh, ph)[:, None, None, None]
              + f32(kh, dh, 0)[None, None, :, None])          # Ho, 1, kh, 1
    base_x = (f32(Wo, sw, pw)[None, :, None, None]
              + f32(kw, dw, 0)[None, None, None, :])          # 1, Wo, 1, kw
    base_y = base_y.expand(Ho, Wo, kh, kw).reshape(Ho, Wo, K)
    base_x = base_x.expand(Ho, Wo, kh, kw).reshape(Ho, Wo, K)

    off = offset.reshape(N, dg, K, 2, Ho, Wo)
    # N, dg, Ho, Wo, K
    ys = base_y + off[:, :, :, 0].permute(0, 1, 3, 4, 2)
    xs = base_x + off[:, :, :, 1].permute(0, 1, 3, 4, 2)
    cols = _bilinear_sample(x.reshape(N, dg, C // dg, H, W),
                            ys.reshape(N, dg, -1), xs.reshape(N, dg, -1))
    cols = cols.reshape(N, dg, C // dg, Ho, Wo, K)
    if mask is not None:
        m = as_tensor(mask, like=x).reshape(N, dg, K, Ho, Wo)
        cols = cols * m.permute(0, 1, 3, 4, 2)[:, :, None]
    cols = cols.reshape(N, C, Ho, Wo, K).permute(0, 1, 4, 2, 3)
    cols = cols.reshape(N, groups, C // groups, K, Ho, Wo)
    wg = weight.reshape(groups, out_c // groups, cpg, K)
    out = torch.einsum("ngckhw,gock->ngohw", cols.float(), wg.float())
    out = out.reshape(N, out_c, Ho, Wo).to(x.dtype)
    if bias is not None:
        out = out + as_tensor(bias, like=x).reshape(1, -1, 1, 1)
    return out


def psroi_pool(x, rois, roi_batch_id, output_channels: int,
               pooled_height: int, pooled_width: int,
               spatial_scale: float = 1.0):
    """Position-sensitive ROI pooling (ref psroi_pool_op.cc): input channel
    layout (N, out_c ph pw, H, W); bin (i, j) of output channel c averages
    input channel c ph pw + i pw + j over the bin's spatial extent."""
    x = as_tensor(x)
    rois = as_tensor(rois, like=x).to(device=x.device, dtype=torch.float32)
    roi_batch_id = as_tensor(roi_batch_id, like=x).to(
        device=x.device, dtype=torch.int64)
    N, C, H, W = x.shape
    R = rois.shape[0]
    ph, pw = pooled_height, pooled_width
    if C != output_channels * ph * pw:
        raise ValueError(
            f"psroi_pool: input channels {C} != out_c*ph*pw "
            f"({output_channels}*{ph}*{pw})")
    dev = x.device
    # ref psroi_pool_op.h: round the RAW roi, +1 on the end coords, THEN
    # apply spatial_scale (order matters for scale != 1)
    x1 = torch.round(rois[:, 0]) * spatial_scale
    y1 = torch.round(rois[:, 1]) * spatial_scale
    x2 = (torch.round(rois[:, 2]) + 1.0) * spatial_scale
    y2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale
    bin_h = torch.clamp(y2 - y1, min=0.1) / ph
    bin_w = torch.clamp(x2 - x1, min=0.1) / pw
    gy = torch.arange(ph, dtype=torch.float32, device=dev)
    gx = torch.arange(pw, dtype=torch.float32, device=dev)
    ys = y1[:, None] + gy * bin_h[:, None]                    # (R, ph) starts
    ye = y1[:, None] + (gy + 1) * bin_h[:, None]
    xs = x1[:, None] + gx * bin_w[:, None]                    # (R, pw)
    xe = x1[:, None] + (gx + 1) * bin_w[:, None]
    ii = torch.arange(H, dtype=torch.float32, device=dev)
    jj = torch.arange(W, dtype=torch.float32, device=dev)
    in_y = ((ii >= torch.floor(ys)[..., None])
            & (ii < torch.ceil(ye)[..., None]) & (ii <= H - 1))  # (R, ph, H)
    in_x = ((jj >= torch.floor(xs)[..., None])
            & (jj < torch.ceil(xe)[..., None]) & (jj <= W - 1))  # (R, pw, W)
    sel = (in_y[:, :, None, :, None] & in_x[:, None, :, None, :]).to(x.dtype)
    cnt = torch.clamp(sel.sum(dim=(-2, -1)), min=1.0)         # (R, ph, pw)
    feat = x[roi_batch_id].reshape(R, output_channels, ph, pw, H, W)
    s = torch.einsum("rcpqhw,rpqhw->rcpq", feat, sel)
    return s / cnt[:, None]
