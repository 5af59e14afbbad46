"""Faster R-CNN R50-FPN's proposal and target stage as a static program,
at the settings of PaddleDetection's configs/faster_rcnn_r50_fpn_1x.yml
(the Paddle 1.8-era release): FPNRPNHead (a shared 3x3 conv of num_chan
256 + ReLU, 1x1 convs to 3 scores and 12 deltas a level, anchor sizes
32-512 on P2-P6, aspect ratios 0.5 / 1 / 2, variance 1), train_proposal
(pre / post_nms_top_n 2000, nms_thresh 0.7, min_size 0), test_proposal
(1000 / 1000), collect_fpn_proposals (post 2000 train, 1000 test),
FPNRoIAlign (levels 2-5, canonical level 4, canonical size 224, 7x7,
sampling_ratio 2), rpn_target_assign (256 an image, fg 0.5, positive 0.7,
negative 0.3) and BBoxAssigner (512 an image, fg_fraction 0.25, fg 0.5,
bg 0-0.5, 81 classes, bbox_reg_weights 0.1 / 0.1 / 0.2 / 0.2).

``build(S, ...)`` builds it with package ``S`` (``paddle_tpu.static`` or
``paddle_tpu_torch.static``); ``inputs(...)`` makes the seeded feeds
(features, image info, anchors, COCO-like ground truth of 1-20 boxes an
image, some of them crowd).  The detection ops have no DSL builder in
either package, so they are appended to the block directly.  It imports
neither jax nor paddle_tpu: chip_smoke.py builds it on the card."""
from __future__ import annotations

import numpy as np

STRIDE = {2: 4, 3: 8, 4: 16, 5: 32, 6: 64}
SIZE = {2: 32, 3: 64, 4: 128, 5: 256, 6: 512}
RATIOS = (0.5, 1.0, 2.0)
A = len(RATIOS)
TRAIN = {"pre": 2000, "post": 2000, "collect": 2000}
TEST = {"pre": 1000, "post": 1000, "collect": 1000}


def level_shape(level, height, width):
    """P<level>'s (H, W) for a padded height x width image (ceil)."""
    s = STRIDE[level]
    return -(-height // s), -(-width // s)


def anchors(level, H, W):
    """anchor_generator_op.h's anchors for one level: (H, W, 3, 4)."""
    stride, size = STRIDE[level], SIZE[level]
    out = np.zeros((H, W, A, 4), np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xc = xs * stride + 0.5 * (stride - 1)
    yc = ys * stride + 0.5 * (stride - 1)
    for k, r in enumerate(RATIOS):
        base_w = np.round(np.sqrt(stride * stride / r))
        base_h = np.round(base_w * r)
        aw = size / stride * base_w
        ah = size / stride * base_h
        out[:, :, k] = np.stack([xc - 0.5 * (aw - 1), yc - 0.5 * (ah - 1),
                                 xc + 0.5 * (aw - 1), yc + 0.5 * (ah - 1)],
                                -1)
    return out


def inputs(seed, n_images, height, width, levels, channels=256,
           max_gt=20):
    """The stage's feeds: P<l> features (N, C, H_l, W_l), im_info, the
    anchors and variances of each level, and per image 1-max_gt ground
    truth boxes (padded with zero rows), their classes (1-80) and crowd
    flags."""
    rng = np.random.default_rng(seed)
    feed = {}
    for lvl in levels:
        H, W = level_shape(lvl, height, width)
        feed[f"p{lvl}"] = rng.normal(0, 1, (n_images, channels, H, W)) \
            .astype(np.float32)
        anc = anchors(lvl, H, W)
        feed[f"anchors{lvl}"] = anc
        feed[f"variances{lvl}"] = np.ones_like(anc)
    feed["im_info"] = np.tile(np.array([[height, width, 1.0]], np.float32),
                              (n_images, 1))
    gt = np.zeros((n_images, max_gt, 4), np.float32)
    cls = np.zeros((n_images, max_gt, 1), np.int32)
    crowd = np.zeros((n_images, max_gt), np.int32)
    for i in range(n_images):
        n = int(rng.integers(1, max_gt + 1))
        wh = rng.uniform(16, min(height, width) / 2, (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * ([width, height] - wh)
        gt[i, :n] = np.concatenate([xy, xy + wh], 1)
        cls[i, :n, 0] = rng.integers(1, 81, n)
        crowd[i, :n] = rng.random(n) < 0.1
    feed.update(gt_boxes=gt, gt_classes=cls, is_crowd=crowd)
    return feed


def build(S, n_images, height, width, levels, channels=256, train=True,
          roi_levels=None, targets=True, rpn_batch=256, roi_batch=512,
          roi_feats=True):
    """Append the stage to the current program of package ``S``; returns
    {name: variable} of its fetches (``roi_feats`` False leaves out the
    RoI features, ``targets`` False the two target assigners)."""
    L = S.layers
    blk = S.default_main_program().global_block()
    cfg = TRAIN if train else TEST
    roi_levels = [lv for lv in (roi_levels or (2, 3, 4, 5))
                  if lv in levels]

    def var(name, shape=(), dtype="float32"):
        return blk.create_var(name=name, shape=shape, dtype=dtype)

    def op(t, ins, outs, attrs=None):
        blk.append_op(t, ins, outs, attrs or {})

    im_info = L.data("im_info", [n_images, 3], append_batch_size=False)
    out = {}
    per_level = []
    for lvl in levels:
        H, W = level_shape(lvl, height, width)
        feat = L.data(f"p{lvl}", [n_images, channels, H, W],
                      append_batch_size=False)
        anc = L.data(f"anchors{lvl}", [H, W, A, 4],
                     append_batch_size=False)
        var_ = L.data(f"variances{lvl}", [H, W, A, 4],
                      append_batch_size=False)
        h = L.conv2d(feat, channels, 3, padding=1, act="relu",
                     param_attr="rpn_conv.w", bias_attr="rpn_conv.b")
        score = L.sigmoid(L.conv2d(h, A, 1, param_attr="rpn_cls.w",
                                   bias_attr="rpn_cls.b"))
        delta = L.conv2d(h, 4 * A, 1, param_attr="rpn_bbox.w",
                         bias_attr="rpn_bbox.b")
        post = min(cfg["post"], cfg["pre"], A * H * W)
        rois = var(f"rpn_rois{lvl}", (n_images, post, 4))
        probs = var(f"rpn_probs{lvl}", (n_images, post, 1))
        num = var(f"rpn_num{lvl}", (n_images,), "int32")
        op("generate_proposals",
           {"Scores": [score.name], "BboxDeltas": [delta.name],
            "ImInfo": [im_info.name], "Anchors": [anc.name],
            "Variances": [var_.name]},
           {"RpnRois": [rois.name], "RpnRoiProbs": [probs.name],
            "RpnRoisNum": [num.name]},
           {"pre_nms_topN": cfg["pre"], "post_nms_topN": cfg["post"],
            "nms_thresh": 0.7, "min_size": 0.0})
        out.update({f"scores{lvl}": score, f"rois{lvl}": rois,
                    f"probs{lvl}": probs, f"num{lvl}": num})
        per_level.append((lvl, H, W, feat, anc, score, delta, rois, probs,
                          num))
    collected = []
    for i in range(n_images):
        def take(v, i=i):
            return L.slice(v, axes=[0], starts=[i], ends=[i + 1])

        r_l = [L.reshape(take(p[7]), [-1, 4]) for p in per_level]
        s_l = [L.reshape(take(p[8]), [-1]) for p in per_level]
        counts = L.concat([take(p[9]) for p in per_level], axis=0)
        total = sum(p[7].shape[1] for p in per_level)
        n_fpn = min(cfg["collect"], total)
        fpn = var(f"fpn_rois_{i}", (n_fpn, 4))
        fnum = var(f"fpn_num_{i}", (), "int32")
        op("collect_fpn_proposals",
           {"MultiLevelRois": [r.name for r in r_l],
            "MultiLevelScores": [s.name for s in s_l],
            "MultiLevelRoIsNum": [counts.name]},
           {"FpnRois": [fpn.name], "RoisNum": [fnum.name]},
           {"post_nms_topN": cfg["collect"]})
        multi = [var(f"multi_rois{lv}_{i}", (n_fpn, 4)) for lv in roi_levels]
        lnum = var(f"level_num_{i}", (len(roi_levels),), "int32")
        restore = var(f"restore_{i}", (n_fpn, 1), "int32")
        op("distribute_fpn_proposals", {"FpnRois": [fpn.name]},
           {"MultiFpnRois": [m.name for m in multi],
            "MultiLevelRoIsNum": [lnum.name], "RestoreIndex": [restore.name]},
           {"min_level": min(roi_levels), "max_level": max(roi_levels),
            "refer_level": 4, "refer_scale": 224})
        out.update({f"fpn_rois_{i}": fpn, f"fpn_num_{i}": fnum,
                    f"level_num_{i}": lnum, f"restore_{i}": restore})
        out.update({f"multi_rois{lv}_{i}": m
                    for lv, m in zip(roi_levels, multi)})
        feats = {p[0]: p[3] for p in per_level}
        for lv, m in zip(roi_levels if roi_feats else (), multi):
            out[f"roi_feat{lv}_{i}"] = L.roi_align(
                take(feats[lv]), m, pooled_height=7, pooled_width=7,
                spatial_scale=1.0 / STRIDE[lv], sampling_ratio=2)
        collected.append(fpn)
    if not targets:
        return out
    gt = L.data("gt_boxes", [n_images, -1, 4], append_batch_size=False)
    cls = L.data("gt_classes", [n_images, -1, 1], dtype="int32",
                 append_batch_size=False)
    crowd = L.data("is_crowd", [n_images, -1], dtype="int32",
                   append_batch_size=False)
    all_anc = L.concat([L.reshape(p[4], [-1, 4]) for p in per_level], 0)
    rpn_outs = ("LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox",
                "MatchedGtIndex", "ForegroundNumber", "ScoreNumber")
    rpn_shape = {"TargetBBox": (n_images, rpn_batch, 4),
                 "ForegroundNumber": (n_images,),
                 "ScoreNumber": (n_images,)}
    rpn = {k: var(f"rpn_{k}", rpn_shape.get(k, (n_images, rpn_batch)),
                  "float32" if k == "TargetBBox" else "int32")
           for k in rpn_outs}
    op("rpn_target_assign", {"Anchor": [all_anc.name], "GtBoxes": [gt.name]},
       {k: [v.name] for k, v in rpn.items()},
       {"rpn_batch_size_per_im": rpn_batch, "rpn_positive_overlap": 0.7,
        "rpn_negative_overlap": 0.3, "rpn_fg_fraction": 0.5,
        "use_random": True})
    out.update({f"rpn_{k}": v for k, v in rpn.items()})
    out["all_anchors"] = all_anc
    stacked = L.concat([L.reshape(c, [1, -1, 4]) for c in collected], 0)
    nums = L.concat([L.reshape(out[f"fpn_num_{i}"], [1])
                     for i in range(n_images)], 0)
    gpl_outs = ("Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
                "BboxOutsideWeights", "RoisNum")
    gpl_shape = {"Rois": (n_images, roi_batch, 4),
                 "LabelsInt32": (n_images, roi_batch, 1),
                 "RoisNum": (n_images,)}
    gpl = {k: var(f"rcnn_{k}", gpl_shape.get(k, (n_images, roi_batch,
                                                  81 * 4)),
                  "int32" if k in ("LabelsInt32", "RoisNum") else "float32")
           for k in gpl_outs}
    op("generate_proposal_labels",
       {"RpnRois": [stacked.name], "RpnRoisNum": [nums.name],
        "GtClasses": [cls.name], "IsCrowd": [crowd.name],
        "GtBoxes": [gt.name], "ImInfo": [im_info.name]},
       {k: [v.name] for k, v in gpl.items()},
       {"batch_size_per_im": roi_batch, "fg_fraction": 0.25,
        "fg_thresh": 0.5, "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
        "class_nums": 81, "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2],
        "use_random": True})
    out.update({f"rcnn_{k}": v for k, v in gpl.items()})
    return out


def iou(a, b):
    """Pairwise IoU of corner boxes with +1 widths (the ops' convention)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt + 1, 0)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda z: (z[:, 2] - z[:, 0] + 1) * (z[:, 3] - z[:, 1] + 1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter,
                              1e-10)


def check_targets(got, feed, n_images, rpn_batch=256, roi_batch=512):
    """Hold the sampled targets by their invariants; returns a summary.

    rpn_target_assign: every sampled fg anchor has IoU >= 0.7 with some
    gt or is a gt's best anchor, every bg anchor IoU < 0.3 with all gt and
    not fg, fg <= 128, the batch filled to 256, TargetBBox the matched gt.
    generate_proposal_labels: fg rows first with IoU >= 0.5 and at most
    128 of them, bg rows IoU in [0, 0.5), labels the matched gt's class on
    fg and 0 on bg,
    the regression targets BoxToDelta(roi, gt) / (0.1, 0.1, 0.2, 0.2) in
    the label's slot and zero elsewhere."""
    anc = np.asarray(got["all_anchors"])
    summary = {"rpn_fg": [], "rpn_bg": [], "rcnn_fg": [], "rcnn_bg": []}
    for i in range(n_images):
        gt_i = feed["gt_boxes"][i]
        valid = gt_i[:, 2] > gt_i[:, 0]
        g = gt_i[valid]
        nfg = int(np.asarray(got["rpn_ForegroundNumber"])[i])
        nsc = int(np.asarray(got["rpn_ScoreNumber"])[i])
        loc = np.asarray(got["rpn_LocationIndex"])[i]
        score = np.asarray(got["rpn_ScoreIndex"])[i]
        ov = iou(anc, g)
        best = ov.max(1)
        is_best = (ov == ov.max(0)[None]).any(1) & (ov.max(0)[None] > 0) \
            .any(1)
        fg_ok = (best >= 0.7) | is_best
        assert 0 < nfg <= rpn_batch // 2, nfg
        assert nsc == rpn_batch, nsc
        f = loc[:nfg]
        assert fg_ok[f].all() and (loc[nfg:] == -1).all()
        s = score[:nsc]
        assert len(np.unique(s)) == nsc
        bg = np.setdiff1d(s, f)
        assert (best[bg] < 0.3 + 1e-6).all() and len(bg) == nsc - nfg
        tb = np.asarray(got["rpn_TargetBBox"])[i][:nfg]
        np.testing.assert_allclose(tb, g[ov[f].argmax(1)], atol=1e-3)
        summary["rpn_fg"].append(nfg)
        summary["rpn_bg"].append(len(bg))

        n = int(np.asarray(got["rcnn_RoisNum"])[i])
        rois = np.asarray(got["rcnn_Rois"])[i]
        lbl = np.asarray(got["rcnn_LabelsInt32"])[i].reshape(-1)
        tgt = np.asarray(got["rcnn_BboxTargets"])[i].reshape(-1, 81, 4)
        cls = feed["gt_classes"][i][valid].reshape(-1)
        o = iou(rois[:n], g)
        mx = o.max(1)
        rfg = int((lbl[:n] > 0).sum())
        assert 0 < rfg <= int(0.25 * roi_batch) and n <= roi_batch
        assert (mx[:rfg] >= 0.5 - 1e-5).all() and (lbl[:rfg] > 0).all()
        assert (mx[rfg:n] < 0.5 + 1e-5).all() and (lbl[rfg:] == 0).all()
        np.testing.assert_array_equal(lbl[:rfg], cls[o[:rfg].argmax(1)])
        w = (0.1, 0.1, 0.2, 0.2)
        e, gg = rois[:rfg], g[o[:rfg].argmax(1)]
        ew, eh = e[:, 2] - e[:, 0] + 1, e[:, 3] - e[:, 1] + 1
        gw, gh = gg[:, 2] - gg[:, 0] + 1, gg[:, 3] - gg[:, 1] + 1
        d = np.stack([((gg[:, 0] + gw / 2) - (e[:, 0] + ew / 2)) / ew / w[0],
                      ((gg[:, 1] + gh / 2) - (e[:, 1] + eh / 2)) / eh / w[1],
                      np.log(gw / ew) / w[2], np.log(gh / eh) / w[3]], 1)
        np.testing.assert_allclose(tgt[np.arange(rfg), lbl[:rfg]], d,
                                   rtol=1e-3, atol=1e-3)
        mask = np.ones(tgt.shape[:2], bool)
        mask[np.arange(rfg), lbl[:rfg]] = False
        assert not tgt[mask].any()
        summary["rcnn_fg"].append(rfg)
        summary["rcnn_bg"].append(n - rfg)
    return summary
