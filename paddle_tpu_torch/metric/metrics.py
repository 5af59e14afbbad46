"""Metric implementations (counterpart of paddle_tpu/metric/metrics.py;
ref: python/paddle/metric/metrics.py).

``Accuracy.compute`` runs on the batch's device with torch ops, where the
JAX package's runs ``jnp`` inside the step; every ``update`` reads its
inputs to host numpy (tensors copied off the device) and accumulates there,
as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a tensor copied off its device;
    bfloat16 through float32)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label):
        """Optional preprocessing run on-device inside the step; default
        passthrough."""
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy (ref: metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        """(batch, maxk) float32 hits of the top-k classes against the
        label, on ``pred``'s device.  The ranking is a stable ascending
        sort, reversed, as ``jnp.argsort(pred)[..., ::-1]``: of tied scores
        the later class ranks first."""
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        maxk = max(self.topk)
        pred_idx = torch.sort(pred, dim=-1, stable=True).indices.flip(-1)
        pred_idx = pred_idx[..., :maxk]
        label = label.reshape(label.shape[0], -1)[:, :1]
        return (pred_idx == label).to(torch.float32)

    def update(self, correct):
        correct = _host(correct)
        for i, k in enumerate(self.topk):
            self.total[i] += correct[:, :k].sum()
            self.count[i] += correct.shape[0]
        acc = self.total / np.maximum(self.count, 1)
        return acc[0] if len(self.topk) == 1 else acc

    def accumulate(self):
        acc = self.total / np.maximum(self.count, 1)
        return float(acc[0]) if len(self.topk) == 1 else acc.tolist()


class Precision(Metric):
    """Binary precision (ref: metrics.py Precision)."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = _host(preds).round().astype(np.int32).reshape(-1)
        labels = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = _host(preds).round().astype(np.int32).reshape(-1)
        labels = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC by thresholded confusion accumulation (ref: metrics.py Auc /
    operators/metrics/auc_op.cc)."""

    def __init__(self, num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _host(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _host(labels).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx[labels == 1], 1)
        np.add.at(self._stat_neg, idx[labels == 0], 1)

    def accumulate(self):
        # integrate TPR over FPR with trapezoids from high threshold to low
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        # anchor the ROC curve at (0, 0) — without it, mass concentrated in
        # the top threshold bin integrates to 0 instead of its true area
        tpr = np.concatenate([[0.0], pos_cum / tot_pos])
        fpr = np.concatenate([[0.0], neg_cum / tot_neg])
        return float(np.trapezoid(tpr, fpr)) if hasattr(np, "trapezoid") else \
            float(np.trapz(tpr, fpr))


class ChunkEvaluator(Metric):
    """ref fluid/metrics.py ChunkEvaluator: accumulate
    (num_infer, num_label, num_correct) chunk counts across batches and
    expose (precision, recall, f1) — the NER evaluation companion of
    layers.chunk_eval / the chunk_eval op."""

    def __init__(self, name=None):
        super().__init__(name or "chunk")
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)
        return self.eval()

    def eval(self):
        p = (self.num_correct_chunks / self.num_infer_chunks
             if self.num_infer_chunks else 0.0)
        r = (self.num_correct_chunks / self.num_label_chunks
             if self.num_label_chunks else 0.0)
        f1 = 2 * p * r / (p + r) if self.num_correct_chunks else 0.0
        return p, r, f1

    accumulate = eval

    def compute(self, *args):
        return args


class DetectionMAP(Metric):
    """Mean average precision for detection (ref fluid/metrics.py
    DetectionMAP + operators/detection_map_op.h).

    Host-side by design: mAP accumulation is per-class RAGGED state
    (variable detections/gts per image), so like every Metric here it
    runs in numpy between steps — the static `detection_map` op stays
    descoped with this class as the re-scope (op_coverage.py).

    ``update(det_boxes, det_labels, det_scores, gt_boxes, gt_labels,
    difficult=None)`` consumes ONE image: detections (D, 4)/(D,)/(D,),
    ground truth (G, 4)/(G,); ``accumulate()`` returns mAP over classes
    that have ground truth, with the reference's two AP algorithms
    (``ap_version`` = "integral" or "11point") and greedy
    highest-score-first matching STRICTLY ABOVE ``overlap_threshold``
    (detection_map_op.h uses ``>``); difficult gts
    are excluded exactly like the reference (matched without counting
    when ``evaluate_difficult`` is False).
    """

    def __init__(self, overlap_threshold=0.5, evaluate_difficult=False,
                 ap_version="integral", name=None):
        super().__init__(name)
        if ap_version not in ("integral", "11point"):
            raise ValueError("ap_version must be 'integral' or '11point', "
                             f"got {ap_version!r}")
        self.overlap_threshold = float(overlap_threshold)
        self.evaluate_difficult = bool(evaluate_difficult)
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        self._scores = {}   # class -> list of (score, is_tp)
        self._npos = {}     # class -> number of non-difficult gts

    def update(self, det_boxes, det_labels, det_scores, gt_boxes,
               gt_labels, difficult=None):
        det_boxes = _host(det_boxes).astype(np.float64).reshape(-1, 4)
        det_labels = _host(det_labels).reshape(-1).astype(int)
        det_scores = _host(det_scores).astype(np.float64).reshape(-1)
        gt_boxes = _host(gt_boxes).astype(np.float64).reshape(-1, 4)
        gt_labels = _host(gt_labels).reshape(-1).astype(int)
        difficult = (np.zeros(len(gt_labels), bool) if difficult is None
                     else _host(difficult).reshape(-1).astype(bool))
        for c in np.unique(gt_labels):
            hard = difficult[gt_labels == c]
            self._npos[c] = self._npos.get(c, 0) + int(
                len(hard) if self.evaluate_difficult
                else (~hard).sum())
        for c in np.unique(det_labels):
            det_idx = np.where(det_labels == c)[0]
            det_idx = det_idx[np.argsort(-det_scores[det_idx],
                                         kind="stable")]
            gt_idx = np.where(gt_labels == c)[0]
            taken = np.zeros(len(gt_idx), bool)
            rec = self._scores.setdefault(c, [])
            # vectorized (D, G) IoU matrix (the chunk_eval precedent:
            # host metrics stay numpy-broadcast, not python loops)
            if len(det_idx) and len(gt_idx):
                d = det_boxes[det_idx]
                g = gt_boxes[gt_idx]
                iw = np.maximum(
                    np.minimum(d[:, None, 2], g[None, :, 2])
                    - np.maximum(d[:, None, 0], g[None, :, 0]), 0.0)
                ih = np.maximum(
                    np.minimum(d[:, None, 3], g[None, :, 3])
                    - np.maximum(d[:, None, 1], g[None, :, 1]), 0.0)
                inter = iw * ih
                area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
                area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
                iou = inter / np.maximum(
                    area_d[:, None] + area_g[None, :] - inter, 1e-10)
            else:
                iou = np.zeros((len(det_idx), len(gt_idx)))
            for rank, di in enumerate(det_idx):
                best_j = int(np.argmax(iou[rank])) if len(gt_idx) else -1
                best = float(iou[rank, best_j]) if best_j >= 0 else 0.0
                # STRICT > like the reference (detection_map_op.h)
                if best > self.overlap_threshold and best_j >= 0:
                    is_diff = difficult[gt_idx[best_j]]
                    if is_diff and not self.evaluate_difficult:
                        continue  # matched a difficult gt: ignored
                    if not taken[best_j]:
                        taken[best_j] = True
                        rec.append((float(det_scores[di]), True))
                    else:
                        rec.append((float(det_scores[di]), False))
                else:
                    rec.append((float(det_scores[di]), False))

    def accumulate(self):
        aps = []
        for c, npos in self._npos.items():
            if npos == 0:
                continue
            rec = sorted(self._scores.get(c, []), key=lambda t: -t[0])
            tp = np.cumsum([1.0 if t else 0.0 for _, t in rec]) \
                if rec else np.zeros(0)
            fp = np.cumsum([0.0 if t else 1.0 for _, t in rec]) \
                if rec else np.zeros(0)
            recall = tp / npos if len(tp) else np.zeros(0)
            precision = tp / np.maximum(tp + fp, 1e-10) if len(tp) \
                else np.zeros(0)
            if self.ap_version == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    p = precision[recall >= t].max() \
                        if np.any(recall >= t) else 0.0
                    ap += p / 11.0
            else:
                # integral: sum precision * delta-recall (detection_map_op)
                ap, prev_r = 0.0, 0.0
                for p, r in zip(precision, recall):
                    ap += p * (r - prev_r)
                    prev_r = r
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
