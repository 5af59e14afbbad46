"""Cross-entropy losses (counterpart of paddle_tpu/nn/functional/loss.py
``softmax_with_cross_entropy`` and ``cross_entropy``), with the
reference's parameter order.

The log-softmax is taken in fp32 whatever the logits' type, for bf16
stability.  Hard labels equal to ``ignore_index`` give a loss of 0 and no
gradient, and a "mean" is taken over the labels that are not ignored
(weighted by ``weight`` where given).  Soft labels are distributions over
``axis``.
"""
from __future__ import annotations

import torch


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1):
    """Per-example loss (no reduction) of fp32 log-softmax and the label:
    a class index, or with ``soft_label`` a distribution over ``axis``."""
    log_probs = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        return -(label.float() * log_probs).sum(dim=axis)
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        label = label.squeeze(axis)
    label = label.long()
    ignored = label == ignore_index
    safe = torch.where(ignored, torch.zeros_like(label), label)
    picked = torch.gather(log_probs.movedim(axis, -1), -1,
                          safe[..., None])[..., 0]
    return torch.where(ignored, torch.zeros_like(picked), -picked)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1):
    """Cross-entropy with Paddle's reductions.  ``weight`` (one value a
    class) scales each hard-label example by its class's weight, and a
    "mean" then divides by the weights of the labels not ignored; without
    it a "mean" divides by their count."""
    loss = softmax_with_cross_entropy(input, label, soft_label=soft_label,
                                      ignore_index=ignore_index, axis=axis)
    if weight is not None and not soft_label:
        w = weight.float()[label.long().clamp_min(0)]
        loss = loss * w
        if reduction == "mean":
            kept = torch.where(label == ignore_index, torch.zeros_like(w), w)
            return loss.sum() / kept.sum().clamp_min(1e-12)
    if reduction == "mean" and not soft_label:
        valid = (label != ignore_index).float().sum()
        return loss.sum() / valid.clamp_min(1.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
