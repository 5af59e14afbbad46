"""Cross-entropy losses (counterpart of paddle_tpu/nn/functional/loss.py
``softmax_with_cross_entropy`` and ``cross_entropy``).

The log-softmax is taken in fp32 whatever the logits' type, for bf16
stability.  Labels equal to ``ignore_index`` give a loss of 0 and no
gradient, and a "mean" is taken over the labels that are not ignored.
"""
from __future__ import annotations

import torch


def softmax_with_cross_entropy(logits, label, ignore_index=-100, axis=-1):
    """Per-example loss (no reduction) of fp32 log-softmax and the label
    index.  (Soft labels and class weights are not ported yet.)"""
    log_probs = torch.log_softmax(logits.float(), dim=axis)
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        label = label.squeeze(axis)
    label = label.long()
    ignored = label == ignore_index
    safe = torch.where(ignored, torch.zeros_like(label), label)
    picked = torch.gather(log_probs.movedim(axis, -1), -1,
                          safe[..., None])[..., 0]
    return torch.where(ignored, torch.zeros_like(picked), -picked)


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1):
    """Cross-entropy with Paddle's reductions; "mean" divides by the count
    of labels that are not ignored."""
    loss = softmax_with_cross_entropy(input, label, ignore_index=ignore_index,
                                      axis=axis)
    if reduction == "mean":
        valid = (label != ignore_index).float().sum()
        return loss.sum() / valid.clamp_min(1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
