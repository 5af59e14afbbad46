"""Losses (counterpart of paddle_tpu/nn/functional/loss.py), with the
reference's parameter order: the cross-entropies, ``nll_loss``, the
regression losses, the binary cross-entropies, ``kl_div``, ``log_loss``,
``hinge_loss`` and ``margin_ranking_loss``.  ``ctc_loss`` is not ported
(ROADMAP.md).

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


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def nll_loss(log_probs, label, weight=None, ignore_index=-100,
             reduction="mean"):
    """-log_probs at the label over the last axis; ignored labels give 0;
    ``weight`` scales by the label's class.  "mean" divides by every
    label's count, as the JAX package does."""
    label = label.long()
    picked = torch.gather(log_probs, -1,
                          label.clamp_min(0)[..., None])[..., 0]
    loss = torch.where(label == ignore_index, torch.zeros_like(picked),
                       -picked)
    if weight is not None:
        loss = loss * weight[label.clamp_min(0)]
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input, label):
    """Per-element squared error."""
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    """On probabilities, each log clipped at 1e-12."""
    eps = 1e-12
    loss = -(label * torch.log(input.clamp_min(eps))
             + (1 - label) * torch.log((1 - input).clamp_min(eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """On logits, the stable form in fp32: (1 - y) x + w (log(1 +
    exp(-|x|)) + max(-x, 0)), w = (pos_weight - 1) y + 1 (1 without
    ``pos_weight``); the loss goes back to the logits' dtype."""
    x = logit.float()
    y = label.float()
    max_val = (-x).clamp_min(0)
    soft = torch.log1p(torch.exp(-x.abs()))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * y + 1
        loss = (1 - y) * x + log_w * (soft + max_val)
    else:
        loss = (1 - y) * x + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.to(logit.dtype), reduction)


def kl_div(input, label, reduction="mean"):
    """label (log label - input), ``input`` in log space; "batchmean"
    divides the sum by the batch."""
    loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4):
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


def hinge_loss(input, label):
    return (1 - input * (2 * label - 1)).clamp_min(0)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce((-label * (input - other) + margin).clamp_min(0),
                   reduction)
