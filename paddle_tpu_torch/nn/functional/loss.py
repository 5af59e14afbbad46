"""Losses (counterpart of paddle_tpu/nn/functional/loss.py), with the
reference's parameter order: the cross-entropies, ``nll_loss``, the
regression losses, the binary cross-entropies, ``kl_div``, ``log_loss``,
``hinge_loss``, ``margin_ranking_loss`` and ``ctc_loss``.

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


def ctc_loss(log_probs, labels, input_lengths=None, label_lengths=None,
             blank=0, reduction="mean", norm_by_times=False):
    """Connectionist Temporal Classification (ref warpctc_op.cc).

    log_probs (T, B, C) raw logits (log_softmax is applied here, warpctc's
    contract); labels (B, L) padded past ``label_lengths``; input_lengths
    (B,) (default T).  The log-semiring alpha recursion over the extended
    label sequence (blank, l1, blank, ..., lL, blank) is a loop over time,
    frozen past each input length; its gradient is torch autograd through
    the loop, as JAX's is AD through the scan.  Impossible states hold
    -1e30, not -inf: -inf makes the gradient NaN where a row's labels are
    empty.  "mean" divides each sample's loss by its label length before
    averaging (the paddle and torch contract)."""
    log_probs = torch.as_tensor(log_probs)
    T, B, C = log_probs.shape
    dev = log_probs.device
    labels = torch.as_tensor(labels, device=dev).long()
    L = labels.shape[1]
    S = 2 * L + 1
    input_lengths = (torch.full((B,), T, dtype=torch.int64, device=dev)
                     if input_lengths is None else
                     torch.as_tensor(input_lengths, device=dev).long())
    label_lengths = (torch.full((B,), L, dtype=torch.int64, device=dev)
                     if label_lengths is None else
                     torch.as_tensor(label_lengths, device=dev).long())
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    s_idx = torch.arange(S, device=dev)
    valid_s = s_idx[None, :] < (2 * label_lengths[:, None] + 1)
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], 1)
    can_skip = (s_idx[None, :] % 2 == 1) & (ext != ext_m2)
    neg = torch.full((), -1e30, device=dev)
    alpha = torch.where((s_idx[None, :] < 2) & valid_s,
                        torch.zeros((), device=dev), neg)
    alpha = torch.where(valid_s, alpha + torch.gather(lp[0], 1, ext), neg)
    pad1 = torch.full((B, 1), -1e30, device=dev)
    pad2 = torch.full((B, 2), -1e30, device=dev)
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], 1)
        shift2 = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], 1),
                             neg)
        merged = torch.logsumexp(torch.stack([alpha, shift1, shift2]), 0)
        new = torch.where(valid_s, merged + torch.gather(lp[t], 1, ext), neg)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    a_last = torch.gather(alpha, 1, (2 * label_lengths)[:, None])[:, 0]
    a_second = torch.where(
        label_lengths > 0,
        torch.gather(alpha, 1, torch.clamp(2 * label_lengths - 1,
                                           min=0)[:, None])[:, 0], neg)
    loss = -torch.logsumexp(torch.stack([a_last, a_second]), 0)
    if norm_by_times:
        loss = loss / input_lengths.to(loss.dtype)
    if reduction == "mean":
        return (loss / torch.clamp(label_lengths.to(loss.dtype),
                                   min=1.0)).mean()
    return _reduce(loss, reduction)
