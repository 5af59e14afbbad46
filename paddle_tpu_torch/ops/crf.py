"""Linear-chain CRF: the negative log-likelihood and Viterbi decoding
(counterpart of paddle_tpu/ops/crf.py; ref operators/linear_chain_crf_op.h
and crf_decoding_op.h).

The transition parameter keeps Fluid's layout, [num_tags + 2, num_tags]:
row 0 the start weights, row 1 the stop weights, rows 2.. the transition
score [from, to].  Emissions are padded (batch, seq, num_tags) with
explicit lengths.  The forward recursion and Viterbi are loops over time
(``lax.scan`` in the JAX package); the NLL's gradient is torch autograd
through the loop, as JAX's is AD through the scan.  Plain torch: the JAX
package runs no Pallas kernel here.
"""
from __future__ import annotations

import torch

from ._util import as_tensor, index as _index
from .sequence import sequence_mask

__all__ = ["linear_chain_crf", "crf_decoding"]


def _split_transition(transition):
    return transition[0], transition[1], transition[2:]


def linear_chain_crf(emission, label, transition, lengths):
    """Per-sequence negative log-likelihood, (b, 1) (the reference op's
    ``log_likelihood`` output, negated).

    emission (b, s, D) unnormalised tag scores; label (b, s) ints;
    transition (D + 2, D); lengths (b,).  Computed in fp32."""
    emission = as_tensor(emission).float()
    label = _index(as_tensor(label, like=emission))
    transition = as_tensor(transition, like=emission).float()
    lengths = as_tensor(lengths, like=emission)
    b, s, D = emission.shape
    start, stop, trans = _split_transition(transition)
    mask = sequence_mask(lengths, s)                                # (b, s)

    # partition function: the forward recursion, frozen past each length
    alpha = start[None, :] + emission[:, 0]
    for t in range(1, s):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, t]
        alpha = torch.where(mask[:, t, None], new, alpha)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=1)           # (b,)

    # the gold path's score
    maskf = mask.float()
    emis = torch.gather(emission, 2, label[..., None])[..., 0]
    emis = (emis * maskf).sum(dim=1)
    start_score = start[label[:, 0]]
    last = torch.clamp(lengths.long() - 1, min=0)
    stop_score = stop[torch.gather(label, 1, last[:, None])[:, 0]]
    pairs = trans[label[:, :-1], label[:, 1:]]                      # (b, s-1)
    pairs = (pairs * maskf[:, 1:]).sum(dim=1)
    gold = start_score + emis + pairs + stop_score
    return (log_z - gold)[:, None]


def crf_decoding(emission, transition, lengths):
    """The Viterbi path, (b, s) int64 (int32 in the JAX package, whose x64
    is off), zeros past each length.  Padded steps keep identity
    backpointers, so backtracking through them is a no-op."""
    emission = as_tensor(emission).float()
    transition = as_tensor(transition, like=emission).float()
    lengths = as_tensor(lengths, like=emission)
    b, s, D = emission.shape
    start, stop, trans = _split_transition(transition)
    mask = sequence_mask(lengths, s)
    ident = torch.arange(D, device=emission.device)[None, :].expand(b, D)

    delta = start[None, :] + emission[:, 0]
    bps = []
    for t in range(1, s):
        scores = delta[:, :, None] + trans[None]                # (b, from, to)
        best, prev = scores.max(dim=1)
        m = mask[:, t, None]
        delta = torch.where(m, best + emission[:, t], delta)
        bps.append(torch.where(m, prev, ident))
    tag = torch.argmax(delta + stop[None, :], dim=1)
    path = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)                           # (b, s)
    return torch.where(mask, path, torch.zeros_like(path))
