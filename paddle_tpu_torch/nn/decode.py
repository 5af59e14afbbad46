"""Seq2seq beam search: ``gather_tree``, ``BeamSearchDecoder`` and
``dynamic_decode`` (counterpart of paddle_tpu/nn/decode.py; ref
fluid/layers/rnn.py and operators/gather_tree_op.cc).

Beams are dense: every tensor carries (batch, beam) leading axes, the
outputs are preallocated (max_steps, batch, beam) buffers, and a finished
beam extends with the end token at zero added score.  The decode loop
stops when every beam has finished or after ``max_step_num`` steps (a
``lax.while_loop`` in the JAX package; here a Python loop that reads
``finished.all()`` once a step).  An inference path: no gradient is taken
through it, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .functional.rnn import map_states


def gather_tree(ids, parents):
    """Backtrack beam parent pointers (ref gather_tree_op.cc): ids, parents
    (max_time, batch, beam) ints; returns the time-major tokens along each
    final beam's parent chain."""
    ids = torch.as_tensor(ids)
    parents = torch.as_tensor(parents, device=ids.device).to(ids.dtype)
    T, b, beam = ids.shape
    beam_idx = torch.arange(beam, dtype=torch.int64,
                            device=ids.device).expand(b, beam)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, beam_idx)
        beam_idx = torch.gather(parents[t], 1, beam_idx).long()
    return torch.stack(out, 0)


class BeamSearchOutput(NamedTuple):
    scores: Any          # (max_steps, batch, beam) accumulated log-probs
    predicted_ids: Any   # (max_steps, batch, beam) backtracked tokens
    parent_ids: Any      # (max_steps, batch, beam) raw parent pointers


class BeamSearchState(NamedTuple):
    cell_states: Any     # nested tensors, leaves (batch * beam, ...)
    log_probs: Any       # (batch, beam)
    finished: Any        # (batch, beam) bool
    lengths: Any         # (batch, beam) int64 (int32 in the JAX package)


class BeamSearchDecoder:
    """Dense beam search over an RNN cell (ref fluid/layers/rnn.py
    BeamSearchDecoder): ``embedding_fn`` maps token ids to the cell's
    inputs, ``output_fn`` the cell's outputs to vocabulary logits;
    ``vocab_size``, when given, checks the logits' width."""

    def __init__(self, cell, start_token: int, end_token: int,
                 beam_size: int, embedding_fn: Callable,
                 output_fn: Callable, vocab_size: Optional[int] = None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.vocab_size = vocab_size

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size: int):
        """(batch, ...) -> (batch * beam, ...), each row repeated
        ``beam_size`` times."""
        return map_states(lambda t: torch.repeat_interleave(t, beam_size, 0),
                          x)

    def initialize(self, initial_cell_states):
        states = self.tile_beam_merge_with_batch(initial_cell_states,
                                                 self.beam_size)
        leaf = states
        while isinstance(leaf, (tuple, list)):
            leaf = leaf[0]
        b, dev = leaf.shape[0] // self.beam_size, leaf.device
        # only beam 0 is live at t = 0 (the reference's kInf masking)
        log_probs = torch.tensor([[0.0] + [-1e9] * (self.beam_size - 1)],
                                 device=dev).repeat(b, 1)
        state = BeamSearchState(
            cell_states=states, log_probs=log_probs,
            finished=torch.zeros((b, self.beam_size), dtype=torch.bool,
                                 device=dev),
            lengths=torch.zeros((b, self.beam_size), dtype=torch.int64,
                                device=dev))
        tokens = torch.full((b, self.beam_size), self.start_token,
                            dtype=torch.int64, device=dev)
        return tokens, state

    def step(self, tokens, state: BeamSearchState):
        """One beam step; returns (ids, parents, scores, next_state)."""
        b, beam = tokens.shape
        cell_out, cell_states = self.cell(
            self.embedding_fn(tokens.reshape(b * beam)), state.cell_states)
        logits = self.output_fn(cell_out)                    # (b*beam, V)
        V = logits.shape[-1]
        if self.vocab_size is not None and V != self.vocab_size:
            raise ValueError(
                f"output_fn produced {V} logits, expected vocab_size="
                f"{self.vocab_size}")
        step_lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, beam,
                                                                    V)
        # a finished beam extends only with the end token, at zero score
        eos_only = torch.full((V,), -1e9, device=logits.device)
        eos_only[self.end_token] = 0.0
        step_lp = torch.where(state.finished[:, :, None], eos_only, step_lp)
        total = state.log_probs[:, :, None] + step_lp        # (b, beam, V)
        top_lp, top_idx = torch.topk(total.reshape(b, beam * V), beam, dim=1)
        parents = top_idx // V
        ids = top_idx % V

        def gather(t):
            return torch.gather(t, 1, parents)

        finished = gather(state.finished) | (ids == self.end_token)
        lengths = gather(state.lengths) + (~gather(state.finished)).long()

        def regroup(leaf):
            leaf_b = leaf.reshape((b, beam) + tuple(leaf.shape[1:]))
            idx = parents.reshape((b, beam) + (1,) * (leaf_b.dim() - 2))
            out = torch.gather(leaf_b, 1, idx.expand(leaf_b.shape))
            return out.reshape(leaf.shape)

        next_state = BeamSearchState(map_states(regroup, cell_states),
                                     top_lp, finished, lengths)
        return ids, parents, top_lp, next_state


def dynamic_decode(decoder: BeamSearchDecoder, inits, max_step_num: int,
                   is_test: bool = True, return_length: bool = False):
    """Run ``decoder`` until every beam has emitted the end token or
    ``max_step_num`` steps, then backtrack with ``gather_tree`` (ref
    fluid/layers/rnn.py dynamic_decode).  Steps never run keep identity
    parents and the end token, and carry the final accumulated log-probs
    as their scores.  Returns (BeamSearchOutput, final state), with the
    lengths appended when ``return_length``."""
    with torch.no_grad():
        tokens, state = decoder.initialize(inits)
        b, beam = tokens.shape
        T, dev = int(max_step_num), tokens.device
        ids_buf = torch.full((T, b, beam), decoder.end_token,
                             dtype=torch.int64, device=dev)
        parents_buf = torch.arange(beam, device=dev).repeat(T, b, 1)
        scores_buf = torch.zeros((T, b, beam), device=dev)
        t = 0
        while t < T and not bool(state.finished.all()):
            ids, parents, scores, state = decoder.step(tokens, state)
            ids_buf[t], parents_buf[t], scores_buf[t] = ids, parents, scores
            tokens = ids
            t += 1
        scores_buf[t:] = state.log_probs
        out = BeamSearchOutput(scores=scores_buf,
                               predicted_ids=gather_tree(ids_buf,
                                                         parents_buf),
                               parent_ids=parents_buf)
    if return_length:
        return out, state, state.lengths
    return out, state
