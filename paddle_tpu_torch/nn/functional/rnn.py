"""The functional recurrent runner (counterpart of paddle_tpu/nn/functional/
rnn.py; ref fluid/layers/rnn.py ``rnn`` / ``birnn``).

The JAX package runs a cell under one ``lax.scan`` over time; the port runs
it in a Python loop over time on tensors, its gradient torch autograd
through the loop.  Steps at or past a row's ``sequence_length`` keep the
carry and emit zeros (the reference's mask semantics), in both directions:
the reverse pass walks from T - 1 down, so each row's reverse pass starts
at its own last valid step (a ``flip`` of the padded batch would start it
in the padding).  cuDNN's fused RNNs are not used: their length semantics
differ.

A cell that has ``project_inputs`` / ``step_projected`` (the port's
SimpleRNN, LSTM and GRU cells) has its input projection computed for
every step in one matrix product ahead of the loop; the loop then does the
hidden product and the gates only.
"""
from __future__ import annotations

import torch


def map_states(fn, *trees):
    """``fn`` over the leaves of nested tuples / lists of tensors."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(map_states(fn, *sub) for sub in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _swap(tree):
    return map_states(lambda x: x.transpose(0, 1), tree)


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Run ``cell`` over the time axis of ``inputs`` ([B, T, ...], or [T, B,
    ...] when ``time_major``; nested tuples allowed).  Returns (outputs,
    final states)."""
    if not time_major:
        inputs = _swap(inputs)
    first = _leaves(inputs)[0]
    n_steps = first.shape[0]
    if initial_states is None:
        initial_states = cell.get_initial_states(
            batch_ref=first, dtype=first.dtype, batch_dim_idx=1)
    active = None
    if sequence_length is not None:
        sequence_length = torch.as_tensor(sequence_length,
                                          device=first.device)
        steps = torch.arange(n_steps, device=first.device)
        active = steps[:, None] < sequence_length[None, :]        # (T, B)

    project = getattr(cell, "project_inputs", None)
    if project is not None and not kwargs and isinstance(inputs,
                                                         torch.Tensor):
        xs = project(inputs)

        def step(t, carry):
            return cell.step_projected(xs[t], carry)
    else:
        def step(t, carry):
            return cell(map_states(lambda x: x[t], inputs), carry, **kwargs)

    carry = initial_states
    outputs = [None] * n_steps
    order = range(n_steps - 1, -1, -1) if is_reverse else range(n_steps)
    for t in order:
        out, new = step(t, carry)
        if active is not None:
            a = active[t]

            def keep(n, o, a=a):
                return torch.where(a.reshape(a.shape + (1,) * (n.dim() - 1)),
                                   n, o)

            new = map_states(keep, new, carry)
            # a Python 0 is a host scalar: no fill launch a step
            out = map_states(lambda o: keep(o, 0), out)
        carry = new
        outputs[t] = out
    outputs = map_states(lambda *o: torch.stack(o, 0), *outputs)
    if not time_major:
        outputs = _swap(outputs)
    return outputs, carry


def birnn(cell_fw, cell_bw, inputs, initial_states=None, sequence_length=None,
          time_major=False, **kwargs):
    """Forward and reverse passes, their outputs concatenated on the feature
    axis; returns (outputs, (final_fw, final_bw))."""
    states_fw, states_bw = (None, None) if initial_states is None \
        else initial_states
    out_fw, final_fw = rnn(cell_fw, inputs, states_fw, sequence_length,
                           time_major=time_major, is_reverse=False, **kwargs)
    out_bw, final_bw = rnn(cell_bw, inputs, states_bw, sequence_length,
                           time_major=time_major, is_reverse=True, **kwargs)
    outputs = map_states(lambda a, b: torch.cat([a, b], -1), out_fw, out_bw)
    return outputs, (final_fw, final_bw)
