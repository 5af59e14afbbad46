"""Recurrent layers: SimpleRNN, LSTM and GRU cells and networks
(counterpart of paddle_tpu/nn/layer/rnn.py; ref python/paddle/nn/layer/
rnn.py).

Weight layouts are the reference's, so state dicts carry over:
weight_ih [gates * H, input], weight_hh [gates * H, H], bias_ih / bias_hh
[gates * H]; LSTM gates in the order (i, f, g, o) (ref rnn.py:535-540);
GRU gates (r, z, c) with the reset applied after the hidden product (ref
rnn.py:685-691); every weight Uniform(-1/sqrt(H), 1/sqrt(H)) (ref
rnn.py:352), drawn on the CPU from ``generator`` (keyword-only; torch's
default generator when None), as the port's other layers; a ``*_attr``
of False drops that parameter, and its initializer is not read, as in the
JAX package.  The networks pack states [L * D, B, H] per state
component, layer-major then direction, and run their cells through
``F.rnn`` / ``F.birnn`` (never cuDNN's fused RNNs, whose length semantics
differ).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from .base import Layer, LayerList
from .common import make_param

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
    "split_states", "concat_states",
]


def split_states(states, bidirectional=False, state_components=1):
    """[L * D, B, H]-packed states as nested lists (ref rnn.py:46)."""
    if state_components == 1:
        states = [states[i] for i in range(states.shape[0])]
    else:
        components = [[s[i] for i in range(s.shape[0])] for s in states]
        states = [tuple(c) for c in zip(*components)]
    if not bidirectional:
        return states
    return [(states[2 * i], states[2 * i + 1])
            for i in range(len(states) // 2)]


def concat_states(states, bidirectional=False, state_components=1):
    """The inverse of ``split_states`` (ref rnn.py:99)."""
    if bidirectional:
        states = [s for pair in states for s in pair]
    if state_components == 1:
        return torch.stack(list(states))
    return tuple(torch.stack(list(c)) for c in zip(*states))


class RNNCellBase(Layer):
    """The cells' base (ref rnn.py:141): ``get_initial_states`` and the
    parameters."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` for the batch of ``batch_ref`` (a tensor
        or nested tuple; its first leaf's dim ``batch_dim_idx``), on its
        device, shaped ``shape`` (default ``state_shape``) per sample."""
        while isinstance(batch_ref, (list, tuple)):
            batch_ref = batch_ref[0]
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape if shape is not None else self.state_shape
        dtype = dtype or batch_ref.dtype

        def build(s):
            if isinstance(s, (list, tuple)) and all(isinstance(d, int)
                                                    for d in s):
                return torch.full((batch,) + tuple(s), init_value,
                                  dtype=dtype, device=batch_ref.device)
            return tuple(build(sub) for sub in s)

        return build(shape)

    def _create_rnn_params(self, input_size, hidden_size, gates,
                           weight_ih_attr=None, weight_hh_attr=None,
                           bias_ih_attr=None, bias_hh_attr=None,
                           generator: Optional[torch.Generator] = None):
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        for name, attr, shape in (
                ("weight_ih", weight_ih_attr, (gates * hidden_size,
                                               input_size)),
                ("weight_hh", weight_hh_attr, (gates * hidden_size,
                                               hidden_size)),
                ("bias_ih", bias_ih_attr, (gates * hidden_size,)),
                ("bias_hh", bias_hh_attr, (gates * hidden_size,))):
            if attr is False:
                self.register_parameter(name, None)
            else:
                make_param(self, name, u, shape, generator)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def project_inputs(self, inputs):
        """``inputs @ weight_ih.T + bias_ih`` for every step at once."""
        return F.linear(inputs, self.weight_ih.t(), self.bias_ih)

    def _hh(self, h):
        return F.linear(h, self.weight_hh.t(), self.bias_hh)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        return self.step_projected(self.project_inputs(inputs), states)


class SimpleRNNCell(RNNCellBase):
    """Elman cell: h = act(W_ih x + b_ih + W_hh h + b_hh) (ref rnn.py:263),
    act tanh or relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._create_rnn_params(input_size, hidden_size, 1, weight_ih_attr,
                                weight_hh_attr, bias_ih_attr, bias_hh_attr,
                                generator)
        if activation not in ("tanh", "relu"):
            raise ValueError(
                f"activation for SimpleRNNCell should be tanh or relu, "
                f"but got {activation}")
        self.activation = activation

    def step_projected(self, x_ih, states):
        pre = x_ih + self._hh(states)
        h = torch.tanh(pre) if self.activation == "tanh" else torch.relu(pre)
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class LSTMCell(RNNCellBase):
    """LSTM cell, gates (i, f, g, o) (ref rnn.py:401, :535)."""

    def __init__(self, input_size, hidden_size,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._create_rnn_params(input_size, hidden_size, 4, weight_ih_attr,
                                weight_hh_attr, bias_ih_attr, bias_hh_attr,
                                generator)

    def step_projected(self, x_ih, states):
        pre_h, pre_c = states
        i, f, g, o = torch.chunk(x_ih + self._hh(pre_h), 4, dim=-1)
        c = torch.sigmoid(f) * pre_c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(RNNCellBase):
    """GRU cell, gates (r, z, c), the reset applied after the hidden
    product (ref rnn.py:555, :685-691): h = (h_prev - c) z + c."""

    def __init__(self, input_size, hidden_size,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._create_rnn_params(input_size, hidden_size, 3, weight_ih_attr,
                                weight_hh_attr, bias_ih_attr, bias_hh_attr,
                                generator)

    def step_projected(self, x_ih, states):
        pre_h = states
        x_r, x_z, x_c = torch.chunk(x_ih, 3, dim=-1)
        h_r, h_z, h_c = torch.chunk(self._hh(pre_h), 3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        h = (pre_h - c) * z + c
        return h, h

    @property
    def state_shape(self):
        return (self.hidden_size,)


class RNN(Layer):
    """A cell run over a sequence (ref rnn.py:704)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        return F.rnn(self.cell, inputs, initial_states=initial_states,
                     sequence_length=sequence_length,
                     time_major=self.time_major, is_reverse=self.is_reverse,
                     **kwargs)


class BiRNN(Layer):
    """Forward and backward cells, outputs concatenated (ref rnn.py:797)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        return F.birnn(self.cell_fw, self.cell_bw, inputs, initial_states,
                       sequence_length, time_major=self.time_major, **kwargs)


class _RNNMixin(LayerList):
    """The multi-layer forward of SimpleRNN, LSTM and GRU (ref rnn.py:892):
    dropout between layers in training, states packed [L * D, B, H]."""

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            D = 2 if self.num_directions == 2 else 1
            batch = inputs.shape[1 if self.time_major else 0]
            shape = (self.num_layers * D, batch, self.hidden_size)
            initial_states = tuple(
                torch.zeros(shape, dtype=inputs.dtype, device=inputs.device)
                for _ in range(self.state_components))
            if self.state_components == 1:
                initial_states = initial_states[0]
        states = split_states(initial_states, self.num_directions == 2,
                              self.state_components)
        final_states = []
        out = inputs
        for i, rnn_layer in enumerate(self):
            if i > 0:
                out = F.dropout(out, self.dropout, training=self.training)
            out, final_state = rnn_layer(out, states[i], sequence_length)
            final_states.append(final_state)
        return out, concat_states(final_states, self.num_directions == 2,
                                  self.state_components)


def _build_multilayer(obj, make_cell, input_size, hidden_size, num_layers,
                      direction, time_major, dropout):
    bidirect = direction in ("bidirect", "bidirectional")
    if direction not in ("forward", "bidirect", "bidirectional"):
        raise ValueError(
            f"direction should be forward or bidirect (or bidirectional), "
            f"received direction = {direction}")
    for i in range(num_layers):
        in_size = input_size if i == 0 else hidden_size * (2 if bidirect
                                                           else 1)
        obj.append(BiRNN(make_cell(in_size), make_cell(in_size), time_major)
                   if bidirect else RNN(make_cell(in_size), False,
                                        time_major))
    obj.input_size = input_size
    obj.hidden_size = hidden_size
    obj.num_layers = num_layers
    obj.num_directions = 2 if bidirect else 1
    obj.time_major = time_major
    obj.dropout = dropout


class SimpleRNN(_RNNMixin):
    """ref rnn.py:934."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", dropout=0.0, time_major=False,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def make_cell(in_size):
            return SimpleRNNCell(in_size, hidden_size, activation,
                                 weight_ih_attr, weight_hh_attr,
                                 bias_ih_attr, bias_hh_attr,
                                 generator=generator)

        _build_multilayer(self, make_cell, input_size, hidden_size,
                          num_layers, direction, time_major, dropout)
        self.state_components = 1


class LSTM(_RNNMixin):
    """ref rnn.py:1074; final states ([L D, B, H] h, [L D, B, H] c)."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", dropout=0.0, time_major=False,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def make_cell(in_size):
            return LSTMCell(in_size, hidden_size, weight_ih_attr,
                            weight_hh_attr, bias_ih_attr, bias_hh_attr,
                            generator=generator)

        _build_multilayer(self, make_cell, input_size, hidden_size,
                          num_layers, direction, time_major, dropout)
        self.state_components = 2


class GRU(_RNNMixin):
    """ref rnn.py:1212."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", dropout=0.0, time_major=False,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def make_cell(in_size):
            return GRUCell(in_size, hidden_size, weight_ih_attr,
                           weight_hh_attr, bias_ih_attr, bias_hh_attr,
                           generator=generator)

        _build_multilayer(self, make_cell, input_size, hidden_size,
                          num_layers, direction, time_major, dropout)
        self.state_components = 1
