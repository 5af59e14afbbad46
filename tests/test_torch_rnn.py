"""The recurrent layers and runners, the port against the JAX package on
the CPU: ``F.rnn`` / ``F.birnn``, the three cells and ``RNN`` / ``BiRNN``
/ ``SimpleRNN`` / ``LSTM`` / ``GRU``, with ragged lengths, both
directions, stacked layers, given initial states and time-major input.

The JAX weights go into the port through ``convert.from_jax_params``
(names and shapes checked).  Held: outputs and final states at rtol 1e-5
(atol 1e-6), the gradient of sum(outputs * c) + sum(final h) with respect
to every weight and the input at rtol 1e-4 (atol 1e-5).  Padded steps
emit exact zeros and keep the carry in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.autograd import functional_call, parameters_dict
from paddle_tpu.nn.layer import rnn as jrnn
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import convert
from paddle_tpu_torch.nn.layer import rnn as trnn

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
B, T, IN, H = 4, 7, 5, 6
LENS = np.array([7, 3, 1, 5], np.int32)


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, ref, rtol=RTOL, atol=ATOL, what=""):
    gl, rl = _leaves(got), _leaves(ref)
    assert len(gl) == len(rl), what
    for g, r in zip(gl, rl):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=rtol,
                                   atol=atol, err_msg=what)


def _parity(jlayer, tlayer, x, *rest, seed=1):
    """Forward in both, then the gradients of sum(out * c) + sum of the
    final states' leaves with respect to every weight and to x."""
    jp = {k: np.asarray(v) for k, v in parameters_dict(jlayer).items()}
    convert.from_jax_params(jp, tlayer)
    jrest = [None if r is None else jnp.asarray(r) for r in rest]
    trest = [None if r is None else torch.from_numpy(r) for r in rest]
    ref = jlayer(jnp.asarray(x), *jrest)
    xt = torch.from_numpy(x).requires_grad_()
    got = tlayer(xt, *trest)
    _close(got[0], ref[0], what="outputs")
    _close(got[1], ref[1], what="final states")
    c = _x(*ref[0].shape, seed=seed)

    def loss(p, xj):
        out, st = functional_call(jlayer, p, (xj, *jrest))
        return jnp.sum(out * c) + sum(jnp.sum(s) for s in _leaves(st))

    jg, jgx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    (torch.sum(got[0] * torch.from_numpy(c))
     + sum(s.sum() for s in _leaves(got[1]))).backward()
    for k, p in tlayer.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(jg[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg="input")
    return got


@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("layers", [1, 2])
def test_networks_with_ragged_lengths(name, direction, layers):
    jl = getattr(jnn, name)(IN, H, layers, direction)
    tl = getattr(tnn, name)(IN, H, layers, direction)
    got = _parity(jl, tl, _x(B, T, IN), None, LENS)
    out = got[0].detach()
    for b, n in enumerate(LENS):
        assert bool((out[b, n:] == 0).all())


@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
def test_networks_time_major_with_initial_states(name):
    D, L = 2, 2
    jl = getattr(jnn, name)(IN, H, L, "bidirectional", time_major=True)
    tl = getattr(tnn, name)(IN, H, L, "bidirectional", time_major=True)
    init = _x(L * D, B, H, seed=4)
    init = (init, _x(L * D, B, H, seed=5)) if name == "LSTM" else init
    jp = {k: np.asarray(v) for k, v in parameters_dict(jl).items()}
    convert.from_jax_params(jp, tl)
    x = _x(T, B, IN)
    ref = jl(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, init),
             jnp.asarray(LENS))
    tinit = tuple(torch.from_numpy(i) for i in init) if name == "LSTM" \
        else torch.from_numpy(init)
    got = tl(torch.from_numpy(x), tinit, torch.from_numpy(LENS))
    _close(got, ref)


def test_simple_rnn_relu_and_no_biases():
    jl = jnn.SimpleRNN(IN, H, 1, "forward", 0.0, False, "relu", None, None,
                       False, False)
    tl = tnn.SimpleRNN(IN, H, 1, "forward", 0.0, False, "relu", None, None,
                       False, False)
    assert tl[0].cell.bias_ih is None and tl[0].cell.bias_hh is None
    _parity(jl, tl, _x(B, T, IN), None, LENS)
    with pytest.raises(ValueError):
        tnn.SimpleRNNCell(IN, H, "sigmoid")
    with pytest.raises(ValueError):
        tnn.GRU(IN, H, direction="backward")


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_cells_one_step(cell):
    jc, tc = getattr(jnn, cell)(IN, H), getattr(tnn, cell)(IN, H)
    convert.from_jax_params({k: np.asarray(v) for k, v in
                             parameters_dict(jc).items()}, tc)
    x = _x(B, IN)
    ref = jc(jnp.asarray(x))                 # zero initial states
    got = tc(torch.from_numpy(x))
    _close(got, ref)
    states = jax.tree_util.tree_map(np.array, ref[1])
    ref2 = jc(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, states))
    got2 = tc(torch.from_numpy(x), tuple(torch.from_numpy(s) for s in states)
              if cell == "LSTMCell" else torch.from_numpy(states))
    _close(got2, ref2)
    assert tc.state_shape == jc.state_shape


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_wrapper_and_functional_runner(reverse):
    jc, tc = jnn.GRUCell(IN, H), tnn.GRUCell(IN, H)
    jl, tl = jnn.RNN(jc, reverse), tnn.RNN(tc, reverse)
    _parity(jl, tl, _x(B, T, IN), None, LENS)
    # the runner called directly, on a time-major batch
    x = _x(T, B, IN, seed=2)
    ref = JF.rnn(jc, jnp.asarray(x), None, jnp.asarray(LENS), True, reverse)
    got = TF.rnn(tc, torch.from_numpy(x), None, torch.from_numpy(LENS), True,
                 reverse)
    _close(got, ref)


def test_reverse_pass_starts_at_each_rows_last_valid_step():
    """The reverse pass of a row of length n is the forward pass of its
    first n steps reversed: a flip of the padded batch would start it in
    the padding."""
    tc = tnn.GRUCell(IN, H)
    x = torch.from_numpy(_x(B, T, IN))
    out, final = TF.rnn(tc, x, None, torch.from_numpy(LENS), False, True)
    for b, n in enumerate(LENS):
        alone, alone_final = TF.rnn(tc, x[b:b + 1, :n].flip(1))
        torch.testing.assert_close(out[b, :n], alone[0].flip(0))
        torch.testing.assert_close(final[b], alone_final[0])


class _JCustom(jnn.Layer):
    """A cell that takes a keyword argument, which the runner passes on."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def get_initial_states(self, **kw):
        return self.inner.get_initial_states(**kw)

    def forward(self, x, states, scale=1.0):
        return self.inner(x * scale, states)


class _TCustom(tnn.Layer):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def get_initial_states(self, **kw):
        return self.inner.get_initial_states(**kw)

    def forward(self, x, states, scale=1.0):
        return self.inner(x * scale, states)


def test_birnn_with_a_cell_taking_keyword_arguments():
    jf, jb = jnn.LSTMCell(IN, H), jnn.LSTMCell(IN, H)
    tf_, tb = tnn.LSTMCell(IN, H), tnn.LSTMCell(IN, H)
    jl = jnn.BiRNN(_JCustom(jf), _JCustom(jb))
    tl = tnn.BiRNN(_TCustom(tf_), _TCustom(tb))
    convert.from_jax_params({k: np.asarray(v) for k, v in
                             parameters_dict(jl).items()}, tl)
    x = _x(B, T, IN)
    ref = jl(jnp.asarray(x), None, jnp.asarray(LENS), scale=0.5)
    got = tl(torch.from_numpy(x), None, torch.from_numpy(LENS), scale=0.5)
    _close(got, ref)
    ref = JF.birnn(_JCustom(jf), _JCustom(jb), jnp.asarray(x), None,
                   jnp.asarray(LENS), False, scale=2.0)
    got = TF.birnn(_TCustom(tf_), _TCustom(tb), torch.from_numpy(x), None,
                   torch.from_numpy(LENS), False, scale=2.0)
    _close(got, ref)


@pytest.mark.parametrize("components,bidirectional", [(1, False), (1, True),
                                                      (2, False), (2, True)])
def test_split_and_concat_states(components, bidirectional):
    packed = _x(4, B, H)
    packed = (packed, _x(4, B, H, seed=1)) if components == 2 else packed
    jpk = jax.tree_util.tree_map(jnp.asarray, packed)
    tpk = tuple(torch.from_numpy(p) for p in packed) if components == 2 \
        else torch.from_numpy(packed)
    js = jrnn.split_states(jpk, bidirectional, components)
    ts = trnn.split_states(tpk, bidirectional, components)
    _close(ts, js)
    _close(trnn.concat_states(ts, bidirectional, components),
           jrnn.concat_states(js, bidirectional, components))


def test_dropout_between_layers_in_training_only():
    tl = tnn.LSTM(IN, H, 2, dropout=0.5)
    x = torch.from_numpy(_x(B, T, IN))
    tl.eval()
    a, b = tl(x)[0], tl(x)[0]
    assert torch.equal(a, b)
    tl.train()
    P.seed(1)
    c = tl(x)[0]
    P.seed(1)
    assert torch.equal(c, tl(x)[0]) and not torch.equal(a, c)


def test_weights_drawn_from_the_generator_in_the_reference_layout():
    a = tnn.GRU(IN, H, 2, "bidirect", generator=torch.Generator()
                .manual_seed(3))
    b = tnn.GRU(IN, H, 2, "bidirect", generator=torch.Generator()
                .manual_seed(3))
    jl = jnn.GRU(IN, H, 2, "bidirect")
    names = dict(a.named_parameters())
    assert set(names) == set(parameters_dict(jl))
    for k, p in names.items():
        assert torch.equal(p, dict(b.named_parameters())[k])
        assert tuple(p.shape) == tuple(parameters_dict(jl)[k].shape)
        assert float(p.detach().abs().max()) <= 1 / np.sqrt(H)
    assert names["0.cell_fw.weight_ih"].shape == (3 * H, IN)
    assert names["1.cell_bw.weight_ih"].shape == (3 * H, 2 * H)
