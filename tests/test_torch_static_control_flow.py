"""Static control flow in the port against the JAX Executor on the CPU:
``cond``, ``while_loop`` (with the carry-dtype cast), ``StaticRNN`` and the
legacy ``While``, gradients through ``cond`` and ``StaticRNN``, a ``while``
on the parameter -> loss path refused by both packages, and a random op
inside a loop body drawing the same values every iteration in both.

Each program is built with each package's DSL; the JAX startup state is
carried into the port by ``convert.static_state_from_jax``."""
import numpy as np
import pytest

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert

JAX, TORCH = jstatic, tstatic
REL = 1e-5
GRAD_REL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _pair(build):
    """(jmain, jfetch, tmain, tfetch, jscope, tscope) for ``build(S)``,
    which returns (main, startup, fetch vars)."""
    jmain, jstart, jf = build(JAX)
    tmain, _, tf = build(TORCH)
    jscope = JAX.Scope()
    JAX.Executor().run(jstart, scope=jscope)
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    return jmain, jf, tmain, tf, jscope, tscope


def _run_both(pair, feed):
    jmain, jf, tmain, tf, jscope, tscope = pair
    want = JAX.Executor().run(jmain, feed=feed, fetch_list=jf, scope=jscope)
    got = TORCH.Executor("cpu").run(tmain, feed=feed, fetch_list=tf,
                                    scope=tscope)
    return got, want


def _cond_program(S, train=False):
    L = S.layers
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        x = L.data("x", [4], "float32")
        zero = L.fill_constant([], "float32", 0.0)
        pred = S.greater_than(L.reduce_sum(x), zero)
        out = S.cond(pred, lambda: L.fc(x, 4, act="tanh"),
                     lambda: L.scale(L.fc(x, 4), 2.0, bias=0.5))
        loss = L.mean(L.square(out))
        fetch = [out, loss]
        if train:
            grads = S.append_backward(loss)
            fetch += [g for _, g in grads]
    return main, start, fetch


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["true", "false"])
def test_cond_matches_the_jax_executor(sign):
    pair = _pair(_cond_program)
    x = sign * np.abs(np.random.default_rng(0).normal(
        0, 1, (3, 4))).astype(np.float32)
    got, want = _run_both(pair, {"x": x})
    for g, w in zip(got, want):
        assert _rel(g, w) <= REL


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["true", "false"])
def test_gradients_through_cond(sign):
    pair = _pair(lambda S: _cond_program(S, train=True))
    x = sign * np.abs(np.random.default_rng(1).normal(
        0, 1, (3, 4))).astype(np.float32)
    got, want = _run_both(pair, {"x": x})
    assert len(got) == 2 + 4          # out, loss, the two fcs' w and b
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.abs(w).max() == 0:      # the branch not taken: zero grads
            assert np.abs(g).max() == 0
        else:
            assert _rel(g, w) <= GRAD_REL


def _while_program(S):
    L = S.layers
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        x = L.data("x", [3], "float32")
        i = L.fill_constant([1], "int32", 0)
        n = L.fill_constant([1], "int32", 5)

        def body(i, acc):
            # scale turns the int32 counter into float32 at run time in
            # both packages; the Executor casts it back to the carry dtype
            return [L.scale(i, 1.0, bias=1.0),
                    L.elementwise_add(L.scale(acc, 0.5), L.tanh(acc))]

        i_out, acc = S.while_loop(lambda i, acc: S.less_than(i, n), body,
                                  [i, x])
    return main, start, [i_out, acc]


def test_while_loop_matches_the_jax_executor_and_casts_the_carry():
    pair = _pair(_while_program)
    x = np.random.default_rng(2).normal(0, 1, (2, 3)).astype(np.float32)
    got, want = _run_both(pair, {"x": x})
    assert got[0].dtype.kind == want[0].dtype.kind == "i"
    np.testing.assert_array_equal(got[0], want[0])
    assert int(got[0][0]) == 5
    assert _rel(got[1], want[1]) <= REL


def _rnn_program(S, T=4, B=2, D=3, H=5):
    L = S.layers
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        x = L.data("x", [T, B, D], "float32", append_batch_size=False)
        h0 = L.fill_constant([B, H], "float32", 0.1)
        rnn = S.StaticRNN()
        with rnn.step():
            w = rnn.step_input(x)
            prev = rnn.memory(init=h0)
            h = L.fc(L.concat([w, prev], axis=1), H, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        out = rnn()
        loss = L.mean(L.square(out))
        grads = S.append_backward(loss)
    return main, start, [out, loss] + [g for _, g in grads]


def test_static_rnn_and_its_gradients_match_the_jax_executor():
    pair = _pair(_rnn_program)
    x = np.random.default_rng(3).normal(0, 1, (4, 2, 3)).astype(np.float32)
    got, want = _run_both(pair, {"x": x})
    assert got[0].shape == (4, 2, 5)
    assert _rel(got[0], want[0]) <= REL
    assert _rel(got[1], want[1]) <= REL
    for g, w in zip(got[2:], want[2:]):
        assert _rel(g, w) <= GRAD_REL


@pytest.mark.parametrize("S", [JAX, TORCH], ids=["jax", "torch"])
def test_legacy_while_is_refused_by_both(S):
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        i = S.layers.fill_constant([1], "int32", 0)
        c = S.less_than(i, S.layers.fill_constant([1], "int32", 3))
        with pytest.raises(NotImplementedError):
            S.control_flow.While(c)


@pytest.mark.parametrize("S", [JAX, TORCH], ids=["jax", "torch"])
def test_while_on_the_loss_path_is_refused_by_both(S):
    L = S.layers
    main, start = S.Program(), S.Program()
    with S.program_guard(main, start):
        x = L.data("x", [3], "float32")
        i = L.fill_constant([1], "int32", 0)
        n = L.fill_constant([1], "int32", 2)
        _, y = S.while_loop(lambda i, y: S.less_than(i, n),
                            lambda i, y: [S.increment(i), L.fc(
                                y, 3, param_attr="w_loop", bias_attr=False)],
                            [i, x])
        loss = L.mean(y)
        with pytest.raises(NotImplementedError, match="while"):
            S.append_backward(loss)


def _dropout_loop(S):
    L = S.layers
    main, start = S.Program(), S.Program()
    main.random_seed = 5
    with S.program_guard(main, start):
        x = L.data("x", [64], "float32")
        i = L.fill_constant([1], "int32", 0)
        n = L.fill_constant([1], "int32", 3)

        def body(i, acc):
            return [S.increment(i),
                    L.elementwise_add(acc, L.dropout(
                        L.fill_constant([8, 64], "float32", 1.0), 0.5))]

        _, acc = S.while_loop(lambda i, acc: S.less_than(i, n), body,
                              [i, x])
    return main, start, [acc]


@pytest.mark.parametrize("S", [JAX, TORCH], ids=["jax", "torch"])
def test_a_dropout_in_a_loop_body_repeats_its_mask_every_iteration(S):
    main, start, fetch = _dropout_loop(S)
    exe = S.Executor() if S is JAX else S.Executor("cpu")
    zeros = np.zeros((8, 64), np.float32)
    acc, = exe.run(main, feed={"x": zeros}, fetch_list=fetch,
                   scope=S.Scope())
    # three draws of one mask: every element is 0 or 3 * 1 / (1 - p)
    assert set(np.unique(acc).tolist()) <= {0.0, 6.0}
    assert 0.3 < float((acc > 0).mean()) < 0.7
    again, = exe.run(main, feed={"x": zeros}, fetch_list=fetch,
                     scope=S.Scope())
    if S is TORCH:
        # the port's draw is a function of (seed, step, salt): the next
        # step draws another mask, the same program seed the same masks
        assert not np.array_equal(acc, again)
        first, = S.Executor("cpu").run(main, feed={"x": zeros},
                                       fetch_list=fetch, scope=S.Scope())
        np.testing.assert_array_equal(first, acc)
