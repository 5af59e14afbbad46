"""Static quantization-aware training of the port against the JAX package,
on the CPU: ``QuantizationTransformPass`` -> SGD steps ->
``QuantizationFreezePass`` -> ``QUANT_INFER_PIPELINE``.

The program is a conv (128 -> 128 channels, so the int8 conv gate takes
it) and two fcs (128 wide, then 10) with ``softmax_with_cross_entropy``;
its test program is cloned before ``minimize``, as the Paddle book does,
and both are transformed.

* The fake-quant functions and op lowerings against the JAX ones, with
  their straight-through gradients (the identity).
* The transform gives the same ops, attrs and startup program as the JAX
  package's (the state ``<act>@quant_moving_scale`` initialised to 0).
* 3 SGD steps, each from the JAX Executor's state at that step
  (``convert.static_state_from_jax``): every quant-dequant output, the
  loss, every gradient, the updated weights and the activation-scale
  state at rel 1e-5 (measured <= 7.1e-7).  An activation that lies a
  last bit from a rounding boundary in one backend flips one level, and
  then every later value differs by more than a last bit: such a batch
  is held only up to the flip (those elements one level apart), and the
  step is taken again from the same state on another batch, until one
  runs without a flip and is held in full (``_trained``; no flip in the
  three steps here).  The scales are held fixed
  after the first batch (``moving_rate`` 1) for the multi-step check:
  the JAX Executor's backward replays the forward from the state its
  forward already updated, so at an EMA rate below 1 its gradient from
  the second step on is that of another forward (the port's is that of
  its own, checked against the JAX Executor at a preset state).  At the
  default rate 0.9 the first step is held.
* The pool is an average: a QAT conv's outputs are sums of grid values
  and tie often, and XLA's and ATen's max-pool gradients break ties
  differently (measured 2.5e-2 on the conv weight's gradient with a
  max pool).
* The freeze, from the same trained state, gives the same ops and attrs
  (weight and frozen activation scales within rel 1e-5) and the
  int8-simulated weights on the same grid.
* ``QUANT_INFER_PIPELINE`` rewrites the frozen program as the JAX package
  does, and the port's Executor (its int8 wrappers' plain versions)
  matches the JAX Executor's (Pallas int8 kernels forced open, interpret
  mode) within 1e-4 of the largest logit; the conv and the 128-wide fc
  take rows 15 / 14.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.ops.pallas import config as pcfg
from paddle_tpu.slim import quant as jquant
from paddle_tpu.slim import quant_static as jqs
from paddle_tpu.static import passes as JP
from paddle_tpu.static.registry import get_lowering as jlowering
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert
from paddle_tpu_torch.ops.kernels import int8 as tint8
from paddle_tpu_torch.slim import quant as tquant
from paddle_tpu_torch.slim import quant_static as tqs
from paddle_tpu_torch.static import passes as TP
from paddle_tpu_torch.static.registry import get_lowering as tlowering
from test_torch_static_train import JAX, TORCH, _attrs, _jax_state, _rel

STEP_REL = 1e-5
PROGRAM_REL = 1e-4
STEADY_RATE = 1.0
MAX_FLIPS = 1e-3
MAX_DRAWS = 4
STATE_SUFFIX = "@quant_moving_scale"


@pytest.fixture
def tpu_gate(monkeypatch):
    monkeypatch.setattr(pcfg, "backend_is_tpu", lambda: True)


@pytest.fixture
def count_int8(monkeypatch):
    seen = {"conv": 0, "matmul": 0}

    def wrap(name, key):
        real = getattr(tint8, name)

        def counted(*a, **k):
            seen[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(tint8, name, counted)

    wrap("int8_conv2d_dequant", "conv")
    wrap("int8_matmul_dequant", "matmul")
    return seen


# -- the fake-quant functions and ops ------------------------------------------

def _jt(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x)).requires_grad_()


def test_fake_quant_functions_match_jax_with_identity_gradients():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (4, 6, 3, 3)).astype(np.float32)
    jx, tx = _jt(x)
    cases = [
        (jquant.fake_quant_dequant_abs_max(jx, 8),
         tquant.fake_quant_dequant_abs_max(tx, 8)),
        (jquant.fake_channel_wise_quant_dequant_abs_max(jx, 8, 1),
         tquant.fake_channel_wise_quant_dequant_abs_max(tx, 8, 1)),
        (jquant.fake_quant_dequant_moving_average_abs_max(jx, 1.5, 8, 0.9),
         tquant.fake_quant_dequant_moving_average_abs_max(tx, 1.5, 8, 0.9)),
        (jquant.fake_quant_dequant_moving_average_abs_max(
            jx, 0.0, 8, 0.9, training=False),
         tquant.fake_quant_dequant_moving_average_abs_max(
             tx, 0.0, 8, 0.9, training=False)),
    ]
    for (jy, js), (ty, ts) in cases:
        assert np.array_equal(ty.detach().numpy(), np.asarray(jy))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        tx.grad = None
        (ty * 3.0).sum().backward()
        assert torch.equal(tx.grad, torch.full_like(tx, 3.0))


@pytest.mark.parametrize("op_type,attrs", [
    ("fake_quantize_dequantize_abs_max", {"bit_length": 8}),
    ("fake_channel_wise_quantize_dequantize_abs_max",
     {"bit_length": 8, "quant_axis": 1}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"bit_length": 8, "moving_rate": 0.9}),
])
@pytest.mark.parametrize("state", [0.0, 2.5])
def test_fake_quant_ops_match_jax_op_by_op(op_type, attrs, state):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (5, 16)).astype(np.float32)
    s = np.array([state], np.float32)
    jins = {"X": [jnp.asarray(x)], "InScale": [jnp.asarray(s)]}
    tins = {"X": [torch.from_numpy(x)], "InScale": [torch.from_numpy(s)]}
    ref = jlowering(op_type)(jins, attrs, None)
    got = tlowering(op_type)(tins, attrs, None)
    for slot in ("Out", "OutScale"):
        assert np.array_equal(got[slot][0].numpy(), np.asarray(ref[slot][0]))


# -- the QAT program ------------------------------------------------------------

def qat_program(pkg):
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 17
    with static.program_guard(main, startup):
        img = L.data("img", [128, 6, 6])
        label = L.data("label", [1], dtype="int64")
        h = L.conv2d(img, 128, 3, padding=1, act="relu")
        h = L.pool2d(h, 2, "avg", 2)
        h = L.fc(L.flatten(h), 128, act="relu")
        logits = L.fc(h, 10)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        test = main.clone(for_test=True)
        static.optimizer.SGD(0.05).minimize(loss)
    return main, startup, test, logits, loss


def _feed(i, b=8, draw=0):
    rng = np.random.default_rng([50 + i, draw] if draw else 50 + i)
    return {"img": rng.normal(0, 1, (b, 128, 6, 6)).astype(np.float32),
            "label": rng.integers(0, 10, (b, 1)).astype(np.int64)}


def _transformed(pkg, qs, rate=0.9):
    main, startup, test, logits, loss = qat_program(pkg)
    qs.QuantizationTransformPass(moving_rate=rate).apply(main, startup)
    qs.QuantizationTransformPass(moving_rate=rate).apply(test)
    return main, startup, test, logits, loss


def _grads(program):
    return [n for n in program.global_block().vars if n.endswith("@GRAD")]


def _pairs(jprog, tprog):
    return list(zip([v.name for v in jprog.list_vars() if v.persistable],
                    [v.name for v in tprog.list_vars() if v.persistable]))


def _qdq(program):
    return [(op.outputs["Out"][0], (op.inputs.get("InScale") or [None])[0])
            for op in program.global_block().ops
            if op.type.startswith("fake_")]


def _step(jp, tp, feed, jscope):
    """One SGD step of each package on ``feed`` from the JAX scope's state
    (carried by ``convert.static_state_from_jax``).  Every quant-dequant
    output must agree within ``STEP_REL`` except at one-level flips (a
    value that the two backends compute a last bit apart and that lies on
    a rounding boundary), at most ``MAX_FLIPS`` of its elements, one level
    each.  Without a flip the loss, every gradient and every updated
    persistable agree within ``STEP_REL``, and the port's loss is
    returned; with one, the JAX scope goes back to its state before the
    step and None is returned.  Returns (loss or None, flips)."""
    (jmain, jloss), (tmain, tloss) = jp, tp
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    jq, tq = _qdq(jmain), _qdq(tmain)
    ref = jstatic.Executor().run(
        jmain, feed=feed, scope=jscope,
        fetch_list=[jloss] + [n for n, _ in jq] + _grads(jmain))
    got = tstatic.Executor("cpu").run(
        tmain, feed=feed, scope=tscope,
        fetch_list=[tloss] + [n for n, _ in tq] + _grads(tmain))
    flips = 0
    for k, (name, state_name) in enumerate(tq):
        g, r = got[1 + k], ref[1 + k]
        off = np.abs(g - r) > STEP_REL * np.abs(r).max()
        if off.any():
            assert state_name is not None, name  # weights never flip
            scale = float(tscope.find_var(state_name).reshape(-1)[0])
            assert off.sum() <= MAX_FLIPS * off.size, (name, off.sum())
            assert np.abs(g - r).max() <= 1.001 * scale / 127, name
            flips += int(off.sum())
    if flips:
        for k, v in state.items():
            jscope.set(k, jnp.asarray(v))
        return None, flips
    names = ["loss"] + [n for n, _ in tq] + _grads(tmain)
    for name, g, r in zip(names, got, ref):
        assert _rel(g, r) <= STEP_REL, (name, _rel(g, r))
    for jn, tn in _pairs(jmain, tmain):
        r, g = np.asarray(jscope.find_var(jn)), tscope.find_var(tn).numpy()
        assert _rel(g, r) <= STEP_REL, (tn, _rel(g, r))
    return float(got[0]), 0


def _trained(steps=3, rate=STEADY_RATE):
    """Both packages' QAT programs, trained ``steps`` SGD steps by the JAX
    Executor, each step held in full against the port's from the same
    state (``_step``) on the first of up to ``MAX_DRAWS`` batches that
    runs without a flip.  Returns (JAX test, logits, scope), the port's
    (test, logits, scope holding the JAX scope's state), the port's
    losses and, for each step, the flips of each batch drawn."""
    jmain, jstart, jtest, jlogits, jloss = _transformed(JAX, jqs, rate)
    tmain, _, ttest, tlogits, tloss = _transformed(TORCH, tqs, rate)
    jscope, _ = _jax_state(jstart)
    losses, flips = [], []
    for i in range(steps):
        seen = []
        for draw in range(MAX_DRAWS):
            loss, n = _step((jmain, jloss), (tmain, tloss),
                            _feed(i, draw=draw), jscope)
            seen.append(n)
            if loss is not None:
                break
        assert loss is not None, (i, seen)
        losses.append(loss)
        flips.append(seen)
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    return ((jtest, jlogits, jscope), (ttest, tlogits, tscope), losses,
            flips)


def test_transform_matches_jax():
    jmain, jstart, jtest, _, _ = _transformed(JAX, jqs)
    tmain, tstart, ttest, _, _ = _transformed(TORCH, tqs)
    for j, t in ((jmain, tmain), (jstart, tstart), (jtest, ttest)):
        assert _attrs(t) == _attrs(j)
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fake_channel_wise_quantize_dequantize_abs_max") == 3
    assert types.count(
        "fake_quantize_dequantize_moving_average_abs_max") == 3
    states = [v.name for v in tmain.list_vars()
              if v.name.endswith(STATE_SUFFIX)]
    assert len(states) == 3 and all(
        tmain.global_block().var(n).persistable for n in states)
    scope = tstatic.Scope()
    tstatic.Executor("cpu").run(tstart, scope=scope)
    assert all(float(scope.find_var(n)) == 0.0 for n in states)


def test_qat_sgd_steps_match_jax():
    """3 steps with the activation scales fixed after the first batch
    (``moving_rate`` 1)."""
    _, (_, _, tscope), losses, flips = _trained(3)
    assert len(losses) == 3 and np.isfinite(losses).all(), flips
    states = [n for n in tscope.keys() if n.endswith(STATE_SUFFIX)]
    assert len(states) == 3 and all(float(tscope.find_var(n)) > 0
                                    for n in states)


def test_qat_first_step_at_the_ema_rate_matches_jax():
    _trained(1, rate=0.9)


def test_qat_gradient_is_that_of_the_forward_the_port_ran():
    """At ``moving_rate`` 0.9 the port's second-step gradient is the
    gradient of its forward, whose activation scale is the state it writes
    (``0.9 * old + 0.1 * amax``): the JAX Executor's gradient of a program
    that quantizes at that state (``moving_rate`` 1, state preset) from the
    same weights.  (The JAX Executor's own step at 0.9 differs: its
    backward replays the forward from the state its forward already
    updated; ROADMAP, found in the reference.)"""
    jmain, jstart, _, _, jloss = _transformed(JAX, jqs, 0.9)
    tmain, _, _, _, tloss = _transformed(TORCH, tqs, 0.9)
    jscope, state = _jax_state(jstart)
    jstatic.Executor().run(jmain, feed=_feed(0), fetch_list=[jloss],
                           scope=jscope)
    tscope = convert.static_state_from_jax(
        jmain, {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()},
        tmain, "cpu")
    got = tstatic.Executor("cpu").run(
        tmain, feed=_feed(1), fetch_list=[tloss] + _grads(tmain),
        scope=tscope)
    # the weights before the port's step (SGD: w_before = w_after + lr g)
    lr = float(tscope.find_var([n for n in tscope.keys()
                                if n.startswith("learning_rate")][0]))
    before = {p: tscope.find_var(p).numpy() + lr * g
              for p, g in zip([n[:-len("@GRAD")] for n in _grads(tmain)],
                              got[1:])}
    fixed, fstart, _, _, floss = _transformed(JAX, jqs, 1.0)
    fscope, _ = _jax_state(fstart)
    for fn, tn in _pairs(fixed, tmain):
        value = before[tn] if tn in before else tscope.find_var(tn).numpy()
        fscope.set(fn, jnp.asarray(value))
    ref = jstatic.Executor().run(fixed, feed=_feed(1),
                                 fetch_list=[floss] + _grads(fixed),
                                 scope=fscope)
    for name, g, r in zip(["loss"] + _grads(tmain), got, ref):
        assert _rel(g, r) <= 10 * STEP_REL, (name, _rel(g, r))


def _frozen():
    """The trained test programs frozen from the same state (the JAX
    scope's, carried into the port)."""
    (jtest, jlogits, jscope), (ttest, tlogits, tscope), _, _ = _trained()
    jqs.QuantizationFreezePass(jscope).apply(jtest)
    tqs.QuantizationFreezePass(tscope).apply(ttest)
    return (jtest, jlogits, jscope), (ttest, tlogits, tscope)


def _split(attrs, approx=("weight_scale", "scale")):
    return ({k: v for k, v in attrs.items() if k not in approx},
            {k: np.asarray(v, np.float64) for k, v in attrs.items()
             if k in approx})


def test_freeze_matches_jax():
    (jtest, _, jscope), (ttest, _, tscope) = _frozen()
    jops, tops = jtest.global_block().ops, ttest.global_block().ops
    assert [op.type for op in tops] == [op.type for op in jops]
    types = [op.type for op in tops]
    assert types.count("fake_quantize_dequantize_fixed_scale") == 3
    assert not any(t.startswith("fake_") and t.endswith("abs_max")
                   for t in types)
    for jo, to in zip(jops, tops):
        (jexact, japprox), (texact, tapprox) = _split(jo.attrs), \
            _split(to.attrs)
        assert texact == jexact
        assert sorted(tapprox) == sorted(japprox)
        for k in japprox:
            assert _rel(tapprox[k], japprox[k]) <= STEP_REL, (to.type, k)
    for jo, to in zip(jops, tops):
        if "weight_scale" not in to.attrs:
            continue
        wname = to.inputs["Filter" if to.type == "conv2d" else "Y"][0]
        jname = jo.inputs["Filter" if jo.type == "conv2d" else "Y"][0]
        w = tscope.find_var(wname).numpy()
        ref = np.asarray(jscope.find_var(jname))
        step = np.asarray(to.attrs["weight_scale"], np.float32) / 127.0
        axis = 0 if w.ndim == 4 else 1
        shape = [1] * w.ndim
        shape[axis] = -1
        grid = w / step.reshape(shape)
        np.testing.assert_allclose(grid, np.round(grid), atol=1e-3)
        assert _rel(w, ref) <= STEP_REL


def test_frozen_program_under_quant_infer_matches_jax(tpu_gate, count_int8):
    (jtest, jlogits, jscope), (ttest, tlogits, tscope) = _frozen()
    feeds = {"img"}
    jw, jrep = JP.PassManager(JP.QUANT_INFER_PIPELINE).apply(
        jtest, feed_names=feeds, fetch_names=[jlogits.name])
    tw, trep = TP.PassManager(TP.QUANT_INFER_PIPELINE).apply(
        ttest, feed_names=feeds, fetch_names=[tlogits.name])
    assert [op.type for op in tw.global_block().ops] == \
        [op.type for op in jw.global_block().ops]
    assert [(p.name, p.ops_before, p.ops_after, p.stats)
            for p in trep.passes] == \
        [(p.name, p.ops_before, p.ops_after, p.stats) for p in jrep.passes]
    types = [op.type for op in tw.global_block().ops]
    assert types.count("quant_conv2d") == 1 and types.count("quant_mul") == 2
    feed = {"img": _feed(9)["img"]}
    with jstatic.scope_guard(jscope):
        ref, = jstatic.Executor().run(jw, feed=feed,
                                      fetch_list=[jlogits.name])
    got, = tstatic.Executor("cpu").run(tw, feed=feed,
                                       fetch_list=[tlogits.name],
                                       scope=tscope)
    assert got.shape == (8, 10)
    assert _rel(got, ref) <= PROGRAM_REL, _rel(got, ref)
    assert count_int8 == {"conv": 1, "matmul": 1}
