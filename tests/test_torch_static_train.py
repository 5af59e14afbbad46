"""Static-graph training of the port against the JAX package, on the CPU.

Each program is built with each package's ``static.layers`` / ``nets``;
the JAX startup program's state is carried into the port by
``convert.static_state_from_jax`` (persistables paired in creation order:
parameters, BN statistics, the learning-rate variable and the optimizer
slots), and both Executors run the same feeds from numpy seeds.

* The eleven static optimizers over 3 steps of a small fc program: every
  parameter and slot at rel 1e-5 of its largest magnitude.  ``Dpsgd`` is
  held at its noise-free limit (sigma 0); with noise its draws cannot
  match ``jax.random``, so it is held for repeatability and for moving
  off the noise-free path.
* A JAX scope at step 2 continues in the port as in JAX (Adam: beta
  powers and moments carried).
* ``gradients()`` with respect to a data variable and to an intermediate
  (the JAX package's frozen-producer semantics).
* The Paddle book's two image-classification programs
  (tests/test_book_image_sentiment.py: ResNet-8 and the narrow VGG with its
  dropouts at 0) over 8 Adam steps: every step-1 gradient within
  ``GRAD_REL`` of the larger of its own largest magnitude and 1e-2 of the
  program's largest gradient (conv biases ahead of a train-mode BN have a
  gradient of 0 in exact arithmetic, so both packages return rounding
  noise there; measured 3.3e-5 / 3.7e-5 of that), and the losses within
  ``LOSS_REL`` of the largest (measured 7.6e-5 / 1.0e-6: ATen and XLA:CPU
  sum in other orders, and Adam's first steps move each weight by about
  ``lr`` whatever the gradient's size, so tiny differences grow).  At the book's
  dropout rates the port repeats itself for a fixed seed.
* ``DEFAULT_PIPELINE`` rewrites a training program (the book VGG with
  ``minimize``) as the JAX package does: ``fuse_conv_bn_act`` fires on
  every conv with train-mode ops that keep their running-stat writes, the
  other fusions and the layout pass skip the program, the optimizer
  updates survive DCE, and nothing rolls back.
"""
import numpy as np
import pytest

import paddle_tpu.static as jstatic
from paddle_tpu.core import flags as jflags
from paddle_tpu.static import layers as JL
from paddle_tpu.static import nets as jnets
from paddle_tpu.static import passes as JP
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.static import layers as TL
from paddle_tpu_torch.static import nets as tnets
from paddle_tpu_torch.static import passes as TP
from paddle_tpu_torch.utils import monitor as tmonitor

JAX = (jstatic, JL, jnets)
TORCH = (tstatic, TL, tnets)
OPT_REL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-2
LOSS_REL = 5e-4

OPTIMIZERS = {
    "SGD": lambda o: o.SGD(0.1),
    "Momentum": lambda o: o.Momentum(0.05, momentum=0.9, use_nesterov=True),
    "Adam": lambda o: o.Adam(0.01),
    "AdamW": lambda o: o.AdamW(0.01, weight_decay=0.1),
    "Adagrad": lambda o: o.Adagrad(0.1),
    "Adadelta": lambda o: o.Adadelta(1.0),
    "RMSProp": lambda o: o.RMSProp(0.01, momentum=0.5, centered=True),
    "Lamb": lambda o: o.Lamb(0.01),
    "Ftrl": lambda o: o.Ftrl(0.1, l1=0.01, l2=0.01),
    "LarsMomentum": lambda o: o.LarsMomentum(0.1),
    "Dpsgd": lambda o: o.Dpsgd(0.1, clip=1.0, batch_size=8.0, sigma=0.0),
}


# -- helpers -----------------------------------------------------------------

def _persistables(program):
    return [v.name for v in program.list_vars() if v.persistable]


def _jax_state(startup):
    scope = jstatic.Scope()
    jstatic.Executor().run(startup, scope=scope)
    return scope, {k: np.asarray(scope.find_var(k)) for k in scope.keys()}


def _rel(got, ref, floor=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), floor, 1e-30)


def _attrs(program):
    def canon(v):
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        return str(v) if not isinstance(v, (int, float, bool, str)) else v
    return [(op.type, {k: canon(v) for k, v in sorted(op.attrs.items())})
            for op in program.global_block().ops]


@pytest.fixture
def opt_passes():
    saved_j = jflags.get_flags(["opt_passes"])
    saved_t = tflags.get_flag("opt_passes")

    def set_(value):
        jflags.set_flags({"opt_passes": value})
        tflags.set_flags({"opt_passes": value})
    yield set_
    jflags.set_flags(saved_j)
    tflags.set_flags({"opt_passes": saved_t})


def _fc_program(pkg, make_opt):
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 5
    with static.program_guard(main, startup):
        x = L.data("x", [8])
        y = L.data("y", [1])
        h = L.fc(x, 16, act="relu")
        pred = L.fc(h, 1)
        loss = L.mean(L.square_error_cost(pred, y))
        make_opt(static.optimizer).minimize(loss)
    return main, startup, loss


def _fc_feed(step):
    rng = np.random.default_rng(30 + step)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    return {"x": x, "y": np.tanh(x[:, :1] - 2.0 * x[:, 1:2])}


def _run_fc(name, steps):
    """(jax main, port main, jax scope, port scope) after ``steps`` steps
    of both from the JAX startup state."""
    jmain, jstart, jloss = _fc_program(JAX, OPTIMIZERS[name])
    tmain, _, tloss = _fc_program(TORCH, OPTIMIZERS[name])
    jscope, init = _jax_state(jstart)
    tscope = convert.static_state_from_jax(jmain, init, tmain, "cpu")
    _steps(jmain, jloss, jscope, tmain, tloss, tscope, range(steps))
    return jmain, tmain, jscope, tscope


def _steps(jmain, jloss, jscope, tmain, tloss, tscope, steps):
    jexe, texe = jstatic.Executor(), tstatic.Executor("cpu")
    for s in steps:
        jl, = jexe.run(jmain, feed=_fc_feed(s), fetch_list=[jloss],
                       scope=jscope)
        tl, = texe.run(tmain, feed=_fc_feed(s), fetch_list=[tloss],
                       scope=tscope)
        assert _rel(tl, jl) <= OPT_REL, (s, tl, jl)


def _assert_state_close(jmain, tmain, jscope, tscope, tol):
    pairs = list(zip(_persistables(jmain), _persistables(tmain)))
    assert len(pairs) == len(_persistables(tmain)) > 0
    for jn, tn in pairs:
        ref = np.asarray(jscope.find_var(jn))
        got = tscope.find_var(tn).numpy()
        assert got.shape == ref.shape, (tn, got.shape, ref.shape)
        assert _rel(got, ref) <= tol, (tn, _rel(got, ref))


# -- the optimizers ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax_over_three_steps(name):
    jmain, tmain, jscope, tscope = _run_fc(name, 3)
    assert _attrs(tmain) == _attrs(jmain)
    _assert_state_close(jmain, tmain, jscope, tscope, OPT_REL)


def test_jax_scope_at_step_two_continues_in_the_port():
    jmain, jstart, jloss = _fc_program(JAX, OPTIMIZERS["Adam"])
    jscope, _ = _jax_state(jstart)
    jexe = jstatic.Executor()
    for s in range(2):
        jexe.run(jmain, feed=_fc_feed(s), fetch_list=[jloss], scope=jscope)
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    b1p = [k for k in state if k.endswith("_beta1_pow")]
    assert len(b1p) == 4 and all(abs(float(state[k]) - 0.81) < 1e-6
                                 for k in b1p)
    tmain, _, tloss = _fc_program(TORCH, OPTIMIZERS["Adam"])
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    _steps(jmain, jloss, jscope, tmain, tloss, tscope, range(2, 4))
    _assert_state_close(jmain, tmain, jscope, tscope, OPT_REL)


def test_dpsgd_noise_repeats_for_a_seed_and_moves_off_the_noise_free_path():
    def run(sigma):
        main, startup, loss = _fc_program(
            TORCH, lambda o: o.Dpsgd(0.1, clip=1.0, sigma=sigma))
        scope, exe = tstatic.Scope(), tstatic.Executor("cpu")
        exe.run(startup, scope=scope)
        for s in range(2):
            exe.run(main, feed=_fc_feed(s), fetch_list=[loss], scope=scope)
        return [scope.find_var(n).numpy() for n in _persistables(main)]

    a, b, clean = run(1.0), run(1.0), run(0.0)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert max(np.abs(x - y).max() for x, y in zip(a, clean)) > 1e-3


# -- gradients() ---------------------------------------------------------------

def _grad_program(pkg, wrt):
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 2
    with static.program_guard(main, startup):
        x = L.data("x", [3])
        w = L.create_parameter((3, 4), name="w_grad")
        h = L.relu(L.matmul(x, w))
        loss = L.mean(L.square(h))
        target = main.global_block().var("x") if wrt == "data" else h
        g = static.gradients(loss, target)[0]
    return main, startup, g, h


@pytest.mark.parametrize("wrt", ["data", "intermediate"])
def test_gradients_match_jax(wrt):
    jmain, jstart, jg, jh = _grad_program(JAX, wrt)
    tmain, _, tg, th = _grad_program(TORCH, wrt)
    assert _attrs(tmain) == _attrs(jmain)
    jscope, state = _jax_state(jstart)
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    xv = np.random.default_rng(0).normal(0, 1, (2, 3)).astype(np.float32)
    ref_g, ref_h = jstatic.Executor().run(jmain, feed={"x": xv},
                                          fetch_list=[jg, jh], scope=jscope)
    got_g, got_h = tstatic.Executor("cpu").run(
        tmain, feed={"x": xv}, fetch_list=[tg, th], scope=tscope)
    assert _rel(got_g, ref_g) <= 1e-6 and _rel(got_h, ref_h) <= 1e-6
    if wrt == "intermediate":   # d mean(h^2) / dh through the consumer only
        np.testing.assert_allclose(got_g, 2.0 * got_h / got_h.size,
                                   rtol=1e-6, atol=1e-8)
    else:
        w = state[[k for k in state if k == "w_grad"][0]]
        mask = (xv @ w > 0).astype(np.float32)
        np.testing.assert_allclose(
            got_g, (2.0 * got_h * mask / got_h.size) @ w.T, rtol=1e-5,
            atol=1e-7)


def test_fetches_and_scope_hold_no_autograd_graph():
    tmain, tstart, _ = _fc_program(TORCH, OPTIMIZERS["SGD"])
    scope, exe = tstatic.Scope(), tstatic.Executor("cpu")
    exe.run(tstart, scope=scope)
    h = [op.outputs["Out"][0] for op in tmain.global_block().ops
         if op.type == "relu"][0]
    out, = exe.run(tmain, feed=_fc_feed(0), fetch_list=[h], scope=scope,
                   return_numpy=False)
    assert not out.requires_grad and out.grad_fn is None
    for n in _persistables(tmain):
        v = scope.find_var(n)
        assert not v.requires_grad and v.grad_fn is None, n


# -- the book's image classification -----------------------------------------

def _conv_bn_layer(L, input, ch_out, filter_size, stride, padding, act="relu",
                   bias_attr=False):
    tmp = L.conv2d(input, ch_out, filter_size, stride=stride, padding=padding,
                   act=None, bias_attr=bias_attr)
    return L.batch_norm(tmp, act=act)


def resnet_cifar10(pkg, input, depth=8, widths=(8, 16, 32)):
    """The book's resnet_cifar10 (tests/test_book_image_sentiment.py:41;
    the book's own depth is 32 at widths 16 / 32 / 64)."""
    _, L, _ = pkg

    def shortcut(input, ch_in, ch_out, stride):
        if ch_in != ch_out:
            return _conv_bn_layer(L, input, ch_out, 1, stride, 0, None)
        return input

    def basicblock(input, ch_in, ch_out, stride):
        tmp = _conv_bn_layer(L, input, ch_out, 3, stride, 1)
        tmp = _conv_bn_layer(L, tmp, ch_out, 3, 1, 1, act=None,
                             bias_attr=None)
        short = shortcut(input, ch_in, ch_out, stride)
        return L.elementwise_add(tmp, short, act="relu")

    def layer_warp(input, ch_in, ch_out, count, stride):
        tmp = basicblock(input, ch_in, ch_out, stride)
        for _ in range(1, count):
            tmp = basicblock(tmp, ch_out, ch_out, 1)
        return tmp

    n = (depth - 2) // 6
    w1, w2, w3 = widths
    conv1 = _conv_bn_layer(L, input, w1, 3, 1, 1)
    res1 = layer_warp(conv1, w1, w1, n, 1)
    res2 = layer_warp(res1, w1, w2, n, 2)
    res3 = layer_warp(res2, w2, w3, n, 2)
    pool = input.shape[-1] // 4
    return L.pool2d(res3, pool, pool_type="avg", pool_stride=1)


def vgg_lite(pkg, input, drops=(0.3, 0.4, 0.5, 0.5)):
    """The book test's narrow vgg16_bn_drop
    (tests/test_book_image_sentiment.py:71)."""
    _, L, nets = pkg

    def conv_block(input, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input, conv_num_filter=[num_filter] * groups, pool_size=2,
            pool_stride=2, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True, conv_batchnorm_drop_rate=dropouts)

    conv1 = conv_block(input, 8, 2, [drops[0], 0.0])
    conv2 = conv_block(conv1, 16, 2, [drops[1], 0.0])
    drop = L.dropout(conv2, dropout_prob=drops[2])
    fc1 = L.fc(drop, 32, act=None)
    bn = L.batch_norm(fc1, act="relu")
    drop2 = L.dropout(bn, dropout_prob=drops[3])
    return L.fc(drop2, 32, act=None)


def book_program(pkg, net, drops=(0.0,) * 4, lr=0.01):
    """ref test_image_classification.py: body, fc(10, softmax),
    cross_entropy, mean, accuracy, Adam(lr).minimize."""
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 13
    with static.program_guard(main, startup):
        images = L.data("pixel", [3, 16, 16])
        label = L.data("label", [1], dtype="int64")
        body = (resnet_cifar10(pkg, images) if net == "resnet"
                else vgg_lite(pkg, images, drops))
        predict = L.fc(body, 10, act="softmax")
        avg_cost = L.mean(L.cross_entropy(predict, label))
        acc = L.accuracy(predict, label)
        _, p_g = static.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
    return main, startup, avg_cost, acc, [g.name for _, g in p_g]


def _cifar_batch(i, b=8):
    rng = np.random.default_rng(100 + i)
    return {"pixel": rng.normal(0, 1, (b, 3, 16, 16)).astype("float32"),
            "label": rng.integers(0, 10, (b, 1)).astype("int64")}


@pytest.mark.parametrize("net", ["resnet", "vgg"])
def test_book_program_trains_as_in_jax(net):
    jmain, jstart, jcost, jacc, jgrads = book_program(JAX, net)
    tmain, _, tcost, tacc, tgrads = book_program(TORCH, net)
    assert _attrs(tmain) == _attrs(jmain)
    assert len(jgrads) == len(tgrads) > 10
    jscope, state = _jax_state(jstart)
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    jexe, texe = jstatic.Executor(), tstatic.Executor("cpu")
    jl, jlosses, tlosses = None, [], []
    for i in range(8):
        feed = _cifar_batch(i)
        fj = [jcost, jacc] + (jgrads if i == 0 else [])
        ft = [tcost, tacc] + (tgrads if i == 0 else [])
        ref = jexe.run(jmain, feed=feed, fetch_list=fj, scope=jscope)
        got = texe.run(tmain, feed=feed, fetch_list=ft, scope=tscope)
        jlosses.append(float(ref[0]))
        tlosses.append(float(got[0]))
        assert abs(float(got[1]) - float(ref[1])) <= 1.0 / 8 + 1e-6
        if i == 0:
            top = max(np.abs(r).max() for r in ref[2:])
            for name, g, r in zip(tgrads, got[2:], ref[2:]):
                assert g.shape == r.shape
                assert _rel(g, r, GRAD_FLOOR * top) <= GRAD_REL, \
                    (name, _rel(g, r, GRAD_FLOOR * top))
    assert np.isfinite(tlosses).all()
    assert _rel(tlosses, jlosses) <= LOSS_REL, (tlosses, jlosses)


def test_book_vgg_repeats_at_the_books_dropout_rates():
    def run():
        main, startup, cost, _, _ = book_program(TORCH, "vgg",
                                                 drops=(0.3, 0.4, 0.5, 0.5))
        scope, exe = tstatic.Scope(), tstatic.Executor("cpu")
        exe.run(startup, scope=scope)
        return [float(exe.run(main, feed=_cifar_batch(i), fetch_list=[cost],
                              scope=scope)[0]) for i in range(3)]

    a, b = run(), run()
    assert a == b and np.isfinite(a).all()


# -- the pass pipeline on a training program --------------------------------------

def vgg16_bn_drop_train(pkg, widths=(8, 128, 128, 128, 128), fc=128):
    """The book's vgg16_bn_drop (as tests/test_torch_static.py builds it)
    with its loss, accuracy and ``Adam.minimize``."""
    static, L, nets = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 7

    def block(x, filters, groups, drops):
        return nets.img_conv_group(
            x, conv_num_filter=[filters] * groups, pool_size=2,
            pool_stride=2, conv_filter_size=3, conv_act="relu",
            conv_with_batchnorm=True, conv_batchnorm_drop_rate=drops)

    with static.program_guard(main, startup):
        img = L.data("img", [3, 32, 32])
        label = L.data("label", [1], dtype="int64")
        h = block(img, widths[0], 2, [0.3, 0])
        h = block(h, widths[1], 2, [0.4, 0])
        h = block(h, widths[2], 3, [0.4, 0.4, 0])
        h = block(h, widths[3], 3, [0.4, 0.4, 0])
        h = block(h, widths[4], 3, [0.4, 0.4, 0])
        h = L.dropout(h, dropout_prob=0.5)
        h = L.fc(h, fc, act=None)
        h = L.batch_norm(h, act="relu")
        h = L.dropout(h, dropout_prob=0.5)
        h = L.fc(h, fc, act=None)
        out = L.fc(h, 10, act="softmax")
        cost = L.mean(L.cross_entropy(out, label))
        L.accuracy(out, label)
        static.optimizer.Adam(1e-3).minimize(cost)
    return main, startup, cost


def test_default_pipeline_rewrites_a_training_program_as_jax_does(opt_passes):
    jmain, _, jcost = vgg16_bn_drop_train(JAX)
    tmain, tstart, tcost = vgg16_bn_drop_train(TORCH)
    feeds = {"img", "label"}
    jw, jrep = JP.PassManager(JP.DEFAULT_PIPELINE).apply(
        jmain, feed_names=feeds, fetch_names=[jcost.name])
    tw, trep = TP.PassManager(TP.DEFAULT_PIPELINE).apply(
        tmain, feed_names=feeds, fetch_names=[tcost.name])
    assert _attrs(tw) == _attrs(jw)
    assert [(p.name, p.changed, p.ops_before, p.ops_after, p.stats)
            for p in trep.passes] == \
        [(p.name, p.changed, p.ops_before, p.ops_after, p.stats)
         for p in jrep.passes]
    ops = tw.global_block().ops
    fused = [op for op in ops if op.type == "fused_conv2d_bn_act"]
    assert len(fused) == 13
    assert all(not op.attrs["is_test"] and op.outputs["MeanOut"]
               == op.inputs["Mean"] for op in fused)
    types = [op.type for op in ops]
    region, = [op for op in ops if op.type == "backward_region"]
    assert types.count("adam") == len(region.inputs["Params"]) == 60
    assert "fused_matmul_bias_act" not in types and "transpose2" not in types

    # the Executor runs the rewrite, and nothing rolls back
    rollbacks = tmonitor.counter("passes.rollbacks")
    before = rollbacks.value()
    opt_passes("default")
    scope, exe = tstatic.Scope(), tstatic.Executor("cpu")
    exe.run(tstart, scope=scope)
    rng = np.random.default_rng(1)
    feed = {"img": rng.normal(size=(2, 3, 32, 32)).astype(np.float32),
            "label": rng.integers(0, 10, (2, 1))}
    loss, = exe.run(tmain, feed=feed, fetch_list=[tcost], scope=scope)
    assert np.isfinite(loss) and rollbacks.value() == before
    assert [op.type for op in exe.executed_program(
        tmain, feeds, [tcost]).global_block().ops] == types
