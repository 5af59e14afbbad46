"""Static-graph vision inference of the port against the JAX package, on
the CPU.

Two programs, built with each package's ``static.layers`` / ``nets``:
``bench_vision.py``'s conv tower (conv/BN/relu/pool x2 + fc) and the Paddle
book's ``vgg16_bn_drop`` (five ``img_conv_group`` blocks, BN + dropout,
fc 512 / BN / fc 512 / fc 10 + softmax), each cloned with
``for_test=True``.  At a narrow width whose groups 2-5 have 128 channels
the kernel gates pass on the same ops as at full width.

* The programs, and their rewrites by ``DEFAULT_PIPELINE`` (op sequence
  and each pass's report), are the same in both packages.
* At full width (VGG 64-512, batch 128; the tower at 128 channels) the ops
  whose JAX dispatch takes the kernels are counted without running the
  JAX program (fused convs 10 / pools 4; tower 1 / 2), and the port's
  Executor dispatches exactly as many to its kernel wrappers.
* ``Executor.run`` fetches match the JAX Executor's (kernel gate forced
  open, so its Pallas kernels run in interpret mode) within 1e-4 of each
  fetch's largest magnitude, the state carried over by
  ``convert.static_state_from_jax`` with random BN statistics.
* Pipeline on against off (``golden_parity``) within the same tolerance;
  rollbacks are counted; constant folding and CSE fold and merge the same
  ops as the JAX passes.
* The main (train-mode) VGG program runs the fused conv's training route,
  and with its dropout rates at 0 matches the JAX Executor; a float64
  feed runs in float32 as in the JAX package; ``dropout`` at p = 1
  returns zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core import flags as jflags
from paddle_tpu.nn.functional import pooling as jpooling
from paddle_tpu.ops.pallas import config as pcfg
from paddle_tpu.static import layers as JL
from paddle_tpu.static import nets as jnets
from paddle_tpu.static import ops_fused as jops_fused
from paddle_tpu.static import passes as JP
from paddle_tpu.utils import monitor as jmonitor
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import errors as terrors
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.ops.kernels import conv_fused as tcf
from paddle_tpu_torch.ops.kernels import pooling as tpool
from paddle_tpu_torch.static import layers as TL
from paddle_tpu_torch.static import nets as tnets
from paddle_tpu_torch.static import passes as TP
from paddle_tpu_torch.utils import monitor as tmonitor

REL_TOL = 1e-4
JAX = (jstatic, JL, jnets)
TORCH = (tstatic, TL, tnets)
VGG_FULL = dict(widths=(64, 128, 256, 512, 512), fc=512)
VGG_NARROW = dict(widths=(8, 128, 128, 128, 128), fc=128)


def conv_tower(pkg, ch=128, size=32):
    """bench_vision.py's _conv_tower (conv/BN(relu)/pool x2 + fc 10)."""
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 11
    with static.program_guard(main, startup):
        img = L.data("img", [3, size, size])
        h = L.conv2d(img, ch, 3, padding=1)
        h = L.batch_norm(h, act="relu", is_test=True)
        h = L.pool2d(h, 2, "max", 2)
        h = L.conv2d(h, ch, 3, padding=1)
        h = L.batch_norm(h, act="relu", is_test=True)
        h = L.pool2d(h, 2, "max", 2)
        out = L.fc(L.flatten(h), 10)
    return main, startup, out


def vgg16_bn_drop(pkg, widths=VGG_FULL["widths"], fc=VGG_FULL["fc"]):
    """The Paddle book's image-classification VGG (chapter 03,
    test_image_classification.py vgg16_bn_drop) on 3 x 32 x 32."""
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
    return main, startup, out


MODELS = {
    "tower": (lambda pkg: conv_tower(pkg), 32),
    "vgg": (lambda pkg: vgg16_bn_drop(pkg, **VGG_NARROW), 32),
}


def _build(model, pkg):
    fn, size = MODELS[model]
    main, startup, out = fn(pkg)
    return main.clone(for_test=True), startup, out, size


def _ops(program):
    return [op.type for op in program.global_block().ops]


def _fetches(program, out):
    """The output and, where it is a softmax, its input logits (a softmax
    of random weights saturates to exact 0s and 1s)."""
    last = program.global_block().ops[-1]
    if last.type == "softmax":
        return [last.inputs["X"][0], out.name]
    return [out.name]


def _attrs(program):
    def canon(v):
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        return str(v) if not isinstance(v, (int, float, bool, str)) else v
    return [(op.type, {k: canon(v) for k, v in sorted(op.attrs.items())})
            for op in program.global_block().ops]


@pytest.fixture
def tpu_gate(monkeypatch):
    monkeypatch.setattr(pcfg, "backend_is_tpu", lambda: True)


@pytest.fixture
def opt_passes():
    """Set both packages' ``opt_passes`` flag; restored afterwards."""
    saved_j = jflags.get_flags(["opt_passes"])
    saved_t = tflags.get_flag("opt_passes")

    def set_(value):
        jflags.set_flags({"opt_passes": value})
        tflags.set_flags({"opt_passes": value})
    yield set_
    jflags.set_flags(saved_j)
    tflags.set_flags({"opt_passes": saved_t})


@pytest.fixture
def count_dispatch(monkeypatch):
    """Count the port's dispatches to its kernel wrappers (on the CPU a
    wrapper runs its plain version and its launch counter stays 0)."""
    seen = {"conv": 0, "max_pool": 0, "avg_pool": 0}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def counted(*a, **k):
            seen[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    wrap(tcf, "conv2d_bn_act", "conv")
    wrap(tpool, "max_pool2d_nhwc", "max_pool")
    wrap(tpool, "avg_pool2d_nhwc", "avg_pool")
    return seen


# -- program structure ------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
def test_programs_are_the_same_in_both_packages(model):
    jmain, jstart, _, _ = _build(model, JAX)
    tmain, tstart, _, _ = _build(model, TORCH)
    assert _attrs(tmain) == _attrs(jmain)
    assert _attrs(tstart) == _attrs(jstart)
    assert [tuple(v.shape) for v in tmain.list_vars() if v.persistable] \
        == [tuple(v.shape) for v in jmain.list_vars() if v.persistable]
    for op in tmain.global_block().ops:
        if op.type in ("dropout", "batch_norm"):
            assert op.attrs["is_test"] is True


@pytest.mark.parametrize("model", sorted(MODELS))
def test_default_pipeline_rewrites_the_same_way(model):
    jmain, _, jout, _ = _build(model, JAX)
    tmain, _, tout, _ = _build(model, TORCH)
    jw, jrep = JP.PassManager(JP.DEFAULT_PIPELINE).apply(
        jmain, feed_names={"img"}, fetch_names=[jout.name])
    tw, trep = TP.PassManager(TP.DEFAULT_PIPELINE).apply(
        tmain, feed_names={"img"}, fetch_names=[tout.name])
    assert tuple(TP.DEFAULT_PIPELINE) == tuple(JP.DEFAULT_PIPELINE)
    assert _attrs(tw) == _attrs(jw)
    assert [(p.name, p.changed, p.ops_before, p.ops_after, p.stats)
            for p in trep.passes] == \
        [(p.name, p.changed, p.ops_before, p.ops_after, p.stats)
         for p in jrep.passes]
    assert (trep.ops_before, trep.ops_after) == (jrep.ops_before,
                                                 jrep.ops_after)
    assert _ops(tmain) != _ops(tw)          # the caller's program is kept
    assert "fused_conv2d_bn_act" in _ops(tw)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_op_of_both_programs_is_registered(model):
    tmain, tstart, tout, _ = _build(model, TORCH)
    tw, _ = TP.PassManager().apply(tmain, {"img"}, [tout.name])
    types = set(_ops(tmain)) | set(_ops(tstart)) | set(_ops(tw))
    assert types >= {"conv2d", "batch_norm", "relu", "pool2d", "mul",
                     "elementwise_add", "uniform_random", "fill_constant",
                     "fused_conv2d_bn_act", "transpose2",
                     "fused_matmul_bias_act"}
    missing = types - set(tstatic.registered_ops())
    assert not missing, missing


# -- kernel dispatch counts at full width --------------------------------------------

def _jax_kernel_ops(program, batch):
    """(fused convs, pools) of a JAX rewritten program whose JAX dispatch
    takes the Pallas kernels at ``batch`` (gate forced open; nothing run)."""
    block = program.global_block()

    def spec(name):
        v = block.var(name)
        return jax.ShapeDtypeStruct(
            tuple(batch if d < 0 else d for d in v.shape), v.dtype)

    convs = pools = 0
    for op in block.ops:
        a = op.attrs
        if op.type == "fused_conv2d_bn_act":
            pair = jops_fused._pair
            convs += jops_fused._use_pallas_conv(
                spec(op.inputs["Input"][0]), spec(op.inputs["Filter"][0]),
                pair(a["strides"]), pair(a["paddings"]),
                pair(a["dilations"]), a["groups"], a["act"],
                a["data_format"])
        elif op.type == "pool2d":
            k = jpooling._pair(a["ksize"])
            pools += jpooling._use_pallas_pool(
                spec(op.inputs["X"][0]), k, jpooling._pair(a["strides"]),
                jpooling._pair(a["paddings"]), a["pooling_type"], True,
                a.get("data_format", "NCHW"))
    return convs, pools


@pytest.mark.parametrize("model,want", [("vgg", (10, 4)), ("tower", (1, 2))])
def test_full_width_kernel_counts_match_jax(model, want, tpu_gate,
                                            opt_passes, count_dispatch):
    build = vgg16_bn_drop if model == "vgg" else conv_tower
    jmain, _, jout = build(JAX)
    jw, _ = JP.PassManager().apply(jmain.clone(for_test=True), {"img"},
                                   [jout.name])
    assert _jax_kernel_ops(jw, 128) == want

    tmain, tstart, tout = build(TORCH)
    scope = tstatic.Scope()
    exe = tstatic.Executor("cpu")
    exe.run(tstart, scope=scope)
    opt_passes("default")
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32))
    out, = exe.run(tmain.clone(for_test=True),
                   feed={"img": x.astype(np.float32)}, fetch_list=[tout],
                   scope=scope)
    assert out.shape == (1, 10) and np.isfinite(out).all()
    assert (count_dispatch["conv"], count_dispatch["max_pool"],
            count_dispatch["avg_pool"]) == (want[0], want[1], 0)


# -- the Executor against the JAX Executor ------------------------------------------

def _jax_state(startup, seed):
    """The JAX startup program's persistables, BN statistics and affine
    parameters replaced by random values (positive variances)."""
    scope = jstatic.Scope()
    with jstatic.scope_guard(scope):
        jstatic.Executor().run(startup)
    rng = np.random.default_rng(seed)
    state = {}
    for k in scope.keys():
        v = np.asarray(scope.find_var(k))
        if k.endswith(".var"):
            v = rng.uniform(0.5, 2.0, v.shape)
        elif k.endswith(".mean"):
            v = rng.normal(0.0, 0.5, v.shape)
        elif k.endswith(".scale"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith(".bias") and "batch_norm" in k:
            v = rng.normal(0.0, 0.5, v.shape)
        state[k] = np.asarray(v, np.float32)
    return state


@pytest.mark.parametrize("model", sorted(MODELS))
def test_executor_matches_jax_executor(model, tpu_gate, opt_passes,
                                       count_dispatch):
    jmain, jstart, jout, size = _build(model, JAX)
    tmain, _, tout, _ = _build(model, TORCH)
    state = _jax_state(jstart, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, 3, size, size)).astype(np.float32)
    opt_passes("default")
    jscope = jstatic.Scope()
    for k, v in state.items():
        jscope.set(k, jnp.asarray(v))
    calls = jmonitor.counter("pallas.kernel_calls", labelnames=("kernel",))
    before = {k: calls.value(kernel=k)
              for k in ("conv2d_bn_act", "max_pool2d", "avg_pool2d")}
    refs = jstatic.Executor().run(jmain, feed={"img": x},
                                  fetch_list=_fetches(jmain, jout),
                                  scope=jscope)
    jax_calls = {k: calls.value(kernel=k) - v for k, v in before.items()}

    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    gots = tstatic.Executor("cpu").run(tmain, feed={"img": x},
                                       fetch_list=_fetches(tmain, tout),
                                       scope=tscope)
    assert len(gots) == len(refs)
    for got, ref in zip(gots, refs):
        assert got.shape == ref.shape
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= REL_TOL, err
    # the JAX trace ran each kernel once per op: the same ops as the port's
    assert (count_dispatch["conv"], count_dispatch["max_pool"]) == \
        (jax_calls["conv2d_bn_act"], jax_calls["max_pool2d"])
    assert count_dispatch["conv"] > 0


def test_static_state_from_jax_checks_shapes():
    jmain, jstart, _, _ = _build("tower", JAX)
    tmain = conv_tower(TORCH, ch=64)[0].clone(for_test=True)
    state = _jax_state(jstart, seed=0)
    with pytest.raises(ValueError, match="shape"):
        convert.static_state_from_jax(jmain, state, tmain, "cpu")


# -- pipeline on against off, rollbacks, refusals ---------------------------------

@pytest.mark.parametrize("model", sorted(MODELS))
def test_golden_parity_pipeline_on_against_off(model, opt_passes):
    tmain, tstart, tout, size = _build(model, TORCH)
    scope = tstatic.Scope()
    tstatic.Executor("cpu").run(tstart, scope=scope)
    state = {k: scope.find_var(k).numpy() for k in scope.keys()}
    x = np.random.default_rng(5).standard_normal(
        (2, 3, size, size)).astype(np.float32)
    opt_passes("")
    fetches = _fetches(tmain, tout)
    refs = tstatic.Executor("cpu").run(tmain, feed={"img": x},
                                       fetch_list=fetches, scope=scope)
    rewritten, _ = TP.PassManager().apply(tmain, {"img"}, fetches)
    assert "fused_conv2d_bn_act" in _ops(rewritten)
    for name, ref in zip(fetches, refs):
        rep = TP.golden_parity(tmain, rewritten, {"img": x}, [name],
                               state=state, rtol=0.0,
                               atol=REL_TOL * float(np.abs(ref).max()),
                               place="cpu")
        assert rep.ok, rep.to_text()
    assert rep.state_max_err == 0.0     # is_test: the state is read only


def test_failed_pipeline_rolls_back_and_counts(opt_passes, monkeypatch):
    tmain, tstart, tout, size = _build("tower", TORCH)
    scope = tstatic.Scope()
    exe = tstatic.Executor("cpu")
    exe.run(tstart, scope=scope)
    x = np.zeros((1, 3, size, size), np.float32)
    opt_passes("default")
    rollbacks = tmonitor.counter("passes.rollbacks")
    before = rollbacks.value()

    def broken(program, ctx):
        raise RuntimeError("pass failed")
    monkeypatch.setattr(TP._REGISTRY["layout_nhwc"], "run", broken)
    out, = exe.run(tmain, feed={"img": x}, fetch_list=[tout], scope=scope)
    assert rollbacks.value() == before + 1
    assert exe.executed_program(tmain, ["img"], [tout]) is tmain
    assert out.shape == (1, 10)


def test_pv011_refuses_a_rewrite_that_drops_a_fetch():
    tmain, _, tout, _ = _build("tower", TORCH)
    broken = tmain.clone()
    block = broken.global_block()
    for i in range(len(block.ops) - 1, -1, -1):
        if tout.name in block.ops[i].output_names():
            block.remove_op(i)
    with pytest.raises(terrors.ProgramVerificationError, match="PV011"):
        TP.verify_rewrite(tmain, broken, ["img"], [tout.name])


def test_training_mode_fused_conv_raises(tpu_gate, opt_passes):
    """The train-mode fused conv used to raise; now the VGG main program
    (not cloned for test) runs under DEFAULT_PIPELINE with its dropouts,
    and with its dropout rates set to 0 in both packages (the port's masks
    cannot match jax.random) its fetches and every running statistic match
    the JAX Executor's within REL_TOL of their largest magnitude."""
    jmain, jstart, jout = vgg16_bn_drop(JAX, **VGG_NARROW)
    tmain, tstart, tout = vgg16_bn_drop(TORCH, **VGG_NARROW)
    opt_passes("default")
    x = np.random.default_rng(9).standard_normal((4, 3, 32, 32)) \
        .astype(np.float32)
    scope = tstatic.Scope()
    exe = tstatic.Executor("cpu")
    exe.run(tstart, scope=scope)
    out, = exe.run(tmain, feed={"img": x}, fetch_list=[tout], scope=scope)
    assert out.shape == (4, 10) and np.isfinite(out).all()
    fused = [op for op in exe.executed_program(
        tmain, ["img"], [tout]).global_block().ops
        if op.type == "fused_conv2d_bn_act"]
    assert len(fused) == 13 and not any(op.attrs["is_test"] for op in fused)

    for prog in (jmain, tmain):
        for op in prog.global_block().ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0
        prog.bump_version()
    state = _jax_state(jstart, seed=10)
    jscope = jstatic.Scope()
    for k, v in state.items():
        jscope.set(k, jnp.asarray(v))
    refs = jstatic.Executor().run(jmain, feed={"img": x},
                                  fetch_list=_fetches(jmain, jout),
                                  scope=jscope)
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    gots = tstatic.Executor("cpu").run(tmain, feed={"img": x},
                                       fetch_list=_fetches(tmain, tout),
                                       scope=tscope)
    for got, ref in zip(gots, refs):
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= REL_TOL, err
    stats = [[n for op in p.global_block().ops if op.type == "batch_norm"
              for n in op.inputs["Mean"] + op.inputs["Variance"]]
             for p in (jmain, tmain)]
    assert len(stats[0]) == len(stats[1]) == 28
    for jn, tn in zip(*stats):
        ref = np.asarray(jscope.find_var(jn))
        err = np.abs(tscope.find_var(tn).numpy() - ref).max() \
            / np.abs(ref).max()
        assert err <= REL_TOL, (tn, err)


def _conv_fc_program(pkg):
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 3
    with static.program_guard(main, startup):
        img = L.data("img", [3, 8, 8])
        h = L.conv2d(img, 4, 3, padding=1, act="relu")
        out = L.fc(L.flatten(h), 5)
    return main, startup, out


def test_float64_feed_runs_in_float32_as_in_jax():
    jmain, jstart, jout = _conv_fc_program(JAX)
    tmain, _, tout = _conv_fc_program(TORCH)
    state = _jax_state(jstart, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 3, 8, 8))  # float64
    assert x.dtype == np.float64
    jscope = jstatic.Scope()
    for k, v in state.items():
        jscope.set(k, jnp.asarray(v))
    ref, = jstatic.Executor().run(jmain, feed={"img": x}, fetch_list=[jout],
                                  scope=jscope)
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    got, = tstatic.Executor("cpu").run(tmain, feed={"img": x},
                                       fetch_list=[tout], scope=tscope)
    assert got.dtype == np.asarray(ref).dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # a declared int64 data variable resolves to int32, as in the JAX package
    from paddle_tpu_torch.core import dtype as tdtype
    assert tdtype.convert_dtype("int64") == torch.int32
    assert tdtype.resolve(torch.float64) == torch.float32


def test_dropout_p1_returns_zeros_as_in_jax():
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    x = np.random.default_rng(3).standard_normal((4, 6)).astype(np.float32)
    for mode in ("upscale_in_train", "downgrade_in_infer"):
        ref = np.asarray(JF.dropout(jnp.asarray(x), p=1.0, mode=mode))
        got = TF.dropout(torch.from_numpy(x), p=1.0, mode=mode).numpy()
        assert np.array_equal(got, ref) and not got.any()
    # the static op reaches it too
    main, startup = tstatic.Program(), tstatic.Program()
    with tstatic.program_guard(main, startup):
        v = TL.data("v", [6])
        out = TL.dropout(v, dropout_prob=1.0)
    got, = tstatic.Executor("cpu").run(main, feed={"v": x}, fetch_list=[out],
                                       scope=tstatic.Scope())
    assert got.shape == x.shape and not got.any()


def test_missing_state_raises_precondition_not_met():
    tmain, _, tout, size = _build("tower", TORCH)
    with pytest.raises(terrors.PreconditionNotMetError,
                       match="run the startup program first"):
        tstatic.Executor("cpu").run(
            tmain, feed={"img": np.zeros((1, 3, size, size), np.float32)},
            fetch_list=[tout], scope=tstatic.Scope())


def test_executor_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tstatic.Executor().place.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tstatic.Executor()


def test_startup_draws_repeat_and_follow_the_seed():
    def init(seed):
        _, start, _ = conv_tower(TORCH, ch=8, size=8)
        start.random_seed = seed
        scope = tstatic.Scope()
        tstatic.Executor("cpu").run(start, scope=scope)
        # names differ between builds (unique_name): take creation order
        return [scope.find_var(v.name).numpy() for v in start.list_vars()]

    a, b, c = init(1), init(1), init(2)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    w = [i for i, x in enumerate(a) if x.ndim == 4]
    assert w and not np.array_equal(a[w[0]], c[w[0]])
    bound = np.sqrt(6.0 / (3 * 9 + 8 * 9))     # Xavier uniform, first conv
    assert 0.9 * bound < np.abs(a[w[0]]).max() <= bound


def _folding_program(pkg):
    """Constants to fold (2 + 3) and a duplicate relu to merge."""
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = L.data("x", [4, 6])
        e = L._to_variable(2.0, x) + 3.0
        out = L.elementwise_add(L.relu(x) + L.relu(x), e)
    return main, out


def test_constant_folding_and_cse_match_jax(opt_passes):
    jmain, jout = _folding_program(JAX)
    tmain, tout = _folding_program(TORCH)
    jw, jrep = JP.PassManager().apply(jmain, {"x"}, [jout.name])
    tw, trep = TP.PassManager().apply(tmain, {"x"}, [tout.name])
    stats = {p.name: p.stats for p in trep.passes}
    assert stats["constant_folding"]["folded"] == 1
    assert stats["cse"]["deduped"] == 1
    assert [(p.name, p.ops_before, p.ops_after, p.stats)
            for p in trep.passes] == \
        [(p.name, p.ops_before, p.ops_after, p.stats) for p in jrep.passes]
    assert _attrs(tw) == _attrs(jw)
    x = np.random.default_rng(6).standard_normal((2, 4, 6)).astype(np.float32)
    opt_passes("default")
    ref, = jstatic.Executor().run(jmain, feed={"x": x}, fetch_list=[jout],
                                  scope=jstatic.Scope())
    got, = tstatic.Executor("cpu").run(tmain, feed={"x": x},
                                       fetch_list=[tout],
                                       scope=tstatic.Scope())
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, 2 * np.maximum(x, 0) + 5.0, rtol=1e-6)
