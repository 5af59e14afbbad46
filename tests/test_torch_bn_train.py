"""Train-mode BatchNorm + act (rows 11 and 12) and the train-mode route of
the fused conv, port against the JAX package, on the CPU.

* Row 11: ``bn_act_train.batch_stats_plain`` (what the port's wrapper runs
  on CPU tensors) against the JAX ``conv_fused._batch_stats`` in interpret
  mode: the per-channel sum and sum of squares within 1e-5 of their
  largest magnitude (fp32 sums in another order).
* Row 12: ``scale_act_plain`` against the JAX ``scale_act`` in interpret
  mode: within 1e-6 of the largest magnitude in fp32 (XLA may contract
  the multiply and add into one FMA), one bf16 rounding (1e-2) in bf16.
* ``fused_bn_act_train`` against the JAX function (interpret mode) and its
  custom VJP: y, mean, var within 1e-5 and the x, gamma, beta gradients
  of ``sum(y ** 2)`` within 1e-4, the tolerances of the reference's own
  test (tests/test_pallas_vision.py:127).
* ``train_supported`` equals the JAX gate over a grid of shapes.
* A train-mode static program (conv-BN(relu)-pool-fc, main program, not
  cloned for test, no dropout: the port's dropout masks cannot match
  ``jax.random``) through ``DEFAULT_PIPELINE``: outputs and running
  statistics against the JAX Executor's (kernel gate forced open), within
  1e-4 of each value's largest magnitude; the port calls each of its two
  kernels once for every ``bn_act_train`` call of the JAX trace.
* Full-width ``vgg16_bn_drop`` main: the port dispatches as many fused
  train-mode BNs to the two kernels as the JAX dispatch takes (11).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core import flags as jflags
from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu.ops.pallas import config as pcfg
from paddle_tpu.ops.pallas import conv_fused as jcf
from paddle_tpu.static import passes as JP
from paddle_tpu.utils import monitor as jmonitor
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.ops.kernels import bn_act_train as tbn
from test_torch_static import JAX, TORCH, VGG_FULL, vgg16_bn_drop

STATS_REL = 1e-5
SCALE_REL = 1e-6
BF16_REL = 1e-2
FN_TOL = 1e-5
GRAD_TOL = 1e-4
PROGRAM_REL = 1e-4


@pytest.fixture
def tpu_gate(monkeypatch):
    monkeypatch.setattr(pcfg, "backend_is_tpu", lambda: True)


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


@pytest.fixture
def count_bn(monkeypatch):
    """The port's calls of its two kernel wrappers (on the CPU they run
    their plain versions, and their launch counters stay 0)."""
    seen = {"stats": 0, "scale": 0}

    def wrap(name, key):
        real = getattr(tbn, name)

        def counted(*a, **k):
            seen[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(tbn, name, counted)

    wrap("batch_stats", "stats")
    wrap("scale_act", "scale")
    return seen


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- rows 11 and 12 against the Pallas kernels ---------------------------------

@pytest.mark.parametrize("rows,c", [(256, 128), (1024, 256), (72, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_stats_plain_matches_jax_kernel(rows, c, dtype):
    x = np.random.default_rng(rows + c).normal(0.5, 2.0, (rows, c)) \
        .astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    js, jss = jcf._batch_stats(jx, jcf._rows_block(rows))
    ts, tss = tbn.batch_stats_plain(torch.from_numpy(x).to(
        getattr(torch, dtype)))
    assert ts.dtype == tss.dtype == torch.float32
    assert _rel(ts, js) <= STATS_REL
    assert _rel(tss, jss) <= STATS_REL


@pytest.mark.parametrize("act", tbn.TRAIN_ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_act_plain_matches_jax_kernel(act, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    a = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    ref = jcf.scale_act(jx, jnp.asarray(a), jnp.asarray(b), act, 256,
                        jx.dtype)
    got = tbn.scale_act_plain(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(a), torch.from_numpy(b), act)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(_np(got), _np(ref)) <= (SCALE_REL if dtype == "float32"
                                        else BF16_REL)


@pytest.mark.parametrize("shape,act", [((2, 4, 4, 8), "relu"),
                                       ((2, 4, 4, 8), ""),
                                       ((2, 6, 6, 128), "relu")])
def test_fused_bn_act_train_matches_jax_and_its_vjp(shape, act):
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    gamma = rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32)
    beta = rng.normal(size=(c,)).astype(np.float32)
    eps = 1e-5

    jy, jmean, jvar = jcf.fused_bn_act_train(x, gamma, beta, eps, act=act)
    tx, tg, tb = (torch.from_numpy(v).requires_grad_(True)
                  for v in (x, gamma, beta))
    ty, tmean, tvar = tbn.fused_bn_act_train(tx, tg, tb, eps, act)
    for got, ref in ((ty, jy), (tmean, jmean), (tvar, jvar)):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=FN_TOL,
                                   atol=FN_TOL)
    assert not tmean.requires_grad and not tvar.requires_grad

    fused = lambda x, g, b: jcf.fused_bn_act_train(x, g, b, eps, act=act)
    jgrads = jax.grad(lambda *args: jnp.sum(fused(*args)[0] ** 2),
                      argnums=(0, 1, 2))(x, gamma, beta)
    (ty ** 2).sum().backward()
    for got, ref in zip((tx.grad, tg.grad, tb.grad), jgrads):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_train_gate_equals_jax_gate():
    checked = passed = 0
    for n, hw, c, dt, act, fmt in itertools.product(
            (1, 2, 3), (1, 2, 5, 8), (64, 128, 256, 200),
            ("float32", "bfloat16", "float16"), ("", "relu", "gelu"),
            ("NHWC", "NCHW")):
        shape = (n, hw, hw, c)
        jx = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
        tx = torch.empty(shape, dtype=getattr(torch, dt), device="meta")
        want = jcf.train_supported(jx, act, fmt)
        assert tbn.train_supported(tx, act, fmt) == want, (shape, dt, act)
        checked += 1
        passed += want
    assert not tbn.train_supported(torch.empty((8, 128), device="meta"))
    assert checked > 500 and passed > 20


def test_wrappers_refuse_direct_grad_and_other_acts():
    x = torch.randn(16, 128, requires_grad=True)
    with pytest.raises(NotImplementedError, match="fused_bn_act_train"):
        tbn.batch_stats(x)
    with pytest.raises(ValueError, match="act"):
        tbn.scale_act(x.detach(), torch.ones(128), torch.zeros(128), "gelu")


# -- the train-mode static program ------------------------------------------------

def conv_bn_program(pkg, ch=128, size=16):
    """conv -> train-mode BN(relu) -> max pool, twice, then fc 10: no
    dropout."""
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 5
    with static.program_guard(main, startup):
        img = L.data("img", [3, size, size])
        h = L.conv2d(img, ch, 3, padding=1)
        h = L.batch_norm(h, act="relu")
        h = L.pool2d(h, 2, "max", 2)
        h = L.conv2d(h, ch, 3, padding=1)
        h = L.batch_norm(h, act="relu")
        h = L.pool2d(h, 2, "max", 2)
        out = L.fc(L.flatten(h), 10)
    return main, startup, out


def _bn_stat_names(program):
    return [n for op in program.global_block().ops if op.type == "batch_norm"
            for n in op.inputs["Mean"] + op.inputs["Variance"]]


def _jax_startup(startup):
    scope = jstatic.Scope()
    with jstatic.scope_guard(scope):
        jstatic.Executor().run(startup)
    return {k: np.asarray(scope.find_var(k)) for k in scope.keys()}


def test_train_mode_program_matches_jax_executor(tpu_gate, opt_passes,
                                                 count_bn):
    jmain, jstart, jout = conv_bn_program(JAX)
    tmain, _, tout = conv_bn_program(TORCH)
    state = _jax_startup(jstart)
    x = np.random.default_rng(8).standard_normal((4, 3, 16, 16)) \
        .astype(np.float32)
    opt_passes("default")
    jscope = jstatic.Scope()
    for k, v in state.items():
        jscope.set(k, jnp.asarray(v))
    calls = jmonitor.counter("pallas.kernel_calls", labelnames=("kernel",))
    before = calls.value(kernel="bn_act_train")
    ref, = jstatic.Executor().run(jmain, feed={"img": x}, fetch_list=[jout],
                                  scope=jscope)
    jax_calls = calls.value(kernel="bn_act_train") - before

    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    exe = tstatic.Executor("cpu")
    got, = exe.run(tmain, feed={"img": x}, fetch_list=[tout], scope=tscope)
    ops = [op.type for op in
           exe.executed_program(tmain, ["img"], [tout]).global_block().ops]
    assert ops.count("fused_conv2d_bn_act") == 2 and "batch_norm" not in ops
    assert _rel(got, ref) <= PROGRAM_REL
    # the running statistics the fused op wrote back, against JAX's
    jnames, tnames = _bn_stat_names(jmain), _bn_stat_names(tmain)
    assert len(jnames) == len(tnames) == 4
    for jn, tn in zip(jnames, tnames):
        new = np.asarray(jscope.find_var(jn))
        assert not np.array_equal(new, state[jn])      # updated
        assert _rel(tscope.find_var(tn).numpy(), new) <= PROGRAM_REL
    # both BNs pass the gate (C = 128): each JAX kernel call is one call
    # of each of the port's two kernels
    assert jax_calls == 2
    assert count_bn == {"stats": jax_calls, "scale": jax_calls}


def _jax_bn_train_ops(program, batch):
    """Fused train-mode BNs of a JAX rewritten program whose JAX dispatch
    takes the Pallas kernels at ``batch`` (gate forced open; nothing
    run): the gate on each fused conv's output."""
    block = program.global_block()
    n = 0
    for op in block.ops:
        if op.type != "fused_conv2d_bn_act" or op.attrs["is_test"]:
            continue
        v = block.var(op.outputs["Output"][0])
        spec = jax.ShapeDtypeStruct(
            tuple(batch if d < 0 else d for d in v.shape), v.dtype)
        n += jnorm._use_fused_bn_act(spec, op.attrs["act"],
                                     op.attrs["data_format"])
    return n


def test_full_width_vgg_bn_train_dispatch_matches_jax(tpu_gate, opt_passes,
                                                      count_bn):
    jmain, _, jout = vgg16_bn_drop(JAX)
    jw, _ = JP.PassManager().apply(jmain, {"img"}, [jout.name])
    # groups 2-5: the 11 BNs of 128-512 channels; group 1 (64) is refused
    assert _jax_bn_train_ops(jw, 128) == _jax_bn_train_ops(jw, 2) == 11

    tmain, tstart, tout = vgg16_bn_drop(TORCH, **VGG_FULL)
    scope = tstatic.Scope()
    exe = tstatic.Executor("cpu")
    exe.run(tstart, scope=scope)
    opt_passes("default")
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32))
    out, = exe.run(tmain, feed={"img": x.astype(np.float32)},
                   fetch_list=[tout], scope=scope)
    assert out.shape == (2, 10) and np.isfinite(out).all()
    assert count_bn == {"stats": 11, "scale": 11}
