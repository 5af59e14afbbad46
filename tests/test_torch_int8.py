"""int8 static inference (rows 14 and 15, PTQ, ``QUANT_INFER_PIPELINE``),
port against the JAX package, on the CPU.

* Rows 14-15: ``int8.int8_matmul_dequant_plain`` / ``int8_conv2d_dequant_plain``
  (what the port's wrappers run on CPU tensors) against the JAX Pallas
  functions in interpret mode, every epilogue act, strides 1 and 2,
  paddings 0-3, filters 1-7, fp32 and bf16 out.  Both sum exactly in
  integers and differ only in the fp32 epilogue (XLA may contract the
  multiply and add into an FMA; sigmoid and tanh are different libm
  code): fp32 within 1e-6 of the largest magnitude, bf16 within one bf16
  rounding (1e-2).
* ``matmul_supported`` / ``conv_supported`` equal the JAX gates.
* The ``fake_quantize_dequantize_fixed_scale`` lowering equals the JAX
  lowering run op by op bit for bit.  (Under ``jax.jit`` XLA rewrites the
  division by the scale into a product with its reciprocal, so the JAX
  Executor can differ from both by one quantization level at a tie.)
* ``quant_int8`` and ``weight_quant_axis`` equal the JAX functions.
* ``PostTrainingQuantization`` of the same program from the same state:
  the same ops, weight scales and int8-simulated weights bit for bit, and
  activation scales equal where they are the feed's, within 1e-6 where
  they come out of float ops computed by the two backends.
* ``QUANT_INFER_PIPELINE`` gives the same op list and attrs as the JAX
  package; on the conv tower and a resnet block the port's Executor
  matches the JAX Executor's (Pallas int8 kernels forced open, interpret
  mode) within 1e-4 of each fetch's largest magnitude.
* The simulate route (flag off, or a shape the gate refuses) is bit for bit
  the program before the rewrite (the reference's own check,
  tests/test_pallas_vision.py:306).
* Full width: the port dispatches as many quant ops to rows 15 / 14 as the
  JAX dispatch takes (tower 1 / 0, ``vgg16_bn_drop`` 10 / 2).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.static as jstatic
from paddle_tpu.core import flags as jflags
from paddle_tpu.ops.pallas import config as pcfg
from paddle_tpu.ops.pallas import int8 as jint8
from paddle_tpu.slim import quant as jquant
from paddle_tpu.slim import quant_static as jqs
from paddle_tpu.static import ops_fused as jops_fused
from paddle_tpu.static import passes as JP
from paddle_tpu.static.registry import get_lowering as jlowering
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.ops.kernels import int8 as tint8
from paddle_tpu_torch.slim import quant as tquant
from paddle_tpu_torch.slim import quant_static as tqs
from paddle_tpu_torch.static import passes as TP
from paddle_tpu_torch.static.registry import get_lowering as tlowering
from test_torch_static import (JAX, TORCH, VGG_FULL, _jax_state, conv_tower,
                               vgg16_bn_drop)

FP32_REL = 1e-6
BF16_REL = 1e-2
ACT_SCALE_REL = 1e-6
PROGRAM_REL = 1e-4
ACTS = tint8.EPILOGUE_ACTS


@pytest.fixture
def tpu_gate(monkeypatch):
    monkeypatch.setattr(pcfg, "backend_is_tpu", lambda: True)


@pytest.fixture
def int8_flag():
    saved_j = jflags.get_flags(["use_pallas_int8"])
    saved_t = tflags.get_flag("use_pallas_int8")
    yield lambda on: tflags.set_flags({"use_pallas_int8": on})
    jflags.set_flags(saved_j)
    tflags.set_flags({"use_pallas_int8": saved_t})


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


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# -- rows 14 and 15 against the Pallas kernels ----------------------------------

@pytest.mark.parametrize("act,out_dtype,bias", [
    (act, dt, b) for act in ACTS for dt in ("float32", "bfloat16")
    for b in (True, False)])
def test_int8_matmul_plain_matches_jax_kernel(act, out_dtype, bias):
    rng = np.random.default_rng(11)
    m, k, n = 24, 256, 128
    x, w = _q(rng, (m, k)), _q(rng, (k, n))
    scale = rng.uniform(1e-5, 1e-4, n).astype(np.float32)
    b = rng.normal(0, 0.5, n).astype(np.float32) if bias else None
    ref = jint8.int8_matmul_dequant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        None if b is None else jnp.asarray(b), act=act,
        out_dtype=getattr(jnp, out_dtype))
    got = tint8.int8_matmul_dequant_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        None if b is None else torch.from_numpy(b), act,
        getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (m, n)
    assert _rel(_np(got), _np(ref)) <= (FP32_REL if out_dtype == "float32"
                                        else BF16_REL)


CONV_CASES = [
    # (n, h, w, c, o, k, stride, padding)
    (2, 6, 7, 128, 128, 3, 1, 1),
    (1, 9, 8, 128, 256, 3, 2, 1),
    (2, 5, 5, 256, 128, 1, 1, 0),
    (1, 11, 10, 128, 128, 7, 2, 3),
    (1, 6, 6, 128, 128, 5, 1, 2),
    (2, 7, 9, 128, 128, 3, 2, 0),
]


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_conv_plain_matches_jax_kernel(case, out_dtype):
    n, h, w, c, o, k, s, p = case
    rng = np.random.default_rng(sum(case))
    x, wq = _q(rng, (n, h, w, c)), _q(rng, (o, c, k, k))
    scale = rng.uniform(1e-6, 1e-5, o).astype(np.float32)
    b = rng.normal(0, 0.5, o).astype(np.float32)
    ref = jint8.int8_conv2d_dequant(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(b),
        stride=(s, s), padding=(p, p), act="relu",
        out_dtype=getattr(jnp, out_dtype))
    got = tint8.int8_conv2d_dequant_plain(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale),
        torch.from_numpy(b), (s, s), (p, p), "relu",
        getattr(torch, out_dtype))
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.is_contiguous()     # NHWC-contiguous, as the kernel's output
    assert _rel(_np(got), _np(ref)) <= (FP32_REL if out_dtype == "float32"
                                        else BF16_REL)


@pytest.mark.parametrize("act", ACTS)
def test_int8_conv_plain_matches_jax_kernel_every_act(act):
    rng = np.random.default_rng(3)
    x, wq = _q(rng, (1, 5, 6, 128)), _q(rng, (128, 128, 3, 3))
    scale = rng.uniform(1e-6, 1e-5, 128).astype(np.float32)
    ref = jint8.int8_conv2d_dequant(jnp.asarray(x), jnp.asarray(wq),
                                    jnp.asarray(scale), None, stride=(1, 1),
                                    padding=(1, 1), act=act)
    got = tint8.int8_conv2d_dequant_plain(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale),
        None, (1, 1), (1, 1), act)
    assert _rel(_np(got), _np(ref)) <= FP32_REL


def test_int8_gates_equal_jax_gates():
    checked = passed = 0
    for m, k, n, dt, act in itertools.product(
            (8, 12, 128), (128, 200, 256), (10, 128, 384), ("int8", "int32"),
            ACTS + ("gelu",)):
        jx = jax.ShapeDtypeStruct((m, k), getattr(jnp, dt))
        tx = torch.empty((m, k), dtype=getattr(torch, dt), device="meta")
        want = jint8.matmul_supported(jx, (k, n), act)
        assert tint8.matmul_supported(tx, (k, n), act) == want
        checked += 1
        passed += want
    for c, o, kk, s, p, hw, dt, act, dil, groups in itertools.product(
            (3, 128, 256), (64, 128), (1, 3, 7, 9), (1, 2, 3), (0, 1, 3),
            (4, 32, 64), ("int8", "float32"), ("", "relu", "gelu"),
            ((1, 1), (2, 2)), (1, 2)):
        shape = (2, hw, hw, c)
        jx = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
        tx = torch.empty(shape, dtype=getattr(torch, dt), device="meta")
        args = ((o, c, kk, kk), (s, s), (p, p), dil, groups, act)
        want = jint8.conv_supported(jx, *args)
        assert tint8.conv_supported(tx, *args) == want, (shape, args)
        assert tint8.conv_supported(tx, *args, data_format="NCHW") is False
        checked += 1
        passed += want
    # the VMEM cap is kept: a 64 x 64 image of 256 channels is refused
    assert not tint8.conv_supported(
        torch.empty((1, 64, 64, 256), dtype=torch.int8, device="meta"),
        (256, 256, 3, 3), (1, 1), (1, 1))
    assert checked > 5000 and passed > 100


# -- the fake quant, the scale axes, PTQ ------------------------------------------

@pytest.mark.parametrize("scale,bits", [(0.37, 8), (2.9134, 8), (1e-3, 8),
                                        (5.0, 4)])
def test_fixed_scale_fake_quant_matches_jax_bitwise(scale, bits):
    x = (np.random.default_rng(bits).standard_normal((64, 300)) * scale
         ).astype(np.float32)
    attrs = {"scale": scale, "bit_length": bits}
    name = "fake_quantize_dequantize_fixed_scale"
    ref = np.asarray(jlowering(name)({"X": [jnp.asarray(x)]}, attrs,
                                     None)["Out"][0])
    got = tlowering(name)({"X": [torch.from_numpy(x)]}, attrs,
                          None)["Out"][0].numpy()
    assert np.array_equal(got, ref)
    # the int8 route's quantization is the same grid point
    qm = 2.0 ** (bits - 1) - 1
    from paddle_tpu_torch.static import ops_fused as tops_fused

    x_q = tops_fused._quantize_int8(torch.from_numpy(x), scale, qm)
    jx_q = jops_fused._quantize_int8(jnp.asarray(x), scale, qm)
    assert x_q.dtype == torch.int8
    assert np.array_equal(x_q.numpy(), np.asarray(jx_q))


def test_quant_int8_and_weight_quant_axis_match_jax():
    for op_type, ndim in itertools.product(
            ("conv2d", "depthwise_conv2d", "mul", "matmul", "matmul_v2",
             "unknown"), (2, 4)):
        assert tquant.weight_quant_axis(op_type, ndim) \
            == jquant.weight_quant_axis(op_type, ndim)
    assert tquant.conv_quant_axis() == jquant.conv_quant_axis() == 0
    w = np.random.default_rng(1).standard_normal((16, 8, 3, 3))
    for axis in (0, 1):
        for got, ref in zip(tquant.quant_int8(w, axis),
                            jquant.quant_int8(w, axis)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)


def resnet_block(pkg, ch=8, size=6):
    """conv-BN(relu) -> conv-BN -> + input -> relu (the reference's
    tests/test_pallas_vision.py _resnet_block)."""
    static, L, _ = pkg
    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 13
    with static.program_guard(main, startup):
        img = L.data("img", [ch, size, size])
        c1 = L.conv2d(img, ch, 3, padding=1)
        b1 = L.batch_norm(c1, act="relu", is_test=True)
        c2 = L.conv2d(b1, ch, 3, padding=1)
        b2 = L.batch_norm(c2, is_test=True)
        out = L.relu(L.elementwise_add(b2, img))
    return main, startup, out


MODELS = {
    "tower": (lambda pkg: conv_tower(pkg, ch=128, size=16), 3, 16),
    "resnet_block": (lambda pkg: resnet_block(pkg), 8, 6),
    "resnet_block_128": (lambda pkg: resnet_block(pkg, ch=128, size=5), 128,
                         5),
}


def _ptq_both(model, seed=0, batch=2):
    """The model built with each package, PTQ'd from the same state on the
    same calibration batch.  Returns the JAX (program, scope, out), the
    port's (program, scope, out), the feed and the float state."""
    build, ch, size = MODELS[model]
    jmain, jstart, jout = build(JAX)
    tmain, _, tout = build(TORCH)
    state = _jax_state(jstart, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, ch, size, size)).astype(np.float32)
    feed = {"img": x}
    jscope = jstatic.Scope()
    for k, v in state.items():
        jscope.set(k, jnp.asarray(v))
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    jexe = jstatic.Executor()
    with jstatic.scope_guard(jscope):
        jqs.PostTrainingQuantization(
            jexe, program=jmain, feed_names=["img"],
            batch_generator=lambda: iter([feed]), batch_nums=1,
            scope=jscope).quantize()
    tqs.PostTrainingQuantization(
        tstatic.Executor("cpu"), program=tmain, feed_names=["img"],
        batch_generator=lambda: iter([feed]), batch_nums=1,
        scope=tscope).quantize()
    return (jmain, jscope, jout), (tmain, tscope, tout), feed, state


def _persistable_pairs(jprog, tprog):
    return list(zip([v.name for v in jprog.list_vars() if v.persistable],
                    [v.name for v in tprog.list_vars() if v.persistable]))


def _canon(attrs, approx=()):
    out = {}
    for k, v in sorted(attrs.items()):
        if k in approx:
            continue
        out[k] = list(v) if isinstance(v, (list, tuple)) else v
    return out


@pytest.mark.parametrize("model", ["tower", "resnet_block"])
def test_ptq_matches_jax(model):
    (jp, jscope, _), (tp, tscope, _), _, state = _ptq_both(model)
    jops, tops = jp.global_block().ops, tp.global_block().ops
    assert [op.type for op in tops] == [op.type for op in jops]
    n_qdq = 0
    for jo, to in zip(jops, tops):
        assert _canon(to.attrs, ("scale",)) == _canon(jo.attrs, ("scale",))
        if jo.type == "fake_quantize_dequantize_fixed_scale":
            n_qdq += 1
            js, ts = jo.attrs["scale"], to.attrs["scale"]
            if jo.inputs["X"] == ["img"]:
                assert ts == js           # the feed: the same values
            else:
                assert abs(ts - js) <= ACT_SCALE_REL * js
    assert n_qdq == sum(op.type in ("conv2d", "mul") for op in jops)
    for jn, tn in _persistable_pairs(jp, tp):
        ref = np.asarray(jscope.find_var(jn))
        got = tscope.find_var(tn).numpy()
        assert np.array_equal(got, ref), tn
        if ref.ndim == 4 or (ref.ndim == 2 and "w" in jn):
            assert not np.array_equal(ref, state[jn])  # simulated


@pytest.mark.parametrize("model", sorted(MODELS))
def test_quant_pipeline_matches_jax(model, tpu_gate, count_int8):
    (jp, jscope, jout), (tp, tscope, tout), feed, _ = _ptq_both(model)
    jw, jrep = JP.PassManager(JP.QUANT_INFER_PIPELINE).apply(
        jp, feed_names={"img"}, fetch_names=[jout.name])
    tw, trep = TP.PassManager(TP.QUANT_INFER_PIPELINE).apply(
        tp, feed_names={"img"}, fetch_names=[tout.name])
    assert tuple(TP.QUANT_INFER_PIPELINE) == tuple(JP.QUANT_INFER_PIPELINE)
    approx = ("in_scale", "scale")
    assert [(op.type, _canon(op.attrs, approx))
            for op in tw.global_block().ops] == \
        [(op.type, _canon(op.attrs, approx)) for op in jw.global_block().ops]
    assert [(p.name, p.ops_before, p.ops_after, p.stats)
            for p in trep.passes] == \
        [(p.name, p.ops_before, p.ops_after, p.stats) for p in jrep.passes]
    types = [op.type for op in tw.global_block().ops]
    assert "quant_conv2d" in types and "conv2d" not in types
    with jstatic.scope_guard(jscope):
        ref, = jstatic.Executor().run(jw, feed=feed,
                                      fetch_list=[jout.name])
    got, = tstatic.Executor("cpu").run(tw, feed=feed, fetch_list=[tout.name],
                                       scope=tscope)
    assert got.shape == np.asarray(ref).shape
    assert _rel(got, ref) <= PROGRAM_REL
    # the gates: C = O = 128 convs take row 15, none of the fcs row 14
    want = {"tower": 1, "resnet_block": 0, "resnet_block_128": 2}[model]
    assert count_int8 == {"conv": want, "matmul": 0}


@pytest.mark.parametrize("model,flag_on", [("resnet_block", True),
                                           ("tower", False)])
def test_simulate_route_is_bitwise_the_unrewritten_program(model, flag_on,
                                                           int8_flag):
    _, (tp, tscope, tout), feed, _ = _ptq_both(model)
    int8_flag(flag_on)
    rewritten, _ = TP.PassManager(("quant_infer",)).apply(
        tp, feed_names={"img"}, fetch_names=[tout.name])
    types = [op.type for op in rewritten.global_block().ops]
    assert "quant_conv2d" in types
    assert "fake_quantize_dequantize_fixed_scale" not in types
    state = {k: tscope.find_var(k).numpy() for k in tscope.keys()}
    rep = TP.golden_parity(tp, rewritten, feed, [tout.name], state=state,
                           rtol=0.0, atol=0.0, place="cpu")
    assert rep.ok and rep.max_abs_err == 0.0, rep.to_text()


def test_quant_mul_kernel_route_against_simulate(tpu_gate):
    """The reference's fc check (tests/test_pallas_vision.py:333): the int8
    matmul's route within rtol = atol = 1e-4 of the simulate route, and
    within the PTQ error bound of the float program."""
    static, L, _ = TORCH
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        x = L.data("x", [128])
        y = L.fc(x, 128, act="relu")
    scope = static.Scope()
    exe = static.Executor("cpu")
    exe.run(startup, scope=scope)
    feed = {"x": np.random.default_rng(4).standard_normal((8, 128))
            .astype(np.float32)}
    float_out, = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    qprog = tqs.PostTrainingQuantization(
        exe, program=main, feed_names=["x"],
        batch_generator=lambda: iter([feed]), batch_nums=1,
        scope=scope).quantize()
    rewritten, _ = TP.PassManager(("quant_infer",)).apply(
        qprog, feed_names={"x"}, fetch_names=[y.name])
    assert "quant_mul" in [op.type for op in rewritten.global_block().ops]
    sim_out, = exe.run(qprog, feed=feed, fetch_list=[y.name], scope=scope)
    int8_out, = exe.run(rewritten, feed=feed, fetch_list=[y.name],
                        scope=scope)
    np.testing.assert_allclose(int8_out, sim_out, rtol=1e-4, atol=1e-4)
    assert np.abs(int8_out - float_out).max() \
        <= 0.05 * np.abs(float_out).max() + 1e-3


def test_ptq_model_prefix_route_raises_until_static_io():
    # the route is ported (static.io.load); a prefix that holds no saved
    # program raises as the JAX route does
    for qs, static, place in ((tqs, tstatic, ("cpu",)), (jqs, jstatic, ())):
        with pytest.raises(FileNotFoundError):
            qs.PostTrainingQuantization(static.Executor(*place),
                                        model_prefix="/nonexistent/model")


# -- full-width dispatch counts ------------------------------------------------------

def _jax_int8_ops(program, batch):
    """(row-15, row-14) ops of a JAX rewritten quant program whose JAX
    dispatch takes the Pallas kernels at ``batch`` (gate forced open;
    nothing run), by the lowerings' own conditions."""
    block = program.global_block()

    def shape(name):
        return tuple(batch if d < 0 else d for d in block.var(name).shape)

    convs = mms = 0
    for op in block.ops:
        a = op.attrs
        if op.type == "quant_conv2d":
            w = shape(op.inputs["Filter"][0])
            pad = a["paddings"]
            if isinstance(pad, str) or a.get("data_format") != "NHWC" \
                    or len(a["weight_scale"]) != w[0]:
                continue
            pair = jops_fused._pair
            convs += jint8.conv_supported(
                jax.ShapeDtypeStruct(shape(op.inputs["Input"][0]), jnp.int8),
                w, pair(a["strides"]), pair(pad), pair(a["dilations"]),
                a["groups"], a["act"], a["data_format"])
        elif op.type == "quant_mul":
            xs, ys = shape(op.inputs["X"][0]), shape(op.inputs["Y"][0])
            xd, yd = a.get("x_num_col_dims", 1), a.get("y_num_col_dims", 1)
            x2 = (int(np.prod(xs[:xd])), int(np.prod(xs[xd:])))
            y2 = (int(np.prod(ys[:yd])), int(np.prod(ys[yd:])))
            if len(a["weight_scale"]) != y2[1]:
                continue
            mms += jint8.matmul_supported(jax.ShapeDtypeStruct(x2, jnp.int8),
                                          y2, a["act"])
    return convs, mms


def _calibrated(pkg, build, batch, seed=0):
    """The test clone of ``build``'s program, PTQ'd on one random batch."""
    static = pkg[0]
    main, startup, out = build(pkg)
    test = main.clone(for_test=True)
    feed = {"img": np.random.default_rng(seed).standard_normal(
        (batch, 3, 32, 32)).astype(np.float32)}
    scope = static.Scope()
    if pkg is JAX:
        exe = static.Executor()
        with static.scope_guard(scope):
            exe.run(startup)
            jqs.PostTrainingQuantization(
                exe, program=test, feed_names=["img"],
                batch_generator=lambda: iter([feed]), batch_nums=1,
                scope=scope).quantize()
    else:
        exe = static.Executor("cpu")
        exe.run(startup, scope=scope)
        tqs.PostTrainingQuantization(
            exe, program=test, feed_names=["img"],
            batch_generator=lambda: iter([feed]), batch_nums=1,
            scope=scope).quantize()
    return test, out, feed, scope, exe


@pytest.mark.parametrize("model,want", [("tower", (1, 0)),
                                        ("vgg", (10, 2))])
def test_full_width_int8_dispatch_counts_match_jax(model, want, count_int8):
    build = (lambda pkg: vgg16_bn_drop(pkg, **VGG_FULL)) if model == "vgg" \
        else (lambda pkg: conv_tower(pkg))
    jtest, jout, _, _, _ = _calibrated(JAX, build, batch=1)
    jw, _ = JP.PassManager(JP.QUANT_INFER_PIPELINE).apply(
        jtest, {"img"}, [jout.name])
    assert _jax_int8_ops(jw, 128) == _jax_int8_ops(jw, 8) == want

    ttest, tout, feed, scope, exe = _calibrated(TORCH, build, batch=8)
    tw, _ = TP.PassManager(TP.QUANT_INFER_PIPELINE).apply(
        ttest, {"img"}, [tout.name])
    out, = exe.run(tw, feed=feed, fetch_list=[tout.name], scope=scope)
    assert out.shape == (8, 10) and np.isfinite(out).all()
    assert (count_int8["conv"], count_int8["matmul"]) == want
