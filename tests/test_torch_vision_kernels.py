"""The port's vision kernels (rows 10 and 13) and functional vision ops
against the JAX package, on the CPU.

* Row 10: ``conv_fused.conv2d_bn_act_plain`` (what the port's wrapper runs
  on CPU tensors) against the JAX ``conv_fused.conv2d_bn_act`` run in
  interpret mode, at C = O = 128, small odd spatial sizes, filters 1-7,
  strides 1 and 2, paddings 0-3 and every epilogue activation.  fp32
  within 1e-5 of the largest magnitude (the same fp32 sums in another
  order); bf16 within 1e-2 of it (one bf16 rounding of those sums).
* Row 13: ``pooling.pool2d_nhwc_plain`` against the JAX
  ``max_pool2d_nhwc`` / ``avg_pool2d_nhwc`` in interpret mode: max bit for
  bit, avg within 1e-6 (the same fp32 sum, in the same tap order).
* The port's ``supported()`` gates equal the JAX gates over a grid.
* ``F.max_pool2d`` / ``F.avg_pool2d`` (and the 1-D and adaptive forms,
  ``F.conv2d``, ``F.batch_norm``) against the JAX functions with the JAX
  kernel gate forced open, as tests/test_pallas_vision.py does: the port
  dispatches by the flag and the shape gate alone, so both packages take
  their kernels on the same shapes.
* The wrappers refuse inputs that require grad (no backward exists).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.ops.pallas import config as pcfg
from paddle_tpu.ops.pallas import conv_fused as jcf
from paddle_tpu.ops.pallas import pooling as jpool
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import config
from paddle_tpu_torch.ops.kernels import conv_fused as tcf
from paddle_tpu_torch.ops.kernels import pooling as tpool

FP32_REL = 1e-5
BF16_REL = 1e-2
AVG_TOL = 1e-6
ACTS = ("", "relu", "relu6", "sigmoid", "tanh", "gelu", "silu", "swish")


@pytest.fixture
def tpu_gate(monkeypatch):
    """Open the JAX kernel gate on the CPU: its Pallas kernels run in
    interpret mode."""
    monkeypatch.setattr(pcfg, "backend_is_tpu", lambda: True)


def _rng(seed):
    return np.random.default_rng(seed)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jnp(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


# -- row 10: the fused conv -----------------------------------------------------

CONV_CASES = [
    # (n, h, w, kh, kw, stride, padding)
    (2, 5, 7, 3, 3, (1, 1), (1, 1)),
    (1, 6, 5, 3, 3, (2, 2), (1, 1)),
    (2, 7, 7, 1, 1, (2, 2), (0, 0)),
    (1, 9, 8, 7, 7, (2, 2), (3, 3)),
    (1, 5, 6, 5, 3, (1, 2), (2, 0)),
    (2, 4, 4, 3, 3, (1, 1), (0, 0)),
    (1, 3, 5, 2, 2, (2, 1), (3, 2)),
]


def _conv_inputs(seed, n, h, w, kh, kw, c=128, o=128):
    rng = _rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((o, c, kh, kw)) * 0.05).astype(np.float32)
    a = rng.uniform(0.5, 1.5, o).astype(np.float32)
    b = rng.standard_normal(o).astype(np.float32)
    return x, wt, a, b


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv_plain_matches_jax_kernel_fp32(case):
    n, h, w, kh, kw, stride, padding = case
    x, wt, a, b = _conv_inputs(1, n, h, w, kh, kw)
    ref = jcf.conv2d_bn_act(x, wt, a, b, stride=stride, padding=padding,
                            act="relu")
    got = tcf.conv2d_bn_act(*(torch.from_numpy(t) for t in (x, wt, a, b)),
                            stride=stride, padding=padding, act="relu")
    assert tuple(got.shape) == tuple(ref.shape)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= FP32_REL


@pytest.mark.parametrize("act", ACTS)
def test_conv_plain_matches_jax_kernel_every_act(act):
    x, wt, a, b = _conv_inputs(2, 1, 5, 5, 3, 3)
    ref = jcf.conv2d_bn_act(x, wt, a, b, stride=(1, 1), padding=(1, 1),
                            act=act)
    got = tcf.conv2d_bn_act_plain(
        *(torch.from_numpy(t) for t in (x, wt, a, b)), (1, 1), (1, 1), act)
    assert _rel(got.numpy(), ref) <= FP32_REL


@pytest.mark.parametrize("case", CONV_CASES[:3], ids=str)
def test_conv_plain_matches_jax_kernel_bf16(case):
    n, h, w, kh, kw, stride, padding = case
    x, wt, a, b = _conv_inputs(3, n, h, w, kh, kw)
    ref = jcf.conv2d_bn_act(_jnp(x, jnp.bfloat16), _jnp(wt, jnp.bfloat16),
                            a, b, stride=stride, padding=padding, act="gelu")
    got = tcf.conv2d_bn_act(_torch(x, torch.bfloat16),
                            _torch(wt, torch.bfloat16), torch.from_numpy(a),
                            torch.from_numpy(b), stride, padding, "gelu")
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert _rel(_np32(got), _np32(ref)) <= BF16_REL


# -- row 13: NHWC pooling ---------------------------------------------------------

POOL_CASES = [
    # (n, h, w, kernel, stride, padding)
    (2, 8, 8, (2, 2), (2, 2), (0, 0)),
    (1, 7, 9, (3, 3), (2, 2), (1, 1)),
    (2, 5, 5, (3, 3), (1, 1), (1, 1)),
    (1, 9, 6, (8, 5), (2, 1), (3, 2)),
    (1, 4, 6, (1, 2), (1, 2), (0, 1)),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_plain_matches_jax_kernel(case, dtype):
    n, h, w, kernel, stride, padding = case
    x = _rng(4).standard_normal((n, h, w, 128)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    xj, xt = _jnp(x, jd), _torch(x, td)
    ref_max = jpool.max_pool2d_nhwc(xj, kernel, stride, padding)
    got_max = tpool.max_pool2d_nhwc(xt, kernel, stride, padding)
    assert tuple(got_max.shape) == tuple(ref_max.shape)
    np.testing.assert_array_equal(_np32(got_max), _np32(ref_max))
    ref_avg = jpool.avg_pool2d_nhwc(xj, kernel, stride, padding)
    got_avg = tpool.avg_pool2d_nhwc_plain(xt, kernel, stride, padding)
    assert got_avg.dtype == td
    tol = AVG_TOL if dtype == "float32" else BF16_REL
    np.testing.assert_allclose(_np32(got_avg), _np32(ref_avg), rtol=0,
                               atol=tol * max(np.abs(x).max(), 1.0))


# -- the gates ------------------------------------------------------------------

def _conv_gate_grid():
    for (c, o, k, s, p, hw, dt, act, dil, groups) in itertools.product(
            (64, 128, 256), (128, 192), (1, 3, 7, 8), (1, 2, 3), (0, 1, 3),
            (4, 64), ("float32", "bfloat16"), ("", "gelu", "elu"),
            ((1, 1), (2, 2)), (1, 2)):
        yield c, o, k, s, p, hw, dt, act, dil, groups


def test_conv_gate_equals_jax_gate():
    checked = passed = 0
    for c, o, k, s, p, hw, dt, act, dil, groups in _conv_gate_grid():
        shape = (2, hw, hw + 1, c)
        jx = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
        tx = torch.empty(shape, dtype=getattr(torch, dt), device="meta")
        args = ((o, c, k, k), (s, s), (p, p), dil, groups, act)
        want = jcf.supported(jx, *args)
        assert tcf.supported(tx, *args) == want, (shape, args)
        assert tcf.supported(tx, *args, data_format="NCHW") is False
        checked += 1
        passed += want
    # big images fail the kept VMEM cap (64 x 65 x 256, 3x3)
    big = torch.empty((1, 64, 65, 256), device="meta")
    assert not tcf.supported(big, (256, 256, 3, 3), (1, 1), (1, 1))
    assert checked > 1000 and passed > 50


def test_pool_gate_equals_jax_gate():
    checked = passed = 0
    for (c, k, s, p, hw, dt, mode, excl) in itertools.product(
            (64, 128, 384), (2, 3, 8, 9), (1, 2, 3), (0, 1), (4, 32, 128),
            ("float32", "bfloat16"), ("max", "avg"), (True, False)):
        shape = (2, hw, hw, c)
        jx = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
        tx = torch.empty(shape, dtype=getattr(torch, dt), device="meta")
        args = ((k, k), (s, s), (p, p), mode, excl)
        want = jpool.supported(jx, *args)
        assert tpool.supported(tx, *args) == want, (shape, args)
        checked += 1
        passed += want
    assert checked > 500 and passed > 50


# -- functional dispatch against the JAX functions ------------------------------

FUNC_POOL_CASES = [
    # (shape NHWC, kernel, stride, padding, exclusive): kernel-gated and not
    ((2, 8, 8, 128), 2, 2, 0, True),
    ((1, 7, 7, 128), 3, 2, 1, True),
    ((1, 5, 5, 128), 3, 1, 1, False),
    ((2, 6, 6, 64), 2, 2, 0, True),      # C 64: refused by both gates
    ((1, 5, 7, 128), 3, 1, 1, True),     # exclusive avg with padding
    ((1, 6, 6, 8), 5, 1, 3, True),       # padding above half the window
]


@pytest.mark.parametrize("case", FUNC_POOL_CASES, ids=str)
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_functional_pool_matches_jax(case, fmt, tpu_gate):
    shape, k, s, p, excl = case
    x = _rng(5).standard_normal(shape).astype(np.float32)
    if fmt == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    calls = dict(config.launch_counts())
    ref_max = JF.max_pool2d(jnp.asarray(x), k, s, p, data_format=fmt)
    got_max = TF.max_pool2d(torch.from_numpy(x), k, s, p, data_format=fmt)
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(ref_max))
    ref_avg = JF.avg_pool2d(jnp.asarray(x), k, s, p, exclusive=excl,
                            data_format=fmt)
    got_avg = TF.avg_pool2d(torch.from_numpy(x), k, s, p, exclusive=excl,
                            data_format=fmt)
    np.testing.assert_allclose(got_avg.numpy(), np.asarray(ref_avg),
                               rtol=1e-6, atol=1e-6)
    assert config.launch_counts() == calls     # CPU: plain versions only


def test_functional_pool_takes_the_kernel_where_the_gate_holds(monkeypatch):
    seen = []
    monkeypatch.setattr(tpool, "max_pool2d_nhwc",
                        lambda *a: seen.append("max") or
                        tpool.max_pool2d_nhwc_plain(*a))
    monkeypatch.setattr(tpool, "avg_pool2d_nhwc",
                        lambda *a: seen.append("avg") or
                        tpool.avg_pool2d_nhwc_plain(*a))
    x = torch.randn(1, 4, 4, 128)
    TF.max_pool2d(x, 2, 2, data_format="NHWC")
    TF.avg_pool2d(x, 2, 2, data_format="NHWC")
    TF.avg_pool2d(x, 3, 1, 1, exclusive=True, data_format="NHWC")
    TF.max_pool2d(x[..., :64], 2, 2, data_format="NHWC")
    TF.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    assert seen == ["max", "avg"]
    flags.set_flags({"use_pallas_pool": False})
    try:
        TF.max_pool2d(x, 2, 2, data_format="NHWC")
    finally:
        flags.set_flags({"use_pallas_pool": True})
    assert seen == ["max", "avg"]


def test_pool_1d_and_adaptive_match_jax():
    x = _rng(6).standard_normal((2, 4, 11)).astype(np.float32)
    np.testing.assert_array_equal(
        TF.max_pool1d(torch.from_numpy(x), 3, 2, 1).numpy(),
        np.asarray(JF.max_pool1d(jnp.asarray(x), 3, 2, 1)))
    np.testing.assert_allclose(
        TF.avg_pool1d(torch.from_numpy(x), 3, 2, 1).numpy(),
        np.asarray(JF.avg_pool1d(jnp.asarray(x), 3, 2, 1)),
        rtol=1e-6, atol=1e-6)
    x4 = _rng(7).standard_normal((2, 3, 7, 9)).astype(np.float32)
    for out in ((3, 4), (7, 3), 1):
        for fmt in ("NCHW", "NHWC"):
            xin = x4 if fmt == "NCHW" else \
                np.ascontiguousarray(x4.transpose(0, 2, 3, 1))
            np.testing.assert_allclose(
                TF.adaptive_avg_pool2d(torch.from_numpy(xin), out,
                                       fmt).numpy(),
                np.asarray(JF.adaptive_avg_pool2d(jnp.asarray(xin), out,
                                                  fmt)),
                rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(
                TF.adaptive_max_pool2d(torch.from_numpy(xin), out,
                                       fmt).numpy(),
                np.asarray(JF.adaptive_max_pool2d(jnp.asarray(xin), out,
                                                  fmt)))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0), (2, 3)])
def test_functional_conv2d_matches_jax(fmt, stride, padding):
    rng = _rng(8)
    x = rng.standard_normal((2, 5, 9, 7)).astype(np.float32)
    w = (rng.standard_normal((6, 5, 3, 3)) * 0.2).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ref = JF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                    padding, data_format=fmt)
    xt = torch.from_numpy(x)
    got = TF.conv2d(xt, torch.from_numpy(w), torch.from_numpy(b), stride,
                    padding, data_format=fmt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if fmt == "NHWC":   # a channels-last view in and out, no copies
        assert got.is_contiguous()


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("shape", [(4, 6, 5, 3), (8, 6)])
def test_functional_batch_norm_matches_jax(training, shape):
    rng = _rng(9)
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    c = shape[1]
    rm = rng.standard_normal(c).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    ref = JF.batch_norm(*(jnp.asarray(t) for t in (x, rm, rv, w, b)),
                        training=training, momentum=0.8)
    got = TF.batch_norm(*(torch.from_numpy(t) for t in (x, rm, rv, w, b)),
                        training=training, momentum=0.8)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    a_t, b_t = TF.bn_inference_scale_bias(
        *(torch.from_numpy(t) for t in (rm, rv, w, b)), 1e-5)
    from paddle_tpu.nn.functional.norm import bn_inference_scale_bias
    a_j, b_j = bn_inference_scale_bias(*(jnp.asarray(t)
                                         for t in (rm, rv, w, b)), 1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-6,
                               atol=1e-6)


# -- no backward ----------------------------------------------------------------

def test_wrappers_refuse_inputs_that_require_grad():
    x = torch.randn(1, 4, 4, 128, requires_grad=True)
    w = torch.randn(128, 128, 3, 3)
    a, b = torch.ones(128), torch.zeros(128)
    with pytest.raises(NotImplementedError, match="has no backward"):
        tcf.conv2d_bn_act(x, w, a, b, (1, 1), (1, 1), "relu")
    with pytest.raises(NotImplementedError, match="has no backward"):
        tcf.conv2d_bn_act(x.detach(), w.requires_grad_(), a, b)
    for fn in (tpool.max_pool2d_nhwc, tpool.avg_pool2d_nhwc):
        with pytest.raises(NotImplementedError, match="has no backward"):
            fn(x, (2, 2), (2, 2), (0, 0))
    with torch.no_grad():
        assert tcf.conv2d_bn_act(x, w, a, b).shape == (1, 2, 2, 128)
        assert tpool.max_pool2d_nhwc(x, (2, 2), (2, 2),
                                     (0, 0)).shape == (1, 2, 2, 128)

