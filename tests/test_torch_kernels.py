"""Kernel-level parity of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX Pallas functions (interpret mode on
the CPU, as the JAX package's own tests run them) and through the port's
wrappers, which on CPU tensors run their kernels' plain versions.
Tolerances: fp32 1e-5 (same arithmetic, other summation order); bf16 2e-2
relative to the largest reference value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops.pallas import flash_attention_packed as jfap
from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops.kernels import config
from paddle_tpu_torch.ops.kernels import flash_attention_packed as tfap
from paddle_tpu_torch.ops.kernels import layer_norm as tln

FP32_TOL = 1e-5
BF16_REL = 2e-2


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _packed_inputs(b, s, h, d, seed=0, pad_from=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (b, s, h * d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(0, 1, (b, s)).astype(np.float32)
    if pad_from is not None:
        bias[-1, pad_from:] = -1e4
    return q, k, v, bias


# -- kernel A: packed flash attention ----------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("h,d", [(2, 64), (1, 128)])
def test_packed_attention_matches_pallas_interpret(h, d, s, causal):
    b = 2
    q, k, v, bias = _packed_inputs(b, s, h, d, pad_from=s - 37)
    scale = 1.0 / np.sqrt(d)
    ref = jfap.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), h,
                                      bias=jnp.asarray(bias), causal=causal)
    out, lse = tfap.flash_attention_packed_fwd(_t(q), _t(k), _t(v), h,
                                               _t(bias), scale, causal)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=FP32_TOL,
                               atol=FP32_TOL)
    # LSE: the port keeps (b, h, s); the TPU kernel (b, pairs, hpg, s)
    # with head index pair * hpg + head, so a reshape maps one onto the other
    _, jlse = jfap._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(bias), jnp.zeros((1,), jnp.int32), h,
                            scale, causal, 0.0, s, s)
    np.testing.assert_allclose(lse.numpy(), _np(jlse).reshape(b, h, s),
                               rtol=FP32_TOL, atol=FP32_TOL)


def test_packed_attention_bf16_matches_pallas_interpret():
    b, s, h, d = 2, 128, 2, 64
    q, k, v, bias = _packed_inputs(b, s, h, d, seed=1, pad_from=90)
    ref = jfap.flash_attention_packed(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), h,
        bias=jnp.asarray(bias))
    out = tfap.flash_attention_packed(
        *(_t(t, torch.bfloat16) for t in (q, k, v)), h, bias=_t(bias))
    assert out.dtype == torch.bfloat16
    r = _np(ref)
    err = np.abs(out.float().numpy() - r).max() / np.abs(r).max()
    assert err <= BF16_REL


def test_packed_plain_matches_split_head_reference():
    """The plain version is scaled-dot-product attention written out."""
    b, s, h, d = 2, 96, 4, 64
    q, k, v, bias = _packed_inputs(b, s, h, d, seed=2, pad_from=50)
    out, _ = tfap.flash_attention_packed_plain(_t(q), _t(k), _t(v), h,
                                               _t(bias), 1.0 / np.sqrt(d))
    split = lambda a: jnp.asarray(a).reshape(b, s, h, d).transpose(0, 2, 1, 3)
    ref = jattn.scaled_dot_product_attention(
        split(q), split(k), split(v),
        attn_mask=jnp.asarray(bias)[:, None, None, :])
    ref = _np(ref).transpose(0, 2, 1, 3).reshape(b, s, h * d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=FP32_TOL, atol=FP32_TOL)


def test_packed_wrapper_on_cpu_counts_no_launch():
    config.reset_counts()
    q, k, v, bias = _packed_inputs(1, 64, 2, 64)
    tfap.flash_attention_packed(_t(q), _t(k), _t(v), 2, bias=_t(bias))
    assert config.launch_counts() == {}


def test_packed_wrapper_refuses_dropout_and_other_devices():
    q = torch.zeros(1, 128, 128)
    with pytest.raises(NotImplementedError):
        tfap.flash_attention_packed(q, q, q, 2, dropout_rate=0.1)
    m = torch.zeros(1, 128, 128, device="meta")
    with pytest.raises(ValueError):
        tfap.flash_attention_packed_fwd(
            m, m, m, 2, torch.zeros(1, 128, device="meta"), 0.125)


def test_sdpa_and_padding_bias_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 2, 64, 32)).astype(np.float32)
    mask = rng.normal(size=(2, 2, 64, 64)).astype(np.float32)
    ref = jattn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
        attn_mask=jnp.asarray(mask), is_causal=True)
    out = tattn.scaled_dot_product_attention(_t(q), _t(q), _t(q),
                                             attn_mask=_t(mask),
                                             is_causal=True)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=FP32_TOL,
                               atol=FP32_TOL)
    kmask = np.where(rng.random((2, 1, 1, 64)) < 0.3, -1e4, 0.0).astype(
        np.float32)
    bool_mask = rng.random((1, 1, 1, 64)) < 0.7
    for m in (kmask, bool_mask):
        jb = jattn._as_padding_bias(jnp.asarray(m), 2, 64)
        tb = tattn._as_padding_bias(torch.from_numpy(m), 2, 64)
        np.testing.assert_array_equal(tb.numpy(), _np(jb))
    assert tattn._as_padding_bias(_t(mask), 2, 64) is None
    assert tattn._as_padding_bias(None, 3, 8).abs().max() == 0


def test_packed_dispatch_semantic_gates():
    b, s, h, d = 2, 64, 2, 64
    q, k, v, _ = _packed_inputs(b, s, h, d, seed=4)
    tq = _t(q)
    general = torch.zeros(b, h, s, s)
    assert tattn.flash_attention_packed(tq, tq, tq, h,
                                        attn_mask=general) is None
    # odd 64-wide heads: the bhsd kernel's layout; plain route on CPU
    t3 = torch.zeros(b, s, 3 * 64)
    assert tattn.flash_attention_packed(t3, t3, t3, 3) is None
    with pytest.raises(NotImplementedError):
        tattn.flash_attention_packed(tq, tq, tq, h, dropout_p=0.1,
                                     training=True)
    out = tattn.flash_attention_packed(tq, tq, tq, h, dropout_p=0.1,
                                       training=False)
    assert out.shape == (b, s, h * d)
    flags.set_flags({"use_flash_attention": False})
    try:
        assert tattn.flash_attention_packed(tq, tq, tq, h) is None
    finally:
        flags.set_flags({"use_flash_attention": True})


# -- kernels B and C: LayerNorm, residual + LayerNorm -------------------------

def _ln_inputs(n, dim, seed=0, mean=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(mean, 1.0, (n, dim)).astype(np.float32)
    res = rng.normal(0.5, 2.0, (n, dim)).astype(np.float32)
    w = rng.normal(1.0, 0.1, (dim,)).astype(np.float32)
    b = rng.normal(0.0, 0.1, (dim,)).astype(np.float32)
    return x, res, w, b


@pytest.mark.parametrize("n,dim", [(256, 128), (512, 256), (300, 768)])
def test_layer_norm_matches_pallas_interpret(n, dim):
    x, _, w, b = _ln_inputs(n, dim)
    jout, jmean, jrstd = jln._fwd(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), 1e-5, jln._rows_block(n),
                                  jnp.float32)
    out, mean, rstd = tln.layer_norm_fwd(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=FP32_TOL,
                               atol=FP32_TOL)
    np.testing.assert_allclose(mean.numpy(), _np(jmean)[0], rtol=FP32_TOL,
                               atol=FP32_TOL)
    np.testing.assert_allclose(rstd.numpy(), _np(jrstd)[0], rtol=FP32_TOL,
                               atol=FP32_TOL)


def test_layer_norm_large_mean_rows():
    """Two-pass variance: rows of mean 1e3 keep an O(1) variance.  The fp32
    spacing at 1e3 is 6e-5, so two summation orders differ by ~3e-4 in the
    normalised output: 1e-3, as the JAX package's own test of this case."""
    x, _, w, b = _ln_inputs(256, 128, seed=3, mean=1000.0)
    ref = jln.fused_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = tln.fused_layer_norm(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-3, atol=1e-3)
    exact = torch.nn.functional.layer_norm(_t(x).double(), (128,),
                                           _t(w).double(), _t(b).double())
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("n,dim", [(256, 128), (512, 256)])
def test_residual_layer_norm_matches_pallas_interpret(n, dim):
    x, res, w, b = _ln_inputs(n, dim, seed=5)
    ref = jln.fused_residual_dropout_layer_norm(
        jnp.asarray(x), jnp.asarray(res), jnp.asarray(w), jnp.asarray(b),
        dropout_rate=0.0)
    out = tln.fused_residual_dropout_layer_norm(_t(x), _t(res), _t(w),
                                                _t(b), dropout_rate=0.0)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=FP32_TOL,
                               atol=FP32_TOL)
    _, jmean, jrstd = jln._rdln_fwd(jnp.asarray(x), jnp.asarray(res),
                                    jnp.asarray(w), jnp.asarray(b),
                                    jnp.zeros((1,), jnp.int32), 1e-5, 0.0,
                                    jln._rows_block(n), jnp.float32)
    _, mean, rstd = tln.residual_layer_norm_fwd(_t(x), _t(res), _t(w), _t(b))
    np.testing.assert_allclose(mean.numpy(), _np(jmean)[0], rtol=FP32_TOL,
                               atol=FP32_TOL)
    np.testing.assert_allclose(rstd.numpy(), _np(jrstd)[0], rtol=FP32_TOL,
                               atol=FP32_TOL)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_layer_norms_bf16_dtype_and_values_match_pallas(wdtype):
    x, res, w, b = _ln_inputs(256, 128, seed=6)
    jw = jnp.asarray(w, jnp.bfloat16 if wdtype == torch.bfloat16
                     else jnp.float32)
    jb = jnp.asarray(b, jw.dtype)
    jx, jres = (jnp.asarray(a, jnp.bfloat16) for a in (x, res))
    tx, tres = (_t(a, torch.bfloat16) for a in (x, res))
    tw, tb = _t(w, wdtype), _t(b, wdtype)
    pairs = (
        (jln.fused_layer_norm(jx, jw, jb), tln.fused_layer_norm(tx, tw, tb)),
        (jln.fused_residual_dropout_layer_norm(jx, jres, jw, jb),
         tln.fused_residual_dropout_layer_norm(tx, tres, tw, tb)),
    )
    for ref, out in pairs:
        assert str(out.dtype)[6:] == str(ref.dtype)
        r = _np(ref)
        assert np.abs(out.float().numpy() - r).max() / np.abs(r).max() \
            <= BF16_REL


def test_layer_norm_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 128)
    w = torch.ones(128)
    with pytest.raises(NotImplementedError):
        tln.fused_residual_dropout_layer_norm(x, x, w, w, dropout_rate=0.1)
    with pytest.raises(ValueError):
        tln.layer_norm_fwd(x, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError):
        tln.residual_layer_norm_fwd(x, x.double(), w, w)
    m = torch.zeros(4, 128, device="meta")
    with pytest.raises(ValueError):
        tln.layer_norm_fwd(m, torch.ones(128, device="meta"),
                           torch.zeros(128, device="meta"))


def test_functional_layer_norm_flag_paths_agree():
    """Flag on: kernel B's plain version; flag off: the composition."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    x, _, w, b = _ln_inputs(2 * 64, 128, seed=7)
    x3 = x.reshape(2, 64, 128)
    ref = JF.layer_norm(jnp.asarray(x3), 128, jnp.asarray(w), jnp.asarray(b))
    outs = []
    for on in (True, False):
        flags.set_flags({"use_fused_layer_norm": on})
        try:
            outs.append(TF.layer_norm(_t(x3), 128, _t(w), _t(b)))
        finally:
            flags.set_flags({"use_fused_layer_norm": True})
    for out in outs:
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=FP32_TOL,
                                   atol=FP32_TOL)


def test_kernel_fingerprint_off_cuda():
    if torch.cuda.is_available():
        pytest.skip("fingerprint bits are 1 where a CUDA device is present")
    assert config.fingerprint() == "tk1:fa=0,ln=0"


def test_gelu_linear_match_jax():
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as TF

    rng = np.random.default_rng(8)
    x = rng.normal(0, 2, (3, 5, 16)).astype(np.float32)
    w = rng.normal(0, 1, (16, 8)).astype(np.float32)
    b = rng.normal(0, 1, (8,)).astype(np.float32)
    np.testing.assert_allclose(TF.gelu(_t(x)).numpy(),
                               _np(JF.gelu(jnp.asarray(x))), rtol=FP32_TOL,
                               atol=FP32_TOL)
    np.testing.assert_allclose(
        TF.linear(_t(x), _t(w), _t(b)).numpy(),
        _np(JF.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))),
        rtol=FP32_TOL, atol=FP32_TOL)
    assert torch.equal(TF.dropout(_t(x), 0.3, training=False), _t(x))
    with pytest.raises(NotImplementedError):
        TF.dropout(_t(x), 0.3, training=True)
