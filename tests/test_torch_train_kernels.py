"""Kernel-level parity of the port's training kernels against the JAX
package: the dropout hash, and the forward and backward of packed flash
attention (kernel A), LayerNorm (B) and residual + dropout + LayerNorm (C).

The same numpy inputs and seeds go through the JAX Pallas functions
(interpret mode on the CPU, as the JAX package's own tests run them,
gradients through ``jax.vjp``) and through the port's wrappers, which on
CPU tensors run their kernels' plain versions inside the port's
``torch.autograd.Function``s.  Tolerances: fp32 2e-5 for attention and
1e-5 for the LayerNorms (same arithmetic, other summation order); bf16
2e-2 relative to the largest reference value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import flash_attention_packed as jfap
from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops.kernels import config
from paddle_tpu_torch.ops.kernels import dropout as tdrop
from paddle_tpu_torch.ops.kernels import flash_attention_packed as tfap
from paddle_tpu_torch.ops.kernels import layer_norm as tln

FA_TOL = 2e-5
LN_TOL = 1e-5
BF16_REL = 2e-2
SEED = -123456789


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t.requires_grad_(grad)


def _rel(out, ref):
    out = out.detach().float().numpy() if torch.is_tensor(out) else out
    ref = _np(ref)
    return np.abs(out - ref).max() / np.abs(ref).max()


# -- the hash -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, -1, 2 ** 31 - 1, -2 ** 31, SEED])
def test_dropout_hash_is_bit_identical_to_jax(seed):
    bh = np.arange(0, 97, 12)[:, None, None].astype(np.int32)
    q = np.arange(0, 1030, 17)[None, :, None].astype(np.int32)
    k = np.arange(0, 1030, 13)[None, None, :].astype(np.int32)
    for rate in (1e-4, 0.1, 0.2, 0.5, 0.9):
        ref = np.asarray(jfa._dropout_keep(
            jnp.int32(seed), jnp.asarray(bh), jnp.asarray(q), jnp.asarray(k),
            rate))
        got = tdrop.keep_mask(seed, torch.from_numpy(bh),
                              torch.from_numpy(q), torch.from_numpy(k), rate)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_dropout_hash_keeps_one_minus_rate():
    pos = torch.arange(512)
    keep = tdrop.keep_mask(3, torch.arange(96)[:, None, None],
                           pos[:, None], pos[None, :], 0.1)
    assert abs(keep.float().mean().item() - 0.9) < 0.005
    assert tdrop.threshold(0.1) == int(0.1 * 2 ** 32)
    with pytest.raises(ValueError):
        tdrop.check_rate(1.0)


# -- kernel A: packed flash attention, forward and backward -------------------

def _packed_inputs(b, s, h, d, seed=0, pad_from=None):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(0, 1, (b, s, h * d)).astype(np.float32)
                   for _ in range(4))
    bias = rng.normal(0, 1, (b, s)).astype(np.float32)
    if pad_from is not None:
        bias[-1, pad_from:] = -1e4
    return q, k, v, do, bias


def _jax_attention(q, k, v, do, bias, h, causal, rate, dtype=jnp.float32):
    fn = lambda q_, k_, v_: jfap.flash_attention_packed(
        q_, k_, v_, h, bias=jnp.asarray(bias), causal=causal,
        dropout_rate=rate, seed=jnp.int32(SEED))
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return (out,) + vjp(jnp.asarray(do, dtype))


def _torch_attention(q, k, v, do, bias, h, causal, rate,
                     dtype=torch.float32):
    tq, tk, tv = (_t(a, dtype, grad=True) for a in (q, k, v))
    out = tfap.flash_attention_packed(tq, tk, tv, h, bias=_t(bias),
                                      causal=causal, dropout_rate=rate,
                                      seed=SEED)
    out.backward(_t(do, dtype))
    return out, tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("h,d", [(2, 64), (1, 128)])
def test_attention_dropout_fwd_bwd_match_pallas(h, d, s, causal):
    q, k, v, do, bias = _packed_inputs(2, s, h, d, seed=s + h,
                                       pad_from=s - 41)
    ref = _jax_attention(q, k, v, do, bias, h, causal, 0.2)
    got = _torch_attention(q, k, v, do, bias, h, causal, 0.2)
    for name, r, g in zip(("out", "dq", "dk", "dv"), ref, got):
        np.testing.assert_allclose(g.detach().numpy(), _np(r), rtol=FA_TOL,
                                   atol=FA_TOL, err_msg=name)


def test_attention_no_dropout_backward_matches_pallas():
    q, k, v, do, bias = _packed_inputs(2, 128, 2, 64, seed=9, pad_from=70)
    ref = _jax_attention(q, k, v, do, bias, 2, False, 0.0)
    got = _torch_attention(q, k, v, do, bias, 2, False, 0.0)
    for name, r, g in zip(("out", "dq", "dk", "dv"), ref, got):
        np.testing.assert_allclose(g.detach().numpy(), _np(r), rtol=FA_TOL,
                                   atol=FA_TOL, err_msg=name)


def test_attention_dropout_bf16_matches_pallas():
    q, k, v, do, bias = _packed_inputs(2, 128, 2, 64, seed=5, pad_from=90)
    ref = _jax_attention(q, k, v, do, bias, 2, False, 0.2, jnp.bfloat16)
    got = _torch_attention(q, k, v, do, bias, 2, False, 0.2, torch.bfloat16)
    for name, r, g in zip(("out", "dq", "dk", "dv"), ref, got):
        assert g.dtype == torch.bfloat16, name
        assert _rel(g, r) <= BF16_REL, name


def test_attention_lse_with_dropout_sums_undropped_p():
    """The forward's LSE does not depend on the dropout rate."""
    q, k, v, _, bias = _packed_inputs(1, 128, 2, 64, seed=3)
    args = (_t(q), _t(k), _t(v), 2, _t(bias), 0.125)
    _, lse0 = tfap.flash_attention_packed_fwd(*args)
    out1, lse1 = tfap.flash_attention_packed_fwd(*args, False, 0.3, SEED)
    out2, _ = tfap.flash_attention_packed_fwd(*args, False, 0.3, SEED + 1)
    assert torch.equal(lse0, lse1)
    assert not torch.allclose(out1, out2)


# -- kernels B and C: forward and backward -----------------------------------

def _ln_inputs(n, dim, seed=0, mean=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(mean, 1.0, (n, dim)).astype(np.float32)
    res = rng.normal(0.5, 2.0, (n, dim)).astype(np.float32)
    w = rng.normal(1.0, 0.1, (dim,)).astype(np.float32)
    b = rng.normal(0.0, 0.1, (dim,)).astype(np.float32)
    dy = rng.normal(0.0, 1.0, (n, dim)).astype(np.float32)
    return x, res, w, b, dy


def _jax_ln(x, res, w, b, dy, rate, dtype=jnp.float32):
    if res is None:
        fn = lambda x_, w_, b_: jln.fused_layer_norm(x_, w_, b_)
        args = (x, w, b)
    else:
        fn = lambda x_, r_, w_, b_: jln.fused_residual_dropout_layer_norm(
            x_, r_, w_, b_, dropout_rate=rate, seed=jnp.int32(SEED))
        args = (x, res, w, b)
    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in args))
    return (out,) + vjp(jnp.asarray(dy, out.dtype))


def _torch_ln(x, res, w, b, dy, rate, dtype=torch.float32):
    tx, tw, tb = (_t(a, dtype, grad=True) for a in (x, w, b))
    if res is None:
        out = tln.fused_layer_norm(tx, tw, tb)
        leaves = (tx, tw, tb)
    else:
        tr = _t(res, dtype, grad=True)
        out = tln.fused_residual_dropout_layer_norm(
            tx, tr, tw, tb, dropout_rate=rate, seed=SEED)
        leaves = (tx, tr, tw, tb)
    out.backward(_t(dy, out.dtype))
    return (out,) + tuple(t.grad for t in leaves)


@pytest.mark.parametrize("mean", [0.0, 1000.0], ids=["mean0", "mean1e3"])
@pytest.mark.parametrize("n,dim", [(256, 128), (512, 256)])
def test_layer_norm_fwd_bwd_match_pallas(n, dim, mean):
    x, _, w, b, dy = _ln_inputs(n, dim, seed=n + dim, mean=mean)
    ref = _jax_ln(x, None, w, b, dy, 0.0)
    got = _torch_ln(x, None, w, b, dy, 0.0)
    # rows of mean 1e3: fp32 spacing 6e-5 in x, ~3e-4 in x_hat (as the
    # forward's large-mean test); dw sums n such values
    tol = LN_TOL if mean == 0.0 else 1e-3
    for name, r, g in zip(("out", "dx", "dw", "db"), ref, got):
        scale = n if name == "dw" and mean else 1.0
        np.testing.assert_allclose(g.detach().numpy(), _np(r),
                                   rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("n,dim", [(256, 128), (512, 256)])
def test_residual_dropout_layer_norm_fwd_bwd_match_pallas(n, dim, rate):
    x, res, w, b, dy = _ln_inputs(n, dim, seed=n + 3)
    ref = _jax_ln(x, res, w, b, dy, rate)
    got = _torch_ln(x, res, w, b, dy, rate)
    for name, r, g in zip(("out", "dx", "dres", "dw", "db"), ref, got):
        np.testing.assert_allclose(g.detach().numpy(), _np(r), rtol=LN_TOL,
                                   atol=LN_TOL * (10 if name == "dw" else 1),
                                   err_msg=name)


def test_residual_dropout_layer_norm_large_mean_rows():
    x, res, w, b, dy = _ln_inputs(256, 128, seed=4, mean=1000.0)
    ref = _jax_ln(x, res, w, b, dy, 0.3)
    got = _torch_ln(x, res, w, b, dy, 0.3)
    for name, r, g in zip(("out", "dx", "dres", "dw", "db"), ref, got):
        scale = 256 if name == "dw" else 1
        np.testing.assert_allclose(g.detach().numpy(), _np(r), rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=name)


@pytest.mark.parametrize("residual", [False, True], ids=["ln", "rdln"])
def test_layer_norms_bf16_fwd_bwd_match_pallas(residual):
    x, res, w, b, dy = _ln_inputs(256, 128, seed=8)
    res = res if residual else None
    ref = _jax_ln(x, res, w, b, dy, 0.3, jnp.bfloat16)
    got = _torch_ln(x, res, w, b, dy, 0.3, torch.bfloat16)
    for r, g in zip(ref, got):
        assert g.dtype == torch.bfloat16
        assert _rel(g, r) <= BF16_REL


def test_layer_norm_kept_share_and_mask_replay():
    """Kernel C's dx is zero exactly where its forward dropped x."""
    x, res, w, b, dy = _ln_inputs(512, 256, seed=2)
    tx = _t(x, grad=True)
    out = tln.fused_residual_dropout_layer_norm(
        tx, _t(res), _t(w), _t(b), dropout_rate=0.1, seed=SEED)
    out.backward(_t(dy))
    kept = tx.grad != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    mask = tdrop.keep_mask(SEED, 0, torch.arange(512)[:, None],
                           torch.arange(256)[None, :], 0.1)
    assert torch.equal(kept, mask)


# -- the Functions: one dispatch on every device ----------------------------

def test_functions_are_the_grad_fn_and_match_plain_backward():
    q, k, v, do, bias = _packed_inputs(1, 64, 2, 64, seed=11)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = tfap.flash_attention_packed(tq, tk, tv, 2, bias=_t(bias),
                                      dropout_rate=0.1, seed=5)
    # the packed layout's view of the one attention Function
    fn = out.grad_fn
    while fn is not None and type(fn).__name__ != "_FlashAttentionBackward":
        fn = fn.next_functions[0][0]
    assert fn is not None
    out.backward(_t(do))
    fo, lse = tfap.flash_attention_packed_plain(
        _t(q), _t(k), _t(v), 2, _t(bias), 0.125, False, 0.1, 5)
    plain = tfap.flash_attention_packed_bwd_plain(
        _t(q), _t(k), _t(v), _t(bias), fo, lse, _t(do), 2, 0.125, False,
        0.1, 5)
    for g, p in zip((tq.grad, tk.grad, tv.grad), plain):
        assert torch.equal(g, p)

    x, res, w, b, dy = _ln_inputs(64, 128, seed=12)
    tx, tr, tw, tb = (_t(a, grad=True) for a in (x, res, w, b))
    out = tln.fused_layer_norm(tx, tw, tb)
    assert type(out.grad_fn).__name__ == "_FusedLayerNormBackward"
    out.backward(_t(dy))
    _, mean, rstd = tln.layer_norm_plain(_t(x), _t(w), _t(b))
    plain = tln.layer_norm_bwd_plain(_t(x), _t(w), mean, rstd, _t(dy))
    for g, p in zip((tx.grad, tw.grad, tb.grad), plain):
        assert torch.equal(g, p)

    tx.grad = tw.grad = tb.grad = None
    out = tln.fused_residual_dropout_layer_norm(tx, tr, tw, tb,
                                                dropout_rate=0.2, seed=6)
    assert (type(out.grad_fn).__name__
            == "_FusedResidualDropoutLayerNormBackward")
    out.backward(_t(dy))
    _, mean, rstd = tln.residual_layer_norm_plain(_t(x), _t(res), _t(w),
                                                  _t(b), 1e-5, 0.2, 6)
    plain = tln.residual_layer_norm_bwd_plain(_t(x), _t(res), _t(w), mean,
                                              rstd, _t(dy), 0.2, 6)
    for g, p in zip((tx.grad, tr.grad, tw.grad, tb.grad), plain):
        assert torch.equal(g, p)


def test_no_grad_calls_run_the_forward_alone():
    q, k, v, _, bias = _packed_inputs(1, 64, 2, 64, seed=13)
    with torch.no_grad():
        out = tfap.flash_attention_packed(_t(q, grad=True), _t(k), _t(v), 2,
                                          bias=_t(bias))
    assert out.grad_fn is None
    config.reset_counts()
    x = _t(np.ones((8, 128), np.float32), grad=True)
    with torch.inference_mode():
        tln.fused_layer_norm(x, torch.ones(128), torch.zeros(128))
    assert config.launch_counts() == {}


def test_backward_wrappers_check_shapes():
    q = torch.zeros(1, 64, 128)
    lse = torch.zeros(1, 2, 64)
    bias = torch.zeros(1, 64)
    with pytest.raises(ValueError):
        tfap.flash_attention_packed_bwd(q, q, q, bias, q, lse[:, :1], q, 2,
                                        0.125)
    with pytest.raises(ValueError):
        tfap.flash_attention_packed_bwd(q, q, q, bias, q, lse,
                                        q.double(), 2, 0.125)
    x = torch.zeros(4, 128)
    w = torch.ones(128)
    stats = torch.zeros(4)
    with pytest.raises(ValueError):
        tln.layer_norm_bwd(x, w, stats, stats, x.bfloat16())
    with pytest.raises(ValueError):
        tln.residual_layer_norm_bwd(x, x, w, stats[:2], stats, x)
