"""Parity of the port's (batch, heads, seq, head_dim) flash attention and
``MultiHeadAttention``'s split-head route against the JAX package.

The same numpy inputs and seeds go through the JAX Pallas function
``paddle_tpu.ops.pallas.flash_attention.flash_attention`` (interpret mode on
the CPU, as the JAX package's own tests run it; gradients through
``jax.vjp``) and through the port, whose wrappers run their kernels' plain
versions on CPU tensors inside the port's ``torch.autograd.Function``.
Blocks of 64-128 rows keep interpret mode quick.  Tolerances (fp32): the
forward 1e-5 (same arithmetic, other summation order), gradients 1e-4 of
the largest reference value; the layers and the model 1e-4 (1e-5 per
layer); dropout masks are bit-identical (same position hash).
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from __graft_entry__ import make_train_step as jax_make_train_step
from paddle_tpu.autograd import parameters_dict as jax_parameters_dict
from paddle_tpu.nn.layer import transformer as jtr
from paddle_tpu.ops import attention as jattn
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.text import ernie as jernie
from paddle_tpu_torch import convert
from paddle_tpu_torch import entry as tentry
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer import transformer as ttr
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops.kernels import config
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_attention_packed as tfap
from paddle_tpu_torch.text import ernie as ternie

FWD_TOL = 1e-5
GRAD_REL = 1e-4
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
SEED = -987654321
BLOCK = 128


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _np_params(layer):
    return {k: np.asarray(v) for k, v in jax_parameters_dict(layer).items()}


def _inputs(b, h, s, d, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(0, 1, (b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    bias = rng.normal(0, 1, (b, s)).astype(np.float32)
    if ragged:
        bias[-1, s - 37:] = -1e4       # a padded request
    return q, k, v, do, bias


def _jax_flash(q, k, v, bias, causal, rate, seed=SEED):
    return jfa.flash_attention(q, k, v, bias=bias, causal=causal,
                               dropout_rate=rate,
                               seed=jnp.int32(seed) if rate else None,
                               block_q=BLOCK, block_k=BLOCK)


CASES = [(2, 3, 128, 64), (1, 2, 256, 128), (1, 1, 128, 256), (1, 1, 128, 320)]


# -- the kernel's plain version against the Pallas function ------------------

@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,s,d", CASES)
def test_forward_matches_pallas_interpret(b, h, s, d, causal, rate):
    q, k, v, _, bias = _inputs(b, h, s, d)
    ref = _jax_flash(*(jnp.asarray(x) for x in (q, k, v, bias)), causal,
                     rate)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias),
                                       d ** -0.5, causal, rate, SEED)
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)
    merged = lambda x: jnp.asarray(x).reshape(b * h, s, d)
    _, jlse = jfa._flash_forward(
        merged(q), merged(k), merged(v), jnp.asarray(bias),
        jnp.full((1,), SEED, jnp.int32), d ** -0.5, causal, rate, BLOCK,
        BLOCK)
    # the port keeps LSE as (b, h, s); the TPU kernel as (b * h, 1, s)
    np.testing.assert_allclose(lse.numpy(), _np(jlse).reshape(b, h, s),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_dropout_mask_is_the_pallas_mask():
    """bh = batch * heads + head: the key of the Pallas kernel's
    ``program_id(0)`` (and of the packed kernel), so the masks agree bit
    for bit."""
    b, h, s, rate = 2, 3, 128, 0.1
    keep = tfa._keep(b, h, s, SEED, rate, "cpu").numpy()
    pos = np.arange(s, dtype=np.int32)
    ref = np.asarray(jfa._dropout_keep(
        jnp.int32(SEED), jnp.arange(b * h, dtype=jnp.int32)[:, None, None],
        jnp.asarray(pos)[:, None], jnp.asarray(pos)[None, :], rate))
    np.testing.assert_array_equal(keep.reshape(b * h, s, s), ref)
    assert 0.88 < keep.mean() < 0.92


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,s,d", CASES)
def test_backward_matches_jax_vjp(b, h, s, d, causal, rate):
    q, k, v, do, bias = _inputs(b, h, s, d, seed=1)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: _jax_flash(q_, k_, v_, jnp.asarray(bias), causal,
                                      rate),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tout = tfa.flash_attention(tq, tk, tv, bias=_t(bias), causal=causal,
                               dropout_rate=rate, seed=SEED)
    assert tout.grad_fn is not None and "FlashAttention" in \
        type(tout.grad_fn).__name__
    np.testing.assert_allclose(tout.detach().numpy(), _np(out),
                               rtol=FWD_TOL, atol=FWD_TOL)
    grads = torch.autograd.grad(tout, (tq, tk, tv), _t(do))
    for name, g, r in zip("qkv", grads, refs):
        r = _np(r)
        err = np.abs(g.numpy() - r).max() / np.abs(r).max()
        assert err <= GRAD_REL, (name, err)


def test_bf16_forward_matches_pallas_interpret():
    b, h, s, d = 2, 3, 128, 64
    q, k, v, _, bias = _inputs(b, h, s, d, seed=2)
    ref = _jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     jnp.asarray(bias), False, 0.0)
    out = tfa.flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                              bias=_t(bias))
    assert out.dtype == torch.bfloat16
    r = _np(ref)
    assert np.abs(out.float().numpy() - r).max() / np.abs(r).max() <= 2e-2


def test_packed_and_split_layouts_share_the_arithmetic():
    """The packed plain version is the split one on the heads' views, so
    out, lse and the gradients agree, dropout included."""
    b, h, s, d = 2, 4, 128, 64
    q, k, v, do, bias = (_t(x) for x in _inputs(b, h, s, d, seed=3))
    packed = lambda x: x.transpose(1, 2).reshape(b, s, h * d)
    out, lse = tfa.flash_attention_fwd(q, k, v, bias, 0.125, True, 0.1, SEED)
    pout, plse = tfap.flash_attention_packed_fwd(
        packed(q), packed(k), packed(v), h, bias, 0.125, True, 0.1, SEED)
    same = lambda a, b_: torch.testing.assert_close(a, b_, rtol=FWD_TOL,
                                                    atol=FWD_TOL)
    same(pout, packed(out))
    same(plse, lse)
    grads = tfa.flash_attention_bwd(q, k, v, bias, out, lse, do, 0.125,
                                    True, 0.1, SEED)
    pgrads = tfap.flash_attention_packed_bwd(
        packed(q), packed(k), packed(v), bias, pout, plse, packed(do), h,
        0.125, True, 0.1, SEED)
    for g, pg in zip(grads, pgrads):
        same(pg, packed(g))


def test_wrappers_count_no_launch_on_cpu_and_refuse_what_cuda_refuses():
    config.reset_counts()
    q, k, v, do, bias = (_t(x) for x in _inputs(1, 2, 128, 64))
    tfa.flash_attention(q.requires_grad_(), k, v, bias=bias).sum().backward()
    assert config.launch_counts() == {}
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, dropout_rate=1.0)
    m = torch.zeros(1, 2, 128, 64, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(m, m, m, torch.zeros(1, 128, device="meta"),
                                0.125)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k[:, :, :64], v, bias, 0.125)
    # every head width supported() admits is taken on CUDA, wide ones too;
    # widths that are not multiples of 64 raise
    for d in (64, 128, 192, 256, 320, 512):
        assert tfa.supported(128, d)
        tfa._check_head_dim(tfa.KERNEL, d)
    for d in (32, 96):
        assert not tfa.supported(128, d)
        with pytest.raises(ValueError, match="head_dim"):
            tfa._check_head_dim(tfa.KERNEL, d)
    # an odd 64-wide head count is not the packed kernel's: the refusal
    # names the route that serves it
    with pytest.raises(ValueError, match="split-head route"):
        tfap._check_layout(tfap.KERNEL, 3, 64)
    tfap._check_layout(tfap.KERNEL, 2, 64)


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 512, 1024])
def test_tile_plan_splits_wide_heads(d):
    """The kernels' tiles for a head width: bf16 keeps Q in shared memory
    up to d 256 and above splits every pass's output columns into CTAs of
    256; fp32 writes backward slices of d / 2 at d 192-256 and every pass
    in slices of 128 above; the slices cover the head."""
    bf = tfa.tile_plan(d, torch.bfloat16)
    assert bf.fwd_rows == 128 and bf.fwd_keys == (128 if d <= 128 else 64)
    assert bf.fwd_stream == (d > 256)
    assert bf.fwd_slices == bf.bwd_slices == bf.dq_slices
    assert bf.fwd_slices * 256 >= d and (bf.fwd_slices - 1) * 256 < d
    assert bf.fwd_slices == (1 if d <= 256 else -(-d // 256))
    assert bf.bwd_rows == (128 if d <= 128 else 64) and bf.bwd_cols == 64
    assert bf.dq_keys in (32, 64, 128)
    f32 = tfa.tile_plan(d, torch.float32)
    width = d if d <= 128 else d // 2 if d <= 256 else 128
    assert f32.bwd_slices == f32.dq_slices == -(-d // width)
    assert f32.fwd_slices == (1 if d <= 256 else -(-d // 128))
    assert f32.fwd_keys == (64 if d <= 128 or d > 256 else 32)


def test_split_head_views_reach_the_kernels_without_copies():
    """The split route's (b, h, s, d) views of the (b, s, h*d) projections
    share one dense layout: the kernels take them as they are, with the
    packed layout's strides, and write outputs in that layout, so the
    packed view of an output is free.  Other layouts are copied first."""
    b, s, h, d = 2, 128, 3, 64
    proj = [torch.randn(b, s, h * d) for _ in range(3)]
    views = [t.reshape(b, s, h, d).transpose(1, 2) for t in proj]
    got = tfa._one_layout(*views)
    for g, p, v in zip(got, proj, views):
        assert g.data_ptr() == p.data_ptr() and g.stride() == v.stride()
    out = tfa._like("t", views[0])
    assert out.stride() == views[0].stride()
    assert tfap._packed(out, out.dtype).data_ptr() == out.data_ptr()
    bias, lse = torch.zeros(b, s), torch.zeros(b, h, s)
    heads = [("q", views[0]), ("k", views[1]), ("v", views[2]), ("out", out)]
    assert tfa._check_cuda("t", torch.float32, heads,
                           [("bias", bias), ("lse", lse)]) \
        == (s * h * d, d, h * d)
    contiguous = torch.randn(b, h, s, d)
    assert tfa._check_cuda("t", torch.float32, [("q", contiguous)], []) \
        == (h * s * d, s * d, d)
    with pytest.raises(ValueError, match="layout"):
        tfa._check_cuda("t", torch.float32,
                        [("q", views[0]), ("k", contiguous)], [])
    assert all(t.is_contiguous()
               for t in tfa._one_layout(views[0], contiguous, contiguous))
    # one fused qkv projection: views with gaps between rows
    fused = torch.randn(b, s, 3 * h * d)
    qkv = [fused[..., i * h * d:(i + 1) * h * d].reshape(b, s, h, d)
           .transpose(1, 2) for i in range(3)]
    assert all(t.is_contiguous() for t in tfa._one_layout(*qkv))
    with pytest.raises(ValueError, match="dense"):
        tfa._like("t", qkv[0])
    # the gradients through the views equal those through contiguous copies
    do = torch.randn(b, h, s, d)
    grads = []
    for inputs in (views, [t.contiguous() for t in views]):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = tfa.flash_attention(*leaves, dropout_rate=0.1, seed=SEED)
        out.backward(do)
        grads.append([t.grad for t in leaves])
    for g, ref in zip(*grads):
        assert torch.equal(g, ref)


def test_no_grad_runs_the_forward_alone():
    q, k, v, _, bias = (_t(x) for x in _inputs(1, 2, 128, 64))
    with torch.no_grad():
        out = tfa.flash_attention(q.requires_grad_(), k, v, bias=bias)
    assert out.grad_fn is None
    ref, _ = tfa.flash_attention_fwd_plain(q.detach(), k, v, bias, 0.125)
    assert torch.equal(out, ref)


# -- the dispatch -------------------------------------------------------------

MASKS = ["none", "key_float", "key_bool_bcast", "general", "query_key",
         "causal", "kv_shorter", "d32", "s100", "flag_off"]


@pytest.mark.parametrize("case", MASKS)
def test_dispatch_gates_match_jax(monkeypatch, case):
    """The port's gates are the JAX dispatcher's minus its TPU gate: with
    the JAX backend gate forced on, both take their kernel in the same
    cases, and the outputs agree."""
    b, h, s, d = 2, 2, 128, 64
    if case == "d32":
        d = 32
    if case == "s100":
        s = 100
    q, k, v, _, _ = _inputs(b, h, s, d, seed=4)
    rng = np.random.default_rng(5)
    mask, causal = None, case == "causal"
    if case == "key_float":
        mask = np.where(rng.random((b, 1, 1, s)) < 0.3, -1e4, 0.0).astype(
            np.float32)
    elif case == "key_bool_bcast":
        mask = rng.random((1, 1, 1, s)) < 0.7
        mask[..., 0] = True
    elif case == "general":
        mask = rng.normal(0, 1, (b, h, s, s)).astype(np.float32)
    elif case == "query_key":
        mask = rng.normal(0, 1, (b, 1, s, s)).astype(np.float32)
    elif case == "kv_shorter":
        k, v = k[:, :, :s // 2], v[:, :, :s // 2]
    calls = {"jax": 0, "port": 0}

    def counted(key, fn):
        def run(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(jattn, "_is_tpu", lambda: True)
    monkeypatch.setattr(jfa, "flash_attention",
                        counted("jax", jfa.flash_attention))
    monkeypatch.setattr(tfa, "flash_attention",
                        counted("port", tfa.flash_attention))
    if case == "flag_off":
        from paddle_tpu.core import flags as jflags

        monkeypatch.setitem(jflags._FLAGS, "use_flash_attention", False)
        flags.set_flags({"use_flash_attention": False})
    try:
        ref = jattn.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            attn_mask=None if mask is None else jnp.asarray(mask),
            is_causal=causal, training=False)
        out = tattn.flash_attention(
            _t(q), _t(k), _t(v),
            attn_mask=None if mask is None else torch.from_numpy(mask),
            is_causal=causal, training=False)
    finally:
        flags.set_flags({"use_flash_attention": True})
    kernel = case in ("none", "key_float", "key_bool_bcast", "causal")
    assert calls == {"jax": int(kernel), "port": int(kernel)}
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_dispatch_draws_one_seed_when_training_drops(monkeypatch):
    seen = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: seen.append(kw["seed"]) or a[0])
    q = torch.zeros(1, 2, 128, 64)
    tattn.flash_attention(q, q, q, dropout_p=0.1, training=True)
    tattn.flash_attention(q, q, q, dropout_p=0.1, training=False)
    tattn.flash_attention(q, q, q)
    assert isinstance(seen[0], int) and seen[1:] == [None, None]


def test_functional_exports_the_attention_ops():
    assert TF.flash_attention is tattn.flash_attention
    assert TF.scaled_dot_product_attention is \
        tattn.scaled_dot_product_attention
    assert "NotImplementedError" not in inspect.getsource(tattn)


# -- MultiHeadAttention against the JAX class ---------------------------------

def _mha_pair(embed, heads, seed, **kw):
    paddle_tpu.seed(seed)
    jm = jtr.MultiHeadAttention(embed, heads, **kw)
    jm.eval()
    tm = ttr.MultiHeadAttention(embed, heads, **kw).eval()
    convert.from_jax_params(_np_params(jm), tm)
    return jm, tm


def _close(got, ref, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mask", ["none", "float", "bool"])
def test_mha_need_weights_matches_jax(mask):
    b, s, e = 2, 64, 96
    jm, tm = _mha_pair(e, 3, 6, need_weights=True)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (b, s, e)).astype(np.float32)
    m = {"none": None,
         "float": np.where(rng.random((b, 1, 1, s)) < 0.3, -1e4,
                           0.0).astype(np.float32),
         "bool": np.tril(np.ones((s, s), bool))[None, None]}[mask]
    jout, jw = jm(jnp.asarray(x), attn_mask=None if m is None
                  else jnp.asarray(m))
    tout, tw = tm(_t(x), attn_mask=None if m is None else torch.from_numpy(m))
    _close(tout, jout)
    _close(tw, jw)
    np.testing.assert_allclose(tw.sum(-1).detach().numpy(), 1.0, atol=1e-5)


def test_mha_need_weights_drops_weights_in_training():
    torch.manual_seed(0)
    tm = ttr.MultiHeadAttention(64, 2, dropout=0.5, need_weights=True)
    x = torch.randn(2, 16, 64)
    out, w = tm(x)
    tm.eval()
    out_eval, w_eval = tm(x)
    assert torch.allclose(w, w_eval)            # weights before dropout
    assert not torch.allclose(out, out_eval)    # the product drops them


@pytest.mark.parametrize("sk", [128, 64], ids=["kernel", "plain"])
def test_mha_kdim_vdim_cross_attention_matches_jax(sk):
    """Odd 64-wide heads: the packed kernel refuses them, so equal lengths
    take the split-head kernel route and a shorter memory the plain one."""
    b, sq, e = 2, 128, 192
    jm, tm = _mha_pair(e, 3, 8, kdim=48, vdim=80)
    assert tuple(tm.k_proj.weight.shape) == (48, 192)
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (b, sq, e)).astype(np.float32)
    key = rng.normal(0, 1, (b, sk, 48)).astype(np.float32)
    val = rng.normal(0, 1, (b, sk, 80)).astype(np.float32)
    mask = np.zeros((b, 1, 1, sk), np.float32)
    mask[-1, ..., sk - 20:] = -1e4
    jout = jm(jnp.asarray(x), jnp.asarray(key), jnp.asarray(val),
              attn_mask=jnp.asarray(mask))
    tout = tm(_t(x), _t(key), _t(val), attn_mask=torch.from_numpy(mask))
    _close(tout, jout)


def test_mha_cache_and_static_cache_match_jax():
    b, s, e = 2, 128, 192
    jm, tm = _mha_pair(e, 3, 10)
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (b, s, e)).astype(np.float32)
    step = rng.normal(0, 1, (b, 1, e)).astype(np.float32)
    mem = rng.normal(0, 1, (b, 96, e)).astype(np.float32)
    jc, tc = jm.gen_cache(jnp.asarray(x)), tm.gen_cache(_t(x))
    assert isinstance(tc, ttr.MultiHeadAttention.Cache)
    assert tuple(tc.k.shape) == (b, 3, 0, 64)
    for inp in (x, step):       # the prompt, then one decode step
        jout, jc = jm(jnp.asarray(inp), cache=jc)
        tout, tc = tm(_t(inp), cache=tc)
        _close(tout, jout)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
    assert tuple(tc.k.shape) == (b, 3, s + 1, 64)
    jsc = jm.gen_cache(jnp.asarray(mem), type=jtr.MultiHeadAttention.StaticCache)
    tsc = tm.gen_cache(_t(mem), type=ttr.MultiHeadAttention.StaticCache)
    _close(tsc.k, jsc.k)
    jout = jm(jnp.asarray(x), jnp.asarray(mem), jnp.asarray(mem), cache=jsc)
    tout = tm(_t(x), _t(mem), _t(mem), cache=tsc)
    assert torch.is_tensor(tout)        # a static cache is not returned
    _close(tout, jout)


def test_encoder_with_cache_matches_jax():
    """A bare encoder carried by name through ``from_jax_params``, run with
    a cache from ``gen_cache``."""
    paddle_tpu.seed(12)
    jl = jtr.TransformerEncoderLayer(192, 3, 256, dropout=0.1,
                                     activation="gelu", act_dropout=0.0)
    je = jtr.TransformerEncoder(jl, 2)
    je.eval()
    te = ttr.TransformerEncoder(
        ttr.TransformerEncoderLayer(192, 3, 256, dropout=0.1,
                                    activation="gelu", act_dropout=0.0),
        2).eval()
    convert.from_jax_params(_np_params(je), te)
    x = np.random.default_rng(13).normal(0, 1, (2, 128, 192)).astype(
        np.float32)
    jout, jcaches = je(jnp.asarray(x), None, je.gen_cache(jnp.asarray(x)))
    tout, tcaches = te(_t(x), None, te.gen_cache(_t(x)))
    _close(tout, jout, MODEL_TOL)
    assert len(tcaches) == 2
    for tc, jc in zip(tcaches, jcaches):
        _close(tc.k, jc.k, MODEL_TOL)
        _close(tc.v, jc.v, MODEL_TOL)
    _close(te(_t(x)), je(jnp.asarray(x)), MODEL_TOL)


# -- the split-head route through ERNIE ---------------------------------------

ODD_HEADS = dict(vocab_size=512, hidden_size=192, num_hidden_layers=2,
                 num_attention_heads=3, intermediate_size=256,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


class _Capture:
    """An optimizer whose update hands back the gradients."""

    def update(self, grads, state, params, lr=None):
        return grads, state


@pytest.fixture(scope="module")
def odd_head_models():
    paddle_tpu.seed(14)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**ODD_HEADS))
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**ODD_HEADS),
                                    device="cpu")
    convert.from_jax_params(_np_params(jm), tm)
    return jm, tm


def _odd_batch(b=2, s=128, vocab=512, n_mask=8):
    rng = np.random.default_rng(15)
    ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
    ids[1, 93:] = 0
    pos = np.stack([rng.choice(90, n_mask, replace=False)
                    for _ in range(b)]).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
            "masked_positions": pos,
            "mlm_labels": rng.integers(0, vocab, (b, n_mask)).astype(
                np.int32),
            "nsp_labels": rng.integers(0, 2, (b,)).astype(np.int32)}


@pytest.fixture
def route_counts(monkeypatch):
    """Calls of the (b, h, s, d) wrappers by the name they would count a
    launch under: the split route's, or the packed kernel's."""
    counts = {"fwd": 0, "bwd": 0, "packed": 0}
    keys = {tfa.KERNEL: "fwd", tfa.KERNEL_BWD: "bwd",
            tfap.KERNEL: "packed", tfap.KERNEL_BWD: "packed"}

    def counted(name):
        fn = getattr(tfa, name)
        default = inspect.signature(fn).parameters["name"].default

        def run(*args, **kw):
            counts[keys[kw.get("name", default)]] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(tfa, name, run)

    counted("flash_attention_fwd")
    counted("flash_attention_bwd")
    return counts


def test_odd_head_ernie_forward_takes_split_route_and_matches_jax(
        odd_head_models, route_counts):
    jm, tm = odd_head_models
    jm.eval()
    tm.eval()
    batch = _odd_batch()
    ids, pos = batch["input_ids"], batch["masked_positions"]
    jl, jn = jm(jnp.asarray(ids), masked_positions=jnp.asarray(pos))
    with torch.no_grad():
        tl, tn = tm(torch.from_numpy(ids).long(),
                    masked_positions=torch.from_numpy(pos).long())
    assert route_counts == {"fwd": 2, "bwd": 0, "packed": 0}
    _close(tl, jl, MODEL_TOL)
    _close(tn, jn, MODEL_TOL)


def test_odd_head_ernie_train_step_matches_jax(odd_head_models,
                                               route_counts):
    jm, tm = odd_head_models
    jm.train()
    tm.train()
    batch = _odd_batch()
    crit = jernie.ErniePretrainingCriterion(512)
    jstep = jax_make_train_step(jm, crit, _Capture())
    jgrads, _, jloss = jstep(jax_parameters_dict(jm), None,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(0))
    tstep = tentry.make_train_step(tm, ternie.ErniePretrainingCriterion(512),
                                   _Capture())
    tgrads, _, tloss = tstep(convert.parameters_dict(tm), None,
                             {k: torch.from_numpy(v).long()
                              for k, v in batch.items()},
                             torch.Generator().manual_seed(0))
    assert route_counts == {"fwd": 2, "bwd": 2, "packed": 0}
    assert abs(tloss.item() - float(jloss)) <= MODEL_TOL * abs(float(jloss))
    assert set(tgrads) == set(jgrads)
    floor = 1e-4 * max(float(np.abs(_np(g)).max()) for g in jgrads.values())
    for name, jg in jgrads.items():
        jg = _np(jg)
        scale = max(float(np.abs(jg).max()), floor)
        err = float(np.abs(tgrads[name].numpy() - jg).max()) / scale
        assert err <= MODEL_TOL, (name, err)
