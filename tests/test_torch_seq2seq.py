"""The port's decoder stack (TransformerDecoderLayer, TransformerDecoder,
Transformer) against the JAX package's, on the CPU at a small size (d 64,
2 heads, FFN 128, 2 + 2 layers, dropout 0), pre- and post-LN, with the
square subsequent mask on the decoder's self attention, equal and unequal
source / target lengths.  Weights go JAX -> port through
``convert.from_jax_params``; inputs are numpy from a seed.  Tolerance: the
output and every gradient (each parameter's, the source's and the
target's) within 1e-4 of that tensor's largest value.  The key
projections' bias gradients are zero in exact arithmetic (softmax ignores
a shift of a whole row of scores), so both packages give rounding noise
there: those are held below 1e-4 of the largest gradient of all.  The
incremental decode (a self-attention ``Cache`` and a cross-attention
``StaticCache`` per layer, one token a step) equals the JAX package's and
the full causal forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.autograd import functional_call, parameters_dict
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn

D, H, FF = 64, 2, 128
REL = 1e-4


def _np_params(layer):
    return {k: np.asarray(v) for k, v in parameters_dict(layer).items()}


def _pair(kind, normalize_before):
    paddle_tpu.seed(3)
    kw = dict(dropout=0.0, normalize_before=normalize_before)
    if kind == "layer":
        j = jnn.TransformerDecoderLayer(D, H, FF, **kw)
        t = tnn.TransformerDecoderLayer(D, H, FF, **kw)
    elif kind == "decoder":
        j = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(D, H, FF, **kw),
                                   2, jnn.LayerNorm(D) if normalize_before
                                   else None)
        t = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(D, H, FF, **kw),
                                   2, tnn.LayerNorm(D) if normalize_before
                                   else None)
    else:
        j = jnn.Transformer(D, H, 2, 2, FF, **kw)
        t = tnn.Transformer(D, H, 2, 2, FF, **kw)
    convert.from_jax_params(_np_params(j), t)
    j.train()
    t.train()
    return j, t


def _inputs(s_src, s_tgt, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (2, s_src, D)).astype(np.float32),
            rng.normal(0, 1, (2, s_tgt, D)).astype(np.float32))


def _call(kind, model, src, tgt, mask):
    if kind == "transformer":
        return model(src, tgt, tgt_mask=mask)
    return model(tgt, src, tgt_mask=mask)


def _close(got, ref, floor):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), floor)
    err = float(np.abs(got.detach().numpy() - ref).max()) / scale
    return err <= REL, err


@pytest.mark.parametrize("s_src,s_tgt", [(16, 16), (24, 10)])
@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("kind", ["layer", "decoder", "transformer"])
def test_forward_and_every_gradient_match_jax(kind, normalize_before, s_src,
                                              s_tgt):
    j, t = _pair(kind, normalize_before)
    src, tgt = _inputs(s_src, s_tgt)
    jmask = jnn.Transformer.generate_square_subsequent_mask(s_tgt)
    tmask = tnn.Transformer.generate_square_subsequent_mask(s_tgt,
                                                            device="cpu")
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask.dtype == torch.float32

    def jloss(p, s, g):
        out = functional_call(j, p, (s, g) if kind == "transformer"
                              else (g, s), {"tgt_mask": jmask})
        return jnp.sum(out * jnp.sin(out)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        parameters_dict(j), jnp.asarray(src), jnp.asarray(tgt))
    ts = torch.from_numpy(src).requires_grad_()
    tt = torch.from_numpy(tgt).requires_grad_()
    tout = _call(kind, t, ts, tt, tmask)
    names = [n for n, _ in t.named_parameters()]
    grads = torch.autograd.grad((tout * torch.sin(tout)).sum(),
                                [ts, tt] + list(t.parameters()))
    ok, err = _close(tout, jout, 1e-30)
    assert ok, ("output", err)
    jp, js, jt = jgrads
    assert set(names) == set(jp)
    ref = dict(jp, __src=js, __tgt=jt)
    got = dict(zip(["__src", "__tgt"] + names, grads))
    top = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    for k, g in got.items():
        if k.endswith("k_proj.bias"):
            assert float(g.abs().max()) <= REL * top, k
            assert float(np.abs(np.asarray(ref[k])).max()) <= REL * top, k
            continue
        ok, err = _close(g, ref[k], 1e-30)
        assert ok, (k, err)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_incremental_decode_caches_match_jax_and_the_full_forward(
        normalize_before):
    j, t = _pair("decoder", normalize_before)
    j.eval()
    t.eval()
    src, tgt = _inputs(12, 6, seed=1)
    memory_j, memory_t = jnp.asarray(src), torch.from_numpy(src)
    jc = [(l.self_attn.gen_cache(memory_j),
           l.cross_attn.gen_cache(memory_j, memory_j,
                                  type=jnn.MultiHeadAttention.StaticCache))
          for l in j.layers]
    tc = [(l.self_attn.gen_cache(memory_t),
           l.cross_attn.gen_cache(memory_t, memory_t,
                                  type=tnn.MultiHeadAttention.StaticCache))
          for l in t.layers]
    steps_j, steps_t = [], []
    with torch.no_grad():
        for i in range(tgt.shape[1]):
            oj, jc = j(jnp.asarray(tgt[:, i:i + 1]), memory_j, cache=jc)
            ot, tc = t(torch.from_numpy(tgt[:, i:i + 1]), memory_t, cache=tc)
            steps_j.append(np.asarray(oj))
            steps_t.append(ot.numpy())
        full = t(torch.from_numpy(tgt), memory_t,
                 tgt_mask=tnn.Transformer.generate_square_subsequent_mask(
                     tgt.shape[1], device="cpu")).numpy()
    inc_t, inc_j = np.concatenate(steps_t, 1), np.concatenate(steps_j, 1)
    scale = float(np.abs(inc_j).max())
    assert float(np.abs(inc_t - inc_j).max()) <= REL * scale
    assert float(np.abs(inc_t - full).max()) <= REL * scale
    assert tc[0][0].k.shape == (2, H, tgt.shape[1], D // H)
    assert isinstance(tc[0][1], tnn.MultiHeadAttention.StaticCache)


def test_copies_are_drawn_anew_from_the_recorded_initializer():
    """The cloned layers' Linear weights are drawn again from the layer's
    own initializer (a weight_attr's), as the JAX package's _reinit."""
    from paddle_tpu_torch.nn import initializer as tinit

    attr = type("A", (), {"initializer": tinit.Uniform(0.5, 0.75)})()
    layer = tnn.TransformerDecoderLayer(D, H, FF, 0.0, "relu", None, None,
                                        False, attr)
    dec = tnn.TransformerDecoder(layer, 3,
                                 generator=torch.Generator().manual_seed(1))
    w = [l.linear1.weight for l in dec.layers]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    for x in w:
        assert float(x.min()) >= 0.5 and float(x.max()) <= 0.75
    for l in dec.layers:
        assert torch.equal(l.self_attn.q_proj.bias, torch.zeros(D))
        assert torch.equal(l.norm1.weight, torch.ones(D))
