"""Module- and model-level parity of the PyTorch port against the JAX
package, on the CPU at a small size.

Weights go JAX -> port through ``paddle_tpu_torch.convert.from_jax_params``;
inputs are made with numpy from a seed.  Tolerances (fp32): 1e-5 per
module, 1e-4 for the model.  Both kernel flags are exercised: on, the
wrappers run their kernels' plain versions (CPU tensors); off, the plain
compositions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu.autograd import parameters_dict as jax_parameters_dict
from paddle_tpu.nn.layer.transformer import (
    TransformerEncoderLayer as JaxEncoderLayer,
)
from paddle_tpu.text import ernie as jernie
from paddle_tpu_torch import convert, entry as tentry
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.nn.layer.transformer import TransformerEncoderLayer
from paddle_tpu_torch.text import ernie as ternie

MODULE_TOL = 1e-5
MODEL_TOL = 1e-4
SMALL = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
             num_attention_heads=2, intermediate_size=256)


def _np_params(layer):
    return {k: np.asarray(v) for k, v in jax_parameters_dict(layer).items()}


def _flags(on):
    flags.set_flags({"use_flash_attention": on, "use_fused_layer_norm": on})


@pytest.fixture(params=[True, False], ids=["kernels", "plain"])
def kernel_flags(request):
    _flags(request.param)
    yield request.param
    _flags(True)


@pytest.fixture(scope="module")
def small_models():
    paddle_tpu.seed(11)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**SMALL))
    jm.eval()
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**SMALL),
                                    device="cpu").eval()
    convert.from_jax_params(_np_params(jm), tm)
    return jm, tm


def _batch(seed=0, b=2, s=128, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
    ids[1, 93:] = 0                       # padded request
    tt = np.zeros_like(ids)
    tt[:, 64:] = 1
    return ids, tt


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
def test_encoder_layer_matches_jax(kernel_flags, normalize_before):
    paddle_tpu.seed(3)
    jl = JaxEncoderLayer(128, 2, 256, dropout=0.1, activation="gelu",
                         attn_dropout=0.1, act_dropout=0.0,
                         normalize_before=normalize_before)
    jl.eval()
    tl = TransformerEncoderLayer(128, 2, 256, dropout=0.1, activation="gelu",
                                 attn_dropout=0.1, act_dropout=0.0,
                                 normalize_before=normalize_before).eval()
    convert.from_jax_params(_np_params(jl), tl)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 128, 128)).astype(np.float32)
    mask = np.zeros((2, 1, 1, 128), np.float32)
    mask[1, ..., 100:] = -1e4
    ref = jl(jnp.asarray(x), src_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = tl(torch.from_numpy(x), src_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=MODULE_TOL,
                               atol=MODULE_TOL)


def test_attention_general_mask_takes_plain_route_like_jax():
    """A (b, h, s, s) mask is not a key-position mask: both packages take
    their reference attention."""
    from paddle_tpu.nn.layer.transformer import MultiHeadAttention as JMHA
    from paddle_tpu_torch.nn.layer.transformer import MultiHeadAttention

    paddle_tpu.seed(4)
    jm = JMHA(128, 2)
    tm = MultiHeadAttention(128, 2)
    convert.from_jax_params(_np_params(jm), tm)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 64, 128)).astype(np.float32)
    mask = rng.normal(0, 1, (2, 2, 64, 64)).astype(np.float32)
    ref = jm(jnp.asarray(x), attn_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=MODULE_TOL,
                               atol=MODULE_TOL)


def test_ernie_pretraining_matches_jax(small_models, kernel_flags):
    jm, tm = small_models
    ids, tt = _batch()
    jl, jn = jm(jnp.asarray(ids), jnp.asarray(tt))
    with torch.no_grad():
        tl, tn = tm(torch.from_numpy(ids).long(), torch.from_numpy(tt).long())
    assert tl.shape == (2, 128, 512) and tn.shape == (2, 2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def test_ernie_masked_positions_match_jax(small_models):
    jm, tm = small_models
    ids, tt = _batch(seed=5)
    pos = np.array([[3, 17, 90], [0, 50, 92]], np.int32)
    jl, jn = jm(jnp.asarray(ids), jnp.asarray(tt),
                masked_positions=jnp.asarray(pos))
    with torch.no_grad():
        tl, tn = tm(torch.from_numpy(ids).long(), torch.from_numpy(tt).long(),
                    masked_positions=torch.from_numpy(pos))
    assert tl.shape == (2, 3, 512)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def test_ernie_model_explicit_2d_mask_matches_jax(small_models):
    jm, tm = small_models
    ids, tt = _batch(seed=6)
    am = (ids != 0).astype(np.int32)
    jseq, jpool = jm.ernie(jnp.asarray(ids), jnp.asarray(tt),
                           attention_mask=jnp.asarray(am))
    with torch.no_grad():
        tseq, tpool = tm.ernie(torch.from_numpy(ids).long(),
                               torch.from_numpy(tt).long(),
                               attention_mask=torch.from_numpy(am))
    np.testing.assert_allclose(tseq.numpy(), np.asarray(jseq),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_padding_mask_is_additive_fp32():
    ids = torch.tensor([[5, 6, 0, 0]])
    m = ternie.padding_mask(ids, 0)
    assert m.dtype == torch.float32 and m.shape == (1, 1, 1, 4)
    assert m.flatten().tolist() == [0.0, 0.0, -1e4, -1e4]


def test_converter_keys_match_and_are_strict(small_models):
    jm, tm = small_models
    jp = _np_params(jm)
    assert set(convert.parameters_dict(tm)) == set(jp)
    assert "cls.predictions.decoder_weight" not in jp
    fresh = ternie.ErnieForPretraining(ternie.ErnieConfig(**SMALL),
                                       device="cpu")
    missing = dict(jp)
    missing.pop("ernie.pooler.dense.bias")
    with pytest.raises(KeyError, match="pooler"):
        convert.from_jax_params(missing, fresh)
    with pytest.raises(KeyError, match="extra"):
        convert.from_jax_params({**jp, "extra": np.zeros(1)}, fresh)
    bad = dict(jp)
    bad["ernie.pooler.dense.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError):
        convert.from_jax_params(bad, fresh)


def test_converter_round_trip_keeps_tied_decoder():
    paddle_tpu.seed(7)
    jm = jernie.ErnieForPretraining(jernie.ErnieConfig(**SMALL))
    jp = _np_params(jm)
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**SMALL),
                                    device="cpu")
    convert.from_jax_params(jp, tm, dtype=torch.bfloat16)
    emb = tm.ernie.embeddings.word_embeddings.weight
    assert tm.cls.predictions.decoder_weight is emb
    assert emb.dtype == torch.bfloat16
    back = {k: v.detach().float().numpy() for k, v in
            convert.parameters_dict(tm).items()}
    assert set(back) == set(jp)
    for k, v in jp.items():
        np.testing.assert_allclose(back[k], v, rtol=1e-2, atol=1e-2,
                                   err_msg=k)
    with torch.no_grad():
        emb.zero_()
    tied = tm.cls.predictions.decoder_weight.detach()
    assert float(tied.abs().max()) == 0.0


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ternie.ErnieForPretraining(ternie.ErnieConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        ternie.ErnieModel(ternie.ErnieConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_entry_forward_on_cpu_matches_direct_call():
    fn, (params, ids, tt) = tentry.entry(
        device="cpu", config=ternie.ErnieConfig(**SMALL),
        generator=torch.Generator().manual_seed(0))
    assert ids.shape == (2, 128) and ids.device.type == "cpu"
    logits, nsp = fn(params, ids, tt)
    assert logits.shape == (2, 128, 512) and nsp.shape == (2, 2)
    assert torch.isfinite(logits).all()
    shifted = dict(params)
    shifted["cls.predictions.decoder_bias"] = torch.ones(512)
    logits2, _ = fn(shifted, ids, tt)
    np.testing.assert_allclose((logits2 - logits).numpy(), 1.0, rtol=1e-5,
                               atol=1e-5)


def test_same_seed_same_weights():
    a = ternie.ErnieForPretraining(ternie.ErnieConfig(**SMALL), device="cpu",
                                   generator=torch.Generator().manual_seed(9))
    b = ternie.ErnieForPretraining(ternie.ErnieConfig(**SMALL), device="cpu",
                                   generator=torch.Generator().manual_seed(9))
    pa, pb = convert.parameters_dict(a), convert.parameters_dict(b)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    l0 = a.ernie.encoder.layers[0].linear1.weight
    l1 = a.ernie.encoder.layers[1].linear1.weight
    assert not torch.equal(l0, l1)   # the copies are drawn anew
