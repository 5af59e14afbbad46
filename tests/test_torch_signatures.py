"""Public signatures of the port that bind positional arguments as the JAX
package's do, each called positionally in both packages.

* ``nn.functional.cross_entropy(input, label, weight, ignore_index,
  reduction, soft_label, axis)`` and ``softmax_with_cross_entropy(logits,
  label, soft_label, ignore_index, axis)``: class weights and soft labels
  included, values at rtol 1e-6.
* ``nn.Embedding(num_embeddings, embedding_dim, padding_idx, sparse,
  weight_attr, name)`` and ``nn.functional.embedding(x, weight,
  padding_idx)``: the padding row's output (and gradient) is zero; the
  port's initialisation arguments are keyword-only; what is not ported
  raises.
* ``PagedDecoder(model, cache, max_seqs, max_blocks_per_seq,
  prefill_chunk, donate, tenant)``: ``donate`` is accepted and ignored.
* ``static.passes.Diagnostic(code, severity, message, block, op_index,
  op_type, var, hint)``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.serving import paged as JPG
from paddle_tpu.static import analysis as janalysis
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.serving import paged as TPG
from paddle_tpu_torch.static import passes as TP

RTOL = 1e-6


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref),
                               rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_positional_weight_and_ignore_index(reduction):
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (7, 5)).astype(np.float32)
    label = np.array([1, 4, -1, 0, 3, -1, 2], np.int32)
    weight = rng.uniform(0.2, 2.0, (5,)).astype(np.float32)
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                           jnp.asarray(weight), -1, reduction)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                           torch.from_numpy(weight), -1, reduction)
    _close(got, ref)
    # no weight: the fourth positional is still ignore_index
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label), None, -1,
                           reduction)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                           None, -1, reduction)
    _close(got, ref)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_cross_entropy_positional_soft_label(reduction):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (6, 4)).astype(np.float32)
    soft = rng.dirichlet(np.ones(4), 6).astype(np.float32)
    ref = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(soft), None,
                           -100, reduction, True)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                           None, -100, reduction, True)
    _close(got, ref)


def test_softmax_with_cross_entropy_positional_soft_label_then_ignore():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (5, 6)).astype(np.float32)
    soft = rng.dirichlet(np.ones(6), 5).astype(np.float32)
    ref = JF.softmax_with_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(soft), True)
    got = TF.softmax_with_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(soft), True)
    _close(got, ref)
    hard = np.array([[2], [0], [5], [5], [1]], np.int32)
    ref = JF.softmax_with_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(hard), False, 5)
    got = TF.softmax_with_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(hard), False, 5)
    _close(got, ref)
    assert float(got[2]) == float(got[3]) == 0.0


def test_embedding_positional_padding_idx():
    ids = np.array([[0, 3, 2], [2, 2, 1]], np.int32)
    jemb = jnn.Embedding(5, 4, 2)
    temb = tnn.Embedding(5, 4, 2)
    assert temb.padding_idx == jemb.padding_idx == 2
    w = np.array(jemb.weight.value)
    with torch.no_grad():
        temb.weight.copy_(torch.from_numpy(w))
    ref = np.asarray(jemb(jnp.asarray(ids)))
    got = temb(torch.from_numpy(ids))
    _close(got, ref)
    assert float(got.detach()[ids == 2].abs().max()) == 0.0
    got.sum().backward()
    assert float(temb.weight.grad[2].abs().max()) == 0.0   # padding row
    assert float(temb.weight.grad[3].abs().min()) == 1.0
    # the functional form, positionally
    _close(TF.embedding(torch.from_numpy(ids), torch.from_numpy(w), 3),
           JF.embedding(jnp.asarray(ids), jnp.asarray(w), 3))


def test_embedding_port_arguments_are_keyword_only_and_unported_raise():
    gen = torch.Generator().manual_seed(0)
    emb = tnn.Embedding(6, 3, std=0.5, generator=gen)
    assert emb.padding_idx is None and emb.weight.abs().max() > 0
    with pytest.raises(TypeError):
        tnn.Embedding(6, 3, None, False, None, None, 0.5)
    with pytest.raises(NotImplementedError):
        tnn.Embedding(6, 3, None, True)
    with pytest.raises(NotImplementedError):
        tnn.Embedding(6, 3, None, False, object())
    with pytest.raises(NotImplementedError):
        TF.embedding(torch.zeros(2, dtype=torch.int32), emb.weight, None,
                     True)


def test_paged_decoder_positional_donate_then_tenant():
    cfg = dict(vocab=64, hidden=32, max_positions=256, seed=3)
    jmodel = JPG.make_paged_toy_lm(**cfg)
    keys = ("emb", "pe", "wq", "wk", "wv", "wo")
    tmodel = convert.paged_toy_lm_from_jax(
        {k: np.asarray(getattr(jmodel, k)) for k in keys}, **cfg,
        device="cpu")
    jdec = JPG.PagedDecoder(jmodel, JPG.PagedKVCache(jmodel, 64, 8), 4, 16,
                            8, False, "tenant-a")
    tdec = TPG.PagedDecoder(tmodel, TPG.PagedKVCache(tmodel, 64, 8), 4, 16,
                            8, False, "tenant-a")
    for d in (jdec, tdec):
        assert (d.max_seqs, d.max_blocks_per_seq, d.prefill_chunk,
                d.tenant) == (4, 16, 8, "tenant-a")
    out = tdec.decode([[1, 2, 3]], 6)
    assert out[0] == JPG.dense_reference_decode(jmodel, [1, 2, 3], 6)


def test_diagnostic_fields_in_the_reference_order():
    args = ("PV011", "error", "msg", 1, 7, "conv2d", "x", "fix it")
    j = janalysis.Diagnostic(*args)
    t = TP.Diagnostic(*args)
    jf = [f.name for f in dataclasses.fields(j)]
    tf = [f.name for f in dataclasses.fields(t)]
    assert tf == jf
    assert [getattr(t, n) for n in tf] == [getattr(j, n) for n in jf]
    assert TP.Diagnostic("PV011", "error", "m", var="v").block == 0
