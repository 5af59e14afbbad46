"""The slice as a whole: sequence labelling with a CRF, the port against
the JAX package on the CPU, at a small size.

* ERNIE + CRF (the model ``chip_smoke.py`` phase 19 runs at ERNIE-base's
  widths): a 2-layer, 64-wide ``ErnieModel``, dropout 0, an emission
  ``Linear(64, 7)`` and ``linear_chain_crf`` over the 7 IOB tags of
  MSRA-NER (PER, ORG, LOC; O = 6), padded batches of lengths 5-24 of 24.
* BiGRU + CRF (LAC's net, phase 20): a sparse-gradient word embedding, two
  stacked bidirectional GRUs, an emission ``Linear`` and the CRF, over 9
  tags (4 chunk types), ragged lengths 1-12 of 12 (reverse directions
  included).

The JAX side differentiates ``functional_call`` with ``jax.grad`` over its
``parameters_dict``; the port gets the same weights through
``convert.from_jax_params`` and differentiates ``loss.backward()``.  Held:
the loss at rtol 1e-5; every gradient within 1e-4 of its largest value,
that scale floored at 1e-4 of the largest gradient of all (the key
projection's bias gradient is rounding noise in both packages; the pooler
takes none); the Viterbi paths equal (int32 in the JAX package, int64 in
the port); ``chunk_eval``'s six outputs equal (ratios at rtol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.nn as jnn
import paddle_tpu.ops as J
from paddle_tpu.autograd import functional_call, parameters_dict
from paddle_tpu.ops import crf as jcrf
from paddle_tpu.text import ernie as JE
import paddle_tpu_torch as P
from paddle_tpu_torch import convert
from paddle_tpu_torch.text import ernie as TE

CFG = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=1, intermediate_size=128,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


class _JCrf(jnn.Layer):
    def _transition(self, num_tags):
        self.transition = self.create_parameter((num_tags + 2, num_tags))

    def loss(self, emission, labels, lengths):
        return jnp.mean(jcrf.linear_chain_crf(emission, labels,
                                              self.transition.value,
                                              lengths))


class JErnieCrf(_JCrf):
    def __init__(self, cfg, num_tags):
        super().__init__()
        self.ernie = JE.ErnieModel(cfg)
        self.dropout = jnn.Dropout(cfg.hidden_dropout_prob)
        self.emission = jnn.Linear(cfg.hidden_size, num_tags)
        self._transition(num_tags)

    def forward(self, ids, types, mask, labels, lengths):
        seq, _ = self.ernie(ids, types, attention_mask=mask)
        em = self.emission(self.dropout(seq))
        return self.loss(em, labels, lengths), em


class JBiGruCrf(_JCrf):
    def __init__(self, vocab, emb, hidden, layers, num_tags):
        super().__init__()
        self.word_emb = jnn.Embedding(vocab, emb, None, True)
        self.gru = jnn.GRU(emb, hidden, layers, "bidirect")
        self.emission = jnn.Linear(2 * hidden, num_tags)
        self._transition(num_tags)

    def forward(self, ids, lengths, labels):
        out, _ = self.gru(self.word_emb(ids), sequence_length=lengths)
        em = self.emission(out)
        return self.loss(em, labels, lengths), em


def _grads_agree(tmodel, jgrads):
    floor = 1e-4 * max(float(np.abs(np.asarray(g)).max())
                       for g in jgrads.values())
    seen = 0
    for name, p in tmodel.named_parameters():
        ref = np.asarray(jgrads[name])
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(ref).max()), floor)
        assert float(np.abs(got - ref).max()) / scale <= GRAD_REL, name
        seen += p.grad is not None
    return seen


def _decode_and_eval(jmodel, tmodel, jem, tem, labels, lens, n_types):
    ref = jcrf.crf_decoding(jem, jmodel.transition.value, lens)
    got = tmodel.decode(tem.detach(), torch.from_numpy(lens))
    assert np.asarray(ref).dtype == np.int32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rc = J.chunk.chunk_eval(ref, labels, lens, "IOB", n_types)
    gc = P.chunk_eval(got, torch.from_numpy(labels), torch.from_numpy(lens),
                      "IOB", n_types)
    for r, g in zip(rc[3:], gc[3:]):
        assert int(r) == int(g)
    for r, g in zip(rc[:3], gc[:3]):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
    assert int(gc[3]) > 0 and int(gc[4]) > 0


def test_ernie_crf_loss_gradients_and_decode():
    ErnieCrfTagger, _ = chip_smoke.tagging_models()
    jm = JErnieCrf(JE.ErnieConfig(**CFG), 7)
    tm = ErnieCrfTagger(TE.ErnieConfig(**CFG), 7, device="cpu")
    jp = {k: np.asarray(v) for k, v in parameters_dict(jm).items()}
    convert.from_jax_params(jp, tm)
    rng = np.random.default_rng(0)
    b, s = 4, 24
    lens = rng.integers(5, s + 1, b).astype(np.int64)
    lens[0] = s
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(1, CFG["vocab_size"], (b, s)) * mask
    labels = chip_smoke.iob_tags(rng, lens, s, 3)
    types = np.zeros_like(ids)
    args = (ids, types, mask, labels, lens)

    def jloss(p):
        return functional_call(jm, p, tuple(jnp.asarray(a) for a in args))

    (jl, jem), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in jp.items()})
    tem = tm(*(torch.from_numpy(a) for a in args[:3]))
    tl = tm.loss(tem, torch.from_numpy(labels), torch.from_numpy(lens))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    assert _grads_agree(tm, jg) == len(jg) - 2          # no pooler gradient
    assert tm.transition.grad is not None
    _decode_and_eval(jm, tm, np.asarray(jem), tem, labels, lens, 3)


@pytest.mark.parametrize("layers", [1, 2])
def test_bigru_crf_loss_gradients_and_decode(layers):
    _, BiGruCrfTagger = chip_smoke.tagging_models()
    dims = (60, 8, 6, layers, 9)
    jm, tm = JBiGruCrf(*dims), BiGruCrfTagger(*dims, device="cpu")
    assert tm.word_emb.sparse
    jp = {k: np.asarray(v) for k, v in parameters_dict(jm).items()}
    convert.from_jax_params(jp, tm)
    rng = np.random.default_rng(layers)
    b, s = 6, 12
    lens = np.array([12, 1, 7, 3, 12, 9], np.int64)
    ids = rng.integers(1, 60, (b, s)) * (np.arange(s)[None] < lens[:, None])
    labels = chip_smoke.iob_tags(rng, lens, s, 4)

    def jloss(p):
        return functional_call(jm, p, (jnp.asarray(ids), jnp.asarray(lens),
                                       jnp.asarray(labels)))

    (jl, jem), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in jp.items()})
    tem = tm(torch.from_numpy(ids), torch.from_numpy(lens))
    tl = tm.loss(tem, torch.from_numpy(labels), torch.from_numpy(lens))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=LOSS_RTOL)
    assert _grads_agree(tm, jg) == len(jg)
    _decode_and_eval(jm, tm, np.asarray(jem), tem, labels, lens, 4)


def test_viterbi_margins_are_the_gap_to_the_runner_up():
    """The margin ``chip_smoke`` compares decoded paths by: the best path's
    score minus the best other path's, by brute force."""
    import itertools

    rng = np.random.default_rng(3)
    em = torch.from_numpy(rng.normal(size=(3, 4, 3)).astype(np.float32))
    tr = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    lens = torch.tensor([4, 2, 1])
    got = chip_smoke.viterbi_margins(em, tr, lens)
    e, t = em.double().numpy(), tr.double().numpy()
    for b, n in enumerate(lens.tolist()):
        scores = sorted(
            t[0, p[0]] + t[1, p[-1]] + sum(e[b, i, y] for i, y in enumerate(p))
            + sum(t[2 + p[i], p[i + 1]] for i in range(n - 1))
            for p in itertools.product(range(3), repeat=n))
        np.testing.assert_allclose(got[b], scores[-1] - scores[-2],
                                   rtol=1e-9)
