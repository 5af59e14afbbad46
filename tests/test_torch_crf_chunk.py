"""The linear-chain CRF and chunk evaluation, the port against the JAX
package on the CPU.

* ``ops.crf.linear_chain_crf``: the per-sequence NLL at rtol 1e-5 and its
  gradients with respect to the emissions and the transition (Fluid's
  layout: start row, stop row, then [from, to]) at rtol 1e-4, ragged
  lengths including 1 and the full length;
* ``ops.crf.crf_decoding``: the Viterbi paths equal (the JAX package
  returns int32, its x64 being off; the port int64), zeros past each
  length, and each path's score the best by brute force over every
  tagging of a short sequence;
* ``ops.chunk_eval``: the six outputs under IOB, IOE, IOBES and plain,
  with and without ``excluded_chunk_types``; the counts equal, the ratios
  at rtol 1e-6, and the counts against a direct reading of the chunks.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as J
from paddle_tpu.ops import crf as jcrf
import paddle_tpu_torch as P
from paddle_tpu_torch.ops import crf as tcrf

RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _case(seed, b=5, s=9, d=4):
    rng = np.random.default_rng(seed)
    emission = rng.normal(0, 1.5, (b, s, d)).astype(np.float32)
    label = rng.integers(0, d, (b, s)).astype(np.int32)
    transition = rng.normal(0, 0.5, (d + 2, d)).astype(np.float32)
    lengths = np.array([s, 1, 4, 7, 2][:b], np.int32)
    return emission, label, transition, lengths


@pytest.mark.parametrize("seed", range(3))
def test_nll_and_its_gradients(seed):
    emission, label, transition, lengths = _case(seed)
    ref = jcrf.linear_chain_crf(emission, label, transition, lengths)
    e, t = (torch.from_numpy(a).requires_grad_() for a in (emission,
                                                          transition))
    got = tcrf.linear_chain_crf(e, torch.from_numpy(label), t,
                                torch.from_numpy(lengths))
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    c = np.random.default_rng(9).normal(size=(5, 1)).astype(np.float32)
    je, jt = jax.grad(lambda a, b: jnp.sum(jcrf.linear_chain_crf(
        a, label, b, lengths) * c), argnums=(0, 1))(jnp.asarray(emission),
                                                   jnp.asarray(transition))
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(je),
                               rtol=GRAD_RTOL, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt),
                               rtol=GRAD_RTOL, atol=1e-5)
    # padded steps take no gradient
    for b, n in enumerate(lengths):
        assert float(e.grad[b, n:].abs().sum()) == 0.0


def test_nll_is_the_log_partition_by_brute_force():
    emission, label, transition, _ = _case(5, b=2, s=4, d=3)
    lengths = np.array([4, 3], np.int32)
    nll = tcrf.linear_chain_crf(*(torch.from_numpy(a) for a in (
        emission, label, transition, lengths))).numpy()[:, 0]
    for b, n in enumerate(lengths):
        scores = []
        for path in itertools.product(range(3), repeat=int(n)):
            s = transition[0, path[0]] + transition[1, path[-1]]
            s += sum(emission[b, t, y] for t, y in enumerate(path))
            s += sum(transition[2 + path[t], path[t + 1]]
                     for t in range(n - 1))
            scores.append(s)
            if list(path) == list(label[b, :n]):
                gold = s
        log_z = np.log(np.sum(np.exp(np.array(scores, np.float64))))
        np.testing.assert_allclose(nll[b], log_z - gold, rtol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_viterbi_paths(seed):
    emission, _, transition, _ = _case(seed, b=5, s=6, d=3)
    lengths = np.array([6, 1, 4, 5, 2], np.int32)
    ref = np.asarray(jcrf.crf_decoding(emission, transition, lengths))
    got = tcrf.crf_decoding(*(torch.from_numpy(a) for a in (
        emission, transition, lengths)))
    assert got.dtype == torch.int64 and ref.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    for b, n in enumerate(lengths):
        assert bool((got[b, n:] == 0).all())
        best = max(itertools.product(range(3), repeat=int(n)), key=lambda p: (
            transition[0, p[0]] + transition[1, p[-1]]
            + sum(emission[b, t, y] for t, y in enumerate(p))
            + sum(transition[2 + p[t], p[t + 1]] for t in range(n - 1))))
        assert list(got[b, :n].numpy()) == list(best)


def _iob_tags(rng, b, s, n_types):
    """Valid IOB taggings: chunks of 1-4 steps, Other between."""
    other = 2 * n_types
    tags = np.full((b, s), other, np.int32)
    for i in range(b):
        t = 0
        while t < s:
            if rng.random() < 0.5:
                typ, n = rng.integers(0, n_types), rng.integers(1, 5)
                tags[i, t] = 2 * typ
                tags[i, t + 1:t + n] = 2 * typ + 1
                t += n
            else:
                t += 1
    return tags


@pytest.mark.parametrize("scheme,n_types,hi", [
    ("IOB", 3, 7), ("IOE", 3, 7), ("IOBES", 2, 9), ("plain", 4, 5)])
@pytest.mark.parametrize("excluded", [None, [1]])
def test_chunk_eval_schemes(scheme, n_types, hi, excluded):
    rng = np.random.default_rng(hash((scheme, n_types)) % 2 ** 32)
    inf = rng.integers(0, hi, (6, 15)).astype(np.int32)
    lab = rng.integers(0, hi, (6, 15)).astype(np.int32)
    lab[:2] = inf[:2]
    lens = np.array([15, 9, 1, 0, 12, 15], np.int32)
    ref = J.chunk.chunk_eval(inf, lab, lens, scheme, n_types, excluded)
    got = P.chunk_eval(torch.from_numpy(inf), torch.from_numpy(lab),
                       torch.from_numpy(lens), scheme, n_types, excluded)
    for r, g in zip(ref[3:], got[3:]):
        assert int(g) == int(r) and g.dtype == torch.int64
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
    assert int(got[3]) > 0 and int(got[5]) > 0


def _chunks(tags, n):
    """(begin, end, type) of each IOB chunk of tags[:n], Other = 6."""
    out, cur = [], None
    for t in range(n):
        y = int(tags[t])
        if y == 6 or y % 2 == 0 or cur is None or cur[2] != y // 2:
            if cur is not None:
                out.append(tuple(cur))
                cur = None
            if y != 6:
                cur = [t, t, y // 2]
        else:
            cur[1] = t
    if cur is not None:
        out.append(tuple(cur))
    return set(out)


def test_chunk_eval_counts_by_reading_the_chunks():
    rng = np.random.default_rng(7)
    lab = _iob_tags(rng, 8, 20, 3)
    inf = lab.copy()
    flip = rng.random(inf.shape) < 0.15
    inf[flip] = rng.integers(0, 7, flip.sum())
    lens = rng.integers(5, 21, 8).astype(np.int32)
    _, _, f1, ni, nl, nc = P.chunk_eval(*(torch.from_numpy(a) for a in (
        inf, lab, lens)), "IOB", 3)
    want = [0, 0, 0]
    for b in range(8):
        ci, cl = _chunks(inf[b], lens[b]), _chunks(lab[b], lens[b])
        want = [want[0] + len(ci), want[1] + len(cl),
                want[2] + len(ci & cl)]
    assert [int(ni), int(nl), int(nc)] == want
    assert 0.0 < float(f1) < 1.0


def test_chunk_stays_the_manipulation_op():
    assert P.chunk is P.ops.manipulation.chunk
    assert [t.shape[0] for t in P.chunk(torch.zeros(7, 2), 3)] == [
        t.shape[0] for t in J.manipulation.chunk(jnp.zeros((7, 2)), 3)]
    with pytest.raises(ValueError, match="chunk_scheme"):
        P.chunk_eval(torch.zeros(1, 2), torch.zeros(1, 2), None, "BIO")
