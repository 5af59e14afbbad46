"""The sequence (LoD) ops, the port against the JAX package on the CPU,
beyond the op table's single cases (``ops.cases``, run by
tests/test_torch_ops.py): every pool type's gradient, the masked softmax's
gradient, the padded <-> segment-id round trip, truncation, and the
errors.

Tolerances: values at rtol 1e-5 (atol 1e-6), gradients at rtol 1e-4
(atol 1e-6); integer outputs and data movement equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence as JS
import paddle_tpu_torch as P
from paddle_tpu_torch.ops import sequence as TS

LENS = np.array([5, 0, 3, 1, 6], np.int32)


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("pool", ["sum", "mean", "sqrt", "max", "first",
                                  "last"])
def test_sequence_pool_value_and_gradient(pool):
    x = _x(5, 6, 3)
    c = _x(5, 3, seed=1)
    ref = JS.sequence_pool(x, LENS, pool, 0.5)
    jg = jax.grad(lambda z: jnp.sum(JS.sequence_pool(z, LENS, pool, 0.5)
                                    * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = TS.sequence_pool(xt, torch.from_numpy(LENS), pool, 0.5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    assert bool((got[1] == 0.5).all())             # the empty sequence


def test_sequence_softmax_gradient_and_padding():
    x = _x(5, 6)
    c = _x(5, 6, seed=2)
    jg = jax.grad(lambda z: jnp.sum(JS.sequence_softmax(z, LENS) * c))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = TS.sequence_softmax(xt, torch.from_numpy(LENS))
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    sums = got.detach().sum(1)
    np.testing.assert_allclose(sums.numpy(), (LENS > 0).astype(np.float32),
                               rtol=1e-6)


def test_pad_unpad_round_trip_and_truncation():
    x = _x(5, 6, 2)
    vals, seg, mask = TS.sequence_unpad(torch.from_numpy(x),
                                        torch.from_numpy(LENS))
    keep = mask.numpy()
    padded, lens = TS.sequence_pad(vals[mask], seg[mask], 5, 6)
    np.testing.assert_array_equal(lens.numpy(), LENS)
    for b, n in enumerate(LENS):
        np.testing.assert_array_equal(padded[b, :n].numpy(), x[b, :n])
    ref = JS.sequence_pad(np.asarray(vals)[keep], np.asarray(seg)[keep], 5,
                          4, -1.0)
    got = TS.sequence_pad(vals[mask], seg[mask], 5, 4, -1.0)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(got[1].max()) == 4


def test_expand_and_slice_against_the_reference():
    x = _x(5, 6, 2)
    reps = np.array([2, 3, 1, 4, 1], np.int32)
    ref = JS.sequence_expand(x, LENS, reps, 9)
    got = TS.sequence_expand(*(torch.from_numpy(a) for a in (x, LENS, reps)),
                             9)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    off, n = np.array([1, 0, 2, 1, 3], np.int32), np.array([3, 2, 1, 1, 5],
                                                           np.int32)
    ref = JS.sequence_slice(x, LENS, off, n)
    got = TS.sequence_slice(*(torch.from_numpy(a) for a in (x, LENS, off,
                                                            n)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max", "segment_min"])
def test_segment_reductions_with_empty_segments(name):
    vals = _x(8, 3)
    seg = np.array([0, 0, 2, 2, 2, 5, 5, 5], np.int32)
    ref = getattr(JS, name)(vals, seg, 7)
    got = getattr(TS, name)(torch.from_numpy(vals), torch.from_numpy(seg), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_mask_requires_maxlen_and_casts():
    with pytest.raises(ValueError, match="maxlen"):
        TS.sequence_mask(torch.tensor([1, 2]))
    m = TS.sequence_mask(torch.tensor([1, 3]), 4, "int32")
    assert m.dtype == torch.int32
    assert m.tolist() == [[1, 0, 0, 0], [1, 1, 1, 0]]
    with pytest.raises(ValueError, match="pool_type"):
        TS.sequence_pool(torch.zeros(1, 2), torch.tensor([1]), "median")
