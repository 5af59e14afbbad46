"""CTC, the port against the JAX package on the CPU: ``nn.functional.
ctc_loss`` (the log-semiring alpha recursion) and its gradient,
``ops.edit_distance`` and ``ops.ctc_greedy_decoder``.

Held: the losses at rtol 1e-5 (atol 1e-5) under each reduction, with
ragged input and label lengths, ``norm_by_times`` and a non-zero blank;
the gradient with respect to the logits at rtol 1e-4 (atol 1e-6); a row
with no labels keeps a finite gradient (the -1e30 sentinel, where -inf
gives NaN); the loss against ``torch.nn.functional.ctc_loss`` as an
independent oracle (rtol 1e-4); distances and decodings equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu.ops as J
import paddle_tpu_torch as P
import paddle_tpu_torch.nn.functional as TF

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _case(seed, T=16, B=4, C=7, L=5, blank=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (T, B, C)).astype(np.float32)
    labels = rng.integers(0, C, (B, L)).astype(np.int32)
    labels[labels == blank] = (blank + 1) % C
    labels[0, 1] = labels[0, 2]                  # a repeat needs a blank
    il = np.array([T, T - 3, 9, 11][:B], np.int32)
    ll = np.array([L, 3, 0, 2][:B], np.int32)
    return logits, labels, il, ll


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("blank,norm", [(0, False), (3, True)])
def test_ctc_loss_and_gradient(reduction, blank, norm):
    logits, labels, il, ll = _case(1, blank=blank)
    args = (labels, il, ll, blank, reduction, norm)
    ref = JF.ctc_loss(jnp.asarray(logits), *args)
    x = torch.from_numpy(logits).requires_grad_()
    got = TF.ctc_loss(x, *(torch.from_numpy(a) for a in args[:3]),
                      *args[3:])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    c = np.random.default_rng(2).normal(size=np.shape(ref)).astype(
        np.float32)
    jg = jax.grad(lambda z: jnp.sum(JF.ctc_loss(z, *args) * c))(
        jnp.asarray(logits))
    (got * torch.from_numpy(c)).sum().backward()
    assert bool(torch.isfinite(x.grad).all())
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    # steps past each input length take no gradient
    for b, n in enumerate(il):
        assert float(x.grad[n:, b].abs().sum()) == 0.0


def test_ctc_loss_against_torch_as_an_oracle():
    logits, labels, il, ll = _case(3)
    lp = torch.log_softmax(torch.from_numpy(logits).double(), -1)
    ref = torch.nn.functional.ctc_loss(
        lp, torch.from_numpy(labels).long(), torch.from_numpy(il).long(),
        torch.from_numpy(ll).long(), blank=0, reduction="none",
        zero_infinity=False)
    got = TF.ctc_loss(*(torch.from_numpy(a) for a in (logits, labels, il,
                                                      ll)), 0, "none")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4)


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance(normalized):
    rng = np.random.default_rng(4)
    hyps = rng.integers(0, 4, (5, 7)).astype(np.int32)
    refs = rng.integers(0, 4, (5, 6)).astype(np.int32)
    hl = np.array([7, 0, 3, 5, 2], np.int32)
    rl = np.array([6, 4, 0, 0, 6], np.int32)
    ref = J.edit_distance(hyps, refs, hl, rl, normalized)
    got = P.edit_distance(*(torch.from_numpy(a) for a in (hyps, refs, hl,
                                                          rl)), normalized)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6)
    assert int(got[1][0]) == int(ref[1][0]) == 5
    # a known pair: kitten -> sitting is 3
    k = torch.tensor([[1, 2, 3, 3, 4, 5, 0]])
    s = torch.tensor([[6, 2, 3, 3, 2, 5, 7]])
    d, _ = P.edit_distance(k, s, torch.tensor([6]), torch.tensor([7]), False)
    assert float(d) == 3.0


def test_ctc_greedy_decoder():
    rng = np.random.default_rng(5)
    probs = rng.random((4, 10, 5)).astype(np.float32)
    probs[1, :4] = np.eye(5)[[2, 2, 0, 2]]           # repeats and a blank
    il = np.array([10, 4, 0, 7], np.int32)
    ref = J.ctc_greedy_decoder(probs, 0, il, -1)
    got = P.ctc_greedy_decoder(torch.from_numpy(probs), 0,
                               torch.from_numpy(il), -1)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert list(got[0][1, :2].numpy()) == [2, 2] and int(got[1][1]) == 2
    assert int(got[1][2]) == 0 and bool((got[0][2] == -1).all())
