"""The operator tail (``ops/misc.py``) beyond the op table's values
(``ops.cases``, held by tests/test_torch_ops.py): the gradients of every
differentiable float case against ``jax.grad`` of the JAX package's op
(rtol 1e-4, atol 1e-5, with respect to the first floating argument), and
the conventions the issue list names: ``max_pool2d_with_index``'s flat
index, ``roi_pool``'s bin rounding, ``grid_sampler`` / ``affine_grid``'s
``align_corners`` and padding modes, ``strided_slice`` with negative
strides, ``nce_loss`` with given ``sample_ids``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as J
import paddle_tpu_torch as P
from paddle_tpu_torch.ops import cases as C
from paddle_tpu_torch.ops import misc as M

_GRAD_OPS = ("cos_sim", "p_norm", "frobenius_norm", "l1_norm", "minus",
             "rank_loss", "sigmoid_focal_loss", "lrn", "affine_grid",
             "grid_sampler", "row_conv", "sequence_conv", "nce_loss",
             "data_norm", "cvm", "spectral_norm", "temporal_shift",
             "pixel_shuffle", "roi_pool", "max_pool2d_with_index")


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _grad_cases():
    return [i for i, c in enumerate(C.CASES) if c.name in _GRAD_OPS]


@pytest.mark.parametrize("index", _grad_cases(),
                         ids=[C.case_ids()[i] for i in _grad_cases()])
def test_gradient_matches_the_reference(index):
    case = C.CASES[index]
    args, kwargs = case.make(np.random.default_rng(index))
    pos = next(i for i, a in enumerate(args) if isinstance(a, np.ndarray)
               and a.dtype == np.float32)
    probe = np.random.default_rng(1)

    def weights(out):
        return [probe.normal(size=np.shape(o)).astype(np.float32)
                for o in C.leaves(out)]

    def jloss(x, cs):
        a = list(C.to_framework(args, jnp.asarray))
        a[pos] = x
        outs = C.leaves(getattr(J, case.name)(*a, **kwargs))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cs)
                   if jnp.issubdtype(o.dtype, jnp.floating))

    ref_out = getattr(J, case.name)(*C.to_framework(args, jnp.asarray),
                                    **kwargs)
    cs = weights(ref_out)
    jg = jax.grad(jloss)(jnp.asarray(args[pos]), cs)
    a = list(C.to_framework(args, torch.from_numpy))
    a[pos] = a[pos].requires_grad_()
    outs = C.leaves(getattr(P, case.name)(*a, **kwargs))
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, cs)
        if o.is_floating_point()).backward()
    np.testing.assert_allclose(a[pos].grad.numpy(), np.asarray(jg),
                               rtol=1e-4, atol=1e-5, err_msg=case.name)


def test_max_pool_flat_index_and_padding():
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    out, idx = M.max_pool2d_with_index(x, 2)
    assert out.flatten().tolist() == [5.0, 7.0, 13.0, 15.0]
    assert idx.flatten().tolist() == [5, 7, 13, 15]
    # a window whose maximum lies in the padding reads -1
    neg = -torch.ones(1, 1, 2, 2) * float("inf")
    _, idx = M.max_pool2d_with_index(neg, 2, 1, 1)
    assert int(idx[0, 0, 0, 0]) == -1


def test_roi_pool_bins_round_the_scaled_boxes():
    feat = torch.arange(64.0).reshape(1, 8, 8)
    out = M.roi_pool(feat, torch.tensor([[0.4, 0.4, 7.4, 7.4]]), 2)
    # the box rounds to 0..7: four 4 x 4 bins, each max at its corner
    assert out.flatten().tolist() == [27.0, 31.0, 59.0, 63.0]
    empty = M.roi_pool(feat, torch.tensor([[9.0, 9.0, 9.0, 9.0]]), 1)
    assert float(empty) == 0.0


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_identity_samples_the_input(align):
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 3, 4, 5)).astype(np.float32))
    theta = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]]).expand(2, 2, 3)
    grid = M.affine_grid(theta, (2, 3, 4, 5), align)
    torch.testing.assert_close(M.grid_sampler(x, grid, "bilinear", "zeros",
                                              align), x)
    with pytest.raises(NotImplementedError, match="reflection"):
        M.grid_sampler(x, grid, padding_mode="reflection")


def test_strided_slice_negative_strides_as_python():
    x = np.arange(42).reshape(6, 7)
    got = M.strided_slice(torch.from_numpy(x), [0, 1], [-1, 6], [0, 0],
                          [-2, -3])
    np.testing.assert_array_equal(got.numpy(), x[-1:0:-2, 6:0:-3])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.strided_slice(x, [0, 1], [-1, 6], [0, 0],
                                                [-2, -3])))


def test_nce_loss_uses_the_given_samples():
    rng = np.random.default_rng(3)
    args = (rng.normal(size=(4, 6)).astype(np.float32),
            rng.integers(0, 20, 4), rng.normal(size=(20, 6)).astype(
                np.float32), rng.normal(size=20).astype(np.float32))
    s1 = rng.integers(0, 20, (4, 5))
    s2 = (s1 + 1) % 20
    a = [torch.from_numpy(np.asarray(v)) for v in args]
    l1 = M.nce_loss(*a, torch.from_numpy(s1))
    l2 = M.nce_loss(*a, torch.from_numpy(s2))
    assert l1.shape == (4, 1) and not torch.equal(l1, l2)
    np.testing.assert_allclose(l1.numpy(), np.asarray(J.nce_loss(*args, s1)),
                               rtol=1e-5)
    # the noise prior B = num_neg / num_total_classes is folded in
    np.testing.assert_allclose(
        M.nce_loss(*a, torch.from_numpy(s1), 40).numpy(),
        np.asarray(J.nce_loss(*args, s1, 40)), rtol=1e-5)


def test_pixel_shuffle_checks_channels():
    with pytest.raises(ValueError, match="divisible"):
        M.pixel_shuffle(torch.zeros(1, 6, 2, 2), 2)
