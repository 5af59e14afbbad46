"""The rest of the convolutions and pools: ``conv1d``, ``conv3d``,
``conv2d_transpose``, ``conv3d_transpose``, the 3-D pools and their layers,
the port against the JAX package on the CPU.

Forward results within 1e-5 of the largest reference value; gradients
with respect to the input, the weight and the bias (against ``jax.grad``
of the same weighted sum) within 1e-4 of the largest.  The transposed
convolutions run over stride, padding (padding above ``k - 1`` included,
which crops), dilation, groups and ``output_padding`` (values at or above
``max(stride, dilation)`` included, which torch's own transposed
convolution refuses and the port reaches by padding the full output).
Layers are built in both packages and the JAX weights carried into the
port's with ``convert.from_jax_params``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.autograd import parameters_dict
import paddle_tpu_torch as P
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import convert

TOL, TOL_GRAD = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with P.device_guard("cpu"):
        yield


def _close(got, ref, tol):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


def _f(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _forward_and_grads(name, arrays, **kw):
    """``name`` over (x, weight[, bias]) in both packages: the output, and
    the gradients of sum(out * w) for a fixed random w."""
    ref = getattr(JF, name)(*[jnp.asarray(a) for a in arrays], **kw)
    tin = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = getattr(TF, name)(*tin, **kw)
    _close(got, ref, TOL)
    w = np.random.default_rng(0).uniform(-1, 1, ref.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(getattr(JF, name)(*a, **kw) * w),
                  argnums=tuple(range(len(arrays))))(
                      *[jnp.asarray(a) for a in arrays])
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip(tin, jg):
        _close(t.grad, g, TOL_GRAD)


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), (2, 2, 2, 2), (1, "SAME", 1, 1), (2, "SAME", 2, 1),
    (1, "VALID", 1, 2), (3, [1], 1, 1)])
def test_conv1d(stride, padding, dilation, groups):
    rng = np.random.default_rng(1)
    arrays = [_f(rng, 2, 4, 11), _f(rng, 6, 4 // groups, 3), _f(rng, 6)]
    _forward_and_grads("conv1d", arrays, stride=stride, padding=padding,
                       dilation=dilation, groups=groups)


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), ((1, 2, 1), (1, 0, 2), (1, 1, 2), 2), (2, "SAME", 1, 1),
    (2, 1, 2, 4)])
def test_conv3d(stride, padding, dilation, groups):
    rng = np.random.default_rng(2)
    arrays = [_f(rng, 2, 4, 5, 6, 7), _f(rng, 8, 4 // groups, 3, 2, 3),
              _f(rng, 8)]
    _forward_and_grads("conv3d", arrays, stride=stride, padding=padding,
                       dilation=dilation, groups=groups)


# (stride, padding, output_padding, dilation, groups); padding 3 and 4 are
# above k - 1 = 2, output_padding 3 and 2 at or above max(stride, dilation)
TRANSPOSE_2D = [(1, 0, 0, 1, 1), (2, 1, 1, 1, 1), (2, 0, 0, 1, 2),
                (1, 3, 0, 1, 1), (2, 4, 1, 1, 2), (2, 1, 3, 1, 1),
                (3, 0, 2, 2, 2), (1, 0, 1, 1, 1), (2, (1, 0), (1, 0), 1, 1),
                (2, -1, 0, 1, 1)]


@pytest.mark.parametrize("stride,padding,output_padding,dilation,groups",
                         TRANSPOSE_2D)
def test_conv2d_transpose(stride, padding, output_padding, dilation, groups):
    rng = np.random.default_rng(3)
    arrays = [_f(rng, 2, 4, 5, 6), _f(rng, 4, 6 // groups, 3, 3),
              _f(rng, 6)]
    _forward_and_grads("conv2d_transpose", arrays, stride=stride,
                       padding=padding, output_padding=output_padding,
                       dilation=dilation, groups=groups)


@pytest.mark.parametrize("stride,padding,output_padding,dilation,groups", [
    (1, 0, 0, 1, 1), ((2, 1, 2), (1, 0, 3), (1, 0, 2), 1, 2),
    (2, 1, 1, 2, 1)])
def test_conv3d_transpose(stride, padding, output_padding, dilation, groups):
    rng = np.random.default_rng(4)
    arrays = [_f(rng, 2, 4, 3, 4, 5), _f(rng, 4, 6 // groups, 3, 2, 3),
              _f(rng, 6)]
    _forward_and_grads("conv3d_transpose", arrays, stride=stride,
                       padding=padding, output_padding=output_padding,
                       dilation=dilation, groups=groups)


@pytest.mark.parametrize("kernel,stride,padding", [
    (3, 2, 1), ((2, 3, 3), None, (1, 2, 2)), (2, 1, 0), (3, 3, 2)])
def test_max_pool3d(kernel, stride, padding):
    x = _f(np.random.default_rng(5), 2, 3, 5, 6, 7)
    ref = JF.max_pool3d(jnp.asarray(x), kernel, stride, padding)
    got = TF.max_pool3d(torch.from_numpy(x), kernel, stride, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("padding,exclusive", [
    (0, True), (0, False), (1, True), (1, False), ((0, 1, 2), True),
    ([0, 0, 0], True), (2, True), (2, False)])
def test_avg_pool3d_exclusive_only_where_padded(padding, exclusive):
    """``exclusive`` divides by the count of non-padding taps where the
    padding is non-zero (the JAX package's test), else by the window."""
    x = _f(np.random.default_rng(6), 2, 3, 5, 6, 7)
    ref = JF.avg_pool3d(jnp.asarray(x), 3, 2, padding, exclusive=exclusive)
    got = TF.avg_pool3d(torch.from_numpy(x), 3, 2, padding,
                        exclusive=exclusive)
    _close(got, ref, TOL)


def test_adaptive_avg_pool3d_and_its_raise():
    x = _f(np.random.default_rng(7), 2, 3, 4, 6, 8)
    for size in ((2, 3, 4), 2, (1, 1, 1)):
        _close(TF.adaptive_avg_pool3d(torch.from_numpy(x), size),
               JF.adaptive_avg_pool3d(jnp.asarray(x), size), TOL)
    with pytest.raises(NotImplementedError):
        TF.adaptive_avg_pool3d(torch.zeros(1, 1, 5, 4, 4), 2)


LAYERS = [
    ("Conv1D", (4, 6, 3), dict(stride=2, padding=1, groups=2), (2, 4, 9)),
    ("Conv3D", (4, 6, 3), dict(padding=1, dilation=2), (2, 4, 6, 6, 6)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1,
                                        output_padding=1, groups=2),
     (2, 4, 5, 5)),
    ("Conv3DTranspose", (4, 6, (3, 2, 3)), dict(stride=2, padding=1),
     (2, 4, 3, 4, 3)),
    ("Conv2D", (4, 6, 3), dict(bias_attr=False, data_format="NHWC"),
     (2, 5, 5, 4)),
]


@pytest.mark.parametrize("name,args,kw,shape", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_conv_layer_matches_with_carried_weights(name, args, kw, shape):
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw,
                            generator=torch.Generator().manual_seed(0))
    jp = {k: np.asarray(v) for k, v in parameters_dict(jl).items()}
    assert set(jp) == {k for k, _ in tl.named_parameters()}
    convert.from_jax_params(jp, tl)
    x = _f(np.random.default_rng(8), *shape)
    _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), TOL)
    # KaimingUniform(fan_in, leaky_relu, sqrt(5)): within 1 / sqrt(fan_in)
    fresh = getattr(tnn, name)(*args, **kw)
    fan_in = (fresh.in_channels // fresh.groups) * int(
        np.prod(fresh.kernel_size))
    assert float(fresh.weight.abs().max()) <= 1.0 / fan_in ** 0.5 + 1e-6


@pytest.mark.parametrize("name,args", [
    ("MaxPool3D", (3, 2, 1)), ("AvgPool3D", (3, 2, 1)),
    ("AdaptiveAvgPool3D", ((2, 3, 2),))])
def test_pool3d_layers(name, args):
    x = _f(np.random.default_rng(9), 2, 3, 4, 6, 6)
    ref = getattr(jnn, name)(*args)(jnp.asarray(x))
    _close(getattr(tnn, name)(*args)(torch.from_numpy(x)), ref, TOL)


def test_relu6_gradient_at_its_corners_is_the_reference():
    """jax.nn.relu6's gradient is 0 at 0 and at 6 (torch.clamp's is 1):
    MobileNet V2 hits exact zeros after a ReLU6, a 1x1 convolution without
    bias and an eval-mode BatchNorm."""
    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    jg = jax.grad(lambda v: jnp.sum(JF.relu6(v)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    TF.relu6(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
