"""The 24 activation functions and 23 activation layers of the port
against the JAX package's, on the CPU: the same inputs (values across
every activation's kinks and thresholds, -25 to 25) and options, fp32 at
rtol 1e-5 / atol 1e-6 (``softplus`` and ``mish`` through ``logaddexp``
and ``tanh`` of another library, the same formula); the gradients of
each function at rtol 1e-4 / atol 3e-5 (gradients of order 1; the
tanh-approximate GELU's backward is another expression in torch, 1.1e-5
apart where it crosses zero) against ``jax.grad``, at points
off every kink (at a kink each package picks its own subgradient: JAX's
``maximum`` splits a tie in half, torch's ``clamp`` passes it whole).
``softmax`` / ``log_softmax`` of a bf16 input compute in fp32 and return
bf16 in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 3e-5

# (function, options); prelu's weight comes in as an input
FUNCTIONS = [
    ("relu", {}), ("relu6", {}), ("leaky_relu", {"negative_slope": 0.2}),
    ("prelu", {}), ("elu", {"alpha": 0.7}), ("celu", {"alpha": 1.3}),
    ("selu", {}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("sigmoid", {}), ("hardsigmoid", {"slope": 0.2, "offset": 0.4}),
    ("hardswish", {}), ("hardtanh", {"min": -0.5, "max": 2.0}),
    ("hardshrink", {"threshold": 0.3}), ("softshrink", {"threshold": 0.3}),
    ("softplus", {"beta": 2.0, "threshold": 10.0}), ("softsign", {}),
    ("silu", {}), ("swish", {}), ("mish", {}), ("tanhshrink", {}),
    ("log_sigmoid", {}), ("softmax", {"axis": 1}), ("log_softmax", {}),
    ("glu", {"axis": 1}),
]

LAYERS = [
    ("ReLU", {}), ("ReLU6", {}), ("Sigmoid", {}), ("Tanh", {}),
    ("GELU", {"approximate": True}), ("SiLU", {}), ("Mish", {}),
    ("Hardswish", {}), ("Hardsigmoid", {"slope": 0.25}),
    ("Hardtanh", {"min": -2.0}), ("ELU", {"alpha": 0.5}), ("CELU", {}),
    ("SELU", {}), ("Softplus", {"beta": 0.5}), ("Softsign", {}),
    ("Softshrink", {"threshold": 0.25}), ("Hardshrink", {}),
    ("Tanhshrink", {}), ("LogSigmoid", {}), ("LeakyReLU", {}),
    ("PReLU", {}), ("Softmax", {"axis": 0}), ("LogSoftmax", {}),
]


def _input(kinks=True):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (4, 6, 5)).astype(np.float32)
    if kinks:
        x.flat[:12] = [-25, -6, -3, -1, -0.3, 0.0, 0.3, 1, 3, 6, 25, 10.0]
    return x


def _args(name, x):
    if name == "prelu":
        w = np.linspace(0.1, 0.6, x.shape[1]).astype(np.float32)
        return (x, w)
    return (x,)


def test_every_function_and_layer_is_covered():
    from paddle_tpu.nn.functional import activation as jact

    names = {n for n, _ in FUNCTIONS}
    assert len(names) == 24
    assert names == {n for n in dir(jact) if not n.startswith("_")
                     and callable(getattr(jact, n))
                     and getattr(jact, n).__module__ == jact.__name__}
    assert len(LAYERS) == 23
    for n, _ in FUNCTIONS:
        assert n in TF.__all__ and callable(getattr(JF, n))
    for n, _ in LAYERS:
        assert n in tnn.__all__ and hasattr(jnn, n)


@pytest.mark.parametrize("name,opts", FUNCTIONS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FUNCTIONS)])
def test_function_and_gradient_match_the_reference(name, opts):
    x = _input()
    args = _args(name, x)
    ref = getattr(JF, name)(*[jnp.asarray(a) for a in args], **opts)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = getattr(TF, name)(*targs, **opts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    # d sum(f(x) * c) / dx, off the kinks
    args = _args(name, _input(kinks=False))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = getattr(TF, name)(*targs, **opts)
    c = np.random.default_rng(1).normal(size=got.shape).astype(np.float32)
    jgrad = jax.grad(lambda *a: jnp.sum(getattr(JF, name)(*a, **opts) * c),
                     argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    tgrad = torch.autograd.grad((got * torch.from_numpy(c)).sum(), targs)
    for t, j in zip(tgrad, jgrad):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("name,opts", LAYERS, ids=[n for n, _ in LAYERS])
def test_layer_matches_the_reference(name, opts):
    x = _input()
    jl, tl = getattr(jnn, name)(**opts), getattr(tnn, name)(**opts)
    assert isinstance(tl, tnn.Layer)
    if name == "PReLU":
        assert [n for n, _ in tl.named_parameters()] == ["weight"]
        assert tl.set_state_dict({"weight": np.full(1, 0.3, np.float32)}) \
            == jl.set_state_dict({"weight": np.full(1, 0.3, np.float32)}) \
            == ([], [])
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl(jnp.asarray(x))), rtol=RTOL,
                               atol=ATOL)


def test_prelu_per_channel_parameter_learns():
    layer = tnn.PReLU(6, 0.25)
    jlayer = jnn.PReLU(6, 0.25)
    x = _input()
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jlayer(jnp.asarray(x))), rtol=RTOL,
                               atol=ATOL)
    layer(torch.from_numpy(x)).sum().backward()
    assert layer.weight.grad.shape == (6,)
    np.testing.assert_allclose(layer.weight.grad.numpy(),
                               np.minimum(x, 0).sum(axis=(0, 2)), rtol=1e-5)


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
def test_softmax_of_bf16_returns_bf16(name):
    x = _input()[0]
    got = getattr(TF, name)(torch.from_numpy(x).to(torch.bfloat16))
    ref = getattr(JF, name)(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)
