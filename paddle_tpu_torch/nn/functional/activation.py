"""Activations (counterpart of paddle_tpu/nn/functional/activation.py; ref
python/paddle/nn/functional/activation.py), each the JAX package's formula
in torch.  ``softmax`` and ``log_softmax`` compute in fp32 and return the
input's dtype, as there."""
from __future__ import annotations

import torch
import torch.nn.functional as tF


def relu(x):
    return torch.relu(x)


def relu6(x):
    """``jax.nn.relu6``: its gradient is 0 at 0 and at 6, as
    ``tF.relu6``'s (``torch.clamp``'s is 1 there)."""
    return tF.relu6(x)


def leaky_relu(x, negative_slope=0.01):
    return tF.leaky_relu(x, negative_slope)


def prelu(x, weight):
    """``x`` where positive, else ``weight * x``; a weight of more than one
    element is per channel on axis 1 (NCHW)."""
    weight = torch.as_tensor(weight, device=x.device)
    if weight.numel() > 1 and x.dim() >= 2:
        shape = [1] * x.dim()
        shape[1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def elu(x, alpha=1.0):
    return tF.elu(x, alpha)


def celu(x, alpha=1.0):
    return tF.celu(x, alpha)


def selu(x):
    return tF.selu(x)


def gelu(x, approximate=False):
    """Exact erf GELU by default, as ``jax.nn.gelu(approximate=False)``."""
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


def softplus(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, torch.zeros_like(x)) / beta)


def softsign(x):
    return x / (1.0 + torch.abs(x))


def silu(x):
    return tF.silu(x)


swish = silu


def mish(x):
    return tF.mish(x)


def tanhshrink(x):
    return x - torch.tanh(x)


def log_sigmoid(x):
    return tF.logsigmoid(x)


def softmax(x, axis=-1, dtype=None):
    """In fp32 and back to ``x``'s dtype; in ``dtype`` when given."""
    if dtype is not None:
        from ...core.dtype import exact_dtype

        return torch.softmax(x.to(exact_dtype(dtype)), dim=axis)
    return torch.softmax(x.float(), dim=axis).to(x.dtype)


def log_softmax(x, axis=-1):
    return torch.log_softmax(x.float(), dim=axis).to(x.dtype)


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)
