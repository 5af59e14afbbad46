"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF


def relu(x):
    return torch.relu(x)


def gelu(x, approximate=False):
    """Exact erf GELU by default, as ``jax.nn.gelu(approximate=False)``."""
    return tF.gelu(x, approximate="tanh" if approximate else "none")


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def leaky_relu(x, negative_slope=0.01):
    return tF.leaky_relu(x, negative_slope)


def elu(x, alpha=1.0):
    return tF.elu(x, alpha)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def hardswish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def softplus(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, torch.zeros_like(x)) / beta)


def silu(x):
    return tF.silu(x)


swish = silu


def mish(x):
    return tF.mish(x)
