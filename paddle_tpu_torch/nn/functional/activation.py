"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as tF


def relu(x):
    return torch.relu(x)


def gelu(x, approximate=False):
    """Exact erf GELU by default, as ``jax.nn.gelu(approximate=False)``."""
    return tF.gelu(x, approximate="tanh" if approximate else "none")
