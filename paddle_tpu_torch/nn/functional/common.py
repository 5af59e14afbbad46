"""Linear and dropout (counterpart of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ...core import random as _random


def linear(x, weight, bias=None):
    """y = x W + b with W in Paddle's (in_features, out_features) layout.
    A plain matrix product: the JAX package leaves it to XLA, the port to
    torch.matmul/addmm."""
    if bias is None:
        return torch.matmul(x, weight)
    x2 = x.reshape(-1, x.shape[-1])
    return torch.addmm(bias, x2, weight).reshape(*x.shape[:-1],
                                                 weight.shape[-1])


def dropout(x, p=0.5, training=True):
    """Inverted (upscale-in-train) dropout: the identity at inference; in
    training, each element is kept with probability 1 - p and scaled by
    1 / (1 - p).  The mask comes from a generator on x's device seeded from
    the active host generator (core/random.py), as the JAX package draws it
    from the active key stream.  A plain op, as in the JAX package."""
    if p == 0.0 or not training:
        return x
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")
    gen = _random.device_generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
