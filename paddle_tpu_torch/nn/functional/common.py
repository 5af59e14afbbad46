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


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    """Dropout in the reference's two modes.  ``upscale_in_train``
    (inverted dropout, the default): the identity at inference; in
    training, each element is kept with probability 1 - p and scaled by
    1 / (1 - p).  Otherwise (``downgrade_in_infer``): kept elements are not
    scaled in training, and inference multiplies by 1 - p.  The mask comes
    from a generator on x's device seeded from the active host generator
    (core/random.py), as the JAX package draws it from the active key
    stream.  At p = 1 training returns zeros in both modes, as the JAX
    package's all-false mask does.  A plain op, as in the JAX package."""
    if p == 0.0:
        return x
    if not training:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1], got {p}")
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if p == 1.0:
        return torch.where(torch.zeros(x.shape, dtype=torch.bool,
                                       device=x.device), x, zero)
    gen = _random.device_generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, zero)
