"""Linear and dropout (counterpart of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch


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
    """Inverted (upscale-in-train) dropout: the identity at inference.
    Training-time dropout comes with the training slice."""
    if p == 0.0 or not training:
        return x
    raise NotImplementedError(
        "dropout in training mode comes with the training slice "
        "(ROADMAP.md, Queue 1 slice 2); call model.eval() to serve")
