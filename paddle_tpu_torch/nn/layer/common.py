"""Linear, Embedding, Dropout (counterpart of paddle_tpu/nn/layer/common.py).

Parameters are made on the CPU from an explicit ``torch.Generator`` (the
global one when none is given), so one seed gives one set of weights on
every device; a model moves them to its device afterwards.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...core import dtype as _dtype
from .. import functional as F


def xavier_uniform(shape, generator: Optional[torch.Generator] = None):
    """Glorot uniform over (fan_in, fan_out) = shape[:2], as the JAX
    package's XavierUniform for a 2-D weight."""
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2.0 * limit) - limit).to(_dtype.get_default_dtype())


def normal(shape, std, generator: Optional[torch.Generator] = None):
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return w.to(_dtype.get_default_dtype())


class Linear(nn.Module):
    """y = x W + b with W: (in_features, out_features), Paddle's layout
    (not torch's (out, in)), so converted weights keep their shape."""

    def __init__(self, in_features, out_features,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(
            xavier_uniform((in_features, out_features), generator))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=_dtype.get_default_dtype()))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.copy_(xavier_uniform(tuple(self.weight.shape),
                                             generator))
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """ref nn/layer/common.py Embedding, with the reference's parameter
    order.  ``padding_idx`` zeroes that id's output row.  The port's
    initialisation is N(0, ``std``) from ``generator`` (keyword-only);
    ``sparse=True`` and a ``weight_attr`` are not ported and raise, and
    ``name`` is accepted (a module has no parameter names of its own)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, std=1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if sparse:
            raise NotImplementedError(
                "Embedding(sparse=True) is not ported to paddle_tpu_torch "
                "yet")
        if weight_attr is not None:
            raise NotImplementedError(
                "Embedding(weight_attr=...) is not ported to "
                "paddle_tpu_torch yet; pass std= and generator=")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = nn.Parameter(
            normal((num_embeddings, embedding_dim), std, generator))

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training)

    def extra_repr(self):
        return f"p={self.p}"
