"""LayerNorm layer (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ...core import dtype as _dtype
from .. import functional as F


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        dt = _dtype.get_default_dtype()
        self.weight = nn.Parameter(torch.ones(self.normalized_shape, dtype=dt))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape, dtype=dt))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            epsilon=self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}"
