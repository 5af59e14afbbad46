"""LayerNorm layer (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch

from ...core import dtype as _dtype
from .. import functional as F
from .base import Layer, Parameter


class LayerNorm(Layer):
    """Scale 1 and shift 0 over ``normalized_shape``; ``weight_attr`` /
    ``bias_attr`` False drop the scale / the shift, as in the JAX package
    (which reads no initializer from them)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        dt = _dtype.get_default_dtype()
        self.weight = None if weight_attr is False else Parameter(
            torch.ones(self.normalized_shape, dtype=dt))
        self.bias = None if bias_attr is False else Parameter(
            torch.zeros(self.normalized_shape, dtype=dt))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            epsilon=self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}"
