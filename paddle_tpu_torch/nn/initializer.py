"""Initializer descriptors (counterpart of paddle_tpu/nn/initializer.py).

Only the descriptors that the static graph maps to startup ops
(``static/layers._init_attrs``) are ported: their fields say what to draw,
and the startup program's random ops draw it.
"""
from __future__ import annotations

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform"]


class Initializer:
    """Base of the descriptors."""


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain
