"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py;
ref python/paddle/nn/layer/activation.py): each holds its options and
calls the functional activation."""
from __future__ import annotations

import torch

from ...core import dtype as _dtype
from .. import functional as F
from .base import Layer, Parameter


def _simple(name, fn, **fixed):
    class _Act(Layer):
        def __init__(self, **kwargs):
            super().__init__()
            self._kwargs = {**fixed, **kwargs}

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
Sigmoid = _simple("Sigmoid", F.sigmoid)
Tanh = _simple("Tanh", F.tanh)
GELU = _simple("GELU", F.gelu)
SiLU = _simple("SiLU", F.silu)
Mish = _simple("Mish", F.mish)
Hardswish = _simple("Hardswish", F.hardswish)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Hardtanh = _simple("Hardtanh", F.hardtanh)
ELU = _simple("ELU", F.elu)
CELU = _simple("CELU", F.celu)
SELU = _simple("SELU", F.selu)
Softplus = _simple("Softplus", F.softplus)
Softsign = _simple("Softsign", F.softsign)
Softshrink = _simple("Softshrink", F.softshrink)
Hardshrink = _simple("Hardshrink", F.hardshrink)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    """A learned slope (``num_parameters`` of them, per channel on axis 1
    when more than one), each ``init`` to start."""

    def __init__(self, num_parameters=1, init=0.25):
        super().__init__()
        self.weight = Parameter(torch.full(
            (num_parameters,), init, dtype=_dtype.get_default_dtype()))

    def forward(self, x):
        return F.prelu(x, self.weight)


class Softmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self.axis)
