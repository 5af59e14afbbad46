"""Conv2D layer (counterpart of paddle_tpu/nn/layer/conv.py ``Conv2D``, the
layer ``QuantizedConv2D`` wraps), on the port's ``F.conv2d``.  Conv1D,
Conv3D and the transposed convolutions are not ported (ROADMAP.md)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from .base import Layer
from .common import make_param, param_init


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class Conv2D(Layer):
    """Weight (out, in / groups, kh, kw): KaimingUniform(fan_in,
    leaky_relu, slope sqrt(5)) unless ``weight_attr`` carries an
    initializer; bias 0, none with ``bias_attr=False``.  ``padding_mode``
    other than zeros is not supported (the reference ignores it too)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        del padding_mode
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        self.dilation = _pair(dilation)
        self.groups = groups
        self.data_format = data_format
        wshape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        w_init = param_init(weight_attr, I.KaimingUniform(
            fan_in=fan_in, nonlinearity="leaky_relu",
            negative_slope=np.sqrt(5.0)))
        make_param(self, "weight", w_init, wshape, generator)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            make_param(self, "bias", param_init(bias_attr, I.Constant(0.0)),
                       (out_channels,), generator)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"k={self.kernel_size}, s={self.stride}")
