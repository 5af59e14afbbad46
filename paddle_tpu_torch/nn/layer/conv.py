"""Convolution layers (counterpart of paddle_tpu/nn/layer/conv.py):
Conv1D, Conv2D (the layer ``QuantizedConv2D`` wraps), Conv3D and
Conv2DTranspose, on the port's functional convolutions.  Conv3DTranspose
shares ``_ConvNd`` from ``extras``, as in the JAX package."""
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


class _ConvNd(Layer):
    """Weight (out, in / groups, k...), or (in, out / groups, k...) when
    ``transpose``: KaimingUniform(fan_in = in / groups * prod(k),
    leaky_relu, slope sqrt(5)) unless ``weight_attr`` carries an
    initializer; bias 0, none with ``bias_attr=False``.  Names and
    signatures are the JAX package's, so ``convert.from_jax_params``
    carries the weights by key."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, bias_attr, weight_attr, ndim,
                 transpose=False, output_padding=0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size, ndim)
        self.stride = _pair(stride, ndim)
        self.padding = padding
        self.dilation = _pair(dilation, ndim)
        self.groups = groups
        self.output_padding = output_padding
        if transpose:
            wshape = (in_channels, out_channels // groups) + self.kernel_size
        else:
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

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"k={self.kernel_size}, s={self.stride}")


class Conv2D(_ConvNd):
    """``padding_mode`` other than zeros is not supported (the reference
    ignores it too)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 generator: Optional[torch.Generator] = None):
        del padding_mode
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         ndim=2, generator=generator)
        self.data_format = data_format

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, data_format=self.data_format)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         ndim=1, generator=generator)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         ndim=3, generator=generator)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         ndim=2, transpose=True,
                         output_padding=output_padding, generator=generator)

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias,
                                  stride=self.stride, padding=self.padding,
                                  output_padding=self.output_padding,
                                  dilation=self.dilation, groups=self.groups)
