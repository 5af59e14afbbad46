"""The tail of the layer classes (counterpart of paddle_tpu/nn/layer/
extras.py): CTCLoss, Bilinear / BilinearTensorProduct, CosineSimilarity,
PairwiseDistance, AlphaDropout, Dropout3D, Pad1D / Pad3D / ZeroPad2D,
PixelShuffle, SpectralNorm, LocalResponseNorm, RowConv, Conv3DTranspose,
the 3-D pools, InstanceNorm1D / 3D, Unfold and Identity: thin layers over
the functional and op library.

Parameters are drawn on the CPU from ``generator`` (keyword-only; torch's
default generator when None), as the port's other layers.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import random as _random
from .. import functional as F
from .. import initializer as I
from .base import Layer
from .common import make_param, param_init
from .conv import _ConvNd
from .norm import InstanceNorm2D

__all__ = [
    "Identity", "CTCLoss", "Bilinear", "BilinearTensorProduct",
    "CosineSimilarity", "PairwiseDistance", "AlphaDropout", "Dropout3D",
    "Pad1D", "Pad3D", "ZeroPad2D", "PixelShuffle", "SpectralNorm",
    "LocalResponseNorm", "RowConv", "Conv3DTranspose", "MaxPool3D",
    "AvgPool3D", "AdaptiveAvgPool3D", "InstanceNorm1D", "InstanceNorm3D",
    "Unfold",
]


class Identity(Layer):
    def forward(self, x):
        return x


class CTCLoss(Layer):
    """``F.ctc_loss`` as a layer (ref paddle.nn.CTCLoss, warpctc_op.cc)."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths=None,
                label_lengths=None):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction)


class Bilinear(Layer):
    """out_k = x1 W_k x2 + b_k (ref bilinear_tensor_product_op.cc); W (out,
    in1, in2) XavierUniform, b 0, unless the attrs carry initializers;
    ``bias_attr=False`` drops b."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        make_param(self, "weight", param_init(weight_attr, I.XavierUniform()),
                   (out_features, in1_features, in2_features), generator)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            make_param(self, "bias", param_init(bias_attr, I.Constant(0.0)),
                       (out_features,), generator)

    def forward(self, x1, x2):
        out = torch.einsum("bi,kij,bj->bk", x1, self.weight, x2)
        return out if self.bias is None else out + self.bias


class BilinearTensorProduct(Bilinear):
    """The Fluid-era name (fluid/dygraph/nn.py BilinearTensorProduct)."""


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    """The p-norm of x - y + epsilon over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p,
                                        dim=-1, keepdim=self.keepdim)


class AlphaDropout(Layer):
    """SELU-preserving dropout (ref paddle.nn.AlphaDropout): a dropped
    element becomes -alpha * scale, then an affine correction keeps the
    mean and variance.  The mask is drawn as ``F.dropout``'s."""

    _ALPHA = 1.6732632423543772
    _SCALE = 1.0507009873554805

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        alpha_p = -self._ALPHA * self._SCALE
        keep = 1.0 - self.p
        a = (keep + alpha_p ** 2 * keep * self.p) ** -0.5
        b = -a * alpha_p * self.p
        gen = _random.device_generator(x.device)
        mask = torch.rand(x.shape, generator=gen, device=x.device) >= self.p
        return a * torch.where(mask, x, torch.full((), alpha_p,
                                                   dtype=x.dtype,
                                                   device=x.device)) + b


class Dropout3D(Layer):
    """Channel-wise dropout of NCDHW (``F.dropout2d`` is rank generic)."""

    def __init__(self, p=0.5, data_format="NCDHW"):
        super().__init__()
        if data_format != "NCDHW":
            raise ValueError(
                "Dropout3D supports NCDHW only (channels-first channel "
                "mask); permute NDHWC input first")
        self.p = p

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__()
        self.padding = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding] * self._n_pad
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    _n_pad = 2


class Pad3D(_PadNd):
    _n_pad = 6

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadNd):
    _n_pad = 4

    def __init__(self, padding, data_format="NCHW"):
        super().__init__(padding, "constant", 0.0, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        from ...ops import misc

        return misc.pixel_shuffle(x, self.upscale_factor)


class SpectralNorm(Layer):
    """A weight over its largest singular value by power iteration (ref
    spectral_norm_op.cc); the vector u (ones at first) persists as the
    buffer ``_u`` and is updated in each forward."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        self.register_buffer("_u", torch.ones(weight_shape[dim]),
                             persistable=True)

    def forward(self, weight):
        from ...ops import misc

        out, u = misc.spectral_norm(weight, self._u, dim=self.dim,
                                    power_iters=self.power_iters,
                                    epsilon=self.eps)
        with torch.no_grad():
            self._u.copy_(u)
        return out


class LocalResponseNorm(Layer):
    def __init__(self, size=5, alpha=1e-4, beta=0.75, k=1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        from ...ops import misc

        return misc.lrn(x, n=self.size, alpha=self.alpha, beta=self.beta,
                        k=self.k)


class RowConv(Layer):
    """Lookahead convolution (ref row_conv_op.cc): weight (future_context_size
    + 1, num_channels), XavierUniform unless ``param_attr`` carries an
    initializer; ``lengths`` stop the lookahead at each sequence's end."""

    def __init__(self, num_channels, future_context_size, param_attr=None,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        make_param(self, "weight", param_init(param_attr, I.XavierUniform()),
                   (future_context_size + 1, num_channels), generator)

    def forward(self, x, lengths=None):
        from ...ops import misc

        return misc.row_conv(x, self.weight, lengths=lengths)


class Conv3DTranspose(_ConvNd):
    """``F.conv3d_transpose``; ``_ConvNd``'s initialization defaults."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias_attr, weight_attr,
                         ndim=3, transpose=True,
                         output_padding=output_padding, generator=generator)

    def forward(self, x):
        return F.conv3d_transpose(
            x, self.weight, self.bias, stride=self.stride,
            padding=self.padding, output_padding=self.output_padding,
            dilation=self.dilation, groups=self.groups)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.exclusive = padding, exclusive

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            exclusive=self.exclusive)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class InstanceNorm1D(InstanceNorm2D):
    """``F.instance_norm`` is rank generic (see InstanceNorm2D)."""


class InstanceNorm3D(InstanceNorm2D):
    """``F.instance_norm`` is rank generic (see InstanceNorm2D)."""


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)
