"""Convolution (counterpart of paddle_tpu/nn/functional/conv.py ``conv2d``).

The JAX package computes this convolution with XLA, outside any Pallas
kernel, so the port calls cuDNN through ``torch.nn.functional.conv2d``.
NHWC runs as a channels-last view: the (N, H, W, C) tensor permuted to an
(N, C, H, W) view with channels-last strides goes into the convolution,
and the output, channels-last, is permuted back to a contiguous (N, H, W,
C) tensor, so no copy is made on either side.  The filter goes in
channels-last too, which makes cuDNN compute in NHWC even where the input
is an NHWC view of NCHW memory (the first convolution after the layout
boundary): cuDNN then converts that input itself, and the output is still
NHWC-contiguous, as the NHWC kernels downstream require.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF


def _pair(v):
    return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) \
        else (int(v), int(v))


def _padding(padding):
    """An int, an (h, w) pair, or "SAME" / "VALID"."""
    return padding.lower() if isinstance(padding, str) else _pair(padding)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """x: (N, C, H, W) or (N, H, W, C); weight: (O, C / groups, kh, kw)."""
    stride, dilation = _pair(stride), _pair(dilation)
    pad = _padding(padding)
    if data_format == "NHWC":
        out = tF.conv2d(x.permute(0, 3, 1, 2),
                        weight.contiguous(memory_format=torch.channels_last),
                        bias, stride, pad, dilation, groups)
        return out.permute(0, 2, 3, 1)
    return tF.conv2d(x, weight, bias, stride, pad, dilation, groups)
