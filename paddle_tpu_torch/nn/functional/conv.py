"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py): 1-D,
2-D, 3-D and the 2-D / 3-D transposed ones.

The JAX package computes these convolutions with XLA, outside any Pallas
kernel, so the port calls cuDNN through ``torch.nn.functional``.
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


def _pair(v, n=2):
    return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) \
        else (int(v),) * n


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


def _pads(padding, x, k, stride, dilation):
    """JAX's padding forms as one (low, high) pair a spatial dim: an int,
    one int a dim, one (low, high) pair a dim, or "SAME" / "VALID" (SAME:
    ceil(in / stride) outputs, the odd pad on the high side)."""
    n = len(k)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pads = []
        for size, kk, s, d in zip(x.shape[2:], k, stride, dilation):
            total = max(-(-size // s) * s - s + d * (kk - 1) + 1 - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if not isinstance(padding, (list, tuple)):
        return [(int(padding), int(padding))] * n
    return [(int(p[0]), int(p[1])) if isinstance(p, (list, tuple))
            else (int(p), int(p)) for p in padding]


def _conv_nd(conv, x, weight, bias, stride, padding, dilation, groups):
    """``conv`` (tF.conv1d / tF.conv3d) with JAX's padding: symmetric
    non-negative pads go to cuDNN, the rest is padded (or, negative,
    cropped) beforehand."""
    n = weight.dim() - 2
    stride, dilation = _pair(stride, n), _pair(dilation, n)
    pads = _pads(padding, x, weight.shape[2:], stride, dilation)
    if all(lo == hi >= 0 for lo, hi in pads):
        return conv(x, weight, bias, stride, [lo for lo, _ in pads],
                    dilation, groups)
    x = tF.pad(x, [v for lo, hi in reversed(pads) for v in (lo, hi)])
    return conv(x, weight, bias, stride, 0, dilation, groups)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """x: (N, C, L); weight: (O, C / groups, k)."""
    return _conv_nd(tF.conv1d, x, weight, bias, stride, padding, dilation,
                    groups)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """x: (N, C, D, H, W); weight: (O, C / groups, kd, kh, kw)."""
    return _conv_nd(tF.conv3d, x, weight, bias, stride, padding, dilation,
                    groups)


def _conv_transpose(conv, x, weight, bias, stride, padding, output_padding,
                    dilation, groups):
    """The JAX package's transposed convolution: a convolution of the
    stride-dilated input with the flipped filter, padded ``k_eff - 1 - p``
    low and ``k_eff - 1 - p + output_padding`` high, where XLA takes any
    pad and crops where it is negative.  That is the full transposed
    output (p = 0) with p cropped low and ``p - output_padding`` high (or
    zeros added there).  cuDNN's transposed convolution computes it where
    torch accepts the values (p >= 0 and output_padding < max(stride,
    dilation)); elsewhere the full output is cropped and padded to it."""
    n = weight.dim() - 2
    stride, dilation = _pair(stride, n), _pair(dilation, n)
    padding, output_padding = _pair(padding, n), _pair(output_padding, n)
    if all(p >= 0 and 0 <= op < max(s, d) for p, op, s, d in
           zip(padding, output_padding, stride, dilation)):
        return conv(x, weight, bias, stride, padding, output_padding,
                    groups, dilation)
    out = conv(x, weight, None, stride, 0, 0, groups, dilation)
    out = tF.pad(out, [v for p, op in zip(reversed(padding),
                                          reversed(output_padding))
                       for v in (-p, op - p)])
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * n)
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    """x: (N, C, H, W); weight: (C, O / groups, kh, kw), groups split along
    its axis 0 (the reference's layout and torch's)."""
    return _conv_transpose(tF.conv_transpose2d, x, weight, bias, stride,
                           padding, output_padding, dilation, groups)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1):
    """x: (N, C, D, H, W); weight: (C, O / groups, kd, kh, kw)."""
    return _conv_transpose(tF.conv_transpose3d, x, weight, bias, stride,
                           padding, output_padding, dilation, groups)
