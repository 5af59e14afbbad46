"""Linear, dropout, padding, interpolation, cosine similarity and unfold
(counterpart of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ...core import random as _random


def linear(x, weight, bias=None):
    """y = x W + b with W in Paddle's (in_features, out_features) layout.
    A plain matrix product: the JAX package leaves it to XLA, the port to
    torch.matmul/addmm."""
    if bias is None:
        return torch.matmul(x, weight)
    x2 = x.reshape(-1, x.shape[-1])
    return torch.addmm(bias, x2, weight).reshape(*x.shape[:-1],
                                                 weight.shape[-1])


def dropout(x, p=0.5, training=True, mode="upscale_in_train"):
    """Dropout in the reference's two modes.  ``upscale_in_train``
    (inverted dropout, the default): the identity at inference; in
    training, each element is kept with probability 1 - p and scaled by
    1 / (1 - p).  Otherwise (``downgrade_in_infer``): kept elements are not
    scaled in training, and inference multiplies by 1 - p.  The mask comes
    from a generator on x's device seeded from the active host generator
    (core/random.py), as the JAX package draws it from the active key
    stream.  At p = 1 training returns zeros in both modes, as the JAX
    package's all-false mask does.  A plain op, as in the JAX package."""
    if p == 0.0:
        return x
    if not training:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1], got {p}")
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if p == 1.0:
        return torch.where(torch.zeros(x.shape, dtype=torch.bool,
                                       device=x.device), x, zero)
    gen = _random.device_generator(x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, zero)


def dropout2d(x, p=0.5, training=True):
    """Channel-wise dropout of NCHW (any rank): one keep draw for each
    (sample, channel), kept channels scaled by 1 / (1 - p)."""
    if p == 0.0 or not training:
        return x
    gen = _random.device_generator(x.device)
    keep = torch.rand(tuple(x.shape[:2]) + (1,) * (x.dim() - 2),
                      generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _pad_index(n, lo, hi, mode, device):
    """The source index of each padded position along a dim of size n."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    # reflect (numpy's, the edge not repeated), periodic in 2 (n - 1)
    period = max(2 * (n - 1), 1)
    m = i % period
    return torch.where(m >= n, period - m, m)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    """ref paddle.nn.functional.pad (pad2d / pad3d).  A full spec (2 *
    ndim values) pads each dim in dim order; a partial one pads the
    spatial dims in Paddle's LAST-DIM-FIRST pair order (NCHW with (l, r,
    t, b) pads W by (l, r), H by (t, b)), before C for channels-last.
    Modes constant, reflect, replicate and circular."""
    if len(pad) == 2 * x.dim():
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(x.dim())]
    else:
        n_spatial = len(pad) // 2
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(n_spatial)]
        cfg = [(0, 0)] * (x.dim() - n_spatial) + pairs[::-1]
        if data_format.endswith("C"):      # channels last: spatial before C
            cfg = ([(0, 0)] + cfg[2:] + [(0, 0)])[: x.dim()]
    cfg = [(int(a), int(b)) for a, b in cfg]
    if mode == "constant":
        flat = [v for a, b in reversed(cfg) for v in (a, b)]
        return torch.nn.functional.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = torch.index_select(x, d, _pad_index(x.shape[d], lo, hi, mode,
                                                    x.device))
    return x


def _axis_coords(out_n, in_n, align_corners, device, clip=True):
    if align_corners and out_n > 1:
        return torch.linspace(0, in_n - 1, out_n, device=device)
    cs = (torch.arange(out_n, device=device) + 0.5) * in_n / out_n - 0.5
    # bicubic keeps the raw (possibly negative) coordinates: its weights
    # come from the unclipped fraction, only the tap indices clamp
    return cs.clamp(0, in_n - 1) if clip else cs


def _cubic_weights(t, a=-0.75):
    """Keys' cubic-convolution weights of the 4 taps around t (ref
    bicubic_interp_v2_op.h cubic_interp1d)."""
    d = t - torch.floor(t)
    x1, x0, xm1, xm2 = 1 + d, d, 1 - d, 2 - d
    return (a * x1 ** 3 - 5 * a * x1 ** 2 + 8 * a * x1 - 4 * a,
            (a + 2) * x0 ** 3 - (a + 3) * x0 ** 2 + 1,
            (a + 2) * xm1 ** 3 - (a + 3) * xm1 ** 2 + 1,
            a * xm2 ** 3 - 5 * a * xm2 ** 2 + 8 * a * xm2 - 4 * a)


def _along(t, axis, ndim):
    """A 1-D ``t`` shaped to broadcast along ``axis`` of an ndim tensor."""
    return t.reshape((1,) * axis + (-1,) + (1,) * (ndim - 1 - axis))


def _sizes(size, scale_factor, spatial):
    if size is not None:
        return tuple(int(s) for s in size)
    sf = scale_factor if isinstance(scale_factor, (tuple, list)) \
        else (scale_factor,) * len(spatial)
    return tuple(int(n * f) for n, f in zip(spatial, sf))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """ref operators/interpolate_v2_op.cc: nearest, (bi)linear and bicubic
    (Keys, a = -0.75) on NCHW or NHWC, trilinear on NCDHW.  Half-pixel
    coordinates, or the corners with ``align_corners``; the interpolation
    is separable, one axis at a time, as in the JAX package."""
    if mode == "trilinear":
        out = x
        for axis, (o, i) in zip((2, 3, 4), zip(
                _sizes(size, scale_factor, x.shape[2:]), x.shape[2:])):
            cs = _axis_coords(o, i, align_corners, x.device)
            c0 = torch.floor(cs).long()
            c1 = (c0 + 1).clamp(0, i - 1)
            frac = _along(cs - c0, axis, 5)
            out = (torch.index_select(out, axis, c0) * (1 - frac)
                   + torch.index_select(out, axis, c1) * frac)
        return out.to(x.dtype)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    oh, ow = _sizes(size, scale_factor, (h, w))
    if mode == "bicubic":
        out = x
        for axis, (o, i) in zip((2, 3), ((oh, h), (ow, w))):
            cs = _axis_coords(o, i, align_corners, x.device, clip=False)
            base = torch.floor(cs).long()
            acc = 0.0
            for tap, wgt in zip((-1, 0, 1, 2), _cubic_weights(cs)):
                idx = (base + tap).clamp(0, i - 1)
                acc = acc + torch.index_select(out, axis, idx) \
                    * _along(wgt, axis, 4)
            out = acc
    elif mode == "nearest":
        dev = x.device
        if align_corners and oh > 1 and ow > 1:
            ridx = torch.round(torch.arange(oh, device=dev) * (h - 1)
                               / (oh - 1)).long()
            cidx = torch.round(torch.arange(ow, device=dev) * (w - 1)
                               / (ow - 1)).long()
        else:
            ridx = (torch.arange(oh, device=dev) * (h / oh)).long()
            cidx = (torch.arange(ow, device=dev) * (w / ow)).long()
        out = x[:, :, ridx][:, :, :, cidx]
    elif mode in ("bilinear", "linear"):
        if align_corners and oh > 1 and ow > 1:
            rs = torch.linspace(0, h - 1, oh, device=x.device)
            cs = torch.linspace(0, w - 1, ow, device=x.device)
        else:
            rs = _axis_coords(oh, h, False, x.device)
            cs = _axis_coords(ow, w, False, x.device)
        r0, c0 = torch.floor(rs).long(), torch.floor(cs).long()
        r1, c1 = (r0 + 1).clamp(0, h - 1), (c0 + 1).clamp(0, w - 1)
        wr = (rs - r0)[None, None, :, None]
        wc = (cs - c0)[None, None, None, :]

        def g(ri, ci):
            return x[:, :, ri][:, :, :, ci]

        out = (g(r0, c0) * (1 - wr) * (1 - wc) + g(r1, c0) * wr * (1 - wc)
               + g(r0, c1) * (1 - wr) * wc + g(r1, c1) * wr * wc)
    else:
        raise NotImplementedError(f"interpolate mode {mode!r}")
    out = out.to(x.dtype)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False):
    return interpolate(x, size=size, scale_factor=scale_factor, mode=mode,
                       align_corners=align_corners)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """ref operators/unfold_op.cc (im2col): (N, C, H, W) -> (N, C kh kw,
    L), the channel index slowest, as the JAX package's patches."""
    return torch.nn.functional.unfold(x, kernel_sizes, dilation=dilations,
                                      padding=paddings, stride=strides)
