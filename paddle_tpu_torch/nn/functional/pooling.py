"""Pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

``max_pool2d`` / ``avg_pool2d`` take the NHWC pooling kernel
(ops/kernels/pooling.py) where ``_use_pallas_pool`` holds: the
``use_pallas_pool`` flag and the JAX package's shape gate ``supported()``.
The JAX package's TPU-backend test has no counterpart: on a CPU tensor the
wrapper runs its plain version, on a CUDA tensor it launches the kernel.
Elsewhere PyTorch's pooling runs, on a channels-last view for NHWC (no
copy), with the JAX semantics: max pads with -inf, the average divides by
the window size, or by the count of non-padding taps when ``exclusive``.
The 3-D pools are NCDHW, with the same semantics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ...core import flags
from ...ops.kernels import pooling as _pool


def _pair(v, n=2):
    return tuple(int(x) for x in v) if isinstance(v, (list, tuple)) \
        else (int(v),) * n


def _use_pallas_pool(x, kernel, stride, pads, mode, exclusive,
                     data_format) -> bool:
    """The kernel's dispatch: flag on and the JAX shape gate."""
    return (bool(flags.get_flag("use_pallas_pool"))
            and _pool.supported(x, kernel, stride, pads, mode, exclusive,
                                data_format))


def _nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(out, data_format):
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def _pad_spatial(x, pads, value):
    """Pad the trailing spatial dims of an NC... tensor, ``pads[i]`` on both
    sides of spatial dim i (PyTorch's pooling takes padding up to half the
    window only)."""
    return tF.pad(x, [v for p in reversed(pads) for v in (p, p)],
                  value=value)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               data_format="NCHW"):
    if return_mask:
        raise NotImplementedError("return_mask is not supported yet")
    kernel = _pair(kernel_size)
    strides = _pair(stride if stride is not None else kernel)
    pads = _pair(padding)
    if _use_pallas_pool(x, kernel, strides, pads, "max", True, data_format):
        return _pool.max_pool2d_nhwc(x, kernel, strides, pads)
    xc = _nchw(x, data_format)
    if pads[0] > kernel[0] // 2 or pads[1] > kernel[1] // 2:
        xc, pads = _pad_spatial(xc, pads, float("-inf")), (0, 0)
    return _back(tF.max_pool2d(xc, kernel, strides, pads), data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               data_format="NCHW"):
    kernel = _pair(kernel_size)
    strides = _pair(stride if stride is not None else kernel)
    pads = _pair(padding)
    if _use_pallas_pool(x, kernel, strides, pads, "avg", exclusive,
                        data_format):
        return _pool.avg_pool2d_nhwc(x, kernel, strides, pads)
    xc = _nchw(x, data_format)
    if pads[0] > kernel[0] // 2 or pads[1] > kernel[1] // 2:
        s = tF.avg_pool2d(_pad_spatial(xc, pads, 0.0), kernel, strides,
                          divisor_override=1)
        if exclusive:
            ones = _pad_spatial(torch.ones_like(xc[:1, :1]), pads, 0.0)
            s = s / tF.avg_pool2d(ones, kernel, strides, divisor_override=1)
        else:
            s = s / float(kernel[0] * kernel[1])
        return _back(s, data_format)
    return _back(tF.avg_pool2d(xc, kernel, strides, pads,
                               count_include_pad=not exclusive), data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0):
    out = max_pool2d(x[..., None], (_pair(kernel_size, 1)[0], 1),
                     None if stride is None else (_pair(stride, 1)[0], 1),
                     (_pair(padding, 1)[0], 0))
    return out[..., 0]


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True):
    out = avg_pool2d(x[..., None], (_pair(kernel_size, 1)[0], 1),
                     None if stride is None else (_pair(stride, 1)[0], 1),
                     (_pair(padding, 1)[0], 0), exclusive=exclusive)
    return out[..., 0]


def _adaptive_pool2d(x, output_size, reduce_fn, data_format):
    """Per-output-bin reduction with the reference's bin edges
    ``(i * h) // oh .. ceil((i + 1) * h / oh)``, as the JAX package."""
    oh, ow = _pair(output_size)
    xc = _nchw(x, data_format)
    n, c, h, w = xc.shape
    rows = []
    for i in range(oh):
        h0, h1 = (i * h) // oh, -(-((i + 1) * h) // oh)
        cols = [reduce_fn(xc[:, :, h0:h1, (j * w) // ow:-(-((j + 1) * w) // ow)])
                for j in range(ow)]
        rows.append(torch.stack(cols, dim=-1))
    return _back(torch.stack(rows, dim=-2), data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool2d(x, output_size,
                            lambda t: t.mean(dim=(2, 3)), data_format)


def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool2d(x, output_size,
                            lambda t: t.amax(dim=(2, 3)), data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0):
    """NCDHW max pool; padding takes -inf."""
    kernel = _pair(kernel_size, 3)
    strides = _pair(stride if stride is not None else kernel, 3)
    pads = _pair(padding, 3)
    if any(p > k // 2 for p, k in zip(pads, kernel)):
        x, pads = _pad_spatial(x, pads, float("-inf")), (0, 0, 0)
    return tF.max_pool3d(x, kernel, strides, pads)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True):
    """NCDHW average pool.  As in the JAX package, ``exclusive`` divides by
    the count of non-padding taps only where the padding is non-zero; with
    no padding every window is whole."""
    kernel = _pair(kernel_size, 3)
    strides = _pair(stride if stride is not None else kernel, 3)
    pads = _pair(padding, 3)
    if padding == 0 or (isinstance(padding, (list, tuple))
                        and not any(padding)) or not exclusive:
        exclusive = False
    if any(p > k // 2 for p, k in zip(pads, kernel)):
        s = tF.avg_pool3d(_pad_spatial(x, pads, 0.0), kernel, strides,
                          divisor_override=1)
        if exclusive:
            ones = _pad_spatial(torch.ones_like(x[:1, :1]), pads, 0.0)
            return s / tF.avg_pool3d(ones, kernel, strides,
                                     divisor_override=1)
        return s / float(kernel[0] * kernel[1] * kernel[2])
    return tF.avg_pool3d(x, kernel, strides, pads,
                         count_include_pad=not exclusive)


def adaptive_avg_pool3d(x, output_size):
    """NCDHW; the output size must divide each spatial dim, as in the JAX
    package, which raises otherwise."""
    od, oh, ow = _pair(output_size, 3)
    n, c, d, h, w = x.shape
    if d % od or h % oh or w % ow:
        raise NotImplementedError(
            "adaptive_avg_pool3d requires divisible spatial dims")
    return x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow).mean(
        dim=(3, 5, 7))
