"""NHWC max / average pooling.

Counterpart of paddle_tpu/ops/pallas/pooling.py (row 13 of the table of
TPU kernels: ``_pool2d_nhwc`` and its entries ``max_pool2d_nhwc``,
``avg_pool2d_nhwc``).  One kernel source, ``csrc/pool2d_nhwc.cu``: each
thread takes one 16-byte vector (4 fp32 or 8 bf16 channels) of one output
pixel and issues every tap's load of the window before it combines them in
fp32; a padding tap reads the TPU kernel's padding (-inf for max, zeros for
the average), and the average multiplies by the fp32 value of
``1 / (kh * kw)`` (the non-exclusive average).  ``pool_plan`` picks, from
the shape, the kernel's compile-time window (2x2/2, 3x3/2 and 3x3/1; a
generic instantiation for the rest), the threads a CTA (so that small
outputs still spread over every SM) and 32- or 64-bit indexing.

``supported()`` is the JAX package's shape gate, VMEM cap included; the
dispatch site (``nn/functional/pooling.py``) applies it.  The wrappers
launch the kernel on CUDA tensors (NHWC-contiguous x, C % 8 == 0) or
raise, and run ``pool2d_nhwc_plain`` on CPU tensors.  Neither has a
backward, as the JAX functions have none: a call with grad enabled on an
input that requires grad raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from . import build, config

SOURCE = "pool2d_nhwc"
MAX_KERNEL = "max_pool2d"
AVG_KERNEL = "avg_pool2d"
REPLACES = "paddle_tpu/ops/pallas/pooling.py:91 _pool2d_nhwc"

VMEM_CAP_BYTES = 12 * 1024 * 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
C_MULTIPLE = 8  # channels: whole 16-byte vectors in either dtype
# The plan (csrc/pool2d_nhwc.cu): window codes of the compile-time
# instantiations (0 is the generic one), threads a CTA from largest to
# smallest, and the CTAs a launch aims for (two for each of the 132 SMs).
WINDOWS = {(2, 2, 2, 2): 1, (3, 3, 2, 2): 2, (3, 3, 1, 1): 3}
GENERIC_WINDOW = 0
POOL_THREADS = (256, 128, 64, 32)
SMS = 132
MIN_CTAS = 2 * SMS


def _out_hw(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def supported(x, kernel, stride, padding, mode="max", exclusive=True,
              data_format="NHWC") -> bool:
    """The JAX package's gate (pooling.py:70): x NHWC (anything with
    ``.shape`` and a torch ``.dtype``)."""
    if data_format != "NHWC" or len(getattr(x, "shape", ())) != 4:
        return False
    if x.dtype not in _DTYPE_CODES:
        return False
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    if kh > 8 or kw > 8 or sh not in (1, 2) or sw not in (1, 2):
        return False
    if mode == "avg" and exclusive and (ph or pw):
        return False
    n, h, w, c = x.shape
    if c % 128:
        return False
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(w, kw, sw, pw)
    if out_h <= 0 or out_w <= 0:
        return False
    itemsize = _ITEMSIZE[x.dtype]
    vmem = ((h + 2 * ph) * (w + 2 * pw) * c * 4
            + out_h * out_w * c * (4 + itemsize))
    return vmem <= VMEM_CAP_BYTES


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """The launch of the pooling kernel: the window code (WINDOWS, or
    GENERIC_WINDOW), ``vec`` channels a thread (one 16-byte vector), the
    output size, ``total`` threads (one a vector of an output pixel) in
    CTAs of ``threads``, and the index width in bits."""
    window: int
    vec: int
    out_h: int
    out_w: int
    total: int
    threads: int
    index_bits: int

    @property
    def ctas(self) -> int:
        return math.ceil(self.total / self.threads)


@functools.lru_cache(maxsize=1024)
def pool_plan(n, h, w, c, kh, kw, sh, sw, dtype, ph=0, pw=0) -> PoolPlan:
    """The plan of a pool over an (n, h, w, c) array of ``dtype``, from the
    shape alone: the compile-time window of (kh, kw, sh, sw) if there is
    one, else the generic one; the largest CTA in POOL_THREADS that still
    makes MIN_CTAS CTAs (the smallest where none does); 32-bit indices
    where the input and the output have fewer than 2 ** 31 elements."""
    vec = 16 // dtype.itemsize
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(w, kw, sw, pw)
    if c % vec or out_h < 1 or out_w < 1:
        raise ValueError(f"pool2d_nhwc: no plan for {(n, h, w, c)} window "
                         f"{(kh, kw)} / {(sh, sw)} / {(ph, pw)}")
    total = n * out_h * out_w * (c // vec)
    threads = next((t for t in POOL_THREADS
                    if math.ceil(total / t) >= MIN_CTAS), POOL_THREADS[-1])
    fits = max(n * h * w * c, n * out_h * out_w * c) < 2 ** 31
    return PoolPlan(window=WINDOWS.get((kh, kw, sh, sw), GENERIC_WINDOW),
                    vec=vec, out_h=out_h, out_w=out_w, total=total,
                    threads=threads, index_bits=32 if fits else 64)


def pool2d_nhwc_plain(x, kernel, stride, padding, mode):
    """The TPU kernel's arithmetic: the fp32 image padded with -inf (max)
    or 0 (avg), the window taps as strided slices combined in (i, j) order
    with max or +, the sum times the fp32 ``1 / (kh * kw)``."""
    n, h, w, c = x.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(w, kw, sw, pw)
    fill = float("-inf") if mode == "max" else 0.0
    xp = torch.nn.functional.pad(x.float(), (0, 0, pw, pw, ph, ph),
                                 value=fill)
    acc = torch.full((n, out_h, out_w, c), fill, dtype=torch.float32,
                     device=x.device)
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + (out_h - 1) * sh + 1:sh,
                     j:j + (out_w - 1) * sw + 1:sw, :]
            acc = torch.maximum(acc, win) if mode == "max" else acc + win
    if mode == "avg":
        acc = acc * torch.tensor(1.0 / (kh * kw), dtype=torch.float32)
    return acc.to(x.dtype)


def max_pool2d_nhwc_plain(x, kernel, stride, padding):
    return pool2d_nhwc_plain(x, kernel, stride, padding, "max")


def avg_pool2d_nhwc_plain(x, kernel, stride, padding):
    return pool2d_nhwc_plain(x, kernel, stride, padding, "avg")


def _check(name, x, kernel, stride, padding):
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NHWC x, got {tuple(x.shape)}")
    n, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if kh < 1 or kw < 1 or sh < 1 or sw < 1 or ph < 0 or pw < 0 \
            or _out_hw(h, kh, sh, ph) < 1 or _out_hw(w, kw, sw, pw) < 1:
        raise ValueError(f"{name}: bad window {kernel} / stride {stride} / "
                         f"padding {padding} on {h}x{w}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{name} has no backward (nor has the TPU kernel it replaces);"
            f" a program with a backward keeps its pools NCHW")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if c % C_MULTIPLE:
        raise ValueError(f"{name}: needs C % {C_MULTIPLE} == 0, got C={c}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be NHWC-contiguous; the wrapper "
                         f"does not copy it")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")


def _entry():
    """C entry: x, out (pointers), n, h, w, c, kh, kw, sh, sw, ph, pw,
    is_max (int), inv_count (float), dtype code, the plan's window code,
    threads and index bits (int), the stream."""
    fn = build.load(SOURCE).pool2d_nhwc
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P] + [I] * 11 + [ctypes.c_float] + [I] * 4 + [P]
        fn.restype = I
    return fn


def _pool2d_nhwc(x, kernel, stride, padding, mode, name):
    kernel, stride, padding = tuple(kernel), tuple(stride), tuple(padding)
    _check(name, x, kernel, stride, padding)
    if x.device.type == "cpu":
        return pool2d_nhwc_plain(x, kernel, stride, padding, mode)
    n, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    plan = pool_plan(n, h, w, c, kh, kw, sh, sw, x.dtype, ph, pw)
    out = torch.empty((n, plan.out_h, plan.out_w, c), dtype=x.dtype,
                      device=x.device)
    err = _entry()(
        x.data_ptr(), out.data_ptr(), n, h, w, c, kh, kw, sh, sw, ph, pw,
        int(mode == "max"), 1.0 / (kh * kw), _DTYPE_CODES[x.dtype],
        plan.window, plan.threads, plan.index_bits,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def max_pool2d_nhwc(x, kernel, stride, padding):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    out = _pool2d_nhwc(x, kernel, stride, padding, "max", MAX_KERNEL)
    if x.device.type == "cuda":
        config.record_call(MAX_KERNEL)
    return out


def avg_pool2d_nhwc(x, kernel, stride, padding):
    """Mean over the full ``kh * kw`` window (padding counts as zeros); the
    caller gates the exclusive-with-padding case out via ``supported()``."""
    out = _pool2d_nhwc(x, kernel, stride, padding, "avg", AVG_KERNEL)
    if x.device.type == "cuda":
        config.record_call(AVG_KERNEL)
    return out


def pool_cost(n, out_h, out_w, c, kh, kw, itemsize=4,
              in_h=None, in_w=None) -> Tuple[float, float]:
    """(flops, device bytes) of one call, the JAX package's cost model: one
    compare or add per tap; x read and the output written once."""
    flops = float(n * out_h * out_w * c * kh * kw)
    in_h = in_h if in_h is not None else out_h
    in_w = in_w if in_w is not None else out_w
    return flops, float((n * in_h * in_w * c + n * out_h * out_w * c)
                        * itemsize)


KERNELS = (
    config.Kernel(MAX_KERNEL, SOURCE, REPLACES, max_pool2d_nhwc,
                  max_pool2d_nhwc_plain),
    config.Kernel(AVG_KERNEL, SOURCE, REPLACES, avg_pool2d_nhwc,
                  avg_pool2d_nhwc_plain),
)
