"""int8 inference: matmul and conv with int32 sums and an fp32 per-channel
dequant epilogue.

Counterpart of paddle_tpu/ops/pallas/int8.py (rows 14 and 15 of the table
of TPU kernels)::

    int8_matmul_dequant:  out = act((x_q @ w_q) * scale + bias)
    int8_conv2d_dequant:  out = act(conv2d(x_q, w_q) * scale + bias)

with int8 operands (symmetric, zero point 0), the sum exact in int32, then
``scale`` (the input step times the weight step, per output channel) and
``bias`` in fp32, act one of "", relu, relu6, sigmoid, tanh, and the
output in ``out_dtype`` (fp32 or bf16).  The quant_conv2d / quant_mul
lowerings (static/ops_fused.py) call them.  Two kernel sources on one
GEMM (``csrc/int8_gemm.cuh``: s8 ``wgmma`` fed by TMA, persistent CTAs,
K split across CTAs where the output tiles do not fill the card):

* ``csrc/int8_matmul_dequant.cu`` (row 14): x_q (M, K) against the weight
  as (N, K);
* ``csrc/int8_conv2d_dequant.cu`` (row 15): an implicit GEMM of the NHWC
  input (TMA im2col loads, zero padding from the loads) against the
  filter as (O, kh, kw, C).

8-bit ``wgmma`` takes both operands K-major, so the wrappers lay the
weight out once per weight tensor and version (``matmul_weight``,
``conv_weight``) and keep that copy while the weight lives.
``matmul_plan`` / ``conv_plan`` mirror the C entries' tiles and K splits.

``matmul_supported`` / ``conv_supported`` are the JAX gates (the conv's
VMEM cap included), so the same ops take the kernels in both packages.
The wrappers launch on CUDA tensors or raise, and run the plain versions
on CPU tensors.  The plain versions sum exactly: in int32 on CPU tensors,
in float64 on CUDA tensors (every partial sum is below 127^2 * 49 * C <
2^53), then apply the epilogue in fp32 as separate multiply and add.  The
kernels do too (no FMA contraction), so kernel and plain version agree bit
for bit for the piecewise-linear acts and within the ulps of expf / tanhf
for sigmoid and tanh.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build, config
from .conv_fused import IM2COL_PAD_LIMIT, ConvPlan, apply_act

MATMUL_SOURCE = "int8_matmul_dequant"
CONV_SOURCE = "int8_conv2d_dequant"
MATMUL_KERNEL = "int8_matmul_dequant"
CONV_KERNEL = "int8_conv2d_dequant"
MATMUL_REPLACES = "paddle_tpu/ops/pallas/int8.py:92 int8_matmul_dequant"
CONV_REPLACES = "paddle_tpu/ops/pallas/int8.py:166 int8_conv2d_dequant"

# Per-image VMEM budget of the TPU conv kernel: part of the JAX dispatch
# rule, not a limit of the CUDA kernel.
VMEM_CAP_BYTES = 12 * 1024 * 1024
EPILOGUE_ACTS = ("", "relu", "relu6", "sigmoid", "tanh")
_ACT_CODES = {"": 0, "relu": 1, "relu6": 2, "sigmoid": 3, "tanh": 4}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' tiling (csrc/int8_gemm.cuh): 128 x 128 output tiles, K in
# units of 128 int8 values (one tap x 128 channels for the conv), C or K a
# multiple of ALIGN_K.
BLOCK_M = 128
BLOCK_N = 128
UNIT_K = 128
ALIGN_K = 64
H100_SMS = 132
MAX_SPLITS = 16
# The split cost model, fitted to H100 times of the kernels at VGG-16's
# 2x2 and 4x4 layers with the splits forced (experiments/int8_experiments.py
# splits): a K unit of a 128 x 128 tile costs a CTA UNIT_US; more than one
# split adds the split-sum launch (SPLIT_US) and SPLIT_VALUE_US for each
# output value of each split (the int32 partials written and summed).
UNIT_US = 0.34
SPLIT_US = 1.0
SPLIT_VALUE_US = 1.3e-6


def split_cost_us(m: int, n: int, units: int, splits: int) -> float:
    """The modelled time of a one-wave call with ``splits`` K splits."""
    extra = SPLIT_US + SPLIT_VALUE_US * splits * m * n if splits > 1 else 0.0
    return -(-units // splits) * UNIT_US + extra


def _plan(m: int, n: int, units: int, sms: int) -> ConvPlan:
    """Where the output tiles alone give fewer than ``sms`` CTAs (one CTA
    an SM: 200 KB of shared memory), K is split into the number of parts,
    up to ``MAX_SPLITS`` and never a second wave, that ``split_cost_us``
    finds fastest: a split halves a CTA's share of K but adds an int32
    partial tile and a second pass, so VGG's 2x2 layer takes 6 (96 CTAs,
    measured faster than 8 with 128), the 4x4 512-channel layer 2 and the
    4x4 256-channel one none."""
    tiles = -(-m // BLOCK_M) * (n // BLOCK_N)
    splits = 1
    if tiles < sms:
        most = min(MAX_SPLITS, units, sms // tiles)
        splits = min(range(1, most + 1),
                     key=lambda s: split_cost_us(m, n, units, s))
    return ConvPlan(BLOCK_M, BLOCK_N, m, tiles, units, splits)


def matmul_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> ConvPlan:
    """The tiles and K splits of ``int8_matmul_dequant`` (row 10's plan
    type; mirrors the C entry): ``ceil(K / UNIT_K)`` units."""
    return _plan(m, n, -(-k // UNIT_K), sms)


def conv_plan(n, h, w, c, o, kh, kw, sh, sw, ph, pw,
              sms: int = H100_SMS) -> ConvPlan:
    """The tiles and K splits of ``int8_conv2d_dequant`` (mirrors the C
    entry): M = n * Ho * Wo pixels, ``kh * kw * ceil(C / UNIT_K)`` units
    of one tap x 128 channels."""
    m = n * _out_hw(h, kh, sh, ph) * _out_hw(w, kw, sw, pw)
    return _plan(m, o, kh * kw * -(-c // UNIT_K), sms)


def grid_ctas(plan: ConvPlan, sms: int = H100_SMS) -> int:
    """The persistent grid of a call: one CTA an SM, at most one a work
    item (output tile x split)."""
    return min(plan.ctas, sms)


def _out_hw(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def matmul_supported(x_q, w_shape, act="") -> bool:
    """The JAX package's gate (int8.py:81): x_q the int8 (M, K) operand
    (anything with ``.shape`` and a torch ``.dtype``)."""
    if len(getattr(x_q, "shape", ())) != 2 or x_q.dtype != torch.int8:
        return False
    if act not in EPILOGUE_ACTS:
        return False
    k, n = w_shape
    m = x_q.shape[0]
    return x_q.shape[1] == k and k % 128 == 0 and n % 128 == 0 \
        and m % 8 == 0


def conv_supported(x_q, w_shape, stride, padding, dilation=(1, 1), groups=1,
                   act="", data_format="NHWC") -> bool:
    """The JAX package's gate (int8.py:141): x_q the int8 NHWC input,
    w_shape the OIHW filter shape."""
    if data_format != "NHWC" or len(getattr(x_q, "shape", ())) != 4:
        return False
    if x_q.dtype != torch.int8 or groups != 1 or tuple(dilation) != (1, 1):
        return False
    if act not in EPILOGUE_ACTS:
        return False
    o, c_in, kh, kw = w_shape
    n, h, w, c = x_q.shape
    if c != c_in or c % 128 or o % 128 or kh > 7 or kw > 7:
        return False
    sh, sw = stride
    ph, pw = padding
    if sh not in (1, 2) or sw not in (1, 2):
        return False
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(w, kw, sw, pw)
    if out_h <= 0 or out_w <= 0:
        return False
    vmem = ((h + 2 * ph) * (w + 2 * pw) * c + kh * kw * c * o
            + 4 * out_h * out_w * o * 2 + out_h * out_w * o * 4)
    return vmem <= VMEM_CAP_BYTES


def _epilogue(acc, scale, bias, act, out_dtype):
    """The exact sum (int32 or float64) as fp32, times scale, plus bias,
    the act, in ``out_dtype``."""
    out = acc.float() * scale.float()
    if bias is not None:
        out = out + bias.float()
    return apply_act(out, act).to(out_dtype)


def _exact(t):
    """int8 operands in a type whose sums are exact on t's device."""
    return t.to(torch.int32 if t.device.type == "cpu" else torch.float64)


def int8_matmul_dequant_plain(x_q, w_q, scale, bias=None, act="",
                              out_dtype=torch.float32):
    """``act((x_q @ w_q) * scale + bias)``, the sum exact."""
    return _epilogue(_exact(x_q) @ _exact(w_q), scale[None, :],
                     None if bias is None else bias[None, :], act, out_dtype)


def int8_conv2d_dequant_plain(x_q, w_q, scale, bias=None, stride=(1, 1),
                              padding=(0, 0), act="",
                              out_dtype=torch.float32):
    """``act(conv2d(x_q, w_q) * scale + bias)``, NHWC in and out (the
    output NHWC-contiguous, as the kernel's), the sum exact (zero padding:
    the symmetric zero point)."""
    acc = torch.nn.functional.conv2d(
        _exact(x_q).permute(0, 3, 1, 2), _exact(w_q), None, tuple(stride),
        tuple(padding)).permute(0, 2, 3, 1).contiguous()
    return _epilogue(acc, scale, bias, act, out_dtype)


def _check_common(name, x_q, w_q, scale, bias, n_out, act, out_dtype):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"{name}: x_q and w_q must be int8, got "
                         f"{x_q.dtype} and {w_q.dtype}")
    if scale.shape != (n_out,) or (bias is not None
                                   and bias.shape != (n_out,)):
        raise ValueError(f"{name}: scale and bias must be ({n_out},)")
    if act not in _ACT_CODES:
        raise ValueError(f"{name}: unsupported act {act!r}; the epilogue "
                         f"takes {EPILOGUE_ACTS}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16")
    if x_q.device.type == "cpu":
        return
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_q.device}")
    for t in (w_q, scale) + (() if bias is None else (bias,)):
        if t.device != x_q.device:
            raise ValueError(f"{name}: all tensors must be on {x_q.device}")
    for t in (scale,) + (() if bias is None else (bias,)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: scale and bias must be contiguous "
                             f"float32")
    if not x_q.is_contiguous() or x_q.data_ptr() % 16:
        raise ValueError(f"{name}: x_q must be contiguous (NHWC for the "
                         f"conv) and 16-byte aligned; the wrapper does not "
                         f"copy it")


def _entry(source, n_ints):
    """C entry of ``source``: x_q, w (K-major), scale, bias (null for
    none), out, ws (pointers), ``n_ints`` shape ints, splits, the grid, act
    and out-dtype codes, the stream."""
    fn = getattr(build.load(source), source)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * (n_ints + 4) + [P]
        fn.restype = I
    return fn


def matmul_weight(w_q):
    """The (K, N) int8 weight as the kernel's B: (N, K), K-major, kept per
    weight version (``config.cached_layout``)."""
    return config.cached_layout(w_q, "_int8_kernel_layout", lambda w: w.t())


def conv_weight(w_q):
    """The OIHW int8 filter as the kernel's B: (O, kh, kw, C), K-major, kept
    per weight version (``config.cached_layout``)."""
    return config.cached_layout(w_q, "_int8_kernel_layout",
                                lambda w: w.permute(0, 2, 3, 1))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _workspace(plan, n_out, device):
    """The int32 partial tiles of a split call, (splits, M, n_out)."""
    if plan.splits == 1:
        return None
    return torch.empty((plan.splits, plan.m, n_out), dtype=torch.int32,
                       device=device)


def int8_matmul_dequant(x_q, w_q, scale, bias=None, act="",
                        out_dtype=torch.float32):
    """The kernel on CUDA tensors, its plain version on CPU tensors.  x_q
    (M, K) int8, w_q (K, N) int8, scale fp32 (N,), bias fp32 (N,) or None."""
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"{MATMUL_KERNEL}: expected (M, K) @ (K, N), got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    m, k = x_q.shape
    n = w_q.shape[1]
    _check_common(MATMUL_KERNEL, x_q, w_q, scale, bias, n, act, out_dtype)
    if x_q.device.type == "cpu":
        return int8_matmul_dequant_plain(x_q, w_q, scale, bias, act,
                                         out_dtype)
    if k % ALIGN_K or n % BLOCK_N:
        raise ValueError(f"{MATMUL_KERNEL}: needs K % {ALIGN_K} == 0 and "
                         f"N % {BLOCK_N} == 0, got K={k}, N={n}")
    sms = _sms(x_q.device)
    plan = matmul_plan(m, n, k, sms)
    out = torch.empty((m, n), dtype=out_dtype, device=x_q.device)
    ws = _workspace(plan, n, x_q.device)
    err = _entry(MATMUL_SOURCE, 3)(
        x_q.data_ptr(), matmul_weight(w_q).data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, plan.splits,
        grid_ctas(plan, sms), _ACT_CODES[act], _OUT_CODES[out_dtype],
        torch.cuda.current_stream(x_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{MATMUL_KERNEL} launch failed: CUDA error {err}")
    config.record_call(MATMUL_KERNEL)
    return out


def int8_conv2d_dequant(x_q, w_q, scale, bias=None, stride=(1, 1),
                        padding=(0, 0), act="", out_dtype=torch.float32):
    """The kernel on CUDA tensors, its plain version on CPU tensors.  x_q
    NHWC int8, w_q OIHW int8, scale fp32 (O,), bias fp32 (O,) or None."""
    stride, padding = tuple(stride), tuple(padding)
    if x_q.dim() != 4 or w_q.dim() != 4 or x_q.shape[3] != w_q.shape[1]:
        raise ValueError(f"{CONV_KERNEL}: expected x_q NHWC and w_q OIHW "
                         f"with matching channels, got {tuple(x_q.shape)} "
                         f"and {tuple(w_q.shape)}")
    n, h, wd, c = x_q.shape
    o, _, kh, kw = w_q.shape
    (sh, sw), (ph, pw) = stride, padding
    if sh < 1 or sw < 1 or ph < 0 or pw < 0 or _out_hw(h, kh, sh, ph) < 1 \
            or _out_hw(wd, kw, sw, pw) < 1:
        raise ValueError(f"{CONV_KERNEL}: bad stride {stride} / padding "
                         f"{padding} for a {kh}x{kw} filter on {h}x{wd}")
    _check_common(CONV_KERNEL, x_q, w_q, scale, bias, o, act, out_dtype)
    if x_q.device.type == "cpu":
        return int8_conv2d_dequant_plain(x_q, w_q, scale, bias, stride,
                                         padding, act, out_dtype)
    if c % ALIGN_K or o % BLOCK_N:
        raise ValueError(f"{CONV_KERNEL}: needs C % {ALIGN_K} == 0 and "
                         f"O % {BLOCK_N} == 0, got C={c}, O={o}")
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(wd, kw, sw, pw)
    if max(ph, pw) > IM2COL_PAD_LIMIT:
        # the im2col map's corners take paddings up to the limit; pad x by
        # the rest (zeros: the symmetric zero point)
        eh, ew = max(ph - IM2COL_PAD_LIMIT, 0), max(pw - IM2COL_PAD_LIMIT, 0)
        x_q = torch.nn.functional.pad(x_q, (0, 0, ew, ew, eh, eh))
        ph, pw = ph - eh, pw - ew
        n, h, wd, c = x_q.shape
    sms = _sms(x_q.device)
    plan = conv_plan(n, h, wd, c, o, kh, kw, sh, sw, ph, pw, sms)
    out = torch.empty((n, out_h, out_w, o), dtype=out_dtype,
                      device=x_q.device)
    ws = _workspace(plan, o, x_q.device)
    err = _entry(CONV_SOURCE, 11)(
        x_q.data_ptr(), conv_weight(w_q).data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), n, h, wd, c, o, kh, kw, sh,
        sw, ph, pw, plan.splits, grid_ctas(plan, sms), _ACT_CODES[act],
        _OUT_CODES[out_dtype],
        torch.cuda.current_stream(x_q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{CONV_KERNEL} launch failed: CUDA error {err}")
    config.record_call(CONV_KERNEL)
    return out


def matmul_cost(m, n, k, out_itemsize=4) -> Tuple[float, float]:
    """(int8 operations, device bytes) of one matmul call: 2 M N K for the
    product plus the epilogue's 3 M N; x_q and w_q read once (1 byte a
    value), the output written, scale and bias read."""
    return (2.0 * m * n * k + 3.0 * m * n,
            float(m * k + k * n + m * n * out_itemsize + 8 * n))


def conv_cost(n, out_h, out_w, c, o, kh, kw, in_h, in_w,
              out_itemsize=4) -> Tuple[float, float]:
    """(int8 operations, device bytes) of one conv call (the JAX package's
    ``int8_cost`` with the output's own item size)."""
    flops = 2.0 * n * out_h * out_w * o * c * kh * kw \
        + 3.0 * n * out_h * out_w * o
    return flops, float(n * in_h * in_w * c + kh * kw * c * o
                        + n * out_h * out_w * o * out_itemsize + 8 * o)


KERNELS = (
    config.Kernel(MATMUL_KERNEL, MATMUL_SOURCE, MATMUL_REPLACES,
                  int8_matmul_dequant, int8_matmul_dequant_plain),
    config.Kernel(CONV_KERNEL, CONV_SOURCE, CONV_REPLACES,
                  int8_conv2d_dequant, int8_conv2d_dequant_plain),
)
