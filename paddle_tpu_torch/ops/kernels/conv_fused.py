"""Fused conv + per-channel epilogue (inference).

Counterpart of paddle_tpu/ops/pallas/conv_fused.py ``conv2d_bn_act``
(row 10 of the table of TPU kernels)::

    out = act(conv2d(x, w) * a + b)

with x NHWC (fp32 or bf16), w OIHW, a and b fp32 ``(O,)`` (the folded
inference BatchNorm of ``nn.functional.norm.bn_inference_scale_bias``, or
``a = 1`` and ``b`` = a conv bias), the sum in fp32 and the output NHWC in
x's dtype.  One kernel source, ``csrc/conv2d_bn_act.cu``: an implicit GEMM
over output pixels x output channels x (taps, C), bf16 on ``wgmma`` with
TMA im2col loads, fp32 on FMAs, zero padding from the loads, and K split
across CTAs where the output tiles alone do not fill the card
(``conv_plan``).

``supported()`` is the JAX package's shape gate, VMEM cap included, so the
same ops take the kernel in both packages; the dispatch site
(``static/ops_fused.py``) applies it.  The wrapper launches the kernel on
CUDA tensors (NHWC-contiguous x, C % 64 == 0, O % 128 == 0, w in x's
dtype) or raises, and runs ``conv2d_bn_act_plain`` on CPU tensors.  It
lays the filter out for the kernel once per weight tensor and version
(bf16 ``(O, kh, kw, C)``, fp32 ``(kh, kw, C, O)``) and keeps that copy
while the weight lives.

The JAX function has no VJP, so neither has this one: a call with grad
enabled on an input that requires grad raises.  The training-mode
kernels (``_batch_stats``, ``scale_act``) are in ``bn_act_train.py``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build, config

SOURCE = "conv2d_bn_act"
KERNEL = "conv2d_bn_act"
REPLACES = "paddle_tpu/ops/pallas/conv_fused.py:152 conv2d_bn_act"

# Per-image VMEM budget of the TPU kernel (input + filter + fp32
# accumulator + output).  Not a limit of the CUDA kernel: it is part of the
# JAX dispatch rule, kept so the same ops take the kernel in both packages.
VMEM_CAP_BYTES = 12 * 1024 * 1024

# Activations the epilogue applies, as in the JAX kernel (gelu is erf).
EPILOGUE_ACTS = ("", "relu", "relu6", "sigmoid", "tanh", "gelu", "silu",
                 "swish")
_ACT_CODES = {"": 0, "relu": 1, "relu6": 2, "sigmoid": 3, "tanh": 4,
              "gelu": 5, "silu": 6, "swish": 6}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
BLOCK_N = 128       # output channels per CTA, both dtypes
BLOCK_M = {torch.bfloat16: 128, torch.float32: 64}  # output pixels per CTA
UNIT_C = 64         # channels of one K unit (one tap x 64 channels)
H100_SMS = 132
MAX_SPLITS = 16
# CTAs an SM runs at once: one 384-thread wgmma CTA (166 KB of shared
# memory); three 128-thread FMA CTAs (167 registers a thread).
CTAS_PER_SM = {torch.bfloat16: 1, torch.float32: 3}
# K units a split sums at least.  A split costs a second launch and an
# fp32 partial tile written and read back; below these a CTA spends longer
# on that than on its share of the sum (the 1x1 s2 256->512 conv at 8x8, 4
# units: 2 bf16 or 4 fp32 splits were slower than none on the card).
MIN_SPLIT_UNITS = {torch.bfloat16: 8, torch.float32: 4}
# Largest zero padding the bf16 kernel's im2col tensor map takes (its
# bounding-box corners lie in [-128, 127]); the wrapper pads x itself by
# the excess beyond it.
IM2COL_PAD_LIMIT = 127


class ConvPlan(NamedTuple):
    """The kernel's grid for one call: ``block_m`` pixels x ``block_n``
    channels a CTA, ``units`` K units of one tap x ``UNIT_C`` channels,
    split over ``splits`` CTAs per output tile (grid z)."""
    block_m: int
    block_n: int
    m: int
    tiles: int
    units: int
    splits: int

    @property
    def ctas(self) -> int:
        return self.tiles * self.splits

    def split_units(self, split: int) -> Tuple[int, int]:
        """The K units [u0, u1) split ``split`` sums (as the kernel)."""
        return (split * self.units // self.splits,
                (split + 1) * self.units // self.splits)


def conv_plan(n, h, w, c, o, kh, kw, sh, sw, ph, pw, dtype,
              sms: int = H100_SMS) -> ConvPlan:
    """The tiles and K splits of ``conv2d_bn_act`` (mirrors the C entry).
    Where the output tiles alone give fewer than ``sms`` CTAs, K is split
    into as many parts as one wave holds (``sms * CTAS_PER_SM[dtype]``
    CTAs), up to ``MAX_SPLITS`` and ``MIN_SPLIT_UNITS[dtype]`` K units a
    split.  Never more than a wave: a second, nearly empty wave costs a
    whole CTA's time (VGG's 2x2 bf16 layer: 9 splits, 144 CTAs, were
    slower than 4 on the card)."""
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(w, kw, sw, pw)
    m = n * out_h * out_w
    bm = BLOCK_M[dtype]
    tiles = -(-m // bm) * (o // BLOCK_N)
    units = kh * kw * (c // UNIT_C)
    wave = sms * CTAS_PER_SM[dtype]
    most = min(MAX_SPLITS, units // MIN_SPLIT_UNITS[dtype])
    splits = 1 if tiles >= sms else min(most, wave // tiles)
    return ConvPlan(bm, BLOCK_N, m, tiles, units, max(splits, 1))


def _out_hw(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def apply_act(out, act):
    """The epilogue's activation on an fp32 tensor."""
    if act == "relu":
        return torch.relu(out)
    if act == "relu6":
        return torch.clamp(out, 0.0, 6.0)
    if act == "sigmoid":
        return torch.sigmoid(out)
    if act == "tanh":
        return torch.tanh(out)
    if act == "gelu":
        return torch.nn.functional.gelu(out, approximate="none")
    if act in ("silu", "swish"):
        return torch.nn.functional.silu(out)
    return out


def _conv_vmem_bytes(hp, wp, c, kh, kw, o, out_h, out_w, itemsize) -> int:
    return (hp * wp * c * 4
            + kh * kw * c * o * itemsize
            + 2 * out_h * out_w * o * 4
            + out_h * out_w * o * itemsize)


def supported(x, w_shape, stride, padding, dilation=(1, 1), groups=1,
              act="", data_format="NHWC") -> bool:
    """The JAX package's gate for ``conv2d_bn_act`` (conv_fused.py:122):
    x is the NHWC input (anything with ``.shape`` and ``.dtype``, a torch
    dtype), w_shape the OIHW filter shape."""
    if data_format != "NHWC" or len(getattr(x, "shape", ())) != 4:
        return False
    if groups != 1 or tuple(dilation) != (1, 1):
        return False
    if act not in EPILOGUE_ACTS:
        return False
    if x.dtype not in _DTYPE_CODES:
        return False
    o, c_in, kh, kw = w_shape
    n, h, w, c = x.shape
    if c != c_in or c % 128 or o % 128:
        return False
    if kh > 7 or kw > 7:
        return False
    sh, sw = stride
    ph, pw = padding
    if sh not in (1, 2) or sw not in (1, 2):
        return False
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(w, kw, sw, pw)
    if out_h <= 0 or out_w <= 0:
        return False
    vmem = _conv_vmem_bytes(h + 2 * ph, w + 2 * pw, c, kh, kw, o, out_h,
                            out_w, _ITEMSIZE[x.dtype])
    return vmem <= VMEM_CAP_BYTES


def conv2d_bn_act_plain(x, w, a, b, stride=(1, 1), padding=(0, 0), act=""):
    """The TPU kernel's arithmetic: the zero-padded fp32 image, a loop over
    the kh x kw taps of ``(pixels, C) @ (C, O)`` products summed in fp32,
    then ``act(acc * a + b)`` in fp32, cast to x's dtype."""
    n, h, wd, c = x.shape
    o, _, kh, kw = w.shape
    sh, sw = stride
    ph, pw = padding
    out_h, out_w = _out_hw(h, kh, sh, ph), _out_hw(wd, kw, sw, pw)
    xp = torch.nn.functional.pad(x.float(), (0, 0, pw, pw, ph, ph))
    wk = w.float().permute(2, 3, 1, 0)  # (kh, kw, C, O)
    acc = torch.zeros(n * out_h * out_w, o, dtype=torch.float32,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + (out_h - 1) * sh + 1:sh,
                     j:j + (out_w - 1) * sw + 1:sw, :]
            acc = acc + win.reshape(-1, c) @ wk[i, j]
    out = apply_act(acc * a.float()[None, :] + b.float()[None, :], act)
    return out.reshape(n, out_h, out_w, o).to(x.dtype)


def _no_grad_check(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward (nor has the TPU kernel it replaces); "
            f"the training-mode fused conv runs the library conv and "
            f"bn_act_train.fused_bn_act_train")


def _check(x, w, a, b, stride, padding, act):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{KERNEL}: expected x NHWC and w OIHW, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c = x.shape
    o, c_in, kh, kw = w.shape
    if c_in != c:
        raise ValueError(f"{KERNEL}: x has {c} channels, w expects {c_in}")
    if a.shape != (o,) or b.shape != (o,):
        raise ValueError(f"{KERNEL}: a and b must be ({o},)")
    if act not in _ACT_CODES:
        raise ValueError(f"{KERNEL}: unsupported act {act!r}; the epilogue "
                         f"takes {EPILOGUE_ACTS}")
    sh, sw = stride
    ph, pw = padding
    if sh < 1 or sw < 1 or ph < 0 or pw < 0 or _out_hw(h, kh, sh, ph) < 1 \
            or _out_hw(wd, kw, sw, pw) < 1:
        raise ValueError(f"{KERNEL}: bad stride {stride} / padding "
                         f"{padding} for a {kh}x{kw} filter on {h}x{wd}")
    _no_grad_check(KERNEL, x, w, a, b)
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"{KERNEL}: x must be float32 or bfloat16 and w of "
                         f"the same dtype, got {x.dtype} and {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"{KERNEL}: a and b must be float32")
    if c % UNIT_C or o % BLOCK_N:
        raise ValueError(f"{KERNEL}: needs C % {UNIT_C} == 0 and O % "
                         f"{BLOCK_N} == 0, got C={c}, O={o}")
    for t in (w, a, b):
        if t.device != x.device:
            raise ValueError(f"{KERNEL}: all tensors must be on {x.device}")
    for t in (x, a, b):
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: x (NHWC), a and b must be "
                             f"contiguous; the wrapper does not copy them")
    if x.data_ptr() % 16:
        raise ValueError(f"{KERNEL}: x must be 16-byte aligned")


def _entry():
    """C entry: x, wk, a, b, out, ws (pointers), n, h, w, c, o, kh, kw, sh,
    sw, ph, pw, splits, act code, dtype code (int), the stream."""
    fn = build.load(SOURCE).conv2d_bn_act
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 14 + [P]
        fn.restype = I
    return fn


def kernel_filter(w):
    """The OIHW filter in the kernel's layout: bf16 (O, kh, kw, C), fp32
    (kh, kw, C, O).  Made once per weight version and storage, and kept on
    the weight tensor itself, so it lives as long as the weight."""
    hit = getattr(w, "_conv2d_bn_act_layout", None)
    if hit is not None and hit[0] == (w._version, w.data_ptr()):
        return hit[1]
    perm = (0, 2, 3, 1) if w.dtype == torch.bfloat16 else (2, 3, 1, 0)
    wk = w.detach().permute(*perm).contiguous()
    w._conv2d_bn_act_layout = ((w._version, w.data_ptr()), wk)
    return wk


def conv2d_bn_act(x, w, a, b, stride=(1, 1), padding=(0, 0), act=""):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    stride, padding = tuple(stride), tuple(padding)
    _check(x, w, a, b, stride, padding, act)
    if x.device.type == "cpu":
        return conv2d_bn_act_plain(x, w, a, b, stride, padding, act)
    o, _, kh, kw = w.shape
    ph, pw = padding
    if x.dtype == torch.bfloat16 and max(ph, pw) > IM2COL_PAD_LIMIT:
        eh, ew = max(ph - IM2COL_PAD_LIMIT, 0), max(pw - IM2COL_PAD_LIMIT, 0)
        x = torch.nn.functional.pad(x, (0, 0, ew, ew, eh, eh))
        ph, pw = ph - eh, pw - ew
    n, h, wd, c = x.shape
    out_h = _out_hw(h, kh, stride[0], ph)
    out_w = _out_hw(wd, kw, stride[1], pw)
    plan = conv_plan(n, h, wd, c, o, kh, kw, stride[0], stride[1], ph, pw,
                     x.dtype, torch.cuda.get_device_properties(
                         x.device).multi_processor_count)
    out = torch.empty((n, out_h, out_w, o), dtype=x.dtype, device=x.device)
    ws = (torch.empty((plan.splits, plan.m, o), dtype=torch.float32,
                      device=x.device) if plan.splits > 1 else None)
    err = _entry()(
        x.data_ptr(), kernel_filter(w).data_ptr(), a.data_ptr(),
        b.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        n, h, wd, c, o, kh, kw, stride[0], stride[1], ph, pw, plan.splits,
        _ACT_CODES[act], _DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    config.record_call(KERNEL)
    return out


def conv_cost(n, out_h, out_w, c, o, kh, kw, itemsize=4,
              in_h=None, in_w=None) -> Tuple[float, float]:
    """(flops, device bytes) of one call, the JAX package's cost model:
    the products and the epilogue's mul / add / act; x read, the output
    written and the filter read once each, a and b in fp32."""
    flops = 2.0 * n * out_h * out_w * o * c * kh * kw \
        + 3.0 * n * out_h * out_w * o
    in_h = in_h if in_h is not None else out_h
    in_w = in_w if in_w is not None else out_w
    bytes_ = (n * in_h * in_w * c + n * out_h * out_w * o
              + kh * kw * c * o) * itemsize + 2 * o * 4
    return flops, bytes_


KERNELS = (
    config.Kernel(KERNEL, SOURCE, REPLACES, conv2d_bn_act,
                  conv2d_bn_act_plain),
)
