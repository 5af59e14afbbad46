"""Fused conv + per-channel epilogue (inference).

Counterpart of paddle_tpu/ops/pallas/conv_fused.py ``conv2d_bn_act``
(row 10 of the table of TPU kernels)::

    out = act(conv2d(x, w) * a + b)

with x NHWC (fp32 or bf16), w OIHW, a and b fp32 ``(O,)`` (the folded
inference BatchNorm of ``nn.functional.norm.bn_inference_scale_bias``, or
``a = 1`` and ``b`` = a conv bias), the sum in fp32 and the output NHWC in
x's dtype.  One kernel source, ``csrc/conv2d_bn_act.cu``: an implicit GEMM
over output pixels x output channels x (taps, C), bf16 on ``mma.sync``,
fp32 on FMAs, zero padding by bounds checks.

``supported()`` is the JAX package's shape gate, VMEM cap included, so the
same ops take the kernel in both packages; the dispatch site
(``static/ops_fused.py``) applies it.  The wrapper launches the kernel on
CUDA tensors (NHWC-contiguous x, C % 32 == 0, O % 128 == 0, w in x's
dtype) or raises, and runs ``conv2d_bn_act_plain`` on CPU tensors.  The
wrapper transposes w to (kh, kw, C, O) per call, as the JAX wrapper does.

The JAX function has no VJP, so neither has this one: a call with grad
enabled on an input that requires grad raises.  The training-mode
kernels (``_batch_stats``, ``scale_act``) are in ``bn_act_train.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

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
BLOCK_N = 128      # output channels per CTA
BLOCK_K_BYTES = 64  # channel bytes per K tile (C % 32 serves both dtypes)


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
    bk = BLOCK_K_BYTES // _ITEMSIZE[x.dtype]
    if c % bk or o % BLOCK_N:
        raise ValueError(f"{KERNEL}: needs C % {bk} == 0 and O % {BLOCK_N} "
                         f"== 0, got C={c}, O={o}")
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
    """C entry: x, wk, a, b, out (pointers), n, h, w, c, o, kh, kw, sh, sw,
    ph, pw, act code, dtype code (int), the stream."""
    fn = build.load(SOURCE).conv2d_bn_act
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 13 + [P]
        fn.restype = I
    return fn


def conv2d_bn_act(x, w, a, b, stride=(1, 1), padding=(0, 0), act=""):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    stride, padding = tuple(stride), tuple(padding)
    _check(x, w, a, b, stride, padding, act)
    if x.device.type == "cpu":
        return conv2d_bn_act_plain(x, w, a, b, stride, padding, act)
    n, h, wd, c = x.shape
    o, _, kh, kw = w.shape
    out_h = _out_hw(h, kh, stride[0], padding[0])
    out_w = _out_hw(wd, kw, stride[1], padding[1])
    wk = w.permute(2, 3, 1, 0).contiguous()  # (kh, kw, C, O)
    out = torch.empty((n, out_h, out_w, o), dtype=x.dtype, device=x.device)
    err = _entry()(
        x.data_ptr(), wk.data_ptr(), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), n, h, wd, c, o, kh, kw, stride[0], stride[1],
        padding[0], padding[1], _ACT_CODES[act], _DTYPE_CODES[x.dtype],
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
