"""Packed-layout flash attention: q/k/v in (batch, seq, heads * head_dim).

Counterpart of paddle_tpu/ops/pallas/flash_attention_packed.py.  The kernel
(``csrc/flash_attention_packed_fwd.cu``) reads each head straight out of the
projection layout by its column offset, so no head transpose exists; it
replaces the Pallas ``_forward`` (the forward only: the backward and the
in-kernel dropout come with the training slice).

``flash_attention_packed_fwd`` launches the kernel for CUDA tensors and runs
``flash_attention_packed_plain`` for CPU tensors; it raises for anything
else.  The plain version repeats the kernel's arithmetic in PyTorch ops and
is what the CPU tests and the on-card comparison use.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, config

KERNEL = "flash_attention_packed"
SOURCE = "flash_attention_packed_fwd"
REPLACES = "paddle_tpu/ops/pallas/flash_attention_packed.py:212 _forward"
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def head_layout_ok(num_heads: int, head_dim: int) -> bool:
    """The packed path's head layouts: 64-wide heads in an even count, or
    128-wide heads (the JAX package's 128-lane groups)."""
    return (head_dim == 64 and num_heads % 2 == 0) or head_dim == 128


def _check(q, k, v, num_heads, bias):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (batch, seq, heads*dim) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, packed = q.shape
    if packed % num_heads:
        raise ValueError(f"packed width {packed} not divisible by "
                         f"num_heads {num_heads}")
    if bias.shape != (b, s) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 ({b}, {s}), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")


def flash_attention_packed_plain(q, k, v, num_heads, bias, sm_scale,
                                 causal=False) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """The kernel's arithmetic in PyTorch ops: split heads, fp32 scores of
    input-type operands, fp32 softmax statistics, P rounded to the input
    type before the PV product, out = acc / max(l, 1e-30).  Returns
    ``(out (b, s, h*d), lse (b, h, s) fp32)``."""
    b, s, packed = q.shape
    hd = packed // num_heads

    def heads(t):  # (b, s, h*d) -> (b, h, s, d) in fp32: bf16 products are exact
        return t.reshape(b, s, num_heads, hd).transpose(1, 2).float()

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * sm_scale
    scores = scores + bias.float()[:, None, None, :]
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(q.dtype).float(), heads(v))
    out = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.transpose(1, 2).reshape(b, s, packed), lse


def flash_attention_packed_fwd(q, k, v, num_heads, bias, sm_scale,
                               causal=False) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Kernel A: ``(out, lse)`` of packed attention.  CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    _check(q, k, v, num_heads, bias)
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, num_heads, bias,
                                            sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {q.device}")
    b, s, packed = q.shape
    hd = packed // num_heads
    if hd not in (64, 128):
        raise ValueError(f"{KERNEL}: head_dim must be 64 or 128, got {hd}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{KERNEL}: dtype must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{KERNEL}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{KERNEL}: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32,
                      device=q.device)
    fn = _entry()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
             out.data_ptr(), lse.data_ptr(), b, s, num_heads, hd,
             float(sm_scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    config.record_call(KERNEL)
    return out, lse


def _entry():
    fn = build.load(SOURCE).flash_attention_packed_fwd
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, ctypes.c_float, I, I, P]
        fn.restype = I
    return fn


def flash_attention_packed(q, k, v, num_heads, bias=None,
                           sm_scale: Optional[float] = None, causal=False,
                           dropout_rate=0.0, seed=None):
    """Flash attention over packed (batch, seq, heads*head_dim) inputs with
    an additive (batch, seq) key bias; returns (batch, seq, heads*head_dim).
    Same contract as the JAX function; dropout waits for the training
    slice."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash_attention_packed: in-kernel dropout comes with the "
            "training slice (ROADMAP.md, Queue 1 slice 2)")
    b, s, packed = q.shape
    if packed % num_heads:
        raise ValueError(f"packed width {packed} not divisible by "
                         f"num_heads {num_heads}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(packed // num_heads)
    if bias is None:
        bias = torch.zeros((b, s), dtype=torch.float32, device=q.device)
    else:
        bias = bias.to(torch.float32).expand(b, s).contiguous()
    out, _ = flash_attention_packed_fwd(q, k, v, num_heads, bias, sm_scale,
                                        causal)
    return out


KERNELS = (config.Kernel(KERNEL, SOURCE, REPLACES, flash_attention_packed_fwd,
                         flash_attention_packed_plain),)
