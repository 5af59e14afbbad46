"""Packed-layout flash attention: q/k/v in (batch, seq, heads * head_dim).

Counterpart of paddle_tpu/ops/pallas/flash_attention_packed.py.  Two kernel
sources read each head straight out of the projection layout by its column
offset, so no head transpose exists:

* ``csrc/flash_attention_packed_fwd.cu`` replaces ``_forward``: online-
  softmax attention with an additive (batch, seq) key bias, causal masking,
  in-kernel dropout, and the fp32 (batch, heads, seq) log-sum-exp;
* ``csrc/flash_attention_packed_bwd.cu`` replaces ``_backward``: dQ, dK and
  dV recomputed from the LSE, with the dropout mask replayed.

``_FlashAttentionPacked`` (a ``torch.autograd.Function``) ties the two
together on every device.  Each wrapper launches its kernel for CUDA
tensors and runs its plain version for CPU tensors; it raises for anything
else.  The plain versions repeat the kernels' arithmetic in PyTorch ops and
take the wrappers' arguments, so a caller can put one in place of the
other; the CPU tests and the on-card comparison use them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, config
from . import dropout as _dropout

KERNEL = "flash_attention_packed"
KERNEL_BWD = "flash_attention_packed_bwd"
SOURCE = "flash_attention_packed_fwd"
SOURCE_BWD = "flash_attention_packed_bwd"
REPLACES = "paddle_tpu/ops/pallas/flash_attention_packed.py:212 _forward"
REPLACES_BWD = "paddle_tpu/ops/pallas/flash_attention_packed.py:246 _backward"
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


def _check_cuda(name, head_dim, dtype, tensors):
    """What the CUDA kernels take; raises on anything else."""
    if head_dim not in (64, 128):
        raise ValueError(f"{name}: head_dim must be 64 or 128, got {head_dim}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    device = tensors[0][1].device
    for tname, t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned")


def _heads(t, num_heads):
    """(b, s, h*d) -> (b, h, s, d) in fp32 (bf16 products are exact)."""
    b, s, packed = t.shape
    return t.reshape(b, s, num_heads, packed // num_heads).transpose(
        1, 2).float()


def _packed(t, dtype):
    """(b, h, s, d) -> (b, s, h*d) in ``dtype``."""
    b, h, s, d = t.shape
    return t.to(dtype).transpose(1, 2).reshape(b, s, h * d)


def _scores(q, k, num_heads, bias, sm_scale):
    return (torch.matmul(_heads(q, num_heads),
                         _heads(k, num_heads).transpose(-1, -2)) * sm_scale
            + bias.float()[:, None, None, :])


def _keep(b, h, s, seed, rate, device):
    """The (b, h, s, s) keep mask: bh = batch * heads + head, global q/k
    positions."""
    bh = torch.arange(b * h, device=device).reshape(b, h, 1, 1)
    pos = torch.arange(s, device=device)
    return _dropout.keep_mask(seed, bh, pos[:, None], pos[None, :], rate)


def _causal(s, device):
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def flash_attention_packed_plain(q, k, v, num_heads, bias, sm_scale,
                                 causal=False, dropout_rate=0.0,
                                 seed=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A forward's arithmetic in PyTorch ops: fp32 scores of
    input-type operands, fp32 softmax statistics, l summed over the
    undropped P, P * keep / (1 - rate) rounded to the input type before the
    PV product, out = acc / max(l, 1e-30).  Returns ``(out (b, s, h*d),
    lse (b, h, s) fp32)``."""
    b, s, _ = q.shape
    scores = _scores(q, k, num_heads, bias, sm_scale)
    if causal:
        scores = scores.masked_fill(~_causal(s, q.device), NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_rate > 0.0:
        keep = _keep(b, num_heads, s, seed, dropout_rate, q.device)
        p = torch.where(keep, p * _dropout.keep_scale(dropout_rate), 0.0)
    acc = torch.matmul(p.to(q.dtype).float(), _heads(v, num_heads))
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return _packed(acc / l_safe, q.dtype), lse


def flash_attention_packed_bwd_plain(q, k, v, bias, out, lse, dout,
                                     num_heads, sm_scale, causal=False,
                                     dropout_rate=0.0, seed=0):
    """Kernel A backward's arithmetic: P = exp(s - lse) unrounded; dV from
    the dropped P rounded to dO's type; dP = dO V^T in fp32, dropped and
    scaled; delta = rowsum(dO * O) in fp32; dS = P (dP - delta) sm_scale,
    rounded to the input type for dK and dQ.  Returns ``(dq, dk, dv)``."""
    b, s, _ = q.shape
    p = torch.exp(_scores(q, k, num_heads, bias, sm_scale)
                  - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal(s, q.device), 0.0)
    do4 = _heads(dout, num_heads)
    dp = torch.matmul(do4, _heads(v, num_heads).transpose(-1, -2))
    p_d = p
    if dropout_rate > 0.0:
        keep = _keep(b, num_heads, s, seed, dropout_rate, q.device)
        scale = _dropout.keep_scale(dropout_rate)
        p_d = torch.where(keep, p * scale, 0.0)
        dp = torch.where(keep, dp * scale, 0.0)
    delta = (do4 * _heads(out, num_heads)).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
    dv = torch.matmul(p_d.to(dout.dtype).float().transpose(-1, -2), do4)
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, num_heads))
    dq = torch.matmul(ds, _heads(k, num_heads))
    return _packed(dq, q.dtype), _packed(dk, k.dtype), _packed(dv, v.dtype)


def _dropout_args(dropout_rate, seed):
    rate = _dropout.check_rate(dropout_rate)
    if rate == 0.0:
        return [0, 0, 1.0, 0]
    return [_dropout.seed_bits(seed), _dropout.threshold(rate),
            _dropout.keep_scale(rate), 1]


def flash_attention_packed_fwd(q, k, v, num_heads, bias, sm_scale,
                               causal=False, dropout_rate=0.0,
                               seed=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A forward: ``(out, lse)`` of packed attention.  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    _check(q, k, v, num_heads, bias)
    _dropout.check_rate(dropout_rate)
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, num_heads, bias,
                                            sm_scale, causal, dropout_rate,
                                            seed)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: unsupported device {q.device}")
    b, s, packed = q.shape
    hd = packed // num_heads
    _check_cuda(KERNEL, hd, q.dtype,
                (("q", q), ("k", k), ("v", v), ("bias", bias)))
    drop = _dropout_args(dropout_rate, seed)
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32,
                      device=q.device)
    err = _entry(SOURCE, 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, s, num_heads, hd, float(sm_scale),
        int(bool(causal)), *drop, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {err}")
    config.record_call(KERNEL)
    return out, lse


def flash_attention_packed_bwd(q, k, v, bias, out, lse, dout, num_heads,
                               sm_scale, causal=False, dropout_rate=0.0,
                               seed=0):
    """Kernel A backward: ``(dq, dk, dv)``.  CUDA tensors launch the
    kernels (a delta pre-pass, dK/dV over key tiles, dQ over query tiles);
    CPU tensors run the plain version."""
    _check(q, k, v, num_heads, bias)
    _dropout.check_rate(dropout_rate)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{KERNEL_BWD}: {name} must match q in shape "
                             f"and dtype")
    b, s, packed = q.shape
    if lse.shape != (b, num_heads, s) or lse.dtype != torch.float32:
        raise ValueError(f"{KERNEL_BWD}: lse must be float32 "
                         f"({b}, {num_heads}, {s})")
    if q.device.type == "cpu":
        return flash_attention_packed_bwd_plain(
            q, k, v, bias, out, lse, dout, num_heads, sm_scale, causal,
            dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL_BWD}: unsupported device {q.device}")
    hd = packed // num_heads
    _check_cuda(KERNEL_BWD, hd, q.dtype,
                (("q", q), ("k", k), ("v", v), ("bias", bias), ("out", out),
                 ("lse", lse), ("dout", dout)))
    drop = _dropout_args(dropout_rate, seed)
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = _entry(SOURCE_BWD, 11)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, num_heads, hd,
        float(sm_scale), int(bool(causal)), *drop, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{KERNEL_BWD} launch failed: CUDA error {err}")
    config.record_call(KERNEL_BWD)
    return dq, dk, dv


def _entry(source, n_pointers):
    """The C entry of ``source`` (named as the source): ``n_pointers``
    pointers, then batch, seq, heads, head_dim, sm_scale, causal, seed,
    threshold, keep_scale, dropout, dtype and the stream."""
    fn = getattr(build.load(source), source)
    if fn.argtypes is None:
        P, I, U, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                      ctypes.c_float)
        fn.argtypes = [P] * n_pointers + [I, I, I, I, F, I, U, U, F, I, I, P]
        fn.restype = I
    return fn


class _FlashAttentionPacked(torch.autograd.Function):
    """Kernel A forward and backward as one differentiable op.  The bias
    gets no gradient (it is a padding mask); the seed and rate ride on the
    context so the backward replays the forward's mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, sm_scale, causal,
                dropout_rate, seed):
        out, lse = flash_attention_packed_fwd(q, k, v, num_heads, bias,
                                              sm_scale, causal, dropout_rate,
                                              seed)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (num_heads, sm_scale, causal, dropout_rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_packed_bwd(q, k, v, bias, out, lse,
                                                dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_packed(q, k, v, num_heads, bias=None,
                           sm_scale: Optional[float] = None, causal=False,
                           dropout_rate=0.0, seed: Optional[int] = None):
    """Flash attention over packed (batch, seq, heads*head_dim) inputs with
    an additive (batch, seq) key bias; returns (batch, seq, heads*head_dim).
    Same contract as the JAX function: ``seed`` (an int32, 0 when None)
    drives the in-kernel dropout.  Differentiable through
    ``_FlashAttentionPacked``; without autograd the forward runs alone."""
    b, s, packed = q.shape
    if packed % num_heads:
        raise ValueError(f"packed width {packed} not divisible by "
                         f"num_heads {num_heads}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(packed // num_heads)
    if bias is None:
        bias = torch.zeros((b, s), dtype=torch.float32, device=q.device)
    else:
        bias = bias.detach().to(torch.float32).expand(b, s).contiguous()
    args = (num_heads, float(sm_scale), bool(causal), float(dropout_rate),
            0 if seed is None else int(seed))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttentionPacked.apply(q, k, v, bias, *args)
    out, _ = flash_attention_packed_fwd(q, k, v, args[0], bias, *args[1:])
    return out


KERNELS = (
    config.Kernel(KERNEL, SOURCE, REPLACES, flash_attention_packed_fwd,
                  flash_attention_packed_plain),
    config.Kernel(KERNEL_BWD, SOURCE_BWD, REPLACES_BWD,
                  flash_attention_packed_bwd,
                  flash_attention_packed_bwd_plain),
)
