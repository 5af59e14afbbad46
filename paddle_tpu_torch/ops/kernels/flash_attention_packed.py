"""Packed-layout flash attention: q/k/v in (batch, seq, heads * head_dim).

Counterpart of paddle_tpu/ops/pallas/flash_attention_packed.py.  The packed
layout is the (batch, heads, seq, head_dim) kernels' own input seen through
other strides: the (b, h, s, d) view of a (b, s, h*d) projection output is
``reshape(b, s, h, d).transpose(1, 2)``, which the kernels of
``flash_attention.py`` read in place, so no head transpose exists.  So

* ``csrc/flash_attention_packed_fwd.cu`` replaces ``_forward``: online-
  softmax attention with an additive (batch, seq) key bias, causal masking,
  in-kernel dropout, and the fp32 (batch, heads, seq) log-sum-exp;
* ``csrc/flash_attention_packed_bwd.cu`` replaces ``_backward``: dQ, dK and
  dV recomputed from the LSE, with the dropout mask replayed.

The packed wrappers take the JAX packed kernel's head layouts (64-wide heads
in an even count, or 128-wide heads) on CUDA and raise on the others, which
the split-head route serves.  They are the (b, h, s, d) wrappers on the
heads' views with their launches counted under this module's names, and
``flash_attention_packed`` differentiates through the same
``flash_attention._FlashAttention``.  Each wrapper launches its kernel for
CUDA tensors and runs its plain version for CPU tensors; it raises for
anything else.  The plain versions repeat the kernels' arithmetic in
PyTorch ops and take the wrappers' arguments, so a caller can put one in
place of the other; the CPU tests and the on-card comparison use them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import config
from . import flash_attention as _fa

KERNEL = "flash_attention_packed"
KERNEL_BWD = "flash_attention_packed_bwd"
SOURCE = _fa.SOURCE
SOURCE_BWD = _fa.SOURCE_BWD
REPLACES = "paddle_tpu/ops/pallas/flash_attention_packed.py:212 _forward"
REPLACES_BWD = "paddle_tpu/ops/pallas/flash_attention_packed.py:246 _backward"


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
    if bias is not None and (bias.shape != (b, s)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be float32 ({b}, {s}), got "
                         f"{bias.dtype} {tuple(bias.shape)}")


def _check_layout(name, num_heads, head_dim):
    """The packed kernel takes the JAX packed kernel's head layouts only;
    the others are served by the (batch, heads, seq, head_dim) kernel."""
    if not head_layout_ok(num_heads, head_dim):
        raise ValueError(
            f"{name}: the packed kernel takes 64-wide heads in an even count "
            f"or 128-wide heads, got {num_heads} heads of {head_dim}; this "
            f"layout is served by the split-head route: "
            f"ops.attention.flash_attention on (batch, heads, seq, "
            f"head_dim), the kernel of ops/kernels/flash_attention.py, which "
            f"MultiHeadAttention takes when flash_attention_packed returns "
            f"None")


def _refuse_off_cpu(name, q, num_heads):
    """Off the CPU, raise for a head layout the packed kernel refuses."""
    if q.device.type != "cpu":
        _check_layout(name, num_heads, q.shape[2] // num_heads)


def _heads(t, num_heads):
    """(b, s, h*d) -> the (b, h, s, d) view."""
    b, s, packed = t.shape
    return t.reshape(b, s, num_heads, packed // num_heads).transpose(1, 2)


def _packed(t, dtype):
    """(b, h, s, d) -> (b, s, h*d) in ``dtype``: a view when ``t`` is in
    the packed layout and type already, as the kernels' outputs are."""
    b, h, s, d = t.shape
    return t.to(dtype).transpose(1, 2).reshape(b, s, h * d)


def flash_attention_packed_plain(q, k, v, num_heads, bias, sm_scale,
                                 causal=False, dropout_rate=0.0,
                                 seed=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A forward's arithmetic in PyTorch ops on the heads' views
    (``flash_attention.attention_fwd_math``): fp32 scores of input-type
    operands, fp32 softmax statistics, l summed over the undropped P,
    P * keep / (1 - rate) rounded to the input type before the PV product,
    out = acc / max(l, 1e-30).  Returns ``(out (b, s, h*d), lse (b, h, s)
    fp32)``."""
    out, lse = _fa.attention_fwd_math(
        _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        bias, sm_scale, causal, dropout_rate, seed)
    return _packed(out, q.dtype), lse


def flash_attention_packed_bwd_plain(q, k, v, bias, out, lse, dout,
                                     num_heads, sm_scale, causal=False,
                                     dropout_rate=0.0, seed=0):
    """Kernel A backward's arithmetic (``flash_attention.attention_bwd_
    math``): P = exp(s - lse) unrounded; dV from the dropped P rounded to
    dO's type; dP = dO V^T in fp32, dropped and scaled; delta = rowsum(dO *
    O) in fp32; dS = P (dP - delta) sm_scale, rounded to the input type for
    dK and dQ.  Returns ``(dq, dk, dv)``."""
    dq, dk, dv = _fa.attention_bwd_math(
        *(_heads(t, num_heads) for t in (q, k, v)), bias,
        _heads(out, num_heads), lse, _heads(dout, num_heads), sm_scale,
        causal, dropout_rate, seed)
    return _packed(dq, q.dtype), _packed(dk, k.dtype), _packed(dv, v.dtype)


def flash_attention_packed_fwd(q, k, v, num_heads, bias, sm_scale,
                               causal=False, dropout_rate=0.0,
                               seed=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A forward: ``(out, lse)`` of packed attention, the (b, h, s,
    d) wrapper on the heads' views with its launches counted as ``KERNEL``.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    _check(q, k, v, num_heads, bias)
    _refuse_off_cpu(KERNEL, q, num_heads)
    out, lse = _fa.flash_attention_fwd(
        *(_heads(t, num_heads) for t in (q, k, v)), bias, sm_scale, causal,
        dropout_rate, seed, name=KERNEL)
    return _packed(out, q.dtype), lse


def flash_attention_packed_bwd(q, k, v, bias, out, lse, dout, num_heads,
                               sm_scale, causal=False, dropout_rate=0.0,
                               seed=0):
    """Kernel A backward: ``(dq, dk, dv)``, the (b, h, s, d) wrapper on the
    heads' views counted as ``KERNEL_BWD``.  CUDA tensors launch the
    kernels (a delta pre-pass, dK/dV over key tiles, dQ over query tiles);
    CPU tensors run the plain version."""
    _check(q, k, v, num_heads, bias)
    _refuse_off_cpu(KERNEL_BWD, q, num_heads)
    grads = _fa.flash_attention_bwd(
        *(_heads(t, num_heads) for t in (q, k, v)), bias,
        _heads(out, num_heads), lse, _heads(dout, num_heads), sm_scale,
        causal, dropout_rate, seed, name=KERNEL_BWD)
    return tuple(_packed(g, q.dtype) for g in grads)


def flash_attention_packed(q, k, v, num_heads, bias=None,
                           sm_scale: Optional[float] = None, causal=False,
                           dropout_rate=0.0, seed: Optional[int] = None):
    """Flash attention over packed (batch, seq, heads*head_dim) inputs with
    an additive (batch, seq) key bias; returns (batch, seq, heads*head_dim).
    Same contract as the JAX function: ``seed`` (an int32, 0 when None)
    drives the in-kernel dropout.  ``flash_attention.flash_attention`` on
    the heads' views with kernel A's launch counters: differentiable
    through its ``_FlashAttention``; without autograd the forward runs
    alone."""
    _check(q, k, v, num_heads, None)
    _refuse_off_cpu(KERNEL, q, num_heads)
    out = _fa.flash_attention(*(_heads(t, num_heads) for t in (q, k, v)),
                              bias=bias, sm_scale=sm_scale, causal=causal,
                              dropout_rate=dropout_rate, seed=seed,
                              names=(KERNEL, KERNEL_BWD))
    return _packed(out, q.dtype)


KERNELS = (
    config.Kernel(KERNEL, SOURCE, REPLACES, flash_attention_packed_fwd,
                  flash_attention_packed_plain),
    config.Kernel(KERNEL_BWD, SOURCE_BWD, REPLACES_BWD,
                  flash_attention_packed_bwd,
                  flash_attention_packed_bwd_plain),
)
