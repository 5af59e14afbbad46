"""Flash attention over (batch, heads, seq, head_dim) inputs.

Counterpart of paddle_tpu/ops/pallas/flash_attention.py (``_flash_forward``
and ``_flash_backward``), the kernel behind ``ops.attention.flash_attention``
and ``MultiHeadAttention``'s split-head route.  The CUDA sources are those of
the packed kernel (``flash_attention_packed.py``): both layouts are one
function of q, k, v that differs only in the (batch, head, row) strides the
C entries take, so

* ``csrc/flash_attention_packed_fwd.cu`` replaces ``_flash_forward`` too:
  online-softmax attention with an additive fp32 (batch, seq) key bias,
  causal masking, in-kernel dropout and the fp32 (batch, heads, seq)
  log-sum-exp, for head widths 64, 128, 192 and 256;
* ``csrc/flash_attention_packed_bwd.cu`` replaces ``_flash_backward``: the
  delta pre-pass, then dK/dV over key tiles and dQ over query tiles,
  recomputed from the LSE with the dropout mask replayed.

The wrappers pass each operand's own strides, so the split-head route's
transposed views of the (b, s, h*d) projections go to the kernels as they
are, and the packed wrappers are these wrappers on such views, counted
under the packed kernel's names.  This module also holds the plain
arithmetic of the kernels (``attention_fwd_math``, ``attention_bwd_math``),
which the packed plain versions call too.  ``_FlashAttention`` (a
``torch.autograd.Function``) ties the forward and backward wrappers
together on every device, for both layouts.  Each wrapper launches its
kernel for CUDA tensors and runs its plain version for CPU tensors; it
raises for anything else.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, config
from . import dropout as _dropout

KERNEL = "flash_attention"
KERNEL_BWD = "flash_attention_bwd"
SOURCE = "flash_attention_packed_fwd"
SOURCE_BWD = "flash_attention_packed_bwd"
REPLACES = "paddle_tpu/ops/pallas/flash_attention.py:172 _flash_forward"
REPLACES_BWD = "paddle_tpu/ops/pallas/flash_attention.py:295 _flash_backward"
NEG_INF = -1e30
HEAD_DIMS = (64, 128, 192, 256)    # what the CUDA kernels take
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supported(seq_len: int, head_dim: int) -> bool:
    """The shapes the JAX package sends to its kernel: 64-aligned head
    widths and a sequence of whole 128-row blocks.  On CUDA the kernels
    take head widths up to 256 and raise above."""
    return head_dim % 64 == 0 and seq_len % 128 == 0 and seq_len >= 128


# -- the kernels' arithmetic, shared by both layouts --------------------------

def _keep(b, h, s, seed, rate, device):
    """The (b, h, s, s) keep mask: bh = batch * heads + head, global q/k
    positions (the key of the Pallas kernels' ``program_id(0)``)."""
    bh = torch.arange(b * h, device=device).reshape(b, h, 1, 1)
    pos = torch.arange(s, device=device)
    return _dropout.keep_mask(seed, bh, pos[:, None], pos[None, :], rate)


def _scores(q4, k4, bias, sm_scale, causal):
    s = q4.shape[2]
    scores = (torch.matmul(q4.float(), k4.float().transpose(-1, -2))
              * sm_scale + bias.float()[:, None, None, :])
    if causal:
        tri = torch.ones(s, s, dtype=torch.bool, device=q4.device).tril()
        scores = scores.masked_fill(~tri, NEG_INF)
    return scores


def attention_fwd_math(q4, k4, v4, bias, sm_scale, causal=False,
                       dropout_rate=0.0, seed=0):
    """The forward kernels' arithmetic on (b, h, s, d) views in the input
    type: fp32 scores of input-type operands, fp32 softmax statistics, l
    summed over the undropped P, P * keep / (1 - rate) rounded to the input
    type before the PV product.  Returns ``(acc / max(l, 1e-30) (b, h, s, d)
    fp32, lse (b, h, s) fp32)``."""
    b, h, s, _ = q4.shape
    scores = _scores(q4, k4, bias, sm_scale, causal)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_rate > 0.0:
        keep = _keep(b, h, s, seed, dropout_rate, q4.device)
        p = torch.where(keep, p * _dropout.keep_scale(dropout_rate), 0.0)
    acc = torch.matmul(p.to(q4.dtype).float(), v4.float())
    return acc / l_safe, (m + torch.log(l_safe)).squeeze(-1)


def attention_bwd_math(q4, k4, v4, bias, out4, lse, dout4, sm_scale,
                       causal=False, dropout_rate=0.0, seed=0):
    """The backward kernels' arithmetic on (b, h, s, d) views: P = exp(s -
    lse) unrounded; dV from the dropped P rounded to dO's type; dP = dO V^T
    in fp32, dropped and scaled; delta = rowsum(dO * O) in fp32; dS = P (dP
    - delta) sm_scale, rounded to the input type for dK and dQ.  Returns
    fp32 ``(dq, dk, dv)`` in (b, h, s, d)."""
    b, h, s, _ = q4.shape
    p = torch.exp(_scores(q4, k4, bias, sm_scale, causal) - lse[..., None])
    do = dout4.float()
    dp = torch.matmul(do, v4.float().transpose(-1, -2))
    p_d = p
    if dropout_rate > 0.0:
        keep = _keep(b, h, s, seed, dropout_rate, q4.device)
        scale = _dropout.keep_scale(dropout_rate)
        p_d = torch.where(keep, p * scale, 0.0)
        dp = torch.where(keep, dp * scale, 0.0)
    delta = (do * out4.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * sm_scale).to(q4.dtype).float()
    dv = torch.matmul(p_d.to(dout4.dtype).float().transpose(-1, -2), do)
    dk = torch.matmul(ds.transpose(-1, -2), q4.float())
    dq = torch.matmul(ds, k4.float())
    return dq, dk, dv


# -- the C entries, shared by both layouts ------------------------------------

def _dense(t) -> bool:
    """True when ``t`` covers its storage span without gaps or overlaps, a
    permutation of a contiguous tensor, so ``torch.empty_like`` keeps its
    strides."""
    want = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size > 1 and stride != want:
            return False
        want *= size
    return True


def _strides_match(a, b) -> bool:
    return all(x == y for n, x, y in zip(a.shape, a.stride(), b.stride())
               if n > 1)


def _check_cuda(name, dtype, heads, rows):
    """What the CUDA kernels take; raises on anything else.  ``heads``
    (q first) are the (batch, heads, seq, head_dim) operands, which share
    one layout of unit-stride 16-byte-aligned rows; ``rows`` are the
    contiguous fp32 bias, LSE and delta.  Returns the layout's (batch,
    head, row) element strides."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    q = heads[0][1]
    for tname, t in heads + rows:
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on "
                             f"{q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be 16-byte aligned")
    for tname, t in heads:
        if not _strides_match(t, q):
            raise ValueError(f"{name}: {tname} must share q's layout "
                             f"(strides {q.stride()}, got {t.stride()})")
    for tname, t in rows:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    strides = q.stride()
    if strides[3] != 1 or any(st * q.element_size() % 16
                              for n, st in zip(q.shape[:3], strides[:3])
                              if n > 1):
        raise ValueError(f"{name}: head rows must be unit-stride and "
                         f"16-byte aligned, got strides {strides}")
    return strides[:3]


def _dropout_args(dropout_rate, seed):
    rate = _dropout.check_rate(dropout_rate)
    if rate == 0.0:
        return [0, 0, 1.0, 0]
    return [_dropout.seed_bits(seed), _dropout.threshold(rate),
            _dropout.keep_scale(rate), 1]


def _entry(source, n_pointers):
    """The C entry of ``source`` (named as the source): ``n_pointers``
    pointers, then batch, seq, heads, head_dim, the (batch, head, row)
    element strides, sm_scale, causal, seed, threshold, keep_scale,
    dropout, dtype and the stream."""
    fn = getattr(build.load(source), source)
    if fn.argtypes is None:
        P, I, L, U, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_uint32, ctypes.c_float)
        fn.argtypes = ([P] * n_pointers
                       + [I, I, I, I, L, L, L, F, I, U, U, F, I, I, P])
        fn.restype = I
    return fn


def _launch(name, source, tensors, batch, seq, heads, head_dim, strides,
            sm_scale, causal, dropout_rate, seed):
    """Launch the C entry of ``source`` on ``tensors`` (pointers in the
    entry's order, q first) with q's device current; raises if CUDA refuses
    the launch."""
    q = tensors[0]
    with torch.cuda.device(q.device):
        err = _entry(source, len(tensors))(
            *(t.data_ptr() for t in tensors), batch, seq, heads, head_dim,
            *strides, float(sm_scale), int(bool(causal)),
            *_dropout_args(dropout_rate, seed), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# -- the (batch, heads, seq, head_dim) kernels ---------------------------------

def _check(q, k, v, bias):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (batch, heads, seq, "
                         f"head_dim) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, s, _ = q.shape
    if bias.shape != (b, s) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 ({b}, {s}), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")


def _check_head_dim(name, head_dim):
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: the CUDA kernels take head_dim in "
                         f"{HEAD_DIMS}, got {head_dim}")


def _like(name, q):
    """An output in q's layout (q's strides when q is dense)."""
    if not _dense(q):
        raise ValueError(f"{name}: q, k, v must be views of one dense "
                         f"layout, got strides {q.stride()}")
    return torch.empty_like(q)


def flash_attention_fwd_plain(q, k, v, bias, sm_scale, causal=False,
                              dropout_rate=0.0, seed=0,
                              name=KERNEL) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The forward kernel's arithmetic in PyTorch ops (``attention_fwd_
    math``).  Returns ``(out (b, h, s, d) in q's type, lse (b, h, s)
    fp32)``; ``name`` (the wrapper's launch counter) is unused."""
    out, lse = attention_fwd_math(q, k, v, bias, sm_scale, causal,
                                  dropout_rate, seed)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, bias, out, lse, dout, sm_scale,
                              causal=False, dropout_rate=0.0, seed=0,
                              name=KERNEL_BWD):
    """The backward kernels' arithmetic in PyTorch ops (``attention_bwd_
    math``).  Returns ``(dq, dk, dv)`` in q's type; ``name`` is unused."""
    grads = attention_bwd_math(q, k, v, bias, out, lse, dout, sm_scale,
                               causal, dropout_rate, seed)
    return tuple(g.to(q.dtype) for g in grads)


def flash_attention_fwd(q, k, v, bias, sm_scale, causal=False,
                        dropout_rate=0.0, seed=0,
                        name=KERNEL) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward: ``(out, lse)`` of (b, h, s, d) attention, out in q's
    layout.  CUDA tensors launch the kernel, counted under ``name`` (the
    packed wrappers count theirs as kernel A); CPU tensors run the plain
    version."""
    _check(q, k, v, bias)
    _dropout.check_rate(dropout_rate)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, bias, sm_scale, causal,
                                         dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, h, s, d = q.shape
    _check_head_dim(name, d)
    out = _like(name, q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = _check_cuda(name, q.dtype,
                          [("q", q), ("k", k), ("v", v), ("out", out)],
                          [("bias", bias), ("lse", lse)])
    _launch(name, SOURCE, (q, k, v, bias, out, lse), b, s, h, d, strides,
            sm_scale, causal, dropout_rate, seed)
    config.record_call(name)
    return out, lse


def flash_attention_bwd(q, k, v, bias, out, lse, dout, sm_scale,
                        causal=False, dropout_rate=0.0, seed=0,
                        name=KERNEL_BWD):
    """Backward: ``(dq, dk, dv)`` in q's layout.  CUDA tensors launch the
    kernels (the delta pre-pass, dK/dV over key tiles, dQ over query
    tiles), counted under ``name``; CPU tensors run the plain version."""
    _check(q, k, v, bias)
    _dropout.check_rate(dropout_rate)
    for tname, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} must match q in shape and "
                             f"dtype")
    b, h, s, d = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be float32 ({b}, {h}, {s})")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                         sm_scale, causal, dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_head_dim(name, d)
    dq, dk, dv = (_like(name, q) for _ in range(3))
    delta = torch.empty_like(lse)
    strides = _check_cuda(
        name, q.dtype,
        [("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
         ("dq", dq), ("dk", dk), ("dv", dv)],
        [("bias", bias), ("lse", lse), ("delta", delta)])
    _launch(name, SOURCE_BWD,
            (q, k, v, bias, out, dout, lse, delta, dq, dk, dv), b, s, h, d,
            strides, sm_scale, causal, dropout_rate, seed)
    config.record_call(name)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op, for both
    layouts (``names``: the launch counters, KERNEL / KERNEL_BWD or the
    packed kernel's).  The bias gets no gradient (it is a padding mask);
    the seed and rate ride on the context so the backward replays the
    forward's mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale, causal, dropout_rate, seed,
                names):
        out, lse = flash_attention_fwd(q, k, v, bias, sm_scale, causal,
                                       dropout_rate, seed, name=names[0])
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (sm_scale, causal, dropout_rate, seed)
        ctx.name = names[1]
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if not _strides_match(dout, out):
            dout = torch.empty_like(out).copy_(dout)
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, dout,
                                         *ctx.args, name=ctx.name)
        return dq, dk, dv, None, None, None, None, None, None


def _one_layout(q, k, v):
    """q, k, v as they are when they share one dense layout with unit-
    stride rows (the projections' split-head views do: the packed layout),
    else as contiguous copies: the kernels take one set of strides."""
    if (q.stride(-1) == 1 and _dense(q) and _strides_match(k, q)
            and _strides_match(v, q)):
        return q, k, v
    return tuple(t.contiguous() for t in (q, k, v))


def flash_attention(q, k, v, bias=None, sm_scale: Optional[float] = None,
                    causal=False, dropout_rate=0.0,
                    seed: Optional[int] = None, names=(KERNEL, KERNEL_BWD)):
    """Flash attention over (batch, heads, seq, head_dim) inputs with an
    optional additive (batch, seq) key bias; returns (batch, heads, seq,
    head_dim) in q's layout.  Same contract as the JAX function: the bias
    is not differentiable, ``sm_scale`` defaults to 1 / sqrt(head_dim),
    ``seed`` (an int32, 0 when None) drives the in-kernel dropout.
    Differentiable through ``_FlashAttention``; without autograd the
    forward runs alone.  Transposed views of one dense tensor (split heads)
    go to the kernels as they are; other layouts are copied first."""
    b, _, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if bias is None:
        bias = torch.zeros((b, s), dtype=torch.float32, device=q.device)
    else:
        bias = bias.detach().to(torch.float32).expand(b, s).contiguous()
    q, k, v = _one_layout(q, k, v)
    args = (float(sm_scale), bool(causal), float(dropout_rate),
            0 if seed is None else int(seed))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bias, *args, tuple(names))
    out, _ = flash_attention_fwd(q, k, v, bias, *args, name=names[0])
    return out


KERNELS = (
    config.Kernel(KERNEL, SOURCE, REPLACES, flash_attention_fwd,
                  flash_attention_fwd_plain),
    config.Kernel(KERNEL_BWD, SOURCE_BWD, REPLACES_BWD, flash_attention_bwd,
                  flash_attention_bwd_plain),
)
