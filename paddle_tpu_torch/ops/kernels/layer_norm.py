"""LayerNorm and residual + dropout + LayerNorm, forward and backward.

Counterpart of paddle_tpu/ops/pallas/layer_norm.py.  Two kernel sources:

* ``csrc/layer_norm_fwd.cu``: kernel B, ``layer_norm`` (replaces ``_fwd``):
  out = LN(x) * w + b; kernel C, ``residual_layer_norm`` (replaces
  ``_rdln_fwd``): out = LN(residual + dropout(x)) * w + b, the dropout mask
  the position hash of ``dropout.py`` keyed by (0, row, column);
* ``csrc/layer_norm_bwd.cu``: their backwards, ``layer_norm_bwd`` (replaces
  ``_bwd``) and ``residual_layer_norm_bwd`` (replaces ``_rdln_bwd``), which
  replays the mask; one wave of persistent CTAs (``ln_bwd_plan``) writes
  per-CTA dw/db partials that a second, deterministic pass sums.

Stats are fp32 whatever the input type, the variance is two-pass, and the
output type is the promotion of the input and parameter types
(``result_type`` in the JAX wrapper).  ``_FusedLayerNorm`` and
``_FusedResidualDropoutLayerNorm`` (``torch.autograd.Function``s) tie each
forward to its backward on every device.

The wrappers launch the kernel for CUDA tensors and run the plain version
for CPU tensors; they raise for anything else.  Each plain version takes its
wrapper's arguments, so a caller can put one in place of the other.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import build, config
from . import dropout as _dropout

SOURCE = "layer_norm_fwd"
SOURCE_BWD = "layer_norm_bwd"
LN = "layer_norm"
RDLN = "residual_layer_norm"
LN_BWD = "layer_norm_bwd"
RDLN_BWD = "residual_layer_norm_bwd"
REPLACES_LN = "paddle_tpu/ops/pallas/layer_norm.py:86 _fwd"
REPLACES_RDLN = "paddle_tpu/ops/pallas/layer_norm.py:266 _rdln_fwd"
REPLACES_LN_BWD = "paddle_tpu/ops/pallas/layer_norm.py:111 _bwd"
REPLACES_RDLN_BWD = "paddle_tpu/ops/pallas/layer_norm.py:292 _rdln_bwd"
MAX_DIM = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _out_dtype(x2, weight):
    """Promotion of the input and parameter types (x and residual share
    one dtype, as do weight and bias)."""
    return torch.promote_types(x2.dtype, weight.dtype)


def _keep(x2, seed, rate):
    """The (n, dim) keep mask: bh = 0, q_pos = row, k_pos = column."""
    n, dim = x2.shape
    rows = torch.arange(n, device=x2.device)[:, None]
    cols = torch.arange(dim, device=x2.device)[None, :]
    return _dropout.keep_mask(seed, 0, rows, cols, rate)


def _dropped(x2, rate, seed):
    """fp32 x * keep / (1 - rate) (x itself at rate 0)."""
    x = x2.float()
    if rate > 0.0:
        x = torch.where(_keep(x2, seed, rate),
                        x * _dropout.keep_scale(rate), 0.0)
    return x


def _ln_rows_plain(h, weight, bias, eps, out_dtype):
    """Two-pass fp32 LayerNorm of the rows of an fp32 ``h``."""
    mean = h.mean(dim=-1, keepdim=True)
    centered = h - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    out = centered * rstd * weight.float() + bias.float()
    return out.to(out_dtype), mean.squeeze(-1), rstd.squeeze(-1)


def _ln_grad_plain(h, weight, mean, rstd, dy2):
    """fp32 (dh, dw, db) of LN rows h with the forward's mean and rstd."""
    xhat = (h - mean[:, None]) * rstd[:, None]
    dy = dy2.float()
    g = dy * weight.float()
    g_mean = g.mean(dim=-1, keepdim=True)
    gx_mean = (g * xhat).mean(dim=-1, keepdim=True)
    dh = rstd[:, None] * (g - g_mean - xhat * gx_mean)
    return dh, (dy * xhat).sum(0), dy.sum(0)


def layer_norm_plain(x2, weight, bias, eps=1e-5):
    """Kernel B's arithmetic: ``(out, mean, rstd)`` of an (n, dim) ``x2``."""
    return _ln_rows_plain(x2.float(), weight, bias, eps,
                          _out_dtype(x2, weight))


def residual_layer_norm_plain(x2, res2, weight, bias, eps=1e-5,
                              dropout_rate=0.0, seed=0):
    """Kernel C's arithmetic: LN(residual + dropout(x)) with the sum taken
    in fp32."""
    return _ln_rows_plain(res2.float() + _dropped(x2, dropout_rate, seed),
                          weight, bias, eps, _out_dtype(x2, weight))


def layer_norm_bwd_plain(x2, weight, mean, rstd, dy2):
    """Kernel B backward's arithmetic: ``(dx, dw, db)``,
    dx = rstd (g - mean(g) - x_hat mean(g x_hat)) with g = dy w in fp32."""
    dh, dw, db = _ln_grad_plain(x2.float(), weight, mean, rstd, dy2)
    return dh.to(x2.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def residual_layer_norm_bwd_plain(x2, res2, weight, mean, rstd, dy2,
                                  dropout_rate=0.0, seed=0):
    """Kernel C backward's arithmetic: ``(dx, dres, dw, db)``; h and the
    keep mask are recomputed, dres = dh and dx = dh * keep / (1 - rate)."""
    h = res2.float() + _dropped(x2, dropout_rate, seed)
    dh, dw, db = _ln_grad_plain(h, weight, mean, rstd, dy2)
    dx = dh
    if dropout_rate > 0.0:
        dx = torch.where(_keep(x2, seed, dropout_rate),
                         dh * _dropout.keep_scale(dropout_rate), 0.0)
    return (dx.to(x2.dtype), dh.to(res2.dtype), dw.to(weight.dtype),
            db.to(weight.dtype))


def _check(name, x2, others, weight, bias=None, dy2=None):
    if x2.dim() != 2:
        raise ValueError(f"{name}: expected (rows, dim) input, got "
                         f"{tuple(x2.shape)}")
    n, dim = x2.shape
    if weight.shape != (dim,) or (bias is not None and bias.shape != (dim,)):
        raise ValueError(f"{name}: weight and bias must be ({dim},)")
    if bias is not None and weight.dtype != bias.dtype:
        raise ValueError(f"{name}: weight and bias must share one dtype")
    for t in others:
        if t.shape != x2.shape or t.dtype != x2.dtype:
            raise ValueError(f"{name}: residual must match x in shape and "
                             f"dtype")
    if dy2 is not None and (dy2.shape != x2.shape
                            or dy2.dtype != _out_dtype(x2, weight)):
        raise ValueError(f"{name}: dy must be ({n}, {dim}) of the forward's "
                         f"output type {_out_dtype(x2, weight)}")
    if x2.device.type == "cpu":
        return
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2.device}")
    if x2.dtype not in _DTYPE_CODES or weight.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x and weight must be float32 or bfloat16, "
                         f"got {x2.dtype} and {weight.dtype}")
    vec = 16 // x2.element_size()
    if dim % vec or dim > MAX_DIM:
        raise ValueError(f"{name}: dim must be a multiple of {vec} and at "
                         f"most {MAX_DIM}, got {dim}")
    extra = tuple(t for t in (bias, dy2) if t is not None)
    for t in (x2, *others, weight, *extra):
        if t.device != x2.device:
            raise ValueError(f"{name}: all tensors must be on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _stats(name, x2, mean, rstd):
    n = x2.shape[0]
    for t in (mean, rstd):
        if t.shape != (n,) or t.dtype != torch.float32 \
                or t.device != x2.device:
            raise ValueError(f"{name}: mean and rstd must be float32 ({n},) "
                             f"on {x2.device}")


def _drop_args(dropout_rate, seed):
    rate = _dropout.check_rate(dropout_rate)
    if rate == 0.0:
        return [0, 0, 1.0, 0]
    return [_dropout.seed_bits(seed), _dropout.threshold(rate),
            _dropout.keep_scale(rate), 1]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(name, x2, res2, weight, bias, eps, drop):
    n, dim = x2.shape
    out = torch.empty((n, dim), dtype=_out_dtype(x2, weight),
                      device=x2.device)
    mean = torch.empty((n,), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x2.device)
    residual = res2 is not None
    args = [x2.data_ptr()] + ([res2.data_ptr()] if residual else [])
    args += [weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
             mean.data_ptr(), rstd.data_ptr(), n, dim, float(eps), *drop,
             _DTYPE_CODES[x2.dtype], _DTYPE_CODES[weight.dtype], _stream(x2)]
    symbol = "residual_layer_norm_fwd" if residual else "layer_norm_fwd"
    err = _entry(SOURCE, symbol, 7 if residual else 6, residual)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    config.record_call(name)
    return out, mean, rstd


WARPS_PER_CTA = 8
MIN_ROWS_PER_WARP = 2


class LnBwdPlan(NamedTuple):
    """The backward's grid: ``ctas`` CTAs of ``WARPS_PER_CTA`` warps; warp
    ``gw`` (CTA ``gw // 8``, warp ``gw % 8``) walks rows ``gw, gw + warps,
    gw + 2 warps, ...`` below ``n``."""
    n: int
    ctas: int

    @property
    def warps(self) -> int:
        return self.ctas * WARPS_PER_CTA

    def rows_of(self, gw: int) -> range:
        return range(gw, self.n, self.warps)


def ln_bwd_plan(n: int, resident: int) -> LnBwdPlan:
    """One wave at most: ``resident`` CTAs (what the device holds at once
    at the kernel's occupancy), fewer where the rows would give a warp
    fewer than ``MIN_ROWS_PER_WARP`` rows (each CTA adds a dw/db partial
    row that the second pass reads)."""
    per_cta = WARPS_PER_CTA * MIN_ROWS_PER_WARP
    return LnBwdPlan(n, max(1, min(resident, -(-n // per_cta))))


_RESIDENT: Dict[tuple, int] = {}


def _resident(x2, weight, residual):
    """CTAs of the backward one wave holds on x2's device, from the
    kernel's occupancy at this build (cached)."""
    dim = x2.shape[1]
    key = (x2.device.index, dim, residual, x2.dtype, weight.dtype)
    if key not in _RESIDENT:
        fn = build.load(SOURCE_BWD).layer_norm_bwd_resident
        if fn.argtypes is None:
            I = ctypes.c_int
            fn.argtypes = [I, I, I, I, ctypes.POINTER(I)]
            fn.restype = I
        out = ctypes.c_int(0)
        with torch.cuda.device(x2.device):
            err = fn(dim, int(residual), _DTYPE_CODES[x2.dtype],
                     _DTYPE_CODES[weight.dtype], ctypes.byref(out))
        if err:
            raise RuntimeError(f"layer_norm_bwd occupancy query failed: CUDA "
                               f"error {err}")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def _launch_bwd(name, x2, res2, weight, mean, rstd, dy2, drop):
    n, dim = x2.shape
    residual = res2 is not None
    plan = ln_bwd_plan(n, _resident(x2, weight, residual))
    dx = torch.empty_like(x2)
    parts = torch.empty((2, plan.ctas, dim), dtype=torch.float32,
                        device=x2.device)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    dres = torch.empty_like(res2) if residual else None
    args = [x2.data_ptr()] + ([res2.data_ptr()] if residual else [])
    args += [weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
             dy2.data_ptr(), dx.data_ptr()]
    args += [dres.data_ptr()] if residual else []
    args += [parts[0].data_ptr(), parts[1].data_ptr(), dw.data_ptr(),
             db.data_ptr(), n, dim, plan.ctas, *drop, _DTYPE_CODES[x2.dtype],
             _DTYPE_CODES[weight.dtype], _stream(x2)]
    symbol = "residual_layer_norm_bwd" if residual else "layer_norm_bwd"
    err = _entry(SOURCE_BWD, symbol, 12 if residual else 10, residual,
                 ctas=True)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    config.record_call(name)
    return ((dx, dres) if residual else (dx,)) + (dw, db)


def _entry(source, symbol, n_pointers, dropout, ctas=False):
    """The C entry ``symbol``: ``n_pointers`` pointers, n (int64), dim,
    [eps | CTAs], [seed, threshold, keep_scale, dropout], x and w dtype
    codes, the stream."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        third = I if ctas else ctypes.c_float
        drop = ([ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, I]
                if dropout else [])
        fn.argtypes = ([P] * n_pointers + [ctypes.c_int64, I, third] + drop
                       + [I, I, P])
        fn.restype = I
    return fn


def layer_norm_fwd(x2, weight, bias, eps=1e-5) -> Tuple[torch.Tensor, ...]:
    """Kernel B: ``(out, mean, rstd)`` for an (n, dim) ``x2``."""
    _check(LN, x2, (), weight, bias)
    if x2.device.type == "cpu":
        return layer_norm_plain(x2, weight, bias, eps)
    return _launch_fwd(LN, x2, None, weight, bias, eps, [])


def residual_layer_norm_fwd(x2, res2, weight, bias, eps=1e-5,
                            dropout_rate=0.0,
                            seed=0) -> Tuple[torch.Tensor, ...]:
    """Kernel C: ``(out, mean, rstd)`` of LN(res2 + dropout(x2))."""
    _check(RDLN, x2, (res2,), weight, bias)
    _dropout.check_rate(dropout_rate)
    if x2.device.type == "cpu":
        return residual_layer_norm_plain(x2, res2, weight, bias, eps,
                                         dropout_rate, seed)
    return _launch_fwd(RDLN, x2, res2, weight, bias, eps,
                       _drop_args(dropout_rate, seed))


def layer_norm_bwd(x2, weight, mean, rstd, dy2) -> Tuple[torch.Tensor, ...]:
    """Kernel B backward: ``(dx, dw, db)``."""
    _check(LN_BWD, x2, (), weight, dy2=dy2)
    _stats(LN_BWD, x2, mean, rstd)
    if x2.device.type == "cpu":
        return layer_norm_bwd_plain(x2, weight, mean, rstd, dy2)
    return _launch_bwd(LN_BWD, x2, None, weight, mean, rstd, dy2, [])


def residual_layer_norm_bwd(x2, res2, weight, mean, rstd, dy2,
                            dropout_rate=0.0,
                            seed=0) -> Tuple[torch.Tensor, ...]:
    """Kernel C backward: ``(dx, dres, dw, db)``."""
    _check(RDLN_BWD, x2, (res2,), weight, dy2=dy2)
    _dropout.check_rate(dropout_rate)
    _stats(RDLN_BWD, x2, mean, rstd)
    if x2.device.type == "cpu":
        return residual_layer_norm_bwd_plain(x2, res2, weight, mean, rstd,
                                             dy2, dropout_rate, seed)
    return _launch_bwd(RDLN_BWD, x2, res2, weight, mean, rstd, dy2,
                       _drop_args(dropout_rate, seed))


def _rows(t):
    return t.reshape(-1, t.shape[-1])


class _FusedLayerNorm(torch.autograd.Function):
    """Kernel B forward and backward as one differentiable op over the last
    axis of ``x`` (any leading shape)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        out, mean, rstd = layer_norm_fwd(_rows(x), weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(_rows(x), weight, mean, rstd,
                                    _rows(dy).contiguous())
        return dx.reshape(x.shape), dw, db, None


class _FusedResidualDropoutLayerNorm(torch.autograd.Function):
    """Kernel C forward and backward as one differentiable op over the last
    axis; the seed and rate ride on the context so the backward replays the
    mask."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps, dropout_rate, seed):
        out, mean, rstd = residual_layer_norm_fwd(
            _rows(x), _rows(residual), weight, bias, eps, dropout_rate, seed)
        ctx.save_for_backward(x, residual, weight, mean, rstd)
        ctx.args = (dropout_rate, seed)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, residual, weight, mean, rstd = ctx.saved_tensors
        dx, dres, dw, db = residual_layer_norm_bwd(
            _rows(x), _rows(residual), weight, mean, rstd,
            _rows(dy).contiguous(), *ctx.args)
        return (dx.reshape(x.shape), dres.reshape(residual.shape), dw, db,
                None, None, None)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis with weight and bias (kernel B),
    differentiable through ``_FusedLayerNorm``."""
    if _needs_grad(x, weight, bias):
        return _FusedLayerNorm.apply(x, weight, bias, float(epsilon))
    out, _, _ = layer_norm_fwd(_rows(x), weight, bias, epsilon)
    return out.reshape(x.shape)


def fused_residual_dropout_layer_norm(x, residual, weight, bias,
                                      dropout_rate=0.0,
                                      seed: Optional[int] = None,
                                      epsilon=1e-5):
    """out = LayerNorm(residual + dropout(x)) in one pass (kernel C).
    ``seed`` (an int32, 0 when None) drives the in-kernel keep mask when
    ``dropout_rate > 0``.  Differentiable through
    ``_FusedResidualDropoutLayerNorm``."""
    args = (float(epsilon), float(dropout_rate),
            0 if seed is None else int(seed))
    if _needs_grad(x, residual, weight, bias):
        return _FusedResidualDropoutLayerNorm.apply(x, residual, weight, bias,
                                                    *args)
    out, _, _ = residual_layer_norm_fwd(_rows(x), _rows(residual), weight,
                                        bias, *args)
    return out.reshape(x.shape)


KERNELS = (
    config.Kernel(LN, SOURCE, REPLACES_LN, layer_norm_fwd, layer_norm_plain),
    config.Kernel(RDLN, SOURCE, REPLACES_RDLN, residual_layer_norm_fwd,
                  residual_layer_norm_plain),
    config.Kernel(LN_BWD, SOURCE_BWD, REPLACES_LN_BWD, layer_norm_bwd,
                  layer_norm_bwd_plain),
    config.Kernel(RDLN_BWD, SOURCE_BWD, REPLACES_RDLN_BWD,
                  residual_layer_norm_bwd, residual_layer_norm_bwd_plain),
)
