"""LayerNorm forward and residual + dropout + LayerNorm forward.

Counterpart of paddle_tpu/ops/pallas/layer_norm.py.  Both kernels live in
``csrc/layer_norm_fwd.cu``:

* kernel B, ``layer_norm`` (replaces ``_fwd``): out = LN(x) * w + b;
* kernel C, ``residual_layer_norm`` (replaces ``_rdln_fwd`` at dropout rate
  0): out = LN(residual + x) * w + b.

Each writes the fp32 per-row mean and rstd beside the output, for the
backward of the training slice.  Stats are fp32 whatever the input type,
the variance is two-pass, and the output type is the promotion of the input
and parameter types (``result_type`` in the JAX wrapper).

The wrappers launch the kernel for CUDA tensors and run the plain version
for CPU tensors; they raise for anything else.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, config

SOURCE = "layer_norm_fwd"
LN = "layer_norm"
RDLN = "residual_layer_norm"
REPLACES_LN = "paddle_tpu/ops/pallas/layer_norm.py:86 _fwd"
REPLACES_RDLN = "paddle_tpu/ops/pallas/layer_norm.py:266 _rdln_fwd"
MAX_DIM = 2048
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _out_dtype(x2, weight):
    """Promotion of the input and parameter types (x and residual share
    one dtype, as do weight and bias)."""
    return torch.promote_types(x2.dtype, weight.dtype)


def _ln_rows_plain(h, weight, bias, eps, out_dtype):
    """Two-pass fp32 LayerNorm of the rows of an fp32 ``h``."""
    mean = h.mean(dim=-1, keepdim=True)
    centered = h - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    out = centered * rstd * weight.float() + bias.float()
    return out.to(out_dtype), mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm_plain(x2, weight, bias, eps=1e-5):
    """Kernel B's arithmetic: ``(out, mean, rstd)`` of an (n, dim) ``x2``."""
    return _ln_rows_plain(x2.float(), weight, bias, eps,
                          _out_dtype(x2, weight))


def residual_layer_norm_plain(x2, res2, weight, bias, eps=1e-5):
    """Kernel C's arithmetic: LN(residual + x) with the sum taken in fp32."""
    return _ln_rows_plain(res2.float() + x2.float(), weight, bias, eps,
                          _out_dtype(x2, weight))


def _check(name, x2, others, weight, bias):
    if x2.dim() != 2:
        raise ValueError(f"{name}: expected (rows, dim) input, got "
                         f"{tuple(x2.shape)}")
    dim = x2.shape[1]
    if weight.shape != (dim,) or bias.shape != (dim,):
        raise ValueError(f"{name}: weight and bias must be ({dim},)")
    if weight.dtype != bias.dtype:
        raise ValueError(f"{name}: weight and bias must share one dtype")
    for t in others:
        if t.shape != x2.shape or t.dtype != x2.dtype:
            raise ValueError(f"{name}: residual must match x in shape and "
                             f"dtype")
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
    for t in (x2, *others, weight, bias):
        if t.device != x2.device:
            raise ValueError(f"{name}: all tensors must be on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _launch(name, entry, x2, res2, weight, bias, eps, out_dtype):
    n, dim = x2.shape
    out = torch.empty((n, dim), dtype=out_dtype, device=x2.device)
    mean = torch.empty((n,), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((n,), dtype=torch.float32, device=x2.device)
    args = [x2.data_ptr()]
    if res2 is not None:
        args.append(res2.data_ptr())
    args += [weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
             mean.data_ptr(), rstd.data_ptr(), n, dim, float(eps),
             _DTYPE_CODES[x2.dtype], _DTYPE_CODES[weight.dtype],
             torch.cuda.current_stream(x2.device).cuda_stream]
    err = _entry(entry, res2 is not None)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    config.record_call(name)
    return out, mean, rstd


def _entry(symbol, residual):
    fn = getattr(build.load(SOURCE), symbol)
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = ([P] * (7 if residual else 6)
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, P])
        fn.restype = ctypes.c_int
    return fn


def layer_norm_fwd(x2, weight, bias, eps=1e-5) -> Tuple[torch.Tensor, ...]:
    """Kernel B: ``(out, mean, rstd)`` for an (n, dim) ``x2``."""
    _check(LN, x2, (), weight, bias)
    if x2.device.type == "cpu":
        return layer_norm_plain(x2, weight, bias, eps)
    return _launch(LN, "layer_norm_fwd", x2, None, weight, bias, eps,
                   _out_dtype(x2, weight))


def residual_layer_norm_fwd(x2, res2, weight, bias,
                            eps=1e-5) -> Tuple[torch.Tensor, ...]:
    """Kernel C: ``(out, mean, rstd)`` of LN(res2 + x2)."""
    _check(RDLN, x2, (res2,), weight, bias)
    if x2.device.type == "cpu":
        return residual_layer_norm_plain(x2, res2, weight, bias, eps)
    return _launch(RDLN, "residual_layer_norm_fwd", x2, res2, weight, bias,
                   eps, _out_dtype(x2, weight))


def fused_layer_norm(x, weight, bias, epsilon=1e-5):
    """LayerNorm over the last axis with weight and bias (kernel B)."""
    dim = x.shape[-1]
    out, _, _ = layer_norm_fwd(x.reshape(-1, dim), weight, bias, epsilon)
    return out.reshape(x.shape)


def fused_residual_dropout_layer_norm(x, residual, weight, bias,
                                      dropout_rate=0.0,
                                      seed: Optional[int] = None,
                                      epsilon=1e-5):
    """out = LayerNorm(residual + dropout(x)) in one pass (kernel C).  The
    in-kernel dropout waits for the training slice."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "fused_residual_dropout_layer_norm: in-kernel dropout comes with "
            "the training slice (ROADMAP.md, Queue 1 slice 2)")
    dim = x.shape[-1]
    out, _, _ = residual_layer_norm_fwd(x.reshape(-1, dim),
                                        residual.reshape(-1, dim), weight,
                                        bias, epsilon)
    return out.reshape(x.shape)


KERNELS = (
    config.Kernel(LN, SOURCE, REPLACES_LN, layer_norm_fwd, layer_norm_plain),
    config.Kernel(RDLN, SOURCE, REPLACES_RDLN, residual_layer_norm_fwd,
                  residual_layer_norm_plain),
)
