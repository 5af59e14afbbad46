"""Elementwise / reduction / matmul math ops (counterpart of
paddle_tpu/ops/math.py; ref python/paddle/tensor/math.py).  Python scalars
stay weakly typed, as in JAX: a bf16 tensor times 2.0 is bf16.  Integer
reductions and cumulative sums come back int64, torch's default (the JAX
package's are int32 with x64 off)."""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as _dtype
from ._util import as_tensor, dims, operands, tensors


def _float_in(x):
    """``x`` as a tensor, integers and bools as the default float (torch's
    transcendental ops want a float input where JAX promotes)."""
    x = as_tensor(x)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(_dtype.get_default_dtype())
    return x


# -- elementwise binary ------------------------------------------------------

def add(x, y):
    return torch.add(*operands(x, y))


def subtract(x, y):
    return torch.subtract(*operands(x, y))


def multiply(x, y):
    return torch.multiply(*operands(x, y))


def divide(x, y):
    return torch.true_divide(*operands(x, y))


def floor_divide(x, y):
    return torch.floor_divide(*operands(x, y))


def mod(x, y):
    """The remainder with the divisor's sign (Python's and numpy's)."""
    return torch.remainder(*operands(x, y))


remainder = mod


def pow(x, y):
    return torch.pow(*operands(x, y))


def maximum(x, y):
    return torch.maximum(*tensors(x, y))


def minimum(x, y):
    return torch.minimum(*tensors(x, y))


def fmax(x, y):
    return torch.fmax(*tensors(x, y))


def fmin(x, y):
    return torch.fmin(*tensors(x, y))


def lerp(x, y, weight):
    x, y = tensors(x, y)
    w = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    return x + w * (y - x)


# -- elementwise unary -------------------------------------------------------

def abs(x):
    return torch.abs(as_tensor(x))


def ceil(x):
    return torch.ceil(as_tensor(x))


def floor(x):
    return torch.floor(as_tensor(x))


def round(x):
    """Half to even, as numpy."""
    return torch.round(as_tensor(x))


def trunc(x):
    return torch.trunc(as_tensor(x))


def exp(x):
    return torch.exp(_float_in(x))


def expm1(x):
    return torch.expm1(_float_in(x))


def log(x):
    return torch.log(_float_in(x))


def log1p(x):
    return torch.log1p(_float_in(x))


def log2(x):
    return torch.log2(_float_in(x))


def log10(x):
    return torch.log10(_float_in(x))


def sqrt(x):
    return torch.sqrt(_float_in(x))


def rsqrt(x):
    return torch.rsqrt(_float_in(x))


def square(x):
    return torch.square(as_tensor(x))


def reciprocal(x):
    return torch.reciprocal(_float_in(x))


def sign(x):
    return torch.sign(as_tensor(x))


def sin(x):
    return torch.sin(_float_in(x))


def cos(x):
    return torch.cos(_float_in(x))


def tan(x):
    return torch.tan(_float_in(x))


def sinh(x):
    return torch.sinh(_float_in(x))


def cosh(x):
    return torch.cosh(_float_in(x))


def tanh(x):
    return torch.tanh(_float_in(x))


def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * _float_in(x))


def erf(x):
    return torch.erf(_float_in(x))


def logit(x, eps=None):
    x = _float_in(x)
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def clip(x, min=None, max=None):
    x = as_tensor(x)
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    """ref: operators/scale_op.cc."""
    x = as_tensor(x)
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def isnan(x):
    return torch.isnan(as_tensor(x))


def isinf(x):
    return torch.isinf(as_tensor(x))


def isfinite(x):
    return torch.isfinite(as_tensor(x))


# -- reductions --------------------------------------------------------------

def _keep_all(out, x, axis, keepdim):
    """A full reduction with ``keepdim``: every dim kept as 1."""
    if keepdim and axis is None:
        return out.reshape((1,) * x.dim())
    return out


def sum(x, axis=None, dtype=None, keepdim=False):
    x = as_tensor(x)
    out = torch.sum(x, dim=dims(axis, x.dim()), keepdim=keepdim,
                    dtype=_dtype.exact_dtype(dtype))
    return _keep_all(out, x, axis, keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False):
    x = as_tensor(x)
    out = torch.nansum(x, dim=dims(axis, x.dim()), keepdim=keepdim,
                       dtype=_dtype.exact_dtype(dtype))
    return _keep_all(out, x, axis, keepdim)


def mean(x, axis=None, keepdim=False):
    x = _float_in(x)
    return _keep_all(torch.mean(x, dim=dims(axis, x.dim()), keepdim=keepdim),
                     x, axis, keepdim)


def nanmean(x, axis=None, keepdim=False):
    x = _float_in(x)
    return _keep_all(torch.nanmean(x, dim=dims(axis, x.dim()),
                                   keepdim=keepdim), x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None):
    x = as_tensor(x)
    dt = _dtype.exact_dtype(dtype)
    if axis is None:
        return _keep_all(torch.prod(x, dtype=dt), x, axis, keepdim)
    out = x if dt is None else x.to(dt)
    for a in sorted((d % x.dim() for d in dims(axis, x.dim())),
                    reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdim)
    return out


def max(x, axis=None, keepdim=False):
    x = as_tensor(x)
    return _keep_all(torch.amax(x, dim=dims(axis, x.dim()), keepdim=keepdim),
                     x, axis, keepdim)


def min(x, axis=None, keepdim=False):
    x = as_tensor(x)
    return _keep_all(torch.amin(x, dim=dims(axis, x.dim()), keepdim=keepdim),
                     x, axis, keepdim)


amax = max
amin = min


def std(x, axis=None, unbiased=True, keepdim=False):
    x = _float_in(x)
    return _keep_all(torch.std(x, dim=dims(axis, x.dim()),
                               correction=1 if unbiased else 0,
                               keepdim=keepdim), x, axis, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    x = _float_in(x)
    return _keep_all(torch.var(x, dim=dims(axis, x.dim()),
                               correction=1 if unbiased else 0,
                               keepdim=keepdim), x, axis, keepdim)


def all(x, axis=None, keepdim=False):
    x = as_tensor(x)
    if axis is None:
        return _keep_all(torch.all(x), x, axis, keepdim)
    return torch.all(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def any(x, axis=None, keepdim=False):
    x = as_tensor(x)
    if axis is None:
        return _keep_all(torch.any(x), x, axis, keepdim)
    return torch.any(x, dim=dims(axis, x.dim()), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False):
    x = _float_in(x)
    return _keep_all(torch.logsumexp(x, dim=dims(axis, x.dim()),
                                     keepdim=keepdim), x, axis, keepdim)


def logcumsumexp(x, axis=None):
    x = _float_in(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, dim=axis)


def cumsum(x, axis=None, dtype=None):
    x = as_tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=axis, dtype=_dtype.exact_dtype(dtype))


def cumprod(x, dim=None, dtype=None):
    x = as_tensor(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim=dim, dtype=_dtype.exact_dtype(dtype))


def add_n(inputs):
    """ref: operators/sum_op.cc (sum of a tensor list)."""
    if not isinstance(inputs, (list, tuple)):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


# -- matmul family -----------------------------------------------------------

def matmul(x, y, transpose_x=False, transpose_y=False):
    x, y = tensors(x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y):
    return torch.matmul(*tensors(x, y))


def bmm(x, y):
    return torch.matmul(*tensors(x, y))


def dot(x, y):
    x, y = tensors(x, y)
    return torch.sum(x * y, dim=-1)


def outer(x, y):
    x, y = tensors(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


def kron(x, y):
    return torch.kron(*tensors(x, y))


def addmm(input, x, y, beta=1.0, alpha=1.0):
    x, y = tensors(x, y)
    return beta * as_tensor(input, like=x) + alpha * torch.matmul(x, y)


def einsum(equation, *operands):
    return torch.einsum(equation, *[as_tensor(o) for o in operands])


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(as_tensor(x), offset, axis1, axis2).sum(-1)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    """A 0-d bool tensor, as the JAX package returns an array."""
    x, y = tensors(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    ok = torch.allclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol,
                        equal_nan=equal_nan)
    return torch.tensor(builtins.bool(ok), device=x.device)
