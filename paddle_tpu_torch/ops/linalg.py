"""Linear algebra ops (counterpart of paddle_tpu/ops/linalg.py; ref
python/paddle/tensor/linalg.py) on ``torch.linalg``.  Decompositions
agree with the JAX package's up to the signs and order their
definitions leave free."""
from __future__ import annotations

import math

import torch

from ._util import as_tensor, dims


def t(x):
    x = as_tensor(x)
    return x.T if x.dim() >= 2 else x


def norm(x, p="fro", axis=None, keepdim=False):
    x = as_tensor(x)
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        return torch.linalg.vector_norm(x, 2, dim=dims(axis, x.dim()),
                                        keepdim=keepdim)
    d = None if axis is None else dims(axis, x.dim())
    if p == math.inf:
        return torch.amax(torch.abs(x), dim=d or (), keepdim=keepdim)
    if p == -math.inf:
        return torch.amin(torch.abs(x), dim=d or (), keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=d, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=d, keepdim=keepdim) ** (1.0 / p)


def cholesky(x, upper=False):
    return torch.linalg.cholesky(as_tensor(x), upper=upper)


def inverse(x):
    return torch.linalg.inv(as_tensor(x))


def det(x):
    return torch.linalg.det(as_tensor(x))


def svd(x, full_matrices=False):
    """(U, S, Vh), as ``numpy.linalg.svd``."""
    return tuple(torch.linalg.svd(as_tensor(x), full_matrices=full_matrices))


def qr(x, mode="reduced"):
    """(Q, R); R alone for ``mode="r"``, as ``numpy.linalg.qr``."""
    q, r = torch.linalg.qr(as_tensor(x), mode=mode)
    return r if mode == "r" else (q, r)


def pinv(x, rcond=1e-15):
    return torch.linalg.pinv(as_tensor(x), rtol=rcond)


def solve(a, b):
    a = as_tensor(a)
    return torch.linalg.solve(a, as_tensor(b, like=a))


def triangular_solve(a, b, upper=True, transpose=False, unitriangular=False):
    a = as_tensor(a)
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, as_tensor(b, like=a),
                                         upper=upper,
                                         unitriangular=unitriangular)


def matrix_power(x, n):
    return torch.linalg.matrix_power(as_tensor(x), n)


def cross(x, y, axis=None):
    x = as_tensor(x)
    return torch.linalg.cross(x, as_tensor(y, like=x),
                              dim=-1 if axis is None else axis)


def histogram(x, bins=100, min=0, max=0):
    """Counts (int64) of ``bins`` equal bins over [min, max], the data's
    range when both are 0; the last bin holds its right edge."""
    x = as_tensor(x)
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    xf = x if x.is_floating_point() else x.float()
    return torch.histc(xf, bins=bins, min=lo, max=hi).to(torch.int64)
