"""Long-tail tensor ops (counterpart of paddle_tpu/ops/extra.py): the
stats, elementwise, manipulation and linalg tail of the paddle.tensor
surface, as torch compositions.  Ops whose output shape depends on the
data (``bincount``) read it on the host, as the JAX package does."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ._util import as_tensor, index as _index, tensors

__all__ = [
    # stats
    "bincount", "median", "nanmedian", "quantile", "nanquantile", "corrcoef",
    "cov", "count_nonzero", "diff",
    # elementwise / math
    "frac", "rad2deg", "deg2rad", "gcd", "lcm", "heaviside", "nextafter",
    "angle", "conj", "real", "imag", "dist", "isclose", "renorm",
    "logaddexp", "ldexp", "copysign", "signbit", "sinc", "i0", "i0e", "i1",
    "i1e", "polygamma", "digamma", "lgamma", "multigammaln", "erfinv",
    "hypot", "square_",
    # manipulation
    "index_add", "index_put", "take", "bucketize", "crop", "unfold",
    "as_strided", "view", "view_as", "moveaxis", "rot90", "atleast_1d",
    "atleast_2d", "atleast_3d", "column_stack", "row_stack", "hstack",
    "vstack", "dstack", "hsplit", "vsplit", "dsplit", "tensor_split",
    "diagonal_scatter", "select_scatter", "slice_scatter",
    # linalg
    "tensordot", "inner", "mv", "lstsq", "eig", "eigvals", "eigh",
    "eigvalsh", "lu", "slogdet", "matrix_rank", "vander", "householder_product",
    "matrix_transpose", "diag_embed", "diagflat",
]


def _float_in(x):
    x = as_tensor(x)
    return x if x.is_floating_point() or x.is_complex() else x.float()


# ------------------------------------------------------------------- stats --
def bincount(x, weights=None, minlength: int = 0):
    """ref bincount_op: length max(minlength, max(x) + 1); the weights'
    dtype when weighted."""
    x = as_tensor(x)
    w = None if weights is None else as_tensor(weights, like=x)
    out = torch.bincount(_index(x), weights=w, minlength=int(minlength))
    return out if w is None else out.to(w.dtype)


def _quantile(fn, x, q, axis, keepdim):
    x = _float_in(x)
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), q, dim=0)
        if keepdim:
            out = out.reshape(tuple(q.shape) + (1,) * x.dim())
        return out
    return fn(x, q, dim=axis, keepdim=keepdim)


def median(x, axis=None, keepdim=False):
    """The mean of the two middle values for an even count, as numpy."""
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def corrcoef(x, rowvar: bool = True):
    x = _float_in(x)
    return torch.corrcoef(x if rowvar else x.T)


def cov(x, rowvar: bool = True, ddof: bool = True, fweights=None,
        aweights=None):
    x = _float_in(x)
    return torch.cov(x if rowvar or x.dim() < 2 else x.T,
                     correction=1 if ddof else 0,
                     fweights=None if fweights is None
                     else _index(fweights),
                     aweights=None if aweights is None
                     else as_tensor(aweights, like=x))


def count_nonzero(x, axis=None, keepdim=False):
    x = as_tensor(x)
    out = torch.count_nonzero(x, dim=axis)
    if keepdim:
        if axis is None:
            return out.reshape((1,) * x.dim())
        for a in sorted(d % x.dim() for d in ((axis,) if isinstance(
                axis, int) else axis)):
            out = out.unsqueeze(a)
    return out


def diff(x, n: int = 1, axis: int = -1, prepend=None, append=None):
    x = as_tensor(x)

    def edge(v):
        if v is None:
            return None
        v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        if v.dim() == 0:
            shape = list(x.shape)
            shape[axis] = 1
            v = v.expand(shape)
        return v

    return torch.diff(x, n=n, dim=axis, prepend=edge(prepend),
                      append=edge(append))


# ------------------------------------------------------------- elementwise --
def frac(x):
    x = as_tensor(x)
    return x - torch.trunc(x)


def rad2deg(x):
    return torch.rad2deg(_float_in(x))


def deg2rad(x):
    return torch.deg2rad(_float_in(x))


def gcd(x, y):
    return torch.gcd(*tensors(x, y))


def lcm(x, y):
    return torch.lcm(*tensors(x, y))


def heaviside(x, y):
    x, y = tensors(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.heaviside(x.to(dt), y.to(dt))


def nextafter(x, y):
    x, y = tensors(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.nextafter(x.to(dt), y.to(dt))


def angle(x):
    return torch.angle(_float_in(x))


def conj(x):
    x = as_tensor(x)
    return torch.conj_physical(x) if x.is_complex() else x


def real(x):
    x = as_tensor(x)
    return torch.real(x) if x.is_complex() else x


def imag(x):
    """The imaginary part; zeros for a real input, as numpy."""
    x = as_tensor(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def dist(x, y, p: float = 2):
    x, y = tensors(x, y)
    d = x - y
    if p == float("inf"):
        return torch.amax(torch.abs(d))
    if p == 0:
        return torch.sum(d != 0).to(d.dtype)
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = tensors(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.isclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def renorm(x, p: float, axis: int, max_norm: float):
    """Sub-tensors along ``axis`` renormalised to at most ``max_norm`` in
    ``p``-norm (ref renorm_op; the JAX package's 1e-7 guard)."""
    x = as_tensor(x)
    axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def logaddexp(x, y):
    x, y = tensors(x, y)
    return torch.logaddexp(_float_in(x), _float_in(y))


def ldexp(x, y):
    return torch.ldexp(*tensors(x, y))


def copysign(x, y):
    return torch.copysign(*tensors(x, y))


def signbit(x):
    return torch.signbit(as_tensor(x))


def sinc(x):
    return torch.sinc(_float_in(x))


def i0(x):
    return torch.special.i0(_float_in(x))


def i0e(x):
    return torch.special.i0e(_float_in(x))


def i1(x):
    return torch.special.i1(_float_in(x))


def i1e(x):
    return torch.special.i1e(_float_in(x))


def polygamma(x, n: int):
    return torch.polygamma(n, _float_in(x))


def digamma(x):
    return torch.digamma(_float_in(x))


def lgamma(x):
    return torch.lgamma(_float_in(x))


def multigammaln(x, p: int):
    return torch.special.multigammaln(_float_in(x), p)


def erfinv(x):
    return torch.erfinv(_float_in(x))


def hypot(x, y):
    x, y = tensors(x, y)
    return torch.hypot(_float_in(x), _float_in(y))


def square_(x):
    return torch.square(as_tensor(x))


# ------------------------------------------------------------ manipulation --
def index_add(x, index, axis, value):
    """``x`` with ``value``'s slices added at ``index`` along ``axis`` (ref
    index_add_op); repeated indices add up."""
    x = as_tensor(x)
    return torch.index_add(x, axis, _index(index),
                           as_tensor(value, like=x).to(x.dtype))


def index_put(x, indices, value, accumulate: bool = False):
    x = as_tensor(x)
    return x.index_put(tuple(_index(i) for i in indices),
                       as_tensor(value, like=x).to(x.dtype),
                       accumulate=accumulate)


def take(x, index, mode: str = "raise"):
    """Gather from the flattened ``x`` (ref take_op); ``wrap`` takes
    indices modulo the size, ``clip`` clamps them."""
    x = as_tensor(x).reshape(-1)
    index = _index(index)
    if mode == "wrap":
        index = torch.remainder(index, x.shape[0])
    elif mode == "clip":
        index = torch.clamp(index, 0, x.shape[0] - 1)
    return x[index]


def bucketize(x, sorted_sequence, out_int32: bool = False, right: bool = False):
    seq = as_tensor(sorted_sequence)
    return torch.searchsorted(seq, as_tensor(x, like=seq),
                              out_int32=out_int32, right=right)


def crop(x, shape, offsets=None):
    """Static crop (ref crop_tensor_op); -1 or None keeps a dim."""
    x = as_tensor(x)
    shape = [x.shape[i] if s in (-1, None) else int(s)
             for i, s in enumerate(shape)]
    offsets = [0] * x.dim() if offsets is None else [int(o) for o in offsets]
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col (ref unfold_op): [N, C, H, W] -> [N, C*kh*kw, L]."""
    return tF.unfold(as_tensor(x), kernel_sizes, dilation=dilations,
                     padding=paddings, stride=strides)


def as_strided(x, shape, stride, offset: int = 0):
    """The strided view of the flattened ``x``, as a copy (the JAX
    package's gather)."""
    flat = as_tensor(x).reshape(-1)
    return torch.as_strided(flat, tuple(shape), tuple(stride),
                            offset).clone()


def view(x, shape_or_dtype):
    x = as_tensor(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(shape_or_dtype))
    from ..core.dtype import exact_dtype

    return x.view(exact_dtype(shape_or_dtype))


def view_as(x, other):
    return as_tensor(x).reshape(tuple(as_tensor(other).shape))


def moveaxis(x, source, destination):
    return torch.movedim(as_tensor(x), source, destination)


def rot90(x, k: int = 1, axes=(0, 1)):
    return torch.rot90(as_tensor(x), k, dims=tuple(axes))


def _atleast(fn, xs):
    out = [fn(as_tensor(x)) for x in xs]
    return out[0] if len(out) == 1 else out


def atleast_1d(*xs):
    return _atleast(torch.atleast_1d, xs)


def atleast_2d(*xs):
    return _atleast(torch.atleast_2d, xs)


def atleast_3d(*xs):
    return _atleast(torch.atleast_3d, xs)


def column_stack(xs):
    return torch.column_stack([as_tensor(x) for x in xs])


def row_stack(xs):
    return torch.vstack([as_tensor(x) for x in xs])


def hstack(xs):
    return torch.hstack([as_tensor(x) for x in xs])


def vstack(xs):
    return torch.vstack([as_tensor(x) for x in xs])


def dstack(xs):
    return torch.dstack([as_tensor(x) for x in xs])


def hsplit(x, num_or_indices):
    return list(torch.hsplit(as_tensor(x), num_or_indices))


def vsplit(x, num_or_indices):
    return list(torch.vsplit(as_tensor(x), num_or_indices))


def dsplit(x, num_or_indices):
    return list(torch.dsplit(as_tensor(x), num_or_indices))


def tensor_split(x, num_or_indices, axis: int = 0):
    return list(torch.tensor_split(as_tensor(x), num_or_indices, dim=axis))


def diagonal_scatter(x, y, offset: int = 0, axis1: int = 0, axis2: int = 1):
    x = as_tensor(x)
    return torch.diagonal_scatter(x, as_tensor(y, like=x).to(x.dtype),
                                  offset, axis1, axis2)


def select_scatter(x, y, axis: int, index: int):
    x = as_tensor(x)
    return torch.select_scatter(x, as_tensor(y, like=x).to(x.dtype), axis,
                                index)


def slice_scatter(x, y, axis: int = 0, start=None, stop=None, step: int = 1):
    x = as_tensor(x)
    return torch.slice_scatter(x, as_tensor(y, like=x).to(x.dtype), axis,
                               start, stop, step)


# ------------------------------------------------------------------ linalg --
def tensordot(x, y, axes=2):
    return torch.tensordot(*tensors(x, y), dims=axes)


def inner(x, y):
    return torch.inner(*tensors(x, y))


def mv(x, vec):
    return torch.matmul(*tensors(x, vec))


def lstsq(x, y, rcond=None, driver=None):
    """(solution, residuals, rank, singular values), as
    ``numpy.linalg.lstsq``: the residuals' squared column norms when the
    system is overdetermined and of full rank, else empty.  ``driver`` is
    accepted (the card has one LAPACK-free driver)."""
    del driver
    x, y = tensors(x, y)
    vec = y.dim() == 1
    b = y[:, None] if vec else y
    sol = torch.linalg.lstsq(x, b, rcond=rcond).solution
    sv = torch.linalg.svdvals(x)
    tol = (sv.max() * max(x.shape[-2:]) * torch.finfo(sv.dtype).eps
           if rcond is None else sv.max() * rcond)
    rank = torch.sum(sv > tol)
    m, n = x.shape[-2:]
    if m > n and int(rank) == n:
        res = torch.sum(torch.square(b - x @ sol), dim=-2)
    else:
        res = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return (sol[:, 0] if vec else sol), res, rank, sv


def eig(x):
    return tuple(torch.linalg.eig(_float_in(x)))


def eigvals(x):
    return torch.linalg.eigvals(_float_in(x))


def eigh(x, UPLO: str = "L"):
    return tuple(torch.linalg.eigh(_float_in(x), UPLO=UPLO))


def eigvalsh(x, UPLO: str = "L"):
    return torch.linalg.eigvalsh(_float_in(x), UPLO=UPLO)


def lu(x, pivot: bool = True):
    """(LU packed, pivots) like the reference lu_op: pivots 0-based, as
    the JAX package's ``lu_factor`` gives them (LAPACK's are 1-based)."""
    lu_, piv = torch.linalg.lu_factor(_float_in(x), pivot=pivot)
    return lu_, piv - 1


def slogdet(x):
    return tuple(torch.linalg.slogdet(_float_in(x)))


def matrix_rank(x, tol=None, hermitian: bool = False):
    """The rank at relative tolerance ``tol`` (numpy's default when None),
    as the JAX package reads ``tol``."""
    return torch.linalg.matrix_rank(_float_in(x), rtol=tol,
                                    hermitian=hermitian)


def vander(x, n=None, increasing: bool = False):
    return torch.vander(as_tensor(x), N=n, increasing=increasing)


def householder_product(x, tau):
    """Q from Householder reflectors (ref householder_product op)."""
    x = as_tensor(x)
    return torch.linalg.householder_product(x, as_tensor(tau, like=x))


def matrix_transpose(x):
    return as_tensor(x).mT


def diag_embed(x, offset: int = 0, dim1: int = -2, dim2: int = -1):
    return torch.diag_embed(as_tensor(x), offset, dim1, dim2)


def diagflat(x, offset: int = 0):
    return torch.diagflat(as_tensor(x), offset)
