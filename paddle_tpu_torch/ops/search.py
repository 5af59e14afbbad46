"""Search / sort ops (counterpart of paddle_tpu/ops/search.py; ref
python/paddle/tensor/search.py).  Indices are int64, the dtype Paddle
declares (the JAX package's are int32 with x64 off)."""
from __future__ import annotations

import torch

from ..core import dtype as _dtype
from ._util import as_tensor, index as _index


def _arg(fn, x, axis, keepdim, dtype):
    x = as_tensor(x)
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=axis, keepdim=keepdim)
    return out.to(_dtype.exact_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False):
    """Stable: equal values keep their order."""
    return torch.argsort(as_tensor(x), dim=axis, descending=descending,
                         stable=True)


def sort(x, axis=-1, descending=False):
    return torch.sort(as_tensor(x), dim=axis, descending=descending,
                      stable=True).values


def topk(x, k, axis=-1, largest=True, sorted=True):
    """ref: operators/top_k_v2_op.cc.  Returns (values, indices), sorted
    (as the JAX package's ``lax.top_k``, whatever ``sorted`` says)."""
    del sorted
    out = torch.topk(as_tensor(x), k, dim=axis, largest=largest, sorted=True)
    return out.values, out.indices


def kthvalue(x, k, axis=-1, keepdim=False):
    out = torch.kthvalue(as_tensor(x), k, dim=axis, keepdim=keepdim)
    return out.values, out.indices


def mode(x, axis=-1, keepdim=False):
    """Most frequent value along ``axis`` (ref mode_op) and the index of
    its first occurrence; ties resolve to the smallest value.  A run-length
    count over a sort, as the JAX package does."""
    x = as_tensor(x)
    moved = torch.movedim(x, axis, -1)
    sorted_x = torch.sort(moved, dim=-1).values
    n = sorted_x.shape[-1]
    eq = torch.cat([torch.zeros_like(sorted_x[..., :1], dtype=torch.bool),
                    sorted_x[..., 1:] == sorted_x[..., :-1]], -1)
    idxs = torch.arange(n, device=x.device)
    run_start = torch.cummax(torch.where(eq, 0, idxs), dim=-1).values
    best = torch.argmax(idxs - run_start + 1, dim=-1)
    values = torch.take_along_dim(sorted_x, best[..., None], -1)[..., 0]
    indices = torch.argmax((moved == values[..., None]).to(torch.uint8),
                           dim=-1)
    if keepdim:
        values = values.unsqueeze(axis)
        indices = indices.unsqueeze(axis)
    return values, indices


def nonzero(x, as_tuple=False):
    """Indices of the non-zero elements, (n, ndim) or a tuple (a
    data-dependent shape)."""
    return torch.nonzero(as_tensor(x), as_tuple=as_tuple)


def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    seq = as_tensor(sorted_sequence)
    return torch.searchsorted(seq, as_tensor(values, like=seq),
                              out_int32=out_int32, right=right)


def masked_fill(x, mask, value):
    x = as_tensor(x)
    return torch.where(as_tensor(mask, like=x).bool(),
                       torch.as_tensor(value, dtype=x.dtype, device=x.device),
                       x)


def index_sample(x, index):
    return torch.take_along_dim(as_tensor(x), _index(index), dim=1)
