"""Shape / layout manipulation ops (counterpart of
paddle_tpu/ops/manipulation.py; ref python/paddle/tensor/manipulation.py).
Lists come back where the JAX package returns lists."""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as _dtype
from ._util import as_tensor, index as _index


def reshape(x, shape):
    return torch.reshape(as_tensor(x), tuple(shape))


def transpose(x, perm):
    return as_tensor(x).permute(tuple(perm))


def cast(x, dtype):
    return as_tensor(x).to(_dtype.exact_dtype(dtype))


def concat(x, axis=0):
    return torch.cat([as_tensor(t) for t in x], dim=int(axis))


def stack(x, axis=0):
    return torch.stack([as_tensor(t) for t in x], dim=axis)


def unstack(x, axis=0, num=None):
    x = as_tensor(x)
    if num is not None and num != x.shape[axis]:
        raise ValueError(f"unstack: num {num} != shape[{axis}] "
                         f"{x.shape[axis]}")
    return list(torch.unbind(x, dim=axis))


def unbind(x, axis=0):
    return unstack(x, axis=axis)


def split(x, num_or_sections, axis=0):
    """ref: operators/split_op.cc -- sections may contain one -1; an int
    must divide the axis."""
    x = as_tensor(x)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"split: {num_or_sections} does not divide "
                             f"{total}")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    sections = list(num_or_sections)
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = total - known
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0):
    """``chunks`` pieces, the first ones one longer where the axis does not
    divide (numpy's ``array_split``)."""
    return list(torch.tensor_split(as_tensor(x), chunks, dim=axis))


def squeeze(x, axis=None):
    x = as_tensor(x)
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(a for a in axis if x.shape[a] == 1)
        return torch.squeeze(x, dim=axis) if axis else x
    return torch.squeeze(x, dim=axis) if x.shape[axis] == 1 else x


def unsqueeze(x, axis):
    x = as_tensor(x)
    if isinstance(axis, (list, tuple)):
        for a in sorted(axis):
            x = torch.unsqueeze(x, a)
        return x
    return torch.unsqueeze(x, axis)


def flatten(x, start_axis=0, stop_axis=-1):
    x = as_tensor(x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def flip(x, axis):
    return torch.flip(as_tensor(x), dims=tuple(axis) if isinstance(
        axis, (list, tuple)) else (axis,))


def roll(x, shifts, axis=None):
    return torch.roll(as_tensor(x), shifts, dims=axis)


def tile(x, repeat_times):
    return torch.tile(as_tensor(x), tuple(repeat_times))


def expand(x, shape):
    """ref: expand_v2 -- -1 keeps the original dim."""
    x = as_tensor(x)
    shape = tuple(x.shape[i - (len(shape) - x.dim())] if s == -1 else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


def expand_as(x, y):
    return torch.broadcast_to(as_tensor(x), tuple(as_tensor(y).shape))


def broadcast_to(x, shape):
    return torch.broadcast_to(as_tensor(x), tuple(shape))


def slice(x, axes, starts, ends):
    """ref: operators/slice_op.cc."""
    x = as_tensor(x)
    idx = [builtins.slice(None)] * x.dim()
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = builtins.slice(s, e)
    return x[tuple(idx)]


def gather(x, index, axis=0):
    """``numpy.take`` along ``axis``: the index's shape replaces the
    axis."""
    x = as_tensor(x)
    index = _index(index)
    out = torch.index_select(x, axis, index.reshape(-1))
    axis = axis % x.dim()
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


def gather_nd(x, index):
    x = as_tensor(x)
    index = _index(index)
    return x[tuple(index[..., i] for i in range(index.shape[-1]))]


def index_select(x, index, axis=0):
    return gather(x, index, axis)


def index_sample(x, index):
    return torch.take_along_dim(as_tensor(x), _index(index), dim=1)


def take_along_axis(x, indices, axis):
    return torch.take_along_dim(as_tensor(x), _index(indices), dim=axis)


def put_along_axis(x, indices, values, axis, reduce="assign"):
    x = as_tensor(x)
    indices = _index(indices)
    values = torch.broadcast_to(torch.as_tensor(values, dtype=x.dtype,
                                                device=x.device),
                                tuple(indices.shape))
    if reduce == "assign":
        return torch.scatter(x, axis, indices, values)
    if reduce == "add":
        return torch.scatter_add(x, axis, indices, values)
    if reduce == "multiply":
        return torch.scatter_reduce(x, axis, indices, values, "prod")
    raise ValueError(f"unknown reduce {reduce!r}")


def scatter(x, index, updates, overwrite=True):
    """ref: operators/scatter_op.cc -- row-wise scatter along axis 0;
    ``overwrite=False`` sums the updates of repeated rows."""
    x = as_tensor(x)
    index = _index(index)
    updates = as_tensor(updates, like=x).to(x.dtype)
    out = x.clone()
    if overwrite:
        out[index] = updates
        return out
    out[index] = torch.zeros_like(updates)
    return out.index_put_((index,), updates, accumulate=True)


def scatter_nd_add(x, index, updates):
    x = as_tensor(x)
    index = _index(index)
    idx = tuple(index[..., i] for i in range(index.shape[-1]))
    return x.clone().index_put_(idx, as_tensor(updates, like=x).to(x.dtype),
                                accumulate=True)


def masked_select(x, mask):
    """The elements where ``mask`` holds, as 1-D (a data-dependent shape:
    the card's result waits for the count)."""
    x = as_tensor(x)
    return torch.masked_select(x, as_tensor(mask, like=x).bool())


def repeat_interleave(x, repeats, axis=None):
    if isinstance(repeats, torch.Tensor):
        repeats = _index(repeats)
    return torch.repeat_interleave(as_tensor(x), repeats, dim=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False):
    """numpy's ``unique`` over the flattened input: sorted values, then the
    first index of each, the inverse (the input's shape) and the counts as
    asked (a data-dependent shape)."""
    x = as_tensor(x)
    flat = x.reshape(-1)
    values, inverse, counts = torch.unique(flat, sorted=True,
                                           return_inverse=True,
                                           return_counts=True)
    out = [values]
    if return_index:
        n = flat.shape[0]
        first = torch.full(values.shape, n, dtype=torch.int64,
                           device=x.device)
        out.append(first.scatter_reduce(
            0, inverse, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        out.append(inverse.reshape(x.shape))
    if return_counts:
        out.append(counts)
    return tuple(out) if len(out) > 1 else values
