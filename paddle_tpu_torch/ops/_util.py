"""Argument coercion shared by the op library."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as _dtype
from ..core.device import resolve_device


def as_tensor(x, like=None):
    """``x`` as a tensor: a tensor passes as it is; numpy arrays, lists and
    scalars go to the device of ``like`` (a tensor), else to the current
    device.  float64 data without a declared dtype becomes the default
    float dtype, as ``to_tensor`` makes it."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else resolve_device()
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        return torch.as_tensor(arr, dtype=_dtype.get_default_dtype(),
                               device=dev)
    return torch.as_tensor(arr, device=dev)


def operands(x, y):
    """The operands of a binary op: Python scalars stay scalars (weakly
    typed in torch as in JAX); other data becomes a tensor on the other
    operand's device."""
    if not isinstance(x, (torch.Tensor, bool, int, float, complex)):
        x = as_tensor(x, like=y)
    if not isinstance(y, (torch.Tensor, bool, int, float, complex)):
        y = as_tensor(y, like=x)
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = as_tensor(x)
    return x, y


def tensors(x, y):
    """Both operands as tensors, a scalar as a 0-d tensor beside the other
    operand (ops such as ``maximum`` take no scalar)."""
    x, y = operands(x, y)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=y.device)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, device=x.device)
    return x, y


def dims(axis, ndim):
    """An axis spec (None, int, list or tuple) as a tuple of dims; None is
    every dim."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def index(t):
    """An index tensor as int64, the dtype torch's indexing takes."""
    t = as_tensor(t)
    return t if t.dtype == torch.int64 else t.long()
