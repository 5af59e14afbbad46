"""Comparison / logical / bitwise ops (counterpart of
paddle_tpu/ops/logic.py; ref python/paddle/tensor/logic.py)."""
from __future__ import annotations

import torch

from ._util import as_tensor, operands, tensors


def equal(x, y):
    return torch.eq(*tensors(x, y))


def not_equal(x, y):
    return torch.ne(*tensors(x, y))


def greater_than(x, y):
    return torch.gt(*tensors(x, y))


def greater_equal(x, y):
    return torch.ge(*tensors(x, y))


def less_than(x, y):
    return torch.lt(*tensors(x, y))


def less_equal(x, y):
    return torch.le(*tensors(x, y))


def equal_all(x, y):
    """A 0-d bool tensor: same shape and every element equal."""
    x, y = tensors(x, y)
    same = x.shape == y.shape and bool(torch.eq(x, y).all())
    return torch.tensor(same, device=x.device)


def logical_and(x, y):
    return torch.logical_and(*tensors(x, y))


def logical_or(x, y):
    return torch.logical_or(*tensors(x, y))


def logical_xor(x, y):
    return torch.logical_xor(*tensors(x, y))


def logical_not(x):
    return torch.logical_not(as_tensor(x))


def bitwise_and(x, y):
    return torch.bitwise_and(*operands(x, y))


def bitwise_or(x, y):
    return torch.bitwise_or(*operands(x, y))


def bitwise_xor(x, y):
    return torch.bitwise_xor(*operands(x, y))


def bitwise_not(x):
    return torch.bitwise_not(as_tensor(x))


def where(condition, x=None, y=None):
    """``x`` where ``condition`` holds, else ``y``; with neither, the
    indices of the true elements as a tuple (a data-dependent shape)."""
    condition = as_tensor(condition)
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    x, y = operands(x, y)
    return torch.where(condition.bool(), x, y)


def is_empty(x):
    x = as_tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)
