"""Tensor creation ops (counterpart of paddle_tpu/ops/creation.py; ref
python/paddle/tensor/creation.py).  New tensors go to the current device
(``core.device``: CUDA unless ``set_device`` or ``place=`` says
otherwise); the ``_like`` ops follow their input."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as _dtype
from ..core.device import resolve_device
from ._util import as_tensor


def _dt(dtype):
    return _dtype.exact_dtype(dtype)


def _float(dtype):
    return _dt(dtype) or _dtype.get_default_dtype()


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor from Python / numpy data or a tensor (copied), on
    ``place`` (default: the current device).  Floating data without a
    dtype takes the default float dtype.  ``stop_gradient=False`` makes a
    leaf that requires grad, so ``loss.backward()`` fills its ``.grad``."""
    dev = resolve_device(place)
    dt = _dt(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().to(device=dev, dtype=dt, copy=True)
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64:
            dt = _dtype.get_default_dtype()
        out = torch.as_tensor(np.array(arr), device=dev)
        if dt is not None:
            out = out.to(dt)
    if dt is None and out.is_floating_point() \
            and out.dtype == torch.float64:
        out = out.to(_dtype.get_default_dtype())
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def full(shape, fill_value, dtype=None):
    dt = _dt(dtype)
    if dt is None:
        if isinstance(fill_value, bool):
            dt = torch.bool
        elif isinstance(fill_value, (int, np.integer)):
            dt = torch.int64
        else:
            dt = _dtype.get_default_dtype()
    return torch.full(tuple(shape), fill_value, dtype=dt,
                      device=resolve_device())


def zeros(shape, dtype=None):
    return torch.zeros(tuple(shape), dtype=_float(dtype),
                       device=resolve_device())


def ones(shape, dtype=None):
    return torch.ones(tuple(shape), dtype=_float(dtype),
                      device=resolve_device())


def zeros_like(x, dtype=None):
    return torch.zeros_like(as_tensor(x), dtype=_dt(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(as_tensor(x), dtype=_dt(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(as_tensor(x), fill_value, dtype=_dt(dtype))


def empty(shape, dtype=None):
    """Zeros, as the JAX package gives (no uninitialised memory)."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=resolve_device())


def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num), dtype=_float(dtype),
                          device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_float(dtype),
                     device=resolve_device())


def meshgrid(*args):
    return list(torch.meshgrid(*[as_tensor(a) for a in args],
                               indexing="ij"))


def diag(x, offset=0, padding_value=0):
    x = as_tensor(x)
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        out = torch.where(torch.diag(keep, offset), out,
                          torch.full_like(out, padding_value))
    return out


def tril(x, diagonal=0):
    return torch.tril(as_tensor(x), diagonal)


def triu(x, diagonal=0):
    return torch.triu(as_tensor(x), diagonal)


def assign(x, output=None):
    """A copy of ``x`` (``output`` is accepted and ignored, as in the JAX
    package)."""
    del output
    x = as_tensor(x)
    return x.clone()
