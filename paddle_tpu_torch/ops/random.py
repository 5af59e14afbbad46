"""Random sampling ops (counterpart of paddle_tpu/ops/random.py; ref
python/paddle/tensor/random.py) on the port's ``core.random`` streams.

Each call draws its samples on the current device from a generator on
that device seeded by one draw from the active host generator
(``core.random.device_generator``): ``seed(n)`` makes a sequence of calls
repeat, on the card as on the CPU.  The draws are not ``jax.random``'s.
"""
from __future__ import annotations

import torch

from ..core import dtype as _dtype
from ..core import random as _random
from ..core.device import resolve_device
from ._util import as_tensor


def _dt(dtype):
    return _dtype.exact_dtype(dtype) or _dtype.get_default_dtype()


def _gen(device, seed=None):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return _random.device_generator(device)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=None):
    """U[min, max); a non-zero ``seed`` seeds this call alone."""
    dev = resolve_device()
    u = torch.rand(tuple(shape), generator=_gen(dev, seed), device=dev,
                   dtype=_dt(dtype))
    return u * (max - min) + min


def rand(shape, dtype=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def standard_normal(shape, dtype=None):
    dev = resolve_device()
    return torch.randn(tuple(shape), generator=_gen(dev), device=dev,
                       dtype=_dt(dtype))


def randn(shape, dtype=None):
    return standard_normal(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None):
    if shape is None:
        shape = tuple(mean.shape) if hasattr(mean, "shape") else ()
    return mean + std * standard_normal(shape)


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return torch.randint(low, high, tuple(shape), generator=_gen(dev),
                         device=dev, dtype=_dtype.exact_dtype(dtype))


def randperm(n, dtype="int64"):
    dev = resolve_device()
    return torch.randperm(n, generator=_gen(dev), device=dev,
                          dtype=_dtype.exact_dtype(dtype))


def bernoulli(x):
    x = as_tensor(x)
    return torch.bernoulli(x, generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False):
    x = as_tensor(x)
    return torch.multinomial(x, num_samples, replacement=replacement,
                             generator=_gen(x.device))
