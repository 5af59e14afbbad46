"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py).

Each initializer is a descriptor and a callable.  Its fields say what to
draw: the static graph maps them to startup ops (``static/layers.
_init_attrs``).  Called as ``init(shape, dtype=None, *, generator=None)``
it returns a CPU tensor drawn from ``generator`` (torch's default
generator when None), so one seed gives one set of weights on every
device; a model moves the tensor to its device afterwards.  Draws are fp32 and cast to
``dtype`` (the default dtype when None), as the JAX package's host draws
are.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core import dtype as _dtype

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign", "Bilinear"]


def _dt(dtype):
    return _dtype.get_default_dtype() if dtype is None else dtype


def _check_float(dtype):
    if not dtype.is_floating_point:
        raise ValueError(f"random initializers require a float dtype, got "
                         f"{dtype}")


def _uniform(shape, dtype, low, high, generator):
    dtype = _dt(dtype)
    _check_float(dtype)
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return (u * (high - low) + low).to(dtype)


def _normal(shape, dtype, mean, std, generator):
    dtype = _dt(dtype)
    _check_float(dtype)
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
    return (x * std + mean).to(dtype)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """Base of the initializers."""

    def __call__(self, shape, dtype=None, *,
                 generator: Optional[torch.Generator] = None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, *, generator=None):
        return torch.full(tuple(shape), self.value, dtype=_dt(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, *, generator=None):
        return _uniform(shape, dtype, self.low, self.high, generator)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, *, generator=None):
        return _normal(shape, dtype, self.mean, self.std, generator)


class TruncatedNormal(Initializer):
    """N(mean, std) cut at two standard deviations: the tail is drawn again
    (at most 8 rounds), then clipped, as the JAX package's host draw."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, *, generator=None):
        dtype = _dt(dtype)
        _check_float(dtype)
        x = torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32)
        for _ in range(8):
            out = (x < -2.0) | (x > 2.0)
            n_out = int(out.sum())
            if n_out == 0:
                break
            x[out] = torch.randn(n_out, generator=generator,
                                 dtype=torch.float32)
        x = x.clamp(-2.0, 2.0)
        return (x * self.std + self.mean).to(dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, *, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, dtype, -limit, limit, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, *, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _normal(shape, dtype, 0.0, std, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "relu":
            return math.sqrt(2.0)
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return 1.0

    def _fan_in(self, shape):
        return self.fan_in if self.fan_in is not None else _fans(shape)[0]

    def __call__(self, shape, dtype=None, *, generator=None):
        limit = self._gain() * math.sqrt(3.0 / self._fan_in(shape))
        return _uniform(shape, dtype, -limit, limit, generator)


class KaimingNormal(KaimingUniform):
    def __call__(self, shape, dtype=None, *, generator=None):
        std = self._gain() / math.sqrt(self._fan_in(shape))
        return _normal(shape, dtype, 0.0, std, generator)


class Assign(Initializer):
    """A fixed value of the requested shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, *, generator=None):
        t = torch.as_tensor(np.asarray(self.value)).to(_dt(dtype)).clone()
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Assign: value has shape {tuple(t.shape)}, the "
                             f"parameter {tuple(shape)}")
        return t


class Bilinear(Initializer):
    """Bilinear upsampling weights for a 4-D transposed-conv kernel."""

    def __call__(self, shape, dtype=None, *, generator=None):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects a 4-D conv kernel")
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[-1] / 2)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape[-2:]))):
            x, y = i % shape[-1], i // shape[-1]
            weight[..., y, x] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight).to(_dt(dtype))
