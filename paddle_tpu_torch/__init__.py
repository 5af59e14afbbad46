"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The port runs on an NVIDIA Hopper card (sm_90a).  Every Pallas kernel of
the JAX package that a ported path reaches becomes a CUDA C++ kernel under
``ops/kernels/csrc/``, built with nvcc at first use and bound with ctypes;
plain matrix products stay ``torch.matmul``.  Entry points run on the card
unless the caller passes ``device="cpu"`` (or calls ``set_device("cpu")``);
on CPU tensors each kernel wrapper runs its plain PyTorch version, which
is what the CPU tests hold against the JAX package.

As in the JAX package, the tensor op library (``ops``) is exported at the
top level and as ``tensor``, with the places, the dtype names, ``seed``,
the flags and ``no_grad``; subpackages (``nn``, ``dygraph``,
``optimizer``, ...) load on first use.  Tensors are ``torch.Tensor``.

This package imports torch and numpy only: nothing of jax and nothing of
paddle_tpu.  What it needs from there is copied.
"""
from __future__ import annotations

import torch as _torch

from . import core
from .core import errors, flags
from .core import tape as _tape
from .core.device import (
    CPUPlace,
    CUDAPlace,
    Place,
    TPUPlace,
    device_guard,
    get_device,
    is_compiled_with_tpu,
    resolve_device,
    set_device,
)
from .core.dtype import (
    bfloat16,
    bool_,
    complex64,
    complex128,
    float16,
    float32,
    float64,
    get_default_dtype,
    int8,
    int16,
    int32,
    int64,
    set_default_dtype,
    uint8,
)
from .core.flags import get_flags, set_flags
from .ops import *  # noqa: F401,F403 -- tensor op library at top level
from . import ops as tensor  # paddle.tensor namespace alias

# the star import binds ``ops.vision`` (the detection ops' module) here;
# ``vision`` at the top level is the model-zoo subpackage, loaded lazily
del vision  # noqa: F821

no_grad = _tape.no_grad_ctx

__version__ = "0.1.0"


def seed(value: int) -> None:
    """Reseed the port's random streams (``paddle.seed``): the host
    generator the random ops and dropout draw from (``core.random``) and
    torch's default generator, which initializers without a generator of
    their own draw from."""
    from .core import random as _random

    _random.seed(value)
    _torch.manual_seed(int(value))


def is_tensor(x) -> bool:
    return isinstance(x, _torch.Tensor)


# Subpackages imported lazily to keep `import paddle_tpu_torch` light;
# `paddle_tpu_torch.nn` etc. resolve on first attribute access.
_LAZY_SUBMODULES = (
    "nn",
    "dygraph",
    "optimizer",
    "amp",
    "autograd",
    "static",
    "io",
    "slim",
    "vision",
    "text",
    "utils",
    "serving",
    "convert",
    "entry",
)


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
