"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The port runs on an NVIDIA Hopper card (sm_90a).  Every Pallas kernel of
the JAX package that a ported path reaches becomes a CUDA C++ kernel under
``ops/kernels/csrc/``, built with nvcc at first use and bound with ctypes;
plain matrix products stay ``torch.matmul``.  Entry points run on the card
unless the caller passes ``device="cpu"``; on CPU tensors each kernel
wrapper runs its plain PyTorch version, which is what the CPU tests hold
against the JAX package.

This package imports torch and numpy only: nothing of jax and nothing of
paddle_tpu.  What it needs from there is copied.
"""
from __future__ import annotations

from .core import flags
from .core.device import resolve_device
from .core.dtype import get_default_dtype, set_default_dtype

__all__ = ["flags", "resolve_device", "get_default_dtype",
           "set_default_dtype"]
