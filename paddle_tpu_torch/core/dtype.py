"""Dtype names (counterpart of paddle_tpu/core/dtype.py), mapped onto
torch dtypes.  Models serve in float32 or bfloat16; the static graph's
variables also name integer and bool types.

As in the JAX package, which runs with x64 off, the names "float64" and
"int64" resolve to their 32-bit types (``resolve`` does the same for a
torch dtype): a program that declares or is fed 64-bit values computes in
32 bits.

The op library (``paddle_tpu_torch.ops``) takes dtypes as Paddle declares
them instead: ``exact_dtype("int64")`` is ``torch.int64``, and the
module-level names (``int64``, ``float64``, ... exported at the top level)
are the torch dtypes of those names.  The JAX package returns 32-bit
values there (x64 off); the port returns the declared type."""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float32,
    "fp64": torch.float32,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int32,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_DTYPE_TO_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                  torch.float16: "float16", torch.float64: "float64",
                  torch.int8: "int8", torch.int16: "int16",
                  torch.int32: "int32", torch.int64: "int64",
                  torch.uint8: "uint8", torch.bool: "bool"}
# 64-bit types and the 32-bit types they resolve to (x64 off)
_X32 = {torch.float64: torch.float32, torch.int64: torch.int32}

_default_dtype = torch.float32


def convert_dtype(dtype):
    """Normalize a dtype spec (name, numpy dtype or torch dtype) to a torch
    dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    try:
        return _NAME_TO_DTYPE[name]
    except KeyError:
        raise ValueError(f"Unknown dtype name: {dtype!r}") from None


_EXACT = {"bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
          "int32": int32, "int64": int64, "float16": float16,
          "fp16": float16, "bfloat16": bfloat16, "bf16": bfloat16,
          "float32": float32, "fp32": float32, "float64": float64,
          "fp64": float64, "complex64": complex64,
          "complex128": complex128}


def exact_dtype(dtype):
    """A dtype spec (name, numpy dtype or type, torch dtype) as the
    torch dtype of that name, 64-bit types kept; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, type):                 # numpy scalar types
        dtype = np.dtype(dtype)
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    try:
        return _EXACT[name]
    except KeyError:
        raise ValueError(f"Unknown dtype name: {dtype!r}") from None


def resolve(dtype) -> torch.dtype:
    """The dtype a value of ``dtype`` computes in: 64-bit types resolve to
    their 32-bit counterparts, as in the JAX package with x64 off."""
    d = convert_dtype(dtype)
    return _X32.get(d, d)


def dtype_name(dtype) -> str:
    """The numpy-style name of a dtype spec (``"float32"``), as the JAX
    package writes dtypes into op attributes."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def set_default_dtype(dtype) -> None:
    global _default_dtype
    d = convert_dtype(dtype)
    if d not in (torch.float32, torch.bfloat16):
        raise TypeError(f"default dtype must be float32 or bfloat16, got {d}")
    _default_dtype = d


class _Bfloat16:
    """numpy has no bfloat16: this stands in for the JAX package's
    ``np.dtype(jnp.bfloat16)`` where the static checkers compare, name and
    size dtypes (kind "V", two bytes, as ml_dtypes declares it)."""

    name = "bfloat16"
    kind = "V"
    itemsize = 2

    def __eq__(self, other):
        return other is self or other == "bfloat16" \
            or other is torch.bfloat16

    def __hash__(self):
        return hash("bfloat16")

    def __str__(self):
        return "bfloat16"

    def __repr__(self):
        return "dtype(bfloat16)"


BFLOAT16_NP = _Bfloat16()
_TORCH_TO_NP_NAME = {torch.float32: "float32", torch.float16: "float16",
                     torch.float64: "float64", torch.int8: "int8",
                     torch.int16: "int16", torch.int32: "int32",
                     torch.int64: "int64", torch.uint8: "uint8",
                     torch.bool: "bool", torch.complex64: "complex64",
                     torch.complex128: "complex128"}


def numpy_dtype(dtype):
    """A dtype spec (torch dtype, name, numpy dtype or scalar type) as the
    numpy dtype the JAX package's ``np.dtype`` gives for it, bfloat16 as
    ``BFLOAT16_NP``: what the static checkers price and name."""
    if dtype is BFLOAT16_NP or dtype is torch.bfloat16 \
            or dtype in ("bfloat16", "bf16"):
        return BFLOAT16_NP
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NP_NAME[dtype])
    return np.dtype(dtype)
