"""Dtype names (counterpart of paddle_tpu/core/dtype.py), mapped onto
torch dtypes.  Models serve in float32 or bfloat16; the static graph's
variables also name integer and bool types.

As in the JAX package, which runs with x64 off, the names "float64" and
"int64" resolve to their 32-bit types (``resolve`` does the same for a
torch dtype): a program that declares or is fed 64-bit values computes in
32 bits."""
from __future__ import annotations

import torch

float32 = torch.float32
bfloat16 = torch.bfloat16

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
