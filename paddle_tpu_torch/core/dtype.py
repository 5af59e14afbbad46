"""Dtype names (counterpart of paddle_tpu/core/dtype.py), mapped onto
torch dtypes.  Models serve in float32 or bfloat16; the static graph's
variables also name integer and bool types."""
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
    "float64": torch.float64,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_DTYPE_TO_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                  torch.float16: "float16", torch.float64: "float64",
                  torch.int8: "int8", torch.int32: "int32",
                  torch.int64: "int64", torch.bool: "bool"}

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
