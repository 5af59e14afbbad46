"""Dtype names (counterpart of paddle_tpu/core/dtype.py), mapped onto
torch dtypes.  The model serves in float32 or bfloat16."""
from __future__ import annotations

import torch

float32 = torch.float32
bfloat16 = torch.bfloat16

_NAME_TO_DTYPE = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}

_default_dtype = torch.float32


def convert_dtype(dtype):
    """Normalize a dtype spec (name or torch dtype) to a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NAME_TO_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"Unknown dtype name: {dtype!r}") from None


def get_default_dtype() -> torch.dtype:
    return _default_dtype


def set_default_dtype(dtype) -> None:
    global _default_dtype
    d = convert_dtype(dtype)
    if d not in (torch.float32, torch.bfloat16):
        raise TypeError(f"default dtype must be float32 or bfloat16, got {d}")
    _default_dtype = d
