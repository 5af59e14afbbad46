"""Weights from the JAX package into the port (counterpart of
paddle_tpu/autograd ``parameters_dict``).

The port's parameter names are the JAX package's qualified names, and
Linear weights keep Paddle's (in, out) layout, so conversion is a checked
copy.  Tied parameters are listed once in both packages (the MLM decoder
appears only as ``ernie.embeddings.word_embeddings.weight``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def parameters_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{qualified_name: parameter}, each tied tensor once, as the JAX
    package's ``parameters_dict``."""
    return dict(model.named_parameters())


def from_jax_params(np_params: Dict[str, np.ndarray], model: nn.Module,
                    dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Copy the JAX package's ``parameters_dict(model)`` output (as numpy
    arrays) into ``model`` in place, with strict key and shape checks.
    ``dtype`` casts every floating parameter afterwards (bfloat16 to serve);
    tied parameters stay tied.  Returns ``model``."""
    own = parameters_dict(model)
    missing = sorted(set(own) - set(np_params))
    unexpected = sorted(set(np_params) - set(own))
    if missing or unexpected:
        raise KeyError(f"from_jax_params: missing keys {missing}, "
                       f"unexpected keys {unexpected}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(np_params[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"from_jax_params: {name} has shape "
                                 f"{arr.shape}, the model expects "
                                 f"{tuple(p.shape)}")
            if arr.dtype.kind == "f" and arr.dtype != np.float64:
                arr = arr.astype(np.float32)
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    if dtype is not None:
        model.to(dtype)
    return model
