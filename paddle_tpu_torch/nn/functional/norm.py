"""LayerNorm (counterpart of paddle_tpu/nn/functional/norm.py
``layer_norm``).

With ``use_fused_layer_norm`` on, a last-axis norm with weight and bias goes
to kernel B (ops/kernels/layer_norm.py): the kernel on CUDA tensors, its
plain version on CPU tensors.  Otherwise the composition below runs, as in
the JAX package: fp32 statistics, the normalised value cast back to x's
dtype, then scale and shift.
"""
from __future__ import annotations

import torch

from ...core import flags
from ...ops.kernels import layer_norm as _fused


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(normalized_shape)
    if (weight is not None and bias is not None
            and flags.get_flag("use_fused_layer_norm")
            and len(normalized_shape) == 1
            and x.shape[-1] == normalized_shape[0]):
        return _fused.fused_layer_norm(x, weight, bias, epsilon)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, keepdim=True, unbiased=False)
    out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
