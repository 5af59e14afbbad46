"""Quantization helpers (counterpart of paddle_tpu/slim/quant.py: the
scale-axis contract, the fake-quant functions of quantization-aware
training and the PTQ weight path).

Per-channel weight scales are always indexed by the op's output-channel
axis: the axis that survives the contraction and lands on the NHWC minor
axis of the op's output, so a ``(O,)`` scale vector applies after the
int32 accumulation (ops/kernels/int8.py's epilogue).  Conv filters are
OIHW (axis 0); mul / matmul ``Y`` weights are (in, out) (the last axis;
axis 0 is the contraction axis, whose scales could not be applied after
the sum).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_WEIGHT_QUANT_AXIS = {
    "conv2d": 0, "depthwise_conv2d": 0, "conv3d": 0,
    "mul": -1, "matmul": -1, "matmul_v2": -1,
}


def weight_quant_axis(op_type: str, ndim: int) -> int:
    """Normalized per-channel quant axis of ``op_type``'s weight input,
    shared by the static PTQ (slim/quant_static.py) and the int8 lowerings
    (static/ops_fused.py)."""
    axis = _WEIGHT_QUANT_AXIS.get(op_type, 0)
    return axis % ndim if ndim else 0


def conv_quant_axis() -> int:
    """OIHW output-channel axis (the NHWC minor axis of the conv output)."""
    return 0


def _ste(x, q):
    """Straight-through estimator: forward ``q``, gradient the identity."""
    return x + (q - x).detach()


def fake_quant_dequant_abs_max(x, bit_length: int = 8):
    """Per-tensor abs-max quantize-dequantize (ref FakeQuantizeAbsMax).
    Returns ``(y, scale)``."""
    qmax = float(2 ** (bit_length - 1) - 1)
    scale = x.detach().abs().amax().clamp_min(1e-8)
    q = (x / scale * qmax).round() / qmax * scale
    return _ste(x, q), scale


def fake_channel_wise_quant_dequant_abs_max(w, bit_length: int = 8,
                                            quant_axis: int = 0):
    """Per-output-channel abs-max for weights (ref
    FakeChannelWiseQuantizeAbsMax).  Returns ``(y, scales[channels])``."""
    qmax = float(2 ** (bit_length - 1) - 1)
    axes = tuple(i for i in range(w.dim()) if i != quant_axis)
    scale = w.detach().abs().amax(dim=axes).clamp_min(1e-8)
    shape = [1] * w.dim()
    shape[quant_axis] = -1
    s = scale.reshape(shape)
    q = (w / s * qmax).round() / qmax * s
    return _ste(w, q), scale


def fake_quant_dequant_moving_average_abs_max(x, state, bit_length: int = 8,
                                              moving_rate: float = 0.9,
                                              training: bool = True):
    """Activation quant with an EMA abs-max scale (ref
    FakeQuantizeMovingAverageAbsMax); ``state`` is the scalar EMA scale.
    Returns ``(y, new_state)``.  Out of training an uncalibrated state (0)
    falls back to the batch's abs-max."""
    qmax = float(2 ** (bit_length - 1) - 1)
    cur = x.detach().abs().amax().clamp_min(1e-8)
    state = torch.as_tensor(state, dtype=cur.dtype, device=cur.device)
    if training:
        new_state = torch.where(
            state > 0, moving_rate * state + (1 - moving_rate) * cur, cur)
        s = new_state
    else:
        new_state = state
        s = torch.where(state > 0, state, cur)
    q = (x / s * qmax).round().clamp(-qmax - 1, qmax) / qmax * s
    return _ste(x, q), new_state


def quant_int8(w, quant_axis: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A float weight as (int8 array, per-channel fp32 steps): abs-max
    scales over every axis but ``quant_axis``, values rounded to the
    nearest of 255 levels (ref post_training_quantization.py
    _quantize_weight)."""
    w = np.asarray(w, np.float32)
    axes = tuple(i for i in range(w.ndim) if i != quant_axis)
    scale = np.maximum(np.abs(w).max(axis=axes), 1e-8)
    shape = [1] * w.ndim
    shape[quant_axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape) * 127.0), -128, 127)
    return q.astype(np.int8), (scale / 127.0).astype(np.float32)
