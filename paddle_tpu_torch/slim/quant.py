"""Quantization (counterpart of paddle_tpu/slim/quant.py): the scale-axis
contract, the fake-quant functions of quantization-aware training, the PTQ
weight path, and the dygraph QAT / PTQ: ``QuantizedLinear`` /
``QuantizedConv2D`` swapped in by ``ImperativeQuantAware``, and
``PostTrainingQuantization``, which calibrates activation ranges with
``_CalibHook`` and converts Linears to ``Int8Linear``.

Per-channel weight scales are always indexed by the op's output-channel
axis: the axis that survives the contraction and lands on the NHWC minor
axis of the op's output, so a ``(O,)`` scale vector applies after the
int32 accumulation (ops/kernels/int8.py's epilogue).  Conv filters are
OIHW (axis 0); mul / matmul ``Y`` weights are (in, out) (the last axis;
axis 0 is the contraction axis, whose scales could not be applied after
the sum).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..nn import functional as F
from ..nn.layer.base import Layer

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


# -------------------------------------------------------- QAT layer swap --
def _ema_scale_step(layer, x):
    """``x`` fake-quantized against the layer's moving-average scale; in
    training the fp32 scale buffer takes the new EMA (eager, in place).  Under
    recompute's replay the buffer already holds this step's value, so the
    replay would quantize against another scale: it raises instead."""
    from ..autograd import replaying

    if layer.training and replaying():
        raise NotImplementedError(
            "quantized layers under recompute are not ported: the replay "
            "would read the activation scale its forward already updated")
    # fp32 arithmetic against the fp32 scale, as the JAX package's
    # promotion gives; the result goes back to x's dtype for the product
    x_q, new_scale = fake_quant_dequant_moving_average_abs_max(
        x.float(), layer.in_scale, layer.activation_bits, layer.moving_rate,
        training=layer.training)
    if layer.training:
        with torch.no_grad():
            layer.in_scale.copy_(new_scale)
    return x_q.to(x.dtype)


class QuantizedLinear(Layer):
    """Linear with a channel-wise fake-quantized weight (output channels on
    axis 1 of the (in, out) weight) and a moving-average fake-quantized
    activation; the scale is the ``in_scale`` buffer."""

    def __init__(self, layer, weight_bits: int = 8, activation_bits: int = 8,
                 moving_rate: float = 0.9):
        super().__init__()
        self.inner = layer
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.register_buffer("in_scale", torch.zeros(
            (), dtype=torch.float32, device=layer.weight.device))

    def forward(self, x):
        x_q = _ema_scale_step(self, x)
        w_q, _ = fake_channel_wise_quant_dequant_abs_max(
            self.inner.weight, self.weight_bits, quant_axis=1)
        return F.linear(x_q, w_q, self.inner.bias)


class QuantizedConv2D(Layer):
    """Conv2D with a channel-wise fake-quantized filter (axis 0) and a
    moving-average fake-quantized activation (``in_scale``)."""

    def __init__(self, layer, weight_bits: int = 8, activation_bits: int = 8,
                 moving_rate: float = 0.9):
        super().__init__()
        self.inner = layer
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.register_buffer("in_scale", torch.zeros(
            (), dtype=torch.float32, device=layer.weight.device))

    def forward(self, x):
        x_q = _ema_scale_step(self, x)
        w_q, _ = fake_channel_wise_quant_dequant_abs_max(
            self.inner.weight, self.weight_bits, quant_axis=0)
        inner = self.inner
        return F.conv2d(x_q, w_q, inner.bias, stride=inner.stride,
                        padding=inner.padding, dilation=inner.dilation,
                        groups=inner.groups, data_format=inner.data_format)


_DEFAULT_QUANTIZABLE = ("Linear", "Conv2D")


class ImperativeQuantAware:
    """QAT driver: swaps the model's Linear / Conv2D children for their
    fake-quant wrappers in place; the model then trains as before and its
    buffers carry the learned activation scales."""

    def __init__(self, weight_bits: int = 8, activation_bits: int = 8,
                 moving_rate: float = 0.9,
                 quantizable_layer_type: Sequence[str] = _DEFAULT_QUANTIZABLE):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.types = tuple(quantizable_layer_type)

    def _wrap(self, layer):
        name = type(layer).__name__
        if name == "Linear" and "Linear" in self.types:
            return QuantizedLinear(layer, self.weight_bits,
                                   self.activation_bits, self.moving_rate)
        if name == "Conv2D" and "Conv2D" in self.types:
            return QuantizedConv2D(layer, self.weight_bits,
                                   self.activation_bits, self.moving_rate)
        return layer

    def quantize(self, model):
        for name, child in list(model.named_children()):
            wrapped = self._wrap(child)
            if wrapped is not child:
                setattr(model, name, wrapped)
            else:
                self.quantize(child)
        return model


# ------------------------------------------------------------------- PTQ --
class _CalibHook(Layer):
    """Records the largest |input| over calibration forwards (one host read
    a call, as in the JAX package)."""

    def __init__(self, layer):
        super().__init__()
        self.inner = layer
        self.abs_max = 0.0

    def forward(self, x, *args, **kwargs):
        self.abs_max = max(self.abs_max, float(x.detach().abs().max()))
        return self.inner(x, *args, **kwargs)


def _ceil_to(n, m):
    return -(-n // m) * m


def int8_matmul(x_q, w):
    """The exact int32 product of int8 ``x_q`` (..., K) and ``w`` (K, N),
    as the JAX package's ``dot_general(preferred_element_type=int32)``
    (no Pallas kernel in either package).  On the CPU an int64 product,
    narrowed.  On the card ``torch._int_mm``, with zero rows / columns
    padded to its shape rules (M > 16, K and N multiples of 8), which
    leaves every sum as it is; an int32 accumulator or a dtype it does not
    take raises there, and nothing falls back to floats."""
    lead = x_q.shape[:-1]
    a = x_q.reshape(-1, x_q.shape[-1])
    if a.device.type != "cuda":
        return (a.to(torch.int64) @ w.to(torch.int64)).to(
            torch.int32).reshape(*lead, w.shape[1])
    m, k = a.shape
    n = w.shape[1]
    mp, kp, np_ = max(_ceil_to(m, 8), 24), _ceil_to(k, 8), _ceil_to(n, 8)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(a.contiguous(), w.contiguous())
    return acc[:m, :n].reshape(*lead, n)


class Int8Linear(Layer):
    """A PTQ-converted Linear: the input quantized to int8 against the
    calibrated ``in_scale`` (step in_scale / qmax), the exact int32 product
    with the int8 (in, out) weight, then the fp32 rescale ``acc *
    (w_scale * s_in) + bias``."""

    def __init__(self, w_int8: np.ndarray, w_scale: np.ndarray,
                 bias: Optional[np.ndarray], in_scale: float,
                 activation_bits: int = 8, *, device=None):
        super().__init__()
        dev = torch.device("cpu") if device is None else torch.device(device)
        self.register_buffer("w_int8", torch.as_tensor(
            np.asarray(w_int8, np.int8)).to(dev))
        self.register_buffer("w_scale", torch.as_tensor(
            np.asarray(w_scale, np.float32)).to(dev))
        if bias is not None:
            self.register_buffer("bias", torch.as_tensor(
                np.asarray(bias, np.float32)).to(dev))
        self.has_bias = bias is not None
        self.in_scale = float(in_scale)
        self.qmax = float(2 ** (activation_bits - 1) - 1)

    def quantize_input(self, x):
        s_in = self.in_scale / self.qmax
        return torch.clamp(torch.round(x.float() / s_in), -self.qmax - 1,
                           self.qmax).to(torch.int8)

    def forward(self, x):
        s_in = self.in_scale / self.qmax
        acc = int8_matmul(self.quantize_input(x), self.w_int8)
        y = acc.to(torch.float32) * (self.w_scale * s_in)
        if self.has_bias:
            y = y + self.bias
        return y


class PostTrainingQuantization:
    """Dygraph PTQ: calibrate activation ranges on sample data, then convert
    the Linear layers to ``Int8Linear``::

        ptq = PostTrainingQuantization(model)
        for batch in calib: ptq.sample(batch)     # eval-mode forwards
        qmodel = ptq.convert()                     # the model, mutated

    (The static-graph PTQ over a Program is ``quant_static``'s.)"""

    def __init__(self, model, activation_bits: int = 8):
        self.model = model
        self.activation_bits = activation_bits
        self._hooked: List[Tuple[nn.Module, str, _CalibHook]] = []
        self._install(model)

    def _install(self, layer):
        for name, child in list(layer.named_children()):
            if type(child).__name__ == "Linear":
                hook = _CalibHook(child)
                setattr(layer, name, hook)
                self._hooked.append((layer, name, hook))
            else:
                self._install(child)

    def sample(self, *args, **kwargs):
        """One calibration forward pass, in eval mode, without autograd."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return self.model(*args, **kwargs)
        finally:
            if was_training:
                self.model.train()

    def convert(self):
        """Replace the hooked Linears with ``Int8Linear`` at the calibrated
        scales; returns the model (mutated in place)."""
        for parent, name, hook in self._hooked:
            lin = hook.inner
            if hook.abs_max <= 0:
                raise RuntimeError(
                    f"layer {name!r} saw no calibration data; call sample() "
                    "with representative batches before convert()")
            w_int8, w_scale = quant_int8(
                lin.weight.detach().float().cpu().numpy(), quant_axis=1)
            bias = (None if lin.bias is None
                    else lin.bias.detach().float().cpu().numpy())
            setattr(parent, name, Int8Linear(
                w_int8, w_scale, bias, hook.abs_max, self.activation_bits,
                device=lin.weight.device))
        self._hooked = []
        return self.model
