"""Lowerings for the fused ops the pass pipeline emits (counterpart of
paddle_tpu/static/ops_fused.py).

- ``fused_conv2d_bn_act``: conv2d -> batch_norm -> act as one op.
  Inference has two executions of the same math.  Where
  ``_use_pallas_conv`` holds (the ``use_pallas_conv_fused`` flag and the
  JAX package's shape gate: NHWC, C and O % 128, ...), the conv runs as
  the fused kernel (ops/kernels/conv_fused.py) with the per-channel BN
  transform ``a * x + b`` and the activation as its epilogue: the kernel
  on CUDA tensors, its plain version on CPU tensors.  Otherwise BN is
  folded into the filter (``w' = w * a`` per output channel, ``b' =
  conv_bias * a + b``) and cuDNN runs one convolution, followed by the
  activation op.  Training mode (``is_test=False``) runs the library
  conv, then ``nn.functional.norm.batch_norm_act`` (the batch-statistics
  and scale + act kernels where the flag and ``train_supported`` hold),
  and writes the running statistics to ``MeanOut`` / ``VarianceOut``.
- ``fused_matmul_bias_act``: mul -> elementwise_add(1-D bias) -> act.
- ``quant_conv2d`` / ``quant_mul``: the int8 inference ops the
  ``quant_infer`` pass makes from PTQ artifacts.  Where the
  ``use_pallas_int8`` flag, a per-output-channel ``weight_scale`` and the
  JAX gate (``conv_supported`` / ``matmul_supported``) hold, the input is
  quantized to int8 (the fixed-scale lowering's rounding, per call), the
  weight's int8 grid recovered as ``round(w / step_w)`` and the combined
  scale formed (once per Filter version and quant attrs, ``_quant_weight``;
  the JAX package redoes both per call), and the int8 kernel
  (ops/kernels/int8.py) sums in int32 with the fp32 dequant and act as its
  epilogue.  Otherwise the simulate route replays the registered
  fixed-scale lowering and the float op: bit for bit the program before
  the rewrite.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import flags
from ..nn import functional as F
from ..nn.functional.norm import batch_norm_act, bn_inference_scale_bias
from ..ops.kernels import conv_fused as _cf
from ..ops.kernels import int8 as _int8
from .ops import _one, matmul_2d
from .ops_tail import qmax as _qmax
from .registry import get_lowering, register_op


def _pair(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1])) if len(v) >= 2 \
            else (int(v[0]), int(v[0]))
    return (int(v), int(v))


# Activations a fusion pattern may absorb: value-wise, attr-free in the
# emitted-by-layers form, with a registered X->Out lowering.
FUSABLE_ACTS = frozenset({
    "relu", "gelu", "sigmoid", "tanh", "relu6", "silu", "swish",
    "leaky_relu", "hard_swish", "softplus", "mish", "elu",
})


def _apply_act(out, act, attrs, op):
    if not act:
        return out
    return get_lowering(act)({"X": [out]}, attrs, op)["Out"][0]


def _use_pallas_conv(x, w, stride, padding, dilation, groups, act,
                     data_format) -> bool:
    """Dispatch to the fused conv kernel: the flag and the JAX package's
    shape gate.  String paddings (SAME/VALID) stay on the library conv."""
    if not (isinstance(padding, tuple) and data_format == "NHWC"):
        return False
    if not flags.get_flag("use_pallas_conv_fused"):
        return False
    return _cf.supported(x, tuple(w.shape), stride, padding, dilation,
                         groups, act, data_format)


@register_op("fused_conv2d_bn_act")
def _fused_conv2d_bn_act(ins, attrs, op):
    x = _one(ins, "Input")
    w = _one(ins, "Filter")
    conv_bias = _one(ins, "Bias")
    act = attrs.get("act", "")
    data_format = attrs.get("data_format", "NCHW")
    stride = _pair(attrs.get("strides", 1))
    dilation = _pair(attrs.get("dilations", 1))
    groups = attrs.get("groups", 1)
    raw_padding = attrs.get("paddings", 0)
    padding = raw_padding if isinstance(raw_padding, str) \
        else _pair(raw_padding)

    if not attrs.get("is_test", True):
        # training: the library conv, then the fused BN statistics + scale
        # + act with the running-stat outputs
        out = F.conv2d(x, w, bias=conv_bias, stride=stride,
                       padding=raw_padding, dilation=dilation, groups=groups,
                       data_format=data_format)
        y, new_rm, new_rv = batch_norm_act(
            out, _one(ins, "Mean"), _one(ins, "Variance"),
            weight=_one(ins, "Scale"), bias=_one(ins, "BnBias"),
            momentum=attrs.get("momentum", 0.9),
            epsilon=attrs.get("epsilon", 1e-5), act=act,
            data_format=data_format)
        return {"Output": [y], "MeanOut": [new_rm], "VarianceOut": [new_rv]}

    a, b = bn_inference_scale_bias(
        _one(ins, "Mean"), _one(ins, "Variance"),
        _one(ins, "Scale"), _one(ins, "BnBias"),
        attrs.get("epsilon", 1e-5))
    if conv_bias is not None:
        b = b + conv_bias.float() * a

    if _use_pallas_conv(x, w, stride, padding, dilation, groups, act,
                        data_format):
        out = _cf.conv2d_bn_act(x, w, a, b, stride=stride, padding=padding,
                                act=act)
        return {"Output": [out]}

    # weight-space fold: scale each OUTPUT channel's filter (OIHW axis 0)
    w = w * a.to(w.dtype).reshape(-1, 1, 1, 1)
    out = F.conv2d(x, w, bias=b.to(x.dtype), stride=stride,
                   padding=raw_padding, dilation=dilation, groups=groups,
                   data_format=data_format)
    return {"Output": [_apply_act(out, act, attrs, op)]}


def _quantize_int8(x, scale, qmax):
    """Symmetric quantization with the fixed-scale lowering's rounding:
    ``round(clip(x / scale, -1, 1) * qmax)`` as int8, contiguous."""
    return (x / scale).clamp(-1.0, 1.0).mul(qmax).round() \
        .to(torch.int8).contiguous()


def _simulate_qdq(x, in_scale, in_bits, op):
    """The simulate route's input: the registered fixed-scale fake-quant
    lowering the quant_infer pass removed, replayed as it is."""
    return get_lowering("fake_quantize_dequantize_fixed_scale")(
        {"X": [x]}, {"bit_length": in_bits, "scale": in_scale}, op)["Out"][0]


def _quant_weight(w, weight_scale, in_scale, in_bits, w_bits, device,
                  shape, axis):
    """(w_q, scale) of a quant op: the Filter's int8 grid ``round(w /
    step_w)`` (w viewed as ``shape``, one step per index of ``axis``,
    ``step_w = weight_scale / qmax_w``) and the kernel's combined scale
    ``(in_scale / qmax_in) * step_w``, on ``device``.  Made once per Filter
    version and storage and quant attrs, and kept on the Filter tensor (the
    int8 wrapper keeps the kernel's K-major layout of w_q beside it), so a
    run whose weights are unchanged rebuilds neither."""
    key = (w._version, w.data_ptr(), str(device), tuple(shape),
           tuple(weight_scale), in_scale, in_bits, w_bits)
    hit = getattr(w, "_quant_int8", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    qm_in, qm_w = _qmax(in_bits), _qmax(w_bits)
    w_scale = torch.tensor(weight_scale, dtype=torch.float32, device=device)
    step_w = w_scale / qm_w
    view = [1] * len(shape)
    view[axis] = -1
    # the weight in the scope is int8-simulated (q / qmax * scale with q
    # integral), so dividing by the step recovers the int8 grid point
    w_q = torch.round(w.reshape(shape) / step_w.reshape(view)) \
        .to(torch.int8)
    value = (w_q, (in_scale / qm_in) * step_w)
    w._quant_int8 = (key, value)
    return value


def _int8_spec(shape):
    """A shape-and-dtype stand-in for the quantized input, for the gates."""
    return torch.empty(tuple(shape), dtype=torch.int8, device="meta")


@register_op("quant_conv2d")
def _quant_conv2d(ins, attrs, op):
    x = _one(ins, "Input")
    w = _one(ins, "Filter")
    bias = _one(ins, "Bias")
    act = attrs.get("act", "")
    data_format = attrs.get("data_format", "NCHW")
    stride = _pair(attrs.get("strides", 1))
    dilation = _pair(attrs.get("dilations", 1))
    groups = attrs.get("groups", 1)
    raw_padding = attrs.get("paddings", 0)
    padding = raw_padding if isinstance(raw_padding, str) \
        else _pair(raw_padding)
    in_scale = float(attrs["in_scale"])
    in_bits = int(attrs.get("in_bits", 8))
    w_scales = attrs["weight_scale"]                          # (O,)
    w_bits = int(attrs.get("weight_bits", 8))

    if (isinstance(padding, tuple) and data_format == "NHWC"
            and np.shape(w_scales)[0] == w.shape[0]
            and flags.get_flag("use_pallas_int8")
            and _int8.conv_supported(_int8_spec(x.shape), tuple(w.shape),
                                     stride, padding, dilation, groups, act,
                                     data_format)):
        x_q = _quantize_int8(x, in_scale, _qmax(in_bits))
        w_q, scale = _quant_weight(w, w_scales, in_scale, in_bits, w_bits,
                                   x.device, tuple(w.shape), 0)
        out = _int8.int8_conv2d_dequant(
            x_q, w_q, scale, bias=None if bias is None else bias.float(),
            stride=stride, padding=padding, act=act, out_dtype=x.dtype)
        return {"Output": [out]}

    xq = _simulate_qdq(x, in_scale, in_bits, op)
    out = F.conv2d(xq, w, bias=bias, stride=stride, padding=raw_padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    return {"Output": [_apply_act(out, act, attrs, op)]}


@register_op("quant_mul")
def _quant_mul(ins, attrs, op):
    x, y = _one(ins, "X"), _one(ins, "Y")
    act = attrs.get("act", "")
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    in_scale = float(attrs["in_scale"])
    in_bits = int(attrs.get("in_bits", 8))
    w_scales = attrs["weight_scale"]                          # (out,)
    w_bits = int(attrs.get("weight_bits", 8))
    x2_shape = (int(np.prod(xs[:xd])), int(np.prod(xs[xd:])))
    y2_shape = (int(np.prod(ys[:yd])), int(np.prod(ys[yd:])))

    # per-channel scales line up with the flattened output only when the
    # weight's quant axis is its flattened minor axis
    if (np.shape(w_scales)[0] == y2_shape[1]
            and flags.get_flag("use_pallas_int8")
            and _int8.matmul_supported(_int8_spec(x2_shape), y2_shape,
                                       act)):
        x_q = _quantize_int8(x.reshape(x2_shape), in_scale, _qmax(in_bits))
        w_q, scale = _quant_weight(y, w_scales, in_scale, in_bits, w_bits,
                                   x.device, y2_shape, 1)
        out2 = _int8.int8_matmul_dequant(x_q, w_q, scale, act=act,
                                         out_dtype=x.dtype)
        return {"Out": [out2.reshape(xs[:xd] + ys[yd:])]}

    xq = _simulate_qdq(x, in_scale, in_bits, op)
    out = matmul_2d(xq, y, xd, yd)
    return {"Out": [_apply_act(out, act, attrs, op)]}


@register_op("fused_matmul_bias_act")
def _fused_matmul_bias_act(ins, attrs, op):
    # the mul lowering's product, then the add and the act ops' math
    out = matmul_2d(_one(ins, "X"), _one(ins, "Y"),
                    attrs.get("x_num_col_dims", 1),
                    attrs.get("y_num_col_dims", 1))
    bias = _one(ins, "Bias")
    if bias is not None:
        out = out + bias          # 1-D bias broadcasts on the last axis
    return {"Out": [_apply_act(out, attrs.get("act", ""), attrs, op)]}

