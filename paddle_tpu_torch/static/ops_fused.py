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
  activation op.  Training mode (``is_test=False``) raises: it needs the
  BN-statistics kernels of the vision training slice.
- ``fused_matmul_bias_act``: mul -> elementwise_add(1-D bias) -> act.

The quant ops (``quant_conv2d`` / ``quant_mul``) come with the int8 slice.
"""
from __future__ import annotations

from ..core import flags
from ..nn import functional as F
from ..nn.functional.norm import bn_inference_scale_bias
from ..ops.kernels import conv_fused as _cf
from .ops import _one, matmul_2d
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
        raise NotImplementedError(
            "fused_conv2d_bn_act in training mode (is_test=False) needs the "
            "BN-statistics and scale+act kernels (conv_fused._batch_stats "
            "and scale_act, rows 11-12), which come with the vision "
            "training slice; clone the program with for_test=True to run "
            "inference")

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

