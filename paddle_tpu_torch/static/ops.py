"""Lowering rules for the static-graph op set (counterpart of
paddle_tpu/static/ops.py).

The ops the vision programs reach, before and after the default pass
pipeline: the startup program's fill and random ops, assign and
assign_value (constant folding), and conv2d, pool2d, batch_norm, dropout,
mul, matmul, the elementwise ops, the activations a fusion may absorb,
softmax, the reductions and the shape ops; the losses and accuracy a
training program ends in; and the sgd / momentum / adam updates (the
other optimizer updates are in ops_tail.py).  Each rule computes what its JAX
counterpart computes, with torch ops on the Executor's device.

Rule signature: fn(ins: {slot: [tensors]}, attrs: dict, op) -> {slot:
[tensors]}.  Ops without inputs create their tensors on ``current_device()``
(the device of the Executor that runs them).  Random ops draw from the
active CPU ``torch.Generator`` (``core.random.current_generator()``; the
Executor opens one per op, seeded from the program seed, the step and the
op's salt) and move the draw to the device, so a startup program gives the
same values on the CPU and on the card.

``transpose2`` returns a permuted view and an is_test ``dropout`` its
input, so the ``transpose2`` pairs the NHWC layout pass leaves around an
is_test dropout hand the next NHWC op its producer's tensor, uncopied.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import dtype as _dtype_mod
from ..core import random as _random
from ..nn import functional as F
from .registry import register_op


class _DeviceState(threading.local):
    def __init__(self):
        self.device = torch.device("cpu")


_device_state = _DeviceState()


def current_device() -> torch.device:
    """The device the running Executor creates tensors on."""
    return _device_state.device


@contextlib.contextmanager
def device_scope(device):
    """Run the ops of a block on ``device`` (the Executor opens it)."""
    prev = _device_state.device
    _device_state.device = torch.device(device)
    try:
        yield
    finally:
        _device_state.device = prev


def _one(ins, slot):
    vs = ins.get(slot, [])
    return vs[0] if vs else None


def _empty():
    """The XShape output of the shape ops (an empty tensor, as in the JAX
    package)."""
    return torch.zeros((0,), device=current_device())


def _draw(fn, attrs):
    """A draw of ``attrs["shape"]`` in fp32 from the active CPU generator,
    cast and moved to the device."""
    shape = tuple(attrs["shape"])
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "float32"))
    out = fn(shape, _random.current_generator())
    return out.to(device=current_device(), dtype=dtype)


# -- creation / init ---------------------------------------------------------

@register_op("fill_constant")
def _fill_constant(ins, attrs, op):
    shape = tuple(attrs["shape"])
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0), dtype=dtype,
                               device=current_device())]}


@register_op("gaussian_random")
def _gaussian_random(ins, attrs, op):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    return {"Out": [_draw(lambda s, g: mean + std * torch.randn(
        s, generator=g), attrs)]}


@register_op("uniform_random")
def _uniform_random(ins, attrs, op):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    return {"Out": [_draw(lambda s, g: lo + (hi - lo) * torch.rand(
        s, generator=g), attrs)]}


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ins, attrs, op):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)

    def draw(shape, gen):
        x = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0,
                                        2.0, generator=gen)
        return mean + std * x

    return {"Out": [_draw(draw, attrs)]}


@register_op("assign")
def _assign(ins, attrs, op):
    return {"Out": [_one(ins, "X")]}


@register_op("assign_value")
def _assign_value(ins, attrs, op):
    values = attrs.get("fp32_values") or attrs.get("int32_values")
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.tensor(values, dtype=dtype, device=current_device())
                    .reshape(tuple(attrs["shape"]))]}


# -- math --------------------------------------------------------------------

def _bcast_axis(x, y, axis):
    """Reference elementwise broadcasting: align y's dims starting at `axis`
    (operators/elementwise/elementwise_op_function.h semantics)."""
    if axis is None or axis == -1 or x.dim() == y.dim():
        return y
    shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return y.reshape(shape)


def _elementwise(fn):
    def rule(ins, attrs, op):
        x, y = _one(ins, "X"), _one(ins, "Y")
        y = _bcast_axis(x, y, attrs.get("axis", -1))
        return {"Out": [fn(x, y)]}

    return rule


for _name, _fn in [("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.div),
                   ("elementwise_max", torch.maximum),
                   ("elementwise_min", torch.minimum),
                   ("elementwise_pow", torch.pow),
                   ("elementwise_mod", torch.remainder),
                   ("elementwise_floordiv", torch.floor_divide)]:
    register_op(_name)(_elementwise(_fn))


def matmul_2d(x, y, xd, yd):
    """The ``mul`` op's product: x flattened to 2-D at ``x_num_col_dims``,
    y at ``y_num_col_dims``, the result reshaped to ``xs[:xd] + ys[yd:]``."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xd])), int(np.prod(xs[xd:])))
    y2 = y.reshape(int(np.prod(ys[:yd])), int(np.prod(ys[yd:])))
    return (x2 @ y2).reshape(xs[:xd] + ys[yd:])


@register_op("mul")
def _mul(ins, attrs, op):
    """ref mul_op: flatten x to 2-D at x_num_col_dims then matmul."""
    return {"Out": [matmul_2d(_one(ins, "X"), _one(ins, "Y"),
                              attrs.get("x_num_col_dims", 1),
                              attrs.get("y_num_col_dims", 1))]}


def _mish(x):
    return x * torch.tanh(tF.softplus(x))


def _hard_swish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


# The activations a fusion may absorb (ops_fused.FUSABLE_ACTS).  The JAX
# package lowers the ``gelu`` op with jax.nn.gelu's default, the tanh
# approximation (the fused conv kernel's epilogue gelu is erf).
for _name, _ufn in [("relu", torch.relu), ("sigmoid", torch.sigmoid),
                    ("tanh", torch.tanh),
                    ("gelu", lambda x: tF.gelu(x, approximate="tanh")),
                    ("softplus", tF.softplus), ("silu", tF.silu),
                    ("swish", tF.silu), ("mish", _mish),
                    ("relu6", lambda x: torch.clamp(x, 0.0, 6.0)),
                    ("hard_swish", _hard_swish)]:
    def _make_unary(fn):
        def rule(ins, attrs, op):
            return {"Out": [fn(_one(ins, "X"))]}
        return rule
    register_op(_name)(_make_unary(_ufn))


@register_op("leaky_relu")
def _leaky_relu(ins, attrs, op):
    a = attrs.get("alpha", 0.02)
    x = _one(ins, "X")
    return {"Out": [torch.where(x >= 0, x, a * x)]}


@register_op("elu")
def _elu(ins, attrs, op):
    a = attrs.get("alpha", 1.0)
    x = _one(ins, "X")
    return {"Out": [torch.where(x >= 0, x, a * (torch.exp(x) - 1.0))]}


@register_op("softmax")
def _softmax(ins, attrs, op):
    return {"Out": [torch.softmax(_one(ins, "X"), dim=attrs.get("axis", -1))]}


@register_op("square")
def _square(ins, attrs, op):
    return {"Out": [torch.square(_one(ins, "X"))]}


@register_op("matmul")
def _matmul(ins, attrs, op):
    x, y = _one(ins, "X"), _one(ins, "Y")
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    return {"Out": [torch.matmul(x, y) * attrs.get("alpha", 1.0)]}


@register_op("mean")
def _mean(ins, attrs, op):
    return {"Out": [_one(ins, "X").mean()]}


def _reduce(fn):
    def rule(ins, attrs, op):
        x = _one(ins, "X")
        dim = attrs.get("dim", None)
        if attrs.get("reduce_all", False) or dim is None:
            dim = tuple(range(x.dim()))
        elif isinstance(dim, int):
            dim = (dim,)
        return {"Out": [fn(x, dim=tuple(dim),
                           keepdim=attrs.get("keep_dim", False))]}

    return rule


register_op("reduce_sum")(_reduce(torch.sum))
register_op("reduce_mean")(_reduce(torch.mean))


# -- shape manipulation ------------------------------------------------------

@register_op("reshape2")
def _reshape2(ins, attrs, op):
    x = _one(ins, "X")
    shape = list(attrs["shape"])
    # ref reshape semantics: 0 = copy input dim, -1 = infer
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [x.reshape(shape)], "XShape": [_empty()]}


@register_op("transpose2")
def _transpose2(ins, attrs, op):
    """A permuted view, never a copy."""
    return {"Out": [_one(ins, "X").permute(*attrs["axis"])],
            "XShape": [_empty()]}


@register_op("flatten2")
def _flatten2(ins, attrs, op):
    x = _one(ins, "X")
    ax = attrs.get("axis", 1)
    out = x.reshape(int(np.prod(x.shape[:ax])) if ax else 1,
                    int(np.prod(x.shape[ax:])))
    return {"Out": [out], "XShape": [_empty()]}


@register_op("flatten_contiguous_range")
def _flatten_contiguous_range(ins, attrs, op):
    x = _one(ins, "X")
    start = int(attrs.get("start_axis", 1)) % x.dim()
    stop = int(attrs.get("stop_axis", -1)) % x.dim()
    return {"Out": [x.flatten(start, stop)], "XShape": [_empty()]}


# -- nn ----------------------------------------------------------------------

@register_op("conv2d")
def _conv2d(ins, attrs, op):
    out = F.conv2d(_one(ins, "Input"), _one(ins, "Filter"),
                   bias=_one(ins, "Bias"),
                   stride=attrs.get("strides", 1),
                   padding=attrs.get("paddings", 0),
                   dilation=attrs.get("dilations", 1),
                   groups=attrs.get("groups", 1),
                   data_format=attrs.get("data_format", "NCHW"))
    return {"Output": [out]}


@register_op("pool2d")
def _pool2d(ins, attrs, op):
    x = _one(ins, "X")
    ptype = attrs.get("pooling_type", "max")
    fmt = attrs.get("data_format", "NCHW")
    if attrs.get("global_pooling", False):
        axes = (1, 2) if fmt == "NHWC" else (2, 3)
        out = (x.amax(dim=axes, keepdim=True) if ptype == "max"
               else x.mean(dim=axes, keepdim=True))
    elif attrs.get("adaptive", False):
        fn = (F.adaptive_max_pool2d if ptype == "max"
              else F.adaptive_avg_pool2d)
        out = fn(x, attrs["ksize"], data_format=fmt)
    else:
        fn = F.max_pool2d if ptype == "max" else F.avg_pool2d
        out = fn(x, attrs["ksize"], stride=attrs.get("strides", None),
                 padding=attrs.get("paddings", 0), data_format=fmt)
    return {"Out": [out]}


@register_op("batch_norm")
def _batch_norm(ins, attrs, op):
    training = not attrs.get("is_test", False)
    out, new_rm, new_rv = F.batch_norm(
        _one(ins, "X"), _one(ins, "Mean"), _one(ins, "Variance"),
        weight=_one(ins, "Scale"), bias=_one(ins, "Bias"),
        training=training, momentum=attrs.get("momentum", 0.9),
        epsilon=attrs.get("epsilon", 1e-5))
    return {"Y": [out], "MeanOut": [new_rm], "VarianceOut": [new_rv]}


@register_op("dropout")
def _dropout(ins, attrs, op):
    out = F.dropout(_one(ins, "X"), p=attrs.get("dropout_prob", 0.5),
                    training=not attrs.get("is_test", False),
                    mode=attrs.get("dropout_implementation",
                                   "upscale_in_train"))
    return {"Out": [out]}


# -- losses and metrics ------------------------------------------------------

def _hard_label(label, like):
    """A class-index label as int64 for ``torch.gather``, its trailing
    unit axis dropped (labels arrive as int32, as in the JAX package)."""
    lab = label[..., 0] if label.dim() == like.dim() else label
    return lab.long()


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ins, attrs, op):
    logits = _one(ins, "Logits")
    loss = F.softmax_with_cross_entropy(
        logits, _one(ins, "Label"), soft_label=attrs.get("soft_label", False),
        ignore_index=attrs.get("ignore_index", -100))
    if loss.dim() < logits.dim():
        loss = loss[..., None]
    return {"Loss": [loss], "Softmax": [torch.softmax(logits, dim=-1)]}


@register_op("cross_entropy")
def _cross_entropy(ins, attrs, op):
    """-log of the probability of the label, clamped at 1e-20 (``X`` holds
    probabilities, not logits)."""
    x, label = _one(ins, "X"), _one(ins, "Label")
    if attrs.get("soft_label", False):
        loss = -(label * torch.log(x.clamp_min(1e-20))).sum(-1, keepdim=True)
    else:
        p = torch.gather(x, -1, _hard_label(label, x)[..., None])
        loss = -torch.log(p.clamp_min(1e-20))
    return {"Y": [loss]}


@register_op("square_error_cost")
def _square_error_cost(ins, attrs, op):
    return {"Out": [torch.square(_one(ins, "X") - _one(ins, "Label"))]}


@register_op("accuracy")
def _accuracy(ins, attrs, op):
    """Top-1 accuracy; ``Correct`` is ``int32(accuracy * rows)``,
    truncated, as the JAX lowering computes it."""
    pred = _one(ins, "Out")
    top1 = pred.argmax(dim=-1)
    acc = (top1 == _hard_label(_one(ins, "Label"), pred)).float().mean()
    n = torch.tensor(pred.shape[0], dtype=torch.int32, device=pred.device)
    return {"Accuracy": [acc], "Correct": [(acc * n).to(torch.int32)],
            "Total": [n]}


# -- optimizer updates (ref operators/optimizers/; the fp32 master math of
#    paddle_tpu/static/ops.py, term for term) ---------------------------------

@register_op("sgd")
def _sgd(ins, attrs, op):
    p, g, lr = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "LearningRate")
    return {"ParamOut": [p - lr.to(p.dtype) * g.to(p.dtype)]}


@register_op("momentum")
def _momentum(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    v, lr = _one(ins, "Velocity"), _one(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    lr = lr.to(p.dtype)
    g = g.to(p.dtype)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}


@register_op("adam")
def _adam(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    m, v = _one(ins, "Moment1"), _one(ins, "Moment2")
    lr = _one(ins, "LearningRate").float()
    b1p = _one(ins, "Beta1Pow").float()
    b2p = _one(ins, "Beta2Pow").float()
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    gf = g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    lr_t = lr * torch.sqrt(1 - b2p * b2) / (1 - b1p * b1)
    p_new = p.float() - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {"ParamOut": [p_new.to(p.dtype)], "Moment1Out": [m_new],
            "Moment2Out": [v_new], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}
