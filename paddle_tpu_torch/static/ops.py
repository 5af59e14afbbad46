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
    return {"Out": [x.flatten(start, stop)],
            "XShape": [torch.zeros((0,) + tuple(x.shape), dtype=x.dtype,
                                   device=x.device)]}


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


# -- the rest of paddle_tpu/static/ops.py: casts, reductions, shape ops,
#    comparisons, the long tail of math and losses, padded sequence ops,
#    vision and CRF ops (each delegates to the port's op library where the
#    JAX rule delegates to its own) ---------------------------------------

def _int32(t):
    """An index result in the static graph's "int64", which resolves to
    int32 in both packages (x64 off)."""
    return t.to(_dtype_mod.convert_dtype("int64"))


@register_op("cast")
def _cast(ins, attrs, op):
    return {"Out": [_one(ins, "X").to(
        _dtype_mod.convert_dtype(attrs["out_dtype"]))]}


@register_op("scale")
def _scale(ins, attrs, op):
    x = _one(ins, "X")
    s, b = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


def _unary_rule(fn):
    def rule(ins, attrs, op):
        return {"Out": [fn(_one(ins, "X"))]}
    return rule


for _name, _ufn in [
        ("exp", torch.exp), ("log", torch.log), ("sqrt", torch.sqrt),
        ("abs", torch.abs), ("floor", torch.floor), ("ceil", torch.ceil),
        ("softsign", tF.softsign), ("sin", torch.sin), ("cos", torch.cos),
        ("tan", torch.tan), ("asin", torch.asin), ("acos", torch.acos),
        ("atan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("rsqrt", torch.rsqrt), ("reciprocal", lambda x: 1.0 / x),
        ("round", torch.round), ("sign", torch.sign), ("log2", torch.log2),
        ("log10", torch.log10), ("log1p", torch.log1p),
        ("expm1", torch.expm1), ("erf", torch.erf), ("selu", tF.selu),
        ("logsigmoid", tF.logsigmoid)]:
    register_op(_name)(_unary_rule(_ufn))


def _reduce_prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = x.prod(dim=d, keepdim=keepdim)
    return x


register_op("reduce_max")(_reduce(torch.amax))
register_op("reduce_min")(_reduce(torch.amin))
register_op("reduce_prod")(_reduce(_reduce_prod))


@register_op("sum")
def _sum(ins, attrs, op):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("clip")
def _clip(ins, attrs, op):
    return {"Out": [torch.clamp(_one(ins, "X"), attrs.get("min"),
                                attrs.get("max"))]}


@register_op("concat")
def _concat(ins, attrs, op):
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("split")
def _split(ins, attrs, op):
    x = _one(ins, "X")
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    if num:
        outs = torch.chunk(x, num, dim=axis)
    else:
        outs = torch.split(x, list(attrs["sections"]), dim=axis)
    return {"Out": list(outs)}


@register_op("stack")
def _stack(ins, attrs, op):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("squeeze2")
def _squeeze2(ins, attrs, op):
    x = _one(ins, "X")
    axes = tuple(a % x.dim() for a in attrs.get("axes", ()))
    out = x.squeeze(axes) if axes else x.squeeze()
    return {"Out": [out], "XShape": [_empty()]}


@register_op("unsqueeze2")
def _unsqueeze2(ins, attrs, op):
    x = _one(ins, "X")
    for a in sorted(attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": [x], "XShape": [_empty()]}


register_op("reshape")(_reshape2)
register_op("transpose")(_transpose2)


@register_op("layer_norm")
def _layer_norm(ins, attrs, op):
    x = _one(ins, "X")
    ax = attrs.get("begin_norm_axis", 1)
    out = F.layer_norm(x, tuple(x.shape[ax:]), weight=_one(ins, "Scale"),
                       bias=_one(ins, "Bias"),
                       epsilon=attrs.get("epsilon", 1e-5))
    return {"Y": [out]}


def lookup(w, ids, attrs):
    """One embedding lookup: a gather of ``w``'s rows, the ``padding_idx``
    rows zeroed (and so given zero gradient)."""
    pad = attrs.get("padding_idx", -1)
    pad = None if pad is None or int(pad) < 0 else int(pad)
    flat = ids.reshape(-1).long()
    out = w.index_select(0, flat)
    if pad is not None:
        out = out * (flat != pad).to(out.dtype)[:, None]
    return out.reshape(tuple(ids.shape) + (int(w.shape[-1]),))


@register_op("lookup_table_v2")
def _lookup_table_v2(ins, attrs, op):
    return {"Out": [lookup(_one(ins, "W"), _one(ins, "Ids"), attrs)]}


@register_op("top_k")
def _top_k(ins, attrs, op):
    vals, idx = torch.topk(_one(ins, "X"), attrs.get("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx.to(torch.int32)]}


@register_op("arg_max")
def _arg_max(ins, attrs, op):
    return {"Out": [_int32(torch.argmax(_one(ins, "X"),
                                        dim=attrs.get("axis", -1)))]}


@register_op("arg_min")
def _arg_min(ins, attrs, op):
    return {"Out": [_int32(torch.argmin(_one(ins, "X"),
                                        dim=attrs.get("axis", -1)))]}


# comparisons / logicals (ref operators/controlflow/compare_op.cc,
# logical_op.cc): booleans feed the cond / while lowerings
def _compare(fn):
    def rule(ins, attrs, op):
        return {"Out": [fn(_one(ins, "X"), _one(ins, "Y"))]}
    return rule


for _name, _cfn in [("less_than", torch.lt), ("less_equal", torch.le),
                    ("greater_than", torch.gt), ("greater_equal", torch.ge),
                    ("equal", torch.eq), ("not_equal", torch.ne),
                    ("logical_and", torch.logical_and),
                    ("logical_or", torch.logical_or),
                    ("logical_xor", torch.logical_xor)]:
    register_op(_name)(_compare(_cfn))


@register_op("logical_not")
def _logical_not(ins, attrs, op):
    return {"Out": [torch.logical_not(_one(ins, "X"))]}


@register_op("increment")
def _increment(ins, attrs, op):
    x = _one(ins, "X")
    return {"Out": [x + torch.tensor(attrs.get("step", 1.0)).to(x.dtype)]}


@register_op("hard_sigmoid")
def _hard_sigmoid(ins, attrs, op):
    slope, offset = attrs.get("slope", 0.2), attrs.get("offset", 0.5)
    return {"Out": [torch.clamp(slope * _one(ins, "X") + offset, 0.0, 1.0)]}


@register_op("pow")
def _pow(ins, attrs, op):
    return {"Out": [torch.pow(_one(ins, "X"), attrs.get("factor", 1.0))]}


@register_op("log_softmax")
def _log_softmax(ins, attrs, op):
    return {"Out": [torch.log_softmax(_one(ins, "X"),
                                      dim=attrs.get("axis", -1))]}


@register_op("cumsum")
def _cumsum(ins, attrs, op):
    x = _one(ins, "X")
    axis = attrs.get("axis")
    if attrs.get("flatten", False) or axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    reverse = attrs.get("reverse", False)
    out = (torch.cumsum(x.flip(axis), dim=axis).flip(axis) if reverse
           else torch.cumsum(x, dim=axis))
    if attrs.get("exclusive", False):
        # shift by one along `axis`, a zero entering on the side the sum
        # starts from (cumsum_op's exclusive semantics in both directions)
        zero = torch.zeros_like(out.narrow(axis, 0, 1))
        n = out.shape[axis]
        out = (torch.cat([out.narrow(axis, 1, n - 1), zero], axis) if reverse
               else torch.cat([zero, out.narrow(axis, 0, n - 1)], axis))
    return {"Out": [out]}


@register_op("gather")
def _gather(ins, attrs, op):
    x, idx = _one(ins, "X"), _one(ins, "Index")
    axis = attrs.get("axis", 0)
    out = x.index_select(axis, idx.reshape(-1).long())
    shape = (tuple(x.shape[:axis % x.dim()]) + tuple(idx.shape)
             + tuple(x.shape[axis % x.dim() + 1:]))
    return {"Out": [out.reshape(shape)]}


@register_op("gather_nd")
def _gather_nd(ins, attrs, op):
    x, idx = _one(ins, "X"), _one(ins, "Index").long()
    return {"Out": [x[tuple(idx.movedim(-1, 0))]]}


@register_op("scatter")
def _scatter(ins, attrs, op):
    x, ids, upd = _one(ins, "X"), _one(ins, "Ids"), _one(ins, "Updates")
    ids = ids.reshape(-1).long()
    if attrs.get("overwrite", True):
        return {"Out": [x.index_put((ids,), upd.to(x.dtype))]}
    return {"Out": [x.index_add(0, ids, upd.to(x.dtype))]}


@register_op("slice")
def _slice(ins, attrs, op):
    x = _one(ins, "Input")
    sl = [slice(None)] * x.dim()
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        sl[ax] = slice(s, e)
    return {"Out": [x[tuple(sl)]]}


@register_op("expand_v2")
def _expand_v2(ins, attrs, op):
    x = _one(ins, "X")
    lead = len(attrs["shape"]) - x.dim()
    shape = [x.shape[i - lead] if s == -1 else s
             for i, s in enumerate(attrs["shape"])]
    return {"Out": [x.expand(shape)]}


@register_op("tile")
def _tile(ins, attrs, op):
    return {"Out": [torch.tile(_one(ins, "X"), tuple(attrs["repeat_times"]))]}


@register_op("where")
def _where(ins, attrs, op):
    c, x, y = _one(ins, "Condition"), _one(ins, "X"), _one(ins, "Y")
    return {"Out": [torch.where(c.bool(), x, y)]}


def one_hot(x, depth):
    """``jax.nn.one_hot``: float32 rows, all zero for an index outside
    ``[0, depth)``."""
    x = x.long()
    hot = (x[..., None] == torch.arange(depth, device=x.device))
    return hot.float()


@register_op("one_hot_v2")
def _one_hot_v2(ins, attrs, op):
    return {"Out": [one_hot(_one(ins, "X"), attrs["depth"])]}


@register_op("range")
def _range(ins, attrs, op):
    s, e, st = _one(ins, "Start"), _one(ins, "End"), _one(ins, "Step")
    out = torch.arange(float(s), float(e), float(st), dtype=torch.float64)
    return {"Out": [out.to(device=s.device, dtype=s.dtype)]}


@register_op("shape")
def _shape(ins, attrs, op):
    x = _one(ins, "Input")
    return {"Out": [torch.tensor(tuple(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register_op("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ins, attrs, op):
    ref = _one(ins, "Input")
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(shape, attrs["value"], device=ref.device,
                               dtype=_dtype_mod.convert_dtype(
                                   attrs.get("dtype", "float32")))]}


@register_op("fill_zeros_like")
def _fill_zeros_like(ins, attrs, op):
    return {"Out": [torch.zeros_like(_one(ins, "X"))]}


@register_op("pad2d")
def _pad2d(ins, attrs, op):
    """ref pad2d_op: NCHW [top, bottom, left, right]."""
    p = attrs["paddings"]
    return {"Out": [F.pad(_one(ins, "X"), [p[2], p[3], p[0], p[1]],
                          mode=attrs.get("mode", "constant"),
                          value=attrs.get("pad_value", 0.0),
                          data_format="NCHW")]}


def pad_pairs(x, pairs, value=0.0):
    """``jnp.pad(x, pairs, constant_values=value)``."""
    flat = []
    for lo, hi in reversed(list(pairs)):
        flat += [int(lo), int(hi)]
    return tF.pad(x, flat, value=value)


@register_op("pad")
def _pad(ins, attrs, op):
    x = _one(ins, "X")
    p = attrs["paddings"]
    return {"Out": [pad_pairs(x, [(p[2 * i], p[2 * i + 1])
                                  for i in range(x.dim())],
                              attrs.get("pad_value", 0.0))]}


@register_op("maximum")
def _maximum(ins, attrs, op):
    return {"Out": [torch.maximum(_one(ins, "X"), _one(ins, "Y"))]}


@register_op("minimum")
def _minimum(ins, attrs, op):
    return {"Out": [torch.minimum(_one(ins, "X"), _one(ins, "Y"))]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ins, attrs, op):
    return {"Out": [torch.square(_one(ins, "X")).sum().reshape(1)]}


@register_op("huber_loss")
def _huber_loss(ins, attrs, op):
    x, y = _one(ins, "X"), _one(ins, "Y")
    d = attrs.get("delta", 1.0)
    r = torch.abs(x - y)
    loss = torch.where(r <= d, 0.5 * r * r, d * (r - 0.5 * d))
    return {"Out": [loss], "Residual": [x - y]}


@register_op("smooth_l1_loss")
def _smooth_l1_loss(ins, attrs, op):
    x, y = _one(ins, "X"), _one(ins, "Y")
    sigma2 = attrs.get("sigma", 1.0) ** 2
    d = torch.abs(x - y)
    loss = torch.where(d < 1.0 / sigma2, 0.5 * d * d * sigma2,
                       d - 0.5 / sigma2)
    return {"Out": [loss.sum(dim=tuple(range(1, x.dim())), keepdim=True)],
            "Diff": [x - y]}


@register_op("relu_grad_passthrough")
def _relu_grad_passthrough(ins, attrs, op):
    return {"Out": [_one(ins, "X")]}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_xent(ins, attrs, op):
    x, label = _one(ins, "X"), _one(ins, "Label")
    loss = torch.clamp_min(x, 0) - x * label \
        + torch.log1p(torch.exp(-torch.abs(x)))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        loss = loss / torch.clamp_min((label != ignore).sum(), 1)
    return {"Out": [loss]}


@register_op("log_loss")
def _log_loss(ins, attrs, op):
    p, label = _one(ins, "Predicted"), _one(ins, "Labels")
    e = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + e)
                     - (1 - label) * torch.log(1 - p + e)]}


@register_op("label_smooth")
def _label_smooth(ins, attrs, op):
    x = _one(ins, "X")
    eps = attrs.get("epsilon", 0.1)
    prior = _one(ins, "PriorDist")
    smooth = prior if prior is not None else 1.0 / x.shape[-1]
    return {"Out": [(1 - eps) * x + eps * smooth]}


@register_op("norm")
def _l2_normalize(ins, attrs, op):
    x = _one(ins, "X")
    n = torch.sqrt(torch.square(x).sum(dim=attrs.get("axis", -1),
                                       keepdim=True))
    return {"Out": [x / torch.clamp_min(n, attrs.get("epsilon", 1e-10))],
            "Norm": [n]}


@register_op("kldiv_loss")
def _kldiv_loss(ins, attrs, op):
    x, tgt = _one(ins, "X"), _one(ins, "Target")
    loss = tgt * (torch.log(torch.clamp_min(tgt, 1e-20)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": [loss]}


# -- padded sequence ops (ops/sequence.py, ops/misc.py) ----------------------

@register_op("sequence_mask")
def _sequence_mask(ins, attrs, op):
    from ..ops import sequence as _seq

    mask = _seq.sequence_mask(_one(ins, "X"), maxlen=int(attrs["maxlen"]),
                              dtype=attrs.get("out_dtype", "float32"))
    return {"Y": [mask.to(_dtype_mod.convert_dtype(
        attrs.get("out_dtype", "float32")))]}


@register_op("sequence_last_step_padded")
def _sequence_last_step_padded(ins, attrs, op):
    from ..ops import sequence as _seq

    return {"Out": [_seq.sequence_last_step(_one(ins, "X"),
                                            _one(ins, "Lengths"))]}


@register_op("sequence_pool_padded")
def _sequence_pool_padded(ins, attrs, op):
    from ..ops import sequence as _seq

    pool = attrs.get("pooltype", "sum").lower()
    pool = {"average": "mean"}.get(pool, pool)
    return {"Out": [_seq.sequence_pool(
        _one(ins, "X"), _one(ins, "Lengths"), pool_type=pool,
        pad_value=float(attrs.get("pad_value", 0.0)))]}


@register_op("sequence_softmax_padded")
def _sequence_softmax_padded(ins, attrs, op):
    from ..ops import sequence as _seq

    return {"Out": [_seq.sequence_softmax(_one(ins, "X"),
                                          _one(ins, "Lengths"))]}


@register_op("sequence_reverse_padded")
def _sequence_reverse_padded(ins, attrs, op):
    from ..ops import sequence as _seq

    return {"Y": [_seq.sequence_reverse(_one(ins, "X"),
                                        _one(ins, "Lengths"))]}


@register_op("sequence_first_step_padded")
def _sequence_first_step_padded(ins, attrs, op):
    from ..ops import sequence as _seq

    return {"Out": [_seq.sequence_first_step(_one(ins, "X"),
                                             _one(ins, "Lengths"))]}


@register_op("sequence_conv_padded")
def _sequence_conv_padded(ins, attrs, op):
    from ..ops import misc as _misc

    lengths = ins.get("Lengths")
    return {"Out": [_misc.sequence_conv(
        _one(ins, "X"), _one(ins, "Filter"),
        lengths=lengths[0] if lengths else None,
        context_length=attrs["contextLength"],
        context_start=attrs.get("contextStart"))]}


# the reference's names of the padded rules (JAX: ops_tail3 / ops_tail5)
for _ref, _padded in [("sequence_pool", _sequence_pool_padded),
                      ("sequence_conv", _sequence_conv_padded),
                      ("sequence_reverse", _sequence_reverse_padded),
                      ("sequence_softmax", _sequence_softmax_padded)]:
    register_op(_ref)(_padded)


# -- nn / vision --------------------------------------------------------------

@register_op("conv2d_transpose")
def _conv2d_transpose(ins, attrs, op):
    return {"Output": [F.conv2d_transpose(
        _one(ins, "Input"), _one(ins, "Filter"), bias=_one(ins, "Bias"),
        stride=attrs.get("strides", 1), padding=attrs.get("paddings", 0),
        output_padding=attrs.get("output_padding", 0),
        dilation=attrs.get("dilations", 1), groups=attrs.get("groups", 1))]}


@register_op("group_norm")
def _group_norm(ins, attrs, op):
    return {"Y": [F.group_norm(_one(ins, "X"), attrs["groups"],
                               weight=_one(ins, "Scale"),
                               bias=_one(ins, "Bias"),
                               epsilon=attrs.get("epsilon", 1e-5))]}


@register_op("instance_norm")
def _instance_norm(ins, attrs, op):
    return {"Y": [F.instance_norm(_one(ins, "X"), weight=_one(ins, "Scale"),
                                  bias=_one(ins, "Bias"),
                                  epsilon=attrs.get("epsilon", 1e-5))]}


@register_op("prelu")
def _prelu(ins, attrs, op):
    return {"Out": [F.prelu(_one(ins, "X"), _one(ins, "Alpha"))]}


@register_op("resize_interp")
def _resize_interp(ins, attrs, op):
    return {"Out": [F.interpolate(
        _one(ins, "X"), size=tuple(attrs["out_shape"]),
        mode=attrs["interp_method"],
        align_corners=attrs.get("align_corners", False))]}


@register_op("prior_box")
def _prior_box(ins, attrs, op):
    from ..ops import vision as V

    x, img = _one(ins, "Input"), _one(ins, "Image")
    boxes, variances = V.prior_box(
        (x.shape[2], x.shape[3]), (img.shape[2], img.shape[3]),
        min_sizes=list(attrs["min_sizes"]),
        max_sizes=list(attrs.get("max_sizes", [])),
        aspect_ratios=list(attrs.get("aspect_ratios", [1.0])),
        variances=list(attrs.get("variances", [0.1, 0.1, 0.2, 0.2])),
        flip=attrs.get("flip", False), clip=attrs.get("clip", False),
        steps=attrs.get("steps", (0.0, 0.0)),
        offset=attrs.get("offset", 0.5))
    return {"Boxes": [boxes.to(x.device)],
            "Variances": [variances.to(x.device)]}


@register_op("box_coder")
def _box_coder(ins, attrs, op):
    from ..ops import vision as V

    return {"OutputBox": [V.box_coder(
        _one(ins, "PriorBox"), _one(ins, "PriorBoxVar"),
        _one(ins, "TargetBox"), attrs["code_type"],
        box_normalized=attrs.get("box_normalized", True),
        axis=attrs.get("axis", 0))]}


def _batch_one(x, what):
    if x.dim() == 4:
        if x.shape[0] != 1:
            raise ValueError(
                f"static {what} lowers the batch-1 kernel; split the batch "
                f"into per-image calls (got N={x.shape[0]})")
        x = x[0]
    return x


@register_op("roi_align")
def _roi_align(ins, attrs, op):
    from ..ops import vision as V

    return {"Out": [V.roi_align(
        _batch_one(_one(ins, "X"), "roi_align"), _one(ins, "ROIs"),
        output_size=(attrs["pooled_height"], attrs["pooled_width"]),
        spatial_scale=attrs.get("spatial_scale", 1.0),
        sampling_ratio=attrs.get("sampling_ratio", -1))]}


@register_op("linear_chain_crf")
def _linear_chain_crf(ins, attrs, op):
    from ..ops import crf as _crf

    return {"LogLikelihood": [_crf.linear_chain_crf(
        _one(ins, "Emission"), _one(ins, "Label"), _one(ins, "Transition"),
        _one(ins, "Length"))]}


@register_op("crf_decoding")
def _crf_decoding(ins, attrs, op):
    from ..ops import crf as _crf

    return {"ViterbiPath": [_crf.crf_decoding(
        _one(ins, "Emission"), _one(ins, "Transition"),
        _one(ins, "Length"))]}


def _misc_op(op_type, in_slots, out_slot="Out", attr_names=()):
    """A lowering forwarding to the ops.misc function of the same name."""
    from ..ops import misc as _misc

    fn = getattr(_misc, op_type)

    @register_op(op_type)
    def _lowered(ins, attrs, op):
        args = [_one(ins, slot) for slot in in_slots]
        kwargs = {name: attrs[name] for name in attr_names if name in attrs}
        return {out_slot: [fn(*args, **kwargs)]}
    return _lowered


_misc_op("pixel_shuffle", ["X"], attr_names=("upscale_factor",))
_misc_op("space_to_depth", ["X"], attr_names=("blocksize",))
_misc_op("shuffle_channel", ["X"], attr_names=("group",))
_misc_op("temporal_shift", ["X"], attr_names=("seg_num", "shift_ratio"))
_misc_op("cos_sim", ["X", "Y"])
_misc_op("lrn", ["X"], attr_names=("n", "k", "alpha", "beta"))


@register_op("multiplex")
def _multiplex(ins, attrs, op):
    from ..ops import misc as _misc

    return {"Out": [_misc.multiplex(ins["X"], _one(ins, "Ids"))]}


@register_op("rank_loss")
def _rank_loss(ins, attrs, op):
    from ..ops import misc as _misc

    return {"Out": [_misc.rank_loss(_one(ins, "Label"), _one(ins, "Left"),
                                    _one(ins, "Right"))]}


@register_op("sigmoid_focal_loss")
def _sigmoid_focal_loss(ins, attrs, op):
    from ..ops import misc as _misc

    return {"Out": [_misc.sigmoid_focal_loss(
        _one(ins, "X"), _one(ins, "Label"), _one(ins, "FgNum"),
        gamma=attrs.get("gamma", 2.0), alpha=attrs.get("alpha", 0.25))]}


@register_op("grid_sampler")
def _grid_sampler(ins, attrs, op):
    from ..ops import misc as _misc

    return {"Output": [_misc.grid_sampler(
        _one(ins, "X"), _one(ins, "Grid"), mode=attrs.get("mode", "bilinear"),
        padding_mode=attrs.get("padding_mode", "zeros"),
        align_corners=attrs.get("align_corners", True))]}


@register_op("affine_grid")
def _affine_grid(ins, attrs, op):
    from ..ops import misc as _misc

    return {"Output": [_misc.affine_grid(
        _one(ins, "Theta"), tuple(attrs["output_shape"]),
        align_corners=attrs.get("align_corners", True))]}


@register_op("roi_pool")
def _roi_pool(ins, attrs, op):
    from ..ops import misc as _misc

    return {"Out": [_misc.roi_pool(
        _batch_one(_one(ins, "X"), "roi_pool"), _one(ins, "ROIs"),
        (attrs["pooled_height"], attrs["pooled_width"]),
        spatial_scale=attrs.get("spatial_scale", 1.0))]}


@register_op("row_conv")
def _row_conv(ins, attrs, op):
    from ..ops import misc as _misc

    lengths = ins.get("Lengths")
    return {"Out": [_misc.row_conv(_one(ins, "X"), _one(ins, "Filter"),
                                   lengths=lengths[0] if lengths else None)]}


@register_op("nce")
def _nce(ins, attrs, op):
    from ..ops import misc as _misc

    return {"Cost": [_misc.nce_loss(
        _one(ins, "Input"), _one(ins, "Label"), _one(ins, "Weight"),
        _one(ins, "Bias"), _one(ins, "SampleIds"),
        num_total_classes=attrs.get("num_total_classes"))]}
