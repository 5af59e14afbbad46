"""Static-graph layers DSL: functions that append ops to the default program
(counterpart of paddle_tpu/static/layers.py, pure Python, copied).

Reference parity: python/paddle/fluid/layers/nn.py (functions appending
OpDescs through ``LayerHelper.append_op``).  The port carries the subset
that builds the vision programs and trains them: data, fc, conv2d,
pool2d, batch_norm, dropout, the activations, softmax, the elementwise
ops, matmul, the reductions, flatten, and the losses and accuracy.  Each function appends the same op types with the same attrs as
its JAX counterpart, so a program built with either package has the same
op sequence.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core import dtype as _dtype_mod
from ..nn import initializer as I
from .framework import (
    Parameter,
    Variable,
    default_main_program,
    default_startup_program,
    unique_name,
)

__all__ = [
    "data", "fc", "conv2d", "pool2d", "batch_norm", "dropout", "relu",
    "sigmoid", "tanh", "gelu", "relu6", "silu", "swish", "leaky_relu", "elu",
    "hard_swish", "softplus", "mish", "softmax", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "square", "matmul", "mean",
    "reduce_sum", "reduce_mean", "flatten", "create_parameter",
    "square_error_cost", "cross_entropy", "softmax_with_cross_entropy",
    "accuracy",
]


# -- helper (ref LayerHelper, fluid/layer_helper.py) -------------------------

def _main_block():
    return default_main_program().current_block()


def _startup_block():
    return default_startup_program().current_block()


def _init_attrs(initializer, shape, dtype):
    """Map an nn.initializer descriptor to a startup init op (type, attrs),
    as the reference appends initializer ops to the startup program
    (fluid/initializer.py)."""
    shape = list(shape)
    base = {"shape": shape, "dtype": _dtype_mod.dtype_name(dtype)}
    if initializer is None or isinstance(initializer, I.XavierUniform):
        fan_in = shape[0] if len(shape) >= 1 else 1
        fan_out = shape[1] if len(shape) >= 2 else fan_in
        if len(shape) > 2:  # conv kernels: receptive field scaling
            rf = int(np.prod(shape[2:]))
            fan_in, fan_out = shape[1] * rf, shape[0] * rf
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return "uniform_random", {**base, "min": -bound, "max": bound}
    if isinstance(initializer, I.Constant):
        return "fill_constant", {**base, "value": float(initializer.value)}
    if isinstance(initializer, I.Normal):
        return "gaussian_random", {**base, "mean": initializer.mean,
                                   "std": initializer.std}
    if isinstance(initializer, I.TruncatedNormal):
        return "truncated_gaussian_random", {**base, "mean": initializer.mean,
                                             "std": initializer.std}
    if isinstance(initializer, I.Uniform):
        return "uniform_random", {**base, "min": initializer.low,
                                  "max": initializer.high}
    raise NotImplementedError(
        f"no startup-op mapping for initializer {type(initializer).__name__}")


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     default_initializer=None, trainable=True) -> Parameter:
    """Create a Parameter in the main program + its init op in startup
    (ref layer_helper_base.py create_parameter).

    A string ``attr`` (or an object with ``.name``) names the parameter;
    re-using a name SHARES the existing parameter (the reference's
    ``param_attr='shared_w'`` idiom) — shapes must then match."""
    initializer = getattr(attr, "initializer", None) or default_initializer
    attr_name = attr if isinstance(attr, str) else getattr(attr, "name", None)
    name = name or attr_name or unique_name("param")
    existing = _main_block().program._parameters.get(name)
    if existing is not None:
        if tuple(existing.shape) != tuple(shape):
            raise ValueError(
                f"shared parameter {name!r} has shape {existing.shape}, "
                f"requested {tuple(shape)}")
        if existing.dtype != _dtype_mod.convert_dtype(dtype):
            raise ValueError(
                f"shared parameter {name!r} has dtype {existing.dtype}, "
                f"requested {dtype}")
        return existing
    p = _main_block().create_parameter(name, shape, dtype, trainable,
                                       initializer)
    sp = _startup_block()
    sp.create_parameter(name, shape, dtype, trainable, initializer)
    op_type, attrs = _init_attrs(initializer, shape, dtype)
    sp.append_op(op_type, outputs={"Out": [name]}, attrs=attrs)
    return p


def _out(dtype="float32", shape=()):
    return _main_block().create_var(shape=shape, dtype=dtype)


def _append(op_type, inputs, outputs, attrs=None):
    return _main_block().append_op(op_type, inputs, outputs, attrs)


def _apply_act(out: Variable, act: Optional[str]) -> Variable:
    if act is None:
        return out
    res = _out(out.dtype, out.shape)
    _append(act, {"X": [out.name]}, {"Out": [res.name]})
    return res


# -- inputs ------------------------------------------------------------------

def data(name, shape, dtype="float32", append_batch_size=True) -> Variable:
    """ref fluid/layers/io.py data / fluid.data."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    return _main_block().create_var(name=name, shape=shape, dtype=dtype,
                                    is_data=True, stop_gradient=True)


# -- dense / conv ------------------------------------------------------------

def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None) -> Variable:
    """ref fluid/layers/nn.py fc — mul + elementwise_add + act."""
    in_dim = int(np.prod(input.shape[num_flatten_dims:]))
    w = create_parameter((in_dim, size), input.dtype, attr=param_attr,
                         name=f"{name}.w" if name else None)
    out_shape = tuple(input.shape[:num_flatten_dims]) + (size,)
    tmp = _out(input.dtype, out_shape)
    _append("mul", {"X": [input.name], "Y": [w.name]}, {"Out": [tmp.name]},
            {"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    if bias_attr is not False:
        b = create_parameter((size,), input.dtype, attr=bias_attr,
                             default_initializer=I.Constant(0.0),
                             name=f"{name}.b" if name else None)
        tmp2 = _out(input.dtype, out_shape)
        _append("elementwise_add", {"X": [tmp.name], "Y": [b.name]},
                {"Out": [tmp2.name]}, {"axis": len(out_shape) - 1})
        tmp = tmp2
    return _apply_act(tmp, act)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _spatial_out(size, k, s, p, d=1, ceil=False):
    if size < 0:
        return -1
    eff = d * (k - 1) + 1
    num = size + 2 * p - eff
    return (num + s - 1) // s + 1 if ceil else num // s + 1


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None
           ) -> Variable:
    """ref fluid/layers/nn.py conv2d (NCHW)."""
    ks = _pair(filter_size)
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    cin = input.shape[1]
    w = create_parameter((num_filters, cin // groups, ks[0], ks[1]),
                         input.dtype, attr=param_attr,
                         name=f"{name}.w" if name else None)
    h = _spatial_out(input.shape[2], ks[0], st[0], pd[0], dl[0])
    wd = _spatial_out(input.shape[3], ks[1], st[1], pd[1], dl[1])
    out = _out(input.dtype, (input.shape[0], num_filters, h, wd))
    inputs = {"Input": [input.name], "Filter": [w.name]}
    if bias_attr is not False:
        b = create_parameter((num_filters,), input.dtype, attr=bias_attr,
                             default_initializer=I.Constant(0.0),
                             name=f"{name}.b" if name else None)
        inputs["Bias"] = [b.name]
    _append("conv2d", inputs, {"Output": [out.name]},
            {"strides": stride, "paddings": padding, "dilations": dilation,
             "groups": groups})
    return _apply_act(out, act)


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, adaptive=False) -> Variable:
    """ref fluid/layers/nn.py pool2d."""
    ks = _pair(pool_size)
    st = _pair(pool_stride if pool_stride is not None else pool_size)
    pd = _pair(pool_padding)
    if global_pooling:
        shape = (input.shape[0], input.shape[1], 1, 1)
    elif adaptive:
        shape = (input.shape[0], input.shape[1], ks[0], ks[1])
    else:
        shape = (input.shape[0], input.shape[1],
                 _spatial_out(input.shape[2], ks[0], st[0], pd[0]),
                 _spatial_out(input.shape[3], ks[1], st[1], pd[1]))
    out = _out(input.dtype, shape)
    _append("pool2d", {"X": [input.name]}, {"Out": [out.name]},
            {"pooling_type": pool_type, "ksize": pool_size,
             "strides": pool_stride if pool_stride is not None else pool_size,
             "paddings": pool_padding, "global_pooling": global_pooling,
             "adaptive": adaptive})
    return out


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, is_test=False,
               param_attr=None, bias_attr=None, name=None) -> Variable:
    """ref fluid/layers/nn.py batch_norm — scale/bias trainable, mean/var
    persistable non-trainable state updated by the op."""
    c = input.shape[1]
    base = name or unique_name("batch_norm")
    scale = create_parameter((c,), input.dtype, attr=param_attr,
                             default_initializer=I.Constant(1.0),
                             name=f"{base}.scale")
    bias = create_parameter((c,), input.dtype, attr=bias_attr,
                            default_initializer=I.Constant(0.0),
                            name=f"{base}.bias")
    mean = create_parameter((c,), input.dtype, trainable=False,
                            default_initializer=I.Constant(0.0),
                            name=f"{base}.mean")
    var = create_parameter((c,), input.dtype, trainable=False,
                           default_initializer=I.Constant(1.0),
                           name=f"{base}.var")
    out = _out(input.dtype, input.shape)
    _append("batch_norm",
            {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
             "Mean": [mean.name], "Variance": [var.name]},
            {"Y": [out.name], "MeanOut": [mean.name],
             "VarianceOut": [var.name]},
            {"momentum": momentum, "epsilon": epsilon, "is_test": is_test})
    return _apply_act(out, act)


def dropout(x, dropout_prob=0.5, is_test=False,
            dropout_implementation="upscale_in_train") -> Variable:
    out = _out(x.dtype, x.shape)
    _append("dropout", {"X": [x.name]}, {"Out": [out.name]},
            {"dropout_prob": dropout_prob, "is_test": is_test,
             "dropout_implementation": dropout_implementation})
    return out


# -- activations / math ------------------------------------------------------

def _unary(op_type, x) -> Variable:
    out = _out(x.dtype, x.shape)
    _append(op_type, {"X": [x.name]}, {"Out": [out.name]})
    return out


def _unary_attr(op_type, x, **attrs) -> Variable:
    out = _out(x.dtype, x.shape)
    _append(op_type, {"X": [x.name]}, {"Out": [out.name]}, attrs or None)
    return out


def relu(x):
    return _unary("relu", x)


def sigmoid(x):
    return _unary("sigmoid", x)


def tanh(x):
    return _unary("tanh", x)


def gelu(x):
    return _unary("gelu", x)


def relu6(x):
    return _unary("relu6", x)


def silu(x):
    return _unary("silu", x)


def swish(x):
    return _unary("swish", x)


def hard_swish(x):
    return _unary("hard_swish", x)


def softplus(x):
    return _unary("softplus", x)


def mish(x):
    return _unary("mish", x)


def leaky_relu(x, alpha=0.02):
    return _unary_attr("leaky_relu", x, alpha=alpha)


def elu(x, alpha=1.0):
    return _unary_attr("elu", x, alpha=alpha)


def softmax(x, axis=-1) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("softmax", {"X": [x.name]}, {"Out": [out.name]}, {"axis": axis})
    return out


def _to_variable(x, like: Variable) -> Variable:
    if isinstance(x, Variable):
        return x
    v = _out(like.dtype, ())
    _append("fill_constant", {}, {"Out": [v.name]},
            {"shape": [], "dtype": _dtype_mod.dtype_name(like.dtype),
             "value": float(x)})
    return v


def _elementwise(op_type, x, y, axis=-1) -> Variable:
    y = _to_variable(y, x)
    out = _out(x.dtype, x.shape)
    _append(op_type, {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]},
            {"axis": axis})
    return out


def elementwise_add(x, y, axis=-1, act=None):
    return _apply_act(_elementwise("elementwise_add", x, y, axis), act)


def elementwise_sub(x, y, axis=-1):
    return _elementwise("elementwise_sub", x, y, axis)


def elementwise_mul(x, y, axis=-1):
    return _elementwise("elementwise_mul", x, y, axis)


def square(x):
    return _unary("square", x)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0) -> Variable:
    out = _out(x.dtype, (-1,) * max(x.ndim, y.ndim))
    _append("matmul", {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]},
            {"transpose_X": transpose_x, "transpose_Y": transpose_y,
             "alpha": alpha})
    return out


def mean(x) -> Variable:
    out = _out(x.dtype, ())
    _append("mean", {"X": [x.name]}, {"Out": [out.name]})
    return out


def _reduce(op_type, x, dim, keep_dim) -> Variable:
    out = _out(x.dtype, (-1,) * x.ndim if keep_dim else ())
    _append(op_type, {"X": [x.name]}, {"Out": [out.name]},
            {"dim": [dim] if isinstance(dim, int) else dim,
             "keep_dim": keep_dim, "reduce_all": dim is None})
    return out


def reduce_sum(x, dim=None, keep_dim=False) -> Variable:
    return _reduce("reduce_sum", x, dim, keep_dim)


def reduce_mean(x, dim=None, keep_dim=False) -> Variable:
    return _reduce("reduce_mean", x, dim, keep_dim)


# -- shape ops ---------------------------------------------------------------


def flatten(x, axis=1) -> Variable:
    lead = x.shape[:axis]
    tail = x.shape[axis:]
    d0 = -1 if any(s < 0 for s in lead) else int(np.prod(lead)) if lead else 1
    d1 = -1 if any(s < 0 for s in tail) else int(np.prod(tail))
    out = _out(x.dtype, (d0, d1))
    xshape = _out(x.dtype, ())
    _append("flatten2", {"X": [x.name]},
            {"Out": [out.name], "XShape": [xshape.name]}, {"axis": axis})
    return out


# -- loss / metrics ----------------------------------------------------------

def square_error_cost(input, label) -> Variable:
    """ref fluid/layers/loss.py square_error_cost: (input - label)^2."""
    out = _out(input.dtype, input.shape)
    _append("square_error_cost", {"X": [input.name], "Label": [label.name]},
            {"Out": [out.name]})
    return out


def cross_entropy(input, label, soft_label=False) -> Variable:
    """ref fluid/layers/loss.py cross_entropy: -log of the probability
    ``input`` gives the label (clamped at 1e-20)."""
    out = _out(input.dtype, input.shape[:-1] + (1,))
    _append("cross_entropy", {"X": [input.name], "Label": [label.name]},
            {"Y": [out.name]}, {"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False):
    loss = _out(logits.dtype, logits.shape[:-1] + (1,))
    sm = _out(logits.dtype, logits.shape)
    _append("softmax_with_cross_entropy",
            {"Logits": [logits.name], "Label": [label.name]},
            {"Loss": [loss.name], "Softmax": [sm.name]},
            {"soft_label": soft_label, "ignore_index": ignore_index})
    return (loss, sm) if return_softmax else loss


def accuracy(input, label, k=1) -> Variable:
    """ref fluid/layers/metric_op.py accuracy (top-1, as in the JAX
    package): the share of rows whose argmax is the label."""
    acc = _out("float32", ())
    correct = _out("int32", ())
    total = _out("int32", ())
    _append("accuracy", {"Out": [input.name], "Label": [label.name]},
            {"Accuracy": [acc.name], "Correct": [correct.name],
             "Total": [total.name]}, {"k": k})
    return acc
