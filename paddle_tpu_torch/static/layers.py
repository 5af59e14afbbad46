"""Static-graph layers DSL: functions that append ops to the default program
(counterpart of paddle_tpu/static/layers.py, pure Python, copied).

Reference parity: python/paddle/fluid/layers/nn.py (functions appending
OpDescs through ``LayerHelper.append_op``, layer_helper.py:42).  Each
function appends the same op types with the same attrs as its JAX
counterpart, so a program built with either package has the same op
sequence; the long tail of builders is in layers_tail.py, which attaches
its functions to this module.  Dtype attrs are written as names
(``"float32"``), as the JAX package writes them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..core import dtype as _dtype_mod
from ..nn import initializer as I
from .framework import (
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    unique_name,
)

__all__ = [
    "data", "fc", "conv2d", "pool2d", "batch_norm", "embedding", "dropout",
    "relu", "sigmoid", "tanh", "softmax", "cross_entropy", "square_error_cost",
    "softmax_with_cross_entropy", "mean", "reduce_sum", "reduce_mean",
    "accuracy", "reshape", "transpose", "concat", "split", "flatten", "cast",
    "scale", "fill_constant", "elementwise_add", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_mod",
    "elementwise_floordiv", "elementwise_max", "elementwise_min",
    "elementwise_pow", "matmul", "topk", "argmax", "argmin", "clip",
    "create_parameter",
    # long tail (same registry coverage as static/ops.py)
    "exp", "log", "sqrt", "square", "abs", "floor", "ceil", "round", "sign",
    "erf", "reciprocal", "rsqrt", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "logsigmoid", "gelu", "leaky_relu", "elu",
    "relu6", "selu", "mish", "silu", "swish", "softplus", "softsign",
    "hard_sigmoid", "hard_swish", "log_softmax", "pow", "shape", "squeeze",
    "unsqueeze", "stack", "expand", "tile", "slice", "gather", "gather_nd",
    "scatter", "where", "one_hot", "cumsum", "fill_zeros_like", "pad",
    "layer_norm", "sigmoid_cross_entropy_with_logits", "log_loss",
    "label_smooth", "l2_normalize", "huber_loss", "smooth_l1", "kldiv_loss",
    "mse_loss",
]


# -- helper (ref LayerHelper, fluid/layer_helper.py) -------------------------

def _main_block():
    return default_main_program().current_block()


def _startup_block():
    return default_startup_program().current_block()


def _init_attrs(initializer, shape, dtype):
    """Map an nn.initializer instance to a startup init op (type, attrs) —
    the reference does this via initializer ops appended to the startup
    program (fluid/initializer.py)."""
    shape = list(shape)
    base = {"shape": shape, "dtype": dtype if isinstance(dtype, str)
            else _dtype_mod.dtype_name(dtype)}
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

    A string ``attr`` (or ``ParamAttr(name=...)``) names the parameter;
    re-using a name SHARES the existing parameter (the reference's
    ``param_attr='shared_w'`` weight-sharing idiom, e.g. the word2vec book
    model's common embedding table) — shapes must then match."""
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
        # first creation wins for trainable/initializer (the reference's
        # ParamAttr sharing semantics); shape+dtype are validated above
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
    v = _main_block().create_var(name=name, shape=shape, dtype=dtype,
                                 is_data=True, stop_gradient=True)
    return v


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


def embedding(input, size, padding_idx=None, param_attr=None,
              dtype="float32", name=None, is_sparse=False) -> Variable:
    """ref fluid/layers/nn.py embedding (lookup_table_v2).  ``is_sparse``
    selects the dedup'd segment-sum gradient (SelectedRows analogue)."""
    w = create_parameter(size, dtype, attr=param_attr,
                         default_initializer=I.Normal(0.0, 1.0),
                         name=f"{name}.w" if name else None)
    out = _out(dtype, tuple(input.shape) + (size[1],))
    _append("lookup_table_v2", {"Ids": [input.name], "W": [w.name]},
            {"Out": [out.name]},
            {"padding_idx": -1 if padding_idx is None else padding_idx,
             "is_sparse": bool(is_sparse)})
    return out


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


def relu(x):
    return _unary("relu", x)


def sigmoid(x):
    return _unary("sigmoid", x)


def tanh(x):
    return _unary("tanh", x)


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


def elementwise_div(x, y, axis=-1):
    return _elementwise("elementwise_div", x, y, axis)


def elementwise_mod(x, y, axis=-1):
    return _elementwise("elementwise_mod", x, y, axis)


def elementwise_floordiv(x, y, axis=-1):
    return _elementwise("elementwise_floordiv", x, y, axis)


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


def reduce_sum(x, dim=None, keep_dim=False) -> Variable:
    out = _out(x.dtype, (-1,) * x.ndim if keep_dim else ())
    _append("reduce_sum", {"X": [x.name]}, {"Out": [out.name]},
            {"dim": [dim] if isinstance(dim, int) else dim,
             "keep_dim": keep_dim, "reduce_all": dim is None})
    return out


def reduce_mean(x, dim=None, keep_dim=False) -> Variable:
    out = _out(x.dtype, (-1,) * x.ndim if keep_dim else ())
    _append("reduce_mean", {"X": [x.name]}, {"Out": [out.name]},
            {"dim": [dim] if isinstance(dim, int) else dim,
             "keep_dim": keep_dim, "reduce_all": dim is None})
    return out


def cast(x, dtype) -> Variable:
    out = _out(dtype, x.shape)
    _append("cast", {"X": [x.name]}, {"Out": [out.name]},
            {"out_dtype": _dtype_mod.dtype_name(dtype) if not isinstance(dtype, str)
             else dtype})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("scale", {"X": [x.name]}, {"Out": [out.name]},
            {"scale": scale, "bias": bias,
             "bias_after_scale": bias_after_scale})
    return out


def clip(x, min, max) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("clip", {"X": [x.name]}, {"Out": [out.name]},
            {"min": min, "max": max})
    return out


def fill_constant(shape, dtype, value) -> Variable:
    out = _out(dtype, tuple(shape))
    _append("fill_constant", {}, {"Out": [out.name]},
            {"shape": list(shape), "dtype": _dtype_mod.dtype_name(dtype)
             if not isinstance(dtype, str) else dtype, "value": value})
    return out


# -- shape ops ---------------------------------------------------------------

def reshape(x, shape) -> Variable:
    out = _out(x.dtype, tuple(shape))
    xshape = _out(x.dtype, ())
    _append("reshape2", {"X": [x.name]},
            {"Out": [out.name], "XShape": [xshape.name]},
            {"shape": list(shape)})
    return out


def transpose(x, perm) -> Variable:
    out = _out(x.dtype, tuple(x.shape[p] for p in perm))
    xshape = _out(x.dtype, ())
    _append("transpose2", {"X": [x.name]},
            {"Out": [out.name], "XShape": [xshape.name]}, {"axis": list(perm)})
    return out


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


def concat(inputs, axis=0) -> Variable:
    # infer shape: concat dim sums (unknown if any input unknown), other
    # dims copy the first statically-known size (downstream fc/create_
    # parameter derive weight shapes from this metadata)
    ndim = inputs[0].ndim
    ax = axis % ndim
    shape = []
    for d in range(ndim):
        dims = [v.shape[d] for v in inputs]
        if d == ax:
            shape.append(-1 if any(s < 0 for s in dims) else int(sum(dims)))
        else:
            known = [s for s in dims if s >= 0]
            shape.append(known[0] if known else -1)
    out = _out(inputs[0].dtype, tuple(shape))
    _append("concat", {"X": [v.name for v in inputs]}, {"Out": [out.name]},
            {"axis": axis})
    return out


def split(x, num_or_sections, dim=0):
    ax = dim % x.ndim
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
        if x.shape[ax] >= 0 and x.shape[ax] % n != 0:
            raise ValueError(
                f"split: dimension {ax} of size {x.shape[ax]} is not "
                f"divisible into {n} equal sections")
        sizes = [x.shape[ax] // n if x.shape[ax] >= 0 else -1] * n
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "num": 0, "axis": dim}
        sizes = [int(v) for v in num_or_sections]
    shapes = [tuple(sz if d == ax else x.shape[d] for d in range(x.ndim))
              for sz in sizes]
    outs = [_out(x.dtype, shp) for shp in shapes]
    _append("split", {"X": [x.name]}, {"Out": [o.name for o in outs]}, attrs)
    return outs


# -- loss / metrics ----------------------------------------------------------

def square_error_cost(input, label) -> Variable:
    """ref fluid/layers/loss.py square_error_cost: (input - label)^2."""
    out = _out(input.dtype, input.shape)
    _append("square_error_cost", {"X": [input.name], "Label": [label.name]},
            {"Out": [out.name]})
    return out


def cross_entropy(input, label, soft_label=False) -> Variable:
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
    acc = _out("float32", ())
    correct = _out("int32", ())
    total = _out("int32", ())
    _append("accuracy", {"Out": [input.name], "Label": [label.name]},
            {"Accuracy": [acc.name], "Correct": [correct.name],
             "Total": [total.name]}, {"k": k})
    return acc


def topk(x, k=1):
    vals = _out(x.dtype, x.shape[:-1] + (k,))
    idx = _out("int32", x.shape[:-1] + (k,))
    _append("top_k", {"X": [x.name]},
            {"Out": [vals.name], "Indices": [idx.name]}, {"k": k})
    return vals, idx


def argmax(x, axis=-1) -> Variable:
    out = _out("int64", x.shape[:axis] + x.shape[axis + 1:])
    _append("arg_max", {"X": [x.name]}, {"Out": [out.name]}, {"axis": axis})
    return out


# -- DSL long tail (ref fluid/layers/nn.py ~200 fns; this block closes the
# gap for every lowering static/ops.py already registers) ---------------------

def _unary_attr(op_type, x, **attrs) -> Variable:
    out = _out(x.dtype, x.shape)
    _append(op_type, {"X": [x.name]}, {"Out": [out.name]}, attrs or None)
    return out


def exp(x):
    return _unary("exp", x)


def log(x):
    return _unary("log", x)


def sqrt(x):
    return _unary("sqrt", x)


def square(x):
    return _unary("square", x)


def abs(x):  # noqa: A001 — fluid.layers.abs shadows builtins there too
    return _unary("abs", x)


def floor(x):
    return _unary("floor", x)


def ceil(x):
    return _unary("ceil", x)


def round(x):  # noqa: A001
    return _unary("round", x)


def sign(x):
    return _unary("sign", x)


def erf(x):
    return _unary("erf", x)


def reciprocal(x):
    return _unary("reciprocal", x)


def rsqrt(x):
    return _unary("rsqrt", x)


def sin(x):
    return _unary("sin", x)


def cos(x):
    return _unary("cos", x)


def tan(x):
    return _unary("tan", x)


def asin(x):
    return _unary("asin", x)


def acos(x):
    return _unary("acos", x)


def atan(x):
    return _unary("atan", x)


def sinh(x):
    return _unary("sinh", x)


def cosh(x):
    return _unary("cosh", x)


def logsigmoid(x):
    return _unary("logsigmoid", x)


def gelu(x):
    return _unary("gelu", x)


def leaky_relu(x, alpha=0.02):
    return _unary_attr("leaky_relu", x, alpha=alpha)


def elu(x, alpha=1.0):
    return _unary_attr("elu", x, alpha=alpha)


def relu6(x):
    return _unary("relu6", x)


def selu(x):
    return _unary("selu", x)


def mish(x):
    return _unary("mish", x)


def silu(x):
    return _unary("silu", x)


def swish(x):
    return _unary("swish", x)


def softplus(x):
    return _unary("softplus", x)


def softsign(x):
    return _unary("softsign", x)


def hard_sigmoid(x, slope=0.2, offset=0.5):
    return _unary_attr("hard_sigmoid", x, slope=slope, offset=offset)


def hard_swish(x):
    return _unary("hard_swish", x)


def log_softmax(x, axis=-1):
    return _unary_attr("log_softmax", x, axis=axis)


def pow(x, factor=1.0):  # noqa: A001
    return _unary_attr("pow", x, factor=factor)


def elementwise_max(x, y, axis=-1):
    return _elementwise("elementwise_max", x, y, axis)


def elementwise_min(x, y, axis=-1):
    return _elementwise("elementwise_min", x, y, axis)


def elementwise_pow(x, y, axis=-1):
    return _elementwise("elementwise_pow", x, y, axis)


# -- shape / index manipulation ----------------------------------------------

def shape(x) -> Variable:
    out = _out("int64", (x.ndim,))
    _append("shape", {"Input": [x.name]}, {"Out": [out.name]})
    return out


def squeeze(x, axes=()) -> Variable:
    shp = [s for i, s in enumerate(x.shape)
           if not ((axes and i in axes) or (not axes and s == 1))]
    out = _out(x.dtype, tuple(shp))
    xshape = _out(x.dtype, ())
    _append("squeeze2", {"X": [x.name]},
            {"Out": [out.name], "XShape": [xshape.name]},
            {"axes": list(axes)})
    return out


def unsqueeze(x, axes) -> Variable:
    axes = [axes] if isinstance(axes, int) else list(axes)
    shp = list(x.shape)
    for a in sorted(axes):
        shp.insert(a if a >= 0 else a + len(shp) + 1, 1)
    out = _out(x.dtype, tuple(shp))
    xshape = _out(x.dtype, ())
    _append("unsqueeze2", {"X": [x.name]},
            {"Out": [out.name], "XShape": [xshape.name]}, {"axes": axes})
    return out


def stack(inputs, axis=0) -> Variable:
    shp = list(inputs[0].shape)
    shp.insert(axis if axis >= 0 else axis + len(shp) + 1, len(inputs))
    out = _out(inputs[0].dtype, tuple(shp))
    _append("stack", {"X": [v.name for v in inputs]}, {"Y": [out.name]},
            {"axis": axis})
    return out


def expand(x, shape) -> Variable:
    out = _out(x.dtype, tuple(shape))
    _append("expand_v2", {"X": [x.name]}, {"Out": [out.name]},
            {"shape": list(shape)})
    return out


def tile(x, repeat_times) -> Variable:
    shp = tuple(-1 if s < 0 else s * r
                for s, r in zip(x.shape, repeat_times))
    out = _out(x.dtype, shp)
    _append("tile", {"X": [x.name]}, {"Out": [out.name]},
            {"repeat_times": list(repeat_times)})
    return out


def slice(x, axes, starts, ends) -> Variable:  # noqa: A001
    shp = list(x.shape)
    for a, s, e in zip(axes, starts, ends):
        if shp[a] >= 0:
            lo = s if s >= 0 else shp[a] + s
            hi = min(e, shp[a]) if e >= 0 else shp[a] + e
            shp[a] = max(hi - lo, 0)
    out = _out(x.dtype, tuple(shp))
    _append("slice", {"Input": [x.name]}, {"Out": [out.name]},
            {"axes": list(axes), "starts": list(starts), "ends": list(ends)})
    return out


def gather(x, index, axis=0) -> Variable:
    shp = list(x.shape)
    shp[axis] = index.shape[0] if index.ndim else 1
    out = _out(x.dtype, tuple(shp))
    _append("gather", {"X": [x.name], "Index": [index.name]},
            {"Out": [out.name]}, {"axis": axis})
    return out


def gather_nd(x, index) -> Variable:
    out = _out(x.dtype, tuple(index.shape[:-1]))
    _append("gather_nd", {"X": [x.name], "Index": [index.name]},
            {"Out": [out.name]})
    return out


def scatter(x, index, updates, overwrite=True) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("scatter", {"X": [x.name], "Ids": [index.name],
                        "Updates": [updates.name]},
            {"Out": [out.name]}, {"overwrite": overwrite})
    return out


def where(condition, x, y) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("where", {"Condition": [condition.name], "X": [x.name],
                      "Y": [y.name]}, {"Out": [out.name]})
    return out


def one_hot(x, depth) -> Variable:
    out = _out("float32", tuple(x.shape) + (depth,))
    _append("one_hot_v2", {"X": [x.name]}, {"Out": [out.name]},
            {"depth": depth})
    return out


def cumsum(x, axis=None, exclusive=False, reverse=False) -> Variable:
    out = _out(x.dtype, x.shape if axis is not None else (-1,))
    _append("cumsum", {"X": [x.name]}, {"Out": [out.name]},
            {"axis": axis, "exclusive": exclusive, "reverse": reverse,
             "flatten": axis is None})
    return out


def argmin(x, axis=-1) -> Variable:
    shp = tuple(s for i, s in enumerate(x.shape)
                if i != (axis if axis >= 0 else axis + x.ndim))
    out = _out("int64", shp)
    _append("arg_min", {"X": [x.name]}, {"Out": [out.name]}, {"axis": axis})
    return out


def fill_zeros_like(x) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("fill_zeros_like", {"X": [x.name]}, {"Out": [out.name]})
    return out


def pad(x, paddings, pad_value=0.0) -> Variable:
    shp = tuple(s + paddings[2 * i] + paddings[2 * i + 1] if s >= 0 else -1
                for i, s in enumerate(x.shape))
    out = _out(x.dtype, shp)
    _append("pad", {"X": [x.name]}, {"Out": [out.name]},
            {"paddings": list(paddings), "pad_value": pad_value})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None) -> Variable:
    """ref fluid/layers/nn.py layer_norm."""
    n = int(np.prod(input.shape[begin_norm_axis:]))
    ins = {"X": [input.name]}
    if scale:
        s = create_parameter((n,), input.dtype, attr=param_attr,
                             default_initializer=I.Constant(1.0))
        ins["Scale"] = [s.name]
    if shift:
        b = create_parameter((n,), input.dtype, attr=bias_attr,
                             default_initializer=I.Constant(0.0))
        ins["Bias"] = [b.name]
    out = _out(input.dtype, input.shape)
    mean = _out("float32", input.shape[:begin_norm_axis])
    var = _out("float32", input.shape[:begin_norm_axis])
    _append("layer_norm", ins,
            {"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
            {"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return out


# -- losses -------------------------------------------------------------------

def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("sigmoid_cross_entropy_with_logits",
            {"X": [x.name], "Label": [label.name]}, {"Out": [out.name]},
            {"ignore_index": ignore_index, "normalize": normalize})
    return out


def log_loss(input, label, epsilon=1e-4) -> Variable:
    out = _out(input.dtype, input.shape)
    _append("log_loss", {"Predicted": [input.name], "Labels": [label.name]},
            {"Loss": [out.name]}, {"epsilon": epsilon})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1) -> Variable:
    out = _out(label.dtype, label.shape)
    ins = {"X": [label.name]}
    if prior_dist is not None:
        ins["PriorDist"] = [prior_dist.name]
    _append("label_smooth", ins, {"Out": [out.name]}, {"epsilon": epsilon})
    return out


def l2_normalize(x, axis=-1, epsilon=1e-10) -> Variable:
    out = _out(x.dtype, x.shape)
    norm = _out(x.dtype, x.shape[:-1] + (1,))
    _append("norm", {"X": [x.name]}, {"Out": [out.name], "Norm": [norm.name]},
            {"axis": axis, "epsilon": epsilon})
    return out


def huber_loss(input, label, delta=1.0) -> Variable:
    out = _out(input.dtype, input.shape)
    _append("huber_loss", {"X": [input.name], "Y": [label.name]},
            {"Out": [out.name]}, {"delta": delta})
    return out


def smooth_l1(x, y, sigma=1.0) -> Variable:
    out = _out(x.dtype, x.shape)
    _append("smooth_l1_loss", {"X": [x.name], "Y": [y.name]},
            {"Out": [out.name]}, {"sigma": sigma})
    return out


def kldiv_loss(x, target, reduction="mean") -> Variable:
    shp = () if reduction in ("mean", "sum", "batchmean") else x.shape
    out = _out(x.dtype, shp)
    _append("kldiv_loss", {"X": [x.name], "Target": [target.name]},
            {"Loss": [out.name]}, {"reduction": reduction})
    return out


def mse_loss(input, label) -> Variable:
    """ref fluid/layers mse_loss — mean of squared error."""
    return mean(square_error_cost(input, label))


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0) -> Variable:
    """ref fluid/layers fill_constant_batch_size_like: constant tensor whose
    dim ``output_dim_idx`` copies ``input``'s runtime dim ``input_dim_idx``
    (the standard way to build batch-shaped RNN initial states when the
    batch dim is unknown at build time)."""
    out_shape = list(shape)
    out_shape[output_dim_idx] = input.shape[input_dim_idx]
    out = _out(dtype, tuple(out_shape))
    _append("fill_constant_batch_size_like", {"Input": [input.name]},
            {"Out": [out.name]},
            {"shape": list(shape), "dtype": dtype if isinstance(dtype, str)
             else _dtype_mod.dtype_name(dtype),
             "value": float(value), "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx})
    return out


# -- padded sequence layers --------------------------------------------------

def sequence_mask(x, maxlen, dtype="float32") -> Variable:
    """(b,) lengths -> (b, maxlen) 0/1 mask (ref fluid/layers/nn.py
    sequence_mask; the padded layout of the LoD policy)."""
    out = _out(dtype, (x.shape[0], int(maxlen)))
    _append("sequence_mask", {"X": [x.name]}, {"Y": [out.name]},
            {"maxlen": int(maxlen),
             "out_dtype": dtype if isinstance(dtype, str)
             else _dtype_mod.dtype_name(dtype)})
    return out


def sequence_last_step(input, sequence_length) -> Variable:
    """Last valid timestep of a padded (b, s, d) sequence batch (ref
    fluid/layers sequence_last_step over LoD; here a masked gather)."""
    out = _out(input.dtype, (input.shape[0], input.shape[2]))
    _append("sequence_last_step_padded",
            {"X": [input.name], "Lengths": [sequence_length.name]},
            {"Out": [out.name]}, {})
    return out


def dynamic_lstm(input, size, sequence_length=None, h0=None, c0=None,
                 param_attr=None, bias_attr=None, gate_activation="sigmoid",
                 cell_activation="tanh", candidate_activation="tanh",
                 name=None):
    """LSTM over a padded (batch, seq, 4H) pre-projected input (ref
    fluid/layers/nn.py dynamic_lstm -> lstm_op.cc).

    The reference consumes a LoD-packed (sum_len, 4H) tensor; the padded
    layout is padded batch-major plus ``sequence_length`` (SURVEY §7 LoD
    policy), and the recurrence runs through StaticRNN.  As in the
    reference, callers pre-project the input with an fc of size 4H; this
    layer owns only the recurrent weight (H, 4H) and bias (4H).  Gate chunk
    order is (i, f, g, o), matching nn.layer.rnn.LSTMCell's weight-layout
    parity contract.  Returns (hidden, cell), each (batch, seq, H).
    """
    from .control_flow import StaticRNN

    if size % 4:
        raise ValueError(f"dynamic_lstm size must be 4*hidden, got {size}")
    H = size // 4
    b, s = int(input.shape[0]), int(input.shape[1])
    if s < 0:
        raise ValueError(
            "dynamic_lstm requires a static (padded) sequence length in "
            "input.shape[1]; got -1.  Pad sequences to a fixed max length "
            "(SURVEY §7 LoD policy) and pass sequence_length for masking.")
    acts = {"sigmoid": sigmoid, "tanh": tanh, "relu": relu,
            "identity": lambda v: v}
    try:
        gate_act = acts[gate_activation]
        cell_act = acts[cell_activation]
        cand_act = acts[candidate_activation]
    except KeyError as e:
        raise ValueError(f"dynamic_lstm: unsupported activation {e}; "
                         f"one of {sorted(acts)}") from None

    w = create_parameter((H, 4 * H), input.dtype, attr=param_attr,
                         name=f"{name}.w" if name else None)
    bias = create_parameter((4 * H,), input.dtype, attr=bias_attr,
                            default_initializer=I.Constant(0.0),
                            name=f"{name}.b" if name else None)
    if h0 is None:
        h0 = fill_constant_batch_size_like(input, (b, H), input.dtype, 0.0)
    if c0 is None:
        c0 = fill_constant_batch_size_like(input, (b, H), input.dtype, 0.0)

    x_tm = transpose(input, [1, 0, 2])                     # (s, b, 4H)
    if sequence_length is not None:
        mask = sequence_mask(sequence_length, s, dtype=input.dtype)
        mask_tm = unsqueeze(transpose(mask, [1, 0]), [2])  # (s, b, 1)

    rnn = StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x_tm)                          # (b, 4H)
        mt = rnn.step_input(mask_tm) if sequence_length is not None else None
        h_prev = rnn.memory(init=h0)
        c_prev = rnn.memory(init=c0)
        gates = elementwise_add(elementwise_add(xt, matmul(h_prev, w)), bias)
        gi, gf, gg, go = split(gates, 4, dim=1)
        c_new = elementwise_add(elementwise_mul(gate_act(gf), c_prev),
                                elementwise_mul(gate_act(gi), cand_act(gg)))
        h_new = elementwise_mul(gate_act(go), cell_act(c_new))
        if mt is not None:
            inv = elementwise_sub(
                fill_constant_batch_size_like(mt, (b, 1), input.dtype, 1.0), mt)
            h_new = elementwise_add(elementwise_mul(h_new, mt),
                                    elementwise_mul(h_prev, inv))
            c_new = elementwise_add(elementwise_mul(c_new, mt),
                                    elementwise_mul(c_prev, inv))
        rnn.update_memory(h_prev, h_new)
        rnn.update_memory(c_prev, c_new)
        rnn.step_output(h_new)
        rnn.step_output(c_new)
    h_tm, c_tm = rnn()
    return transpose(h_tm, [1, 0, 2]), transpose(c_tm, [1, 0, 2])


def sequence_pool(input, pool_type, sequence_length, pad_value=0.0) -> Variable:
    """Pool over each padded sequence's valid steps (ref fluid/layers
    sequence_pool over LoD -> sequence_ops/sequence_pool_op)."""
    out = _out(input.dtype, (input.shape[0],) + tuple(input.shape[2:]))
    _append("sequence_pool_padded",
            {"X": [input.name], "Lengths": [sequence_length.name]},
            {"Out": [out.name]},
            {"pooltype": pool_type, "pad_value": float(pad_value)})
    return out


def sequence_first_step(input, sequence_length) -> Variable:
    """ref fluid/layers sequence_first_step."""
    out = _out(input.dtype, (input.shape[0],) + tuple(input.shape[2:]))
    _append("sequence_first_step_padded",
            {"X": [input.name], "Lengths": [sequence_length.name]},
            {"Out": [out.name]}, {})
    return out


def sequence_softmax(input, sequence_length) -> Variable:
    """ref fluid/layers sequence_softmax (softmax within each sequence)."""
    out = _out(input.dtype, input.shape)
    _append("sequence_softmax_padded",
            {"X": [input.name], "Lengths": [sequence_length.name]},
            {"Out": [out.name]}, {})
    return out


def sequence_reverse(input, sequence_length) -> Variable:
    """ref fluid/layers sequence_reverse (valid prefix reversed in place)."""
    out = _out(input.dtype, input.shape)
    _append("sequence_reverse_padded",
            {"X": [input.name], "Lengths": [sequence_length.name]},
            {"Y": [out.name]}, {})
    return out


def dynamic_gru(input, size, sequence_length=None, h0=None, param_attr=None,
                bias_attr=None, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", name=None) -> Variable:
    """GRU over a padded (batch, seq, 3H) pre-projected input (ref
    fluid/layers/nn.py dynamic_gru -> gru_op.cc).

    Like dynamic_lstm, callers pre-project the input with an fc of size 3H;
    this layer owns the recurrent weight (H, 3H) and bias (3H).  Gate chunk
    order (r, z, c) with the reset gate applied AFTER the hidden matmul,
    matching nn.layer.rnn.GRUCell's weight-layout parity contract.
    ``is_reverse`` runs the recurrence right-to-left over the valid prefix
    (the reference attribute), implemented by sequence_reverse on both ends.
    Returns hidden (batch, seq, H).
    """
    from .control_flow import StaticRNN

    if size % 3:
        raise ValueError(f"dynamic_gru size must be 3*hidden, got {size}")
    H = size // 3
    b, s = int(input.shape[0]), int(input.shape[1])
    if s < 0:
        raise ValueError(
            "dynamic_gru requires a static (padded) sequence length in "
            "input.shape[1]; pad sequences and pass sequence_length")
    acts = {"sigmoid": sigmoid, "tanh": tanh, "relu": relu,
            "identity": lambda v: v}
    try:
        gate_act = acts[gate_activation]
        cand_act = acts[candidate_activation]
    except KeyError as e:
        raise ValueError(f"dynamic_gru: unsupported activation {e}; "
                         f"one of {sorted(acts)}") from None

    if is_reverse:
        if sequence_length is None:
            raise ValueError("dynamic_gru(is_reverse=True) needs "
                             "sequence_length to locate each valid prefix")
        input = sequence_reverse(input, sequence_length)

    w = create_parameter((H, 3 * H), input.dtype, attr=param_attr,
                         name=f"{name}.w" if name else None)
    bias = create_parameter((3 * H,), input.dtype, attr=bias_attr,
                            default_initializer=I.Constant(0.0),
                            name=f"{name}.b" if name else None)
    if h0 is None:
        h0 = fill_constant_batch_size_like(input, (b, H), input.dtype, 0.0)

    x_tm = transpose(input, [1, 0, 2])                     # (s, b, 3H)
    if sequence_length is not None:
        mask = sequence_mask(sequence_length, s, dtype=input.dtype)
        mask_tm = unsqueeze(transpose(mask, [1, 0]), [2])  # (s, b, 1)

    w_rz, w_c = split(w, [2 * H, H], dim=1)
    b_rz, b_c = split(bias, [2 * H, H], dim=0)

    rnn = StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x_tm)                          # (b, 3H)
        mt = rnn.step_input(mask_tm) if sequence_length is not None else None
        h_prev = rnn.memory(init=h0)
        x_rz, x_c = split(xt, [2 * H, H], dim=1)
        rz = gate_act(elementwise_add(
            elementwise_add(x_rz, matmul(h_prev, w_rz)), b_rz))
        r, z = split(rz, 2, dim=1)
        c = cand_act(elementwise_add(
            elementwise_add(x_c, elementwise_mul(r, matmul(h_prev, w_c))),
            b_c))
        one = fill_constant_batch_size_like(xt, (b, 1), input.dtype, 1.0)
        h_new = elementwise_add(elementwise_mul(z, h_prev),
                                elementwise_mul(elementwise_sub(one, z), c))
        if mt is not None:
            inv = elementwise_sub(one, mt)
            h_new = elementwise_add(elementwise_mul(h_new, mt),
                                    elementwise_mul(h_prev, inv))
        rnn.update_memory(h_prev, h_new)
        rnn.step_output(h_new)
    h_tm = rnn()
    hidden = transpose(h_tm, [1, 0, 2])
    if is_reverse:
        hidden = sequence_reverse(hidden, sequence_length)
    return hidden


# -- conv-transpose / norm / vision long tail --------------------------------

def conv2d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1, param_attr=None,
                     bias_attr=None, act=None, name=None) -> Variable:
    """ref fluid/layers/nn.py conv2d_transpose (NCHW; weight layout
    (in_c, out_c/groups, kh, kw) like conv_transpose_op.cc)."""
    ks, st = _pair(filter_size), _pair(stride)
    pd, dl, op_ = _pair(padding), _pair(dilation), _pair(output_padding)
    cin = input.shape[1]
    w = create_parameter((cin, num_filters // groups, ks[0], ks[1]),
                         input.dtype, attr=param_attr,
                         name=f"{name}.w" if name else None)

    def _tout(sz, k, s, p, d, o):
        if sz < 0:
            return -1
        return (sz - 1) * s - 2 * p + (k - 1) * d + 1 + o

    h = _tout(input.shape[2], ks[0], st[0], pd[0], dl[0], op_[0])
    wd = _tout(input.shape[3], ks[1], st[1], pd[1], dl[1], op_[1])
    out = _out(input.dtype, (input.shape[0], num_filters, h, wd))
    inputs = {"Input": [input.name], "Filter": [w.name]}
    if bias_attr is not False:
        b = create_parameter((num_filters,), input.dtype, attr=bias_attr,
                             default_initializer=I.Constant(0.0),
                             name=f"{name}.b" if name else None)
        inputs["Bias"] = [b.name]
    _append("conv2d_transpose", inputs, {"Output": [out.name]},
            {"strides": stride, "paddings": padding, "dilations": dilation,
             "output_padding": output_padding, "groups": groups})
    return _apply_act(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None) -> Variable:
    """ref fluid/layers/nn.py group_norm -> group_norm_op.cc (NCHW)."""
    C = input.shape[1]
    scale = create_parameter((C,), input.dtype, attr=param_attr,
                             default_initializer=I.Constant(1.0),
                             name=f"{name}.w" if name else None)
    bias = create_parameter((C,), input.dtype, attr=bias_attr,
                            default_initializer=I.Constant(0.0),
                            name=f"{name}.b" if name else None)
    out = _out(input.dtype, input.shape)
    _append("group_norm", {"X": [input.name], "Scale": [scale.name],
                           "Bias": [bias.name]}, {"Y": [out.name]},
            {"groups": int(groups), "epsilon": float(epsilon)})
    return _apply_act(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None) -> Variable:
    """ref fluid/layers/nn.py instance_norm -> instance_norm_op.cc."""
    C = input.shape[1]
    scale = create_parameter((C,), input.dtype, attr=param_attr,
                             default_initializer=I.Constant(1.0),
                             name=f"{name}.w" if name else None)
    bias = create_parameter((C,), input.dtype, attr=bias_attr,
                            default_initializer=I.Constant(0.0),
                            name=f"{name}.b" if name else None)
    out = _out(input.dtype, input.shape)
    _append("instance_norm", {"X": [input.name], "Scale": [scale.name],
                              "Bias": [bias.name]}, {"Y": [out.name]},
            {"epsilon": float(epsilon)})
    return out


def prelu(x, mode="all", param_attr=None, name=None) -> Variable:
    """ref fluid/layers/nn.py prelu (mode: all|channel)."""
    if mode == "all":
        alpha_shape = (1,)
    elif mode == "channel":
        alpha_shape = (x.shape[1],)
    else:
        raise ValueError("prelu mode must be 'all' or 'channel' "
                         "(per-'element' alpha is descoped)")
    alpha = create_parameter(alpha_shape, x.dtype, attr=param_attr,
                             default_initializer=I.Constant(0.25),
                             name=f"{name}.alpha" if name else None)
    out = _out(x.dtype, x.shape)
    _append("prelu", {"X": [x.name], "Alpha": [alpha.name]},
            {"Out": [out.name]}, {"mode": mode})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          name=None) -> Variable:
    """ref fluid/layers/nn.py pad2d (NCHW, [top, bottom, left, right])."""
    t, b, l, r = paddings
    shape = list(input.shape)
    if shape[2] >= 0:
        shape[2] += t + b
    if shape[3] >= 0:
        shape[3] += l + r
    out = _out(input.dtype, tuple(shape))
    _append("pad2d", {"X": [input.name]}, {"Out": [out.name]},
            {"paddings": list(paddings), "mode": mode,
             "pad_value": float(pad_value)})
    return out


def _resize(input, out_shape, method, align_corners):
    out = _out(input.dtype,
               (input.shape[0], input.shape[1]) + tuple(out_shape))
    _append("resize_interp", {"X": [input.name]}, {"Out": [out.name]},
            {"out_shape": list(out_shape), "interp_method": method,
             "align_corners": bool(align_corners)})
    return out


def resize_bilinear(input, out_shape, align_corners=True, name=None):
    """ref fluid/layers/nn.py resize_bilinear -> bilinear_interp_op
    (fluid defaults align_corners=True)."""
    return _resize(input, out_shape, "bilinear", align_corners)


def resize_nearest(input, out_shape, align_corners=True, name=None):
    """ref fluid/layers/nn.py resize_nearest -> nearest_interp_op
    (fluid defaults align_corners=True)."""
    return _resize(input, out_shape, "nearest", align_corners)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    """ref fluid/layers/detection.py prior_box -> prior_box_op.cc.
    Returns (boxes, variances), each (H, W, num_priors, 4)."""
    from ..ops.vision import expand_aspect_ratios

    # shared with the eager kernel so count inference can never drift
    n_ratio = len(expand_aspect_ratios(aspect_ratios, flip))
    num = len(min_sizes) * n_ratio + len(max_sizes or [])
    H, W = input.shape[2], input.shape[3]
    boxes = _out(input.dtype, (H, W, num, 4))
    variances = _out(input.dtype, (H, W, num, 4))
    _append("prior_box", {"Input": [input.name], "Image": [image.name]},
            {"Boxes": [boxes.name], "Variances": [variances.name]},
            {"min_sizes": list(min_sizes),
             "max_sizes": list(max_sizes or []),
             "aspect_ratios": list(aspect_ratios),
             "variances": list(variance), "flip": flip, "clip": clip,
             "steps": list(steps), "offset": offset})
    return boxes, variances


def box_coder(prior_box, prior_box_var, target_box, code_type,
              box_normalized=True, axis=0, name=None) -> Variable:
    """ref fluid/layers/detection.py box_coder -> box_coder_op.cc.
    encode_center_size: target (N, 4) x priors (M, 4) -> (N, M, 4);
    decode_center_size keeps the target's shape."""
    if str(code_type).startswith("encode"):
        out_shape = (target_box.shape[0], prior_box.shape[0], 4)
    else:
        out_shape = target_box.shape
    out = _out(target_box.dtype, out_shape)
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    _append("box_coder", inputs, {"OutputBox": [out.name]},
            {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None) -> Variable:
    """ref fluid/layers/detection.py roi_align -> roi_align_op.cc
    (batch-1 static-shape policy; see the lowering's docstring)."""
    C = input.shape[1]
    out = _out(input.dtype, (rois.shape[0], C, pooled_height, pooled_width))
    _append("roi_align", {"X": [input.name], "ROIs": [rois.name]},
            {"Out": [out.name]},
            {"pooled_height": pooled_height, "pooled_width": pooled_width,
             "spatial_scale": spatial_scale,
             "sampling_ratio": sampling_ratio})
    return out


def linear_chain_crf(input, label, length, param_attr=None,
                     name=None) -> Variable:
    """ref fluid/layers/nn.py linear_chain_crf -> linear_chain_crf_op.h.
    Owns the (num_tags + 2, num_tags) transition parameter (start/stop
    rows + pairwise); share it with crf_decoding via param_attr name.
    Returns the per-sequence NLL (b, 1) (the reference's negated
    log-likelihood output)."""
    D = input.shape[-1]
    # layer `name` must NOT rename the parameter (it would break the
    # param_attr sharing contract with crf_decoding); fluid's name arg is a
    # display name only
    transition = create_parameter((D + 2, D), input.dtype, attr=param_attr)
    out = _out(input.dtype, (input.shape[0], 1))
    _append("linear_chain_crf",
            {"Emission": [input.name], "Label": [label.name],
             "Transition": [transition.name], "Length": [length.name]},
            {"LogLikelihood": [out.name]}, {})
    return out


def crf_decoding(input, length, param_attr=None, name=None) -> Variable:
    """ref fluid/layers/nn.py crf_decoding -> crf_decoding_op.h (Viterbi);
    pass the SAME param_attr name used for linear_chain_crf."""
    D = input.shape[-1]
    transition = create_parameter((D + 2, D), input.dtype, attr=param_attr)
    out = _out("int32", input.shape[:-1])
    _append("crf_decoding",
            {"Emission": [input.name], "Transition": [transition.name],
             "Length": [length.name]},
            {"ViterbiPath": [out.name]}, {})
    return out


# -- misc op-parity layer functions ------------------------------------------

def _same_shape_op(op_type, x, attrs=None, in_name="X", out_name="Out",
                   out_shape=None, out_dtype=None):
    out = _out(out_dtype or x.dtype, out_shape if out_shape is not None
               else x.shape)
    _append(op_type, {in_name: [x.name]}, {out_name: [out.name]}, attrs or {})
    return out


def pixel_shuffle(x, upscale_factor) -> Variable:
    """ref pixel_shuffle layer (2.x nn.functional.pixel_shuffle)."""
    r = int(upscale_factor)
    n, c, h, w = x.shape
    shape = (n, c // (r * r) if c >= 0 else -1,
             h * r if h >= 0 else -1, w * r if w >= 0 else -1)
    return _same_shape_op("pixel_shuffle", x, {"upscale_factor": r},
                          out_shape=shape)


def space_to_depth(x, blocksize) -> Variable:
    """ref fluid/layers/nn.py space_to_depth."""
    b = int(blocksize)
    n, c, h, w = x.shape
    shape = (n, c * b * b if c >= 0 else -1,
             h // b if h >= 0 else -1, w // b if w >= 0 else -1)
    return _same_shape_op("space_to_depth", x, {"blocksize": b},
                          out_shape=shape)


def shuffle_channel(x, group) -> Variable:
    """ref fluid/layers/nn.py shuffle_channel."""
    return _same_shape_op("shuffle_channel", x, {"group": int(group)})


def temporal_shift(x, seg_num, shift_ratio=0.25) -> Variable:
    """ref fluid/layers/nn.py temporal_shift."""
    return _same_shape_op("temporal_shift", x,
                          {"seg_num": int(seg_num),
                           "shift_ratio": float(shift_ratio)})


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75) -> Variable:
    """ref fluid/layers/nn.py lrn."""
    return _same_shape_op("lrn", input,
                          {"n": n, "k": k, "alpha": alpha, "beta": beta})


def cos_sim(X, Y) -> Variable:
    """ref fluid/layers/nn.py cos_sim."""
    out = _out(X.dtype, (X.shape[0], 1))
    _append("cos_sim", {"X": [X.name], "Y": [Y.name]}, {"Out": [out.name]})
    return out


def multiplex(inputs, index) -> Variable:
    """ref fluid/layers/nn.py multiplex."""
    out = _out(inputs[0].dtype, inputs[0].shape)
    _append("multiplex", {"X": [v.name for v in inputs],
                          "Ids": [index.name]}, {"Out": [out.name]})
    return out


def rank_loss(label, left, right) -> Variable:
    """ref fluid/layers/loss.py rank_loss."""
    out = _out(left.dtype, left.shape)
    _append("rank_loss", {"Label": [label.name], "Left": [left.name],
                          "Right": [right.name]}, {"Out": [out.name]})
    return out


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25) -> Variable:
    """ref fluid/layers/detection.py sigmoid_focal_loss."""
    out = _out(x.dtype, x.shape)
    _append("sigmoid_focal_loss",
            {"X": [x.name], "Label": [label.name], "FgNum": [fg_num.name]},
            {"Out": [out.name]}, {"gamma": gamma, "alpha": alpha})
    return out


def affine_grid(theta, out_shape) -> Variable:
    """ref fluid/layers/nn.py affine_grid."""
    n, _, h, w = out_shape
    out = _out(theta.dtype, (n, h, w, 2))
    _append("affine_grid", {"Theta": [theta.name]}, {"Output": [out.name]},
            {"output_shape": list(out_shape)})
    return out


def grid_sampler(x, grid, mode="bilinear", padding_mode="zeros",
                 align_corners=True) -> Variable:
    """ref fluid/layers/nn.py grid_sampler."""
    out = _out(x.dtype, (x.shape[0], x.shape[1], grid.shape[1],
                         grid.shape[2]))
    _append("grid_sampler", {"X": [x.name], "Grid": [grid.name]},
            {"Output": [out.name]},
            {"mode": mode, "padding_mode": padding_mode,
             "align_corners": align_corners})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0) -> Variable:
    """ref fluid/layers/detection.py roi_pool (batch-1 static policy)."""
    out = _out(input.dtype, (rois.shape[0], input.shape[1], pooled_height,
                             pooled_width))
    _append("roi_pool", {"X": [input.name], "ROIs": [rois.name]},
            {"Out": [out.name]},
            {"pooled_height": pooled_height, "pooled_width": pooled_width,
             "spatial_scale": spatial_scale})
    return out


def row_conv(input, future_context_size, sequence_length=None,
             param_attr=None) -> Variable:
    """ref fluid/layers/nn.py row_conv (owns the lookahead filter)."""
    d = input.shape[-1]
    w = create_parameter((future_context_size + 1, d), input.dtype,
                         attr=param_attr)
    out = _out(input.dtype, input.shape)
    inputs = {"X": [input.name], "Filter": [w.name]}
    if sequence_length is not None:
        inputs["Lengths"] = [sequence_length.name]
    _append("row_conv", inputs, {"Out": [out.name]}, {})
    return out


def sequence_conv(input, num_filters, filter_size=3, padding_start=None,
                  sequence_length=None, param_attr=None, bias_attr=None,
                  act=None, name=None) -> Variable:
    """ref fluid/layers/sequence_lod.py sequence_conv -> sequence_conv_op:
    windowed conv over each padded sequence's time axis."""
    din = input.shape[-1]
    w = create_parameter((filter_size * din, num_filters), input.dtype,
                         attr=param_attr, name=f"{name}.w" if name else None)
    out = _out(input.dtype, tuple(input.shape[:-1]) + (num_filters,))
    inputs = {"X": [input.name], "Filter": [w.name]}
    if sequence_length is not None:
        inputs["Lengths"] = [sequence_length.name]
    _append("sequence_conv_padded", inputs, {"Out": [out.name]},
            {"contextLength": int(filter_size),
             "contextStart": padding_start})
    res = out
    if bias_attr is not False:
        b = create_parameter((num_filters,), input.dtype, attr=bias_attr,
                             default_initializer=I.Constant(0.0),
                             name=f"{name}.b" if name else None)
        res = elementwise_add(out, b, axis=len(out.shape) - 1)
    return _apply_act(res, act)


def nce(input, label, num_total_classes, sample_ids, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None) -> Variable:
    """ref fluid/layers/nn.py nce -> nce_op.cc.  The reference samples
    negatives inside the op; the padded contract takes explicit
    ``sample_ids`` (batch, num_neg) — sampling is data-pipeline work, and
    an in-graph sampler would re-trace per draw."""
    if num_neg_samples is not None and \
            int(num_neg_samples) != int(sample_ids.shape[-1]):
        raise ValueError(
            f"nce: num_neg_samples={num_neg_samples} disagrees with "
            f"sample_ids width {sample_ids.shape[-1]} — the noise prior "
            "comes from the drawn negatives")
    dim = input.shape[-1]
    w = create_parameter((num_total_classes, dim), input.dtype,
                         attr=param_attr, name=f"{name}.w" if name else None)
    if bias_attr is not False:
        b = create_parameter((num_total_classes,), input.dtype,
                             attr=bias_attr,
                             default_initializer=I.Constant(0.0),
                             name=f"{name}.b" if name else None)
        bias_name = b.name
    else:
        zb = fill_constant((num_total_classes,), input.dtype, 0.0)
        bias_name = zb.name
    out = _out(input.dtype, (input.shape[0], 1))
    _append("nce", {"Input": [input.name], "Label": [label.name],
                    "Weight": [w.name], "Bias": [bias_name],
                    "SampleIds": [sample_ids.name]},
            {"Cost": [out.name]},
            {"num_total_classes": int(num_total_classes)})
    return out


# -- CTC / sequence distance (ref fluid/layers/loss.py warpctc,
#    fluid/layers/nn.py edit_distance, ctc_greedy_decoder) -------------------

def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None) -> Variable:
    """ref fluid/layers/loss.py warpctc -> warpctc_op.cc (padded mode:
    input (T, B, C), label (B, L), lengths (B,))."""
    if input_length is None or label_length is None:
        raise ValueError("padded-mode warpctc needs input_length and "
                         "label_length (LoD mode is descoped: README)")
    B = input.shape[1]
    loss = _out(input.dtype, (B, 1))
    _append("warpctc",
            {"Logits": [input.name], "Label": [label.name],
             "LogitsLength": [input_length.name],
             "LabelLength": [label_length.name]},
            {"Loss": [loss.name]},
            {"blank": blank, "norm_by_times": norm_by_times})
    return loss


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """ref fluid/layers/nn.py edit_distance -> edit_distance_op.cc.
    Returns (distance (B,1), seq_num (1,))."""
    B = input.shape[0]
    dist = _out("float32", (B, 1))
    num = _out("int32", (1,))
    ins = {"Hyps": [input.name], "Refs": [label.name]}
    if input_length is not None:
        ins["HypsLength"] = [input_length.name]
    if label_length is not None:
        ins["RefsLength"] = [label_length.name]
    _append("edit_distance", ins,
            {"Out": [dist.name], "SequenceNum": [num.name]},
            {"normalized": normalized})
    return dist, num


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0):
    """ref fluid/layers/nn.py ctc_greedy_decoder (padded mode) ->
    ctc_align_op: input (B, T, C).  Returns (decoded (B,T), lengths (B,))."""
    B, T = input.shape[0], input.shape[1]
    out = _out("int32", (B, T))
    lens = _out("int32", (B,))
    ins = {"Input": [input.name]}
    if input_length is not None:
        ins["InputLength"] = [input_length.name]
    _append("ctc_align", ins,
            {"Output": [out.name], "OutputLength": [lens.name]},
            {"blank": blank, "padding_value": padding_value})
    return out, lens


# -- 3D conv/pool family (ref fluid/layers/nn.py conv3d/pool3d/...) ----------

def _triple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * 3


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None
           ) -> Variable:
    """ref fluid/layers/nn.py conv3d (NCDHW) -> conv3d op."""
    ks = _triple(filter_size)
    st, pd, dl = _triple(stride), _triple(padding), _triple(dilation)
    cin = input.shape[1]
    w = create_parameter((num_filters, cin // groups) + ks, input.dtype,
                         attr=param_attr)
    spatial = tuple(
        -1 if input.shape[2 + i] < 0 else
        (input.shape[2 + i] + 2 * pd[i] - (dl[i] * (ks[i] - 1) + 1))
        // st[i] + 1 for i in range(3))
    out = _out(input.dtype, (input.shape[0], num_filters) + spatial)
    ins = {"Input": [input.name], "Filter": [w.name]}
    if bias_attr is not False:
        b = create_parameter((num_filters,), input.dtype, attr=bias_attr,
                             default_initializer=I.Constant(0.0))
        ins["Bias"] = [b.name]
    _append("conv3d", ins, {"Output": [out.name]},
            {"strides": list(st), "paddings": list(pd),
             "dilations": list(dl), "groups": groups})
    return _apply_act(out, act)


def conv3d_transpose(input, num_filters, filter_size, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1, param_attr=None,
                     bias_attr=None, act=None, name=None) -> Variable:
    """ref fluid/layers/nn.py conv3d_transpose -> conv3d_transpose op."""
    ks = _triple(filter_size)
    st, pd, dl = _triple(stride), _triple(padding), _triple(dilation)
    opd = _triple(output_padding)
    cin = input.shape[1]
    w = create_parameter((cin, num_filters // groups) + ks, input.dtype,
                         attr=param_attr)
    spatial = tuple(
        -1 if input.shape[2 + i] < 0 else
        (input.shape[2 + i] - 1) * st[i] - 2 * pd[i]
        + dl[i] * (ks[i] - 1) + 1 + opd[i] for i in range(3))
    out = _out(input.dtype, (input.shape[0], num_filters) + spatial)
    ins = {"Input": [input.name], "Filter": [w.name]}
    if bias_attr is not False:
        b = create_parameter((num_filters,), input.dtype, attr=bias_attr,
                             default_initializer=I.Constant(0.0))
        ins["Bias"] = [b.name]
    _append("conv3d_transpose", ins, {"Output": [out.name]},
            {"strides": list(st), "paddings": list(pd),
             "dilations": list(dl), "groups": groups,
             "output_padding": list(opd)})
    return _apply_act(out, act)


def pool3d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, exclusive=True,
           name=None) -> Variable:
    """ref fluid/layers/nn.py pool3d -> pool3d op (NCDHW)."""
    ks = _triple(pool_size)
    st = _triple(pool_stride if pool_stride is not None else pool_size)
    pd = _triple(pool_padding)
    if global_pooling:
        spatial = (1, 1, 1)
    else:
        spatial = tuple(
            -1 if input.shape[2 + i] < 0 else
            (input.shape[2 + i] + 2 * pd[i] - ks[i]) // st[i] + 1
            for i in range(3))
    out = _out(input.dtype, (input.shape[0], input.shape[1]) + spatial)
    _append("pool3d", {"X": [input.name]}, {"Out": [out.name]},
            {"ksize": list(ks), "strides": list(st), "paddings": list(pd),
             "pooling_type": pool_type, "global_pooling": global_pooling,
             "exclusive": exclusive})
    return out


# -- detection DSL (ref fluid/layers/detection.py) ---------------------------

def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0, name=None):
    """ref detection.py yolo_box -> yolo_box op.  Returns (boxes, scores)."""
    n = x.shape[0]
    an = len(anchors) // 2
    hw = x.shape[2] * x.shape[3] if x.shape[2] > 0 and x.shape[3] > 0 else -1
    cnt = an * hw if hw > 0 else -1
    boxes = _out(x.dtype, (n, cnt, 4))
    scores = _out(x.dtype, (n, cnt, class_num))
    _append("yolo_box", {"X": [x.name], "ImgSize": [img_size.name]},
            {"Boxes": [boxes.name], "Scores": [scores.name]},
            {"anchors": list(anchors), "class_num": class_num,
             "conf_thresh": conf_thresh,
             "downsample_ratio": downsample_ratio, "clip_bbox": clip_bbox,
             "scale_x_y": scale_x_y})
    return boxes, scores


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, scale_x_y=1.0, name=None) -> Variable:
    """ref detection.py yolov3_loss -> yolov3_loss op."""
    loss = _out(x.dtype, (x.shape[0],))
    ins = {"X": [x.name], "GTBox": [gt_box.name], "GTLabel": [gt_label.name]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score.name]
    _append("yolov3_loss", ins, {"Loss": [loss.name]},
            {"anchors": list(anchors), "anchor_mask": list(anchor_mask),
             "class_num": class_num, "ignore_thresh": ignore_thresh,
             "downsample_ratio": downsample_ratio,
             "use_label_smooth": use_label_smooth, "scale_x_y": scale_x_y})
    return loss


def multiclass_nms(bboxes, scores, score_threshold=0.05, nms_top_k=-1,
                   keep_top_k=-1, nms_threshold=0.3, normalized=True,
                   background_label=0, name=None) -> Variable:
    """ref detection.py multiclass_nms -> multiclass_nms op (dense padded
    output, (N, keep, 6))."""
    n = bboxes.shape[0]
    keep = keep_top_k if keep_top_k > 0 else -1
    out = _out(bboxes.dtype, (n, keep, 6))
    num = _out("int32", (n,))
    _append("multiclass_nms",
            {"BBoxes": [bboxes.name], "Scores": [scores.name]},
            {"Out": [out.name], "NmsRoisNum": [num.name]},
            {"score_threshold": score_threshold, "nms_top_k": nms_top_k,
             "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
             "normalized": normalized,
             "background_label": background_label})
    return out


def density_prior_box(input, image, densities, fixed_sizes,
                      fixed_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    """ref detection.py density_prior_box -> density_prior_box op."""
    num = sum(d * d for d in densities for _ in fixed_ratios)
    H, W = input.shape[2], input.shape[3]
    shape = (-1, 4) if flatten_to_2d else (H, W, num, 4)
    boxes = _out(input.dtype, shape)
    variances = _out(input.dtype, shape)
    _append("density_prior_box",
            {"Input": [input.name], "Image": [image.name]},
            {"Boxes": [boxes.name], "Variances": [variances.name]},
            {"densities": list(densities), "fixed_sizes": list(fixed_sizes),
             "fixed_ratios": list(fixed_ratios), "variances": list(variance),
             "clip": clip, "step_w": steps[0], "step_h": steps[1],
             "offset": offset, "flatten_to_2d": flatten_to_2d})
    return boxes, variances


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=1, deformable_groups=1,
                    im2col_step=1, param_attr=None, bias_attr=None,
                    modulated=True, name=None) -> Variable:
    """ref fluid/layers/nn.py deformable_conv -> deformable_conv(_v1) op."""
    ks = _pair(filter_size)
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    cin = input.shape[1]
    w = create_parameter((num_filters, cin // groups) + ks, input.dtype,
                         attr=param_attr)
    spatial = tuple(
        -1 if input.shape[2 + i] < 0 else
        (input.shape[2 + i] + 2 * pd[i] - (dl[i] * (ks[i] - 1) + 1))
        // st[i] + 1 for i in range(2))
    out = _out(input.dtype, (input.shape[0], num_filters) + spatial)
    ins = {"Input": [input.name], "Offset": [offset.name],
           "Filter": [w.name]}
    op_type = "deformable_conv" if modulated else "deformable_conv_v1"
    if modulated:
        ins["Mask"] = [mask.name]
    _append(op_type, ins, {"Output": [out.name]},
            {"strides": list(st), "paddings": list(pd),
             "dilations": list(dl), "groups": groups,
             "deformable_groups": deformable_groups,
             "im2col_step": im2col_step})
    return out


def psroi_pool(input, rois, rois_batch_id, output_channels, spatial_scale,
               pooled_height, pooled_width, name=None) -> Variable:
    """ref detection.py psroi_pool -> psroi_pool op."""
    out = _out(input.dtype,
               (rois.shape[0], output_channels, pooled_height, pooled_width))
    _append("psroi_pool",
            {"X": [input.name], "ROIs": [rois.name],
             "RoisBatchId": [rois_batch_id.name]},
            {"Out": [out.name]},
            {"output_channels": output_channels,
             "pooled_height": pooled_height, "pooled_width": pooled_width,
             "spatial_scale": spatial_scale})
    return out


# -- misc new statics --------------------------------------------------------

def affine_channel(x, scale, bias, name=None) -> Variable:
    """ref fluid/layers/nn.py affine_channel."""
    out = _out(x.dtype, x.shape)
    _append("affine_channel",
            {"X": [x.name], "Scale": [scale.name], "Bias": [bias.name]},
            {"Out": [out.name]}, {})
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None
           ) -> Variable:
    """ref fluid/layers/nn.py unfold -> unfold op (im2col)."""
    ks = _pair(kernel_sizes)
    st, pd, dl = _pair(strides), _pair(paddings), _pair(dilations)
    n, c, h, w = x.shape
    lh = -1 if h < 0 else (h + 2 * pd[0] - (dl[0] * (ks[0] - 1) + 1)) \
        // st[0] + 1
    lw = -1 if w < 0 else (w + 2 * pd[1] - (dl[1] * (ks[1] - 1) + 1)) \
        // st[1] + 1
    L = -1 if (lh < 0 or lw < 0) else lh * lw
    out = _out(x.dtype, (n, c * ks[0] * ks[1], L))
    _append("unfold", {"X": [x.name]}, {"Y": [out.name]},
            {"kernel_sizes": list(ks), "strides": list(st),
             "paddings": list(pd), "dilations": list(dl)})
    return out


def maxout(x, groups, name=None) -> Variable:
    """ref fluid/layers/nn.py maxout."""
    out = _out(x.dtype,
               (x.shape[0], x.shape[1] // groups) + tuple(x.shape[2:]))
    _append("maxout", {"X": [x.name]}, {"Out": [out.name]},
            {"groups": groups})
    return out


def mean_iou(input, label, num_classes):
    """ref fluid/layers/nn.py mean_iou.  Returns (mean_iou, out_wrong,
    out_correct)."""
    miou = _out("float32", ())
    wrong = _out("float32", (num_classes,))
    correct = _out("float32", (num_classes,))
    _append("mean_iou",
            {"Predictions": [input.name], "Labels": [label.name]},
            {"OutMeanIou": [miou.name], "OutWrong": [wrong.name],
             "OutCorrect": [correct.name]},
            {"num_classes": num_classes})
    return miou, wrong, correct


def argsort(x, axis=-1, descending=False, name=None):
    """ref fluid/layers/tensor.py argsort.  Returns (sorted, indices)."""
    out = _out(x.dtype, x.shape)
    idx = _out("int64", x.shape)
    _append("argsort", {"X": [x.name]},
            {"Out": [out.name], "Indices": [idx.name]},
            {"axis": axis, "descending": descending})
    return out, idx
