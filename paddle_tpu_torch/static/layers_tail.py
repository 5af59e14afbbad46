"""fluid.layers DSL tail: wrappers over already-registered lowerings
(counterpart of paddle_tpu/static/layers_tail.py, pure Python, copied).

Reference parity: the remainder of python/paddle/fluid/layers/ (nn.py,
tensor.py, loss.py, detection.py, sequence_lod.py) — each function appends
the same-named op (or the documented composition) exactly like the
reference's LayerHelper.append_op flow.  Ops themselves live in
static/ops*.py; this module is pure graph-building surface.
"""
from __future__ import annotations

import numpy as np

from ..core import dtype as _dtype_mod
from .layers import (  # noqa: F401 — shared builders
    _append,
    _apply_act,
    _out,
    _pair,
    Variable,
)
from . import layers as _L

__all__ = []


def _export(fn):
    __all__.append(fn.__name__)
    setattr(_L, fn.__name__, fn)  # surface on static.layers like the ref
    return fn


def _xo(op_type, x, attrs=None, dtype=None, shape=None, out_slot="Out",
        in_slot="X"):
    out = _out(dtype or x.dtype, x.shape if shape is None else shape)
    _append(op_type, {in_slot: [x.name]}, {out_slot: [out.name]},
            attrs or {})
    return out


# -- logicals / reductions ---------------------------------------------------

def _logical(op_type):
    def fn(x, y=None, name=None):
        ins = {"X": [x.name]}
        if y is not None:
            ins["Y"] = [y.name]
        out = _out("bool", x.shape)
        _append(op_type, ins, {"Out": [out.name]})
        return out

    fn.__name__ = op_type
    return _export(fn)


logical_and = _logical("logical_and")
logical_or = _logical("logical_or")
logical_xor = _logical("logical_xor")
logical_not = _logical("logical_not")


def _reduce(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        if dim is None:
            shape = () if not keep_dim else (1,) * input.ndim
        else:
            dims = [dim] if isinstance(dim, int) else list(dim)
            dims = [d % input.ndim for d in dims]
            shape = tuple(
                (1 if keep_dim else None) if i in dims else s
                for i, s in enumerate(input.shape))
            shape = tuple(s for s in shape if s is not None)
        out = _out("bool" if op_type in ("reduce_all", "reduce_any")
                   else input.dtype, shape)
        _append(op_type, {"X": [input.name]}, {"Out": [out.name]},
                {"dim": dim, "keep_dim": keep_dim,
                 "reduce_all": dim is None})
        return out

    fn.__name__ = op_type
    return _export(fn)


reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")
reduce_all = _reduce("reduce_all")
reduce_any = _reduce("reduce_any")


# -- creation ----------------------------------------------------------------

@_export
def ones(shape, dtype="float32", name=None):
    return _L.fill_constant(shape, dtype, 1.0)


@_export
def zeros(shape, dtype="float32", name=None):
    return _L.fill_constant(shape, dtype, 0.0)


@_export
def ones_like(x, name=None):
    out = _out(x.dtype, x.shape)
    _append("fill_any_like", {"X": [x.name]}, {"Out": [out.name]},
            {"value": 1.0})
    return out


@_export
def zeros_like(x, name=None):
    return _xo("fill_zeros_like", x)


@_export
def eye(num_rows, num_columns=None, dtype="float32", name=None):
    n = num_columns or num_rows
    vals = np.eye(num_rows, n).reshape(-1).tolist()
    out = _out(dtype, (num_rows, n))
    _append("assign_value", {}, {"Out": [out.name]},
            {"shape": (num_rows, n), "dtype": dtype, "fp32_values": vals})
    return out


@_export
def diag(diagonal, name=None):
    n = diagonal.shape[0]
    out = _out(diagonal.dtype, (n, n))
    _append("diag", {"Diagonal": [diagonal.name]}, {"Out": [out.name]})
    return out


@_export
def create_tensor(dtype="float32", name=None, persistable=False):
    from .framework import default_main_program

    return default_main_program().current_block().create_var(
        name=name, dtype=dtype, persistable=persistable)


@_export
def create_global_var(shape, value, dtype="float32", persistable=False,
                      force_cpu=False, name=None):
    from ..nn import initializer as I
    from .layers import create_parameter

    del force_cpu
    return create_parameter(tuple(shape), dtype, name=name,
                            default_initializer=I.Constant(value),
                            trainable=False)


@_export
def gaussian_random(shape, mean=0.0, std=1.0, dtype="float32", seed=0,
                    name=None):
    out = _out(dtype, tuple(shape))
    _append("gaussian_random", {}, {"Out": [out.name]},
            {"shape": tuple(shape), "mean": mean, "std": std,
             "dtype": dtype, "seed": seed})
    return out


@_export
def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    out = _out(dtype, tuple(shape))
    _append("uniform_random", {}, {"Out": [out.name]},
            {"shape": tuple(shape), "min": min, "max": max, "dtype": dtype,
             "seed": seed})
    return out


@_export
def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,
                                    input_dim_idx=0, output_dim_idx=0,
                                    dtype="float32"):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return gaussian_random(shape, mean, std, dtype)


@_export
def uniform_random_batch_size_like(input, shape, min=-1.0, max=1.0,
                                   input_dim_idx=0, output_dim_idx=0,
                                   dtype="float32"):
    shape = list(shape)
    shape[output_dim_idx] = input.shape[input_dim_idx]
    return uniform_random(shape, dtype, min, max)


@_export
def linspace(start, stop, num, dtype="float32", name=None):
    out = _out(dtype, (int(num),))
    ins = {}
    if isinstance(start, Variable):
        ins["Start"] = [start.name]
    if isinstance(stop, Variable):
        ins["Stop"] = [stop.name]
    attrs = {"num": int(num), "dtype": dtype}
    if not isinstance(start, Variable):
        s = _L.fill_constant((1,), dtype, float(start))
        ins["Start"] = [s.name]
    if not isinstance(stop, Variable):
        e = _L.fill_constant((1,), dtype, float(stop))
        ins["Stop"] = [e.name]
    _append("linspace", ins, {"Out": [out.name]}, attrs)
    return out


# -- manipulation ------------------------------------------------------------

@_export
def reverse(x, axis, name=None):
    return _xo("reverse", x, {"axis": [axis] if isinstance(axis, int)
                              else list(axis)})


@_export
def unbind(input, axis=0, name=None):
    ax = axis % input.ndim
    n = input.shape[ax]
    shape = tuple(s for i, s in enumerate(input.shape) if i != ax)
    outs = [_out(input.dtype, shape) for _ in range(n)]
    _append("unbind", {"X": [input.name]},
            {"Out": [o.name for o in outs]}, {"axis": axis})
    return outs


@_export
def unstack(x, axis=0, num=None, name=None):
    ax = axis % x.ndim
    n = num or x.shape[ax]
    shape = tuple(s for i, s in enumerate(x.shape) if i != ax)
    outs = [_out(x.dtype, shape) for _ in range(n)]
    _append("unstack", {"X": [x.name]}, {"Y": [o.name for o in outs]},
            {"axis": axis, "num": n})
    return outs


@_export
def strided_slice(input, axes, starts, ends, strides, name=None):
    shape = list(input.shape)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        if shape[ax] >= 0:
            n = shape[ax]
            # normalize negative indices the way the slice executes
            s_ = s + n if s < 0 else s
            e_ = e + n if e < 0 else e
            if st > 0:
                shape[ax] = max(0, -(-(min(e_, n) - min(max(s_, 0), n))
                                     // st))
            else:
                shape[ax] = max(0, -(-(min(s_, n - 1) - max(e_, -1))
                                     // -st))
    out = _out(input.dtype, tuple(shape))
    _append("strided_slice", {"Input": [input.name]}, {"Out": [out.name]},
            {"axes": list(axes), "starts": list(starts),
             "ends": list(ends), "strides": list(strides)})
    return out


@_export
def crop_tensor(x, shape=None, offsets=None, name=None):
    out = _out(x.dtype, tuple(shape))
    _append("crop_tensor", {"X": [x.name]}, {"Out": [out.name]},
            {"shape": list(shape), "offsets": list(offsets or [])})
    return out


@_export
def crop(x, shape=None, offsets=None, name=None):
    return crop_tensor(x, shape, offsets, name)


@_export
def expand_as(x, target_tensor, name=None):
    out = _out(x.dtype, target_tensor.shape)
    _append("expand_as", {"X": [x.name],
                          "target_tensor": [target_tensor.name]},
            {"Out": [out.name]})
    return out


@_export
def pad_constant_like(x, y, pad_value=0.0, name=None):
    out = _out(y.dtype, x.shape)
    _append("pad_constant_like", {"X": [x.name], "Y": [y.name]},
            {"Out": [out.name]}, {"pad_value": pad_value})
    return out


@_export
def scatter_nd_add(ref, index, updates, name=None):
    out = _out(ref.dtype, ref.shape)
    _append("scatter_nd_add",
            {"X": [ref.name], "Index": [index.name],
             "Updates": [updates.name]},
            {"Out": [out.name]})
    return out


@_export
def scatter_nd(index, updates, shape, name=None):
    z = zeros(shape, updates.dtype)
    return scatter_nd_add(z, index, updates)


@_export
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    return _xo("shard_index", input,
               {"index_num": index_num, "nshards": nshards,
                "shard_id": shard_id, "ignore_value": ignore_value})


@_export
def gather_tree(ids, parents):
    out = _out(ids.dtype, ids.shape)
    _append("gather_tree", {"Ids": [ids.name], "Parents": [parents.name]},
            {"Out": [out.name]})
    return out


@_export
def sum(x, name=None):
    """fluid.layers.sum over Variables; attaching this to the layers
    module shadows the builtin for code inside layers.py, so non-Variable
    inputs dispatch to builtins.sum (generators/int lists keep working)."""
    import builtins

    xs = x if isinstance(x, (list, tuple)) else [x]
    if not xs or not isinstance(xs[0], Variable):
        return builtins.sum(x)
    out = _out(xs[0].dtype, xs[0].shape)
    _append("sum", {"X": [v.name for v in xs]}, {"Out": [out.name]})
    return out


@_export
def sums(input, out=None):
    res = sum(input)
    if out is not None:
        _append("assign", {"X": [res.name]}, {"Out": [out.name]})
        return out
    return res


@_export
def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    # the runtime rule reshapes back to x.shape[:xd] + y.shape[yd:]
    out = _out(x.dtype,
               tuple(x.shape[:x_num_col_dims]) + tuple(
                   y.shape[y_num_col_dims:]))
    _append("mul", {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]},
            {"x_num_col_dims": x_num_col_dims,
             "y_num_col_dims": y_num_col_dims})
    return out


@_export
def rank(input):
    return _L.fill_constant((1,), "int32", input.ndim)


@_export
def size(input):
    out = _out("int64", ())
    _append("size", {"Input": [input.name]}, {"Out": [out.name]})
    return out


@_export
def clip_by_norm(x, max_norm, name=None):
    return _xo("clip_by_norm", x, {"max_norm": max_norm})


@_export
def isfinite(x, name=None):
    out = _out("bool", (1,))
    _append("isfinite", {"X": [x.name]}, {"Out": [out.name]})
    return out


@_export
def has_inf(x):
    out = _out("bool", x.shape)  # isinf_v2 is elementwise
    _append("isinf_v2", {"X": [x.name]}, {"Out": [out.name]})
    return reduce_any(out)


@_export
def has_nan(x):
    out = _out("bool", x.shape)
    _append("isnan_v2", {"X": [x.name]}, {"Out": [out.name]})
    return reduce_any(out)


# -- losses / misc -----------------------------------------------------------

@_export
def bpr_loss(input, label, name=None):
    out = _out(input.dtype, (input.shape[0], 1))
    _append("bpr_loss", {"X": [input.name], "Label": [label.name]},
            {"Out": [out.name]})
    return out


@_export
def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    from .layers import create_parameter
    from ..nn import initializer as I

    centers = create_parameter((num_classes, input.shape[-1]), input.dtype,
                               default_initializer=I.Constant(0.0),
                               trainable=False)
    rate = _L.fill_constant((1,), "float32", alpha)
    loss = _out(input.dtype, (input.shape[0], 1))
    diff = _out(input.dtype, input.shape)
    _append("center_loss",
            {"X": [input.name], "Label": [label.name],
             "Centers": [centers.name], "CenterUpdateRate": [rate.name]},
            {"Loss": [loss.name], "SampleCenterDiff": [diff.name],
             "CentersOut": [centers.name]},
            {"need_update": update_center})
    return loss


@_export
def margin_rank_loss(label, left, right, margin=0.1, name=None):
    out = _out(left.dtype, left.shape)
    _append("margin_rank_loss",
            {"Label": [label.name], "X1": [left.name], "X2": [right.name]},
            {"Out": [out.name]}, {"margin": margin})
    return out


@_export
def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    out = _out(input.dtype, (input.shape[0], 1))
    _append("teacher_student_sigmoid_loss",
            {"X": [input.name], "Label": [label.name]},
            {"Y": [out.name]},
            {"soft_max_up_bound": soft_max_up_bound,
             "soft_max_lower_bound": soft_max_lower_bound})
    return out


@_export
def cross_entropy2(input, label, ignore_index=-100):
    y = _out(input.dtype, tuple(input.shape[:-1]) + (1,))
    match = _out(input.dtype, tuple(input.shape[:-1]) + (1,))
    xshape = _out(input.dtype, input.shape)
    _append("cross_entropy2", {"X": [input.name], "Label": [label.name]},
            {"Y": [y.name], "MatchX": [match.name],
             "XShape": [xshape.name]},
            {"ignore_index": ignore_index})
    return y


@_export
def dice_loss(input, label, epsilon=1e-5):
    """ref fluid/layers/nn.py dice_loss: one_hot the int labels, dice per
    SAMPLE over dims 1.., then mean — the reference composition exactly."""
    # v1 one_hot semantics: the trailing size-1 label dim is replaced by
    # the class dim (label [N1..ND-1,1] -> [N1..ND-1,classes])
    depth = input.shape[-1]
    label_oh = _out("float32", tuple(label.shape[:-1]) + (depth,))
    _append("one_hot", {"X": [label.name]}, {"Out": [label_oh.name]},
            {"depth": depth})
    rd = list(range(1, input.ndim))
    inse = _L.reduce_sum(_L.elementwise_mul(input, label_oh), dim=rd)
    denom = _L.elementwise_add(_L.reduce_sum(input, dim=rd),
                               _L.reduce_sum(label_oh, dim=rd))
    two = _L.fill_constant((), "float32", 2.0)
    one = _L.fill_constant((), "float32", 1.0)
    eps = _L.fill_constant((), "float32", epsilon)
    score = _L.elementwise_sub(one, _L.elementwise_div(
        _L.elementwise_mul(inse, two), _L.elementwise_add(denom, eps)))
    return _L.mean(score)


@_export
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """ref fluid/layers/loss.py npair_loss (NIPS'16 N-pair): soft-label CE
    over the anchor·positiveᵀ similarity matrix, where the soft target is
    the row-normalized label-EQUALITY matrix; plus Beta*l2_reg * mean
    per-sample embedding norms — the reference composition exactly."""
    B = labels.shape[0]
    lab = _L.reshape(labels, (B, 1))
    expanded = _out(lab.dtype, (B, B))
    _append("expand_v2", {"X": [lab.name]}, {"Out": [expanded.name]},
            {"shape": (B, B)})
    eq_b = _out("bool", (B, B))
    _append("equal", {"X": [expanded.name],
                      "Y": [_L.transpose(expanded, [1, 0]).name]},
            {"Out": [eq_b.name]})
    eq = _L.cast(eq_b, "float32")
    target = _L.elementwise_div(
        eq, _L.reduce_sum(eq, dim=1, keep_dim=True))
    l2 = _L.elementwise_add(
        _L.mean(_L.reduce_sum(_L.elementwise_mul(anchor, anchor), dim=1)),
        _L.mean(_L.reduce_sum(_L.elementwise_mul(positive, positive),
                              dim=1)))
    reg = _L.fill_constant((), "float32", 0.25 * l2_reg)
    sim = _L.matmul(anchor, positive, transpose_y=True)
    ce = _L.softmax_with_cross_entropy(sim, target, soft_label=True)
    celoss = _L.mean(_L.reduce_sum(_L.elementwise_mul(target, ce), dim=0))
    return _L.elementwise_add(celoss, _L.elementwise_mul(reg, l2))


@_export
def fsp_matrix(x, y):
    out = _out(x.dtype, (x.shape[0], x.shape[1], y.shape[1]))
    _append("fsp", {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]})
    return out


@_export
def iou_similarity(x, y, box_normalized=True, name=None):
    out = _out(x.dtype, (x.shape[0], y.shape[0]))
    _append("iou_similarity", {"X": [x.name], "Y": [y.name]},
            {"Out": [out.name]}, {"box_normalized": box_normalized})
    return out


@_export
def box_clip(input, im_info, name=None):
    out = _out(input.dtype, input.shape)
    _append("box_clip", {"Input": [input.name], "ImInfo": [im_info.name]},
            {"Output": [out.name]})
    return out


@_export
def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    out = _out(input.dtype, (rois.shape[0], input.shape[1], pooled_height,
                             pooled_width))
    ins = {"X": [input.name], "ROIs": [rois.name]}
    if batch_roi_nums is not None:
        ins["BatchRoINums"] = [batch_roi_nums.name]
    _append("prroi_pool", ins, {"Out": [out.name]},
            {"spatial_scale": spatial_scale, "pooled_height": pooled_height,
             "pooled_width": pooled_width})
    return out


@_export
def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    out = _out(ins.dtype, ins.shape)
    w = _out(ins.dtype, (ins.shape[0], 1))
    idx = _out("int32", (ins.shape[0], 2))
    _append("filter_by_instag",
            {"Ins": [ins.name], "Ins_tag": [ins_tag.name],
             "Filter_tag": [filter_tag.name]},
            {"Out": [out.name], "LossWeight": [w.name],
             "IndexMap": [idx.name]},
            {"is_lod": is_lod, "out_val_if_empty": out_val_if_empty})
    return out, w


@_export
def data_norm(input, name=None, epsilon=1e-4):
    from .layers import create_parameter
    from ..nn import initializer as I

    c = input.shape[-1]
    bs = create_parameter((c,), "float32", default_initializer=I.Constant(
        1e4), trainable=False, name=f"{name}.batch_size" if name else None)
    bsum = create_parameter((c,), "float32",
                            default_initializer=I.Constant(0.0),
                            trainable=False)
    bsq = create_parameter((c,), "float32",
                           default_initializer=I.Constant(1e4),
                           trainable=False)
    y = _out(input.dtype, input.shape)
    _append("data_norm",
            {"X": [input.name], "BatchSize": [bs.name],
             "BatchSum": [bsum.name], "BatchSquareSum": [bsq.name]},
            {"Y": [y.name], "BatchSizeOut": [bs.name],
             "BatchSumOut": [bsum.name], "BatchSquareSumOut": [bsq.name]},
            {"epsilon": epsilon})
    return y


@_export
def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    ks = _pair(filter_size)
    st = _pair(stride)
    pd = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    n, c, h, w = input.shape
    oh = -1 if h < 0 else (h + pd[0] + pd[2] - ks[0]) // st[0] + 1
    ow = -1 if w < 0 else (w + pd[1] + pd[3] - ks[1]) // st[1] + 1
    rows = -1 if (oh < 0 or ow < 0 or n < 0) else n * oh * ow
    out = _out(input.dtype, (rows, c * ks[0] * ks[1]))
    _append("im2sequence", {"X": [input.name]}, {"Out": [out.name]},
            {"kernels": list(ks), "strides": list(st), "paddings": list(pd)})
    return out


@_export
def inplace_abn(input, act="identity", is_test=False, momentum=0.9,
                epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    from .layers import create_parameter
    from ..nn import initializer as I

    c = input.shape[1]
    scale = create_parameter((c,), input.dtype, attr=param_attr,
                             default_initializer=I.Constant(1.0))
    bias = create_parameter((c,), input.dtype, attr=bias_attr,
                            default_initializer=I.Constant(0.0))
    mean = create_parameter((c,), input.dtype,
                            default_initializer=I.Constant(0.0),
                            trainable=False)
    var = create_parameter((c,), input.dtype,
                           default_initializer=I.Constant(1.0),
                           trainable=False)
    y = _out(input.dtype, input.shape)
    _append("inplace_abn",
            {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
             "Mean": [mean.name], "Variance": [var.name]},
            {"Y": [y.name], "MeanOut": [mean.name],
             "VarianceOut": [var.name]},
            {"activation": act, "is_test": is_test, "momentum": momentum,
             "epsilon": epsilon})
    return y


@_export
def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from .layers import create_parameter
    from ..nn import initializer as I

    u = create_parameter((weight.shape[dim],), "float32",
                         default_initializer=I.Constant(1.0),
                         trainable=False)
    out = _out(weight.dtype, weight.shape)
    _append("spectral_norm", {"Weight": [weight.name], "U": [u.name]},
            {"Out": [out.name]},
            {"dim": dim, "power_iters": power_iters, "eps": eps})
    return out


@_export
def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       seed=0):
    """ref loss.py sampled_softmax_with_cross_entropy — sample_logits +
    softmax CE over the (1+num_samples)-way sampled problem."""
    B = logits.shape[0]
    sampled = _out(logits.dtype, (B, 1 + num_samples))
    samples = _out("int32", (B, 1 + num_samples))
    slabels = _out("int32", (B,))
    _append("sample_logits",
            {"Logits": [logits.name], "Labels": [label.name]},
            {"SampledLogits": [sampled.name], "Samples": [samples.name],
             "SampledLabels": [slabels.name]},
            {"num_samples": num_samples, "seed": seed})
    zero = _L.fill_constant((B, 1), "int64", 0)  # true label is column 0
    return _L.softmax_with_cross_entropy(sampled, zero)


@_export
def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """ref nn.py add_position_encoding: alpha*x + beta*sincos — the
    position table is a build-time constant."""
    b, t, d = input.shape
    pos = np.arange(t)[:, None]
    div = np.exp(np.arange(0, d, 2) * -(np.log(10000.0) / d))
    table = np.zeros((t, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: d // 2])
    tab = _out(input.dtype, (1, t, d))
    _append("assign_value", {}, {"Out": [tab.name]},
            {"shape": (1, t, d), "dtype": "float32",
             "fp32_values": table.reshape(-1).tolist()})
    a = _L.fill_constant((), "float32", alpha)
    bta = _L.fill_constant((), "float32", beta)
    return _L.elementwise_add(
        _L.elementwise_mul(input, a),
        _L.elementwise_mul(tab, bta))


@_export
def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 align_corners=True, name=None):
    method = resample.lower()
    if out_shape is None:
        h, w = input.shape[2], input.shape[3]
        out_shape = (int(h * scale), int(w * scale))
    return _L._resize(input, out_shape, method, align_corners)


@_export
def resize_linear(input, out_shape, align_corners=True, name=None):
    out = _out(input.dtype,
               (input.shape[0], input.shape[1], out_shape[0]))
    _append("linear_interp", {"X": [input.name]}, {"Out": [out.name]},
            {"out_w": out_shape[0], "align_corners": align_corners})
    return out


@_export
def resize_trilinear(input, out_shape, align_corners=True, name=None):
    out = _out(input.dtype,
               (input.shape[0], input.shape[1]) + tuple(out_shape))
    _append("trilinear_interp", {"X": [input.name]}, {"Out": [out.name]},
            {"out_d": out_shape[0], "out_h": out_shape[1],
             "out_w": out_shape[2], "align_corners": align_corners})
    return out


@_export
def get_tensor_from_selected_rows(x, name=None):
    return _xo("get_tensor_from_selected_rows", x)


@_export
def merge_selected_rows(x, name=None):
    return _xo("merge_selected_rows", x)


@_export
def lod_reset(x, y=None, target_lod=None):
    return _xo("lod_reset", x)


@_export
def lod_append(x, level):
    del level  # dense layout carries no LoD levels
    return _xo("lod_reset", x)


@_export
def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """ref py_func_op: the callable registers into the op registry keyed
    by id (static/ops_tail2.register_py_func)."""
    from . import ops_tail2

    fid = id(func)
    ops_tail2.register_py_func(fid, func)
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    _append("py_func", {"X": [v.name for v in xs]},
            {"Out": [o.name for o in outs]},
            {"forward_callable_id": fid,
             "out_shapes": [tuple(o.shape) for o in outs],
             "out_dtypes": [_dtype_mod.dtype_name(o.dtype) for o in outs]})
    return out


@_export
def save(x, file_path, overwrite=True):
    _append("save", {"X": [x.name]}, {}, {"file_path": file_path,
                                          "overwrite": overwrite})


@_export
def save_combine(x, file_path, overwrite=True):
    xs = x if isinstance(x, (list, tuple)) else [x]
    _append("save_combine", {"X": [v.name for v in xs]}, {},
            {"file_path": file_path, "overwrite": overwrite})


@_export
def load_combine(out, file_path):
    outs = out if isinstance(out, (list, tuple)) else [out]
    _append("load_combine", {}, {"Out": [o.name for o in outs]},
            {"file_path": file_path})
    return out


# activation-style wrappers over batch-registered act ops
def _act_layer(op_type, **default_attrs):
    def fn(x, name=None, **kw):
        attrs = dict(default_attrs)
        attrs.update(kw)
        return _xo(op_type, x, attrs)

    fn.__name__ = op_type
    return _export(fn)


soft_relu = _act_layer("soft_relu", threshold=40.0)
brelu = _act_layer("brelu", t_min=0.0, t_max=24.0)
stanh = _act_layer("stanh", scale_a=0.67, scale_b=1.7159)


@_export
def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """ref fluid/layers/nn.py chunk_eval -> chunk_eval op.  Returns the
    reference's six outputs (precision, recall, f1, n_infer, n_label,
    n_correct)."""
    outs = {
        "Precision": _out("float32", ()),
        "Recall": _out("float32", ()),
        "F1-Score": _out("float32", ()),
        "NumInferChunks": _out("int64", ()),
        "NumLabelChunks": _out("int64", ()),
        "NumCorrectChunks": _out("int64", ()),
    }
    ins = {"Inference": [input.name], "Label": [label.name]}
    if seq_length is not None:
        ins["SeqLength"] = [seq_length.name]
    _append("chunk_eval", ins, {k: [v.name] for k, v in outs.items()},
            {"chunk_scheme": chunk_scheme,
             "num_chunk_types": num_chunk_types,
             "excluded_chunk_types": list(excluded_chunk_types or [])})
    return (outs["Precision"], outs["Recall"], outs["F1-Score"],
            outs["NumInferChunks"], outs["NumLabelChunks"],
            outs["NumCorrectChunks"])
