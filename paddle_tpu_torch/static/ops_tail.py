"""Lowerings of the reference's long tail of ops (counterpart of
paddle_tpu/static/ops_tail.py): CTC, the 3-D conv and pool families, the
detection suite, the interpolate family, the optimizer updates beyond
sgd / momentum / adam (static/ops.py), beam search and ``gather_tree``, the
fake-quant ops of static quantization (the trainable quant-dequant ops
that ``QuantizationTransformPass`` inserts, with straight-through
gradients, and the frozen-scale op that ``QuantizationFreezePass`` and
post-training quantization leave), and the linalg / manipulation / loss /
metric tail.  Most rules delegate to the port's op library
(paddle_tpu_torch/ops/) as the JAX rules delegate to theirs.

Each optimizer update copies the JAX lowering's fp32 master math term for
term; ``dpsgd``'s noise comes from the Executor's per-op CPU generator, so
its draws repeat for a fixed seed but cannot match ``jax.random``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import dtype as _dtype_mod
from ..core import random as _random
from ..nn import functional as F
from .ops import (_adam, _int32, _one, _reduce, current_device, lookup,
                  one_hot, pad_pairs)
from .registry import register_op


def qmax(bits) -> float:
    """The largest level of a symmetric ``bits``-bit grid (127 for 8)."""
    return float(2 ** (int(bits) - 1) - 1)


def _norm(x):
    """The 2-norm of every element (``jnp.linalg.norm`` of a vector or
    the Frobenius norm of a matrix)."""
    return torch.linalg.vector_norm(x)


# -- optimizer updates (ref operators/optimizers/*.h) ------------------------

@register_op("adamax")
def _adamax(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    m, u = _one(ins, "Moment"), _one(ins, "InfNorm")
    lr = _one(ins, "LearningRate").float()
    b1p = _one(ins, "Beta1Pow").float()
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g32 = g.float()
    m_new = b1 * m + (1 - b1) * g32
    u_new = torch.maximum(b2 * u, g32.abs() + eps)
    p_new = p.float() - lr / (1 - b1p) * m_new / u_new
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [m_new],
            "InfNormOut": [u_new]}


@register_op("adamw")
def _adamw(ins, attrs, op):
    coeff = attrs.get("coeff", 0.01)
    out = _adam(ins, attrs, op)
    p = _one(ins, "Param")
    lr = _one(ins, "LearningRate").float()
    p_new = out["ParamOut"][0].float() - lr * coeff * p.float()
    out["ParamOut"] = [p_new.to(p.dtype)]
    return out


@register_op("adagrad")
def _adagrad(ins, attrs, op):
    p, g, acc = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate").float()
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    acc_new = acc + g32 * g32
    p_new = p.float() - lr * g32 / (torch.sqrt(acc_new) + eps)
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [acc_new]}


@register_op("decayed_adagrad")
def _decayed_adagrad(ins, attrs, op):
    p, g, acc = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Moment")
    lr = _one(ins, "LearningRate").float()
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    acc_new = decay * acc + (1 - decay) * g32 * g32
    p_new = p.float() - lr * g32 / (torch.sqrt(acc_new) + eps)
    return {"ParamOut": [p_new.to(p.dtype)], "MomentOut": [acc_new]}


@register_op("adadelta")
def _adadelta(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    avg_sq_g = _one(ins, "AvgSquaredGrad")
    avg_sq_u = _one(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g32 = g.float()
    avg_sq_g_new = rho * avg_sq_g + (1 - rho) * g32 * g32
    upd = torch.sqrt(avg_sq_u + eps) / torch.sqrt(avg_sq_g_new + eps) * g32
    avg_sq_u_new = rho * avg_sq_u + (1 - rho) * upd * upd
    p_new = p.float() - upd
    return {"ParamOut": [p_new.to(p.dtype)],
            "AvgSquaredGradOut": [avg_sq_g_new],
            "AvgSquaredUpdateOut": [avg_sq_u_new]}


@register_op("rmsprop")
def _rmsprop(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    ms, mg = _one(ins, "MeanSquare"), _one(ins, "MeanGrad")
    mom = _one(ins, "Moment")
    lr = _one(ins, "LearningRate").float()
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    momentum = attrs.get("momentum", 0.0)
    g32 = g.float()
    ms_new = rho * ms + (1 - rho) * g32 * g32
    if attrs.get("centered", False):
        mg_new = rho * mg + (1 - rho) * g32
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
    else:
        mg_new = mg
        denom = torch.sqrt(ms_new + eps)
    mom_new = momentum * mom + lr * g32 / denom
    p_new = p.float() - mom_new
    return {"ParamOut": [p_new.to(p.dtype)], "MeanSquareOut": [ms_new],
            "MeanGradOut": [mg_new], "MomentOut": [mom_new]}


@register_op("ftrl")
def _ftrl(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    sq, lin = _one(ins, "SquaredAccumulator"), _one(ins, "LinearAccumulator")
    lr = _one(ins, "LearningRate").float()
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    g32, p32 = g.float(), p.float()
    sq_new = sq + g32 * g32
    pow_old = sq ** (-lr_power)
    pow_new = sq_new ** (-lr_power)
    sigma = (pow_new - torch.where(sq > 0, pow_old,
                                   torch.zeros_like(pow_old))) / lr
    lin_new = lin + g32 - sigma * p32
    quad = pow_new / lr + 2 * l2
    pre = torch.clamp(lin_new, -l1, l1) - lin_new
    p_new = torch.where(lin_new.abs() > l1, pre / quad,
                        torch.zeros_like(p32))
    return {"ParamOut": [p_new.to(p.dtype)], "SquaredAccumOut": [sq_new],
            "LinearAccumOut": [lin_new]}


@register_op("lamb")
def _lamb(ins, attrs, op):
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    m, v = _one(ins, "Moment1"), _one(ins, "Moment2")
    lr = _one(ins, "LearningRate").float()
    b1p = _one(ins, "Beta1Pow").float()
    b2p = _one(ins, "Beta2Pow").float()
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    g32, p32 = g.float(), p.float()
    m_new = b1 * m + (1 - b1) * g32
    v_new = b2 * v + (1 - b2) * g32 * g32
    mhat = m_new / (1 - b1p * b1)
    vhat = v_new / (1 - b2p * b2)
    r = mhat / (torch.sqrt(vhat) + eps) + wd * p32
    p_norm, r_norm = _norm(p32), _norm(r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    p_new = p32 - lr * trust * r
    return {"ParamOut": [p_new.to(p.dtype)], "Moment1Out": [m_new],
            "Moment2Out": [v_new], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}


@register_op("lars_momentum")
def _lars_momentum(ins, attrs, op):
    p, g, vel = _one(ins, "Param"), _one(ins, "Grad"), _one(ins, "Velocity")
    lr = _one(ins, "LearningRate").float()
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 1e-9)
    g32, p32 = g.float(), p.float()
    p_norm, g_norm = _norm(p32), _norm(g32)
    local_lr = torch.where((p_norm > 0) & (g_norm > 0),
                           coeff * p_norm / (g_norm + wd * p_norm + eps),
                           torch.ones_like(p_norm))
    v_new = mu * vel + lr * local_lr * (g32 + wd * p32)
    p_new = p32 - v_new
    return {"ParamOut": [p_new.to(p.dtype)], "VelocityOut": [v_new]}


@register_op("dpsgd")
def _dpsgd(ins, attrs, op):
    """Clip the gradient to norm ``clip``, add N(0, (sigma * clip)^2)
    noise (drawn on the host from the op's generator) and step."""
    p, g = _one(ins, "Param"), _one(ins, "Grad")
    lr = _one(ins, "LearningRate").float()
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    g32 = g.float()
    g_clip = g32 / torch.clamp_min(_norm(g32) / clip, 1.0)
    draw = torch.randn(tuple(g32.shape),
                       generator=_random.current_generator())
    noise = sigma * clip * draw.to(current_device())
    p_new = p.float() - lr * (g_clip + noise)
    return {"ParamOut": [p_new.to(p.dtype)]}


# -- fake quantization (ref operators/fake_quantize_op.cc) -------------------

@register_op("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(ins, attrs, op):
    from ..slim.quant import fake_quant_dequant_abs_max

    y, scale = fake_quant_dequant_abs_max(_one(ins, "X"),
                                          attrs.get("bit_length", 8))
    return {"Out": [y], "OutScale": [scale.reshape(1)]}


@register_op("fake_channel_wise_quantize_dequantize_abs_max")
def _fake_cw_qdq_abs_max(ins, attrs, op):
    from ..slim.quant import fake_channel_wise_quant_dequant_abs_max

    y, scale = fake_channel_wise_quant_dequant_abs_max(
        _one(ins, "X"), attrs.get("bit_length", 8),
        quant_axis=attrs.get("quant_axis", 0))
    return {"Out": [y], "OutScale": [scale]}


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def _fake_qdq_moving_avg(ins, attrs, op):
    """Activation quant-dequant against an EMA of the batch abs-max: the
    state ``InScale`` (0 before the first batch) becomes ``rate * state +
    (1 - rate) * amax``; ``q = round(clip(x / scale, -1, 1) * qmax) / qmax
    * scale``, as ``x + (q - x).detach()`` (straight-through).  The new
    scale is state, written back detached."""
    x = _one(ins, "X")
    state = _one(ins, "InScale").reshape(())
    rate = attrs.get("moving_rate", 0.9)
    qm = qmax(attrs.get("bit_length", 8))
    cur = x.detach().abs().amax().clamp_min(1e-8)
    scale = torch.where(state > 0, rate * state + (1 - rate) * cur, cur)
    q = (x / scale).clamp(-1.0, 1.0).mul(qm).round().div(qm).mul(scale)
    return {"Out": [x + (q - x).detach()], "OutScale": [scale.reshape(1)]}


@register_op("fake_quantize_dequantize_fixed_scale")
def _fake_qdq_fixed_scale(ins, attrs, op):
    """Frozen-scale quant-dequant: ``q = round(clip(x / scale, -1, 1) *
    qmax) / qmax * scale`` in x's dtype, in the straight-through form
    ``x + (q - x).detach()`` (forward q up to that sum's rounding,
    gradient the identity), as the JAX lowering computes it."""
    x = _one(ins, "X")
    qm = qmax(attrs.get("bit_length", 8))
    scale = attrs["scale"]
    q = (x / scale).clamp(-1.0, 1.0).mul(qm).round().div(qm).mul(scale)
    return {"Out": [x + (q - x).detach()]}


def _xo(fn, in_slot="X", out_slot="Out"):
    """X -> Out delegation rule."""

    def rule(ins, attrs, op):
        return {out_slot: [fn(_one(ins, in_slot))]}

    return rule


def _xyo(fn, a="X", b="Y", out="Out"):
    def rule(ins, attrs, op):
        return {out: [fn(_one(ins, a), _one(ins, b))]}

    return rule


# -- CTC + sequence distance (ref warpctc_op.cc, edit_distance_op.cc,
#    ctc_align_op.cu) ---------------------------------------------------------

@register_op("warpctc")
def _warpctc(ins, attrs, op):
    """Padded-mode warpctc: Logits (T,B,C), Label (B,L) + lengths."""
    loss = F.ctc_loss(_one(ins, "Logits"), _one(ins, "Label"),
                      _one(ins, "LogitsLength"), _one(ins, "LabelLength"),
                      blank=attrs.get("blank", 0), reduction="none",
                      norm_by_times=attrs.get("norm_by_times", False))
    return {"Loss": [loss[:, None]]}


@register_op("edit_distance")
def _edit_distance(ins, attrs, op):
    from ..ops import ctc as C

    d, n = C.edit_distance(_one(ins, "Hyps"), _one(ins, "Refs"),
                           _one(ins, "HypsLength"), _one(ins, "RefsLength"),
                           normalized=attrs.get("normalized", True))
    return {"Out": [d], "SequenceNum": [n]}


@register_op("ctc_align")
def _ctc_align(ins, attrs, op):
    from ..ops import ctc as C

    out, lens = C.ctc_greedy_decoder(
        _one(ins, "Input"), attrs.get("blank", 0), _one(ins, "InputLength"),
        padding_value=attrs.get("padding_value", 0))
    return {"Output": [out], "OutputLength": [lens]}


# -- conv / pool 3-D, depthwise, unfold, pad3d ---------------------------------

def _conv_nd(ins, attrs, fn, transpose=False):
    kwargs = dict(stride=tuple(attrs.get("strides", (1,))),
                  padding=tuple(attrs.get("paddings", (0,))),
                  dilation=tuple(attrs.get("dilations", (1,))),
                  groups=attrs.get("groups", 1))
    if transpose:
        kwargs["output_padding"] = tuple(
            attrs.get("output_padding", (0,)) or (0,))
    out = fn(_one(ins, "Input"), _one(ins, "Filter"), **kwargs)
    b = _one(ins, "Bias")
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * (out.dim() - 2))
    return {"Output": [out]}


@register_op("conv3d")
def _conv3d(ins, attrs, op):
    return _conv_nd(ins, attrs, F.conv3d)


@register_op("conv3d_transpose")
def _conv3d_transpose(ins, attrs, op):
    return _conv_nd(ins, attrs, F.conv3d_transpose, transpose=True)


def _depthwise(attrs, x):
    a = dict(attrs)
    a["groups"] = a.get("groups", 0) or x.shape[1]
    return a


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ins, attrs, op):
    return _conv_nd(ins, _depthwise(attrs, _one(ins, "Input")), F.conv2d)


@register_op("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ins, attrs, op):
    return _conv_nd(ins, _depthwise(attrs, _one(ins, "Input")),
                    F.conv2d_transpose, transpose=True)


@register_op("pool3d")
def _pool3d(ins, attrs, op):
    x = _one(ins, "X")
    ksize = tuple(attrs["ksize"])
    if attrs.get("global_pooling", False):
        ksize = tuple(x.shape[2:])
    kwargs = dict(stride=tuple(attrs.get("strides", ksize)),
                  padding=tuple(attrs.get("paddings", (0, 0, 0))))
    if attrs.get("pooling_type", "max") == "max":
        out = F.max_pool3d(x, ksize, **kwargs)
    else:
        out = F.avg_pool3d(x, ksize, exclusive=attrs.get("exclusive", True),
                           **kwargs)
    return {"Out": [out]}


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ins, attrs, op):
    from ..ops import misc as M

    out, idx = M.max_pool2d_with_index(
        _one(ins, "X"), tuple(attrs["ksize"]),
        tuple(attrs.get("strides", attrs["ksize"])),
        tuple(attrs.get("paddings", (0, 0))))
    return {"Out": [out], "Mask": [idx]}


def _patches(x, k, s, pads, d=(1, 1)):
    """(N, C*kh*kw, L) patches of ``x`` (C-major, as XLA's
    conv_general_dilated_patches orders them); ``pads`` per spatial dim."""
    x = pad_pairs(x, [(0, 0), (0, 0)] + list(pads))
    return tF.unfold(x, tuple(k), dilation=tuple(d), stride=tuple(s))


@register_op("unfold")
def _unfold(ins, attrs, op):
    """im2col (ref unfold_op.cc): (N,C,H,W) -> (N, C*kh*kw, L)."""
    p = list(attrs.get("paddings", (0, 0, 0, 0)))
    pads = ([(p[0], p[0]), (p[1], p[1])] if len(p) == 2
            else [(p[0], p[2]), (p[1], p[3])])
    return {"Y": [_patches(_one(ins, "X"), attrs["kernel_sizes"],
                           attrs.get("strides", (1, 1)), pads,
                           attrs.get("dilations", (1, 1)))]}


@register_op("im2sequence")
def _im2sequence(ins, attrs, op):
    """ref im2sequence_op.cc: patches flattened to (N*L, C*kh*kw) rows."""
    x = _one(ins, "X")
    kh, kw = attrs["kernels"]
    p = attrs.get("paddings", (0, 0, 0, 0))
    patches = _patches(x, (kh, kw), attrs.get("strides", (1, 1)),
                       [(p[0], p[2]), (p[1], p[3])])
    return {"Out": [patches.transpose(1, 2).reshape(
        -1, x.shape[1] * kh * kw)]}


@register_op("pad3d")
def _pad3d(ins, attrs, op):
    x = _one(ins, "X")
    p = [int(v) for v in attrs["paddings"]]  # (l, r, t, b, front, back)
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": [tF.pad(x, p, value=attrs.get("value", 0.0))]}
    return {"Out": [tF.pad(x, p, mode=mode)]}


@register_op("spectral_norm")
def _spectral_norm(ins, attrs, op):
    from ..ops import misc as M

    out, _ = M.spectral_norm(_one(ins, "Weight"), _one(ins, "U"),
                             power_iters=attrs.get("power_iters", 1),
                             epsilon=attrs.get("eps", 1e-12),
                             dim=attrs.get("dim", 0))
    return {"Out": [out]}


@register_op("affine_channel")
def _affine_channel(ins, attrs, op):
    x = _one(ins, "X")
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return {"Out": [x * _one(ins, "Scale").reshape(shape)
                    + _one(ins, "Bias").reshape(shape)]}


@register_op("conv_shift")
def _conv_shift(ins, attrs, op):
    """ref conv_shift_op.cc: circular correlation of X (B,M) with Y (B,N)."""
    x, y = _one(ins, "X"), _one(ins, "Y")
    m, n = x.shape[1], y.shape[1]
    ar_m = torch.arange(m, device=x.device)
    ar_n = torch.arange(n, device=x.device)
    idx = (ar_m[:, None] + ar_n[None, :] - (n - 1) // 2) % m
    return {"Out": [torch.einsum("bmn,bn->bm", x[:, idx], y)]}


# -- interpolate family (ref interpolate_op.cc / interpolate_v2_op.cc) -------

def _interp(mode):
    def rule(ins, attrs, op):
        x = _one(ins, "X")
        size = _one(ins, "OutSize")
        if size is not None:
            size = tuple(int(v) for v in size.reshape(-1).tolist())
        elif attrs.get("out_shape"):
            size = tuple(attrs["out_shape"])
        elif mode == "trilinear":
            size = (attrs["out_d"], attrs["out_h"], attrs["out_w"])
        elif mode == "linear":
            size = (attrs["out_w"],)
        else:
            size = (attrs["out_h"], attrs["out_w"])
        align = attrs.get("align_corners", True)
        if mode == "linear":  # NCW via the bilinear kernel on (N,C,1,W)
            out = F.interpolate(x[:, :, None, :], size=(1,) + size,
                                mode="bilinear", align_corners=align)[:, :, 0]
        else:
            out = F.interpolate(x, size=size, mode=mode, align_corners=align)
        return {"Out": [out]}

    return rule


for _name, _mode in [
        ("bilinear_interp", "bilinear"), ("bilinear_interp_v2", "bilinear"),
        ("nearest_interp", "nearest"), ("nearest_interp_v2", "nearest"),
        ("bicubic_interp", "bicubic"), ("bicubic_interp_v2", "bicubic"),
        ("trilinear_interp", "trilinear"),
        ("trilinear_interp_v2", "trilinear"),
        ("linear_interp", "linear"), ("linear_interp_v2", "linear")]:
    register_op(_name)(_interp(_mode))


# -- detection suite (ref operators/detection/) -------------------------------

@register_op("yolo_box")
def _yolo_box(ins, attrs, op):
    from ..ops import vision as V

    boxes, scores = V.yolo_box(
        _one(ins, "X"), _one(ins, "ImgSize"), attrs["anchors"],
        attrs["class_num"], attrs.get("conf_thresh", 0.01),
        attrs.get("downsample_ratio", 32),
        clip_bbox=attrs.get("clip_bbox", True),
        scale_x_y=attrs.get("scale_x_y", 1.0))
    return {"Boxes": [boxes], "Scores": [scores]}


@register_op("yolov3_loss")
def _yolov3_loss(ins, attrs, op):
    from ..ops import vision as V

    return {"Loss": [V.yolo_loss(
        _one(ins, "X"), _one(ins, "GTBox"), _one(ins, "GTLabel"),
        attrs["anchors"], attrs["anchor_mask"], attrs["class_num"],
        attrs.get("ignore_thresh", 0.7), attrs.get("downsample_ratio", 32),
        gt_score=_one(ins, "GTScore"),
        use_label_smooth=attrs.get("use_label_smooth", True),
        scale_x_y=attrs.get("scale_x_y", 1.0))]}


@register_op("multiclass_nms")
def _multiclass_nms(ins, attrs, op):
    from ..ops import vision as V

    bboxes = _one(ins, "BBoxes")   # (N, M, 4)
    scores = _one(ins, "Scores")   # (N, C, M)
    keep_top_k = attrs.get("keep_top_k", -1)
    if keep_top_k <= 0:
        keep_top_k = scores.shape[1] * scores.shape[2]
    nms_top_k = attrs.get("nms_top_k", -1)
    if nms_top_k <= 0:
        nms_top_k = scores.shape[2]
    dets, nums = zip(*[V.multiclass_nms(
        b, s, score_threshold=attrs.get("score_threshold", 0.05),
        nms_top_k=nms_top_k, keep_top_k=keep_top_k,
        nms_threshold=attrs.get("nms_threshold", 0.3),
        normalized=attrs.get("normalized", True),
        background_label=attrs.get("background_label", 0))
        for b, s in zip(bboxes, scores)])
    return {"Out": [torch.stack(dets)],
            "NmsRoisNum": [torch.stack([torch.as_tensor(n) for n in nums])]}


register_op("multiclass_nms2")(_multiclass_nms)


@register_op("density_prior_box")
def _density_prior_box(ins, attrs, op):
    from ..ops import vision as V

    x, img = _one(ins, "Input"), _one(ins, "Image")
    boxes, var = V.density_prior_box(
        (x.shape[2], x.shape[3]), (img.shape[2], img.shape[3]),
        attrs["densities"], attrs["fixed_sizes"],
        attrs.get("fixed_ratios", (1.0,)), clip=attrs.get("clip", False),
        steps=(attrs.get("step_w", 0.0), attrs.get("step_h", 0.0)),
        offset=attrs.get("offset", 0.5),
        variances=attrs.get("variances", (0.1, 0.1, 0.2, 0.2)),
        flatten_to_2d=attrs.get("flatten_to_2d", False))
    return {"Boxes": [boxes], "Variances": [var]}


def _deform_conv_rule(with_mask):
    def rule(ins, attrs, op):
        from ..ops import vision as V

        return {"Output": [V.deformable_conv(
            _one(ins, "Input"), _one(ins, "Offset"), _one(ins, "Filter"),
            mask=_one(ins, "Mask") if with_mask else None,
            stride=tuple(attrs.get("strides", (1, 1))),
            padding=tuple(attrs.get("paddings", (0, 0))),
            dilation=tuple(attrs.get("dilations", (1, 1))),
            groups=attrs.get("groups", 1),
            deformable_groups=attrs.get("deformable_groups", 1))]}

    return rule


register_op("deformable_conv")(_deform_conv_rule(True))
register_op("deformable_conv_v1")(_deform_conv_rule(False))


@register_op("psroi_pool")
def _psroi_pool(ins, attrs, op):
    from ..ops import vision as V

    return {"Out": [V.psroi_pool(
        _one(ins, "X"), _one(ins, "ROIs"), _one(ins, "RoisBatchId"),
        attrs["output_channels"], attrs["pooled_height"],
        attrs["pooled_width"], attrs.get("spatial_scale", 1.0))]}


@register_op("iou_similarity")
def _iou_similarity(ins, attrs, op):
    from ..ops import vision as V

    return {"Out": [V.iou_similarity(
        _one(ins, "X"), _one(ins, "Y"),
        box_normalized=attrs.get("box_normalized", True))]}


@register_op("box_clip")
def _box_clip(ins, attrs, op):
    from ..ops import vision as V

    return {"Output": [V.box_clip(_one(ins, "Input"), _one(ins, "ImInfo"))]}


@register_op("anchor_generator")
def _anchor_generator(ins, attrs, op):
    from ..ops import vision as V

    x = _one(ins, "Input")
    anchors, var = V.anchor_generator(
        (x.shape[2], x.shape[3]), attrs["anchor_sizes"],
        attrs["aspect_ratios"], attrs.get("stride", (16.0, 16.0)),
        variances=attrs.get("variances", (0.1, 0.1, 0.2, 0.2)),
        offset=attrs.get("offset", 0.5))
    return {"Anchors": [anchors], "Variances": [var]}


# -- beam search (ref beam_search_op.cc, beam_search_decode_op.cc,
#    gather_tree_op.cc): dense (batch, beam) layout ---------------------------

@register_op("beam_search")
def _beam_search(ins, attrs, op):
    """One dense beam step: scores (B, beam, V) cumulative log-probs ->
    top-beam (ids, parents, scores)."""
    scores = _one(ins, "Scores")
    B, K, V = scores.shape
    top, idx = torch.topk(scores.reshape(B, K * V), attrs["beam_size"])
    return {"SelectedIds": [(idx % V).to(torch.int32)],
            "ParentIdx": [(idx // V).to(torch.int32)],
            "SelectedScores": [top]}


@register_op("gather_tree")
def _gather_tree(ins, attrs, op):
    from ..nn.decode import gather_tree

    return {"Out": [gather_tree(_one(ins, "Ids"), _one(ins, "Parents"))]}


@register_op("beam_search_decode")
def _beam_search_decode(ins, attrs, op):
    """Backtrack full beams: Ids / ParentIdx (T, B, beam) -> time-major
    token paths + final scores."""
    from ..nn.decode import gather_tree

    ids, scores = _one(ins, "Ids"), _one(ins, "Scores")
    return {"SentenceIds": [gather_tree(ids, _one(ins, "ParentIdx"))],
            "SentenceScores": [scores[-1] if scores is not None
                               else torch.zeros(ids.shape[1:],
                                                device=ids.device)]}


# -- fake quantization (ref fake_quantize_op.cc) ------------------------------

def _abs_max(x):
    return torch.clamp_min(x.abs().amax(), 1e-8)


@register_op("fake_quantize_abs_max")
def _fake_quantize_abs_max(ins, attrs, op):
    x = _one(ins, "X")
    scale = _abs_max(x)
    q = torch.round(x / scale * qmax(attrs.get("bit_length", 8)))
    return {"Out": [q], "OutScale": [scale.reshape(1)]}


@register_op("moving_average_abs_max_scale")
def _moving_avg_scale(ins, attrs, op):
    x = _one(ins, "X")
    state = _one(ins, "InScale").reshape(())
    rate = attrs.get("moving_rate", 0.9)
    cur = _abs_max(x)
    scale = torch.where(state > 0, rate * state + (1 - rate) * cur, cur)
    return {"Out": [x], "OutScale": [scale.reshape(1)]}


@register_op("fake_quantize_range_abs_max")
def _fake_quantize_range_abs_max(ins, attrs, op):
    x = _one(ins, "X")
    scale = torch.maximum(_one(ins, "InScale").reshape(()), _abs_max(x))
    q = torch.round(torch.clamp(x / scale, -1, 1)
                    * qmax(attrs.get("bit_length", 8)))
    return {"Out": [q], "OutScale": [scale.reshape(1)]}


@register_op("fake_channel_wise_quantize_abs_max")
def _fake_cw_quantize_abs_max(ins, attrs, op):
    x = _one(ins, "X")
    axis = attrs.get("quant_axis", 0)
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = torch.clamp_min(x.abs().amax(dim=red), 1e-8)
    shape = [1] * x.dim()
    shape[axis] = -1
    return {"Out": [torch.round(x / scale.reshape(shape)
                                * qmax(attrs.get("bit_length", 8)))],
            "OutScale": [scale]}


# -- linalg / manipulation / loss tail: delegation to the op library ---------

def _axes(v):
    return tuple(v) if v else None


def _register_delegates():
    from .. import ops as T

    register_op("matmul_v2")(lambda ins, attrs, op: {"Out": [T.matmul(
        _one(ins, "X"), _one(ins, "Y"),
        transpose_x=attrs.get("trans_x", False),
        transpose_y=attrs.get("trans_y", False))]})
    register_op("bmm")(_xyo(T.bmm))
    register_op("dot")(_xyo(T.dot))
    register_op("cross")(lambda ins, attrs, op: {"Out": [T.cross(
        _one(ins, "X"), _one(ins, "Y"),
        axis=attrs.get("dim", attrs.get("axis", -1)))]})
    register_op("inverse")(_xo(T.inverse, "Input", "Output"))
    register_op("cholesky")(lambda ins, attrs, op: {"Out": [T.cholesky(
        _one(ins, "X"), upper=attrs.get("upper", False))]})
    register_op("kron")(_xyo(T.kron))
    register_op("addmm")(lambda ins, attrs, op: {"Out": [T.addmm(
        _one(ins, "Input"), _one(ins, "X"), _one(ins, "Y"),
        beta=attrs.get("Beta", 1.0), alpha=attrs.get("Alpha", 1.0))]})
    register_op("trace")(lambda ins, attrs, op: {"Out": [T.trace(
        _one(ins, "Input"), offset=attrs.get("offset", 0),
        axis1=attrs.get("axis1", 0), axis2=attrs.get("axis2", 1))]})
    register_op("dist")(lambda ins, attrs, op: {"Out": [T.dist(
        _one(ins, "X"), _one(ins, "Y"), p=attrs.get("p", 2.0))]})
    register_op("p_norm")(lambda ins, attrs, op: {"Out": [T.p_norm(
        _one(ins, "X"), p=attrs.get("porder", 2.0),
        axis=attrs.get("axis", -1), keepdim=attrs.get("keepdim", False))]})
    register_op("frobenius_norm")(lambda ins, attrs, op: {"Out": [
        T.frobenius_norm(_one(ins, "X"), axis=_axes(attrs.get("dim")),
                         keepdim=attrs.get("keep_dim", False))]})
    register_op("logsumexp")(lambda ins, attrs, op: {"Out": [T.logsumexp(
        _one(ins, "X"), axis=_axes(attrs.get("axis")),
        keepdim=attrs.get("keepdim", False))]})
    register_op("l1_norm")(_xo(T.l1_norm))
    register_op("flip")(lambda ins, attrs, op: {"Out": [T.flip(
        _one(ins, "X"), attrs["axis"])]})
    register_op("reverse")(lambda ins, attrs, op: {"Out": [T.flip(
        _one(ins, "X"), attrs["axis"])]})
    register_op("roll")(lambda ins, attrs, op: {"Out": [T.roll(
        _one(ins, "X"), attrs["shifts"],
        attrs.get("axis", attrs.get("dims", None)))]})
    register_op("tril_triu")(lambda ins, attrs, op: {"Out": [
        (T.tril if attrs.get("lower", True) else T.triu)(
            _one(ins, "X"), attrs.get("diagonal", 0))]})
    register_op("index_select")(lambda ins, attrs, op: {"Out": [
        T.index_select(_one(ins, "X"), _one(ins, "Index"),
                       axis=attrs.get("dim", 0))]})
    register_op("index_sample")(_xyo(T.index_sample, "X", "Index"))
    register_op("masked_select")(lambda ins, attrs, op: {"Y": [
        T.masked_select(_one(ins, "X"), _one(ins, "Mask"))]})
    register_op("meshgrid")(lambda ins, attrs, op: {"Out": list(
        T.meshgrid(*ins["X"]))})
    register_op("unbind")(lambda ins, attrs, op: {"Out": list(T.unbind(
        _one(ins, "X"), attrs.get("axis", 0)))})
    register_op("unstack")(lambda ins, attrs, op: {"Y": list(T.unstack(
        _one(ins, "X"), attrs.get("axis", 0)))})
    register_op("strided_slice")(lambda ins, attrs, op: {"Out": [
        T.strided_slice(_one(ins, "Input"), attrs["axes"], attrs["starts"],
                        attrs["ends"], attrs.get(
                            "strides", [1] * len(attrs["axes"])))]})
    for name in ("crop", "crop_tensor"):
        register_op(name)(lambda ins, attrs, op: {"Out": [T.crop(
            _one(ins, "X"), shape=attrs.get("shape"),
            offsets=attrs.get("offsets"))]})
    register_op("squeeze")(lambda ins, attrs, op: {"Out": [T.squeeze(
        _one(ins, "X"), tuple(attrs.get("axes", ())) or None)]})
    register_op("unsqueeze")(lambda ins, attrs, op: {"Out": [T.unsqueeze(
        _one(ins, "X"), list(attrs["axes"]))]})
    register_op("pad_constant_like")(lambda ins, attrs, op: {"Out": [
        T.pad_constant_like(_one(ins, "X"), _one(ins, "Y"),
                            attrs.get("pad_value", 0.0))]})
    register_op("scatter_nd_add")(lambda ins, attrs, op: {"Out": [
        T.scatter_nd_add(_one(ins, "X"), _one(ins, "Index"),
                         _one(ins, "Updates"))]})
    register_op("minus")(_xyo(T.minus))
    register_op("cvm")(lambda ins, attrs, op: {"Y": [T.cvm(
        _one(ins, "X"), use_cvm=attrs.get("use_cvm", True))]})
    register_op("data_norm")(_data_norm)
    register_op("cos_sim_v2")(_xyo(T.cos_sim))

    def _top_k_v2(ins, attrs, op):
        v, i = T.topk(_one(ins, "X"), attrs.get("k", 1),
                      axis=attrs.get("axis", -1),
                      largest=attrs.get("largest", True))
        return {"Out": [v], "Indices": [i.to(torch.int32)]}

    register_op("top_k_v2")(_top_k_v2)


def _data_norm(ins, attrs, op):
    from .. import ops as T

    y, size, total, sq = T.data_norm(
        _one(ins, "X"), _one(ins, "BatchSize"), _one(ins, "BatchSum"),
        _one(ins, "BatchSquareSum"), epsilon=attrs.get("epsilon", 1e-4))
    return {"Y": [y], "BatchSizeOut": [size], "BatchSumOut": [total],
            "BatchSquareSumOut": [sq]}


_register_delegates()


@register_op("squared_l2_distance")
def _squared_l2_distance(ins, attrs, op):
    d = _one(ins, "X") - _one(ins, "Y")
    return {"Out": [(d * d).sum(dim=tuple(range(1, d.dim())), keepdim=True)],
            "sub_result": [d]}


@register_op("clip_by_norm")
def _clip_by_norm(ins, attrs, op):
    x = _one(ins, "X")
    n = torch.clamp_min(_norm(x), 1e-12)
    return {"Out": [x * torch.clamp_max(attrs["max_norm"] / n, 1.0)]}


@register_op("expand")
def _expand(ins, attrs, op):
    return {"Out": [torch.tile(_one(ins, "X"),
                               tuple(attrs["expand_times"]))]}


@register_op("expand_as")
def _expand_as(ins, attrs, op):
    return {"Out": [_one(ins, "X").expand(ins["target_tensor"][0].shape)]}


@register_op("expand_as_v2")
def _expand_as_v2(ins, attrs, op):
    shape = (tuple(attrs["target_shape"]) if attrs.get("target_shape")
             else ins["Y"][0].shape)
    return {"Out": [_one(ins, "X").expand(shape)]}


@register_op("flatten")
def _flatten(ins, attrs, op):
    x = _one(ins, "X")
    ax = attrs.get("axis", 1)
    return {"Out": [x.reshape(int(np.prod(x.shape[:ax])) if ax else 1, -1)]}


@register_op("shard_index")
def _shard_index(ins, attrs, op):
    x = _one(ins, "X")
    # ref shard_index_op.h: shard_size = ceil(index_num / nshards)
    size = -(-attrs["index_num"] // attrs["nshards"])
    return {"Out": [torch.where(
        torch.div(x, size, rounding_mode="floor") == attrs["shard_id"],
        x % size, torch.full_like(x, attrs.get("ignore_value", -1)))]}


@register_op("argsort")
def _argsort(ins, attrs, op):
    x = _one(ins, "X")
    ax = attrs.get("axis", -1)
    vals, idx = torch.sort(x, dim=ax, stable=True)
    if attrs.get("descending", False):
        vals, idx = vals.flip(ax), idx.flip(ax)
    return {"Out": [vals], "Indices": [_int32(idx)]}


@register_op("lookup_table")
def _lookup_table(ins, attrs, op):
    """v1 ids carry a trailing length-1 dim; otherwise lookup_table_v2."""
    return {"Out": [lookup(ins["W"][0], _one(ins, "Ids").squeeze(-1),
                           attrs)]}


@register_op("size")
def _size(ins, attrs, op):
    x = _one(ins, "Input")
    return {"Out": [_int32(torch.tensor(x.numel(), device=x.device))]}


register_op("isfinite_v2")(_xo(torch.isfinite))
register_op("isinf_v2")(_xo(torch.isinf))
register_op("isnan_v2")(_xo(torch.isnan))


@register_op("isfinite")
def _isfinite(ins, attrs, op):
    return {"Out": [torch.isfinite(_one(ins, "X")).all()[None]]}


@register_op("linspace")
def _linspace(ins, attrs, op):
    """ref linspace_op.cc; ``num`` from the attr or the ``Num`` input."""
    num = attrs.get("num")
    if num is None:
        num = int(_one(ins, "Num").reshape(()).item())
    start = _one(ins, "Start")
    return {"Out": [torch.linspace(
        float(start.reshape(())), float(_one(ins, "Stop").reshape(())),
        int(num), device=start.device,
        dtype=_dtype_mod.convert_dtype(attrs.get("dtype", "float32")))]}


@register_op("one_hot")
def _one_hot(ins, attrs, op):
    return {"Out": [one_hot(_one(ins, "X").squeeze(-1), attrs["depth"])]}


def _partial_slice(xs, s, ln):
    # ref partial_sum_op.cc / partial_concat_op.cc: length -1 runs to the
    # end of the row
    end = xs[0].shape[1] if ln in (-1, None) else s + ln
    return [x[:, s:end] for x in xs]


@register_op("partial_sum")
def _partial_sum(ins, attrs, op):
    return {"Out": [sum(_partial_slice(ins["X"], attrs.get("start_index", 0),
                                       attrs.get("length", -1)))]}


@register_op("partial_concat")
def _partial_concat(ins, attrs, op):
    return {"Out": [torch.cat(_partial_slice(
        ins["X"], attrs.get("start_index", 0), attrs.get("length", -1)),
        dim=1)]}


@register_op("batch_fc")
def _batch_fc(ins, attrs, op):
    return {"Out": [torch.einsum("bsi,bio->bso", _one(ins, "Input"),
                                 _one(ins, "W")) + _one(ins, "Bias")]}


@register_op("shuffle_batch")
def _shuffle_batch(ins, attrs, op):
    x = _one(ins, "X")
    perm = torch.randperm(x.shape[0], generator=_random.current_generator())
    perm = perm.to(x.device)
    return {"Out": [x[perm]], "ShuffleIdx": [_int32(perm)]}


for _name in ("lod_reset", "get_tensor_from_selected_rows",
              "merge_selected_rows"):
    register_op(_name)(lambda ins, attrs, op: {"Out": [_one(ins, "X")]})


@register_op("coalesce_tensor")
def _coalesce_tensor(ins, attrs, op):
    """ref coalesce_tensor_op.cc: the fused buffer is a concatenation and
    the outputs are views of it."""
    xs = ins["Input"]
    flat = torch.cat([x.reshape(-1) for x in xs])
    outs, offset = [], 0
    for x in xs:
        n = x.numel()
        outs.append(flat[offset:offset + n].reshape(x.shape))
        offset += n
    return {"Output": outs, "FusedOutput": [flat]}


# -- losses -------------------------------------------------------------------

@register_op("bce_loss")
def _bce_loss(ins, attrs, op):
    return {"Out": [F.binary_cross_entropy(
        _one(ins, "X"), _one(ins, "Label"), reduction="none")]}


@register_op("nll_loss")
def _nll_loss(ins, attrs, op):
    x = _one(ins, "X")
    return {"Out": [F.nll_loss(x, _one(ins, "Label"),
                               weight=_one(ins, "Weight"),
                               ignore_index=attrs.get("ignore_index", -100),
                               reduction=attrs.get("reduction", "mean"))],
            "Total_weight": [torch.tensor(float(x.shape[0]),
                                          device=x.device)]}


@register_op("hinge_loss")
def _hinge_loss(ins, attrs, op):
    return {"Loss": [F.hinge_loss(_one(ins, "Logits"), _one(ins, "Labels"))]}


@register_op("margin_rank_loss")
def _margin_rank_loss(ins, attrs, op):
    return {"Out": [F.margin_ranking_loss(
        _one(ins, "X1"), _one(ins, "X2"), _one(ins, "Label"),
        margin=attrs.get("margin", 0.0), reduction="none")]}


@register_op("bpr_loss")
def _bpr_loss(ins, attrs, op):
    """ref bpr_loss_op.cc: -mean(log(sigmoid(pos - negs)))."""
    x = _one(ins, "X")
    B, C = x.shape
    label = _one(ins, "Label").reshape(B).long()
    pos = torch.gather(x, 1, label[:, None])
    mask = torch.ones((B, C), device=x.device)
    mask[torch.arange(B, device=x.device), label] = 0.0
    loss = -(tF.logsigmoid(pos - x) * mask).sum(1, keepdim=True) \
        / max(C - 1, 1)
    return {"Out": [loss]}


@register_op("center_loss")
def _center_loss(ins, attrs, op):
    """ref center_loss_op.cc: 0.5*||x - center_label||^2; the centers move
    by CenterUpdateRate when ``need_update`` is set."""
    x = _one(ins, "X")
    label = _one(ins, "Label").reshape(-1).long()
    centers = _one(ins, "Centers")
    rate = _one(ins, "CenterUpdateRate")
    diff = x - centers[label]
    loss = 0.5 * (diff * diff).sum(1, keepdim=True)
    if attrs.get("need_update", True) and rate is not None:
        counts = torch.zeros(centers.shape[0], device=x.device).index_add(
            0, label, torch.ones_like(label, dtype=torch.float32))
        delta = torch.zeros_like(centers).index_add(0, label, diff)
        centers = centers + rate.reshape(()) * delta / (counts[:, None] + 1.0)
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [centers]}


# -- activation tail (ref operators/activation_op.cc) -------------------------

def _act(fn):
    def rule(ins, attrs, op):
        return {"Out": [fn(_one(ins, "X"), attrs)]}

    return rule


def _zero_where(keep, x):
    return torch.where(keep, x, torch.zeros_like(x))


@register_op("maxout")
def _maxout(ins, attrs, op):
    x, g = _one(ins, "X"), attrs["groups"]
    return {"Out": [x.reshape(x.shape[0], x.shape[1] // g, g,
                              *x.shape[2:]).amax(dim=2)]}


register_op("soft_relu")(_act(lambda x, a: torch.log1p(torch.exp(
    torch.clamp(x, -a.get("threshold", 40.0), a.get("threshold", 40.0))))))
register_op("brelu")(_act(lambda x, a: torch.clamp(
    x, a.get("t_min", 0.0), a.get("t_max", 24.0))))
register_op("stanh")(_act(lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 0.67) * x)))
register_op("thresholded_relu")(_act(lambda x, a: _zero_where(
    x > a.get("threshold", 1.0), x)))
register_op("hard_shrink")(_act(lambda x, a: _zero_where(
    x.abs() > a.get("threshold", 0.5), x)))
register_op("softshrink")(_act(lambda x, a: torch.where(
    x > a.get("lambda", 0.5), x - a.get("lambda", 0.5),
    torch.where(x < -a.get("lambda", 0.5), x + a.get("lambda", 0.5),
                torch.zeros_like(x)))))
register_op("tanh_shrink")(_act(lambda x, a: x - torch.tanh(x)))
register_op("hard_tanh")(_act(lambda x, a: torch.clamp(
    x, a.get("t_min", -1.0), a.get("t_max", 1.0))))


# -- metrics (ref operators/metrics/): mean_iou, auc --------------------------

def _bincount(idx, n, weights=None):
    """Counts of ``idx`` in ``[0, n)`` (indices outside dropped)."""
    keep = (idx >= 0) & (idx < n)
    w = torch.ones_like(idx, dtype=torch.float32) if weights is None \
        else weights.float()
    return torch.zeros(n, device=idx.device).index_add(
        0, torch.where(keep, idx, torch.zeros_like(idx)),
        torch.where(keep, w, torch.zeros_like(w)))


@register_op("mean_iou")
def _mean_iou(ins, attrs, op):
    """ref mean_iou_op.h: mean of per-class intersection / union."""
    pred = _one(ins, "Predictions").reshape(-1).long()
    label = _one(ins, "Labels").reshape(-1).long()
    n = attrs["num_classes"]
    inter = _bincount(torch.where(pred == label, pred,
                                  torch.full_like(pred, n)), n)
    pred_cnt, label_cnt = _bincount(pred, n), _bincount(label, n)
    union = pred_cnt + label_cnt - inter
    iou = torch.where(union > 0, inter / torch.clamp_min(union, 1.0),
                      torch.zeros_like(union))
    mean = iou.sum() / torch.clamp_min((union > 0).float().sum(), 1.0)
    return {"OutMeanIou": [mean], "OutWrong": [pred_cnt - inter],
            "OutCorrect": [inter]}


@register_op("auc")
def _auc(ins, attrs, op):
    """ref auc_op.h: batch AUC from the positive-class score histogram."""
    probs = _one(ins, "Predict")[:, 1]
    label = _one(ins, "Label").reshape(-1).float()
    bins = attrs.get("num_thresholds", 4095) + 1
    idx = torch.clamp((probs * (bins - 1)).to(torch.int32), 0,
                      bins - 1).long()
    pos = _bincount(idx, bins, label)
    neg = _bincount(idx, bins, 1.0 - label)
    # from the high-score end: at threshold bin b, tp = positives above
    tp = torch.cumsum(pos.flip(0), 0).flip(0)
    fp = torch.cumsum(neg.flip(0), 0).flip(0)
    auc = ((fp[:-1] - fp[1:]) * (tp[:-1] + tp[1:]) / 2.0).sum()
    auc = torch.where((tp[0] > 0) & (fp[0] > 0),
                      auc / torch.clamp_min(tp[0] * fp[0], 1.0),
                      torch.zeros_like(auc))
    return {"AUC": [auc], "StatPosOut": [pos], "StatNegOut": [neg]}


# -- padded sequence statics + RNN units + creation ---------------------------

@register_op("sequence_pad")
def _sequence_pad(ins, attrs, op):
    from ..ops import sequence as S

    out, lens = S.sequence_pad(_one(ins, "X"), _one(ins, "SegmentIds"),
                               attrs["batch"], attrs["maxlen"],
                               pad_value=attrs.get("pad_value", 0.0))
    return {"Out": [out], "Length": [lens]}


@register_op("sequence_unpad")
def _sequence_unpad(ins, attrs, op):
    from ..ops import sequence as S

    vals, seg, mask = S.sequence_unpad(_one(ins, "X"), _one(ins, "Length"))
    return {"Out": [vals], "SegmentIds": [seg], "Mask": [mask]}


@register_op("sequence_expand_padded")
def _sequence_expand_padded(ins, attrs, op):
    from ..ops import sequence as S

    out, _ = S.sequence_expand(_one(ins, "X"), _one(ins, "Length"),
                               _one(ins, "RefLength"), attrs["maxlen"])
    return {"Out": [out]}


@register_op("sequence_slice_padded")
def _sequence_slice_padded(ins, attrs, op):
    from ..ops import sequence as S

    y, lens = S.sequence_slice(_one(ins, "X"), _one(ins, "Length"),
                               _one(ins, "Offset"), _one(ins, "SliceLength"))
    return {"Out": [y], "OutLength": [lens]}


@register_op("sequence_concat_padded")
def _sequence_concat_padded(ins, attrs, op):
    """Concatenate two padded sequence batches along time, left-packing the
    valid steps (ref sequence_concat_op.cc at LoD level 0)."""
    x, y = ins["X"]
    lx, ly = ins["Length"]
    B, Tx, Ty = x.shape[0], x.shape[1], y.shape[1]
    t_idx = torch.arange(Tx + Ty, device=x.device)[None, :]
    lx2, out_len = lx.long()[:, None], lx + ly
    tail = (1,) * (x.dim() - 2)

    def take(v, idx):
        idx = idx.reshape(B, -1, *tail).expand(B, -1, *v.shape[2:])
        return torch.gather(v, 1, idx)

    gx = take(x, torch.clamp(t_idx, 0, Tx - 1).expand(B, -1))
    gy = take(y, torch.clamp(t_idx - lx2, 0, Ty - 1))
    from_x = (t_idx < lx2).reshape(B, -1, *tail)
    valid = (t_idx < out_len.long()[:, None]).reshape(B, -1, *tail)
    out = torch.where(from_x, gx, gy)
    return {"Out": [torch.where(valid, out, torch.zeros_like(out))],
            "OutLength": [out_len]}


for _ref, _padded in [("sequence_concat", _sequence_concat_padded),
                      ("sequence_expand", _sequence_expand_padded),
                      ("sequence_slice", _sequence_slice_padded)]:
    register_op(_ref)(_padded)


@register_op("gru_unit")
def _gru_unit(ins, attrs, op):
    """ref gru_unit_op.h: one GRU step from pre-projected input gates."""
    gates_x, h_prev = _one(ins, "Input"), _one(ins, "HiddenPrev")
    w, b = _one(ins, "Weight"), _one(ins, "Bias")
    D = h_prev.shape[1]
    g = gates_x + b if b is not None else gates_x
    uh = h_prev @ w[:, :2 * D]
    r = torch.sigmoid(g[:, :D] + uh[:, :D])
    z = torch.sigmoid(g[:, D:2 * D] + uh[:, D:])
    c = torch.tanh(g[:, 2 * D:] + (r * h_prev) @ w[:, 2 * D:])
    return {"Hidden": [z * h_prev + (1 - z) * c],
            "ResetHiddenPrev": [r * h_prev], "Gate": [g]}


@register_op("lstm_unit")
def _lstm_unit(ins, attrs, op):
    """ref lstm_unit_op.h: one LSTM step from the fused gate
    pre-activations (i, f, c~, o)."""
    gates, c_prev = _one(ins, "X"), _one(ins, "C_prev")
    D = c_prev.shape[1]
    i = torch.sigmoid(gates[:, :D])
    f = torch.sigmoid(gates[:, D:2 * D] + attrs.get("forget_bias", 0.0))
    g = torch.tanh(gates[:, 2 * D:3 * D])
    o = torch.sigmoid(gates[:, 3 * D:])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register_op("fill_any_like")
def _fill_any_like(ins, attrs, op):
    x = _one(ins, "X")
    dtype = attrs.get("dtype", -1)
    dt = x.dtype if dtype in (-1, None) else _dtype_mod.convert_dtype(dtype)
    return {"Out": [torch.full(x.shape, attrs.get("value", 0.0), dtype=dt,
                               device=x.device)]}


@register_op("is_empty")
def _is_empty(ins, attrs, op):
    x = _one(ins, "X")
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}


@register_op("smooth_l1")
def _smooth_l1(ins, attrs, op):
    """ref smooth_l1_loss_op.cc (sigma-weighted variant)."""
    x, y = _one(ins, "X"), _one(ins, "Y")
    inw, outw = _one(ins, "InsideWeight"), _one(ins, "OutsideWeight")
    d = (x - y) * inw if inw is not None else x - y
    s2 = attrs.get("sigma", 1.0) ** 2
    ad = d.abs()
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if outw is not None:
        loss = loss * outw
    return {"Out": [loss.sum(dim=tuple(range(1, loss.dim())), keepdim=True)],
            "Diff": [d]}


@register_op("teacher_student_sigmoid_loss")
def _teacher_student_sigmoid_loss(ins, attrs, op):
    """ref teacher_student_sigmoid_loss_op.cc (distillation CTR loss)."""
    x = _one(ins, "X").reshape(-1)
    label = _one(ins, "Label").reshape(-1)
    z = torch.clamp(x, attrs.get("soft_max_lower_bound", -15.0),
                    attrs.get("soft_max_up_bound", 15.0))
    soft_plus = torch.log1p(torch.exp(-z.abs()))
    ce = torch.clamp_min(z, 0.0) - z * (label > 0.5).to(z.dtype) + soft_plus
    soft = torch.clamp_min(z, 0.0) - z * label + soft_plus
    loss = torch.where((label > 0.0) & (label < 1.0), ce + soft, ce)
    return {"Y": [loss[:, None]]}


def _bool_reduce(fn):
    def rule(ins, attrs, op):
        return _reduce(fn)({"X": [_one(ins, "X").bool()]}, attrs, op)
    return rule


def _all(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = x.all(dim=d, keepdim=keepdim)
    return x


def _any(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = x.any(dim=d, keepdim=keepdim)
    return x


register_op("reduce_all")(_bool_reduce(_all))
register_op("reduce_any")(_bool_reduce(_any))


@register_op("diag")
def _diag(ins, attrs, op):
    """ref diag_op.cc: vector -> diagonal matrix."""
    return {"Out": [torch.diagflat(_one(ins, "Diagonal"))]}
