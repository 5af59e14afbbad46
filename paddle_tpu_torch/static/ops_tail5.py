"""Static-op long tail, batch 5 (counterpart of
paddle_tpu/static/ops_tail5.py): v1 aliases and the numeric tail —
``allreduce`` / ``broadcast``, ``allclose``, the random ops ``bernoulli``
/ ``randint`` / ``randperm`` / ``sampling_id`` / ``seed`` /
``*_batch_size_like`` / ``random_crop``, ``eye`` / ``fill`` /
``diag_v2`` / ``diag_embed`` / ``histogram``, losses and encodings, the
dequantize family, ModelAverage's ``average_accumulates``,
``precision_recall``, ``spp``, ``polygon_box_transform``,
``hierarchical_sigmoid``, the SSD assignment trio ``bipartite_match`` /
``target_assign`` / ``mine_hard_examples``, ``fc`` and ``assert``.

Dynamic-size outputs keep batch 4's padded + valid-count contract.  The
random ops draw from the Executor's per-op CPU generator (their draws
repeat for a fixed seed, but cannot match ``jax.random``).
``bipartite_match``'s greedy loop runs one step a gt row with no host
read.  ``assert`` reads its condition on the host as it runs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import dtype as _dtype_mod
from ..core import random as _random
from . import ops_tail2 as _ops_tail2  # noqa: F401 — merge_lod_tensor
from .ops import _one, current_device
from .registry import get_lowering, register_op


def _gen():
    return _random.current_generator()


register_op("merge_lod_tensor_infer")(get_lowering("merge_lod_tensor"))


@register_op("allreduce")
def _allreduce(ins, attrs, op):
    """ref collective/allreduce_op.h: reduce_type 0..3 = sum/prod/max/min."""
    red = {0: "c_allreduce_sum", 1: "c_allreduce_prod",
           2: "c_allreduce_max", 3: "c_allreduce_min"}[
        int(attrs.get("reduce_type", 0))]
    return get_lowering(red)(ins, attrs, op)


@register_op("broadcast")
def _broadcast(ins, attrs, op):
    return get_lowering("c_broadcast")(ins, attrs, op)


# =========================================================================
# easy numeric tail
# =========================================================================

@register_op("allclose")
def _allclose(ins, attrs, op):
    x, y = _one(ins, "Input"), _one(ins, "Other")
    close = (x - y).abs() <= float(attrs.get("atol", 1e-8)) \
        + float(attrs.get("rtol", 1e-5)) * y.abs()
    if attrs.get("equal_nan", False):
        close = close | (torch.isnan(x) & torch.isnan(y))
    return {"Out": [close.all()]}


@register_op("bernoulli")
def _bernoulli(ins, attrs, op):
    x = _one(ins, "X")
    u = torch.rand(tuple(x.shape), generator=_gen()).to(x.device)
    return {"Out": [(u < x).to(x.dtype)]}


@register_op("eye")
def _eye(ins, attrs, op):
    rows = int(attrs["num_rows"])
    cols = int(attrs.get("num_columns", -1))
    return {"Out": [torch.eye(rows, cols if cols > 0 else rows,
                              dtype=_dtype_mod.convert_dtype(
                                  attrs.get("dtype", "float32")),
                              device=current_device())]}


@register_op("fill")
def _fill(ins, attrs, op):
    """ref fill_op.cc: a tensor from an attr value list + shape."""
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "float32"))
    vals = torch.as_tensor(np.asarray(attrs["value"], np.float64))
    return {"Out": [vals.to(dtype=dtype, device=current_device())
                    .reshape(tuple(attrs["shape"]))]}


@register_op("fill_zeros_like2")
def _fill_zeros_like2(ins, attrs, op):
    return {"Out": [torch.zeros_like(_one(ins, "X"))]}


def _diag_rc(n, offset, device):
    i = torch.arange(n, device=device)
    return (i, i + offset) if offset >= 0 else (i - offset, i)


@register_op("diag_v2")
def _diag_v2(ins, attrs, op):
    x = _one(ins, "X")
    offset = int(attrs.get("offset", 0))
    if x.ndim == 1:
        n = x.shape[0] + abs(offset)
        out = torch.full((n, n), attrs.get("padding_value", 0),
                         dtype=x.dtype, device=x.device)
        r, c = _diag_rc(x.shape[0], offset, x.device)
        out[r, c] = x
        return {"Out": [out]}
    return {"Out": [torch.diagonal(x, offset)]}


@register_op("diag_embed")
def _diag_embed(ins, attrs, op):
    x = _one(ins, "X")
    offset = int(attrs.get("offset", 0))
    n = x.shape[-1] + abs(offset)
    r, c = _diag_rc(x.shape[-1], offset, x.device)
    out = torch.zeros(tuple(x.shape[:-1]) + (n, n), dtype=x.dtype,
                      device=x.device)
    out[..., r, c] = x
    nd = out.ndim
    d1 = int(attrs.get("dim1", -2)) % nd
    d2 = int(attrs.get("dim2", -1)) % nd
    if (d1, d2) != (nd - 2, nd - 1):
        out = torch.movedim(out, (nd - 2, nd - 1), (d1, d2))
    return {"Out": [out]}


@register_op("histogram")
def _histogram(ins, attrs, op):
    x = _one(ins, "X").reshape(-1).float()
    bins = int(attrs.get("bins", 100))
    lo, hi = float(attrs.get("min", 0)), float(attrs.get("max", 0))
    if lo == hi == 0:
        lo_t, hi_t = x.min(), x.max()
        hi_t = torch.where(hi_t == lo_t, lo_t + 1, hi_t)
    else:
        lo_t = torch.tensor(lo, device=x.device)
        hi_t = torch.tensor(hi, device=x.device)
    idx = ((x - lo_t) / (hi_t - lo_t) * bins).to(torch.int32).clamp(
        0, bins - 1).long()
    inside = (x >= lo_t) & (x <= hi_t)
    counts = torch.zeros((bins,), dtype=torch.int64, device=x.device)
    counts.index_add_(0, idx[inside], torch.ones_like(idx[inside]))
    return {"Out": [counts]}


@register_op("randint")
def _randint(ins, attrs, op):
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "int64"))
    out = torch.randint(int(attrs.get("low", 0)), int(attrs.get("high", 100)),
                        tuple(attrs["shape"]), generator=_gen())
    return {"Out": [out.to(device=current_device(), dtype=dtype)]}


@register_op("randperm")
def _randperm(ins, attrs, op):
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "int64"))
    out = torch.randperm(int(attrs["n"]), generator=_gen())
    return {"Out": [out.to(device=current_device(), dtype=dtype)]}


@register_op("sampling_id")
def _sampling_id(ins, attrs, op):
    """ref sampling_id_op.h: per row, the inverse-CDF sample over the
    probability vector (a uniform draw in [min, max))."""
    x = _one(ins, "X")
    lo, hi = float(attrs.get("min", 0.0)), float(attrs.get("max", 1.0))
    u = (lo + (hi - lo) * torch.rand((x.shape[0], 1), generator=_gen())
         ).to(device=x.device, dtype=x.dtype)
    idx = (torch.cumsum(x, dim=1) < u).sum(1)  # first j with cdf >= u
    return {"Out": [idx.clamp_max(x.shape[1] - 1)]}


@register_op("seed")
def _seed(ins, attrs, op):
    """ref seed_op.cc: the dropout seed scalar (attr seed, or a fresh
    draw when 0)."""
    s = int(attrs.get("seed", 0))
    if s == 0:
        s = int(torch.randint(1, 2 ** 31 - 1, (1,), generator=_gen()))
    return {"Out": [torch.tensor([s], dtype=torch.int32,
                                 device=current_device())]}


@register_op("modified_huber_loss")
def _modified_huber_loss(ins, attrs, op):
    """ref modified_huber_loss_op.h: z = x*(2y-1); loss = -4z (z<-1),
    (1-z)^2 (z<1), 0 otherwise."""
    x, y = _one(ins, "X"), _one(ins, "Y")
    z = x * (2.0 * y - 1.0)
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, (1.0 - z) ** 2,
                                   torch.zeros_like(z)))
    return {"IntermediateVal": [z], "Out": [loss]}


@register_op("add_position_encoding")
def _add_position_encoding(ins, attrs, op):
    """ref add_position_encoding_op.h: alpha*x + beta*PE with the half-sin
    / half-cos layout (frequency index k/(half-1))."""
    x = _one(ins, "X")
    _B, T, D = x.shape
    half = D // 2
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    if half > 1:
        denom = torch.pow(torch.tensor(10000.0, device=x.device),
                          torch.arange(half, dtype=torch.float32,
                                       device=x.device) / max(half - 1, 1))
    else:
        denom = torch.full((1,), 10000.0, device=x.device)
    val = pos / denom[None, :]
    pe = torch.cat([torch.sin(val), torch.cos(val)], dim=1)
    if 2 * half < D:  # odd size: the last channel has no PE pair
        pe = tF.pad(pe, (0, 1))
    return {"Out": [float(attrs.get("alpha", 1.0)) * x
                    + float(attrs.get("beta", 1.0)) * pe[None].to(x.dtype)]}


@register_op("amp_check_finite_and_scale")
def _amp_check_finite_and_scale(ins, attrs, op):
    """ref amp/check_finite_and_scale (v1 name): Out_i = X_i * Scale;
    FoundInfinite = any nonfinite value across the inputs."""
    scale = _one(ins, "Scale").reshape(())
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for x in ins.get("X", []):
        found = found | ~torch.isfinite(x).all()
        outs.append(x * scale.to(x.dtype))
    return {"Out": outs, "FoundInfinite": [found.reshape(1)]}


@register_op("fake_init")
def _fake_init(ins, attrs, op):
    return {"Out": [torch.zeros(tuple(attrs["shape"]),
                                dtype=_dtype_mod.convert_dtype(
                                    attrs.get("dtype", "float32")),
                                device=current_device())]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ins, attrs, op):
    """ref bilinear_tensor_product_op.h: out[b,k] = x[b] W[k] y[b]^T."""
    out = torch.einsum("bi,kij,bj->bk", _one(ins, "X"), _one(ins, "Weight"),
                       _one(ins, "Y"))
    b = _one(ins, "Bias")
    if b is not None:
        out = out + b.reshape(1, -1)
    return {"Out": [out]}


def _batch_size_like_shape(ins, attrs):
    shape = list(attrs["shape"])
    shape[int(attrs.get("output_dim_idx", 0))] = \
        _one(ins, "Input").shape[int(attrs.get("input_dim_idx", 0))]
    return tuple(shape)


@register_op("gaussian_random_batch_size_like")
def _gaussian_random_bsl(ins, attrs, op):
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "float32"))
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * torch.randn(
        _batch_size_like_shape(ins, attrs), generator=_gen())
    return {"Out": [out.to(device=current_device(), dtype=dtype)]}


@register_op("uniform_random_batch_size_like")
def _uniform_random_bsl(ins, attrs, op):
    dtype = _dtype_mod.convert_dtype(attrs.get("dtype", "float32"))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = lo + (hi - lo) * torch.rand(_batch_size_like_shape(ins, attrs),
                                      generator=_gen())
    return {"Out": [out.to(device=current_device(), dtype=dtype)]}


@register_op("sequence_expand_as")
def _sequence_expand_as(ins, attrs, op):
    """ref sequence_expand_as_op.cc, dense: X row b repeats across the
    timesteps < Length[b] of the (B, T, ...) output (Y gives T)."""
    x, lengths = _one(ins, "X"), _one(ins, "Length")
    T = _one(ins, "Y").shape[1]
    out = x[:, None].repeat_interleave(T, dim=1)
    if lengths is not None:
        mask = torch.arange(T, device=x.device)[None, :] \
            < lengths.reshape(-1)[:, None]
        out = torch.where(mask.reshape(mask.shape + (1,) * (out.ndim - 2)),
                          out, torch.zeros_like(out))
    return {"Out": [out]}


# =========================================================================
# dequantize family (slim / int8 deploy path)
# =========================================================================

@register_op("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ins, attrs, op):
    """ref fake_dequantize_op.cc: Out = X * Scale / max_range."""
    x = _one(ins, "X").float()
    scale = _one(ins, "Scale").reshape(()).float()
    return {"Out": [x * scale / float(attrs["max_range"])]}


register_op("dequantize_abs_max")(_fake_dequantize_max_abs)


@register_op("fake_channel_wise_dequantize_max_abs")
def _fake_cw_dequantize_max_abs(ins, attrs, op):
    """ref fake_dequantize_op.cc channel-wise form: one scale per channel
    along quant_axis, an optional second (activation) scale."""
    x = _one(ins, "X").float()
    scales = ins.get("Scales", [])
    bits = attrs.get("quant_bits", [8])
    shape = [1] * x.ndim
    shape[int(attrs.get("quant_axis", 0))] = -1
    out = x * scales[0].float().reshape(shape) / (2 ** (int(bits[0]) - 1) - 1)
    if len(scales) > 1 and scales[1] is not None:
        out = out * scales[1].reshape(()).float() \
            / (2 ** (int(bits[1]) - 1) - 1)
    return {"Out": [out]}


@register_op("dequantize_log")
def _dequantize_log(ins, attrs, op):
    """ref dequantize_log_op.cc: int8 codes index a 128-entry dict;
    negative codes mirror with a sign flip."""
    x = _one(ins, "X").long()
    table = _one(ins, "Dict").float()
    return {"Out": [torch.where(x < 0, -table[(x + 128) % 128],
                                table[x % 128])]}


@register_op("fake_quantize_moving_average_abs_max")
def _fake_quantize_moving_avg_abs_max(ins, attrs, op):
    """ref fake_quantize_op.cc FakeQuantizeMovingAverageAbsMax: an EMA of
    |x|_max drives the scale; round(x/scale*bin_cnt)."""
    x = _one(ins, "X")
    in_scale = _one(ins, "InScale").reshape(())
    rate = float(attrs.get("moving_rate", 0.9))
    bin_cnt = 2 ** (int(attrs.get("bit_length", 8)) - 1) - 1
    cur = x.abs().max().to(in_scale.dtype)
    state, accum = _one(ins, "InState"), _one(ins, "InAccum")
    if attrs.get("is_test", False):
        scale, new_state, new_accum = in_scale, state, accum
    else:
        new_state = (rate * state.reshape(()) + 1 if state is not None
                     else torch.tensor(1.0, device=x.device))
        new_accum = (rate * accum.reshape(()) + cur if accum is not None
                     else cur)
        scale = new_accum / new_state
    inv = bin_cnt / torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x.float() * inv), -bin_cnt, bin_cnt)
    out = {"Out": [(q / inv).to(x.dtype)], "OutScale": [scale.reshape(1)]}
    if state is not None:
        out["OutState"] = [new_state.reshape(state.shape)]
    if accum is not None:
        out["OutAccum"] = [new_accum.reshape(accum.shape)]
    return out


# =========================================================================
# ModelAverage support + metric ops
# =========================================================================

@register_op("average_accumulates")
def _average_accumulates(ins, attrs, op):
    """ref average_accumulates_op.h: three-tier sum accumulation with a
    rollover every 16384 updates and a window restart when the window
    outgrows num_updates*average_window."""
    p = _one(ins, "param")
    s1, s2, s3 = (_one(ins, "in_sum_1"), _one(ins, "in_sum_2"),
                  _one(ins, "in_sum_3"))
    nu_in = _one(ins, "in_num_updates")
    nu = nu_in.reshape(()).long() + 1
    na = _one(ins, "in_num_accumulates").reshape(()).long() + 1
    ona = _one(ins, "in_old_num_accumulates").reshape(()).long()
    avg_win = float(attrs.get("average_window", 0.0))
    max_win = int(attrs.get("max_average_window", 2 ** 62))
    min_win = int(attrs.get("min_average_window", 10000))
    o1, o2, o3 = s1 + p, s2, s3
    roll = (nu % 16384) == 0
    o2 = torch.where(roll, o2 + o1, o2)
    o1 = torch.where(roll, torch.zeros_like(o1), o1)
    window = torch.minimum(torch.tensor(float(max_win), dtype=torch.float64,
                                        device=p.device),
                           nu.double() * avg_win).long()
    restart = (na >= min_win) & (na >= window)
    o3 = torch.where(restart, o1 + o2, o3)
    o1 = torch.where(restart, torch.zeros_like(o1), o1)
    o2 = torch.where(restart, torch.zeros_like(o2), o2)
    ona = torch.where(restart, na, ona)
    na = torch.where(restart, torch.zeros_like(na), na)
    dt = nu_in.dtype
    return {"out_sum_1": [o1], "out_sum_2": [o2], "out_sum_3": [o3],
            "out_num_updates": [nu.to(dt).reshape(1)],
            "out_num_accumulates": [na.to(dt).reshape(1)],
            "out_old_num_accumulates": [ona.to(dt).reshape(1)]}


def _pr_metrics(states):
    tp, fp, fn = states[:, 0], states[:, 1], states[:, 3]
    zero = torch.zeros_like(tp)
    prec = torch.where(tp + fp > 0, tp / (tp + fp + 1e-12), zero)
    rec = torch.where(tp + fn > 0, tp / (tp + fn + 1e-12), zero)
    f1 = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec + 1e-12),
                     zero)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    z = torch.zeros_like(stp)
    mp = torch.where(stp + sfp > 0, stp / (stp + sfp + 1e-12), z)
    mr = torch.where(stp + sfn > 0, stp / (stp + sfn + 1e-12), z)
    mf = torch.where(mp + mr > 0, 2 * mp * mr / (mp + mr + 1e-12), z)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])


@register_op("precision_recall")
def _precision_recall(ins, attrs, op):
    """ref precision_recall_op.h: per-class TP/FP/TN/FN from argmax
    predictions vs labels (+ optional weights), macro- and micro-averaged
    precision / recall / F1, with running accumulation."""
    cls = int(attrs["class_number"])
    idx = _one(ins, "Indices").reshape(-1).long()
    labels = _one(ins, "Labels").reshape(-1).long()
    w = _one(ins, "Weights")
    w = (w.reshape(-1).float() if w is not None
         else torch.ones(idx.shape, device=idx.device))
    onehot_p = tF.one_hot(idx, cls).float()
    onehot_l = tF.one_hot(labels, cls).float()
    tp = torch.einsum("nc,nc,n->c", onehot_p, onehot_l, w)
    fp = torch.einsum("nc,n->c", onehot_p, w) - tp
    fn = torch.einsum("nc,n->c", onehot_l, w) - tp
    tn = w.sum() - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)   # (C, 4)
    acc = _one(ins, "StatesInfo")
    accum_states = (batch_states + acc.float() if acc is not None
                    else batch_states)
    return {"BatchMetrics": [_pr_metrics(batch_states)],
            "AccumMetrics": [_pr_metrics(accum_states)],
            "AccumStatesInfo": [accum_states]}


# =========================================================================
# vision tail
# =========================================================================

@register_op("spp")
def _spp(ins, attrs, op):
    """ref spp_op.h: a pyramid of 2^p x 2^p poolings, each flattened and
    concatenated along the feature dim (ceil kernel + centring pad)."""
    from ..nn.functional import pooling as P

    x = _one(ins, "X")
    N, _C, H, W = x.shape
    outs = []
    for p in range(int(attrs["pyramid_height"])):
        bins = 2 ** p
        kh, kw = -(-H // bins), -(-W // bins)
        ph, pw = (kh * bins - H + 1) // 2, (kw * bins - W + 1) // 2
        if attrs.get("pooling_type", "max") == "max":
            lvl = P.max_pool2d(x, (kh, kw), (kh, kw), (ph, pw))
        else:
            lvl = P.avg_pool2d(x, (kh, kw), (kh, kw), (ph, pw),
                               exclusive=False)
        outs.append(lvl.reshape(N, -1))
    return {"Out": [torch.cat(outs, dim=1)]}


@register_op("polygon_box_transform")
def _polygon_box_transform(ins, attrs, op):
    """ref detection/polygon_box_transform_op.cc: even geo channels are
    x-offsets (4*w_idx - in), odd are y-offsets (4*h_idx - in)."""
    x = _one(ins, "Input")
    _N, G, H, W = x.shape
    wi = torch.arange(W, dtype=x.dtype, device=x.device).reshape(1, 1, 1, W)
    hi = torch.arange(H, dtype=x.dtype, device=x.device).reshape(1, 1, H, 1)
    even = (torch.arange(G, device=x.device) % 2 == 0).reshape(1, G, 1, 1)
    return {"Output": [torch.where(even, 4.0 * wi - x, 4.0 * hi - x)]}


@register_op("random_crop")
def _random_crop(ins, attrs, op):
    """ref random_crop_op.h: crop the trailing dims to attr shape at a
    random offset (the batch dims keep their extent)."""
    x = _one(ins, "X")
    shape = tuple(attrs["shape"])
    nbatch = x.ndim - len(shape)
    out = x
    for i, s in enumerate(shape):
        hi = x.shape[nbatch + i] - s
        start = int(torch.randint(0, hi + 1, (), generator=_gen())) \
            if hi > 0 else 0
        out = out.narrow(nbatch + i, start, s)
    return {"Out": [out], "SeedOut": [torch.zeros((1,), dtype=torch.int32,
                                                  device=x.device)]}


# =========================================================================
# hierarchical sigmoid (ref hierarchical_sigmoid_op.h +
# math/matrix_bit_code.h SimpleCode)
# =========================================================================

@register_op("hierarchical_sigmoid")
def _hierarchical_sigmoid(ins, attrs, op):
    x, w = _one(ins, "X"), _one(ins, "W")          # (B, D), (C-1, D)
    label = _one(ins, "Label").reshape(-1)
    bias = _one(ins, "Bias")
    path, code = _one(ins, "PathTable"), _one(ins, "PathCode")
    if path is not None and code is not None:
        node = path.long()
        bits = code.float()
        valid = node >= 0
        node = node.clamp_min(0)
    else:
        C = int(attrs["num_classes"])
        # SimpleCode: c = label + C; bit j's weight index (c >> (j+1)) - 1,
        # its branch bit (c >> j) & 1, the path ending at the root
        L = max((2 * C - 1).bit_length() - 1, 1)
        c = label.long() + C
        j = torch.arange(L, device=x.device)[None, :]
        node = (c[:, None] >> (j + 1)) - 1
        bits = ((c[:, None] >> j) & 1).float()
        valid = node >= 0
        node = torch.where(valid, node, torch.zeros_like(node))
    pre = torch.einsum("bd,bld->bl", x, w[node])
    if bias is not None:
        pre = pre + bias.reshape(-1)[node]
    lossb = tF.softplus(pre) - bits * pre
    loss = torch.where(valid, lossb, torch.zeros_like(lossb)).sum(
        1, keepdim=True)
    return {"Out": [loss], "PreOut": [pre]}


# =========================================================================
# SSD training-assignment trio
# =========================================================================

@register_op("bipartite_match")
def _bipartite_match(ins, attrs, op):
    """ref detection/bipartite_match_op.cc: greedy global-argmax matching
    of rows (gt) to cols (priors) by descending DistMat, then optional
    per_prediction argmax completion above dist_threshold.  DistMat
    (B, R, C) -> ColToRowMatchIndices / ColToRowMatchDist (B, C)."""
    dist = _one(ins, "DistMat")
    if dist.ndim == 2:
        dist = dist[None]
    B, R, C = dist.shape
    dev = dist.device
    md = torch.zeros((B, C), dtype=dist.dtype, device=dev)
    mi = torch.full((B, C), -1, dtype=torch.int32, device=dev)
    used_r = torch.ones((B, R), dtype=dist.dtype, device=dev)
    bidx = torch.arange(B, device=dev)
    for _ in range(R):
        m = dist * used_r[:, :, None] * (mi < 0)[:, None, :]
        flat = m.reshape(B, -1).argmax(1)
        r, c = flat // C, flat % C
        val = m[bidx, r, c]
        ok = val > 0
        mi[bidx, c] = torch.where(ok, r.to(torch.int32), mi[bidx, c])
        md[bidx, c] = torch.where(ok, dist[bidx, r, c], md[bidx, c])
        used_r[bidx, r] = torch.where(ok, torch.zeros_like(val),
                                      used_r[bidx, r])
    if attrs.get("match_type", "bipartite") == "per_prediction":
        best_d, best_r = dist.max(dim=1)
        take = (mi < 0) & (best_d >= float(attrs.get("dist_threshold", 0.5)))
        mi = torch.where(take, best_r.to(torch.int32), mi)
        md = torch.where(take, best_d, md)
    return {"ColToRowMatchIndices": [mi], "ColToRowMatchDis": [md],
            "ColToRowMatchDist": [md]}


@register_op("target_assign")
def _target_assign(ins, attrs, op):
    """ref detection/target_assign_op.h, dense: X (B, P, K) candidate rows,
    MatchIndices (B, M) -> Out (B, M, K) + OutWeight (B, M, 1); the
    optional NegIndices (B, M) (-1 padded) set mismatch_value, weight 1."""
    x = _one(ins, "X")
    if x.ndim == 2:
        x = x[:, :, None]
    match = _one(ins, "MatchIndices").long()
    B, M = match.shape
    mismatch = torch.tensor(float(attrs.get("mismatch_value", 0)),
                            dtype=x.dtype, device=x.device)
    b_idx = torch.arange(B, device=x.device)[:, None]
    gathered = x[b_idx, match.clamp_min(0)]
    matched = (match >= 0)[..., None]
    out = torch.where(matched, gathered, mismatch)
    wt = matched.float()
    neg = _one(ins, "NegIndices")
    if neg is not None:
        neg = neg.long()
        negmask = torch.zeros((B, M + 1), dtype=torch.bool, device=x.device)
        negmask[b_idx.expand_as(neg), torch.where(neg >= 0, neg,
                                                  torch.full_like(neg, M))] \
            = True
        negmask = negmask[:, :M, None]
        out = torch.where(negmask, mismatch, out)
        wt = torch.where(negmask, torch.ones_like(wt), wt)
    return {"Out": [out], "OutWeight": [wt]}


@register_op("mine_hard_examples")
def _mine_hard_examples(ins, attrs, op):
    """ref detection/mine_hard_examples_op.cc.  max_negative: candidates
    are unmatched priors ranked by ClsLoss, keep min(num_pos *
    neg_pos_ratio, #candidates); hard_example: candidates have MatchDist
    < neg_dist_threshold, loss cls + loc, keep sample_size and un-match
    the positives that do not survive.  NegIndices (B, P) ascending, -1
    padded."""
    cls_loss, loc_loss = _one(ins, "ClsLoss"), _one(ins, "LocLoss")
    match = _one(ins, "MatchIndices").to(torch.int32)
    mining = attrs.get("mining_type", "max_negative")
    B, P = match.shape
    if mining == "hard_example":
        eligible = _one(ins, "MatchDist") < float(
            attrs.get("neg_dist_threshold", 0.5))
        loss = cls_loss + (loc_loss if loc_loss is not None else 0.0)
        neg_sel = torch.clamp_max(eligible.sum(1),
                                  int(attrs.get("sample_size", 0)))
    else:
        eligible = match < 0
        loss = cls_loss
        num_pos = (match >= 0).sum(1)
        neg_sel = torch.minimum(
            (num_pos * float(attrs.get("neg_pos_ratio", 1.0))).to(
                torch.int32), eligible.sum(1).to(torch.int32))
    masked = torch.where(eligible, loss, torch.full_like(loss, -np.inf))
    order = torch.argsort(-masked, dim=1, stable=True)
    rank = torch.argsort(order, dim=1)
    selected = eligible & (rank < neg_sel[:, None])
    upd = match
    if mining == "hard_example":
        upd = torch.where((match > -1) & ~selected, torch.full_like(match, -1),
                          match)
        neg_mask = (match < 0) & selected
    else:
        neg_mask = selected
    tgt = torch.cumsum(neg_mask.long(), 1) - 1
    neg_idx = torch.full((B, P), -1, dtype=torch.int32, device=match.device)
    rows = torch.arange(B, device=match.device)[:, None].expand(B, P)
    cols = torch.arange(P, dtype=torch.int32,
                        device=match.device)[None].expand(B, P)
    neg_idx[rows[neg_mask], tgt[neg_mask]] = cols[neg_mask]
    return {"NegIndices": [neg_idx], "UpdatedMatchIndices": [upd]}


@register_op("fc")
def _fc_op(ins, attrs, op):
    """ref fc_op.h: flatten the leading ``in_num_col_dims`` dims, x @ W +
    b, optional relu."""
    x, w, b = _one(ins, "Input"), _one(ins, "W"), _one(ins, "Bias")
    lead = tuple(x.shape[:int(attrs.get("in_num_col_dims", 1))])
    out = x.reshape(int(np.prod(lead)) if lead else 1, -1) @ w
    if b is not None:
        out = out + b.reshape(1, -1)
    if attrs.get("activation_type", "") == "relu":
        out = torch.relu(out)
    return {"Out": [out.reshape(lead + (w.shape[1],))]}


@register_op("assert")
def _assert_op(ins, attrs, op):
    """ref controlflow/assert_op.cc: abort the run when Cond is false
    anywhere, printing the attached data vars (read on the host)."""
    cond = _one(ins, "Cond")
    if not bool(cond.all()):
        summarize = int(attrs.get("summarize", -1))
        shown = [_host_np(a).ravel()[:summarize if summarize > 0 else None]
                 for a in ins.get("Data", [])]
        raise AssertionError(f"assert_op failed; data: {shown}")
    return {}


def _host_np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
