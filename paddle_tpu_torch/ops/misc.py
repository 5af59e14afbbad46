"""The long tail of the reference's operators (counterpart of
paddle_tpu/ops/misc.py; ref operators/*.cc, named in each docstring):
pixel and space rearrangement, similarity and norm reductions, ranking
and focal losses, LRN, crop and pad utilities, multiplex and strided
slices, pooling with indices, affine_grid and grid_sampler, roi_pool,
row_conv, sequence_conv, NCE, data_norm, cvm, spectral_norm and the
temporal shift.  Plain torch compositions, as they are jnp ones in the
JAX package (no Pallas kernel lies behind them).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as tF

from ._util import as_tensor, index as _index

__all__ = [
    "affine_grid", "cos_sim", "crop_tensor", "cvm", "data_norm",
    "frobenius_norm", "nce_loss", "sequence_conv", "spectral_norm",
    "grid_sampler", "l1_norm", "lrn", "max_pool2d_with_index", "minus",
    "multiplex", "p_norm", "pad_constant_like", "pixel_shuffle",
    "pixel_unshuffle", "rank_loss", "reverse", "roi_pool", "row_conv",
    "shuffle_channel", "sigmoid_focal_loss", "space_to_depth",
    "strided_slice", "temporal_shift",
]


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


# -- rearrangement -------------------------------------------------------------
def pixel_shuffle(x, upscale_factor: int, data_format="NCHW"):
    """ref pixel_shuffle_op.cc: (N, C r^2, H, W) -> (N, C, H r, W r)."""
    r = int(upscale_factor)
    x = as_tensor(x)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    if c % (r * r):
        raise ValueError(f"channels {c} not divisible by upscale^2 {r * r}")
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(
        0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r, w * r)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def pixel_unshuffle(x, downscale_factor: int, data_format="NCHW"):
    """The inverse of ``pixel_shuffle`` (paddle 2.x API)."""
    r = int(downscale_factor)
    x = as_tensor(x)
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // r, r, w // r, r).permute(
        0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r, w // r)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def space_to_depth(x, blocksize: int):
    """ref space_to_depth_op.cc (NCHW)."""
    b = int(blocksize)
    x = as_tensor(x)
    n, c, h, w = x.shape
    return x.reshape(n, c, h // b, b, w // b, b).permute(
        0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


def shuffle_channel(x, group: int):
    """ref shuffle_channel_op.cc: interleave channel groups (ShuffleNet)."""
    x = as_tensor(x)
    n, c, h, w = x.shape
    return x.reshape(n, group, c // group, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25):
    """ref temporal_shift_op.cc (TSM): a ``shift_ratio`` share of the
    channels moves one segment back, the next share one forward, zero
    filled."""
    x = as_tensor(x)
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([x5[:, 1:, :c1], torch.zeros_like(x5[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(x5[:, :1, c1:c2]), x5[:, :-1, c1:c2]],
                    1)
    return torch.cat([back, fwd, x5[:, :, c2:]], 2).reshape(nt, c, h, w)


# -- similarity and norms --------------------------------------------------------
def cos_sim(x, y):
    """ref cos_sim_op.cc: row-wise cosine similarity, (N, 1)."""
    x = as_tensor(x)
    y = as_tensor(y, like=x).expand(x.shape)
    fx, fy = x.reshape(x.shape[0], -1), y.reshape(y.shape[0], -1)
    den = torch.linalg.vector_norm(fx, dim=-1) * torch.linalg.vector_norm(
        fy, dim=-1)
    return ((fx * fy).sum(-1) / torch.clamp(den, min=1e-12))[:, None]


def p_norm(x, p=2.0, axis=None, epsilon=1e-12, keepdim=False):
    """ref p_norm_op.cc; floored at ``epsilon`` for p > 0."""
    x = as_tensor(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if p == float("inf"):
        out = x.abs().amax(dim=axis, keepdim=keepdim)
    elif p == float("-inf"):
        out = x.abs().amin(dim=axis, keepdim=keepdim)
    else:
        out = (x.abs() ** p).sum(dim=axis, keepdim=keepdim) ** (1.0 / p)
    return torch.clamp(out, min=epsilon) if p > 0 else out


def frobenius_norm(x, axis=None, keepdim=False):
    """ref frobenius_norm_op.cc."""
    x = as_tensor(x)
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else (
        tuple(range(x.dim())) if axis is None else axis)
    return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=keepdim))


def l1_norm(x):
    """ref l1_norm_op.cc: the sum of absolute values, a scalar."""
    return as_tensor(x).abs().sum()


def minus(x, y):
    """ref minus_op.cc."""
    x = as_tensor(x)
    return x - as_tensor(y, like=x)


def reverse(x, axis):
    """ref reverse_op.cc: the Fluid-era name of ``flip``."""
    from .manipulation import flip

    return flip(x, axis)


def multiplex(inputs: Sequence, index):
    """ref multiplex_op.cc: row i of the output is row i of
    ``inputs[index[i]]``."""
    stacked = torch.stack([as_tensor(t) for t in inputs], 0)     # (K, N, ...)
    idx = _index(as_tensor(index, like=stacked)).reshape(-1)
    return stacked[idx, torch.arange(idx.shape[0], device=idx.device)]


def strided_slice(x, axes, starts, ends, strides):
    """ref strided_slice_op.cc with Python's slice semantics, negative
    strides included (torch slicing takes none: an index gather)."""
    x = as_tensor(x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx = range(*slice(s, e, st).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.as_tensor(
            list(idx), dtype=torch.int64, device=x.device))
    return x


# -- losses ----------------------------------------------------------------------
def _softplus(z):
    """log(1 + e^z), stable (``logaddexp(0, z)``)."""
    return torch.logaddexp(torch.zeros_like(z), z)


def rank_loss(label, left, right):
    """ref rank_loss_op.cc: RankNet's pairwise loss in the stable softplus
    form."""
    left = as_tensor(left)
    diff = left - as_tensor(right, like=left)
    return _softplus(diff) - as_tensor(label, like=left) * diff


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    """ref sigmoid_focal_loss_op.cc (RetinaNet): x (N, C) logits, label
    (N, 1) in [0, C] with 0 the background, fg_num the normaliser."""
    x = as_tensor(x).float()
    n, c = x.shape
    lab = as_tensor(label, like=x).reshape(-1)
    target = (lab[:, None] == torch.arange(1, c + 1, device=x.device)[None, :]
              ).float()
    p = torch.sigmoid(x)
    pos = target > 0
    ce = _softplus(torch.where(pos, -x, x))
    p_t = torch.where(pos, p, 1 - p)
    a_t = torch.where(pos, torch.full_like(x, alpha),
                      torch.full_like(x, 1 - alpha))
    loss = a_t * ((1 - p_t) ** gamma) * ce
    return loss / torch.clamp(as_tensor(fg_num, like=x).float(), min=1.0)


def lrn(x, n=5, k=1.0, alpha=1e-4, beta=0.75):
    """ref lrn_op.cc: local response normalisation across the channels of
    NCHW; the window starts (n - 1) // 2 channels before each channel, as
    the reference's C truncation gives."""
    x = as_tensor(x)
    half = (n - 1) // 2
    sq = tF.pad(x * x, (0, 0, 0, 0, half, n - 1 - half))
    csum = torch.cat([torch.zeros_like(sq[:, :1]), torch.cumsum(sq, 1)], 1)
    win = csum[:, n:] - csum[:, :-n]
    return x / ((k + alpha * win) ** beta)


def pad_constant_like(x, y, pad_value=0.0):
    """ref pad_constant_like_op.cc: pad y at the end up to x's shape."""
    y = as_tensor(y)
    cfg = []
    for xd, yd in reversed(list(zip(x.shape, y.shape))):
        cfg += [0, int(xd) - int(yd)]
    return tF.pad(y, cfg, value=pad_value)


def crop_tensor(x, shape=None, offsets=None):
    """ref crop_tensor_op.cc: ``extra.crop``; shape None keeps x's shape."""
    from .extra import crop

    x = as_tensor(x)
    return crop(x, shape=list(x.shape) if shape is None else list(shape),
                offsets=offsets)


# -- pooling, sampling, ROI --------------------------------------------------------
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0):
    """ref max_pool2d_with_index_op.cc: (out, the flat index of each
    maximum within its image's H*W plane).  The first maximum of a window
    wins, as ``argmax``; a window whose maximum lies in the padding gives
    -1.  The index is int64 (int32 in the JAX package)."""
    x = as_tensor(x)
    ks = _pair(kernel_size)
    st = ks if stride is None else _pair(stride)
    pd = _pair(padding)
    n, c, h, w = x.shape
    xp = tF.pad(x, (pd[1], pd[1], pd[0], pd[0]), value=float("-inf"))
    win = xp.unfold(2, ks[0], st[0]).unfold(3, ks[1], st[1])  # n c oh ow kh kw
    oh, ow = win.shape[2], win.shape[3]
    flat = win.reshape(n, c, oh, ow, ks[0] * ks[1])
    arg = torch.argmax(flat, dim=-1)
    out = torch.gather(flat, -1, arg[..., None])[..., 0]
    r = (torch.arange(oh, device=x.device) * st[0])[:, None] + arg // ks[1] \
        - pd[0]
    q = (torch.arange(ow, device=x.device) * st[1])[None, :] + arg % ks[1] \
        - pd[1]
    inside = (r >= 0) & (r < h) & (q >= 0) & (q < w)
    return out, torch.where(inside, r * w + q, torch.full_like(r, -1))


def affine_grid(theta, out_shape, align_corners=True):
    """ref affine_grid_op.cc: theta (N, 2, 3) -> the sampling grid (N, H, W,
    2) of normalised (x, y) coordinates."""
    theta = as_tensor(theta)
    _, _, h, w = out_shape

    def axis_coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    gy, gx = torch.meshgrid(axis_coords(h), axis_coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(theta.dtype)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sampler(x, grid, mode="bilinear", padding_mode="zeros",
                 align_corners=True):
    """ref grid_sampler_op.cc: sample NCHW x at grid (N, H', W', 2) of
    normalised (x, y) coordinates, bilinear or nearest (round half to
    even), ``padding_mode`` zeros or border; reflection raises, as in the
    JAX package."""
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sampler padding_mode {padding_mode!r}: only zeros/border "
            "are implemented")
    x = as_tensor(x)
    grid = as_tensor(grid, like=x)
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(iy, ix):
        vals = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        if padding_mode == "zeros":
            inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            vals = torch.where(inb[..., None], vals, torch.zeros_like(vals))
        return vals                                        # (n, H', W', c)

    if mode == "nearest":
        out = gather(torch.round(fy).long(), torch.round(fx).long())
    else:
        x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
        wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
        out = (gather(y0, x0) * (1 - wy) * (1 - wx)
               + gather(y0, x0 + 1) * (1 - wy) * wx
               + gather(y0 + 1, x0) * wy * (1 - wx)
               + gather(y0 + 1, x0 + 1) * wy * wx)
    return out.permute(0, 3, 1, 2).to(x.dtype)


def roi_pool(input, rois, output_size, spatial_scale=1.0):
    """ref roi_pool_op.cc: max over ROI bins of one (C, H, W) feature map;
    rois (R, 4) x1 y1 x2 y2, rounded after scaling; bin (i, j) covers rows
    floor(y1 + i rh) .. ceil(y1 + (i + 1) rh) - 1; an empty bin gives 0.
    Returns (R, C, ph, pw)."""
    input = as_tensor(input)
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else tuple(output_size)
    C, H, W = input.shape
    boxes = torch.round(as_tensor(rois, like=input).float() * spatial_scale)
    x1, y1, x2, y2 = boxes.unbind(-1)
    rh = torch.clamp(y2 - y1 + 1, min=1.0) / ph
    rw = torch.clamp(x2 - x1 + 1, min=1.0) / pw
    ys = torch.arange(H, dtype=torch.float32, device=input.device)
    xs = torch.arange(W, dtype=torch.float32, device=input.device)
    neg = torch.full((), float("-inf"), dtype=input.dtype,
                     device=input.device)
    out = []
    for i in range(ph):
        row = []
        for j in range(pw):
            my = ((ys[None] >= torch.floor(y1 + i * rh)[:, None])
                  & (ys[None] < torch.ceil(y1 + (i + 1) * rh)[:, None]))
            mx = ((xs[None] >= torch.floor(x1 + j * rw)[:, None])
                  & (xs[None] < torch.ceil(x1 + (j + 1) * rw)[:, None]))
            m = my[:, :, None] & mx[:, None, :]                  # (R, H, W)
            v = torch.where(m[:, None], input[None], neg).amax(dim=(2, 3))
            row.append(torch.where(torch.isfinite(v), v, torch.zeros_like(v)))
        out.append(torch.stack(row, -1))
    return torch.stack(out, -2).to(input.dtype)


# -- sequence convolutions ---------------------------------------------------------
def _length_mask(lengths, x):
    from .sequence import sequence_mask

    return sequence_mask(as_tensor(lengths, like=x), x.shape[1]).to(
        x.dtype)[..., None]


def row_conv(x, weight, lengths=None):
    """ref row_conv_op.cc (lookahead convolution for streaming ASR): x (b,
    s, d), weight (future_context + 1, d), out[t] = sum_k w[k] x[t + k].
    With ``lengths`` the lookahead stops at each sequence's end and output
    rows past it are zero."""
    x = as_tensor(x)
    weight = as_tensor(weight, like=x)
    k = weight.shape[0]
    if lengths is not None:
        m = _length_mask(lengths, x)
        x = x * m
    out = torch.zeros_like(x)
    for i in range(k):
        shifted = tF.pad(x[:, i:], (0, 0, 0, i))
        out = out + shifted * weight[i][None, None, :]
    return out * m if lengths is not None else out


def sequence_conv(x, weight, lengths=None, context_length=3,
                  context_start=None):
    """ref sequence_conv_op.cc: a windowed convolution over each sequence's
    time axis.  x (b, s, din), weight (context_length * din, dout); the
    window of step t covers [t + context_start, t + context_start +
    context_length), zero outside the sequence; ``context_start`` None is
    -(context_length // 2)."""
    x = as_tensor(x)
    b, s, din = x.shape
    if context_start is None:
        context_start = -(context_length // 2)
    if lengths is not None:
        m = _length_mask(lengths, x)
        x = x * m
    cols = []
    for i in range(context_length):
        off = context_start + i
        if abs(off) >= s:
            cols.append(torch.zeros_like(x))
        elif off < 0:
            cols.append(tF.pad(x[:, :s + off], (0, 0, -off, 0)))
        elif off > 0:
            cols.append(tF.pad(x[:, off:], (0, 0, 0, off)))
        else:
            cols.append(x)
    out = torch.cat(cols, -1) @ as_tensor(weight, like=x)
    return out * m if lengths is not None else out


# -- NCE, CTR ops, spectral norm -----------------------------------------------------
def nce_loss(input, label, weight, bias, sample_ids,
             num_total_classes=None):
    """ref nce_op.cc: noise-contrastive estimation with the uniform noise
    prior B = num_neg / num_total_classes folded in: logistic losses on
    logit - log(B) for the true class and each given negative.  input (b,
    dim), label (b,), weight (classes, dim), bias (classes,), sample_ids
    (b, num_neg) drawn by the caller.  Returns (b, 1)."""
    input = as_tensor(input)
    label = _index(as_tensor(label, like=input)).reshape(-1)
    sample_ids = _index(as_tensor(sample_ids, like=input))
    weight = as_tensor(weight, like=input)
    bias = as_tensor(bias, like=input)
    if num_total_classes is None:
        num_total_classes = weight.shape[0]
    num_neg = sample_ids.shape[1]
    log_b = float(torch.log(torch.tensor(num_neg / num_total_classes,
                                         dtype=torch.float32)))
    pos_logit = (input * weight[label]).sum(-1) + bias[label]
    neg_logit = torch.einsum("bd,bkd->bk", input, weight[sample_ids]) \
        + bias[sample_ids]
    loss = _softplus(-(pos_logit - log_b)) + _softplus(neg_logit - log_b
                                                       ).sum(-1)
    return loss[:, None]


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    """ref data_norm_op.cc (CTR models): normalise by the accumulated batch
    statistics, scale sqrt(batch_size / batch_square_sum) with no mean^2
    term (ref :301-302); returns (y, and the three accumulators updated)."""
    x = as_tensor(x)
    mean = batch_sum / batch_size
    scale = torch.sqrt(batch_size / (batch_square_sum + epsilon))
    return ((x - mean) * scale, batch_size + x.shape[0],
            batch_sum + x.sum(0), batch_square_sum + (x * x).sum(0))


def cvm(x, use_cvm=True):
    """ref cvm_op.cc (continuous value model): the first two features are
    show / click counts; with ``use_cvm`` they become log(show + 1) and
    log(click + 1) - log(show + 1), else they are dropped."""
    x = as_tensor(x)
    if use_cvm:
        show = torch.log(x[:, 0:1] + 1.0)
        return torch.cat([show, torch.log(x[:, 1:2] + 1.0) - show, x[:, 2:]],
                         1)
    return x[:, 2:]


def spectral_norm(weight, u, dim=0, power_iters=1, epsilon=1e-12):
    """ref spectral_norm_op.cc: ``weight`` over its largest singular value,
    estimated by power iteration from ``u`` (rows,); returns (weight /
    sigma, the new u), the caller keeping u."""
    w = as_tensor(weight)
    perm = (dim,) + tuple(i for i in range(w.dim()) if i != dim)
    mat = w.permute(perm).reshape(w.shape[dim], -1)
    u = as_tensor(u, like=w)

    def norm(v):
        return v / (torch.linalg.vector_norm(v) + epsilon)

    v = None
    for _ in range(max(1, int(power_iters))):
        v = norm(mat.T @ u)
        u = norm(mat @ v)
    return w / (u @ mat @ v), u
