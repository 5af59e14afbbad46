"""Training-mode BatchNorm + activation (NHWC), around the library conv.

Counterpart of the training half of paddle_tpu/ops/pallas/conv_fused.py
(rows 11 and 12 of the table of TPU kernels)::

    y = act((x - mean) * rsqrt(var + eps) * gamma + beta)

over the channels of an NHWC x viewed as (rows, C), with the batch
statistics ``mean`` and ``var = E[x^2] - mean^2`` (clamped at 0, the JAX
formula, not Welford) returned in fp32 for the caller's running-stat
update.  One kernel source, ``csrc/bn_act_train.cu``, two kernels:

* ``batch_stats`` (row 11, ``_batch_stats``): the per-channel fp32 sum
  and sum of squares in one launch: a cluster of up to 16 CTAs splits a
  tile of channels by rows and combines its partials through distributed
  shared memory in rank order (``stats_plan`` sizes the tiles and
  clusters from the shape; no atomics: repeatable bit for bit);
* ``scale_act`` (row 12, ``scale_act``): ``act(x * a + b)`` with
  per-channel fp32 ``a = gamma * rsqrt(var + eps)``, ``b = beta - mean *
  a``, in one pass, out in x's dtype.

``fused_bn_act_train`` ties them in ``_FusedBnActTrain``, whose backward
is the JAX custom VJP's two-pass BatchNorm backward (``_bn_act_train_bwd``)
in torch: that VJP is plain jnp math, not a Pallas kernel, so it has no
kernel here either.  ``train_supported`` is the JAX gate (NHWC, fp32 or
bf16, act "" or relu, C % 128 == 0, rows % 8 == 0); the dispatch site is
``nn/functional/norm.batch_norm_act``.  The wrappers launch their kernels
on CUDA tensors (contiguous, C % 128 == 0) or raise, and run their plain
versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from . import build, config
from .conv_fused import apply_act

SOURCE = "bn_act_train"
STATS_KERNEL = "bn_batch_stats"
SCALE_KERNEL = "bn_scale_act"
STATS_REPLACES = "paddle_tpu/ops/pallas/conv_fused.py:234 _batch_stats"
SCALE_REPLACES = "paddle_tpu/ops/pallas/conv_fused.py:251 scale_act"
# The JAX function's VJP, plain jnp math: the backward here is torch math.
PLAIN_BACKWARD = "paddle_tpu/ops/pallas/conv_fused.py:301 _bn_act_train_bwd"

# Acts whose gradient the backward rebuilds from the saved output.
TRAIN_ACTS = ("", "relu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE_C = 128              # channels a CTA of scale_act covers
CTAS_PER_SM, SMS = 4, 132  # the grid scale_act aims for
DEFAULT_BLOCK_ROWS = 256  # the TPU kernel's row block (plain version)
# batch_stats' plan (csrc/bn_act_train.cu: kStatsThreads, kMaxCluster and
# the tiles its entry instantiates): CTAs a plan aims for (about one an
# SM) and the bytes of a row a CTA reads at most where that many fit
STATS_TILES = (16, 32, 64, 128)
STATS_THREADS = 256
MAX_CLUSTER = 16
STATS_CTAS = 128
STATS_SEGMENT = 64


def _rows_block(n_rows: int) -> int:
    block = min(DEFAULT_BLOCK_ROWS, n_rows)
    while n_rows % block:
        block //= 2
    return max(block, 1)


def train_supported(x, act="", data_format="NHWC") -> bool:
    """The JAX package's gate (conv_fused.py:267): x is the NHWC input
    (anything with ``.shape`` and a torch ``.dtype``)."""
    if data_format != "NHWC" or len(getattr(x, "shape", ())) != 4:
        return False
    if act not in TRAIN_ACTS:
        return False
    if x.dtype not in _DTYPE_CODES:
        return False
    n, h, w, c = x.shape
    return c % 128 == 0 and (n * h * w) % 8 == 0


def batch_stats_plain(x2):
    """The TPU kernel's arithmetic: fp32 sums of x and x * x over blocks
    of ``_rows_block`` rows, then over the blocks' partials."""
    rows, c = x2.shape
    xf = x2.float().reshape(rows // _rows_block(rows), -1, c)
    return xf.sum(1).sum(0), (xf * xf).sum(1).sum(0)


def scale_act_plain(x2, a, b, act):
    """``act(x * a + b)`` in fp32, cast to x's dtype."""
    return apply_act(x2.float() * a[None, :] + b[None, :], act).to(x2.dtype)


def _grid(rows: int, c: int) -> Tuple[int, int]:
    """scale_act's (rows a CTA walks, row blocks): about CTAS_PER_SM CTAs
    on each SM."""
    blocks = max(1, min(rows, CTAS_PER_SM * SMS // (c // TILE_C)))
    rows_per = math.ceil(rows / blocks)
    return rows_per, math.ceil(rows / rows_per)


@dataclasses.dataclass(frozen=True)
class StatsPlan:
    """The launch of ``batch_stats``: channel tiles of ``tile_c`` channels,
    each one cluster of ``cluster`` CTAs, one a block of ``rows_per_cta``
    rows (``row_blocks == cluster``; a block past the last row sums
    nothing), ``threads`` threads a CTA."""
    tile_c: int
    channel_tiles: int
    cluster: int
    row_blocks: int
    rows_per_cta: int
    threads: int

    @property
    def ctas(self) -> int:
        return self.channel_tiles * self.row_blocks


@functools.lru_cache(maxsize=1024)
def stats_plan(rows: int, c: int, dtype) -> StatsPlan:
    """The plan of ``batch_stats`` over a (rows, c) array of ``dtype``,
    from the shape alone: the channel tile of STATS_SEGMENT bytes, or
    narrower (down to 16 channels, a 32-byte segment) where C / 8 is, so
    that clusters of at most MAX_CLUSTER row blocks can make STATS_CTAS
    CTAs; the cluster the smallest power of two that makes them (smaller
    clusters wait less at their barrier), at most the largest power of two
    up to ``rows``, the rows split evenly over it."""
    itemsize = dtype.itemsize
    want = max(STATS_TILES[0], min(STATS_SEGMENT // itemsize,
                                   c // (STATS_CTAS // MAX_CLUSTER)))
    tiles = [t for t in STATS_TILES if c % t == 0 and t * itemsize >= 32]
    if rows < 1 or not tiles:
        raise ValueError(f"{STATS_KERNEL}: no plan for {rows} x {c} {dtype}")
    tile = max([t for t in tiles if t <= want] or tiles[:1])
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * 2 <= rows \
            and (c // tile) * cluster < STATS_CTAS:
        cluster *= 2
    return StatsPlan(tile_c=tile, channel_tiles=c // tile, cluster=cluster,
                     row_blocks=cluster,
                     rows_per_cta=math.ceil(rows / cluster),
                     threads=STATS_THREADS)


def _check(name, x2, *vectors):
    if x2.dim() != 2:
        raise ValueError(f"{name}: expected x of shape (rows, C), got "
                         f"{tuple(x2.shape)}")
    rows, c = x2.shape
    for v in vectors:
        if v.shape != (c,):
            raise ValueError(f"{name}: per-channel vectors must be ({c},)")
    if torch.is_grad_enabled() and x2.requires_grad:
        raise NotImplementedError(
            f"{name} has no backward of its own: differentiate through "
            f"fused_bn_act_train")
    if x2.device.type == "cpu":
        return
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2.device}")
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got "
                         f"{x2.dtype}")
    if c % TILE_C or rows < 1:
        raise ValueError(f"{name}: needs rows >= 1 and C % {TILE_C} == 0, "
                         f"got {rows} x {c}")
    for v in vectors:
        if v.dtype != torch.float32 or v.device != x2.device \
                or not v.is_contiguous():
            raise ValueError(f"{name}: a and b must be contiguous float32 "
                             f"on {x2.device}")
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned;"
                         f" the wrapper does not copy it")


def _entry(symbol):
    """C entry ``symbol`` of the library.  ``bn_batch_stats``: x, sum,
    sumsq (pointers), rows (int64), c, channel tile, cluster, rows per CTA
    (int64), dtype code, the stream.  ``bn_scale_act``: x, a, b, out, rows
    (int64), c, rows per CTA (int64), row blocks, relu, dtype code, the
    stream.  ``bn_stats_max_clusters``: c, channel tile, cluster, dtype
    code, an int pointer."""
    fn = getattr(build.load(SOURCE), symbol)
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = {STATS_KERNEL: [P] * 3 + [L, I, I, I, L, I, P],
                       SCALE_KERNEL: [P] * 4 + [L, I, L, I, I, I, P],
                       "bn_stats_max_clusters": [
                           I, I, I, I, ctypes.POINTER(I)]}[symbol]
        fn.restype = I
    return fn


def stats_max_clusters(rows, c, dtype) -> int:
    """``cudaOccupancyMaxActiveClusters`` of ``stats_plan(rows, c,
    dtype)``'s launch on the current CUDA device: how many of its clusters
    the card holds at once."""
    plan = stats_plan(rows, c, dtype)
    out = ctypes.c_int(0)
    err = _entry("bn_stats_max_clusters")(
        c, plan.tile_c, plan.cluster, _DTYPE_CODES[dtype], ctypes.pointer(out))
    if err:
        raise RuntimeError(f"bn_stats_max_clusters failed: CUDA error {err}")
    return out.value


def batch_stats(x2):
    """Per-channel fp32 (sum, sum of squares) of a (rows, C) array: the
    kernel on CUDA tensors, its plain version on CPU tensors."""
    _check(STATS_KERNEL, x2)
    if x2.device.type == "cpu":
        return batch_stats_plain(x2)
    rows, c = x2.shape
    plan = stats_plan(rows, c, x2.dtype)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    err = _entry(STATS_KERNEL)(
        x2.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), rows, c,
        plan.tile_c, plan.cluster, plan.rows_per_cta, _DTYPE_CODES[x2.dtype],
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise RuntimeError(f"{STATS_KERNEL} launch failed: CUDA error {err}")
    config.record_call(STATS_KERNEL)
    return out[0], out[1]


def scale_act(x2, a, b, act):
    """``act(x * a + b)`` over a (rows, C) array, a and b fp32 (C,): the
    kernel on CUDA tensors, its plain version on CPU tensors."""
    if act not in TRAIN_ACTS:
        raise ValueError(f"{SCALE_KERNEL}: act must be one of {TRAIN_ACTS}, "
                         f"got {act!r}")
    _check(SCALE_KERNEL, x2, a, b)
    if x2.device.type == "cpu":
        return scale_act_plain(x2, a, b, act)
    rows, c = x2.shape
    rows_per, parts = _grid(rows, c)
    out = torch.empty_like(x2)
    err = _entry(SCALE_KERNEL)(
        x2.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, c,
        rows_per, parts, int(act == "relu"), _DTYPE_CODES[x2.dtype],
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err:
        raise RuntimeError(f"{SCALE_KERNEL} launch failed: CUDA error {err}")
    config.record_call(SCALE_KERNEL)
    return out


class _FusedBnActTrain(torch.autograd.Function):
    """Forward: the two kernels and the (C,)-sized statistics between
    them.  Backward: the JAX VJP's two-pass BatchNorm backward; the
    cotangents of mean and var are ignored (they feed the detached
    running-stat update only)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, act):
        rows = x2.shape[0]
        s, ss = batch_stats(x2)
        mean = s / rows
        var = torch.clamp(ss / rows - mean * mean, min=0.0)
        a = gamma.float() * torch.rsqrt(var + eps)
        b = beta.float() - mean * a
        y2 = scale_act(x2, a, b, act)
        ctx.save_for_backward(x2, gamma, mean, var, y2)
        ctx.eps, ctx.act = eps, act
        ctx.mark_non_differentiable(mean, var)
        return y2, mean, var

    @staticmethod
    def backward(ctx, dy2, _dmean, _dvar):
        x2, gamma, mean, var, y2 = ctx.saved_tensors
        rows = x2.shape[0]
        dz = dy2.float()
        if ctx.act == "relu":
            dz = torch.where(y2 > 0, dz, torch.zeros((), device=dz.device))
        inv = torch.rsqrt(var + ctx.eps)
        xhat = (x2.float() - mean[None, :]) * inv[None, :]
        dbeta = dz.sum(0)
        dgamma = (dz * xhat).sum(0)
        g = gamma.float() * inv
        dx = g[None, :] * (dz - dbeta[None, :] / rows
                           - xhat * dgamma[None, :] / rows)
        return (dx.to(x2.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None, None)


def fused_bn_act_train(x, gamma, beta, eps=1e-5, act=""):
    """Training-mode fused BatchNorm + activation over an NHWC tensor.
    Returns ``(y, batch_mean, batch_var)``: y differentiable in (x, gamma,
    beta), mean and var fp32 ``(C,)`` batch statistics."""
    n, h, w, c = x.shape
    y2, mean, var = _FusedBnActTrain.apply(x.reshape(n * h * w, c), gamma,
                                           beta, float(eps), act)
    return y2.reshape(n, h, w, c), mean, var


def stats_cost(rows, c, itemsize=4) -> Tuple[float, float]:
    """(flops, device bytes) of ``batch_stats``: an add, a multiply and an
    add per value; x read once, the two (C,) fp32 sums written."""
    return 3.0 * rows * c, float(rows * c * itemsize + 2 * c * 4)


def scale_cost(rows, c, itemsize=4) -> Tuple[float, float]:
    """(flops, device bytes) of ``scale_act``: a multiply, an add and the
    act per value; x read and the output written once, a and b read."""
    return 3.0 * rows * c, float(2 * rows * c * itemsize + 2 * c * 4)


KERNELS = (
    config.Kernel(STATS_KERNEL, SOURCE, STATS_REPLACES, batch_stats,
                  batch_stats_plain),
    config.Kernel(SCALE_KERNEL, SOURCE, SCALE_REPLACES, scale_act,
                  scale_act_plain),
)
