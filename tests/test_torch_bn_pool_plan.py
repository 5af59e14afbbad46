"""The host side of the batch-statistics kernel (row 11) and the NHWC pool
(row 13), on the CPU: the plans that the wrappers hand the C entries, and
the order in which each kernel combines its values, against the JAX
package's Pallas kernels.

* ``stats_plan`` covers every (row, channel) once, keeps its cluster within
  16 CTAs and its channel tile within C and at 32 bytes of a row or more,
  gives at least 128 busy CTAs wherever the shape has that many (row,
  channel-tile) units (exactly 128 at VGG-16's four b128 shapes and
  ResNet-50's stage 1), and takes the shape alone.
* The statistics' order (a thread's rows, a butterfly over a warp's row
  lanes, the warps, then the cluster's ranks) in plain fp32 arithmetic is
  held against the JAX ``_batch_stats`` (interpret mode, the JAX package's
  own CPU route) at 1e-5 of the largest sum, as the plain version is.
* ``pool_plan`` gives 2x2/2, 3x3/2 and 3x3/1 their compile-time windows
  and every other window the generic one, maps each thread to one 16-byte
  vector of one output pixel so that every output value is written once,
  and spreads VGG-16's 2x2 c512 b128 pool over at least 132 CTAs.
* The pool's order (every tap loaded first, padding taps predicated to
  -inf or +0.0, combined in (i, j) order) is the JAX kernel's max bit for
  bit, NaNs included, and the plain version's average bit for bit.
"""
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import conv_fused as jcf
from paddle_tpu.ops.pallas import pooling as jpool
from paddle_tpu_torch.ops.kernels import bn_act_train as tbn
from paddle_tpu_torch.ops.kernels import pooling as tpool

CSRC = Path(tbn.__file__).parent / "csrc"
STATS_SOURCE = (CSRC / f"{tbn.SOURCE}.cu").read_text()
POOL_SOURCE = (CSRC / f"{tpool.SOURCE}.cu").read_text()
STATS_REL = 1e-5
DTYPES = (torch.float32, torch.bfloat16)
# (rows, C): VGG-16's train-mode BN shapes at b128, ResNet-50's stage 1 at
# b64, C = 128 with 8 rows, rows that no row block divides, C = 1024.
STATS_SHAPES = ((32768, 128), (8192, 256), (2048, 512), (512, 512),
                (200704, 256), (8, 128), (24, 384), (32776, 128),
                (2056, 1024), (8, 1024))
VGG_POOLS = ((128, 16, 16, 128), (128, 8, 8, 256), (128, 4, 4, 512),
             (128, 2, 2, 512))


def _constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_wrapper_constants_are_the_c_entrys():
    assert tbn.STATS_THREADS == _constant(STATS_SOURCE, "kStatsThreads")
    assert tbn.MAX_CLUSTER == _constant(STATS_SOURCE, "kMaxCluster")
    cases = re.findall(r"case (\d+): return F<T, (\d+)>::run",
                       STATS_SOURCE)
    assert tuple(int(a) for a, b in cases) == tbn.STATS_TILES
    assert all(a == b for a, b in cases)
    for (kh, kw, sh, sw), code in tpool.WINDOWS.items():
        name = f"kWin{kh}x{kw}s{sh}"
        assert sh == sw and _constant(POOL_SOURCE, name) == code, name
        assert re.search(rf"case {name}:\s+pool2d_nhwc_kernel<T, kMax, "
                         rf"{kh}, {kw}, {sh}, {sw}, I>", POOL_SOURCE), name
    assert _constant(POOL_SOURCE, "kGeneric") == tpool.GENERIC_WINDOW
    assert max(tpool.POOL_THREADS) == _constant(POOL_SOURCE, "kMaxThreads")
    for t in tpool.POOL_THREADS:
        assert f"threads != {t}" in POOL_SOURCE


# -- row 11: the statistics plan -----------------------------------------------

def _row_blocks(plan, rows):
    """The [start, end) rows of each block of the plan, as the kernel takes
    them (rank * rows_per_cta, clipped to rows)."""
    return [(min(r * plan.rows_per_cta, rows),
             min((r + 1) * plan.rows_per_cta, rows))
            for r in range(plan.row_blocks)]


@pytest.mark.parametrize("rows,c", STATS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_stats_plan_covers_each_row_and_channel_once(rows, c, dtype):
    plan = tbn.stats_plan(rows, c, dtype)
    assert plan.tile_c in tbn.STATS_TILES and c % plan.tile_c == 0
    assert plan.channel_tiles * plan.tile_c == c
    assert plan.tile_c * dtype.itemsize >= 32        # a 32-byte segment
    assert 1 <= plan.cluster <= tbn.MAX_CLUSTER
    assert plan.row_blocks % plan.cluster == 0
    assert plan.threads == tbn.STATS_THREADS
    lanes = plan.tile_c // (16 // dtype.itemsize)     # threads along C
    assert 32 % lanes == 0 and 2 * plan.tile_c <= plan.threads
    blocks = _row_blocks(plan, rows)
    assert blocks[0][0] == 0 and blocks[-1][1] == rows
    for (a0, a1), (b0, b1) in zip(blocks, blocks[1:]):
        assert a1 == b0 and a0 <= a1
    assert sum(b - a for a, b in blocks) == rows


@pytest.mark.parametrize("rows,c", STATS_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_stats_plan_fills_the_card(rows, c, dtype):
    plan = tbn.stats_plan(rows, c, dtype)
    busy = plan.channel_tiles * sum(
        b > a for a, b in _row_blocks(plan, rows))
    assert busy >= min(128, rows * c // plan.tile_c)
    assert plan.ctas == plan.channel_tiles * plan.row_blocks
    if (rows, c) in STATS_SHAPES[:5]:     # VGG-16 b128, ResNet-50 stage 1
        assert plan.ctas == busy == 128


def test_stats_plan_reads_shapes_only():
    assert list(inspect.signature(tbn.stats_plan).parameters) == \
        ["rows", "c", "dtype"]
    a = tbn.stats_plan(32768, 128, torch.float32)
    assert a == tbn.stats_plan(np.int64(32768), np.int64(128), torch.float32)
    assert a == tbn.stats_plan(32768, 128, torch.bfloat16)
    with pytest.raises(ValueError):
        tbn.stats_plan(0, 128, torch.float32)


def _cluster_sums(x, plan, itemsize):
    """The kernel's order in plain fp32: each thread's rows in order, a
    butterfly over the row lanes of a warp, the warps in order, the ranks
    in order.  x: (rows, C) fp32 values (of the dtype of ``itemsize``)."""
    rows, c = x.shape
    vec = 16 // itemsize
    tx = plan.tile_c // vec                 # threads along C
    ty = plan.threads // tx                 # row lanes
    warp_rows = 32 // tx
    out = torch.zeros(2, c, dtype=torch.float32)
    for t in range(plan.channel_tiles):
        cols = slice(t * plan.tile_c, (t + 1) * plan.tile_c)
        ranks = []
        for r0, r1 in _row_blocks(plan, rows):
            blk = x[r0:r1, cols]
            steps = math.ceil(blk.shape[0] / ty)
            pad = torch.zeros(steps * ty, plan.tile_c)
            pad[:blk.shape[0]] = blk
            s = torch.zeros(ty, plan.tile_c)
            ss = torch.zeros(ty, plan.tile_c)
            for k in range(steps):
                v = pad[k * ty:(k + 1) * ty]
                s, ss = s + v, ss + v * v
            both = torch.stack([s, ss]).reshape(2, ty // warp_rows,
                                                warp_rows, plan.tile_c)
            off = 1
            while off < warp_rows:          # lane l takes l ^ off
                idx = torch.arange(warp_rows) ^ off
                both = both + both[:, :, idx]
                off *= 2
            warps = both[:, :, 0]
            acc = warps[:, 0]
            for w in range(1, warps.shape[1]):
                acc = acc + warps[:, w]
            ranks.append(acc)
        acc = ranks[0]
        for part in ranks[1:]:
            acc = acc + part
        out[:, cols] = acc
    return out[0], out[1]


@pytest.mark.parametrize("rows,c", [(256, 128), (72, 384), (24, 384),
                                    (8, 128), (2056, 256), (40, 1024)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_stats_cluster_order_matches_jax_kernel(rows, c, dtype):
    x = np.random.default_rng(rows * 7 + c).normal(0.5, 2.0, (rows, c)) \
        .astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    js, jss = jcf._batch_stats(jnp.asarray(x).astype(jd),
                               jcf._rows_block(rows))
    xt = torch.from_numpy(x).to(dtype).float()
    plan = tbn.stats_plan(rows, c, dtype)
    s, ss = _cluster_sums(xt, plan, dtype.itemsize)
    assert _rel(s, js) <= STATS_REL
    assert _rel(ss, jss) <= STATS_REL


# -- row 13: the pooling plan ---------------------------------------------------

@pytest.mark.parametrize("window,fixed", [
    ((2, 2, 2, 2), True), ((3, 3, 2, 2), True), ((3, 3, 1, 1), True),
    ((5, 5, 1, 1), False), ((3, 2, 2, 2), False), ((2, 2, 1, 1), False),
    ((3, 3, 1, 2), False), ((8, 8, 2, 2), False), ((1, 1, 1, 1), False)])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pool_plan_picks_the_window(window, fixed, dtype):
    kh, kw, sh, sw = window
    plan = tpool.pool_plan(4, 16, 16, 128, kh, kw, sh, sw, dtype)
    if fixed:
        assert plan.window == tpool.WINDOWS[window] != tpool.GENERIC_WINDOW
    else:
        assert plan.window == tpool.GENERIC_WINDOW
    assert plan.vec * dtype.itemsize == 16
    assert plan.threads in tpool.POOL_THREADS and plan.index_bits == 32


def _thread_outputs(n, ho, wo, c, plan):
    """The output values each thread of the plan writes, as the kernel
    maps a thread to (image, oy, ox, vector)."""
    idx = np.arange(plan.ctas * plan.threads, dtype=np.int64)
    idx = idx[idx < plan.total]
    groups = c // plan.vec
    pix, g = idx // groups, idx % groups
    row, ox = pix // wo, pix % wo
    img, oy = row // ho, row % ho
    first = ((img * ho + oy) * wo + ox) * c + g * plan.vec
    return (first[:, None] + np.arange(plan.vec)[None, :]).ravel()


@pytest.mark.parametrize("case", [
    (2, 16, 16, 128, 2, 2, 2, 2, 0, 0), (1, 15, 17, 256, 3, 3, 2, 2, 1, 1),
    (3, 9, 6, 128, 3, 3, 1, 1, 1, 1), (1, 9, 6, 136, 5, 5, 1, 1, 2, 2),
    (2, 7, 9, 128, 3, 2, 2, 2, 0, 1), (1, 4, 6, 8, 1, 2, 1, 2, 0, 1)],
    ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pool_plan_covers_each_output_once(case, dtype):
    n, h, w, c, kh, kw, sh, sw, ph, pw = case
    plan = tpool.pool_plan(n, h, w, c, kh, kw, sh, sw, dtype, ph, pw)
    ho, wo = plan.out_h, plan.out_w
    assert (ho, wo) == (jpool._out_hw(h, kh, sh, ph),
                        jpool._out_hw(w, kw, sw, pw))
    assert plan.total * plan.vec == n * ho * wo * c
    assert (plan.ctas - 1) * plan.threads < plan.total \
        <= plan.ctas * plan.threads
    hits = np.bincount(_thread_outputs(n, ho, wo, c, plan),
                       minlength=n * ho * wo * c)
    assert hits.shape == (n * ho * wo * c,) and (hits == 1).all()


@pytest.mark.parametrize("shape", VGG_POOLS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pool_plan_spreads_vgg_pools_over_the_card(shape, dtype):
    plan = tpool.pool_plan(*shape, 2, 2, 2, 2, dtype)
    assert plan.window == tpool.WINDOWS[(2, 2, 2, 2)]
    assert plan.ctas >= tpool.SMS
    if plan.threads != tpool.POOL_THREADS[0]:     # shrunk only to spread
        assert math.ceil(plan.total / (2 * plan.threads)) < tpool.MIN_CTAS


def test_pool_plan_indexes_in_64_bits_beyond_2_to_the_31():
    assert tpool.pool_plan(256, 256, 256, 128, 2, 2, 2, 2,
                           torch.float32).index_bits == 64     # 2 ** 31
    assert tpool.pool_plan(255, 256, 256, 128, 2, 2, 2, 2,
                           torch.float32).index_bits == 32


def _predicated_pool(x, kernel, stride, padding, mode):
    """The kernel's order in plain fp32: every tap of the window read first
    (a padding tap reads the fill value), then combined in (i, j) order by
    the kernel's rule (max: the tap where it is larger or NaN)."""
    n, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = jpool._out_hw(h, kh, sh, ph), jpool._out_hw(w, kw, sw, pw)
    fill = float("-inf") if mode == "max" else 0.0
    oy = torch.arange(ho)[:, None] * sh - ph
    ox = torch.arange(wo)[None, :] * sw - pw
    taps = []
    for i in range(kh):
        for j in range(kw):
            y, xx = oy + i, ox + j
            ok = ((y >= 0) & (y < h) & (xx >= 0) & (xx < w))
            v = x[:, y.clamp(0, h - 1), xx.clamp(0, w - 1), :]
            taps.append(torch.where(ok[None, :, :, None], v,
                                    torch.tensor(fill)))
    acc = torch.full((n, ho, wo, c), fill)
    for v in taps:
        if mode == "max":
            acc = torch.where((v > acc) | torch.isnan(v), v, acc)
        else:
            acc = acc + v
    if mode == "avg":
        acc = acc * torch.tensor(1.0 / (kh * kw), dtype=torch.float32)
    return acc


def _same(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert (np.isnan(got) == np.isnan(ref)).all()
    ok = ~np.isnan(ref)
    np.testing.assert_array_equal(got[ok], ref[ok])


@pytest.mark.parametrize("case", [
    (2, 8, 8, (2, 2), (2, 2), (0, 0)), (1, 9, 7, (3, 3), (2, 2), (1, 1)),
    (2, 6, 6, (3, 3), (1, 1), (1, 1)), (1, 9, 6, (5, 5), (1, 1), (2, 2)),
    (1, 7, 9, (3, 2), (2, 2), (0, 1))], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("nans", [False, True])
def test_pool_predicated_taps_match_jax_kernel(case, dtype, nans):
    n, h, w, kernel, stride, padding = case
    x = np.random.default_rng(h * 31 + w).standard_normal(
        (n, h, w, 128)).astype(np.float32)
    if nans:
        x[0, 1, 2, 5] = x[-1, h - 1, w - 1, 100] = np.nan
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xt = torch.from_numpy(x).to(dtype)
    ref_max = jpool.max_pool2d_nhwc(jnp.asarray(x).astype(jd), kernel,
                                    stride, padding)
    got = _predicated_pool(xt.float(), kernel, stride, padding, "max")
    _same(got.to(dtype).float(),
          np.asarray(ref_max.astype(jnp.float32)))
    got = _predicated_pool(xt.float(), kernel, stride, padding, "avg")
    _same(got.to(dtype).float(),
          tpool.avg_pool2d_nhwc_plain(xt, kernel, stride, padding).float())
