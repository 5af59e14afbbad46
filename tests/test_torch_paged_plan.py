"""The paged-attention kernel's host side (row 9), on the CPU: the plan that
the wrapper hands the C entry, and the split-and-merge algebra of the
kernel against the JAX package's Pallas kernel.

* ``paged_plan`` fills at least one wave of CTAs for a 64-row decode step
  at the server's live widths, gives a prefill chunk's stride-0 table the
  cheaper of its two routes under the cost model (one row group where the
  shared-table CTA group wins, as for fp32 caches on wide tables; else the
  decode step's one-row plan), keeps every split non-empty at the full
  table width, stays within the C entry's limits (constants read from the
  source), and takes no lengths.
* The partials' scratch is a new tensor each call: nothing outlives a call
  that a CUDA graph could have captured.
* ``tile_geometry`` tiles every block shape the wrapper accepts within
  one shared-memory slot, so the kernel takes every such shape.
* The algebra: each split's partial (m, l, acc) over its tiles' positions,
  in plain fp32 arithmetic (int8: the scales out of the dots, as the
  kernel does), combined in split order, against the JAX
  ``paged_attention_kernel`` in interpret mode (the JAX package's own CPU
  route) at rtol = atol = 2e-5, for decode-like and stride-0 inputs made
  from a numpy seed, at the plan's split count and at every other one.
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

SOURCE = (Path(tpa.__file__).parent / "csrc" / f"{tpa.SOURCE}.cu").read_text()
TOL = 2e-5
SMS = tpa.H100_SMS
ELTS = (4, 2, 1)   # fp32, bf16, int8 caches


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_wrapper_constants_are_the_c_entrys():
    for py, c in (("MAX_DIM", "kMaxDim"), ("MAX_BLOCK_SIZE", "kMaxBlockSize"),
                  ("SLOT_BYTES", "kSlotBytes"),
                  ("MAX_TILE_TOKENS", "kMaxTileTokens"),
                  ("SHARED_TILE_TOKENS", "kSharedTileTokens"),
                  ("MAX_TILE_COPIES", "kMaxTileCopies"),
                  ("ROW_WARPS", "kRowWarps"), ("SHARED_WARPS", "kSharedWarps"),
                  ("ROWS_PER_LANE", "kRowsPerLane"),
                  ("SHARED_COLS", "kSharedCols"), ("MAX_SPLITS", "kMaxSplits"),
                  ("WINDOW", "kWindow")):
        assert getattr(tpa, py) == _constant(c), py


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("elt", ELTS)
def test_decode_step_fills_one_wave(width, elt):
    plan = tpa.paged_plan(64, width, 16, 128, elt, False)
    assert plan.row_groups == 64 and plan.rows_per_cta == 1
    assert plan.row_groups * plan.splits >= SMS
    assert not plan.shared_tile


@pytest.mark.parametrize("width", [64, 128])
def test_prefill_chunk_is_one_row_group(width):
    # fp32 caches on the server's wide chunk tables: the shared-table route
    plan = tpa.paged_plan(64, width, 16, 128, 4, True)
    assert plan.shared_tile
    assert plan.rows_per_cta == 64 and plan.row_groups == 1
    assert plan.splits > 1             # merged over the rows


@pytest.mark.parametrize("width", [4, 16, 64, 128, 256])
@pytest.mark.parametrize("elt", ELTS)
def test_prefill_chunk_takes_the_cheaper_route(width, elt):
    plan = tpa.paged_plan(64, width, 16, 128, elt, True)
    costs = {tile: tpa.route_plan(64, width, 16, 128, elt, tile)
             for tile in (False, True)}
    assert plan == min(costs.values(), key=lambda cp: cp[0])[1]
    if not plan.shared_tile:   # one-row groups on the stride-0 table
        assert plan == tpa.paged_plan(64, width, 16, 128, elt, False)
    if width <= 16:   # narrow tables: the one-row kernel, any cache type
        assert not plan.shared_tile


def test_wide_calls_take_few_splits():
    # the 256-row timed shape fills the card without splitting much
    for elt in ELTS:
        plan = tpa.paged_plan(256, 128, 16, 128, elt, False)
        assert plan.splits <= 4


def _shapes():
    for rows in (1, 3, 64, 256):
        for width in (1, 3, 64, 128, 256, 1000):
            for bs in (1, 8, 16, 24, 64):
                for d in (32, 96, 128, 256):
                    for elt in ELTS:
                        for shared in (False, True):
                            yield rows, width, bs, d, elt, shared


def test_every_split_non_empty_at_full_width_and_within_limits():
    for rows, width, bs, d, elt, shared in _shapes():
        plan = tpa.paged_plan(rows, width, bs, d, elt, shared)
        assert shared or not plan.shared_tile
        tt, ct, copies, tiles = tpa.tile_geometry(d, elt, bs, width,
                                                  plan.shared_tile)
        assert (plan.tile_tokens, plan.copy_tokens, plan.copies,
                plan.tiles) == (tt, ct, copies, tiles)
        assert 1 <= plan.splits <= tpa.MAX_SPLITS
        assert plan.tiles_per_split == -(-tiles // plan.splits)
        # the C entry's check: every split starts below the full width
        assert (plan.splits - 1) * plan.tiles_per_split < tiles
        assert plan.splits * plan.tiles_per_split >= tiles
        assert plan.row_groups == -(-rows // plan.rows_per_cta)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("elt", ELTS)
def test_tiles_fit_a_slot_for_every_accepted_block(elt, shared):
    most = tpa.SHARED_TILE_TOKENS if shared else tpa.MAX_TILE_TOKENS
    for bs in range(1, tpa.MAX_BLOCK_SIZE + 1):
        for d in range(32, tpa.MAX_DIM + 1, 32):
            tt, ct, copies, tiles = tpa.tile_geometry(d, elt, bs, 7, shared)
            assert tt * d * elt <= tpa.SLOT_BYTES and tt <= most
            assert 1 <= copies <= tpa.MAX_TILE_COPIES and tt == ct * copies
            assert (bs % tt == 0) if tt < bs else (tt % bs == 0)
            assert tiles * tt >= 7 * bs > (tiles - 1) * tt   # covers it
            assert (d * elt) % 16 == 0                 # bulk copies' unit


def test_plan_takes_shapes_only():
    params = list(inspect.signature(tpa.paged_plan).parameters)
    assert params == ["num_seqs", "max_blocks", "block_size", "d", "kv_elt",
                      "shared", "sms"]
    assert hasattr(tpa.paged_plan, "cache_info")        # cached per shape


@pytest.mark.parametrize("shared", [False, True])
def test_workspace_is_new_each_call(shared):
    plan = tpa.paged_plan(64, 128, 16, 128, 4, shared)
    assert plan.splits > 1
    a = tpa._workspace(plan, 64, 128, "cpu")
    b = tpa._workspace(plan, 64, 128, "cpu")
    assert a.dtype == torch.float32 and a.numel() == 64 * plan.splits * 130
    assert a.data_ptr() != b.data_ptr()
    one = tpa.paged_plan(4, 1, 16, 128, 4, shared)
    assert one.splits == 1 and tpa._workspace(one, 4, 128, "cpu") is None
    # no buffer kept in the module, no counter in the kernel
    assert not any(isinstance(v, torch.Tensor) for v in vars(tpa).values())
    assert "atomicAdd" not in SOURCE


def test_supported_still_covers_the_slice():
    assert tpa.supported(64, 16, 128, torch.float32)
    assert tpa.supported(64, 16, 128, torch.int8)
    assert tpa.supported(64, 16, 128, torch.bfloat16)
    assert tpa.supported(256, 64, 256, torch.float32)
    assert tpa.supported(4, 1, 32, torch.int8)
    for bad in ((4, 8, 48), (4, 65, 128), (4, 8, 288), (4, 0, 128)):
        assert not tpa.supported(*bad, torch.float32)
    assert not tpa.supported(4, 8, 128, torch.float16)


def test_wrapper_still_raises_where_it_did():
    q = torch.zeros(4, 32)
    k = torch.zeros(5, 8, 32)
    tb = torch.zeros(4, 2, dtype=torch.int32)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.paged_attention(*(t.to("meta") for t in (q, k, k, tb, lens)))
    with pytest.raises(ValueError, match="kv_scales"):
        tpa.paged_attention(q, k.to(torch.int8), k.to(torch.int8), tb, lens)
    with pytest.raises(ValueError, match="d="):
        tpa.paged_attention(torch.zeros(4, 64), k, k, tb, lens)
    with pytest.raises(ValueError, match="block_tables"):
        tpa.paged_attention(q, k, k, tb[:3], lens)


# -- the split-and-merge algebra ----------------------------------------------

def _case(seed, rows, width, bs, d, shared, int8):
    rng = np.random.default_rng(seed)
    n_tab = width if shared else rows * width
    nb = n_tab + 1
    if int8:
        k, v = (rng.integers(-127, 128, (nb, bs, d)).astype(np.int8)
                for _ in range(2))
        scales = rng.uniform(0.01, 0.1, (nb, 2)).astype(np.float32)
    else:
        k, v = (rng.normal(size=(nb, bs, d)).astype(np.float32)
                for _ in range(2))
        scales = None
    q = rng.normal(size=(rows, d)).astype(np.float32)
    tab = (rng.permutation(nb - 1)[:n_tab] + 1).astype(np.int32)
    tables = (np.broadcast_to(tab.reshape(1, width), (rows, width))
              if shared else tab.reshape(rows, width))
    if shared:
        start = int(rng.integers(0, width * bs - rows + 1))
        lens = np.arange(start + 1, start + rows + 1, dtype=np.int32)
    else:
        lens = rng.integers(0, width * bs + 1, rows).astype(np.int32)
        lens[0] = 0
    return q, k, v, np.ascontiguousarray(tables), lens, scales


def _split_merge(q, k, v, tables, lens, scales, sm, plan, bs):
    """The kernel's arithmetic per split (partials over the split's tiles'
    positions, each row masked by its own length; a group's splits counted
    from its longest row), combined in split order."""
    rows, d = q.shape
    width = tables.shape[1]
    tt, tps = plan.tile_tokens, plan.tiles_per_split
    q = torch.from_numpy(q)
    out = torch.zeros(rows, d)
    for g in range(plan.row_groups):
        members = range(g * plan.rows_per_cta,
                        min((g + 1) * plan.rows_per_cta, rows))
        glen = max(min(int(lens[r]), width * bs) for r in members)
        ntl = -(-glen // tt)
        nw = -(-ntl // tps)
        for r in members:
            length = min(int(lens[r]), width * bs)
            parts = []
            for s in range(max(nw, 1)):
                lo = s * tps * tt
                hi = min(min((s + 1) * tps, ntl) * tt, length)
                pos = np.arange(lo, max(lo, hi))
                bid = tables[r, pos // bs]
                kk = torch.from_numpy(k[bid, pos % bs].astype(np.float32))
                vv = torch.from_numpy(v[bid, pos % bs].astype(np.float32))
                if scales is not None:   # the scales out of the dots
                    ks = torch.from_numpy(scales[bid, 0]) * sm
                    vs = torch.from_numpy(scales[bid, 1])
                    sc = (kk @ q[r]) * ks
                else:
                    vs = torch.ones(len(pos))
                    sc = (kk @ q[r]) * sm
                if len(pos) == 0:
                    parts.append((tpa.NEG_INF, torch.tensor(0.0),
                                  torch.zeros(d)))
                    continue
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m, p.sum(), (p * vs) @ vv))
            mx = max(float(m) for m, _, _ in parts)
            den, acc = torch.tensor(0.0), torch.zeros(d)
            for m, l, a in parts:            # split order
                f = torch.exp(torch.tensor(float(m) - mx))
                den = den + l * f
                acc = acc + a * f
            out[r] = acc / torch.clamp(den, min=1e-30)
    return out.numpy()


def _jax_kernel(q, k, v, tables, lens, scales, sm):
    kw = {} if scales is None else {"kv_scales": jnp.asarray(scales)}
    return np.asarray(jpa.paged_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), sm_scale=sm, **kw), np.float32)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_split_merge_matches_jax_kernel(shared, int8):
    rows, width, bs, d = (6, 16, 8, 128)
    case = _case(31 + 2 * shared + int8, rows, width, bs, d, shared, int8)
    sm = 0.088
    ref = _jax_kernel(*case, sm)
    plan = tpa.paged_plan(rows, width, bs, d, 1 if int8 else 4, shared)
    tiles = plan.tiles
    assert tiles > 3
    for splits in sorted({plan.splits, 1, 2, 3, tiles}):
        tps = -(-tiles // splits)
        forced = plan._replace(splits=-(-tiles // tps), tiles_per_split=tps)
        got = _split_merge(*case, sm, forced, bs)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   err_msg=f"{splits} splits")
        assert np.all(got[case[4] == 0] == 0.0)


def test_splits_cover_each_position_once():
    for rows, width, bs, d, elt, shared in _shapes():
        plan = tpa.paged_plan(rows, width, bs, d, elt, shared)
        full = width * bs
        covered = []
        ntl = -(-full // plan.tile_tokens)
        for s in range(-(-ntl // plan.tiles_per_split)):
            lo = s * plan.tiles_per_split * plan.tile_tokens
            hi = min(min((s + 1) * plan.tiles_per_split, ntl)
                     * plan.tile_tokens, full)
            covered.extend(range(lo, hi))
        assert covered == list(range(full))
