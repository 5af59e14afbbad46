"""The int8 kernels' host side (rows 14 and 15), on the CPU: the tile and
K-split plans that mirror the C entries, the K-major weight layouts the
wrappers keep per weight version, and the quant lowerings' int8 weight
cache.

* ``matmul_plan`` / ``conv_plan`` cover every K unit exactly once over the
  splits, never launch more than one wave, and give the grids measured best
  on the H100 at VGG-16's small layers (PERF.md, section 6).
* ``matmul_weight`` / ``conv_weight`` equal ``t()`` / ``permute`` of the
  weight, contiguous, the same tensor while the weight is unchanged and a
  new one after an in-place update.
* ``quant_conv2d`` / ``quant_mul`` keep the Filter's int8 grid and combined
  scale per Filter version and quant attrs: equal to the per-call values,
  reused while the Filter is unchanged, rebuilt after an in-place update,
  and the ops' outputs unchanged.
"""
import itertools

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import int8 as tint8
from paddle_tpu_torch.static.ops_tail import qmax
from paddle_tpu_torch.static.registry import get_lowering

SMS = tint8.H100_SMS


def _units_once(plan):
    """Every K unit in exactly one split, each split non-empty."""
    seen = []
    for split in range(plan.splits):
        u0, u1 = plan.split_units(split)
        assert u1 > u0
        seen.extend(range(u0, u1))
    assert seen == list(range(plan.units))


def _one_wave(plan):
    grid = tint8.grid_ctas(plan)
    assert 1 <= grid <= SMS
    if plan.splits > 1:
        # a split plan never needs a second wave, and the cost model
        # prefers it to no split
        assert plan.ctas <= SMS and plan.tiles < SMS
        assert plan.splits <= tint8.MAX_SPLITS
        n = plan.tiles // -(-plan.m // tint8.BLOCK_M) * tint8.BLOCK_N
        assert tint8.split_cost_us(plan.m, n, plan.units, plan.splits) \
            < tint8.split_cost_us(plan.m, n, plan.units, 1)


def _conv_shapes():
    """Every (n, h, w, c, o, k, s, p) of a small grid that the JAX gate
    admits (C % 128), plus the C % 128 == 64 shapes the wrapper takes."""
    for n, hw, c, o, k, s, p in itertools.product(
            (1, 2, 8, 32, 128), (2, 4, 7, 8, 16, 32), (64, 128, 192, 256,
                                                      512),
            (128, 256, 512), (1, 3, 5, 7), (1, 2), (0, 1, 3)):
        x = torch.empty((n, hw, hw, c), dtype=torch.int8, device="meta")
        gate = tint8.conv_supported(x, (o, c, k, k), (s, s), (p, p))
        if c % 128 and (hw + 2 * p - k) // s + 1 >= 1:
            gate = True   # the wrapper's own shapes beyond the JAX gate
        if gate:
            yield n, hw, hw, c, o, k, s, p


def test_conv_plan_covers_every_unit_once_within_one_wave():
    planned = 0
    for n, h, w, c, o, k, s, p in _conv_shapes():
        plan = tint8.conv_plan(n, h, w, c, o, k, k, s, s, p, p)
        out = (h + 2 * p - k) // s + 1
        assert plan.m == n * out * out
        assert plan.units == k * k * -(-c // tint8.UNIT_K)
        assert plan.tiles == -(-plan.m // tint8.BLOCK_M) \
            * (o // tint8.BLOCK_N)
        _units_once(plan)
        _one_wave(plan)
        if plan.tiles >= SMS:
            assert plan.splits == 1
        planned += 1
    assert planned > 1000


def test_matmul_plan_covers_every_unit_once_within_one_wave():
    planned = 0
    for m, k, n in itertools.product((8, 40, 128, 512, 1000, 4096),
                                     (64, 128, 192, 512, 768, 3072),
                                     (128, 256, 512, 3072)):
        plan = tint8.matmul_plan(m, n, k)
        assert plan.units == -(-k // tint8.UNIT_K)
        assert plan.tiles == -(-m // tint8.BLOCK_M) * (n // tint8.BLOCK_N)
        _units_once(plan)
        _one_wave(plan)
        planned += 1
    assert planned == 6 * 6 * 4


@pytest.mark.parametrize("hw,c,splits", [(2, 512, 6), (4, 512, 2),
                                         (4, 256, 1)])
def test_conv_plan_gives_the_measured_grid_at_vgg_small_layers(hw, c,
                                                               splits):
    """VGG-16's b128 layers whose output tiles leave half the card idle or
    more: the split counts are the fastest measured on the H100
    (experiments/int8_experiments.py splits; 6 splits, 96 CTAs, beat 8
    with 128 at 2x2, and the 256-channel 4x4 layer runs faster unsplit)."""
    plan = tint8.conv_plan(128, hw, hw, c, 512, 3, 3, 1, 1, 1, 1)
    assert plan.tiles < SMS and plan.splits == splits
    assert plan.ctas == plan.tiles * splits <= SMS
    _units_once(plan)


def test_plans_leave_full_layers_and_vgg_fc_unsplit():
    # 16x16 (256 tiles) and 8x8 (128 tiles) layers; VGG's fc (4 tiles of
    # 4 units) and the FFN shape (768 tiles)
    for c, o, hw in ((128, 128, 16), (128, 256, 8), (256, 256, 8)):
        plan = tint8.conv_plan(128, hw, hw, c, o, 3, 3, 1, 1, 1, 1)
        assert plan.splits == 1
    assert tint8.matmul_plan(128, 512, 512).splits == 1
    ffn = tint8.matmul_plan(4096, 3072, 768)
    assert ffn.splits == 1 and tint8.grid_ctas(ffn) == SMS


@pytest.mark.parametrize("kind", ["matmul", "conv"])
def test_int8_weight_layout_is_cached_per_weight_version(kind):
    rng = np.random.default_rng(3)
    if kind == "matmul":
        shape, layout, view = (192, 256), tint8.matmul_weight, \
            (lambda w: w.t())
    else:
        shape, layout, view = (128, 64, 3, 3), tint8.conv_weight, \
            (lambda w: w.permute(0, 2, 3, 1))
    w = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    first = layout(w)
    assert first.is_contiguous() and torch.equal(first, view(w))
    assert layout(w) is first
    with torch.no_grad():
        w.neg_()
    again = layout(w)
    assert again is not first and torch.equal(again, view(w))


def _quant_attrs(rng, n_out, **extra):
    return dict(in_scale=float(rng.uniform(0.5, 2.0)), in_bits=8,
                weight_bits=8,
                weight_scale=[float(v) for v in rng.uniform(0.1, 1.0,
                                                            n_out)],
                **extra)


def _simulated(rng, shape, scales, axis):
    """An int8-simulated weight (q / 127 * scale, q integral), as PTQ
    leaves it in the scope."""
    q = rng.integers(-127, 128, shape).astype(np.float32)
    view = [1] * len(shape)
    view[axis] = -1
    return torch.from_numpy(q / 127.0 * np.asarray(
        scales, np.float32).reshape(view))


def _per_call(w, attrs, shape, axis):
    """The per-call int8 grid and combined scale (the JAX lowering's
    arithmetic)."""
    w_scale = torch.tensor(attrs["weight_scale"], dtype=torch.float32)
    step = w_scale / qmax(attrs["weight_bits"])
    view = [1] * len(shape)
    view[axis] = -1
    w_q = torch.round(w.reshape(shape) / step.reshape(view)).to(torch.int8)
    return w_q, (attrs["in_scale"] / qmax(attrs["in_bits"])) * step


@pytest.mark.parametrize("op_type", ["quant_conv2d", "quant_mul"])
def test_quant_lowering_caches_the_int8_weight_per_filter_version(op_type):
    rng = np.random.default_rng(7)
    if op_type == "quant_conv2d":
        attrs = _quant_attrs(rng, 128, data_format="NHWC", strides=[1, 1],
                             paddings=[1, 1], dilations=[1, 1], groups=1,
                             act="relu")
        w = _simulated(rng, (128, 128, 3, 3), attrs["weight_scale"], 0)
        x = torch.from_numpy(rng.standard_normal((2, 5, 6, 128))
                             .astype(np.float32))
        ins = {"Input": [x], "Filter": [w], "Bias": []}
        slot, shape, axis = "Output", tuple(w.shape), 0
    else:
        attrs = _quant_attrs(rng, 256, act="relu")
        w = _simulated(rng, (128, 256), attrs["weight_scale"], 1)
        x = torch.from_numpy(rng.standard_normal((8, 128))
                             .astype(np.float32))
        ins = {"X": [x], "Y": [w]}
        slot, shape, axis = "Out", tuple(w.shape), 1
    lower = get_lowering(op_type)
    first = lower(ins, attrs, None)[slot][0]
    w_q, scale = w._quant_int8[1]
    ref_q, ref_scale = _per_call(w, attrs, shape, axis)
    assert torch.equal(w_q, ref_q) and torch.equal(scale, ref_scale)
    assert w_q.abs().max() > 100   # the grid, not a rounding of it

    again = lower(ins, attrs, None)[slot][0]
    assert w._quant_int8[1][0] is w_q and torch.equal(again, first)

    with torch.no_grad():
        w.mul_(-1.0)                       # an in-place update
    updated = lower(ins, attrs, None)[slot][0]
    new_q, new_scale = w._quant_int8[1]
    assert new_q is not w_q
    assert torch.equal(new_q, _per_call(w, attrs, shape, axis)[0])
    assert torch.equal(new_q, -w_q) and torch.equal(new_scale, scale)
    assert not torch.equal(updated, first)

    other = dict(attrs, weight_scale=[v * 2 for v in attrs["weight_scale"]])
    lower(ins, other, None)
    assert torch.equal(w._quant_int8[1][0],
                       _per_call(w, other, shape, axis)[0])
