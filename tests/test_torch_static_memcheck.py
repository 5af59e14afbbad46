"""The port's static memory verifier (paddle_tpu_torch/static/memcheck.py)
against the JAX package's: tests/test_memcheck.py's programs (the fc tower
under SGD, Momentum and Adam, the conv / BN block, the embedding net) and
plans (none, dp2, ZeRO-2, donation), built in each package, give equal
``estimate_peak`` byte counts — peak, state, feed, out, temp, the high
water op and the whole per-op timeline — and the same MC diagnostics
(code, severity, location, variable, message, hint).  Declared int64 is
priced at the variable's dtype in both (int32: both packages resolve
64-bit types to 32)."""
import jax
import numpy as np
import pytest

from tests import torch_static_checks as K



@pytest.fixture
def eight_devices():
    """The JAX plans' mesh needs the 8 virtual CPU devices (decided when a
    test runs, not when the module is imported)."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")


needs_devices = pytest.mark.usefixtures("eight_devices")

FEEDS_FC = {"x": (16, 32), "y": (16, 1)}
FEEDS_CONV = {"img": (8, 3, 16, 16), "y": (8, 1)}
FEEDS_EMB = {"ids": (16, 16), "y": (16, 1)}


def _mc(S):
    import importlib

    return importlib.import_module(S.__name__ + ".memcheck")


def _estimates(builder, args, feeds, plan_kw=None, n=2):
    out = []
    for S in K.PKGS:
        main, _, loss = K.build(S, builder, *args)
        plan = K.plan(S, n, **plan_kw) if plan_kw is not None else None
        out.append(_mc(S).estimate_peak(main, plan, feeds=feeds,
                                        fetch_list=[loss.name]))
    return out


def _same(est_j, est_t):
    j, t = est_j.to_dict(), est_t.to_dict()
    for key in ("device_kind", "capacity_bytes"):
        assert t.pop(key) == j.pop(key), key
    assert t == j
    assert est_t.peak_bytes == est_j.peak_bytes > 0


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_fc_tower_estimate_equal(opt):
    _same(*_estimates(K.fc_tower, (opt,), FEEDS_FC))


def test_conv_block_estimate_equal():
    j, t = _estimates(K.conv_block, (), FEEDS_CONV)
    _same(j, t)
    # the backward region carries the peak in both
    bw = [b for _i, op, b in t.timeline if op == "backward_region"]
    assert bw and max(bw) == max(b for _i, _o, b in t.timeline)


def test_embedding_net_estimate_equal():
    _same(*_estimates(K.embedding_net, (), FEEDS_EMB))


@needs_devices
@pytest.mark.parametrize("opt,plan_kw", [
    ("sgd", {"donate": False}), ("momentum", {"zero_stage": 2,
                                              "donate": False}),
    ("adam", {"donate": True}), ("adam", {"zero_stage": 1})])
def test_planned_estimate_equal(opt, plan_kw):
    _same(*_estimates(K.fc_tower, (opt,), FEEDS_FC, plan_kw))


def _reports(builder, args, feeds, plan_kw=None, n=2, **kw):
    out = []
    for S in K.PKGS:
        main, _, loss = K.build(S, builder, *args)
        if builder is K.fc_tower and kw.pop("orphan", False):
            with S.program_guard(main):
                S.layers.create_parameter([256, 256], name="orphan_w")
            kw["orphan"] = True
        plan = K.plan(S, n, **plan_kw) if plan_kw is not None else None
        vkw = {k: v for k, v in kw.items() if k != "orphan"}
        out.append(_mc(S).verify_memory(main, plan, feeds=feeds,
                                        fetch_list=[loss.name], **vkw))
    return out


CASES = {
    "mc001": (K.fc_tower, ("sgd",), FEEDS_FC, None,
              {"capacity_bytes": 1024}, {"MC001"}),
    "mc002": (K.wide, (4096, 2176), {"x": (16, 4096), "y": (16, 1)},
              {"donate": False}, {}, {"MC002"}),
    "mc003": (K.embedding_net, (65536,), FEEDS_EMB, None, {}, {"MC003"}),
    "mc003_sparse": (K.embedding_net, (65536, True), FEEDS_EMB, None, {},
                     set()),
    "mc004": (K.wide, (2048, 2048, "adam"), {"x": (16, 2048),
                                             "y": (16, 1)},
              {"zero_stage": 0}, {}, {"MC004"}),
    "mc004_zero2": (K.wide, (2048, 2048, "adam"), {"x": (16, 2048),
                                                   "y": (16, 1)},
                    {"zero_stage": 2}, {}, set()),
    "mc005": (K.fc_tower, ("sgd",), FEEDS_FC, None, {"orphan": True},
              {"MC005"}),
    "mc006": (K.fc_tower, ("sgd",), FEEDS_FC, None,
              {"bucket_edges": (16,), "max_live_programs": 4,
               "capacity_bytes": 2 * 90456}, {"MC006"}),
}


@needs_devices
@pytest.mark.parametrize("name", sorted(CASES))
def test_same_mc_diagnostics(name):
    builder, args, feeds, plan_kw, kw, codes = CASES[name]
    jrep, trep = _reports(builder, args, feeds, plan_kw, **kw)
    assert K.diag_keys(trep.diagnostics) == K.diag_keys(jrep.diagnostics)
    _same(jrep.mem, trep.mem)
    assert {d.code for d in trep.diagnostics} == codes


@pytest.mark.parametrize("blocks,existing,cap", [
    (64, 0, 1 << 20), (64, 0, 1 << 30), (64, 900_000, 1 << 20)])
def test_check_kv_pool_same_mc008(blocks, existing, cap):
    from paddle_tpu.static import memcheck as jmc
    from paddle_tpu_torch.static import memcheck as tmc

    args = (blocks, 16, 64, "float32", existing, cap)
    assert K.diag_keys(tmc.check_kv_pool(*args)) == \
        K.diag_keys(jmc.check_kv_pool(*args))


def test_capacity_precedence_and_the_cpu():
    """arg > memcheck_capacity_gb flag > the card; None on a host with no
    card, so MC001 stays quiet there."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.static import memcheck as tmc

    assert tmc._hbm_capacity(None) == (None, "cpu")
    assert tmc._hbm_capacity(123) == (123, "cpu")
    saved = flags.get_flag("memcheck_capacity_gb")
    flags.set_flags({"memcheck_capacity_gb": 0.5})
    try:
        assert tmc._hbm_capacity(None) == (1 << 29, "cpu")
        assert tmc._hbm_capacity(7) == (7, "cpu")
    finally:
        flags.set_flags({"memcheck_capacity_gb": saved})


def test_mc007_waits_for_the_sharded_embedding():
    """The port's plans cannot ask for embedding_shard yet (item 9b)."""
    from paddle_tpu_torch.parallel.sharding import ShardingPlan

    with pytest.raises(NotImplementedError, match="9b"):
        ShardingPlan(embedding_shard="mp")

