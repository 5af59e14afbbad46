"""The static graph's op tail beyond one-op programs: the c_* collectives
on the shared 2-rank gloo job against the sum, max, min or product of the
ranks' inputs (and sync_batch_norm against the JAX package's batch norm
over the whole batch), the PS push ops' effect on the table against the
JAX package's, and Faster R-CNN R50-FPN's proposal and target stage
(tests/torch_static_fpn.py) at a small size — one image, P2-P3 of 16x24 —
through both Executors from the same weights.  Deterministic fetches
agree exactly (integers, counts, level routing) or within 1e-5 of the
largest magnitude (scores, boxes, RoI features); the sampled targets are
held by their invariants."""
import numpy as np
import pytest

import paddle_tpu.static as jstatic
import paddle_tpu_torch.static as tstatic
from paddle_tpu_torch import convert
from tests import torch_parallel_job as J
from tests import torch_parallel_worker as W
from tests import torch_static_cases as T
from tests import torch_static_fpn as F

RANKS = (0, 1)


@pytest.fixture(scope="module")
def static2():
    out, rc, log = J.shared_job("static2", 2, ["static_collectives"])
    assert rc == 0, log[-4000:]
    return [J.result(out, "static_collectives", r) for r in RANKS]


def _xs():
    return [J.rank_array(r, (4, 6), seed=30) for r in RANKS]


def _expected(op_type, attrs, rank):
    xs = _xs()
    x = xs[rank]
    if op_type in ("c_allreduce_sum",) or (op_type == "allreduce"
                                           and attrs["reduce_type"] == 0):
        return xs[0] + xs[1]
    if op_type == "c_allreduce_max" or op_type == "allreduce":
        return np.maximum(xs[0], xs[1])
    if op_type == "c_allreduce_min":
        return np.minimum(xs[0], xs[1])
    if op_type == "c_allreduce_prod":
        return xs[0] * xs[1]
    if op_type == "c_allgather":
        return np.concatenate(xs, 0)
    if op_type == "c_reducescatter":
        return (xs[0] + xs[1])[2 * rank:2 * rank + 2]
    if op_type in ("c_broadcast", "broadcast"):
        return xs[attrs["root"]]
    if op_type == "c_reduce_sum":
        return xs[0] + xs[1] if rank == attrs["root_id"] else x
    if op_type == "c_reduce_prod":
        return xs[0] * xs[1] if rank == attrs["root_id"] else x
    if op_type == "c_scatter":
        return xs[attrs["root"]][2 * rank:2 * rank + 2]
    return x                      # barrier, comm init, stream syncs


@pytest.mark.parametrize("k", range(len(W.STATIC_COLL)))
@pytest.mark.parametrize("rank", RANKS)
def test_static_collective_on_two_ranks(static2, k, rank):
    op_type, attrs = W.STATIC_COLL[k]
    got = static2[rank][f"{k}_{op_type}"]
    want = _expected(op_type, attrs, rank)
    if attrs.get("compress") == "int8":
        # block-quantized payload: within one quantization step a block
        assert np.abs(got - want).max() <= 2 * np.abs(want).max() / 127
        return
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if op_type == "c_allreduce_prod":
        assert (np.sign(got) == np.sign(want)).all()


def test_static_sync_batch_norm_is_the_whole_batch_norm(static2, tmp_path):
    """Each rank's Y is its rows of the JAX package's batch norm over both
    ranks' batches (one device, the full batch); the running stats agree."""
    w, b = W.bn_params()
    full = np.concatenate([J.rank_array(r, J.BN_SHAPE, seed=11)
                           for r in RANKS])
    case = T.Case("sync_batch_norm",
                  {"X": full, "Scale": w, "Bias": b,
                   "Mean": np.zeros(3, np.float32),
                   "Variance": np.ones(3, np.float32)}, {"is_test": False},
                  outs=("Y", "MeanOut", "VarianceOut"))
    want, _ = T.run(case, jstatic, tmp_path)
    n = J.BN_SHAPE[0]
    for r in RANKS:
        np.testing.assert_allclose(static2[r]["bn_Y"],
                                   want["Y"][0][r * n:(r + 1) * n],
                                   rtol=1e-4, atol=1e-5)
        for slot in ("MeanOut", "VarianceOut"):
            np.testing.assert_allclose(static2[r][f"bn_{slot}"],
                                       want[slot][0], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("op_type", ["push_sparse", "push_sparse_v2"])
def test_push_sparse_moves_the_table_alike(op_type, tmp_path):
    import importlib

    case = T.Case(op_type, {"Ids": np.array([3, 5, 3], np.int32),
                            "Grads": T.f(3, 4)},
                  {"table_name": "emb", "lr": 0.5}, bind=T._ps_table)
    rows = []
    for S in (jstatic, tstatic):
        T.run(case, S, tmp_path / S.__name__,
              place=None if S is jstatic else "cpu")
        table = importlib.import_module(
            S.__name__ + ".ops_tail2")._PS_TABLES["emb"]
        rows.append(table.pull(np.array([3, 5, 7])))
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-6)
    fresh = importlib.import_module(
        "paddle_tpu_torch.distributed.ps").SparseTable(
            dim=4, num_shards=2, optimizer="sgd", seed=9)
    assert not np.allclose(rows[1][:2], fresh.pull(np.array([3, 5])))


# -- Faster R-CNN R50-FPN's proposal and target stage, small -------------------

SMALL = dict(n_images=1, height=64, width=96, levels=(2, 3), channels=8,
             roi_levels=(2, 3), rpn_batch=64, roi_batch=32)


def _stage(S, train=True):
    main, start = S.Program(), S.Program()
    main.random_seed = start.random_seed = 3
    with S.program_guard(main, start):
        out = F.build(S, train=train, **SMALL)
    return main, start, out


@pytest.fixture(scope="module")
def fpn_runs():
    feed = F.inputs(11, SMALL["n_images"], SMALL["height"], SMALL["width"],
                    SMALL["levels"], SMALL["channels"], max_gt=6)
    jmain, jstart, jout = _stage(jstatic)
    tmain, _, tout = _stage(tstatic)
    jscope = jstatic.Scope()
    jstatic.Executor().run(jstart, scope=jscope)
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    names = sorted(jout)
    jgot = dict(zip(names, jstatic.Executor().run(
        jmain, feed=feed, fetch_list=[jout[n] for n in names],
        scope=jscope)))
    tgot = dict(zip(names, tstatic.Executor("cpu").run(
        tmain, feed=feed, fetch_list=[tout[n] for n in names],
        scope=tscope)))
    return feed, jgot, tgot


DETERMINISTIC = ("scores", "rois", "probs", "num", "fpn_rois", "fpn_num",
                 "level_num", "restore", "roi_feat", "all_anchors")


def test_fpn_stage_deterministic_fetches_match(fpn_runs):
    _feed, jgot, tgot = fpn_runs
    checked = 0
    for name in sorted(jgot):
        if not name.startswith(DETERMINISTIC):
            continue
        g, w = np.asarray(tgot[name]), np.asarray(jgot[name])
        assert g.shape == w.shape, name
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            err = np.abs(g - w).max() if w.size else 0.0
            assert err <= 1e-5 * max(np.abs(w).max(), 1.0), (name, err)
        checked += 1
    assert checked >= 14
    # the proposal stage did real work: proposals kept, rois routed
    assert int(np.asarray(tgot["fpn_num_0"]).sum()) > 50
    # every roi with an extent is routed (a box clipped to a point is not)
    routed = int(np.asarray(tgot["level_num_0"]).sum())
    assert 0.9 * int(np.asarray(tgot["fpn_num_0"])) <= routed <= \
        int(np.asarray(tgot["fpn_num_0"]))


def test_fpn_stage_targets_hold_their_invariants(fpn_runs):
    feed, jgot, tgot = fpn_runs
    for got in (jgot, tgot):
        s = F.check_targets(got, feed, SMALL["n_images"],
                            SMALL["rpn_batch"], SMALL["roi_batch"])
        assert s["rpn_fg"][0] > 0 and s["rcnn_fg"][0] > 0


def test_fpn_stage_test_settings_run_alike():
    """The test-time proposal settings (1000 / 1000) through the port's
    Executor: the same deterministic proposals as the JAX Executor."""
    feed = F.inputs(5, 1, 64, 96, (2, 3), 8, max_gt=3)
    res = []
    for S in (jstatic, tstatic):
        main, start, out = _stage(S, train=False)
        res.append((S, main, start, out))
    (_, jmain, jstart, jout), (_, tmain, _, tout) = res
    jscope = jstatic.Scope()
    jstatic.Executor().run(jstart, scope=jscope)
    state = {k: np.asarray(jscope.find_var(k)) for k in jscope.keys()}
    tscope = convert.static_state_from_jax(jmain, state, tmain, "cpu")
    names = ["fpn_rois_0", "fpn_num_0", "restore_0"]
    j = jstatic.Executor().run(jmain, feed=feed,
                               fetch_list=[jout[n] for n in names],
                               scope=jscope)
    t = tstatic.Executor("cpu").run(tmain, feed=feed,
                                    fetch_list=[tout[n] for n in names],
                                    scope=tscope)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
