"""The port's sharding-plan verifier (paddle_tpu_torch/static/shardcheck.py)
against the JAX package's: tests/test_shardcheck.py's programs and plans,
built in each package (the plan on each package's mesh of the same
sizes), give the same SC diagnostics — code, severity, location, variable,
message and hint, exactly — and the same ``estimate_comm`` bytes, bucket by
bucket.  ``comm_quantize='fp8'`` is judged by what each package's
``compress`` supports; both support it here, so the reports agree."""
import jax
import pytest

from tests import torch_static_checks as K



@pytest.fixture
def eight_devices():
    """The JAX plans' mesh needs the 8 virtual CPU devices (decided when a
    test runs, not when the module is imported)."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")


needs_devices = pytest.mark.usefixtures("eight_devices")


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    yield
    from paddle_tpu.parallel import mesh as jmesh
    from paddle_tpu_torch.parallel import mesh as tmesh

    jmesh.set_mesh(None)
    tmesh.set_mesh(None)


def _tower_extra(S, L, hidden=12, extra=None):
    loss = K.tower(S, L, hidden)
    if extra:
        extra(S, L, S.default_main_program())
    return loss


def _data_persistable(S, L, main):
    main.global_block().create_var(name="stateful_in", shape=(8, 4),
                                   is_data=True, persistable=True)


def _big_feed(S, L, main):
    main.global_block().create_var(name="big", shape=(64, 8), is_data=True)


def _cond_clash(S, L):
    cf = S.control_flow
    a = L.fill_constant([2, 4], "float32", 1.0)
    b = L.fill_constant([2, 2], "float32", 1.0)
    zero = L.fill_constant([1], "float32", 0.0)
    one = L.fill_constant([1], "float32", 1.0)
    return cf.cond(cf.less_than(zero, one), lambda: L.reshape(a, [-1]),
                   lambda: L.reshape(b, [-1]))


def _big_embedding(S, L):
    return K.embedding_net(S, L, vocab=65536)


def _rules(S, pattern, axes):
    import importlib

    pkg = "paddle_tpu" if S is K.jstatic else "paddle_tpu_torch"
    r = importlib.import_module(pkg + ".parallel.sharding").ShardingRules()
    r.add(pattern, axes)
    return r


# name: (builder, builder kwargs, plan kwargs (S -> dict), verify kwargs)
CASES = {
    "clean_int8": (_tower_extra, {"hidden": 16},
                   lambda S: {"comm_quantize": "int8"},
                   {"feed_shapes": {"x": (16, 8), "y": (16, 1)}}),
    "fp8": (_tower_extra, {"hidden": 16},
            lambda S: {"comm_quantize": "fp8"}, {}),
    "sc001_feed": (_tower_extra, {}, lambda S: {},
                   {"feed_shapes": {"x": (12, 8), "y": (12, 1)}}),
    "sc001_edges": (_tower_extra, {}, lambda S: {},
                    {"feed_shapes": {"x": (8, 8)},
                     "bucket_edges": (1, 2, 4, 6)}),
    "sc002_rule": (_tower_extra, {},
                   lambda S: {"rules": _rules(S, "param_.*", ("dq", None))},
                   {}),
    "sc003_rank": (_tower_extra, {},
                   lambda S: {"annotations": {"param_1": ("dp", None)}}, {}),
    "sc003_indivisible": (_tower_extra, {},
                          lambda S: {"annotations": {"param_0": (None,
                                                                 "dp")}},
                          {}),
    "sc003_conflicts": (_tower_extra, {},
                        lambda S: {"rules": _rules(S, "param_0",
                                                   (None, "tp")),
                                   "annotations": {"param_0": (None, None),
                                                   "paramX_0": ("dp",)}},
                        {}),
    "sc004": (_tower_extra, {"extra": _data_persistable}, lambda S: {},
              {"feed_shapes": {"param_1": (16,)}}),
    "sc004_no_donate": (_tower_extra, {"extra": _data_persistable},
                        lambda S: {"donate": False},
                        {"feed_shapes": {"param_1": (16,)}}),
    "sc005_block_buffer": (_tower_extra, {},
                           lambda S: {"comm_quantize": "int8",
                                      "comm_block_size": 0,
                                      "comm_buffer_mb": 0.0}, {}),
    "sc005_small_bucket": (_tower_extra, {},
                           lambda S: {"comm_quantize": "int8",
                                      "comm_block_size": 4096}, {}),
    "sc006": (_cond_clash, {}, lambda S: {}, {}),
    "sc007": (_tower_extra, {"extra": _big_feed}, lambda S: {},
              {"feed_names": ["big"], "bucket_edges": (1, 2, 4)}),
    "sc007_edges": (_tower_extra, {}, lambda S: {},
                    {"feed_names": ["x", "nope"],
                     "bucket_edges": (4, 2)}),
    "sc008": (_tower_extra, {},
              lambda S: {"zero_stage": 3,
                         "annotations": {"param_0": ("dp", None)}}, {}),
    "sc010_dense": (_big_embedding, {}, lambda S: {},
                    {"feed_shapes": {"ids": (16, 16), "y": (16, 1)}}),
}


def _reports(name):
    builder, bkw, plan_kw, vkw = CASES[name]
    out = []
    for S in K.PKGS:
        main, _, _ = K.build(S, builder, **bkw)
        p = K.plan(S, **plan_kw(S))
        out.append(S.verify_plan(main, p, **vkw))
    return out


@needs_devices
@pytest.mark.parametrize("name", sorted(CASES))
def test_same_sc_diagnostics_and_comm_estimate(name):
    jrep, trep = _reports(name)
    assert K.diag_keys(trep.diagnostics) == K.diag_keys(jrep.diagnostics)
    assert trep.comm.to_dict() == jrep.comm.to_dict()
    if jrep.mem is not None:
        t, j = trep.mem.to_dict(), jrep.mem.to_dict()
        for key in ("device_kind", "capacity_bytes"):
            t.pop(key), j.pop(key)
        assert t == j
    expect = {"sc001_feed": {"SC001"}, "sc001_edges": {"SC001"},
              "sc002_rule": {"SC002"}, "sc003_rank": {"SC003"},
              "sc003_indivisible": {"SC003"}, "sc004": {"SC004"},
              "sc005_block_buffer": {"SC005"}, "sc006": {"SC006"},
              # the ladder (1, 2, 4) does not divide 8 devices either
              "sc007": {"SC001", "SC007"},
              "sc007_edges": {"SC001", "SC007"},
              "sc008": {"SC008"}}.get(name, set())
    assert {d.code for d in trep.errors} == expect


@needs_devices
def test_sc009_prices_the_contraction_alike():
    out = []
    for S in K.PKGS:
        main, _, _ = K.build(S, K.tower, 12)
        out.append(S.verify_plan(main, K.plan(
            S, axes=("tp",), annotations={"param_0": ("tp", None)})))
    jrep, trep = out
    assert K.diag_keys(trep.diagnostics) == K.diag_keys(jrep.diagnostics)
    assert trep.comm.gather_sites == jrep.comm.gather_sites
    assert trep.comm.gather_bytes == int(round(8 * 12 * 4 * 7 / 8))


@needs_devices
@pytest.mark.parametrize("n,kw", [(8, {}), (2, {"comm_quantize": "int8"}),
                                  (4, {"comm_buffer_mb": 0.001})])
def test_estimate_comm_bytes_equal(n, kw):
    ests = []
    for S in K.PKGS:
        main, _, _ = K.build(S, K.fc_tower, "adam")
        ests.append(S.estimate_comm(main, K.plan(S, n, **kw)))
    assert ests[1].to_dict() == ests[0].to_dict()
    assert ests[1].allreduce_bytes > 0


@needs_devices
def test_check_plan_raises_and_check_with_plan_memoizes():
    import numpy as np
    import paddle_tpu_torch.static.shardcheck as sc
    from paddle_tpu_torch.core import errors

    main, _, _ = K.build(K.tstatic, K.tower, 16)
    plan = K.plan(K.tstatic)
    with pytest.raises(errors.ProgramVerificationError) as ei:
        sc.check_plan(main, plan, feed_shapes={"x": (12, 8), "y": (12, 1)})
    assert [d.code for d in ei.value.diagnostics] == ["SC001", "SC001"]
    feed = {"x": np.zeros((16, 8), np.float32),
            "y": np.zeros((16, 1), np.float32)}
    r1 = sc.check_with_plan(main, plan, feed)
    assert sc.check_with_plan(main, plan, feed) is r1
    other, _, _ = K.build(K.tstatic, K.tower, 16)
    assert other._version == main._version
    # two programs at one version do not share a memo entry
    assert sc.check_with_plan(other, plan, feed) is not r1
