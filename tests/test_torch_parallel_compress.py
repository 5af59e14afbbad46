"""The port's compression arithmetic, bucketing, hierarchy and mesh sizing
against the JAX package's, in one process on the CPU (the multi-rank
routes are in test_torch_parallel_collective.py).

Held exactly (bit for bit, or equal values): ``quantize_blockwise`` /
``dequantize_blockwise`` for int8 and fp8 at block sizes 64 and 256
(zero blocks, outliers, values at the rounding midpoints and subnormal
fp8 scales included), ``wire_bytes``, ``bucket_assignment``,
``bucket_signature``, ``hierarchical_groups``, ``resolve_hierarchy``,
``dp_hierarchy`` and ``MeshConfig.resolve``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.parallel.compress as JC
import paddle_tpu.parallel.mesh as JM
import paddle_tpu_torch.distributed as tdist
import paddle_tpu_torch.parallel.compress as TC
import paddle_tpu_torch.parallel.mesh as TM
from paddle_tpu_torch.parallel import DataParallel, apply_collective_grads


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    TM.set_mesh(None)


def _vector(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n).astype(np.float32)
    x[:256] = 0.0                                 # a zero block
    x[300] = 1e4                                  # an outlier
    x[600:700] = rng.normal(0, 1e-30, 100)        # tiny (fp8 subnormals)
    x[800:900] = (np.arange(100) - 50) * (1.0 / 127)   # on the int8 grid
    x[900:1000] = (np.arange(100) - 49.5) * 0.5   # midpoints
    return x


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("block_size", [64, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_and_dequantize_are_bit_equal_to_jax(kind, block_size,
                                                      seed):
    x = _vector(seed, 4096)
    jq, js = JC.quantize_blockwise(jnp.asarray(x), kind, block_size)
    tq, ts = TC.quantize_blockwise(torch.from_numpy(x), kind, block_size)
    np.testing.assert_array_equal(
        tq.view(torch.uint8 if kind == "fp8" else torch.int8).numpy(),
        np.asarray(jq).view(np.uint8 if kind == "fp8" else np.int8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0]) == 0.0 and not tq[:block_size].float().any()
    jd = JC.dequantize_blockwise(jq, js, block_size)
    td = TC.dequantize_blockwise(tq, ts, block_size)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quantize_rejects_a_ragged_vector_and_unknown_kinds():
    with pytest.raises(ValueError, match="block_size"):
        TC.quantize_blockwise(torch.ones(100), "int8", 64)
    with pytest.raises(ValueError, match="unknown compression kind"):
        TC.quantize_blockwise(torch.ones(64), "int4", 64)


@pytest.mark.parametrize("nelem,compress,block,n", [
    (1000, None, 256, 2), (1000, "int8", 256, 2), (12345, "fp8", 64, 8),
    (7, None, 256, 1), (10 ** 8, "int8", 256, 4), (333, None, 128, 3)])
def test_wire_bytes_match(nelem, compress, block, n):
    assert TC.wire_bytes(nelem, compress, block, n) == \
        JC.wire_bytes(nelem, compress, block, n)


def test_bucket_assignment_matches():
    rng = np.random.default_rng(3)
    for _ in range(20):
        sizes = [int(s) for s in rng.integers(1, 3 << 20, rng.integers(1, 40))]
        mb = float(rng.choice([0.5, 1.0, 4.0, 25.0]))
        assert TC.bucket_assignment(sizes, mb) == \
            JC.bucket_assignment(sizes, mb)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"encoder": {"w": rng.normal(size=(64, 32)).astype(np.float32),
                        "b": rng.normal(size=(32,)).astype(np.float32)},
            "emb": rng.normal(size=(300, 16)).astype(np.float32),
            "layers": [rng.normal(size=(8,)).astype(np.float32),
                       rng.normal(size=(4, 4)).astype(np.float32)],
            "head.bias": rng.normal(size=(5,)).astype(np.float32)}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("buffer_mb", [0.001, 0.01, 25.0])
def test_bucket_signature_is_the_jax_string(buffer_mb):
    tree = _tree(0)
    assert TC.bucket_signature(_to(tree, torch.from_numpy), buffer_mb) == \
        JC.bucket_signature(_to(tree, jnp.asarray), buffer_mb)


def test_bucketed_all_reduce_in_one_process_keeps_every_value():
    """With no process group a bucket's flatten -> (one-member) reduce ->
    unflatten moves no value, for every leaf and dtype."""
    tree = _to(_tree(1), torch.from_numpy)
    tree["half"] = torch.randn(7, 3).to(torch.bfloat16)
    out = TC.bucketed_all_reduce(tree, "dp", buffer_mb=0.001)
    flat_in, flat_out = TC._flatten(tree), TC._flatten(out)
    assert [k for k, _ in flat_in] == [k for k, _ in flat_out]
    for (_, a), (_, b) in zip(flat_in, flat_out):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert TC.sync_gradients(tree, "dp")["emb"].data_ptr() != \
        tree["emb"].data_ptr()


@pytest.mark.parametrize("n,intra", [(8, 2), (8, 4), (6, 3), (4, 1)])
def test_hierarchical_groups_match(n, intra):
    assert TC.hierarchical_groups(n, intra) == JC.hierarchical_groups(n, intra)


@pytest.mark.parametrize("spec,n", [
    (None, 8), ("off", 8), ("flat", 4), (False, 4), (1, 8), (2, 8), (4, 8),
    ((2, 4), 8), ((4, 2), 8), (8, 8), ((1, 8), 8)])
def test_resolve_hierarchy_matches(spec, n):
    assert TC.resolve_hierarchy(spec, n) == JC.resolve_hierarchy(spec, n)


@pytest.mark.parametrize("spec,n", [(3, 8), ((2, 3), 8)])
def test_resolve_hierarchy_rejects_what_jax_rejects(spec, n):
    with pytest.raises(ValueError):
        JC.resolve_hierarchy(spec, n)
    with pytest.raises(ValueError):
        TC.resolve_hierarchy(spec, n)


@pytest.mark.parametrize("axis,local", [(8, 2), (8, 4), (8, 8), (8, 1),
                                        (8, 3), (4, 2), (16, 4), (2, 2)])
def test_dp_hierarchy_matches(axis, local):
    assert TM.dp_hierarchy(axis, local) == JM.dp_hierarchy(axis, local)


def test_dp_hierarchy_counts_the_ranks_of_this_host(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "10.0.0.1:6170,10.0.0.1:6171,10.0.0.2:6170,"
                       "10.0.0.2:6171")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "10.0.0.2:6171")
    assert TM.dp_hierarchy(4) == (2, 2)
    assert TC.resolve_hierarchy("auto", 4) == (2, 2)
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS")
    assert TM.dp_hierarchy(4) is None


@pytest.mark.parametrize("cfg", [dict(), dict(dp=8), dict(dp=-1, pp=2),
                                 dict(dp=2, tp=4), dict(dp=4, sp=2),
                                 dict(dp=-1, ep=2, tp=2)])
def test_mesh_config_resolves_like_jax(cfg):
    devices = list(range(8))
    assert TM.MeshConfig(**cfg, devices=devices).resolve() == \
        JM.MeshConfig(**cfg, devices=devices).resolve()


@pytest.mark.parametrize("cfg", [dict(dp=3, tp=4), dict(dp=3)])
def test_mesh_config_rejects_what_jax_rejects(cfg):
    devices = list(range(8))
    with pytest.raises(ValueError):
        JM.MeshConfig(**cfg, devices=devices).resolve()
    with pytest.raises(ValueError):
        TM.MeshConfig(**cfg, devices=devices).resolve()


@pytest.mark.parametrize("axis", ["pp", "tp", "sp", "ep"])
def test_other_degrees_raise_until_item_8b(axis):
    """Item 8b landed: a degree above 1 on each dim builds the mesh the
    JAX package builds (sizes only here: no process group)."""
    m = TM.build_mesh(TM.MeshConfig(dp=1, devices=[0, 1], **{axis: 2}))
    jm = JM.build_mesh(JM.MeshConfig(dp=1, devices=jax.devices()[:2],
                                     **{axis: 2}))
    assert m.axis_names == tuple(jm.axis_names) == (axis,)
    assert m.shape == {axis: 2} and m.device_mesh is None


def test_a_mesh_without_a_process_group_sizes_only():
    m = TM.build_mesh(TM.MeshConfig(devices=list(range(4))))
    assert m.axis_names == ("dp",) and m.shape == {"dp": 4}
    assert m.device is None and m.device_mesh is None
    assert TM.mesh_fingerprint(m) == "mesh(dp=4)x4@?:?"
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        m.group("dp")
    assert TM.data_sharding(m) == (("dp",),)


def test_one_process_without_a_mesh_is_the_identity():
    """No mesh set: DataParallel and apply_collective_grads hand the
    gradients back, and spawn runs in the process (or raises for more
    than one process, as in the JAX package)."""
    grads = {"w": torch.ones(3)}
    assert apply_collective_grads(grads, comm_buffer_size=1) is grads
    dp = DataParallel(torch.nn.Linear(2, 2))
    assert dp.apply_collective_grads(grads) is grads
    assert tdist.spawn(lambda a: a + 1, (1,)) == 2
    with pytest.raises(NotImplementedError, match="launch"):
        tdist.spawn(print, nprocs=2)
    assert tdist.get_rank() == 0 and tdist.get_world_size() == 1
    with pytest.raises(ValueError, match="comm_buffer_size"):
        DataParallel(torch.nn.Linear(2, 2), comm_buffer_size=0)


def test_comm_options_signature_and_scope_match():
    for kw in (dict(), dict(quantize="int8", block_size=64, buffer_mb=0.5,
                            hierarchy=(2, 4)), dict(quantize="none")):
        t, j = TC.CommOptions(**kw), JC.CommOptions(**kw)
        assert t.signature() == j.signature() and t.payload() == j.payload()
    with TC.comm_scope(TC.CommOptions(quantize="fp8")) as opts:
        assert TC.current_comm() is opts
    assert TC.current_comm() is None
