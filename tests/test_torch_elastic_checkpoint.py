"""The port's elastic checkpoints (paddle_tpu_torch/elastic/checkpoint.py),
``ShardingPlan`` placement, ``utils.checkpoint.load`` of a manifest
directory and ``AutoCheckpoint`` against the JAX package's, on the CPU.

Counterparts of tests/test_elastic_checkpoint.py: the manifest round trip
and the 4 -> 2 reshard (one process that is the whole mesh), corruption,
GC, no tmp litter, ``scope_state`` over the port's static Scope,
``utils.checkpoint``, ``AutoCheckpoint`` and the hapi wiring.  Its CLI
tests (``tools.elastic``, ROADMAP.md Queue 1 item 10) and its
compile-cache resume test (the Executor's persistent cache, item 9) have
no counterpart yet.

Across the packages: a manifest the port writes has the JAX package's
body for the same state and plan (so the same digests), each package
restores the other's fp32 / int leaves bit for bit, and with gloo ranks
(tests/torch_parallel_worker.py): a JAX-written 4-way ZeRO checkpoint (4
virtual CPU devices) restores on 2 port ranks under dp2, every slice
bitwise and ``resharded_leaves`` equal to the JAX package's; a 4-rank
port checkpoint restores in the JAX package under its dp2 plan, bitwise.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_parallel_job as J
from paddle_tpu.elastic import checkpoint as jeckpt
from paddle_tpu.parallel.sharding import ShardingPlan as JPlan
import paddle_tpu_torch as P
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.elastic import checkpoint as eckpt
from paddle_tpu_torch.parallel.mesh import Mesh
from paddle_tpu_torch.parallel.sharding import ShardingPlan
from paddle_tpu_torch.utils import checkpoint as uckpt
from paddle_tpu_torch.utils import monitor
from paddle_tpu_torch.utils import trace as trace_mod
from paddle_tpu_torch.utils.auto_checkpoint import AutoCheckpoint


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch.core import device

    with device.device_guard("cpu"):
        yield


def _mesh(n):
    return Mesh(("dp",), {"dp": n}, device=torch.device("cpu"))


def _dp_plan(n: int, zero_stage: int = 3) -> ShardingPlan:
    return ShardingPlan(mesh=_mesh(n), zero_stage=zero_stage, donate=False)


def _jax_plan(n: int, zero_stage: int = 3) -> JPlan:
    return JPlan(mesh=JMesh(np.asarray(jax.devices()[:n]), ("dp",)),
                 zero_stage=zero_stage, donate=False)


def _state(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(64, 16)).astype(np.float32),
            "b": rng.normal(size=(16,)).astype(np.float32),
            "scalar": np.float32(3.5),
            "count": np.arange(6, dtype=np.int32)}


def _equal(restored, expect) -> bool:
    return all(np.array_equal(np.asarray(restored[k]), np.asarray(expect[k]))
               and np.asarray(restored[k]).dtype == np.asarray(expect[k]).dtype
               for k in expect)


@pytest.fixture
def _elastic_flags_guard():
    saved = flags.get_flags(["elastic_save_every", "elastic_ckpt_dir",
                             "elastic_keep_last", "metrics"])
    yield
    flags.set_flags(saved)


# -- manifest round trip + resharding ---------------------------------------

def test_manifest_roundtrip_same_mesh_no_reshard(tmp_path):
    state = _state()
    plan = _dp_plan(4)
    eckpt.save_checkpoint(str(tmp_path), state, 11, plan=plan,
                          prng_key=np.arange(2, dtype=np.uint32))
    restored, meta = eckpt.restore_checkpoint(str(tmp_path), plan=plan)
    assert _equal(restored, state)
    assert all(isinstance(v, torch.Tensor) for v in restored.values())
    assert meta["step"] == 11 and meta["resharded_leaves"] == 0
    assert meta["mesh_axes"] == {"dp": 4}
    assert meta["prng_key"] == [0, 1]
    assert meta["plan_fingerprint"] == plan.fingerprint() \
        == _jax_plan(4).fingerprint()


def test_reshard_4_to_2_bitwise_and_counted(tmp_path):
    reg = monitor.default_registry()
    m0 = reg.get("elastic.resharded_leaves").value()
    state = _state()
    eckpt.save_checkpoint(str(tmp_path), state, 5, plan=_dp_plan(4))
    body = eckpt.load_manifest(str(tmp_path))
    shards = {l["name"]: len(l["shards"]) for l in body["leaves"]}
    assert shards == {"w": 4, "b": 4, "scalar": 1, "count": 1}
    restored, meta = eckpt.restore_checkpoint(str(tmp_path),
                                              plan=_dp_plan(2))
    assert _equal(restored, state)
    # w and b change degree, count (6 rows: 4 do not divide it, 2 do)
    # goes from replicated to split; the scalar stays
    _, jmeta = jeckpt.restore_checkpoint(str(tmp_path), plan=_jax_plan(2))
    assert meta["resharded_leaves"] == jmeta["resharded_leaves"] == 3
    assert reg.get("elastic.resharded_leaves").value() - m0 == 3


def test_restore_without_plan_gathers_to_host(tmp_path):
    state = _state()
    eckpt.save_checkpoint(str(tmp_path), state, 1, plan=_dp_plan(4))
    restored, meta = eckpt.restore_checkpoint(str(tmp_path))
    assert meta["resharded_leaves"] == 0
    assert all(isinstance(v, np.ndarray) for v in restored.values())
    assert _equal(restored, state)


def test_latest_gc_and_no_tmp_litter(tmp_path):
    state = _state()
    for step in (1, 2, 3, 4):
        eckpt.save_checkpoint(str(tmp_path), state, step, keep_last=2)
    assert eckpt.list_steps(str(tmp_path)) == [3, 4]
    assert eckpt.latest_step(str(tmp_path)) == 4
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    os.unlink(tmp_path / "LATEST")
    assert eckpt.latest_step(str(tmp_path)) == 4
    restored, meta = eckpt.restore_checkpoint(str(tmp_path), step=3)
    assert meta["step"] == 3 and _equal(restored, state)


def _kinds():
    return [e["kind"] for e in trace_mod.flight_recorder().events()]


def test_corrupted_shard_raises(tmp_path):
    eckpt.save_checkpoint(str(tmp_path), _state(), 1)
    shard = sorted((tmp_path / "step_00000001").glob("leaf*.npy"))[0]
    blob = bytearray(shard.read_bytes())
    blob[-4] ^= 0xFF
    shard.write_bytes(bytes(blob))
    n0 = _kinds().count("elastic_shard_corrupt")
    with pytest.raises(eckpt.CheckpointError, match="digest mismatch"):
        eckpt.restore_checkpoint(str(tmp_path))
    assert _kinds().count("elastic_shard_corrupt") == n0 + 1


def test_edited_manifest_raises(tmp_path):
    eckpt.save_checkpoint(str(tmp_path), _state(), 1)
    mpath = tmp_path / "step_00000001" / "manifest.json"
    payload = json.loads(mpath.read_text())
    payload["manifest"]["step"] = 999
    mpath.write_text(json.dumps(payload))
    n0 = _kinds().count("elastic_manifest_corrupt")
    with pytest.raises(eckpt.CheckpointError, match="digest mismatch"):
        eckpt.load_manifest(str(tmp_path))
    assert _kinds().count("elastic_manifest_corrupt") == n0 + 1


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(eckpt.CheckpointError, match="no checkpoints"):
        eckpt.restore_checkpoint(str(tmp_path / "nope"))


def test_scope_state_roundtrip(tmp_path):
    """scope_state captures the persistables of a port static program;
    restore_scope_state puts them back into a fresh Scope."""
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.static import layers as L

    main, startup = static.Program(), static.Program()
    main.random_seed = startup.random_seed = 7
    with static.program_guard(main, startup):
        x = L.data("x", [4])
        loss = L.mean(L.fc(x, 2))
        static.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = static.Scope()
    with static.scope_guard(scope):
        exe = static.Executor()
        exe.run(startup)
        exe.run(main, feed={"x": np.ones((8, 4), np.float32)},
                fetch_list=[loss])
    state = eckpt.scope_state(main, scope)
    assert state
    eckpt.save_checkpoint(str(tmp_path), state, 1)
    restored, _ = eckpt.restore_checkpoint(str(tmp_path))
    fresh = static.Scope()
    eckpt.restore_scope_state(restored, fresh)
    for name, val in state.items():
        assert np.array_equal(np.asarray(fresh.find_var(name)),
                              np.asarray(torch.as_tensor(val).cpu())), name


# -- across the packages ----------------------------------------------------

def test_port_manifest_is_the_jax_packages(tmp_path):
    """The same state under the same plan gives the JAX package's manifest
    body: leaf specs, shard files, indices and digests, mesh and plan
    fingerprints."""
    state = _state()
    eckpt.save_checkpoint(str(tmp_path / "t"), state, 9, plan=_dp_plan(4),
                          prng_key=np.arange(2, dtype=np.uint32))
    jeckpt.save_checkpoint(str(tmp_path / "j"), state, 9, plan=_jax_plan(4),
                           prng_key=np.arange(2, dtype=np.uint32))
    assert eckpt.load_manifest(str(tmp_path / "t")) == \
        jeckpt.load_manifest(str(tmp_path / "j"))
    a, b = (sorted(os.listdir(tmp_path / d / "step_00000009"))
            for d in "tj")
    assert a == b


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("with_plan", [False, True])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer, with_plan):
    state = _state(3)
    if writer == "jax":
        jeckpt.save_checkpoint(str(tmp_path), state, 2,
                               plan=_jax_plan(4) if with_plan else None)
        got, meta = eckpt.restore_checkpoint(
            str(tmp_path), plan=_dp_plan(2) if with_plan else None)
        back = uckpt.load(str(tmp_path / "step_00000002"))
    else:
        eckpt.save_checkpoint(str(tmp_path), state, 2,
                              plan=_dp_plan(4) if with_plan else None)
        got, meta = jeckpt.restore_checkpoint(
            str(tmp_path), plan=_jax_plan(2) if with_plan else None)
        from paddle_tpu.utils import checkpoint as juckpt
        back = juckpt.load(str(tmp_path / "step_00000002"))
    assert _equal(got, state) and _equal(back, state)
    assert meta["resharded_leaves"] == (3 if with_plan else 0)


def test_bfloat16_leaves(tmp_path):
    """A bf16 leaf round-trips in the port; the port reads the JAX
    package's bf16 words as the same bf16 values; both write the same
    2-byte words."""
    import ml_dtypes

    h = torch.randn(4, 3).bfloat16()
    eckpt.save_checkpoint(str(tmp_path / "t"), {"h": h}, 1)
    got, _ = eckpt.restore_checkpoint(str(tmp_path / "t"))
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], h)
    hj = h.float().numpy().astype(ml_dtypes.bfloat16)
    jeckpt.save_checkpoint(str(tmp_path / "j"), {"h": hj}, 1)
    got, _ = eckpt.restore_checkpoint(str(tmp_path / "j"))
    assert torch.equal(got["h"], h)
    words = [np.load(tmp_path / d / "step_00000001" / "leaf0000.shard000.npy")
             .view(np.uint16) for d in "tj"]
    assert np.array_equal(*words)
    assert eckpt.load_manifest(str(tmp_path / "t"))["leaves"][0]["dtype"] \
        == jeckpt.load_manifest(str(tmp_path / "j"))["leaves"][0]["dtype"] \
        == "bfloat16"


def test_generator_state_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)
    eckpt.save_checkpoint(str(tmp_path), _state(), 1, prng_key=gen)
    expect = torch.rand(4, generator=gen)
    _, meta = eckpt.restore_checkpoint(str(tmp_path))
    fresh = torch.Generator()
    eckpt.restore_generator(fresh, meta["prng_key"])
    assert torch.equal(torch.rand(4, generator=fresh), expect)


# -- utils.checkpoint / AutoCheckpoint --------------------------------------

def test_utils_checkpoint_atomic_save_roundtrip(tmp_path):
    state = {"a": np.ones((2, 3), np.float32), "b": (np.float32(2.0),)}
    path = str(tmp_path / "ck")
    uckpt.save(state, path)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    back = uckpt.load(path)
    assert np.array_equal(back["a"], state["a"]) and back["b"][0] == 2.0


def test_utils_load_detects_manifest_directory(tmp_path):
    state = _state()
    d = str(tmp_path / "mdir")
    eckpt.write_state(d, state, plan=_dp_plan(4))
    assert _equal(uckpt.load(d), state)


def test_auto_checkpoint_manifest_delegation_and_legacy(tmp_path):
    plan = _dp_plan(4)
    state = _state()
    acp = AutoCheckpoint(str(tmp_path / "m"), job_id="j", plan=plan)
    acp.save(0, state)
    sdir = os.path.join(acp.root, "epoch_0", "state")
    assert os.path.exists(os.path.join(sdir, eckpt.MANIFEST_NAME))
    assert _equal(acp.load(0), state)
    acp2 = AutoCheckpoint(str(tmp_path / "m"), job_id="j", plan=plan)
    assert acp2.last_epoch == 0
    assert list(acp2.train_epoch_range(2)) == [1]
    assert _equal(acp2.restored_state, state)
    legacy = AutoCheckpoint(str(tmp_path / "l"), job_id="j")
    legacy.save(0, {"x": np.zeros(2, np.float32)})
    assert os.path.exists(os.path.join(legacy.root, "epoch_0", "state.npz"))
    assert np.array_equal(legacy.load(0)["x"], np.zeros(2, np.float32))


# -- hapi wiring: elastic_* flags -> periodic saves -> restore_model ---------

def _hapi_model(seed: int = 5):
    from paddle_tpu_torch.hapi import Model

    P.seed(seed)
    net = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 1))
    model = Model(net)
    model.prepare(optimizer=P.optimizer.Adam(learning_rate=0.05,
                                             parameters=net.parameters()),
                  loss=tnn.MSELoss())
    return model


def _hapi_data(lo=0, hi=64):
    from paddle_tpu_torch.io import TensorDataset

    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.normal(size=(64, 1)).astype(np.float32)
    return TensorDataset([x[lo:hi], y[lo:hi]])


class _Losses:
    def __init__(self):
        self.losses = []

    def set_model(self, model):
        pass

    def set_params(self, params):
        pass

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)


def test_hapi_fit_elastic_flags_and_restore_model(tmp_path,
                                                  _elastic_flags_guard):
    ckpt = str(tmp_path / "eck")
    flags.set_flags({"elastic_save_every": 2, "elastic_ckpt_dir": ckpt,
                     "elastic_keep_last": 3})
    model = _hapi_model(seed=5)
    model.fit(_hapi_data(), batch_size=16, epochs=2, verbose=0,
              shuffle=False)
    steps = eckpt.list_steps(ckpt)
    assert steps == [4, 6, 8]
    names = [l["name"] for l in eckpt.load_manifest(ckpt)["leaves"]]
    assert "param/0.weight" in names and "opt/0000" in names
    assert len([n for n in names if n.startswith("opt/")]) == 1 + 2 * 4
    fresh = _hapi_model(seed=99)
    meta = eckpt.restore_model(fresh, ckpt)
    assert meta["step"] == 8
    for (k, a), (_, b) in zip(model.network.named_parameters(),
                              fresh.network.named_parameters()):
        assert torch.equal(a, b), k
    _, slots = eckpt._opt_slots(model)
    _, got = eckpt._opt_slots(fresh)
    assert all(torch.equal(a, b) for a, b in zip(slots, got))
    assert fresh._optimizer._step_count == 8


def test_fit_resumes_bitwise_from_a_checkpoint(tmp_path,
                                               _elastic_flags_guard):
    """Phase 26a at toy size: a fresh model restored at step 2 fits steps
    3-4 on the same batches with the uninterrupted run's losses."""
    ckpt = str(tmp_path / "eck")
    flags.set_flags({"elastic_save_every": 2, "elastic_ckpt_dir": ckpt})
    rec = _Losses()
    _hapi_model(seed=5).fit(_hapi_data(), batch_size=16, epochs=1,
                            verbose=0, shuffle=False, callbacks=[rec])
    assert eckpt.list_steps(ckpt) == [2, 4]
    flags.set_flags({"elastic_save_every": 0, "elastic_ckpt_dir": ""})
    fresh = _hapi_model(seed=99)
    eckpt.restore_model(fresh, ckpt, step=2)
    rec2 = _Losses()
    fresh.fit(_hapi_data(32, 64), batch_size=16, epochs=1, verbose=0,
              shuffle=False, callbacks=[rec2])
    assert rec2.losses == rec.losses[2:]


def test_hapi_fit_without_flags_writes_nothing(tmp_path,
                                               _elastic_flags_guard):
    flags.set_flags({"elastic_save_every": 0, "elastic_ckpt_dir": ""})
    _hapi_model().fit(_hapi_data(), batch_size=32, epochs=1, verbose=0)
    assert not list(tmp_path.iterdir())


# -- gloo ranks --------------------------------------------------------------

@pytest.fixture(scope="module")
def rank_jobs(tmp_path_factory):
    """The JAX package writes a 4-way ZeRO-3 checkpoint; 4 port ranks
    write theirs (ZeRO-3 and ZeRO-1); 2 port ranks restore the JAX one and
    the port's ZeRO-1 one under dp2."""
    out = tmp_path_factory.mktemp("elastic_ranks")
    jeckpt.save_checkpoint(str(out / "jax_zero3"), J.elastic_state(), 6,
                           plan=_jax_plan(4))
    rc4, _, log4 = J.run_job(out, 4, ["elastic_save_dp4"])
    rc2, _, log2 = J.run_job(out, 2, ["elastic_restore_dp2"])
    return out, rc4, log4, rc2, log2


def _slices(full, spec_axis0, n, r):
    if not spec_axis0:
        return full
    per = full.shape[0] // n
    return full[r * per:(r + 1) * per]


def test_jax_zero_checkpoint_restores_on_two_port_ranks(rank_jobs):
    out, rc4, log4, rc2, log2 = rank_jobs
    assert rc2 == 0, log2[-3000:]
    state = J.elastic_state()
    jstate, jmeta = jeckpt.restore_checkpoint(str(out / "jax_zero3"),
                                              plan=_jax_plan(2))
    specs = _jax_plan(2).state_shardings(state)
    for r in range(2):
        res = J.result(out, "elastic_restore_dp2", r)
        assert int(res["jax3/resharded"]) == jmeta["resharded_leaves"] == 5
        assert int(res["jax3/step"]) == 6
        for k, v in state.items():
            split = tuple(specs[k].spec)[:1] == ("dp",)
            want = _slices(np.asarray(v), split, 2, r)
            got = res[f"jax3/{k}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), k
            assert str(res[f"jax3/spec/{k}"]) == (
                "('dp',)" if split else "None"), k


def test_port_four_rank_checkpoint_restores_in_jax(rank_jobs):
    out, rc4, log4, rc2, log2 = rank_jobs
    assert rc4 == 0, log4[-3000:]
    state = J.elastic_state()
    body = jeckpt.load_manifest(str(out / "port_zero3"))
    assert body["plan_fingerprint"] == _jax_plan(4).fingerprint()
    assert {l["name"]: len(l["shards"]) for l in body["leaves"]} == {
        "param/w": 4, "param/b": 4, "opt/w.m": 4, "opt/b.m": 4,
        "scalar": 1, "count": 1}
    got, meta = jeckpt.restore_checkpoint(str(out / "port_zero3"),
                                          plan=_jax_plan(2))
    assert _equal(got, state)
    assert meta["resharded_leaves"] == 5       # and count: 6 rows split 2
    assert not [n for n in os.listdir(out / "port_zero3") if ".tmp" in n]
    assert not list((out / "port_zero3" / "step_00000007").glob("shards.*"))


def test_zero1_moments_saved_as_dp_slices_params_once(rank_jobs):
    out, rc4, log4, rc2, log2 = rank_jobs
    assert rc4 == 0 and rc2 == 0, (log4 + log2)[-3000:]
    body = eckpt.load_manifest(str(out / "port_zero1"))
    leaves = {l["name"]: l for l in body["leaves"]}
    assert len(leaves["opt/w.m"]["shards"]) == 4
    assert leaves["opt/w.m"]["spec"] == ["dp"]
    assert len(leaves["param/w"]["shards"]) == 1
    assert leaves["param/w"]["spec"] == []
    state = J.elastic_state()
    got, _ = eckpt.restore_checkpoint(str(out / "port_zero1"))
    assert _equal(got, state)
    for r in range(2):
        res = J.result(out, "elastic_restore_dp2", r)
        # the moments stay split (4 -> 2 ranks), the parameters whole
        assert int(res["zero1/resharded"]) == 2
        for k, v in state.items():
            split = k in J.ELASTIC_SLOTS
            assert np.array_equal(res[f"zero1/{k}"],
                                  _slices(np.asarray(v), split, 2, r)), k
