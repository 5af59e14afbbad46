"""The hybrid-parallel ERNIE pretrainer on 4 gloo ranks on the CPU against
the JAX package's ``HybridPretrainer`` on the same mesh shape over 4 of
the 8 virtual CPU devices.

The ``_dryrun_on_mesh`` widths (hidden 64, 4 heads, 2 layers, I 128,
vocab 128, dropout 0), b8 s16 with 4 masked positions, the JAX trainer's
parameters put into the port with ``convert.hybrid_params_from_jax``.
Meshes: pp2 x tp2 with GPipe (2 micro-batches) and with 1F1B (4),
dp2 x sp2 with fleet ``sharding`` (ZeRO-1), tp4 (one head a rank: the
split-head route), ep2 x sp2 with 4 experts.  Held:

* the loss against the JAX loss on that mesh (``jax.value_and_grad(
  trainer.loss_fn)``; for 1F1B also the JAX 1F1B train step's) at rtol
  2e-4, the ``_dryrun_on_mesh`` contract;
* every gradient, gathered to its whole tensor on every rank, against
  JAX's: within 1e-4 of the tensor's largest value, that floored at
  1e-4 of the largest of all (the key bias's gradient is zero in exact
  arithmetic, tests/test_torch_train.py);
* ZeRO-1: one Adam step's parameters equal the step without it to 1e-6,
  and each rank's moments take half the bytes;
* a group over two mesh dims, ``shard_batch(seq_axis=)`` against the JAX
  ``ShardingPlan.feed_shardings`` placement, and the fleet errors (an
  unknown schedule, ``sequence_parallel`` without sp) as the JAX trainer
  raises them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.parallel import fleet as JF
from paddle_tpu.parallel import mesh as JM
from paddle_tpu.parallel.sharding import ShardingPlan
from paddle_tpu.text.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.text.pretrainer import HybridPretrainer as JTrainer
from paddle_tpu_torch.parallel import fleet as TF
from paddle_tpu_torch.parallel import mesh as TM
from paddle_tpu_torch.text.ernie import ErnieConfig
from paddle_tpu_torch.text.pretrainer import HybridPretrainer
import torch_parallel_job as J

LOSS_RTOL = 2e-4
GRAD_REL = 1e-4
ZERO_ATOL = 1e-6


class _Capture:
    def update(self, grads, state, params, lr=None):
        return grads, state


def _jax_strategy(schedule, num_micro, sp, zero):
    s = JF.DistributedStrategy()
    s.pipeline = True
    s.pipeline_configs.schedule = schedule
    s.pipeline_configs.micro_batch = num_micro
    s.sequence_parallel = sp
    s.sharding = zero
    return s


def _jax_reference(name, raw, batch):
    degrees, num_micro, schedule, experts, zero = J.HYBRID_MESHES[name]
    jm = JM.build_mesh(JM.MeshConfig(devices=jax.devices()[:4],
                                     **dict({"dp": 1}, **degrees)))
    JM.set_mesh(jm)
    try:
        jt = JTrainer(JErnieConfig(**J.HYBRID), mesh=jm, moe_experts=experts,
                      strategy=_jax_strategy(schedule, num_micro,
                                             "sp" in degrees, zero))
        params = jt.place_params(jax.tree_util.tree_map(jnp.asarray, raw))
        sh = jt.data_shardings(jm)
        placed = {k: jax.device_put(v.astype(np.int32), sh[k])
                  for k, v in batch.items()}
        key = jax.random.PRNGKey(0)
        with jm:
            loss, grads = jax.jit(jax.value_and_grad(jt.loss_fn))(
                params, placed, key)
            losses = [float(loss)]
            if schedule == "1f1b":
                _, _, l1 = jax.jit(jt.make_train_step(_Capture()))(
                    params, None, placed, key)
                losses.append(float(l1))
    finally:
        JM.set_mesh(None)
    return losses, {f"{g}/{k}": np.asarray(v)
                    for g, leaves in grads.items() for k, v in leaves.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX trainers' parameters (written for the job), then the
    4-rank job."""
    out = tmp_path_factory.mktemp("hybrid")
    raws = {}
    for experts in (0, 4):
        paddle_tpu.seed(11 + experts)
        jm = JM.build_mesh(JM.MeshConfig(devices=jax.devices()[:1]))
        jt = JTrainer(JErnieConfig(**J.HYBRID), mesh=jm, moe_experts=experts)
        raws[experts] = jax.tree_util.tree_map(np.asarray, jt.init_params())
        np.savez(out / f"hybrid_params_{experts}.npz",
                 **J.flat_params(raws[experts]))
    JM.set_mesh(None)
    rc, secs, log = J.run_job(out, 4, ["group_dp_sp", "shard_batch_seq"] + [
        f"hybrid_{n}" for n in J.HYBRID_MESHES])
    assert rc == 0, log[-4000:]
    return out, raws


@pytest.mark.parametrize("name", list(J.HYBRID_MESHES))
def test_hybrid_step_matches_jax_on_the_same_mesh(reference, name):
    out, raws = reference
    experts = J.HYBRID_MESHES[name][3]
    losses, grads = _jax_reference(name, raws[experts], J.hybrid_batch())
    floor = GRAD_REL * max(float(np.abs(g).max()) for g in grads.values())
    for r in range(4):
        got = J.result(out, f"hybrid_{name}", r)
        for want in losses:
            np.testing.assert_allclose(got["loss"], want, rtol=LOSS_RTOL)
        assert {k[len("grad/"):] for k in got if k.startswith("grad/")} \
            == set(grads)
        for k, want in grads.items():
            tol = max(GRAD_REL * float(np.abs(want).max()), floor)
            np.testing.assert_allclose(got[f"grad/{k}"], want, rtol=0,
                                       atol=tol, err_msg=f"{name} rank {r} {k}")


def test_zero1_keeps_half_the_moments_and_takes_the_same_step(reference):
    """Adam's first step is -lr g / (|g| + eps): a gradient at noise level
    (the key bias's, zero in exact arithmetic) takes a full-size step whose
    sign the summation order decides, and ZeRO-1 sums in another order
    (reduce-scatter).  So a tensor whose largest gradient is below the
    floor is held to the step bound (2 lr apart at most); every other
    tensor to 1e-6."""
    out, _ = reference
    lr = 1e-3
    for r in range(4):
        got = J.result(out, "hybrid_dp2sp2_zero", r)
        assert 2 * got["zero/moment_bytes"] == got["plain/moment_bytes"]
        grads = {k[len("grad/"):]: v for k, v in got.items()
                 if k.startswith("grad/")}
        floor = GRAD_REL * max(float(np.abs(g).max()) for g in grads.values())
        for k, g in grads.items():
            noise = float(np.abs(g).max()) < floor
            np.testing.assert_allclose(
                got[f"zero/{k}"], got[f"plain/{k}"], rtol=0,
                atol=2 * lr * (1 + 1e-6) if noise else ZERO_ATOL,
                err_msg=k)
        assert any(float(np.abs(g).max()) < floor for g in grads.values())


def test_a_group_over_two_mesh_dims(reference):
    out, _ = reference
    xs = [J.rank_array(r, (3,), seed=80) for r in range(4)]
    for r in range(4):
        got = J.result(out, "group_dp_sp", r)
        np.testing.assert_allclose(got["sum_dp_sp"], sum(xs), rtol=1e-6)
        d = r // 2
        np.testing.assert_allclose(got["sum_sp"], xs[2 * d] + xs[2 * d + 1],
                                   rtol=1e-6)
        assert tuple(got["coords"]) == (d, r % 2)


def test_shard_batch_seq_axis_places_as_jax(reference):
    out, _ = reference
    jm = JM.build_mesh(JM.MeshConfig(devices=jax.devices()[:4], dp=2, sp=2))
    batch = J.seq_batch()
    specs = ShardingPlan(mesh=jm, seq_axis="sp", donate=False) \
        .feed_shardings(batch)
    for r in range(4):
        got = J.result(out, "shard_batch_seq", r)
        coords = {"dp": r // 2, "sp": r % 2}
        for k, v in batch.items():
            want = np.asarray(v)
            for dim, a in enumerate(tuple(specs[k].spec)):
                if a is not None:
                    per = want.shape[dim] // jm.shape[a]
                    want = np.take(want, range(coords[a] * per,
                                               (coords[a] + 1) * per), dim)
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        assert got["indivisible_raises"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_fleet_errors_as_jax(package):
    if package == "port":
        mesh = TM.build_mesh(TM.MeshConfig(devices=list(range(4)), dp=4))
        strategy, make = TF.DistributedStrategy(), (
            lambda s: HybridPretrainer(ErnieConfig(**J.HYBRID), mesh=mesh,
                                       strategy=s, device="cpu"))
    else:
        mesh = JM.build_mesh(JM.MeshConfig(devices=jax.devices()[:4], dp=4))
        strategy, make = JF.DistributedStrategy(), (
            lambda s: JTrainer(JErnieConfig(**J.HYBRID), mesh=mesh,
                               strategy=s))
    strategy.pipeline = True
    strategy.pipeline_configs.schedule = "interleaved"
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        make(strategy)
    strategy.pipeline_configs.schedule = "1f1b"
    strategy.pipeline_configs.micro_batch = 4
    assert make(strategy).num_micro == 4
    strategy.sequence_parallel = True
    with pytest.raises(ValueError, match="no sp axis"):
        make(strategy)
    JM.set_mesh(None)
    TM.set_mesh(None)
