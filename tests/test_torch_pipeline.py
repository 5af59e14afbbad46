"""Pipeline parallelism on 2 gloo ranks on the CPU (the shared 2-rank job
of tests/torch_parallel_job.py) against the JAX package's
``pipeline_apply`` / ``pipeline_train_1f1b`` under ``shard_map`` on pp=2 and
against the sequential computation.

Four blocks tanh(x W + b), two a stage, 4 micro-batches of 2:
* GPipe (``pipeline_apply``): the outputs on both ranks, the gradients of
  sum(out^2) for each rank's blocks and for the input;
* ``PipelineStage``: its forward after ``shard_params``;
* 1F1B (``pipeline_train_1f1b``, a linear head + MSE a micro-batch): the
  mean loss, each rank's block gradients, the head's and the input's.
Tolerances are tests/test_pipeline.py's: outputs rtol 2e-5 / atol 2e-5,
loss rtol 1e-5, gradients rtol 2e-4 / atol 1e-5.  The in-process cases
(microbatch, stack_block_params, one stage) need no job.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import paddle_tpu.distributed as jdist
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import pipeline as JP
from paddle_tpu.parallel.collective import shard_map
from paddle_tpu_torch.parallel import pipeline as TP
import torch_parallel_job as J

OUT = dict(rtol=2e-5, atol=2e-5)
LOSS_RTOL = 1e-5
GRAD = dict(rtol=2e-4, atol=1e-5)


def _jblock(blk, x):
    return jnp.tanh(x @ blk["w"] + blk["b"])


def _jhead(hp, y, t, micro_idx=0):
    return jnp.mean((y @ hp["w_out"] - t) ** 2)


@pytest.fixture(scope="module")
def job():
    out, rc, log = J.pair_job()
    assert rc == 0, log[-4000:]
    return out


@pytest.fixture(scope="module")
def jax_pipeline():
    blocks, head, x, tgt = J.pipe_inputs()
    blocks = {k: jnp.asarray(v) for k, v in blocks.items()}
    head = {k: jnp.asarray(v) for k, v in head.items()}
    x, tgt = jnp.asarray(x), jnp.asarray(tgt)
    m = jdist.init_parallel_env(pp=2)
    nm = J.PIPE["num_micro"]
    pspec = {"w": PartitionSpec("pp"), "b": PartitionSpec("pp")}
    stage = JP.blockwise_stage_fn(_jblock)
    try:
        def gpipe(p, x_):
            f = shard_map(lambda p_, xs: JP.pipeline_apply(stage, p_, xs,
                                                           axis="pp"),
                          mesh=m, in_specs=(pspec, PartitionSpec()),
                          out_specs=PartitionSpec(), check_rep=False)
            return JP.unmicrobatch(f(p, JP.microbatch(x_, nm)))

        out = gpipe(blocks, x)
        g_p, g_x = jax.grad(lambda p, x_: jnp.sum(gpipe(p, x_) ** 2),
                            argnums=(0, 1))(blocks, x)
        f1 = shard_map(
            lambda p_, hp, xs, ts: JP.pipeline_train_1f1b(
                lambda a, b, i: stage(a, b), _jhead, p_, hp, xs, ts,
                axis="pp"),
            mesh=m, in_specs=(pspec, PartitionSpec(), PartitionSpec(),
                              PartitionSpec()),
            out_specs=(PartitionSpec(), pspec, PartitionSpec(),
                       PartitionSpec()), check_rep=False)
        loss, sg, hg, dxs = f1(blocks, head, JP.microbatch(x, nm),
                               JP.microbatch(tgt, nm))
    finally:
        jmesh.set_mesh(None)

    def seq_total(p, hp, x_):  # the sequential reference of 1F1B
        def per(xm, tm):
            h = xm
            for i in range(J.PIPE["blocks"]):
                h = _jblock({"w": p["w"][i], "b": p["b"][i]}, h)
            return _jhead(hp, h, tm)
        return jnp.mean(jax.vmap(per)(JP.microbatch(x_, nm),
                                      JP.microbatch(tgt, nm)))

    seq = jax.value_and_grad(seq_total, argnums=(0, 1, 2))(blocks, head, x)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(out=np_(out), g_p=np_(g_p), g_x=np_(g_x),
                f1=np_((loss, sg, hg, JP.unmicrobatch(dxs))), seq=np_(seq))


def _stage_rows(a, r):
    per = a.shape[0] // 2
    return a[r * per:(r + 1) * per]


def test_gpipe_matches_jax_and_sequential(job, jax_pipeline):
    blocks, _, x, _ = J.pipe_inputs()
    h = x
    for i in range(J.PIPE["blocks"]):
        h = np.tanh(h @ blocks["w"][i] + blocks["b"][i])
    for r in range(2):
        got = J.result(job, "pipeline", r)
        np.testing.assert_allclose(got["gpipe/out"], jax_pipeline["out"],
                                   **OUT)
        np.testing.assert_allclose(got["gpipe/out"], h, **OUT)
        np.testing.assert_allclose(got["stage/out"], h, **OUT)
        np.testing.assert_allclose(got["gpipe/dx"], jax_pipeline["g_x"],
                                   **GRAD)
        for k in ("w", "b"):
            np.testing.assert_allclose(
                got[f"gpipe/d{k}"], _stage_rows(jax_pipeline["g_p"][k], r),
                **GRAD)


def test_1f1b_matches_jax_and_sequential(job, jax_pipeline):
    loss, sg, hg, dx = jax_pipeline["f1"]
    seq_loss, (seq_p, seq_h, seq_x) = jax_pipeline["seq"]
    for r in range(2):
        got = J.result(job, "pipeline", r)
        for want in (loss, seq_loss):
            np.testing.assert_allclose(got["1f1b/loss"], want,
                                       rtol=LOSS_RTOL)
        for want in (hg["w_out"], seq_h["w_out"]):
            np.testing.assert_allclose(got["1f1b/dw_out"], want, **GRAD)
        for want in (dx, seq_x):
            np.testing.assert_allclose(got["1f1b/dx"], want, **GRAD)
        for k in ("w", "b"):
            for want in (sg[k], seq_p[k]):
                np.testing.assert_allclose(got[f"1f1b/d{k}"],
                                           _stage_rows(want, r), **GRAD)


def test_microbatch_and_stacking_match_jax():
    x = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    t = TP.microbatch(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(
        JP.microbatch(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(TP.unmicrobatch(t).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        TP.microbatch(torch.from_numpy(x), 4)
    blocks = [{"w": np.full((2, 2), i, np.float32)} for i in range(3)]
    np.testing.assert_array_equal(
        TP.stack_block_params(blocks)["w"].numpy(),
        np.asarray(JP.stack_block_params(blocks)["w"]))
    with pytest.raises(ValueError, match="identical parameter"):
        TP.stack_block_params([{"w": torch.zeros(2)}, {"x": torch.zeros(2)}])


def test_single_stage_runs_the_blocks_in_order():
    blocks, head, x, tgt = J.pipe_inputs()
    from paddle_tpu_torch.parallel import mesh as TM

    pipe = TP.PipelineStage(
        lambda blk, h: torch.tanh(h @ blk["w"] + blk["b"]),
        {k: torch.from_numpy(v) for k, v in blocks.items()}, num_micro=2,
        mesh=TM.build_mesh(TM.MeshConfig(devices=[0])))
    h = x
    for i in range(J.PIPE["blocks"]):
        h = np.tanh(h @ blocks["w"][i] + blocks["b"][i])
    np.testing.assert_allclose(pipe(torch.from_numpy(x)).numpy(), h, **OUT)
    assert pipe.sharding_annotations() == {"w": ("pp", None, None),
                                           "b": ("pp", None)}
