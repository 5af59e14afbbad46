"""Sequence parallelism and the differentiable collectives on 2 gloo ranks
on the CPU (the shared 2-rank job of tests/torch_parallel_job.py).

* Each differentiable collective (all_reduce and copy_to_group,
  all_gather / reduce_scatter, the tiled all_to_all, ppermute): each
  rank's output and the gradient of sum_r <w_r, y_r> for its input
  against autograd through the gathered computation in one process
  (the sum's output is consumed the same on every rank, so there the
  loss is <w, y> counted once); exact to 1e-6.
* ``ring_attention`` and ``ulysses_attention``, causal and not, on sp=2:
  each rank's output and its q / k / v gradients against the JAX
  functions under ``shard_map`` on 2 of the 8 virtual CPU devices, at
  the JAX package's own tolerance (rtol 2e-4, atol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import paddle_tpu.distributed as jdist
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel.collective import shard_map
from paddle_tpu.parallel.ring_attention import (
    ring_attention as jax_ring,
    ulysses_attention as jax_ulysses,
)
import torch_parallel_job as J

EXACT = 1e-6
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def job():
    out, rc, log = J.pair_job()
    assert rc == 0, log[-4000:]
    return out


def _gathered(name, xs):
    """Every rank's output of collective ``name`` from all ranks' inputs,
    computed in one process."""
    n = len(xs)
    if name == "all_reduce":
        return [xs[0] + xs[1]] * n
    if name == "copy_to_group":
        return list(xs)
    if name == "all_gather":
        return [torch.cat(xs, dim=1)] * n
    if name == "reduce_scatter":
        return list(torch.chunk(xs[0] + xs[1], n, dim=0))
    if name == "all_to_all":
        return [torch.cat([torch.chunk(x, n, dim=1)[r] for x in xs], dim=0)
                for r in range(n)]
    perm = J.COLL_PERMS[name]
    out = [torch.zeros_like(xs[0]) for _ in range(n)]
    for s, d in perm:
        out[d] = xs[s]
    return out


@pytest.mark.parametrize("i,name,same_x,same_w",
                         [(i,) + op for i, op in enumerate(J.coll_ops())],
                         ids=[op[0] for op in J.coll_ops()])
def test_collective_backward_is_its_transpose(job, i, name, same_x, same_w):
    got = [J.result(job, "coll_grads", r) for r in range(2)]
    if same_x:
        x = torch.from_numpy(J.rank_array(0, J.COLL_SHAPE, seed=70 + i))
        x.requires_grad_(True)
        xs, leaves = [x, x], [x]
    else:
        xs = [torch.from_numpy(J.rank_array(r, J.COLL_SHAPE, seed=70 + i))
              .requires_grad_(True) for r in range(2)]
        leaves = xs
    ys = _gathered(name, xs)
    ws = [torch.from_numpy(J.rank_array(0 if same_w else r,
                                        tuple(ys[r].shape), seed=90 + i))
          for r in range(2)]
    if name == "all_reduce":  # consumed the same on every rank: once
        loss = (ys[0] * ws[0]).sum()
    else:
        loss = sum((y * w).sum() for y, w in zip(ys, ws))
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    for r in range(2):
        np.testing.assert_allclose(got[r][f"{name}/y"], ys[r].detach().numpy(),
                                   rtol=0, atol=EXACT)
        want = grads[0] if same_x else grads[r]
        np.testing.assert_allclose(got[r][f"{name}/grad"], want.numpy(),
                                   rtol=0, atol=EXACT)


def test_collectives_took_the_gloo_cpu_routes(job):
    routes = set(J.result(job, "coll_grads", 0)["routes"])
    assert "ppermute as point_to_point (gloo, cpu)" in routes
    assert "all_to_all_single (gloo, cpu)" in routes
    assert "reduce_scatter (gloo, cpu)" in routes


@pytest.fixture(scope="module")
def jax_attention():
    """The JAX functions' outputs and q / k / v gradients on sp=2."""
    q, k, v, ct = (jnp.asarray(a) for a in J.attn_inputs())
    m = jdist.init_parallel_env(sp=2)
    out = {}
    try:
        for name, fn in (("ring", jax_ring), ("ulysses", jax_ulysses)):
            for causal in (False, True):
                f = shard_map(
                    lambda q_, k_, v_, fn=fn, c=causal: fn(
                        q_, k_, v_, axis="sp", causal=c),
                    mesh=m, in_specs=(PartitionSpec(None, None, "sp"),) * 3,
                    out_specs=PartitionSpec(None, None, "sp"),
                    check_rep=False)
                y = f(q, k, v)
                grads = jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) * ct),
                                 argnums=(0, 1, 2))(q, k, v)
                out[(name, causal)] = (np.asarray(y),) + tuple(
                    np.asarray(g) for g in grads)
    finally:
        jmesh.set_mesh(None)
    return out


@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_sequence_parallel_attention_matches_jax(job, jax_attention, name,
                                                 causal):
    y, dq, dk, dv = jax_attention[(name, causal)]
    per = J.ATTN["s"] // 2
    for r in range(2):
        got = J.result(job, "seq_attention", r)
        tag = f"{name}/{int(causal)}"
        sl = slice(r * per, (r + 1) * per)
        for key, want in (("out", y), ("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(got[f"{tag}/{key}"],
                                       want[:, :, sl], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag} {key} rank {r}")
