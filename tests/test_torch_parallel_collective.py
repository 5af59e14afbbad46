"""The port's collectives, compressed all-reduce, shard_batch,
SyncBatchNorm and distributed metrics on 2 (and 4) gloo ranks on the CPU,
against the JAX package.

One job of the port's launcher per rank count runs every case
(torch_parallel_job.py); each parametrised test reads one case's results.
Tolerances:

* collectives: the JAX package's eager collectives over 2 (or, for a
  subgroup, a 2 x 2 mesh's "tp" dim over 4) virtual devices on the same
  per-rank inputs, rtol 1e-6 (sums of 2 fp32 values; 0 difference
  expected), exact for data movement;
* compressed / hierarchical all-reduce: a numpy oracle of the algorithm
  (paddle_tpu/parallel/compress.py:221-270 and :296-318) built on the JAX
  package's ``quantize_blockwise`` / ``dequantize_blockwise``: atol
  1e-6 of the largest output value (fp32 sums of the peers'
  contributions in another order; 2 ranks give 0).  The JAX routes
  themselves fail on this jax (ROADMAP.md Queue 3);
* SyncBatchNorm: the JAX ``F.batch_norm`` in training on the
  concatenated batch, rtol/atol 1e-5 (mean of squares minus the squared
  mean against the centred variance);
* metrics: the JAX ``parallel.metrics`` functions on the summed values,
  rtol 1e-6 (the JAX ones compute in fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import paddle_tpu.distributed as jdist
from paddle_tpu.parallel import compress as JC
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import metrics as jmetrics
import torch_parallel_job as J

RANKS = (0, 1)


@pytest.fixture(scope="module")
def job2(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel2")
    rc, secs, log = J.run_job(out, 2, ["all_reduce", "collectives",
                                       "compress2", "shard_batch", "sync_bn",
                                       "metrics"])
    assert rc == 0, log[-4000:]
    return out


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel4")
    rc, secs, log = J.run_job(out, 4, ["hier", "subgroup"])
    assert rc == 0, log[-4000:]
    return out


@pytest.fixture
def jax_mesh():
    """A JAX mesh over the first n virtual devices, set as the global one."""
    def make(n=2, **axes):
        m = jmesh.build_mesh(jmesh.MeshConfig(
            **(axes or {"dp": n}), devices=jax.devices()[:n]))
        jmesh.set_mesh(m)
        return m
    yield make
    jmesh.set_mesh(None)


def _sharded(m, parts, spec=P("dp")):
    return jax.device_put(np.concatenate(parts), NamedSharding(m, spec))


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_all_reduce_ops_match_the_jax_eager_collective(job2, jax_mesh, op):
    m = jax_mesh()
    xs = [J.rank_array(r, (3, 4), seed=1) for r in RANKS]
    ref = np.asarray(jdist.all_reduce(_sharded(m, xs), op=op))
    for r in RANKS:
        got = J.result(job2, "all_reduce", r)
        np.testing.assert_allclose(got[op], ref, rtol=1e-6, atol=0)
        assert got["input_unchanged"]


def _collective_refs(m):
    xs = [J.rank_array(r, (4, 6), seed=2) for r in RANKS]
    x = _sharded(m, xs)
    gathered = np.asarray(jdist.all_gather(x))
    scattered = np.asarray(jdist.reduce_scatter(x))
    a2a = np.asarray(jdist.all_to_all(x, split_axis=1, concat_axis=0))
    a2a00 = np.asarray(jdist.all_to_all(x))
    refs = []
    for r in RANKS:
        refs.append({
            "all_gather": gathered,
            "all_gather_axis1": np.concatenate(xs, axis=1),
            "reduce_scatter": scattered[2 * r:2 * r + 2],
            "a2a_s1_c0": a2a[:, 3 * r:3 * r + 3],
            "a2a_s0_c0": a2a00[4 * r:4 * r + 4],
            "broadcast": np.asarray(jdist.broadcast(x, src=1)),
            "reduce": np.asarray(jdist.reduce(x, dst=0)),
            "absent_dim": xs[r],
            "ppermute": xs[1 - r],
            "ppermute_one_edge": xs[0] if r == 1 else np.zeros_like(xs[0]),
            "scatter": np.full((2,), float(r), np.float32),
            "all_gather_list": np.stack(xs),
            "ranks_group": np.asarray(jdist.all_reduce(x)),
        })
    chunks = [jnp.full((2,), float(i)) for i in range(2)]
    scat = np.asarray(jdist.scatter(None, tensor_list=chunks, src=0))
    for r in RANKS:
        np.testing.assert_array_equal(refs[r]["scatter"], scat[r])
    return xs, refs


COLLECTIVES = ["all_gather", "all_gather_axis1", "reduce_scatter",
               "a2a_s1_c0", "a2a_s0_c0", "broadcast", "reduce", "absent_dim",
               "ppermute", "ppermute_one_edge", "scatter", "all_gather_list",
               "ranks_group", "recv"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_match_the_jax_eager_collectives(job2, jax_mesh, name):
    """Data movement exact; the sums (reduce_scatter, reduce, the ranks
    group) within rtol 1e-6.  send / recv and ppermute have no eager JAX
    counterpart (they raise there): they are held against the inputs."""
    xs, refs = _collective_refs(jax_mesh())
    for r in RANKS:
        got = J.result(job2, "collectives", r)[name]
        if name == "recv":
            want = xs[0] * 3 if r == 1 else np.zeros(0)
        else:
            want = refs[r][name]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("op", ["sum", "max", "min", "prod", "avg"])
def test_subgroup_matches_a_jax_mesh_dim(job4, jax_mesh, op):
    """Ranks {0, 1} and {2, 3} as groups against the "tp" dim of a
    dp 2 x tp 2 JAX mesh (device index dp * 2 + tp)."""
    m = jax_mesh(4, dp=2, tp=2)
    xs = [J.rank_array(r, (3, 4), seed=3) for r in range(4)]
    x = _sharded(m, xs, P(("dp", "tp")))
    ref = np.asarray(jdist.all_reduce(x, op=op, group="tp"))
    for r in range(4):
        got = J.result(job4, "subgroup", r)
        np.testing.assert_allclose(got[op], ref[3 * (r // 2):3 * (r // 2) + 3],
                                   rtol=1e-6, atol=0)
        pair = xs[2 * (r // 2):2 * (r // 2) + 2]
        np.testing.assert_array_equal(got["all_gather"],
                                      np.concatenate(pair))
        np.testing.assert_array_equal(got["broadcast"], pair[1])
        np.testing.assert_allclose(got["world_sum"], sum(xs), rtol=1e-6)


# -- compressed all-reduce against an oracle on the JAX quantizer --------------

def _jq(flat, kind, bs):
    q, s = JC.quantize_blockwise(jnp.asarray(flat), kind, bs)
    return np.asarray(q), np.asarray(s)


def _jdq(q, s, bs):
    return np.asarray(JC.dequantize_blockwise(jnp.asarray(q),
                                              jnp.asarray(s), bs))


def _oracle_compressed(xs, kind, bs, mean_denom=None):
    """compress.py:221-270 in numpy around the JAX quantizer: every rank
    quantizes its padded vector, member j sums every rank's dequantized
    chunk j in fp32 (rank order), divides, re-quantizes; all gather."""
    n, m = len(xs), xs[0].size
    pad = (-m) % (n * bs)
    flats = [np.concatenate([x.reshape(-1).astype(np.float32),
                             np.zeros(pad, np.float32)]) for x in xs]
    qs = [_jq(f, kind, bs) for f in flats]
    k = flats[0].size // n
    out = []
    for j in range(n):
        acc = np.zeros(k, np.float32)
        for q, s in qs:
            acc = acc + _jdq(q[j * k:(j + 1) * k],
                             s[j * k // bs:(j + 1) * k // bs], bs)
        if mean_denom:
            acc = acc / np.float32(mean_denom)
        out.append(_jdq(*_jq(acc, kind, bs), bs))
    return np.concatenate(out)[:m].reshape(xs[0].shape)


def _oracle_hierarchical(xs, kind, bs, intra, mean):
    """compress.py:296-318 in numpy: intra-host reduce-scatter (fp32, rank
    order), the inter-host all-reduce of each shard (plain or the
    compressed oracle), the intra-host all-gather."""
    n, m = len(xs), xs[0].size
    pad = (-m) % intra
    flats = [np.concatenate([x.reshape(-1), np.zeros(pad, np.float32)])
             for x in xs]
    k = flats[0].size // intra
    hosts = n // intra
    shards = {}     # (host, member) -> reduce-scattered shard
    for h in range(hosts):
        for i in range(intra):
            acc = np.zeros(k, np.float32)
            for j in range(intra):
                acc = acc + flats[h * intra + j][i * k:(i + 1) * k]
            shards[h, i] = acc
    full = {}
    for i in range(intra):
        peers = [shards[h, i] for h in range(hosts)]
        if kind is None:
            red = np.zeros(k, np.float32)
            for p in peers:
                red = red + p
            if mean:
                red = red / np.float32(n)
        else:
            red = _oracle_compressed(peers, kind, bs, n if mean else None)
        full[i] = red
    return np.concatenate([full[i] for i in range(intra)])[:m]


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("bs", [64, 256])
@pytest.mark.parametrize("denom", [None, 2])
def test_compressed_all_reduce_matches_the_oracle(job2, kind, bs, denom):
    xs = [J.compress_input(r) for r in RANKS]
    want = _oracle_compressed(xs, kind, bs, denom)
    for r in RANKS:
        got = J.result(job2, "compress2", r)[f"{kind}_{bs}_{denom}"]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_all_reduce_compress_argument_and_scope(job2, kind):
    """``all_reduce(compress=)``, its AVG, and the ambient comm_scope (with
    "none" forcing full precision inside it)."""
    xs = [J.compress_input(r) for r in RANKS]
    for r in RANKS:
        got = J.result(job2, "compress2", r)
        np.testing.assert_allclose(got[f"api_{kind}"],
                                   _oracle_compressed(xs, kind, 64), atol=0)
        np.testing.assert_allclose(got[f"api_avg_{kind}"],
                                   _oracle_compressed(xs, kind, 256, 2),
                                   atol=0)
        # the scope gives the payload kind; the block size is all_reduce's
        # own (256), as in the JAX package
        np.testing.assert_allclose(got["scoped"],
                                   _oracle_compressed(xs, "int8", 256),
                                   atol=0)
        np.testing.assert_allclose(got["scoped_none"], xs[0] + xs[1],
                                   rtol=1e-7)
        np.testing.assert_allclose(got["flat_mean"], (xs[0] + xs[1]) / 2,
                                   rtol=1e-7)


@pytest.mark.parametrize("kind", [None, "int8", "fp8"])
@pytest.mark.parametrize("mean", [False, True])
def test_hierarchical_all_reduce_on_4_ranks_matches_the_oracle(job4, kind,
                                                               mean):
    xs = [J.compress_input(r, n=1001) for r in range(4)]
    want = _oracle_hierarchical(xs, kind, 64, 2, mean)
    for r in range(4):
        got = J.result(job4, "hier", r)[f"{kind}_{mean}"]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
        if kind is None and mean:
            np.testing.assert_allclose(J.result(job4, "hier", r)["tuple_fp32"],
                                       want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())


# -- shard_batch, SyncBatchNorm, metrics ---------------------------------------

def test_shard_batch_splits_the_leading_dim_and_replicates_the_rest(job2):
    for r in RANKS:
        got = J.result(job2, "shard_batch", r)
        np.testing.assert_array_equal(got["x"],
                                      np.arange(12.0).reshape(4, 3)[2 * r:2 * r + 2])
        assert float(got["s"]) == 2.0
        np.testing.assert_array_equal(got["one"], np.ones((1, 3)))
        assert got["indivisible_raises"]


def _jax_bn(x, ct, w, b):
    from paddle_tpu.nn import functional as JF

    def f(x, w, b):
        out, _, _ = JF.batch_norm(x, jnp.zeros(3), jnp.ones(3), w, b,
                                  training=True, epsilon=1e-5)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(x, w, b)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("what", ["out", "x_grad", "w_grad", "b_grad"])
def test_sync_batch_norm_matches_batch_norm_on_the_whole_batch(job2, what):
    """Each rank's forward and input gradient are its slice of the JAX
    BatchNorm's on the concatenated batch; the parameter gradients summed
    over the ranks are the JAX ones.  The running statistics stay as they
    were (the JAX sync route does not update them)."""
    from torch_parallel_worker import bn_params

    w, b = bn_params()
    xs = [J.rank_array(r, J.BN_SHAPE, seed=11) for r in RANKS]
    cts = [J.rank_array(r, J.BN_SHAPE, seed=12) for r in RANKS]
    out, (gx, gw, gb) = _jax_bn(jnp.asarray(np.concatenate(xs)),
                                jnp.asarray(np.concatenate(cts)),
                                jnp.asarray(w), jnp.asarray(b))
    n = J.BN_SHAPE[0]
    for r in RANKS:
        got = J.result(job2, "sync_bn", r)
        want = {"out": out[r * n:(r + 1) * n], "x_grad": gx[r * n:(r + 1) * n],
                "w_grad": gw, "b_grad": gb}[what]
        np.testing.assert_allclose(got[what], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["running_mean"], np.zeros(3))


@pytest.mark.parametrize("name", ["sum", "max", "min", "acc", "mae", "rmse",
                                  "auc"])
def test_distributed_metrics_match_the_reference_on_merged_values(job2, name):
    from paddle_tpu.metric import Auc as JAuc

    ms = [J.metric_inputs(r) for r in RANKS]
    tot = {k: ms[0][k] + ms[1][k] for k in ("correct", "total", "abserr",
                                             "sqrerr")}
    if name == "auc":
        stats = []
        for m in ms:
            a = JAuc(num_thresholds=255)
            a.update(m["preds"], m["labels"])
            stats.append(a)
        want = jmetrics.auc(stats[0]._stat_pos + stats[1]._stat_pos,
                            stats[0]._stat_neg + stats[1]._stat_neg)
    elif name in ("sum", "max", "min"):
        op = {"sum": np.add, "max": np.maximum, "min": np.minimum}[name]
        want = op(ms[0]["value"], ms[1]["value"])
        np.testing.assert_allclose(
            np.asarray(getattr(jmetrics, name)(jnp.asarray(want))), want)
    elif name == "acc":
        want = jmetrics.acc(tot["correct"], tot["total"])
    elif name == "mae":
        want = jmetrics.mae(tot["abserr"], tot["total"])
    else:
        want = jmetrics.rmse(tot["sqrerr"], tot["total"])
    for r in RANKS:
        np.testing.assert_allclose(J.result(job2, "metrics", r)[name],
                                   np.asarray(want), rtol=1e-6)
