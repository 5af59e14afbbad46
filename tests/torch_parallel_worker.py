"""A rank of a port parallel test job (see torch_parallel_job.py)::

    python -m paddle_tpu_torch.distributed.launch --nproc N \\
        tests/torch_parallel_worker.py OUT_DIR CASE [CASE ...]

Each rank asks for the CPU, joins the job through ``fleet.init()`` (gloo)
and runs the named cases in order, writing each one's arrays to
``OUT_DIR/<case>.rank<r>.npz``.  It imports neither jax nor paddle_tpu:
the tests compare the results with the JAX package in the pytest process.
"""
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_parallel_job as J  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _np(t):
    return t.detach().cpu().numpy()


@case
def all_reduce(rank, out_dir):
    from paddle_tpu_torch.distributed import all_reduce as ar

    x = torch.from_numpy(J.rank_array(rank, (3, 4), seed=1))
    res = {op: _np(ar(x, op=op)) for op in ("sum", "max", "min", "prod",
                                             "avg")}
    res["input_unchanged"] = np.array(np.array_equal(
        _np(x), J.rank_array(rank, (3, 4), seed=1)))
    return res


@case
def collectives(rank, out_dir):
    import paddle_tpu_torch.distributed as dist

    x = torch.from_numpy(J.rank_array(rank, (4, 6), seed=2))
    res = {"all_gather": _np(dist.all_gather(x)),
           "all_gather_axis1": _np(dist.all_gather(x, axis=1)),
           "reduce_scatter": _np(dist.reduce_scatter(x)),
           "a2a_s1_c0": _np(dist.all_to_all(x, split_axis=1, concat_axis=0)),
           "a2a_s0_c0": _np(dist.all_to_all(x)),
           "broadcast": _np(dist.broadcast(x, src=1)),
           "reduce": _np(dist.reduce(x, dst=0)),
           "absent_dim": _np(dist.all_reduce(x, group="tp")),
           "ppermute": _np(dist.ppermute(x, [(0, 1), (1, 0)])),
           "ppermute_one_edge": _np(dist.ppermute(x, [(0, 1)]))}
    chunks = [torch.full((2,), float(i)) for i in range(2)]
    res["scatter"] = _np(dist.scatter(None, tensor_list=chunks, src=0))
    parts = []
    dist.all_gather(parts, x)
    res["all_gather_list"] = np.stack([_np(p) for p in parts])
    g = dist.new_group(ranks=[0, 1])
    res["ranks_group"] = _np(dist.all_reduce(x, group=g))
    if rank == 0:
        dist.send(x * 3, dst=1)
        res["recv"] = np.zeros(0)
    else:
        buf = torch.empty_like(x)
        res["recv"] = _np(dist.recv(buf, src=0))
    dist.barrier()
    return res


@case
def compress2(rank, out_dir):
    from paddle_tpu_torch.distributed import all_reduce as ar
    from paddle_tpu_torch.parallel import compress as C

    x = torch.from_numpy(J.compress_input(rank))
    res = {}
    for kind in C.COMPRESS_KINDS:
        for bs in (64, 256):
            for denom in (None, 2):
                res[f"{kind}_{bs}_{denom}"] = _np(C.all_reduce_compressed(
                    x, "dp", compress=kind, block_size=bs, mean_denom=denom))
        res[f"api_{kind}"] = _np(ar(x, compress=kind, block_size=64))
        res[f"api_avg_{kind}"] = _np(ar(x, op="avg", compress=kind))
    res["flat_mean"] = _np(C.optimized_all_reduce(x, "dp", mean=True))
    with C.comm_scope(C.CommOptions(quantize="int8", block_size=64)):
        res["scoped"] = _np(ar(x))
        res["scoped_none"] = _np(ar(x, compress="none"))
    return res


@case
def hier(rank, out_dir):
    from paddle_tpu_torch.parallel import compress as C

    x = torch.from_numpy(J.compress_input(rank, n=1001))
    res = {}
    for kind in (None, "int8", "fp8"):
        for mean in (False, True):
            res[f"{kind}_{mean}"] = _np(C.optimized_all_reduce(
                x, "dp", compress=kind, block_size=64, hierarchy=2,
                mean=mean))
    res["tuple_fp32"] = _np(C.optimized_all_reduce(
        x, "dp", hierarchy=(2, 2), mean=True))
    return res


@case
def subgroup(rank, out_dir):
    import paddle_tpu_torch.distributed as dist

    groups = [dist.new_group(ranks=[0, 1]), dist.new_group(ranks=[2, 3])]
    g = groups[rank // 2]
    x = torch.from_numpy(J.rank_array(rank, (3, 4), seed=3))
    res = {op: _np(dist.all_reduce(x, op=op, group=g))
           for op in ("sum", "max", "min", "prod", "avg")}
    res["all_gather"] = _np(dist.all_gather(x, group=g))
    res["broadcast"] = _np(dist.broadcast(x, src=1, group=g))
    res["world_sum"] = _np(dist.all_reduce(x))
    return res


@case
def shard_batch(rank, out_dir):
    from paddle_tpu_torch.parallel import shard_batch as sb

    batch = {"x": np.arange(12.0).reshape(4, 3), "s": np.float32(2.0),
             "one": np.ones((1, 3))}
    got = sb(batch)
    res = {k: _np(v) for k, v in got.items()}
    try:
        sb({"bad": np.zeros((3, 2))})
    except ValueError:
        res["indivisible_raises"] = np.array(True)
    return res


def bn_params():
    rng = np.random.default_rng(9)
    return (1.0 + 0.1 * rng.normal(size=3)).astype(np.float32), \
        (0.1 * rng.normal(size=3)).astype(np.float32)


@case
def sync_bn(rank, out_dir):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn

    bn = nn.SyncBatchNorm(3)
    w, b = bn_params()
    bn.set_state_dict({"weight": w, "bias": b})
    bn.train()
    x = torch.from_numpy(J.rank_array(rank, J.BN_SHAPE, seed=11)) \
        .requires_grad_(True)
    ct = torch.from_numpy(J.rank_array(rank, J.BN_SHAPE, seed=12))
    out = bn(x)
    (out * ct).sum().backward()
    return {"out": _np(out), "x_grad": _np(x.grad),
            "w_grad": _np(dist.all_reduce(bn.weight.grad)),
            "b_grad": _np(dist.all_reduce(bn.bias.grad)),
            "running_mean": _np(bn._mean)}


@case
def metrics(rank, out_dir):
    from paddle_tpu_torch.metric import Auc
    from paddle_tpu_torch.parallel import metrics as M

    m = J.metric_inputs(rank)
    auc = Auc(num_thresholds=255)
    auc.update(m["preds"], m["labels"])
    return {"sum": _np(M.sum(m["value"])), "max": _np(M.max(m["value"])),
            "min": _np(M.min(m["value"])),
            "acc": _np(M.acc(m["correct"], m["total"])),
            "mae": _np(M.mae(m["abserr"], m["total"])),
            "rmse": _np(M.rmse(m["sqrerr"], m["total"])),
            "auc": np.array(M.auc(auc._stat_pos, auc._stat_neg))}


def _ernie(out_dir):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.text import ernie

    with np.load(Path(out_dir) / "ernie_params.npz") as z:
        params = {k: z[k] for k in z.files}
    model = ernie.ErnieForPretraining(ernie.ErnieConfig(**J.ERNIE),
                                      device="cpu")
    convert.from_jax_params(params, model)
    return model


def _capture(dopt):
    """The gradients the inner optimizer of ``dopt`` receives, per step."""
    seen = []
    update = dopt.inner.update

    def capturing(grads, state, params, lr=None):
        seen.append({k: v.clone() for k, v in grads.items()})
        return update(grads, state, params, lr)

    dopt.inner.update = capturing
    return seen


class _Capture:
    def update(self, grads, state, params, lr=None):
        return grads, state


def _batch(step):
    from paddle_tpu_torch.parallel import shard_batch as sb

    return {k: v.long() for k, v in sb(J.ernie_batch(step)).items()}


@case
def ernie_dp(rank, out_dir):
    """DataParallel + fleet's DistributedOptimizer(Adam) through
    ``entry.make_train_step``, 3 steps; then one step each with fleet's
    owned int8 / fp8 sync; and this rank's own first-step gradients."""
    from paddle_tpu_torch import convert, entry
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import DataParallel
    from paddle_tpu_torch.parallel.fleet import DistributedStrategy
    from paddle_tpu_torch.text import ernie

    crit = ernie.ErniePretrainingCriterion(J.ERNIE["vocab_size"])
    gen = torch.Generator().manual_seed(0)
    res = {}
    model = _ernie(out_dir)
    local, _, _ = entry.make_train_step(model, crit, _Capture())(
        convert.parameters_dict(model), None, _batch(0), gen)
    res.update({f"local/{k}": _np(v) for k, v in local.items()})

    dp = DataParallel(model, comm_buffer_size=J.ERNIE_BUFFER_MB)
    dopt = fleet.distributed_optimizer(Adam(learning_rate=J.ERNIE_LR),
                                       DistributedStrategy())
    seen = _capture(dopt)
    step = entry.make_train_step(dp, crit, dopt)
    params = convert.parameters_dict(model)
    state = dopt.init(params)
    losses = []
    for i in range(J.ERNIE_STEPS):
        params, state, loss = step(params, state, _batch(i), gen)
        losses.append(loss.item())
    res["losses"] = np.array(losses)
    res.update({f"grad/{k}": _np(v) for k, v in seen[0].items()})

    for kind in ("int8", "fp8"):
        model = _ernie(out_dir)
        strategy = DistributedStrategy()
        strategy.comm_quantize = kind
        strategy.comm_configs.buffer_size_mb = J.ERNIE_BUFFER_MB
        dopt = fleet.distributed_optimizer(
            Adam(learning_rate=J.ERNIE_LR), strategy)
        seen = _capture(dopt)
        step = entry.make_train_step(model, crit, dopt)
        params = convert.parameters_dict(model)
        step(params, dopt.init(params), _batch(0), gen)
        res.update({f"{kind}/{k}": _np(v) for k, v in seen[0].items()})
    return res


def main():
    out_dir = Path(sys.argv[1])
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import fleet, get_rank

    torch.set_num_threads(1)
    P.set_device("cpu")
    fleet.init()
    rank = get_rank()
    for name in sys.argv[2:]:
        res = CASES[name](rank, out_dir)
        tmp = out_dir / f".{name}.rank{rank}.npz"
        np.savez(tmp, **res)
        os.replace(tmp, out_dir / f"{name}.rank{rank}.npz")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
