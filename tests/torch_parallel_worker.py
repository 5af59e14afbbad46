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


# -- model-parallel cases ------------------------------------------------------

class _on_mesh:
    """Run a case on a mesh of these degrees, the job's default mesh
    restored afterwards."""

    def __init__(self, **degrees):
        self.degrees = degrees

    def __enter__(self):
        from paddle_tpu_torch.parallel import mesh as M

        self.old = M.get_mesh()
        m = M.build_mesh(M.MeshConfig(**dict({"dp": 1}, **self.degrees)))
        M.set_mesh(m)
        return m

    def __exit__(self, *exc):
        from paddle_tpu_torch.parallel import mesh as M

        M.set_mesh(self.old)


@case
def coll_grads(rank, out_dir):
    """Each differentiable collective on 2 ranks: its output and the
    gradient of <cotangent, output> for this rank's input."""
    from paddle_tpu_torch.parallel import collective as dist

    ops = {"all_reduce": lambda x: dist.all_reduce(x),
           "copy_to_group": lambda x: dist.copy_to_group(x),
           "all_gather": lambda x: dist.all_gather(x, axis=1),
           "reduce_scatter": lambda x: dist.reduce_scatter(x),
           "all_to_all": lambda x: dist.all_to_all(x, split_axis=1,
                                                   concat_axis=0)}
    for name, perm in J.COLL_PERMS.items():
        ops[name] = lambda x, perm=perm: dist.ppermute(x, perm)
    res = {}
    for i, (name, same_x, same_w) in enumerate(J.coll_ops()):
        x = torch.from_numpy(J.rank_array(0 if same_x else rank,
                                          J.COLL_SHAPE, seed=70 + i))
        x.requires_grad_(True)
        y = ops[name](x)
        w = torch.from_numpy(J.rank_array(0 if same_w else rank,
                                          tuple(y.shape), seed=90 + i))
        (y * w).sum().backward()
        res[f"{name}/y"], res[f"{name}/grad"] = _np(y), _np(x.grad)
    res["routes"] = np.array(sorted(dist.routes()))
    return res


def _seq_chunk(x, rank, n=2, dim=2):
    per = x.shape[dim] // n
    return np.ascontiguousarray(np.take(x, range(rank * per, (rank + 1) * per),
                                        axis=dim))


@case
def seq_attention(rank, out_dir):
    """ring_attention and ulysses_attention on sp=2, causal and not: this
    rank's output and the gradients of <cotangent, output>."""
    from paddle_tpu_torch.parallel import ring_attention as R

    q, k, v, ct = J.attn_inputs()
    res = {}
    with _on_mesh(sp=2):
        for name, fn in (("ring", R.ring_attention),
                         ("ulysses", R.ulysses_attention)):
            for causal in (False, True):
                qkv = [torch.from_numpy(_seq_chunk(t, rank)).requires_grad_()
                       for t in (q, k, v)]
                out = fn(*qkv, axis="sp", causal=causal)
                (out * torch.from_numpy(_seq_chunk(ct, rank))).sum().backward()
                tag = f"{name}/{int(causal)}"
                res[f"{tag}/out"] = _np(out)
                for n_, t in zip("qkv", qkv):
                    res[f"{tag}/d{n_}"] = _np(t.grad)
    return res


@case
def pipeline(rank, out_dir):
    """GPipe (pipeline_apply and PipelineStage) and 1F1B on pp=2, 2 blocks
    a stage, the block tanh(x W + b)."""
    from paddle_tpu_torch.parallel import pipeline as PL
    from paddle_tpu_torch.parallel import sharding as S

    blocks, head, x, tgt = J.pipe_inputs()

    def block_fn(blk, h):
        return torch.tanh(h @ blk["w"] + blk["b"])

    def head_loss(hp, y, t, micro_idx=0):
        return ((y @ hp["w_out"] - t) ** 2).mean()

    res = {}
    with _on_mesh(pp=2) as m:
        local = {k: S.place(torch.from_numpy(v), S.PartitionSpec("pp"), m)
                 .requires_grad_() for k, v in blocks.items()}
        xs = torch.from_numpy(x).requires_grad_()
        stage = PL.blockwise_stage_fn(block_fn)
        out = PL.unmicrobatch(PL.pipeline_apply(
            stage, local, PL.microbatch(xs, J.PIPE["num_micro"]), axis="pp"))
        (out ** 2).sum().backward()
        res["gpipe/out"], res["gpipe/dx"] = _np(out), _np(xs.grad)
        for k, t in local.items():
            res[f"gpipe/d{k}"] = _np(t.grad)
        pipe = PL.PipelineStage(block_fn, {k: torch.from_numpy(v)
                                           for k, v in blocks.items()},
                                num_micro=2, mesh=m)
        pipe.shard_params()
        with torch.no_grad():
            res["stage/out"] = _np(pipe(torch.from_numpy(x)))
        loss, sg, hg, dxs = PL.pipeline_train_1f1b(
            lambda p, h, b: stage(p, h), head_loss,
            {k: t.detach() for k, t in local.items()},
            {k: torch.from_numpy(v) for k, v in head.items()},
            PL.microbatch(torch.from_numpy(x), J.PIPE["num_micro"]),
            PL.microbatch(torch.from_numpy(tgt), J.PIPE["num_micro"]),
            axis="pp")
        res["1f1b/loss"] = _np(loss)
        res["1f1b/dx"] = _np(PL.unmicrobatch(dxs))
        res["1f1b/dw_out"] = _np(hg["w_out"])
        for k, t in sg.items():
            res[f"1f1b/d{k}"] = _np(t)
    return res


@case
def moe_ep2(rank, out_dir):
    """MoEFFN (top-2 and top-1) on ep=2, each rank on its half of the
    batch: its output, the gradients of <cotangent, output> (the gate's
    summed over the ranks), its experts' gradients and the aux loss."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import all_reduce
    from paddle_tpu_torch.parallel import sharding as S

    w, x, ct = J.moe_inputs()
    half = J.MOE["batch"] // 2
    res = {}
    with _on_mesh(ep=2) as m:
        for top_k in (2, 1):
            layer = nn.MoEFFN(J.MOE["d"], J.MOE["f"], J.MOE["experts"],
                              top_k=top_k,
                              capacity_factor=J.MOE["capacity_factor"])
            layer.set_state_dict(w)
            S.shard_layer(layer, m)
            xi = torch.from_numpy(x[rank * half:(rank + 1) * half]) \
                .requires_grad_()
            y = layer(xi)
            (y * torch.from_numpy(ct[rank * half:(rank + 1) * half])) \
                .sum().backward()
            tag = f"top{top_k}"
            res.update({f"{tag}/y": _np(y), f"{tag}/dx": _np(xi.grad),
                        f"{tag}/aux": _np(layer.aux_loss),
                        f"{tag}/dgate": _np(all_reduce(
                            layer.gate_weight.grad)),
                        f"{tag}/dwi": _np(layer.wi.grad),
                        f"{tag}/dwo": _np(layer.wo.grad)})
    return res


@case
def shard_batch_seq(rank, out_dir):
    """shard_batch with seq_axis on a dp2 x sp2 mesh."""
    from paddle_tpu_torch.parallel import shard_batch as sb

    with _on_mesh(dp=2, sp=2):
        res = {k: _np(v) for k, v in sb(J.seq_batch(),
                                         seq_axis="sp").items()}
        try:
            sb({"bad": np.zeros((3, 4))}, seq_axis="sp")
        except ValueError:
            res["indivisible_raises"] = np.array(True)
    return res


@case
def group_dp_sp(rank, out_dir):
    """An all-reduce over a group of two dims of a dp2 x sp2 mesh."""
    import paddle_tpu_torch.distributed as dist

    x = torch.from_numpy(J.rank_array(rank, (3,), seed=80))
    with _on_mesh(dp=2, sp=2) as m:
        return {"sum_dp_sp": _np(dist.all_reduce(x, group=("dp", "sp"))),
                "sum_sp": _np(dist.all_reduce(x, group="sp")),
                "coords": np.array([m.axis_index("dp"), m.axis_index("sp")])}


@case
def elastic_save_dp4(rank, out_dir):
    """Four ranks write two checkpoints of ``elastic_state``: ZeRO-3 (each
    leaf this rank's placed slice) and ZeRO-1 (the moments this rank's dp
    slice, the parameters whole)."""
    from paddle_tpu_torch.elastic import checkpoint as ec
    from paddle_tpu_torch.parallel.sharding import ShardingPlan, place

    st = J.elastic_state()
    plan3 = ShardingPlan(zero_stage=3, donate=False)
    specs = plan3.state_shardings(st)
    ec.save_checkpoint(str(Path(out_dir) / "port_zero3"),
                       {k: place(v, specs[k]) for k, v in st.items()}, 7,
                       plan=plan3)
    plan1 = ShardingPlan(zero_stage=1, donate=False)
    specs1 = plan1.state_shardings(st, optimizer_slots=J.ELASTIC_SLOTS)
    local = {k: place(v, specs1[k]) if k in J.ELASTIC_SLOTS
             else torch.from_numpy(np.asarray(v)) for k, v in st.items()}
    ec.save_checkpoint(str(Path(out_dir) / "port_zero1"), local, 8,
                       plan=plan1, optimizer_slots=J.ELASTIC_SLOTS)
    return {"plan3": np.array(plan3.fingerprint()),
            "moment_rows": np.array(local["opt/w.m"].shape[0])}


@case
def elastic_restore_dp2(rank, out_dir):
    """Two ranks restore the JAX package's 4-way ZeRO-3 checkpoint under a
    dp2 ZeRO-3 plan and the 4-rank ZeRO-1 one under a dp2 ZeRO-1 plan;
    each rank's slices, their specs and the reshard counts."""
    from paddle_tpu_torch.elastic import checkpoint as ec
    from paddle_tpu_torch.parallel.sharding import ShardingPlan, slice_spec

    res = {}
    for tag, plan, slots in (
            ("jax3", ShardingPlan(zero_stage=3, donate=False), None),
            ("zero1", ShardingPlan(zero_stage=1, donate=False),
             J.ELASTIC_SLOTS)):
        ckpt = "jax_zero3" if tag == "jax3" else "port_zero1"
        state, meta = ec.restore_checkpoint(str(Path(out_dir) / ckpt),
                                            plan=plan, optimizer_slots=slots)
        res[f"{tag}/resharded"] = np.array(meta["resharded_leaves"])
        res[f"{tag}/step"] = np.array(meta["step"])
        for k, v in state.items():
            res[f"{tag}/{k}"] = _np(v)
            marked = slice_spec(v)
            res[f"{tag}/spec/{k}"] = np.array(
                repr(None if marked is None else marked[0]))
    return res


class _GradCapture:
    """An optimizer whose update keeps the gradients and moves nothing."""

    def init(self, params):
        return {}

    def update(self, grads, state, params, lr=None):
        self.grads = {k: v.detach().clone() for k, v in grads.items()}
        return params, state


def _hybrid_run(name, rank, out_dir):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.fleet import DistributedStrategy
    from paddle_tpu_torch.text.ernie import ErnieConfig
    from paddle_tpu_torch.text.pretrainer import HybridPretrainer

    degrees, num_micro, schedule, experts, zero = J.HYBRID_MESHES[name]
    with np.load(Path(out_dir) / f"hybrid_params_{experts}.npz") as z:
        whole = J.nested_params({k: z[k] for k in z.files})
    batch = J.hybrid_batch()
    res = {}
    with _on_mesh(**degrees) as m:
        strategy = DistributedStrategy()
        strategy.pipeline = True
        strategy.pipeline_configs.schedule = schedule
        strategy.pipeline_configs.micro_batch = num_micro
        strategy.sequence_parallel = "sp" in degrees
        strategy.sharding = zero

        def trainer():
            return HybridPretrainer(ErnieConfig(**J.HYBRID), mesh=m,
                                    moe_experts=experts, strategy=strategy,
                                    device="cpu")

        tr = trainer()
        placed = convert.hybrid_params_from_jax(whole, tr)
        local = tr.place_batch(batch)
        gen = torch.Generator().manual_seed(0)
        strategy.sharding = False  # the gradients whole on every dp rank
        cap = _GradCapture()
        tr_cap = trainer()
        _, _, loss = tr_cap.make_train_step(cap)(
            placed, tr_cap.init_opt_state(cap, placed), local, gen)
        res["loss"] = _np(loss)
        full = tr.unshard_params(J.nested_params(cap.grads))
        res.update({f"grad/{k}": _np(v)
                    for k, v in J.flat_params(full).items()})
        if zero:
            strategy.sharding = True
            for tag, t in (("zero", tr), ("plain", tr_cap)):
                p = convert.hybrid_params_from_jax(whole, t)
                opt = Adam(learning_rate=1e-3)
                st = t.init_opt_state(opt, p)
                p, st, _ = t.make_train_step(opt)(p, st, local, gen)
                res.update({f"{tag}/{k}": _np(v) for k, v in J.flat_params(
                    t.unshard_params(p)).items()})
                res[f"{tag}/moment_bytes"] = np.array(sum(
                    s.numel() * s.element_size()
                    for slots in st["per_param"].values() for s in slots
                    if torch.is_tensor(s)))
    return res


for _name in J.HYBRID_MESHES:
    CASES[f"hybrid_{_name}"] = (
        lambda rank, out_dir, _n=_name: _hybrid_run(_n, rank, out_dir))


def main():
    out_dir = Path(sys.argv[1])
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import (fleet, get_rank,
                                              shutdown_parallel_env)

    torch.set_num_threads(1)
    P.set_device("cpu")
    fleet.init()
    rank = get_rank()
    for name in sys.argv[2:]:
        res = CASES[name](rank, out_dir)
        tmp = out_dir / f".{name}.rank{rank}.npz"
        np.savez(tmp, **res)
        os.replace(tmp, out_dir / f"{name}.rank{rank}.npz")
    # a barrier, then the process groups destroyed and collected while
    # the interpreter is whole (a group left to interpreter exit aborted
    # the rank with "terminate called without an active exception")
    shutdown_parallel_env()


if __name__ == "__main__":
    main()
