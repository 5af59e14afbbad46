"""Pipeline parallelism over the ``pp`` mesh dim (counterpart of
paddle_tpu/parallel/pipeline.py).

Reference parity: ``PipelineOptimizer`` (python/paddle/fluid/optimizer.py
:3661) splits a program into per-device sections that ``SectionWorker``
threads run, connected by queues (framework/device_worker.h:415); the
micro-batch count comes from PipelineConfig
(framework/distributed_strategy.proto:92).

The JAX package runs the schedule as one SPMD scan under ``shard_map``,
activations rotating with ``lax.ppermute`` each tick, and differentiates
it.  In the port each pp rank is a process holding its stage's blocks
(the leading block dim split over pp); the ticks are a Python loop and
each tick's activations go to the next stage with ``ppermute`` (the
backward's cotangents to the previous one).  A rank runs its stage only
on the ticks where a micro-batch is there, but takes part in every
tick's ppermute, so the collectives line up across ranks.

* ``pipeline_apply`` (GPipe): every micro-batch's forward, then every
  backward in reverse tick order, written out in an autograd Function;
  each micro-batch's stage graph is kept from its forward to its
  backward (activations of all micro-batches live at once).
* ``pipeline_train_1f1b``: one forward and one backward slot a tick; a
  stage keeps only the inputs of the micro-batches in flight (at most
  2 pp - 1) and recomputes a micro-batch's forward in its backward slot,
  so the block activations of one micro-batch live at a time.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from . import collective as _coll
from . import mesh as _mesh

__all__ = [
    "microbatch", "unmicrobatch", "pipeline_apply", "pipeline_train_1f1b",
    "stack_block_params", "blockwise_stage_fn", "PipelineStage",
]


def microbatch(x, num_micro: int):
    """[B, ...] -> [num_micro, B / num_micro, ...]."""
    if x.shape[0] % num_micro != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by micro-batch count {num_micro}")
    return x.reshape((num_micro, x.shape[0] // num_micro) + tuple(x.shape[1:]))


def unmicrobatch(x):
    """Inverse of microbatch."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


class _Ring:
    """The pp group of this rank: its size, this rank's stage, and the
    global rank of a stage (for broadcasts)."""

    def __init__(self, axis: str):
        self.pg = _coll._resolve(axis).process_group()
        self.n = 1 if self.pg is None else dist.get_world_size(self.pg)
        self.me = 0 if self.pg is None else dist.get_rank(self.pg)
        self.down = tuple((i, i + 1) for i in range(self.n - 1))
        self.up = tuple((i + 1, i) for i in range(self.n - 1))

    def permute(self, x, perm):
        return x if self.pg is None else _coll._raw_ppermute(x, self.pg, perm)

    def broadcast(self, x, stage):
        """Stage ``stage``'s ``x`` on every stage (``x`` on the others is
        overwritten; its shape and dtype must match)."""
        if self.pg is None:
            return x
        x = x.contiguous()
        dist.broadcast(x, src=dist.get_global_rank(self.pg, stage),
                       group=self.pg)
        return x


def _grads(outputs, inputs, cot):
    return torch.autograd.grad(outputs, inputs, cot, allow_unused=True)


def _acc(acc, grads):
    """``acc`` plus ``grads`` slot by slot (None: nothing yet)."""
    return [a if g is None else g if a is None else a + g
            for a, g in zip(acc, grads)]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, ring, names, xs, *leaves):
        num_micro = xs.shape[0]
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        bound = dict(zip(names, params))
        graphs, outs = {}, torch.zeros_like(xs)
        state = None
        for t in range(num_micro + ring.n - 1):
            b = t - ring.me
            send = None
            if 0 <= b < num_micro:
                x_in = (xs[b] if ring.me == 0 else state).detach()
                x_in.requires_grad_(True)
                with torch.enable_grad():
                    y = stage_fn(bound, x_in)
                graphs[b] = (x_in, y)
                send = y.detach()
                if ring.me == ring.n - 1:
                    outs[b] = send
            if t < num_micro + ring.n - 2:
                state = ring.permute(
                    torch.zeros_like(xs[0]) if send is None else send,
                    ring.down)
        ctx.stage = (ring, params, graphs, num_micro, xs.shape)
        return ring.broadcast(outs, ring.n - 1)

    @staticmethod
    def backward(ctx, d_outs):
        ring, params, graphs, num_micro, shape = ctx.stage
        trainable = [p for p in params if p.requires_grad]
        acc = [None] * len(trainable)
        dxs = d_outs.new_zeros(shape)
        cot = None
        for t in reversed(range(num_micro + ring.n - 1)):
            b = t - ring.me
            send = None
            if 0 <= b < num_micro:
                x_in, y = graphs.pop(b)
                dy = d_outs[b] if ring.me == ring.n - 1 else cot
                gx, *gp = _grads(y, [x_in] + trainable, dy)
                acc = _acc(acc, gp)
                send = gx
                if ring.me == 0:
                    dxs[b] = gx
            if t > 0:
                cot = ring.permute(
                    torch.zeros_like(d_outs[0]) if send is None else send,
                    ring.up)
        dxs = ring.broadcast(dxs, 0)
        acc = iter(acc)
        out = []
        for p in params:
            g = next(acc) if p.requires_grad else None
            out.append(torch.zeros_like(p) if p.requires_grad and g is None
                       else g)
        return (None, None, None, dxs) + tuple(out)


def pipeline_apply(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                   xs, *, axis: str = _mesh.PP_AXIS):
    """The GPipe schedule over ``axis``.

    stage_fn: (stage_params, x) -> y with y.shape == x.shape (uniform
      stages; embeddings and heads stay outside the pipeline).
    stage_params: this rank's {name: tensor} (its blocks).
    xs: [num_micro, mb, ...], the same on every pp rank.
    Returns [num_micro, mb, ...], the last stage's outputs, on every pp
    rank (the JAX package's psum).  Differentiable in ``xs`` and the
    stage parameters: the backward is the reverse schedule, the
    cotangent of the outputs taken from the last stage (every stage holds
    the same one, as the head after the pipeline runs on every stage),
    the cotangent of ``xs`` broadcast from stage 0."""
    names = list(stage_params)
    return _GPipe.apply(stage_fn, _Ring(axis), names, xs,
                        *[stage_params[k] for k in names])


def pipeline_train_1f1b(stage_fn: Callable, loss_fn: Callable,
                        stage_params, head_params, xs, targets, *,
                        axis: str = _mesh.PP_AXIS):
    """One-forward-one-backward schedule with hand-run backward slots.

    Tick t on stage ``me`` (n stages, num_micro micro-batches, T =
    num_micro + 2(n - 1) ticks):
      * forward of micro-batch b at t = b + me (its input stashed);
      * on the last stage, loss and output cotangent of b in the same tick
        (``loss_fn``, differentiated in the head parameters and y);
      * backward of b at t = b + 2(n - 1) - me: the stage forward is run
        again from the stashed input (so its dropout draws must depend on
        b alone: ``micro_idx``), then differentiated.

    stage_fn: (stage_params, x, micro_idx) -> y, uniform stages.
    loss_fn: (head_params, y, target, micro_idx) -> one micro-batch's
      mean loss; runs on the last stage only.
    targets: [num_micro, ...], or a dict of such tensors.
    Returns (mean loss, stage gradients, head gradients, dxs): the loss
    and head gradients broadcast from the last stage, dxs (the
    cotangents of ``xs``, for the caller's embedding backward) from stage
    0; the stage gradients are this stage's."""
    ring = _Ring(axis)
    n, me = ring.n, ring.me
    num_micro = xs.shape[0]
    inv = 1.0 / num_micro
    snames = list(stage_params)
    sleaves = [stage_params[k].detach().requires_grad_(True) for k in snames]
    sbound = dict(zip(snames, sleaves))
    hnames = list(head_params)
    hleaves = [head_params[k].detach().requires_grad_(True) for k in hnames]
    hbound = dict(zip(hnames, hleaves))
    sacc, hacc = [None] * len(sleaves), [None] * len(hleaves)
    loss_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
    dxs = torch.zeros_like(xs)
    stash, fwd_state, bwd_cot = {}, None, None
    zero = torch.zeros_like(xs[0])
    ticks = num_micro + 2 * (n - 1)
    for t in range(ticks):
        b_f = t - me
        y = dy_last = None
        if 0 <= b_f < num_micro:
            x_in = xs[b_f] if me == 0 else fwd_state
            stash[b_f] = x_in
            with torch.no_grad():
                y = stage_fn(sbound, x_in, b_f)
            if me == n - 1:
                tgt = ({k: v[b_f] for k, v in targets.items()}
                       if isinstance(targets, dict) else targets[b_f])
                y_req = y.detach().requires_grad_(True)
                with torch.enable_grad():
                    l_b = loss_fn(hbound, y_req, tgt, b_f)
                dy_last, *dh = _grads(l_b, [y_req] + hleaves, None)
                hacc = _acc(hacc, [None if g is None else g * inv
                                   for g in dh])
                loss_sum = loss_sum + l_b.detach().float()
        b_b = t - 2 * (n - 1) + me
        dx = None
        if 0 <= b_b < num_micro:
            cot = dy_last * inv if me == n - 1 else bwd_cot
            x_saved = stash.pop(b_b).detach().requires_grad_(True)
            with torch.enable_grad():
                y2 = stage_fn(sbound, x_saved, b_b)
            dx, *gp = _grads(y2, [x_saved] + sleaves, cot)
            sacc = _acc(sacc, gp)
            if me == 0:
                dxs[b_b] = dx
        if t < ticks - 1:
            fwd_state = ring.permute(zero if y is None else y, ring.down)
            bwd_cot = ring.permute(zero if dx is None else dx, ring.up)
    loss = ring.broadcast(loss_sum * inv, n - 1)
    hgrads = {k: ring.broadcast(
        torch.zeros_like(p) if g is None else g, n - 1)
        for k, p, g in zip(hnames, hleaves, hacc)}
    sgrads = {k: torch.zeros_like(p) if g is None else g
              for k, p, g in zip(snames, sleaves, sacc)}
    return loss, sgrads, hgrads, ring.broadcast(dxs, 0)


def stack_block_params(block_params: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Stack per-block {name: tensor} dicts into {name: [L, ...]}: the
    layout the pipeline splits over pp and a stage loops over.  All
    blocks must have the same names."""
    keys = list(block_params[0])
    for bp in block_params[1:]:
        if list(bp) != keys:
            raise ValueError("pipeline blocks must have identical parameter "
                             f"structure; got {list(bp)} vs {keys}")
    return {k: torch.stack([torch.as_tensor(bp[k]) for bp in block_params])
            for k in keys}


def blockwise_stage_fn(block_fn: Callable) -> Callable:
    """Lift ``block_fn(block_params, x)`` into a stage function over the
    stage's local blocks (leaves [L_local, ...]), run in order."""

    def stage_fn(stage_params, x, *rest):
        depth = next(iter(stage_params.values())).shape[0]
        for i in range(depth):
            x = block_fn({k: v[i] for k, v in stage_params.items()}, x)
        return x

    return stage_fn


class PipelineStage:
    """Partition a stack of isomorphic blocks into pp stages and run the
    GPipe schedule over them::

        pipe = PipelineStage(block_fn, stacked_params, num_micro=4)
        pipe.shard_params()     # this rank keeps its stage's blocks
        y = pipe(x)             # x: [B, ...], the same on every pp rank
    """

    def __init__(self, block_fn: Callable,
                 stacked_params: Dict[str, torch.Tensor],
                 num_micro: int = 1, axis: str = _mesh.PP_AXIS, mesh=None):
        self.block_fn = block_fn
        self.axis = axis
        self.num_micro = num_micro
        self.mesh = mesh or _mesh.current_mesh()
        n_stages = _mesh.mesh_axis_size(axis, self.mesh)
        depth = next(iter(stacked_params.values())).shape[0]
        if depth % n_stages != 0:
            raise ValueError(
                f"{depth} blocks not divisible into {n_stages} stages")
        self.params = stacked_params

    def sharding_spec(self):
        """The spec placing the block dim over pp (leaves [L, ...])."""
        from .sharding import PartitionSpec

        return PartitionSpec(self.axis)

    def sharding_annotations(self):
        """{name: (pp, None, ...)}, the annotations
        ``sharding.infer_sharding`` takes."""
        return {k: (self.axis,) + (None,) * (v.dim() - 1)
                for k, v in self.params.items()}

    def shard_params(self):
        from . import sharding as _sharding

        self.params = _sharding.shard_params(
            self.params, mesh=self.mesh,
            annotations=self.sharding_annotations())
        return self.params

    def __call__(self, x, params=None):
        params = self.params if params is None else params
        stage = blockwise_stage_fn(self.block_fn)
        if _mesh.mesh_axis_size(self.axis, self.mesh) == 1:
            return stage(params, x)
        ys = pipeline_apply(stage, params, microbatch(x, self.num_micro),
                            axis=self.axis)
        return unmicrobatch(ys)
