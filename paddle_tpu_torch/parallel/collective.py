"""Collective communication API (counterpart of
paddle_tpu/parallel/collective.py).

Reference parity: python/paddle/distributed/collective.py (broadcast :59,
all_reduce :116, reduce :191, all_gather :274, scatter :347, barrier :419)
and the ``c_*`` collective op family, whose communicators are keyed by
ring_id (platform/collective_helper.h:62).

A group is the process group of one mesh dim (ring_id ~ dim name) or of a
list of ranks.  The JAX module has a traced route (lax collectives inside
``shard_map``) and an eager route (a one-off ``shard_map`` over a global
array).  In the port every rank is its own process holding its own
tensor, so the two become one route: each function takes this rank's
tensor and returns the collective's result for this rank, as a new
tensor (the input is not changed), through ``torch.distributed`` on the
group's process group.  A group whose dims are absent from the mesh or
hold one member is the identity, as in the JAX package.

Differentiable forwards (tensor, sequence, pipeline and expert
parallelism) run through these functions, so each is an autograd
Function whose backward is its transposed collective:

  - ``all_reduce`` (sum) -> identity: the sum is consumed the same on
    every member (Megatron's "g"); ``copy_to_group`` is its partner,
    identity forward and sum backward (Megatron's "f"), for a value every
    member holds whole and consumes differently;
  - ``all_gather`` <-> ``reduce_scatter``;
  - the tiled ``all_to_all`` -> the inverse all-to-all;
  - ``ppermute`` -> the inverse permutation.

Routes.  The tiled all-to-all is one ``all_to_all_single`` on every
backend.  ``ppermute`` is a batch of point-to-point sends and receives,
except on gloo with CUDA tensors (ranks sharing one card, where NCCL
refuses two ranks): gloo hands a device pointer to its TCP transport
there and fails, so that route is a dense ``all_to_all_single`` whose
slot j carries what goes to member j (zeros where nothing does).  The
route is picked once per call from the group's backend and the tensor's
device (``ppermute_route``), never by catching an error.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import compress as _compress
from . import mesh as _mesh

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "bound_data_axis",
    "shard_map", "group_mean", "all_reduce", "copy_to_group", "all_gather",
    "all_to_all", "broadcast", "reduce", "reduce_scatter", "scatter",
    "barrier", "send", "recv", "ppermute", "ppermute_route", "axis_index",
    "routes", "reset_routes",
]


def shard_map(f, mesh=None, in_specs=None, out_specs=None, check_rep=False):
    """The JAX package's ``shard_map`` in the port: every rank already
    holds its local shards, so the returned function calls ``f`` on this
    rank's arguments as they are; the specs are not read."""
    del mesh, in_specs, out_specs, check_rep
    return f


class ReduceOp:
    """ref: distributed/collective.py ReduceOp enum."""
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A communicator group: a set of mesh dims (ref ``ring_id`` ->
    ``NCCLComm``, collective_helper.h:50), or an explicit list of ranks
    (``new_group(ranks=...)``).  Group 0 is every dim of the mesh."""

    def __init__(self, axes: Sequence[str] = (), id: int = 0,
                 ranks: Optional[Sequence[int]] = None, pg=None):
        self.axes = tuple(axes)
        self.id = id
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self._pg = pg

    @property
    def axis(self):
        return self.axes if len(self.axes) > 1 else self.axes[0]

    def size(self, mesh=None) -> int:
        if self.ranks is not None:
            return len(self.ranks)
        n = 1
        for a in self.axes:
            n *= _mesh.mesh_axis_size(a, mesh)
        return n

    @property
    def nranks(self) -> int:
        return self.size()

    @property
    def world_size(self) -> int:
        return self.size()

    def process_group(self):
        """The ``torch.distributed`` process group, or None where the
        group holds one member (or this rank is not in it)."""
        if self.ranks is not None:
            return self._pg
        m = _mesh.current_mesh()
        axes = tuple(a for a in self.axes if a in m.axis_names)
        if not axes or self.size(m) == 1:
            return None
        return m.group(axes)

    def __repr__(self):
        if self.ranks is not None:
            return f"Group(id={self.id}, ranks={self.ranks})"
        return f"Group(id={self.id}, axes={self.axes})"


# AVG is a sum divided by the member count (not every backend has AVG)
_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
             ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN}

_groups: Dict[int, Group] = {}
_next_group_id = [1]


def _global_group() -> Group:
    m = _mesh.current_mesh()
    return Group(tuple(m.axis_names), id=0)


def new_group(axes=None, id: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None) -> Group:
    """A group over the given mesh dim(s) (default: all dims), or, with
    ``ranks``, over those ranks (the reference's ``new_group(ranks)``;
    every rank of the job calls it, as ``torch.distributed`` requires).

    ref: distributed/collective.py new_group / c_comm_init with ring_id.
    """
    if axes is None and ranks is None:
        g = _global_group()
    else:
        gid = id if id is not None else _next_group_id[0]
        _next_group_id[0] = max(_next_group_id[0], gid) + 1
        if ranks is not None:
            ranks = sorted(int(r) for r in ranks)
            pg = dist.new_group(ranks, timeout=_mesh._TIMEOUT)
            if dist.get_rank() not in ranks:
                pg = None
            g = Group((), id=gid, ranks=ranks, pg=pg)
        else:
            if isinstance(axes, str):
                axes = (axes,)
            g = Group(tuple(axes), id=gid)
    _groups[g.id] = g
    return g


def get_group(id: int = 0) -> Group:
    if id == 0:
        return _global_group()
    return _groups[id]


def _resolve(group) -> Group:
    if group is None:
        return _global_group()
    if isinstance(group, str):
        return Group((group,))
    if isinstance(group, (tuple, list)):
        return Group(tuple(group))
    return group


def bound_data_axis() -> Optional[str]:
    """The data-parallel dim when the mesh is set and its group has more
    than one member, else None (the JAX package's "axis bound in this
    trace": a one-member or absent dim needs no collective)."""
    from ..distributed import env as _env

    m = _mesh.get_mesh()
    axis = _env.current_data_axis() or _mesh.DP_AXIS
    if m is None or _mesh.mesh_axis_size(axis, m) <= 1:
        return None
    return axis


def _sum_into(t, pg):
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=pg)
    return t


def _gather_stack(x, pg) -> torch.Tensor:
    """Every member's ``x`` stacked along a new leading dim, in group rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, x, group=pg)
    return torch.stack(parts)


# -- core collectives --------------------------------------------------------

def _resolve_compress(compress):
    """Normalize the compress= argument, consulting the ambient comm scope
    (compress.comm_scope) when the caller passed None.  Returns a payload
    kind or None; "none" explicitly forces full precision inside a
    quantizing scope."""
    if compress is None:
        opts = _compress.current_comm()
        return opts.payload() if opts is not None else None
    if compress in ("", "none", False):
        return None
    if compress not in _compress.COMPRESS_KINDS:
        raise ValueError(
            f"compress={compress!r}; expected one of "
            f"{_compress.COMPRESS_KINDS} or 'none'")
    return compress


def all_reduce(tensor, op: str = ReduceOp.SUM, group=None, sync_op=True,
               compress=None, block_size: int = 256, hierarchy="auto"):
    """ref: distributed/collective.py:116; c_allreduce_op.h:38.  The
    reduction of every member's ``tensor``.

    compress="int8"/"fp8" rides the wire as an EQuARX-style block-quantized
    payload (parallel/compress.py; SUM and AVG only, single-dim groups);
    None inherits the ambient comm_scope, "none" forces full precision.
    PROD gathers every member's tensor and multiplies in rank order (the
    JAX package's sign-safe product).  The exact SUM is differentiable,
    its backward the identity (module docstring)."""
    del sync_op
    g = _resolve(group)
    opname = op.lower() if isinstance(op, str) else op
    if opname not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN,
                      ReduceOp.PROD, ReduceOp.AVG):
        raise ValueError(f"unknown reduce op {op!r}")
    kind = _resolve_compress(compress) \
        if opname in (ReduceOp.SUM, ReduceOp.AVG) else None
    if kind is not None and len(g.axes) > 1:
        kind = None  # multi-dim global ring: no single hierarchy, stay exact
    x = torch.as_tensor(tensor)
    pg = g.process_group()
    if pg is None:
        return x
    n = dist.get_world_size(pg)

    def reduce_local():
        if kind is not None:
            return _compress.optimized_all_reduce(
                x, g, compress=kind, block_size=block_size,
                hierarchy=hierarchy, mean=opname == ReduceOp.AVG)
        if opname == ReduceOp.PROD:
            return torch.prod(_gather_stack(x, pg), dim=0)
        if opname == ReduceOp.SUM:
            return _AllReduce.apply(x, pg)
        out = x.clone()
        dist.all_reduce(out, op=_TORCH_OP[opname], group=pg)
        if opname == ReduceOp.AVG:
            out = _compress.true_div(out, n)
        return out

    axis_label = "+".join(g.axes) if g.ranks is None else "ranks"
    return _instrumented(reduce_local, x, axis_label, opname, kind,
                         block_size, n)


def _instrumented(fn, x, axis_label, opname, kind, block_size, n):
    """An all-reduce wrapped in a trace span and the monitor's
    comm.allreduce_ms{axis} / comm.allreduce_bytes{axis,dtype} histograms
    and comm.compress_ratio gauge, so imperative sync shows up as comm.
    The device sync inside the timer happens only while metrics are on."""
    from ..utils import monitor as _monitor
    from ..utils import trace as _trace

    nelem = x.numel()
    wire = _compress.wire_bytes(nelem, kind, block_size, n)
    with _trace.span("comm::allreduce", axis=axis_label, op=opname,
                     bytes=wire, compress=kind or "none"):
        t0 = time.perf_counter()
        out = fn()
        if _monitor.enabled():
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            _monitor.histogram(
                "comm.allreduce_ms", "eager allreduce wall time",
                labelnames=("axis",), buckets=_monitor.TIME_MS_BUCKETS,
            ).observe((time.perf_counter() - t0) * 1e3, axis=axis_label)
    _monitor.histogram(
        "comm.allreduce_bytes", "wire bytes per allreduce",
        labelnames=("axis", "dtype"),
        buckets=(1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26, 1 << 30),
    ).observe(wire, axis=axis_label,
              dtype=kind or str(x.dtype).replace("torch.", ""))
    raw = _compress.wire_bytes(nelem, None, block_size, n)
    if raw:
        _monitor.gauge(
            "comm.compress_ratio", "wire bytes relative to fp32 allreduce",
        ).set(wire / raw)
    return out


def _group_avg(x, pg):
    return _compress.true_div(_sum_into(x.clone(), pg),
                              dist.get_world_size(pg))


class _GroupMean(torch.autograd.Function):
    """Mean over a process group whose backward averages the cotangent
    over the group (the transpose of the JAX package's ``pmean``)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _group_avg(x, pg)

    @staticmethod
    def backward(ctx, ct):
        return _group_avg(ct, ctx.pg), None


def group_mean(x, group=None):
    """The mean of every member's ``x``, differentiable through the group
    (SyncBatchNorm's statistics); the identity for a one-member group."""
    pg = _resolve(group).process_group()
    return x if pg is None else _GroupMean.apply(x, pg)


# -- differentiable collectives ---------------------------------------------

# calls a route took since reset_routes(), keyed "<call> (<backend>,
# <device type>)"; chip_smoke.py prints them per rank
_ROUTES: collections.Counter = collections.Counter()


def _route(call, pg, x):
    _ROUTES[f"{call} ({dist.get_backend(pg)}, {x.device.type})"] += 1


def routes() -> Dict[str, int]:
    """The calls each route of the differentiable collectives took since
    ``reset_routes()``."""
    return dict(_ROUTES)


def reset_routes() -> None:
    _ROUTES.clear()


def _raw_sum(x, pg):
    _route("all_reduce", pg, x)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=pg)
    return out


def _raw_all_gather(x, pg, axis):
    _route("all_gather", pg, x)
    return torch.cat(list(_gather_stack(x, pg)), dim=axis)


def _raw_reduce_scatter(x, pg, axis):
    n = dist.get_world_size(pg)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not split over {n} members")
    _route("reduce_scatter", pg, x)
    moved = x.movedim(axis, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=pg)
    return out.movedim(0, axis)


def _raw_all_to_all(x, pg, split_axis, concat_axis):
    """Chunk j of ``x`` along ``split_axis`` to member j; the chunks
    received, in member order, concatenated along ``concat_axis``: one
    ``all_to_all_single`` over the chunks stacked on a leading dim."""
    n = dist.get_world_size(pg)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} members")
    _route("all_to_all_single", pg, x)
    moved = x.movedim(split_axis, 0)
    stacked = moved.reshape((n, moved.shape[0] // n)
                            + tuple(moved.shape[1:])).contiguous()
    out = torch.empty_like(stacked)
    dist.all_to_all_single(out, stacked, group=pg)
    return torch.cat([c.movedim(0, split_axis) for c in out.unbind(0)],
                     dim=concat_axis)


def ppermute_route(pg, x) -> str:
    """The route ``ppermute`` takes on process group ``pg`` for ``x``:
    "all_to_all_single" on gloo with a CUDA tensor, else
    "point_to_point" (module docstring)."""
    if dist.get_backend(pg) == "gloo" and x.is_cuda:
        return "all_to_all_single"
    return "point_to_point"


def _raw_ppermute(x, pg, perm):
    x = x.contiguous()
    me = dist.get_rank(pg)
    _route(f"ppermute as {ppermute_route(pg, x)}", pg, x)
    if ppermute_route(pg, x) == "all_to_all_single":
        n = dist.get_world_size(pg)
        slots = x.new_zeros((n,) + tuple(x.shape))
        for s, d in perm:
            if s == me:
                slots[d].copy_(x)
        got = torch.empty_like(slots)
        dist.all_to_all_single(got, slots, group=pg)
        src = [s for s, d in perm if d == me]
        return got[src[0]].clone() if src else torch.zeros_like(x)
    out = torch.zeros_like(x)
    ops: List[dist.P2POp] = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(pg, d), pg))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(pg, s), pg))
    for w in dist.batch_isend_irecv(ops) if ops else ():
        w.wait()
    return out


class _AllReduce(torch.autograd.Function):
    """Sum over the group; backward: the identity."""

    @staticmethod
    def forward(ctx, x, pg):
        return _raw_sum(x, pg)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Copy(torch.autograd.Function):
    """Identity; backward: the sum of the cotangents over the group."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _raw_sum(ct, ctx.pg), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, axis):
        ctx.pg, ctx.axis = pg, axis
        return _raw_all_gather(x, pg, axis)

    @staticmethod
    def backward(ctx, ct):
        return _raw_reduce_scatter(ct, ctx.pg, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, axis):
        ctx.pg, ctx.axis = pg, axis
        return _raw_reduce_scatter(x, pg, axis)

    @staticmethod
    def backward(ctx, ct):
        return _raw_all_gather(ct.contiguous(), ctx.pg, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, split_axis, concat_axis):
        ctx.pg, ctx.axes = pg, (split_axis, concat_axis)
        return _raw_all_to_all(x, pg, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        split_axis, concat_axis = ctx.axes
        return (_raw_all_to_all(ct, ctx.pg, concat_axis, split_axis), None,
                None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, perm):
        ctx.pg, ctx.perm = pg, perm
        return _raw_ppermute(x, pg, perm)

    @staticmethod
    def backward(ctx, ct):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _raw_ppermute(ct, ctx.pg, inverse), None, None


def copy_to_group(tensor, group=None):
    """``tensor`` itself, whose gradient is summed over the group: mark a
    value every member holds whole before each member consumes it
    differently (a column-parallel product's input, a replicated
    parameter used on this member's tokens).  The partner of the
    differentiable ``all_reduce``."""
    pg = _resolve(group).process_group()
    return tensor if pg is None else _Copy.apply(tensor, pg)


def axis_index(group=None) -> int:
    """This rank's index within the group (0 for a one-member group)."""
    pg = _resolve(group).process_group()
    return 0 if pg is None else dist.get_rank(pg)


def all_gather(tensor_or_list, tensor=None, group=None, axis: int = 0):
    """ref: distributed/collective.py:274 (list-out API); also functional:
    ``out = all_gather(x)`` returns every member's ``x`` concatenated along
    ``axis`` in rank order (differentiable: backward reduce-scatters)."""
    out_list = None
    if isinstance(tensor_or_list, list):
        out_list, x = tensor_or_list, tensor
    else:
        x = tensor_or_list
    g = _resolve(group)
    x = torch.as_tensor(x)
    pg = g.process_group()
    out = x if pg is None else _AllGather.apply(x.contiguous(), pg, axis)
    if out_list is not None:
        n = 1 if pg is None else dist.get_world_size(pg)
        out_list.extend(torch.chunk(out, n, dim=axis))
        return out_list
    return out


def reduce_scatter(tensor, op: str = ReduceOp.SUM, group=None, axis: int = 0):
    """ref: operators/collective/c_reducescatter_op.cc.  The sum of every
    member's ``tensor``, split along ``axis`` into one chunk a member: this
    rank gets its own chunk (differentiable: backward all-gathers)."""
    g = _resolve(group)
    if op.lower() != ReduceOp.SUM:
        raise NotImplementedError("reduce_scatter supports sum")
    x = torch.as_tensor(tensor)
    pg = g.process_group()
    if pg is None:
        return x
    return _ReduceScatter.apply(x, pg, axis)


def all_to_all(in_tensor_list, out_tensor_list=None, group=None,
               split_axis: int = 0, concat_axis: int = 0):
    """ref: distributed/collective.py alltoall.  Functional form: pass a
    tensor, get it split along ``split_axis`` into one chunk a member,
    chunk j sent to member j, and the chunks received concatenated along
    ``concat_axis`` (the Ulysses sequence-parallel primitive;
    differentiable: backward is the inverse all-to-all).  List form:
    entry j goes to member j, the list received comes back."""
    g = _resolve(group)
    if isinstance(in_tensor_list, (list, tuple)):
        x = torch.stack([torch.as_tensor(t) for t in in_tensor_list])
        split_axis, concat_axis = 0, 0
        listed = True
    else:
        x = torch.as_tensor(in_tensor_list)
        listed = False
    pg = g.process_group()
    out = x if pg is None else _AllToAll.apply(x, pg, split_axis,
                                               concat_axis)
    if listed and out_tensor_list is not None:
        out_tensor_list.extend(list(out))
        return out_tensor_list
    return out


def broadcast(tensor, src: int = 0, group=None, sync_op=True):
    """ref: distributed/collective.py:59; c_broadcast_op.  Member ``src``'s
    tensor (``src`` a rank within the group)."""
    del sync_op
    g = _resolve(group)
    x = torch.as_tensor(tensor)
    pg = g.process_group()
    if pg is None:
        return x
    out = x.clone().contiguous()
    dist.broadcast(out, src=dist.get_global_rank(pg, src), group=pg)
    return out


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM, group=None):
    """ref: distributed/collective.py:191.  As in the JAX package every
    member computes the reduction; ``dst`` is accepted for API parity."""
    del dst
    return all_reduce(tensor, op=op, group=group)


def scatter(tensor, tensor_list=None, src: int = 0, group=None):
    """ref: distributed/collective.py:347.  This member's entry of member
    ``src``'s list (or of its stacked tensor's leading dim)."""
    g = _resolve(group)
    if tensor_list is not None:
        stacked = torch.stack([torch.as_tensor(t) for t in tensor_list])
    else:
        stacked = torch.as_tensor(tensor)
    pg = g.process_group()
    if pg is None:
        return stacked[0] if tensor_list is not None else stacked
    parts = [p.contiguous() for p in stacked.unbind(0)]
    out = torch.empty_like(parts[0])
    src_global = dist.get_global_rank(pg, src)
    dist.scatter(out, parts if dist.get_rank() == src_global else None,
                 src=src_global, group=pg)
    return out


def barrier(group=None):
    """ref: distributed/collective.py:419 (barrier op = allreduce of a
    scalar): a sum of 1 over the group, read back on the host."""
    g = _resolve(group)
    pg = g.process_group()
    if pg is None:
        return
    one = torch.ones((), device=_mesh.current_mesh().device or "cpu")
    _sum_into(one, pg).item()


def ppermute(tensor, perm, group=None):
    """Ring permute: for each (src, dst) pair of ``perm`` (ranks within
    the group) member src's tensor goes to member dst; a member no pair
    sends to gets zeros (``lax.ppermute``'s semantics).  The JAX package
    allows it only inside ``shard_map``; here every rank is a process and
    every member of the group calls it.  Differentiable: the backward
    permutes the cotangents back.  Route: ``ppermute_route``."""
    g = _resolve(group)
    x = torch.as_tensor(tensor)
    pg = g.process_group()
    if pg is None:
        return x.clone() if any(s == d for s, d in perm) \
            else torch.zeros_like(x)
    return _PPermute.apply(x, pg, tuple((int(s), int(d)) for s, d in perm))


def send(tensor, dst: int, group=None):
    """ref: distributed send (the PS-era ``send_op``): ``tensor`` to member
    ``dst``, which calls ``recv``.  The JAX package raises (a ppermute
    edge inside ``shard_map`` plays this role there)."""
    g = _resolve(group)
    pg = g.process_group()
    if pg is None:
        raise ValueError("send needs a group of more than one member")
    dist.send(torch.as_tensor(tensor).contiguous(),
              dist.get_global_rank(pg, dst), group=pg)


def recv(tensor, src: int = 0, group=None):
    """ref: distributed recv: fills ``tensor`` from member ``src``'s
    ``send`` and returns it."""
    g = _resolve(group)
    pg = g.process_group()
    if pg is None:
        raise ValueError("recv needs a group of more than one member")
    dist.recv(tensor, dist.get_global_rank(pg, src), group=pg)
    return tensor
