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
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import compress as _compress
from . import mesh as _mesh

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "bound_data_axis",
    "shard_map", "group_mean", "all_reduce", "all_gather", "all_to_all",
    "broadcast", "reduce", "reduce_scatter", "scatter", "barrier", "send",
    "recv", "ppermute",
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
    JAX package's sign-safe product)."""
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


def all_gather(tensor_or_list, tensor=None, group=None, axis: int = 0):
    """ref: distributed/collective.py:274 (list-out API); also functional:
    ``out = all_gather(x)`` returns every member's ``x`` concatenated along
    ``axis`` in rank order."""
    out_list = None
    if isinstance(tensor_or_list, list):
        out_list, x = tensor_or_list, tensor
    else:
        x = tensor_or_list
    g = _resolve(group)
    x = torch.as_tensor(x)
    pg = g.process_group()
    if pg is None:
        out = x
    else:
        out = torch.cat(list(_gather_stack(x, pg)), dim=axis)
    if out_list is not None:
        n = 1 if pg is None else dist.get_world_size(pg)
        out_list.extend(torch.chunk(out, n, dim=axis))
        return out_list
    return out


def reduce_scatter(tensor, op: str = ReduceOp.SUM, group=None, axis: int = 0):
    """ref: operators/collective/c_reducescatter_op.cc.  The sum of every
    member's ``tensor``, split along ``axis`` into one chunk a member: this
    rank gets its own chunk."""
    g = _resolve(group)
    if op.lower() != ReduceOp.SUM:
        raise NotImplementedError("reduce_scatter supports sum")
    x = torch.as_tensor(tensor)
    pg = g.process_group()
    if pg is None:
        return x
    n = dist.get_world_size(pg)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not split over {n} members")
    moved = x.movedim(axis, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=pg)
    return out.movedim(0, axis)


def _all_to_all_tiled(x, pg, split_axis, concat_axis):
    n = dist.get_world_size(pg)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} members")
    chunks = [c.contiguous() for c in torch.chunk(x, n, dim=split_axis)]
    recv = [torch.empty_like(c) for c in chunks]
    dist.all_to_all(recv, chunks, group=pg)
    return torch.cat(recv, dim=concat_axis)


def all_to_all(in_tensor_list, out_tensor_list=None, group=None,
               split_axis: int = 0, concat_axis: int = 0):
    """ref: distributed/collective.py alltoall.  Functional form: pass a
    tensor, get it split along ``split_axis`` into one chunk a member,
    chunk j sent to member j, and the chunks received concatenated along
    ``concat_axis`` (the Ulysses sequence-parallel primitive).  List form:
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
    out = x if pg is None else _all_to_all_tiled(x, pg, split_axis,
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
    allows it only inside ``shard_map``; here every rank is a process, so
    it is a batch of sends and receives."""
    g = _resolve(group)
    x = torch.as_tensor(tensor).contiguous()
    pg = g.process_group()
    if pg is None:
        return x.clone() if any(s == d for s, d in perm) \
            else torch.zeros_like(x)
    me = dist.get_rank(pg)
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
