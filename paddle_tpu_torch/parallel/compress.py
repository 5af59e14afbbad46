"""Communication compression and scheduling for data-parallel gradient sync
(counterpart of paddle_tpu/parallel/compress.py).

Reference parity: the fleet gradient-sync stack -- ``c_allreduce_sum``
ring allreduce (operators/collective/c_allreduce_op.h), gradient bucket
coalescing (imperative/reducer.cc ``Group`` / ``assign_group_by_size``,
the ``comm_buffer_size`` knob of dygraph DataParallel), and DGC's
sparse-allreduce ancestry (sparse_all_reduce_op_handle.cc).

The JAX package's design, kept: an EQuARX-style block-quantized allreduce
(arxiv 2506.17615) built from collective primitives::

    local blockwise quantize (int8 / fp8-e4m3, per-block fp32 scale)
      -> all_to_all of the quantized payload (the reduce-scatter exchange)
      -> dequantize each peer chunk and accumulate in fp32
      -> re-quantize the reduced shard
      -> all_gather of the quantized shard -> dequantize

so only quantized bytes ride the wire while every accumulation happens in
fp32; a hierarchical schedule (TACCL sketch, arxiv 2111.04867) factors the
dp dim into (intra-host, inter-host) groups: full-precision
reduce-scatter inside a host, the (optionally quantized) allreduce of the
1/intra shard across hosts, an all-gather inside the host.  Bucketing
coalesces gradient leaves into ~``buffer_mb`` MB flat fp32 buffers in
reverse flatten order.  Everything here is fp32 torch arithmetic on the
rank's own tensors and ``torch.distributed`` collectives (the JAX
package's are jnp code: no kernel sits under either).

A group (``axis``) is a mesh dim name, a tuple of them or a
``collective.Group``; ``groups`` are lists of the group's member indices,
as the JAX package's ``axis_index_groups``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "COMPRESS_KINDS", "CommOptions", "comm_scope", "current_comm",
    "quantize_blockwise", "dequantize_blockwise", "all_reduce_compressed",
    "optimized_all_reduce", "hierarchical_groups", "resolve_hierarchy",
    "bucket_assignment", "bucket_signature", "bucketed_all_reduce",
    "sync_gradients", "wire_bytes",
]

# Quantized payload dtypes: int8, and fp8 as e4m3fn (finite max 448).
COMPRESS_KINDS = ("int8", "fp8")
_QMAX = {"int8": 127.0, "fp8": 448.0}


def _payload_dtype(kind: str):
    if kind == "int8":
        return torch.int8
    if kind == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(
        f"unknown compression kind {kind!r}; expected one of {COMPRESS_KINDS}")


def _check_kind(kind: str) -> str:
    _payload_dtype(kind)  # raises on unknown kinds
    return kind


def _on_device(d, like):
    return torch.full((), d, dtype=like.dtype, device=like.device)


def true_div(x, d):
    """``x / d`` for a Python number ``d``, correctly rounded on every
    device: CUDA's kernel multiplies by a CPU scalar's reciprocal instead
    (one ulp off), which would put the card's scales and means beside the
    CPU's and the JAX package's."""
    return x / _on_device(d, x)


# -- comm options scope -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommOptions:
    """Gradient-communication options carried by DistributedStrategy into
    the step.

    quantize: "" (off), "none" (owned sync, full precision), "int8", "fp8".
    hierarchy: "auto" (factor by the ranks of a host), "off"/None (flat),
        an int intra-group size, or an explicit (intra, inter) tuple.
    """
    quantize: str = ""
    block_size: int = 256
    buffer_mb: float = 25.0
    hierarchy: Any = "auto"

    def payload(self) -> Optional[str]:
        """The compression kind actually applied to wire payloads, or None."""
        return self.quantize if self.quantize in COMPRESS_KINDS else None

    def signature(self) -> str:
        return (f"q={self.quantize};bs={int(self.block_size)};"
                f"buf={float(self.buffer_mb):g};hier={self.hierarchy!r}")


_COMM_STACK: List[CommOptions] = []


@contextlib.contextmanager
def comm_scope(options: Optional[CommOptions]):
    """Make ``options`` the ambient comm configuration for collectives
    issued inside the scope (read by collective.all_reduce when no
    explicit compress= is given)."""
    if options is None:
        yield None
        return
    _COMM_STACK.append(options)
    try:
        yield options
    finally:
        _COMM_STACK.pop()


def current_comm() -> Optional[CommOptions]:
    return _COMM_STACK[-1] if _COMM_STACK else None


# -- blockwise quantization ---------------------------------------------------

def quantize_blockwise(flat, kind: str = "int8", block_size: int = 256):
    """Quantize a flat fp32 vector (size divisible by block_size) into
    (payload, scales): payload is int8/fp8 with one fp32 scale per block of
    ``block_size`` elements (scale = blockwise max|x| / qmax, EQuARX-style).
    int8 rounds half to even and clips to +-127.  Zero blocks get scale 0
    and a zero payload."""
    _check_kind(kind)
    flat = torch.as_tensor(flat).to(torch.float32)
    if flat.numel() % block_size:
        raise ValueError(
            f"quantize_blockwise needs size % block_size == 0, got "
            f"{flat.numel()} % {block_size}")
    blocks = flat.reshape(-1, block_size)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = true_div(amax, _QMAX[kind])
    y = blocks / torch.where(scale > 0, scale, torch.ones_like(scale))
    if kind == "int8":
        q = torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    else:
        q = y.to(_payload_dtype(kind))
    return q.reshape(-1), scale.reshape(-1)


def dequantize_blockwise(payload, scales, block_size: int = 256):
    """Inverse of quantize_blockwise: flat fp32 vector."""
    blocks = payload.reshape(-1, block_size).to(torch.float32)
    return (blocks * scales.reshape(-1, 1)).reshape(-1)


# -- wire accounting ----------------------------------------------------------

def wire_bytes(nelem: int, compress: Optional[str] = None,
               block_size: int = 256, n: int = 2,
               dtype_bytes: int = 4) -> int:
    """Bytes moved over the interconnect by one ring allreduce of ``nelem``
    elements across ``n`` members: 2*(n-1)/n * payload bytes, where the
    quantized payload carries 1 byte/element plus one fp32 scale per block."""
    if n <= 1:
        return 0
    if compress in COMPRESS_KINDS:
        per_elem = 1.0 + 4.0 / float(block_size)
    else:
        per_elem = float(dtype_bytes)
    return int(round(2.0 * (n - 1) / n * nelem * per_elem))


# -- hierarchy resolution -----------------------------------------------------

def hierarchical_groups(n: int, intra: int):
    """(intra_groups, inter_groups) partitioning member indices 0..n-1 in
    host-major order (each host's ranks consecutive): intra groups are runs
    of ``intra`` consecutive members, inter groups connect member i of
    every host."""
    if n % intra:
        raise ValueError(f"axis size {n} not divisible by intra size {intra}")
    inter = n // intra
    intra_groups = [[h * intra + i for i in range(intra)]
                    for h in range(inter)]
    inter_groups = [[h * intra + i for h in range(inter)]
                    for i in range(intra)]
    return intra_groups, inter_groups


def resolve_hierarchy(hierarchy, n: int) -> Optional[Tuple[int, int]]:
    """Normalize a hierarchy spec to (intra, inter) or None (flat).

    "auto" factors by the ranks of a host (see mesh.dp_hierarchy) and
    degrades to flat when the dim lives on one host (or one device per
    host); an int is the intra-group size; a tuple is taken as-is."""
    if hierarchy in (None, "off", "flat", False, 0, 1):
        return None
    if hierarchy == "auto":
        from . import mesh as _mesh
        return _mesh.dp_hierarchy(n)
    if isinstance(hierarchy, (tuple, list)):
        intra, inter = int(hierarchy[0]), int(hierarchy[1])
        if intra * inter != n:
            raise ValueError(
                f"hierarchy {hierarchy!r} does not factor axis size {n}")
    else:
        intra = int(hierarchy)
        if n % intra:
            raise ValueError(
                f"hierarchy intra size {intra} does not divide axis size {n}")
        inter = n // intra
    if intra <= 1 or inter <= 1:
        return None
    return intra, inter


# -- groups -------------------------------------------------------------------

def _members(axis):
    """(process group or None, the group's global ranks in member order)
    of ``axis``.  The group is there even with one member once the mesh
    has process groups (a one-member all-reduce still runs)."""
    from . import collective as _coll
    from . import mesh as _mesh

    g = _coll._resolve(axis)
    if g.ranks is not None:
        return g.process_group(), list(g.ranks)
    m = _mesh.current_mesh()
    axes = tuple(a for a in g.axes if a in m.axis_names)
    n = 1
    for a in axes:
        n *= m.shape[a]
    if not axes or (m.device_mesh is None and n == 1):
        return None, list(range(n))
    pg = m.group(axes)
    return pg, [dist.get_global_rank(pg, i) for i in range(n)]


def _subgroup(ranks, groups):
    """This rank's process group of ``groups`` (member indices into
    ``ranks``)."""
    from . import mesh as _mesh

    return _mesh.current_mesh().enumerated_group(
        [[ranks[i] for i in grp] for grp in groups])


def _bytes(t):
    """A payload as bytes for the wire (the fp8 dtype is not every
    backend's; int8 and uint8 are)."""
    return t.contiguous().view(torch.uint8)


def _exchange(q, pg):
    """all_to_all of the (n, k) rows: row j goes to member j, row j of the
    result came from member j."""
    out = torch.empty_like(q)
    dist.all_to_all_single(_bytes(out), _bytes(q), group=pg)
    return out


def _gather_tiled(x, pg, n):
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(_bytes(out), _bytes(x), group=pg)
    return out


# -- quantized / hierarchical allreduce ---------------------------------------

def all_reduce_compressed(x, axis, *, compress: str = "int8",
                          block_size: int = 256, groups=None,
                          mean_denom: Optional[int] = None):
    """Block-quantized sum-allreduce over a group (or, with ``groups``, over
    this rank's group of that partition).  The payload rides the wire as
    int8/fp8 with per-block fp32 scales; accumulation is fp32.
    ``mean_denom`` divides the reduced value before the second
    quantization (pmean semantics without spending quantization range on
    the division)."""
    _check_kind(compress)
    pg, ranks = _members(axis)
    if groups is not None:
        pg = _subgroup(ranks, groups)
    n = len(groups[0]) if groups is not None else len(ranks)
    x = torch.as_tensor(x)
    if n <= 1:
        out = x.to(torch.float32)
        if mean_denom:
            out = true_div(out, mean_denom)
        return out.to(x.dtype)
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    m = flat.numel()
    chunk = n * block_size
    pad = (-m) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    # 1. local blockwise quantize
    q, s = quantize_blockwise(flat, compress, block_size)
    # 2. reduce-scatter exchange: row j of the reshaped payload is the chunk
    #    owned by member j; all_to_all hands each member everyone's copy of
    #    its own chunk.
    qx = _exchange(q.reshape(n, -1), pg)
    sx = _exchange(s.reshape(n, -1), pg)
    # 3. dequantize each peer's contribution and accumulate in fp32
    shard = (qx.reshape(n, -1, block_size).to(torch.float32)
             * sx.reshape(n, -1, 1)).sum(dim=0).reshape(-1)
    if mean_denom:
        shard = true_div(shard, mean_denom)
    # 4. re-quantize the reduced shard and all-gather it
    q2, s2 = quantize_blockwise(shard, compress, block_size)
    out = dequantize_blockwise(_gather_tiled(q2, pg, n),
                               _gather_tiled(s2, pg, n), block_size)
    if pad:
        out = out[:m]
    return out.reshape(shape).to(dtype)


def _flat_sum_(buf, pg, n, mean):
    """In place: ``buf`` summed (or averaged) over the group."""
    if pg is not None:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=pg)
    if mean:
        buf.div_(_on_device(n, buf))   # in place, correctly rounded
    return buf


def optimized_all_reduce(x, axis, *, compress: Optional[str] = None,
                         block_size: int = 256, hierarchy: Any = "auto",
                         mean: bool = False):
    """Sum (or mean) allreduce over a group with an optional
    block-quantized payload and optional hierarchical scheduling.

    Flat unquantized calls are one plain all-reduce (then a division by the
    member count for the mean).  Hierarchical unquantized: intra
    reduce-scatter -> inter allreduce -> intra all-gather, all fp32.  With
    compress set, only the phase that crosses hosts (inter) carries
    quantized bytes; the intra phases stay full precision."""
    if compress is not None:
        _check_kind(compress)
    pg, ranks = _members(axis)
    n = len(ranks)
    hier = resolve_hierarchy(hierarchy, n)
    denom = n if mean else None
    x = torch.as_tensor(x)
    _record_comm(axis, x.numel(), compress, block_size, n)
    if hier is None:
        if compress is None:
            return _flat_sum_(x.clone(), pg, n, mean)
        return all_reduce_compressed(
            x, axis, compress=compress, block_size=block_size,
            mean_denom=denom)
    intra, _inter = hier
    intra_groups, inter_groups = hierarchical_groups(n, intra)
    shape, dtype = x.shape, x.dtype
    flat = x.to(torch.float32).reshape(-1)
    m = flat.numel()
    pad = (-m) % intra
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    intra_pg = _subgroup(ranks, intra_groups)
    # intra-host reduce-scatter on the fast links (full precision)
    shard = flat.new_empty(flat.numel() // intra)
    dist.reduce_scatter_tensor(shard, flat.contiguous(),
                               op=dist.ReduceOp.SUM, group=intra_pg)
    # inter-host allreduce of the 1/intra shard (quantized when requested)
    if compress is None:
        dist.all_reduce(shard, op=dist.ReduceOp.SUM,
                        group=_subgroup(ranks, inter_groups))
        if denom:
            shard = true_div(shard, denom)
    else:
        shard = all_reduce_compressed(
            shard, axis, compress=compress, block_size=block_size,
            groups=inter_groups, mean_denom=denom)
    # intra-host all-gather back to the full vector
    full = _gather_tiled(shard, intra_pg, intra)
    if pad:
        full = full[:m]
    return full.reshape(shape).to(dtype)


def _record_comm(axis, nelem, compress, block_size, n):
    """Telemetry for one allreduce: its wire bytes and compression ratio
    (the JAX package records them when the step is traced; here, per
    call)."""
    from ..utils import monitor as _monitor

    wire = wire_bytes(nelem, compress, block_size, n)
    raw = wire_bytes(nelem, None, block_size, n)
    _monitor.histogram(
        "comm.allreduce_bytes", "wire bytes per allreduce",
        labelnames=("axis", "dtype"),
        buckets=(1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26, 1 << 30),
    ).observe(wire, axis=str(axis), dtype=compress or "fp32")
    if raw:
        _monitor.gauge(
            "comm.compress_ratio", "wire bytes relative to fp32 allreduce",
        ).set(wire / raw)


# -- gradient pytrees ---------------------------------------------------------

def _flatten(tree, path=""):
    """[(name, leaf)] in the JAX package's pytree order (dict keys sorted,
    sequences in order, None empty) with ``jax.tree_util.keystr`` names."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator, in _flatten's
    order) in place of its leaves."""
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)


def _dtype_name(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


# -- gradient bucketing -------------------------------------------------------

def bucket_assignment(sizes: Sequence[int], buffer_mb: float) -> List[List[int]]:
    """Greedy capacity fill: partition leaf indices (already in issue order)
    into contiguous buckets of at most ~buffer_mb MB of fp32 payload.  A
    leaf larger than the cap gets its own bucket.  Deterministic: depends
    only on the byte sizes and the cap."""
    cap = max(1, int(float(buffer_mb) * (1 << 20)))
    buckets: List[List[int]] = []
    cur: List[int] = []
    filled = 0
    for i, nbytes in enumerate(sizes):
        if cur and filled + nbytes > cap:
            buckets.append(cur)
            cur, filled = [], 0
        cur.append(i)
        filled += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def bucket_signature(grads, buffer_mb: float) -> str:
    """Stable hex digest of the bucket layout (leaf names, shapes, dtypes,
    cap), the same string as the JAX package's for the same tree."""
    rev = list(reversed(_flatten(grads)))
    buckets = bucket_assignment([leaf.numel() * 4 for _, leaf in rev],
                                buffer_mb)
    h = hashlib.sha256()
    h.update(f"buffer_mb={float(buffer_mb):g}".encode())
    for b in buckets:
        h.update(b"|bucket")
        for i in b:
            name, leaf = rev[i]
            h.update(f";{name}:{tuple(leaf.shape)}:"
                     f"{_dtype_name(leaf)}".encode())
    return h.hexdigest()


def bucketed_all_reduce(grads, axis, *, buffer_mb: float = 25.0,
                        compress: Optional[str] = None,
                        block_size: int = 256, hierarchy: Any = "auto",
                        mean: bool = True):
    """Allreduce a gradient tree in coalesced flat fp32 buckets.

    Leaves are concatenated in reverse flatten order (the gradients a
    backward produces first go into the first bucket) and each bucket
    rides one ``optimized_all_reduce``; the input is not changed."""
    named = _flatten(grads)
    if not named:
        return grads
    rev = list(reversed(list(enumerate(named))))
    buckets = bucket_assignment([leaf.numel() * 4 for _, (_, leaf) in rev],
                                buffer_mb)
    out_flat: List[Any] = [None] * len(named)
    for bucket in buckets:
        parts = [rev[i][1][1].detach().to(torch.float32).reshape(-1)
                 for i in bucket]
        buf = parts[0] if len(parts) == 1 else torch.cat(parts)
        red = optimized_all_reduce(
            buf, axis, compress=compress, block_size=block_size,
            hierarchy=hierarchy, mean=mean)
        off = 0
        for i in bucket:
            orig_idx, (_, leaf) = rev[i]
            size = leaf.numel()
            out_flat[orig_idx] = red[off:off + size].reshape(
                leaf.shape).to(leaf.dtype)
            off += size
    return _unflatten(grads, iter(out_flat))


def sync_gradients(grads, axis, *, compress: Optional[str] = None,
                   block_size: int = 256, buffer_mb: float = 25.0,
                   hierarchy: Any = "auto"):
    """Average a gradient tree over the dp group: the shared bucketer
    behind fleet's comm_quantize and dygraph DataParallel(comm_buffer_size).

    The JAX package divides leaves that a VMA-tracking backward already
    summed over the axis by its size (``_leaf_varying`` false) and buckets
    the rest.  In the port each rank's backward is its own, so every leaf
    still varies over dp: the whole tree rides the bucketed mean
    allreduce."""
    return bucketed_all_reduce(
        grads, axis, buffer_mb=buffer_mb, compress=compress,
        block_size=block_size, hierarchy=hierarchy, mean=True)
