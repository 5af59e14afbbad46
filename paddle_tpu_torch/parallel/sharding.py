"""Parameter and state sharding: rules -> specs -> this rank's slices
(counterpart of paddle_tpu/parallel/sharding.py).  ``ShardingPlan`` comes
with its placement half (the specs of a state and of a feed, the
fingerprint), which the elastic checkpoints read; the static Executor's
use of a plan and the sharded embedding are ROADMAP.md Queue 1 items 9 and
9b.

A spec (``PartitionSpec``, a tuple as the JAX one) says which mesh dim
splits which tensor dim.  The JAX package places a pytree on the mesh and
lets GSPMD insert the collectives; in the port each rank is a process,
so "placing" a tensor means this rank keeps its slice (``place``), and
``unshard`` gathers the whole tensor back.  The collectives GSPMD would
insert are written out: ``shard_layer`` turns rule-matched ``Linear``s
into Megatron column- and row-parallel ones (an attention layer then
runs on its local heads) and a vocab-split ``Embedding`` into a
vocab-parallel lookup.

Three layers of intent, highest precedence first (as in the JAX
package):
1. ``Parameter.sharding_axes`` set by a layer (MoEFFN marks its expert
   dim ``ep``);
2. ``ShardingRules``: an ordered [(name regex, axes)] table over the
   structured parameter names;
3. ZeRO: the largest divisible dim of every remaining leaf over dp
   (stage 3 for parameters; fleet's ``sharding`` applies it to the
   optimizer state only, stage 1).

A rank's slice records what it is a slice of: ``place`` (and
``mark_slice``) set ``sharding_axes`` (the spec) and ``global_shape`` on
it, which ``slice_spec`` reads back; ``elastic.checkpoint`` writes such a
slice as the shard of the whole tensor it holds.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..nn import functional as F
from ..nn.layer.base import Layer, Parameter
from ..nn.layer.common import Embedding, Linear
from . import collective as _coll
from . import mesh as _mesh

__all__ = [
    "PartitionSpec", "ShardingRules", "zero_spec", "infer_sharding",
    "place", "shard_params", "layer_annotations", "shard_layer",
    "shard_pytree", "unshard", "ColumnParallelLinear", "RowParallelLinear",
    "VocabParallelEmbedding", "TRANSFORMER_RULES", "ShardingPlan",
    "mark_slice", "slice_spec", "spec_index",
]

Rules = Sequence[Tuple[str, Sequence[Optional[Union[str, Tuple[str, ...]]]]]]


class PartitionSpec(tuple):
    """Per tensor dim: None, a mesh dim name, or a tuple of names (the JAX
    ``PartitionSpec``, trailing Nones dropped by the functions here)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def _axis_name_error(axis: str, mesh, where: str) -> ValueError:
    from ..static.registry import suggest_names  # lazy: avoids a cycle

    candidates = list(mesh.axis_names) + [
        a for a in _mesh._CANONICAL_ORDER if a not in mesh.axis_names]
    suggestion = suggest_names(axis, candidates=candidates)
    msg = (f"{where} references axis {axis!r}, which is neither in the "
           f"mesh {tuple(mesh.axis_names)} nor a canonical axis "
           f"{_mesh._CANONICAL_ORDER}")
    if suggestion:
        msg += f" — {suggestion}"
    return ValueError(msg)


def _validate_axes(axes, mesh, where: str) -> None:
    """Reject axis names that are neither mesh dims nor canonical names (a
    canonical name absent from the mesh is the degree-1 collapse)."""
    if axes is None or mesh is None:
        return
    valid = set(mesh.axis_names) | set(_mesh._CANONICAL_ORDER)
    for a in axes:
        if a is None:
            continue
        for x in (a if isinstance(a, (tuple, list)) else (a,)):
            if isinstance(x, str) and x not in valid:
                raise _axis_name_error(x, mesh, where)


class ShardingRules:
    """Ordered regex -> axes table applied to structured parameter names."""

    def __init__(self, rules: Rules = ()):
        self.rules: List[Tuple[re.Pattern, Tuple]] = []
        for pat, axes in rules:
            self.add(pat, axes)

    def add(self, pattern: str, axes: Sequence):
        # typo check against the ambient mesh, when one is set
        _validate_axes(tuple(axes), _mesh.get_mesh(),
                       f"sharding rule {pattern!r}")
        self.rules.append((re.compile(pattern), tuple(axes)))
        return self

    def match(self, name: str, ndim: int) -> Optional[Tuple]:
        for pat, axes in self.rules:
            if pat.search(name) and len(axes) == ndim:
                return axes
        return None


def _clean_spec(axes: Optional[Tuple], mesh) -> PartitionSpec:
    """Drop dims absent from the mesh (degree-1 parallelism collapses to
    replication) and trailing Nones."""
    if axes is None:
        return PartitionSpec()
    out = []
    for a in axes:
        if a is None:
            out.append(None)
        elif isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x in mesh.axis_names)
            out.append(kept if kept else None)
        else:
            out.append(a if a in mesh.axis_names else None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _names(a) -> Tuple[str, ...]:
    return () if a is None else (a if isinstance(a, tuple) else (a,))


def _divisible(shape, spec: PartitionSpec, mesh) -> bool:
    for dim, a in zip(shape, tuple(spec)):
        n = 1
        for x in _names(a):
            n *= mesh.shape[x]
        if dim % n:
            return False
    return True


def zero_spec(shape, mesh, axis: str = _mesh.DP_AXIS) -> PartitionSpec:
    """ZeRO-style spec: the largest divisible dim over ``axis``."""
    if axis not in mesh.axis_names or not shape:
        return PartitionSpec()
    n = mesh.shape[axis]
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % n == 0 and shape[i] >= n:
            spec = [None] * len(shape)
            spec[i] = axis
            return _clean_spec(tuple(spec), mesh)
    return PartitionSpec()


def infer_sharding(params: Dict[str, Any], mesh=None,
                   rules: Optional[ShardingRules] = None,
                   annotations: Optional[Dict[str, Tuple]] = None,
                   zero_stage: int = 0) -> Dict[str, PartitionSpec]:
    """The spec of every leaf of a flat {name: tensor} dict: annotation >
    rule > (ZeRO-3) > replicated; a spec whose dims do not divide the
    shape replicates."""
    mesh = mesh or _mesh.current_mesh()
    out: Dict[str, PartitionSpec] = {}
    for name, v in params.items():
        shape = tuple(v.shape)
        spec = None
        if annotations and annotations.get(name) is not None:
            spec = _clean_spec(annotations[name], mesh)
        if spec is None and rules is not None:
            m = rules.match(name, len(shape))
            if m is not None:
                spec = _clean_spec(m, mesh)
        if spec is not None and not _divisible(shape, spec, mesh):
            spec = None
        if spec is None or spec == PartitionSpec():
            spec = zero_spec(shape, mesh) if zero_stage >= 3 \
                else PartitionSpec()
        out[name] = spec
    return out


def _coords(a, mesh) -> Tuple[int, int]:
    """(this rank's index, member count) over the dim(s) ``a``, the first
    name outermost."""
    idx, n = 0, 1
    for x in _names(a):
        idx = idx * mesh.shape[x] + mesh.axis_index(x)
        n *= mesh.shape[x]
    return idx, n


def spec_index(spec, shape, mesh, coords=None) -> List[List[int]]:
    """The ``[[start, stop], ...]`` box of the whole tensor of ``shape``
    that the rank at mesh ``coords`` ({dim name: index}; default this
    rank's) holds under ``spec``."""
    out = []
    for dim, size in enumerate(shape):
        a = tuple(spec)[dim] if dim < len(tuple(spec)) else None
        idx, n = 0, 1
        for x in _names(a):
            c = (mesh.axis_index(x) if coords is None
                 else int(coords.get(x, 0)))
            idx, n = idx * mesh.shape[x] + c, n * mesh.shape[x]
        per = int(size) // n
        out.append([idx * per, (idx + 1) * per])
    return out


def mark_slice(t, spec, global_shape):
    """Record on ``t``, this rank's slice of a whole tensor of
    ``global_shape``, the spec it was cut by; returns ``t``."""
    t.sharding_axes = tuple(spec)
    t.global_shape = tuple(int(d) for d in global_shape)
    return t


def slice_spec(t) -> Optional[Tuple[tuple, Tuple[int, ...]]]:
    """(spec, whole shape) of a slice marked by ``place`` / ``mark_slice``,
    or None for a whole tensor."""
    shape = getattr(t, "global_shape", None)
    if shape is None:
        return None
    return tuple(t.sharding_axes), tuple(shape)


def place(x, spec, mesh=None) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` under ``spec``, on the
    rank's device (the JAX package's ``device_put`` with a
    ``NamedSharding``): a new tensor, never a view of ``x``, marked with
    its spec and ``x``'s shape when ``spec`` splits a dim."""
    mesh = mesh or _mesh.current_mesh()
    t = torch.as_tensor(x)
    whole = tuple(t.shape)
    for dim, a in enumerate(tuple(spec)):
        if a is None:
            continue
        idx, n = _coords(a, mesh)
        per = t.shape[dim] // n
        t = t.narrow(dim, idx * per, per)
    if mesh.device is not None and t.device != mesh.device:
        t = t.to(mesh.device).contiguous()
    else:
        t = t.clone(memory_format=torch.contiguous_format)
    if any(a is not None for a in tuple(spec)):
        mark_slice(t, spec, whole)
    return t


def shard_params(params: Dict[str, Any], mesh=None,
                 rules: Optional[ShardingRules] = None,
                 annotations: Optional[Dict[str, Tuple]] = None,
                 zero_stage: int = 0) -> Dict[str, torch.Tensor]:
    """Every leaf's slice on this rank, by ``infer_sharding``."""
    mesh = mesh or _mesh.current_mesh()
    specs = infer_sharding(params, mesh, rules, annotations, zero_stage)
    return {k: place(v, specs[k], mesh) for k, v in params.items()}


def layer_annotations(layer) -> Dict[str, Tuple]:
    """``Parameter.sharding_axes`` annotations keyed by structured name."""
    out = {}
    for name, p in layer.named_parameters():
        if getattr(p, "sharding_axes", None) is not None:
            out[name] = tuple(p.sharding_axes)
    return out


def unshard(x, spec=None, mesh=None):
    """The whole tensor from this rank's slice ``x`` under ``spec`` (every
    split dim all-gathered over its mesh dims); a dict of tensors takes a
    dict of specs.  The JAX package's fetch to host replicas."""
    if isinstance(x, dict):
        return {k: unshard(v, None if spec is None else spec.get(k), mesh)
                for k, v in x.items()}
    mesh = mesh or _mesh.current_mesh()
    t = x
    for dim, a in enumerate(tuple(spec or ())):
        # the first name is outermost: gather the innermost first
        for name in reversed(_names(a)):
            with torch.no_grad():
                t = _coll.all_gather(t, group=name, axis=dim)
    return t


def shard_pytree(tree, like_tree_specs, mesh=None):
    """Place a nested dict of tensors with specs taken leaf-wise from a
    matching nested dict (optimizer state inheriting its parameter's)."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, like_tree_specs.get(k), mesh)
                for k, v in tree.items()}
    if like_tree_specs is None or not isinstance(tree, torch.Tensor):
        return tree
    return place(tree, like_tree_specs, mesh)


# -- tensor-parallel layers -------------------------------------------------

def _bare(cls, src, axis):
    """An instance of ``cls`` with ``src``'s plain attributes and no
    parameters yet (no initializer runs, so no random stream moves)."""
    out = cls.__new__(cls)
    Layer.__init__(out)
    for k, v in vars(src).items():
        if not k.startswith("_") and k not in ("weight", "bias", "training"):
            setattr(out, k, v)
    out.axis = axis
    return out


def _local(p, spec, mesh):
    q = Parameter(place(p.detach(), spec, mesh), trainable=p.requires_grad,
                  name=p.name, initializer=p.initializer)
    q.sharding_axes = tuple(spec)
    q.global_shape = tuple(p.shape)
    return q


class ColumnParallelLinear(Linear):
    """Megatron's column-parallel ``Linear``: this rank holds out-features
    ``[r*out/n, (r+1)*out/n)`` of W (and b); the input, whole on every
    member, enters through ``copy_to_group`` (its gradient sums the
    members' parts) and the output stays split on its last dim."""

    @classmethod
    def from_linear(cls, lin: Linear, axis: str, mesh) -> "ColumnParallelLinear":
        out = _bare(cls, lin, axis)
        out.weight = _local(lin.weight, PartitionSpec(None, axis), mesh)
        out.bias = None if lin.bias is None else _local(
            lin.bias, PartitionSpec(axis), mesh)
        return out

    def forward(self, x):
        return F.linear(_coll.copy_to_group(x, self.axis), self.weight,
                        self.bias)


class RowParallelLinear(Linear):
    """Megatron's row-parallel ``Linear``: this rank holds in-features
    ``[r*in/n, (r+1)*in/n)`` of W, takes its split of the input, and the
    members' partial products are summed (``all_reduce``, identity
    backward) before the whole bias is added."""

    @classmethod
    def from_linear(cls, lin: Linear, axis: str, mesh) -> "RowParallelLinear":
        out = _bare(cls, lin, axis)
        out.weight = _local(lin.weight, PartitionSpec(axis), mesh)
        out.bias = lin.bias
        return out

    def forward(self, x):
        y = _coll.all_reduce(F.linear(x, self.weight, None), group=self.axis)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(Embedding):
    """An ``Embedding`` whose rows are split over ``axis``: this rank looks
    up the ids in its range ``[r*V/n, (r+1)*V/n)`` (zeros elsewhere) and
    the members' rows are summed (``all_reduce``)."""

    @classmethod
    def from_embedding(cls, emb: Embedding, axis: str, mesh):
        out = _bare(cls, emb, axis)
        out.weight = _local(emb.weight, PartitionSpec(axis), mesh)
        idx, _ = _coords(axis, mesh)
        out.start = idx * out.weight.shape[0]
        return out

    def forward(self, x):
        rows = self.weight.shape[0]
        local = x.long() - self.start
        mine = (local >= 0) & (local < rows)
        if self.padding_idx is not None:
            mine = mine & (x != self.padding_idx)
        y = F.embedding(local.clamp(0, rows - 1), self.weight)
        y = y * mine[..., None].to(y.dtype)
        return _coll.all_reduce(y, group=self.axis)


def _set_child(root, path: str, module) -> None:
    parent, _, leaf = path.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, module)


def shard_layer(layer, mesh=None, rules: Optional[ShardingRules] = None,
                zero_stage: int = 0):
    """Re-make ``layer`` for this rank in place: a ``Linear`` whose weight
    spec splits its out-features becomes column-parallel, its
    in-features row-parallel; a row-split ``Embedding`` vocab-parallel; a
    ``MultiHeadAttention`` with column-parallel projections runs on its
    local heads; every other parameter with a spec keeps its slice
    (``Parameter.sharding_axes`` records the spec).  Specs come from
    ``infer_sharding`` over the layer's annotations and ``rules``.  ZeRO-3
    parameter sharding has no gather-on-use in the port and raises."""
    from ..nn.layer.transformer import MultiHeadAttention

    if zero_stage >= 3:
        raise NotImplementedError(
            "shard_layer(zero_stage=3): the port shards optimizer state "
            "(ZeRO-1, fleet sharding), not parameters")
    mesh = mesh or _mesh.current_mesh()
    params = dict(layer.named_parameters())
    specs = infer_sharding(params, mesh, rules, layer_annotations(layer))
    done = set()
    for path, mod in list(layer.named_modules()):
        pre = path + "." if path else ""
        wspec = tuple(specs.get(pre + "weight", ()))
        if type(mod) is Linear and wspec:
            if wspec[0] is None and len(wspec) == 2:
                new = ColumnParallelLinear.from_linear(mod, wspec[1], mesh)
            elif len(wspec) == 1:
                new = RowParallelLinear.from_linear(mod, wspec[0], mesh)
            else:
                raise ValueError(f"{pre}weight: spec {wspec} splits both "
                                 "dims of a Linear")
            _set_child(layer, path, new)
            done.update({pre + "weight", pre + "bias"})
        elif type(mod) is Embedding and wspec:
            if len(wspec) != 1:
                raise ValueError(f"{pre}weight: spec {wspec} splits the "
                                 "embedding width")
            _set_child(layer, path,
                       VocabParallelEmbedding.from_embedding(mod, wspec[0],
                                                             mesh))
            done.add(pre + "weight")
    for path, mod in layer.named_modules():
        if isinstance(mod, MultiHeadAttention) and isinstance(
                mod.q_proj, ColumnParallelLinear):
            n = _mesh.mesh_axis_size(mod.q_proj.axis, mesh)
            if mod.num_heads % n:
                raise ValueError(f"{path}: {mod.num_heads} heads do not "
                                 f"split over {n} ranks")
            mod.num_heads //= n
    for name, spec in specs.items():
        if name in done or not tuple(spec):
            continue
        path, _, leaf = name.rpartition(".")
        owner = layer.get_submodule(path) if path else layer
        setattr(owner, leaf, _local(getattr(owner, leaf), spec, mesh))
    return layer


# -- the placement plan ------------------------------------------------------

_plan_tokens = iter(range(1, 1 << 62))

_EMBEDDING_9B = ("vocab-sharded embedding tables (ShardingPlan "
                 "embedding_shard / embedding_*) come with the sharded "
                 "embedding, ROADMAP.md Queue 1 item 9b")


class _Shape:
    """A leaf's shape without its values (``infer_sharding`` reads
    ``.shape`` only)."""

    def __init__(self, shape):
        self.shape = tuple(int(d) for d in shape)


def _leaf_shape(v) -> Tuple[int, ...]:
    """The whole tensor's shape: a marked slice's ``global_shape``, else
    the value's own."""
    marked = slice_spec(v)
    if marked is not None:
        return marked[1]
    return tuple(int(d) for d in np.shape(v)) if not hasattr(v, "shape") \
        else tuple(int(d) for d in v.shape)


class ShardingPlan:
    """Resolved placement intent on a mesh (the JAX package's
    ``ShardingPlan``, its placement half).

    One plan = one placement policy: how feed batches split across the mesh
    (``batch_axes`` / ``seq_axis``) and how a flat persistable-state dict is
    laid out (``annotations`` > ``rules`` > ZeRO ``zero_stage``, the
    ``infer_sharding`` precedence; under ZeRO-1/2 the optimizer slots named
    to ``state_shardings`` split over dp).  The constructor takes the JAX
    plan's arguments; the specs are the port's ``PartitionSpec``s on the
    port's ``Mesh`` and ``fingerprint()`` is the JAX plan's string for the
    same mesh shape and knobs.  ``comm_*`` builds a
    ``compress.CommOptions``.  ``donate`` is recorded for the fingerprint
    (the Executor does not take a plan yet: ROADMAP.md Queue 1 item 9b).
    The ``embedding_*`` knobs raise ``NotImplementedError`` (item 9b)."""

    def __init__(self, mesh=None, rules: Optional[ShardingRules] = None,
                 annotations: Optional[Dict[str, Tuple]] = None,
                 zero_stage: int = 0,
                 batch_axes: Sequence[str] = (_mesh.DP_AXIS,),
                 seq_axis: Optional[str] = None,
                 donate: bool = True,
                 devices: Optional[Sequence] = None,
                 comm_quantize: str = "",
                 comm_block_size: int = 256,
                 comm_buffer_mb: float = 25.0,
                 comm_hierarchy: Any = "auto",
                 embedding_shard: Optional[Union[str, Dict[str, str]]] = None,
                 embedding_capacity: Optional[float] = None,
                 embedding_quantize: str = ""):
        if mesh is not None and devices is not None:
            raise ValueError("pass either mesh or devices, not both")
        if (embedding_shard is not None or embedding_capacity is not None
                or embedding_quantize):
            raise NotImplementedError(_EMBEDDING_9B)
        self._mesh = mesh
        self._devices = list(devices) if devices is not None else None
        self.rules = rules
        self.annotations = dict(annotations) if annotations else None
        self.zero_stage = int(zero_stage)
        self.batch_axes = tuple(batch_axes)
        self.seq_axis = seq_axis
        self.donate = bool(donate)
        known_mesh = mesh if mesh is not None else _mesh.get_mesh()
        _validate_axes(self.batch_axes, known_mesh, "batch_axes")
        if seq_axis is not None:
            _validate_axes((seq_axis,), known_mesh, "seq_axis")
        if self.annotations:
            for _name, _spec in self.annotations.items():
                _validate_axes(_spec, known_mesh,
                               f"annotation for {_name!r}")
        from . import compress as _compress

        if comm_quantize and comm_quantize != "none" \
                and comm_quantize not in _compress.COMPRESS_KINDS:
            from ..static.registry import suggest_names

            suggestion = suggest_names(
                comm_quantize,
                candidates=list(_compress.COMPRESS_KINDS) + ["none"])
            raise ValueError(
                f"comm_quantize={comm_quantize!r} is not a known kind "
                f"{_compress.COMPRESS_KINDS}"
                + (f" — {suggestion}" if suggestion else ""))
        self.comm = None
        if comm_quantize:
            self.comm = _compress.CommOptions(
                quantize=comm_quantize, block_size=int(comm_block_size),
                buffer_mb=float(comm_buffer_mb), hierarchy=comm_hierarchy)
        self.embedding_shard = None
        self.embedding_capacity = None
        self.embedding_quantize = ""
        # identity token (the JAX plan's cheap in-memory cache key)
        self.token = next(_plan_tokens)

    def comm_scope(self):
        """Context manager making this plan's comm options ambient (a no-op
        context when the plan carries none)."""
        from . import compress as _compress
        return _compress.comm_scope(self.comm)

    def embedding_axis_for(self, name: str, lookup: bool = False):
        raise NotImplementedError(_EMBEDDING_9B)

    def bind_embedding_tables(self, program):
        raise NotImplementedError(_EMBEDDING_9B)

    def embedding_scope(self, program=None):
        raise NotImplementedError(_EMBEDDING_9B)

    def resolve_mesh(self):
        """The mesh this plan places onto (resolved once, then pinned).  A
        ``devices``-only plan gets a one-dim dp mesh over those ranks."""
        if self._mesh is None:
            if self._devices is not None:
                self._mesh = _mesh.build_mesh(
                    _mesh.MeshConfig(devices=self._devices))
            else:
                self._mesh = _mesh.current_mesh()
        return self._mesh

    def num_devices(self) -> int:
        return self.resolve_mesh().size

    def _batch_spec_axes(self, mesh) -> Tuple[str, ...]:
        return tuple(a for a in self.batch_axes if a in mesh.axis_names)

    def batch_divisor(self, mesh=None) -> int:
        mesh = mesh or self.resolve_mesh()
        return math.prod(mesh.shape[a] for a in self._batch_spec_axes(mesh))

    def feed_sharding(self, name: str, arr, mesh=None) -> PartitionSpec:
        """The spec of one feed array: the leading (batch) dim over the
        batch dims, the second over ``seq_axis`` when it divides; scalars
        and batch-1 feeds replicate.  An indivisible batch raises."""
        mesh = mesh or self.resolve_mesh()
        batch = self._batch_spec_axes(mesh)
        shape = tuple(np.shape(arr)) if not hasattr(arr, "shape") \
            else tuple(arr.shape)
        ndim = len(shape)
        if not batch or ndim == 0 or shape[0] == 1:
            return PartitionSpec()
        n = self.batch_divisor(mesh)
        if shape[0] % n != 0:
            raise ValueError(
                f"data-parallel feed '{name}' batch dim {shape[0]} "
                f"does not divide the {n} devices (the reference's "
                "with_data_parallel requires an even split)")
        spec = [batch if len(batch) > 1 else batch[0]]
        if (self.seq_axis is not None and self.seq_axis in mesh.axis_names
                and ndim > 1 and shape[1] % mesh.shape[self.seq_axis] == 0
                and shape[1] > 1):
            spec.append(self.seq_axis)
        return PartitionSpec(*spec)

    def feed_shardings(self, batch: Dict[str, Any],
                       mesh=None) -> Dict[str, PartitionSpec]:
        mesh = mesh or self.resolve_mesh()
        return {k: self.feed_sharding(k, v, mesh) for k, v in batch.items()}

    def state_shardings(self, state: Dict[str, Any], mesh=None,
                        optimizer_slots=None) -> Dict[str, PartitionSpec]:
        """The spec of every leaf of a flat state dict (annotations > rules
        > ZeRO-3 > replicated; a marked slice counts at its whole shape).
        Under ``zero_stage`` 1-2 the leaves named in ``optimizer_slots``
        split over dp (``zero_spec``) where nothing else places them."""
        mesh = mesh or self.resolve_mesh()
        shapes = {k: _Shape(_leaf_shape(v)) for k, v in state.items()}
        out = infer_sharding(shapes, mesh, self.rules, self.annotations,
                             self.zero_stage)
        if self.zero_stage in (1, 2) and optimizer_slots:
            for name in optimizer_slots:
                if name not in state or out.get(name) != PartitionSpec():
                    continue
                spec = zero_spec(shapes[name].shape, mesh)
                if spec != PartitionSpec():
                    out[name] = spec
        return out

    def placement_spec(self, name: str, shape: Tuple[int, ...],
                       mesh=None) -> PartitionSpec:
        """The spec of one persistable var by name and shape, with the
        precedence ``state_shardings`` applies."""
        mesh = mesh or self.resolve_mesh()
        return infer_sharding({name: _Shape(shape)}, mesh, self.rules,
                              self.annotations, self.zero_stage)[name]

    def placement_divisor(self, name: str, shape: Tuple[int, ...],
                          mesh=None) -> int:
        """How many ways this plan splits the named var (1 = replicated)."""
        mesh = mesh or self.resolve_mesh()
        spec = self.placement_spec(name, tuple(shape), mesh)
        return math.prod(mesh.shape[x] for a in tuple(spec)
                         for x in _names(a))

    def fingerprint(self) -> str:
        """Content fingerprint: mesh shape + every placement knob, the JAX
        plan's string for the same mesh shape and knobs."""
        mesh = self.resolve_mesh()
        rules = "-"
        if self.rules is not None:
            rules = ";".join(f"{p.pattern}->{a}"
                             for p, a in self.rules.rules)
        ann = "-"
        if self.annotations:
            ann = ";".join(f"{k}->{v}"
                           for k, v in sorted(self.annotations.items()))
        comm = self.comm.signature() if self.comm is not None else "-"
        return (f"{_mesh.mesh_fingerprint(mesh)}|batch={self.batch_axes}"
                f"|seq={self.seq_axis}|zero={self.zero_stage}"
                f"|donate={int(self.donate)}|rules={rules}|ann={ann}"
                f"|comm={comm}|emb=-")


# Default rule table for transformer-family models (ERNIE/BERT/GPT blocks):
# Megatron layout -- attention qkv + ffn-in column-parallel, attention-out +
# ffn-out row-parallel, embeddings vocab-parallel.  Matches the structured
# names of nn.layer.transformer / text.ernie.
TRANSFORMER_RULES = ShardingRules([
    (r"word_embeddings\.weight$", (_mesh.TP_AXIS, None)),
    (r"(q_proj|k_proj|v_proj|qkv_proj)\.weight$", (None, _mesh.TP_AXIS)),
    (r"(q_proj|k_proj|v_proj|qkv_proj)\.bias$", (_mesh.TP_AXIS,)),
    (r"out_proj\.weight$", (_mesh.TP_AXIS, None)),
    (r"linear1\.weight$", (None, _mesh.TP_AXIS)),
    (r"linear1\.bias$", (_mesh.TP_AXIS,)),
    (r"linear2\.weight$", (_mesh.TP_AXIS, None)),
])
