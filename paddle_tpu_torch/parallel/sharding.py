"""Parameter and state sharding: rules -> specs -> this rank's slices
(counterpart of paddle_tpu/parallel/sharding.py, without ``ShardingPlan``,
which is the static Executor's placement plan: ROADMAP.md Queue 1 item
9b).

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
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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
    "VocabParallelEmbedding", "TRANSFORMER_RULES",
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


def place(x, spec, mesh=None) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` under ``spec``, on the
    rank's device (the JAX package's ``device_put`` with a
    ``NamedSharding``): a new tensor, never a view of ``x``."""
    mesh = mesh or _mesh.current_mesh()
    t = torch.as_tensor(x)
    for dim, a in enumerate(tuple(spec)):
        if a is None:
            continue
        idx, n = _coords(a, mesh)
        per = t.shape[dim] // n
        t = t.narrow(dim, idx * per, per)
    if mesh.device is not None and t.device != mesh.device:
        return t.to(mesh.device).contiguous()
    return t.clone(memory_format=torch.contiguous_format)


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
