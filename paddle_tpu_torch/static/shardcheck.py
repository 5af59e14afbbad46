"""Sharding-plan verifier: Program × ShardingPlan static checks (SC001–SC010)
(counterpart of paddle_tpu/static/shardcheck.py, over the port's
``parallel.ShardingPlan`` and ``Mesh``).

The port's plans cannot carry ``embedding_shard`` yet (ROADMAP item 9b:
the constructor raises), so SC010's sharded-table checks and the embedding
exchange estimate are reached by no plan; its dense-gradient warning is.
The Executor takes no plan yet either (9b), so ``check_with_plan`` is
called directly.  ``comm_quantize='fp8'`` is judged by what the port's
``compress._payload_dtype`` supports, not by a jax version.

The second tier of the static-analysis stack.  Tier one
(``static/analysis.py``, PV001–PV010) checks a Program in isolation; this
module checks the *pairing* of a Program with a ``parallel.ShardingPlan``
— the misconfigurations that today surface minutes into a run as an opaque
XLA trace error, a ``ValueError`` deep inside ``feed_sharding``, or (worst)
a silent wrong layout: a param the user believes is tensor-parallel that
``infer_sharding`` quietly replicated because a dim was indivisible.

Diagnostic codes (severity ``error`` aborts ``Executor.run`` under flag
``check_sharding``; ``warning`` never does):

- ``SC001`` feed batch divisibility: a concrete feed batch dim (or a
  serving bucket edge) does not divide the plan's batch-axis device
  product — ``feed_sharding`` would raise at placement time, the serving
  frontend at first submit.  An indivisible ``seq_axis`` dim is a warning
  (the plan silently skips sequence sharding there).
- ``SC002`` mesh-axis validity: a rules/annotations/batch_axes/seq_axis
  axis name that is neither in the mesh nor a canonical axis
  (dp/pp/ep/sp/tp) — almost always a typo; a difflib nearest-name
  suggestion is attached.  A *canonical* name absent from the mesh is the
  legitimate degree-1 collapse and stays silent.
- ``SC003`` state placement: an annotation whose rank does not match the
  variable, or an annotation/rule spec over an indivisible dim —
  ``infer_sharding`` silently falls back to replication (annotation: error;
  broad-regex rule: warning).  An annotation overriding a matching rule is
  a warning (precedence is defined, but usually unintended).
- ``SC004`` donation aliasing: under a donating plan, a var that is both
  ``is_data`` and persistable (the donated buffer aliases the feed), or a
  fed name that names persistable state (warning — the executor skips the
  alias at runtime, but the overlap is usually a bug).
- ``SC005`` comm_quantize applicability: unknown quantize kind (today it
  silently disables compression), fp8 without hardware dtype support,
  non-positive block size / buffer, non-float trainable params under block
  quantization; a gradient bucket smaller than one quantization block is a
  warning (scale overhead dominates).
- ``SC006`` sub-block consistency: cond branches whose *inferred* output
  shapes/dtypes disagree, while carries that are not shape-invariant
  against the body — lax.cond/lax.while_loop reject these at trace time
  with an aval error that names no source op.  (Found by the analysis
  engine; surfaced here because declared shapes often agree while inferred
  ones do not.)
- ``SC007`` serving buckets: registration-time validation of a tenant
  program against the server's bucket ladder — unsorted/non-positive
  edges, a fed name that is not a data var, a declared concrete batch dim
  exceeding the largest bucket.
- ``SC008`` ZeRO/annotation conflict: ``zero_stage > 0`` with an
  annotation/rule sharding state over a *batch* axis (dp carries replica
  semantics for gradient sync), or ``zero_stage >= 3`` with a param no dim
  of which divides the dp world (zero_spec silently replicates — warning).
- ``SC009`` predicted collective sites (warning): a matmul-family weight
  sharded on its contraction dim — GSPMD must insert an allreduce /
  all-gather there.  Legitimate for row-parallel layers; the site and its
  estimated bytes feed the communication estimate either way.
- ``SC010`` vocab-sharded embeddings (``ShardingPlan(embedding_shard=)``,
  parallel/embedding.py): a vocab dim indivisible by the shard axis
  (error — the sharded lookup raises at trace time), the shard axis doubling
  as a batch axis or a user annotation conflicting with the plan's table
  placement (errors — silent wrong layout otherwise), and a large table
  served by neither is_sparse nor a shard plan (warning — the backward
  materializes a dense vocab-sized gradient).

``estimate_comm`` additionally produces the static per-bucket allreduce
byte estimate for the data-parallel gradient sync (same math as
``compress.sync_gradients``: reverse-order leaves, ``bucket_assignment``,
``wire_bytes`` per bucket), cross-checkable against the measured
``comm.allreduce_bytes`` histogram via ``CommEstimate.measured_bytes``.

``check_with_plan`` is the Executor entry point: memoized by plan token ×
program version × feed-shape signature, so steady-state cost is zero and
the retrace/fast-path pins hold.  CLI: ``python -m tools.shardcheck``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import errors as _errors
from ..core.dtype import numpy_dtype as _np_dtype
from ..utils import monitor as _monitor
from .analysis import Diagnostic, infer_program
from .backward import GRAD_SUFFIX
from .framework import Parameter, Program

__all__ = [
    "CommEstimate", "PlanReport", "verify_plan", "check_plan",
    "check_with_plan", "estimate_comm",
]

_m_plans_checked = _monitor.counter(
    "analysis.plans_checked",
    "Full sharding-plan verifier walks (cache misses of check_with_plan "
    "plus direct verify_plan calls).")

# ops whose second operand is contracted: op type -> (weight slot, fn that
# maps (weight rank, attrs) -> contracted dim indices of the weight)
_CONTRACTION_OPS = {
    "mul": ("Y", lambda nd, at: tuple(range(int(at.get("y_num_col_dims", 1))))),
    "matmul": ("Y", lambda nd, at: (
        (nd - 1,) if at.get("transpose_Y", at.get("trans_y", False))
        else (nd - 2,)) if nd >= 2 else (0,)),
    "matmul_v2": ("Y", lambda nd, at: (
        (nd - 1,) if at.get("transpose_Y", at.get("trans_y", False))
        else (nd - 2,)) if nd >= 2 else (0,)),
    "fc": ("W", lambda nd, at: (0,)),
}


# ---------------------------------------------------------------------------
# Result containers
# ---------------------------------------------------------------------------

@dataclass
class CommEstimate:
    """Static communication prediction for one Program × plan."""

    world: int                       # batch-axis device product (dp sync)
    payload: Optional[str]           # "int8"/"fp8" or None (full precision)
    block_size: int
    buffer_mb: float
    # [(leaf names, total elements, predicted wire bytes)] per bucket, in
    # allreduce issue order (reverse parameter-declaration order)
    buckets: List[Tuple[Tuple[str, ...], int, int]] = field(default_factory=list)
    allreduce_bytes: int = 0
    # [(op site, weight name, sharded axes, estimated bytes)] from SC009
    gather_sites: List[Tuple[str, str, Tuple[str, ...], int]] = \
        field(default_factory=list)
    gather_bytes: int = 0
    # [(op site, table name, local ids priced, estimated bytes)] — the
    # vocab-sharded embedding all_to_all exchange (parallel/embedding.py),
    # same dedup-capacity x row-bytes x quantize-ratio math the traced
    # emb.exchange_bytes histogram observes
    exchange_sites: List[Tuple[str, str, int, int]] = field(default_factory=list)
    exchange_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return self.allreduce_bytes + self.gather_bytes + self.exchange_bytes

    def measured_bytes(self, axis: Optional[str] = None) -> float:
        """Sum of the ``comm.allreduce_bytes`` histogram (recorded at trace
        time by compress._record_comm) for cross-checking the estimate.
        ``axis=None`` sums every labeled cell."""
        return measured_comm_bytes(axis)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "world": self.world,
            "payload": self.payload,
            "block_size": self.block_size,
            "buffer_mb": self.buffer_mb,
            "allreduce_bytes": self.allreduce_bytes,
            "gather_bytes": self.gather_bytes,
            "exchange_bytes": self.exchange_bytes,
            "total_bytes": self.total_bytes,
            "buckets": [{"leaves": list(names), "nelem": nelem,
                         "wire_bytes": wire}
                        for names, nelem, wire in self.buckets],
            "gather_sites": [{"site": site, "weight": w,
                              "axes": list(axes), "bytes": b}
                             for site, w, axes, b in self.gather_sites],
            "exchange_sites": [{"site": site, "table": w,
                                "n_local": n, "bytes": b}
                               for site, w, n, b in self.exchange_sites],
        }


@dataclass
class PlanReport:
    """verify_plan output: diagnostics + the communication estimate +
    the resident-memory estimate (static/memcheck.py) — one call prices
    a plan in both bytes-moved and bytes-resident."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    comm: Optional[CommEstimate] = None
    mem: Optional[Any] = None          # memcheck.MemEstimate

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    def render(self) -> str:
        lines = []
        if self.diagnostics:
            lines.append(_errors.render_diagnostics(self.diagnostics))
        else:
            lines.append("shardcheck: no findings")
        if self.comm is not None:
            c = self.comm
            lines.append(
                f"comm estimate: world={c.world} payload={c.payload or 'fp32'}"
                f" buckets={len(c.buckets)}"
                f" allreduce={c.allreduce_bytes}B gather={c.gather_bytes}B"
                f" exchange={c.exchange_bytes}B total={c.total_bytes}B")
            for names, nelem, wire in c.buckets:
                head = ", ".join(names[:3]) + (", ..." if len(names) > 3
                                               else "")
                lines.append(f"  bucket [{head}] nelem={nelem} wire={wire}B")
            for site, w, axes, b in c.gather_sites:
                lines.append(f"  gather @{site} weight={w} axes={axes} "
                             f"~{b}B")
            for site, w, n, b in c.exchange_sites:
                lines.append(f"  exchange @{site} table={w} n_local={n} "
                             f"~{b}B")
        if self.mem is not None:
            lines.append(self.mem.render())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Individual checks (each appends Diagnostics to `out`)
# ---------------------------------------------------------------------------

def _axis_names_of(spec) -> List[str]:
    """Flatten a PartitionSpec-like tuple into its axis-name strings."""
    out = []
    for a in (spec or ()):
        if a is None:
            continue
        for x in (a if isinstance(a, (tuple, list)) else (a,)):
            if isinstance(x, str):
                out.append(x)
    return out


def _check_mesh_axes(plan, mesh, out: List[Diagnostic]):
    from ..parallel.mesh import _CANONICAL_ORDER
    from .registry import suggest_names

    referenced: List[Tuple[str, str]] = []      # (axis, where)
    for a in plan.batch_axes:
        referenced.append((a, "batch_axes"))
    if plan.seq_axis is not None:
        referenced.append((plan.seq_axis, "seq_axis"))
    if plan.annotations:
        for name, spec in plan.annotations.items():
            for a in _axis_names_of(spec):
                referenced.append((a, f"annotations[{name!r}]"))
    if plan.rules is not None:
        for pat, axes in plan.rules.rules:
            for a in _axis_names_of(axes):
                referenced.append((a, f"rules[{pat.pattern!r}]"))
    valid = set(mesh.axis_names) | set(_CANONICAL_ORDER)
    seen = set()
    for axis, where in referenced:
        if axis in valid or (axis, where) in seen:
            continue
        seen.add((axis, where))
        suggestion = suggest_names(
            axis, candidates=list(mesh.axis_names) + list(_CANONICAL_ORDER))
        out.append(Diagnostic(
            "SC002", "error",
            f"{where} references mesh axis {axis!r} which is neither in "
            f"the mesh {tuple(mesh.axis_names)} nor a canonical axis — "
            "_clean_spec would silently drop it (replication)",
            var=axis, hint=suggestion or
            f"valid axes: {sorted(valid)}"))


def _check_feeds(program, plan, mesh, feed_shapes, bucket_edges,
                 out: List[Diagnostic]):
    n = plan.batch_divisor(mesh)
    shapes = dict(feed_shapes or {})
    if not shapes:
        for v in program.list_vars():
            if v.is_data and tuple(v.shape):
                shapes[v.name] = tuple(v.shape)
    for name, shape in shapes.items():
        shape = tuple(shape)
        if not shape:
            continue
        b = shape[0]
        if n > 1 and isinstance(b, (int, np.integer)) and b > 1 and b % n:
            out.append(Diagnostic(
                "SC001", "error",
                f"feed {name!r} batch dim {int(b)} does not divide the "
                f"plan's {n} batch-axis devices "
                f"(batch_axes={plan.batch_axes}) — feed_sharding raises "
                "at placement time",
                var=name,
                hint=f"pad the batch to a multiple of {n} or shrink the "
                     "mesh"))
        if (plan.seq_axis is not None and plan.seq_axis in mesh.axis_names
                and len(shape) > 1):
            s = shape[1]
            sz = mesh.shape[plan.seq_axis]
            if isinstance(s, (int, np.integer)) and s > 1 and s % sz:
                out.append(Diagnostic(
                    "SC001", "warning",
                    f"feed {name!r} seq dim {int(s)} does not divide "
                    f"seq_axis {plan.seq_axis!r} ({sz} devices) — the "
                    "plan silently skips sequence sharding for it",
                    var=name,
                    hint=f"pad the sequence to a multiple of {sz}"))
    if bucket_edges and n > 1:
        bad = [int(e) for e in bucket_edges if int(e) > 1 and int(e) % n]
        if bad:
            out.append(Diagnostic(
                "SC001", "error",
                f"serving bucket edges {bad} do not divide the plan's {n} "
                "batch-axis devices — every padded batch hits the "
                "feed_sharding error at first submit",
                hint=f"use bucket edges that are multiples of {n}"))


def _state_vars(program) -> List[Tuple[str, Tuple[int, ...], Any, bool]]:
    """(name, concrete-shape-or-(), dtype, trainable) per persistable var."""
    out = []
    for v in program.list_vars():
        if not (v.persistable or isinstance(v, Parameter)):
            continue
        if v.name.endswith(GRAD_SUFFIX):
            continue
        shape = tuple(v.shape)
        if any(not isinstance(d, (int, np.integer)) or d < 0 for d in shape):
            shape = ()
        out.append((v.name, shape, _np_dtype(v.dtype),
                    bool(getattr(v, "trainable", False))))
    return out


def _check_state_placement(program, plan, mesh, out: List[Diagnostic]):
    from ..parallel.sharding import PartitionSpec, _clean_spec, _divisible

    from .registry import suggest_names

    all_names = {v.name for v in program.list_vars()}
    for name in (plan.annotations or {}):
        if name not in all_names:
            suggestion = suggest_names(name, candidates=sorted(all_names))
            out.append(Diagnostic(
                "SC003", "warning",
                f"annotation names {name!r}, which is not a variable of "
                "the program — the placement silently never applies",
                var=name, hint=suggestion or "check the variable name"))

    batch_axes = set(plan.batch_axes)
    for name, shape, _dtype, _tr in _state_vars(program):
        ann = (plan.annotations or {}).get(name)
        rule = (plan.rules.match(name, len(shape))
                if plan.rules is not None and shape else None)
        if ann is not None and shape:
            if len(ann) > len(shape):
                out.append(Diagnostic(
                    "SC003", "error",
                    f"annotation for {name!r} has {len(ann)} entries but "
                    f"the variable is rank {len(shape)} ({shape})",
                    var=name,
                    hint="a PartitionSpec may be shorter than the rank, "
                         "never longer"))
                continue
            spec = _clean_spec(ann, mesh)
            if tuple(spec) and not _divisible(shape, spec, mesh):
                out.append(Diagnostic(
                    "SC003", "error",
                    f"annotation {tuple(ann)} for {name!r} does not divide "
                    f"its shape {shape} on mesh "
                    f"{dict(mesh.shape)} — infer_sharding silently falls "
                    "back to full replication",
                    var=name,
                    hint="resize the dim to a multiple of the axis size or "
                         "drop the annotation"))
            if rule is not None and tuple(rule) != tuple(ann):
                out.append(Diagnostic(
                    "SC003", "warning",
                    f"{name!r} matches both an annotation {tuple(ann)} and "
                    f"a rule {tuple(rule)}; the annotation wins",
                    var=name, hint="drop one of the two placements"))
        elif rule is not None and shape:
            spec = _clean_spec(rule, mesh)
            if tuple(spec) and not _divisible(shape, spec, mesh):
                out.append(Diagnostic(
                    "SC003", "warning",
                    f"rule spec {tuple(rule)} matches {name!r} but does "
                    f"not divide its shape {shape} — it silently "
                    "replicates",
                    var=name,
                    hint="tighten the rule regex or resize the dim"))
        # SC008: ZeRO vs explicit dp-axis placement
        if plan.zero_stage > 0:
            placed = ann if ann is not None else rule
            dp_used = sorted(set(_axis_names_of(placed)) & batch_axes)
            if dp_used:
                out.append(Diagnostic(
                    "SC008", "error",
                    f"zero_stage={plan.zero_stage} shards state over the "
                    f"batch axes, but {name!r} is explicitly placed on "
                    f"{dp_used} by an "
                    f"{'annotation' if ann is not None else 'rule'} — the "
                    "two placements fight over the same axis",
                    var=name,
                    hint="use a non-batch axis (e.g. 'tp') for explicit "
                         "placement, or drop zero_stage"))
            elif (plan.zero_stage >= 3 and placed is None and shape):
                n = plan.batch_divisor(mesh)
                if n > 1 and not any(
                        d % n == 0 and d >= n for d in shape):
                    out.append(Diagnostic(
                        "SC008", "warning",
                        f"zero_stage=3: no dim of {name!r} {shape} divides "
                        f"the {n}-way batch axes — zero_spec silently "
                        "keeps it fully replicated",
                        var=name,
                        hint="pad the largest dim to a multiple of "
                             f"{n} to actually shard it"))


def _check_donation(program, plan, feed_shapes, out: List[Diagnostic]):
    if not plan.donate:
        return
    fed = set(feed_shapes or ())
    for v in program.list_vars():
        persistable = v.persistable or isinstance(v, Parameter)
        if persistable and v.is_data:
            out.append(Diagnostic(
                "SC004", "error",
                f"{v.name!r} is both a data (feed) var and persistable "
                "state under a donating plan — the donated buffer would "
                "alias the caller's feed array",
                var=v.name,
                hint="split the feed var from the state var, or build the "
                     "plan with donate=False"))
        elif persistable and v.name in fed:
            out.append(Diagnostic(
                "SC004", "warning",
                f"feed {v.name!r} names persistable state under a "
                "donating plan — the executor skips the aliased donation "
                "at runtime, but feeding state is usually a bug",
                var=v.name,
                hint="initialize state through the startup program "
                     "instead of feeding it"))


def _check_comm_quantize(program, plan, mesh, out: List[Diagnostic]):
    from ..parallel.compress import (COMPRESS_KINDS, _payload_dtype,
                                     bucket_assignment)
    from .registry import suggest_names

    comm = plan.comm
    if comm is None:
        return
    kind = comm.quantize
    if kind not in ("", "none") and kind not in COMPRESS_KINDS:
        suggestion = suggest_names(
            kind, candidates=list(COMPRESS_KINDS) + ["none"])
        out.append(Diagnostic(
            "SC005", "error",
            f"comm_quantize={kind!r} is not a known kind — CommOptions "
            "silently treats it as no compression",
            hint=suggestion or f"use one of {COMPRESS_KINDS} or 'none'"))
        return
    if kind == "fp8":
        try:
            _payload_dtype("fp8")
        except (NotImplementedError, AttributeError) as e:
            out.append(Diagnostic(
                "SC005", "error",
                f"comm_quantize='fp8' is unavailable here: {e}",
                hint="use comm_quantize='int8' on this torch version"))
    if comm.block_size <= 0:
        out.append(Diagnostic(
            "SC005", "error",
            f"comm_block_size={comm.block_size} must be positive",
            hint="the block is the quantization scale granularity"))
    if comm.buffer_mb <= 0:
        out.append(Diagnostic(
            "SC005", "error",
            f"comm_buffer_mb={comm.buffer_mb} must be positive",
            hint="the buffer caps each gradient bucket"))
    if comm.payload() is None or comm.block_size <= 0 or comm.buffer_mb <= 0:
        return
    grads = _grad_leaves(program)
    for name, _nelem, dtype in grads:
        if dtype.kind != "f":
            out.append(Diagnostic(
                "SC005", "error",
                f"comm_quantize={kind!r} block-quantizes gradients, but "
                f"trainable param {name!r} is {dtype.name} — integer "
                "grads cannot take a float scale",
                var=name,
                hint="exclude the param from training or drop "
                     "comm_quantize"))
    sizes = [nelem * 4 for _n, nelem, _d in grads]
    for bucket in bucket_assignment(sizes, comm.buffer_mb):
        nelem = sum(sizes[i] for i in bucket) // 4
        if 0 < nelem < comm.block_size:
            names = [grads[i][0] for i in bucket]
            out.append(Diagnostic(
                "SC005", "warning",
                f"gradient bucket {names} has {nelem} elements — smaller "
                f"than one quantization block ({comm.block_size}); scale "
                "overhead dominates the wire savings",
                hint="raise comm_buffer_mb or lower comm_block_size"))


def _check_serving_buckets(program, feed_names, bucket_edges,
                           out: List[Diagnostic]):
    edges = [int(e) for e in (bucket_edges or ())]
    if not edges:
        return
    if sorted(edges) != edges or any(e <= 0 for e in edges) \
            or len(set(edges)) != len(edges):
        out.append(Diagnostic(
            "SC007", "error",
            f"bucket_edges {edges} must be strictly increasing positive "
            "ints",
            hint="e.g. (1, 2, 4, 8, 16, 32)"))
        return
    data_vars = {v.name: v for v in program.list_vars() if v.is_data}
    for name in (feed_names or ()):
        v = data_vars.get(name)
        if v is None:
            out.append(Diagnostic(
                "SC007", "error",
                f"tenant feed {name!r} is not a data var of the program — "
                "every submit would fail feed-name validation",
                var=name,
                hint=f"data vars: {sorted(data_vars)}"))
            continue
        shape = tuple(v.shape)
        if shape and isinstance(shape[0], (int, np.integer)) \
                and shape[0] > edges[-1]:
            out.append(Diagnostic(
                "SC007", "error",
                f"feed {name!r} declares batch dim {int(shape[0])}, larger "
                f"than the largest bucket ({edges[-1]}) — every submit "
                "would be rejected at batch time",
                var=name,
                hint="declare the batch dim -1 or extend bucket_edges"))


def _effective_spec(plan, mesh, name, shape):
    """Mirror infer_sharding's precedence (annotation > rule > ZeRO) for a
    declared shape, including the silent indivisible→replicate fallback."""
    from ..parallel.sharding import (PartitionSpec, _clean_spec, _divisible,
                                     zero_spec)

    spec = None
    if plan.annotations and plan.annotations.get(name) is not None:
        spec = _clean_spec(plan.annotations[name], mesh)
    if spec is None and plan.rules is not None:
        m = plan.rules.match(name, len(shape))
        if m is not None:
            spec = _clean_spec(m, mesh)
    if spec is not None and not _divisible(shape, spec, mesh):
        spec = None
    if spec is None or spec == PartitionSpec():
        spec = zero_spec(shape, mesh) if plan.zero_stage >= 3 \
            else PartitionSpec()
    return spec


def _check_contractions(program, plan, mesh, out: List[Diagnostic],
                        est: CommEstimate):
    """SC009: weights sharded on a contracted dim → predicted collective."""
    state = {name: (shape, dtype)
             for name, shape, dtype, _tr in _state_vars(program) if shape}
    for block in program.blocks:
        for op_idx, op in enumerate(block.ops):
            site = _CONTRACTION_OPS.get(op.type)
            if site is None:
                continue
            slot, contracted_of = site
            names = op.inputs.get(slot, ())
            if not names or names[0] not in state:
                continue
            wname = names[0]
            shape, dtype = state[wname]
            spec = _effective_spec(plan, mesh, wname, shape)
            spec_t = tuple(spec)
            contracted = contracted_of(len(shape), op.attrs)
            for dim in contracted:
                if not 0 <= dim < len(spec_t) or spec_t[dim] is None:
                    continue
                axes = tuple(a for a in (
                    spec_t[dim] if isinstance(spec_t[dim], tuple)
                    else (spec_t[dim],)) if a is not None)
                n = 1
                for a in axes:
                    n *= mesh.shape[a]
                if n <= 1:
                    continue
                nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                coll = int(round(nbytes * (n - 1) / n))
                loc = f"{op.type}.b{block.idx}.i{op_idx}"
                est.gather_sites.append((loc, wname, axes, coll))
                est.gather_bytes += coll
                out.append(Diagnostic(
                    "SC009", "warning",
                    f"{op.type} at block {block.idx} op {op_idx} contracts "
                    f"dim {dim} of {wname!r}, which the plan shards over "
                    f"{axes} — GSPMD inserts an allreduce/all-gather "
                    f"(~{coll} wire bytes) at this site",
                    block.idx, op_idx, op.type, var=wname,
                    hint="intended for row-parallel layers; otherwise "
                         "shard the non-contracted dim"))


_LOOKUP_OPS = ("lookup_table", "lookup_table_v2", "embedding")
# below this vocab size a dense gradient is cheap enough not to nag about
_SC010_DENSE_VOCAB = 65536


def _check_embedding(program, plan, mesh, out: List[Diagnostic]):
    """SC010: vocab-sharded embedding tables (parallel/embedding.py) — an
    indivisible vocab dim raises inside shard_map at trace time, a table
    whose id batch shares the vocab axis double-shards, and a conflicting
    user annotation places the table somewhere the lookup lowering's
    exchange does not expect; an *uncovered* huge table without is_sparse
    silently pays the dense vocab-sized gradient (warning)."""
    state = {name: (shape, dtype)
             for name, shape, dtype, _tr in _state_vars(program) if shape}
    covered = getattr(plan, "embedding_shard", None) is not None
    for block in program.blocks:
        for op_idx, op in enumerate(block.ops):
            if op.type not in _LOOKUP_OPS:
                continue
            names = op.inputs.get("W", ())
            if not names or names[0] not in state:
                continue
            wname = names[0]
            shape, _dtype = state[wname]
            axis = (plan.embedding_axis_for(wname, lookup=True)
                    if covered else None)
            if axis is None:
                if (not op.attrs.get("is_sparse", False)
                        and shape[0] >= _SC010_DENSE_VOCAB):
                    out.append(Diagnostic(
                        "SC010", "warning",
                        f"{op.type} at block {block.idx} op {op_idx} reads "
                        f"table {wname!r} (vocab {shape[0]}) with neither "
                        "is_sparse nor an embedding_shard plan — the "
                        "backward materializes a dense vocab-sized gradient",
                        block.idx, op_idx, op.type, var=wname,
                        hint="set is_sparse=True or "
                             "ShardingPlan(embedding_shard=...)"))
                continue
            k = int(mesh.shape[axis]) if axis in mesh.axis_names else 1
            if k > 1 and shape[0] % k:
                out.append(Diagnostic(
                    "SC010", "error",
                    f"embedding table {wname!r} vocab {shape[0]} does not "
                    f"divide mesh axis {axis!r} size {k} — the sharded "
                    "lookup raises at trace time",
                    block.idx, op_idx, op.type, var=wname,
                    hint="pad the vocab to a multiple of the axis size"))
            if axis in plan.batch_axes:
                out.append(Diagnostic(
                    "SC010", "error",
                    f"embedding_shard axis {axis!r} for table {wname!r} is "
                    "also a plan batch axis — ids and vocab would shard "
                    "over the same devices and the exchange computes "
                    "garbage",
                    block.idx, op_idx, op.type, var=wname,
                    hint="vocab-shard over a model axis (tp), batch over "
                         "dp"))
            ann = (plan.annotations or {}).get(wname)
            if ann is not None:
                dim0 = ann[0] if len(ann) else None
                dim0_axes = tuple(
                    a for a in (dim0 if isinstance(dim0, (tuple, list))
                                else (dim0,)) if a is not None)
                if dim0_axes != (axis,):
                    out.append(Diagnostic(
                        "SC010", "error",
                        f"table {wname!r} is vocab-sharded over {axis!r} by "
                        f"embedding_shard but annotated {tuple(ann)!r} — "
                        "annotations win placement, so the lookup's "
                        f"all_to_all over {axis!r} would read a "
                        "differently-laid-out table",
                        block.idx, op_idx, op.type, var=wname,
                        hint="drop the annotation or align it to "
                             f"({axis!r}, None)"))


# ---------------------------------------------------------------------------
# Communication estimate
# ---------------------------------------------------------------------------

def _grad_leaves(program) -> List[Tuple[str, int, np.dtype]]:
    """(name, nelem, dtype) of every trainable param with a grad var, in
    allreduce issue order (reverse declaration order — backward produces
    the last layer's gradients first, matching compress._named_leaves)."""
    grad_names = {n for b in program.blocks for n in b.vars
                  if n.endswith(GRAD_SUFFIX)}
    leaves = []
    for p in program.all_parameters():
        if not p.trainable or p.name + GRAD_SUFFIX not in grad_names:
            continue
        shape = tuple(p.shape)
        if any(not isinstance(d, (int, np.integer)) or d < 0 for d in shape):
            continue
        leaves.append((p.name, int(np.prod(shape, dtype=np.int64)) if shape
                       else 1, _np_dtype(p.dtype)))
    return list(reversed(leaves))


def measured_comm_bytes(axis: Optional[str] = None) -> float:
    """Cumulative sum of the ``comm.allreduce_bytes`` histogram (wire bytes
    recorded when a step is *traced*, compress._record_comm) — the shared
    snapshot/delta primitive behind ``CommEstimate.measured_bytes`` and the
    calibration ledger's per-compile comm attribution (utils/ledger.py
    snapshots it before a compile and charges the delta to that trace)."""
    hist = _monitor.histogram(
        "comm.allreduce_bytes", "wire bytes per allreduce",
        labelnames=("axis", "dtype"),
        buckets=(1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26, 1 << 30))
    total = 0.0
    for labels, stat in hist.samples():
        if axis is None or labels.get("axis") == axis:
            total += stat.total
    return total


def _estimate_exchange(program, plan, mesh, feed_shapes,
                       est: CommEstimate) -> None:
    """Price the vocab-sharded embedding all_to_all exchange per lookup
    site with the exact math ``embedding.exchange_bytes`` observes at trace
    time (``emb.exchange_bytes`` histogram): dedup capacity x row bytes x
    quantize ratio, for the batch-local id count.  Sites whose id batch is
    unknowable statically (no feed shape and a dynamic declared shape) are
    skipped — underpricing honestly beats inventing a batch."""
    if getattr(plan, "embedding_shard", None) is None:
        return
    raise NotImplementedError(
        "the vocab-sharded embedding exchange waits for ROADMAP item 9b")


def estimate_comm(program: Program, plan, mesh=None,
                  feed_shapes=None) -> CommEstimate:
    """Static per-bucket allreduce wire-byte estimate for the plan's
    data-parallel gradient sync — same bucketing and wire math as
    ``compress.sync_gradients`` (bucket_assignment + wire_bytes), so on the
    fleet/collbench path the estimate matches the traced
    ``comm.allreduce_bytes`` records — plus the per-site vocab-sharded
    embedding exchange bytes (mirroring the traced ``emb.exchange_bytes``)
    so recommender plans score their dominant collective honestly."""
    from ..parallel.compress import bucket_assignment, wire_bytes

    mesh = mesh or plan.resolve_mesh()
    world = plan.batch_divisor(mesh)
    comm = plan.comm
    payload = comm.payload() if comm is not None else None
    block_size = comm.block_size if comm is not None else 256
    if block_size <= 0:               # SC005 already flagged it; keep going
        block_size = 256
    buffer_mb = comm.buffer_mb if comm is not None else 25.0
    est = CommEstimate(world=world, payload=payload, block_size=block_size,
                       buffer_mb=max(buffer_mb, 1e-9))
    _estimate_exchange(program, plan, mesh, feed_shapes, est)
    leaves = _grad_leaves(program)
    if not leaves:
        return est
    sizes = [nelem * 4 for _n, nelem, _d in leaves]
    for bucket in bucket_assignment(sizes, est.buffer_mb):
        names = tuple(leaves[i][0] for i in bucket)
        nelem = sum(leaves[i][1] for i in bucket)
        wire = wire_bytes(nelem, payload, block_size, n=world)
        est.buckets.append((names, nelem, wire))
        est.allreduce_bytes += wire
    return est


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def verify_plan(program: Program, plan,
                feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
                bucket_edges: Optional[Sequence[int]] = None,
                feed_names: Optional[Sequence[str]] = None) -> PlanReport:
    """Run every SC check for `program` under `plan`; returns the full
    report (diagnostics + communication estimate).  ``feed_shapes`` narrows
    the feed assumption to concrete arrays (the Executor passes the real
    batch); ``bucket_edges``/``feed_names`` enable the serving checks."""
    _m_plans_checked.inc()
    mesh = plan.resolve_mesh()
    out: List[Diagnostic] = []
    _check_mesh_axes(plan, mesh, out)
    _check_feeds(program, plan, mesh, feed_shapes, bucket_edges, out)
    _check_state_placement(program, plan, mesh, out)
    _check_donation(program, plan, feed_shapes, out)
    _check_comm_quantize(program, plan, mesh, out)
    _check_serving_buckets(program, feed_names, bucket_edges, out)
    # SC006 rides the analysis engine's sub-block findings: declared shapes
    # often agree (the builder checked them) while inferred ones clash
    _diags, engine = infer_program(program, feed_names=feed_names or (
        None if feed_shapes is None else set(feed_shapes)))
    out.extend(engine.subblock_findings)
    est = estimate_comm(program, plan, mesh, feed_shapes=feed_shapes)
    _check_contractions(program, plan, mesh, out, est)
    _check_embedding(program, plan, mesh, out)
    # the memory dimension (static/memcheck.py): the same call that prices
    # the plan in bytes moved prices it in bytes resident.  Findings stay
    # out of this report (the Executor's check_memory hook owns MC
    # enforcement) — here the estimate is the deliverable, the HBM leg of
    # the auto-sharding scorer next to `comm`.  Deferred import: memcheck
    # builds on this module.
    mem = None
    try:
        from .memcheck import estimate_peak

        mem = estimate_peak(program, plan, feed_shapes)
    except Exception:      # pragma: no cover - defensive
        pass               # a sizing failure must never mask SC findings
    return PlanReport(diagnostics=out, comm=est, mem=mem)


def check_plan(program: Program, plan,
               feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
               bucket_edges: Optional[Sequence[int]] = None,
               feed_names: Optional[Sequence[str]] = None) -> PlanReport:
    """verify_plan + raise ``ProgramVerificationError`` on any
    error-severity finding."""
    report = verify_plan(program, plan, feed_shapes, bucket_edges,
                         feed_names)
    errs = report.errors
    if errs:
        raise _errors.ProgramVerificationError(
            "sharding-plan verification failed (set "
            "PDTPU_FLAGS_check_sharding=0 to bypass):\n"
            + _errors.render_diagnostics(errs), diagnostics=errs)
    return report


_memo_lock = threading.Lock()
# the memo lives on the Program object (two programs at one version never
# share an entry; ROADMAP Queue 3 has the JAX package's process-wide dict)
_MEMO_CAP = 4096


def check_with_plan(program: Program, plan,
                    feed_arrays: Optional[Dict[str, Any]] = None
                    ) -> PlanReport:
    """Executor entry point: ``check_plan`` memoized by (plan token,
    program version, feed-shape signature).  The plan token is monotonic
    per ShardingPlan instance and the version bumps on any program
    mutation, so a hit is exact; steady-state (hot-cache) steps never even
    reach here — this runs only in the trace/compile branch."""
    feed_shapes = None
    if feed_arrays is not None:
        feed_shapes = {k: tuple(int(d) for d in np.shape(v))
                       for k, v in feed_arrays.items()}
    sig = None if feed_shapes is None else tuple(sorted(feed_shapes.items()))
    key = (plan.token, program._version, sig)
    with _memo_lock:
        memo = getattr(program, "_shardcheck_memo", None)
        if memo is None:
            memo = program._shardcheck_memo = {}
        hit = memo.get(key)
    if hit is not None:
        return hit
    report = check_plan(program, plan, feed_shapes=feed_shapes)
    with _memo_lock:
        if len(memo) >= _MEMO_CAP:
            memo.clear()
        memo[key] = report
    return report
