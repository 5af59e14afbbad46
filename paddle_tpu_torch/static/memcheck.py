"""Static peak-HBM verifier: prices a Program × ShardingPlan in bytes-resident
before anything compiles (MC001–MC008) (counterpart of
paddle_tpu/static/memcheck.py).

In the port the Executor runs the Program op by op and releases each
intermediate after its last reader (static/executor.py), so the sweep below
prices the resident set the card really holds; the capacity is the card's
own (``torch.cuda.get_device_properties``), None on a host without one.
The port's plans carry no ``embedding_shard`` yet (ROADMAP item 9b), so
MC007 is reached by no plan.

The third tier of the static-analysis stack.  Tier one
(``static/analysis.py``, PV001–PV011) checks a Program in isolation; tier
two (``static/shardcheck.py``, SC001–SC010) checks the Program ×
ShardingPlan pairing and prices it in *bytes moved*; this module prices the
same pairing in *bytes resident*: size every var from the shape/dtype
inference engine, compute buffer lifetimes from the liveness analysis
(sub-block free reads pin while/cond carries live for the whole carrying
op), divide per-device bytes by the plan's placement, and sweep op order to
a peak-HBM estimate plus a per-op high-water timeline.  The estimate is
calibrated against ``aot.memory_analysis()`` (args + out + temp) with a
test-pinned 1.5x accuracy gate — the HBM leg of the cost model the
reference's adaptive planner (arxiv 2112.02752) needs next to the
communication leg (``shardcheck.estimate_comm``, pinned within 2x).

Diagnostic codes (severity ``error`` aborts ``Executor.run`` under flag
``check_memory``; ``warning`` never does):

- ``MC001`` predicted OOM: the per-device peak estimate exceeds the
  device's HBM capacity (``xprof.resolve_peaks`` table per TPU generation,
  or the ``memcheck_capacity_gb`` flag / ``capacity_bytes`` override) —
  rejected *before* any trace/compile; the legacy failure is an XLA
  allocation error minutes into the cold start.
- ``MC002`` undonated state: large trainable state under a plan that does
  not donate — the update step holds old + new parameter copies
  simultaneously, an avoidable ~2x on the dominant resident term.
- ``MC003`` dense embedding gradient: a lookup over a large table with
  neither ``is_sparse`` nor a ``ShardingPlan(embedding_shard=)`` — the
  backward materializes a dense vocab-sized gradient this check prices.
- ``MC004`` replicated optimizer state: dp world > 1, ``zero_stage`` < 2,
  and the optimizer slots replicate — a stage bump shards them, saving
  ``slots × (world-1)/world`` bytes per device.
- ``MC005`` dead persistable: state no op reads anywhere (main or
  sub-blocks) and no fetch returns — resident HBM for nothing.
- ``MC006`` serving ladder overflow: the peak re-estimated at the largest
  bucket edge, times ``max_live_programs`` concurrent tenants, exceeds
  capacity — admission control admits a workload the device cannot hold.
- ``MC007`` embedding exchange capacity: a ``capacity``-factored exchange
  buffer smaller than the uniform lower bound ``ceil(n_local / k)`` —
  guaranteed id drops for *any* batch, not just skewed ones.
- ``MC008`` KV block pool overflow: a paged-serving KV pool
  (``num_blocks × block_bytes``, ``serving/paged.py``) that would exceed
  HBM capacity on its own or stacked on pools already admitted —
  ``TenantManager.admit_kv_pool`` rejects the config before any arrays
  allocate or anything compiles (``check_kv_pool``).

Entry points: ``estimate_peak`` (the public costing API),
``verify_memory``/``check_memory`` (the PV/SC-shaped report/raise pair),
and ``check_memory_cached`` — the Executor hook, memoized by plan token ×
program version × feed-shape signature exactly like
``shardcheck.check_with_plan``, so steady-state steps never re-check and
compile-cache keys are untouched for passing programs.

CLI: ``python -m tools.memcheck`` (text/json timeline, ``--capacity-gb``,
``--selfcheck`` riding tier-1).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import errors as _errors
from ..core import flags as _flags
from ..core.dtype import numpy_dtype as _np_dtype
from ..utils import monitor as _monitor
from .analysis import Diagnostic, Sym, _known, infer_program
from .backward import GRAD_SUFFIX
from .framework import Program
from .passes import liveness, subblock_free_reads
from .shardcheck import _state_vars

__all__ = [
    "MemEstimate", "MemReport", "estimate_peak", "verify_memory",
    "check_memory", "check_memory_cached",
]

_m_mem_checks = _monitor.counter(
    "analysis.mem_checks",
    "Full static memory-verifier walks (cache misses of "
    "check_memory_cached plus direct estimate_peak/verify_memory calls).")
_m_mem_violations = _monitor.counter(
    "analysis.mem_violations",
    "Memory-verifier findings by diagnostic code (MC001-MC008).",
    labelnames=("code",))

# advisory thresholds: below these, MC002/MC003/MC004 stay silent — tiny
# models double their state in noise, and the hints would be pure nags
_MC002_MIN_STATE_BYTES = 32 << 20          # 32 MiB of trainable state
_MC003_MIN_VOCAB = 65536                   # matches shardcheck _SC010 floor
_MC004_MIN_SLOT_BYTES = 16 << 20           # 16 MiB of optimizer slots

# optimizer update ops: any *input* slot besides these is persistent
# optimizer state (velocity/moment/beta_pow/... — static/optimizer.py
# _slot() wires them all through this contract)
_OPT_PASSTHROUGH_SLOTS = frozenset(("Param", "Grad", "LearningRate"))
_OPT_OPS = frozenset((
    "sgd", "momentum", "lars_momentum", "adam", "adamw", "lamb", "adagrad",
    "adadelta", "rmsprop", "ftrl",
))

_LOOKUP_OPS = ("lookup_table", "lookup_table_v2", "embedding")


# ---------------------------------------------------------------------------
# Result containers
# ---------------------------------------------------------------------------

@dataclass
class MemEstimate:
    """Static per-device resident-bytes prediction for one Program × plan.

    The decomposition mirrors ``xprof.memory_stats`` /
    ``aot.memory_analysis()`` so the two are directly comparable:
    ``args`` (feeds + resident state in), ``out`` (fetches + updated
    state out, zero under donation aliasing), ``temp`` (the transient
    high-water from the lifetime sweep); ``peak = args + out + temp``."""

    devices: int = 1
    device_kind: str = "unknown"
    capacity_bytes: Optional[int] = None
    feed_bytes: int = 0
    state_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    peak_op: Optional[Tuple[int, str]] = None     # (op_index, op_type)
    # (op_index, op_type, resident bytes incl. state) per op, in op order
    timeline: List[Tuple[int, str, int]] = field(default_factory=list)

    @property
    def args_bytes(self) -> int:
        return self.feed_bytes + self.state_bytes

    @property
    def peak_bytes(self) -> int:
        return self.args_bytes + self.out_bytes + self.temp_bytes

    def to_dict(self) -> dict:
        return {
            "devices": self.devices,
            "device_kind": self.device_kind,
            "capacity_bytes": self.capacity_bytes,
            "args_bytes": self.args_bytes,
            "feed_bytes": self.feed_bytes,
            "state_bytes": self.state_bytes,
            "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
            "peak_bytes": self.peak_bytes,
            "peak_op": list(self.peak_op) if self.peak_op else None,
            "timeline": [{"op_index": i, "op_type": t, "bytes": b}
                         for i, t, b in self.timeline],
        }

    def render(self, timeline: bool = False) -> str:
        def _gb(n):
            return f"{n / (1 << 30):.3f}GiB" if n >= (1 << 20) else f"{n}B"

        cap = (_gb(self.capacity_bytes) if self.capacity_bytes
               else "unknown")
        lines = [
            f"mem estimate ({self.device_kind} x{self.devices}): "
            f"peak={_gb(self.peak_bytes)} of {cap} "
            f"[args={_gb(self.args_bytes)} out={_gb(self.out_bytes)} "
            f"temp={_gb(self.temp_bytes)}]"]
        if self.peak_op is not None:
            lines.append(f"  high water at op {self.peak_op[0]} "
                         f"({self.peak_op[1]})")
        if timeline:
            for i, t, b in self.timeline:
                bar = "#" * max(1, int(40 * b / max(1, self.peak_bytes)))
                lines.append(f"  [{i:4d}] {t:<24s} {_gb(b):>12s} {bar}")
        return "\n".join(lines)


@dataclass
class MemReport:
    """verify_memory output: diagnostics + the peak estimate."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    mem: Optional[MemEstimate] = None

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
            lines.append("memcheck: no findings")
        if self.mem is not None:
            lines.append(self.mem.render())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Sizing: shapes from the inference engine, symbols resolved by the feeds
# ---------------------------------------------------------------------------

class _Sizer:
    """Resolves engine SymShapes to concrete per-device byte counts.

    Unknown symbols resolve through the feed shapes (the engine memoizes
    one Sym per (name, dim), so a feed's batch symbol IS the downstream
    activations' batch symbol); a symbol no feed pins falls back to the
    largest fed batch dim, then 1 — under-estimation is the only
    alternative, and the calibration gate keeps this honest."""

    def __init__(self, program, engine, feed_shapes, plan, mesh):
        self.program = program
        self.engine = engine
        self.plan = plan
        self.mesh = mesh
        self.block = program.global_block()
        self.sym_values: Dict[Sym, int] = {}
        self.default_dim = 1
        batch_dims = []
        for name, shape in (feed_shapes or {}).items():
            sym_shape = engine.shape_of(self.block, name)
            if sym_shape is None:
                continue
            for sym_d, d in zip(sym_shape, tuple(shape)):
                if isinstance(sym_d, Sym) and isinstance(d, (int, np.integer)):
                    self.sym_values[sym_d] = int(d)
            if shape:
                d0 = shape[0]
                if isinstance(d0, (int, np.integer)) and d0 > 0:
                    batch_dims.append(int(d0))
        if batch_dims:
            self.default_dim = max(batch_dims)
        self.batch_div = plan.batch_divisor(mesh) if plan is not None else 1

    def resolve(self, name: str, block=None) -> Tuple[int, ...]:
        shape = self.engine.shape_of(block or self.block, name)
        if shape is None:
            return ()
        out = []
        for d in shape:
            if _known(d):
                out.append(int(d))
            else:
                out.append(self.sym_values.get(d, self.default_dim))
        return tuple(out)

    def nbytes(self, name: str, shape: Optional[Tuple[int, ...]] = None,
               block=None) -> int:
        shape = self.resolve(name, block) if shape is None else shape
        dtype = self.engine.dtype_of(block or self.block, name)
        itemsize = _np_dtype(dtype).itemsize if dtype is not None else 4
        n = 1
        for d in shape:
            n *= max(0, int(d))
        return n * itemsize

    def per_device_transient(self, name: str, block=None) -> int:
        """Per-device bytes of an activation/grad/temp: batch-sharded
        feeds shard everything downstream of them, so a leading dim the
        batch divisor divides is split; everything else replicates."""
        shape = self.resolve(name, block)
        total = self.nbytes(name, shape, block)
        n = self.batch_div
        if n > 1 and shape and shape[0] >= n and shape[0] % n == 0:
            return total // n
        return total

    def per_device_state(self, name: str, shape, dtype) -> int:
        """Per-device bytes of a persistable: the plan's placement divisor
        (annotation/rule/embedding/ZeRO-3 precedence); ZeRO stages 1-2
        additionally shard replicated *optimizer slots* over dp (handled
        by the caller, which knows slot identity)."""
        total = int(np.prod(shape, dtype=np.int64)) if shape else 1
        total *= _np_dtype(dtype).itemsize
        if self.plan is None:
            return total
        div = self.plan.placement_divisor(name, tuple(shape), self.mesh)
        return total // max(1, div)


def _zero_divisor(shape: Tuple[int, ...], mesh) -> int:
    """How many ways ``zero_spec`` splits this shape over the dp axis —
    the runtime's ZeRO slot placement, mirrored for the estimate."""
    from ..parallel.sharding import zero_spec

    div = 1
    for entry in zero_spec(shape, mesh):
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in axes:
            if ax is not None:
                div *= int(mesh.shape[ax])
    return div


def _feed_shape_dict(feeds) -> Dict[str, Tuple[int, ...]]:
    """Normalize a {name: array-or-shape} dict to {name: int tuple}."""
    out = {}
    for k, v in (feeds or {}).items():
        if isinstance(v, (tuple, list)) and all(
                isinstance(d, (int, np.integer)) for d in v):
            out[k] = tuple(int(d) for d in v)
        else:
            out[k] = tuple(int(d) for d in np.shape(v))
    return out


def _optimizer_slots(program) -> Dict[str, str]:
    """{slot var name: op type} of every persistent optimizer-state input
    (momentum/moment1/beta_pow/... — any non-Param/Grad/LR input slot of
    an optimizer update op)."""
    slots: Dict[str, str] = {}
    for block in program.blocks:
        for op in block.ops:
            if op.type not in _OPT_OPS:
                continue
            for slot, names in op.inputs.items():
                if slot in _OPT_PASSTHROUGH_SLOTS:
                    continue
                for n in names:
                    slots[n] = op.type
    return slots


def _all_reads(program) -> set:
    """Every name any op in any block reads (including sub-block free
    reads) — the MC005 'is this state ever carried' oracle."""
    reads = set()
    for block in program.blocks:
        for op in block.ops:
            reads.update(op.input_names())
            if op.sub_block_indices():
                reads.update(subblock_free_reads(op, block))
    return reads


# ---------------------------------------------------------------------------
# The sweep: lifetimes -> per-op high-water timeline -> peak
# ---------------------------------------------------------------------------

def _hbm_capacity(capacity_bytes: Optional[int] = None
                  ) -> Tuple[Optional[int], str]:
    """(capacity bytes or None, device kind).  Precedence: explicit arg >
    memcheck_capacity_gb flag > the card's own memory
    (``torch.cuda.get_device_properties``; None on a host without a card,
    kind "cpu", so MC001 stays quiet there)."""
    kind, total = "cpu", None
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        kind, total = props.name, int(props.total_memory)
    if capacity_bytes is not None:
        return int(capacity_bytes), kind
    flag_gb = float(_flags.get_flag("memcheck_capacity_gb"))
    if flag_gb > 0:
        return int(flag_gb * (1 << 30)), kind
    return total, kind


def estimate_peak(program: Program, plan=None, feeds=None,
                  fetch_list: Optional[Sequence] = None,
                  capacity_bytes: Optional[int] = None) -> MemEstimate:
    """Static per-device peak-HBM estimate for ``program`` under ``plan``.

    ``feeds`` maps feed names to arrays *or* concrete shapes; ``fetch_list``
    names (or Variables for) the fetched outputs.  Sweeps block-0 op order
    with sub-block-aware buffer lifetimes and returns the peak plus the
    per-op timeline — the HBM leg of the auto-sharding cost model and the
    number ``aot.memory_analysis()`` later confirms, minutes of compile
    earlier."""
    _m_mem_checks.inc()
    feed_shapes = _feed_shape_dict(feeds)
    fetch_names = tuple(
        f if isinstance(f, str) else f.name for f in (fetch_list or ()))
    mesh = plan.resolve_mesh() if plan is not None else None
    _diags, engine = infer_program(
        program, feed_names=set(feed_shapes) or None,
        fetch_names=fetch_names or None)
    sizer = _Sizer(program, engine, feed_shapes, plan, mesh)
    block = program.global_block()

    capacity, kind = _hbm_capacity(capacity_bytes)
    est = MemEstimate(
        devices=(mesh.size if mesh is not None else 1),
        device_kind=kind, capacity_bytes=capacity)

    # -- resident state (args leg) and its update copies (out leg) ----------
    state = _state_vars(program)
    state_names = {n for n, _s, _d, _t in state}
    donate = bool(plan is not None and plan.donate)
    zero = int(getattr(plan, "zero_stage", 0) or 0) if plan is not None else 0
    slots = _optimizer_slots(program)
    dp_world = sizer.batch_div
    per_dev_state: Dict[str, int] = {}
    for name, shape, dtype, _trainable in state:
        b = sizer.per_device_state(name, shape, dtype)
        if (zero in (1, 2) and dp_world > 1 and name in slots
                and plan is not None and mesh is not None
                and plan.placement_divisor(name, tuple(shape), mesh) <= 1):
            # ZeRO-1/2 shard replicated optimizer state over the batch
            # axes — the same zero_spec placement state_shardings applies
            # (a slot no dim of which divides stays replicated there too)
            b //= max(1, _zero_divisor(tuple(shape), mesh))
        per_dev_state[name] = b
    est.state_bytes = sum(per_dev_state.values())

    # updated persistable outputs: without donation the step returns fresh
    # copies next to the old buffers (out leg); donation aliases them away
    # at the first redefinition, so the out leg holds only the fetches
    updated = set()
    for op in block.ops:
        for n in op.output_names():
            if n in state_names:
                updated.add(n)
    if not donate:
        est.out_bytes += sum(per_dev_state[n] for n in updated)

    # -- feeds (args leg) and fetches (out leg) ------------------------------
    for name in feed_shapes:
        est.feed_bytes += sizer.per_device_transient(name)
    for name in fetch_names:
        est.out_bytes += sizer.per_device_transient(name)

    # -- transient high-water sweep ------------------------------------------
    feed_names = set(feed_shapes)

    def _transient(n: str) -> bool:
        return n not in state_names and n not in feed_names

    _live_ops, live_after = liveness(block, fetch_names or state_names)
    byte_memo: Dict[str, int] = {}

    def _b(n: str) -> int:
        v = byte_memo.get(n)
        if v is None:
            v = byte_memo[n] = sizer.per_device_transient(n)
        return v

    def _skip(n: str, boundary) -> bool:
        return n in state_names or n in feed_names or n in boundary

    def _inner_transient(op, in_block) -> int:
        """Peak transient *inside* an op's carried sub-blocks — the grad /
        loop-body intermediates XLA materializes while the region runs.
        The op's declared outputs are the region's live-out boundary (the
        outer sweep already counts them); everything else live inside is
        extra residency the region holds at its own high water."""
        boundary = set(op.output_names())
        inner_peak = 0
        for _attr, bi in op.sub_block_indices():
            sub = in_block.program.blocks[bi]
            _lo, sub_live_after = liveness(sub, boundary)
            for sidx, sop in enumerate(sub.ops):
                during = set(sub_live_after[sidx])
                during.update(sop.input_names())
                during.update(sop.output_names())
                resident = sum(
                    sizer.per_device_transient(n, sub) for n in during
                    if not _skip(n, boundary))
                if sop.sub_block_indices():
                    resident += _inner_transient(sop, sub)
                inner_peak = max(inner_peak, resident)
        return inner_peak

    peak = 0
    # running stats over the ops already swept, for backward_region below:
    # reverse-mode AD re-traces the whole block prefix, so at its own high
    # water the region holds the saved forward activations (~ the prefix
    # sweep's transient peak) plus the cotangent of the widest activation
    prefix_peak = 0
    prefix_max_out = 0
    for idx, op in enumerate(block.ops):
        # live during the op: everything live after it, plus its own
        # operands (consumed-at and produced-by this op overlap here)
        during = set(live_after[idx])
        during.update(op.input_names())
        during.update(op.output_names())
        if op.sub_block_indices():
            during.update(subblock_free_reads(op, block))
        resident = sum(_b(n) for n in during if _transient(n))
        if op.sub_block_indices():
            resident += _inner_transient(op, block)
        if op.type == "backward_region":
            resident += prefix_peak + prefix_max_out
        else:
            prefix_peak = max(prefix_peak, resident)
            prefix_max_out = max(
                prefix_max_out,
                max((_b(n) for n in op.output_names() if _transient(n)),
                    default=0))
        total = est.state_bytes + est.feed_bytes + resident
        est.timeline.append((idx, op.type, total))
        if resident > peak:
            peak = resident
            est.peak_op = (idx, op.type)
    est.temp_bytes = peak
    return est


# ---------------------------------------------------------------------------
# MC001-MC007 checks
# ---------------------------------------------------------------------------

def _check_capacity(est: MemEstimate, out: List[Diagnostic]):
    if est.capacity_bytes is None:
        return
    if est.peak_bytes > est.capacity_bytes:
        gb = est.peak_bytes / (1 << 30)
        cap = est.capacity_bytes / (1 << 30)
        out.append(Diagnostic(
            "MC001", "error",
            f"predicted per-device peak {gb:.2f}GiB exceeds the "
            f"{est.device_kind} HBM capacity {cap:.2f}GiB "
            f"(args={est.args_bytes}B out={est.out_bytes}B "
            f"temp={est.temp_bytes}B) — the compile would OOM at "
            "allocation time, minutes from now",
            op_index=est.peak_op[0] if est.peak_op else None,
            op_type=est.peak_op[1] if est.peak_op else None,
            hint="shard state (ShardingPlan rules/zero_stage), shrink the "
                 "batch, or donate=True to drop the update copy"))


def _check_donation(program, plan, est, per_dev_trainable: int,
                    out: List[Diagnostic]):
    if plan is not None and plan.donate:
        return
    if per_dev_trainable < _MC002_MIN_STATE_BYTES:
        return
    out.append(Diagnostic(
        "MC002", "warning",
        f"{per_dev_trainable}B of trainable state is updated without "
        "donation — the step holds old and new parameter copies "
        f"simultaneously ({per_dev_trainable}B of avoidable out-leg "
        "residency)",
        hint="ShardingPlan(donate=True) aliases updates in place "
             "(the executor skips feed-aliased buffers automatically)"))


def _check_dense_embedding(program, plan, sizer, out: List[Diagnostic]):
    grad_names = {n for b in program.blocks for n in b.vars
                  if n.endswith(GRAD_SUFFIX)}
    covered = plan is not None and getattr(
        plan, "embedding_shard", None) is not None
    for block in program.blocks:
        for op_idx, op in enumerate(block.ops):
            if op.type not in _LOOKUP_OPS:
                continue
            names = op.inputs.get("W", ())
            if not names:
                continue
            wname = names[0]
            try:
                v = block.var(wname)
            except KeyError:
                continue
            shape = tuple(v.shape)
            if (not shape or not _known(shape[0])
                    or shape[0] < _MC003_MIN_VOCAB):
                continue
            if op.attrs.get("is_sparse", False):
                continue
            if covered and plan.embedding_axis_for(
                    wname, lookup=True) is not None:
                continue
            if wname + GRAD_SUFFIX not in grad_names:
                continue
            gbytes = (int(np.prod(shape, dtype=np.int64))
                      * _np_dtype(v.dtype).itemsize)
            out.append(Diagnostic(
                "MC003", "warning",
                f"{op.type} at block {block.idx} op {op_idx} backprops "
                f"through table {wname!r} (vocab {shape[0]}) with neither "
                "is_sparse nor an embedding_shard plan — the backward "
                f"materializes a dense {gbytes}B vocab-sized gradient "
                "every step",
                block.idx, op_idx, op.type, var=wname,
                hint="ShardingPlan(embedding_shard=...) shards vocab and "
                     "gradient; is_sparse=True keeps the gradient "
                     "row-sparse"))


def _check_zero_opportunity(program, plan, sizer, per_dev_state,
                            out: List[Diagnostic]):
    if plan is None:
        return
    world = sizer.batch_div
    if world <= 1 or plan.zero_stage >= 2:
        return
    mesh = sizer.mesh
    slots = _optimizer_slots(program)
    replicated = 0
    for name in slots:
        b = per_dev_state.get(name)
        if b is None:
            continue
        try:
            shape = tuple(program.global_block().var(name).shape)
        except KeyError:
            shape = ()
        if plan.placement_divisor(name, shape, mesh) <= 1:
            replicated += b
    if replicated < _MC004_MIN_SLOT_BYTES:
        return
    saved = replicated * (world - 1) // world
    out.append(Diagnostic(
        "MC004", "warning",
        f"{replicated}B of optimizer state replicates across the "
        f"{world}-way dp world under zero_stage={plan.zero_stage} — "
        f"zero_stage=2 shards it, saving ~{saved}B per device",
        hint="ShardingPlan(zero_stage=2) partitions optimizer slots "
             "over dp with no change to the training math"))


def _check_dead_state(program, fetch_names, per_dev_state,
                      out: List[Diagnostic]):
    reads = _all_reads(program)
    fetched = set(fetch_names or ())
    for name, b in per_dev_state.items():
        if name in reads or name in fetched or b == 0:
            continue
        out.append(Diagnostic(
            "MC005", "warning",
            f"persistable {name!r} ({b}B per device) is never read by any "
            "op (main or sub-blocks) and never fetched — resident HBM "
            "for nothing",
            var=name,
            hint="drop the variable or stop marking it persistable"))


def _check_serving_ladder(program, plan, feed_shapes, fetch_names,
                          bucket_edges, max_live_programs, capacity_bytes,
                          out: List[Diagnostic]):
    if not bucket_edges or not feed_shapes:
        return
    edge = max(int(e) for e in bucket_edges)
    concurrency = max(1, int(max_live_programs or 1))
    bucket_feeds = {
        name: ((edge,) + tuple(shape[1:]) if shape else shape)
        for name, shape in feed_shapes.items()}
    worst = estimate_peak(program, plan, bucket_feeds,
                          fetch_list=list(fetch_names or ()),
                          capacity_bytes=capacity_bytes)
    if worst.capacity_bytes is None:
        return
    # tenants share nothing: each live program holds its own args/out/temp
    total = worst.peak_bytes * concurrency
    if total > worst.capacity_bytes:
        out.append(Diagnostic(
            "MC006", "warning",
            f"serving ladder bucket {edge} costs {worst.peak_bytes}B per "
            f"program; at max_live_programs={concurrency} that is "
            f"{total}B — over the {worst.capacity_bytes}B HBM capacity, "
            "so admission control admits a working set the device "
            "cannot hold",
            hint=f"cap the ladder below {edge}, lower max_live_programs, "
                 "or shard the tenants over more devices"))


def _check_embedding_capacity(program, plan, sizer, feed_shapes,
                              out: List[Diagnostic]):
    if plan is None or getattr(plan, "embedding_shard", None) is None:
        return
    factor = getattr(plan, "embedding_capacity", None)
    if factor is None:
        return
    raise NotImplementedError(
        "MC007 prices the vocab-sharded embedding exchange, which waits "
        "for ROADMAP item 9b")


def check_kv_pool(num_blocks: int, block_size: int, hidden: int,
                  kv_dtype: str = "float32",
                  existing_bytes: int = 0,
                  capacity_bytes: Optional[int] = None) -> List[Diagnostic]:
    """MC008: price a paged-serving KV block pool before it allocates.

    The pool is resident state outside any Program (``serving/paged.py``
    holds it across requests), so the ladder walk in MC006 never sees it —
    this check prices ``num_blocks × block_bytes`` (plus the null block
    and per-block scales, the same formula ``PagedKVCache`` allocates by)
    against HBM capacity, stacked on ``existing_bytes`` of pools already
    admitted.  Error when the working set cannot fit (the caller must
    reject the config); warning above 80% of capacity (nothing is left
    for executables and transients).  Capacity resolves like MC001:
    explicit arg > ``memcheck_capacity_gb`` flag > the per-device-kind
    peaks table (None on CPU — the check stays quiet)."""
    from ..serving.paged import kv_pool_bytes

    _m_mem_checks.inc()
    pool = kv_pool_bytes(num_blocks, block_size, hidden, kv_dtype)
    capacity, kind = _hbm_capacity(capacity_bytes)
    out: List[Diagnostic] = []
    if capacity is None:
        return out
    total = pool + int(existing_bytes)
    if total > capacity:
        out.append(Diagnostic(
            "MC008", "error",
            f"paged KV pool of {num_blocks} x {block_size}-token blocks "
            f"(hidden={hidden}, {kv_dtype}) costs {pool}B; with "
            f"{existing_bytes}B of pools already admitted that is "
            f"{total}B — over the {capacity}B HBM capacity ({kind}), so "
            "the pool would OOM at allocation or starve every executable",
            hint="shrink num_blocks/block_size, switch kv_dtype to int8 "
                 "(4x fewer bytes per block), or raise "
                 "memcheck_capacity_gb if the device table is wrong"))
    elif total > 0.8 * capacity:
        out.append(Diagnostic(
            "MC008", "warning",
            f"paged KV pool ({pool}B; {total}B with already-admitted "
            f"pools) uses over 80% of the {capacity}B HBM capacity "
            f"({kind}) — executables and transients get the remainder",
            hint="leave headroom for compiled programs: shrink the pool "
                 "or quantize blocks to int8"))
    for d in out:
        _m_mem_violations.inc(code=d.code)
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def verify_memory(program: Program, plan=None, feeds=None,
                  fetch_list: Optional[Sequence] = None,
                  bucket_edges: Optional[Sequence[int]] = None,
                  max_live_programs: Optional[int] = None,
                  capacity_bytes: Optional[int] = None) -> MemReport:
    """Run the estimate and every MC check; returns the full report."""
    feed_shapes = _feed_shape_dict(feeds)
    fetch_names = tuple(
        f if isinstance(f, str) else f.name for f in (fetch_list or ()))
    est = estimate_peak(program, plan, feed_shapes, fetch_names,
                        capacity_bytes=capacity_bytes)
    mesh = plan.resolve_mesh() if plan is not None else None
    _diags, engine = infer_program(
        program, feed_names=set(feed_shapes) or None,
        fetch_names=fetch_names or None)
    sizer = _Sizer(program, engine, feed_shapes, plan, mesh)

    per_dev_state: Dict[str, int] = {}
    per_dev_trainable = 0
    updated = set()
    block = program.global_block()
    for op in block.ops:
        updated.update(op.output_names())
    for name, shape, dtype, trainable in _state_vars(program):
        b = sizer.per_device_state(name, shape, dtype)
        per_dev_state[name] = b
        if trainable and name in updated:
            per_dev_trainable += b

    out: List[Diagnostic] = []
    _check_capacity(est, out)
    _check_donation(program, plan, est, per_dev_trainable, out)
    _check_dense_embedding(program, plan, sizer, out)
    _check_zero_opportunity(program, plan, sizer, per_dev_state, out)
    _check_dead_state(program, fetch_names, per_dev_state, out)
    _check_serving_ladder(program, plan, feed_shapes, fetch_names,
                          bucket_edges, max_live_programs, capacity_bytes,
                          out)
    _check_embedding_capacity(program, plan, sizer, feed_shapes, out)
    for d in out:
        _m_mem_violations.inc(code=d.code)
    return MemReport(diagnostics=out, mem=est)


def check_memory(program: Program, plan=None, feeds=None,
                 fetch_list: Optional[Sequence] = None,
                 bucket_edges: Optional[Sequence[int]] = None,
                 max_live_programs: Optional[int] = None,
                 capacity_bytes: Optional[int] = None) -> MemReport:
    """verify_memory + raise ``ProgramVerificationError`` on any
    error-severity finding (MC001 — predicted OOM)."""
    report = verify_memory(program, plan, feeds, fetch_list, bucket_edges,
                           max_live_programs, capacity_bytes)
    errs = report.errors
    if errs:
        raise _errors.ProgramVerificationError(
            "memory verification failed (set "
            "PDTPU_FLAGS_check_memory=0 to bypass):\n"
            + _errors.render_diagnostics(errs), diagnostics=errs)
    return report


_memo_lock = threading.Lock()
_MEMO_CAP = 4096


def _memo_of(program) -> Dict[tuple, Any]:
    """The memo on the Program object itself: it dies with the program, and
    two programs at the same version never share an entry (the JAX
    package keys one process-wide dict without the program: ROADMAP
    Queue 3)."""
    memo = getattr(program, "_memcheck_memo", None)
    if memo is None:
        memo = program._memcheck_memo = {}
    return memo


def check_memory_cached(program: Program, plan=None,
                        feed_arrays: Optional[Dict[str, Any]] = None,
                        fetch_names: Optional[Sequence[str]] = None
                        ) -> MemReport:
    """Executor entry point: ``check_memory`` memoized by (plan token,
    program version, feed-shape signature, fetches) — the
    ``check_with_plan`` contract: zero steady-state cost, runs only in the
    trace/compile branch, no compile-cache key change for passing
    programs.  Failures raise (and the build aborts), so only passing
    reports are memoized."""
    feed_shapes = _feed_shape_dict(feed_arrays)
    sig = tuple(sorted(feed_shapes.items()))
    # the capacity joins the key: a memoized pass under one
    # memcheck_capacity_gb must not satisfy a stricter budget later
    capacity, _kind = _hbm_capacity(None)
    key = (plan.token if plan is not None else None, program._version, sig,
           tuple(fetch_names or ()), capacity)
    with _memo_lock:
        memo = _memo_of(program)
        hit = memo.get(key)
    if hit is not None:
        return hit
    report = check_memory(program, plan, feed_shapes,
                          fetch_list=list(fetch_names or ()))
    with _memo_lock:
        if len(memo) >= _MEMO_CAP:
            memo.clear()
        memo[key] = report
    return report


_EST_MEMO_CAP = 4096


def estimate_peak_cached(program: Program, plan=None,
                         feed_arrays: Optional[Dict[str, Any]] = None,
                         fetch_names: Optional[Sequence[str]] = None
                         ) -> Optional[MemEstimate]:
    """Never-raising, memoized ``estimate_peak`` for the calibration ledger
    (utils/ledger.py) and the autoplan candidate search
    (parallel/autoplan.py): the ledger prices *every* compile event,
    including runs where the check_memory flag (and its MC001 abort) is
    off, and a broken estimate there must degrade to an unpriced record,
    never a failed compile.  Same memo key shape as ``check_memory_cached``
    (minus the capacity — no gate is enforced here), sharing its lock but
    with bounded-ring eviction rather than clear-on-cap: autoplan prices
    hundreds of short-lived candidate plans per search, and a full clear
    would also evict the handful of hot ledger keys riding alongside them.
    Recently-inserted keys survive; the oldest insertion is evicted (dicts
    iterate in insertion order, so the ring is free)."""
    try:
        feed_shapes = _feed_shape_dict(feed_arrays)
        sig = tuple(sorted(feed_shapes.items()))
        key = ("est", plan.token if plan is not None else None,
               program._version, sig, tuple(fetch_names or ()))
        with _memo_lock:
            memo = _memo_of(program)
            if key in memo:
                # refresh recency so repeat lookups aren't next in line
                est = memo.pop(key)
                memo[key] = est
                return est
        est = estimate_peak(program, plan, feeds=feed_shapes,
                            fetch_list=list(fetch_names or ()))
        with _memo_lock:
            while len(memo) >= _EST_MEMO_CAP:
                memo.pop(next(iter(memo)))
            memo[key] = est
        return est
    except Exception:
        return None
