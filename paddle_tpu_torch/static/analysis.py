"""Program verifier: static analysis over Program/Block/Operator IR
(counterpart of paddle_tpu/static/analysis.py; its diagnostics, messages
and shape rules are the JAX package's, dtypes compared as the numpy
dtypes ``core.dtype.numpy_dtype`` gives for the port's torch dtypes).

Reference parity: the reference runs an entire pass ecosystem over
ProgramDesc before execution — `framework/ir/` graph passes,
`inference/analysis/` (analyzer.cc → ir_pass_manager.cc), and every
`PADDLE_ENFORCE*` site in `platform/enforce.h` carrying a typed error code.
The port's Executor runs a Program op by op, so a malformed program
used to surface as a ``KeyError`` or a torch error deep inside a lowering
rule.  This module is the missing compilation stage: it walks
every Block (descending through ``SUB_BLOCK_ATTRS``) *before the first
op runs* and reports structured diagnostics.

Checks (diagnostic codes):

- ``PV001`` dataflow: an op input is not produced by an earlier op, a feed,
  a persistable, or a parameter (the trace would KeyError in the env dict).
- ``PV002`` dataflow (warning): a non-persistable temporary is written but
  never read or fetched — it silently inflates the trace.
- ``PV003`` registry: op type has no registered lowering and no DESCOPED
  rationale; a difflib nearest-name suggestion is attached.
- ``PV004`` registry: op type is DESCOPED (rationale attached) — it can
  never lower here.
- ``PV005`` structure: a sub-block index is out of range / not an int, or a
  known control-flow op is missing its block attr.
- ``PV006`` structure: an op carries a block-reference attr that is NOT in
  ``SUB_BLOCK_ATTRS`` — dataflow walkers (backward._effective_io, the
  Executor's _first_access scan) would go blind to reads inside its body
  (the hazard documented at framework.SUB_BLOCK_ATTRS).
- ``PV007`` structure: a ``@GRAD`` variable has no primal counterpart.
- ``PV008`` structure: a persistable read by the main program is never
  initialized by the startup program (only checked when a startup program
  is supplied).
- ``PV009`` shape/dtype: a per-op-type inference table propagates shapes
  through the block and flags statically-certain rank/dim/dtype
  mismatches (-1 / unknown dims are wildcards — never flagged).
- ``PV010`` shape/dtype (warning): the symbolic engine's inferred output
  shape contradicts the variable's *declared* shape — the declaration is
  stale or wrong (the trace would still succeed; downstream PV009 checks
  run on the inferred shape, not the stale declaration).
- ``PV011`` rewrite safety (emitted by static/passes.py, not by this
  walker): a graph-rewrite pass broke the fetch-reachable interface — a
  fetch vanished or its inferred shape/dtype changed between the
  ``infer_program`` snapshots taken before and after the rewrite.  The
  pass manager raises ``ProgramVerificationError`` carrying these.

The PV009 table is fed by a forward **symbolic inference engine**
(``_ShapeEnv``): every ``-1``/undeclared dim becomes a stable symbol
(``Sym``), op-type rules in ``_INFER_RULES`` propagate shapes and dtypes
through blocks and sub-blocks (with env snapshot/restore around each
descent, mirroring executor._lower_cond/_lower_while), and ``@GRAD``
outputs of ``backward_region`` inherit their primal's shape/dtype.  That
means a wildcard batch dim flows through a conv→pool→reshape→matmul chain
and a *concrete* mismatch five ops downstream is still caught.  Sub-block
output clashes (cond branches with different inferred shapes, while
carries not shape-invariant against the body) are recorded on the engine
(``subblock_findings``) for the sharding-plan verifier
(``static/shardcheck.py``, diagnostic SC006) rather than emitted here —
``verify_program``'s own diagnostic surface is unchanged.
``shape_rule_coverage()`` reports which registered ops the engine covers.

Severity ``error`` aborts ``Executor.run`` (flag ``check_program``, default
on; ``PDTPU_FLAGS_check_program=0`` or ``set_flags({"check_program":
False})`` to skip); ``warning`` never does.  Diagnostics render through
``core.errors.render_diagnostics`` and raise
``core.errors.ProgramVerificationError``.

``check_program_cached`` is the Executor entry point: it memoizes the
(warning-only) result by program version × feed/fetch signature on the
Program object itself, so serving buckets and repeated cold runs re-walk
nothing, and keeps a weak list of every program that passed
(``session_passed_programs``).  Counters:
``analysis.programs_checked`` (actual walks) and
``analysis.violations{code=...}``.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..core import errors as _errors
from ..core.dtype import numpy_dtype as _np_dtype
from ..utils import monitor as _monitor
from .backward import GRAD_SUFFIX
from .framework import SUB_BLOCK_ATTRS, Parameter, Program

__all__ = ["Diagnostic", "Sym", "verify_program", "check_program",
           "check_program_cached", "infer_program", "shape_rule_coverage"]

_m_programs_checked = _monitor.counter(
    "analysis.programs_checked",
    "Full verifier walks (cache misses of check_program_cached plus every "
    "direct verify_program call).")
_m_violations = _monitor.counter(
    "analysis.violations",
    "Diagnostics found by the program verifier, by code.",
    labelnames=("code",))


# Op types realized by the Executor itself (its own dispatch in
# executor._run_one) — they have no registry entry by design.
EXECUTOR_OPS = frozenset({
    "feed", "fetch", "backward_region", "conditional_block", "while",
    "static_rnn",
})

# Control-flow ops and the SUB_BLOCK_ATTRS attrs each must carry, plus the
# names their lowering injects into the sub-block env before tracing it
# (executor._lower_cond/_lower_while/_lower_static_rnn).
_BLOCK_OP_REQUIRED_ATTRS = {
    "conditional_block": ("true_block", "false_block"),
    "while": ("cond_block", "body_block"),
    "static_rnn": ("rnn_block",),
}

# Attrs whose values are *variable names read by the executor's lowering*
# (branch outputs, loop carries...) — they count as reads for PV002.
_NAME_LIST_ATTRS = ("true_outs", "false_outs", "body_outs", "mem_next",
                    "out_names")
_NAME_ATTRS = ("cond_out",)

# After walking a sub-block, these are the names whose inferred shapes the
# engine captures (the values the executor's lowering returns out of the
# traced sub-env): branch outputs, the while condition/carries, RNN slots.
_RECORD_ATTRS = {
    "true_block": ("true_outs",),
    "false_block": ("false_outs",),
    "cond_block": ("cond_out",),
    "body_block": ("body_outs",),
    "rnn_block": ("out_names", "mem_next"),
}


@dataclass
class Diagnostic:
    """One structured finding (code, severity, location, fix-hint)."""

    code: str
    severity: str                 # "error" | "warning"
    message: str
    block: int = 0
    op_index: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    hint: Optional[str] = None

    def __str__(self):
        return _errors.render_diagnostics([self])


# ---------------------------------------------------------------------------
# Symbolic dimensions.  A shape in the engine is a tuple whose entries are
# non-negative ints (known) or Sym objects (unknown-but-tracked: the same
# -1 dim of the same variable is the same Sym everywhere it flows, so
# "batch" stays one symbol through an arbitrarily long chain).  None means
# "shape entirely unknown" (the IR's undeclared `()`).
# ---------------------------------------------------------------------------

class Sym:
    """One unknown dimension.  Identity is equality: two Syms compare equal
    only when they are the same object, so unification is pointer-cheap."""

    __slots__ = ("id", "origin")
    _ids = itertools.count()

    def __init__(self, origin: str = ""):
        self.id = next(Sym._ids)
        self.origin = origin

    def __repr__(self):
        return f"s{self.id}" + (f"<{self.origin}>" if self.origin else "")


Dim = Union[int, Sym]
SymShape = Optional[Tuple[Dim, ...]]


def _known(d) -> bool:
    """True for a concrete, usable dimension (non-bool int >= 0)."""
    return (isinstance(d, (int, np.integer)) and not isinstance(d, bool)
            and int(d) >= 0)


def _legacy(shape: SymShape):
    """Engine shape → the legacy checker form (ints with -1 wildcards)."""
    if shape is None:
        return None
    return tuple(int(d) if _known(d) else -1 for d in shape)


def _dims_equal(a: Dim, b: Dim) -> bool:
    if _known(a) and _known(b):
        return int(a) == int(b)
    return a is b


class _ShapeEnv:
    """Flat name→(shape, dtype) environment mirroring the executor's trace
    env (one dict, sub-blocks snapshot/restore around descent).  Falls back
    to the *declared* Variable shape with -1 dims memoized into per-(name,
    dim) symbols, so the engine degrades gracefully to exactly the old
    declared-shape behavior for any op it has no rule for."""

    def __init__(self, program: Program):
        self.program = program
        self.shapes: Dict[str, SymShape] = {}
        self.dtypes: Dict[str, Optional[np.dtype]] = {}
        self._sym_memo: Dict[Tuple[str, int], Sym] = {}
        # control-flow consistency findings for shardcheck (SC006); never
        # emitted by verify_program itself
        self.subblock_findings: List[Diagnostic] = []
        # (id(op), attr) -> [(name, shape, dtype)] captured at sub-block end
        self.records: Dict[Tuple[int, str], List[tuple]] = {}

    # -- lookups -------------------------------------------------------------
    def _declared_shape(self, block, name) -> SymShape:
        try:
            v = block.var(name)
        except KeyError:
            return None
        s = tuple(v.shape)
        if not s:
            return None                 # () is "undeclared" in this IR
        return tuple(int(d) if _known(d) else self._sym(name, i)
                     for i, d in enumerate(s))

    def _declared_dtype(self, block, name) -> Optional[np.dtype]:
        try:
            return _np_dtype(block.var(name).dtype)
        except (KeyError, TypeError):
            return None

    def _sym(self, name: str, i: int) -> Sym:
        key = (name, i)
        s = self._sym_memo.get(key)
        if s is None:
            s = self._sym_memo[key] = Sym(f"{name}[{i}]")
        return s

    def shape_of(self, block, name: str) -> SymShape:
        if name in self.shapes:
            return self.shapes[name]
        return self._declared_shape(block, name)

    def dtype_of(self, block, name: str) -> Optional[np.dtype]:
        if name in self.dtypes:
            return self.dtypes[name]
        return self._declared_dtype(block, name)

    # -- mutation ------------------------------------------------------------
    def bind(self, name: str, shape: SymShape, dtype: Optional[np.dtype]):
        self.shapes[name] = shape
        self.dtypes[name] = dtype

    def bind_declared(self, block, name: str):
        self.bind(name, self._declared_shape(block, name),
                  self._declared_dtype(block, name))

    def snapshot(self):
        return dict(self.shapes), dict(self.dtypes)

    def restore(self, snap):
        self.shapes, self.dtypes = snap

    def inject(self, names, block):
        """Bind sub-block-scoped names (loop memories, step inputs) to their
        declared shapes in `block`, shadowing any outer binding."""
        for n in names:
            self.bind_declared(block, n)

    def capture(self, op, attr: str, block):
        """Record the inferred (shape, dtype) of each name the executor's
        lowering reads back out of this sub-block's env."""
        rec = []
        for src in _RECORD_ATTRS.get(attr, ()):
            val = op.attrs.get(src)
            names = [val] if isinstance(val, str) else list(val or ())
            for n in names:
                if isinstance(n, str):
                    rec.append((n, self.shape_of(block, n),
                                self.dtype_of(block, n)))
        self.records[(id(op), attr)] = rec


class _Verifier:
    def __init__(self, program: Program, startup: Optional[Program],
                 feed_names: Optional[Sequence[str]],
                 fetch_names: Optional[Sequence[str]]):
        self.program = program
        self.startup = startup
        # feed_names=None means "verifying without a concrete run": any
        # is_data var is assumed feedable.  A concrete feed dict narrows
        # that to the names actually fed.
        self.feed_names = None if feed_names is None else set(feed_names)
        self.fetch_names = set(fetch_names or ())
        self.diags: List[Diagnostic] = []
        self.reads: Set[str] = set()
        self.writes: Dict[str, Tuple[int, int, str]] = {}  # name -> site
        self.engine = _ShapeEnv(program)
        self._op_flagged = False        # PV009 fired for the current op

    # -- reporting -----------------------------------------------------------
    def _emit(self, code, severity, message, block=0, op_index=None,
              op_type=None, var=None, hint=None):
        self.diags.append(Diagnostic(code, severity, message, block,
                                     op_index, op_type, var, hint))

    # -- entry ---------------------------------------------------------------
    def run(self) -> List[Diagnostic]:
        self._check_grad_pairing()
        if self.startup is not None:
            self._check_startup_init()
        defined = self._initial_defined(self.program.global_block())
        self._walk_block(0, defined, set())
        self._check_dead_temps()
        return self.diags

    # -- initial environment -------------------------------------------------
    def _initial_defined(self, block) -> Set[str]:
        """Names bound into the env before any op runs: feeds + persistable
        state (executor.run seeds env from `state` then `feeds`)."""
        defined = set()
        for v in self.program.list_vars():
            if v.persistable or isinstance(v, Parameter):
                defined.add(v.name)
            elif v.is_data:
                if self.feed_names is None or v.name in self.feed_names:
                    defined.add(v.name)
        if self.feed_names:
            defined |= self.feed_names
        return defined

    # -- block walk ----------------------------------------------------------
    def _walk_block(self, block_idx: int, defined: Set[str],
                    visiting: Set[int]) -> Set[str]:
        """Walk one block in execution order, growing `defined`; returns the
        defined-set after the last op (used for sub-block out checks)."""
        if block_idx in visiting:        # cyclic sub-block reference
            return defined
        visiting = visiting | {block_idx}
        block = self.program.blocks[block_idx]
        for op_idx, op in enumerate(block.ops):
            self._check_registry(block_idx, op_idx, op)
            self._check_structure(block_idx, op_idx, op)
            if op.type in ("feed", "fetch"):
                # executor skips these; feed outputs are env-bound by name
                for name in op.output_names():
                    defined.add(name)
                    self.engine.bind_declared(block, name)
                continue
            # dataflow: every input must already be defined
            for name in op.input_names():
                self.reads.add(name)
                if name not in defined:
                    self._emit(
                        "PV001", "error",
                        f"op {op.type!r} reads {name!r} which is not "
                        "produced by any earlier op, feed, persistable, or "
                        "parameter",
                        block_idx, op_idx, op.type, name,
                        hint=self._pv001_hint(block, name))
            for attr in _NAME_LIST_ATTRS:
                for name in op.attrs.get(attr, ()) or ():
                    if isinstance(name, str):
                        self.reads.add(name)
            for attr in _NAME_ATTRS:
                name = op.attrs.get(attr)
                if isinstance(name, str):
                    self.reads.add(name)
            # descend into sub-blocks with the defined-set AT this op (the
            # lowering snapshots the env here: executor._arrays_only)
            for attr, sub_idx in self._sub_blocks(op):
                if not self._valid_block_idx(sub_idx):
                    continue            # PV005 already emitted
                injected = self._injected_names(op, attr)
                sub_defined = set(defined) | injected
                sub_block = self.program.blocks[int(sub_idx)]
                snap = self.engine.snapshot()
                if op.type != "while":
                    # while carries keep their (possibly more concrete)
                    # outer bindings — the executor passes the env values
                    # of X straight into the body trace
                    self.engine.inject(injected, sub_block)
                self._walk_block(int(sub_idx), sub_defined, visiting)
                self.engine.capture(op, attr, sub_block)
                self.engine.restore(snap)
            self._op_flagged = False
            self._check_shapes(block_idx, op_idx, op)
            self._infer_op(block_idx, op_idx, op)
            for name in op.output_names():
                defined.add(name)
                self.writes.setdefault(name, (block_idx, op_idx, op.type))
        return defined

    def _pv001_hint(self, block, name) -> str:
        if not block.has_var(name):
            return (f"{name!r} is not declared in block {block.idx} or any "
                    "ancestor — check the op's input names")
        v = block.var(name)
        if v.is_data:
            return (f"{name!r} is a data var but was not fed — add it to "
                    "the feed dict")
        return (f"declare {name!r} persistable, feed it, or reorder the "
                "producing op before this one")

    @staticmethod
    def _sub_blocks(op):
        return op.sub_block_indices()

    def _valid_block_idx(self, idx) -> bool:
        return (isinstance(idx, (int, np.integer))
                and not isinstance(idx, bool)
                and 0 <= int(idx) < len(self.program.blocks))

    def _injected_names(self, op, attr) -> Set[str]:
        """Names the executor binds into a sub-block env before tracing it."""
        if op.type == "while":
            return set(op.inputs.get("X", ()))
        if op.type == "static_rnn":
            return (set(op.attrs.get("mem_names", ()))
                    | set(op.attrs.get("step_in_names", ())))
        return set()

    # -- registry soundness --------------------------------------------------
    def _check_registry(self, block_idx, op_idx, op):
        from . import executor as _executor  # noqa: F401 — registers every op
        from .op_coverage import DESCOPED
        from .registry import is_registered, suggest_names

        if op.type in EXECUTOR_OPS or is_registered(op.type):
            return
        if op.type in DESCOPED:
            self._emit(
                "PV004", "error",
                f"op type {op.type!r} is descoped and can never lower here",
                block_idx, op_idx, op.type,
                hint=f"rationale: {DESCOPED[op.type]}")
            return
        suggestion = suggest_names(op.type)
        self._emit(
            "PV003", "error",
            f"op type {op.type!r} has no registered lowering",
            block_idx, op_idx, op.type,
            hint=suggestion or "register one with static.register_op")

    # -- structural soundness ------------------------------------------------
    def _check_structure(self, block_idx, op_idx, op):
        n_blocks = len(self.program.blocks)
        for attr in _BLOCK_OP_REQUIRED_ATTRS.get(op.type, ()):
            if attr not in op.attrs:
                self._emit(
                    "PV005", "error",
                    f"control-flow op {op.type!r} is missing its "
                    f"{attr!r} sub-block attr",
                    block_idx, op_idx, op.type,
                    hint="build it through static.cond/while_loop/StaticRNN")
        for attr, sub_idx in self._sub_blocks(op):
            if not self._valid_block_idx(sub_idx):
                self._emit(
                    "PV005", "error",
                    f"op {op.type!r} attr {attr!r} references block "
                    f"{sub_idx!r} but the program has {n_blocks} blocks",
                    block_idx, op_idx, op.type,
                    hint="sub-block attrs hold an index into program.blocks")
        # block-reference attrs the walkers cannot see (the framework.py
        # "walkers go blind" hazard): an int attr named *_block outside
        # SUB_BLOCK_ATTRS almost certainly references a block
        for attr, value in op.attrs.items():
            if (attr.endswith("_block") and attr not in SUB_BLOCK_ATTRS
                    and isinstance(value, (int, np.integer))
                    and not isinstance(value, bool)):
                self._emit(
                    "PV006", "error",
                    f"op {op.type!r} attr {attr!r} looks like a sub-block "
                    "reference but is not listed in "
                    "framework.SUB_BLOCK_ATTRS — dataflow walkers will not "
                    "descend into that block",
                    block_idx, op_idx, op.type,
                    hint="add the attr name to framework.SUB_BLOCK_ATTRS")

    # -- grad pairing --------------------------------------------------------
    def _check_grad_pairing(self):
        # program-wide primal pool: append_backward puts param grads in
        # block 0 even when the primal was created inside a sub-block
        # (StaticRNN parameters), so block-scoped lookup would false-flag
        all_names = {n for b in self.program.blocks for n in b.vars}
        for block in self.program.blocks:
            for name, v in block.vars.items():
                if not name.endswith(GRAD_SUFFIX):
                    continue
                primal = name[: -len(GRAD_SUFFIX)]
                if not block.has_var(primal) and primal not in all_names:
                    self._emit(
                        "PV007", "error",
                        f"grad var {name!r} has no primal {primal!r} "
                        "anywhere in the program",
                        block.idx, var=name,
                        hint="grad vars are created by append_backward/"
                             "gradients next to their primal")

    # -- startup coverage ----------------------------------------------------
    def _check_startup_init(self):
        initialized = set()
        for block in self.startup.blocks:
            for op in block.ops:
                initialized |= set(op.output_names())
        # a persistable the main program READS before any main-program op
        # writes it must come from startup (executor._needs_value semantics)
        for v in self.program.list_vars():
            if not v.persistable or v.name in initialized:
                continue
            if self._first_access(self.program.global_block(), v.name) == "read":
                self._emit(
                    "PV008", "error",
                    f"persistable {v.name!r} is read by the main program "
                    "but never initialized by the startup program",
                    var=v.name,
                    hint="append an init op for it to the startup program "
                         "(layers.create_parameter does this automatically)")

    def _first_access(self, block, name):
        for op in block.ops:
            if name in op.input_names():
                return "read"
            for _attr, sub_idx in self._sub_blocks(op):
                if self._valid_block_idx(sub_idx):
                    sub = self._first_access(self.program.blocks[sub_idx],
                                             name)
                    if sub == "read":
                        return "read"
            if name in op.output_names():
                return "write"
        return None

    # -- dead temporaries ----------------------------------------------------
    def _check_dead_temps(self):
        for name, (block_idx, op_idx, op_type) in self.writes.items():
            if name in self.reads or name in self.fetch_names:
                continue
            block = self.program.blocks[block_idx]
            try:
                v = block.var(name)
            except KeyError:
                v = None
            if v is not None and (v.persistable or v.is_data):
                continue
            self._emit(
                "PV002", "warning",
                f"temporary {name!r} (written by op {op_type!r}) is never "
                "read or fetched — it inflates the trace for nothing",
                block_idx, op_idx, op_type, name,
                hint="drop the op or fetch the value")

    # -- shape / dtype plausibility ------------------------------------------
    def _var_shape(self, block, name) -> Optional[Tuple[int, ...]]:
        try:
            v = block.var(name)
        except KeyError:
            return None
        shape = tuple(v.shape)
        return shape if shape else None   # () is "undeclared" in this IR

    def _var_dtype(self, block, name):
        try:
            return _np_dtype(block.var(name).dtype)
        except KeyError:
            return None

    def _check_shapes(self, block_idx, op_idx, op):
        checker = _SHAPE_CHECKERS.get(op.type)
        if checker is None:
            return
        block = self.program.blocks[block_idx]

        # the legacy table consumes (ints, -1 wildcards) — feed it the
        # ENGINE's propagated shapes so a concrete dim inferred upstream is
        # checked here even when the variable was declared with -1/()
        def shape(slot, i=0):
            names = op.inputs.get(slot, ())
            return (_legacy(self.engine.shape_of(block, names[i]))
                    if i < len(names) else None)

        def dtype(slot, i=0):
            names = op.inputs.get(slot, ())
            return (self.engine.dtype_of(block, names[i])
                    if i < len(names) else None)

        for message, hint in checker(op, shape, dtype):
            self._op_flagged = True
            self._emit("PV009", "error", message, block_idx, op_idx,
                       op.type, hint=hint)

    # -- forward symbolic inference ------------------------------------------
    def _infer_op(self, block_idx, op_idx, op):
        """Propagate shapes/dtypes through one op via _INFER_RULES; ops
        without a rule fall back to their declared output shapes."""
        block = self.program.blocks[block_idx]
        eng = self.engine
        if op.type == "backward_region":
            params = list(op.inputs.get("Params", ()))
            for i, g in enumerate(op.outputs.get("Grads", ())):
                if i < len(params):
                    eng.bind(g, eng.shape_of(block, params[i]),
                             eng.dtype_of(block, params[i]))
                else:
                    eng.bind_declared(block, g)
            return
        if op.type == "conditional_block":
            self._infer_cond(block_idx, op_idx, op)
            return
        if op.type == "while":
            self._infer_while(block_idx, op_idx, op)
            return
        rule = _INFER_RULES.get(op.type)
        if rule is not None:
            ctx = _InferCtx(self, block_idx, op_idx, op)
            try:
                rule(ctx)
            except Exception:           # a broken rule must never block
                ctx.failed = True       # the trace — degrade to declared
            bound = ctx.bound
        else:
            bound = set()
        for name in op.output_names():
            if name not in bound:
                eng.bind_declared(block, name)

    def _infer_cond(self, block_idx, op_idx, op):
        """lax.cond requires identical branch avals: compare the inferred
        true/false outputs positionally; record clashes for shardcheck
        (SC006) and bind Out from the unified result."""
        eng = self.engine
        block = self.program.blocks[block_idx]
        t_rec = eng.records.get((id(op), "true_block"), [])
        f_rec = eng.records.get((id(op), "false_block"), [])
        outs = list(op.outputs.get("Out", ()))
        for i, name in enumerate(outs):
            t = t_rec[i] if i < len(t_rec) else None
            f = f_rec[i] if i < len(f_rec) else None
            if t is None or f is None:
                eng.bind_declared(block, name)
                continue
            (tn, ts, td), (fn, fs, fd) = t, f
            clash = _shape_clash(ts, fs)
            if clash:
                eng.subblock_findings.append(Diagnostic(
                    "SC006", "error",
                    f"cond branches disagree on output {i} "
                    f"({tn!r} vs {fn!r}): {clash} — lax.cond requires "
                    "identical branch avals",
                    block_idx, op_idx, op.type, var=name,
                    hint="make both branches produce the same shape"))
            elif (td is not None and fd is not None and td != fd
                  and tn in eng.dtypes and fn in eng.dtypes):
                # dtype clash only when both sides were RULE-inferred (a
                # declared-default float32 on one side must not false-flag)
                eng.subblock_findings.append(Diagnostic(
                    "SC006", "error",
                    f"cond branches disagree on output {i} dtype "
                    f"({tn!r} is {td}, {fn!r} is {fd}) — lax.cond "
                    "requires identical branch avals",
                    block_idx, op_idx, op.type, var=name,
                    hint="cast one branch to the other's dtype"))
            eng.bind(name, _shape_unify(ts, fs), td if td == fd else None)

    def _infer_while(self, block_idx, op_idx, op):
        """lax.while_loop carries must be shape-invariant: compare each
        carry's entry shape against the body's inferred output shape.
        Shape-only — the executor casts body outputs back to the carry
        dtype, so dtype drift is legal at runtime."""
        eng = self.engine
        block = self.program.blocks[block_idx]
        carries = list(op.inputs.get("X", ()))
        b_rec = eng.records.get((id(op), "body_block"), [])
        outs = list(op.outputs.get("Out", ()))
        for i, name in enumerate(outs):
            cs = (eng.shape_of(block, carries[i])
                  if i < len(carries) else None)
            cd = (eng.dtype_of(block, carries[i])
                  if i < len(carries) else None)
            if i < len(b_rec):
                bn, bs, _bd = b_rec[i]
                clash = _shape_clash(cs, bs)
                if clash:
                    eng.subblock_findings.append(Diagnostic(
                        "SC006", "error",
                        f"while carry {i} ({carries[i]!r}) is not "
                        f"shape-invariant: body output {bn!r} — {clash}",
                        block_idx, op_idx, op.type, var=name,
                        hint="lax.while_loop carries must keep their shape"))
            eng.bind(name, cs, cd)


# ---------------------------------------------------------------------------
# Shape/dtype inference table.  Each checker yields (message, hint) pairs;
# -1 and undeclared shapes are wildcards — only statically-certain
# mismatches are flagged.
# ---------------------------------------------------------------------------

def _dims_clash(a: int, b: int) -> bool:
    return a != -1 and b != -1 and a != b


def _broadcast_clash(x, y, axis):
    """Reference elementwise broadcasting (ops._bcast_axis): y aligns to x
    starting at `axis`; equal ranks and axis in (None, -1) fall back to
    numpy trailing alignment.  Dims clash only when both are known, neither
    is 1, and they differ."""
    if x is None or y is None:
        return None
    if len(y) > len(x):
        return None                      # x broadcasts into y; jnp handles it
    if len(y) == len(x) or axis in (None, -1):
        for i in range(1, len(y) + 1):
            dx, dy = x[-i], y[-i]
            if dx != 1 and dy != 1 and _dims_clash(dx, dy):
                return (f"trailing dim -{i}: x has {dx}, y has {dy} "
                        "(not broadcastable)")
        return None
    start = axis
    if start < 0 or start + len(y) > len(x):
        return f"y rank {len(y)} does not fit into x rank {len(x)} at axis {axis}"
    for i, dy in enumerate(y):
        dx = x[start + i]
        if dx != 1 and dy != 1 and _dims_clash(dx, dy):
            return (f"dim {start + i}: x has {dx}, y has {dy} "
                    "(not broadcastable)")
    return None


def _chk_elementwise(op, shape, dtype):
    clash = _broadcast_clash(shape("X"), shape("Y"),
                             op.attrs.get("axis", -1))
    if clash:
        yield (f"elementwise {op.type!r}: {clash}",
               "shapes must broadcast under the reference axis rule")


def _chk_mul(op, shape, dtype):
    x, y = shape("X"), shape("Y")
    if x is None or y is None:
        return
    xn = op.attrs.get("x_num_col_dims", 1)
    yn = op.attrs.get("y_num_col_dims", 1)
    xin = x[xn:]
    yin = y[:yn]
    if any(d == -1 for d in xin) or any(d == -1 for d in yin):
        return
    a, b = int(np.prod(xin or (1,))), int(np.prod(yin or (1,)))
    if a != b:
        yield (f"mul: x flattens to inner dim {a} (shape {x} at "
               f"x_num_col_dims={xn}) but y provides {b} (shape {y})",
               "inner dimensions must match")


def _chk_matmul(op, shape, dtype):
    x, y = shape("X"), shape("Y")
    if x is None or y is None or len(x) < 1 or len(y) < 1:
        return
    kx = x[-2] if (op.attrs.get("transpose_X") and len(x) >= 2) else x[-1]
    if len(y) == 1:
        ky = y[0]
    else:
        ky = y[-1] if op.attrs.get("transpose_Y") else y[-2]
    if _dims_clash(kx, ky):
        yield (f"matmul: contraction dims differ — x contributes {kx} "
               f"(shape {x}), y contributes {ky} (shape {y})",
               "check transpose_X/transpose_Y and operand shapes")


def _chk_cast(op, shape, dtype):
    if "out_dtype" not in op.attrs:
        yield ("cast: missing required attr 'out_dtype'",
               "set attrs={'out_dtype': <dtype>}")


def _chk_fill_constant(op, shape, dtype):
    if "shape" not in op.attrs:
        yield ("fill_constant: missing required attr 'shape'",
               "set attrs={'shape': (...), 'value': v}")


def _chk_concat(op, shape, dtype):
    ranks = set()
    for i, _ in enumerate(op.inputs.get("X", ())):
        s = shape("X", i)
        if s is not None:
            ranks.add(len(s))
    if len(ranks) > 1:
        yield (f"concat: inputs have differing ranks {sorted(ranks)}",
               "all concat inputs must share a rank")


def _chk_softmax_ce(op, shape, dtype):
    if op.attrs.get("soft_label", False):
        return
    dt = dtype("Label")
    if dt is not None and dt.kind not in ("i", "u"):
        yield (f"softmax_with_cross_entropy: hard labels must be integer, "
               f"got {dt.name}",
               "cast the label to int64 or set soft_label=True")
    lx, ll = shape("Logits"), shape("Label")
    if lx is not None and ll is not None and len(ll) == len(lx):
        if _dims_clash(ll[-1], 1):
            yield (f"softmax_with_cross_entropy: hard label last dim must "
                   f"be 1, got {ll}",
                   "labels carry one class index per row")


def _chk_lookup_table(op, shape, dtype):
    dt = dtype("Ids")
    if dt is not None and dt.kind not in ("i", "u"):
        yield (f"{op.type}: Ids must be integer, got {dt.name}",
               "cast the ids to int64")


def _chk_conv2d(op, shape, dtype):
    x, w = shape("Input"), shape("Filter")
    if x is None or w is None or len(x) != 4 or len(w) != 4:
        return
    groups = op.attrs.get("groups", 1) or 1
    cin = x[1] if op.attrs.get("data_format", "NCHW") == "NCHW" else x[-1]
    if _dims_clash(cin, w[1] * groups):
        yield (f"conv2d: input channels {cin} != filter in-channels "
               f"{w[1]} * groups {groups}",
               "filter shape is (out_c, in_c/groups, kh, kw)")


def _chk_reshape(op, shape, dtype):
    x = shape("X")
    tgt = op.attrs.get("shape")
    if x is None or not tgt or any(d == -1 for d in x):
        return
    tgt = tuple(int(d) for d in tgt)
    if any(d == -1 for d in tgt) or 0 in tgt:
        return
    if int(np.prod(x)) != int(np.prod(tgt)):
        yield (f"reshape: cannot reshape {x} ({int(np.prod(x))} elements) "
               f"to {tgt} ({int(np.prod(tgt))} elements)",
               "element counts must match (use -1 for one inferred dim)")


_SHAPE_CHECKERS = {
    "mul": _chk_mul,
    "matmul": _chk_matmul,
    "cast": _chk_cast,
    "fill_constant": _chk_fill_constant,
    "concat": _chk_concat,
    "softmax_with_cross_entropy": _chk_softmax_ce,
    "lookup_table": _chk_lookup_table,
    "embedding": _chk_lookup_table,
    "c_embedding": _chk_lookup_table,
    "conv2d": _chk_conv2d,
    "reshape": _chk_reshape,
    "reshape2": _chk_reshape,
}
for _name in ("elementwise_add", "elementwise_sub", "elementwise_mul",
              "elementwise_div", "elementwise_max", "elementwise_min",
              "elementwise_pow", "elementwise_mod", "elementwise_floordiv"):
    _SHAPE_CHECKERS[_name] = _chk_elementwise


# ---------------------------------------------------------------------------
# Forward inference rules.  Each rule reads propagated input shapes/dtypes
# through an _InferCtx and binds output slots; anything it cannot determine
# stays None/declared (never guess — a wrong concrete dim would cascade
# into false PV009s downstream).  Rules mirror the registered lowerings in
# static/ops*.py (slot names, attr defaults) — a rule here without a
# matching lowering semantic is a bug.
# ---------------------------------------------------------------------------

def _shape_clash(a: SymShape, b: SymShape) -> Optional[str]:
    """Human-readable description of a statically-certain disagreement
    between two inferred shapes, or None (unknowns never clash)."""
    if a is None or b is None:
        return None
    if len(a) != len(b):
        return f"rank {len(a)} ({_legacy(a)}) vs rank {len(b)} ({_legacy(b)})"
    for i, (da, db) in enumerate(zip(a, b)):
        if _known(da) and _known(db) and int(da) != int(db):
            return f"dim {i}: {int(da)} vs {int(db)}"
    return None


def _shape_unify(a: SymShape, b: SymShape) -> SymShape:
    if a is None:
        return b
    if b is None or len(a) != len(b):
        return a
    return tuple(da if _known(da) else (db if _known(db) else da)
                 for da, db in zip(a, b))


def _bdim(a: Dim, b: Dim) -> Dim:
    """One broadcast output dim (clashes are the checker's job, not ours)."""
    if _known(a) and int(a) == 1:
        return b
    if _known(b) and int(b) == 1:
        return a
    if _known(a):
        return int(a)
    if _known(b):
        return int(b)
    return a


def _sym_broadcast(x: SymShape, y: SymShape, axis=-1) -> SymShape:
    """Output shape of the reference elementwise broadcast (_bcast_axis: y
    aligns into x at `axis`; trailing alignment otherwise)."""
    if x is None or y is None:
        return None
    if len(y) > len(x):
        x, y, axis = y, x, -1           # plain jnp broadcasting kicks in
    out = list(x)
    if len(y) == len(x) or axis in (None, -1):
        for i in range(1, len(y) + 1):
            out[-i] = _bdim(x[-i], y[-i])
        return tuple(out)
    if axis < 0 or axis + len(y) > len(x):
        return None
    for i, dy in enumerate(y):
        out[axis + i] = _bdim(x[axis + i], dy)
    return tuple(out)


def _prod_dim(dims) -> Dim:
    """Product of a dim run: concrete when every factor is, else a fresh
    anonymous Sym (NOT memoized — a different run is a different unknown)."""
    dims = tuple(dims)
    if all(_known(d) for d in dims):
        return int(np.prod([int(d) for d in dims], dtype=np.int64)) \
            if dims else 1
    return Sym("prod")


class _InferCtx:
    """The narrow surface a rule sees: propagated inputs, op attrs, and
    set_out (which also cross-checks inferred-vs-declared → PV010)."""

    def __init__(self, verifier: "_Verifier", block_idx, op_idx, op):
        self.v = verifier
        self.block_idx, self.op_idx, self.op = block_idx, op_idx, op
        self.block = verifier.program.blocks[block_idx]
        self.eng = verifier.engine
        self.bound: Set[str] = set()
        self.failed = False

    def in_shape(self, slot, i=0) -> SymShape:
        names = self.op.inputs.get(slot, ())
        return (self.eng.shape_of(self.block, names[i])
                if i < len(names) else None)

    def in_dtype(self, slot, i=0):
        names = self.op.inputs.get(slot, ())
        return (self.eng.dtype_of(self.block, names[i])
                if i < len(names) else None)

    def n_inputs(self, slot) -> int:
        return len(self.op.inputs.get(slot, ()))

    def attr(self, name, default=None):
        return self.op.attrs.get(name, default)

    def fail(self, message, hint=None):
        """A statically-certain lowering failure found while inferring —
        same severity and code as the plausibility table (PV009)."""
        self.v._op_flagged = True
        self.v._emit("PV009", "error", message, self.block_idx,
                     self.op_idx, self.op.type, hint=hint)

    def set_out(self, slot, shape: SymShape, dtype=None, i=0):
        names = self.op.outputs.get(slot, ())
        if i >= len(names):
            return
        name = names[i]
        if dtype is None:
            dtype = self.eng._declared_dtype(self.block, name)
        self.eng.bind(name, shape, dtype)
        self.bound.add(name)
        if shape is None or self.v._op_flagged:
            return
        # PV010: a rule-inferred concrete dim contradicting the DECLARED
        # shape means the declaration is stale/wrong (warning only — the
        # executor traces from values, not declarations)
        try:
            declared = tuple(self.block.var(name).shape)
        except KeyError:
            return
        if not declared:
            return
        if len(declared) != len(shape):
            self.v._emit(
                "PV010", "warning",
                f"{self.op.type}: inferred shape of {name!r} is "
                f"{_legacy(shape)} (rank {len(shape)}) but it is declared "
                f"as {declared} (rank {len(declared)})",
                self.block_idx, self.op_idx, self.op.type, var=name,
                hint="fix the declared shape — downstream checks use the "
                     "inferred one")
            return
        for j, (a, b) in enumerate(zip(shape, declared)):
            if _known(a) and _known(b) and int(a) != int(b):
                self.v._emit(
                    "PV010", "warning",
                    f"{self.op.type}: inferred {name!r} dim {j} = {int(a)} "
                    f"contradicts its declared shape {declared}",
                    self.block_idx, self.op_idx, self.op.type, var=name,
                    hint="fix the declared shape — downstream checks use "
                         "the inferred one")
                return


# -- rule bodies -------------------------------------------------------------

def _rule_unary(ctx):
    ctx.set_out("Out", ctx.in_shape("X"), ctx.in_dtype("X"))


def _rule_elementwise(ctx):
    out = _sym_broadcast(ctx.in_shape("X"), ctx.in_shape("Y"),
                         ctx.attr("axis", -1))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_compare(ctx):
    out = _sym_broadcast(ctx.in_shape("X"), ctx.in_shape("Y"), -1)
    ctx.set_out("Out", out, _np_dtype(bool))


def _rule_logical_not(ctx):
    ctx.set_out("Out", ctx.in_shape("X"), _np_dtype(bool))


def _rule_reduce(ctx):
    x = ctx.in_shape("X")
    if x is None or not len(x):
        ctx.set_out("Out", None if x is None else (), ctx.in_dtype("X"))
        return
    dim = ctx.attr("dim")
    if ctx.attr("reduce_all", False) or dim is None:
        dims = set(range(len(x)))
    else:
        axes = (dim,) if isinstance(dim, (int, np.integer)) else tuple(dim)
        dims = {int(d) % len(x) for d in axes}
    if ctx.attr("keep_dim", False):
        out = tuple(1 if i in dims else d for i, d in enumerate(x))
    else:
        out = tuple(d for i, d in enumerate(x) if i not in dims)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_mean(ctx):
    ctx.set_out("Out", (), ctx.in_dtype("X"))


def _rule_sum(ctx):
    ctx.set_out("Out", ctx.in_shape("X", 0), ctx.in_dtype("X", 0))


def _rule_mul(ctx):
    x, y = ctx.in_shape("X"), ctx.in_shape("Y")
    xn = int(ctx.attr("x_num_col_dims", 1))
    yn = int(ctx.attr("y_num_col_dims", 1))
    out = None
    if x is not None and y is not None and len(x) >= xn and len(y) >= yn:
        out = tuple(x[:xn]) + tuple(y[yn:])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_matmul(ctx):
    x, y = ctx.in_shape("X"), ctx.in_shape("Y")
    if x is None or y is None:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    if ctx.attr("transpose_X", ctx.attr("trans_x", False)) and len(x) >= 2:
        x = x[:-2] + (x[-1], x[-2])
    if ctx.attr("transpose_Y", ctx.attr("trans_y", False)) and len(y) >= 2:
        y = y[:-2] + (y[-1], y[-2])
    if len(x) >= 2 and len(y) >= 2:
        batch = _sym_broadcast(x[:-2], y[:-2], -1)
        out = None if batch is None else batch + (x[-2], y[-1])
    elif len(x) >= 2 and len(y) == 1:
        out = x[:-1]
    elif len(x) == 1 and len(y) >= 2:
        out = y[:-2] + (y[-1],)
    else:
        out = ()
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_fc(ctx):
    x, w = ctx.in_shape("Input"), ctx.in_shape("W")
    ncol = int(ctx.attr("in_num_col_dims", 1))
    out = None
    if x is not None and w is not None and len(w) >= 2 and len(x) >= ncol:
        out = tuple(x[:ncol]) + (w[1],)
    ctx.set_out("Out", out, ctx.in_dtype("Input"))


def _rule_cast(ctx):
    dt = ctx.attr("out_dtype")
    try:
        dt = _np_dtype(dt) if dt is not None else None
    except TypeError:
        dt = None
    ctx.set_out("Out", ctx.in_shape("X"), dt)


def _rule_fill_constant(ctx):
    shape = ctx.attr("shape")
    dt = ctx.attr("dtype", "float32")
    try:
        dt = _np_dtype(dt)
    except TypeError:
        dt = None
    ctx.set_out("Out",
                None if shape is None else tuple(int(d) for d in shape), dt)


def _rule_fill_like(ctx):
    ctx.set_out("Out", ctx.in_shape("X"), ctx.in_dtype("X"))


def _rule_concat(ctx):
    n = ctx.n_inputs("X")
    shapes = [ctx.in_shape("X", i) for i in range(n)]
    if not shapes or any(s is None for s in shapes) \
            or len({len(s) for s in shapes}) != 1:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    axis = int(ctx.attr("axis", 0)) % len(shapes[0]) if len(shapes[0]) \
        else 0
    out = list(shapes[0])
    cat = [s[axis] for s in shapes]
    out[axis] = (int(sum(int(d) for d in cat))
                 if all(_known(d) for d in cat) else Sym("concat"))
    for j in range(len(out)):
        if j != axis and not _known(out[j]):
            for s in shapes[1:]:        # any sibling's concrete dim wins
                if _known(s[j]):
                    out[j] = int(s[j])
                    break
    ctx.set_out("Out", tuple(out), ctx.in_dtype("X"))


def _rule_stack(ctx):
    n = ctx.n_inputs("X")
    x = ctx.in_shape("X", 0)
    if x is None:
        ctx.set_out("Y", None, ctx.in_dtype("X"))
        return
    axis = int(ctx.attr("axis", 0))
    if axis < 0:
        axis += len(x) + 1
    if not 0 <= axis <= len(x):
        ctx.set_out("Y", None, ctx.in_dtype("X"))
        return
    ctx.set_out("Y", tuple(x[:axis]) + (n,) + tuple(x[axis:]),
                ctx.in_dtype("X"))


def _rule_reshape(ctx):
    x = ctx.in_shape("X")
    tgt = ctx.attr("shape")
    if tgt is None:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    tgt = [int(d) for d in tgt]
    out = []
    for i, d in enumerate(tgt):
        if d == 0:                      # reference semantics: copy input dim
            out.append(x[i] if x is not None and i < len(x) else Sym("resh"))
        elif d == -1:
            out.append(None)            # placeholder, solved below
        else:
            out.append(d)
    if None in out:
        hole = out.index(None)
        rest = [d for d in out if d is not None]
        total = _prod_dim(x) if x is not None else Sym("resh")
        if _known(total) and all(_known(d) for d in rest):
            denom = int(np.prod([int(d) for d in rest], dtype=np.int64)) \
                if rest else 1
            out[hole] = int(total) // denom if denom and \
                int(total) % denom == 0 else Sym("resh")
        else:
            out[hole] = Sym("resh")
    ctx.set_out("Out", tuple(out), ctx.in_dtype("X"))


def _rule_transpose(ctx):
    x = ctx.in_shape("X")
    perm = ctx.attr("axis")
    if x is None or perm is None:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    perm = [int(p) for p in perm]
    if sorted(p % len(x) if len(x) else p for p in perm) \
            != list(range(len(x))):
        ctx.fail(
            f"transpose: perm {perm} is not a permutation of rank "
            f"{len(x)} input {_legacy(x)}",
            "attrs['axis'] must list each input axis exactly once")
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    ctx.set_out("Out", tuple(x[p % len(x)] for p in perm),
                ctx.in_dtype("X"))


def _rule_flatten(ctx):
    x = ctx.in_shape("X")
    ax = int(ctx.attr("axis", 1))
    if x is None or not 0 <= ax <= len(x):
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    ctx.set_out("Out", (_prod_dim(x[:ax]) if ax else 1, _prod_dim(x[ax:])),
                ctx.in_dtype("X"))


def _rule_squeeze(ctx):
    x = ctx.in_shape("X")
    axes = tuple(int(a) for a in ctx.attr("axes", ()) or ())
    if x is None:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    if not axes:
        if not all(_known(d) for d in x):
            ctx.set_out("Out", None, ctx.in_dtype("X"))
            return
        out = tuple(d for d in x if int(d) != 1)
    else:
        drop = {a % len(x) for a in axes} if len(x) else set()
        out = tuple(d for i, d in enumerate(x) if i not in drop)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_unsqueeze(ctx):
    x = ctx.in_shape("X")
    axes = ctx.attr("axes")
    if x is None or axes is None:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    out = list(x)
    for a in sorted(int(a) for a in axes):
        if not -len(out) - 1 <= a <= len(out):
            ctx.set_out("Out", None, ctx.in_dtype("X"))
            return
        out.insert(a if a >= 0 else a + len(out) + 1, 1)
    ctx.set_out("Out", tuple(out), ctx.in_dtype("X"))


def _conv_spatial(size: Dim, k: int, s: int, p: int, d: int = 1) -> Dim:
    if not _known(size):
        return Sym("conv")
    eff = d * (k - 1) + 1
    return (int(size) + 2 * p - eff) // s + 1


def _rule_conv2d(ctx):
    x, w = ctx.in_shape("Input"), ctx.in_shape("Filter")
    if x is None or w is None or len(x) != 4 or len(w) != 4:
        ctx.set_out("Output", None, ctx.in_dtype("Input"))
        return
    st = tuple(ctx.attr("strides", (1, 1)))
    pd = tuple(ctx.attr("paddings", (0, 0)))
    dl = tuple(ctx.attr("dilations", (1, 1)))
    nchw = ctx.attr("data_format", "NCHW") == "NCHW"
    h_in, w_in = (x[2], x[3]) if nchw else (x[1], x[2])
    if not (_known(w[2]) and _known(w[3])):
        ctx.set_out("Output", None, ctx.in_dtype("Input"))
        return
    h = _conv_spatial(h_in, int(w[2]), int(st[0]), int(pd[0]), int(dl[0]))
    wd = _conv_spatial(w_in, int(w[3]), int(st[1]), int(pd[1]), int(dl[1]))
    out = (x[0], w[0], h, wd) if nchw else (x[0], h, wd, w[0])
    ctx.set_out("Output", out, ctx.in_dtype("Input"))


def _rule_pool2d(ctx):
    x = ctx.in_shape("X")
    if x is None or len(x) != 4:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    nchw = ctx.attr("data_format", "NCHW") == "NCHW"
    c = x[1] if nchw else x[3]
    h_in, w_in = (x[2], x[3]) if nchw else (x[1], x[2])

    def _emit(h, w):
        out = (x[0], c, h, w) if nchw else (x[0], h, w, c)
        ctx.set_out("Out", out, ctx.in_dtype("X"))

    if ctx.attr("global_pooling", False):
        _emit(1, 1)
        return
    ks = tuple(int(k) for k in ctx.attr("ksize", (1, 1)))
    if ctx.attr("adaptive", False):
        _emit(*ks)
        return
    st = tuple(int(s) for s in ctx.attr("strides", ks))
    pd = tuple(int(p) for p in ctx.attr("paddings", (0, 0)))
    if ctx.attr("ceil_mode", False):
        _emit(Sym("pool"), Sym("pool"))
        return
    _emit(_conv_spatial(h_in, ks[0], st[0], pd[0]),
          _conv_spatial(w_in, ks[1], st[1], pd[1]))


def _rule_batch_norm(ctx):
    ctx.set_out("Y", ctx.in_shape("X"), ctx.in_dtype("X"))


def _rule_layer_norm(ctx):
    ctx.set_out("Y", ctx.in_shape("X"), ctx.in_dtype("X"))


def _rule_lookup_table(ctx):
    ids, w = ctx.in_shape("Ids"), ctx.in_shape("W")
    out = None
    if ids is not None and w is not None and len(w) >= 1 and len(ids) >= 1:
        # lookup_table squeezes the trailing ids dim (jnp.take of ids[...,0])
        out = tuple(ids[:-1]) + tuple(w[1:])
    ctx.set_out("Out", out, ctx.in_dtype("W"))


def _rule_embedding(ctx):
    ids, w = ctx.in_shape("Ids"), ctx.in_shape("W")
    out = None
    if ids is not None and w is not None and len(w) >= 1:
        out = tuple(ids) + tuple(w[1:])   # F.embedding: no squeeze
    ctx.set_out("Out", out, ctx.in_dtype("W"))


def _rule_softmax_ce(ctx):
    logits = ctx.in_shape("Logits")
    if logits is None or not len(logits):
        return
    ctx.set_out("Loss", tuple(logits[:-1]) + (1,), ctx.in_dtype("Logits"))
    ctx.set_out("Softmax", logits, ctx.in_dtype("Logits"))


def _rule_one_hot(ctx):
    x = ctx.in_shape("X")
    depth = ctx.attr("depth")
    out = None
    if x is not None and depth is not None:
        out = tuple(x) + (int(depth),)
    ctx.set_out("Out", out)


def _rule_top_k(ctx):
    x = ctx.in_shape("X")
    k = ctx.attr("k", 1)
    out = None
    if x is not None and len(x):
        out = tuple(x[:-1]) + (int(k),)
    ctx.set_out("Out", out, ctx.in_dtype("X"))
    ctx.set_out("Indices", out, _np_dtype(np.int64))


def _rule_arg_reduce(ctx):
    x = ctx.in_shape("X")
    if x is None or not len(x):
        ctx.set_out("Out", None, _np_dtype(np.int64))
        return
    axis = int(ctx.attr("axis", -1)) % len(x)
    keep = ctx.attr("keepdims", False)
    out = tuple(1 if i == axis else d for i, d in enumerate(x)) if keep \
        else tuple(d for i, d in enumerate(x) if i != axis)
    ctx.set_out("Out", out, _np_dtype(np.int64))


def _rule_param_out(ctx):
    """Optimizer update ops: every '<Slot>Out' output mirrors its '<Slot>'
    input (sgd/momentum/adam/... all follow the ref naming convention);
    unmatched outputs degrade to their declared shapes."""
    for slot in ctx.op.outputs:
        src = slot[:-3] if slot.endswith("Out") else None
        if src and src in ctx.op.inputs:
            ctx.set_out(slot, ctx.in_shape(src), ctx.in_dtype(src))


def _rule_gather(ctx):
    x, idx = ctx.in_shape("X"), ctx.in_shape("Index")
    out = None
    if x is not None and idx is not None and len(x):
        axis = int(ctx.attr("axis", 0)) % len(x)
        out = tuple(x[:axis]) + tuple(idx) + tuple(x[axis + 1:])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_index_select(ctx):
    x, idx = ctx.in_shape("X"), ctx.in_shape("Index")
    out = None
    if x is not None and idx is not None and len(x) and len(idx) == 1:
        d = int(ctx.attr("dim", 0)) % len(x)
        out = tuple(x[:d]) + (idx[0],) + tuple(x[d + 1:])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _slice_len(dim: Dim, s: int, e: int, stride: int = 1) -> Dim:
    if not _known(dim):
        return Sym("slice")
    d = int(dim)
    s = s + d if s < 0 else s
    e = e + d if e < 0 else e
    s, e = max(0, min(s, d)), max(0, min(e, d))
    return max(0, -(-(e - s) // stride))


def _rule_slice(ctx):
    x = ctx.in_shape("Input")
    axes = ctx.attr("axes")
    if x is None or axes is None:
        ctx.set_out("Out", None, ctx.in_dtype("Input"))
        return
    starts = tuple(ctx.attr("starts", ()))
    ends = tuple(ctx.attr("ends", ()))
    strides = tuple(ctx.attr("strides", (1,) * len(axes)))
    out = list(x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        if 0 <= ax < len(out):
            out[ax] = _slice_len(out[ax], int(s), int(e), int(st))
    ctx.set_out("Out", tuple(out), ctx.in_dtype("Input"))


def _rule_expand(ctx):
    # expand/tile: jnp.tile — reps shorter than rank apply trailing,
    # reps longer than rank prepend dims
    x = ctx.in_shape("X")
    reps = ctx.attr("expand_times", ctx.attr("repeat_times"))
    if x is None or reps is None:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    reps = tuple(int(r) for r in reps)
    if len(reps) < len(x):
        reps = (1,) * (len(x) - len(reps)) + reps
    xs = (1,) * (len(reps) - len(x)) + tuple(x)
    out = tuple(int(d) * r if _known(d) else Sym("tile")
                for d, r in zip(xs, reps))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_expand_v2(ctx):
    x, shape = ctx.in_shape("X"), ctx.attr("shape")
    out = None
    if x is not None and shape is not None and len(shape) == len(x):
        out = tuple(x[i] if int(s) == -1 else int(s)
                    for i, s in enumerate(shape))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_expand_as(ctx):
    target = ctx.attr("target_shape")
    shape = tuple(int(s) for s in target) if target else (
        ctx.in_shape("target_tensor") if ctx.n_inputs("target_tensor")
        else ctx.in_shape("Y"))
    ctx.set_out("Out", shape, ctx.in_dtype("X"))


def _rule_shape_op(ctx):
    x = ctx.in_shape("Input")
    ctx.set_out("Out", (len(x),) if x is not None else None,
                _np_dtype(np.int32))


def _rule_size(ctx):
    ctx.set_out("Out", (), _np_dtype(np.int64))


def _rule_fill_batch_like(ctx):
    ref, shape = ctx.in_shape("Input"), ctx.attr("shape")
    if shape is None:
        return
    out = [int(s) for s in shape]
    odim = int(ctx.attr("output_dim_idx", 0))
    idim = int(ctx.attr("input_dim_idx", 0))
    if ref is not None and idim < len(ref) and odim < len(out):
        out[odim] = ref[idim]
    dt = ctx.attr("dtype")
    try:
        dt = _np_dtype(dt) if dt is not None else None
    except TypeError:
        dt = None
    ctx.set_out("Out", tuple(out), dt)


def _rule_pad(ctx):
    x, p = ctx.in_shape("X"), ctx.attr("paddings")
    out = None
    if x is not None and p is not None and len(p) >= 2 * len(x):
        out = tuple(_bdim(d, int(p[2 * i]) + int(p[2 * i + 1]))
                    for i, d in enumerate(x))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_pad2d(ctx):
    x, p = ctx.in_shape("X"), ctx.attr("paddings")
    out = None
    if x is not None and len(x) == 4 and p is not None and len(p) >= 4:
        # NCHW, paddings [top, bottom, left, right]
        out = (x[0], x[1], _bdim(x[2], int(p[0]) + int(p[1])),
               _bdim(x[3], int(p[2]) + int(p[3])))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_interp(mode):
    def rule(ctx):
        x = ctx.in_shape("X")
        spatial_rank = {"linear": 1, "trilinear": 3}.get(mode, 2)
        if x is None or len(x) != 2 + spatial_rank:
            ctx.set_out("Out", None, ctx.in_dtype("X"))
            return
        if ctx.n_inputs("OutSize"):       # runtime-tensor size: unknown
            spatial = tuple(Sym("interp") for _ in range(spatial_rank))
        elif ctx.attr("out_shape"):
            spatial = tuple(int(v) for v in ctx.attr("out_shape"))
        elif mode == "trilinear":
            spatial = (ctx.attr("out_d"), ctx.attr("out_h"),
                       ctx.attr("out_w"))
        elif mode == "linear":
            spatial = (ctx.attr("out_w"),)
        else:
            spatial = (ctx.attr("out_h"), ctx.attr("out_w"))
        if any(s is None for s in spatial):
            ctx.set_out("Out", None, ctx.in_dtype("X"))
            return
        spatial = tuple(s if isinstance(s, Sym) else int(s)
                        for s in spatial)
        ctx.set_out("Out", (x[0], x[1]) + spatial, ctx.in_dtype("X"))

    return rule


def _rule_resize_interp(ctx):
    x, sz = ctx.in_shape("X"), ctx.attr("out_shape")
    out = None
    if x is not None and len(x) == 4 and sz is not None and len(sz) == 2:
        out = (x[0], x[1], int(sz[0]), int(sz[1]))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_unstack(ctx):
    x = ctx.in_shape("X")
    slot = "Y" if "Y" in ctx.op.outputs else "Out"
    n = len(ctx.op.outputs.get(slot, ()))
    if x is None or not len(x):
        for i in range(n):
            ctx.set_out(slot, None, ctx.in_dtype("X"), i=i)
        return
    axis = int(ctx.attr("axis", 0)) % len(x)
    out = tuple(d for i, d in enumerate(x) if i != axis)
    for i in range(n):
        ctx.set_out(slot, out, ctx.in_dtype("X"), i=i)


def _rule_argsort(ctx):
    x = ctx.in_shape("X")
    ctx.set_out("Out", x, ctx.in_dtype("X"))
    ctx.set_out("Indices", x)           # int width is platform-dependent


def _rule_keepdim_batch(out_slot, extra_slots=()):
    """Losses reducing all non-batch dims with keepdims: (N, 1, ..., 1)."""
    def rule(ctx):
        x = ctx.in_shape("X")
        out = None
        if x is not None and len(x):
            out = (x[0],) + (1,) * (len(x) - 1)
        ctx.set_out(out_slot, out, ctx.in_dtype("X"))
        for s in extra_slots:
            ctx.set_out(s, x, ctx.in_dtype("X"))

    return rule


def _rule_cross_entropy(ctx):
    x = ctx.in_shape("X")
    out = None
    if x is not None and len(x):
        out = tuple(x[:-1]) + (1,)
    ctx.set_out("Y", out, ctx.in_dtype("X"))


def _rule_accuracy(ctx):
    ctx.set_out("Accuracy", (), ctx.in_dtype("Out"))
    ctx.set_out("Correct", (), _np_dtype(np.int32))
    ctx.set_out("Total", (), _np_dtype(np.int32))


def _rule_squared_l2_norm(ctx):
    ctx.set_out("Out", (1,), ctx.in_dtype("X"))


def _rule_norm(ctx):
    x = ctx.in_shape("X")
    ctx.set_out("Out", x, ctx.in_dtype("X"))
    if x is not None and len(x):
        axis = int(ctx.attr("axis", -1)) % len(x)
        ctx.set_out("Norm", tuple(1 if i == axis else d
                                  for i, d in enumerate(x)),
                    ctx.in_dtype("X"))


def _rule_kldiv_loss(ctx):
    red = ctx.attr("reduction", "mean")
    x = ctx.in_shape("X")
    ctx.set_out("Loss", x if red == "none" else (), ctx.in_dtype("X"))


def _rule_maxout(ctx):
    x, g = ctx.in_shape("X"), ctx.attr("groups")
    out = None
    if x is not None and len(x) >= 2 and g:
        c = x[1]
        out = (x[0], int(c) // int(g) if _known(c) else Sym("maxout")) \
            + tuple(x[2:])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_crop(ctx):
    shape = ctx.attr("shape")
    out = None
    if shape and all(int(s) > 0 for s in shape):
        out = tuple(int(s) for s in shape)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_same_as(in_slot, out_slot, dtype=None):
    """Output mirrors one input's shape (value-wise op with custom slot
    names); dtype overrides for predicate outputs."""
    def rule(ctx):
        ctx.set_out(out_slot, ctx.in_shape(in_slot),
                    dtype if dtype is not None else ctx.in_dtype(in_slot))

    return rule


# Ops whose lowering is value-wise: output 0 has exactly X's shape+dtype.
_SAME_SHAPE_OPS = (
    # ops.py unary families
    "relu", "sigmoid", "tanh", "gelu", "exp", "log", "sqrt", "square",
    "abs", "floor", "ceil", "softsign", "sin", "cos", "tan", "asin",
    "acos", "atan", "sinh", "cosh", "rsqrt", "reciprocal", "round",
    "sign", "log2", "log10", "log1p", "expm1", "erf", "softplus", "silu",
    "swish", "mish", "relu6", "hard_swish", "selu", "logsigmoid",
    "leaky_relu", "elu", "softmax", "scale", "clip", "assign",
    "increment", "dropout", "cumsum", "label_smooth", "log_softmax",
    "hard_sigmoid", "hard_shrink", "soft_shrink", "softshrink",
    "tanh_shrink", "thresholded_relu", "pow", "stanh",
    "bernoulli", "flip", "roll",
    # ops_tail families verified value-wise (activations, clips, masks,
    # selected-rows passthroughs, element-wise losses)
    "brelu", "hard_tanh", "soft_relu", "clip_by_norm", "prelu",
    "tril_triu", "reverse", "inverse", "shard_index", "scatter",
    "scatter_nd_add", "relu_grad_passthrough", "where",
    "get_tensor_from_selected_rows", "merge_selected_rows",
    "bce_loss", "sigmoid_cross_entropy_with_logits",
)

_INFER_RULES: Dict[str, object] = {
    "mul": _rule_mul,
    "matmul": _rule_matmul,
    "matmul_v2": _rule_matmul,
    "bmm": _rule_matmul,
    "fc": _rule_fc,
    "cast": _rule_cast,
    "fill_constant": _rule_fill_constant,
    "gaussian_random": _rule_fill_constant,
    "uniform_random": _rule_fill_constant,
    "truncated_gaussian_random": _rule_fill_constant,
    "fill_zeros_like": _rule_fill_like,
    "fill_any_like": _rule_fill_like,
    "concat": _rule_concat,
    "stack": _rule_stack,
    "reshape": _rule_reshape,
    "reshape2": _rule_reshape,
    "transpose": _rule_transpose,
    "transpose2": _rule_transpose,
    "flatten": _rule_flatten,
    "flatten2": _rule_flatten,
    "squeeze": _rule_squeeze,
    "squeeze2": _rule_squeeze,
    "unsqueeze": _rule_unsqueeze,
    "unsqueeze2": _rule_unsqueeze,
    "conv2d": _rule_conv2d,
    "depthwise_conv2d": _rule_conv2d,
    "pool2d": _rule_pool2d,
    "batch_norm": _rule_batch_norm,
    "layer_norm": _rule_layer_norm,
    "lookup_table": _rule_lookup_table,
    "lookup_table_v2": _rule_embedding,
    "embedding": _rule_embedding,
    "c_embedding": _rule_embedding,
    "softmax_with_cross_entropy": _rule_softmax_ce,
    "one_hot": _rule_one_hot,
    "one_hot_v2": _rule_one_hot,
    "top_k": _rule_top_k,
    "top_k_v2": _rule_top_k,
    "arg_max": _rule_arg_reduce,
    "arg_min": _rule_arg_reduce,
    "mean": _rule_mean,
    "sum": _rule_sum,
    "logical_not": _rule_logical_not,
    # data movement / indexing
    "gather": _rule_gather,
    "index_select": _rule_index_select,
    "slice": _rule_slice,
    "strided_slice": _rule_slice,
    "expand": _rule_expand,
    "tile": _rule_expand,
    "expand_v2": _rule_expand_v2,
    "expand_as": _rule_expand_as,
    "expand_as_v2": _rule_expand_as,
    "shape": _rule_shape_op,
    "size": _rule_size,
    "fill_constant_batch_size_like": _rule_fill_batch_like,
    "gaussian_random_batch_size_like": _rule_fill_batch_like,
    "uniform_random_batch_size_like": _rule_fill_batch_like,
    "pad": _rule_pad,
    "pad2d": _rule_pad2d,
    "resize_interp": _rule_resize_interp,
    "unstack": _rule_unstack,
    "unbind": _rule_unstack,
    "argsort": _rule_argsort,
    "crop": _rule_crop,
    "crop_tensor": _rule_crop,
    "maxout": _rule_maxout,
    # losses / metrics with non-X slots or reduced shapes
    "cross_entropy": _rule_cross_entropy,
    "cross_entropy2": _rule_cross_entropy,
    "accuracy": _rule_accuracy,
    "squared_l2_norm": _rule_squared_l2_norm,
    "norm": _rule_norm,
    "kldiv_loss": _rule_kldiv_loss,
    "smooth_l1_loss": _rule_keepdim_batch("Out", extra_slots=("Diff",)),
    "cos_sim_v2": _rule_keepdim_batch("Out", extra_slots=("sub_result",)),
    "square_error_cost": _rule_same_as("X", "Out"),
    "huber_loss": _rule_same_as("X", "Out"),
    "log_loss": _rule_same_as("Predicted", "Loss"),
    "hinge_loss": _rule_same_as("Logits", "Loss"),
    "margin_rank_loss": _rule_same_as("X1", "Out"),
    "label_smooth": _rule_same_as("X", "Out"),
    # norm layers writing slot Y
    "group_norm": _rule_same_as("X", "Y"),
    "instance_norm": _rule_same_as("X", "Y"),
    "data_norm": _rule_same_as("X", "Y"),
    # predicates (bool out, X's shape)
    "isfinite_v2": _rule_same_as("X", "Out", _np_dtype(np.bool_)),
    "isinf_v2": _rule_same_as("X", "Out", _np_dtype(np.bool_)),
    "isnan_v2": _rule_same_as("X", "Out", _np_dtype(np.bool_)),
    # collectives: shape-preserving reductions over the data axis
    "c_allreduce_sum": _rule_same_as("X", "Out"),
    "c_allreduce_max": _rule_same_as("X", "Out"),
    "c_allreduce_min": _rule_same_as("X", "Out"),
    "c_allreduce_prod": _rule_same_as("X", "Out"),
}
for _name in ("sgd", "momentum", "adam", "adamw", "adamax", "adagrad",
              "adadelta", "rmsprop", "ftrl", "lamb", "lars_momentum",
              "decayed_adagrad", "dpsgd", "proximal_adagrad",
              "proximal_gd", "dgc_momentum"):
    _INFER_RULES[_name] = _rule_param_out
for _name, _mode in (("bilinear_interp", "bilinear"),
                     ("bilinear_interp_v2", "bilinear"),
                     ("nearest_interp", "nearest"),
                     ("nearest_interp_v2", "nearest"),
                     ("bicubic_interp", "bicubic"),
                     ("bicubic_interp_v2", "bicubic"),
                     ("trilinear_interp", "trilinear"),
                     ("trilinear_interp_v2", "trilinear"),
                     ("linear_interp", "linear"),
                     ("linear_interp_v2", "linear")):
    _INFER_RULES[_name] = _rule_interp(_mode)
for _name in ("maximum", "minimum"):
    _INFER_RULES[_name] = _rule_elementwise
for _name in _SAME_SHAPE_OPS:
    _INFER_RULES[_name] = _rule_unary
for _name in ("elementwise_add", "elementwise_sub", "elementwise_mul",
              "elementwise_div", "elementwise_max", "elementwise_min",
              "elementwise_pow", "elementwise_mod", "elementwise_floordiv"):
    _INFER_RULES[_name] = _rule_elementwise
for _name in ("less_than", "less_equal", "greater_than", "greater_equal",
              "equal", "not_equal", "logical_and", "logical_or",
              "logical_xor"):
    _INFER_RULES[_name] = _rule_compare
for _name in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
              "reduce_prod"):
    _INFER_RULES[_name] = _rule_reduce


# -- pass-relevant op families (PR 11 satellite): conv/pool/transpose
#    variants the fusion+layout passes rewrite, matmul variants, scalar
#    reductions, fills, and data movement.  Every rule mirrors its
#    registered lowering (static/ops*.py) — shapes first, declared-dtype
#    fallback where the lowering preserves input dtype. ----------------------

def _tuplen(v, n):
    """Scalar-or-sequence attr -> n-tuple (the F.* layer convention)."""
    if v is None:
        return (0,) * n
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    return t * n if len(t) == 1 else t


def _deconv_spatial(size, k, s, p, d=1, op_=0):
    if not _known(size):
        return Sym("deconv")
    return (int(size) - 1) * s - 2 * p + d * (k - 1) + 1 + op_


def _rule_conv_nd(spatial, transpose=False):
    """conv3d / conv*_transpose: filter (O, I/g, *k) — transposed filters
    are (I, O/g, *k), so out channels = w[1] * groups."""
    def rule(ctx):
        x, w = ctx.in_shape("Input"), ctx.in_shape("Filter")
        rank = 2 + spatial
        if x is None or w is None or len(x) != rank or len(w) != rank:
            ctx.set_out("Output", None, ctx.in_dtype("Input"))
            return
        if not all(_known(w[2 + i]) for i in range(spatial)):
            ctx.set_out("Output", None, ctx.in_dtype("Input"))
            return
        st = _tuplen(ctx.attr("strides", 1), spatial)
        pd = _tuplen(ctx.attr("paddings", 0), spatial)
        dl = _tuplen(ctx.attr("dilations", 1), spatial)
        if transpose:
            g = ctx.attr("groups", 0) or (
                int(x[1]) if _known(x[1]) else None)
            op_ = _tuplen(ctx.attr("output_padding", 0), spatial)
            ch = int(w[1]) * int(g) if g and _known(w[1]) else Sym("deconv_c")
            dims = tuple(_deconv_spatial(x[2 + i], int(w[2 + i]), st[i],
                                         pd[i], dl[i], op_[i])
                         for i in range(spatial))
        else:
            ch = w[0]
            dims = tuple(_conv_spatial(x[2 + i], int(w[2 + i]), st[i],
                                       pd[i], dl[i])
                         for i in range(spatial))
        ctx.set_out("Output", (x[0], ch) + dims, ctx.in_dtype("Input"))

    return rule


def _rule_pool3d(ctx):
    x = ctx.in_shape("X")
    if x is None or len(x) != 5:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    if ctx.attr("global_pooling", False):
        ctx.set_out("Out", (x[0], x[1], 1, 1, 1), ctx.in_dtype("X"))
        return
    ks = _tuplen(ctx.attr("ksize", 1), 3)
    st = _tuplen(ctx.attr("strides", None), 3) if ctx.attr("strides") else ks
    pd = _tuplen(ctx.attr("paddings", 0), 3)
    dims = tuple(_conv_spatial(x[2 + i], ks[i], st[i], pd[i])
                 for i in range(3))
    ctx.set_out("Out", (x[0], x[1]) + dims, ctx.in_dtype("X"))


def _rule_pool_with_index(spatial):
    def rule(ctx):
        x = ctx.in_shape("X")
        rank = 2 + spatial
        if x is None or len(x) != rank:
            ctx.set_out("Out", None, ctx.in_dtype("X"))
            ctx.set_out("Mask", None)
            return
        ks = _tuplen(ctx.attr("ksize", 1), spatial)
        st = _tuplen(ctx.attr("strides", None), spatial) \
            if ctx.attr("strides") else ks
        pd = _tuplen(ctx.attr("paddings", 0), spatial)
        dims = tuple(_conv_spatial(x[2 + i], ks[i], st[i], pd[i])
                     for i in range(spatial))
        out = (x[0], x[1]) + dims
        ctx.set_out("Out", out, ctx.in_dtype("X"))
        ctx.set_out("Mask", out)

    return rule


def _rule_unfold(ctx):
    x = ctx.in_shape("X")
    if x is None or len(x) != 4:
        ctx.set_out("Y", None, ctx.in_dtype("X"))
        return
    kh, kw = _tuplen(ctx.attr("kernel_sizes"), 2)
    sh, sw = _tuplen(ctx.attr("strides", 1), 2)
    dh, dw = _tuplen(ctx.attr("dilations", 1), 2)
    p = list(ctx.attr("paddings", (0, 0, 0, 0)))
    if len(p) == 2:
        pads = (p[0], p[1])
    else:                    # (up, left, down, right): symmetric sums halved
        pads = None
    c = int(x[1]) if _known(x[1]) else None
    if pads is not None:
        ho = _conv_spatial(x[2], kh, sh, pads[0], dh)
        wo = _conv_spatial(x[3], kw, sw, pads[1], dw)
        length = (int(ho) * int(wo)
                  if _known(ho) and _known(wo) else Sym("unfold"))
    else:
        length = Sym("unfold")
    ctx.set_out("Y", (x[0], c * kh * kw if c else Sym("unfold_c"), length),
                ctx.in_dtype("X"))


def _rule_pad3d(ctx):
    x, p = ctx.in_shape("X"), ctx.attr("paddings")
    out = None
    if x is not None and len(x) == 5 and p is not None and len(p) >= 6:
        # NCDHW with paddings (l, r, t, b, front, back)
        out = (x[0], x[1], _bdim(x[2], int(p[4]) + int(p[5])),
               _bdim(x[3], int(p[2]) + int(p[3])),
               _bdim(x[4], int(p[0]) + int(p[1])))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_spp(ctx):
    x, h = ctx.in_shape("X"), ctx.attr("pyramid_height")
    out = None
    if x is not None and len(x) == 4 and h:
        c = x[1]
        feat = (int(c) * (4 ** int(h) - 1) // 3 if _known(c)
                else Sym("spp"))
        out = (x[0], feat)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_pixel_shuffle(ctx):
    x, r = ctx.in_shape("X"), ctx.attr("upscale_factor")
    out = None
    if x is not None and len(x) == 4 and r:
        r = int(r)
        c = int(x[1]) // (r * r) if _known(x[1]) else Sym("pxs")
        out = (x[0], c, _scaled(x[2], r), _scaled(x[3], r))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _scaled(d, mult):
    return int(d) * mult if _known(d) else Sym("scaled")


def _rule_space_to_depth(ctx):
    x, b = ctx.in_shape("X"), ctx.attr("blocksize")
    out = None
    if x is not None and len(x) == 4 and b:
        b = int(b)
        c = int(x[1]) * b * b if _known(x[1]) else Sym("s2d")
        h = int(x[2]) // b if _known(x[2]) else Sym("s2d")
        w = int(x[3]) // b if _known(x[3]) else Sym("s2d")
        out = (x[0], c, h, w)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_dot(ctx):
    x = ctx.in_shape("X")
    ctx.set_out("Out", tuple(x[:-1]) if x is not None and len(x) else None,
                ctx.in_dtype("X"))


def _rule_addmm(ctx):
    x, y = ctx.in_shape("X"), ctx.in_shape("Y")
    out = None
    if x is not None and y is not None and len(x) == 2 and len(y) == 2:
        out = (x[0], y[1])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_batch_fc(ctx):
    x, w = ctx.in_shape("Input"), ctx.in_shape("W")
    out = None
    if x is not None and w is not None and len(x) == 3 and len(w) == 3:
        out = (x[0], x[1], w[2])
    ctx.set_out("Out", out, ctx.in_dtype("Input"))


def _rule_bilinear_tp(ctx):
    x, w = ctx.in_shape("X"), ctx.in_shape("Weight")
    out = None
    if x is not None and w is not None and len(x) == 2 and len(w) == 3:
        out = (x[0], w[0])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_scalar(out_slot="Out", dtype=None):
    def rule(ctx):
        ctx.set_out(out_slot, (),
                    dtype if dtype is not None else ctx.in_dtype("X"))

    return rule


def _rule_keepdim_reduce(axis_attr, keep_attr):
    """logsumexp/frobenius_norm-style: axis list attr or all-dims."""
    def rule(ctx):
        x = ctx.in_shape("X")
        if x is None or not len(x):
            ctx.set_out("Out", None if x is None else (), ctx.in_dtype("X"))
            return
        ax = ctx.attr(axis_attr)
        dims = set(range(len(x))) if not ax else \
            {int(d) % len(x) for d in
             ((ax,) if isinstance(ax, (int, np.integer)) else tuple(ax))}
        if ctx.attr(keep_attr, False):
            out = tuple(1 if i in dims else d for i, d in enumerate(x))
        else:
            out = tuple(d for i, d in enumerate(x) if i not in dims)
        ctx.set_out("Out", out, ctx.in_dtype("X"))

    return rule


def _rule_p_norm(ctx):
    x = ctx.in_shape("X")
    if x is None:
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    ax = ctx.attr("axis")
    keep = ctx.attr("keepdim", False)
    if ax is None:                       # ravel() then reduce axis 0
        ctx.set_out("Out", (1,) if keep else (), ctx.in_dtype("X"))
        return
    dims = {int(ax) % len(x)} if len(x) else set()
    out = tuple(1 if i in dims else d for i, d in enumerate(x)) if keep \
        else tuple(d for i, d in enumerate(x) if i not in dims)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_trace_op(ctx):
    x = ctx.in_shape("Input")
    out = None
    if x is not None and len(x) >= 2:
        a1 = int(ctx.attr("axis1", 0)) % len(x)
        a2 = int(ctx.attr("axis2", 1)) % len(x)
        out = tuple(d for i, d in enumerate(x) if i not in (a1, a2))
    ctx.set_out("Out", out, ctx.in_dtype("Input"))


def _rule_histogram(ctx):
    ctx.set_out("Out", (int(ctx.attr("bins", 100)),), _np_dtype(np.int64))


def _rule_eye(ctx):
    rows = ctx.attr("num_rows")
    if rows is None:
        return
    cols = int(ctx.attr("num_columns", -1) or -1)
    out = (int(rows), cols if cols > 0 else int(rows))
    ctx.set_out("Out", out, _attr_dtype(ctx, "float32"))


def _attr_dtype(ctx, default=None):
    dt = ctx.attr("dtype", default)
    try:
        return _np_dtype(dt) if dt is not None else None
    except TypeError:
        return None


def _rule_fill_values(ctx):
    shape = ctx.attr("shape")
    ctx.set_out("Out",
                None if shape is None else tuple(int(d) for d in shape),
                _attr_dtype(ctx, "float32"))


def _rule_diag(ctx):
    x = ctx.in_shape("Diagonal")
    out = None
    if x is not None and len(x) == 1 and _known(x[0]):
        out = (int(x[0]), int(x[0]))
    ctx.set_out("Out", out, ctx.in_dtype("Diagonal"))


def _rule_diag_v2(ctx):
    x = ctx.in_shape("X")
    off = abs(int(ctx.attr("offset", 0)))
    out = None
    if x is not None and len(x) == 1:
        n = int(x[0]) + off if _known(x[0]) else Sym("diag")
        out = (n, n)
    elif x is not None and len(x) == 2:
        out = None                      # diagonal length: declared fallback
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_diag_embed(ctx):
    x = ctx.in_shape("X")
    out = None
    if (x is not None and len(x) >= 1
            and int(ctx.attr("dim1", -2)) == -2
            and int(ctx.attr("dim2", -1)) == -1):
        off = abs(int(ctx.attr("offset", 0)))
        n = int(x[-1]) + off if _known(x[-1]) else Sym("diag")
        out = tuple(x[:-1]) + (n, n)
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_randperm(ctx):
    n = ctx.attr("n")
    ctx.set_out("Out", (int(n),) if n else None,
                _attr_dtype(ctx, "int64"))


def _rule_linspace(ctx):
    num = ctx.attr("num")
    ctx.set_out("Out", (int(num),) if num else (Sym("linspace"),),
                _attr_dtype(ctx, "float32"))


def _rule_range_op(ctx):
    # bounds are value-dependent: rank/dtype only
    ctx.set_out("Out", (Sym("range"),), ctx.in_dtype("Start"))


def _rule_meshgrid(ctx):
    n = ctx.n_inputs("X")
    shapes = [ctx.in_shape("X", i) for i in range(n)]
    if any(s is None or len(s) != 1 for s in shapes):
        return
    grid = tuple(s[0] for s in shapes)
    for i in range(len(ctx.op.outputs.get("Out", ()))):
        ctx.set_out("Out", grid, ctx.in_dtype("X", min(i, n - 1)), i=i)


def _rule_split(ctx):
    x = ctx.in_shape("X")
    outs = ctx.op.outputs.get("Out", ())
    if x is None or not len(x):
        for i in range(len(outs)):
            ctx.set_out("Out", None, ctx.in_dtype("X"), i=i)
        return
    axis = int(ctx.attr("axis", 0)) % len(x)
    num = ctx.attr("num", 0)
    sections = ctx.attr("sections")
    for i in range(len(outs)):
        out = list(x)
        if sections:
            out[axis] = int(sections[i]) if i < len(sections) else None
        elif num:
            out[axis] = (int(x[axis]) // int(num) if _known(x[axis])
                         else Sym("split"))
        else:
            out[axis] = Sym("split")
        ctx.set_out("Out", tuple(out), ctx.in_dtype("X"), i=i)


def _rule_flatten_range(ctx):
    x = ctx.in_shape("X")
    if x is None or not len(x):
        ctx.set_out("Out", None, ctx.in_dtype("X"))
        return
    start = int(ctx.attr("start_axis", 1)) % len(x)
    stop = int(ctx.attr("stop_axis", -1)) % len(x)
    mid = x[start:stop + 1]
    flat = int(np.prod([int(d) for d in mid])) \
        if all(_known(d) for d in mid) else Sym("flatten")
    ctx.set_out("Out", tuple(x[:start]) + (flat,) + tuple(x[stop + 1:]),
                ctx.in_dtype("X"))


def _rule_gather_nd(ctx):
    x, idx = ctx.in_shape("X"), ctx.in_shape("Index")
    out = None
    if (x is not None and idx is not None and len(idx) >= 1
            and _known(idx[-1]) and int(idx[-1]) <= len(x)):
        out = tuple(idx[:-1]) + tuple(x[int(idx[-1]):])
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_sequence_mask(ctx):
    x, maxlen = ctx.in_shape("X"), ctx.attr("maxlen")
    out = None
    if x is not None and maxlen:
        out = tuple(x) + (int(maxlen),)
    ctx.set_out("Y", out)


def _rule_multiplex(ctx):
    ctx.set_out("Out", ctx.in_shape("X", 0), ctx.in_dtype("X", 0))


def _rule_quant_cast(dtype):
    def rule(ctx):
        ctx.set_out("Output", ctx.in_shape("Input"), _np_dtype(dtype))

    return rule


_INFER_RULES.update({
    # conv/pool variants (the layout + fusion pass families)
    "conv3d": _rule_conv_nd(3),
    "conv2d_transpose": _rule_conv_nd(2, transpose=True),
    "depthwise_conv2d_transpose": _rule_conv_nd(2, transpose=True),
    "conv3d_transpose": _rule_conv_nd(3, transpose=True),
    "pool3d": _rule_pool3d,
    "max_pool2d_with_index": _rule_pool_with_index(2),
    "max_pool3d_with_index": _rule_pool_with_index(3),
    "unfold": _rule_unfold,
    "pad3d": _rule_pad3d,
    "spp": _rule_spp,
    "pixel_shuffle": _rule_pixel_shuffle,
    "space_to_depth": _rule_space_to_depth,
    # BN/affine/channel-wise variants: value-wise in X
    "sync_batch_norm": _rule_same_as("X", "Y"),
    "affine_channel": _rule_same_as("X", "Out"),
    "temporal_shift": _rule_same_as("X", "Out"),
    "shuffle_channel": _rule_same_as("X", "Out"),
    "lrn": _rule_same_as("X", "Out"),
    "spectral_norm": _rule_same_as("Weight", "Out"),
    "conv_shift": _rule_same_as("X", "Out"),
    "pad_constant_like": _rule_same_as("X", "Out"),
    "lod_reset": _rule_same_as("X", "Out"),
    "fill_zeros_like2": _rule_same_as("X", "Out"),
    "cvm": _rule_same_as("X", "Y"),
    # collectives: shape-preserving on every member
    "allreduce": _rule_same_as("X", "Out"),
    "broadcast": _rule_same_as("X", "Out"),
    "c_broadcast": _rule_same_as("X", "Out"),
    "c_reduce_sum": _rule_same_as("X", "Out"),
    "c_reduce_max": _rule_same_as("X", "Out"),
    "c_reduce_min": _rule_same_as("X", "Out"),
    "c_reduce_prod": _rule_same_as("X", "Out"),
    # matmul variants
    "dot": _rule_dot,
    "addmm": _rule_addmm,
    "batch_fc": _rule_batch_fc,
    "bilinear_tensor_product": _rule_bilinear_tp,
    "cos_sim": _rule_keepdim_batch("Out"),
    "minus": _rule_elementwise,
    "smooth_l1": _rule_keepdim_batch("Out", extra_slots=("Diff",)),
    "squared_l2_distance": _rule_keepdim_batch(
        "Out", extra_slots=("sub_result",)),
    "rank_loss": _rule_same_as("Label", "Out"),
    # reductions to scalars / reduced shapes
    "reduce_all": _rule_reduce,
    "reduce_any": _rule_reduce,
    "logsumexp": _rule_keepdim_reduce("axis", "keepdim"),
    "frobenius_norm": _rule_keepdim_reduce("dim", "keep_dim"),
    "p_norm": _rule_p_norm,
    "l1_norm": _rule_scalar(),
    "dist": _rule_scalar(),
    "allclose": _rule_scalar(dtype=_np_dtype(np.bool_)),
    "trace": _rule_trace_op,
    "histogram": _rule_histogram,
    # fills / generators
    "eye": _rule_eye,
    "fill": _rule_fill_values,
    "assign_value": _rule_fill_values,
    "diag": _rule_diag,
    "diag_v2": _rule_diag_v2,
    "diag_embed": _rule_diag_embed,
    "randint": _rule_fill_values,
    "randperm": _rule_randperm,
    "linspace": _rule_linspace,
    "range": _rule_range_op,
    "meshgrid": _rule_meshgrid,
    # data movement
    "split": _rule_split,
    "flatten_contiguous_range": _rule_flatten_range,
    "gather_nd": _rule_gather_nd,
    "sequence_mask": _rule_sequence_mask,
    "multiplex": _rule_multiplex,
    # int8 deployment path
    "quantize": _rule_quant_cast(np.int8),
    "dequantize": _rule_quant_cast(np.float32),
    "requantize": _rule_quant_cast(np.int8),
    # pass-emitted fused ops (static/passes.py): the fusion absorbs only
    # value-wise act + channel-wise BN / 1-D bias, so the output contract
    # is exactly the anchor op's (conv2d / mul respectively)
    "fused_conv2d_bn_act": _rule_conv2d,
    "fused_matmul_bias_act": _rule_mul,
    # quant_infer-emitted int8 inference ops (static/passes.py): int8
    # compute is internal, the op's IO contract is the float anchor's
    "quant_conv2d": _rule_conv2d,
    "quant_mul": _rule_mul,
})


# -- QAT fake-quant family (static/ops_tail.py): value-wise passthrough
#    (the quantized carrier keeps X's float dtype) plus a scale output ------

def _rule_fake_quant(ctx):
    x, dt = ctx.in_shape("X"), ctx.in_dtype("X")
    ctx.set_out("Out", x, dt)
    ctx.set_out("OutScale", (1,), dt)


def _rule_fake_quant_channel(ctx):
    """Channel-wise variants: OutScale has one entry per quant_axis slice."""
    x, dt = ctx.in_shape("X"), ctx.in_dtype("X")
    ctx.set_out("Out", x, dt)
    c = None
    if x is not None and len(x):
        c = x[int(ctx.attr("quant_axis", 0)) % len(x)]
    ctx.set_out("OutScale", None if c is None else (c,), dt)


def _rule_roi(ctx):
    """roi_align / roi_pool (static/ops.py): (R, C, ph, pw) where R is the
    ROI count and C is X's channel dim ((1,C,H,W) or (C,H,W))."""
    x, rois = ctx.in_shape("X"), ctx.in_shape("ROIs")
    out = None
    if x is not None and rois is not None and len(x) >= 3:
        c = x[1] if len(x) == 4 else x[0]
        out = (rois[0], c, int(ctx.attr("pooled_height", 1)),
               int(ctx.attr("pooled_width", 1)))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_grid_sampler(ctx):
    """Output spatial dims come from Grid (N, Hg, Wg, 2), channels from X."""
    x, g = ctx.in_shape("X"), ctx.in_shape("Grid")
    out = None
    if x is not None and g is not None and len(x) == 4 and len(g) == 4:
        out = (x[0], x[1], g[1], g[2])
    ctx.set_out("Output", out, ctx.in_dtype("X"))


def _rule_affine_grid(ctx):
    os = ctx.attr("output_shape")
    out = None
    if os is not None and len(os) == 4 and all(int(d) > 0 for d in os):
        out = (int(os[0]), int(os[2]), int(os[3]), 2)
    elif (th := ctx.in_shape("Theta")) is not None and len(th) == 3:
        out = (th[0], None, None, 2) if _known(th[0]) else None
    ctx.set_out("Output", out, ctx.in_dtype("Theta"))


def _rule_nll_loss(ctx):
    x, red = ctx.in_shape("X"), ctx.attr("reduction", "mean")
    out = None
    if x is not None:
        out = (x[0],) if red == "none" else ()
    ctx.set_out("Out", out, ctx.in_dtype("X"))
    ctx.set_out("Total_weight", (), _np_dtype(np.float32))


def _rule_mean_iou(ctx):
    k = ctx.attr("num_classes")
    kshape = None if not k else (int(k),)
    ctx.set_out("OutMeanIou", (), _np_dtype(np.float32))
    ctx.set_out("OutWrong", kshape, _np_dtype(np.float32))
    ctx.set_out("OutCorrect", kshape, _np_dtype(np.float32))


def _rule_unique_padded(ctx):
    """unique / unique_with_counts (static/ops_tail4.py): static-shape
    lowering pads Out/Index/Count(s) to len(X); ValidCount is scalar."""
    x = ctx.in_shape("X")
    idt = _np_dtype(np.int64 if int(ctx.attr("dtype", 3)) == 3 else np.int32)
    ctx.set_out("Out", x, ctx.in_dtype("X"))
    for slot in ("Index", "Counts", "Count"):
        ctx.set_out(slot, x, idt)
    ctx.set_out("ValidCount", (), idt)


def _rule_where_index(ctx):
    """where_index (nonzero): padded (numel, rank) int64 + ValidCount."""
    x = ctx.in_shape("X")
    out = None
    if x is not None:
        if all(_known(d) for d in x):
            n = 1
            for d in x:
                n *= int(d)
            out = (n, max(1, len(x)))
        elif len(x) == 1:
            out = (x[0], 1)
    ctx.set_out("Out", out, _np_dtype(np.int64))
    ctx.set_out("ValidCount", (), _np_dtype(np.int64))


def _rule_amp_check(ctx):
    """amp_check_finite_and_scale: Out list mirrors the X list; the found-
    infinite flag is a (1,) bool."""
    for i in range(ctx.n_inputs("X")):
        ctx.set_out("Out", ctx.in_shape("X", i), ctx.in_dtype("X", i), i=i)
    ctx.set_out("FoundInfinite", (1,), _np_dtype(np.bool_))


def _rule_edit_distance(ctx):
    h = ctx.in_shape("Hyps")
    ctx.set_out("Out", None if h is None else (h[0], 1),
                _np_dtype(np.float32))
    ctx.set_out("SequenceNum", (1,), _np_dtype(np.int32))


def _rule_kron(ctx):
    x, y = ctx.in_shape("X"), ctx.in_shape("Y")
    out = None
    if (x is not None and y is not None and len(x) == len(y)
            and all(_known(d) for d in x) and all(_known(d) for d in y)):
        out = tuple(int(a) * int(b) for a, b in zip(x, y))
    ctx.set_out("Out", out, ctx.in_dtype("X"))


def _rule_batch_column(out_slot, in_slot="X"):
    """Per-example losses that emit a (B, 1) column from a (B, C) input."""
    def rule(ctx):
        x = ctx.in_shape(in_slot)
        ctx.set_out(out_slot, None if x is None or not len(x) else (x[0], 1),
                    ctx.in_dtype(in_slot))

    return rule


def _rule_modified_huber(ctx):
    x, dt = ctx.in_shape("X"), ctx.in_dtype("X")
    ctx.set_out("IntermediateVal", x, dt)
    ctx.set_out("Out", x, dt)


_INFER_RULES.update({
    # QAT fake-quant / dequant (static/ops_tail.py, ops_tail5.py)
    "fake_quantize_abs_max": _rule_fake_quant,
    "fake_quantize_dequantize_abs_max": _rule_fake_quant,
    "fake_quantize_moving_average_abs_max": _rule_fake_quant,
    "fake_quantize_dequantize_moving_average_abs_max": _rule_fake_quant,
    "fake_quantize_range_abs_max": _rule_fake_quant,
    "moving_average_abs_max_scale": _rule_fake_quant,
    "fake_channel_wise_quantize_abs_max": _rule_fake_quant_channel,
    "fake_channel_wise_quantize_dequantize_abs_max":
        _rule_fake_quant_channel,
    "fake_quantize_dequantize_fixed_scale": _rule_unary,
    "fake_dequantize_max_abs": _rule_same_as(
        "X", "Out", dtype=_np_dtype(np.float32)),
    "dequantize_abs_max": _rule_same_as(
        "X", "Out", dtype=_np_dtype(np.float32)),
    "fake_channel_wise_dequantize_max_abs": _rule_same_as(
        "X", "Out", dtype=_np_dtype(np.float32)),
    "dequantize_log": _rule_same_as(
        "X", "Out", dtype=_np_dtype(np.float32)),
    # value-wise tails (verified against their lowerings)
    "row_conv": _rule_unary,
    "add_position_encoding": _rule_unary,
    "cross": _rule_unary,
    "cholesky": _rule_unary,
    "sigmoid_focal_loss": _rule_unary,
    "print": _rule_same_as("In", "Out"),
    "gather_tree": _rule_same_as("Ids", "Out"),
    "modified_huber_loss": _rule_modified_huber,
    "index_sample": _rule_same_as("Index", "Out"),
    # scalars / fixed shapes
    "is_empty": _rule_scalar(dtype=_np_dtype(np.bool_)),
    "isfinite": lambda ctx: ctx.set_out("Out", (1,), _np_dtype(np.bool_)),
    "seed": lambda ctx: ctx.set_out("Out", (1,), _np_dtype(np.int32)),
    # losses
    "bpr_loss": _rule_batch_column("Y"),
    "teacher_student_sigmoid_loss": _rule_batch_column("Y"),
    "nll_loss": _rule_nll_loss,
    "mean_iou": _rule_mean_iou,
    "edit_distance": _rule_edit_distance,
    # search / movement with static-shape (padded) lowerings
    "unique": _rule_unique_padded,
    "unique_with_counts": _rule_unique_padded,
    "where_index": _rule_where_index,
    # masked_select's length is data-dependent: propagate dtype only
    "masked_select": lambda ctx: ctx.set_out("Y", None, ctx.in_dtype("X")),
    "amp_check_finite_and_scale": _rule_amp_check,
    # vision
    "roi_align": _rule_roi,
    "roi_pool": _rule_roi,
    "grid_sampler": _rule_grid_sampler,
    "affine_grid": _rule_affine_grid,
    # math
    "kron": _rule_kron,
})


def shape_rule_coverage() -> Dict[str, object]:
    """Declared engine coverage over the registered op set: which ops have
    a forward inference rule and/or a PV009 plausibility checker.  The
    uncovered list is the worklist — an uncovered op degrades gracefully
    (declared shapes), it does not go unchecked for dataflow/registry."""
    from . import executor as _executor  # noqa: F401 — registers every op
    from .registry import registered_ops

    registered = set(registered_ops())
    inferred = set(_INFER_RULES) & registered
    checked = set(_SHAPE_CHECKERS) & registered
    covered = inferred | checked
    return {
        "registered": len(registered),
        "inference_rules": len(inferred),
        "plausibility_checkers": len(checked),
        "covered": len(covered),
        "coverage": round(len(covered) / max(1, len(registered)), 4),
        "uncovered": sorted(registered - covered),
    }


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def verify_program(program: Program, startup: Optional[Program] = None,
                   feed_names: Optional[Sequence[str]] = None,
                   fetch_names: Optional[Sequence[str]] = None
                   ) -> List[Diagnostic]:
    """Statically verify `program`; returns all diagnostics (errors and
    warnings).  Supplying `startup` additionally checks persistable
    initialization coverage (PV008); supplying `feed_names`/`fetch_names`
    narrows the feed assumption / marks fetches as reads."""
    diags, _engine = infer_program(program, startup, feed_names, fetch_names)
    return diags


def infer_program(program: Program, startup: Optional[Program] = None,
                  feed_names: Optional[Sequence[str]] = None,
                  fetch_names: Optional[Sequence[str]] = None):
    """verify_program, additionally returning the populated ``_ShapeEnv``
    (propagated shapes/dtypes, sub-block findings) — the input to the
    sharding-plan verifier in static/shardcheck.py."""
    v = _Verifier(program, startup, feed_names, fetch_names)
    diags = v.run()
    _m_programs_checked.inc()
    for d in diags:
        _m_violations.inc(code=d.code)
    return diags, v.engine


def check_program(program: Program, startup: Optional[Program] = None,
                  feed_names: Optional[Sequence[str]] = None,
                  fetch_names: Optional[Sequence[str]] = None
                  ) -> List[Diagnostic]:
    """verify_program + raise ``ProgramVerificationError`` carrying the
    structured diagnostics when any error-severity finding exists.  Returns
    the (warning-only) diagnostics otherwise."""
    diags = verify_program(program, startup, feed_names, fetch_names)
    errs = [d for d in diags if d.severity == "error"]
    if errs:
        raise _errors.ProgramVerificationError(
            "program verification failed (set "
            "PDTPU_FLAGS_check_program=0 to bypass):\n"
            + _errors.render_diagnostics(errs), diagnostics=errs)
    return diags


# ---------------------------------------------------------------------------
# Memoized Executor entry point + session log.
# ---------------------------------------------------------------------------

_memo_lock = threading.Lock()
# weakrefs to every Program that PASSED a cached check, with the version it
# passed at — tests/conftest.py re-verifies these at session end
_PASSED_PROGRAMS: List[tuple] = []


def check_program_cached(program: Program,
                         feed_names: Optional[Sequence[str]] = None,
                         fetch_names: Optional[Sequence[str]] = None
                         ) -> List[Diagnostic]:
    """check_program memoized by (program._version, feed-name set, fetch
    tuple) on the Program object itself (the memo dies with the program and
    invalidates on any mutation — Program bumps ``_version`` in append_op/
    create_var).  Serving buckets of one program share a single walk; a
    cold Executor.run of an already-checked program re-walks nothing.
    Failures are not memoized (they raise, and the build aborts anyway)."""
    key = (program._version,
           None if feed_names is None else frozenset(feed_names),
           tuple(fetch_names or ()))
    with _memo_lock:
        memo = getattr(program, "_analysis_memo", None)
        if memo is None:
            memo = program._analysis_memo = {}
        hit = memo.get(key)
    if hit is not None:
        return hit
    diags = check_program(program, feed_names=feed_names,
                          fetch_names=fetch_names)
    with _memo_lock:
        memo[key] = diags
        _PASSED_PROGRAMS.append(
            (weakref.ref(program), program._version, key[1], key[2]))
    return diags


def session_passed_programs():
    """Live (program, version, feed_names, fetch_names) tuples for every
    program that passed ``check_program_cached`` and is still alive —
    consumed by the test suite's end-of-session re-verification."""
    out = []
    with _memo_lock:
        entries = list(_PASSED_PROGRAMS)
    for ref, version, feeds, fetches in entries:
        prog = ref()
        if prog is not None:
            out.append((prog, version, feeds, fetches))
    return out
