"""Static-graph Executor: run a Program op by op on torch tensors
(counterpart of paddle_tpu/static/executor.py).

Reference parity: ``Executor::Run`` (paddle/fluid/framework/executor.cc:180)
interprets the block sequentially, op by op, with per-op kernel dispatch;
python side fluid/executor.py with feed/fetch injection and a prepared-
context cache.  The JAX package traces the block into one jitted XLA
computation instead; the port interprets it as the reference does, each
op's lowering rule (static/registry.py) running eagerly on the Executor's
device, so the kernel wrappers launch from the lowerings.

Per ``(program, version, feed names, fetch names, opt_passes value)`` the
Executor keeps the program it runs: the caller's, or the pass pipeline's
rewrite of it (static/passes.py) when ``opt_passes`` is on.  State is every
persistable variable (parameters, BN statistics, optimizer slots): read
from the scope before the walk, written back after it, detached.  Random
ops (and ``dpsgd``'s noise) draw from a CPU ``torch.Generator`` seeded from
the program's ``random_seed``, the run's step and the op's salt, so a
rewrite that keeps salts keeps draws.

``backward_region`` (static/backward.py) is torch autograd over the walk
itself: the JAX package replays the ops before the region as a pure
function of the differentiated values and takes ``jax.grad``; the port
runs those ops with autograd on, the tensors bound to the region's
``Params`` made gradient leaves where they are first bound (scope reads
for parameters, feeds for data variables, an op's output as produced for
an intermediate, whose gradient is then taken through its consumers with
its producer held fixed, as the JAX replay's frozen injection does).  The
region is ``torch.autograd.grad`` of ``sum(fp32(loss))`` over its
``Loss`` names.  Every tensor is detached after the last region, so no
graph outlives it, and the ops after it (the optimizer updates) run
without autograd.

Control flow (``conditional_block``, ``while``, ``static_rnn``, built by
static/control_flow.py) runs its sub-blocks op by op as well, on a snapshot
of the enclosing environment, as the JAX package's ``lax.cond`` /
``lax.while_loop`` / ``lax.scan`` lowerings read it.  The branch choice
and the loop test read a device scalar on the host each time, and
``static_rnn`` is a Python loop over the time-major leading axis.  A random
op inside a sub-block draws under the salt of its (block, op index), so,
as in the JAX package, it draws the same values at every iteration of a
step.  Gradients through ``conditional_block`` and ``static_rnn`` are
torch autograd over the sub-block ops that actually ran.

Before the first op of a new entry, under the ``check_program`` flag, the
program verifier (static/analysis.py, PV001-PV010) walks the caller's
program, memoized by program version x feed/fetch signature, and raises
``ProgramVerificationError`` on an error.  Under ``check_memory`` the
static peak-memory verifier (static/memcheck.py) prices each new feed-shape
signature before any feed moves to the device: a predicted OOM (MC001)
raises with nothing allocated, and the estimate is the
``executor.predicted_peak_bytes`` gauge.

The walk releases each intermediate after its last reader: ``env`` drops a
name once no later op of block 0 reads it (a sub-block's free reads and
the names its lowering returns count as reads of the carrying op), so the
card holds the step's live set, the quantity memcheck prices, rather than
every intermediate of the step.  Fetches, feeds and persistable state are
kept; what a backward region saves, autograd keeps.

Not ported yet (ROADMAP): tracing into one graph, state donation, sharding
plans (the ``check_sharding`` hook comes with them) and the persistent
compile cache.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import dtype as _dtype
from ..core import errors as _errors
from ..core import flags as _flags
from ..core import random as _random
from ..core.device import resolve_device
from ..utils import monitor as _monitor
from . import ops as _ops
from . import ops_fused as _ops_fused  # noqa: F401 — registers lowerings
from . import ops_tail as _ops_tail  # noqa: F401 — registers lowerings
from . import ops_tail2 as _ops_tail2  # noqa: F401 — registers lowerings
from . import ops_tail3 as _ops_tail3  # noqa: F401 — registers lowerings
from . import ops_tail4 as _ops_tail4  # noqa: F401 — registers lowerings
from . import ops_tail5 as _ops_tail5  # noqa: F401 — registers lowerings
from . import ops_tail6 as _ops_tail6  # noqa: F401 — registers lowerings
from . import ops_tail7 as _ops_tail7  # noqa: F401 — registers lowerings
from .framework import Program, Variable, default_main_program
from .registry import get_lowering

__all__ = ["Scope", "global_scope", "scope_guard", "Executor", "to_numpy"]

# Odd 64-bit constants mixing (seed, step, salt) into a random op's seed.
_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)

# Ops that draw but are not RANDOM_OPS in either package's passes: an
# optimizer update (it writes state, so no pass folds, merges or drops it),
# sampled softmax's negatives and the detection / TDM samplers.
_DRAWING_OPS = frozenset({"dpsgd", "sample_logits", "rpn_target_assign",
                          "generate_proposal_labels", "tdm_sampler"})


class Scope:
    """Name -> value store for persistables (ref framework/scope.h:46).

    Hierarchical like the reference: ``new_scope()`` creates a child whose
    lookups fall through to ancestors; writes always land in the scope they
    are issued on.  Values are torch tensors once an Executor has written
    them; a caller may set numpy arrays, which the Executor moves to its
    device when it reads them."""

    def __init__(self, parent: "Optional[Scope]" = None):
        self._vars: Dict[str, Any] = {}
        self._parent = parent
        self._kids: List["Scope"] = []

    def new_scope(self) -> "Scope":
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    @property
    def parent(self) -> "Optional[Scope]":
        return self._parent

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        return None

    def local_var(self, name: str):
        """Lookup without falling through to ancestors."""
        return self._vars.get(name)

    def var(self, name: str):
        return self._vars.setdefault(name, None)

    def set(self, name: str, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()

    def drop_kids(self):
        """ref Scope::DropKids."""
        self._kids.clear()

    def drop(self):
        self._vars.clear()
        self._kids.clear()


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


class scope_guard:
    """ref fluid/executor.py scope_guard."""

    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _scope_stack.pop()


def to_numpy(value) -> np.ndarray:
    """A scope or fetch value as a numpy array (bf16 as float32)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def _op_salt(block_idx: int, op_idx: int) -> int:
    return block_idx * 65536 + op_idx


def _grad_leaf(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a tensor the region can differentiate with respect to: a
    fresh leaf unless it already carries gradient."""
    return t if t.requires_grad else t.detach().requires_grad_()


def _backward_region(op, env, leaves, retain_graph: bool) -> None:
    """``Grads`` = d sum(fp32(loss)) / d ``Params`` (a value the loss does
    not reach gets zeros, as under ``jax.grad``)."""
    losses = [env[n] for n in op.inputs["Loss"]]
    wrt = [leaves[n] for n in op.inputs["Params"]]
    total = sum(t.float().sum() for t in losses)
    grads = [None] * len(wrt)
    if total.requires_grad:
        grads = torch.autograd.grad(total, wrt, retain_graph=retain_graph,
                                    allow_unused=True)
    for name, g, p in zip(op.outputs["Grads"], grads, wrt):
        env[name] = torch.zeros_like(p) if g is None else g


def _run_ops(program, block_idx, ops, env, seed, step):
    """Run ``ops`` of block ``block_idx`` on ``env``, dispatching the
    control-flow ops to their sub-block lowerings."""
    for idx, op in enumerate(ops):
        _run_one(program, block_idx, idx, op, env, seed, step)


def _run_one(program, block_idx, idx, op, env, seed, step):
    lower = _CONTROL_FLOW.get(op.type)
    if lower is not None:
        lower(program, op, env, seed, step)
        return
    salt = op.rng_salt if op.rng_salt is not None \
        else _op_salt(block_idx, idx)
    _run_op(op, env, seed, step, salt)


def _scalar_true(t) -> bool:
    """A one-element predicate read on the host (a device sync on CUDA)."""
    return bool(t.reshape(()).item())


def _lower_cond(program, op, env, seed, step):
    """conditional_block: run the chosen branch on a snapshot of ``env``
    (ref operators/controlflow/conditional_block_op.cc)."""
    take_true = _scalar_true(env[op.inputs["Cond"][0]])
    blk = program.blocks[op.attrs["true_block" if take_true
                                  else "false_block"]]
    names = op.attrs["true_outs" if take_true else "false_outs"]
    env2 = dict(env)
    _run_ops(program, blk.idx, blk.ops, env2, seed, step)
    for name, src in zip(op.outputs["Out"], names):
        env[name] = env2[src]


def _lower_while(program, op, env, seed, step):
    """while: ``X`` is the carry; each body output is cast to its carry's
    dtype (ref operators/controlflow/while_op.cc)."""
    cb = program.blocks[op.attrs["cond_block"]]
    bb = program.blocks[op.attrs["body_block"]]
    loop_names = op.inputs["X"]
    carry = [env[n] for n in loop_names]

    def with_carry():
        env2 = dict(env)
        env2.update(zip(loop_names, carry))
        return env2

    while True:
        env2 = with_carry()
        _run_ops(program, cb.idx, cb.ops, env2, seed, step)
        if not _scalar_true(env2[op.attrs["cond_out"]]):
            break
        env2 = with_carry()
        _run_ops(program, bb.idx, bb.ops, env2, seed, step)
        carry = [torch.as_tensor(env2[n]).to(c.dtype)
                 for n, c in zip(op.attrs["body_outs"], carry)]
    for name, val in zip(op.outputs["Out"], carry):
        env[name] = val


def _lower_static_rnn(program, op, env, seed, step):
    """static_rnn: the step block over the time-major leading axis of every
    ``X``, the memories carried in their initial dtypes, the step outputs
    stacked (ref operators/recurrent_op.cc)."""
    blk = program.blocks[op.attrs["rnn_block"]]
    seqs = [env[n] for n in op.inputs["X"]]
    mems = [env[n] for n in op.inputs["Init"]]
    outs = [[] for _ in op.attrs["out_names"]]
    for t in range(seqs[0].shape[0]):
        env2 = dict(env)
        env2.update(zip(op.attrs["mem_names"], mems))
        env2.update(zip(op.attrs["step_in_names"], (x[t] for x in seqs)))
        _run_ops(program, blk.idx, blk.ops, env2, seed, step)
        mems = [env2[n].to(m.dtype)
                for n, m in zip(op.attrs["mem_next"], mems)]
        for acc, n in zip(outs, op.attrs["out_names"]):
            acc.append(env2[n])
    for name, acc in zip(op.outputs["Out"], outs):
        env[name] = torch.stack(acc)


_CONTROL_FLOW = {"conditional_block": _lower_cond, "while": _lower_while,
                 "static_rnn": _lower_static_rnn}


def _op_generator(seed: int, step: int, salt: int) -> torch.Generator:
    mixed = (seed * _MIX[0] + step * _MIX[1] + salt * _MIX[2]) \
        & 0x7FFFFFFFFFFFFFFF
    return torch.Generator().manual_seed(mixed)


def _run_op(op, env, seed, step, salt):
    """Execute one op's lowering on the tensors in ``env``; an op that
    draws under a generator of its own."""
    from .passes import RANDOM_OPS

    lowering = get_lowering(op.type)
    try:
        ins = {slot: [env[n] for n in names] if names else []
               for slot, names in op.inputs.items()}
    except KeyError as e:
        raise _errors.PreconditionNotMetError(
            f"op {op.type!r} reads {e.args[0]!r}, which no earlier op "
            "produced and the feed and scope do not hold") from None
    if op.type in RANDOM_OPS or op.type in _DRAWING_OPS:
        with _random.rng_scope(_op_generator(seed, step, salt)):
            outs = lowering(ins, op.attrs, op)
    else:
        outs = lowering(ins, op.attrs, op)
    for slot, names in op.outputs.items():
        for name, val in zip(names, outs.get(slot, [])):
            env[name] = val


_m_predicted_peak = _monitor.gauge(
    "executor.predicted_peak_bytes", "memcheck's static per-device peak "
    "estimate for this program, set before the run it prices.",
    labelnames=("program",))

# attrs naming variables a control-flow lowering reads out of the
# environment (branch outputs, loop carries, the loop test, RNN slots)
_NAME_LIST_ATTRS = ("true_outs", "false_outs", "body_outs", "mem_next",
                    "out_names")


def _reads(op, block):
    """Every name op reads from ``env``: its inputs, its sub-blocks' free
    reads, and the names its lowering returns out of a sub-block."""
    names = set(op.input_names())
    if op.sub_block_indices():
        from .passes import subblock_free_reads

        names |= subblock_free_reads(op, block)
        for a in _NAME_LIST_ATTRS:
            names.update(op.attrs.get(a, ()))
        if "cond_out" in op.attrs:
            names.add(op.attrs["cond_out"])
    return names


def release_plan(block, keep) -> List[tuple]:
    """Per op of ``block``, the names dead after it: read or written by
    the op and read by no later op, less ``keep``.  The walk is the
    kill-then-gen liveness scan of ``passes.liveness`` with every op
    treated as live (the Executor runs dead ops too)."""
    later: set = set()
    plan: List[tuple] = [()] * len(block.ops)
    for idx in range(len(block.ops) - 1, -1, -1):
        op = block.ops[idx]
        reads = _reads(op, block)
        touched = reads | set(op.output_names())
        plan[idx] = tuple(sorted(n for n in touched
                                 if n not in later and n not in keep))
        later |= reads
    return plan


_tokens = itertools.count(1)


def _program_token(program) -> int:
    """A process-unique id of a Program object (ids of collected objects
    are reused; the token is not)."""
    token = getattr(program, "_exec_cache_token", None)
    if token is None:
        token = next(_tokens)
        program._exec_cache_token = token
    return token


# feed-shape signatures an entry remembers as checked, cleared when full
# (memcheck's own memo is bounded the same way)
_MEM_CHECKED_CAP = 4096


class _Entry:
    __slots__ = ("program", "passes", "state_names", "needs_value",
                 "last_region", "wrt", "release", "mem_checked")

    def __init__(self, program, passes, state_names, needs_value, keep):
        self.program = program
        self.passes = passes
        self.state_names = state_names
        self.needs_value = needs_value
        block = program.global_block()
        ops = block.ops
        regions = [i for i, op in enumerate(ops)
                   if op.type == "backward_region"]
        # ops up to the last region run with autograd on
        self.last_region = regions[-1] if regions else -1
        self.wrt = {n for i in regions for n in ops[i].inputs["Params"]}
        self.release = release_plan(block, keep)
        # feed-shape signatures memcheck has passed for this entry
        self.mem_checked: set = set()


class Executor:
    """ref fluid/executor.py:474.  ``place`` is the device: None means
    CUDA and raises where there is no card; pass ``"cpu"`` to run the
    plain PyTorch path (each kernel wrapper then runs its plain
    version)."""

    def __init__(self, place=None):
        self.place = resolve_device(place)
        self._cache: Dict[tuple, _Entry] = {}
        self._step = 0

    def run(self, program=None, feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True):
        """Run one step of ``program``: feeds in, the block op by op,
        persistable outputs back to ``scope``, the fetches out (numpy
        arrays with ``return_numpy``, else tensors on the device)."""
        program = program or default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        entry = self._entry(program, feed, fetch_names)
        if _flags.get_flag("check_memory"):
            self._check_memory(entry, program, feed, fetch_names)

        env: Dict[str, Any] = {}
        missing = []
        for n in entry.state_names:
            v = scope.find_var(n)
            if v is None:
                if n in entry.needs_value:
                    missing.append(n)
            else:
                env[n] = self._tensor(v)
        if missing:
            raise _errors.PreconditionNotMetError(
                f"persistable variables {missing} have no value in scope — "
                "run the startup program first (exe.run(startup_program))")
        block = program.global_block()
        for k, v in feed.items():
            # each feed in its data variable's dtype (64-bit resolved to
            # 32, as in the JAX package with x64 off)
            env[k] = self._tensor(v, block.var(k).dtype
                                  if block.has_var(k) else None)

        # gradient leaves of the regions: scope reads and feeds here,
        # intermediates as their ops produce them
        leaves = {n: _grad_leaf(env[n]) for n in entry.wrt if n in env}
        env.update(leaves)
        run_program = entry.program
        seed = run_program.random_seed or _random.draw_seed()
        step = self._step
        self._step += 1
        ops = run_program.global_block().ops
        last = entry.last_region
        release = entry.release
        with _ops.device_scope(self.place):
            with torch.enable_grad():
                for idx in range(last + 1):
                    op = ops[idx]
                    if op.type == "backward_region":
                        _backward_region(op, env, leaves, idx < last)
                    else:
                        _run_one(run_program, 0, idx, op, env, seed, step)
                        for n in op.output_names():
                            if n in entry.wrt and n not in leaves:
                                env[n] = leaves[n] = _grad_leaf(env[n])
                    for n in release[idx]:
                        env.pop(n, None)
            if last >= 0:
                for k, v in env.items():
                    if isinstance(v, torch.Tensor) and v.requires_grad:
                        env[k] = v.detach()
            with torch.no_grad():
                for idx in range(last + 1, len(ops)):
                    _run_one(run_program, 0, idx, ops[idx], env, seed, step)
                    for n in release[idx]:
                        env.pop(n, None)
        for n in entry.state_names:
            if n in env:
                scope.set(n, env[n].detach())
        try:
            fetches = [env[n].detach() for n in fetch_names]
        except KeyError as e:
            raise KeyError(f"fetch {e.args[0]!r} is neither produced by the "
                           "program nor fed") from None
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches

    def executed_program(self, program, feed_names, fetch_list) -> Program:
        """The program ``run`` executes for these feeds and fetches under
        the current ``opt_passes`` value (the pipeline's rewrite, or
        ``program`` itself)."""
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]
        return self._entry(program, dict.fromkeys(feed_names),
                           fetch_names).program

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread: int = 0, debug: bool = False,
                           fetch_list=None, fetch_info=None,
                           print_period: int = 100,
                           prefetch_to_device=False):
        """ref fluid/executor.py:1597 train_from_dataset →
        TrainerFactory/MultiTrainer/DeviceWorker (trainer.h:41,
        device_worker.h:215 HogwildWorker threads pulling from the DataFeed
        channel).

        As in the JAX package, the C++ DataFeed (core/native.py) parses,
        shuffles and batches on background threads and one device runs the
        steps in order, so the N-worker Hogwild loop becomes sequential
        ``run`` calls over the feed stream (``thread`` is accepted for
        parity; parse parallelism is the dataset's ``set_thread``).

        ``prefetch_to_device=True`` (the Executor's device) or a device
        stages batch N+1 on the device from a background thread while batch
        N computes (io/prefetch.py).  Returns the last step's fetches."""
        if dataset is None:
            raise ValueError("train_from_dataset requires a dataset")
        del thread  # parity knob; parse parallelism lives on the dataset
        fetch_list = list(fetch_list or [])
        names = [v.name if isinstance(v, Variable) else str(v)
                 for v in fetch_list]
        labels = list(fetch_info or names)
        stream = dataset
        if prefetch_to_device:
            from ..io.prefetch import DeviceFeeder

            stream = DeviceFeeder(
                dataset, device=self.place if prefetch_to_device is True
                else prefetch_to_device)
        step = 0
        last = None
        for batch in stream:
            last = self.run(program, feed=batch, fetch_list=fetch_list,
                            scope=scope)
            step += 1
            if debug and fetch_list and step % print_period == 0:
                msg = ", ".join(f"{l}={np.asarray(v).ravel()[:1][0]:.6g}"
                                for l, v in zip(labels, last))
                print(f"[train_from_dataset] step {step}: {msg}")
        return last

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread: int = 0, debug: bool = False,
                           fetch_list=None, fetch_info=None,
                           print_period: int = 100,
                           prefetch_to_device=False):
        """ref fluid/executor.py:1476 — same loop; the program is expected
        to be an inference/test clone (no optimizer ops)."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period, prefetch_to_device)

    def close(self):
        self._cache.clear()

    # -- internals -----------------------------------------------------------
    def _entry(self, program, feed, fetch_names) -> _Entry:
        flag = _flags.get_flag("opt_passes")
        key = (_program_token(program), program._version,
               tuple(sorted(feed)), tuple(fetch_names), str(flag))
        entry = self._cache.get(key)
        if entry is None:
            if _flags.get_flag("check_program"):
                # PV001-PV010 before the first op, memoized by program
                # version x feed/fetch signature on the program itself
                from .analysis import check_program_cached

                check_program_cached(program, feed_names=set(feed),
                                     fetch_names=fetch_names)
            run_program, passes_fp = program, ""
            if flag:
                from . import passes as _passes

                run_program, passes_fp = _passes.optimize_for_executor(
                    program, flag, set(feed), fetch_names)
            state_names = [v.name for v in program.list_vars()
                           if v.persistable]
            needs = {n for n in state_names
                     if self._first_access(program.global_block(),
                                           n) == "read"}
            keep = set(fetch_names) | set(feed) | {
                v.name for v in run_program.list_vars() if v.persistable}
            entry = _Entry(run_program, passes_fp, state_names, needs, keep)
            self._cache[key] = entry
        return entry

    def _check_memory(self, entry, program, feed, fetch_names) -> None:
        """memcheck's MC checks for a feed-shape signature this entry has
        not run yet: a predicted OOM raises before any feed moves to the
        device; the peak estimate is the predicted-peak gauge."""
        shapes = {k: tuple(v.shape) if hasattr(v, "shape")
                  else np.shape(v) for k, v in feed.items()}
        sig = tuple(sorted(shapes.items()))
        if sig in entry.mem_checked:
            return
        if len(entry.mem_checked) >= _MEM_CHECKED_CAP:
            entry.mem_checked.clear()
        from .memcheck import check_memory_cached

        report = check_memory_cached(program, None, shapes, fetch_names)
        if report.mem is not None and _monitor.enabled():
            _m_predicted_peak.set(report.mem.peak_bytes,
                                  program=str(_program_token(program)))
        entry.mem_checked.add(sig)

    def _tensor(self, value, dtype=None) -> torch.Tensor:
        """``value`` on the Executor's device in ``dtype`` (None: its own
        dtype, 64-bit types resolved to 32-bit)."""
        if not isinstance(value, torch.Tensor):
            arr = np.asarray(value)
            value = torch.from_numpy(arr) if arr.flags.writeable \
                else torch.tensor(arr)
        dtype = _dtype.resolve(dtype if dtype is not None else value.dtype)
        if value.device == self.place and value.dtype == dtype:
            return value
        return value.to(device=self.place, dtype=dtype)

    @staticmethod
    def _first_access(block, name: str):
        """First access to ``name`` in execution order: 'read', 'write', or
        None.  A control-flow op's sub-blocks are walked at the op's
        position: a read anywhere inside is a read."""
        program = block.program
        for op in block.ops:
            if name in op.input_names():
                return "read"
            for _a, idx in op.sub_block_indices():
                if Executor._first_access(program.blocks[idx],
                                          name) == "read":
                    return "read"
            if name in op.output_names():
                return "write"
        return None
