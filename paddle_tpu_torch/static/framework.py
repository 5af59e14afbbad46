"""Static-graph program model: Program / Block / Operator / Variable
(counterpart of paddle_tpu/static/framework.py, pure Python, copied).

Reference parity: python/paddle/fluid/framework.py — `Variable` (:869),
`Operator` (:1861), `Block` (:2452), `Program` (:3914), `Parameter` (:5033),
global default programs (:5243/:5277), program_guard.

The program is the IR.  Ops carry no kernels: each op type has a
registered lowering rule (static/registry.py) that the Executor
(static/executor.py) calls op by op on torch tensors.  Variable dtypes are
torch dtypes; op attributes name them as strings (``"float32"``), as in the
JAX package.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

from ..core import dtype as _dtype_mod

__all__ = [
    "Variable", "Parameter", "Operator", "Block", "Program",
    "default_main_program", "default_startup_program", "program_guard",
    "unique_name", "name_scope", "SUB_BLOCK_ATTRS",
]

# Every attr name through which a control-flow op references a sub-block
# (by block index).  Dataflow walkers (the pass liveness analysis, the
# Executor's first-access precondition scan) descend through these; a new
# block-carrying op MUST add its attr here or those walkers go blind to
# reads inside its body.
SUB_BLOCK_ATTRS = ("true_block", "false_block", "cond_block", "body_block",
                   "rnn_block")


class _UniqueNames(threading.local):
    def __init__(self):
        self.counters: Dict[str, int] = {}

    def generate(self, prefix: str) -> str:
        i = self.counters.get(prefix, 0)
        self.counters[prefix] = i + 1
        return f"{prefix}_{i}"


_unique = _UniqueNames()


def unique_name(prefix: str = "tmp") -> str:
    """ref: fluid/unique_name.py generate()."""
    return _unique.generate(prefix)


class Variable:
    """Symbolic tensor in a Block (ref framework.py:869).  Shape may contain
    -1 (batch) — concrete shapes bind at feed time."""

    def __init__(self, block: "Block", name: str, shape: Sequence[int],
                 dtype="float32", persistable: bool = False,
                 stop_gradient: bool = False, is_data: bool = False):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _dtype_mod.convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={_dtype_mod.dtype_name(self.dtype)}, "
                f"persistable={self.persistable})")

    # operator sugar lowers to ops in the current block (ref Variable's
    # monkey-patched math ops, fluid/layers/math_op_patch.py)
    def _binary(self, other, op_type):
        from . import layers as L
        return L._elementwise(op_type, self, other)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")


class Parameter(Variable):
    """Persistable trainable variable (ref framework.py:5033); `trainable`
    and `initializer` drive append_backward and the startup program."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 initializer=None, regularizer=None):
        super().__init__(block, name, shape, dtype, persistable=True,
                         stop_gradient=not trainable)
        self.trainable = trainable
        self.initializer = initializer
        self.regularizer = regularizer


class Operator:
    """One node: type + named input/output slots (lists of var names) + attrs
    (ref OpDesc framework.proto:42; framework.py:1861)."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, List[str]]] = None,
                 outputs: Optional[Dict[str, List[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # Stable PRNG salt: the Executor salts per-op randomness by (block,
        # op index) unless this is set.  The pass manager stamps rewritten
        # programs with each op's pre-rewrite index so random draws survive
        # op insertion/removal (golden parity depends on it).
        self.rng_salt: Optional[int] = None

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def sub_block_indices(self) -> List[tuple]:
        """(attr_name, block_index) for every sub-block this op references —
        the one sanctioned way for dataflow walkers (the pass liveness
        analysis, the Executor's first-access scan) to descend, so a new
        block-carrying op only has to extend SUB_BLOCK_ATTRS."""
        return [(a, self.attrs[a]) for a in SUB_BLOCK_ATTRS
                if a in self.attrs]

    def __repr__(self):
        return f"Operator({self.type}, in={self.inputs}, out={self.outputs})"


class Block:
    """Ordered op list + var table (ref BlockDesc; framework.py:2452)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name=None, shape=(), dtype="float32", **kw) -> Variable:
        name = name or unique_name("tmp")
        v = Variable(self, name, shape, dtype, **kw)
        self.vars[name] = v
        self.program._version += 1
        return v

    def create_parameter(self, name, shape, dtype="float32", trainable=True,
                         initializer=None, regularizer=None) -> Parameter:
        p = Parameter(self, name, shape, dtype, trainable, initializer,
                      regularizer)
        self.vars[name] = p
        self.program._parameters[name] = p
        self.program._version += 1
        return p

    def var(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = (self.program.blocks[b.parent_idx]
                 if b.parent_idx >= 0 else None)
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None
                  ) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._version += 1
        return op

    # -- sanctioned structural mutation (the pass-manager API) --------------
    # Every mutation bumps `program._version`: the Executor's cache of
    # rewritten programs is version-keyed, so a mutated program is never
    # served a stale rewrite.  Mutating `block.ops` directly bypasses that
    # invalidation.

    def insert_op(self, index: int, type: str, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        """Insert an op at `index` (ref BlockDesc::InsertOp)."""
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._version += 1
        return op

    def remove_op(self, index: int) -> Operator:
        """Remove and return the op at `index` (ref BlockDesc::RemoveOp)."""
        op = self.ops.pop(index)
        self.program._version += 1
        return op

    def replace_op(self, index: int, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        """Replace the op at `index` in place, preserving its position (and
        therefore the PRNG salts of every other op)."""
        op = Operator(self, type, inputs, outputs, attrs)
        op.rng_salt = self.ops[index].rng_salt
        self.ops[index] = op
        self.program._version += 1
        return op

    def set_ops(self, new_ops) -> None:
        """Bulk-replace this block's op list — for whole-graph rewrites
        that rebuild the list in one sweep (slim's quant passes)."""
        self.ops = list(new_ops)
        self.program._version += 1

    def remove_var(self, name: str) -> None:
        """Drop a var from this block's table (dead-var elimination)."""
        if name in self.vars:
            del self.vars[name]
            self.program._parameters.pop(name, None)
            self.program._version += 1

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


class Program:
    """ref framework.py:3914.  `_version` invalidates the Executor's compiled
    cache whenever the graph mutates."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._parameters: Dict[str, Parameter] = {}
        self._version = 0
        self.random_seed: Optional[int] = None
        self._current_block_idx = 0

    def bump_version(self) -> int:
        """Explicitly invalidate version-keyed caches (the Executor's
        rewritten-program cache).  The Block mutation API calls
        this path implicitly; passes that edit op slots/attrs in place must
        call it themselves."""
        self._version += 1
        return self._version

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """Open a sub-block (ref Program._create_block): ops appended while it
        is current land in it — the control-flow builders (cond/while_loop)
        wrap callbacks with this."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        self._version += 1
        return b

    def _rollback(self) -> None:
        """Close the current sub-block (ref Program._rollback)."""
        self._current_block_idx = self.current_block().parent_idx
        if self._current_block_idx < 0:
            self._current_block_idx = 0

    def all_parameters(self) -> List[Parameter]:
        return list(self._parameters.values())

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Structural clone (ref Program.clone), every block kept with its
        index, so control-flow ops still name their sub-blocks (the JAX
        package's clone keeps block 0 only).  for_test drops ops after the
        last fetchable var is produced is NOT emulated; instead,
        `is_test`-sensitive ops (dropout, batch_norm) read the attr set
        here."""
        p = Program()
        p.random_seed = self.random_seed
        for src in self.blocks:
            b = p.global_block() if src.idx == 0 \
                else p._create_block(src.parent_idx)
            copy_block(src, b, for_test)
        p._current_block_idx = 0
        return p

    def to_string(self, throw_on_error=False) -> str:
        lines = [f"Program(version={self._version})"]
        for blk in self.blocks:
            lines.append(f" Block {blk.idx}:")
            for v in blk.vars.values():
                lines.append(f"  {v!r}")
            for op in blk.ops:
                lines.append(f"  {op!r}")
        return "\n".join(lines)

    def __repr__(self):
        return self.to_string()


def copy_block(src: Block, dst: Block, for_test: bool = False,
               names=None, ops=None) -> None:
    """Append ``src``'s vars (those in ``names``, all when None) and ops
    (``ops``, all when None) to ``dst``; with ``for_test`` the dropout and
    batch_norm ops run in test mode."""
    for name, v in src.vars.items():
        if names is not None and name not in names:
            continue
        if isinstance(v, Parameter):
            dst.create_parameter(name, v.shape, v.dtype, v.trainable,
                                 v.initializer, v.regularizer)
        else:
            dst.create_var(name, v.shape, v.dtype,
                           persistable=v.persistable,
                           stop_gradient=v.stop_gradient, is_data=v.is_data)
    for op in src.ops if ops is None else ops:
        attrs = dict(op.attrs)
        if for_test and op.type in ("dropout", "batch_norm"):
            attrs["is_test"] = True
        dst.append_op(op.type, op.inputs, op.outputs,
                      attrs).rng_salt = op.rng_salt


class _ProgramState(threading.local):
    def __init__(self):
        self.main = Program()
        self.startup = Program()


_state = _ProgramState()


def default_main_program() -> Program:
    """ref framework.py:5277."""
    return _state.main


def default_startup_program() -> Program:
    """ref framework.py:5243."""
    return _state.startup


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    """ref framework.py program_guard."""
    old_main, old_startup = _state.main, _state.startup
    _state.main = main_program
    if startup_program is not None:
        _state.startup = startup_program
    try:
        yield
    finally:
        _state.main, _state.startup = old_main, old_startup


@contextlib.contextmanager
def name_scope(prefix: str):
    """ref framework.py name_scope — cosmetic; names stay flat here."""
    yield
