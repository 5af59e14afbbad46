"""Static-graph control flow: cond / while_loop + compare/logical DSL.

Reference parity: fluid/layers/control_flow.py (`cond`, `while_loop`,
`While`, `increment`, `less_than` ...) lowering to
operators/controlflow/conditional_block_op.cc and while_op.cc, which run
sub-blocks through a scoped Executor with mutable Scopes.

As in the JAX package, sub-blocks are real ``Block``s in the Program
(built by running the user callbacks under ``Program._create_block``), and
the builders append the same ops with the same attrs.  The port's Executor
runs a sub-block op by op on a snapshot of the enclosing environment
(static/executor.py): sub-block ops may read any outer variable, and the
loop state is exactly the ``loop_vars`` carry.  The contract is the JAX
package's:
  * both cond branches must produce matching shapes/dtypes,
  * while-loop carries are shape-invariant,
  * a random op inside a ``while_loop`` body or an RNN step draws the same
    values every iteration of a step (its seed comes from its (block, op
    index) salt) — thread a counter through ``loop_vars`` if
    per-iteration randomness is required,
  * ``append_backward`` rejects programs with a ``while`` op on the
    parameter -> loss path (backward._reject_while_ops); gradients flow
    through ``cond`` and ``StaticRNN``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from .framework import Program, Variable, default_main_program
from .layers import _append, _main_block, _out, fill_constant

__all__ = [
    "cond", "while_loop", "StaticRNN", "increment", "less_than", "less_equal",
    "greater_than", "greater_equal", "equal", "not_equal", "logical_and",
    "logical_or", "logical_xor", "logical_not",
]


# -- compare / logical DSL (ref layers/control_flow.py less_than :1262 etc.) --
def _sym_broadcast(a, b):
    """np.broadcast_shapes that tolerates -1 (unknown) dims."""
    out = []
    for da, db in zip((1,) * (len(b) - len(a)) + tuple(a),
                      (1,) * (len(a) - len(b)) + tuple(b)):
        if da == 1:
            out.append(db)
        elif db == 1 or da == db:
            out.append(da)
        elif -1 in (da, db):
            out.append(-1)
        else:
            raise ValueError(f"cannot broadcast {a} with {b}")
    return tuple(out)


def _cmp(op_type, x: Variable, y: Variable) -> Variable:
    out = _out("bool", _sym_broadcast(x.shape, y.shape))
    _append(op_type, {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]})
    return out


def less_than(x, y):
    return _cmp("less_than", x, y)


def less_equal(x, y):
    return _cmp("less_equal", x, y)


def greater_than(x, y):
    return _cmp("greater_than", x, y)


def greater_equal(x, y):
    return _cmp("greater_equal", x, y)


def equal(x, y):
    return _cmp("equal", x, y)


def not_equal(x, y):
    return _cmp("not_equal", x, y)


def logical_and(x, y):
    return _cmp("logical_and", x, y)


def logical_or(x, y):
    return _cmp("logical_or", x, y)


def logical_xor(x, y):
    return _cmp("logical_xor", x, y)


def logical_not(x):
    out = _out("bool", x.shape)
    _append("logical_not", {"X": [x.name]}, {"Out": [out.name]})
    return out


def increment(x: Variable, value: float = 1.0, in_place: bool = True) -> Variable:
    """ref layers/control_flow.py increment :1203 — writes back to the same
    variable name so while-loop counters advance through the env."""
    out_name = x.name if in_place else None
    if in_place:
        _append("increment", {"X": [x.name]}, {"Out": [x.name]},
                {"step": float(value)})
        return x
    out = _out(x.dtype, x.shape)
    _append("increment", {"X": [x.name]}, {"Out": [out.name]},
            {"step": float(value)})
    return out


# -- structure helpers --------------------------------------------------------
def _flatten_vars(out) -> List[Variable]:
    if out is None:
        return []
    if isinstance(out, Variable):
        return [out]
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(_flatten_vars(o))
        return res
    raise TypeError(f"control-flow branch returned non-Variable {type(out)}")


def _pack_like(template, flat: List[Variable]):
    """Rebuild the user's structure from a flat var list."""
    if template is None:
        return None
    if isinstance(template, Variable):
        return flat.pop(0)
    if isinstance(template, tuple):
        return tuple(_pack_like(t, flat) for t in template)
    if isinstance(template, list):
        return [_pack_like(t, flat) for t in template]
    raise TypeError(type(template))


# -- cond ---------------------------------------------------------------------
def cond(pred: Variable, true_fn: Callable, false_fn: Callable,
         name: Optional[str] = None):
    """ref layers/control_flow.py cond :2313 → conditional_block_op.cc.

    Both branches build real sub-blocks; the Executor runs the chosen one
    over a snapshot of the enclosing environment.
    """
    prog = pred.block.program
    parent = prog.current_block()

    tb = prog._create_block()
    t_out = true_fn()
    prog._rollback()
    fb = prog._create_block()
    f_out = false_fn()
    prog._rollback()

    t_list = _flatten_vars(t_out)
    f_list = _flatten_vars(f_out)
    if len(t_list) != len(f_list):
        raise ValueError(
            f"cond branches returned {len(t_list)} vs {len(f_list)} outputs; "
            "they must match (cond requires identical output structure)")
    for tv, fv in zip(t_list, f_list):
        if tv.shape != fv.shape or tv.dtype != fv.dtype:
            raise ValueError(
                f"cond branch outputs mismatch: {tv.name}{tv.shape}:"
                f"{tv.dtype} vs {fv.name}{fv.shape}:{fv.dtype}")

    outs = [parent.create_var(shape=v.shape, dtype=v.dtype) for v in t_list]
    parent.append_op(
        "conditional_block",
        inputs={"Cond": [pred.name]},
        outputs={"Out": [o.name for o in outs]},
        attrs={"true_block": tb.idx, "false_block": fb.idx,
               "true_outs": [v.name for v in t_list],
               "false_outs": [v.name for v in f_list]})
    flat = list(outs)
    return _pack_like(t_out, flat)


# -- while_loop ---------------------------------------------------------------
def while_loop(cond_fn: Callable, body_fn: Callable,
               loop_vars: Sequence[Variable], is_test: bool = False,
               name: Optional[str] = None):
    """ref layers/control_flow.py while_loop :1085 → while_op.cc.

    `loop_vars` is the carried state (shape-invariant).  `body_fn` must
    return the next carry with matching structure; the Executor runs the
    condition and body blocks until the condition is false.
    """
    loop_vars = list(loop_vars)
    if not loop_vars:
        raise ValueError("while_loop requires at least one loop variable")
    prog = loop_vars[0].block.program
    parent = prog.current_block()

    cb = prog._create_block()
    c_out = cond_fn(*loop_vars)
    prog._rollback()
    if not isinstance(c_out, Variable):
        raise TypeError("while_loop cond_fn must return a boolean Variable")

    bb = prog._create_block()
    b_out = body_fn(*loop_vars)
    prog._rollback()
    if isinstance(b_out, Variable):
        b_out = [b_out]
    b_list = _flatten_vars(list(b_out))
    if len(b_list) != len(loop_vars):
        raise ValueError(
            f"while_loop body returned {len(b_list)} vars for "
            f"{len(loop_vars)} loop_vars")
    for lv, bv in zip(loop_vars, b_list):
        if lv.shape != bv.shape or lv.dtype != bv.dtype:
            raise ValueError(
                f"loop var {lv.name}{lv.shape}:{lv.dtype} vs body output "
                f"{bv.name}{bv.shape}:{bv.dtype} — carries must be "
                "shape-invariant")

    outs = [parent.create_var(shape=v.shape, dtype=v.dtype)
            for v in loop_vars]
    parent.append_op(
        "while",
        inputs={"X": [v.name for v in loop_vars]},
        outputs={"Out": [o.name for o in outs]},
        attrs={"cond_block": cb.idx, "body_block": bb.idx,
               "cond_out": c_out.name,
               "body_outs": [v.name for v in b_list]})
    return outs


class StaticRNN:
    """Static (fixed-length) recurrence (ref layers/control_flow.py
    StaticRNN → recurrent_op.cc).

    The Executor runs the step block once per step of the TIME-MAJOR
    leading axis of every step input and stacks the step outputs; autograd
    runs through the steps, so seq2seq models TRAIN through this construct
    (the reference's RecurrentGradOp machinery collapses into autograd).

    Usage (reference API shape)::

        rnn = StaticRNN()
        with rnn.step():
            w = rnn.step_input(x_tmajor)        # [T, B, D] -> per-step [B, D]
            prev = rnn.memory(init=h0)          # carried state
            h = layers.fc(concat([w, prev], 1), H, act='tanh')
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        outs = rnn()                            # [T, B, H]
    """

    def __init__(self, name: Optional[str] = None):
        self._prog: Optional[Program] = None
        self._block = None
        self._seq_pairs = []     # (outer_var, step_var)
        self._mem_pairs = []     # (step_mem_var, init_outer_var)
        self._mem_next = {}      # step_mem_name -> step_next_name
        self._outputs = []       # step vars
        self._built = False

    class _StepGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            from .framework import default_main_program

            rnn = self.rnn
            rnn._prog = default_main_program()
            rnn._block = rnn._prog._create_block()
            return rnn

        def __exit__(self, *exc):
            self.rnn._prog._rollback()
            return False

    def step(self):
        return StaticRNN._StepGuard(self)

    def step_input(self, x: Variable) -> Variable:
        if x.ndim < 1:
            raise ValueError("step_input needs a [T, ...] sequence variable")
        v = self._block.create_var(shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._seq_pairs.append((x, v))
        return v

    def memory(self, init: Optional[Variable] = None) -> Variable:
        if init is None:
            raise ValueError(
                "memory requires init= (batch_ref/shape form of the "
                "reference is not supported; pass an initialized tensor)")
        m = self._block.create_var(shape=init.shape, dtype=init.dtype)
        self._mem_pairs.append((m, init))
        return m

    def update_memory(self, mem: Variable, new: Variable) -> None:
        if mem.shape != new.shape or mem.dtype != new.dtype:
            raise ValueError(
                f"update_memory: carry must be shape-invariant, got "
                f"{mem.shape}:{mem.dtype} vs {new.shape}:{new.dtype}")
        self._mem_next[mem.name] = new.name

    def step_output(self, o: Variable) -> None:
        self._outputs.append(o)

    output = step_output

    def __call__(self):
        if self._built:
            raise RuntimeError("StaticRNN() already materialized")
        if not self._seq_pairs:
            raise ValueError("StaticRNN needs at least one step_input")
        missing = [m.name for m, _ in self._mem_pairs
                   if m.name not in self._mem_next]
        if missing:
            raise ValueError(f"memories {missing} never update_memory'd")
        self._built = True
        parent = self._prog.current_block()
        T = self._seq_pairs[0][0].shape[0]
        outs = [parent.create_var(shape=(T,) + tuple(v.shape),
                                  dtype=v.dtype) for v in self._outputs]
        parent.append_op(
            "static_rnn",
            inputs={"X": [x.name for x, _ in self._seq_pairs],
                    "Init": [i.name for _, i in self._mem_pairs]},
            outputs={"Out": [o.name for o in outs]},
            attrs={"rnn_block": self._block.idx,
                   "step_in_names": [v.name for _, v in self._seq_pairs],
                   "mem_names": [m.name for m, _ in self._mem_pairs],
                   "mem_next": [self._mem_next[m.name]
                                for m, _ in self._mem_pairs],
                   "out_names": [v.name for v in self._outputs]})
        return outs if len(outs) > 1 else outs[0]


class While:
    """Legacy block-style While (ref layers/control_flow.py While :1005):

        i = fill_constant(shape=[1], dtype='int64', value=0)
        cond = less_than(i, limit)
        w = While(cond)
        with w.block():
            ...body ops...
            increment(i)
            # body must recompute the condition in-place:
            less_than(i, limit, out=cond)   # here: assign via cond.update()

    The carried state must be explicit, which the legacy mutable-Scope API
    hides; as in the JAX package the constructor refuses, pointing at
    ``while_loop``.
    """

    def __init__(self, cond_var: Variable):
        raise NotImplementedError(
            "the legacy While block API relies on mutable-Scope semantics "
            "that do not map to an explicit carry; use static.while_loop("
            "cond_fn, body_fn, loop_vars) instead (same expressive power, "
            "explicit carried state)")
