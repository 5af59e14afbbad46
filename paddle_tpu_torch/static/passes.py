"""Graph-rewrite passes over static ``Program``s (counterpart of
paddle_tpu/static/passes.py).

Reference parity: the ``framework/ir`` pass stage — constant folding,
common-subexpression and dead-op elimination, the fusion family
(conv_bn_fuse_pass.cc, fc_fuse_pass.cc) and layout transfer.  The passes
pay off at the Program level: fewer ops to run, the conv + BN + act
pattern collapsed into one op the fused kernel serves, and an NHWC layout
chosen before the convolutions run.  ``QUANT_INFER_PIPELINE`` folds the
artifacts of post-training quantization into the int8 ops
``quant_conv2d`` / ``quant_mul`` (``quant_infer``) before the layout pass.

The rewrite contract:

1. passes operate on a ``Program.clone()`` — the caller's program is never
   mutated;
2. the clone is stamped with per-op ``rng_salt`` before any rewrite, so
   random ops keep their pre-rewrite streams when op indices shift;
3. every fetch must remain *produced or fed* after the rewrite, with the
   inferred shape and dtype it had before (static/analysis.py's symbolic
   engine): a violation raises ``ProgramVerificationError`` carrying a
   ``PV011`` diagnostic;
4. the rewritten program must pass the PV001-PV010 program walker
   (``analysis.check_program``).

The Executor runs the pipeline on its first run of a (program, feeds,
fetches, flag) key behind the ``opt_passes`` flag; a failed pipeline
*rolls back* to the unrewritten program and counts ``passes.rollbacks``
instead of failing the run.  ``golden_parity`` runs the original and the
rewritten program from the same state and compares fetches and final
persistable state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core import dtype as _dtype_mod
from ..core import errors as _errors
from ..utils import monitor as _monitor
from .analysis import Diagnostic, _known, check_program, infer_program
from .framework import Block, Operator, Program

__all__ = [
    "PassManager", "PassContext", "PassReport", "PipelineReport",
    "ParityReport", "Diagnostic", "DEFAULT_PIPELINE",
    "QUANT_INFER_PIPELINE", "available_passes",
    "pipeline_from_flag", "optimize_for_executor", "golden_parity",
    "verify_rewrite", "use_def_chains", "liveness", "is_pure",
    "subblock_free_reads",
    "RANDOM_OPS", "CONTROL_FLOW_OPS",
]

# ---------------------------------------------------------------------------
# Op classification (the analyses' ground truth).
# ---------------------------------------------------------------------------

# Ops that draw random numbers.  Never folded, never CSE'd (two identical
# random ops are independent draws), and their clones carry a pinned
# ``rng_salt`` so rewrites that shift op indices don't re-seed them.
RANDOM_OPS = frozenset({
    "gaussian_random", "uniform_random", "truncated_gaussian_random",
    "gaussian_random_batch_size_like", "uniform_random_batch_size_like",
    "randint", "randperm", "bernoulli", "multinomial", "sampling_id",
    "dropout", "random_crop", "shuffle_batch", "seed", "rrelu",
    "class_center_sample",
})

# Control-flow / executor pseudo-ops.  ``backward_region`` is additionally
# a liveness root for everything its Loss depends on.
CONTROL_FLOW_OPS = frozenset({
    "feed", "fetch", "backward_region", "conditional_block", "while",
    "static_rnn",
})

# Host-IO / stateful ops: liveness roots.
_SIDE_EFFECT_OPS = frozenset({
    "save", "save_combine", "load", "load_combine", "print", "py_func",
    "write_to_array", "read_from_array", "array_to_lod_tensor",
    "lod_tensor_to_array", "shrink_rnn_memory", "merge_lod_tensor",
    "split_lod_tensor", "lookup_sparse_table_merge", "merge_ids",
    "split_ids", "allreduce", "broadcast", "sync_batch_norm",
    "inplace_abn",
})


def has_side_effects(op_type: str) -> bool:
    """Host IO, collectives, or host-state mutation: a liveness root."""
    return (op_type in _SIDE_EFFECT_OPS
            or op_type.startswith(("c_", "push_", "pull_", "distributed_")))


def is_pure(op: Operator) -> bool:
    """Safe to fold/dedup/remove when its outputs are dead: deterministic,
    effect-free, and sub-block-free."""
    return (op.type not in RANDOM_OPS
            and op.type not in CONTROL_FLOW_OPS
            and not has_side_effects(op.type)
            and not op.sub_block_indices())


# ---------------------------------------------------------------------------
# Analyses: use-def chains, liveness.
# ---------------------------------------------------------------------------

def use_def_chains(block: Block) -> Tuple[Dict[str, List[Tuple[int, str]]],
                                          Dict[str, List[Tuple[int, str]]]]:
    """(defs, uses): var name -> [(op_index, slot)] over one block, in op
    order.  Names can be multiply defined (persistable write-backs like
    batch_norm's MeanOut alias their input) — consumers must check."""
    defs: Dict[str, List[Tuple[int, str]]] = {}
    uses: Dict[str, List[Tuple[int, str]]] = {}
    for idx, op in enumerate(block.ops):
        for slot, names in op.inputs.items():
            for n in names:
                uses.setdefault(n, []).append((idx, slot))
        for slot, names in op.outputs.items():
            for n in names:
                defs.setdefault(n, []).append((idx, slot))
    return defs, uses


def subblock_free_reads(op: Operator, block: Block) -> Set[str]:
    """Names the op's sub-blocks read from an enclosing scope.

    Walks every sub-block the op references (recursively), tracking which
    names are defined *by earlier ops within that sub-block*; any read of
    a name not so defined is a free read — the outer scope must keep it
    live for the whole duration of the carrying op (while/cond carries,
    rnn sequence inputs, backward_region's forward reads).  Names that
    turn out not to exist in the outer block are harmless over-approximation
    (the caller's live-set simply carries a name nobody produces)."""
    free: Set[str] = set()
    program = block.program

    def walk(block_idx: int, defined: Set[str]) -> None:
        sub = program.blocks[block_idx]
        local = set(defined)
        for sop in sub.ops:
            for n in sop.input_names():
                if n not in local:
                    free.add(n)
            for _attr, sbi in sop.sub_block_indices():
                walk(sbi, local)
            local.update(sop.output_names())

    for _attr, bi in op.sub_block_indices():
        walk(bi, set())
    return free


def _op_is_root(block: Block, op: Operator) -> bool:
    """Ops that must survive DCE regardless of dataflow: effects, control
    flow, and writes to persistable state (the executor writes persistable
    outputs back to the scope)."""
    if op.type in CONTROL_FLOW_OPS or has_side_effects(op.type):
        return True
    if op.sub_block_indices():
        return True
    for n in op.output_names():
        try:
            if block.var(n).persistable:
                return True
        except KeyError:
            pass
    return False


def liveness(block: Block, fetch_names: Sequence[str]
             ) -> Tuple[List[bool], List[Set[str]]]:
    """Backward liveness over one block: per-op liveness (is the op needed
    for any fetch / persistable write / side effect?) and the set of names
    live *after* each op, by the classic kill-then-gen walk.  Ops that
    carry sub-blocks gen every free read of their sub-blocks
    (``subblock_free_reads``): a carry read only inside a loop body stays
    live across the whole loop."""
    n = len(block.ops)
    needed: Set[str] = set(fetch_names or ())
    live = [False] * n
    live_after: List[Set[str]] = [set()] * n
    for idx in range(n - 1, -1, -1):
        op = block.ops[idx]
        live_after[idx] = set(needed)
        outs = set(op.output_names())
        if _op_is_root(block, op) or (outs & needed):
            live[idx] = True
            needed -= outs
            needed |= set(op.input_names())
            if op.sub_block_indices():
                needed |= subblock_free_reads(op, block)
    return live, live_after


# ---------------------------------------------------------------------------
# Pass context + shared rewrite helpers.
# ---------------------------------------------------------------------------

@dataclass
class PassContext:
    feed_names: Set[str] = field(default_factory=set)
    fetch_names: Tuple[str, ...] = ()

    def protected(self, block: Block, name: str) -> bool:
        """Names a pass must keep producing under their own identity:
        fetches, feeds, and persistable state."""
        if name in self.fetch_names or name in self.feed_names:
            return True
        try:
            v = block.var(name)
        except KeyError:
            return False
        return bool(v.persistable or v.is_data)


def _fresh_name(block: Block, base: str) -> str:
    """Deterministic name minting for pass-created vars: the base, suffixed
    only on collision within this block (never the process-global
    ``unique_name`` counter, so a rewrite does not depend on how many
    programs were built before)."""
    if base not in block.vars:
        return base
    i = 0
    while f"{base}.{i}" in block.vars:
        i += 1
    return f"{base}.{i}"


def _rewrite_reads(block: Block, old: str, new: str,
                   start: int = 0) -> int:
    """Redirect every input read of ``old`` to ``new`` from op ``start``
    on; bumps the program version."""
    count = 0
    for op in block.ops[start:]:
        for slot, names in op.inputs.items():
            if old in names:
                op.inputs[slot] = [new if n == old else n for n in names]
                count += 1
    if count:
        block.program.bump_version()
    return count


def _single_def_use(defs, uses, name) -> Optional[Tuple[int, str]]:
    """The unique (op_index, slot) consuming ``name`` when it has exactly
    one def and one use; else None."""
    if len(defs.get(name, ())) != 1 or len(uses.get(name, ())) != 1:
        return None
    return uses[name][0]


def _stamp_rng_salts(program: Program) -> None:
    """Pin every random op's salt to its PRE-rewrite (block, index)
    position; the Executor honours ``op.rng_salt`` over the positional
    default, so draws survive op insertion/removal."""
    from .executor import _op_salt

    for block in program.blocks:
        for idx, op in enumerate(block.ops):
            if op.type in RANDOM_OPS and op.rng_salt is None:
                op.rng_salt = _op_salt(block.idx, idx)


def _canon_attr(v):
    if isinstance(v, (list, tuple)):
        return tuple(_canon_attr(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon_attr(x)) for k, x in v.items()))
    if isinstance(v, np.generic):
        return v.item()
    return v


def _canon_attrs(attrs: Dict[str, Any]):
    return tuple(sorted((k, _canon_attr(v)) for k, v in attrs.items()))


# ---------------------------------------------------------------------------
# The passes.
# ---------------------------------------------------------------------------

class Pass:
    """One rewrite over a (cloned) Program.  ``run`` returns a stats dict;
    a truthy ``"changed"`` entry marks the program as rewritten."""

    name = "pass"

    def run(self, program: Program, ctx: PassContext) -> Dict[str, Any]:
        raise NotImplementedError


_FOLD_MAX_ELEMS = 4096  # don't bake big tensors into attrs

# seeds of constness: ops whose output is a function of attrs alone
_CONST_SOURCES = frozenset({"fill_constant", "assign_value", "eye",
                            "range", "linspace"})


class ConstantFolding(Pass):
    """Evaluate compile-time-constant subgraphs on the host and replace
    each root with a single ``assign_value``; the fold runs the op's own
    lowering on CPU tensors."""

    name = "constant_folding"

    def run(self, program, ctx):
        from .registry import get_lowering

        block = program.global_block()
        const_vals: Dict[str, torch.Tensor] = {}
        folded = 0
        for idx, op in enumerate(list(block.ops)):
            if not is_pure(op):
                for n in op.output_names():
                    const_vals.pop(n, None)
                continue
            is_source = op.type in _CONST_SOURCES and not op.inputs
            if not is_source and (not op.input_names() or any(
                    n not in const_vals for n in op.input_names())):
                for n in op.output_names():
                    const_vals.pop(n, None)
                continue
            outs = op.output_names()
            try:
                val = self._evaluate(get_lowering, op, const_vals)
            except Exception:  # noqa: BLE001 — an op that cannot fold stays
                val = None
            if val is None:
                for n in outs:
                    const_vals.pop(n, None)
                continue
            name = outs[0]
            const_vals[name] = val
            # replacing a source with assign_value is churn, not progress —
            # only rewrite ops that actually *consumed* constants
            if is_source or op.type == "assign_value":
                continue
            attrs = self._assign_value_attrs(val)
            if attrs is None:
                continue
            slot = next(iter(op.outputs))
            block.replace_op(idx, "assign_value", {}, {slot: [name]}, attrs)
            folded += 1
        return {"changed": folded > 0, "folded": folded}

    @staticmethod
    def _evaluate(get_lowering, op, const_vals):
        """Run the op's lowering on CPU tensors; single-output pure ops
        only, bounded result size."""
        if sum(len(v) for v in op.outputs.values()) != 1:
            return None
        lowering = get_lowering(op.type)
        ins = {slot: [const_vals[n] for n in names]
               for slot, names in op.inputs.items()}
        outs = lowering(ins, op.attrs, op)
        vals = outs.get(next(iter(op.outputs)), [])
        if len(vals) != 1 or not isinstance(vals[0], torch.Tensor):
            return None
        val = vals[0].detach().cpu()
        if val.numel() == 0 or val.numel() > _FOLD_MAX_ELEMS:
            return None
        return val

    @staticmethod
    def _assign_value_attrs(val: torch.Tensor) -> Optional[Dict[str, Any]]:
        if val.dtype.is_floating_point:
            # Python floats are f64: exact carriers for f32/bf16 values
            values = {"fp32_values":
                      [float(x) for x in val.double().flatten().tolist()]}
        elif val.dtype in (torch.int8, torch.int32, torch.int64,
                           torch.bool):
            values = {"int32_values":
                      [int(x) for x in val.flatten().tolist()]}
        else:
            return None
        return {"shape": [int(d) for d in val.shape],
                "dtype": _dtype_mod.dtype_name(val.dtype), **values}


class CSE(Pass):
    """Common-subexpression elimination by value numbering: two pure ops
    with the same type, attrs, and value-numbered inputs compute the same
    thing — the later one's reads are redirected to the first and the
    duplicate is deleted (random ops are never merged)."""

    name = "cse"

    def run(self, program, ctx):
        block = program.global_block()
        table: Dict[tuple, int] = {}
        vn: Dict[str, tuple] = {}
        renames: Dict[str, str] = {}
        dups: List[int] = []
        for idx, op in enumerate(block.ops):
            key = self._key(op, vn) if is_pure(op) else None
            if key is None:
                for n in op.output_names():
                    vn[n] = ("opaque", idx)
                continue
            first = table.setdefault(key, idx)
            if first == idx or not self._mergeable(block, ctx, op):
                for slot, names in op.outputs.items():
                    for i, n in enumerate(names):
                        vn[n] = ("cse", table[key], slot, i)
                continue
            # duplicate of block.ops[first]: alias outputs slot-by-slot
            prev = block.ops[first]
            for slot, names in op.outputs.items():
                for i, n in enumerate(names):
                    renames[n] = prev.outputs[slot][i]
                    vn[n] = ("cse", first, slot, i)
            dups.append(idx)
        if not dups:
            return {"changed": False, "deduped": 0}
        for op in block.ops:
            for slot, names in op.inputs.items():
                if any(n in renames for n in names):
                    op.inputs[slot] = [renames.get(n, n) for n in names]
        for idx in reversed(dups):
            block.remove_op(idx)
        return {"changed": True, "deduped": len(dups)}

    @staticmethod
    def _key(op, vn):
        try:
            return (op.type, _canon_attrs(op.attrs),
                    tuple(sorted((slot, tuple(vn.get(n, ("ext", n))
                                              for n in names))
                                 for slot, names in op.inputs.items())),
                    tuple(sorted((slot, len(names))
                                 for slot, names in op.outputs.items())))
        except TypeError:
            return None                      # unhashable attr: skip

    @staticmethod
    def _mergeable(block, ctx, op):
        return not any(ctx.protected(block, n) for n in op.output_names())


class DCE(Pass):
    """Dead-op + dead-var elimination: remove ops that reach no fetch, no
    persistable write, and no effect, then drop var-table entries nothing
    references."""

    name = "dce"

    def run(self, program, ctx):
        block = program.global_block()
        live, _ = liveness(block, ctx.fetch_names)
        removed = 0
        for idx in range(len(block.ops) - 1, -1, -1):
            if not live[idx]:
                block.remove_op(idx)
                removed += 1
        dropped = self._sweep_vars(block, ctx)
        return {"changed": removed > 0 or dropped > 0,
                "ops_removed": removed, "vars_removed": dropped}

    @staticmethod
    def _sweep_vars(block, ctx):
        referenced: Set[str] = set()
        for op in block.ops:
            referenced.update(op.input_names())
            referenced.update(op.output_names())
        dead = [n for n, v in block.vars.items()
                if n not in referenced and not v.persistable
                and not v.is_data and n not in ctx.fetch_names
                and n not in ctx.feed_names]
        for n in dead:
            block.remove_var(n)
        return len(dead)


class FuseConvBNAct(Pass):
    """conv2d → batch_norm [→ act] ⇒ ``fused_conv2d_bn_act``
    (ref conv_bn_fuse_pass.cc + conv_elementwise_add_act_fuse_pass.cc).

    The fused op keeps the ``MeanOut``/``VarianceOut`` running-stat writes
    of a training batch_norm (which alias ``Mean``/``Variance`` in place,
    as layers.batch_norm emits them) and records ``is_test``/``momentum``;
    its lowering (static/ops_fused.py) serves both modes."""

    name = "fuse_conv_bn_act"

    def run(self, program, ctx):
        from .ops_fused import FUSABLE_ACTS

        block = program.global_block()
        fused = 0
        while True:
            match = self._find(block, ctx, FUSABLE_ACTS)
            if match is None:
                break
            self._apply(block, *match)
            fused += 1
        return {"changed": fused > 0, "fused": fused}

    def _find(self, block, ctx, fusable_acts):
        defs, uses = use_def_chains(block)
        for idx, conv in enumerate(block.ops):
            if conv.type != "conv2d":
                continue
            conv_out = conv.outputs.get("Output", [None])[0]
            if conv_out is None or ctx.protected(block, conv_out):
                continue
            use = _single_def_use(defs, uses, conv_out)
            if use is None or use[1] != "X":
                continue
            j = use[0]
            bn = block.ops[j]
            if bn.type != "batch_norm" or j <= idx:
                continue
            # the running-stat write-back must be the in-place alias
            if (bn.outputs.get("MeanOut", [None])[0]
                    != bn.inputs.get("Mean", [None])[0]
                    or bn.outputs.get("VarianceOut", [None])[0]
                    != bn.inputs.get("Variance", [None])[0]):
                continue
            bn_y = bn.outputs.get("Y", [None])[0]
            if bn_y is None:
                continue
            k = None
            act = ""
            y_use = _single_def_use(defs, uses, bn_y)
            if (y_use is not None and y_use[1] == "X"
                    and not ctx.protected(block, bn_y)):
                cand = block.ops[y_use[0]]
                if (y_use[0] > j and cand.type in fusable_acts
                        and not cand.attrs
                        and len(cand.outputs.get("Out", ())) == 1):
                    k, act = y_use[0], cand.type
            return idx, j, k, act
        return None

    @staticmethod
    def _apply(block, idx, j, k, act):
        conv, bn = block.ops[idx], block.ops[j]
        final = (block.ops[k].outputs["Out"][0] if k is not None
                 else bn.outputs["Y"][0])
        ins = {"Input": conv.inputs["Input"],
               "Filter": conv.inputs["Filter"],
               "Mean": bn.inputs["Mean"], "Variance": bn.inputs["Variance"],
               "Scale": bn.inputs["Scale"], "BnBias": bn.inputs["Bias"]}
        if conv.inputs.get("Bias"):
            ins["Bias"] = conv.inputs["Bias"]
        attrs = {"strides": conv.attrs.get("strides", 1),
                 "paddings": conv.attrs.get("paddings", 0),
                 "dilations": conv.attrs.get("dilations", 1),
                 "groups": conv.attrs.get("groups", 1),
                 "data_format": conv.attrs.get("data_format", "NCHW"),
                 "epsilon": bn.attrs.get("epsilon", 1e-5), "act": act,
                 "is_test": bn.attrs.get("is_test", False),
                 "momentum": bn.attrs.get("momentum", 0.9)}
        outs = {"Output": [final]}
        if not attrs["is_test"]:
            # training: the running-stat updates are real — keep them
            outs["MeanOut"] = bn.outputs["MeanOut"]
            outs["VarianceOut"] = bn.outputs["VarianceOut"]
        block.replace_op(idx, "fused_conv2d_bn_act", ins, outs, attrs)
        for dead in sorted([x for x in (j, k) if x is not None],
                           reverse=True):
            block.remove_op(dead)


class FuseMatmulBiasAct(Pass):
    """mul → elementwise_add(1-D bias on the last axis) [→ act] ⇒
    ``fused_matmul_bias_act`` — the fc pattern (ref fc_fuse_pass.cc;
    L.fc emits exactly this op triple)."""

    name = "fuse_matmul_bias_act"

    def run(self, program, ctx):
        from .ops_fused import FUSABLE_ACTS

        block = program.global_block()
        if any(op.type == "backward_region" for op in block.ops):
            return {"changed": False, "fused": 0}
        fused = 0
        while True:
            match = self._find(block, ctx, FUSABLE_ACTS)
            if match is None:
                break
            self._apply(block, *match)
            fused += 1
        return {"changed": fused > 0, "fused": fused}

    def _find(self, block, ctx, fusable_acts):
        defs, uses = use_def_chains(block)
        for idx, mm in enumerate(block.ops):
            if mm.type != "mul":
                continue
            out = mm.outputs.get("Out", [None])[0]
            if out is None or ctx.protected(block, out):
                continue
            use = _single_def_use(defs, uses, out)
            if use is None or use[1] != "X":
                continue
            j = use[0]
            add = block.ops[j]
            if add.type != "elementwise_add" or j <= idx:
                continue
            bias = add.inputs.get("Y", [None])[0]
            if bias is None or not self._last_axis_bias(block, add, out,
                                                        bias):
                continue
            add_out = add.outputs["Out"][0]
            k = None
            act = ""
            a_use = _single_def_use(defs, uses, add_out)
            if (a_use is not None and a_use[1] == "X"
                    and not ctx.protected(block, add_out)):
                cand = block.ops[a_use[0]]
                if (a_use[0] > j and cand.type in fusable_acts
                        and not cand.attrs
                        and len(cand.outputs.get("Out", ())) == 1):
                    k, act = a_use[0], cand.type
            return idx, j, k, act
        return None

    @staticmethod
    def _last_axis_bias(block, add, x_name, bias_name) -> bool:
        """The fused lowering broadcasts a 1-D bias over the LAST axis;
        accept only elementwise_adds that provably mean the same."""
        try:
            if len(block.var(bias_name).shape) != 1:
                return False
            rank = len(block.var(x_name).shape)
        except KeyError:
            return False
        axis = add.attrs.get("axis", -1)
        return axis == -1 or axis == rank - 1

    @staticmethod
    def _apply(block, idx, j, k, act):
        mm, add = block.ops[idx], block.ops[j]
        final = (block.ops[k].outputs["Out"][0] if k is not None
                 else add.outputs["Out"][0])
        ins = {"X": mm.inputs["X"], "Y": mm.inputs["Y"],
               "Bias": add.inputs["Y"]}
        attrs = {"x_num_col_dims": mm.attrs.get("x_num_col_dims", 1),
                 "y_num_col_dims": mm.attrs.get("y_num_col_dims", 1),
                 "act": act}
        block.replace_op(idx, "fused_matmul_bias_act", ins, {"Out": [final]},
                         attrs)
        for dead in sorted([x for x in (j, k) if x is not None],
                           reverse=True):
            block.remove_op(dead)


class QuantInfer(Pass):
    """PTQ artifacts => int8 inference ops: a ``conv2d`` / ``mul`` carrying
    ``weight_scale`` attrs (left by the static PostTrainingQuantization,
    slim/quant_static.py) whose activation input comes through a
    ``fake_quantize_dequantize_fixed_scale`` op becomes ``quant_conv2d`` /
    ``quant_mul`` with the input scale in its attrs; the qdq op is deleted
    when nothing else reads it.  A trailing attr-free activation the int8
    epilogue takes is absorbed.  The rewritten ops' lowerings
    (static/ops_fused.py) run the int8 kernels (ops/kernels/int8.py) where
    gated, else a simulate route that replays the removed fake-quant +
    float op bit for bit.  Not in the default pipeline: quantized inference
    opts in through ``QUANT_INFER_PIPELINE`` or ``opt_passes``."""

    name = "quant_infer"

    # op type -> (activation slot, output slot, quant op type)
    _TARGETS = {"conv2d": ("Input", "Output", "quant_conv2d"),
                "mul": ("X", "Out", "quant_mul")}
    # acts the int8 kernels take as epilogue (ops/kernels/int8.EPILOGUE_ACTS)
    _ACTS = frozenset({"relu", "relu6", "sigmoid", "tanh"})

    def run(self, program, ctx):
        block = program.global_block()
        if any(op.type == "backward_region" for op in block.ops):
            return {"changed": False, "fused": 0}   # inference-only rewrite
        rewritten = 0
        while True:
            match = self._find(block, ctx)
            if match is None:
                break
            self._apply(block, *match)
            rewritten += 1
        return {"changed": rewritten > 0, "fused": rewritten}

    def _find(self, block, ctx):
        defs, uses = use_def_chains(block)
        for idx, op in enumerate(block.ops):
            spec = self._TARGETS.get(op.type)
            if spec is None or "weight_scale" not in op.attrs:
                continue
            aslot, oslot, _qtype = spec
            a_name = op.inputs.get(aslot, [None])[0]
            if a_name is None:
                continue
            d = defs.get(a_name, ())
            if len(d) != 1:
                continue
            q_idx = d[0][0]
            qdq = block.ops[q_idx]
            if (qdq.type != "fake_quantize_dequantize_fixed_scale"
                    or q_idx >= idx or "scale" not in qdq.attrs):
                continue
            # the qdq op is removable only when this op is its sole reader
            removable = (len(uses.get(a_name, ())) == 1
                         and not ctx.protected(block, a_name))
            out_name = op.outputs.get(oslot, [None])[0]
            k = None
            act = ""
            o_use = _single_def_use(defs, uses, out_name) \
                if out_name and not ctx.protected(block, out_name) else None
            if o_use is not None and o_use[1] == "X":
                cand = block.ops[o_use[0]]
                if (o_use[0] > idx and cand.type in self._ACTS
                        and not cand.attrs
                        and len(cand.outputs.get("Out", ())) == 1):
                    k, act = o_use[0], cand.type
            return idx, q_idx, removable, k, act
        return None

    def _apply(self, block, idx, q_idx, removable, k, act):
        op, qdq = block.ops[idx], block.ops[q_idx]
        aslot, oslot, qtype = self._TARGETS[op.type]
        ins = dict(op.inputs)
        ins[aslot] = list(qdq.inputs["X"])
        outs = {s: list(names) for s, names in op.outputs.items()}
        if k is not None:
            outs[oslot] = [block.ops[k].outputs["Out"][0]]
        attrs = dict(op.attrs)
        attrs["in_scale"] = float(qdq.attrs["scale"])
        attrs["in_bits"] = int(qdq.attrs.get("bit_length", 8))
        attrs["act"] = act
        block.replace_op(idx, qtype, ins, outs, attrs)
        _m_quant_ops.inc(op=op.type)
        for dead in sorted([x for x in (k, q_idx if removable else None)
                            if x is not None], reverse=True):
            block.remove_op(dead)


_NCHW_TO_NHWC = (0, 2, 3, 1)
_NHWC_TO_NCHW = (0, 3, 1, 2)
# 4-D ops whose lowerings take data_format (ops.py _conv2d/_pool2d,
# ops_fused._fused_conv2d_bn_act / _quant_conv2d)
_LAYOUT_OPS = {"conv2d": ("Input", "Output"),
               "fused_conv2d_bn_act": ("Input", "Output"),
               "quant_conv2d": ("Input", "Output"),
               "pool2d": ("X", "Out")}
# value-wise single-input ops a transpose can sink through unchanged
_SINKABLE = frozenset({
    "relu", "gelu", "sigmoid", "tanh", "relu6", "silu", "swish",
    "leaky_relu", "hard_swish", "softplus", "mish", "elu", "scale", "cast",
    "abs", "exp", "log", "sqrt", "rsqrt", "square",
})


class LayoutNHWC(Pass):
    """End-to-end NHWC layout propagation (ref the conv-layout /
    transfer-layout IR passes).

    Three phases, each exact:
    1. wrap every NCHW conv/fused-conv/pool in ``transpose2`` in/out pairs
       and flip the op's ``data_format`` to NHWC;
    2. sink transposes through value-wise ops (act between conv and pool),
       so back-to-back inverse pairs become adjacent;
    3. cancel adjacent inverse pairs (fetch-protected names get an
       ``assign`` instead of a rename).
    A chain conv→relu→pool thus runs NHWC throughout, with exactly one
    transpose at each NCHW boundary.  Pairs around an op a transpose
    cannot sink through (an is_test dropout) stay; the Executor runs each
    ``transpose2`` as a permuted view, so they cost no copy."""

    name = "layout_nhwc"

    def run(self, program, ctx):
        block = program.global_block()
        if any(op.type == "backward_region" for op in block.ops):
            return {"changed": False}
        wrapped = self._wrap(block)
        sunk = cancelled = 0
        if wrapped:
            for _ in range(64):                       # fixpoint, bounded
                s = self._sink(block)
                c = self._cancel(block, ctx)
                sunk += s
                cancelled += c
                if not s and not c:
                    break
        return {"changed": wrapped > 0, "converted": wrapped,
                "transposes_sunk": sunk, "transposes_cancelled": cancelled}

    # -- phase 1: local NHWC wrap -------------------------------------------
    def _wrap(self, block) -> int:
        converted = 0
        idx = 0
        while idx < len(block.ops):
            op = block.ops[idx]
            slots = _LAYOUT_OPS.get(op.type)
            if (slots is None
                    or op.attrs.get("data_format", "NCHW") != "NCHW"
                    or not self._rank4(block, op, slots)):
                idx += 1
                continue
            in_slot, out_slot = slots
            x = op.inputs[in_slot][0]
            out = op.outputs[out_slot][0]
            nhwc_in = self._tvar(block, x, _NCHW_TO_NHWC)
            nhwc_out = self._tvar(block, out, _NCHW_TO_NHWC)
            op.inputs[in_slot] = [nhwc_in]
            op.outputs[out_slot] = [nhwc_out]
            op.attrs["data_format"] = "NHWC"
            block.program.bump_version()
            block.insert_op(idx, "transpose2", {"X": [x]},
                            {"Out": [nhwc_in],
                             "XShape": [self._xshape(block, nhwc_in)]},
                            {"axis": list(_NCHW_TO_NHWC)})
            block.insert_op(idx + 2, "transpose2", {"X": [nhwc_out]},
                            {"Out": [out],
                             "XShape": [self._xshape(block, out)]},
                            {"axis": list(_NHWC_TO_NCHW)})
            converted += 1
            idx += 3
        return converted

    @staticmethod
    def _rank4(block, op, slots) -> bool:
        try:
            return (len(block.var(op.inputs[slots[0]][0]).shape) == 4
                    and len(block.var(op.outputs[slots[1]][0]).shape) == 4)
        except (KeyError, IndexError):
            return False

    @staticmethod
    def _tvar(block, name, perm):
        v = block.var(name)
        shape = tuple(v.shape[p] for p in perm)
        return block.create_var(_fresh_name(block, f"{name}.nhwc"), shape,
                                v.dtype).name

    @staticmethod
    def _xshape(block, base):
        return block.create_var(_fresh_name(block, f"{base}.xshape"),
                                (), "float32").name

    # -- phase 2: sink through value-wise ops -------------------------------
    def _sink(self, block) -> int:
        defs, uses = use_def_chains(block)
        for t_idx, t in enumerate(block.ops):
            if t.type != "transpose2":
                continue
            v = t.outputs["Out"][0]
            use = _single_def_use(defs, uses, v)
            if use is None or use[1] != "X":
                continue
            o_idx = use[0]
            op = block.ops[o_idx]
            if (o_idx <= t_idx or op.type not in _SINKABLE
                    or len(op.inputs.get("X", ())) != 1
                    or len(op.outputs.get("Out", ())) != 1):
                continue
            x = t.inputs["X"][0]
            w = op.outputs["Out"][0]
            try:
                v2_shape = block.var(x).shape
                w_dtype = block.var(w).dtype
            except KeyError:
                continue
            v2 = block.create_var(_fresh_name(block, f"{w}.sink"), v2_shape,
                                  w_dtype).name
            xshape = t.outputs.get("XShape", [self._xshape(block, w)])[0]
            axis = list(t.attrs["axis"])
            block.replace_op(t_idx, op.type, {"X": [x]}, {"Out": [v2]},
                             dict(op.attrs))
            block.replace_op(o_idx, "transpose2", {"X": [v2]},
                             {"Out": [w], "XShape": [xshape]},
                             {"axis": axis})
            return 1
        return 0

    # -- phase 3: cancel adjacent inverse pairs -----------------------------
    def _cancel(self, block, ctx) -> int:
        defs, uses = use_def_chains(block)
        for a_idx, a in enumerate(block.ops):
            if a.type != "transpose2":
                continue
            v = a.outputs["Out"][0]
            if ctx.protected(block, v):
                continue
            use = _single_def_use(defs, uses, v)
            if use is None or use[1] != "X":
                continue
            b_idx = use[0]
            b = block.ops[b_idx]
            if b.type != "transpose2" or b_idx <= a_idx:
                continue
            pa = [int(p) for p in a.attrs["axis"]]
            pb = [int(p) for p in b.attrs["axis"]]
            if [pa[p] for p in pb] != list(range(len(pa))):
                continue
            x = a.inputs["X"][0]
            w = b.outputs["Out"][0]
            if ctx.protected(block, w):
                block.replace_op(b_idx, "assign", {"X": [x]}, {"Out": [w]})
                block.remove_op(a_idx)
            else:
                _rewrite_reads(block, w, x)
                block.remove_op(b_idx)
                block.remove_op(a_idx)
            return 1
        return 0


# ---------------------------------------------------------------------------
# VerifiedRewrite: the PV011 interface contract.
# ---------------------------------------------------------------------------

def _norm_dim(d):
    return int(d) if _known(d) else "?"


def _interface_snapshot(program: Program, feed_names, fetch_names
                        ) -> Dict[str, tuple]:
    """fetch name -> (reachable, normalized shape, dtype string) from the
    infer_program symbolic engine.  ``reachable`` means the executor's env
    will actually hold the name after the walk: produced by an op, fed, or
    carried persistable state."""
    _diags, engine = infer_program(program, feed_names=feed_names,
                                   fetch_names=fetch_names)
    block = program.global_block()
    produced: Set[str] = set()
    for b in program.blocks:
        for op in b.ops:
            produced.update(op.output_names())
    snap = {}
    for n in fetch_names or ():
        try:
            v = block.var(n)
            fed = v.is_data or v.persistable
        except KeyError:
            fed = False
        fed = fed or n in (feed_names or ())
        reachable = n in produced or fed
        shape = engine.shape_of(block, n)
        dtype = engine.dtype_of(block, n)
        snap[n] = (reachable,
                   None if shape is None else tuple(_norm_dim(d)
                                                    for d in shape),
                   None if dtype is None else str(dtype))
    return snap


def _verify_interface(before: Dict[str, tuple], after: Dict[str, tuple]
                      ) -> List[Diagnostic]:
    """PV011: the fetch-reachable interface must survive the rewrite."""
    diags = []
    for name, (was_reachable, shape0, dtype0) in before.items():
        reachable, shape1, dtype1 = after.get(name, (False, None, None))
        if was_reachable and not reachable:
            diags.append(Diagnostic(
                "PV011", "error",
                f"rewrite broke the fetch interface: {name!r} is no longer "
                "produced or fed", var=name,
                hint="a pass removed or renamed the producing op"))
            continue
        if shape0 is not None and shape1 is not None:
            bad_rank = len(shape0) != len(shape1)
            bad_dim = not bad_rank and any(
                a != "?" and b != "?" and a != b
                for a, b in zip(shape0, shape1))
            if bad_rank or bad_dim:
                diags.append(Diagnostic(
                    "PV011", "error",
                    f"rewrite changed fetch {name!r} inferred shape "
                    f"{shape0} -> {shape1}", var=name,
                    hint="passes must preserve every fetch's shape"))
        if dtype0 is not None and dtype1 is not None and dtype0 != dtype1:
            diags.append(Diagnostic(
                "PV011", "error",
                f"rewrite changed fetch {name!r} inferred dtype "
                f"{dtype0} -> {dtype1}", var=name,
                hint="passes must preserve every fetch's dtype"))
    return diags


def verify_rewrite(original: Program, rewritten: Program,
                   feed_names: Optional[Sequence[str]] = None,
                   fetch_names: Optional[Sequence[str]] = None) -> None:
    """Standalone VerifiedRewrite check between two programs: proves the
    rewritten program still serves the original's fetch interface (PV011
    on violation) and re-runs the full program walker on it.  Raises
    ``ProgramVerificationError``; returns None when the rewrite holds."""
    feeds = set(feed_names or ())
    fetches = tuple(fetch_names or ())
    diags = _verify_interface(
        _interface_snapshot(original, feeds, fetches),
        _interface_snapshot(rewritten, feeds, fetches))
    if diags:
        raise _errors.ProgramVerificationError(
            "graph-rewrite verification failed (PV011):\n"
            + _errors.render_diagnostics(diags), diagnostics=diags)
    check_program(rewritten, feed_names=sorted(feeds) or None,
                  fetch_names=fetches or None)


# ---------------------------------------------------------------------------
# PassManager + pipeline.
# ---------------------------------------------------------------------------

_PASSES_SCHEMA = 1  # bump on any semantics change

_REGISTRY: Dict[str, Pass] = {p.name: p for p in (
    ConstantFolding(), CSE(), FuseConvBNAct(), FuseMatmulBiasAct(),
    QuantInfer(), LayoutNHWC(), DCE(),
)}

DEFAULT_PIPELINE = ("constant_folding", "cse", "fuse_conv_bn_act",
                    "fuse_matmul_bias_act", "layout_nhwc", "dce")

# the opt-in pipeline for PTQ-calibrated inference programs: fold the quant
# artifacts into int8 ops first, then lay out NHWC (quant_conv2d is in
# _LAYOUT_OPS) and sweep the orphaned qdq chains
QUANT_INFER_PIPELINE = ("constant_folding", "cse", "quant_infer",
                        "fuse_matmul_bias_act", "layout_nhwc", "dce")


def available_passes() -> List[str]:
    return sorted(_REGISTRY)


_m_runs = _monitor.counter(
    "passes.runs", "Pass-pipeline applications (one per Executor cache "
    "miss with opt_passes on, plus direct PassManager.apply calls).")
_m_rollbacks = _monitor.counter(
    "passes.rollbacks", "Pipelines abandoned because a pass or the "
    "rewrite check failed — the Executor ran the original program.")
_m_ops_removed = _monitor.counter(
    "passes.ops_removed", "Ops removed by rewrite passes, labeled by pass.",
    labelnames=("pass",))
_m_ops_fused = _monitor.counter(
    "passes.ops_fused", "Op patterns collapsed into fused ops, labeled by "
    "pass.", labelnames=("pass",))
_m_pipeline_ms = _monitor.histogram(
    "passes.pipeline_ms", "Wall-clock of one pipeline application "
    "(clone + passes + verification).")
_m_quant_ops = _monitor.counter(
    "quant.ops_rewritten", "float ops rewritten to int8 quant ops by the "
    "quant_infer pass, labeled by the original op type.",
    labelnames=("op",))


@dataclass
class PassReport:
    name: str
    changed: bool
    ops_before: int
    ops_after: int
    stats: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PipelineReport:
    passes: List[PassReport] = field(default_factory=list)
    ops_before: int = 0
    ops_after: int = 0
    elapsed_ms: float = 0.0
    skipped: Optional[str] = None
    fingerprint: str = ""

    @property
    def changed(self) -> bool:
        return any(p.changed for p in self.passes)

    def to_text(self) -> str:
        if self.skipped:
            return f"pipeline skipped: {self.skipped}"
        lines = [f"pipeline {self.fingerprint}: "
                 f"{self.ops_before} -> {self.ops_after} ops "
                 f"({self.elapsed_ms:.1f} ms)"]
        for p in self.passes:
            extra = ", ".join(f"{k}={v}" for k, v in p.stats.items()
                              if k != "changed" and v)
            lines.append(f"  {p.name:<22} {p.ops_before:>4} -> "
                         f"{p.ops_after:<4}{'  ' + extra if extra else ''}")
        return "\n".join(lines)


class PassManager:
    """Apply a named pass pipeline under the rewrite contract: ``apply``
    clones, stamps PRNG salts, rewrites the clone, checks the fetch
    interface (PV011), re-runs the program verifier, and only then returns
    the rewritten program."""

    def __init__(self, passes: Sequence[str] = DEFAULT_PIPELINE):
        unknown = [p for p in passes if p not in _REGISTRY]
        if unknown:
            raise ValueError(
                f"unknown pass(es) {unknown}; available: "
                f"{available_passes()}")
        self.pass_names = tuple(passes)

    def fingerprint(self) -> str:
        """Human-readable pipeline identity."""
        return f"v{_PASSES_SCHEMA}:" + "+".join(self.pass_names)

    def apply(self, program: Program,
              feed_names: Optional[Sequence[str]] = None,
              fetch_names: Optional[Sequence[str]] = None
              ) -> Tuple[Program, PipelineReport]:
        t0 = time.perf_counter()
        report = PipelineReport(fingerprint=self.fingerprint())
        report.ops_before = sum(len(b.ops) for b in program.blocks)
        if len(program.blocks) > 1:
            # Program.clone is block-0 only: control-flow programs run as-is
            report.skipped = "program has sub-blocks"
            report.ops_after = report.ops_before
            return program, report
        _m_runs.inc()
        fetches = tuple(fetch_names or ())
        ctx = PassContext(feed_names=set(feed_names or ()),
                          fetch_names=fetches)
        before = _interface_snapshot(program, ctx.feed_names, fetches)
        work = program.clone()
        _stamp_rng_salts(work)
        for name in self.pass_names:
            p = _REGISTRY[name]
            n0 = len(work.global_block().ops)
            stats = p.run(work, ctx)
            n1 = len(work.global_block().ops)
            report.passes.append(PassReport(
                name, bool(stats.get("changed")), n0, n1, stats))
            if n0 > n1:
                _m_ops_removed.inc(n0 - n1, **{"pass": name})
            if stats.get("fused"):
                _m_ops_fused.inc(stats["fused"], **{"pass": name})
        report.ops_after = len(work.global_block().ops)
        diags = _verify_interface(
            before, _interface_snapshot(work, ctx.feed_names, fetches))
        if diags:
            raise _errors.ProgramVerificationError(
                "graph-rewrite verification failed (PV011):\n"
                + _errors.render_diagnostics(diags), diagnostics=diags)
        # the rewritten program must satisfy the full PV001-PV010 walker
        check_program(work, feed_names=sorted(ctx.feed_names) or None,
                      fetch_names=fetches or None)
        report.elapsed_ms = (time.perf_counter() - t0) * 1000.0
        _m_pipeline_ms.observe(report.elapsed_ms)
        return work, report


def pipeline_from_flag(value) -> Optional[PassManager]:
    """Parse the ``opt_passes`` flag: "" -> off; "1"/"true"/"default" ->
    the default pipeline; a comma list -> exactly those passes."""
    if not value:
        return None
    text = str(value).strip()
    if text.lower() in ("1", "true", "default", "on"):
        return PassManager(DEFAULT_PIPELINE)
    return PassManager(tuple(s.strip() for s in text.split(",") if s.strip()))


def optimize_for_executor(program: Program, flag_value, feed_names,
                          fetch_names) -> Tuple[Program, str]:
    """Executor entry: (program to run, pipeline fingerprint).  Any failure
    of the pipeline rolls back to the original program and counts
    ``passes.rollbacks`` — the run still happens, unoptimized."""
    pm = pipeline_from_flag(flag_value)
    if pm is None:
        return program, ""
    try:
        work, report = pm.apply(program, feed_names, fetch_names)
    except Exception:  # noqa: BLE001 — rollback is the contract
        _m_rollbacks.inc()
        return program, ""
    if report.skipped:
        return program, ""
    return work, pm.fingerprint()


# ---------------------------------------------------------------------------
# Golden-parity harness: execute original vs rewritten, compare.
# ---------------------------------------------------------------------------

@dataclass
class ParityReport:
    ok: bool
    max_abs_err: float
    per_fetch: Dict[str, float]
    state_max_err: float
    message: str = ""

    def to_text(self) -> str:
        verdict = "PARITY OK" if self.ok else "PARITY FAILED"
        per = ", ".join(f"{k}={v:.3g}" for k, v in self.per_fetch.items())
        return (f"{verdict}: max|err|={self.max_abs_err:.3g} "
                f"(state {self.state_max_err:.3g}) [{per}]"
                + (f" — {self.message}" if self.message else ""))


def _compare(a, b, rtol, atol):
    """(max abs err, within tolerance) of two numpy arrays; integers and
    bools must be equal."""
    if a.dtype.kind in ("i", "u", "b"):
        err = float(np.max(np.abs(a.astype(np.int64) - b.astype(np.int64)))) \
            if a.size else 0.0
        return err, err == 0.0
    a, b = a.astype(np.float64), b.astype(np.float64)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    return err, bool(np.allclose(a, b, rtol=rtol, atol=atol))


def golden_parity(original: Program, rewritten: Program, feed: Dict,
                  fetch_names: Sequence[str],
                  state: Optional[Dict[str, Any]] = None,
                  rtol: float = 1e-5, atol: float = 1e-6,
                  place=None) -> ParityReport:
    """Run both programs from identical state on ``place`` (None: CUDA)
    and compare: integer/bool fetches equal, floats within ``rtol/atol``;
    the final persistable state is compared too."""
    from .executor import Executor, Scope, to_numpy

    def run(prog):
        scope = Scope()
        for k, v in (state or {}).items():
            scope.set(k, np.array(v, copy=True))
        outs = Executor(place).run(
            prog, feed={k: np.asarray(v) for k, v in feed.items()},
            fetch_list=list(fetch_names), scope=scope, return_numpy=True)
        final = {k: to_numpy(scope.find_var(k)) for k in (state or {})}
        return outs, final

    outs0, state0 = run(original)
    outs1, state1 = run(rewritten)
    per_fetch: Dict[str, float] = {}
    ok = True
    msg = ""
    max_err = 0.0
    for name, a, b in zip(fetch_names, outs0, outs1):
        if a.shape != b.shape or a.dtype != b.dtype:
            ok, msg = False, (f"fetch {name!r}: {a.dtype}{a.shape} vs "
                              f"{b.dtype}{b.shape}")
            per_fetch[name] = float("inf")
            continue
        err, good = _compare(a, b, rtol, atol)
        if not good:
            ok, msg = False, f"fetch {name!r} out of tolerance"
        per_fetch[name] = err
        max_err = max(max_err, err)
    state_err = 0.0
    for k in state0:
        a, b = state0[k], state1.get(k)
        if b is None or a.shape != b.shape:
            ok, msg = False, f"state {k!r} shape/presence diverged"
            state_err = float("inf")
            continue
        e, good = _compare(a, b, rtol, atol)
        if not good:
            ok, msg = False, f"state {k!r} out of tolerance"
        state_err = max(state_err, e)
    return ParityReport(ok, max_err, per_fetch, state_err, msg)
