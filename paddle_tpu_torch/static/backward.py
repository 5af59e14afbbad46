"""append_backward for static programs (counterpart of
paddle_tpu/static/backward.py).

Reference parity: python/paddle/fluid/backward.py:1215 ``append_backward``,
which walks the block emitting one grad op per forward op through each
op's GradOpMaker (:862 ``_append_backward_ops_``).

As in the JAX package, no per-op grad ops exist: the program records one
``backward_region`` op carrying the loss and parameter names, plus
``<param>@GRAD`` variables that the optimizer's update ops consume as the
reference's grad vars.  The programs of both packages stay op for op
equal.  The port's Executor computes the region with torch autograd over
the forward it has just run eagerly (static/executor.py).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .framework import Parameter, Program, Variable, default_main_program

GRAD_SUFFIX = "@GRAD"


def _effective_io(program, op):
    """(inputs, outputs) of an op for dataflow purposes.  Control-flow ops
    additionally read every outer variable their sub-blocks reference."""
    ins = set(op.input_names())
    outs = set(op.output_names())
    for _a, blk_idx in op.sub_block_indices():
        blk = program.blocks[blk_idx]
        defined = set()
        for sub in blk.ops:
            si, so = _effective_io(program, sub)
            ins |= {n for n in si if n not in defined}
            defined |= so
    return ins, outs


def _reject_while_ops(program, loss_names, param_names, api_name: str) -> None:
    """Refuse, at build time, a ``while`` op on the parameter -> loss path:
    the reference differentiates it with its own WhileGrad op
    (operators/controlflow/while_op.cc), which neither package has.  While
    ops off the gradient path (counters, preprocessing of fed data) are
    fine.  (The port has no control-flow ops yet; the check keeps the
    reference's contract for when it does.)"""
    def contains_while(op):
        if op.type == "while":
            return True
        return any(contains_while(sub)
                   for _a, blk_idx in op.sub_block_indices()
                   for sub in program.blocks[blk_idx].ops)

    block = program.global_block()
    suspects = [_effective_io(program, op) for op in block.ops
                if contains_while(op)]
    if not suspects:
        return
    # forward: vars transitively computed from the params
    tainted = set(param_names)
    for op in block.ops:
        ins, outs = _effective_io(program, op)
        if ins & tainted:
            tainted |= outs
    # backward: vars the loss transitively reads
    needed = set(loss_names)
    for op in reversed(block.ops):
        ins, outs = _effective_io(program, op)
        if outs & needed:
            needed |= ins
    for ins, outs in suspects:
        if (ins & tainted) and (outs & needed):
            raise NotImplementedError(
                f"{api_name}: a `while` op lies on the parameter→loss "
                "path; static backward through a while loop is "
                "unsupported. Move the loop out of the differentiated "
                "region or use the dygraph autograd path.")


def append_backward(loss: Variable, parameter_list: Optional[List] = None,
                    no_grad_set=None, program: Optional[Program] = None
                    ) -> List[Tuple[Parameter, Variable]]:
    """Returns [(param, grad_var)] like the reference (backward.py:1215)."""
    program = program or default_main_program()
    block = program.global_block()
    if parameter_list:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    no_grad = {v if isinstance(v, str) else v.name for v in (no_grad_set or ())}
    params = [p for p in params if p.name not in no_grad]
    _reject_while_ops(program, [loss.name], [p.name for p in params],
                      "append_backward")

    grad_vars = []
    for p in params:
        g = block.create_var(name=p.name + GRAD_SUFFIX, shape=p.shape,
                             dtype=p.dtype, stop_gradient=True)
        grad_vars.append(g)
    block.append_op(
        "backward_region",
        inputs={"Loss": [loss.name], "Params": [p.name for p in params]},
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs={})
    return list(zip(params, grad_vars))


def gradients(targets, inputs, program: Optional[Program] = None):
    """ref backward.py:1795 ``gradients``: grads of the sum of ``targets``
    with respect to ``inputs`` (parameters, data variables or
    intermediates; an intermediate's gradient is taken through its
    consumers, its producer held fixed)."""
    program = program or default_main_program()
    block = program.global_block()
    tgt = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    _reject_while_ops(program, [t.name for t in tgt], [v.name for v in ins],
                      "gradients")
    grad_vars = []
    for v in ins:
        g = block.create_var(name=v.name + GRAD_SUFFIX, shape=v.shape,
                             dtype=v.dtype, stop_gradient=True)
        grad_vars.append(g)
    block.append_op(
        "backward_region",
        inputs={"Loss": [t.name for t in tgt], "Params": [v.name for v in ins]},
        outputs={"Grads": [g.name for g in grad_vars]},
        attrs={"wrt_any": True})
    return grad_vars
