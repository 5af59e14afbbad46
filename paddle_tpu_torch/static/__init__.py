"""paddle_tpu_torch.static — the static-graph (Fluid-style) programming
model (counterpart of paddle_tpu.static).

Build a Program with ``static.layers`` / ``static.nets`` under
``program_guard``, append its training with
``static.optimizer.<Name>(...).minimize(loss)`` (``append_backward`` and
one update op per parameter), initialise its parameters with
``Executor.run(startup)`` and run it with ``Executor.run(main, feed,
fetch_list)``.  With the
``opt_passes`` flag at ``"default"`` the Executor runs the pass pipeline's
rewrite (conv + BN + act fusion, NHWC layout), whose fused convolutions and
NHWC pools take the port's CUDA kernels.

The Executor verifies a program before its first op (``check_program``:
the PV001-PV010 walker and symbolic shape engine of ``static.analysis``)
and prices its peak memory per feed shape (``check_memory``:
``static.memcheck``), raising ``ProgramVerificationError`` on an error;
``static.shardcheck`` checks a Program against a ``ShardingPlan``.

Ported so far: the program model, the whole ``static.layers`` DSL and
``static.nets``, every op lowering of the JAX package's registry
(``ops.py``, ``ops_tail.py`` to ``ops_tail7.py``, ``ops_fused.py``),
control flow (``cond``, ``while_loop``, ``StaticRNN`` and the compare /
logical DSL), model I/O (``save`` / ``load``, ``save_inference_model`` /
``load_inference_model``, ``save_persistables`` / ``load_persistables``,
in the JAX package's native format or the reference's ``__model__``
format), ``append_backward`` / ``gradients`` and the eleven static
optimizers, the default pass pipeline, the int8 ``QUANT_INFER_PIPELINE``
for programs quantized by ``slim.PostTrainingQuantization`` or frozen after
quantization-aware training, the three static checkers and the Executor.
Still to port (ROADMAP): ``CompiledProgram`` and the Executor's use of a
``ShardingPlan``, and the compile cache.
"""
from . import layers, optimizer
from . import layers_tail  # noqa: F401 — the DSL tail (attaches to layers)
from . import control_flow
from . import nets
from .backward import append_backward, gradients
from .control_flow import (
    StaticRNN,
    cond,
    equal,
    greater_equal,
    greater_than,
    increment,
    less_equal,
    less_than,
    logical_and,
    logical_not,
    logical_or,
    logical_xor,
    not_equal,
    while_loop,
)
from .executor import Executor, Scope, global_scope, scope_guard
from .framework import (
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
    unique_name,
)
from .io import (
    load,
    load_inference_model,
    load_persistables,
    save,
    save_inference_model,
    save_persistables,
)
from .passes import (DEFAULT_PIPELINE, QUANT_INFER_PIPELINE, PassManager,
                     available_passes, golden_parity, optimize_for_executor)
from .registry import register_op, registered_ops
from . import op_version
from . import analysis, memcheck, shardcheck
from .analysis import (Diagnostic, check_program, check_program_cached,
                       infer_program, shape_rule_coverage, verify_program)
from .shardcheck import check_plan, estimate_comm, verify_plan

data = layers.data

__all__ = ["layers", "nets", "optimizer", "control_flow", "op_version",
           "StaticRNN", "cond", "equal", "greater_equal",
           "greater_than", "increment", "less_equal", "less_than",
           "logical_and", "logical_not", "logical_or", "logical_xor",
           "not_equal", "while_loop", "load", "load_inference_model",
           "load_persistables", "save", "save_inference_model",
           "save_persistables", "append_backward", "gradients",
           "Executor", "Scope", "global_scope",
           "scope_guard", "Block", "Operator", "Parameter", "Program",
           "Variable", "default_main_program", "default_startup_program",
           "name_scope", "program_guard", "unique_name", "DEFAULT_PIPELINE",
           "QUANT_INFER_PIPELINE",
           "PassManager", "available_passes", "golden_parity",
           "optimize_for_executor", "register_op", "registered_ops", "data",
           "analysis", "memcheck", "shardcheck", "Diagnostic",
           "check_program", "check_program_cached", "infer_program",
           "shape_rule_coverage", "verify_program", "check_plan",
           "estimate_comm", "verify_plan"]
