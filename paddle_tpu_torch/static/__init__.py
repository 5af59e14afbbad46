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

Ported so far: the program model, the layers and nets that build vision
programs and their losses, their op lowerings (train-mode BN included),
``append_backward`` / ``gradients`` and the eleven static optimizers, the
default pass pipeline, the int8 ``QUANT_INFER_PIPELINE`` for programs
quantized by ``slim.PostTrainingQuantization`` or frozen after
quantization-aware training, and the Executor.  Still to port (ROADMAP):
control flow, io, the program verifier and shape engine, the compile
cache, and memory and sharding checks.
"""
from . import layers, nets, optimizer
from .backward import append_backward, gradients
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
from .passes import (DEFAULT_PIPELINE, QUANT_INFER_PIPELINE, PassManager,
                     available_passes, golden_parity, optimize_for_executor)
from .registry import register_op, registered_ops

data = layers.data

__all__ = ["layers", "nets", "optimizer", "append_backward", "gradients",
           "Executor", "Scope", "global_scope",
           "scope_guard", "Block", "Operator", "Parameter", "Program",
           "Variable", "default_main_program", "default_startup_program",
           "name_scope", "program_guard", "unique_name", "DEFAULT_PIPELINE",
           "QUANT_INFER_PIPELINE",
           "PassManager", "available_passes", "golden_parity",
           "optimize_for_executor", "register_op", "registered_ops", "data"]
