"""paddle_tpu_torch.fluid — the Gen-2 "Fluid prototype" analog (the port
of ``paddle_tpu/fluid``).

Reference: paddle/framework (ProgramDesc/Scope/Operator/Executor/autodiff),
paddle/operators (76 op families), python/paddle/v2/framework (graph builder,
Executor, layers, optimizer) — see SURVEY.md §2.2.

Design: Program/Block/Operator IR built in python; ``append_backward`` is a
program transform adding grad ops; ``Executor`` runs the op list on torch
ops (on ``cuda`` unless asked for the CPU), its grad ops through autograd
over the graph the forward ops recorded.
"""

from paddle_tpu_torch.fluid import backward, io, layers, optimizer, ops
from paddle_tpu_torch.fluid.backward import append_backward
from paddle_tpu_torch.fluid.executor import Executor, Scope, global_scope
from paddle_tpu_torch.fluid.framework import (Block, Operator, Parameter,
                                              Program, Variable,
                                              default_main_program,
                                              grad_name, program_guard,
                                              reset_default_program)
from paddle_tpu_torch.fluid.ops import LoDArray, registered_ops

__all__ = [
    "backward", "io", "layers", "optimizer", "ops", "append_backward",
    "Executor", "Scope", "global_scope", "Block", "Operator", "Parameter",
    "Program", "Variable", "default_main_program", "grad_name",
    "program_guard", "reset_default_program", "LoDArray", "registered_ops",
]
