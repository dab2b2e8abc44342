"""append_backward: the program-level reverse-mode autodiff transform (the
port of ``paddle_tpu/fluid/backward.py``, copied).

Reference analog: AppendBackward / BackwardRecursive
(paddle/framework/backward.cc:101,434; design doc framework/backward.md):
walk the forward ops in reverse, appending one grad op per forward op and
``@GRAD`` variables.

The IR transform is kept (grad ops appear in the Program, inspectable and
prunable), but each grad op carries NO hand-written kernel: the Executor
computes it with ``torch.autograd.grad`` through the graph its forward op
recorded (executor.py), so every op's gradient is exact by construction.
Gradient accumulation for fan-out vars is done by the executor summing
contributions (the reference inserts explicit add ops with @RENAME vars).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from paddle_tpu_torch.fluid import ops as op_lib
from paddle_tpu_torch.fluid.framework import (Block, Operator, Parameter,
                                              Program, Variable, grad_name)
from paddle_tpu_torch.platform.enforce import enforce_that


def append_backward(loss: Variable, parameter_list: Optional[List[str]] = None,
                    no_grad_set: Optional[Set[str]] = None
                    ) -> List[tuple]:
    """Append grad ops for ``loss`` to its program's global block.

    Returns [(param, grad_var)] for all trainable parameters (or
    ``parameter_list``), mirroring the reference's optimizer contract
    (v2/framework/optimizer.py create_backward_pass)."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())

    # ---- forward reachability: which vars feed the loss ------------------
    ops = list(block.ops)
    needed: Set[str] = {loss.name}
    on_path: List[int] = []
    for idx in range(len(ops) - 1, -1, -1):
        op = ops[idx]
        info = op_lib.get(op.type)
        if info.no_grad:
            continue
        if any(n in needed for n in op.output_names()):
            on_path.append(idx)
            needed.update(op.input_names())
    on_path.reverse()

    # ---- seed d loss / d loss = 1 ---------------------------------------
    enforce_that(loss.name not in no_grad, "loss in no_grad_set",
                 context="backward")
    _make_grad_var(block, loss)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [grad_name(loss.name)]},
        attrs={"shape": [1], "value": 1.0, "dtype": loss.dtype,
               "_seed_for": loss.name})

    # ---- one grad op per forward op, reverse order -----------------------
    for idx in reversed(on_path):
        op = ops[idx]
        out_grads = [grad_name(n) for n in op.output_names()]
        in_grads = []
        for n in op.input_names():
            if n in no_grad:
                continue
            v = block.var(n)
            if v.stop_gradient or v.dtype.startswith(("int", "bool", "uint")):
                continue
            _make_grad_var(block, v)
            in_grads.append(grad_name(n))
        if not in_grads:
            continue
        block.append_op(
            type=op.type + "_grad",
            inputs={"OutGrad": out_grads},
            outputs={"InGrad": in_grads},
            attrs={"fwd_idx": idx})

    # ---- collect (param, grad) pairs -------------------------------------
    params_and_grads = []
    for p in block.program.global_block().all_parameters():
        if parameter_list is not None and p.name not in parameter_list:
            continue
        if not p.trainable or p.name in no_grad:
            continue
        gname = grad_name(p.name)
        if block.has_var(gname):
            params_and_grads.append((p, block.var(gname)))
    return params_and_grads


def _make_grad_var(block: Block, v: Variable) -> Variable:
    gname = grad_name(v.name)
    if gname in block.vars:
        return block.vars[gname]
    g = block.create_var(name=gname, shape=v.shape, dtype=v.dtype,
                         lod_level=v.lod_level)
    return g
