"""Fluid-analog program IR: Program / Block / Operator / Variable (the
port of ``paddle_tpu/fluid/framework.py``, pure Python, copied).

Reference analog: the ProgramDesc protobuf IR
(paddle/framework/framework.proto:33-137) and its python graph builder
(python/paddle/v2/framework/framework.py:10-483: Variable/Operator/Block/
Program/Parameter).

The IR is a plain-python op graph. Nothing here executes: ``Executor``
(executor.py) runs a Program's ops one after another on torch ops, and
the sub-blocks of the ``recurrent``, ``cond`` and ``dynamic_recurrent``
ops run in a Python loop over their steps.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that

# ---------------------------------------------------------------------------
# dtypes (framework.proto DataType analog)
# ---------------------------------------------------------------------------

_DTYPES = ("float32", "float64", "float16", "bfloat16", "int32", "int64",
           "bool", "uint8")


def normalize_dtype(dtype) -> str:
    s = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    enforce_that(s in _DTYPES, f"unsupported dtype {s}", context="fluid")
    return s


# ---------------------------------------------------------------------------
# Variable (VarDesc analog)
# ---------------------------------------------------------------------------


class Variable:
    """A named tensor slot in a Block (VarDesc analog, framework.proto:89-106).

    ``shape`` may contain -1 in the leading (batch) dim. ``lod_level`` > 0
    marks a LoDTensor-analog: at feed time the value carries ragged sequence
    boundaries (see executor.LoDArray; lod_tensor.h:57-80)."""

    def __init__(self, block: "Block", name: str, shape: Sequence[int] = (),
                 dtype="float32", lod_level: int = 0, persistable: bool = False,
                 trainable: bool = False, stop_gradient: bool = False):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = normalize_dtype(dtype)
        self.lod_level = int(lod_level)
        self.persistable = bool(persistable)
        self.trainable = bool(trainable)
        self.stop_gradient = bool(stop_gradient)
        self.initializer: Optional[dict] = None  # e.g. {"type": "normal", ...}
        self.op: Optional["Operator"] = None     # producing op, if any

    # Sugar so layers compose like expressions.
    def _binop(self, other, op_type):
        from paddle_tpu_torch.fluid import layers as L
        return L._elementwise(op_type, self, other)

    def __add__(self, other):
        return self._binop(other, "elementwise_add")

    def __sub__(self, other):
        return self._binop(other, "elementwise_sub")

    def __mul__(self, other):
        return self._binop(other, "elementwise_mul")

    def __truediv__(self, other):
        return self._binop(other, "elementwise_div")

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, lod={self.lod_level}, "
                f"persistable={self.persistable})")


class Parameter(Variable):
    """A trainable, persistable Variable (framework.py Parameter analog)."""

    def __init__(self, block, name, shape, dtype="float32",
                 initializer: Optional[dict] = None, trainable: bool = True,
                 regularizer=None):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, trainable=trainable)
        enforce_that(all(s > 0 for s in self.shape),
                     f"parameter {name} needs static shape, got {shape}",
                     context="fluid")
        self.initializer = initializer or {"type": "xavier"}
        self.regularizer = regularizer


# ---------------------------------------------------------------------------
# Operator (OpDesc analog)
# ---------------------------------------------------------------------------


@dataclass
class Operator:
    """One op node (OpDesc analog, framework.proto:33-57): a type string,
    named input/output slots each holding variable-name lists, and attrs."""

    type: str
    inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: Dict[str, List[str]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"Operator({self.type}, in={ins}, out={outs})"


# ---------------------------------------------------------------------------
# Block / Program (BlockDesc / ProgramDesc analogs)
# ---------------------------------------------------------------------------


class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    # -- vars ---------------------------------------------------------------

    def create_var(self, name: Optional[str] = None, **kw) -> Variable:
        name = name or self.program.unique_name("tmp")
        enforce_that(name not in self.vars, f"duplicate var {name}",
                     context="fluid")
        v = Variable(self, name, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name: Optional[str] = None, shape=(),
                         dtype="float32", **kw) -> Parameter:
        # parameters always live in block 0 (global scope analog,
        # executor.cc:62-66 persistable→global scope) so sub-block step
        # graphs can route them through op input slots for autodiff
        g = self.program.global_block()
        name = name or self.program.unique_name("param")
        enforce_that(name not in g.vars, f"duplicate param {name}",
                     context="fluid")
        p = Parameter(g, name, shape, dtype=dtype, **kw)
        g.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = (self.program.blocks[b.parent_idx]
                 if b.parent_idx >= 0 else None)
        raise EnforceError(f"variable {name!r} not found in block {self.idx}",
                           context="fluid")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except EnforceError:
            return False

    # -- ops ----------------------------------------------------------------

    def append_op(self, type: str, inputs: Dict[str, Any] = None,
                  outputs: Dict[str, Any] = None,
                  attrs: Dict[str, Any] = None) -> Operator:
        def _names(d):
            out: Dict[str, List[str]] = {}
            for slot, vs in (d or {}).items():
                if vs is None:
                    continue
                vs = vs if isinstance(vs, (list, tuple)) else [vs]
                out[slot] = [v.name if isinstance(v, Variable) else str(v)
                             for v in vs]
            return out

        op = Operator(type=type, inputs=_names(inputs),
                      outputs=_names(outputs), attrs=dict(attrs or {}))
        from paddle_tpu_torch.fluid import ops as op_lib
        op_lib.check_registered(type)
        self.ops.append(op)
        for slot, vs in (outputs or {}).items():
            vs = vs if isinstance(vs, (list, tuple)) else [vs]
            for v in vs:
                if isinstance(v, Variable):
                    v.op = op
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]


class Program:
    """ProgramDesc analog: an ordered list of Blocks; block 0 is global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._name_counters: Dict[str, int] = {}
        self._current_block_idx = 0
        self.random_seed = 0
        self._version = 0  # bumped on mutation → executor cache key

    # -- naming -------------------------------------------------------------

    def unique_name(self, prefix: str) -> str:
        i = self._name_counters.get(prefix, 0)
        self._name_counters[prefix] = i + 1
        return f"{prefix}_{i}"

    # -- blocks -------------------------------------------------------------

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def create_block(self) -> Block:
        parent = self._current_block_idx
        b = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def rollback(self) -> None:
        enforce_that(self._current_block_idx != 0,
                     "rollback() at the global block", context="fluid")
        self._current_block_idx = self.current_block().parent_idx

    # -- introspection ------------------------------------------------------

    def fingerprint(self) -> Tuple:
        """Structural identity for executor compile caching."""
        sig = []
        for b in self.blocks:
            for op in b.ops:
                sig.append((b.idx, op.type,
                            tuple(sorted((k, tuple(v))
                                         for k, v in op.inputs.items())),
                            tuple(sorted((k, tuple(v))
                                         for k, v in op.outputs.items())),
                            tuple(sorted(
                                (k, _hashable(v))
                                for k, v in op.attrs.items()))))
        return tuple(sig)

    def to_string(self) -> str:
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for name, v in b.vars.items():
                kind = "param" if isinstance(v, Parameter) else "var"
                lines.append(f"  {kind} {name}: {v.dtype}{list(v.shape)}"
                             + (f" lod={v.lod_level}" if v.lod_level else ""))
            for op in b.ops:
                lines.append(f"  op {op!r}")
        return "\n".join(lines)

    __str__ = to_string


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return (v.dtype.str, v.shape, v.tobytes())
    return v


# ---------------------------------------------------------------------------
# default program / guards (framework.py g_main_program analog)
# ---------------------------------------------------------------------------

_tls = threading.local()


def _stack() -> List[Program]:
    if not hasattr(_tls, "stack"):
        _tls.stack = [Program()]
    return _tls.stack


def default_main_program() -> Program:
    return _stack()[-1]


def reset_default_program() -> Program:
    _stack()[:] = [Program()]
    return _stack()[-1]


class program_guard:
    """`with program_guard(prog): ...` — layer calls build into `prog`."""

    def __init__(self, program: Program):
        self.program = program

    def __enter__(self):
        _stack().append(self.program)
        return self.program

    def __exit__(self, *exc):
        _stack().pop()
        return False


GRAD_SUFFIX = "@GRAD"


def grad_name(name: str) -> str:
    return name + GRAD_SUFFIX


def prune(program: Program, targets) -> Program:
    """Dead-op elimination: a new Program keeping only ops/vars the target
    variables depend on (framework/prune.cc analog). Grad/optimize ops are
    dropped unless a target depends on them — the inference-program
    extraction path."""
    names = {t.name if isinstance(t, Variable) else str(t) for t in targets}
    src = program.global_block()
    needed = set(names)
    kept: List[tuple] = []          # (old_idx, op)
    for idx in range(len(src.ops) - 1, -1, -1):
        op = src.ops[idx]
        if any(n in needed for n in op.output_names()):
            kept.append((idx, op))
            needed.update(op.input_names())
    kept.reverse()
    keep = [op for _, op in kept]
    # grad ops bind to their forward op positionally; dropping earlier ops
    # shifts indices, so fwd_idx must be remapped into the pruned program
    old_to_new = {old: new for new, (old, _) in enumerate(kept)}

    def copy_op(op: Operator) -> Operator:
        # inner name lists/attrs must not be shared: later mutation of the
        # pruned program must never corrupt the source program
        return Operator(op.type,
                        {k: list(v) for k, v in op.inputs.items()},
                        {k: list(v) for k, v in op.outputs.items()},
                        {k: (list(v) if isinstance(v, list) else v)
                         for k, v in op.attrs.items()})

    out = Program()
    out.random_seed = program.random_seed
    dst = out.global_block()
    block_map = {0: 0}
    for op in keep:
        if "sub_block" in op.attrs:
            sub = program.blocks[int(op.attrs["sub_block"])]
            nb = Block(out, len(out.blocks), parent_idx=0)
            nb.vars = dict(sub.vars)   # Variables are structural leaves
            nb.ops = [copy_op(sop) for sop in sub.ops]
            out.blocks.append(nb)
            block_map[sub.idx] = nb.idx
            for sop in sub.ops:
                needed.update(sop.input_names())
    for name in needed:
        if name in src.vars:
            dst.vars[name] = src.vars[name]
    for op in keep:
        new_op = copy_op(op)
        if "sub_block" in new_op.attrs:
            new_op.attrs["sub_block"] = block_map[
                int(new_op.attrs["sub_block"])]
        if "fwd_idx" in new_op.attrs:
            old = int(new_op.attrs["fwd_idx"])
            enforce_that(old in old_to_new,
                         f"grad op {new_op.type} survives pruning but its "
                         f"forward op (idx {old}) was pruned",
                         context="fluid")
            new_op.attrs["fwd_idx"] = old_to_new[old]
        dst.ops.append(new_op)
    return out
