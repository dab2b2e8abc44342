"""Program-level checkpoint IO: the save_restore_op.cc + (later-era)
fluid.io surface (the port of ``paddle_tpu/fluid/io.py``, copied).

Reference: paddle/operators/save_restore_op.cc (SaveOp writes each input
tensor's raw bytes under a folder attr; RestoreOp reads them back). Here
save/restore are host-side ops the Executor runs on their own (an IO-only
program); each variable lands as one ``<dir>/<name>.npy``, the layout the
JAX package writes, so a directory saved by either package restores in
the other.
"""

from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch.fluid.framework import (Parameter, Program, Variable,
                                        default_main_program)
from paddle_tpu_torch.platform.enforce import enforce_that


def _io_program(op_type: str, dirname: str, names: List[str]) -> Program:
    prog = Program()
    blk = prog.global_block()
    vars_ = [blk.create_var(name=n, shape=(1,), persistable=True)
             for n in names]
    if op_type == "save":
        blk.append_op("save", inputs={"X": vars_}, outputs={},
                      attrs={"path": dirname})
    else:
        blk.append_op("restore", inputs={}, outputs={"Out": vars_},
                      attrs={"path": dirname})
    return prog


def _persistable_names(main_program: Optional[Program],
                       predicate) -> List[str]:
    prog = main_program or default_main_program()
    return sorted(v.name for v in prog.global_block().vars.values()
                  if v.persistable and predicate(v))


def save_vars(executor, dirname: str, vars: List[Variable],
              scope=None) -> None:
    names = [v.name if isinstance(v, Variable) else str(v) for v in vars]
    enforce_that(bool(names), "save_vars: nothing to save", context="io")
    executor.run(_io_program("save", dirname, names), scope=scope)


def load_vars(executor, dirname: str, vars: List[Variable],
              scope=None) -> None:
    names = [v.name if isinstance(v, Variable) else str(v) for v in vars]
    enforce_that(bool(names), "load_vars: nothing to load", context="io")
    executor.run(_io_program("restore", dirname, names), scope=scope)


def save_params(executor, dirname: str,
                main_program: Optional[Program] = None, scope=None) -> None:
    """Persist trainable parameters only."""
    names = _persistable_names(main_program,
                               lambda v: isinstance(v, Parameter))
    executor.run(_io_program("save", dirname, names), scope=scope)


def load_params(executor, dirname: str,
                main_program: Optional[Program] = None, scope=None) -> None:
    names = _persistable_names(main_program,
                               lambda v: isinstance(v, Parameter))
    executor.run(_io_program("restore", dirname, names), scope=scope)


def save_persistables(executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope=None) -> None:
    """Persist every persistable var (params + optimizer slots + stats)."""
    names = _persistable_names(main_program, lambda v: True)
    executor.run(_io_program("save", dirname, names), scope=scope)


def load_persistables(executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope=None) -> None:
    names = _persistable_names(main_program, lambda v: True)
    executor.run(_io_program("restore", dirname, names), scope=scope)
