"""Parameter and layer attributes (a copy of ``paddle_tpu/attr.py``
trimmed to what the training slice reads).

Decay, clipping, sharding, update hooks and per-layer device labels wait
for the slices that read them; passing them raises ``TypeError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class ParamAttr:
    """Per-parameter attributes: a shared name, an initializer, a learning
    rate multiplier, and ``is_static`` (never updated)."""

    name: Optional[str] = None
    initializer: Any = None          # paddle_tpu_torch.initializer.*
    learning_rate: float = 1.0       # per-parameter LR multiplier
    is_static: bool = False          # frozen parameter (no update)

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, dict):
            return ParamAttr(**arg)
        raise TypeError(f"cannot convert {arg!r} to ParamAttr")


@dataclass
class ExtraAttr:
    """Extra layer attributes: dropout only (``drop_rate``, applied to the
    layer's output in training)."""

    drop_rate: float = 0.0

    @staticmethod
    def to_attr(arg) -> "ExtraAttr":
        if arg is None:
            return ExtraAttr()
        if isinstance(arg, ExtraAttr):
            return arg
        if isinstance(arg, dict):
            return ExtraAttr(**arg)
        raise TypeError(f"cannot convert {arg!r} to ExtraAttr")
