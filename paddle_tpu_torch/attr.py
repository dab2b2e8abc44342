"""Parameter and layer attributes (a copy of ``paddle_tpu/attr.py``).

``ParamAttr.sharding`` and ``ExtraAttr.sharding``/``device`` are carried
as data: they take effect over a device mesh, which the port does not
have yet, as they do nothing in the JAX package without one.
``sparse_update`` and ``dtype`` are carried as data in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence


@dataclass
class HookAttr:
    """Parameter updater hook.  ``type='pruning'``: a static mask made
    once from the initial weights keeps the largest (1 - sparsity_ratio)
    fraction by |value|; the optimizer applies it to every gradient and
    every updated value."""

    type: str = "pruning"
    sparsity_ratio: float = 0.6

    @staticmethod
    def to_hooks(arg) -> "list[HookAttr]":
        if arg is None:
            return []
        if isinstance(arg, HookAttr):
            return [arg]
        if isinstance(arg, dict):
            return [HookAttr(**arg)]
        return [HookAttr(**h) if isinstance(h, dict) else h for h in arg]


# the reference's name for the same concept
HookAttribute = HookAttr


@dataclass
class ParamAttr:
    """Per-parameter attributes: a shared name, an initializer, a learning
    rate multiplier, L1/L2 decay (overriding the optimizer's
    regularizer), ``is_static`` (never updated), a per-parameter gradient
    clip, pruning hooks, and the placement fields carried as data."""

    name: Optional[str] = None
    initializer: Any = None          # paddle_tpu_torch.initializer.*
    learning_rate: float = 1.0       # per-parameter LR multiplier
    l1_decay: float = 0.0
    l2_decay: float = 0.0
    is_static: bool = False          # frozen parameter (no update)
    sparse_update: bool = False      # row-sparse gradient (embedding tables)
    gradient_clipping_threshold: float = 0.0
    sharding: Optional[Sequence[Optional[str]]] = None
    dtype: Any = None                # parameter dtype override
    update_hooks: Any = None         # HookAttr / list (pruning masks)

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


# the reference's name for the same concept
ParameterAttribute = ParamAttr


@dataclass
class ExtraAttr:
    """Extra layer attributes: dropout (``drop_rate``, applied to the
    layer's output in training), ``error_clipping_threshold`` (the
    gradient flowing into the layer's output clipped to [-t, t]), and
    the output ``sharding`` and stage ``device`` label, carried as
    data."""

    drop_rate: float = 0.0
    sharding: Optional[Sequence[Optional[str]]] = None   # output sharding
    device: Optional[int] = None                         # v1 stage label
    error_clipping_threshold: float = 0.0                # clip activations' grad

    @staticmethod
    def to_attr(arg) -> "ExtraAttr":
        if arg is None:
            return ExtraAttr()
        if isinstance(arg, ExtraAttr):
            return arg
        if isinstance(arg, dict):
            return ExtraAttr(**arg)
        raise TypeError(f"cannot convert {arg!r} to ExtraAttr")


ExtraLayerAttribute = ExtraAttr
