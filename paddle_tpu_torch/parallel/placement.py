"""Placement plans and tensor-parallel fc layers (the port of
``paddle_tpu/parallel/placement.py``).

A plan maps parameter names to specs (one mesh axis or None a dim); the
trainer cuts each rank's part out of the full weights by it
(:func:`paddle_tpu_torch.parallel.api.local_shard`) and gathers the parts
back for a checkpoint, so a checkpoint is the same whatever the layout.

Model parallelism is an fc whose weight is split over an axis:

- ``part="col"``: W split over its output features [in, axis]: each rank
  computes its slice of the output features from the whole input (the
  input enters the split region: its gradient is all-reduced);
- ``part="row"``: W split over its input features [axis, out]: each rank
  multiplies its slice of the features and the partial products are
  all-reduced (before the bias, which stays whole).

A col -> row pair is the Megatron block: no rank holds a whole weight.
JAX states the activation's sharding and GSPMD inserts the all-reduce;
here ``layer.fc`` makes both collectives itself when the context's mesh
has the axis (:mod:`paddle_tpu_torch.parallel.comm`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from paddle_tpu_torch.attr import ExtraAttr, ParamAttr

#: the mesh-axis taxonomy every plan draws from:
#:   data   — batch split; the gradient-sum and ZeRO domain
#:   zero   — the role of ``data`` when ZeRO shards optimizer state
#:   stage  — pipeline stages (stacked layer dim, leading dim split)
#:   expert — MoE experts (stacked expert dim, leading dim split)
#:   model  — tensor parallelism (col/row feature split)
KNOWN_AXES = ("data", "zero", "stage", "expert", "model")


@dataclass(frozen=True)
class _PlanSpec:
    """Adapter: a plan entry in the ``specs[name].attr`` shape
    ``param_sharding`` and ``build_zero_plan`` read."""

    attr: ParamAttr


def plan_param_attrs(plan: Dict[str, Tuple]) -> Dict[str, _PlanSpec]:
    """{name: per-dim axis tuple} -> {name: spec with that sharding};
    entries naming no axis are left out (an explicit all-None spec would
    opt the weight out of ZeRO)."""
    out: Dict[str, _PlanSpec] = {}
    for name, spec in plan.items():
        dims = tuple(spec)
        if any(a is not None for a in dims):
            out[name] = _PlanSpec(attr=ParamAttr(sharding=dims))
    return out


def leading_axis_plan(params: Dict[str, object],
                      axis: str) -> Dict[str, Tuple]:
    """{name: (axis, None, ...)}: the leading dim of every stacked weight
    split over ``axis`` (pipeline stages, MoE experts)."""
    out: Dict[str, Tuple] = {}
    for name, v in params.items():
        nd = getattr(v, "ndim", None)
        if nd is None:
            nd = len(getattr(v, "shape", ()))
        out[name] = (axis,) + (None,) * (int(nd) - 1)
    return out


def pipeline_param_attrs(params: Dict[str, object],
                         axis: str = "stage") -> Dict[str, _PlanSpec]:
    """The pipeline plan: each stacked body weight [L, ...] split over
    ``axis``, so a stage's rank holds its L/S layers."""
    return plan_param_attrs(leading_axis_plan(params, axis))


def expert_param_attrs(params: Dict[str, object],
                       axis: str = "expert") -> Dict[str, _PlanSpec]:
    """The MoE plan: each [E, ...] expert stack split over ``axis``."""
    return plan_param_attrs(leading_axis_plan(params, axis))


def stage_attrs(part: str, axis: str = "model"):
    """(param_attr, layer_attr) of one model-parallel fc."""
    if part == "col":
        pa = ParamAttr(sharding=(None, axis))
        la = ExtraAttr(sharding=(None, axis))
    elif part == "row":
        pa = ParamAttr(sharding=(axis, None))
        la = ExtraAttr(sharding=(None, None))
    else:
        raise ValueError(f"part must be 'col' or 'row', got {part!r}")
    return pa, la


def model_parallel_fc(input, size: int, *, part: str, axis: str = "model",
                      act=None, name: Optional[str] = None,
                      bias_attr=True):
    """fc whose weight and output are split over ``axis`` (col: the bias
    is split with the output features; row: it stays whole)."""
    from paddle_tpu_torch import layer

    pa, la = stage_attrs(part, axis)
    if bias_attr is True and part == "col":
        bias_attr = ParamAttr(sharding=(axis,))
    return layer.fc(input=input, size=size, act=act, name=name,
                    param_attr=pa, bias_attr=bias_attr, layer_attr=la)


def model_parallel_mlp(input, hidden_sizes: Sequence[int], out_size: int,
                       *, axis: str = "model", act: str = "relu",
                       out_act=None, name_prefix: str = "mp"):
    """Alternating col/row tensor-parallel MLP ending in a row fc whose
    output [batch, out_size] is whole on every rank."""
    net = input
    part = "col"
    for i, h in enumerate(hidden_sizes):
        net = model_parallel_fc(net, h, part=part, axis=axis, act=act,
                                name=f"{name_prefix}_fc{i}")
        part = "row" if part == "col" else "col"
    return model_parallel_fc(net, out_size, part="row", axis=axis,
                             act=out_act, name=f"{name_prefix}_out")
