"""Topology: the layer graph and its execution (the port of
``paddle_tpu/topology.py:38-318``).

Layer functions build a DAG of :class:`LayerOutput` nodes; a
:class:`Topology` freezes the transitive closure of the requested outputs
into a topological order and runs it eagerly in ``forward``.  There is no
hand-written backward: ``torch.autograd`` differentiates ``forward`` as
``jax.grad`` does in the JAX package.

Not yet ported: ``remat_scope`` (activation checkpointing), model state
slots (batch-norm statistics) and the per-node RNG stream (dropout runs at
rate 0 in this slice).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.data_type import InputType
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that

# ---------------------------------------------------------------------------
# Graph nodes
# ---------------------------------------------------------------------------

_name_counters: Dict[str, int] = {}


def unique_name(prefix: str) -> str:
    idx = _name_counters.get(prefix, 0)
    _name_counters[prefix] = idx + 1
    return f"{prefix}_{idx}"


def reset_name_scope() -> None:
    _name_counters.clear()


@dataclass
class ParamSpec:
    """Declared parameter of a layer node."""

    shape: Tuple[int, ...]
    attr: ParamAttr = field(default_factory=ParamAttr)
    dtype: Any = torch.float32


class Context:
    """Per-forward execution context handed to each node's compute fn."""

    def __init__(self, train: bool):
        self.train = train


@dataclass
class LayerOutput:
    """A node in the layer graph; also the user-facing handle."""

    name: str
    layer_type: str
    inputs: List["LayerOutput"]
    # fn(ctx, params: dict, inputs: list of values) -> value
    fn: Optional[Callable[[Context, Dict[str, torch.Tensor], List[Any]], Any]]
    params: Dict[str, ParamSpec] = field(default_factory=dict)
    size: Optional[int] = None          # feature dimension
    is_sequence: bool = False           # value is a SequenceBatch
    is_cost: bool = False               # per-example loss output
    input_type: Optional[InputType] = None   # data layers only
    declare_idx: int = 0                # data layers: declaration order

    def __post_init__(self):
        enforce_that(self.name is not None, "layer needs a name")

    # graph sugar: l1 + l2 = addto
    def __add__(self, other: "LayerOutput") -> "LayerOutput":
        from paddle_tpu_torch import layer as L

        return L.addto(input=[self, other])

    def __repr__(self):
        return (f"LayerOutput({self.name!r}, type={self.layer_type!r}, "
                f"size={self.size})")


def topological_order(outputs: Sequence[LayerOutput]) -> List[LayerOutput]:
    seen: Dict[str, LayerOutput] = {}
    order: List[LayerOutput] = []

    def visit(node: LayerOutput, stack: Tuple[int, ...]):
        if node.name in seen:
            enforce_that(seen[node.name] is node,
                         f"two different layers named {node.name!r}",
                         context="topology")
            return
        if id(node) in stack:
            raise EnforceError(f"cycle through layer {node.name!r}",
                               context="topology")
        for inp in node.inputs:
            visit(inp, stack + (id(node),))
        # a transitively-visited input may have claimed this name already
        enforce_that(seen.get(node.name, node) is node,
                     f"two different layers named {node.name!r}",
                     context="topology")
        seen[node.name] = node
        order.append(node)

    for out in outputs:
        visit(out, ())
    return order


# ---------------------------------------------------------------------------
# Topology
# ---------------------------------------------------------------------------


class Topology:
    """Frozen graph over the transitive closure of ``outputs``."""

    def __init__(self, outputs: Union[LayerOutput, Sequence[LayerOutput]]):
        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs: List[LayerOutput] = list(outputs)
        self.nodes: List[LayerOutput] = topological_order(self.outputs)
        self.by_name: Dict[str, LayerOutput] = {n.name: n for n in self.nodes}
        self.data_nodes: List[LayerOutput] = sorted(
            (n for n in self.nodes if n.layer_type == "data"),
            key=lambda n: n.declare_idx)

    def param_specs(self) -> Dict[str, ParamSpec]:
        """Flat parameter table: '<layer>.<param>' -> spec.  An explicit
        ``ParamAttr.name`` shares one tensor between layers."""
        specs: Dict[str, ParamSpec] = {}
        for node in self.nodes:
            for pname, spec in node.params.items():
                full = spec.attr.name or f"{node.name}.{pname}"
                if full in specs:
                    enforce_that(tuple(specs[full].shape) == tuple(spec.shape),
                                 f"shared parameter {full!r} shape mismatch "
                                 f"{specs[full].shape} vs {spec.shape}",
                                 context="topology")
                else:
                    specs[full] = spec
        return specs

    def param_key(self, node: LayerOutput, pname: str) -> str:
        spec = node.params[pname]
        return spec.attr.name or f"{node.name}.{pname}"

    def forward(self, params: Dict[str, torch.Tensor],
                feeds: Dict[str, Any], *, train: bool = False,
                outputs: Optional[Sequence[LayerOutput]] = None) -> List[Any]:
        """Run the graph on ``feeds`` (data layer name -> value) and return
        the values of ``outputs`` (default: the topology's outputs)."""
        wanted = list(outputs) if outputs is not None else self.outputs
        ctx = Context(train=train)
        values: Dict[str, Any] = {}
        for node in topological_order(wanted):
            if node.fn is None:  # data layers
                if node.name not in feeds:
                    raise EnforceError(f"missing feed for data layer "
                                       f"{node.name!r}", context="forward")
                values[node.name] = feeds[node.name]
                continue
            node_params = {p: params[self.param_key(node, p)]
                           for p in node.params}
            ins = [values[i.name] for i in node.inputs]
            try:
                values[node.name] = node.fn(ctx, node_params, ins)
            except Exception as e:
                # name the failing layer so shape/dtype errors point at
                # the config
                e.add_note(
                    f"[paddle_tpu_torch] while computing layer "
                    f"{node.name!r} (type={node.layer_type}, "
                    f"inputs={[i.name for i in node.inputs]})")
                raise
        return [values[w.name] for w in wanted]

    def __repr__(self):
        return (f"Topology({len(self.nodes)} nodes, "
                f"outputs={[o.name for o in self.outputs]})")
