"""Topology: the layer graph and its execution (the port of
``paddle_tpu/topology.py:38-318``).

Layer functions build a DAG of :class:`LayerOutput` nodes; a
:class:`Topology` freezes the transitive closure of the requested outputs
into a topological order and runs it eagerly in ``forward``.  There is no
hand-written backward: ``torch.autograd`` differentiates ``forward`` as
``jax.grad`` does in the JAX package.

Model state (batch norm's moving statistics) lives in ``{layer: {slot:
tensor}}`` dicts outside the graph: :meth:`Topology.forward_with_state`
reads the state it is given and returns the updated slots beside the
outputs without changing it, as the JAX package's pure ``forward`` does.
Each node draws its random numbers (dropout masks) from
:meth:`Context.rng_for`, a generator seeded from the step's seed and the
node's name.  A node that hosts a step graph (``recurrent_group``,
``beam_search``) declares its sub-layers' state slots as
``foreign_state``, under the sub-layers' own names, and runs the step
graph as a sub-topology through :meth:`Topology.forward_with_state` with
its own parameter dict, state and seed.

Nodes created inside a :class:`remat_scope` form a remat group that
``forward`` runs as one ``torch.utils.checkpoint`` segment (the JAX
package's ``jax.checkpoint``): the backward recomputes the segment's
activations from its boundary inputs instead of keeping them.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.data_type import InputType
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
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


# ---------------------------------------------------------------------------
# Remat (activation checkpointing) scopes
# ---------------------------------------------------------------------------

_remat_stack: List[str] = []


class remat_scope:
    """Tag every layer created inside with the remat group ``group``.
    ``Topology.forward`` runs a group's nodes as one checkpointed segment:
    the backward recomputes their activations from the segment's inputs,
    with the same per-node random streams, and the model state the
    forward wrote is kept (the recompute's is dropped)::

        with topology.remat_scope("blk0"):
            x = layer.fc(...)
    """

    def __init__(self, group: str):
        self.group = group

    def __enter__(self):
        _remat_stack.append(self.group)
        return self

    def __exit__(self, *exc):
        _remat_stack.pop()
        return False


@dataclass
class ParamSpec:
    """Declared parameter of a layer node."""

    shape: Tuple[int, ...]
    attr: ParamAttr = field(default_factory=ParamAttr)
    dtype: Any = torch.float32


@dataclass
class StateSpec:
    """Non-trainable state slot (batch norm's moving statistics)."""

    shape: Tuple[int, ...]
    init_value: float = 0.0
    dtype: Any = torch.float32


State = Dict[str, Dict[str, torch.Tensor]]


class Context:
    """Per-forward execution context handed to each node's compute fn:
    the mode, the state read (``state_in``) and written (``state_out``),
    and the step's seed and device for the nodes' random streams."""

    def __init__(self, train: bool, state: State, seed: int = 0,
                 device: torch.device = torch.device("cpu")):
        self.train = train
        self.state_in = state
        self.state_out: State = {}
        self.seed = int(seed)
        self.device = device
        self.current: Optional[str] = None   # the node being computed

    def seed_for(self, *names) -> int:
        """A 63-bit seed from the step's seed and ``names``: the same each
        time within a step, different across names and steps."""
        key = "/".join(str(n) for n in (self.seed,) + names)
        digest = hashlib.md5(key.encode()).digest()
        return int.from_bytes(digest[:8], "little") >> 1

    def rng_for(self, node_name: str) -> torch.Generator:
        """A generator on the step's device, seeded from the step's seed
        and ``node_name``: the same stream each time a node asks within a
        step, different streams across nodes and steps."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed_for(node_name))
        return gen

    def get_state(self, node_name: str, key: str) -> torch.Tensor:
        return self.state_in[node_name][key]

    def set_state(self, node_name: str, key: str,
                  value: torch.Tensor) -> None:
        self.state_out.setdefault(node_name, {})[key] = value


@dataclass
class LayerOutput:
    """A node in the layer graph; also the user-facing handle."""

    name: str
    layer_type: str
    inputs: List["LayerOutput"]
    # fn(ctx, params: dict, inputs: list of values) -> value
    fn: Optional[Callable[[Context, Dict[str, torch.Tensor], List[Any]], Any]]
    params: Dict[str, ParamSpec] = field(default_factory=dict)
    state: Dict[str, StateSpec] = field(default_factory=dict)
    # slots this node keeps under OTHER namespaces: the sub-layers of a
    # hosted step graph, by their own names, so a training group and a
    # generator built from the same step share them as they share weights
    foreign_state: Dict[str, Dict[str, StateSpec]] = field(
        default_factory=dict)
    size: Optional[int] = None          # feature dimension
    is_sequence: bool = False           # value is a SequenceBatch
    is_cost: bool = False               # per-example loss output
    input_type: Optional[InputType] = None   # data layers only
    declare_idx: int = 0                # data layers: declaration order
    height: Optional[int] = None        # data layers: image geometry
    width: Optional[int] = None
    img_shape: Optional[Tuple[int, int, int]] = None  # (H, W, C) of maps
    remat_group: Optional[str] = None   # set by the enclosing remat_scope

    def __post_init__(self):
        enforce_that(self.name is not None, "layer needs a name")
        if self.remat_group is None and _remat_stack and self.fn is not None:
            self.remat_group = _remat_stack[-1]

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


def _device_of(params: Dict[str, torch.Tensor],
               feeds: Dict[str, Any]) -> torch.device:
    """The step's device: the parameters', else the first tensor feed's."""
    for t in params.values():
        return t.device
    for v in feeds.values():
        t = getattr(v, "data", v)
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


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

    def state_specs(self) -> Dict[str, Dict[str, StateSpec]]:
        """``{namespace: {slot: spec}}``: every node's own slots under its
        name, and every hosted sub-layer's under the sub-layer's name."""
        out: Dict[str, Dict[str, StateSpec]] = {}
        for n in self.nodes:
            if n.state:
                out.setdefault(n.name, {}).update(n.state)
            for ns, slots in n.foreign_state.items():
                have = out.setdefault(ns, {})
                for k, spec in slots.items():
                    if k not in have:
                        have[k] = spec
                        continue
                    enforce_that(tuple(have[k].shape) == tuple(spec.shape),
                                 f"shared state slot {ns}/{k} shape "
                                 f"mismatch {have[k].shape} vs {spec.shape}",
                                 context="topology")
        return out

    def init_state(self, device: DeviceLike = None) -> State:
        """Every state slot at its initial value on ``device`` (``cuda``
        unless asked)."""
        dev = resolve_device(device)
        return {lname: {k: torch.full(tuple(s.shape), s.init_value,
                                      dtype=s.dtype, device=dev)
                        for k, s in slots.items()}
                for lname, slots in self.state_specs().items()}

    def forward(self, params: Dict[str, torch.Tensor],
                feeds: Dict[str, Any], *, train: bool = False,
                outputs: Optional[Sequence[LayerOutput]] = None,
                state: Optional[State] = None, seed: int = 0) -> List[Any]:
        """Run the graph on ``feeds`` (data layer name -> value) and return
        the values of ``outputs`` (default: the topology's outputs).
        ``state`` defaults to :meth:`init_state` on the parameters'
        device; the updated slots are dropped (see
        :meth:`forward_with_state`)."""
        return self.forward_with_state(params, state, feeds, train=train,
                                       outputs=outputs, seed=seed)[0]

    def forward_with_state(self, params: Dict[str, torch.Tensor],
                           state: Optional[State], feeds: Dict[str, Any],
                           *, train: bool = False, seed: int = 0,
                           outputs: Optional[Sequence[LayerOutput]] = None
                           ) -> Tuple[List[Any], State]:
        """(values of ``outputs``, new state): the new state is ``state``
        with the slots the nodes set replaced; ``state`` itself is not
        changed.  ``seed`` seeds the nodes' random streams."""
        wanted = list(outputs) if outputs is not None else self.outputs
        order = self.nodes if outputs is None else topological_order(wanted)
        device = _device_of(params, feeds)
        if state is None:
            state = self.init_state(device) if self.state_specs() else {}
        ctx = Context(train=train, state=state, seed=seed, device=device)
        values: Dict[str, Any] = {}
        done_groups: set = set()
        for node in order:
            if node.fn is None:  # data layers
                if node.name not in feeds:
                    raise EnforceError(f"missing feed for data layer "
                                       f"{node.name!r}", context="forward")
                values[node.name] = feeds[node.name]
                continue
            if node.remat_group is not None:
                if node.remat_group not in done_groups:
                    done_groups.add(node.remat_group)
                    self._run_remat_group(node.remat_group, order, values,
                                          params, ctx,
                                          {w.name for w in wanted})
                continue
            node_params = {p: params[self.param_key(node, p)]
                           for p in node.params}
            ins = [values[i.name] for i in node.inputs]
            ctx.current = node.name
            values[node.name] = self._compute(node, ctx, node_params, ins)
        new_state = dict(state)
        for ns, slots in ctx.state_out.items():
            new_state[ns] = {**new_state.get(ns, {}), **slots}
        return [values[w.name] for w in wanted], new_state

    @staticmethod
    def _compute(node: LayerOutput, ctx: Context, node_params, ins,
                 group: Optional[str] = None):
        try:
            return node.fn(ctx, node_params, ins)
        except Exception as e:
            # name the failing layer so shape/dtype errors point at the
            # config
            where = f", remat group {group!r}" if group is not None else ""
            e.add_note(
                f"[paddle_tpu_torch] while computing layer {node.name!r} "
                f"(type={node.layer_type}{where}, "
                f"inputs={[i.name for i in node.inputs]})")
            raise

    def _run_remat_group(self, group: str, order: List[LayerOutput],
                         values: Dict[str, Any],
                         params: Dict[str, torch.Tensor], ctx: Context,
                         wanted_names: set) -> None:
        """Run one remat group as a single checkpointed segment: a
        function of the group's boundary inputs (its parameters are read
        from ``params``) returning its boundary outputs and the state it
        wrote.  The backward reruns it; each run builds its own
        ``Context``, so the dropout generators ``rng_for`` makes are
        seeded alike, and only the first run's state is kept."""
        nodes = [n for n in order if n.remat_group == group]
        in_group = {n.name for n in nodes}
        ext_in: List[str] = []
        for n in nodes:
            for i in n.inputs:
                if i.name not in in_group and i.name not in ext_in:
                    ext_in.append(i.name)
                    enforce_that(
                        i.name in values,
                        f"remat group {group!r} input {i.name!r} is not "
                        f"available yet — the group is not a contiguous "
                        f"segment of the graph", context="remat")
        consumed_outside = set(wanted_names)
        for n in order:
            if n.remat_group != group:
                consumed_outside.update(i.name for i in n.inputs)
        ext_out = [n.name for n in nodes if n.name in consumed_outside]
        enforce_that(ext_out,
                     f"remat group {group!r} has no outputs used outside it",
                     context="remat")

        def segment(*ext_vals):
            local = dict(zip(ext_in, ext_vals))
            sub = Context(train=ctx.train, state=ctx.state_in,
                          seed=ctx.seed, device=ctx.device)
            for n in nodes:
                node_params = {p: params[self.param_key(n, p)]
                               for p in n.params}
                sub.current = n.name
                local[n.name] = self._compute(
                    n, sub, node_params, [local[i.name] for i in n.inputs],
                    group)
            return [local[nm] for nm in ext_out], sub.state_out

        # the segment draws its random numbers from its own generators,
        # so the global RNG state needs no stashing
        outs, state_out = checkpoint(
            segment, *[values[nm] for nm in ext_in], use_reentrant=False,
            preserve_rng_state=False)
        values.update(zip(ext_out, outs))
        for ns, slots in state_out.items():
            ctx.state_out.setdefault(ns, {}).update(slots)

    def __repr__(self):
        return (f"Topology({len(self.nodes)} nodes, "
                f"outputs={[o.name for o in self.outputs]})")
