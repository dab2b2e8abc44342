"""Recurrent layer groups (the port of ``paddle_tpu/recurrent.py``:
``memory``, ``StaticInput``, ``SubsequenceInput`` and ``recurrent_group``,
flat and hierarchical).

The user's ``step`` function is traced once into a sub-topology whose
frame inputs are placeholder nodes.  At run time the group node turns its
sequence inputs into the padded [B, T, D] view and runs the sub-topology
once a frame in a Python loop, where the JAX package runs it under
``lax.scan``; ``torch.autograd`` differentiates the loop.  The loop keeps
the scan's rules:

- a frame is live for a row only while every in-link is live (the masks
  are ANDed), and the output lengths are the sums of that combined mask;
- memories carry through dead frames (``where(mask, new, prev)``); a boot
  value is cast to f32, a memory without one boots as f32 zeros;
- ``reverse=True`` runs the frames from the last of the padded layout to
  the first;
- outputs are zeroed on dead frames;
- each frame draws a fresh random stream from the group's name and the
  frame's index;
- sub-layer state (batch norm's moving statistics) lives under the
  sub-layers' own names (``LayerOutput.foreign_state``) and advances only
  on frames where some row is live.

Frames past the longest live row change nothing (every memory carries,
every output is 0, no state moves), so the loop stops there: one host
read of the mask a group call, where the scan would run them.

``memory(name=N)`` links to the step layer literally named N.

A hierarchical group (every sequence in-link a ``SubsequenceInput`` of a
nested batch) steps over INNER sequences: frame s hands the step each
outer sequence's s-th inner sequence as a SequenceBatch, rebuilt from the
[B, S, W] view of ``sequence.nested_to_padded`` (S = ``max_inner``, W =
``max_inner_len``, host-side bounds; tokens past them are dropped, as in
the JAX package).  The outer frames advance in lockstep on the least
inner-sequence count of the in-links; a row without an s-th inner
sequence gets a one-token zero frame whose results the masks discard.  A
``memory(is_seq=True)`` carries a whole inner sequence (the previous
sentence) to the next frame and boots as one zero token.  A step output
that is a sequence makes a nested output over the outer structure; a
vector output makes a flat sequence, one row an inner sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import torch

from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.sequence import (SequenceBatch, nested_from_padded,
                                       nested_to_padded)
from paddle_tpu_torch.topology import (Context, LayerOutput, ParamSpec,
                                       Topology, unique_name)

__all__ = ["memory", "StaticInput", "SubsequenceInput", "recurrent_group"]


# one list of memories per step function being traced
_MEMORY_STACK: List[List["_Memory"]] = []


@dataclasses.dataclass
class _Memory:
    node: LayerOutput                  # placeholder read inside the step
    link_name: str                     # step layer that feeds frame t + 1
    size: int
    boot_layer: Optional[LayerOutput]
    is_seq: bool = False


def memory(name: str, size: int, boot_layer: Optional[LayerOutput] = None,
           is_seq: bool = False, **_kw) -> LayerOutput:
    """Cross-frame state inside a ``recurrent_group`` step: the value of
    the step layer named ``name`` at the previous frame (``boot_layer``'s
    value, or zeros, at the first)."""
    enforce_that(len(_MEMORY_STACK) > 0,
                 "memory() must be called inside a recurrent_group step",
                 context="recurrent")
    enforce_that(not _kw, f"unsupported memory() options: {sorted(_kw)}",
                 context="recurrent")
    enforce_that(is_seq or boot_layer is None or not boot_layer.is_sequence,
                 "memory boot_layer must be a non-sequence layer "
                 "(pool/last_seq it first)", context="recurrent")
    enforce_that(not (is_seq and boot_layer is not None),
                 "sequence memories boot empty (is_seq=True + boot_layer "
                 "is not supported)", context="recurrent")
    node = LayerOutput(name=unique_name(f"mem_{name}"), layer_type="memory",
                       inputs=[], fn=None, size=size, is_sequence=is_seq)
    _MEMORY_STACK[-1].append(_Memory(node, name, size, boot_layer, is_seq))
    return node


class StaticInput:
    """A whole (possibly sequence) value seen unchanged at every frame."""

    def __init__(self, input: LayerOutput, is_seq: bool = None):
        self.input = input
        self.is_seq = input.is_sequence if is_seq is None else is_seq


class SubsequenceInput:
    """A nested sequence in-link of a hierarchical group: each frame is
    one inner sequence.  ``max_inner`` (most inner sequences an outer one
    has) and ``max_inner_len`` (the longest inner sequence) bound the
    [B, S, W] view; they default to the input's ``max_len``."""

    def __init__(self, input: LayerOutput, max_inner: int = None,
                 max_inner_len: int = None):
        self.input = input
        self.max_inner = max_inner
        self.max_inner_len = max_inner_len


# ---------------------------------------------------------------------------
# What recurrent_group and generation.beam_search share: both trace a step
# graph, resolve its memory links and hoist its parameters and state
# ---------------------------------------------------------------------------

def make_static_node(group_name: str, item: StaticInput) -> LayerOutput:
    """The placeholder a StaticInput is bound to inside the step graph."""
    return LayerOutput(name=unique_name(f"{group_name}_static"),
                       layer_type="static_frame", inputs=[], fn=None,
                       size=item.input.size, is_sequence=item.is_seq)


def trace_step(step, frame_args):
    """Call the user's step function once: (its outputs, its memories)."""
    _MEMORY_STACK.append([])
    try:
        step_outs = step(*frame_args)
    finally:
        memories = _MEMORY_STACK.pop()
    return step_outs, memories


def resolve_memory_links(probe: Topology, memories: Sequence[_Memory],
                         context: str) -> List[LayerOutput]:
    """Each memory's linked step layer in ``probe``, in memory order."""
    links = []
    for m in memories:
        target = probe.by_name.get(m.link_name)
        if target is None:
            raise EnforceError(
                f"memory links to layer {m.link_name!r} which is not in the "
                "step graph reachable from its outputs", context=context)
        links.append(target)
    return links


def pin_param_names(sub_topo: Topology) -> Dict[str, ParamSpec]:
    """The step graph's parameters, each spec's name pinned to its key, so
    the outer table uses the same key whichever node hosts the step: a
    training group and a generator built from one step share weights."""
    out: Dict[str, ParamSpec] = {}
    for key, spec in sub_topo.param_specs().items():
        if spec.attr.name is None:
            spec = dataclasses.replace(
                spec, attr=dataclasses.replace(spec.attr, name=key))
        out[key] = spec
    return out


def read_group_state(ctx: Context, sub_topo: Topology):
    """The step graph's state, read from the shared namespaces."""
    return {lname: {k: ctx.get_state(lname, k) for k in slots}
            for lname, slots in sub_topo.state_specs().items()}


def write_group_state(ctx: Context, sub_state) -> None:
    for lname, slots in (sub_state or {}).items():
        for k, v in slots.items():
            ctx.set_state(lname, k, v)


def _data_of(v):
    return v.data if isinstance(v, SequenceBatch) else v


# ---------------------------------------------------------------------------
# recurrent_group
# ---------------------------------------------------------------------------

def recurrent_group(step, input, reverse: bool = False,
                    name: Optional[str] = None
                    ) -> Union[LayerOutput, List[LayerOutput]]:
    """Run ``step`` over the frames of the sequence inputs.

    ``input``: sequence layers (one frame each step) and StaticInputs.
    ``step(*frame_args)`` builds the frame's graph and returns one or more
    layers; the group's outputs are SequenceBatches aligned with the first
    sequence input (a multi-output step gives one ``{name}_out{i}`` node
    per output)."""
    name = name or unique_name("recurrent_group")
    inputs = input if isinstance(input, (list, tuple)) else [input]
    seq_inputs: List[LayerOutput] = []
    static_inputs: List[StaticInput] = []
    frame_args: List[LayerOutput] = []
    frame_nodes: List[LayerOutput] = []
    static_nodes: List[LayerOutput] = []
    nested_specs: List[SubsequenceInput] = []
    nested = any(isinstance(it, SubsequenceInput) for it in inputs)
    for item in inputs:
        if isinstance(item, StaticInput):
            node = make_static_node(name, item)
            static_inputs.append(item)
            static_nodes.append(node)
        elif isinstance(item, SubsequenceInput):
            # a hierarchical group: the frame is an inner sequence
            node = LayerOutput(name=unique_name(f"{name}_subseq_frame"),
                               layer_type="frame", inputs=[], fn=None,
                               size=item.input.size, is_sequence=True)
            seq_inputs.append(item.input)
            nested_specs.append(item)
            frame_nodes.append(node)
        else:
            enforce_that(isinstance(item, LayerOutput) and item.is_sequence,
                         f"recurrent_group input {item!r} must be a sequence "
                         "layer (wrap non-sequences in StaticInput)",
                         context="recurrent")
            enforce_that(not nested,
                         "a hierarchical recurrent_group steps over inner "
                         "sequences: wrap EVERY sequence in-link in "
                         "SubsequenceInput", context="recurrent")
            node = LayerOutput(name=unique_name(f"{name}_frame"),
                               layer_type="frame", inputs=[], fn=None,
                               size=item.size)
            seq_inputs.append(item)
            frame_nodes.append(node)
        frame_args.append(node)
    enforce_that(len(seq_inputs) > 0,
                 "recurrent_group needs >=1 sequence input",
                 context="recurrent")

    step_outs, memories = trace_step(step, frame_args)
    multi_out = isinstance(step_outs, (list, tuple))
    out_list: List[LayerOutput] = list(step_outs) if multi_out \
        else [step_outs]
    links = resolve_memory_links(Topology(out_list), memories, "recurrent")
    sub_topo = Topology(out_list + links)
    n_seq, n_static, n_out = len(seq_inputs), len(static_inputs), \
        len(out_list)
    if not nested:
        enforce_that(not any(m.is_seq for m in memories),
                     "memory(is_seq=True) carries a whole inner sequence "
                     "across outer frames: it needs a hierarchical group "
                     "(SubsequenceInput in-links)", context="recurrent")

    def compute(ctx: Context, p, ins):
        seq_vals: List[SequenceBatch] = ins[:n_seq]
        static_vals = ins[n_seq:n_seq + n_static]
        boots = iter(ins[n_seq + n_static:])
        first = seq_vals[0]
        frames, mask = [], None
        for sv in seq_vals:
            pd, mk = sv.to_padded()
            enforce_that(
                mask is None or mk.shape == mask.shape,
                f"recurrent_group sequence inputs disagree on max length "
                f"({mk.shape[1]} vs {mask.shape[1] if mask is not None else 0})"
                "; all in-links must share lengths and bucketing",
                context="recurrent")
            frames.append(pd.unbind(1))
            # a frame runs for a row only while EVERY in-link is live
            mask = mk if mask is None else mask & mk
        B, T = mask.shape
        live = int(mask.any(0).sum())     # frames [0, live) hold a live row
        mems = {}
        for m in memories:
            if m.boot_layer is not None:
                bv = next(boots)
                enforce_that(not isinstance(bv, SequenceBatch),
                             f"memory {m.link_name!r} boot_layer must be a "
                             "non-sequence layer (got a sequence)",
                             context="recurrent")
                mems[m.node.name] = bv.float()
            else:
                mems[m.node.name] = torch.zeros(
                    (B, m.size), dtype=torch.float32, device=mask.device)
        sstate = read_group_state(ctx, sub_topo)
        group_name = ctx.current or name
        masks = mask.unbind(1)
        ys: List[List[Optional[torch.Tensor]]] = [[None] * T
                                                  for _ in out_list]
        for t in (range(live - 1, -1, -1) if reverse else range(live)):
            feeds = {node.name: xs[t] for node, xs in zip(frame_nodes,
                                                          frames)}
            feeds.update(zip((n.name for n in static_nodes), static_vals))
            feeds.update(mems)
            outs, sstate = sub_topo.forward_with_state(
                p, sstate, feeds, train=ctx.train,
                seed=ctx.seed_for(group_name, t))
            m_t = masks[t][:, None]
            for m, lo in zip(memories, outs[n_out:]):
                mems[m.node.name] = torch.where(m_t, _data_of(lo),
                                                mems[m.node.name])
            for i, o in enumerate(outs[:n_out]):
                ys[i][t] = _data_of(o)
        write_group_state(ctx, sstate)
        lengths = mask.sum(1).to(first.lengths.dtype)
        results = []
        for i, y in enumerate(ys):
            if live:
                y = torch.stack(y[:live], dim=1)            # [B, live, D]
                y = torch.cat([y, y.new_zeros((B, T - live) +
                                              y.shape[2:])], dim=1)
                y = torch.where(mask.reshape(B, T, *[1] * (y.dim() - 2)),
                                y, torch.zeros_like(y))
            else:
                y = torch.zeros((B, T, out_list[i].size),
                                dtype=torch.float32, device=mask.device)
            results.append(SequenceBatch.from_padded(
                y, lengths, capacity=first.capacity))
        return tuple(results) if multi_out else results[0]

    def compute_nested(ctx: Context, p, ins):
        seq_vals: List[SequenceBatch] = ins[:n_seq]
        static_vals = ins[n_seq:n_seq + n_static]
        boots = iter(ins[n_seq + n_static:])
        first = seq_vals[0]
        B = first.num_seqs
        views, counts, S, W = [], None, None, None
        for spec, sv in zip(nested_specs, seq_vals):
            enforce_that(sv.sub_segment_ids is not None,
                         "SubsequenceInput needs a nested SequenceBatch "
                         "feed (sub_segment_ids)", context="recurrent")
            s_b = int(spec.max_inner or sv.max_len or sv.capacity)
            w_b = int(spec.max_inner_len or sv.max_len or sv.capacity)
            enforce_that(S is None or (S == s_b and W == w_b),
                         "nested in-links disagree on max_inner/"
                         "max_inner_len bounds", context="recurrent")
            S, W = s_b, w_b
            data, inner_lens, cnt = nested_to_padded(sv, S, W)
            views.append((data.unbind(1), inner_lens.unbind(1)))
            # the outer frames advance in lockstep
            counts = cnt if counts is None else torch.minimum(counts, cnt)
        dev = counts.device
        outer_mask = torch.arange(S, device=dev)[None, :] < counts[:, None]
        live = int(outer_mask.any(0).sum())   # frames [0, live) hold a row
        mems = {}
        for m in memories:
            if m.is_seq:
                # one zero token (an empty sequence would make a max pool
                # give -inf and NaN gradients)
                mems[m.node.name] = (
                    torch.zeros((B, W, m.size), dtype=torch.float32,
                                device=dev),
                    torch.ones((B,), dtype=torch.int32, device=dev))
            elif m.boot_layer is not None:
                mems[m.node.name] = next(boots).float()
            else:
                mems[m.node.name] = torch.zeros(
                    (B, m.size), dtype=torch.float32, device=dev)
        sstate = read_group_state(ctx, sub_topo)
        group_name = ctx.current or name
        masks = outer_mask.unbind(1)
        ys: List[List] = [[None] * S for _ in out_list]
        for t in (range(live - 1, -1, -1) if reverse else range(live)):
            m_t = masks[t]
            feeds = {}
            for node, (xs, ls) in zip(frame_nodes, views):
                safe = torch.where(m_t, ls[t], torch.ones_like(ls[t]))
                feeds[node.name] = SequenceBatch.from_padded(
                    xs[t], safe, capacity=B * W)
            feeds.update(zip((n.name for n in static_nodes), static_vals))
            for m in memories:
                v = mems[m.node.name]
                feeds[m.node.name] = (SequenceBatch.from_padded(
                    v[0], v[1], capacity=B * W) if m.is_seq else v)
            outs, sstate = sub_topo.forward_with_state(
                p, sstate, feeds, train=ctx.train,
                seed=ctx.seed_for(group_name, t))
            for m, lo in zip(memories, outs[n_out:]):
                prev = mems[m.node.name]
                if m.is_seq:
                    enforce_that(isinstance(lo, SequenceBatch),
                                 f"memory(is_seq=True) links to "
                                 f"{m.link_name!r} which is not a sequence "
                                 "layer", context="recurrent")
                    lp = lo.to_padded(max_len=W)[0]
                    keep = m_t.reshape((B,) + (1,) * (lp.dim() - 1))
                    mems[m.node.name] = (
                        torch.where(keep, lp, prev[0]),
                        torch.where(m_t, torch.clamp(lo.lengths, 1, W),
                                    prev[1]))
                else:
                    mems[m.node.name] = torch.where(m_t[:, None],
                                                    _data_of(lo), prev)
            for i, o in enumerate(outs[:n_out]):
                ys[i][t] = ((o.to_padded()[0], o.lengths)
                            if isinstance(o, SequenceBatch) else o)
        write_group_state(ctx, sstate)
        results = []
        for node, y in zip(out_list, ys):
            done = [v for v in y if v is not None]
            if node.is_sequence:
                # a nested output: the frames' inner sequences reassemble
                # over the outer structure
                like = done[0][0] if done else torch.zeros(
                    (B, W, node.size), device=dev)
                yp = torch.stack([v[0] if v is not None else
                                  torch.zeros_like(like) for v in y], 1)
                yl = torch.stack([v[1] if v is not None else
                                  torch.zeros_like(counts) for v in y], 1)
                yl = torch.where(outer_mask, yl, torch.zeros_like(yl))
                wo = yp.shape[2]
                results.append(nested_from_padded(
                    yp, torch.clamp(yl, 0, wo), counts,
                    capacity=max(first.capacity, B * S * wo)))
            else:
                # one row an inner sequence: a flat sequence of counts
                like = done[0] if done else torch.zeros(
                    (B, node.size), device=dev)
                yd = torch.stack([v if v is not None else
                                  torch.zeros_like(like) for v in y], 1)
                yd = torch.where(
                    outer_mask.reshape((B, S) + (1,) * (yd.dim() - 2)),
                    yd, torch.zeros_like(yd))
                results.append(SequenceBatch.from_padded(yd, counts,
                                                         capacity=B * S))
        return tuple(results) if multi_out else results[0]

    outer_inputs = (seq_inputs + [s.input for s in static_inputs] +
                    [m.boot_layer for m in memories
                     if m.boot_layer is not None])
    group = LayerOutput(name=name, layer_type="recurrent_group",
                        inputs=outer_inputs,
                        fn=compute_nested if nested else compute,
                        params=pin_param_names(sub_topo),
                        foreign_state=sub_topo.state_specs(),
                        size=out_list[0].size, is_sequence=True)
    if not multi_out:
        return group
    return [LayerOutput(name=f"{name}_out{i}", layer_type="rg_output",
                        inputs=[group],
                        fn=lambda ctx, p, ins, i=i: ins[0][i],
                        size=o.size, is_sequence=True)
            for i, o in enumerate(out_list)]
