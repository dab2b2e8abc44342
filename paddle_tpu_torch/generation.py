"""Beam-search generation (the port of ``paddle_tpu/generation.py:37-346``:
``BeamState``, ``GeneratedInput`` and ``beam_search`` with its four
hooks).

Beams are the batch dimension (B * K rows); reordering them is a gather,
and a finished beam continues only by ``eos`` at cost 0, keeping its
memories.  The JAX package runs the ``max_length`` steps as one
``lax.scan``; here they are a Python loop, one eager forward of the step
graph a step.  Candidates are chosen as ``jax.lax.top_k`` chooses them:
the K highest totals of the row's K x V, the lower flat index first among
equal totals (a stable descending sort; ``torch.topk`` promises no order
among ties).

The loop stops early once every row is done: stopped by
``stop_condition``, or with all K beams finished, their scores in order
and no ``path_filter``.  Such a row is a fixed point of the step (each
beam's only candidate is its own ``eos`` at cost 0, so the K winners are
the K beams in place), so the steps left would change nothing the
outputs hold.  Deciding it waits on the card once a step: the check, or,
with a ``host_candidate_adjust``, the hook's own transfer.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.ops.embedding import embedding_lookup
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.recurrent import (StaticInput, _data_of,
                                        make_static_node, pin_param_names,
                                        read_group_state,
                                        resolve_memory_links, trace_step)
from paddle_tpu_torch.sequence import SequenceBatch
from paddle_tpu_torch.topology import (Context, LayerOutput, ParamSpec,
                                       Topology, unique_name)

__all__ = ["GeneratedInput", "BeamState", "beam_search"]

NEG = -1e9


class BeamState(NamedTuple):
    """The beams as the hooks see them: ``t`` the step (an int), the
    others [B, K] tensors on the beams' device."""

    t: int
    tokens: torch.Tensor      # int64, the last token of each beam
    scores: torch.Tensor      # f32, cumulative log-probability
    finished: torch.Tensor    # bool, the beam has emitted eos
    lengths: torch.Tensor     # int32, generated length


class GeneratedInput:
    """The previous step's token, embedded through the table
    ``embedding_name`` ([size, embedding_size])."""

    def __init__(self, size: int, embedding_name: str, embedding_size: int):
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


def _top_k_stable(flat: torch.Tensor, k: int):
    """(values, indices) of the k largest per row, best first, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(flat, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def beam_search(step, input, bos_id: int, eos_id: int, beam_size: int = 5,
                max_length: int = 30, name: Optional[str] = None,
                candidate_adjust: Optional[Callable] = None,
                host_candidate_adjust: Optional[Callable] = None,
                path_filter: Optional[Callable] = None,
                stop_condition: Optional[Callable] = None) -> LayerOutput:
    """Generate with beam search.  ``step(*frame_args)`` returns the step's
    probability layer ([B * K, vocab], a softmax output).  The node's
    value is ``(tokens [B, K, max_length] int32, lengths [B, K] int32,
    scores [B, K] f32)``, beams best first, tokens past a beam's length
    ``eos``; evaluate it with ``Inference``.

    Hooks, as in the JAX package:

    - ``candidate_adjust(logp, beam)``: ``logp`` the [B, K, V]
      continuation log-probabilities before finished beams are frozen,
      ``beam`` a :class:`BeamState`; returns the adjusted [B, K, V].
    - ``host_candidate_adjust(logp, tokens, t)``: the same on the host,
      with numpy arrays ([B, K, V] f32, [B, K] int32, () int32); returns
      a [B, K, V] array.  It costs a wait on the card every step.
    - ``path_filter(beam)``: after the top-k, with the new beams; returns
      a [B, K] bool keep-mask, and dropped beams score -1e9.
    - ``stop_condition(beam)``: after the top-k; a [] or [B] bool, true
      freezing the row's beams for the remaining steps.
    """
    name = name or unique_name("beam_search")
    inputs = input if isinstance(input, (list, tuple)) else [input]
    gen: Optional[GeneratedInput] = None
    gen_node: Optional[LayerOutput] = None
    static_inputs: List[StaticInput] = []
    static_nodes: List[LayerOutput] = []
    frame_args: List[LayerOutput] = []
    for item in inputs:
        if isinstance(item, GeneratedInput):
            enforce_that(gen is None, "only one GeneratedInput allowed",
                         context="beam_search")
            gen = item
            gen_node = LayerOutput(name=unique_name(f"{name}_token_emb"),
                                   layer_type="frame", inputs=[], fn=None,
                                   size=item.embedding_size)
            frame_args.append(gen_node)
        elif isinstance(item, StaticInput):
            node = make_static_node(name, item)
            static_inputs.append(item)
            static_nodes.append(node)
            frame_args.append(node)
        else:
            raise EnforceError("beam_search inputs must be GeneratedInput "
                               "or StaticInput", context="beam_search")
    enforce_that(gen is not None, "beam_search needs a GeneratedInput",
                 context="beam_search")

    prob_layer, memories = trace_step(step, frame_args)
    enforce_that(not isinstance(prob_layer, (list, tuple)),
                 "beam_search step must return a single probability layer",
                 context="beam_search")
    links = resolve_memory_links(Topology([prob_layer]), memories,
                                 "beam_search")
    sub_topo = Topology([prob_layer] + links)
    # the same keys as a training recurrent_group built from this step
    group_params = pin_param_names(sub_topo)
    emb_key = gen.embedding_name
    if emb_key not in group_params:
        group_params[emb_key] = ParamSpec(
            (gen.size, gen.embedding_size), ParamAttr(name=emb_key))
    n_static = len(static_inputs)
    K, V = beam_size, gen.size

    def compute(ctx: Context, p, ins):
        static_vals, boot_vals = ins[:n_static], ins[n_static:]
        if boot_vals:
            B = boot_vals[0].shape[0]
        elif static_vals:
            sv = static_vals[0]
            B = sv.num_seqs if isinstance(sv, SequenceBatch) else sv.shape[0]
        else:
            raise EnforceError("beam_search needs a static or boot input to "
                               "infer batch size", context="beam_search")
        # each row's statics repeated for its K beams
        tiled = []
        for sv in static_vals:
            if isinstance(sv, SequenceBatch):
                padded, _ = sv.to_padded()
                tiled.append(SequenceBatch.from_padded(
                    padded.repeat_interleave(K, 0),
                    sv.lengths.repeat_interleave(K, 0),
                    capacity=B * K * padded.shape[1]))
            else:
                tiled.append(sv.repeat_interleave(K, 0))
        boots = iter(boot_vals)
        mems = {}
        for m in memories:
            mems[m.node.name] = (next(boots).float().repeat_interleave(K, 0)
                                 if m.boot_layer is not None else
                                 torch.zeros((B * K, m.size),
                                             dtype=torch.float32,
                                             device=p[emb_key].device))
        # trained sub-layer state through the sub-layers' own namespaces
        sub_state = read_group_state(ctx, sub_topo)
        seed = ctx.seed_for(ctx.current or name)
        dev = p[emb_key].device
        bix = torch.arange(B, device=dev)[:, None]
        kix = torch.arange(K, device=dev)[None, :].expand(B, K)
        eos_only = torch.where(torch.arange(V, device=dev) == eos_id,
                               0.0, NEG)
        tokens = torch.full((B, K), bos_id, dtype=torch.long, device=dev)
        scores = torch.where(kix == 0, 0.0, NEG)
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)
        stopped = torch.zeros((B,), dtype=torch.bool, device=dev)
        done = None
        toks_hist, parents_hist = [], []
        for t in range(max_length):
            if done is not None and host_candidate_adjust is None \
                    and bool(done):
                break
            feeds = {gen_node.name: embedding_lookup(p[emb_key],
                                                     tokens.reshape(B * K))}
            feeds.update(zip((n.name for n in static_nodes), tiled))
            feeds.update(mems)
            outs, _ = sub_topo.forward_with_state(p, sub_state, feeds,
                                                  train=False, seed=seed)
            probs = _data_of(outs[0])
            logp = torch.log(torch.clamp(probs, 1e-20, 1.0)).reshape(B, K, V)
            if candidate_adjust is not None:
                logp = candidate_adjust(logp, BeamState(
                    t, tokens, scores, finished, lengths))
            if host_candidate_adjust is not None:
                adjusted = host_candidate_adjust(
                    logp.float().cpu().numpy(),
                    tokens.to(torch.int32).cpu().numpy(), np.int32(t))
                # the transfer waited on the card: the check costs no more
                if done is not None and bool(done):
                    break
                logp = torch.as_tensor(np.asarray(adjusted, np.float32),
                                       device=dev)
            # finished beams continue only by eos at cost 0, applied after
            # the hooks so they cannot unfreeze them
            cont = torch.where(finished[..., None], eos_only, logp)
            total = scores[..., None] + cont
            top_scores, top_idx = _top_k_stable(total.reshape(B, K * V), K)
            parent = top_idx // V
            token = top_idx % V
            fin_p = finished[bix, parent]
            new_fin = fin_p | (token == eos_id)
            new_len = lengths[bix, parent] + (~fin_p).to(torch.int32)
            if path_filter is not None:
                keep = path_filter(BeamState(t, token, top_scores, new_fin,
                                             new_len))
                top_scores = torch.where(keep, top_scores, NEG)
            new_mems = {}
            for m, lo in zip(memories, outs[1:]):
                val = _data_of(lo).reshape(B, K, -1)[bix, parent]
                prev = mems[m.node.name].reshape(B, K, -1)[bix, parent]
                new_mems[m.node.name] = torch.where(
                    fin_p[..., None], prev, val).reshape(B * K, -1)
            if stop_condition is not None:
                # stopped rows pass through unchanged, parents in place
                row = stopped[:, None]
                token = torch.where(row, eos_id, token)
                parent = torch.where(row, kix, parent)
                top_scores = torch.where(row, scores, top_scores)
                new_fin = torch.where(row, finished, new_fin)
                new_len = torch.where(row, lengths, new_len)
                row_bk = stopped.repeat_interleave(K)[:, None]
                new_mems = {k: torch.where(row_bk, mems[k], v)
                            for k, v in new_mems.items()}
                stop_now = torch.as_tensor(stop_condition(BeamState(
                    t, token, top_scores, new_fin, new_len)),
                    dtype=torch.bool, device=dev)
                stopped = stopped | torch.broadcast_to(stop_now, (B,))
            tokens, scores, finished, lengths = (token, top_scores, new_fin,
                                                 new_len)
            mems = new_mems
            toks_hist.append(token)
            parents_hist.append(parent)
            done = stopped
            if path_filter is None:
                done = done | (finished.all(1) &
                               (scores[:, :-1] >= scores[:, 1:]).all(1) &
                               (scores[:, -1] - scores[:, 0] > NEG / 2))
            done = done.all()
        steps = len(toks_hist)
        node.steps_taken = steps
        # walk the parents back from the last step; the steps the early
        # stop left out hold eos in place, past every beam's length
        beam = kix
        out = torch.full((B, K, max_length), eos_id, dtype=torch.int32,
                         device=dev)
        for t in range(steps - 1, -1, -1):
            out[:, :, t] = toks_hist[t][bix, beam].to(torch.int32)
            beam = parents_hist[t][bix, beam]
        valid = torch.arange(max_length, device=dev)[None, None, :] < \
            lengths[..., None]
        out = torch.where(valid, out, torch.full_like(out, eos_id))
        return out, lengths, scores

    node = LayerOutput(name=name, layer_type="beam_search",
                       inputs=[s.input for s in static_inputs] +
                       [m.boot_layer for m in memories
                        if m.boot_layer is not None],
                       fn=compute, params=group_params,
                       foreign_state=sub_topo.state_specs(),
                       size=max_length)
    node.beam_size = beam_size
    node.max_length = max_length
    node.steps_taken = None
    return node
