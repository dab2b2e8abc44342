"""Sequence ops on the flat segment-id form (the port of
``paddle_tpu/ops/sequence_ops.py``: the pooling ops, ``seq_first``,
``seq_last``, ``sequence_softmax``, ``seq_expand``, ``seq_concat``,
``seq_reshape``, ``seq_slice``, ``kmax_seq_score``, ``max_id`` and
``sub_nested_seq``).

Padding slots go to one trash segment (``num_seqs``) that is cut off the
result, so no per-sequence loop is needed.  Sequences are packed in order
from slot 0 with the padding after them (as the feeder, ``from_list`` and
``from_padded`` pack them), so the segment ids are non-decreasing and
every segment is a contiguous run of slots.  That makes every sum here an
ordered one, and a run reproducible to the bit on the card:

- segment sums are :func:`segment_sum` (``torch.segment_reduce`` over the
  runs' lengths, each segment added in slot order), where ``index_add``
  adds with atomics in no fixed order on the card;
- gathers by segment are :func:`gather_rows`, an ``index_select`` whose
  backward is that ordered segment sum (``index_select``'s own backward is
  an ``index_add``; an advanced-index gather's sorts its indices first: on
  an H100 that took 73 of a 195 ms NMT training step's card time);
- the per-segment maximum is ``scatter_reduce`` with ``"amax"``, exact in
  any order.

``seq_slice`` and ``sub_nested_seq`` keep the JAX package's layout: the
tokens they drop stay where they were, marked as padding, so a sequence
may have holes.  The sums here run over :func:`_runs`, where a hole or
padding slot joins the run before it with its value zeroed, so they stay
ordered and leave the holes out.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.sequence import (SequenceBatch, lengths_to_segment_ids,
                                       position_in_sequence)


def _seg(sb: SequenceBatch) -> torch.Tensor:
    """Segment ids with pads mapped to the trash segment (= num_seqs)."""
    return torch.where(sb.valid_mask, sb.segment_ids, sb.num_seqs).long()


def _runs(sb: SequenceBatch) -> torch.Tensor:
    """Non-decreasing segment ids: a valid slot's own, any other slot the
    last valid id before it (0 before the first).  The valid slots' ids
    are non-decreasing in every batch the port builds, holes included."""
    ids = torch.where(sb.valid_mask, sb.segment_ids.long(), -1)
    return torch.clamp(torch.cummax(ids, 0).values, min=0)


def _zero_invalid(sb: SequenceBatch, data: torch.Tensor) -> torch.Tensor:
    valid = sb.valid_mask.reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(valid, data, torch.zeros_like(data))


def segment_sum(data: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = sum(data[i] for i with seg[i] == s)`` along dim 0, each
    segment added in slot order; ``seg`` is non-decreasing, slots past
    the last segment (``seg[i] >= num_segments``) are left out, and an
    empty segment sums to 0."""
    seg = seg.long()
    r = torch.arange(num_segments, device=seg.device)
    counts = (torch.searchsorted(seg, r, right=True) -
              torch.searchsorted(seg, r))
    return torch.segment_reduce(data, "sum", lengths=counts, axis=0,
                                unsafe=True)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.n = values.shape[0]
        return values.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return segment_sum(grad, idx, ctx.n), None


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` along dim 0 for a non-decreasing ``idx``; its
    backward sums the rows' gradients in slot order (:func:`segment_sum`)."""
    return _GatherRows.apply(values, idx.long())


def _rows(seg: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return seg.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)


def seq_pool_sum(sb: SequenceBatch) -> torch.Tensor:
    return segment_sum(_zero_invalid(sb, sb.data), _runs(sb), sb.num_seqs)


def seq_pool_avg(sb: SequenceBatch) -> torch.Tensor:
    s = seq_pool_sum(sb)
    denom = torch.clamp(sb.lengths, min=1).to(s.dtype)
    return s / denom.reshape((-1,) + (1,) * (s.dim() - 1))


def seq_pool_sqrtn(sb: SequenceBatch) -> torch.Tensor:
    s = seq_pool_sum(sb)
    denom = torch.sqrt(torch.clamp(sb.lengths, min=1).to(s.dtype))
    return s / denom.reshape((-1,) + (1,) * (s.dim() - 1))


def seq_pool_max(sb: SequenceBatch) -> torch.Tensor:
    """Per-sequence max; the gradient goes to the maximal token (a tie
    between tokens shares it, as ``scatter_reduce`` splits it)."""
    data = sb.data
    low = (float("-inf") if data.is_floating_point()
           else torch.iinfo(data.dtype).min)
    valid = sb.valid_mask.reshape((-1,) + (1,) * (data.dim() - 1))
    masked = torch.where(valid, data, torch.full_like(data, low))
    out = torch.full((sb.num_seqs + 1,) + data.shape[1:], low,
                     dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, _rows(_seg(sb), masked), masked, "amax",
                             include_self=True)
    return out[:sb.num_seqs]


def seq_first(sb: SequenceBatch) -> torch.Tensor:
    """First token of each sequence (sequences packed in order from slot
    0, as the feeder and ``from_padded`` pack them)."""
    ends = torch.cumsum(sb.lengths, 0)
    starts = torch.cat([ends.new_zeros((1,)), ends[:-1]])
    return gather_rows(sb.data, starts)


def seq_last(sb: SequenceBatch) -> torch.Tensor:
    """Last token of each sequence (slot 0 for an empty one)."""
    ends = torch.clamp(torch.cumsum(sb.lengths, 0) - 1, min=0)
    return gather_rows(sb.data, ends)


def sequence_softmax(sb: SequenceBatch) -> SequenceBatch:
    """Softmax over each sequence's scalar scores; data [capacity] or
    [capacity, 1].  The per-sequence maximum only shifts the exponent, so
    it carries no gradient (the softmax's derivative through it is 0)."""
    x = sb.data
    squeeze = x.dim() > 1
    if squeeze:
        x = x[..., 0]
    seg = _seg(sb)
    n = sb.num_seqs + 1
    valid = sb.valid_mask
    x = torch.where(valid, x, torch.full_like(x, float("-inf")))
    mx = torch.full((n,), float("-inf"), dtype=x.dtype, device=x.device)
    mx = mx.scatter_reduce(0, seg, x.detach(), "amax", include_self=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    ex = torch.where(valid, torch.exp(x - mx.index_select(0, seg)),
                     torch.zeros_like(x))
    runs = _runs(sb)
    z = segment_sum(ex, runs, sb.num_seqs)
    out = ex / torch.clamp(gather_rows(z, runs), min=1e-30)
    if squeeze:
        out = out[..., None]
    return sb.with_data(out.to(sb.data.dtype))


def seq_expand(short, sb_long: SequenceBatch) -> SequenceBatch:
    """Each sequence's row of ``short`` (a dense [num_seqs, ...] tensor,
    or a SequenceBatch whose first tokens are taken) copied to every
    token of that sequence in ``sb_long``; padding slots are 0."""
    values = seq_first(short) if isinstance(short, SequenceBatch) else short
    seg = torch.clamp(_runs(sb_long), max=values.shape[0] - 1)
    data = gather_rows(values, seg)
    mask = sb_long.valid_mask.reshape((-1,) + (1,) * (data.dim() - 1))
    return sb_long.with_data(torch.where(mask, data, torch.zeros_like(data)))


def seq_concat(a: SequenceBatch, b: SequenceBatch) -> SequenceBatch:
    """Sequence i of ``a`` followed by sequence i of ``b``, capacity the
    sum of theirs."""
    pa, _ = a.to_padded()
    pb, mb = b.to_padded()
    B, Ta, Tb = a.num_seqs, pa.shape[1], pb.shape[1]
    # one more column takes b's padding slots, then is cut off
    out = torch.cat([pa, pa.new_zeros((B, Tb + 1) + pa.shape[2:])], dim=1)
    t_idx = torch.arange(Tb, device=pb.device)[None, :] + \
        a.lengths.long()[:, None]
    t_idx = torch.where(mb, t_idx, Ta + Tb)
    rows = torch.arange(B, device=pb.device)[:, None].expand(B, Tb)
    out = out.index_put((rows, t_idx), pb.to(out.dtype))[:, :Ta + Tb]
    return SequenceBatch.from_padded(out, a.lengths + b.lengths,
                                     capacity=a.capacity + b.capacity)


def seq_reshape(sb: SequenceBatch, new_dim: int) -> SequenceBatch:
    """Each sequence's [len, d] as [len d / new_dim, new_dim] (tokens
    packed)."""
    d = sb.data.shape[-1]
    cap = sb.capacity * d // new_dim
    lengths = (sb.lengths * d) // new_dim
    new_max = None if sb.max_len is None else max(1, sb.max_len * d //
                                                  new_dim)
    return SequenceBatch(data=sb.data.reshape(cap, new_dim),
                         segment_ids=lengths_to_segment_ids(lengths, cap),
                         lengths=lengths.to(torch.int32), max_len=new_max)


def seq_slice(sb: SequenceBatch, starts: torch.Tensor,
              ends: torch.Tensor) -> SequenceBatch:
    """Keep the tokens at positions [start, end) of each sequence, in
    place (the dropped ones become padding); same capacity."""
    pos = position_in_sequence(sb.segment_ids)
    seg = torch.clamp(sb.segment_ids, 0, sb.num_seqs - 1).long()
    keep = sb.valid_mask & (pos >= starts[seg]) & (pos < ends[seg])
    lengths = torch.clamp(torch.minimum(ends, sb.lengths) - starts, min=0)
    mask = keep.reshape((-1,) + (1,) * (sb.data.dim() - 1))
    return SequenceBatch(
        data=torch.where(mask, sb.data, torch.zeros_like(sb.data)),
        segment_ids=torch.where(keep, sb.segment_ids,
                                sb.num_seqs).to(torch.int32),
        lengths=lengths.to(torch.int32), max_len=sb.max_len)


def kmax_seq_score(sb: SequenceBatch, k: int) -> torch.Tensor:
    """[num_seqs, k] int32 positions of each sequence's k best scores
    (data [capacity] or [capacity, 1]), -1 past its length.  Equal scores
    go to the lower position first, as ``lax.top_k`` orders them: a
    stable descending sort, where ``torch.topk`` promises no order."""
    data = sb.data[..., 0] if sb.data.dim() > 1 else sb.data
    scores, mask = sb.with_data(data).to_padded()
    scores = torch.where(mask, scores, torch.full_like(scores,
                                                       float("-inf")))
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]
    valid = torch.gather(mask, 1, idx)
    return torch.where(valid, idx, -1).to(torch.int32)


def max_id(x: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (the first of equal maxima), int32."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def sub_nested_seq(sb: SequenceBatch, selected: torch.Tensor
                   ) -> SequenceBatch:
    """Keep the inner sequences ``selected`` [num_seqs, k] names (-1 for
    none) of a nested batch, in place; the result is a flat batch."""
    enforce_that(sb.sub_segment_ids is not None,
                 "sub_nested_seq requires a nested SequenceBatch",
                 context="sub_nested_seq")
    n = sb.num_seqs
    seg = torch.clamp(sb.segment_ids, 0, n - 1).long()
    sel = selected.long()[seg]                              # [capacity, k]
    keep = (sel == sb.sub_segment_ids.long()[:, None]).any(-1) & \
        sb.valid_mask
    # an integer count: exact in any order
    lengths = torch.zeros(n + 1, dtype=torch.int32,
                          device=seg.device).index_add_(
        0, torch.where(keep, seg, n), keep.to(torch.int32))[:n]
    mask = keep.reshape((-1,) + (1,) * (sb.data.dim() - 1))
    return SequenceBatch(
        data=torch.where(mask, sb.data, torch.zeros_like(sb.data)),
        segment_ids=torch.where(keep, sb.segment_ids, n).to(torch.int32),
        lengths=lengths, max_len=sb.max_len)
