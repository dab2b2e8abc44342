"""Sequence ops on the flat segment-id form (the port of
``paddle_tpu/ops/sequence_ops.py:24-101``: the pooling ops, ``seq_first``,
``seq_last``, ``sequence_softmax`` and ``seq_expand``).

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
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.sequence import SequenceBatch


def _seg(sb: SequenceBatch) -> torch.Tensor:
    """Segment ids with pads mapped to the trash segment (= num_seqs)."""
    return torch.where(sb.valid_mask, sb.segment_ids, sb.num_seqs).long()


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
    return segment_sum(sb.data, _seg(sb), sb.num_seqs)


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
    z = segment_sum(ex, seg, n)
    out = ex / torch.clamp(gather_rows(z, seg), min=1e-30)
    if squeeze:
        out = out[..., None]
    return sb.with_data(out.to(sb.data.dtype))


def seq_expand(short, sb_long: SequenceBatch) -> SequenceBatch:
    """Each sequence's row of ``short`` (a dense [num_seqs, ...] tensor,
    or a SequenceBatch whose first tokens are taken) copied to every
    token of that sequence in ``sb_long``; padding slots are 0."""
    values = seq_first(short) if isinstance(short, SequenceBatch) else short
    seg = torch.clamp(sb_long.segment_ids, 0, values.shape[0] - 1).long()
    data = gather_rows(values, seg)
    mask = sb_long.valid_mask.reshape((-1,) + (1,) * (data.dim() - 1))
    return sb_long.with_data(torch.where(mask, data, torch.zeros_like(data)))
