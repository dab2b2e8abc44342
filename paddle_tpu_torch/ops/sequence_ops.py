"""Sequence pooling on the flat segment-id form (the port of
``paddle_tpu/ops/sequence_ops.py:24-52``, the pooling ops so far).

Padding slots go to one trash segment (``num_seqs``) that is cut off the
result, so no per-sequence loop is needed.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.sequence import SequenceBatch


def _seg(sb: SequenceBatch) -> torch.Tensor:
    """Segment ids with pads mapped to the trash segment (= num_seqs)."""
    return torch.where(sb.valid_mask, sb.segment_ids, sb.num_seqs).long()


def _rows(seg: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return seg.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)


def seq_pool_sum(sb: SequenceBatch) -> torch.Tensor:
    out = sb.data.new_zeros((sb.num_seqs + 1,) + sb.data.shape[1:])
    return out.index_add(0, _seg(sb), sb.data)[:sb.num_seqs]


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
