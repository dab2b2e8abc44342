"""Ragged sequences in flat, segment-id form (the port of
``SequenceBatch``, ``paddle_tpu/sequence.py:27-232``, nested batches
included).

A batch of variable-length sequences is one token buffer padded to a
capacity, plus ``segment_ids`` mapping each slot to its sequence.  Padding
slots take the id ``num_seqs``, so they form one more segment of their
own: attention never crosses a segment, and costs mask padding out with
``valid_mask``.  ``to_padded``/``from_padded`` give the [B, T, ...] view
the recurrent scans take, with T the feeder's bucketed ``max_len``.

A nested batch (sequences of sub-sequences, the reference's
``subSequenceStartPositions``) carries a second level of ids,
``sub_segment_ids``: each slot's inner-sequence index within its outer
sequence.  :func:`nested_to_padded` and :func:`nested_from_padded` give
and take its [B, S, W, ...] view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that


@dataclass(frozen=True)
class SequenceBatch:
    """data: [capacity, ...feature]; segment_ids: [capacity] int32 (>=
    num_seqs marks padding); lengths: [num_seqs] int32; max_len: a host-
    side upper bound on the longest sequence; sub_segment_ids: [capacity]
    int32 inner-sequence ids of a nested batch, else None."""

    data: torch.Tensor
    segment_ids: torch.Tensor
    lengths: torch.Tensor
    max_len: Optional[int] = None
    sub_segment_ids: Optional[torch.Tensor] = None

    @property
    def num_seqs(self) -> int:
        return self.lengths.shape[0]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def valid_mask(self) -> torch.Tensor:
        return self.segment_ids < self.num_seqs

    def with_data(self, data: torch.Tensor) -> "SequenceBatch":
        return SequenceBatch(data, self.segment_ids, self.lengths,
                             self.max_len, self.sub_segment_ids)

    def to_padded(self, max_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """([B, T, ...feature], mask [B, T]): T is ``max_len``, else
        ``self.max_len``, else the capacity.  Tokens at positions >= T are
        dropped; empty slots are 0."""
        B = self.num_seqs
        T = int(max_len if max_len is not None
                else (self.max_len or self.capacity))
        pos = position_in_sequence(self.segment_ids)
        valid = self.valid_mask & (pos < T)
        seg = torch.where(valid, self.segment_ids, B).long()
        p = torch.where(valid, pos, 0).long()
        feat = self.data.shape[1:]
        vals = torch.where(valid.reshape((-1,) + (1,) * len(feat)),
                           self.data, torch.zeros_like(self.data))
        out = self.data.new_zeros((B + 1, T) + feat).index_put((seg, p), vals)
        mask = torch.arange(T, device=self.lengths.device)[None, :] < \
            self.lengths[:, None]
        return out[:B], mask

    @staticmethod
    def from_padded(padded: torch.Tensor, lengths: torch.Tensor,
                    capacity: Optional[int] = None) -> "SequenceBatch":
        """Flat form of [B, T, ...] + lengths, tokens packed in sequence
        order (a stable sort puts the valid slots first); the capacity
        defaults to B * T."""
        B, T = padded.shape[0], padded.shape[1]
        dev = padded.device
        cap = int(capacity) if capacity is not None else B * T
        seg_full = torch.arange(B, dtype=torch.int32,
                                device=dev).repeat_interleave(T)
        pos_full = torch.arange(T, dtype=torch.int32, device=dev).repeat(B)
        valid_full = pos_full < lengths[seg_full.long()]
        order = torch.argsort((~valid_full).to(torch.int32), stable=True)
        take = order[:cap]
        # index_select: its backward is an index_add, where an indexed
        # gather's sorts the indices first; `take` holds each slot at most
        # once, so every row of that index_add gets one addend and the sum
        # is the same to the bit in any order
        flat = padded.reshape((B * T,) + padded.shape[2:]).index_select(
            0, take)
        seg = torch.where(valid_full[take], seg_full[take],
                          B).to(torch.int32)
        if cap > B * T:          # pad out to the requested capacity
            extra = cap - B * T
            flat = torch.cat([flat, flat.new_zeros((extra,) +
                                                   flat.shape[1:])])
            seg = torch.cat([seg, torch.full((extra,), B, dtype=torch.int32,
                                             device=dev)])
        keep = (seg < B).reshape((-1,) + (1,) * (flat.dim() - 1))
        data = torch.where(keep, flat, torch.zeros_like(flat))
        return SequenceBatch(data=data, segment_ids=seg, lengths=lengths,
                             max_len=T)

    @staticmethod
    def from_list(seqs, dtype=np.float32, capacity: Optional[int] = None,
                  device: DeviceLike = None) -> "SequenceBatch":
        """Pack a list of [len_i, ...] arrays on the host, then move the
        packed buffers to ``device`` (``cuda`` unless asked otherwise)."""
        dev = resolve_device(device)
        arrs = [np.asarray(s) for s in seqs]
        lengths = np.asarray([a.shape[0] for a in arrs], dtype=np.int32)
        total = int(lengths.sum())
        cap = capacity if capacity is not None else total
        enforce_that(cap >= total,
                     f"from_list capacity {cap} < total tokens {total}",
                     context="sequence")
        feat = arrs[0].shape[1:] if arrs else ()
        data = np.zeros((cap,) + feat, dtype=dtype)
        seg = np.full((cap,), len(arrs), dtype=np.int32)
        off = 0
        for i, a in enumerate(arrs):
            n = a.shape[0]
            data[off:off + n] = a
            seg[off:off + n] = i
            off += n
        return SequenceBatch(
            data=torch.from_numpy(data).to(dev),
            segment_ids=torch.from_numpy(seg).to(dev),
            lengths=torch.from_numpy(lengths).to(dev),
            max_len=int(lengths.max()) if len(arrs) else 0)


def position_in_sequence(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-slot position within its segment (segments contiguous)."""
    n = segment_ids.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=segment_ids.device)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=segment_ids.device),
                          segment_ids[1:] != segment_ids[:-1]])
    start_idx = torch.where(is_start, idx, torch.zeros_like(idx))
    return idx - torch.cummax(start_idx, dim=0).values


def lengths_to_segment_ids(lengths: torch.Tensor,
                           capacity: int) -> torch.Tensor:
    """[num_seqs] lengths -> [capacity] contiguous segment ids, padding
    at ``num_seqs``."""
    B = lengths.shape[0]
    ends = torch.cumsum(lengths, 0)
    slots = torch.arange(capacity, dtype=ends.dtype, device=lengths.device)
    seg = torch.searchsorted(ends, slots, right=True).to(torch.int32)
    return torch.where(slots < ends[-1], seg, B).to(torch.int32)


def nested_to_padded(sb: SequenceBatch, max_inner: int, max_inner_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense view of a nested batch: ([B, S, W, ...feature] data, inner
    lengths [B, S], inner-sequence counts [B]).  ``max_inner`` (S) and
    ``max_inner_len`` (W) are host-side bounds; tokens past them are
    dropped, as ``to_padded`` drops those past its ``max_len``."""
    enforce_that(sb.sub_segment_ids is not None,
                 "nested_to_padded needs a nested SequenceBatch "
                 "(sub_segment_ids)", context="sequence")
    B, S, W = sb.num_seqs, int(max_inner), int(max_inner_len)
    seg = sb.segment_ids.long()
    sub = sb.sub_segment_ids.long()
    valid = sb.valid_mask & (sub < S)
    # contiguous (outer, inner) runs give the position in the inner one
    combined = torch.where(valid, seg * S + sub, B * S)
    pos = position_in_sequence(combined).long()
    valid = valid & (pos < W)
    s_seg = torch.where(valid, seg, B)
    s_sub = torch.where(valid, sub, 0)
    s_pos = torch.where(valid, pos, 0)
    feat = sb.data.shape[1:]
    vals = torch.where(valid.reshape((-1,) + (1,) * len(feat)), sb.data,
                       torch.zeros_like(sb.data))
    out = sb.data.new_zeros((B + 1, S, W) + feat).index_put(
        (s_seg, s_sub, s_pos), vals)
    ones = valid.to(torch.int32)
    # integer sums and maxima: exact in any order
    inner_lens = torch.zeros((B + 1) * S, dtype=torch.int32,
                             device=seg.device).index_add_(
        0, s_seg * S + s_sub, ones).reshape(B + 1, S)
    counts = torch.zeros(B + 1, dtype=torch.int32,
                         device=seg.device).scatter_reduce(
        0, torch.where(valid, seg, B), torch.where(valid, sub + 1, 0).to(
            torch.int32), "amax", include_self=True)
    return out[:B], inner_lens[:B], counts[:B]


def nested_from_padded(data: torch.Tensor, inner_lens: torch.Tensor,
                       counts: torch.Tensor, capacity: int
                       ) -> SequenceBatch:
    """Inverse of :func:`nested_to_padded`: [B, S, W, ...feature] + inner
    lengths [B, S] + counts [B] -> a nested batch of ``min(capacity, B S
    W)`` slots (the JAX package's size), tokens packed in (outer, inner,
    position) order."""
    B, S, W = data.shape[0], data.shape[1], data.shape[2]
    dev = data.device
    cap = int(capacity)
    feat = data.shape[3:]
    b_ix = torch.arange(B, device=dev).repeat_interleave(S * W)
    s_ix = torch.arange(S, device=dev).repeat_interleave(W).repeat(B)
    w_ix = torch.arange(W, device=dev).repeat(B * S)
    valid = (s_ix < counts.long()[b_ix]) & \
        (w_ix < inner_lens.long()[b_ix, s_ix])
    order = torch.argsort((~valid).to(torch.int32), stable=True)[:cap]
    flat = data.reshape((B * S * W,) + feat).index_select(0, order)
    seg = torch.where(valid[order], b_ix[order], B).to(torch.int32)
    sub = torch.where(valid[order], s_ix[order], 0).to(torch.int32)
    live = torch.arange(S, device=dev)[None, :] < counts[:, None]
    lengths = torch.where(live, inner_lens, torch.zeros_like(inner_lens)
                          ).sum(1).to(torch.int32)
    mask = (seg < B).reshape((-1,) + (1,) * len(feat))
    return SequenceBatch(data=torch.where(mask, flat, torch.zeros_like(flat)),
                         segment_ids=seg, lengths=lengths,
                         max_len=min(cap, S * W), sub_segment_ids=sub)
