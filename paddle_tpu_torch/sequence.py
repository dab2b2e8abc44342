"""Ragged sequences in flat, segment-id form (the port of
``SequenceBatch``, ``paddle_tpu/sequence.py:27-160``).

A batch of variable-length sequences is one token buffer padded to a
capacity, plus ``segment_ids`` mapping each slot to its sequence.  Padding
slots take the id ``num_seqs``, so they form one more segment of their
own: attention never crosses a segment, and costs mask padding out with
``valid_mask``.  ``to_padded``/``from_padded`` give the [B, T, ...] view
the recurrent scans take, with T the feeder's bucketed ``max_len``.
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
    side upper bound on the longest sequence."""

    data: torch.Tensor
    segment_ids: torch.Tensor
    lengths: torch.Tensor
    max_len: Optional[int] = None

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
                             self.max_len)

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
