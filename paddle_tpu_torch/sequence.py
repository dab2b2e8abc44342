"""Ragged sequences in flat, segment-id form (the port of
``SequenceBatch``, ``paddle_tpu/sequence.py:27-131``).

A batch of variable-length sequences is one token buffer padded to a
capacity, plus ``segment_ids`` mapping each slot to its sequence.  Padding
slots take the id ``num_seqs``, so they form one more segment of their
own: attention never crosses a segment, and costs mask padding out with
``valid_mask``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
