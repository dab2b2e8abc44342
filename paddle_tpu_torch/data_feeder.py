"""DataFeeder: sample batches -> tensors / SequenceBatch (the port of
``paddle_tpu/data_feeder.py``, sequence INDEX slots only so far).

Sequence slots are packed into the flat segment-id form with a bucketed
capacity (the next power of two over the batch's token count, at least
64), as in the JAX package: the same batch gives the same capacity, the
same segment ids and so the same attention masks in both packages.  The
packed tensors go to the feeder's device, ``cuda`` unless asked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from paddle_tpu_torch.data_type import InputType, SeqKind, SlotKind
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.sequence import SequenceBatch


def _bucket(n: int, minimum: int = 64) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


class DataFeeder:
    """feeding: {data_layer_name: index-in-sample} or a list of names."""

    def __init__(self, data_types: List[Tuple[str, InputType]], feeding=None,
                 device: DeviceLike = None):
        self.data_types = data_types
        if feeding is None:
            feeding = {name: i for i, (name, _) in enumerate(data_types)}
        elif isinstance(feeding, (list, tuple)):
            feeding = {name: i for i, name in enumerate(feeding)}
        self.feeding = feeding
        self.device = resolve_device(device)
        for name, itype in data_types:
            enforce_that(itype.slot == SlotKind.INDEX and
                         itype.seq == SeqKind.SEQUENCE,
                         f"slot {name!r} is {itype}: the port feeds integer "
                         "sequences only so far", context="feeder")

    def __call__(self, batch_data) -> Dict[str, SequenceBatch]:
        return self.feed(batch_data)

    def feed(self, batch_data) -> Dict[str, SequenceBatch]:
        out: Dict[str, SequenceBatch] = {}
        for name, _ in self.data_types:
            col = [sample[self.feeding[name]] for sample in batch_data]
            out[name] = self._sequence(col)
        return out

    def _sequence(self, col) -> SequenceBatch:
        seqs = [np.asarray(s, np.int32).reshape(-1) for s in col]
        cap = _bucket(sum(s.shape[0] for s in seqs))
        sb = SequenceBatch.from_list(seqs, dtype=np.int32, capacity=cap,
                                     device=self.device)
        # bucket the host-side max_len as the JAX feeder does
        return dataclasses.replace(
            sb, max_len=min(cap, _bucket(sb.max_len or 1, minimum=16)))
