"""DataFeeder: sample batches -> tensors / SequenceBatch (the port of
``paddle_tpu/data_feeder.py``: dense vectors, sparse binary and sparse
float vectors, integer values, and sequences and nested sequences of
each).

A dense slot is one f32 row per sample, stacked to a [B, dim] tensor (a
sample already shaped [H, W, C] or the like keeps its shape, as
``paddle_tpu/data_feeder.py:55-60`` allows).  An integer value slot is
one int32 per sample, a [B] tensor (a [B, n] one for rows of n > 1
values), as ``paddle_tpu/data_feeder.py:76-83`` gives it.  A sparse
binary sample (a list of ids) and a sparse float sample (a list of (id,
value) pairs, the last pair of an id winning) become dense f32 rows of
``dim`` (``paddle_tpu/data_feeder.py:64-71``), alone or as a sequence's
tokens.  Sequence slots
are packed into the flat segment-id form with a bucketed capacity (the
next power of two over the batch's token count, at least 64) and a
bucketed ``max_len`` (at least 16), as in the JAX package: the same batch
gives the same capacity, the same segment ids and so the same attention
masks in both packages.  Integer tokens are a [capacity] tensor, dense
ones [capacity, dim].  A sub-sequence slot takes a list of inner
sequences per sample and adds their inner ids (``sub_segment_ids``, 0 on
padding).  The tensors go to the feeder's device, ``cuda`` unless asked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

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

    def __call__(self, batch_data):
        return self.feed(batch_data)

    def feed(self, batch_data) -> Dict[str, Union[torch.Tensor,
                                                  SequenceBatch]]:
        out: Dict[str, Union[torch.Tensor, SequenceBatch]] = {}
        for name, itype in self.data_types:
            col = [sample[self.feeding[name]] for sample in batch_data]
            if itype.seq == SeqKind.SEQUENCE:
                out[name] = self._sequence(itype, col)
            elif itype.seq == SeqKind.SUB_SEQUENCE:
                out[name] = self._sub_sequence(itype, col)
            elif itype.slot == SlotKind.INDEX:
                out[name] = self._values(col)
            else:
                out[name] = self._dense(itype, name, col)
        return out

    @staticmethod
    def _row(itype: InputType, name: str, r) -> np.ndarray:
        """One sample (or token) of a dense or sparse slot as f32."""
        if itype.slot == SlotKind.SPARSE_BINARY:
            row = np.zeros((itype.dim,), np.float32)
            row[np.asarray(r, dtype=np.int64)] = 1.0
            return row
        if itype.slot == SlotKind.SPARSE_FLOAT:
            row = np.zeros((itype.dim,), np.float32)
            for idx, val in r:
                row[idx] = val
            return row
        arr = np.asarray(r, dtype=np.float32)
        enforce_that(arr.size == itype.dim or arr.ndim > 1,
                     f"dense slot {name!r} expects dim {itype.dim}, got "
                     f"shape {arr.shape}", context="feeder")
        return arr.reshape(-1) if arr.ndim <= 1 else arr

    def _dense(self, itype: InputType, name: str, col) -> torch.Tensor:
        rows = [self._row(itype, name, r) for r in col]
        return torch.from_numpy(np.stack(rows)).to(self.device)

    def _values(self, col) -> torch.Tensor:
        # one conversion for the column (rows of one shape), not one a row
        arr = np.asarray(col, np.int32).reshape(len(col), -1)
        if arr.shape[1] == 1:
            arr = arr[:, 0]
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _tokens(self, itype: InputType, seq) -> np.ndarray:
        """One sequence's tokens: [n] int32 ids or [n, dim] f32 rows (a
        sparse token made dense)."""
        if itype.slot == SlotKind.INDEX:
            return np.asarray(seq, np.int32).reshape(-1)
        rows = [self._row(itype, "token", t).reshape(-1) for t in seq]
        for r in rows:
            enforce_that(r.size == itype.dim, f"dense sequence slot expects "
                         f"dim {itype.dim}, got {r.size}", context="feeder")
        return (np.stack(rows) if rows else
                np.zeros((0, itype.dim), np.float32))

    def _pack(self, itype: InputType, seqs) -> SequenceBatch:
        cap = _bucket(sum(s.shape[0] for s in seqs))
        dtype = np.int32 if itype.slot == SlotKind.INDEX else np.float32
        sb = SequenceBatch.from_list(seqs, dtype=dtype, capacity=cap,
                                     device=self.device)
        # bucket the host-side max_len as the JAX feeder does
        return dataclasses.replace(
            sb, max_len=min(cap, _bucket(sb.max_len or 1, minimum=16)))

    def _sequence(self, itype: InputType, col) -> SequenceBatch:
        return self._pack(itype, [self._tokens(itype, s) for s in col])

    def _sub_sequence(self, itype: InputType, col) -> SequenceBatch:
        flat, sub_ids = [], []
        for sample in col:
            inner = [self._tokens(itype, s) for s in sample]
            for j, toks in enumerate(inner):
                sub_ids.extend([j] * toks.shape[0])
            flat.append(np.concatenate(inner, axis=0) if inner else
                        self._tokens(itype, []))
        sb = self._pack(itype, flat)
        sub = np.zeros((sb.capacity,), np.int32)
        sub[:len(sub_ids)] = sub_ids
        return dataclasses.replace(
            sb, sub_segment_ids=torch.from_numpy(sub).to(self.device))
