"""Batch and parameter placement, and the ``DataParallel`` helper (the
port of ``paddle_tpu/parallel/api.py``).

JAX places one global array over the mesh and lets GSPMD slice it; here
every rank holds its own part.  A *spec* is JAX's ``PartitionSpec`` as a
tuple: one entry a dim, an axis name (that dim is split over the axis in
equal chunks, chunk i on the rank at coordinate i) or None.
:func:`local_shard` cuts a rank's part out of a full tensor and
:func:`gather_full` puts the parts back together (an all-gather per
split dim).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.parallel.comm import all_gather_dim, axis_group
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.sequence import SequenceBatch

Spec = Tuple[Optional[str], ...]


def _rows(mesh, axis: str, n_rows: int) -> slice:
    n = mesh.axis_size(axis)
    enforce_that(n_rows % n == 0,
                 f"a batch of {n_rows} does not divide over {axis}={n}",
                 context="shard_batch")
    k = n_rows // n
    i = mesh.coord(axis)
    return slice(i * k, (i + 1) * k)


def shard_batch(mesh, value, axis: str = "data"):
    """This rank's rows of a global batch: a tensor's leading-dim chunk,
    or a SequenceBatch's chunk of whole sequences, repacked at 1/N of the
    global capacity (or the most any rank's sequences fill), so the ranks'
    slots together are the global batch's, padding slots included: a
    layer that routes every slot (``moe_ffn``) sees JAX's slot count."""
    if isinstance(value, SequenceBatch):
        rows = _rows(mesh, axis, value.num_seqs)
        if rows.stop - rows.start == value.num_seqs:
            return value
        padded, _ = value.to_padded()
        lengths = value.lengths[rows]
        k = rows.stop - rows.start
        fill = int(value.lengths.reshape(-1, k).sum(dim=1).max())
        cap = max(value.capacity // mesh.axis_size(axis), fill)
        sb = SequenceBatch.from_padded(padded[rows], lengths, capacity=cap)
        if value.max_len is not None:
            sb = SequenceBatch(sb.data, sb.segment_ids, sb.lengths,
                               value.max_len)
        return sb
    return value[_rows(mesh, axis, value.shape[0])]


def replicate(mesh, tree):
    """Every rank of ``mesh`` takes its first rank's tensors (a
    broadcast per tensor, in place); returns ``tree``."""
    import torch.distributed as dist

    if mesh.size == 1:
        return tree
    src = int(mesh.devices.reshape(-1)[0])
    group = mesh.whole_group

    def put(v):
        if isinstance(v, torch.Tensor):
            dist.broadcast(v, src=src, group=group)
        elif isinstance(v, dict):
            for x in v.values():
                put(x)
        return v

    put(tree)
    return tree


def param_sharding(mesh, params: Dict[str, object], specs=None,
                   zero_axis: Optional[str] = None) -> Dict[str, Spec]:
    """{name: spec}: a declared ``ParamAttr.sharding`` wins (dims naming
    an axis this mesh lacks fall back to None); else with ``zero_axis``
    the largest dim divisible by that axis's size is split over it
    (ZeRO-3-style weight sharding); else replicated ``()``."""
    out: Dict[str, Spec] = {}
    for name, v in params.items():
        shape = tuple(v.shape)
        attr = None
        if specs is not None and name in specs:
            attr = specs[name].attr
        if attr is not None and attr.sharding is not None:
            out[name] = tuple(a if (a is None or a in mesh.shape) else None
                              for a in attr.sharding)
        elif zero_axis is not None:
            n = mesh.axis_size(zero_axis)
            dims: list = [None] * len(shape)
            for d in np.argsort(shape, kind="stable")[::-1]:
                if shape[d] % n == 0 and shape[d] >= n:
                    dims[int(d)] = zero_axis
                    break
            out[name] = tuple(dims)
        else:
            out[name] = ()
    return out


def is_split(spec: Spec) -> bool:
    return any(a is not None for a in spec)


def local_shard(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's part of ``full`` under ``spec`` (a copy when split)."""
    out = full
    for d, a in enumerate(spec):
        if a is None:
            continue
        n = mesh.axis_size(a)
        enforce_that(out.shape[d] % n == 0,
                     f"dim {d} of {tuple(full.shape)} does not divide over "
                     f"{a}={n}", context="placement")
        k = out.shape[d] // n
        i = mesh.coord(a)
        out = out.narrow(d, i * k, k)
    return out.contiguous() if out is not full else full


def gather_full(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's part under ``spec`` (every
    rank of each split axis must call it)."""
    out = local.detach()
    for d, a in enumerate(spec):
        if a is not None:
            out = all_gather_dim(out, d, axis_group(mesh, a))
    return out


def _map_slots(state, fn):
    """``state`` with ``fn(name, v)`` applied to every per-parameter
    entry (slots, model averages, prune masks)."""
    if not isinstance(state, dict):
        return state
    out = dict(state)
    if "slots" in out:
        out["slots"] = {s: {k: fn(k, v) for k, v in d.items()}
                        for s, d in out["slots"].items()}
    for key in ("avg", "prune_masks"):
        if key in out:
            out[key] = {k: fn(k, v) for k, v in out[key].items()}
    return out


class MeshPlacement:
    """What a trainer on a mesh does around its step (JAX's
    ``_place_on_mesh``, ``_shard_feeds`` and the gradient psum GSPMD
    inserts):

    - :meth:`place` cuts each split parameter (a declared
      ``ParamAttr.sharding``, or ``zero_axis``'s largest-dim rule) down
      to this rank's part and makes every whole one equal to the mesh's
      first rank's;
    - :meth:`forward_params` all-gathers the ``zero_axis``-split weights
      for the forward (the layers use declared splits as they are); over
      the data axis the gather's backward reduce-scatters;
    - :meth:`shard_feeds` takes this rank's rows of the global batch over
      ``data``; each rank's loss is then 1/N of the global one and
      :meth:`reduce_grads` sums the gradients over ``data``;
    - :meth:`whole_params`/:meth:`whole_state` gather the parts for a
      checkpoint and :meth:`local_params`/:meth:`local_state` cut a
      loaded one, so a checkpoint holds whole tensors whatever the
      layout."""

    def __init__(self, mesh, params: Dict[str, torch.Tensor], specs=None,
                 zero_axis: Optional[str] = None):
        self.mesh = mesh
        shard = param_sharding(mesh, params, specs=specs,
                               zero_axis=zero_axis)
        self.layout: Dict[str, Spec] = {k: v for k, v in shard.items()
                                        if is_split(v)}
        declared = set()
        for k in params:
            attr = specs[k].attr if specs is not None and k in specs \
                else None
            if attr is not None and attr.sharding is not None:
                declared.add(k)
        self.gathered = {k for k in self.layout if k not in declared}
        self.dp_axis = "data" if "data" in mesh.axis_names else None
        # split over the data axis and gathered: the gather's backward
        # already sums the chunk's gradient over 'data'
        self.summed = {k for k in self.gathered
                       if self.dp_axis in self.layout[k]}
        self.dp_group = axis_group(mesh, self.dp_axis)
        self.dp_n = mesh.axis_size(self.dp_axis) if self.dp_axis else 1

    def place(self, parameters) -> None:
        whole = {}
        for k in list(parameters.keys()):
            v = parameters[k]
            if k in self.layout:
                parameters.place(k, local_shard(v, self.layout[k],
                                                self.mesh))
            else:
                whole[k] = v
        with torch.no_grad():
            replicate(self.mesh, whole)

    def forward_params(self, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        from paddle_tpu_torch.parallel.comm import (gather_parts,
                                                    gather_replicated)

        if not self.gathered:
            return params
        out = dict(params)
        # sorted: every rank must gather in the same order (a set's
        # order follows the process's string hash seed)
        for k in sorted(self.gathered):
            if k in out:
                v = out[k]
                for d, a in enumerate(self.layout[k]):
                    if a is not None:
                        gather = gather_parts if a == self.dp_axis \
                            else gather_replicated
                        v = gather(v, d, axis_group(self.mesh, a))
                out[k] = v
        return out

    def shard_feeds(self, feeds: Dict[str, object]) -> Dict[str, object]:
        if self.dp_axis is None or self.dp_n == 1:
            return feeds
        return {k: shard_batch(self.mesh, v, self.dp_axis)
                for k, v in feeds.items()}

    def reduce_grads(self, grads: Dict[str, Optional[torch.Tensor]]
                     ) -> None:
        """Sum each gradient over ``data``, in place (those of weights
        split over it arrive summed)."""
        from paddle_tpu_torch.parallel.comm import all_reduce_

        if self.dp_group is None:
            return
        for k, g in grads.items():
            if g is not None and k not in self.summed:
                all_reduce_(g, self.dp_group)

    def mean_over_data(self, v: torch.Tensor) -> torch.Tensor:
        """A per-rank scalar (a part's cost) -> the global mean."""
        from paddle_tpu_torch.parallel.comm import all_reduce_

        if self.dp_group is None:
            return v.detach()
        return all_reduce_(v.detach().clone(), self.dp_group) / self.dp_n

    def whole_params(self, params: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        return {k: (gather_full(params[k], self.layout[k], self.mesh)
                    if k in self.layout else params[k])
                for k in sorted(params)}

    def whole_state(self, state):
        return _map_slots(state, lambda k, v: (
            gather_full(v, self.layout[k], self.mesh)
            if k in self.layout and isinstance(v, torch.Tensor) else v))

    def local_params(self, loaded: Dict[str, object]) -> Dict[str, object]:
        return {k: (self._cut(k, v) if k in self.layout else v)
                for k, v in loaded.items()}

    def local_state(self, state):
        return _map_slots(state, lambda k, v: (
            self._cut(k, v) if k in self.layout else v))

    def _cut(self, k, v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        return local_shard(t, self.layout[k], self.mesh)

    @property
    def writer(self) -> bool:
        """The rank that writes checkpoints: the mesh's first."""
        return self.mesh.rank == int(self.mesh.devices.reshape(-1)[0])


class DataParallel:
    """Convenience: this rank's share of the feeds and replicated
    parameters for data-parallel training (``trainer.SGD`` does the same
    when given a mesh)."""

    def __init__(self, mesh, axis: str = "data"):
        enforce_that(axis in mesh.axis_names, f"no axis {axis!r} in mesh",
                     context="DataParallel")
        self.mesh = mesh
        self.axis = axis

    def shard_feeds(self, feeds: Dict[str, object]) -> Dict[str, object]:
        return {k: shard_batch(self.mesh, v, self.axis)
                for k, v in feeds.items()}

    def replicate_params(self, params):
        return replicate(self.mesh, params)

    @property
    def num_devices(self) -> int:
        return int(self.mesh.size)
