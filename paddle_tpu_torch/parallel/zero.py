"""ZeRO-1: optimizer state sharded over the data axis (the port of
``paddle_tpu/parallel/zero.py``; arXiv 2004.13336).

Each parameter is flattened, zero-padded to a multiple of the axis size N
and cut into N equal chunks; rank i of the axis owns chunk i of every
optimizer slot.  A step:

1. :meth:`ZeroPlan.shard_view` reduce-scatters the rank's own gradient
   (each rank's loss is one part of the global loss): rank i receives
   chunk i of the summed gradient;
2. the optimizer's elementwise rule updates chunk i of the weight
   (:meth:`ZeroPlan.local_view`) with chunk i of every slot;
3. :meth:`ZeroPlan.gather_view` all-gathers the updated chunks back into
   the whole weight on every rank.

JAX states the same layout with sharding constraints and GSPMD lowers
them to the reduce-scatter and all-gather; here they are the explicit
``torch.distributed`` calls.  Parameters the plan leaves whole (a
declared sharding, static, or a mesh of one) take an all-reduce of their
gradient instead.

Checkpoints stay layout-free: :meth:`ZeroPlan.gather_state` all-gathers
every flat slot back to its parameter's shape, and
:meth:`ZeroPlan.shard_state` cuts a loaded full-shape state into this
rank's chunks, so a run saved on N ranks resumes on M.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.platform.enforce import enforce_that

# state keys holding one entry per parameter name; everything else in an
# optimizer state (step, the sm scalars, avg_count) has no layout
_PARAM_KEYED = ("avg", "prune_masks")


@dataclass(frozen=True)
class ZeroEntry:
    """A parameter's layout: ``shape`` flattens to ``size`` elements,
    zero-padded to ``padded`` (a multiple of the axis size) when
    sharded."""

    shape: Tuple[int, ...]
    size: int
    padded: int
    sharded: bool
    # split over the axis by the ``zero_axis`` rule: gathered for the
    # forward, its gradient arrives summed over the axis
    summed: bool = False


class ZeroPlan:
    """The shard plan over one mesh axis.  Step side:
    :meth:`local_view`, :meth:`shard_view`, :meth:`gather_view`.
    Placement side (checkpoints): :meth:`shard_state`,
    :meth:`gather_state`."""

    def __init__(self, mesh, axis: str, entries: Dict[str, ZeroEntry]):
        self.mesh = mesh
        self.axis = axis
        self.entries = entries
        self.n = mesh.axis_size(axis)
        self.index = mesh.coord(axis)
        self.group = comm.axis_group(mesh, axis)

    def is_sharded(self, name: str) -> bool:
        e = self.entries.get(name)
        return e is not None and e.sharded

    def _chunk(self, e: ZeroEntry) -> slice:
        k = e.padded // self.n
        return slice(self.index * k, (self.index + 1) * k)

    def _flat_padded(self, e: ZeroEntry, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1)
        if e.padded != e.size:
            flat = torch.cat([flat, flat.new_zeros(e.padded - e.size)])
        return flat

    # -- step side ---------------------------------------------------------

    def local_view(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's flat chunk of a whole tensor (a parameter, a prune
        mask), a copy; a whole entry passes through."""
        e = self.entries.get(name)
        if e is None or not e.sharded:
            return x
        return self._flat_padded(e, x.detach())[self._chunk(e)].clone()

    def shard_view(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's own gradient -> its chunk of the gradient summed
        over the axis (the reduce-scatter); a whole entry's gradient is
        all-reduced."""
        e = self.entries.get(name)
        if e is not None and e.summed:
            return g
        if e is None or not e.sharded:
            return comm.all_reduce_(g.contiguous(), self.group)
        return comm.reduce_scatter_flat(self._flat_padded(e, g), self.group)

    def gather_view(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's updated chunk -> the whole tensor (the
        all-gather)."""
        e = self.entries.get(name)
        if e is None or not e.sharded:
            return x
        full = comm.all_gather_flat(x.contiguous(), self.group)
        return full[:e.size].reshape(e.shape)

    # -- placement side (checkpoints) --------------------------------------

    def place_flat(self, name: str, v) -> np.ndarray:
        """A whole-shape (or already flat padded) host array -> this
        rank's flat chunk."""
        e = self.entries[name]
        host = np.asarray(v)
        if not e.sharded:
            return host
        if host.shape != (e.padded,):
            enforce_that(host.size == e.size,
                         f"zero shard of {name!r}: got {host.shape}, "
                         f"expected {e.shape} or flat ({e.padded},)",
                         context="zero")
            flat = host.reshape(-1)
            if e.padded != e.size:
                flat = np.concatenate(
                    [flat, np.zeros(e.padded - e.size, flat.dtype)])
            host = flat
        return host[self._chunk(e)].copy()

    def _map_keyed(self, state: Any, fn) -> Any:
        if not isinstance(state, dict):
            return state
        out = dict(state)
        if "slots" in out:
            out["slots"] = {
                s: {k: (fn(k, v) if k in self.entries else v)
                    for k, v in d.items()}
                for s, d in out["slots"].items()}
        for key in _PARAM_KEYED:
            if key in out:
                out[key] = {k: (fn(k, v) if k in self.entries else v)
                            for k, v in out[key].items()}
        return out

    def shard_state(self, state: Any) -> Any:
        """A full-shape host optimizer state (a checkpoint's) -> this
        rank's flat chunks of every planned slot."""
        return self._map_keyed(state, self.place_flat)

    def _unflatten(self, name: str, v) -> Any:
        e = self.entries[name]
        if not e.sharded or tuple(v.shape) == e.shape:
            return v
        return self.gather_view(name, v)

    def gather_state(self, state: Any) -> Any:
        """Inverse of :meth:`shard_state` on live tensors: every flat
        slot all-gathered back to its parameter's shape (a collective:
        every rank of the axis calls it)."""
        return self._map_keyed(state, self._unflatten)


def build_zero_plan(mesh, params: Dict[str, Any], specs=None,
                    axis: str = "data",
                    zero_axis: Optional[str] = None) -> ZeroPlan:
    """The per-tensor plan over ``axis``: only parameters
    :func:`~paddle_tpu_torch.parallel.api.param_sharding` leaves whole
    (no declared sharding, not split by ``zero_axis``'s largest-dim rule)
    and that are not static get the flat 1/N layout; sizes that do not
    divide pad up."""
    from paddle_tpu_torch.parallel.api import param_sharding

    enforce_that(axis in mesh.axis_names, f"no axis {axis!r} in mesh",
                 context="zero")
    n = mesh.axis_size(axis)
    declared = param_sharding(mesh, params, specs=specs, zero_axis=zero_axis)
    entries = {}
    for name, v in params.items():
        attr = specs[name].attr if specs is not None and name in specs \
            else None
        static = bool(attr is not None and attr.is_static)
        explicit = attr is not None and attr.sharding is not None
        replicated = not explicit and all(a is None for a in declared[name])
        shape = tuple(v.shape)
        size = int(np.prod(shape)) if shape else 1
        sharded = replicated and not static and n > 1
        padded = -(-size // n) * n if sharded else size
        summed = not explicit and axis in declared[name]
        entries[name] = ZeroEntry(shape=shape, size=size, padded=padded,
                                  sharded=sharded, summed=summed)
    return ZeroPlan(mesh, axis, entries)


def opt_state_bytes_per_device(tree) -> int:
    """Bytes this rank holds of a state tree (every tensor is local)."""
    total = 0
    if isinstance(tree, dict):
        for v in tree.values():
            total += opt_state_bytes_per_device(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            total += opt_state_bytes_per_device(v)
    elif isinstance(tree, torch.Tensor):
        total += tree.numel() * tree.element_size()
    elif isinstance(tree, np.ndarray):
        total += tree.nbytes
    return total
