"""Device meshes over ``torch.distributed`` ranks (the port of
``paddle_tpu/parallel/mesh.py``).

A :class:`Mesh` lays the job's ranks out as an N-d array with one name
per axis (the taxonomy of :mod:`paddle_tpu_torch.parallel.placement`:
``data``, ``zero``, ``stage``, ``expert``, ``model``) and holds one
process group per axis: the ranks that share every other coordinate with
this one.  A collective "over an axis" is a collective on that group.
Each rank computes on one device: its card under NCCL, the CPU under
gloo.

``torch.distributed.new_group`` must be called by every process of the
job, in the same order, for every group: so every process builds every
mesh, also a mesh it is not part of.  A mesh of one rank needs no
process group at all; without ``init_process_group`` only such meshes
can be built.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from paddle_tpu_torch.platform.enforce import enforce_that


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """``shape`` ranks named by ``axis_names``; ``ranks`` (default
    ``0 .. n-1``) are the global ranks in row-major order.

    ``devices`` is the array of global ranks (JAX's ``mesh.devices``),
    ``shape`` maps each axis to its size (JAX's ``mesh.shape``).
    ``coord(axis)`` is this rank's index along an axis, ``group(axis)``
    its process group (None outside a ``torch.distributed`` job),
    ``axis_ranks(axis)``
    the global ranks of that group in axis order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        shape = tuple(int(s) for s in shape)
        names = tuple(str(a) for a in axis_names)
        enforce_that(len(shape) == len(names),
                     f"mesh shape {shape} and axes {names} differ in rank",
                     context="mesh")
        enforce_that(len(set(names)) == len(names),
                     f"mesh axes {names} repeat a name", context="mesh")
        n = int(np.prod(shape)) if shape else 1
        ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
        enforce_that(len(ranks) == n,
                     f"mesh {shape} needs {n} ranks, got {len(ranks)}",
                     context="mesh")
        ws = world_size()
        enforce_that(max(ranks) < ws,
                     f"mesh {shape} needs ranks {ranks}, the job has {ws} "
                     "(start the ranks with torch.distributed, e.g. "
                     "platform.virtual.start_ranks on the CPU)",
                     context="mesh")
        self.axis_names: Tuple[str, ...] = names
        self.devices = np.asarray(ranks, dtype=np.int64).reshape(shape)
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.size = n
        self.rank = global_rank()
        hit = np.argwhere(self.devices == self.rank)
        self.member = bool(len(hit))
        self._coords = tuple(int(c) for c in hit[0]) if self.member \
            else (0,) * len(shape)
        self._groups: Dict[str, object] = {}
        self._lines: Dict[str, List[int]] = {}
        for i, a in enumerate(names):
            self._build_axis(i, a)
        # one group over the whole mesh (broadcasts, barriers); None when
        # the mesh is the whole job or one rank
        self.whole_group = dist.new_group(ranks) \
            if 1 < n < ws else None

    def _build_axis(self, i: int, a: str) -> None:
        moved = np.moveaxis(self.devices, i, -1)
        lines = moved.reshape(-1, moved.shape[-1])
        for line in lines:
            ranks = [int(r) for r in line]
            # an axis of one rank still gets its group inside a job (its
            # collectives then run, as identities, on the backend)
            group = dist.new_group(ranks) if dist.is_initialized() \
                else None
            if self.rank in ranks:
                self._groups[a] = group
                self._lines[a] = ranks

    # -- queries -----------------------------------------------------------

    def axis_size(self, axis: str) -> int:
        enforce_that(axis in self.shape, f"no axis {axis!r} in mesh "
                     f"{self.axis_names}", context="mesh")
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        self.axis_size(axis)
        return self._coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        self.axis_size(axis)
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        self.axis_size(axis)
        return list(self._lines.get(axis, [self.rank]))

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, ranks="
                f"{self.devices.reshape(-1).tolist()})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh over the first prod(shape) ranks (or over ``devices``, a
    list of global ranks)."""
    n = int(np.prod(tuple(shape)))
    ranks = list(range(world_size())) if devices is None \
        else [int(r) for r in devices]
    enforce_that(n <= len(ranks),
                 f"mesh {tuple(shape)} needs {n} devices, have "
                 f"{len(ranks)}", context="mesh")
    return Mesh(shape, axis_names, ranks[:n])


def data_parallel_mesh(num: Optional[int] = None) -> Mesh:
    """1-D ``data`` mesh over every rank (or the first ``num``)."""
    n = num or world_size()
    return make_mesh((n,), ("data",))


def hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                axis_names: Sequence[str], devices=None) -> Mesh:
    """Multi-host mesh: each axis is ``dcn * ici`` long, laid out so the
    ``ici`` factor varies fastest (ranks of one host, which torchrun
    numbers consecutively, stay adjacent along every axis) and the
    ``dcn`` factor spans hosts.  Needs exactly that many ranks."""
    enforce_that(len(ici_shape) == len(dcn_shape) == len(axis_names),
                 "ici_shape/dcn_shape/axis_names must have the same rank",
                 context="hybrid_mesh")
    ranks = list(range(world_size())) if devices is None \
        else [int(r) for r in devices]
    shape = tuple(int(i) * int(d) for i, d in zip(ici_shape, dcn_shape))
    n = int(np.prod(shape))
    enforce_that(n == len(ranks),
                 f"hybrid mesh {shape} needs exactly {n} devices, got "
                 f"{len(ranks)} (pass devices= to build a sub-mesh)",
                 context="hybrid_mesh")
    k = len(shape)
    # rank index = (dcn coords, ici coords) row-major, then interleave to
    # (dcn_0, ici_0, dcn_1, ici_1, ...) and merge each pair into an axis
    arr = np.asarray(ranks).reshape(tuple(int(d) for d in dcn_shape)
                                    + tuple(int(i) for i in ici_shape))
    arr = np.transpose(arr, [j for i in range(k) for j in (i, i + k)])
    return Mesh(shape, axis_names, arr.reshape(-1).tolist())


def mesh_slices(tp: int, axis: str = "model", devices=None,
                max_slices: Optional[int] = None) -> List[Mesh]:
    """Consecutive ``tp``-rank 1-D meshes over ``axis`` (leftover ranks
    unused): the unit a tensor-parallel serving replica runs on."""
    ranks = list(range(world_size())) if devices is None \
        else [int(r) for r in devices]
    tp = int(tp)
    enforce_that(tp >= 1, f"tp must be >= 1, got {tp}", context="mesh")
    n = len(ranks) // tp
    enforce_that(n >= 1, f"{len(ranks)} device(s) cannot host even one "
                 f"{tp}-chip slice", context="mesh")
    if max_slices is not None:
        n = min(n, int(max_slices))
    return [Mesh((tp,), (axis,), ranks[i * tp:(i + 1) * tp])
            for i in range(n)]


def mesh_axis_names(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)
