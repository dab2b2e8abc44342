"""Sparse embedding gradients and row updates (the port of the
single-device half of ``paddle_tpu/parallel/sparse.py``: ``SelectedRows``,
``embedding_grad``, ``sgd_update_rows``, ``adagrad_update_rows`` and
``SparseEmbeddingUpdater`` without a mesh).

A gradient stays in SelectedRows form (ids and rows) and the optimizers
update only the touched rows of a table.  The JAX functions return new
tables; these update the table (and accumulator) IN PLACE and return it,
which keeps one copy of a table that may take gigabytes (33.8 M rows at
Criteo's width).  Duplicate ids are first combined by an ordered segment
sum (a stable sort of the ids, then ``torch.segment_reduce``), as the JAX
package combines them with ``jnp.unique(size=n)`` and ``segment_sum``:
every touched row then takes exactly one addend, so the update is the
same to the bit on every run, where an ``index_add`` over duplicates
adds with atomics in no fixed order on the card.  The combine keeps the
JAX shape discipline, n slots for n ids, the unused slots padded with id
-1 and masked to zero rows, so no call waits for the host.

The row-sharded half (the pserver block partition): a table sharded
over a mesh axis of N ranks is each rank's contiguous ``vocab / N`` rows
(:func:`shard_table`).  :func:`sharded_lookup` serves every id from its
owner (each rank gathers the ids it owns, zeros for the rest, and one
all-reduce over the axis assembles the rows everywhere; each rank
passes its own ids, so a batch split over a data axis is looked up
slice by slice — JAX's ``batch_axis``), :func:`alltoall_lookup`
takes ids split over the axis (an all-gather of the queries, owners
compute, a reduce-scatter hands each rank its rows back), and
:func:`sharded_row_update` applies an SGD row update to the rows each
rank owns, with no traffic.  ``SparseEmbeddingUpdater(mesh=)`` takes
that update for its marked tables, each held as this rank's shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.ops.sequence_ops import segment_sum
from paddle_tpu_torch.platform.enforce import enforce_that


@dataclass
class SelectedRows:
    """A sparse slab of a [height, dim] tensor: ``rows[i]`` is the
    gradient of table row ``ids[i]``.  Duplicate ids are allowed and
    sum."""

    ids: torch.Tensor     # [n] integer
    rows: torch.Tensor    # [n, dim]
    height: int

    def to_dense(self) -> torch.Tensor:
        uniq, combined = _combine(self.ids, self.rows)
        out = self.rows.new_zeros((self.height, self.rows.shape[-1]))
        safe = uniq.clamp(0, self.height - 1)
        return out.index_add_(0, safe, combined)


def _unique(ids: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, slot, uniq) of n ids: the stable order that sorts them,
    the slot of each sorted id among the distinct ones (non-decreasing),
    and the distinct ids ascending, padded with -1 to n slots."""
    ids = ids.reshape(-1).long()
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    slot = torch.cumsum(first.long(), 0) - 1
    uniq = torch.full_like(sid, -1).scatter_(0, slot, sid)
    return order, slot, uniq


def _combine(ids: torch.Tensor, rows: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uniq [n], combined [n, dim]): the distinct ids (:func:`_unique`)
    and each one's rows summed in slot order (pad slots zero)."""
    order, slot, uniq = _unique(ids)
    return uniq, segment_sum(rows[order], slot, uniq.shape[0])


def embedding_grad(table: torch.Tensor, ids: torch.Tensor,
                   loss_fn: Callable[[torch.Tensor], torch.Tensor]
                   ) -> Tuple[torch.Tensor, SelectedRows]:
    """(loss, SelectedRows gradient) of an embedding lookup:
    ``loss_fn(rows)`` consumes the gathered rows [n, dim]; the table is
    never densely differentiated."""
    flat = ids.reshape(-1).long()
    rows = table.detach().index_select(0, flat).requires_grad_(True)
    loss = loss_fn(rows)
    d_rows, = torch.autograd.grad(loss, rows)
    return loss.detach(), SelectedRows(flat, d_rows, table.shape[0])


@torch.no_grad()
def sgd_update_rows(table: torch.Tensor, grad: SelectedRows,
                    lr: float) -> torch.Tensor:
    """``table[ids] -= lr * rows`` (duplicates summed), in place;
    returns ``table``."""
    uniq, combined = _combine(grad.ids, grad.rows)
    safe = uniq.clamp(0, table.shape[0] - 1)
    # pad slots clip to row 0 with zero deltas: adding +0 changes nothing
    return table.index_add_(0, safe, (-lr * combined).to(table.dtype))


@torch.no_grad()
def adagrad_update_rows(table: torch.Tensor, accum: torch.Tensor,
                        grad: SelectedRows, lr: float,
                        epsilon: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sparse Adagrad, in place on ``table`` and ``accum``; returns
    both.  Each touched row's gradients are combined first, so the
    accumulator sees each row once."""
    uniq, combined = _combine(grad.ids, grad.rows)
    pad = (uniq < 0)[:, None]
    safe = uniq.clamp(0, table.shape[0] - 1)
    combined = torch.where(pad, 0.0, combined)
    acc_delta = combined * combined
    acc_rows = accum.index_select(0, safe) + acc_delta
    step = lr * combined / (torch.sqrt(acc_rows) + epsilon)
    tab_delta = torch.where(pad, 0.0, -step)
    table.index_add_(0, safe, tab_delta.to(table.dtype))
    accum.index_add_(0, safe, acc_delta.to(accum.dtype))
    return table, accum


# ---------------------------------------------------------------------------
# mesh-sharded table + lookup
# ---------------------------------------------------------------------------


def _shard_rows(mesh, axis: str, vocab: int) -> Tuple[int, int]:
    """(first row, rows) of this rank's shard of a ``vocab``-row table."""
    n = mesh.axis_size(axis)
    enforce_that(vocab % n == 0,
                 f"vocab {vocab} must divide over {n} '{axis}' shards",
                 context="sparse")
    per = vocab // n
    return mesh.coord(axis) * per, per


def shard_table(mesh, table: torch.Tensor, axis: str = "model"
                ) -> torch.Tensor:
    """This rank's contiguous ``vocab / N`` rows of a [vocab, dim] table
    row-sharded over ``axis`` (a copy: the whole table may be freed)."""
    lo, per = _shard_rows(mesh, axis, table.shape[0])
    return table[lo:lo + per].clone()


def _owned_rows(shard: torch.Tensor, ids: torch.Tensor, lo: int):
    """The shard's rows for the ids it owns, zeros for the others."""
    per = shard.shape[0]
    rel = ids.long() - lo
    mine = (rel >= 0) & (rel < per)
    rows = shard.index_select(0, rel.clamp(0, per - 1).reshape(-1))
    rows = rows.reshape(tuple(ids.shape) + (shard.shape[-1],))
    return torch.where(mine[..., None], rows, torch.zeros_like(rows))


def sharded_lookup(mesh, shard: torch.Tensor, ids: torch.Tensor,
                   axis: str = "model") -> torch.Tensor:
    """Rows of a row-sharded table for ``ids``: owner computes, then one
    all-reduce over ``axis`` gives every rank of it the whole rows.
    ``shard`` is this rank's :func:`shard_table`; ``ids`` the ids this
    rank asks for.  The ranks of one ``axis`` group may ask for
    different ids: where a batch is split over a data axis (JAX's
    ``batch_axis``), each passes its own slice and gets that slice's
    rows."""
    from paddle_tpu_torch.parallel import comm

    n = mesh.axis_size(axis)
    lo, _ = _shard_rows(mesh, axis, shard.shape[0] * n)
    rows = _owned_rows(shard, ids, lo)
    return comm.all_reduce_(rows, mesh.group(axis))


@torch.no_grad()
def sharded_row_update(mesh, shard: torch.Tensor, grad: SelectedRows,
                       lr: float, axis: str = "model") -> torch.Tensor:
    """SGD row update of a row-sharded table, in place on this rank's
    ``shard``: each rank adds ``-lr * rows`` to the rows it owns
    (duplicates summed first) and moves no gradient; returns ``shard``."""
    n = mesh.axis_size(axis)
    lo, per = _shard_rows(mesh, axis, shard.shape[0] * n)
    uniq, combined = _combine(grad.ids, grad.rows)
    rel = uniq - lo
    mine = ((uniq >= 0) & (rel >= 0) & (rel < per))[:, None]
    delta = torch.where(mine, -lr * combined, torch.zeros_like(combined))
    return shard.index_add_(0, rel.clamp(0, per - 1),
                            delta.to(shard.dtype))


def alltoall_lookup(mesh, shard: torch.Tensor, ids: torch.Tensor,
                    axis: str = "model") -> torch.Tensor:
    """Lookup for ids split over ``axis`` (``ids``: this rank's [b / N]
    queries of a global [b]): an all-gather of the queries, each owner
    serves its rows, and a reduce-scatter hands every rank the rows of
    its own queries."""
    from paddle_tpu_torch.parallel import comm

    n = mesh.axis_size(axis)
    lo, _ = _shard_rows(mesh, axis, shard.shape[0] * n)
    group = mesh.group(axis)
    every = comm.all_gather_flat(ids.reshape(-1), group)        # [b]
    rows = _owned_rows(shard, every, lo)
    return comm.reduce_scatter_flat(rows, group)


class SparseEmbeddingUpdater:
    """Row-sparse updates for marked embedding parameters inside a
    training loop (the ``sparse_update=True`` path of the reference).

    ``apply(params, grads, lr, ids={...})`` updates a marked parameter
    only on the rows named by that step's ids, from the rows of its dense
    gradient (duplicate ids counted once); unmarked parameters, and marked
    ones without ids, take the dense SGD step ``p -= lr * g``.  Updates
    are in place; returns ``params``.

    With a ``mesh``, a marked parameter is this rank's shard of a table
    row-sharded over ``axis`` (:func:`shard_table`) and its gradient the
    whole table's; the marked rows take :func:`sharded_row_update`."""

    def __init__(self, mesh=None, sparse_params: Tuple[str, ...] = (),
                 axis: str = "model"):
        if mesh is not None:
            mesh.axis_size(axis)
        self.mesh = mesh
        self.axis = axis
        self.sparse = set(sparse_params)

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, Optional[torch.Tensor]], lr: float,
              ids: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
        ids = ids or {}
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            if k in self.sparse and k in ids:
                _, _, uniq = _unique(ids[k])
                pad = (uniq < 0)[:, None]
                safe = uniq.clamp(0, g.shape[0] - 1)
                rows = torch.where(pad, 0.0, g.index_select(0, safe))
                sel = SelectedRows(safe, rows, g.shape[0])
                if self.mesh is not None:
                    sharded_row_update(self.mesh, p, sel, lr, self.axis)
                else:
                    sgd_update_rows(p, sel, lr)
            else:
                p.sub_(lr * g)
        return params
