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

The row-sharded tables, lookups and updates (``shard_table``,
``sharded_lookup``, ``sharded_row_update``, ``alltoall_lookup``) are not
ported yet: a mesh raises.
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


class SparseEmbeddingUpdater:
    """Row-sparse updates for marked embedding parameters inside a
    training loop (the ``sparse_update=True`` path of the reference).

    ``apply(params, grads, lr, ids={...})`` updates a marked parameter
    only on the rows named by that step's ids, from the rows of its dense
    gradient (duplicate ids counted once); unmarked parameters, and marked
    ones without ids, take the dense SGD step ``p -= lr * g``.  Updates
    are in place; returns ``params``."""

    def __init__(self, mesh=None, sparse_params: Tuple[str, ...] = ()):
        enforce_that(mesh is None,
                     "SparseEmbeddingUpdater takes no mesh yet: the "
                     "row-sharded tables and updates of parallel/sparse.py "
                     "are not ported", context="sparse")
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
                safe = uniq.clamp(0, p.shape[0] - 1)
                rows = torch.where(pad, 0.0, g.index_select(0, safe))
                sgd_update_rows(p, SelectedRows(safe, rows, p.shape[0]), lr)
            else:
                p.sub_(lr * g)
        return params
