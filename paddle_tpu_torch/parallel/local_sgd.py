"""Local SGD with periodic parameter averaging (the port of
``paddle_tpu/parallel/local_sgd.py``, the asynchronous-SGD analog).

Reference analog: the pserver's asynchronous path applies each trainer's
gradients without barriers, trainers tolerate stale parameters, and
``async_lagged_grad_discard_ratio`` drops gradients that lag too far
behind.  Here there is no parameter server: each rank of a ``data`` axis
keeps its own replica and steps it on its rows of the batch with no
traffic, and every ``sync_period`` steps the replicas are averaged with
one all-reduce.  ``lagged_grad_discard_ratio`` skips the local update of
a rank whose gradient norm exceeds the ratio times the mean norm over
the axis (an outlier or straggler gradient).

JAX stacks the replicas on a leading axis sharded over the mesh; here
each rank holds its own replica as a ``{name: tensor}`` dict.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.api import shard_batch

__all__ = ["LocalSGD"]


def _tree_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.values()))


class LocalSGD:
    """Local-update data parallelism with periodic averaging over
    ``axis`` of ``mesh``.

    ``replicate`` gives every rank of the axis the first rank's
    parameters, ``average`` their mean over the axis, and
    ``make_step(grad_fn)`` the step each rank runs on its replica."""

    def __init__(self, mesh, sync_period: int = 4, axis: str = "data",
                 lagged_grad_discard_ratio: float = 0.0,
                 learning_rate: float = 0.01):
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.axis_size(axis)
        self.group = mesh.group(axis)
        self.sync_period = int(sync_period)
        self.discard_ratio = float(lagged_grad_discard_ratio)
        self.lr = float(learning_rate)

    # -- parameter layout --------------------------------------------------

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce_(x.detach().clone(), self.group) / self.n

    @torch.no_grad()
    def replicate(self, params: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """This rank's replica: a copy of the axis's first rank's
        ``params`` (one broadcast per tensor)."""
        src = self.mesh.axis_ranks(self.axis)[0]
        return {k: comm.broadcast_(v.detach().clone(), src, self.group)
                for k, v in params.items()}

    @torch.no_grad()
    def average(self, params: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The mean of every rank's replica, on every rank."""
        return {k: self._mean(v) for k, v in params.items()}

    # -- step --------------------------------------------------------------

    def make_step(self, grad_fn: Callable):
        """``grad_fn(params, feeds) -> (loss, grads)`` on one rank's rows.

        Returns ``step(params, step_idx, feeds) -> (new params, mean
        loss)``: ``feeds`` are the global batch (each value's leading dim
        divisible by the axis size), of which the step takes this rank's
        rows; ``step_idx`` is the same on every rank, so the averaging
        all-reduce runs on all of them at once."""
        period, ratio, lr = self.sync_period, self.discard_ratio, self.lr

        def step(params, step_idx: int, feeds):
            local = {k: shard_batch(self.mesh, v, self.axis)
                     for k, v in feeds.items()}
            loss, grads = grad_fn(params, local)
            with torch.no_grad():
                if ratio > 0.0:
                    gn = _tree_norm(grads)
                    keep = gn <= ratio * self._mean(gn)
                    grads = {k: torch.where(keep, g, torch.zeros_like(g))
                             for k, g in grads.items()}
                new = {k: p.detach() - lr * grads[k]
                       for k, p in params.items()}
                if (int(step_idx) + 1) % period == 0:
                    new = {k: self._mean(v) for k, v in new.items()}
                return new, self._mean(loss.detach().float())

        return step
