"""Collectives over one mesh axis, plain and differentiable.

GSPMD inserts the JAX package's collectives implicitly and differentiates
through ``shard_map``'s; here each one is an explicit ``torch.distributed``
call, and the ones on a training path are ``autograd.Function``s whose
backward is the transposed collective.  Every function takes the axis's
process group; ``None`` (an axis of one rank) makes it the identity.

Two kinds of region meet in a parallel program: *replicated* values
(every rank of the axis holds the same tensor and computes the same
thing with it) and *sharded* ones (each rank holds its part).  Their
boundaries, in the Megatron-LM convention:

- :func:`enter_sharded` — a replicated value used inside a sharded
  computation (a router weight over token shards, the input of a
  column-split product): identity forward, all-reduce of the gradient
  backward (each rank's gradient covers only its part);
- :func:`reduce_replicated` — per-rank partial sums made whole (a
  row-split product): all-reduce forward, identity backward;
- :func:`gather_replicated` / :func:`scatter_replicated` — a sharded
  value made replicated and back: all-gather forward and the own chunk
  backward, or the reverse;
- :func:`all_to_all` and :func:`ppermute` — shard exchanges, their own
  transposes (the reverse exchange).

A data-parallel axis is different: each rank's loss is a part of the
global loss, so its gradients are summed (:func:`all_reduce_`) by the
trainer, not by these boundaries; a weight split over that axis is
gathered by :func:`gather_parts`, whose backward reduce-scatters.  A
statistic of the global batch (batch norm's sums, a mixture of experts'
routing means) is :func:`pooled_sum`: all-reduce forward, and all-reduce
backward, since every rank's part of the loss reads the pooled value.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from paddle_tpu_torch.parallel.compat import (all_gather_single,
                                              reduce_scatter_single)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place sum (or ``op``) over the group."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_flat(shard: torch.Tensor, group) -> torch.Tensor:
    """[k] shards -> [n * k] in group-rank order."""
    n = group_size(group)
    if n == 1:
        return shard
    out = torch.empty((n * shard.shape[0],) + tuple(shard.shape[1:]),
                      dtype=shard.dtype, device=shard.device)
    all_gather_single(out, shard.contiguous(), group=group)
    return out


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank
    order."""
    n = group_size(group)
    if n == 1:
        return t
    moved = t.movedim(dim, 0).contiguous()
    full = all_gather_flat(moved, group)
    return full.movedim(0, dim).contiguous()


def reduce_scatter_flat(full: torch.Tensor, group) -> torch.Tensor:
    """[n * k] per rank -> this rank's [k] chunk of the sum."""
    n = group_size(group)
    if n == 1:
        return full
    out = torch.empty((full.shape[0] // n,) + tuple(full.shape[1:]),
                      dtype=full.dtype, device=full.device)
    reduce_scatter_single(out, full.contiguous(), group=group)
    return out


def chunk_of(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal chunk of ``t`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return t
    return t.chunk(n, dim=dim)[group_rank(group)].contiguous()


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place: every rank's ``t`` becomes global rank ``src``'s."""
    if group is not None:
        dist.broadcast(t, src=src, group=group)
    return t


def _exchange(x: torch.Tensor, ranks: Sequence[int],
              perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: group-index pairs (src, dst); this rank sends
    ``x`` to its dst and returns what its src sent (zeros without one)."""
    me = ranks.index(dist.get_rank())
    ops: List[dist.P2POp] = []
    out = torch.zeros_like(x)
    for s, d in perm:
        if s == me and d != me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[d]))
        if d == me and s != me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s]))
        if s == me and d == me:
            out = x.clone()
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


# ---------------------------------------------------------------------------
# differentiable boundaries
# ---------------------------------------------------------------------------


class _EnterSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return chunk_of(g, ctx.dim, ctx.group), None, None


class _ScatterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return chunk_of(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


class _GatherParts(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward: a weight split over a
    data-parallel axis (``zero_axis``) gathered for a forward whose loss
    is one part of the global loss on each rank, so its chunk's gradient
    sums every rank's."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        moved = g.movedim(ctx.dim, 0).contiguous()
        part = reduce_scatter_flat(moved, ctx.group)
        return part.movedim(0, ctx.dim).contiguous(), None, None


class _PooledSum(torch.autograd.Function):
    """All-reduce forward and backward: a sum over the ranks' rows of a
    batch whose loss is split over the same ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, perm):
        ctx.ranks, ctx.perm = ranks, perm
        return _exchange(x, ranks, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _exchange(g.contiguous(), ctx.ranks, back), None, None


def enter_sharded(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _EnterSharded.apply(x, group)


def reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceReplicated.apply(x, group)


def pooled_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over a data-parallel group of per-rank partial sums, on
    every rank; its gradient is the sum of every rank's gradient."""
    return x if group is None else _PooledSum.apply(x, group)


def mean_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group of per-rank values, replicated (JAX's
    ``pmean``); its gradient is the replicated gradient over n."""
    n = group_size(group)
    return x if n == 1 else reduce_replicated(x, group) / n


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherReplicated.apply(x, dim, group)


def scatter_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _ScatterReplicated.apply(x, dim, group)


def gather_parts(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherParts.apply(x, dim, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal split of dim 0 into n chunks; chunk j goes to group rank j,
    and the result holds every rank's chunk for this one, in rank
    order (JAX's ``all_to_all(split_axis=0, concat_axis=0)``)."""
    return x if group is None else _AllToAll.apply(x, group)


def ppermute(x: torch.Tensor, ranks: Sequence[int],
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """JAX's ``lax.ppermute`` over an axis whose global ranks are
    ``ranks``: ``perm`` pairs axis indices (src, dst)."""
    if len(ranks) == 1:
        for s, d in perm:
            if s == d == 0:
                return x
        return torch.zeros_like(x)
    return _PPermute.apply(x, list(ranks), [tuple(p) for p in perm])


def axis_group(mesh, axis: Optional[str]):
    """The mesh's group over ``axis``; None without a mesh or axis."""
    if mesh is None or axis is None or axis not in mesh.shape:
        return None
    return mesh.group(axis)
