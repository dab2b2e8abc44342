"""GPipe pipeline parallelism over a mesh axis (the port of
``paddle_tpu/parallel/pipeline.py``).

The model is S shape-homogeneous stages; stage i's weights live only on
the rank at coordinate i of the ``stage`` axis.  M microbatches run the
GPipe fill-and-drain schedule in M + S - 1 ticks: at tick t stage i runs
microbatch t - i (when there is one) on the activation stage i - 1 sent
it at the end of tick t - 1, then every stage hands its output to the
next in one ``batch_isend_irecv``.  The backward is the same schedule in
reverse: the last stage starts from the loss's gradient and each stage
sends its input's gradient back.  Bubble ticks run nothing (JAX's SPMD
program computes them and masks the result).

JAX differentiates its scan of ``ppermute`` hops; here the schedule is an
``autograd.Function`` that keeps each microbatch's stage graph from the
forward (or, with ``remat``, only its input, recomputing the stage in the
backward) and runs ``torch.autograd.backward`` on it microbatch by
microbatch, so each send meets its receive in a known order.

Boundary hooks put the embedding and the loss on the end stages:
``first_fn(first_params, mb)`` makes stage 0's input from a microbatch's
feed, ``last_fn(last_params, y, mb)`` maps the last stage's output (and
the feed, for targets) to the value that accumulates.  The [M, ...]
accumulator is broadcast from the last stage to every stage (JAX's psum
of a one-hot-masked buffer); the hooks' parameters are whole on every
stage, and their gradients, made on one stage, are summed over the axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.parallel.moe import CommBudget, _factor
from paddle_tpu_torch.platform.enforce import enforce_that


@dataclass(frozen=True)
class PipelineConfig:
    """``trainer.SGD(pipeline=PipelineConfig(...))``: ``num_stages`` S
    (0: the ``pipeline_stages`` flag, else the mesh's ``axis`` size, else
    every rank), ``microbatches`` M (0: the ``pipeline_microbatches``
    flag), the zoo transformer's ``n_layers``/``n_heads`` (``blk{i}_*``
    parameters -> S stages of n_layers/S blocks) and ``remat``."""

    num_stages: int = 0
    microbatches: int = 0
    axis: str = "stage"
    remat: bool = False
    n_layers: int = 0
    n_heads: int = 1


def pipeline_contract(mesh, axis: str, m: int, hop_shape, hop_dtype,
                      out_shape, out_dtype,
                      n_extra_args: int = 0) -> CommBudget:
    """Bytes one schedule moves: one hop of the activation a tick
    (``ticks = M + S - 1``; JAX's ppermute sends every tick) and the
    replication of the [M, ...] accumulator (JAX's psum,
    ``2 M b_out (S-1)/S``).  ``n_extra_args`` is JAX's signature; it
    moves no bytes."""
    del n_extra_args
    s = int(mesh.shape[axis])
    ticks = m + s - 1
    b_hop = int(np.prod(hop_shape)) * _itemsize(hop_dtype)
    b_out = int(np.prod(out_shape)) * _itemsize(out_dtype)
    comm_b = float(ticks * b_hop) + 2.0 * m * b_out * _factor(s)
    return CommBudget(comm_bytes=comm_b, mesh_axes=tuple(
        (a, int(mesh.shape[a])) for a in mesh.axis_names))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


def stack_stage_params(param_list: Sequence[Dict[str, torch.Tensor]],
                       mesh=None, axis: str = "stage"
                       ) -> Dict[str, torch.Tensor]:
    """Stack S per-stage dicts into one with leading dim S; with a mesh,
    this rank's stage slice [1, ...] of it."""
    stacked = {k: torch.stack([p[k] for p in param_list])
               for k in param_list[0]}
    if mesh is None:
        return stacked
    i = mesh.coord(axis)
    n = mesh.axis_size(axis)
    enforce_that(len(param_list) % n == 0,
                 f"{len(param_list)} stages do not divide over {axis}={n}",
                 context="pipeline")
    k = len(param_list) // n
    return {name: v[i * k:(i + 1) * k].contiguous()
            for name, v in stacked.items()}


def _index(mbs, m: int):
    if isinstance(mbs, dict):
        return {k: v[m] for k, v in mbs.items()}
    return mbs[m]


class _Schedule:
    """The fill/drain schedule of one rank (stage ``s`` of ``n``)."""

    def __init__(self, mesh, axis: str, m: int):
        self.n = mesh.axis_size(axis)
        self.s = mesh.coord(axis)
        self.ranks = mesh.axis_ranks(axis)
        self.group = mesh.group(axis)
        self.m = m

    def fwd_mb(self, t: int, stage: int) -> Optional[int]:
        mb = t - stage
        return mb if 0 <= mb < self.m else None

    def bwd_mb(self, t: int, stage: int) -> Optional[int]:
        k = t - (self.n - 1 - stage)
        return self.m - 1 - k if 0 <= k < self.m else None

    def exchange(self, send: Optional[torch.Tensor], to: int,
                 recv_like: Optional[torch.Tensor], frm: int
                 ) -> Optional[torch.Tensor]:
        """Post this tick's send (to stage ``to``) and receive (from
        stage ``frm``) together; returns the received tensor."""
        ops = []
        buf = None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  self.ranks[to]))
        if recv_like is not None:
            buf = torch.empty_like(recv_like)
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[frm]))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return buf


def _run_stage(run, leaves, mb: int, x_in, grad: bool):
    """(input, output) of this rank's stage on microbatch ``mb``: the
    output is the last stage's ``last_fn`` value, else the activation."""
    sched: _Schedule = run["sched"]
    stage_p, first_p, last_p = leaves
    stage_fn, first_fn, last_fn = run["fns"]
    s, n = sched.s, sched.n
    with torch.set_grad_enabled(grad):
        feed = _index(run["mbs"], mb)
        if s == 0:
            x = first_fn(first_p, feed) if first_fn is not None else feed
        else:
            x = x_in.detach().requires_grad_(grad)
        y = stage_fn(stage_p, x)
        enforce_that(tuple(y.shape) == tuple(x.shape) and y.dtype == x.dtype,
                     "pipeline stage_fn must be shape-homogeneous: in "
                     f"{tuple(x.shape)}:{x.dtype} vs out {tuple(y.shape)}:"
                     f"{y.dtype}", context="pipeline")
        out = y
        if s == n - 1 and last_fn is not None:
            out = last_fn(last_p, y, feed)
    return x, out


def _bcast_new(t: Optional[torch.Tensor], src: int, group,
               device) -> torch.Tensor:
    """Broadcast a tensor only ``src`` has (its shape and dtype first)."""
    codes = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
    meta = torch.zeros(10, dtype=torch.int64, device=device)
    if t is not None:
        meta[0] = codes.index(t.dtype)
        meta[1] = t.dim()
        meta[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
    comm.broadcast_(meta, src, group)
    if t is None:
        shape = tuple(int(v) for v in meta[2:2 + int(meta[1])].tolist())
        t = torch.empty(shape, dtype=codes[int(meta[0])], device=device)
    return comm.broadcast_(t, src, group)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, *flat):
        sched: _Schedule = run["sched"]
        n_stage, n_first = run["n_stage"], run["n_first"]
        leaves_l = [t.detach().requires_grad_(t.requires_grad)
                    for t in flat]
        leaves = (dict(zip(run["stage_keys"], leaves_l[:n_stage])),
                  dict(zip(run["first_keys"],
                           leaves_l[n_stage:n_stage + n_first])),
                  dict(zip(run["last_keys"], leaves_l[n_stage + n_first:])))
        s, n, remat = sched.s, sched.n, run["remat"]
        acc: Optional[torch.Tensor] = None
        saved: Dict[int, tuple] = {}
        recv = None
        for t in range(sched.m + n - 1):
            mb = sched.fwd_mb(t, s)
            send = None
            if mb is not None:
                x, out = _run_stage(run, leaves, mb, recv, not remat)
                # remat keeps only the stage's input (the feed is at hand)
                saved[mb] = (recv,) if remat else (x, out)
                if s == n - 1:
                    if acc is None:
                        acc = out.new_zeros((sched.m,) + tuple(out.shape))
                    acc[mb] = out.detach()
                else:
                    send = out.detach()
            nxt = sched.fwd_mb(t + 1, s)
            recv = sched.exchange(send, s + 1,
                                  run["x_like"] if (s > 0 and nxt is not None)
                                  else None, s - 1)
        acc = _bcast_new(acc, sched.ranks[n - 1], sched.group,
                         run["x_like"].device) if n > 1 else acc
        ctx.run, ctx.saved, ctx.leaves = run, saved, leaves
        return acc

    @staticmethod
    def backward(ctx, d_acc):
        run, saved, leaves = ctx.run, ctx.saved, ctx.leaves
        sched: _Schedule = run["sched"]
        s, n = sched.s, sched.n
        dy = None
        for t in range(sched.m + n - 1):
            mb = sched.bwd_mb(t, s)
            dx = None
            if mb is not None:
                if run["remat"]:
                    x, out = _run_stage(run, leaves, mb, saved.pop(mb)[0],
                                        True)
                else:
                    x, out = saved.pop(mb)
                with torch.enable_grad():
                    torch.autograd.backward(
                        out, d_acc[mb] if s == n - 1 else dy)
                if s > 0:
                    dx = x.grad
            nxt = sched.bwd_mb(t + 1, s)
            dy = sched.exchange(dx, s - 1,
                                run["x_like"] if (s < n - 1
                                                  and nxt is not None)
                                else None, s + 1)
        grads: List[Optional[torch.Tensor]] = []
        stage_p, first_p, last_p = leaves
        grads.extend(v.grad for v in stage_p.values())
        for tree in (first_p, last_p):
            for v in tree.values():
                # a hook's weights are whole on every stage and used on
                # one: sum their gradients over the axis
                g = torch.zeros_like(v) if v.grad is None else v.grad
                grads.append(comm.all_reduce_(g, sched.group))
        return (None, *grads)


def pipeline_apply(mesh, stage_fn: Callable, stacked_params, microbatches,
                   axis: str = "stage", first_fn: Optional[Callable] = None,
                   first_params=None, last_fn: Optional[Callable] = None,
                   last_params=None, remat: bool = False) -> torch.Tensor:
    """Run M microbatches through the S stages; returns the [M, ...]
    outputs on every rank of the axis.

    ``stacked_params``: this rank's stage, a dict of tensors with leading
    dim 1 (:func:`stack_stage_params`); ``stage_fn(params, x)`` gets them
    without it and must return ``x``'s shape and dtype.
    ``microbatches``: [M, mb, ...], or a dict of such tensors when
    ``first_fn`` digests a structured feed; whole on every rank.
    ``first_params``/``last_params``: dicts of tensors, whole on every
    rank.  ``remat`` recomputes each stage in the backward."""
    sched = _Schedule(mesh, axis, _num_mb(microbatches))
    stage_p = {k: v[0] for k, v in stacked_params.items()}
    first_params = dict(first_params or {})
    last_params = dict(last_params or {})
    # every stage needs the activation's shape for its receive buffers;
    # only stage 0 computes it, so the others make it from microbatch 0
    with torch.no_grad():
        feed0 = _index(microbatches, 0)
        x0 = first_fn(first_params, feed0) if first_fn is not None \
            else feed0
    run = {"sched": sched, "fns": (stage_fn, first_fn, last_fn),
           "mbs": microbatches, "remat": bool(remat),
           "x_like": torch.empty_like(x0),
           "stage_keys": list(stage_p), "first_keys": list(first_params),
           "last_keys": list(last_params), "n_stage": len(stage_p),
           "n_first": len(first_params)}
    flat = list(stage_p.values()) + list(first_params.values()) \
        + list(last_params.values())
    return _Pipeline.apply(run, *flat)


def _num_mb(microbatches) -> int:
    if isinstance(microbatches, dict):
        return int(next(iter(microbatches.values())).shape[0])
    return int(microbatches.shape[0])
