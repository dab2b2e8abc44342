"""torch version shims shared by the parallel modules (the port of
``paddle_tpu/parallel/compat.py``, which holds JAX's).

The collectives the port calls exist under two names across the torch
releases it runs on: 2.13 renames ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` to ``all_gather_single`` and
``reduce_scatter_single`` (the old names warn as deprecated), 2.11 has
only the old ones.  Each shim resolves the name once, at its first call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_single", "reduce_scatter_single"]


def _first(*names):
    for n in names:
        fn = getattr(dist, n, None)
        if fn is not None:
            return fn
    raise AttributeError(f"torch.distributed has none of {names}")


def all_gather_single(out: torch.Tensor, inp: torch.Tensor,
                      group=None) -> None:
    """``out`` [n * k, ...] = every rank's ``inp`` [k, ...] in group-rank
    order."""
    _first("all_gather_single", "all_gather_into_tensor")(out, inp,
                                                          group=group)


def reduce_scatter_single(out: torch.Tensor, inp: torch.Tensor,
                          group=None) -> None:
    """``out`` [k, ...] = this rank's chunk of the sum over ranks of
    ``inp`` [n * k, ...]."""
    _first("reduce_scatter_single", "reduce_scatter_tensor")(
        out, inp, op=dist.ReduceOp.SUM, group=group)
