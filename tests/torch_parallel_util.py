"""Shared by the parallel test files: one launch of the port's ranks a
file (``paddle_tpu_torch.platform.virtual.start_ranks`` over
:mod:`torch_parallel_ranks`), and the f32 policy in both packages."""

import contextlib
import os

import numpy as np

from paddle_tpu.platform.flags import FLAGS as JFLAGS
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.platform.virtual import start_ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = 4


def launch(calls, world: int = WORLD, timeout: float = 240.0):
    """Start ``torch_parallel_ranks.run_all(calls)`` in ``world`` gloo
    ranks; ``.wait()`` on the result returns the per-rank result dicts,
    rank 0 first.  A module fixture starts it so the JAX side computes
    while the ranks run."""
    return start_ranks("torch_parallel_ranks:run_all", world,
                       {"calls": calls}, timeout=timeout, paths=[TESTS])


@contextlib.contextmanager
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def cat(results, key, n, axis=0):
    """Concatenate ranks 0..n-1's ``key`` along ``axis``."""
    return np.concatenate([results[r][key] for r in range(n)], axis=axis)
