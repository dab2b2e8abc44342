"""Where a training step's card time goes: the helpers the profiling
tools and ``chip_smoke.py`` share.

:func:`ranged_optimizer` puts a trainer's optimizer update inside a
profiler range (:data:`OPTIMIZER_RANGE`), :func:`step_wall_ms` times
``SGD.step`` on the host clock, and :func:`breakdown` splits a
``torch.profiler`` profile of training steps into a model's groups of
kernels, each kernel's group read from the ops that launched it.
"""

from __future__ import annotations

import time

import torch

from paddle_tpu_torch.tools.profile_image import _kernels

OPTIMIZER_RANGE = "optimizer_update"
TOP_KERNELS = 12


def launched(prof):
    """(device us, the launching op and its callers' names) of every
    kernel the profiler ties to the CPU op that launched it."""
    from torch.autograd import DeviceType

    def chain(e):
        while e is not None:
            yield e.name
            e = e.cpu_parent

    return [(float(k.duration), list(chain(e))) for e in prof.events()
            if e.device_type == DeviceType.CPU for k in e.kernels]


def ranged_optimizer(sgd) -> None:
    """Run ``sgd``'s optimizer update inside a profiler range."""
    apply = sgd.optimizer.apply

    def ranged(*a, **k):
        with torch.profiler.record_function(OPTIMIZER_RANGE):
            return apply(*a, **k)

    sgd.optimizer.apply = ranged


def step_wall_ms(sgd, feeds, steps: int) -> float:
    """Mean wall ms of ``steps`` ``SGD.step`` s, the last cost on the
    host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        cost = sgd.step(feeds)
    float(cost)
    return 1e3 * (time.perf_counter() - t0) / steps


def breakdown(prof, steps: int, wall_ms: float, group_of, groups) -> dict:
    """Busy ms, idle share, and card ms and launches a step by group
    (``group_of`` maps a kernel's ops, innermost first, to one of
    ``groups``) of a profile of ``steps`` steps against a step's
    ``wall_ms``; launches a step and the top kernels."""
    # the optimizer's range is listed beside the kernels with the device
    # time it spans: left out, as it is no kernel
    kernels = [k for k in _kernels(prof) if k[0] != OPTIMIZER_RANGE]
    busy = sum(us for _, us, _ in kernels) / 1e3 / steps
    ms = dict.fromkeys(groups, 0.0)
    launches = dict.fromkeys(groups, 0.0)
    for us, ops in launched(prof):
        g = group_of(ops)
        ms[g] += us / 1e3 / steps
        launches[g] += 1 / steps
    top = sorted(kernels, key=lambda k: -k[1])[:TOP_KERNELS]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_group": ms, "launches_by_group": launches,
            "kernel_launches": sum(c for _, _, c in kernels) / steps,
            "top_kernels": [{"name": n[:100], "ms": us / 1e3 / steps,
                             "count": c / steps} for n, us, c in top]}
