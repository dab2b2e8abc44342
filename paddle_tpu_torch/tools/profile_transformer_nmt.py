"""Where the Transformer-base translation step's time goes on the card.

Trains ``transformer_nmt_workload``'s configuration (``build_seq2seq`` at
the base model's widths: 6 + 6 blocks, d_model 512, 8 heads, dictionaries
of 30000; batch 80 of lengths 10-80, Adam as in the paper) on one batch:
two warm-up steps, ``STEPS`` steps through ``SGD.train`` (the DataFeeder
feeds the batch each step), ``STEPS`` through ``SGD.step`` on feeds made
once, each ending in the cost's host copy, then ``STEPS`` ``SGD.step``
steps under ``torch.profiler``.  One JSON line: wall ms, device busy ms
(the sum of CUDA kernel times), ``idle_share`` = 1 - busy / wall, device
ms and launches a step grouped by the op that launched each kernel
(:data:`GROUPS`: the flash kernels B1-B3, matrix products, layer norm,
the embeddings' lookups and their backward, the optimizer's update, and
the elementwise rest; ``untied`` is the busy time of kernels the trace
ties to no op), kernel launches, the top kernels, peak memory and the
card's SM clock read just after the profile.  ``chip_smoke.py``
profiles one step of its own run through :func:`profile_steps`.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_transformer_nmt
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from paddle_tpu_torch import event
from paddle_tpu_torch.tools import transformer_nmt_workload as tnw
from paddle_tpu_torch.tools.compare_flash import sm_clock
from paddle_tpu_torch.tools.profiling import (OPTIMIZER_RANGE,
                                              ranged_optimizer,
                                              step_wall_ms)
from paddle_tpu_torch.tools.profile_image import _kernels

STEPS = 3
GROUPS = ("flash", "matmul", "layer_norm", "embedding", "optimizer",
          "elementwise")
_MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
               "aten::_scaled_mm")


def group(kernel: str, ops) -> str:
    """A kernel's group, from its name and the ops that launched it (the
    innermost first, then its callers)."""
    low = [op.lower() for op in ops]
    if "flash_" in kernel:
        return "flash"
    if OPTIMIZER_RANGE in low:
        return "optimizer"
    if any("embedding" in op for op in low):
        return "embedding"
    if any("layer_norm" in op for op in low):
        return "layer_norm"
    if any(op in _MATMUL_OPS for op in low):
        return "matmul"
    return "elementwise"


def _launched(prof):
    """(kernel name, device us, the launching op and its callers' names)
    of every kernel the profiler ties to the CPU op that launched it."""
    from torch.autograd import DeviceType

    def chain(e):
        while e is not None:
            yield e.name
            e = e.cpu_parent

    return [(k.name, float(k.duration), list(chain(e)))
            for e in prof.events()
            if e.device_type == DeviceType.CPU for k in e.kernels]


def profile_steps(sgd, feeds, steps: int, wall_ms: float) -> dict:
    """``steps`` ``SGD.step`` s on ``feeds`` under ``torch.profiler``
    (the optimizer's update in a range); a step's busy ms, idle share
    against ``wall_ms``, device ms and launches by group, launches and
    the top kernels."""
    ranged_optimizer(sgd)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(steps):
            sgd.step(feeds)
        torch.cuda.synchronize()
    # the optimizer's range is listed beside the kernels: it is no kernel
    kernels = [k for k in _kernels(prof) if k[0] != OPTIMIZER_RANGE]
    busy = sum(us for _, us, _ in kernels) / 1e3 / steps
    ms = dict.fromkeys(GROUPS, 0.0)
    launches = dict.fromkeys(GROUPS, 0.0)
    for name, us, ops in _launched(prof):
        g = group(name, ops)
        ms[g] += us / 1e3 / steps
        launches[g] += 1 / steps
    ms["untied"] = busy - sum(ms.values())
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_group": ms, "launches_by_group": launches,
            "kernel_launches": sum(c for _, _, c in kernels) / steps,
            "top_kernels": [{"name": n[:100], "ms": us / 1e3 / steps,
                             "count": c / steps} for n, us, c in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_transformer_nmt: needs a CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sgd = tnw.build_trainer(dev)
    batch = tnw.samples(tnw.SEED + 1)
    feeds = tnw.feeds(sgd, batch)
    step_wall_ms(sgd, feeds, 2)                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    costs = []
    sgd.train(tnw.repeat_reader(batch, STEPS), feeding=tnw.FEEDING,
              event_handler=lambda ev: costs.append(ev.cost)
              if isinstance(ev, event.EndIteration) else None)
    float(costs[-1])
    train_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    wall = step_wall_ms(sgd, feeds, STEPS)
    res = profile_steps(sgd, feeds, STEPS, wall)
    print(json.dumps({
        "what": "transformer_nmt_train_step", "model": tnw.MODEL,
        "batch": tnw.BATCH, "source_tokens": tnw.source_tokens(batch),
        "target_tokens": tnw.target_tokens(batch), "steps": STEPS,
        "train_ms": train_ms,
        "target_tokens_per_s": tnw.target_tokens(batch) / (wall / 1e3),
        **res, "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "sm_clock_after_profile": sm_clock(),
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
