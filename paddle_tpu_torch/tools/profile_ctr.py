"""Where DeepFM's training step's time goes on the card.

Trains ``ctr_workload``'s configuration (DeepFM at Criteo's width: 39
fields over one shared table of 33,763,409 ids, k 10, a 400-400-400
tower, batch 4096, Adam at 1e-3, the bf16 policy): two warm-up steps,
``STEPS`` steps through ``SGD.train`` (the end-to-end step: the
``DataFeeder`` feeds each batch of samples), ``STEPS`` through
``SGD.step`` on device feeds, each ending in the cost's host copy, then
``STEPS`` ``SGD.step`` steps under ``torch.profiler``.  It prints one JSON
line: wall ms a step both ways, examples/s, device busy ms a step (the
CUDA kernels' time), ``idle_share`` = 1 - busy / wall, and device ms and
launches a step in the groups of :func:`group`: the optimizer's update
(Adam over the tables), the lookups' backward (``embedding_dense_backward``
of the 39 lookups, dense [V, k] gradients), the sums of those 39 gradients
(autograd's adds outside the lookups), the tower's matrix products, and
the rest; kernel launches a step, the top kernels, peak memory, and the
card's SM clock read just after the profile.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_ctr
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from paddle_tpu_torch import event
from paddle_tpu_torch.tools import ctr_workload as cw
from paddle_tpu_torch.tools.compare_flash import sm_clock
from paddle_tpu_torch.tools.profiling import (OPTIMIZER_RANGE, breakdown,
                                              ranged_optimizer,
                                              step_wall_ms)

STEPS = 3
GROUPS = ("optimizer", "lookup_backward", "gradient_sums", "matmul",
          "other")


def group(ops) -> str:
    """A kernel's group, from the ops that launched it: the innermost
    first, then its callers (an ``aten`` op, or the optimizer's range)."""
    low = [op.lower() for op in ops]
    if OPTIMIZER_RANGE in low:
        return "optimizer"
    if "aten::embedding_dense_backward" in low:
        return "lookup_backward"
    if low[0] in ("aten::add", "aten::add_"):
        return "gradient_sums"     # autograd's sums of the lookups' grads
    if any("embedding" in op for op in low):
        return "lookup_backward"
    if any(op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul")
           for op in low):
        return "matmul"
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_ctr: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sgd = cw.build_trainer(dev)
    ranged_optimizer(sgd)
    data = cw.CtrData(dev, batches=1)
    feeds = data.feeds(0)
    samples = data.samples(0)
    step_wall_ms(sgd, feeds, 2)                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    costs = []
    sgd.train(cw.repeat_reader(samples, STEPS), event_handler=lambda ev:
              costs.append(ev.cost) if isinstance(ev, event.EndIteration)
              else None)
    train_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    wall = step_wall_ms(sgd, feeds, STEPS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(STEPS):
            sgd.step(feeds)
        torch.cuda.synchronize()
    print(json.dumps({
        "what": "deepfm_train_step", "vocab": cw.VOCAB, "fields": cw.FIELDS,
        "factor": cw.FACTOR, "deep": cw.DEEP, "batch": cw.BATCH,
        "steps": STEPS, "train_ms": train_ms,
        "examples_per_s": cw.BATCH / (wall / 1e3),
        **breakdown(prof, STEPS, wall, group, GROUPS),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
        "sm_clock_after_profile": sm_clock(),
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
