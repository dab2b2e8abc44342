"""Where the recurrent training step's time goes on the card.

Trains the workloads of ``chip_smoke.py`` (``rnn_workload``: bench.py's
IMDB text classifier, dict 30000, embedding 128, batch 64 of 100 tokens,
``Momentum(0.9, 0.01)``) through ``SGD.train``, one JSON line each: the
2 x LSTM h 512 main config, the GRU variant at h 512 (2 layers) and at
h 1280 (1 layer).  Per config: two warm-up steps, then ``STEPS`` steps
unprofiled for the host wall time (each ending in the cost's host copy),
then ``STEPS`` steps under ``torch.profiler`` for the kernels.  It prints
wall ms a step, device busy ms a step (sum of CUDA kernel times of the
profiled steps), ``idle_share`` = 1 - busy / wall, device ms and launches
a step grouped into the four RNN kernels, matrix products and everything
else, kernel launches a step, the top kernels, and the card's SM clock
read just after the profiled steps.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_rnn
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from paddle_tpu_torch.tools import rnn_workload as rw
from paddle_tpu_torch.tools.compare_flash import sm_clock

STEPS = 3
CONFIGS = (("lstm", 512, 2), ("gru", 512, 2), ("gru", 1280, 1))


def _group(name: str) -> str:
    low = name.lower()
    for kernel in ("lstm_step", "gru_step", "gru_zr", "gru_cand"):
        if kernel + "_kernel" in low:
            return kernel
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    return "other"


def _kernels(prof):
    """(name, device us, count) of the CUDA kernels only."""
    from torch.autograd import DeviceType

    return [(e.key, float(e.self_device_time_total), e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _steps(sgd, batch, n: int) -> float:
    """Wall ms of ``n`` steps through ``SGD.train``, ending in the last
    cost's host copy."""
    from paddle_tpu_torch import event

    costs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sgd.train(rw.repeat_reader(batch, n), event_handler=lambda ev:
              costs.append(ev.cost) if isinstance(ev, event.EndIteration)
              else None, feeding=rw.FEEDING)
    return 1e3 * (time.perf_counter() - t0)


def profile(dev, cell: str, hidden: int, layers: int) -> dict:
    sgd = rw.build_trainer(dev, cell, hidden=hidden, num_layers=layers)
    batch = rw.samples(rw.SEED + 1)
    _steps(sgd, batch, 2)                         # warm-up
    wall = _steps(sgd, batch, STEPS) / STEPS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        _steps(sgd, batch, STEPS)
    clock = sm_clock()
    kernels = _kernels(prof)
    busy = sum(us for _, us, _ in kernels) / 1e3 / STEPS
    groups, counts = {}, {}
    for name, us, count in kernels:
        groups[_group(name)] = groups.get(_group(name), 0.0) + \
            us / 1e3 / STEPS
        counts[_group(name)] = counts.get(_group(name), 0) + count / STEPS
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {"cell": cell, "hidden": hidden, "layers": layers,
            "batch": rw.BATCH, "time_steps": rw.STEPS_T, "steps": STEPS,
            "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / wall,
            "device_ms_per_step_by_group": groups,
            "launches_per_step_by_group": counts,
            "sm_clock_after_profile": clock,
            "kernel_launches_per_step": sum(c for _, _, c in kernels) / STEPS,
            "top_kernels": [{"name": n[:90], "ms_per_step": us / 1e3 / STEPS,
                             "count": c} for n, us, c in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_rnn: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for cell, hidden, layers in CONFIGS:
        res = profile(dev, cell, hidden, layers)
        res.update(device=torch.cuda.get_device_name(0), nvidia_smi=card)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
