"""Where the training step's time goes on the card.

Trains the workload of ``chip_smoke.py`` (``train_workload``: the
full-width transformer LM, vocab 32768, d 2048, 8 layers, 16 heads, with
random weights, one batch of 8 x 1024 tokens, ``Momentum(0.9, 1e-3)``)
through ``SGD.train``: two warm-up steps, then ``WALL_REPEATS`` runs of
``STEPS`` steps unprofiled for the host wall time (each ending in the
cost's host copy), then ``STEPS`` steps under ``torch.profiler`` for the
kernels (the profiler's own overhead would swamp the wall time).  It
prints one JSON line: wall ms a step (the median run's, and each run's),
device busy ms a step (sum of CUDA kernel times of the
profiled steps), ``idle_share`` = 1 - busy / wall, device ms a step
grouped into the three flash kernels, matrix products and everything
else, kernel launches a step, and the top kernels.

With ``--moe`` it profiles bench.py's MoE LM instead
(``parallel_workload``: d 1024, 8 layers, 8 experts, top-1, 4 x 1024
tokens, the dense dispatch), then, once the MoE trainer's memory is
freed, its dense twin (``moe_experts=0``) at the same width, as
``chip_smoke.py``'s ``train_moe`` runs them: one line each.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_train [--moe]
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from paddle_tpu_torch.tools import train_workload as tw

STEPS = 3
WALL_REPEATS = 3


def _group(name: str) -> str:
    low = name.lower()
    for kernel in ("flash_fwd", "flash_bwd_kv", "flash_bwd_dq"):
        if kernel + "_" in low:        # the CUDA-core or tensor-core kernel
            return kernel
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul"
    return "other"


def _kernels(prof):
    """(name, device us, count) of the CUDA kernels only — a CPU op's
    self device time repeats its kernels' time."""
    from torch.autograd import DeviceType

    return [(e.key, float(e.self_device_time_total), e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _steps(sgd, samples, n: int) -> float:
    """Wall ms of ``n`` steps through ``SGD.train``, ending in the last
    cost's host copy."""
    from paddle_tpu_torch import event

    costs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sgd.train(tw.repeat_reader(samples, n), event_handler=lambda ev:
              costs.append(ev.cost) if isinstance(ev, event.EndIteration)
              else None, feeding=tw.FEEDING)
    return 1e3 * (time.perf_counter() - t0)


def _profile(sgd, samples, model: str, card: str) -> dict:
    """Warm-up, the unprofiled walls, then ``STEPS`` profiled steps."""
    _steps(sgd, samples, 2)                       # warm-up
    walls = [_steps(sgd, samples, STEPS) / STEPS
             for _ in range(WALL_REPEATS)]
    wall = sorted(walls)[len(walls) // 2]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        _steps(sgd, samples, STEPS)
    kernels = _kernels(prof)
    busy = sum(us for _, us, _ in kernels) / 1e3 / STEPS
    groups = {}
    for name, us, _ in kernels:
        groups[_group(name)] = groups.get(_group(name), 0.0) + \
            us / 1e3 / STEPS
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {
        "model": model, "steps": STEPS, "wall_ms_per_step": wall,
        "wall_ms_per_step_repeats": walls,
        "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / wall,
        "device_ms_per_step_by_group": groups,
        "kernel_launches_per_step": sum(c for _, _, c in kernels) / STEPS,
        "top_kernels": [{"name": n[:90], "ms_per_step": us / 1e3 / STEPS,
                         "count": c} for n, us, c in top],
        "device": torch.cuda.get_device_name(0), "nvidia_smi": card}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if "--moe" in sys.argv[1:]:
        from paddle_tpu_torch.tools import parallel_workload as pw

        samples = pw.moe_samples(tw.SEED + 1)
        runs = [("moe", lambda: pw.moe_trainer(dev)),
                ("moe_dense_twin", lambda: pw.moe_trainer(
                    dev, moe_experts=0))]
    else:
        samples = tw.lm_samples(tw.SEED + 1)
        runs = [("headline", lambda: tw.build_trainer(dev))]
    for model, make in runs:
        sgd = make()
        print(json.dumps(_profile(sgd, samples, model, card)), flush=True)
        del sgd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
