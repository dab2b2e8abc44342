"""Where the serving step's time goes on the card.

Serves the workload of ``chip_smoke.py`` (``serve_workload``: the
full-width DecoderLM with random weights, the engine at the flag
defaults with a 129-page f32 pool, eight requests of 96-896 prompt
tokens, one of them sharing a 512-token prefix served from the prefix
cache, 32 new tokens each) after the same warm-up, in two windows: from
submission until every prefill is done (steps that carry prefill chunks)
and the decode-only rest.  The workload runs twice on fresh engines:
unprofiled for the host wall time of each window (ending in a
synchronize), then under ``torch.profiler`` for the kernels (the
profiler's own overhead would swamp the wall time).  Both passes run the
same deterministic steps.  For each window it prints one JSON line: wall
time, device busy time (sum of CUDA kernel times of the profiled pass),
``idle_share`` = 1 - busy / wall of the unprofiled pass, and device time
grouped into the ragged attention kernel, matrix products and everything
else, plus the top kernels.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.profile_serve
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch

from paddle_tpu_torch.tools.serve_workload import (Workload, build_model,
                                                   make_engine, warm_up)


def _group(name: str) -> str:
    low = name.lower()
    if "ragged_attention" in low or "ragged_paged_attention" in low:
        return "ragged_attention"
    if "gemm" in low or "gemv" in low or "cutlass" in low:
        return "matmul"
    return "other"


def _kernels(prof):
    """(name, device us, count) of the CUDA kernels only — a CPU op's
    self device time repeats its kernels' time."""
    from torch.autograd import DeviceType

    return [(e.key, float(e.self_device_time_total), e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _serve(eng, profile: bool):
    """The workload in two windows (until every prefill is done, then
    the decode-only rest).  Returns per window the host wall time (ending
    in a synchronize) and, when profiling, the kernels."""
    wl = Workload(eng)
    out = []
    for label, until in (("prefill_carrying", lambda: wl.prefill_done),
                         ("decode_only", lambda: wl.done)):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        steps = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts, acc_events=True) \
                if profile else contextlib.nullcontext() as prof:
            while not until():
                wl.step()
                steps += 1
            torch.cuda.synchronize()
        out.append({"window": label, "steps": steps,
                    "wall_ms": 1e3 * (time.perf_counter() - t0),
                    "kernels": _kernels(prof) if profile else None})
    eng.check_page_conservation()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serve: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = build_model(dev)
    warm_up(model, dev)
    timed = _serve(make_engine(model, dev), profile=False)
    profiled = _serve(make_engine(model, dev), profile=True)
    for t, p in zip(timed, profiled):
        busy = sum(us for _, us, _ in p["kernels"]) / 1e3
        groups = {}
        for name, us, _ in p["kernels"]:
            groups[_group(name)] = groups.get(_group(name), 0.0) + us / 1e3
        top = sorted(p["kernels"], key=lambda k: -k[1])[:8]
        print(json.dumps({
            "window": t["window"], "steps": t["steps"],
            "profiled_steps": p["steps"], "wall_ms": t["wall_ms"],
            "device_busy_ms": busy,
            "idle_share": 1.0 - busy / t["wall_ms"],
            "device_ms_by_group": groups,
            "top_kernels": [{"name": n[:90], "ms": us / 1e3, "count": c}
                            for n, us, c in top]}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
