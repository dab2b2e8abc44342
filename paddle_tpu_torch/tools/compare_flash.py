"""Time the bf16 flash forward, dK/dV and dQ kernels against an earlier
commit's, in one process on one card, taking turns.

The earlier kernels come from a ``git archive`` of that commit unpacked
into a directory: its flash sources (``paddle_tpu_torch/csrc/
flash_attention_sm90.cu`` where it has one, and ``flash_attention.cu``)
are built there with this checkout's nvcc flags, and each entry
(``flash_fwd``, ``flash_bwd_kv``, ``flash_bwd_dq``, one signature in every
version) is called in the first of them that exports it, as that
commit's bf16 wrappers did.  This checkout's kernels run through their
wrappers.  Both run the training case (``train_workload`` case a: q/k/v
[1, 8192, 16, 128] bf16, 8 causal segments of 1024) on the same inputs;
each is first held against the plain version
(``train_workload.flash_error``), then timed in rounds of earlier, this,
this, earlier.  A time is card time: the CUDA kernels of ``REPS`` calls
under ``torch.profiler``, over ``REPS`` (the wrapper's small range ops
included, for both); each time carries the timer that took it
(:func:`card_ms`).  It prints one JSON line per kernel and round and a
summary line.

Run from the repository root on a machine with one GPU::

    mkdir -p chip_scratch/parent
    git archive <commit> | tar -x -C chip_scratch/parent
    python -m paddle_tpu_torch.tools.compare_flash chip_scratch/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.tools import train_workload as tw

CASE = "a_bf16_8x1024_causal"
REPS = 20
ROUNDS = 2
ENTRIES = ("flash_fwd", "flash_bwd_kv", "flash_bwd_dq")
# an earlier tree's bf16 route: the wgmma source first, where it exists
EARLIER_SOURCES = ("flash_attention_sm90", "flash_attention")
PROFILER_TRIES = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_ms(fn: Callable[[], object], reps: int = REPS,
            only: str = "") -> Tuple[float, str]:
    """Card time of one call and the timer that took it.  ``"profiler"``:
    the CUDA kernels (those whose name holds ``only``) of ``reps`` calls
    under ``torch.profiler``, over ``reps``.  Where the trace caught no
    kernel ``PROFILER_TRIES`` times (it happens now and then on the card's
    machine), ``"events"``: the calls back to back between two CUDA
    events, over ``reps``, which for a kernel shorter than its wrapper's
    host work times the host instead."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and only in e.key)
        if total > 0.0:
            return total / 1e3 / reps, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "events"


def summary(times: Dict[str, Dict[str, list]]) -> dict:
    """{name: {version: median, every time, and the timers that took
    them}} from {name: {version: [(ms, timer), ...]}}."""
    return {name: {v: {"median_ms": float(np.median([ms for ms, _ in t])),
                       "all_ms": [ms for ms, _ in t],
                       "timers": sorted({timer for _, timer in t})}
                   for v, t in versions.items()}
            for name, versions in times.items()}


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build_earlier(tree: Path, names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """``paddle_tpu_torch/csrc/<name>.cu`` of an unpacked earlier tree,
    each that exists, built with this checkout's flags (one nvcc each, in
    parallel) and loaded, by name."""
    jobs = {}
    for name in names:
        src = tree / "paddle_tpu_torch" / "csrc" / f"{name}.cu"
        if src.exists():
            out = tree / f"lib{name}_earlier.so"
            jobs[name] = (out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for name, (out, job) in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on the earlier {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def earlier_entries(tree: Path) -> Dict[str, object]:
    """Each flash entry of the earlier tree, from the first of
    ``EARLIER_SOURCES`` that exports it, with its signature set."""
    libs = build_earlier(tree, EARLIER_SOURCES)
    entries = {}
    for sym in ENTRIES:
        lib = next(libs[n] for n in EARLIER_SOURCES
                   if n in libs and hasattr(libs[n], sym))
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = A._SIGNATURES[sym]
        entries[sym] = fn
    return entries


def earlier_calls(entries, case, cfg):
    """The earlier wrappers' work: ranges, outputs, one launch."""
    q, k = case.q, case.k
    geo = A._geometry(q, k, cfg["causal"], False, cfg["sm_scale"])

    def fwd():
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=torch.float32, device=q.device)
        qr, kr = A._tile_ranges(case.q_seg), A._tile_ranges(case.kv_seg)
        rc = entries["flash_fwd"](q.data_ptr(), k.data_ptr(), case.v.data_ptr(),
                           qr.data_ptr(), kr.data_ptr(),
                           case.q_seg.data_ptr(), case.kv_seg.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), *geo)
        assert rc == 0, rc
        return out, lse

    def bwd_kv(lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(case.v)
        qr, kr = A._tile_ranges(case.q_seg), A._tile_ranges(case.kv_seg)
        rc = entries["flash_bwd_kv"](
            q.data_ptr(), k.data_ptr(), case.v.data_ptr(),
            case.dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            qr.data_ptr(), kr.data_ptr(), case.q_seg.data_ptr(),
            case.kv_seg.data_ptr(), dk.data_ptr(), dv.data_ptr(), *geo)
        assert rc == 0, rc
        return dk, dv

    def bwd_dq(lse, delta):
        dq = torch.empty_like(q)
        qr, kr = A._tile_ranges(case.q_seg), A._tile_ranges(case.kv_seg)
        rc = entries["flash_bwd_dq"](
            q.data_ptr(), k.data_ptr(), case.v.data_ptr(),
            case.dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            qr.data_ptr(), kr.data_ptr(), case.q_seg.data_ptr(),
            case.kv_seg.data_ptr(), dq.data_ptr(), *geo)
        assert rc == 0, rc
        return (dq,)

    return fwd, bwd_kv, bwd_dq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path,
                    help="unpacked git archive of the earlier commit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_flash: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    entries = earlier_entries(args.tree)
    case = tw.flash_case(CASE, "cuda")
    cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
    fwd_args = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
    o_ref, lse_ref = A.flash_fwd_reference(*fwd_args, **cfg)
    delta = A.attention_delta(o_ref, case.dout)
    bwd_args = fwd_args + (case.dout, lse_ref, delta)
    dk_ref, dv_ref = A.flash_bwd_kv_reference(*bwd_args, **cfg)
    dq_ref = A.flash_bwd_dq_reference(*bwd_args, **cfg)
    old_fwd, old_bwd, old_dq = earlier_calls(entries, case, cfg)
    calls = {
        "flash_fwd": {"earlier": old_fwd,
                      "this": lambda: A.flash_fwd_kernel(*fwd_args, **cfg)},
        "flash_bwd_kv": {
            "earlier": lambda: old_bwd(lse_ref, delta),
            "this": lambda: A.flash_bwd_kv_kernel(*bwd_args, **cfg)},
        "flash_bwd_dq": {
            "earlier": lambda: old_dq(lse_ref, delta),
            "this": lambda: (A.flash_bwd_dq_kernel(*bwd_args, **cfg),)},
    }
    wants = {"flash_fwd": (o_ref, lse_ref), "flash_bwd_kv": (dk_ref, dv_ref),
             "flash_bwd_dq": (dq_ref,)}
    for kname, versions in calls.items():
        for version, fn in versions.items():
            got = fn()
            torch.cuda.synchronize()
            errs = [tw.flash_error(g, w) for g, w in zip(got, wants[kname])]
            if not all(e["within_tolerance"] for e in errs):
                raise AssertionError(f"{version} {kname} outside tolerance: "
                                     f"{errs}")
    times = {k: {"earlier": [], "this": []} for k in calls}
    for rnd in range(ROUNDS):
        for version in ("earlier", "this", "this", "earlier"):
            for kname, versions in calls.items():
                ms, timer = card_ms(versions[version])
                times[kname][version].append((ms, timer))
                emit({"round": rnd, "kernel": kname, "version": version,
                      "ms": ms, "timer": timer})
    emit({"card": card, "case": CASE, "reps": REPS,
          "earlier": str(args.tree), **summary(times)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
