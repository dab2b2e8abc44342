"""Time the bf16 flash forward and dK/dV kernels against an earlier
commit's, in one process on one card, taking turns.

The earlier kernels come from a ``git archive`` of that commit unpacked
into a directory: its ``paddle_tpu_torch/csrc/flash_attention.cu`` is
built there with this checkout's nvcc flags and called through the C
entries ``flash_fwd`` and ``flash_bwd_kv``, which every version exports
with one signature.  This checkout's kernels run through their wrappers.
Both run the training case (``train_workload`` case a: q/k/v [1, 8192,
16, 128] bf16, 8 causal segments of 1024) on the same inputs; each is
first held against the plain version (``train_workload.flash_error``),
then timed in rounds of earlier, this, this, earlier.  A time is card
time: the CUDA kernels of ``REPS`` calls under ``torch.profiler``, over
``REPS`` (the wrapper's small range ops included, for both).  It prints
one JSON line per kernel and round and a summary line.

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

import numpy as np
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.tools import train_workload as tw

CASE = "a_bf16_8x1024_causal"
REPS = 20
ROUNDS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_ms(fn, reps: int = REPS) -> float:
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def earlier_library(tree: Path) -> ctypes.CDLL:
    src = tree / "paddle_tpu_torch" / "csrc" / "flash_attention.cu"
    out = tree / "libflash_attention_earlier.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for sym in ("flash_fwd", "flash_bwd_kv"):
        argtypes, restype = A._SIGNATURES[sym]
        getattr(lib, sym).argtypes = list(argtypes)
        getattr(lib, sym).restype = restype
    return lib


def earlier_calls(lib, case, cfg):
    """The earlier wrappers' work: ranges, outputs, one launch."""
    q, k = case.q, case.k
    geo = A._geometry(q, k, cfg["causal"], False, cfg["sm_scale"])

    def fwd():
        out = torch.empty_like(q)
        lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                          dtype=torch.float32, device=q.device)
        qr, kr = A._tile_ranges(case.q_seg), A._tile_ranges(case.kv_seg)
        rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), case.v.data_ptr(),
                           qr.data_ptr(), kr.data_ptr(),
                           case.q_seg.data_ptr(), case.kv_seg.data_ptr(),
                           out.data_ptr(), lse.data_ptr(), *geo)
        assert rc == 0, rc
        return out, lse

    def bwd_kv(lse, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(case.v)
        qr, kr = A._tile_ranges(case.q_seg), A._tile_ranges(case.kv_seg)
        rc = lib.flash_bwd_kv(q.data_ptr(), k.data_ptr(), case.v.data_ptr(),
                              case.dout.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), qr.data_ptr(), kr.data_ptr(),
                              case.q_seg.data_ptr(), case.kv_seg.data_ptr(),
                              dk.data_ptr(), dv.data_ptr(), *geo)
        assert rc == 0, rc
        return dk, dv

    return fwd, bwd_kv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path,
                    help="unpacked git archive of the earlier commit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_flash: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    lib = earlier_library(args.tree)
    case = tw.flash_case(CASE, "cuda")
    cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
    fwd_args = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
    o_ref, lse_ref = A.flash_fwd_reference(*fwd_args, **cfg)
    delta = A.attention_delta(o_ref, case.dout)
    bwd_args = fwd_args + (case.dout, lse_ref, delta)
    dk_ref, dv_ref = A.flash_bwd_kv_reference(*bwd_args, **cfg)
    old_fwd, old_bwd = earlier_calls(lib, case, cfg)
    calls = {
        "flash_fwd": {"earlier": old_fwd,
                      "this": lambda: A.flash_fwd_kernel(*fwd_args, **cfg)},
        "flash_bwd_kv": {
            "earlier": lambda: old_bwd(lse_ref, delta),
            "this": lambda: A.flash_bwd_kv_kernel(*bwd_args, **cfg)},
    }
    wants = {"flash_fwd": (o_ref, lse_ref), "flash_bwd_kv": (dk_ref, dv_ref)}
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
                ms = card_ms(versions[version])
                times[kname][version].append(ms)
                emit({"round": rnd, "kernel": kname, "version": version,
                      "ms": ms})
    emit({"card": card, "case": CASE, "reps": REPS,
          "earlier": str(args.tree), **{
              kname: {v: {"median_ms": float(np.median(t)), "all_ms": t}
                      for v, t in versions.items()}
              for kname, versions in times.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
