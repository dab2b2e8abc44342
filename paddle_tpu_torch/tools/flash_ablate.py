"""Where the card time of the wgmma flash kernels goes.

Builds variants of ``csrc/flash_attention_sm90.cu`` that each leave out
one part of the work and times them on the training case (``train_workload``
case a: q/k/v [1, 8192, 16, 128] bf16, 8 causal segments of 1024) beside
the source as built, in turns, in one process on one card:

- ``as_built``: the source unchanged;
- ``no_products``: the consumers wait for and release every tile but
  compute nothing: the copy pipeline and each block's fixed costs;
- ``k_only``: the forward copies K tiles only, half the bytes a tile:
  whether bytes bound the pipeline;
- ``no_tile_loop``: each block copies its Q (forward) or K and V (dK/dV)
  tiles and writes its outputs, and visits no tile: a block's fixed cost.

Each variant is a text substitution on the source, and a substitution
whose anchor is missing raises, so the variants follow the source or
fail.  The variants' outputs are wrong by design; only their times are
read: card time of the flash kernels of ``REPS`` calls under
``torch.profiler``, over ``REPS``.  It prints one JSON line per variant and
round, and a summary with the card's name and power limit.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.flash_ablate
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.tools import train_workload as tw

CASE = "a_bf16_8x1024_causal"
REPS = 20
ROUNDS = 2

# variant: [(anchor, replacement)], each anchor found exactly once
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "as_built": [],
    "no_products": [
        ("      if (!((masks.mine >> j) & 1)) {", "      if (true) {"),
        ("      if ((masks.mine >> j) & 1) {", "      if (false) {"),
    ],
    "k_only": [
        ("        mbar_expect_tx(full, 2 * TB);",
         "        mbar_expect_tx(full, TB);"),
        ("          tma_box(k_tile + TB + c * BOX_BYTES, &tm_v,",
         "          if (kt < 0) tma_box(k_tile + TB + c * BOX_BYTES, &tm_v,"),
    ],
    "no_tile_loop": [
        ("  const int kt_end = causal ? min(nkt, qt0 + nact) : nkt;",
         "  const int kt_end = 0;"),
        ("  const int qt_begin = causal ? kt0 : 0;",
         "  const int qt_begin = nqt;"),
    ],
}


def variant_source(name: str, source: str) -> str:
    """``source`` with the variant's substitutions applied."""
    for anchor, replacement in VARIANTS[name]:
        count = source.count(anchor)
        if count != 1:
            raise ValueError(f"{name}: anchor found {count} times: {anchor}")
        source = source.replace(anchor, replacement)
    return source


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
               if e.device_type == DeviceType.CUDA and "flash" in e.key
               ) / 1e3 / reps


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Every variant compiled (one nvcc each, in parallel) under the
    package's build directory and loaded."""
    source = (build.CSRC_DIR / "flash_attention_sm90.cu").read_text()
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in VARIANTS:
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(name, source))
        jobs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for sym, (argtypes, restype) in A._SM90_SIGNATURES.items():
            getattr(lib, sym).argtypes = list(argtypes)
            getattr(lib, sym).restype = restype
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_variants()
    case = tw.flash_case(CASE, "cuda")
    cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
    fwd_args = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
    o, lse = A.flash_fwd_reference(*fwd_args, **cfg)
    bwd_args = fwd_args + (case.dout, lse, A.attention_delta(o, case.dout))
    route = A._library
    times = {name: {"flash_fwd": [], "flash_bwd_kv": []} for name in libs}
    try:
        for rnd in range(ROUNDS):
            for name, lib in libs.items():
                A._library = lambda q, pv_f32, _lib=lib: _lib
                fwd = card_ms(lambda: A.flash_fwd_kernel(*fwd_args, **cfg))
                bwd = card_ms(lambda: A.flash_bwd_kv_kernel(*bwd_args,
                                                           **cfg))
                times[name]["flash_fwd"].append(fwd)
                times[name]["flash_bwd_kv"].append(bwd)
                emit({"round": rnd, "variant": name, "flash_fwd_ms": fwd,
                      "flash_bwd_kv_ms": bwd})
    finally:
        A._library = route
    emit({"card": card, "case": CASE, "reps": REPS, **{
        name: {k: float(np.median(v)) for k, v in t.items()}
        for name, t in times.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
