"""Where the card time of the wgmma flash kernels goes.

Builds variants of ``csrc/flash_attention_sm90.cu`` that each leave out
or change one part of the work and times them on the training case
(``train_workload`` case a: q/k/v [1, 8192, 16, 128] bf16, 8 causal
segments of 1024) beside the source as built, in turns, in one process
on one card:

- ``as_built``: the source unchanged;
- ``no_products``: the consumers of all three kernels wait for and
  release every tile but compute nothing: the copy pipeline and each
  block's fixed costs;
- ``k_only``: the forward and dQ copy K tiles only, half the bytes a
  tile: whether bytes bound the pipeline;
- ``no_tile_loop``: each block copies its resident tiles (Q in the
  forward; K and V in dK/dV; Q, dO, lse and delta in dQ) and writes its
  outputs, and visits no tile: a block's fixed cost;
- ``dq_3_stages``: dQ's ring holds 3 K/V tile pairs instead of 4.

Each variant is a text substitution on the source
(:func:`variant_source`, which ``compare_rnn`` uses for B5's variants
too), and a substitution whose anchor is not found exactly the given
number of times raises, so the variants follow the source or fail.  The
first four variants' outputs are wrong by design; only their times are
read: card time of the flash kernels of ``REPS`` calls
(``compare_flash.card_ms``, which names its timer).  It prints one JSON
line per variant and round, and a summary with the card's name and power
limit.

Run from the repository root on a machine with one GPU::

    python -m paddle_tpu_torch.tools.flash_ablate
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.tools import train_workload as tw
from paddle_tpu_torch.tools.compare_flash import (card_ms, card_name, emit,
                                                  summary)

CASE = "a_bf16_8x1024_causal"
REPS = 20
ROUNDS = 2

# variant: [(anchor, replacement, times the anchor occurs)]
Variants = Dict[str, List[Tuple[str, str, int]]]
VARIANTS: Variants = {
    "as_built": [],
    "no_products": [
        # forward and dQ consumers, then dK/dV's
        ("      if (!((masks.mine >> j) & 1)) {", "      if (true) {", 2),
        ("      if ((masks.mine >> j) & 1) {", "      if (false) {", 1),
    ],
    "k_only": [
        ("      mbar_expect_tx(full, 2 * TB);",
         "      mbar_expect_tx(full, TB);", 1),
        ("        tma_box(k_tile + TB + c * BOX_BYTES, tm_v,",
         "        if (kt < 0) tma_box(k_tile + TB + c * BOX_BYTES, tm_v,", 1),
    ],
    "no_tile_loop": [
        ("  const int kt_end = causal ? min(nkt, qt0 + nact) : nkt;",
         "  const int kt_end = 0;", 2),
        ("  const int qt_begin = causal ? kt0 : 0;",
         "  const int qt_begin = nqt;", 1),
    ],
    "dq_3_stages": [
        ("constexpr int DQ_STAGES = 4;", "constexpr int DQ_STAGES = 3;", 1),
    ],
}
KERNELS = ("flash_fwd", "flash_bwd_kv", "flash_bwd_dq")


def variant_source(name: str, source: str,
                   variants: Variants = VARIANTS) -> str:
    """``source`` with the substitutions of ``variants[name]`` applied;
    raises where an anchor is not found the given number of times."""
    for anchor, replacement, times in variants[name]:
        count = source.count(anchor)
        if count != times:
            raise ValueError(f"{name}: anchor found {count} times, not "
                             f"{times}: {anchor}")
        source = source.replace(anchor, replacement)
    return source


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
        for sym, (argtypes, restype) in A._SIGNATURES.items():
            getattr(lib, sym).argtypes = list(argtypes)
            getattr(lib, sym).restype = restype
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablate: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    libs = build_variants()
    case = tw.flash_case(CASE, "cuda")
    cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
    fwd_args = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
    o, lse = A.flash_fwd_reference(*fwd_args, **cfg)
    bwd_args = fwd_args + (case.dout, lse, A.attention_delta(o, case.dout))
    calls = {"flash_fwd": lambda: A.flash_fwd_kernel(*fwd_args, **cfg),
             "flash_bwd_kv": lambda: A.flash_bwd_kv_kernel(*bwd_args, **cfg),
             "flash_bwd_dq": lambda: A.flash_bwd_dq_kernel(*bwd_args, **cfg)}
    route = A._library
    times = {name: {k: [] for k in KERNELS} for name in libs}
    try:
        for rnd in range(ROUNDS):
            for name, lib in libs.items():
                A._library = lambda q, pv_f32, _lib=lib: _lib
                line = {"round": rnd, "variant": name}
                for kname in KERNELS:
                    ms, timer = card_ms(calls[kname], REPS, only="flash")
                    times[name][kname].append((ms, timer))
                    line[f"{kname}_ms"] = ms
                    line[f"{kname}_timer"] = timer
                emit(line)
    finally:
        A._library = route
    emit({"card": card, "case": CASE, "reps": REPS, **summary(times)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
