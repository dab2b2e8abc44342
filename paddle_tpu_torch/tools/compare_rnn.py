"""Time the fused LSTM step (B5) against an earlier commit's, in one
process on one card, taking turns, with cuDNN's LSTM beside them.

The earlier kernel comes from a ``git archive`` of that commit unpacked
into a directory: its ``paddle_tpu_torch/csrc/rnn_cells.cu`` is built
there with this checkout's nvcc flags and called through the C entry
``rnn_lstm_step``, which every version exports with one signature.  This
checkout's kernel runs through its wrapper.  Both run ``rnn_workload``'s
LSTM cases at B 64 with H 512 and H 1280, f32, acts saved and not, on the
same inputs; each is first held against the plain version
(``rnn_workload.rnn_error``), then timed in rounds of earlier, this,
this, earlier.  A time is card time (``compare_flash.card_ms``: the CUDA
kernels of ``REPS`` calls under ``torch.profiler``, over ``REPS``) and
carries the timer that took it.  The library yardstick, timed once a round, is cuDNN's ``torch.nn.LSTM``
forward (input size H, TF32 off) over [64, 128, H] divided by 128 steps;
the port never calls it.  It prints one JSON line per case, version and
round and a summary line.

``--variant NAME`` times, in the earlier version's place and under the
name ``variant``, a variant of this checkout's own ``rnn_cells.cu`` that
leaves out one part of B5's work (``flash_ablate.variant_source``: a text
substitution whose anchor must occur the given number of times); its
outputs are wrong by design and are not checked:

- ``no_copies``: the ring is never filled; the products run on whatever
  shared memory holds: the products, barriers and epilogue alone;
- ``no_products``: the ring is filled and waited for but nothing is
  summed: the copy pipeline, barriers and epilogue alone;
- ``no_w_copies`` and ``no_h_copies``: one of the two copy streams left
  out (W's 8-byte pieces, or h's 16-byte words).

Run from the repository root on a machine with one GPU::

    mkdir -p chip_scratch/parent
    git archive <commit> | tar -x -C chip_scratch/parent
    python -m paddle_tpu_torch.tools.compare_rnn chip_scratch/parent
    python -m paddle_tpu_torch.tools.compare_rnn --variant no_copies
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
import numpy as np
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.tools import rnn_workload as rw
from paddle_tpu_torch.tools.compare_flash import (build_earlier, card_ms,
                                                  card_name, emit, summary)
from paddle_tpu_torch.tools.flash_ablate import Variants, variant_source

CASES = ("lstm_f32_h512_acts", "lstm_f32_h512", "lstm_f32_h1280_acts",
         "lstm_f32_h1280")
REPS = 50
ROUNDS = 2

# variant: [(anchor, replacement, times the anchor occurs)]
VARIANTS: Variants = {
    "no_copies": [
        ("      lstm_stage<T, VEC>(",
         "      if (H < 0) lstm_stage<T, VEC>(", 2),
    ],
    "no_products": [
        ("    lstm_mac<T>(acc, ", "    if (H < 0) lstm_mac<T>(acc, ", 1),
    ],
    "no_w_copies": [
        ("      cp_async<8>(", "      if (H < 0) cp_async<8>(", 1),
    ],
    "no_h_copies": [
        ("      cp_async<16>(hs", "      if (H < 0) cp_async<16>(hs", 1),
    ],
}


def variant_tree(name: str) -> Path:
    """A tree under the package's build directory holding this
    checkout's ``rnn_cells.cu`` with the variant's substitutions."""
    source = variant_source(
        name, (build.CSRC_DIR / "rnn_cells.cu").read_text(), VARIANTS)
    tree = build.BUILD_DIR / "rnn_variants" / name
    (tree / "paddle_tpu_torch" / "csrc").mkdir(parents=True, exist_ok=True)
    (tree / "paddle_tpu_torch" / "csrc" / "rnn_cells.cu").write_text(source)
    return tree


def earlier_step(tree: Path):
    """The earlier tree's ``rnn_lstm_step``, with its signature set."""
    fn = build_earlier(tree, ("rnn_cells",))["rnn_cells"].rnn_lstm_step
    fn.argtypes, fn.restype = R._SIGNATURES["rnn_lstm_step"]
    return fn


def earlier_call(fn, case):
    """The earlier wrapper's work: outputs, one launch."""
    xp, h, c = case["xp"], case["h"], case["c"]
    B, H = h.shape

    def call():
        new_h, new_c = torch.empty_like(h), torch.empty_like(c)
        acts = (torch.empty((B, 5 * H), dtype=torch.float32, device=h.device)
                if case["save_acts"] else None)
        rc = fn(xp.data_ptr(), h.data_ptr(), c.data_ptr(),
                case["w_h"].data_ptr(), case["bias"].data_ptr(),
                new_h.data_ptr(), new_c.data_ptr(), R._ptr(acts), B, H,
                R._DTYPE_CODE[xp.dtype], R._stream(h.device))
        assert rc == 0, rc
        return new_h, new_c, acts

    return call


def cudnn_step_ms(H: int) -> float:
    """cuDNN's LSTM forward over [64, 128, H], per step, and the timer."""
    gen = torch.Generator(device="cpu").manual_seed(rw.SEED)
    lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x = torch.randn((rw.BATCH, rw.STEPS_T, H), generator=gen).cuda()
    with torch.no_grad():
        ms, timer = card_ms(lambda: lstm(x), reps=5)
    return ms / rw.STEPS_T, timer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path, nargs="?",
                    help="unpacked git archive of the earlier commit")
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="time a variant of this checkout's B5 instead")
    args = ap.parse_args(argv)
    if (args.tree is None) == (args.variant is None):
        ap.error("give an earlier tree or --variant, not both")
    if not torch.cuda.is_available():
        print("compare_rnn: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name()
    tree = args.tree if args.variant is None else variant_tree(args.variant)
    # the other version: the earlier commit's B5, or this checkout's variant
    other = "earlier" if args.variant is None else "variant"
    fn = earlier_step(tree)
    calls = {}
    for name in CASES:
        case = rw.rnn_case(name, "cuda")
        a = (case["xp"], case["h"], case["c"], case["w_h"], case["bias"])
        save = case["save_acts"]
        versions = {other: earlier_call(fn, case),
                    "this": lambda a=a, save=save: R.lstm_step_kernel(
                        *a, save_acts=save)}
        want = R.lstm_step_reference(*a, save_acts=save)
        for version, call in versions.items():
            if version == "variant":
                continue
            got = call()
            torch.cuda.synchronize()
            errs = [rw.rnn_error(g, w) for g, w in zip(got, want)
                    if w is not None]
            if not all(e["within_tolerance"] for e in errs):
                raise AssertionError(f"{version} {name} outside tolerance: "
                                     f"{errs}")
        calls[name] = versions
    times = {n: {other: [], "this": []} for n in CASES}
    cudnn = {512: [], 1280: []}
    for rnd in range(ROUNDS):
        for version in (other, "this", "this", other):
            for name, versions in calls.items():
                ms, timer = card_ms(versions[version], reps=REPS)
                times[name][version].append((ms, timer))
                emit({"round": rnd, "case": name, "version": version,
                      "ms": ms, "timer": timer})
        for H in cudnn:
            ms, timer = cudnn_step_ms(H)
            cudnn[H].append((ms, timer))
            emit({"round": rnd, "cudnn_H": H, "ms_per_step": ms,
                  "timer": timer})
    emit({"card": card, "reps": REPS, other: str(args.tree or args.variant),
          "cudnn_ms_per_step": {
              str(H): float(np.median([ms for ms, _ in t]))
              for H, t in cudnn.items()},
          "cudnn_timers": sorted({timer for t in cudnn.values()
                                  for _, timer in t}),
          **summary(times)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
