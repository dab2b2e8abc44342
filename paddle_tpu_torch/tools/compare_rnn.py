"""Time the fused RNN steps (B5, B6, B7 and B8) against an earlier
commit's, in one process on one card, taking turns, with cuDNN's LSTM
beside them.

The earlier kernels come from a ``git archive`` of that commit unpacked
into a directory: its ``paddle_tpu_torch/csrc/rnn_cells.cu`` is built
there with this checkout's nvcc flags and called through its C entries
(``rnn_lstm_step``, ``rnn_gru_step``, ``rnn_gru_zr``, ``rnn_gru_cand``),
which every version exports with one signature each.  This checkout's B5
runs through its wrapper; its GRU kernels through the same C entries as
the earlier ones, on the same outputs.  The cases are ``rnn_workload``'s
at B 64, f32, on the same inputs:

- B5: the LSTM cases at H 512 and H 1280, acts saved and not;
- B6: ``gru_block_f32_h512_acts`` and ``gru_block_f32_h512``;
- B7: ``gru_tiled_f32_h1280_acts``;
- B8 on B7's plain outputs at the same case, a control: this checkout
  leaves B8 as it was.

Each is first held against the plain version (``rnn_workload.rnn_error``),
then timed in rounds of earlier, this, this, earlier.  A time is card time
(``compare_flash.card_ms``: one call's worth of each CUDA kernel's mean
record over ``REPS`` calls under ``torch.profiler``) and carries the
timer that took it and
the card's SM clock read just after it (``nvidia-smi --query-gpu=
clocks.sm``).  Once a round, this checkout's B6 on its main case is also
timed three other ways, for the gap between one kernel's readings in
different settings (``chip_smoke.py``'s, this tool's, the training
scan's): ``spaced``, each call waited for before the next is launched
(the card idle between launches, as in the host-bound scan);
``cold_l2``, each call after 64 MB of writes that evict W_h from the
50 MB L2; and ``after_load``, each call right after a [4096, 4096] f32
product (which evicts the L2 too), as ``chip_smoke.py`` times a kernel
right after its plain version's products.  The library yardstick, timed once a round, is cuDNN's
``torch.nn.LSTM`` forward (input size H, TF32 off) over [64, 128, H]
divided by 128 steps; the port never calls it.  It prints one JSON line
per case, version and round and a summary line with the card's name and
power limit.

``--variant NAME`` times, in the earlier version's place and under the
name ``variant``, a variant of this checkout's own ``rnn_cells.cu`` that
leaves out one part of the main loops' work (``flash_ablate.
variant_source``: a text substitution whose anchor must occur the given
number of times); its outputs are wrong by design and are not checked:

- ``no_copies``: the rings are never filled (B5's, and the GRU loop's of
  B6 and B7); the products run on whatever shared memory holds: the
  products, barriers and epilogues alone;
- ``no_products``: the rings are filled and waited for but nothing is
  summed: the copy pipelines, barriers and epilogues alone;
- ``no_sync``: B6 without its grid-wide sync: what the sync costs;
- ``no_w_copies`` and ``no_h_copies`` (B5 only): one of its two copy
  streams left out (W's 8-byte pieces, or h's 16-byte words).

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
                                                  card_name, emit, sm_clock,
                                                  summary)
from paddle_tpu_torch.tools.flash_ablate import Variants, variant_source

CASES = ("lstm_f32_h512_acts", "lstm_f32_h512", "lstm_f32_h1280_acts",
         "lstm_f32_h1280")
# (rnn_workload case, kernel); a line's name is "kernel:case"
GRU_CASES = (("gru_block_f32_h512_acts", "gru_step"),
             ("gru_block_f32_h512", "gru_step"),
             ("gru_tiled_f32_h1280_acts", "gru_zr"),
             ("gru_tiled_f32_h1280_acts", "gru_cand"))
GAP_CASE = "gru_step:gru_block_f32_h512_acts"
REPS = 50
ROUNDS = 2
L2_FLUSH_BYTES = 64 << 20

# variant: [(anchor, replacement, times the anchor occurs)]; the GRU
# loop's anchors are listed in GRU_ANCHORS
VARIANTS: Variants = {
    "no_copies": [
        ("      lstm_stage<T, VEC>(",
         "      if (H < 0) lstm_stage<T, VEC>(", 2),
        ("gru_copy_a<TA, VEC>(gru_a", "if (H < 0) gru_copy_a<TA, VEC>(gru_a",
         2),
        ("gru_copy_w<NG, VEC>(gru_w", "if (H < 0) gru_copy_w<NG, VEC>(gru_w",
         3),
    ],
    "no_products": [
        ("    lstm_mac<T>(acc, ", "    if (H < 0) lstm_mac<T>(acc, ", 1),
        ("    gru_mac<NG, TA>(acc, ", "    if (H < 0) gru_mac<NG, TA>(acc, ",
         1),
    ],
    "no_sync": [
        ("  cg::this_grid().sync();", "  if (H < 0) cg::this_grid().sync();",
         1),
    ],
    "no_w_copies": [
        ("      cp_async<8>(", "      if (H < 0) cp_async<8>(", 1),
    ],
    "no_h_copies": [
        ("      cp_async<16>(hs", "      if (H < 0) cp_async<16>(hs", 1),
    ],
}
GRU_ANCHORS = {"gru_copy_a<TA, VEC>(gru_a", "gru_copy_w<NG, VEC>(gru_w",
               "    gru_mac<NG, TA>(acc, ", "  cg::this_grid().sync();"}


def variant_tree(name: str) -> Path:
    """A tree under the package's build directory holding this
    checkout's ``rnn_cells.cu`` with the variant's substitutions."""
    source = variant_source(
        name, (build.CSRC_DIR / "rnn_cells.cu").read_text(), VARIANTS)
    tree = build.BUILD_DIR / "rnn_variants" / name
    (tree / "paddle_tpu_torch" / "csrc").mkdir(parents=True, exist_ok=True)
    (tree / "paddle_tpu_torch" / "csrc" / "rnn_cells.cu").write_text(source)
    return tree


def earlier_lib(tree: Path):
    """The earlier tree's ``rnn_cells`` library, its step entries'
    signatures set."""
    lib = build_earlier(tree, ("rnn_cells",))["rnn_cells"]
    for sym in ("rnn_lstm_step", "rnn_gru_step", "rnn_gru_zr",
                "rnn_gru_cand"):
        fn = getattr(lib, sym)
        fn.argtypes, fn.restype = R._SIGNATURES[sym]
    return lib


def earlier_call(fn, case):
    """The earlier B5 wrapper's work: outputs, one launch."""
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


def gru_entry_call(lib, case, kernel: str):
    """One launch of ``kernel`` through ``lib``'s C entry on ``case``,
    returning {output: tensor} (B8 on B7's plain outputs), and the plain
    version's {output: tensor}."""
    xp, h, w, b = case["xp"], case["h"], case["w_h"], case["bias"]
    B, H = h.shape
    save = case["save_acts"]
    dt, stream = R._DTYPE_CODE[xp.dtype], R._stream(h.device)
    if kernel == "gru_step":
        want_h, want_acts = R.gru_step_reference(xp, h, w, b, save_acts=save)
        want = {"h": want_h, "acts": want_acts}

        def call():
            new_h = torch.empty_like(h)
            rh = torch.empty((B, H), dtype=torch.float32, device=h.device)
            acts = (torch.empty((B, 3 * H), dtype=torch.float32,
                                device=h.device) if save else None)
            assert lib.rnn_gru_step(xp.data_ptr(), h.data_ptr(), w.data_ptr(),
                                    b.data_ptr(), rh.data_ptr(),
                                    new_h.data_ptr(), R._ptr(acts), B, H, dt,
                                    stream) == 0
            return {"h": new_h, "acts": acts}
    elif kernel == "gru_zr":
        zrc_p, rh_p = R.gru_zr_reference(xp, h, w, b)
        want = {"zr": zrc_p[:, :2 * H], "rh": rh_p}

        def call():
            zrc = torch.empty((B, 3 * H), dtype=torch.float32,
                              device=h.device)
            rh = torch.empty((B, H), dtype=torch.float32, device=h.device)
            assert lib.rnn_gru_zr(xp.data_ptr(), h.data_ptr(), w.data_ptr(),
                                  b.data_ptr(), zrc.data_ptr(), rh.data_ptr(),
                                  B, H, dt, stream) == 0
            return {"zr": zrc[:, :2 * H], "rh": rh}
    else:
        zrc_p, rh_p = R.gru_zr_reference(xp, h, w, b)
        zw = zrc_p.clone()
        want = {"h": R.gru_cand_reference(rh_p, xp, w, b, zw, h,
                                          save_c=save),
                "c": zw[:, 2 * H:] if save else None}

        def call():
            zrc = zrc_p.clone()
            new_h = torch.empty_like(h)
            assert lib.rnn_gru_cand(rh_p.data_ptr(), xp.data_ptr(),
                                    w.data_ptr(), b.data_ptr(),
                                    zrc.data_ptr(), h.data_ptr(),
                                    new_h.data_ptr(), int(save), B, H, dt,
                                    stream) == 0
            return {"h": new_h, "c": zrc[:, 2 * H:] if save else None}
    return call, want


def check(version: str, name: str, got: dict, want: dict) -> None:
    errs = {o: rw.rnn_error(got[o], w) for o, w in want.items()
            if w is not None}
    if not all(e["within_tolerance"] for e in errs.values()):
        raise AssertionError(f"{version} {name} outside tolerance: {errs}")


def cudnn_step_ms(H: int) -> float:
    """cuDNN's LSTM forward over [64, 128, H], per step, and the timer."""
    gen = torch.Generator(device="cpu").manual_seed(rw.SEED)
    lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x = torch.randn((rw.BATCH, rw.STEPS_T, H), generator=gen).cuda()
    with torch.no_grad():
        ms, timer = card_ms(lambda: lstm(x), reps=5)
    return ms / rw.STEPS_T, timer


def gap_versions(call) -> dict:
    """B6's main case called ``spaced`` (each call waited for), after an
    L2 flush (``cold_l2``) and after a large product (``after_load``); of
    the last two only the kernel's own time is read."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    load = torch.ones((4096, 4096), device="cuda")

    def spaced():
        call()
        torch.cuda.synchronize()

    def cold():
        flush.zero_()
        call()

    def after_load():
        torch.matmul(load, load)
        call()

    return {"this_spaced": (spaced, ""),
            "this_cold_l2": (cold, "gru_step_kernel"),
            "this_after_load": (after_load, "gru_step_kernel")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path, nargs="?",
                    help="unpacked git archive of the earlier commit")
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="time a variant of this checkout's kernels instead")
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
    # the other version: the earlier commit's kernels, or this checkout's
    # variant
    other = "earlier" if args.variant is None else "variant"
    lib = earlier_lib(tree)
    this_lib = build.load("rnn_cells", R._SIGNATURES)
    calls = {}
    for name in CASES:
        case = rw.rnn_case(name, "cuda")
        a = (case["xp"], case["h"], case["c"], case["w_h"], case["bias"])
        save = case["save_acts"]
        versions = {other: earlier_call(lib.rnn_lstm_step, case),
                    "this": lambda a=a, save=save: R.lstm_step_kernel(
                        *a, save_acts=save)}
        want = R.lstm_step_reference(*a, save_acts=save)
        for version, call in versions.items():
            if version == "variant":
                continue
            got = call()
            torch.cuda.synchronize()
            check(version, name, dict(enumerate(got)),
                  dict(enumerate(want)))
        calls[name] = versions
    for cname, kernel in GRU_CASES:
        name = f"{kernel}:{cname}"
        case = rw.rnn_case(cname, "cuda")
        versions = {}
        for version, vlib in ((other, lib), ("this", this_lib)):
            call, want = gru_entry_call(vlib, case, kernel)
            if version != "variant":
                got = call()
                torch.cuda.synchronize()
                check(version, name, got, want)
            versions[version] = call
        calls[name] = versions
    times = {n: {other: [], "this": []} for n in calls}
    gaps = gap_versions(calls[GAP_CASE]["this"])
    times[GAP_CASE].update({v: [] for v in gaps})
    cudnn = {512: [], 1280: []}
    for rnd in range(ROUNDS):
        for version in (other, "this", "this", other):
            for name, versions in calls.items():
                ms, timer = card_ms(versions[version], reps=REPS)
                times[name][version].append((ms, timer))
                emit({"round": rnd, "case": name, "version": version,
                      "ms": ms, "timer": timer, "sm_clock": sm_clock(),
                      "card": card})
        for version, (fn, only) in gaps.items():
            ms, timer = card_ms(fn, reps=REPS, only=only)
            times[GAP_CASE][version].append((ms, timer))
            emit({"round": rnd, "case": GAP_CASE, "version": version,
                  "ms": ms, "timer": timer, "sm_clock": sm_clock(),
                  "card": card})
        for H in cudnn:
            ms, timer = cudnn_step_ms(H)
            cudnn[H].append((ms, timer))
            emit({"round": rnd, "cudnn_H": H, "ms_per_step": ms,
                  "timer": timer})
    emit({"card": card, "sm_clock": sm_clock(), "reps": REPS,
          other: str(args.tree or args.variant),
          "cudnn_ms_per_step": {
              str(H): float(np.median([ms for ms, _ in t]))
              for H, t in cudnn.items()},
          "cudnn_timers": sorted({timer for t in cudnn.values()
                                  for _, timer in t}),
          **summary(times)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
