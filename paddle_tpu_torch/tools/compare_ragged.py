"""Time the ragged paged-attention kernel against an earlier commit's, in
one process on one card, taking turns.

The earlier kernel comes from a ``git archive`` of that commit unpacked
into a directory: its ``paddle_tpu_torch/csrc/ragged_paged_attention.cu``
is built there with this checkout's nvcc flags and called through its C
entry: the one every commit before the split token axis exported
(``rpa_launch(q, k_pages, v_pages, k_scale, v_scale, page_table, kv_lens,
row_seq, qpos, out, T, H, KVH, D, page, Pm, page dtype, sm_scale,
stream)``, f32 queries, head_dim 128), or, where the earlier source takes
``n_splits`` (the split token axis's entry, this checkout's too), through
this checkout's wrapper with the earlier library in place of this one's.
This checkout's kernel runs through its wrapper.  Both run the main
path's cases (``ragged_cases`` ``decode_f32`` and ``mixed_f32``: 16 heads
of head_dim 128, page 128, f32 pool) on the same inputs; each is first
held against the plain version
(``ragged_cases.check``), then timed in rounds of earlier, this, this,
earlier.  A time is card time (``compare_flash.card_ms``: one call's
worth of each CUDA kernel's mean record over ``REPS`` calls under
``torch.profiler``; this checkout's includes its merge launch and the wrapper's small casts, and
so does the earlier one's casts); each time carries the timer that took
it.  It prints one JSON line per case and round, then a summary line with
the bound of each case and the card's name and power limit.

Run from the repository root on a machine with one GPU::

    mkdir -p chip_scratch/parent
    git archive <commit> | tar -x -C chip_scratch/parent
    python -m paddle_tpu_torch.tools.compare_ragged chip_scratch/parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from paddle_tpu_torch.serving import decode_attention as da
from paddle_tpu_torch.tools import ragged_cases as rc
from paddle_tpu_torch.tools.compare_flash import (build_earlier, card_ms,
                                                  card_name, summary)

CASES = ("decode_f32", "mixed_f32")
# with an earlier tree that has this checkout's entry, also the int8 and
# bf16 pages at head dim 128 and the bf16 tensor-core path
CURRENT_ENTRY_CASES = ("mixed_int8", "mixed_bf16", "mixed_bf16q_bf16",
                       "decode_bf16q_bf16")
REPS = 50
ROUNDS = 2
_VOIDP, _INT = ctypes.c_void_p, ctypes.c_int
# the earlier trees' C entry: 10 pointers, 7 ints, sm_scale, stream
EARLIER_SIGNATURE = ([_VOIDP] * 10 + [_INT] * 7 + [ctypes.c_float, _VOIDP],
                     _INT)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def earlier_lib(tree: Path):
    """The earlier tree's library, built, and whether its ``rpa_launch``
    is this checkout's entry (it takes ``n_splits``)."""
    name = "ragged_paged_attention"
    source = (tree / "paddle_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    lib = build_earlier(tree, (name,))[name]
    current = "int n_splits" in source
    for sym, (argtypes, restype) in (da._RPA_SIGNATURES.items() if current
                                     else [("rpa_launch",
                                            EARLIER_SIGNATURE)]):
        getattr(lib, sym).argtypes = list(argtypes)
        getattr(lib, sym).restype = restype
    return lib, current


class _Library:
    """Stands in for ``build`` in the wrapper's module: ``load`` gives
    the earlier library."""

    def __init__(self, lib):
        self.lib = lib

    def load(self, name, signatures):
        return self.lib


def wrapper_call(lib, case):
    """This checkout's wrapper on ``case`` with ``lib`` in place of its
    own library."""
    def call():
        own = da.build
        da.build = _Library(lib)
        try:
            return da.ragged_paged_attention_kernel(*rc.args(case),
                                                    **rc.scales(case))
        finally:
            da.build = own

    return call


def earlier_call(fn, case):
    """A call of the earlier kernel (the entry before the split token
    axis) on ``case`` as its wrapper made it: int32 casts of the index
    arrays, the output, one launch."""
    q, kp, vp = case["q"], case["k_pages"], case["v_pages"]
    t, h, d = q.shape
    _, page, kvh, _ = kp.shape
    pm = case["page_table"].shape[1]

    def call():
        idx = [case[k].to(torch.int32).contiguous() for k in
               ("page_table", "kv_lens", "row_seq", "qpos")]
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
                 *(x.data_ptr() for x in idx), out.data_ptr(), t, h, kvh, d,
                 page, pm, 0, float(d) ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path,
                    help="unpacked git archive of the earlier commit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_ragged: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name()
    cases = dict(rc.kernel_cases(torch.device("cuda")))
    lib, current = earlier_lib(args.tree)
    calls = {}
    # an earlier tree with this checkout's entry runs every case it takes
    names = CASES + (CURRENT_ENTRY_CASES if current else ())
    for name in names:
        case = cases[name]
        calls[name] = {
            "earlier": (wrapper_call(lib, case) if current
                        else earlier_call(lib.rpa_launch, case)),
            "this": lambda case=case: da.ragged_paged_attention_kernel(
                *rc.args(case), **rc.scales(case))}
        for version, fn in calls[name].items():
            res = rc.check(case, fn())
            if not res["within_tolerance"]:
                raise AssertionError(f"{version} {name} outside tolerance: "
                                     f"{res}")
    times = {name: {"earlier": [], "this": []} for name in calls}
    for rnd in range(ROUNDS):
        for version in ("earlier", "this", "this", "earlier"):
            for name, versions in calls.items():
                ms, timer = card_ms(versions[version], REPS)
                times[name][version].append((ms, timer))
                emit({"round": rnd, "case": name, "version": version,
                      "ms": ms, "timer": timer})
    bounds = {name: {k: v for k, v in rc.roofline(cases[name]).items()
                     if k in ("bound_ms", "bound_by")} for name in calls}
    emit({"card": card, "reps": REPS, "earlier": str(args.tree),
          "bounds": bounds, **summary(times)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
