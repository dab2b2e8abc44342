"""``python -m paddle_tpu_torch.resilience`` — run / check the
fault-tolerant training runtime (the port of
``paddle_tpu/resilience/cli.py``).

``run [--save-dir D] [--seed N] [--device D]``
    Demo + operator entry point: restart a seeded chaos training run
    (kills mid-pass, a kill between blob write and meta commit, injected
    NaN gradients, a slow-step window) across injected deaths under the
    resume supervisor, against an uninterrupted control, and print one
    JSON summary line (restarts, skipped bad steps, parity, checkpoint
    stall/write split).

``check [--device D]``
    The gate: run the same seeded chaos replay PLUS the torn-save probe
    and exit 0 only when every acceptance invariant holds — final params
    bit-identical to control, every death resumed from a verified
    checkpoint, injected non-finite steps skipped with optimizer slots
    untouched, zero corrupt surviving artifacts, and the
    kill-between-blob-and-meta case leaving the previous checkpoint
    loadable.  Findings print one ``CKPT-CHECK`` line each (plus any
    ``CKPT-CORRUPT`` lines from the loader) and a ``CKPT-CORRUPT-GATE``
    summary, and exit 1.  A crash exits 2.

Both run on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import List, Optional


def _run_scenarios(save_dir: Optional[str], seed: int,
                   device: Optional[str]) -> dict:
    import os
    import shutil

    from paddle_tpu_torch.resilience.chaos import (seeded_chaos,
                                                   torn_save_probe)

    if save_dir is None:
        save_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_resilience_")
    chaos_dir = os.path.join(save_dir, "chaos")
    torn_dir = os.path.join(save_dir, "torn")
    # the replay owns these two scratch subdirs: stale checkpoints from
    # a previous invocation would make attempt 0 resume at a completed
    # cursor and falsely fail the parity assertions
    for d in (chaos_dir, torn_dir):
        shutil.rmtree(d, ignore_errors=True)
    out = seeded_chaos(chaos_dir, seed=seed, device=device)
    out.pop("costs")
    probe = torn_save_probe(torn_dir, seed=seed + 1, device=device)
    out["problems"] = list(out["problems"]) + list(probe["problems"])
    probe.pop("problems")
    out.update(probe)
    out["save_dir"] = save_dir
    return out


def cmd_run(args) -> int:
    out = _run_scenarios(args.save_dir, args.seed, args.device)
    problems = out.pop("problems")
    out["ok"] = int(not problems)
    print(json.dumps(out), flush=True)
    for p in problems:
        print(f"resilience: {p}", flush=True)
    return 0 if not problems else 1


def cmd_check(args) -> int:
    import shutil

    out = _run_scenarios(None, 0, args.device)
    # the gate's scratch dir is always a fresh tempdir: remove it, or
    # every invocation would leak a checkpoint-filled tree
    shutil.rmtree(out.pop("save_dir"), ignore_errors=True)
    problems: List[str] = out.pop("problems")
    if problems:
        for p in problems:
            print(f"CKPT-CHECK: {p}", flush=True)
        print(f"CKPT-CORRUPT-GATE: {len(problems)} finding(s) — the "
              "chaos replay's checkpoint/resume invariants do not hold",
              flush=True)
        return 1
    print(f"resilience check ok: {out['train_chaos_deaths']} injected "
          f"deaths resumed, {out['train_chaos_bad_steps_skipped']} bad "
          f"steps skipped, params bit-identical to control, "
          f"0 corrupt artifacts", flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.resilience",
        description="fault-tolerant training runtime: chaos run + gate")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="supervised seeded-chaos training "
                                   "demo; prints one JSON summary line")
    p.add_argument("--save-dir", default=None,
                   help="checkpoint root (default: a fresh temp dir). "
                        "The replay owns and CLEARS the chaos/ and "
                        "torn/ subdirs under it on every invocation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("check", help="gate: seeded chaos replay + "
                                     "torn-save probe; exit 1 on any "
                                     "violated invariant")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_check)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except SystemExit:
        raise
    except BaseException as e:   # crash != findings: distinct exit code
        print(f"resilience checker crashed: {e!r}", flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
