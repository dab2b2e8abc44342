"""``python -m paddle_tpu_torch.analysis`` — the analysis CLIs (the port of
``paddle_tpu/analysis/cli.py``).

``program <script.py> [--fetch NAME ...] [--feed NAME ...] [--strict]``
    Execute the script (a fluid graph-building file) under a fresh
    default program and verify every ``fluid.Program`` it leaves behind:
    the default program plus any Program bound to a module-level name.
    Exit 1 when any ERROR diagnostic fires (``--strict``: any finding).

``lint [paths...] [--rule NAME ...]``
    Run the repo-invariant linter (default: the whole
    ``paddle_tpu_torch`` package).  Findings print one per line; a
    nonzero count ends with a ``LINT-FAIL`` tagged line and exit 1.

``concurrency [--rule NAME ...] [--strict] [--device DEV]``
    The concurrency auditor: ``guarded-by`` (CONC-AUDIT lock-discipline
    checker over the ``# guarded_by(...)`` annotations), ``state-table``
    (PROTO-AUDIT static check of every literal assignment site against
    the declared lifecycle state machines), ``transition-runtime`` (the
    same machines checked dynamically through the transition recorder
    while the seeded chaos drives run), and ``schedule-permute``
    (SCHED-AUDIT: replay each chaos drive under permuted intra-tick
    schedules and fail on any terminal-fingerprint divergence, dumping
    an OBS-POSTMORTEM for the minimal divergent prefix).  The drives run
    on ``cuda`` unless ``--device cpu``.  Exit 0 = clean, 1 = findings,
    2 = crash.

``xla`` and ``sharding``
    The JAX package's jaxpr auditors are not ported yet: they come with
    the last slice of the analysis package, and both commands raise
    naming it.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

_JAXPR_AUDITORS = ("the last slice of the analysis package (the jaxpr "
                   "auditors: retrace, xla, sharding)")


def cmd_program(args) -> int:
    import runpy

    from paddle_tpu_torch.analysis.diagnostics import Severity, format_report
    from paddle_tpu_torch.analysis.program_check import verify_program
    from paddle_tpu_torch.fluid.framework import (Program,
                                                  default_main_program,
                                                  reset_default_program)

    reset_default_program()
    mod = runpy.run_path(args.script)
    programs = {"<default program>": default_main_program()}
    for name, val in mod.items():
        if isinstance(val, Program):
            programs[name] = val
    # an untouched default program is noise when the script builds its
    # own Programs explicitly
    if len(programs) > 1 and not default_main_program().global_block().ops:
        programs.pop("<default program>")

    worst = 0
    for name, prog in programs.items():
        # --fetch/--feed describe ONE run contract; applying them to
        # every module-level Program would fabricate dangling-fetch
        # errors on programs (pruned test graphs, sub-builds) they never
        # belonged to — so they bind to the default program only, unless
        # the script builds exactly one Program
        scoped = name == "<default program>" or len(programs) == 1
        fetch = (args.fetch or None) if scoped else None
        feed = (args.feed or None) if scoped else None
        diags = verify_program(prog, fetch_names=fetch, feed_names=feed)
        print(format_report(
            diags, title=f"== {args.script} :: {name} "
                         f"({len(prog.global_block().ops)} ops)"))
        errs = [d for d in diags if d.severity is Severity.ERROR]
        if errs or (args.strict and diags):
            worst = 1
    return worst


def cmd_lint(args) -> int:
    from paddle_tpu_torch.analysis.lint import RULES, run_lint

    unknown = [r for r in (args.rule or []) if r not in RULES]
    if unknown:
        print(f"unknown rule(s) {unknown}; known: {sorted(RULES)}",
              file=sys.stderr)
        return 2
    findings = run_lint(paths=args.paths or None, rules=args.rule or None)
    for d in findings:
        print(f"{d.message}  [{d.code}]")
    if findings:
        print(f"LINT-FAIL: {len(findings)} finding(s) — fix, or annotate "
              "a justified exception with `# lint: allow(<rule>)`")
        return 1
    print("lint ok: 0 findings")
    return 0


def cmd_unported(args) -> int:
    from paddle_tpu_torch.platform.enforce import EnforceError

    raise EnforceError(f"the {args.cmd} audit is not ported yet: it comes "
                       f"with {_JAXPR_AUDITORS}", context="analysis")


def cmd_concurrency(args) -> int:
    from paddle_tpu_torch.analysis.concurrency import (
        RULE_NAMES, run_concurrency_audit)
    from paddle_tpu_torch.analysis.diagnostics import Severity

    unknown = [r for r in (args.rule or []) if r not in RULE_NAMES]
    if unknown:
        print(f"unknown rule(s) {unknown}; known: {sorted(RULE_NAMES)}",
              file=sys.stderr)
        return 2
    try:
        diags = run_concurrency_audit(rules=args.rule or None,
                                      device=args.device)
    except Exception as e:      # crash != findings: distinct exit code
        print(f"concurrency audit crashed: {e!r}")
        return 2
    for d in diags:
        print(d)
    errs = [d for d in diags if d.severity is Severity.ERROR]
    if errs or (args.strict and diags):
        strict_note = ""
        if args.strict and len(diags) > len(errs):
            strict_note = (f" + {len(diags) - len(errs)} non-ERROR "
                           "finding(s) failing under --strict")
        print(f"CONC-AUDIT: {len(errs)} ERROR finding(s){strict_note} — "
              "fix the access/transition/order, or annotate the "
              "justified exception")
        return 1
    print(f"concurrency audit ok: 0 ERROR findings "
          f"({len(diags)} informational)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.analysis",
        description="static program verifier + repo-invariant linter")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("program",
                       help="verify fluid Programs built by a script")
    p.add_argument("script", help="python file that builds the program(s)")
    p.add_argument("--fetch", action="append", default=[],
                   help="fetch target name (enables dangling-fetch and "
                        "dead-var checks); repeatable.  Binds to the "
                        "default program (or the script's single "
                        "Program) — other module-level Programs get the "
                        "structural checks only")
    p.add_argument("--feed", action="append", default=[],
                   help="feed name the run will provide; repeatable "
                        "(same scoping as --fetch)")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on ANY diagnostic, not just ERRORs")
    p.set_defaults(fn=cmd_program)

    p = sub.add_parser("lint", help="run the repo-invariant linter")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: paddle_tpu/)")
    p.add_argument("--rule", action="append", default=[],
                   help="restrict to the named rule(s); repeatable")
    p.set_defaults(fn=cmd_lint)

    for name in ("xla", "sharding"):
        p = sub.add_parser(name, help=f"not ported yet: comes with "
                                      f"{_JAXPR_AUDITORS}")
        p.add_argument("--rule", action="append", default=[])
        p.add_argument("--strict", action="store_true")
        p.set_defaults(fn=cmd_unported)

    p = sub.add_parser(
        "concurrency",
        help="lock-discipline checker + lifecycle state machines + "
             "schedule-permutation model checker over the seeded chaos "
             "drives")
    p.add_argument("--rule", action="append", default=[],
                   help="restrict the audit to the named rule(s); "
                        "repeatable")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on ANY diagnostic, not just ERRORs")
    p.add_argument("--device", default=None,
                   help="where the chaos drives' engines run: cuda (the "
                        "default) or cpu")
    p.set_defaults(fn=cmd_concurrency)

    args = parser.parse_args(argv)
    return args.fn(args)
