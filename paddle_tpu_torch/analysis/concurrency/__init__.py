"""paddle_tpu_torch.analysis.concurrency — the concurrency auditor (the
port of ``paddle_tpu/analysis/concurrency``).

Three rule families over the distributed runtime's host-side state (CLI
``python -m paddle_tpu_torch.analysis concurrency``):

- :mod:`~paddle_tpu_torch.analysis.concurrency.guards` — ``CONC-AUDIT``:
  the ``# guarded_by(...)`` lock-discipline checker (rule
  ``guarded-by``).
- :mod:`~paddle_tpu_torch.analysis.concurrency.lifecycle` — ``PROTO-AUDIT``:
  declared :class:`StateMachineSpec` tables checked statically against
  every literal assignment site (rule ``state-table``) and dynamically
  through the transition recorder during the chaos drives (rule
  ``transition-runtime``).
- :mod:`~paddle_tpu_torch.analysis.concurrency.schedules` — ``SCHED-AUDIT``:
  the schedule-permutation model checker replaying the seeded chaos
  drives under permuted intra-tick phase orders (rule
  ``schedule-permute``).

This ``__init__`` stays lazy on purpose: ``serving/fleet.py`` and
``resilience/checkpointer.py`` import the transition-recorder hook from
:mod:`.lifecycle` on their own import paths, so pulling the schedule
explorer (which itself drives the fleet) in here would be a cycle.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

RULE_NAMES = ("guarded-by", "state-table", "transition-runtime",
              "schedule-permute")

__all__ = ["RULE_NAMES", "run_concurrency_audit"]


def run_concurrency_audit(rules: Optional[Sequence[str]] = None,
                          device=None) -> List:
    """Run the selected rule families (default: all four) and return
    their merged :class:`Diagnostic` list.  ``transition-runtime`` and
    ``schedule-permute`` drive the real chaos fleets (on ``cuda`` unless
    ``device="cpu"``), so they dominate the runtime; the two static
    families are milliseconds."""
    selected = tuple(rules) if rules is not None else RULE_NAMES
    diags: List = []
    if "guarded-by" in selected:
        from paddle_tpu_torch.analysis.concurrency.guards import \
            run_guard_check
        diags.extend(run_guard_check())
    if "state-table" in selected:
        from paddle_tpu_torch.analysis.concurrency.lifecycle import \
            run_static_check
        diags.extend(run_static_check())
    need_drives = {"transition-runtime", "schedule-permute"} & set(selected)
    if need_drives:
        from paddle_tpu_torch.analysis.concurrency import schedules
        diags.extend(schedules.run_schedule_audit(
            runtime_only="schedule-permute" not in selected, device=device))
    return diags
