"""Resume supervisor: restart a training fn across injected (or real)
trainer deaths and bad-step rollbacks (the port of
``paddle_tpu/resilience/supervisor.py``, pure Python).

The serving fleet already treats replica death as routine
(``FleetRouter`` resubmits and moves on); this is the training-side
mirror: ``run_supervised`` keeps calling ``train_fn`` until it returns,
catching :class:`~paddle_tpu_torch.resilience.faults.InjectedTrainerDeath`
(a preemption / crash) and
:class:`~paddle_tpu_torch.resilience.faults.BadStepRollback` (the guard's
K-consecutive-bad-steps escalation) up to ``max_restarts`` times.  Each
``train_fn(attempt)`` is expected to build a FRESH trainer and call
``train(..., save_dir=..., resume=True)`` (or ``train(master=...)``,
whose resume is implicit) so every restart resumes from the newest
verified checkpoint — exactly what a replacement worker on preemptible
capacity does.

Restarts land on the obs timeline (``trainer_restart`` instants) and the
unified registry (``train_restarts_total``), so a chaos replay's
recovery history exports next to its serving twin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from paddle_tpu_torch.resilience.faults import (BadStepRollback,
                                          InjectedTrainerDeath)

__all__ = ["run_supervised", "RunReport", "SupervisorGaveUp"]


class SupervisorGaveUp(RuntimeError):
    """``max_restarts`` exhausted without the training fn completing."""


@dataclass
class RunReport:
    """What the supervisor observed across one supervised run."""

    completed: bool = False
    restarts: int = 0
    deaths: int = 0
    rollbacks: int = 0
    # (attempt, kind, message) per restart, for postmortems/benches
    history: List[Tuple[int, str, str]] = field(default_factory=list)


def run_supervised(train_fn: Callable[[int], Any], *,
                   max_restarts: int = 32, tracer=None, registry=None,
                   on_restart: Optional[Callable[[int, BaseException],
                                                 None]] = None
                   ) -> Tuple[RunReport, Any]:
    """Run ``train_fn(attempt)`` to completion across deaths/rollbacks.

    Returns ``(report, result)`` where ``result`` is ``train_fn``'s
    return value on the attempt that completed.  ``on_restart(attempt,
    exc)`` runs between a failure and the next attempt — the seam for
    advancing an injected clock past a lease TTL, or clearing a
    transient fault window after a rollback."""
    from paddle_tpu_torch.obs.trace import NULL_TRACER
    from paddle_tpu_torch.platform import plog

    tracer = tracer if tracer is not None else NULL_TRACER
    log = plog.logger()
    report = RunReport()
    while True:
        try:
            result = train_fn(report.restarts)
            report.completed = True
            return report, result
        except (InjectedTrainerDeath, BadStepRollback) as e:
            kind = ("rollback" if isinstance(e, BadStepRollback)
                    else "death")
            if kind == "rollback":
                report.rollbacks += 1
            else:
                report.deaths += 1
            report.restarts += 1
            report.history.append((report.restarts, kind, str(e)))
            tracer.instant("trainer_restart", cat="train", kind=kind,
                           attempt=report.restarts)
            if registry is not None:
                registry.counter(
                    "train_restarts_total",
                    "supervised trainer restarts after a death or "
                    "bad-step rollback").labels(kind=kind).inc()
            log.info("supervisor: restart %d after %s: %s",
                     report.restarts, kind, e)
            if report.restarts > max_restarts:
                raise SupervisorGaveUp(
                    f"gave up after {max_restarts} restarts "
                    f"(last: {kind}: {e})") from e
            if on_restart is not None:
                on_restart(report.restarts, e)
