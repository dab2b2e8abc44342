"""paddle_tpu_torch.resilience — the fault-tolerant training runtime (the
port of ``paddle_tpu/resilience``).

Every recovery path here is deterministic, seeded and replayable.  Four
connected parts:

- :mod:`~paddle_tpu_torch.resilience.faults` — :class:`TrainFaultPlan`,
  the seedable injected-failure schedule (deaths, NaN gradients, slow
  steps, kill-during-save) threaded through ``trainer.SGD(faults=...)``
  on an injected clock;
- :mod:`~paddle_tpu_torch.resilience.guard` — :class:`BadStepGuard`, the
  skip / hysteresis / rollback-to-last-good policy ladder over one
  global grad-norm + finiteness reduction, its verdict read once a step;
- :mod:`~paddle_tpu_torch.resilience.checkpointer` —
  :class:`AsyncCheckpointer`, step-granular background checkpoint
  writes over the tmp+rename+md5 commit protocol (training stalls only
  for the device->host snapshot);
- :mod:`~paddle_tpu_torch.resilience.supervisor` — :func:`run_supervised`,
  restarting a training fn across deaths/rollbacks from the newest
  verified checkpoint.

``python -m paddle_tpu_torch.resilience run`` replays the seeded chaos
demo; ``... check`` is the gate (exit 0 clean, 1 findings, 2 crash).
"""

from paddle_tpu_torch.resilience.checkpointer import AsyncCheckpointer
from paddle_tpu_torch.resilience.faults import (BadStepRollback,
                                                InjectedTrainerDeath,
                                                ManualClock, TrainFaultPlan)
from paddle_tpu_torch.resilience.guard import BadStepGuard
from paddle_tpu_torch.resilience.supervisor import (RunReport,
                                                    SupervisorGaveUp,
                                                    run_supervised)

__all__ = [
    "TrainFaultPlan", "InjectedTrainerDeath", "BadStepRollback",
    "ManualClock", "BadStepGuard", "AsyncCheckpointer",
    "run_supervised", "RunReport", "SupervisorGaveUp",
]
