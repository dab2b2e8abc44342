"""Deterministic fault injection for the TRAINING runtime (the port of
``paddle_tpu/resilience/faults.py``, pure Python: the same draws, so the
port's schedule is the JAX package's, draw for draw).

The serving engine proved its guardrails with ``serving/faults.py`` — a
seedable :class:`~paddle_tpu_torch.serving.faults.FaultPlan` on an injected
clock, threaded through ``ServingEngine(faults=...)`` so every recovery
path runs in CI without sleeps or real kills.  This module is the
training twin: a :class:`TrainFaultPlan` threaded through
``trainer.SGD(faults=...)`` so checkpoint/resume, bad-step guards and
the resume supervisor are chaos-tested the same way.

Injection points (all host-side, all deterministic):

- **clock** — a :class:`ManualClock` (shared with serving) advanced
  ``tick_s`` per train step plus any extra from ``slow_steps`` (global
  step -> added seconds), so lease-TTL paths (elastic training) and obs
  timelines fire on chosen steps without wall-clock dependence.
- **process "crashes"** — ``kill_at`` (global steps) and/or a seeded
  ``kill_rate`` raise :class:`InjectedTrainerDeath` at the top of the
  chosen step, before it executes.  Each kill fires ONCE per plan
  object (a resumed run re-executing the step survives it, like a real
  preemption that does not repeat), and the rate draw is a pure
  function of ``(seed, step)`` so a re-run of any step replays the same
  schedule regardless of how many restarts preceded it.
- **non-finite gradients** — ``bad_steps`` / seeded ``bad_rate`` make
  :meth:`grad_inject` return ``bad_value`` (NaN by default) for the
  chosen global steps.  The trainer adds it to every gradient after
  the backward, before the guard's screen; the bad-step guard must then
  skip the update.  Deterministic per ``(seed, step)``, so an
  uninterrupted control run and a kill-riddled chaos run poison exactly
  the same steps — the bit-identical-parity contract ``seeded_chaos``
  pins.
- **kill during save** — ``kill_save_at`` (checkpoint id -> commit
  phase from ``checkpoint.COMMIT_PHASES``) raises the death inside
  :func:`~paddle_tpu_torch.checkpoint.write_checkpoint` just before that
  phase's write.  ``{ck: "meta"}`` is the classic torn save: both blobs
  durable, meta never committed, previous checkpoint still ``latest``.
  Fires once per checkpoint id (the re-written save after resume
  completes).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Set

import numpy as np

from paddle_tpu_torch.serving.faults import ManualClock

__all__ = ["TrainFaultPlan", "InjectedTrainerDeath", "BadStepRollback",
           "ManualClock"]


class InjectedTrainerDeath(RuntimeError):
    """A fault-plan-injected trainer "crash" (the in-process stand-in
    for a preempted worker / OOM-killed process).  Catchable, so the
    resume supervisor restarts the training fn deterministically."""


class BadStepRollback(RuntimeError):
    """Raised by the bad-step guard when ``rollback_after`` consecutive
    bad steps accumulate: the run must roll back to its last verified
    checkpoint (the supervisor treats it like a death — restart and
    resume — after the guard has dumped its flight-recorder
    postmortem)."""


@dataclass
class TrainFaultPlan:
    """A seeded, replayable schedule of injected training failures.

    All randomized draws are pure functions of ``(seed, step)`` — NOT a
    sequential RNG stream — because chaos runs re-execute steps after
    every resume: a re-run step must see the same injection decision it
    saw the first time, and an uninterrupted control run must see the
    same schedule as a kill-riddled one.
    """

    seed: int = 0
    clock: Optional[ManualClock] = None
    # process crashes: global steps to die at + a seeded per-step rate
    kill_at: Set[int] = field(default_factory=set)
    kill_rate: float = 0.0
    # non-finite gradient injection: explicit steps + a seeded rate
    bad_steps: Set[int] = field(default_factory=set)
    bad_rate: float = 0.0
    bad_value: float = float("nan")
    # global step -> extra injected seconds (on top of clock.tick_s)
    slow_steps: Dict[int, float] = field(default_factory=dict)
    # checkpoint id -> commit phase (checkpoint.COMMIT_PHASES) to die at
    kill_save_at: Dict[int, str] = field(default_factory=dict)

    def __post_init__(self):
        self._fired_kills: Set[int] = set()
        self._fired_saves: Set[int] = set()

    # ---- plan surface ----------------------------------------------------

    def injects_grads(self) -> bool:
        """True when the plan poisons gradients — the trainer requires a
        bad-step guard in that case (without the in-step reduction the
        poison would silently corrupt optimizer slots forever)."""
        return bool(self.bad_steps) or self.bad_rate > 0.0

    def control_twin(self) -> "TrainFaultPlan":
        """The uninterrupted-control version of this plan: same seed and
        same gradient poison schedule, NO kills / slow windows / save
        kills.  A chaos run resumed across every injected death must end
        bit-identical to a run under its control twin — the
        ``seeded_chaos`` acceptance bar."""
        return TrainFaultPlan(seed=self.seed, bad_steps=set(self.bad_steps),
                              bad_rate=self.bad_rate,
                              bad_value=self.bad_value)

    # ---- hooks the trainer calls -----------------------------------------

    def _draw(self, step: int, salt: int) -> float:
        # order-independent: a per-(seed, step, salt) RandomState, so a
        # resumed run re-drawing an already-run step replays identically
        rs = np.random.RandomState(
            (self.seed * 1000003 + step * 9176 + salt) % (2 ** 31 - 1))
        return float(rs.random_sample())

    def step_begin(self, step: int) -> None:
        """Advance the injected clock for this global step and raise the
        scheduled death, if any.  Called at the TOP of the step — before
        the batch is applied — so a killed step's work is provably lost
        and must be re-run from the last checkpoint."""
        if self.clock is not None:
            self.clock.advance(self.clock.tick_s +
                               self.slow_steps.get(step, 0.0))
        kill = step in self.kill_at or (
            self.kill_rate > 0.0 and self._draw(step, 1) < self.kill_rate)
        if kill and step not in self._fired_kills:
            self._fired_kills.add(step)
            raise InjectedTrainerDeath(
                f"injected trainer death at step {step}")

    def grad_inject(self, step: int) -> float:
        """The value the trainer adds to every gradient this step: 0.0
        normally, ``bad_value`` on poisoned steps."""
        if step in self.bad_steps:
            return self.bad_value
        if self.bad_rate > 0.0 and self._draw(step, 2) < self.bad_rate:
            return self.bad_value
        return 0.0

    def save_hook(self, ck_id: int) -> Callable[[str], None]:
        """The ``commit_hook`` for checkpoint ``ck_id``: raises the
        scheduled :class:`InjectedTrainerDeath` just before the chosen
        commit phase, once.  On the async path the death lands on the
        writer thread, is recorded by the AsyncCheckpointer, and
        re-raises on the trainer's next durability wait — exactly the
        delayed failure surface a real lost writer has."""
        def hook(phase: str) -> None:
            if self.kill_save_at.get(ck_id) == phase \
                    and ck_id not in self._fired_saves:
                self._fired_saves.add(ck_id)
                raise InjectedTrainerDeath(
                    f"injected death during save of checkpoint {ck_id} "
                    f"(before {phase} commit)")

        return hook
