"""Failure types and the injectable clock of the serving engine (the
part of ``paddle_tpu/serving/faults.py`` this slice needs; the seeded
``FaultPlan`` is not ported yet)."""

from __future__ import annotations

__all__ = ["InjectedDeviceError", "ManualClock", "PageLeakError"]


class InjectedDeviceError(RuntimeError):
    """A transient device failure, raised by the seeded fault plan before
    a step runs.  The plan and the engine's step retry that absorbs it come
    with a later slice; this slice's engine does not catch it."""


class PageLeakError(AssertionError):
    """Free-list conservation violated.  The message always contains the
    literal token ``PAGE-LEAK`` or ``REF-LEAK`` so CI logs can be grepped."""


class ManualClock:
    """A monotonic clock a test advances by hand; pass it as
    ``ServingEngine(time_fn=...)`` to drive deadlines deterministically."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)
