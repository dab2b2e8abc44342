"""Bad-step guards: the step policy that keeps one NaN gradient from
poisoning optimizer slots forever (the port of
``paddle_tpu/resilience/guard.py``).

After the backward, ``trainer.SGD`` (when a :class:`BadStepGuard` is set)
adds the fault plan's poison to the gradients and screens them with ONE
global f32 sum of squares (:func:`screen_grads`): ``good`` means
all-finite, and under ``max_norm`` when set.

The JAX step is one jitted program: it runs the update either way and
selects every params / slot / model-state leaf, the step counter
included, back to its old value on a bad step, with the verdict kept on
the device.  The port updates its tensors in place, so it reads the
verdict to the host ONCE a step (counted in the trainer's
``verdict_reads``) and, on a bad step, never runs the update: params, slots
and the optimizer's step counter (Adam's bias correction, the learning
rate schedule and the dropout seed read it) stay as they were, and the
step's model state is dropped (:func:`select_good` with a host verdict).
That costs one wait for the card a guarded step; it needs no pre-step
copy of the weights and slots, which a device-side select would.

Policy ladder:

- ``"skip"`` — never apply a bad step; count it (the per-step floor
  every policy includes);
- ``"rollback"`` — additionally, ``rollback_after`` CONSECUTIVE bad
  steps raise :class:`~paddle_tpu_torch.resilience.faults.BadStepRollback`
  after dumping a flight-recorder postmortem: persistent badness means
  the inputs or state are wrong and the run must restart from its last
  verified checkpoint (the resume supervisor does exactly that).  The
  check runs every ``check_every`` steps (default: ``rollback_after``),
  at the steps where the JAX package reads its device counter back.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["BadStepGuard", "screen_grads", "select_good", "guard_init",
           "guard_outputs"]


@dataclass(frozen=True)
class BadStepGuard:
    """Configuration for the bad-step guard.

    - ``policy``: ``"skip"`` or ``"rollback"`` (the ladder above);
    - ``max_norm``: global grad-norm ceiling — a FINITE step whose norm
      exceeds it is also treated bad (0 = finiteness check only);
    - ``rollback_after``: K consecutive bad steps trigger the rollback
      (policy ``"rollback"`` only);
    - ``check_every``: cadence of the rollback check, in steps
      (0 = ``rollback_after``).
    """

    policy: str = "skip"
    max_norm: float = 0.0
    rollback_after: int = 3
    check_every: int = 0

    def __post_init__(self):
        if self.policy not in ("skip", "rollback"):
            raise ValueError(f"BadStepGuard.policy must be 'skip' or "
                             f"'rollback', got {self.policy!r}")
        if self.policy == "rollback" and self.rollback_after < 1:
            # 0 would make `consec >= rollback_after` true on a healthy
            # step: every cadence check rolls back a perfectly good run
            raise ValueError("BadStepGuard.rollback_after must be >= 1, "
                             f"got {self.rollback_after}")

    @property
    def cadence(self) -> int:
        return max(1, int(self.check_every or self.rollback_after))


def guard_init():
    """Fresh guard state: ``inject`` is re-stamped by the trainer from the
    fault plan every step (0.0 outside injection windows); the counters
    are host ints that :func:`guard_outputs` advances."""
    return {"inject": 0.0, "bad_consec": 0, "bad_total": 0}


def screen_grads(grads, inject: float, max_norm: float):
    """Poison + screen the gradient dict (name -> tensor or None, None
    meaning a parameter the cost does not reach).

    Adds ``inject`` (0.0 = no-op, and then no pass over the gradients;
    NaN/Inf = an injected bad step) to every gradient, then computes ONE
    global f32 sum of squares and the ``good`` verdict, a 0-d bool tensor
    on the gradients' device: all-finite, and under ``max_norm`` when
    set.  Returns ``(grads, good, sq_norm)`` without waiting for the
    card."""
    if inject != 0.0:
        grads = {k: None if g is None else g + inject
                 for k, g in grads.items()}
    live = [g for g in grads.values() if g is not None]
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                         for g in live])
    sq = torch.sum(torch.square(norms))
    good = torch.isfinite(sq)
    if max_norm > 0.0:
        good = torch.logical_and(
            good, sq <= torch.tensor(max_norm, dtype=torch.float32) ** 2)
    return grads, good, sq


def select_good(good, new_tree, old_tree):
    """Per-leaf ``where(good, new, old)`` over matching trees of dicts,
    tensors and host numbers — the skip-step select.  ``good`` is a host
    bool (the trainer's case: the chosen tree itself comes back) or a 0-d
    bool tensor (``torch.where`` per tensor leaf)."""
    if isinstance(good, bool):
        return new_tree if good else old_tree
    if isinstance(new_tree, dict):
        return {k: select_good(good, new_tree[k], old_tree[k])
                for k in new_tree}
    if isinstance(new_tree, torch.Tensor):
        return torch.where(good, new_tree, old_tree)
    return new_tree if bool(good) else old_tree


def guard_outputs(good: bool, guard_state):
    """Next guard counters — consecutive resets on a good step, total
    accumulates."""
    return {"bad_consec": 0 if good else guard_state["bad_consec"] + 1,
            "bad_total": guard_state["bad_total"] + (0 if good else 1)}
