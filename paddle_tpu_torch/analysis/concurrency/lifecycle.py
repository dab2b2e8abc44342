"""Declared lifecycle state machines and the runtime transition recorder
(the runtime half of ``paddle_tpu/analysis/concurrency/lifecycle.py``,
copied: it is pure Python).

The fleet's correctness arguments are phrased over small state machines
(a request reaches exactly one terminal status; a replica dies exactly
once; a migration resolves to exactly one of applied/fallback/aborted;
a checkpoint commits through a fixed phase chain).  This module declares
them as :class:`StateMachineSpec` tables, and the runtime calls
:func:`record_transition` at its transition choke points
(``FleetRouter._finish`` / ``_fence`` / ``_promote_joining`` / the
migration ledger).  The process-global :class:`TransitionRecorder`
counts every edge and flags undeclared ones: a drive that takes an edge
outside the tables surfaces it through :func:`undeclared_transitions`
and the ``lifecycle_transitions_total`` / ``lifecycle_undeclared_total``
counters on whichever obs registry the caller passes in.

Not ported yet: the static half (``run_static_check``, the AST pass that
checks every literal status assignment site against the tables), which
comes with the analysis slice (ROADMAP A13).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Tuple

__all__ = ["StateMachineSpec", "MACHINES", "TransitionRecorder",
           "recorder", "record_transition", "undeclared_transitions",
           "reset_recorder"]


@dataclass(frozen=True)
class StateMachineSpec:
    """One declared lifecycle machine: the full state set, the legal
    edge set, and where its literal assignment sites live."""

    name: str
    states: Tuple[str, ...]
    initial: str
    terminal: FrozenSet[str]
    edges: FrozenSet[Tuple[str, str]]
    doc: str = ""

    def legal(self, src: str, dst: str) -> bool:
        return (src, dst) in self.edges


_REQ_TERMINALS = ("completed", "timed_out", "cancelled", "rejected",
                  "failed")

REQUEST_STATUS = StateMachineSpec(
    name="request_status",
    states=("queued", "running", "preempted") + _REQ_TERMINALS,
    initial="queued",
    terminal=frozenset(_REQ_TERMINALS),
    edges=frozenset(
        # dispatch / engine-mirror progress
        [("queued", "running"), ("queued", "preempted"),
         ("running", "preempted"), ("preempted", "running"),
         # death-resubmit and migration-fallback re-dispatch loops
         ("running", "queued"), ("preempted", "queued")]
        # every live state may reach every terminal (shed, deadline,
        # cancel, kill-with-burned-budget, engine reject)
        + [(src, t) for src in ("queued", "running", "preempted")
           for t in _REQ_TERMINALS]),
    doc="fleet-level request lifecycle (mirrors the engine statuses; "
        "exactly one terminal transition per rid — _finish refuses a "
        "second one and counts it as duplicate_completions instead)")

REPLICA_LIFECYCLE = StateMachineSpec(
    name="replica_lifecycle",
    states=("joining", "ready", "draining", "dead"),
    initial="joining",
    terminal=frozenset({"dead"}),
    edges=frozenset([
        ("joining", "ready"),      # lease alive + healthz -> promoted
        ("joining", "draining"),   # drained before first promotion
        ("joining", "dead"),       # fenced before first promotion
        ("ready", "draining"),     # drain_replica / autoscaler
        ("ready", "dead"),         # kill / lease lapse -> _fence
        ("draining", "dead"),      # graceful retire, or fenced mid-drain
        ("dead", "joining"),       # restart_replica (warm restart)
    ]),
    doc="replica membership lifecycle (fence-then-reap on death; "
        "restart re-enters through JOINING, never straight to READY)")

MIGRATION_TRANSFER = StateMachineSpec(
    name="migration_transfer",
    states=("started", "applied", "fallback", "aborted"),
    initial="started",
    terminal=frozenset({"applied", "fallback", "aborted"}),
    edges=frozenset([
        ("started", "applied"),    # chain imported at the destination
        ("started", "fallback"),   # blob dropped in flight -> re-prefill
        ("started", "aborted"),    # stale / terminal rid / dest died
    ]),
    doc="chain-handoff ledger states; conservation requires "
        "started == applied + fallback + aborted at any full drain")

CHECKPOINT_COMMIT = StateMachineSpec(
    name="checkpoint_commit",
    states=("idle", "snapshot", "write", "commit", "prune", "failed"),
    initial="idle",
    terminal=frozenset(),          # the machine cycles back to idle
    edges=frozenset([
        ("idle", "snapshot"),      # save(): blocking device->host copy
        ("snapshot", "write"),     # writer thread takes the payload
        ("write", "commit"),       # tmp+rename+md5 landed, meta last
        ("commit", "prune"),       # keep-budget pruning (keep > 0)
        ("commit", "idle"),        # keep == 0: no prune pass
        ("prune", "idle"),
        ("write", "failed"),       # writer exception (injected death)
        ("failed", "idle"),        # error recorded; surfaces at wait()
    ]),
    doc="depth-one pipelined checkpoint phases (commit order == submit "
        "order; a failed write leaves the previous checkpoint latest)")

MACHINES: Dict[str, StateMachineSpec] = {
    m.name: m for m in (REQUEST_STATUS, REPLICA_LIFECYCLE,
                        MIGRATION_TRANSFER, CHECKPOINT_COMMIT)}


# ---------------------------------------------------------------------------
# dynamic: the transition recorder
# ---------------------------------------------------------------------------


class TransitionRecorder:
    """Process-global transition counter.

    Stateless with respect to the *instances* being tracked: call sites
    pass explicit ``(src, dst)`` pairs, so any number of routers,
    engines and checkpointers share one recorder without confusing each
    other's machines.  Thread-safe because the checkpoint writer thread
    records from off the training thread.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str, str], int] = {}  # guarded_by(_lock)
        self._undeclared: List[Tuple[str, str, str]] = []   # guarded_by(_lock)

    def record(self, machine: str, src, dst, registry=None) -> bool:
        """Count one ``src -> dst`` edge; returns True when the edge is
        declared.  Self-loops (mirror refreshes) are ignored.  Unknown
        machine names are themselves undeclared edges."""
        src_s, dst_s = str(src), str(dst)
        if src_s == dst_s:
            return True
        spec = MACHINES.get(machine)
        ok = spec is not None and spec.legal(src_s, dst_s)
        with self._lock:
            key = (machine, src_s, dst_s)
            self._counts[key] = self._counts.get(key, 0) + 1
            if not ok:
                self._undeclared.append(key)
        if registry is not None:
            registry.counter(
                "lifecycle_transitions_total",
                "declared-state-machine edges taken at runtime").labels(
                    machine=machine, src=src_s, dst=dst_s).inc()
            if not ok:
                registry.counter(
                    "lifecycle_undeclared_total",
                    "transitions outside the declared tables "
                    "(PROTO-AUDIT)").labels(machine=machine).inc()
        return ok

    def counts(self) -> Dict[Tuple[str, str, str], int]:
        with self._lock:
            return dict(self._counts)

    def undeclared(self) -> List[Tuple[str, str, str]]:
        with self._lock:
            return list(self._undeclared)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._undeclared.clear()


_RECORDER = TransitionRecorder()


def recorder() -> TransitionRecorder:
    return _RECORDER


def record_transition(machine: str, src, dst, registry=None) -> bool:
    """The runtime hook: one line at each transition choke point."""
    return _RECORDER.record(machine, src, dst, registry=registry)


def undeclared_transitions() -> List[Tuple[str, str, str]]:
    return _RECORDER.undeclared()


def reset_recorder() -> None:
    _RECORDER.reset()
