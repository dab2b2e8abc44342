"""Declared lifecycle state machines — the ``PROTO-AUDIT`` rule family
(the port of ``paddle_tpu/analysis/concurrency/lifecycle.py``, pure
Python, pointed at the port's source paths).

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

Statically, :func:`run_static_check` extracts every literal
status/phase assignment site (``x.status = RequestStatus.X``,
``rep.state = ReplicaState.Y``, the ``metrics.on_migration_*`` ledger
markers, the ``ckpt.snapshot/write/prune`` phase chain) and flags any
site whose state is not in the tables, plus drift between the
scheduler's ``_TERMINAL`` frozenset / the ``ReplicaState`` enum and the
declared tables, so the tables cannot silently rot.
:func:`runtime_diagnostics` turns the recorder's undeclared edges into
findings.  All findings carry the grep-able ``PROTO-AUDIT`` code.
"""

from __future__ import annotations

import ast
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

__all__ = ["StateMachineSpec", "MACHINES", "TransitionRecorder",
           "recorder", "record_transition", "undeclared_transitions",
           "reset_recorder", "run_static_check", "runtime_diagnostics"]


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


# ---------------------------------------------------------------------------
# static: assignment-site extraction probes
# ---------------------------------------------------------------------------


def _pkg_root() -> Path:
    return Path(__file__).resolve().parent.parent.parent


def _read_sources(rel_paths: Sequence[str],
                  sources: Optional[Dict[str, str]]) -> Dict[str, str]:
    """{package-relative path: source}; ``sources`` overrides disk (the
    seeded-bad tests feed doctored modules through here)."""
    if sources is not None:
        return dict(sources)
    root = _pkg_root().parent
    return {p: (root / p).read_text() for p in rel_paths}


def _enum_assign_sites(tree: ast.Module, attr: str,
                       enum_name: str) -> List[Tuple[int, str]]:
    """(line, MEMBER) for every ``<x>.<attr> = <enum_name>.<MEMBER>``
    assignment — plus dataclass defaults ``<attr>: T = <enum>.<M>``."""
    out: List[Tuple[int, str]] = []

    def _value_member(value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Attribute) and \
                isinstance(value.value, ast.Name) and \
                value.value.id == enum_name:
            return value.attr
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            member = _value_member(node.value)
            if member is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == attr:
                    out.append((node.lineno, member))
                elif isinstance(t, ast.Tuple):
                    for el in t.elts:
                        if isinstance(el, ast.Attribute) and \
                                el.attr == attr:
                            out.append((node.lineno, member))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            member = _value_member(node.value)
            if member is not None and \
                    isinstance(node.target, ast.Name) and \
                    node.target.id == attr:
                out.append((node.lineno, member))
    return out


def _frozenset_members(tree: ast.Module, name: str,
                       enum_name: str) -> Optional[List[str]]:
    """Members of ``NAME = frozenset({Enum.A, Enum.B, ...})``."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets)):
            continue
        call = node.value
        if not (isinstance(call, ast.Call) and
                isinstance(call.func, ast.Name) and
                call.func.id == "frozenset" and call.args):
            continue
        members: List[str] = []
        for el in ast.walk(call.args[0]):
            if isinstance(el, ast.Attribute) and \
                    isinstance(el.value, ast.Name) and \
                    el.value.id == enum_name:
                members.append(el.attr)
        return members
    return None


def _enum_class_members(tree: ast.Module,
                        cls_name: str) -> Optional[List[str]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            members = []
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and \
                        isinstance(stmt.value, ast.Constant) and \
                        isinstance(stmt.value.value, str):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            members.append(stmt.value.value)
            return members
    return None


def _diag(msg: str, where: str) -> Diagnostic:
    return Diagnostic(Severity.ERROR, "PROTO-AUDIT", msg, vars=(where,))


def _check_request_status(sources: Optional[Dict[str, str]]) -> List[Diagnostic]:
    spec = REQUEST_STATUS
    paths = ("paddle_tpu_torch/serving/scheduler.py",
             "paddle_tpu_torch/serving/engine.py",
             "paddle_tpu_torch/serving/fleet.py")
    srcs = _read_sources(paths, sources)
    out: List[Diagnostic] = []
    declared = {s.upper() for s in spec.states}
    for path, src in srcs.items():
        tree = ast.parse(src, filename=path)
        for lineno, member in _enum_assign_sites(tree, "status",
                                                 "RequestStatus"):
            if member not in declared:
                out.append(_diag(
                    f"{path}:{lineno}: assignment site uses undeclared "
                    f"request status RequestStatus.{member} — declare "
                    "it in the request_status StateMachineSpec or drop "
                    "the state", f"{path}:{lineno}"))
        terms = _frozenset_members(tree, "_TERMINAL", "RequestStatus")
        if terms is not None:
            got = {t.lower() for t in terms}
            if got != set(spec.terminal):
                out.append(_diag(
                    f"{path}: scheduler _TERMINAL {sorted(got)} drifted "
                    f"from the declared terminal set "
                    f"{sorted(spec.terminal)}", path))
    return out


def _check_replica_lifecycle(sources: Optional[Dict[str, str]]) -> List[Diagnostic]:
    spec = REPLICA_LIFECYCLE
    path = "paddle_tpu_torch/serving/fleet.py"
    src = _read_sources((path,), sources)[path]
    tree = ast.parse(src, filename=path)
    out: List[Diagnostic] = []
    declared = {s.upper() for s in spec.states}
    for lineno, member in _enum_assign_sites(tree, "state",
                                             "ReplicaState"):
        if member not in declared:
            out.append(_diag(
                f"{path}:{lineno}: assignment site uses undeclared "
                f"replica state ReplicaState.{member} — declare it in "
                "the replica_lifecycle StateMachineSpec",
                f"{path}:{lineno}"))
    members = _enum_class_members(tree, "ReplicaState")
    if members is not None and set(members) != set(spec.states):
        out.append(_diag(
            f"{path}: ReplicaState enum {sorted(members)} drifted from "
            f"the declared state set {sorted(spec.states)}", path))
    return out


_MIGRATION_MARKERS = {
    "applied": "on_migration_applied",
    "fallback": "on_migration_fallback",
    "aborted": "on_migration_aborted",
}


def _check_migration_transfer(sources: Optional[Dict[str, str]]) -> List[Diagnostic]:
    spec = MIGRATION_TRANSFER
    path = "paddle_tpu_torch/serving/fleet.py"
    src = _read_sources((path,), sources)[path]
    tree = ast.parse(src, filename=path)
    calls: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr.startswith("on_migration_"):
            calls[node.func.attr] = calls.get(node.func.attr, 0) + 1
    out: List[Diagnostic] = []
    if "on_migration_start" not in calls:
        out.append(_diag(
            f"{path}: no on_migration_start ledger marker — the "
            "migration_transfer machine has no entry site", path))
    for state in sorted(spec.terminal):
        marker = _MIGRATION_MARKERS[state]
        if marker not in calls:
            out.append(_diag(
                f"{path}: declared migration terminal '{state}' has no "
                f"{marker}() ledger site — the conservation identity "
                "cannot balance", path))
    # on_migration_resubmit counts cross-replica prefix RE-SEEDING for a
    # resubmitted request — a cache-warmth event, not a transfer-state
    # transition — so it is exempt rather than declared
    known = {"on_migration_start", "on_migration_resubmit"} \
        | set(_MIGRATION_MARKERS.values())
    for marker in sorted(set(calls) - known):
        out.append(_diag(
            f"{path}: ledger marker {marker}() has no state in the "
            "migration_transfer StateMachineSpec — declare it", path))
    return out


_CKPT_PHASE_MARKERS = (("snapshot", "snapshot_checkpoint"),
                       ("write", "write_checkpoint"),
                       ("prune", "prune_checkpoints"))


def _check_checkpoint_commit(sources: Optional[Dict[str, str]]) -> List[Diagnostic]:
    path = "paddle_tpu_torch/resilience/checkpointer.py"
    src = _read_sources((path,), sources)[path]
    tree = ast.parse(src, filename=path)
    first_line: Dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            name = node.func.attr
            if any(name == marker for _, marker in _CKPT_PHASE_MARKERS):
                first_line.setdefault(name, node.lineno)
    out: List[Diagnostic] = []
    prev = 0
    for phase, marker in _CKPT_PHASE_MARKERS:
        if marker not in first_line:
            out.append(_diag(
                f"{path}: checkpoint phase '{phase}' has no "
                f"ckpt.{marker}() site — the commit chain is broken",
                path))
            continue
        if first_line[marker] < prev:
            out.append(_diag(
                f"{path}:{first_line[marker]}: ckpt.{marker}() appears "
                f"before the preceding phase's marker — the declared "
                "phase order snapshot->write->prune is violated",
                f"{path}:{first_line[marker]}"))
        prev = first_line[marker]
    return out


def run_static_check(sources: Optional[Dict[str, str]] = None) -> List[Diagnostic]:
    """All four machines' static probes.  ``sources`` (path -> source)
    overrides disk for the probed files — the seeded-bad tests use it."""
    out: List[Diagnostic] = []
    out.extend(_check_request_status(sources))
    out.extend(_check_replica_lifecycle(sources))
    out.extend(_check_migration_transfer(sources))
    out.extend(_check_checkpoint_commit(sources))
    out.sort(key=lambda d: d.message)
    return out


def runtime_diagnostics() -> List[Diagnostic]:
    """PROTO-AUDIT findings for every undeclared edge the recorder has
    seen since the last reset (the dynamic half of the rule)."""
    out: List[Diagnostic] = []
    seen = set()
    for machine, src, dst in _RECORDER.undeclared():
        key = (machine, src, dst)
        if key in seen:
            continue
        seen.add(key)
        out.append(Diagnostic(
            Severity.ERROR, "PROTO-AUDIT",
            f"runtime transition {machine}: {src} -> {dst} is not in "
            "the declared StateMachineSpec — declare the edge or fix "
            "the transition site", vars=(machine,)))
    return out
