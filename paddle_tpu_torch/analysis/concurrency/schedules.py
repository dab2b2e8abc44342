"""SCHED-AUDIT: the schedule-permutation model checker (the port of
``paddle_tpu/analysis/concurrency/schedules.py``, driving the port's
``FleetRouter`` through its ``schedule_hook``).

The fleet's ``step()`` declares a permutable mid-tick section (lease
sweep / autoscale / WFQ drain / migration pump, then per-replica step
order) and CLAIMS those orderings are commutable with respect to every
terminal outcome: request statuses, exactly-once token streams, and the
conservation ledgers.  This module holds the runtime to that claim by
replaying small seeded chaos drives — replica kill + heartbeat
partition, migration drop + kill, tenant storm + autoscale, host-tier
spill + kill + warm restart — under systematically permuted intra-tick
schedules and comparing a canonical terminal fingerprint byte-for-byte.

Exploration is bounded DFS with a partial-order reduction: a canonical
run first records which ordering points are HOT (two or more phases
with actual work, or two or more replicas with work — permuting
anything else is the identity), then single-tick permutations of hot
points run first, then depth-2 combinations, up to
``FLAGS.conc_audit_max_schedules`` per drive.  Every divergence is
reproducible from its finding: the message names the minimal schedule
delta (tick, ordering-point kind, permutation), and the divergent
schedule is replayed once more under a real tracer so the flight
recorder lands an ``OBS-POSTMORTEM`` dump.

The fingerprint is deliberately the OUTCOME, not the trajectory:
per-frid (terminal status, emitted count, result tokens) plus the
duplicate-completion count.  Tick counts, migration apply-vs-fallback
tallies, and autoscale action counts legitimately vary with intra-tick
order; terminal results must not.

The drives' engines run on ``cuda`` unless the caller passes
``device="cpu"``; every engine step launches the ragged paged-attention
kernel there.  The tiny model's weights are a seeded numpy draw
(``convert.init_numpy_params``).  An eager engine compiles nothing, so
the JAX package's persistent compile cache has no counterpart.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.flags import FLAGS

__all__ = [
    "FleetDrive", "ToyOrderDrive", "default_drives", "explore_drive",
    "run_schedule_audit", "MIN_SCHEDULES_PER_DRIVE",
]

# the documented coverage bar: a clean audit must have explored at
# least this many distinct schedules per chaos drive (budget allowing)
MIN_SCHEDULES_PER_DRIVE = 50

# (kind, tick) -> permuted name order
_Delta = Dict[Tuple[str, int], Tuple]


# ---------------------------------------------------------------------------
# tiny shared model (one a device, shared by every drive and replay)
# ---------------------------------------------------------------------------

_MODELS: Dict[str, object] = {}


def _model(device: DeviceLike = None):
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.serving import DecoderLM

    dev = resolve_device(device)
    if str(dev) not in _MODELS:
        model = DecoderLM(vocab_size=32, num_layers=1, num_heads=2,
                          head_dim=4, max_positions=64, device=dev)
        convert.decoder_lm_from_numpy(
            convert.init_numpy_params(model, seed=0), model)
        _MODELS[str(dev)] = model
    return _MODELS[str(dev)]


def _make_engine(time_fn, device: DeviceLike = None, **kw):
    from paddle_tpu_torch.serving import ServingEngine

    base = dict(eos_id=1, page_size=4, num_pages=32, max_pages_per_seq=8,
                max_slots=2, buckets=(4, 8))
    base.update(kw)
    return ServingEngine(_model(device), time_fn=time_fn, device=device,
                         **base)


def _prompts(seed: int, n: int, shared: int = 0, lo: int = 4, hi: int = 7):
    import numpy as np

    rng = np.random.RandomState(seed)
    sysp = rng.randint(2, 32, size=shared).tolist() if shared else []
    return [sysp + rng.randint(2, 32, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


# ---------------------------------------------------------------------------
# drives
# ---------------------------------------------------------------------------


class FleetDrive:
    """One seeded chaos scenario with explorer hooks.

    ``build(tracer)`` returns a fresh :class:`FleetRouter`;
    ``arrivals(tick, fl)`` injects that tick's submissions/actions
    (called BEFORE the tick steps, outside the permutable section, so
    arrivals are schedule-invariant by construction).  Replays are full
    re-executions from a fresh router — the model is the only state
    shared between schedules.
    """

    def __init__(self, name: str,
                 build: Callable[[Optional[object]], object],
                 arrivals: Callable[[int, object], None],
                 max_ticks: int = 300,
                 extra_checks: Optional[Callable[[object], None]] = None):
        self.name = name
        self._build = build
        self._arrivals = arrivals
        self.max_ticks = max_ticks
        self._extra_checks = extra_checks

    # -- execution ---------------------------------------------------------

    def _execute(self, hook=None, tracer=None):
        from paddle_tpu_torch.platform.enforce import enforce_that

        fl = self._build(tracer)
        if hook is not None:
            fl.schedule_hook = lambda t, k, names: hook(fl, t, k, names)
        tick = 0
        while True:
            self._arrivals(tick, fl)
            if not fl.has_work and tick > 0:
                break
            fl.step()
            tick += 1
            enforce_that(tick < self.max_ticks,
                         f"SCHED-AUDIT drive {self.name} failed to drain "
                         f"within {self.max_ticks} ticks",
                         context="analysis")
        fl.check_fleet_conservation()
        if self._extra_checks is not None:
            self._extra_checks(fl)
        return fl

    def _fingerprint(self, fl) -> bytes:
        rows = []
        # enumerate in frid order but fingerprint the POSITION: fleet
        # rids come from a process-global counter, so the raw numbers
        # differ between replays while submission order is identical
        for pos, frid in enumerate(sorted(fl._requests)):
            freq = fl._requests[frid]
            rows.append((pos, str(freq.status), freq.emitted,
                         tuple(freq.result) if freq.result is not None
                         else None))
        return repr((rows, fl.metrics.duplicate_completions)).encode()

    # -- hotness (the partial-order reduction) -----------------------------

    @staticmethod
    def _hot(fl, kind: str, names: Sequence) -> bool:
        from paddle_tpu_torch.serving import ReplicaState

        if kind == "phases":
            active = 0
            if any(r.state in (ReplicaState.JOINING, ReplicaState.DRAINING)
                   for r in fl.replicas):
                active += 1                         # lease sweep acts
            if fl.autoscaler is not None:
                active += 1                         # policy loop runs
            if fl.wfq is not None and len(fl.wfq):
                active += 1                         # WFQ has buffered work
            if any(fl._mig_queues.values()):
                active += 1                         # transfers pending
            return active >= 2
        # two or more live replicas and at least one with work: step
        # order then interleaves harvest/resubmit/retire against other
        # replicas' state (a lone live replica, or an all-idle tick,
        # makes every order the identity)
        live = [r for r in fl.replicas
                if r.state is not ReplicaState.DEAD]
        return len(live) >= 2 and any(r.engine.has_work for r in live)

    # -- explorer interface ------------------------------------------------

    def record(self):
        """Canonical run; returns (fingerprint, ordered hot sites)."""
        sites: List[Tuple[str, int, Tuple]] = []

        def hook(fl, tick, kind, names):
            if self._hot(fl, kind, names):
                sites.append((kind, tick, tuple(names)))
            return names

        fl = self._execute(hook)
        return self._fingerprint(fl), sites

    def replay(self, deltas: _Delta, tracer=None) -> bytes:
        def hook(fl, tick, kind, names):
            want = deltas.get((kind, tick))
            if want is not None and list(want) != list(names) and \
                    sorted(map(repr, want)) == sorted(map(repr, names)):
                return list(want)
            return names

        return self._fingerprint(self._execute(hook, tracer=tracer))

    def postmortem(self, deltas: _Delta, reason: str) -> None:
        """Replay the divergent schedule under a real tracer and dump
        the flight recorder (prints the OBS-POSTMORTEM line)."""
        from paddle_tpu_torch.obs.trace import Tracer

        tracer = Tracer()
        try:
            self.replay(deltas, tracer=tracer)
        except Exception:
            pass                       # the dump is the point
        tracer.dump_postmortem(reason)


class ToyOrderDrive:
    """Deliberately order-SENSITIVE drive for the auditor's own tests:
    two phases, increment and double, whose composition does not
    commute.  The explorer must catch it on the first permuted
    schedule and name the minimal delta."""

    name = "toy_order_sensitive"

    def __init__(self, ticks: int = 3, commuting: bool = False):
        self.ticks = ticks
        # commuting=True turns both phases into increments — the clean
        # twin, for pinning the no-findings path without a fleet
        self.commuting = commuting

    def _execute(self, hook=None, tracer=None) -> int:
        x = 1
        for tick in range(self.ticks):
            names = ["inc", "dbl"]
            order = names if hook is None else hook(None, tick, "phases",
                                                    names)
            for phase in order:
                if phase == "inc" or self.commuting:
                    x += 1
                else:
                    x *= 2
        return x

    def record(self):
        sites = [("phases", t, ("inc", "dbl")) for t in range(self.ticks)]
        return repr(self._execute()).encode(), sites

    def replay(self, deltas: _Delta, tracer=None) -> bytes:
        def hook(_fl, tick, kind, names):
            want = deltas.get((kind, tick))
            return list(want) if want is not None else names

        return repr(self._execute(hook)).encode()

    def postmortem(self, deltas: _Delta, reason: str) -> None:
        return None                    # nothing to dump for the toy


# ---------------------------------------------------------------------------
# the four scaled-down chaos drives
# ---------------------------------------------------------------------------


def _drive_fleet_kill_partition(device: DeviceLike = None) -> FleetDrive:
    """Replica kill + heartbeat partition on a 3-replica unified fleet:
    one replica is killed outright, a second is partitioned past its
    lease TTL (zombie-fenced), and every request must still reach one
    terminal with its exactly-once stream intact."""

    def build(tracer=None):
        from paddle_tpu_torch.serving import (FleetFaultPlan, FleetRouter,
                                        ManualClock)

        plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                              kill_at={5: 0}, partitions={1: (3, 60)})
        return FleetRouter(lambda i, tf: _make_engine(tf, device), 3,
                           heartbeat_s=0.05, resubmit_budget=3,
                           faults=plan, tracer=tracer)

    prompts = _prompts(seed=1, n=6)

    def arrivals(tick, fl):
        if tick == 0:
            for p in prompts[:4]:
                fl.submit(p, max_tokens=3)
        elif tick == 2:
            for p in prompts[4:]:
                fl.submit(p, max_tokens=3)

    return FleetDrive("fleet_kill_partition", build, arrivals)


def _drive_migration_drop_kill(device: DeviceLike = None) -> FleetDrive:
    """Disaggregated prefill/decode fleet: chain handoffs with one blob
    dropped in flight (re-prefill fallback) and one decode replica
    killed mid-stream (death resubmit) — the migration ledger must
    balance under every schedule."""

    def build(tracer=None):
        from paddle_tpu_torch.serving import (FleetFaultPlan, FleetRouter,
                                        ManualClock)

        plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                              drop_migration_at={1}, kill_at={8: 2})
        return FleetRouter(lambda i, tf: _make_engine(tf, device), 3,
                           roles=["prefill", "decode", "decode"],
                           heartbeat_s=0.05, resubmit_budget=3,
                           migrate_budget=8, faults=plan, tracer=tracer)

    prompts = _prompts(seed=2, n=5, shared=8)

    def arrivals(tick, fl):
        if tick == 0:
            for p in prompts:
                fl.submit(p, max_tokens=3)

    return FleetDrive("migration_drop_kill", build, arrivals)


def _drive_control_storm_autoscale(device: DeviceLike = None) -> FleetDrive:
    """Tenant storm through the WFQ with the autoscaler live: a batch
    tenant floods a 1-replica fleet, the policy loop scales up and back
    down, and weighted-fair release order must not leak into terminal
    results."""

    def build(tracer=None):
        from paddle_tpu_torch.serving import (FleetFaultPlan, FleetRouter,
                                        ManualClock)
        from paddle_tpu_torch.serving.control import (AutoscalePolicy,
                                                TenantRegistry)

        reg = TenantRegistry()
        reg.register("storm", "batch")
        reg.register("fg", "batch")
        plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01))
        return FleetRouter(
            lambda i, tf: _make_engine(tf, device), 1, heartbeat_s=0.05,
            resubmit_budget=2, faults=plan, tenants=reg, wfq=True,
            autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2,
                                      buffered_hi=2, cooldown_ticks=2),
            tracer=tracer)

    storm = _prompts(seed=3, n=9, lo=5, hi=8)
    fg = _prompts(seed=4, n=2)

    def arrivals(tick, fl):
        if tick in (0, 2, 4):
            for p in storm[tick // 2 * 3:tick // 2 * 3 + 3]:
                fl.submit(p, max_tokens=2, tenant="storm")
        if tick == 1:
            for p in fg:
                fl.submit(p, max_tokens=2, tenant="fg")

    def extra(fl):
        from paddle_tpu_torch.serving.control import check_control_conservation

        check_control_conservation(fl)

    return FleetDrive("control_storm_autoscale", build, arrivals,
                      extra_checks=extra)


def _drive_hosttier_kill_restart(device: DeviceLike = None) -> FleetDrive:
    """Host-RAM spill tier under pressure: a small device pool forces
    spills, one replica is killed and later warm-restarted (its host
    tier re-adopted, checksum-verified), and late arrivals ride the
    restored cache — page conservation must hold across the restart
    under every schedule."""

    state = {"restarted": False}

    def build(tracer=None):
        from paddle_tpu_torch.serving import (FleetFaultPlan, FleetRouter,
                                        ManualClock)

        state["restarted"] = False
        plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                              kill_at={4: 0})
        return FleetRouter(
            lambda i, tf: _make_engine(tf, device, num_pages=16,
                                       host_tier_bytes=1 << 20,
                                       swap_in_budget=4),
            2, heartbeat_s=0.05, resubmit_budget=3, faults=plan,
            routing="round_robin", tracer=tracer)

    prompts = _prompts(seed=5, n=12, shared=8, lo=4, hi=6)

    # Arrival waves are dense enough that the fleet never drains before
    # the warm restart: _execute() stops as soon as has_work goes False,
    # so a gap in arrivals would end the drive early and the restart
    # window (and its JOINING+READY overlap, the interesting hot ticks)
    # would never be explored.
    waves = {0: prompts[:4], 3: prompts[4:6], 5: prompts[6:8],
             7: prompts[8:10], 9: prompts[10:]}

    def arrivals(tick, fl):
        from paddle_tpu_torch.serving import ReplicaState

        for p in waves.get(tick, ()):
            fl.submit(p, max_tokens=5)
        if tick == 5 and not state["restarted"] and \
                fl.replicas[0].state is ReplicaState.DEAD:
            fl.restart_replica(0)
            state["restarted"] = True

    return FleetDrive("hosttier_kill_restart", build, arrivals)


def default_drives(device: DeviceLike = None) -> List[FleetDrive]:
    return [_drive_fleet_kill_partition(device),
            _drive_migration_drop_kill(device),
            _drive_control_storm_autoscale(device),
            _drive_hosttier_kill_restart(device)]


# ---------------------------------------------------------------------------
# the explorer
# ---------------------------------------------------------------------------


def _site_perms(names: Tuple, cap: int = 5) -> List[Tuple]:
    """Non-canonical permutations of one ordering point, deterministic
    (lexicographic) order, capped so replica-rich fleets don't explode
    one site into hundreds of schedules."""
    out = [p for p in itertools.permutations(names) if p != tuple(names)]
    return out[:cap]


def enumerate_schedules(sites: List[Tuple[str, int, Tuple]],
                        budget: int) -> List[_Delta]:
    """Single-tick deltas over every hot site first (breadth), then
    depth-2 combinations (site-pair, first permutation each) — bounded
    DFS order, deterministic, truncated at ``budget``."""
    singles: List[Tuple[Tuple[str, int], Tuple]] = []
    for kind, tick, names in sites:
        for p in _site_perms(names):
            singles.append(((kind, tick), p))
    schedules: List[_Delta] = [{key: p} for key, p in singles]
    if len(schedules) < budget:
        for (k1, p1), (k2, p2) in itertools.combinations(singles, 2):
            if k1 == k2:
                continue              # one order per ordering point
            schedules.append({k1: p1, k2: p2})
            if len(schedules) >= budget:
                break
    return schedules[:budget]


def _fmt_delta(deltas: _Delta) -> str:
    parts = [f"tick {tick} {kind} order {list(order)!r}"
             for (kind, tick), order in sorted(deltas.items())]
    return "; ".join(parts)


def explore_drive(drive, budget: Optional[int] = None,
                  max_findings: int = 3) -> Tuple[int, List[Diagnostic]]:
    """Explore one drive's schedule space; returns (schedules explored,
    diagnostics).  A fingerprint mismatch or a replay crash (a
    conservation ledger raising under a permuted schedule) is an ERROR
    finding naming the minimal schedule delta; exploration continues —
    capped at ``max_findings`` — so one divergence doesn't mask an
    independent one at another site."""
    if budget is None:
        budget = int(FLAGS.conc_audit_max_schedules)
    diags: List[Diagnostic] = []
    base_fp, sites = drive.record()
    explored = 0
    for deltas in enumerate_schedules(sites, budget):
        delta_s = _fmt_delta(deltas)
        try:
            fp = drive.replay(deltas)
        except Exception as e:
            explored += 1
            diags.append(Diagnostic(
                Severity.ERROR, "SCHED-AUDIT",
                f"drive {drive.name}: replay crashed under permuted "
                f"schedule [{delta_s}]: {type(e).__name__}: {e} — the "
                "permuted order broke an invariant the canonical order "
                "upholds"))
            if len(diags) >= max_findings:
                break
            continue
        explored += 1
        if fp != base_fp:
            diags.append(Diagnostic(
                Severity.ERROR, "SCHED-AUDIT",
                f"drive {drive.name}: terminal fingerprint diverged "
                f"under permuted schedule [{delta_s}] — minimal "
                "schedule prefix; statuses, streams, or ledgers are "
                "order-sensitive where step() declares them commutable"))
            drive.postmortem(deltas,
                             f"SCHED-AUDIT divergence: {drive.name} "
                             f"[{delta_s}]")
            if len(diags) >= max_findings:
                break
    if not diags and explored < min(MIN_SCHEDULES_PER_DRIVE, budget):
        diags.append(Diagnostic(
            Severity.WARNING, "SCHED-AUDIT",
            f"drive {drive.name}: only {explored} schedules explored "
            f"(coverage bar is {MIN_SCHEDULES_PER_DRIVE}, budget "
            f"{budget}) — the drive has too few hot ordering points to "
            "meaningfully audit; widen it"))
    return explored, diags


def run_schedule_audit(runtime_only: bool = False,
                       device: DeviceLike = None) -> List[Diagnostic]:
    """Drive the chaos scenarios and return SCHED-AUDIT diagnostics
    (plus PROTO-AUDIT runtime-transition findings — the recorder is
    reset first and every drive feeds it through the fleet's
    instrumented transition sites).  ``runtime_only`` skips the
    permutation exploration and runs each drive once canonically — the
    cheap path when only rule ``transition-runtime`` is selected.  The
    drives run on ``cuda`` unless ``device="cpu"``."""
    from paddle_tpu_torch.analysis.concurrency.lifecycle import (
        reset_recorder, runtime_diagnostics)

    reset_recorder()
    diags: List[Diagnostic] = []
    for drive in default_drives(device):
        if runtime_only:
            drive.record()
        else:
            _, found = explore_drive(drive)
            diags.extend(found)
    diags.extend(runtime_diagnostics())
    return diags
