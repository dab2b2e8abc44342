"""Multi-tenant SLO control plane: the policy layer over the fleet's
mechanisms (a copy of ``paddle_tpu/serving/control.py``, which is pure
Python; only the imports and the gate's model differ).

Every mechanism this module governs already exists: drain/join
elasticity and lease-driven membership (fleet.py), deadlines /
shedding / preemption budgets (engine.py + scheduler.py), role-split
replicas with page migration (migrate.py), one Prometheus scrape
surface (obs.registry).  What was missing is POLICY — today one
tenant's prompt storm starves everyone and fleet size is fixed
forever.  Three pieces compose here:

- :class:`TenantRegistry` — SLO classes (interactive / standard /
  batch, overridable per tenant): latency-tier deadlines stamped at
  fleet submit, token-rate quotas enforced at admission via
  injected-clock token buckets, and preemption precedence so
  batch-class slots are victimized before interactive ones
  (``ContinuousBatchingScheduler.precedence_fn``).
- :class:`WeightedFairQueue` — per-tenant virtual-time queues ahead
  of dispatch, prompt-token-weighted service: an adversarial storm
  from one tenant backlogs only that tenant's queue while the others
  drain at their weighted share and keep their deadline SLO.
- :class:`Autoscaler` — a policy loop on the same injected clock that
  joins/drains replicas from registry signals (queue_wait_ms_p95,
  pages_in_use, deadline-miss delta, prefill_backlog_tokens) with
  hysteresis + cooldown; in disaggregated fleets the joined replica's
  role follows the dominant pressure (prefill backlog vs decode
  load), and the drain candidate is never the last prefill-capable
  replica (``FleetRouter.drain_replica`` refuses that loudly — the
  pinned behavior; the autoscaler filters candidates so it never
  trips it).

The conservation story extends to admission: the
:class:`AdmissionLedger` partitions every submitted fleet request,
per tenant, as ``submitted == admitted + quota_deferred + shed`` —
"admitted" the moment the router releases it to dispatch (immediately
with WFQ off; at WFQ drain with it on), "quota_deferred" when the
token bucket refuses it (terminal REJECTED), "shed" when it leaves
the WFQ buffer without dispatch (deadline expiry, or cancel while
buffered).  :func:`check_control_conservation` asserts the partition,
an empty WFQ at drain, zero duplicate completions and the fleet's own
page/ref conservation on every replica (dead ones included);
violations raise :class:`~paddle_tpu_torch.serving.faults.PageLeakError`
tagged ``CONTROL-LEAK``, and ``python -c
"...control.main(['check'])"`` replays a seeded tenant-storm +
autoscale + kill trace as the standalone gate.

This module must stay importable WITHOUT fleet.py (fleet imports it);
the selfcheck imports the router lazily.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

from paddle_tpu_torch.platform.device import DeviceLike
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.serving.faults import PageLeakError

__all__ = ["TenantClass", "TenantSpec", "TenantRegistry", "DEFAULT_CLASSES",
           "AdmissionLedger", "WeightedFairQueue", "AutoscalePolicy",
           "Autoscaler", "check_control_conservation"]


# ---------------------------------------------------------------------------
# SLO classes and the tenant registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TenantClass:
    """One latency tier: the default deadline stamped on submits that
    do not carry their own, the WFQ service weight, and the preemption
    precedence rank (HIGHER rank = victimized FIRST when the scheduler
    needs pages back, so batch slots evict before interactive ones)."""

    name: str
    deadline_s: Optional[float]    # None = no deadline (batch)
    weight: float                  # WFQ service share
    precedence: int                # higher = preempted first


DEFAULT_CLASSES: Dict[str, TenantClass] = {
    "interactive": TenantClass("interactive", deadline_s=0.5, weight=4.0,
                               precedence=0),
    "standard": TenantClass("standard", deadline_s=2.0, weight=2.0,
                            precedence=1),
    "batch": TenantClass("batch", deadline_s=None, weight=1.0,
                         precedence=2),
}


@dataclass
class TenantSpec:
    """One tenant's resolved policy: its class plus per-tenant
    overrides, and the token-bucket quota state.  The bucket runs on
    whatever clock the caller passes ``now`` from — it never reads a
    clock itself, so fleet replays on an injected clock are
    bit-deterministic."""

    name: str
    cls: TenantClass
    deadline_s: Optional[float] = None     # None = class default
    quota_tokens_per_s: Optional[float] = None   # None = unmetered
    burst_tokens: Optional[float] = None   # None = 1s worth of quota
    # token-bucket state (filled lazily on first admit)
    _tokens: float = field(default=0.0, repr=False)
    _last_refill: Optional[float] = field(default=None, repr=False)

    @property
    def effective_deadline_s(self) -> Optional[float]:
        return self.cls.deadline_s if self.deadline_s is None \
            else self.deadline_s

    @property
    def effective_burst(self) -> float:
        if self.burst_tokens is not None:
            return float(self.burst_tokens)
        return float(self.quota_tokens_per_s or 0.0)

    def take(self, cost: float, now: float) -> bool:
        """Token-bucket admission: refill at ``quota_tokens_per_s``
        capped at the burst, then take ``cost`` tokens or refuse.
        Unmetered tenants (no quota) always pass."""
        if self.quota_tokens_per_s is None:
            return True
        if self._last_refill is None:
            self._tokens = self.effective_burst    # bucket starts full
        else:
            dt = max(0.0, now - self._last_refill)
            self._tokens = min(self.effective_burst,
                               self._tokens + dt * self.quota_tokens_per_s)
        self._last_refill = now
        if self._tokens >= cost:
            self._tokens -= cost
            return True
        return False


class TenantRegistry:
    """Tenant -> policy resolution.  Unknown tenants auto-register as
    ``standard`` on first touch — the legacy "default" tenant every
    un-annotated submit bills to just works, with middle-tier SLOs."""

    def __init__(self, classes: Optional[Dict[str, TenantClass]] = None):
        self.classes = dict(DEFAULT_CLASSES if classes is None else classes)
        self._specs: Dict[str, TenantSpec] = {}

    def register(self, name: str, cls: str = "standard", *,
                 deadline_s: Optional[float] = None,
                 quota_tokens_per_s: Optional[float] = None,
                 burst_tokens: Optional[float] = None) -> TenantSpec:
        enforce_that(cls in self.classes,
                     f"unknown tenant class {cls!r} for tenant {name!r} "
                     f"(have {sorted(self.classes)})", context="serving")
        spec = TenantSpec(name=str(name), cls=self.classes[cls],
                          deadline_s=deadline_s,
                          quota_tokens_per_s=quota_tokens_per_s,
                          burst_tokens=burst_tokens)
        self._specs[spec.name] = spec
        return spec

    def spec(self, name: str) -> TenantSpec:
        sp = self._specs.get(name)
        if sp is None:
            sp = self.register(name)       # auto-register: standard tier
        return sp

    def deadline_s(self, name: str) -> Optional[float]:
        return self.spec(name).effective_deadline_s

    def weight(self, name: str) -> float:
        return self.spec(name).cls.weight

    def precedence(self, name: str) -> int:
        """The scheduler's victim rank (bound to
        ``ContinuousBatchingScheduler.precedence_fn``)."""
        return self.spec(name).cls.precedence

    def admit_quota(self, name: str, cost_tokens: float,
                    now: float) -> bool:
        return self.spec(name).take(float(cost_tokens), now)

    def tenants(self) -> List[str]:
        return sorted(self._specs)

    @classmethod
    def from_flag(cls, text: str) -> "TenantRegistry":
        """Parse ``FLAGS.serving_tenant_classes``: a comma list of
        ``name:class`` pairs (``alice:interactive,bulk:batch``).  A
        bare name (no colon) registers as standard."""
        reg = cls()
        for part in str(text).split(","):
            part = part.strip()
            if not part:
                continue
            name, _, klass = part.partition(":")
            reg.register(name.strip(), klass.strip() or "standard")
        return reg


# ---------------------------------------------------------------------------
# admission ledger: the CONTROL-LEAK partition
# ---------------------------------------------------------------------------


class AdmissionLedger:
    """Per-tenant admission accounting.  The invariant the gate
    asserts: for every tenant, ``submitted == admitted +
    quota_deferred + shed`` — each submit ends in exactly one bucket,
    so no request can be silently dropped between the front door and
    dispatch (nor double-released into the fleet)."""

    def __init__(self):
        self.submitted: Dict[str, int] = {}
        self.admitted: Dict[str, int] = {}
        self.quota_deferred: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}

    @staticmethod
    def _inc(d: Dict[str, int], tenant: str) -> None:
        d[tenant] = d.get(tenant, 0) + 1

    def on_submit(self, tenant: str) -> None:
        self._inc(self.submitted, tenant)

    def on_admit(self, tenant: str) -> None:
        self._inc(self.admitted, tenant)

    def on_quota_deferred(self, tenant: str) -> None:
        self._inc(self.quota_deferred, tenant)

    def on_shed(self, tenant: str) -> None:
        self._inc(self.shed, tenant)

    def problems(self) -> List[str]:
        out: List[str] = []
        tenants = set(self.submitted) | set(self.admitted) | \
            set(self.quota_deferred) | set(self.shed)
        for t in sorted(tenants):
            sub = self.submitted.get(t, 0)
            adm = self.admitted.get(t, 0)
            quo = self.quota_deferred.get(t, 0)
            shd = self.shed.get(t, 0)
            if sub != adm + quo + shd:
                out.append(f"tenant {t!r}: submitted={sub} != "
                           f"admitted={adm} + quota_deferred={quo} + "
                           f"shed={shd}")
        return out

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {t: {"submitted": self.submitted.get(t, 0),
                    "admitted": self.admitted.get(t, 0),
                    "quota_deferred": self.quota_deferred.get(t, 0),
                    "shed": self.shed.get(t, 0)}
                for t in sorted(set(self.submitted) | set(self.admitted) |
                                set(self.quota_deferred) | set(self.shed))}


# ---------------------------------------------------------------------------
# weighted fair queuing (virtual-time WFQ)
# ---------------------------------------------------------------------------


class WeightedFairQueue:
    """Classic virtual-time WFQ over per-tenant FIFO queues.

    Each pushed item is stamped a virtual FINISH time::

        start  = max(vtime, last_finish[tenant])
        finish = start + cost / weight

    and ``pop`` serves the earliest head finish tag across tenants,
    advancing ``vtime`` to it.  With cost = prompt tokens, a tenant
    flooding 10x traffic only pushes ITS OWN finish tags far into the
    virtual future — other tenants' tags stay near ``vtime`` and keep
    being served at their weighted share, which is exactly the
    cross-tenant isolation the storm bench asserts."""

    def __init__(self):
        self._queues: Dict[str, Deque[Tuple[float, object]]] = {}
        self._last_finish: Dict[str, float] = {}
        self._vtime = 0.0

    def push(self, tenant: str, cost: float, weight: float,
             item: object) -> None:
        start = max(self._vtime, self._last_finish.get(tenant, 0.0))
        fin = start + max(1.0, float(cost)) / max(1e-9, float(weight))
        self._last_finish[tenant] = fin
        self._queues.setdefault(tenant, deque()).append((fin, item))

    def pop(self) -> Optional[Tuple[str, object]]:
        """Serve the earliest finish tag; None when empty."""
        best: Optional[str] = None
        best_fin = 0.0
        for t, q in self._queues.items():
            if not q:
                continue
            fin = q[0][0]
            if best is None or fin < best_fin:
                best, best_fin = t, fin
        if best is None:
            return None
        fin, item = self._queues[best].popleft()
        if not self._queues[best]:
            del self._queues[best]
        self._vtime = max(self._vtime, fin)
        return best, item

    def remove(self, item: object) -> Optional[str]:
        """Drop ``item`` wherever it is buffered; returns its tenant
        (None when not found) so the caller can balance the ledger."""
        for t, q in list(self._queues.items()):
            for pair in q:
                if pair[1] is item:
                    q.remove(pair)
                    if not q:
                        del self._queues[t]
                    return t
        return None

    def expire(self, pred: Callable[[object], bool]
               ) -> List[Tuple[str, object]]:
        """Remove every buffered item with ``pred(item)`` true;
        returns the (tenant, item) pairs removed."""
        out: List[Tuple[str, object]] = []
        for t, q in list(self._queues.items()):
            keep = deque(p for p in q if not pred(p[1]))
            if len(keep) != len(q):
                out.extend((t, p[1]) for p in q if pred(p[1]))
                if keep:
                    self._queues[t] = keep
                else:
                    del self._queues[t]
        return out

    def backlog(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items()}

    def items(self) -> Iterable[Tuple[str, object]]:
        for t, q in self._queues.items():
            for _, item in q:
                yield t, item

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())


# ---------------------------------------------------------------------------
# autoscaler
# ---------------------------------------------------------------------------


@dataclass
class AutoscalePolicy:
    """Hysteresis knobs for the policy loop.  ``*_hi`` thresholds
    trigger scale-UP when ANY is breached; scale-DOWN needs the fleet
    genuinely idle (zero queued/running/buffered work and no fresh
    misses) — an asymmetry on purpose: adding capacity under pressure
    is cheap to undo, removing it under load is not."""

    min_replicas: int = 1
    max_replicas: int = 8
    queue_wait_hi_ms: float = 50.0     # p95 admission wait, any replica
    pages_hi_frac: float = 0.85        # live pages / usable, any replica
    backlog_hi_tokens: int = 512       # prompt tokens still owed prefill
    buffered_hi: int = 8               # WFQ items ahead of dispatch
    cooldown_ticks: int = 10           # no action for N ticks after one


class Autoscaler:
    """Joins/drains replicas from registry signals on the fleet's
    clock.  Stateless between fleets; all counters are public so the
    bench and the gate can assert the loop actually acted:

    - ``scale_ups`` / ``scale_downs`` — actions taken;
    - ``replica_ticks`` — alive-replica x tick integral, the
      "chip-ticks" currency the autoscaled-vs-static comparison uses.
    """

    def __init__(self, router, policy: Optional[AutoscalePolicy] = None):
        self.router = router
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.scale_ups = 0
        self.scale_downs = 0
        self.replica_ticks = 0
        self._cooldown = 0
        self._last_misses = 0

    # -- signals -----------------------------------------------------------

    def _miss_delta(self) -> int:
        m = self.router.metrics
        misses = m.timed_out + m.shed
        delta = misses - self._last_misses
        self._last_misses = misses
        return delta

    def on_tick(self, tick: int, now: float) -> None:
        """One policy evaluation, called by ``FleetRouter.step`` after
        the lease sweep (so membership is current) and before WFQ
        drain/dispatch (so a joined replica can admit this tick's
        releases next tick, once JOINING promotes)."""
        from paddle_tpu_torch.serving.fleet import ReplicaState

        R = self.router
        p = self.policy
        self.replica_ticks += sum(1 for r in R.replicas
                                  if r.state is not ReplicaState.DEAD)
        miss_delta = self._miss_delta()    # track EVERY tick, so a miss
        #                            during cooldown still reads as fresh
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        alive = [r for r in R.replicas
                 if r.state in (ReplicaState.READY, ReplicaState.JOINING)]
        ready = [r for r in alive if r.state is ReplicaState.READY]
        buffered = len(R.wfq) if R.wfq is not None else 0
        if not ready:
            # fleet-wide outage (every replica killed/draining): grow if
            # the ceiling allows — the scale-up-under-kill path
            if len(alive) < p.max_replicas and (buffered or R.has_work):
                self._scale_up(reason="no ready replicas")
            return
        wait_ms = max(r.engine.metrics.queue_wait_ms_p95() for r in ready)
        pages_frac = max(
            r.engine.pool.num_live / max(1, r.engine.pool.num_usable)
            for r in ready)
        backlog = sum(r.engine.load()["prefill_backlog_tokens"]
                      for r in ready)
        live_load = sum(r.engine.load()["queue_depth"] +
                        r.engine.load()["running"] for r in ready)
        hot = (wait_ms > p.queue_wait_hi_ms or
               pages_frac > p.pages_hi_frac or
               backlog > p.backlog_hi_tokens or
               buffered > p.buffered_hi or
               miss_delta > 0)
        # cold = provably idle: wait-p95 is a trailing window (it stays
        # high long after a storm), so the DOWN decision reads live
        # state only — nothing queued, running, buffered, owed, or
        # freshly missed
        cold = (live_load == 0 and buffered == 0 and backlog == 0 and
                miss_delta == 0)
        if hot and len(alive) < p.max_replicas:
            self._scale_up(reason=f"wait={wait_ms:.0f}ms "
                                  f"pages={pages_frac:.2f} "
                                  f"backlog={backlog} buffered={buffered} "
                                  f"miss_delta={miss_delta}")
        elif cold and len(alive) > p.min_replicas:
            self._scale_down(ready)

    # -- actions -----------------------------------------------------------

    def _role_for_join(self) -> str:
        """In a disaggregated fleet, join where the pressure is: a
        dominant prefill backlog wants another prefill replica,
        otherwise decode.  Unified fleets always join unified."""
        from paddle_tpu_torch.serving.fleet import ReplicaState

        R = self.router
        if not R._disagg:
            return "unified"
        backlog = queued = 0
        for r in R.replicas:
            if r.state is ReplicaState.DEAD:
                continue
            ld = r.engine.load()
            backlog += ld["prefill_backlog_tokens"]
            queued += ld["queue_depth"] + ld["running"]
        return "prefill" if backlog >= queued * self._page(R) else "decode"

    @staticmethod
    def _page(R) -> int:
        return R.replicas[0].engine.kv_cfg.page_size

    def _scale_up(self, reason: str) -> None:
        R = self.router
        idx = R.add_replica(role=self._role_for_join())
        self.scale_ups += 1
        self._cooldown = self.policy.cooldown_ticks
        R.tracer.instant("autoscale_up", cat="fleet", replica=idx,
                         reason=reason)

    def _scale_down(self, ready) -> None:
        from paddle_tpu_torch.serving.fleet import ReplicaState

        R = self.router
        # drain the newest idle replica (LIFO — undo the latest join)
        # that is NOT the last prefill-capable one: drain_replica
        # refuses that loudly, and the policy loop must never trip the
        # refusal it relies on
        for rep in sorted(ready, key=lambda r: r.idx, reverse=True):
            if R._disagg and rep.role in ("prefill", "unified"):
                others = [o for o in R.replicas
                          if o.idx != rep.idx and
                          o.state in (ReplicaState.READY,
                                      ReplicaState.JOINING) and
                          o.role in ("prefill", "unified")]
                if not others:
                    continue
            R.drain_replica(rep.idx)
            self.scale_downs += 1
            self._cooldown = self.policy.cooldown_ticks
            R.tracer.instant("autoscale_down", cat="fleet",
                             replica=rep.idx)
            return


# ---------------------------------------------------------------------------
# conservation: the CONTROL-LEAK gate
# ---------------------------------------------------------------------------


def check_control_conservation(router) -> None:
    """Control-plane conservation, valid at drain (raises
    :class:`PageLeakError` tagged ``CONTROL-LEAK``):

    - the admission ledger partitions per tenant:
      ``submitted == admitted + quota_deferred + shed``;
    - the WFQ buffer is empty (nothing half-admitted);
    - ``duplicate_completions`` stayed 0 through every scaling event;
    - the fleet's own conservation holds — every rid at exactly one
      terminal status and every replica's pool (dead ones included)
      free of page/ref leaks."""
    problems: List[str] = []
    ledger = getattr(router, "ledger", None)
    if ledger is not None:
        problems.extend(ledger.problems())
    wfq = getattr(router, "wfq", None)
    if wfq is not None and len(wfq):
        problems.append(f"{len(wfq)} requests still buffered in the "
                        "WFQ after drain")
    if router.metrics.duplicate_completions:
        problems.append(f"{router.metrics.duplicate_completions} "
                        "duplicate completions")
    try:
        router.check_fleet_conservation()
    except PageLeakError as e:
        problems.append(f"fleet conservation: {e}")
    if problems:
        if "CONTROL-LEAK" not in router._postmortems_dumped:
            router._postmortems_dumped.add("CONTROL-LEAK")
            router.tracer.dump_postmortem("CONTROL-LEAK")
        raise PageLeakError("CONTROL-LEAK: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# standalone gate: `python -c "...control.main(['check'])"`
# ---------------------------------------------------------------------------


def _selfcheck(device: DeviceLike = None) -> int:
    """Replay a seeded tenant-storm + autoscale + kill trace and run
    the control conservation check, on ``device`` (default ``cuda``) —
    the JAX package's CONTROL-LEAK gate.  Returns 0 (clean) or 1
    (findings); a crash propagates as 2."""
    import numpy as np

    from paddle_tpu_torch.serving._gate import gate_model
    from paddle_tpu_torch.serving.engine import ServingEngine
    from paddle_tpu_torch.serving.faults import FleetFaultPlan, ManualClock
    from paddle_tpu_torch.serving.fleet import FleetRouter

    model = gate_model(device)
    clock = ManualClock(tick_s=0.01)
    # one injected clock drives everything: the kill, the storm window,
    # the quota buckets and the autoscaler cooldowns
    plan = FleetFaultPlan(seed=0, clock=clock, kill_at={10: 1},
                          tenant_storm=("carl", 2, 8, 4))
    reg = TenantRegistry()
    reg.register("alice", "interactive")
    reg.register("bob", "standard")
    # carl is metered: the storm must overflow his bucket so the
    # quota_deferred path is exercised, not just the WFQ
    reg.register("carl", "batch", quota_tokens_per_s=300.0,
                 burst_tokens=40.0)

    def mk(i, time_fn):
        return ServingEngine(model, eos_id=1, page_size=4, num_pages=32,
                             max_pages_per_seq=8, max_slots=4,
                             buckets=(8, 16), time_fn=time_fn,
                             device=device)

    fleet = FleetRouter(mk, 2, heartbeat_s=0.05, resubmit_budget=2,
                        faults=plan, tenants=reg, wfq=True,
                        autoscale=AutoscalePolicy(
                            min_replicas=2, max_replicas=4,
                            queue_wait_hi_ms=15.0, buffered_hi=3,
                            cooldown_ticks=3))
    scaler = fleet.autoscaler
    rng = np.random.RandomState(1)
    system = rng.randint(2, 64, size=8).tolist()     # 2 shared pages
    tick = 0
    while tick < 16 or fleet.has_work:
        if tick < 16:
            for tenant in ("alice", "bob", "carl"):
                n = plan.storm_factor(tick, tenant) if tick % 2 == 0 else 0
                for _ in range(n):
                    fleet.submit(
                        system + rng.randint(2, 64, size=4).tolist(),
                        max_tokens=4, tenant=tenant)
        fleet.step()
        tick += 1
        if tick > 600:
            print("CONTROL-LEAK: fleet failed to drain within 600 ticks")
            return 1
    # idle tail: the cold condition must hold long enough (cooldowns
    # included) for the autoscaler to shrink back toward min_replicas
    for _ in range(12):
        fleet.step()
    check_control_conservation(fleet)
    led = fleet.ledger
    misses = {t: c.get("deadline_misses", 0)
              for t, c in fleet.healthz()["tenants"].items()}
    problems: List[str] = []
    for tenant in ("alice", "bob"):
        if misses.get(tenant, 0):
            problems.append(f"non-storming tenant {tenant!r} missed "
                            f"{misses[tenant]} deadlines under carl's "
                            "storm")
    if led.quota_deferred.get("carl", 0) < 1:
        problems.append("carl's storm never overflowed his quota bucket")
    if scaler.scale_ups < 1:
        problems.append("autoscaler never grew the fleet under the storm")
    if scaler.scale_downs < 1:
        problems.append("autoscaler never shrank the fleet after the storm")
    if fleet.metrics.duplicate_completions:
        problems.append(f"{fleet.metrics.duplicate_completions} duplicate "
                        "completions")
    if problems:
        print("CONTROL-LEAK: " + "; ".join(problems))
        return 1
    snap = fleet.snapshot()
    print(f"control-check ok: {snap['fleet_completed']} completed "
          f"across {len(fleet.replicas)} replicas "
          f"(ups={scaler.scale_ups} downs={scaler.scale_downs}), "
          f"ledger balanced for {len(led.snapshot())} tenants "
          f"(carl quota_deferred={led.quota_deferred.get('carl', 0)}), "
          f"0 cross-tenant misses, 0 duplicate completions, 0 leaks")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``check [--device D]``: the CONTROL-LEAK gate (exit 0 clean, 1
    findings, 2 a crash); importable, like ``kv_cache.main``."""
    from paddle_tpu_torch.serving._gate import run_gate

    return run_gate(argv, "control",
                    "python -c \"from paddle_tpu_torch.serving.control "
                    "import main; main(['check'])\"", _selfcheck)


if __name__ == "__main__":
    import sys

    sys.exit(main())
