"""FleetRouter: N ServingEngine replicas behind one prefix-aware
front door (the port of ``paddle_tpu/serving/fleet.py``, which is pure
Python over its engines; only the imports and the gate's model differ).
The heavy-traffic deployment: many replicas behind one router, one
replica lost without a token lost or repeated, prefill split from
decode.  Replicas on one card share one model; each owns its pool.

Two halves join here:

- the **serving** stack gives every replica a full SLO surface —
  ``submit``/``step``/``status``/``cancel``/``healthz``, deadlines,
  shedding, prefix caching — plus the ``drain()`` toggle;
- the **master** stack contributes its etcd-analog lease machinery:
  :class:`~paddle_tpu_torch.master.service.LeaseTable` gives each replica a
  (slot, token) TTL lease, so liveness is decided by heartbeats on the
  injected clock and a zombie replica whose slot was reclaimed can
  never ack again (token mismatch — the exact semantics
  ``Service.heartbeat`` pins for trainers).

Routing is by **chained prompt-block hash** — literally the
:class:`~paddle_tpu_torch.serving.kv_cache.PrefixCache` key function
(:func:`~paddle_tpu_torch.serving.kv_cache.prefix_chain_hashes`) — so two
prompts that would share cached pages inside an engine also share a
routing key across the fleet, and shared-prefix traffic lands where its
pages already live.  The router remembers which replica owns each chain
key (updated at every successful dispatch, dropped on replica death);
healthz-driven load balancing (``queue_depth`` / ``free_pages``) is the
tiebreak for unkeyed traffic and the overflow path when the prefix
owner is saturated.  ``routing="round_robin"`` keeps the naive policy
alive as the bench's A/B control.

Replica lifecycle::

    JOINING ──(lease alive + healthz ok)──▶ READY
      READY ──drain_replica()──▶ DRAINING ──(engine empty)──▶ DEAD
      READY/DRAINING ──(kill fault | lease expiry)──▶ DEAD

DEAD is terminal and fenced: the lease is dropped (token can never ack
again), the replica's chain-key ownership is forgotten, its engine-side
in-flight work is cancelled (pages return to its pool), and every
not-yet-terminal fleet request it carried is **resubmitted** to a
survivor through the normal dispatch path — deadlines carry over as
absolute times, resubmits are budgeted (``serving_fleet_resubmit_budget``)
and then FAILED, and the rid map is severed BEFORE resubmission so one
fleet rid can never complete twice (``duplicate_completions`` is a
counter precisely so the conservation check can assert it stayed 0).

Token streams are exactly-once: the router wraps ``on_token`` with a
high-water mark per fleet request, so a greedy request replayed on a
survivor after a kill re-emits only the tokens the user has not seen
yet (greedy decoding is deterministic, so the replay prefix matches).
On a card the replay must take the same path through the ragged kernel
as the first attempt for that to hold bit for bit: B4 splits a
sequence's keys into spans from ``max_pages_per_seq * page_size``, so
every replica of a fleet is built with the same engine geometry.  A
replay may still stitch its prompt onto prefix pages cached on the
survivor where the first attempt prefilled it whole, which can move a
first token that sat on a near tie of its logits.

``check_fleet_conservation()`` extends the engine's PAGE/REF-LEAK
contract to the fleet: after a drain, every submitted fleet rid reached
EXACTLY one terminal status, no rid completed twice, and every
replica's pool — dead ones included — holds zero live refs.  Violations
raise :class:`~paddle_tpu_torch.serving.faults.PageLeakError` tagged
``FLEET-LEAK``, and ``main(["check"])`` replays a seeded kill-chaos
trace as a standalone gate.

``FleetRouter.over_mesh_slices`` makes the replica unit a tensor-parallel
mesh slice (``parallel.mesh.mesh_slices``): replica i is a
``ServingEngine(mesh=slice i)``.  JAX runs one controller; here every
rank of the job runs the same router on the same clock, and each replica
is one engine on its slice's ranks and a :class:`SliceProxy` on every
other rank.  After each call that changes a replica (submit, step,
cancel, drain) the slice's first rank broadcasts the outcome over a CPU
(gloo) group of every rank: the statuses of the requests the router
tracks there, the results of the completed ones, the tokens streamed,
``load()`` and ``healthz()``.  The proxies take it as their state, and
every rank then runs the fleet's stream callbacks over those tokens, so
a callback runs after its replica's call on every rank.  So every rank's
router and ``snapshot()`` are equal, and a kill fences and reaps a slice
as one unit on every rank.  The view also carries what the migration
plane and the autoscaler read: the request digests, the migratable rids,
the backlog probe, the pool and the metrics.  One clock serves every
rank: rank 0 reads the fleet's clock at each tick (and at a submit or a
cancel without ``now``) and broadcasts the reading on the plane, and
every rank's router and engines read that value until the next one.  A
page transfer between two slices (a chain handoff from a prefill slice
to a decode slice, or a prefix seed) runs on their ranks: each source
rank exports its own KV-head shard into host tensors and sends it over
the plane to the destination rank at the same position of its slice,
which imports it; the destination's first rank then broadcasts the
outcome.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from enum import Enum
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple)

import torch
import torch.distributed as dist

from paddle_tpu_torch.analysis.concurrency.lifecycle import \
    record_transition
from paddle_tpu_torch.master.service import LeaseTable
from paddle_tpu_torch.obs.registry import MetricsRegistry
from paddle_tpu_torch.obs.trace import tracer_for
from paddle_tpu_torch.platform.device import DeviceLike
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.serving.control import (AdmissionLedger, Autoscaler,
                                              AutoscalePolicy,
                                              TenantRegistry,
                                              WeightedFairQueue)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.faults import FleetFaultPlan, PageLeakError
from paddle_tpu_torch.serving.kv_cache import prefix_chain_hashes
from paddle_tpu_torch.serving.metrics import FleetMetrics
from paddle_tpu_torch.serving.migrate import (export_chain, export_prefix,
                                              import_chain, import_prefix)
from paddle_tpu_torch.serving.scheduler import RequestStatus

__all__ = ["FleetRouter", "Replica", "ReplicaState", "SliceProxy"]

_frid_counter = itertools.count()


class ReplicaState(str, Enum):
    """Replica lifecycle (str-valued like RequestStatus, so comparisons
    against the literal strings work)."""

    JOINING = "joining"      # registered, not yet admitted to routing
    READY = "ready"          # lease live, healthz ok — routable
    DRAINING = "draining"    # admission closed, running work finishing
    DEAD = "dead"            # fenced: lease dropped, never routable again

    def __str__(self) -> str:
        return self.value


@dataclass
class _FleetRequest:
    """One fleet-level request: the fleet rid is the caller's handle;
    the (replica, erid) binding below it changes across resubmits but
    at most ONE binding is live at a time."""

    frid: int
    prompt: List[int]
    max_tokens: int
    on_token: Optional[Callable[[int], None]] = None
    deadline_at: Optional[float] = None   # absolute, carries over resubmits
    status: RequestStatus = RequestStatus.QUEUED
    replica: Optional[int] = None         # current replica index
    erid: Optional[int] = None            # current engine rid
    resubmits: int = 0
    emitted: int = 0                      # exactly-once stream high-water
    attempt_tokens: int = 0               # tokens seen in CURRENT attempt
    result: Optional[List[int]] = None
    submitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    terminal_transitions: int = 0         # conservation: must end at 1
    tenant: str = "default"               # billing identity; survives
    #                                       resubmits and migrations

    @property
    def finished(self) -> bool:
        return self.status.terminal


class Replica:
    """One engine plus its fleet-side bookkeeping."""

    def __init__(self, idx: int, engine: ServingEngine,
                 role: str = "unified"):
        self.idx = idx
        self.engine = engine
        self.role = role                      # prefill | decode | unified
        self.state = ReplicaState.JOINING
        self.slot: Optional[int] = None       # LeaseTable slot
        self.token: Optional[str] = None      # lease token (zombie fence)
        self.last_hb: Optional[float] = None
        self.rid_map: Dict[int, int] = {}     # engine rid -> fleet rid
        self.dead_reason: Optional[str] = None
        # (fleet rid, token) streamed since the last outcome broadcast,
        # in a fleet over mesh slices on several ranks
        self.outbox: List[Tuple[int, int]] = []

    def load_key(self) -> Tuple[int, int, int]:
        """Balancing key: fewer queued+running first, more free pages as
        the tiebreak, index for determinism.  Reads the engine's O(1)
        ``load()`` probe, not ``healthz()`` — routing runs this per
        candidate replica per submit, and healthz pays a full
        conservation scan for its ``ok`` bit."""
        ld = self.engine.load()
        return (ld["queue_depth"] + ld["running"], -ld["free_pages"],
                self.idx)

    def prefill_key(self) -> Tuple[int, int, int, int]:
        """Balancing key for PROMPT dispatch in a disaggregated fleet:
        lead with the O(1) ``prefill_backlog_tokens`` probe (the tokens
        actually ahead of a new prompt), then the classic load key —
        queue depth alone undercounts a replica chewing a 2k-token
        prefill."""
        ld = self.engine.load()
        return (ld["prefill_backlog_tokens"],
                ld["queue_depth"] + ld["running"], -ld["free_pages"],
                self.idx)


def _broadcast_view(engine, plane, rids=(), erid: Optional[int] = None,
                    tokens=()) -> Dict[str, object]:
    """One outcome broadcast of a replica over ``plane`` (CPU group, the
    slice's first rank): that rank sends what the router reads of its
    engine — the statuses of ``rids`` and ``erid``, the completed ones'
    results, the ``tokens`` streamed — and a :class:`SliceProxy` takes
    it as its state."""
    group, src = plane[0], plane[1]
    view = None
    if dist.get_rank() == src:
        ids = set(rids) | ({erid} if erid is not None else set())
        status = {e: engine.status(e) for e in ids}
        sched = engine.scheduler
        migratable = engine.migratable_rids()
        view = {"erid": erid, "status": status,
                "results": {e: engine.result(e) for e, st in status.items()
                            if st is RequestStatus.COMPLETED},
                "tokens": list(tokens), "has_work": engine.has_work,
                "load": engine.load(), "healthz": engine.healthz(),
                "role": engine.role, "tp": engine.tp,
                "kv_cfg": engine.kv_cfg, "max_slots": engine._max_slots,
                "metrics": engine.metrics, "pool": engine.pool,
                "has_cache": engine.cache is not None,
                "migratable": migratable,
                "requests": {e: _RequestDigest(engine._requests[e])
                             for e in ids | set(migratable)
                             if e in engine._requests},
                "backlog": (sched.prefill_backlog_tokens,
                            sched.recompute_backlog())}
    box = [view]
    dist.broadcast_object_list(box, src=src, group=group)
    if isinstance(engine, SliceProxy):
        engine.apply(box[0])
    return box[0]


class _RequestDigest:
    """What the migration plane reads of an engine request, carried to
    the proxies of its replica."""

    __slots__ = ("status", "prefilling", "generated", "cache_len")

    def __init__(self, req) -> None:
        self.status = req.status
        self.prefilling = req.prefilling
        self.generated = list(req.generated)
        self.cache_len = req.cache_len


class _ProxyScheduler:
    """The backlog probe and its recompute, as the slice reported them."""

    def __init__(self, backlog: Tuple[int, int]) -> None:
        self.prefill_backlog_tokens, self._recomputed = backlog

    def recompute_backlog(self) -> int:
        return self._recomputed


class _PlaneClock:
    """The fleet's clock on every rank of a fleet over mesh slices: rank
    0 reads ``base`` at each :meth:`sync` (a collective on the plane) and
    broadcasts it; every rank returns that reading until the next."""

    def __init__(self, base: Callable[[], float], plane) -> None:
        self._base = base
        self._plane = plane
        self._now = 0.0
        self.sync()

    def sync(self) -> float:
        t = torch.tensor([self._base() if dist.get_rank() == 0 else 0.0],
                         dtype=torch.float64)
        dist.broadcast(t, src=0, group=self._plane)
        self._now = float(t[0])
        return self._now

    def __call__(self) -> float:
        return self._now


class SliceProxy:
    """A replica's stand-in on a rank outside its mesh slice, in a fleet
    over mesh slices on several ranks (module doc).  It runs nothing:
    the calls that change the replica return None here, and the slice's
    first rank broadcasts their outcome, which :meth:`apply` takes as
    this proxy's state.  It holds no pages: its conservation check reads
    the leak bit the slice's own ranks report."""

    host_tier = None
    cache = None

    def __init__(self) -> None:
        self._status: Dict[int, RequestStatus] = {}
        self._view: Dict[str, object] = {}

    def apply(self, view: Dict[str, object]) -> None:
        # terminal statuses leave once the router stops asking for them
        # (a view lists every rid the router tracks on the replica)
        self._status = {e: st for e, st in self._status.items()
                        if not st.terminal}
        self._status.update(view["status"])
        self._view = view
        self.role, self.tp = view["role"], view["tp"]
        self.kv_cfg, self._max_slots = view["kv_cfg"], view["max_slots"]
        self.metrics, self.pool = view["metrics"], view["pool"]
        self._requests = view["requests"]
        self.scheduler = _ProxyScheduler(view["backlog"])

    def migratable_rids(self) -> List[int]:
        return list(self._view["migratable"])

    def submit(self, *args, **kwargs) -> None:
        return None

    def step(self, now: Optional[float] = None) -> None:
        return None

    def cancel(self, rid: int, now: Optional[float] = None) -> None:
        return None

    def drain(self, on: bool = True) -> None:
        return None

    def release_pool(self) -> None:
        return None

    def set_tracer(self, tracer) -> None:
        return None

    def set_registry(self, registry, **labels) -> None:
        return None

    def status(self, rid: int) -> RequestStatus:
        return self._status[rid]

    def result(self, rid: int) -> Optional[List[int]]:
        return self._view["results"].get(rid)

    @property
    def has_work(self) -> bool:
        return bool(self._view["has_work"])

    def load(self) -> Dict[str, object]:
        return self._view["load"]

    def healthz(self) -> Dict[str, object]:
        return self._view["healthz"]

    def check_page_conservation(self) -> None:
        if self._view["healthz"]["page_leak"]:
            raise PageLeakError("the slice's ranks report a page leak "
                                "(their own check names it)")


@dataclass
class _Transfer:
    """One pending page transfer, queued per DESTINATION and admitted
    against its per-tick page credit (``serving_migrate_budget``) —
    charged to the destination like chunked prefill, never blocking its
    decode tick.  ``kind="chain"`` hands a live request off;
    ``kind="seed"`` warms a peer's PrefixCache."""

    kind: str                          # "chain" | "seed"
    src: int                           # source replica index
    dest: int                          # destination replica index
    seq: int                           # fleet-wide migration sequence no.
    frid: Optional[int] = None         # chain: the fleet rid moving
    erid: Optional[int] = None         # chain: source engine rid at enqueue
    tokens: Optional[List[int]] = None  # seed: the prompt to warm
    pages: int = 0                     # admission estimate (re-read at apply)


class FleetRouter:
    """Prefix-affinity router over N ServingEngine replicas on ONE
    injected clock (see module doc).

    ``make_engine(idx, time_fn)`` must build each replica's engine with
    ``time_fn=time_fn`` (and no per-engine fault clock), so the whole
    fleet shares the router's clock — the same determinism contract the
    single-engine fault plans use.
    """

    def __init__(self, make_engine: Callable[[int, Callable[[], float]],
                                             ServingEngine],
                 num_replicas: Optional[int] = None, *,
                 heartbeat_s: Optional[float] = None,
                 resubmit_budget: Optional[int] = None,
                 routing: str = "affinity",
                 overflow_queue_depth: Optional[int] = None,
                 max_retained: int = 10000,
                 max_owner_keys: int = 16384,
                 faults: Optional[FleetFaultPlan] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 tracer=None,
                 registry: Optional[MetricsRegistry] = None,
                 roles: Optional[Sequence[str]] = None,
                 migrate_budget: Optional[int] = None,
                 tenants: Optional[TenantRegistry] = None,
                 wfq: Optional[bool] = None,
                 autoscale=None, _plane=None):
        enforce_that(routing in ("affinity", "round_robin"),
                     f"unknown routing policy {routing!r}",
                     context="serving")
        if num_replicas is None:
            num_replicas = int(FLAGS.serving_fleet_replicas)
        if heartbeat_s is None:
            heartbeat_s = float(FLAGS.serving_fleet_heartbeat_s)
        if resubmit_budget is None:
            resubmit_budget = int(FLAGS.serving_fleet_resubmit_budget)
        # disaggregation: per-replica roles; a shorter list
        # pads with "unified", empty = the classic every-replica-unified
        # fleet with every migration path dormant
        if roles is None:
            raw = str(FLAGS.serving_fleet_roles).strip()
            roles = [s.strip() for s in raw.split(",")
                     if s.strip()] if raw else []
        self._roles: List[str] = [str(r) for r in roles]
        for r in self._roles:
            enforce_that(r in ("prefill", "decode", "unified"),
                         f"unknown replica role {r!r}", context="serving")
        if migrate_budget is None:
            migrate_budget = int(FLAGS.serving_migrate_budget)
        self.migrate_budget = max(0, int(migrate_budget))
        self._disagg = any(r != "unified" for r in self._roles)
        enforce_that(num_replicas >= 1, "fleet needs >= 1 replica",
                     context="serving")
        self._make_engine = make_engine
        self.routing = routing
        self.heartbeat_s = float(heartbeat_s)
        # 3x heartbeat, the master's lease_ttl_s : timeout_s ratio — two
        # missed heartbeats survive, the third is death
        self.lease_ttl_s = 3.0 * self.heartbeat_s
        self.resubmit_budget = max(0, int(resubmit_budget))
        self.overflow_queue_depth = overflow_queue_depth
        self.max_retained = max(1, int(max_retained))
        self.max_owner_keys = max(1, int(max_owner_keys))
        self.faults = faults
        if faults is not None and faults.clock is not None:
            self._time = faults.clock
        else:
            self._time = time_fn or time.monotonic
        if _plane is not None:
            self._time = _PlaneClock(self._time, _plane)
        # obs: ONE tracer and ONE registry for the whole fleet (replica
        # engines get the tracer scoped to their index and the registry
        # labeled with it), so a chaos replay yields one timeline and
        # one scrape surface instead of N disjoint ones
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else tracer_for(self._time, registry=self.registry)
        if self.tracer.enabled and self.tracer.registry is None:
            self.tracer.registry = self.registry
        self._postmortems_dumped: Set[str] = set()
        self._lease = LeaseTable(self.lease_ttl_s, time_fn=self._time,
                                 tracer=self.tracer if self.tracer.enabled
                                 else None)
        self.metrics = FleetMetrics()
        self.replicas: List[Replica] = []
        self._requests: Dict[int, _FleetRequest] = {}
        self._live: Set[int] = set()          # non-terminal fleet rids
        self._retired: Deque[int] = deque()   # terminal rids, oldest first
        # chain hash -> owning replica, LRU-bounded at max_owner_keys:
        # like every other long-lived structure here (max_retained
        # history, the engines' LRU caches) it must not grow per unique
        # prompt forever.  Eviction only degrades affinity to a load-
        # balanced pick — correctness never depends on this map.
        self._prefix_owner: "OrderedDict[int, int]" = OrderedDict()
        # replica idx -> (CPU group, slice's first rank): the outcome
        # plane of a fleet over mesh slices on several ranks
        self._planes: Dict[int, Tuple[object, int]] = {}
        self._rr_next = 0
        self._tick = 0
        # page-migration plane: pending transfers FIFO per
        # destination, admitted against a per-destination page credit of
        # ``migrate_budget`` pages per fleet tick; chain transfers are
        # also indexed by fleet rid so a terminal transition anywhere
        # (completion, death resubmit) aborts the in-flight handoff
        # instead of leaving it pending forever
        self._mig_queues: Dict[int, Deque[_Transfer]] = {}
        self._mig_pending: Dict[int, _Transfer] = {}   # frid -> transfer
        self._mig_credit: Dict[int, int] = {}
        self._mig_seq = 0
        # control plane: tenant SLO classes, weighted fair
        # queuing ahead of dispatch, and the autoscaler policy loop.
        # All three default off via flags, so the classic fleet is
        # byte-identical; the admission ledger ALWAYS runs (it is free
        # and the CONTROL-LEAK gate asserts it even with WFQ off).
        if tenants is None:
            raw = str(FLAGS.serving_tenant_classes).strip()
            tenants = TenantRegistry.from_flag(raw) if raw else None
        self.tenants = tenants
        if wfq is None:
            wfq = bool(FLAGS.serving_wfq)
        self.wfq = WeightedFairQueue() if wfq else None
        self.ledger = AdmissionLedger()
        if autoscale is None:
            autoscale = bool(FLAGS.serving_autoscale)
        if autoscale is True:
            autoscale = AutoscalePolicy(
                cooldown_ticks=int(FLAGS.serving_autoscale_cooldown))
        self.autoscaler = Autoscaler(self, autoscale) \
            if isinstance(autoscale, AutoscalePolicy) else None
        for _ in range(num_replicas):
            self.add_replica()
        # initial replicas come up READY before the first submit (their
        # leases are fresh); replicas added later go through an
        # observable JOINING tick first
        self._promote_joining()

    @classmethod
    def over_mesh_slices(cls, make_engine, tp: int = 1,
                         axis: str = "model", devices=None,
                         num_replicas: Optional[int] = None, **kwargs
                         ) -> "FleetRouter":
        """A fleet whose replica unit is a MESH SLICE, not a chip: the
        ranks are partitioned into ``tp``-rank slices
        (:func:`~paddle_tpu_torch.parallel.mesh.mesh_slices`) and
        ``make_engine(idx, time_fn, mesh)`` must return a
        ``ServingEngine(mesh=mesh, ...)`` on its slice (``mesh`` is None
        when ``tp == 1``: plain replicas).  Routing, leases, death
        fencing and resubmission are unchanged: a slice dies and rejoins
        as one unit.  ``num_replicas`` caps the slice count (default:
        every full slice the ranks afford).  Every rank of the job calls
        this, with the same arguments (module doc)."""
        if tp <= 1:
            slices = None
            n = num_replicas
        else:
            from paddle_tpu_torch.parallel.mesh import mesh_slices

            slices = mesh_slices(tp, axis=axis, devices=devices,
                                 max_slices=num_replicas)
            n = len(slices)
        plane, planes = None, {}
        if slices is not None and dist.is_initialized() \
                and dist.get_world_size() > 1:
            # the outcome plane: every rank of the job, on the CPU
            plane = dist.new_group(list(range(dist.get_world_size())),
                                   backend="gloo")

        def mk(i: int, time_fn):
            mesh = slices[i] if slices is not None else None
            if plane is None:
                return make_engine(i, time_fn, mesh)
            ranks = tuple(int(r) for r in mesh.devices.flat)
            planes[i] = (plane, ranks[0], ranks)
            engine = make_engine(i, time_fn, mesh) if mesh.member \
                else SliceProxy()
            _broadcast_view(engine, planes[i])
            return engine

        fleet = cls(mk, n, _plane=plane, **kwargs)
        fleet._planes = planes    # filled on: a warm restart adds one
        return fleet

    # ---- replica lifecycle ------------------------------------------------

    def add_replica(self, role: Optional[str] = None) -> int:
        """Elastic join: build an engine on the shared clock, claim a
        lease, enter JOINING.  Promoted to READY by the next tick's
        sweep once the lease is live and healthz reports ok.

        ``role`` pins the new replica's class explicitly (the
        autoscaler joins where the pressure is); None keeps the
        classic resolution — the fleet's roles list, then the engine's
        own role, then "unified"."""
        idx = len(self.replicas)
        engine = self._make_engine(idx, self._time)
        if role is None:
            # role: the fleet's roles list wins (padding with
            # "unified"); an engine built with its own role keeps it
            # when the list is silent about this index
            role = self._roles[idx] if idx < len(self._roles) \
                else getattr(engine, "role", "unified")
        else:
            enforce_that(role in ("prefill", "decode", "unified"),
                         f"unknown replica role {role!r}",
                         context="serving")
            # record the explicit role so _disagg and later joins see a
            # consistent picture
            while len(self._roles) < idx:
                self._roles.append("unified")
            if len(self._roles) == idx:
                self._roles.append(role)
            else:
                self._roles[idx] = role
            self._disagg = any(r != "unified" for r in self._roles)
        engine.role = role
        if self.tenants is not None and not isinstance(engine, SliceProxy):
            # preemption precedence: batch-class slots are victimized
            # before interactive ones, on EVERY replica incl. late joins
            engine.scheduler.precedence_fn = self.tenants.precedence
        rep = Replica(idx, engine, role=role)
        # one fleet-wide tracer/registry: the engine's instrumentation
        # points report under this replica's identity
        rep.engine.set_tracer(self.tracer.scoped(replica=idx))
        rep.engine.set_registry(self.registry, replica=idx)
        rep.slot, rep.token = self._lease.register(self.lease_ttl_s)
        rep.last_hb = self._time()
        self.replicas.append(rep)
        self.metrics.replicas_joined += 1
        self.tracer.instant("replica_join", cat="fleet", replica=idx)
        return idx

    def drain_replica(self, idx: int) -> None:
        """Begin a clean retirement: admission closes now (both at the
        router — no longer routable — and at the engine, whose own
        ``submit`` REJECTs), running and queued work finishes, and the
        replica retires to DEAD once its engine is empty."""
        rep = self.replicas[idx]
        enforce_that(rep.state in (ReplicaState.READY, ReplicaState.JOINING),
                     f"cannot drain replica in state {rep.state}",
                     context="serving")
        if self._disagg and rep.role in ("prefill", "unified"):
            # PINNED behavior: draining the LAST
            # prefill-capable replica of a disaggregated fleet is
            # REFUSED loudly rather than silently stranding every
            # future prompt — the autoscaler filters its drain
            # candidates on exactly this predicate, so the policy loop
            # can never trip it
            others = [o for o in self.replicas
                      if o.idx != idx and
                      o.state in (ReplicaState.READY,
                                  ReplicaState.JOINING) and
                      o.role in ("prefill", "unified")]
            enforce_that(bool(others),
                         f"refusing to drain replica {idx}: it is the "
                         "last prefill-capable replica of a "
                         "disaggregated fleet (prompts would have "
                         "nowhere to prefill)", context="serving")
        record_transition("replica_lifecycle", str(rep.state), "draining",
                          registry=self.registry)
        rep.state = ReplicaState.DRAINING
        rep.engine.drain()
        self._share(rep)
        self._forget_owner(idx)
        self.tracer.instant("replica_drain", cat="fleet", replica=idx)

    def kill_replica(self, idx: int,
                     reason: str = "killed by operator") -> None:
        """Immediately fence a replica (operator kill, or an external
        failure detector ahead of the lease timeout): DEAD, lease
        dropped, chain-key ownership forgotten, in-flight work
        resubmitted to survivors.  Same path the injected kill fault
        takes."""
        self._mark_dead(self.replicas[idx], self._time(), reason)

    def restart_replica(self, idx: int) -> int:
        """Crash-WARM restart: rebuild a DEAD replica as a
        fresh engine that re-adopts its predecessor's host-RAM spill
        tier instead of starting cold.  Crash semantics are honored —
        device pages died with the engine and are NOT salvaged;
        only pages the old engine had already spilled to host memory
        survive, and every one of them is checksum-verified during
        adoption (a corrupt page counts ``HOSTTIER-CORRUPT`` and is
        dropped, never served).  The successor is a NEW replica index
        going through the normal JOINING -> READY lifecycle, so the
        lease/fence/resubmit machinery is untouched: the dead replica's
        in-flight work was already resubmitted at fence time, and the
        exactly-once stream fence makes any replay invisible.  Returns
        the successor's index."""
        rep = self.replicas[idx]
        enforce_that(rep.state is ReplicaState.DEAD,
                     f"cannot warm-restart replica in state {rep.state} "
                     "(kill or drain it first)", context="serving")
        old_tier = rep.engine.host_tier
        # the successor re-enters through JOINING: record the warm
        # restart as the dead replica's declared dead -> joining edge
        record_transition("replica_lifecycle", "dead", "joining",
                          registry=self.registry)
        new_idx = self.add_replica(role=rep.role)
        new_rep = self.replicas[new_idx]
        restored = 0
        if old_tier is not None and new_rep.engine.host_tier is not None:
            tier = new_rep.engine.host_tier
            before = tier.restored
            tier.adopt(old_tier)
            restored = tier.restored - before
        self.metrics.on_warm_restart(restored)
        self.tracer.instant("replica_warm_restart", cat="fleet",
                            replica=idx, successor=new_idx,
                            pages_restored=restored)
        return new_idx

    def replica_state(self, idx: int) -> ReplicaState:
        return self.replicas[idx].state

    def _promote_joining(self) -> None:
        for rep in self.replicas:
            if rep.state is not ReplicaState.JOINING:
                continue
            if self._lease.alive(rep.slot, rep.token) and \
                    rep.engine.healthz()["ok"]:
                record_transition("replica_lifecycle", "joining", "ready",
                                  registry=self.registry)
                rep.state = ReplicaState.READY
                self.tracer.instant("replica_ready", cat="fleet",
                                    replica=rep.idx)

    def _lease_sweep(self, tick: int, now: float) -> None:
        """Renew every live replica's lease (unless partitioned), then
        declare any replica whose lease lapsed DEAD.  Renewal is a
        cheap host op, so it runs EVERY sweep rather than being paced
        by ``heartbeat_s`` — pacing would turn any engine tick slower
        than the TTL minus the pace (a first-compile spike on a real
        clock) into a mass false-positive death of the whole fleet.
        ``heartbeat_s`` is the TTL knob: a partitioned replica stops
        renewing, its lease expires after ``3 * heartbeat_s``, and when
        the partition heals its stale token can never ack — the zombie
        fence, end-to-end.  On a wall clock, size ``heartbeat_s`` above
        the worst-case single tick (compile spikes), since a tick
        longer than the whole TTL still lapses mid-tick.

        Deaths are collected, then ALL fenced, then reaped: a
        correlated failure (one partition taking out several replicas
        crosses the TTL on the same sweep) must not burn a request's
        bounded resubmit budget dispatching it to a replica this same
        sweep is about to declare dead."""
        lapsed: List[Tuple[Replica, str]] = []
        for rep in self.replicas:
            if rep.state is ReplicaState.DEAD:
                continue
            blocked = (self.faults is not None and
                       self.faults.heartbeat_blocked(rep.idx, tick))
            if not blocked:
                if self._lease.heartbeat(rep.slot, rep.token,
                                         self.lease_ttl_s):
                    rep.last_hb = now
                else:
                    lapsed.append((rep, "lease lost (zombie ack "
                                        "rejected)"))
                    continue
            if not self._lease.alive(rep.slot, rep.token):
                lapsed.append((rep, "lease expired"))
        for rep, reason in lapsed:
            self._fence(rep, now, reason)
        for rep, _ in lapsed:
            self._reap(rep, now)
        self._promote_joining()

    def _forget_owner(self, idx: int) -> None:
        self._prefix_owner = OrderedDict(
            (h, i) for h, i in self._prefix_owner.items() if i != idx)

    def _record_owner(self, hashes: List[int], idx: int) -> None:
        owner = self._prefix_owner
        for h in hashes:
            owner[h] = idx
            owner.move_to_end(h)
        while len(owner) > self.max_owner_keys:
            owner.popitem(last=False)

    def _mark_dead(self, rep: Replica, now: float, reason: str) -> None:
        """Fence a replica and resubmit its in-flight work (see module
        doc for the ordering that makes this idempotent).  Callers with
        SEVERAL deaths to declare at once fence them all first and only
        then reap (see _lease_sweep) — this one-replica path is for
        isolated deaths (operator kill)."""
        if rep.state is ReplicaState.DEAD:
            return
        self._fence(rep, now, reason)
        self._reap(rep, now)

    def _fence(self, rep: Replica, now: float, reason: str) -> None:
        """DEAD, lease dropped, chain ownership forgotten: from this
        line on the replica is unroutable and its zombie token can
        never ack.  Resubmission of its work is _reap's job."""
        record_transition("replica_lifecycle", str(rep.state), "dead",
                          registry=self.registry)
        rep.state = ReplicaState.DEAD
        rep.dead_reason = reason
        self.metrics.replicas_dead += 1
        self._lease.drop(rep.slot, rep.token)
        self._forget_owner(rep.idx)
        self.tracer.instant("replica_fence", cat="fleet", replica=rep.idx,
                            reason=reason)

    def _reap(self, rep: Replica, now: float) -> None:
        """Resubmit a fenced replica's unfinished work to survivors.

        Completions that landed BEFORE death are real — harvest them
        first so only genuinely unfinished work resubmits."""
        self._harvest(rep, now)
        pending = list(rep.rid_map.items())
        self.tracer.instant("replica_reap", cat="fleet", replica=rep.idx,
                            in_flight=len(pending))
        # sever the map BEFORE resubmitting: from this line on, nothing
        # this replica's engine does can reach a fleet request again
        rep.rid_map.clear()
        for erid, frid in pending:
            freq = self._requests[frid]
            # tear down the dead engine's copy so its pages return (the
            # process still owns the pool even though the fleet fenced
            # the replica) and the fleet-wide conservation check stays
            # provable over ALL replicas
            if not rep.engine.status(erid).terminal:
                rep.engine.cancel(erid, now=now)
                self._share(rep, erid)
            if freq.finished:
                continue
            freq.replica = None
            freq.erid = None
            self._resubmit(freq, now)
        # the dead engine never steps again: its device pool goes back to
        # the allocator now (a warm restart adopts only its host tier)
        if not rep.engine.has_work:
            rep.engine.release_pool()

    def _retire_replica(self, rep: Replica, now: float) -> None:
        """Clean end of a drain: engine empty, lease handed back."""
        self._lease.drop(rep.slot, rep.token)
        record_transition("replica_lifecycle", str(rep.state), "dead",
                          registry=self.registry)
        rep.state = ReplicaState.DEAD
        rep.dead_reason = "drained"
        self.metrics.replicas_drained += 1
        self._forget_owner(rep.idx)
        self.tracer.instant("replica_drained", cat="fleet",
                            replica=rep.idx)
        # the engine is empty and never steps again: free its device pool
        # as a reaped replica's is (a warm restart adopts its host tier)
        rep.engine.release_pool()

    # ---- routing ----------------------------------------------------------

    def _ready(self, exclude: Set[int]) -> List[Replica]:
        return [r for r in self.replicas
                if r.state is ReplicaState.READY and r.idx not in exclude]

    def _page_size(self) -> int:
        return self.replicas[0].engine.kv_cfg.page_size

    def _route(self, prompt: Sequence[int],
               exclude: Set[int]) -> Tuple[Optional[int], List[int], bool,
                                           Optional[int]]:
        """Pick a READY replica for ``prompt``.  Returns (replica index
        or None, the prompt's chain hashes — empty under round_robin,
        which never reads them, routed-by-affinity?, seed-from replica
        or None).

        Disaggregated fleets restrict PROMPT dispatch to prefill-class
        replicas (prefill/unified), balanced by their
        ``prefill_backlog_tokens`` probe.  The affinity owner map is
        keyed by the union of classes — a chain migrated to a decode
        replica records it as owner — so when the deepest owner cannot
        (or should not) take the prompt itself, the pick falls to the
        least-backlogged prefill replica and the owner comes back as
        ``seed_from``: the dispatcher warms the target's cache from the
        owner via the page-migration plane instead of re-prefilling."""
        ready = self._ready(exclude)
        if not ready:
            return None, [], False, None
        if self.routing == "round_robin":
            while True:   # `ready` is non-empty, so the cycle terminates
                idx = self._rr_next % len(self.replicas)
                self._rr_next += 1
                rep = self.replicas[idx]
                if rep.state is ReplicaState.READY and idx not in exclude:
                    return idx, [], False, None
        if self._disagg:
            eligible = [r for r in ready
                        if r.role in ("prefill", "unified")] or ready
            balance_key = Replica.prefill_key
        else:
            eligible = ready
            balance_key = Replica.load_key
        eligible_idx = {r.idx for r in eligible}
        hashes = prefix_chain_hashes(prompt, self._page_size())
        # affinity: the DEEPEST chain link with a known live owner wins
        # (deeper link = longer shared prefix already materialized there)
        affinity = None
        for h in hashes:
            owner = self._prefix_owner.get(h)
            if owner is not None and owner not in exclude and \
                    self.replicas[owner].state is ReplicaState.READY:
                affinity = owner
        seed_from = None
        if affinity is not None:
            rep = self.replicas[affinity]
            if affinity in eligible_idx:
                limit = self.overflow_queue_depth
                if limit is None:
                    # default: tolerate a queue as deep as two full decode
                    # batches before overflowing to the least-loaded
                    # replica
                    limit = 2 * rep.engine._max_slots
                if rep.engine.load()["queue_depth"] < limit:
                    return affinity, hashes, True, None
            # the owner holds the prefix but is not taking the prompt
            # (wrong class, or saturated): seed the eventual target
            seed_from = affinity
        best = min(eligible, key=balance_key)
        if seed_from == best.idx:
            seed_from = None
        return best.idx, hashes, False, seed_from

    # ---- user surface ------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_tokens: int,
               on_token: Optional[Callable[[int], None]] = None,
               deadline_s: Optional[float] = None,
               now: Optional[float] = None,
               tenant: str = "default") -> int:
        """Route a request into the fleet; returns its fleet rid ALWAYS
        (a refused request carries status REJECTED, mirroring the
        engine's contract).  ``deadline_s`` becomes an absolute deadline
        on the shared clock and carries over death-resubmits — a request
        does not get a fresh budget because its replica died.

        ``tenant`` is the billing identity.  With a tenant
        registry configured: a submit without its own ``deadline_s``
        inherits the tenant's SLO-class deadline, and the tenant's
        token bucket meters admission (an over-quota submit is REJECTED
        up front and ledgered as quota_deferred).  With WFQ on, the
        request buffers in the per-tenant virtual-time queue and is
        released to dispatch at its weighted share on the next tick."""
        now = self._now() if now is None else now
        tenant = str(tenant)
        freq = _FleetRequest(frid=next(_frid_counter),
                             prompt=[int(t) for t in prompt],
                             max_tokens=int(max_tokens), on_token=on_token,
                             tenant=tenant)
        freq.submitted_at = now
        if deadline_s is None and self.tenants is not None:
            deadline_s = self.tenants.deadline_s(tenant)
        if deadline_s is not None:
            freq.deadline_at = now + float(deadline_s)
        self._requests[freq.frid] = freq
        self._live.add(freq.frid)
        self.metrics.on_submit(now)
        self.ledger.on_submit(tenant)
        # THE root span: one async begin per fleet rid, ended by the
        # request's single terminal transition in _finish — the
        # exactly-once invariant drawn as exactly one bar per rid
        self.tracer.async_begin("fleet_request", id=freq.frid,
                                id_space="frid", tokens=len(freq.prompt),
                                max_tokens=freq.max_tokens)
        if self.tenants is not None and not self.tenants.admit_quota(
                tenant, len(freq.prompt) + freq.max_tokens, now):
            # token-bucket refusal: worst-case token cost (prompt +
            # max_tokens), terminal REJECTED — the caller retries after
            # the bucket refills, the fleet never buffers over-quota work
            self.ledger.on_quota_deferred(tenant)
            self.tracer.instant("quota_defer", cat="fleet",
                                frid=freq.frid, tenant=tenant)
            self._finish(freq, RequestStatus.REJECTED, now)
            return freq.frid
        if self.wfq is not None:
            weight = self.tenants.weight(tenant) \
                if self.tenants is not None else 1.0
            self.wfq.push(tenant, len(freq.prompt), weight, freq)
            self.tracer.instant("wfq_enqueue", cat="fleet",
                                frid=freq.frid, tenant=tenant)
            return freq.frid
        self.ledger.on_admit(tenant)
        self._dispatch(freq, now)
        return freq.frid

    def status(self, frid: int) -> RequestStatus:
        """Fleet-level lifecycle status; raises KeyError for a rid this
        fleet never issued (or evicted past ``max_retained``)."""
        return self._requests[frid].status

    def result(self, frid: int) -> Optional[List[int]]:
        """Generated tokens for a COMPLETED fleet rid (None while in
        flight or for non-completed terminals); KeyError for unknown."""
        return self._requests[frid].result

    def cancel(self, frid: int, now: Optional[float] = None) -> bool:
        """Cancel a fleet request wherever it currently lives."""
        freq = self._requests[frid]
        if freq.finished:
            return False
        now = self._now() if now is None else now
        if self.wfq is not None and self.wfq.remove(freq) is not None:
            # cancelled while still buffered ahead of dispatch: it left
            # the WFQ without being admitted — ledger it as shed so the
            # per-tenant partition stays balanced
            self.ledger.on_shed(freq.tenant)
        if freq.replica is not None:
            rep = self.replicas[freq.replica]
            rep.rid_map.pop(freq.erid, None)
            if not rep.engine.status(freq.erid).terminal:
                rep.engine.cancel(freq.erid, now=now)
                self._share(rep, freq.erid)
        self._finish(freq, RequestStatus.CANCELLED, now)
        return True

    @property
    def has_work(self) -> bool:
        return bool(self._live)

    def _now(self) -> float:
        """A fresh reading of the fleet's clock (over mesh slices on
        several ranks, rank 0's, broadcast)."""
        clock = self._time
        return clock.sync() if isinstance(clock, _PlaneClock) else clock()

    def step(self) -> bool:
        """One fleet tick: advance the shared clock, apply fleet faults
        (kills), sweep leases (partition -> expiry -> DEAD -> resubmit),
        step every live replica (slow replicas skip their off ticks),
        harvest terminal engine statuses into fleet statuses, retire
        drained replicas.  Returns True while fleet work remains."""
        tick = self._tick
        if self.faults is not None:
            self.faults.tick_begin(tick)
        now = self._now()
        if self.faults is not None:
            ready_idx = [r.idx for r in self.replicas
                         if r.state is ReplicaState.READY]
            # fence every killed replica before reaping any (same
            # correlated-death ordering as _lease_sweep)
            doomed = []
            for idx in self.faults.kills(tick, ready_idx):
                if 0 <= idx < len(self.replicas):
                    rep = self.replicas[idx]
                    if rep.state is not ReplicaState.DEAD:
                        self._fence(rep, now, f"injected kill @ tick {tick}")
                        doomed.append(rep)
            for rep in doomed:
                self._reap(rep, now)
        # the permutable mid-tick section.  Canonical order: lease sweep
        # (membership is current for everything after), autoscaler
        # (may join/drain replicas), WFQ drain (releases this tick's
        # weighted-fair share into dispatch), migration pump (a chain
        # or seed that clears its destination's per-tick credit lands
        # ahead of that destination's admission/decode this tick).
        # These four phases are CLAIMED commutable w.r.t. terminal
        # outcomes — the SCHED-AUDIT explorer replays chaos drives
        # under every permutation the hook asks for and holds the
        # fleet to that claim; the kill prologue above and the
        # engine-step/scan epilogue below are fixed, not permutable.
        for phase in self._schedule(tick, "phases", self._PHASES):
            if phase == "lease_sweep":
                self._lease_sweep(tick, now)
            elif phase == "autoscale":
                if self.autoscaler is not None:
                    self.autoscaler.on_tick(tick, now)
            elif phase == "wfq_drain":
                self._drain_wfq(now)
            else:                             # mig_pump
                self._pump_migrations(now)
        self._step_replicas(tick, now)
        # AFTER the engines step: prefill-class replicas whose requests
        # just finished prefilling (first token this tick) enqueue their
        # chain handoffs; the transfers clear next tick's pump
        self._scan_migratable()
        self._tick = tick + 1
        return self.has_work

    # canonical phase order for the permutable mid-tick section
    _PHASES = ("lease_sweep", "autoscale", "wfq_drain", "mig_pump")

    # SCHED-AUDIT ordering point: None (production) keeps canonical
    # order at zero cost; the schedule explorer installs a callable
    # ``hook(tick, kind, names) -> permutation`` with kind "phases"
    # (the four mid-tick phases) or "replicas" (engine step order)
    schedule_hook: Optional[Callable[[int, str, List], List]] = None

    def _schedule(self, tick: int, kind: str, names: List) -> List:
        """Ask the installed schedule hook (if any) for this tick's
        order of ``names``; the hook must return a permutation — the
        explorer probes orderings, it may not drop or invent work."""
        hook = self.schedule_hook
        if hook is None:
            return list(names)
        order = list(hook(tick, kind, list(names)))
        enforce_that(sorted(order, key=repr) == sorted(names, key=repr),
                     f"schedule_hook returned {order!r}, not a "
                     f"permutation of {names!r}", context="serving")
        return order

    def _step_replicas(self, tick: int, now: float) -> None:
        """Step every live replica (slow replicas skip their off
        ticks), harvest terminal engine statuses into fleet statuses,
        retire drained replicas — in hook-chosen order."""
        idxs = [rep.idx for rep in self.replicas]
        for idx in self._schedule(tick, "replicas", idxs):
            rep = self.replicas[idx]
            if rep.state is ReplicaState.DEAD:
                continue
            if self.faults is not None and \
                    not self.faults.replica_steps(rep.idx, tick):
                continue                      # slow replica: off tick
            if rep.engine.has_work:
                rep.engine.step()
                self._share(rep)
            self._harvest(rep, self._time())
            if rep.state is ReplicaState.DRAINING and \
                    not rep.engine.has_work:
                self._retire_replica(rep, now)

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Tick until the fleet drains (or ``max_ticks``); returns
        {fleet rid: tokens} for completions so far.  A full drain runs
        the fleet conservation check (FLEET-LEAK on violation)."""
        ticks = 0
        while self.has_work:
            self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        if not self.has_work:
            self.check_fleet_conservation()
        return {frid: fr.result for frid, fr in self._requests.items()
                if fr.result is not None}

    # ---- weighted fair queuing ----------------------------------

    def _drain_wfq(self, now: float) -> None:
        """Release buffered requests to dispatch in virtual-time order,
        bounded by the READY replicas' admission slack (two decode
        batches of headroom each, the same depth the affinity overflow
        tolerates) — so engine queues stay shallow and the WFQ, not
        FIFO arrival order, decides who runs next.  Buffered requests
        whose deadline lapsed are shed here: they never reached an
        engine, so the router is their deadline enforcer."""
        if self.wfq is None:
            return
        for tenant, freq in self.wfq.expire(
                lambda fr: fr.deadline_at is not None and
                now >= fr.deadline_at):
            self.ledger.on_shed(tenant)
            self._finish(freq, RequestStatus.TIMED_OUT, now)
        if not len(self.wfq):
            return
        budget = 0
        for rep in self._ready(set()):
            ld = rep.engine.load()
            budget += max(0, 2 * rep.engine._max_slots -
                          (ld["queue_depth"] + ld["running"]))
        while budget > 0:
            popped = self.wfq.pop()
            if popped is None:
                break
            tenant, freq = popped
            if freq.finished:
                continue       # raced a cancel; already ledgered there
            self.ledger.on_admit(tenant)
            budget -= 1
            self._dispatch(freq, now)

    # ---- dispatch / harvest ------------------------------------------------

    def _wrap_on_token(self, freq: _FleetRequest):
        return lambda tok: self._stream(freq, tok)

    def _stream(self, freq: _FleetRequest, tok: int) -> None:
        """Exactly-once stream fence: forward only tokens beyond the
        high-water mark, so a resubmitted (deterministically replayed)
        request never double-delivers."""
        freq.attempt_tokens += 1
        if freq.attempt_tokens > freq.emitted:
            freq.emitted += 1
            self.metrics.on_token(self._time(), tenant=freq.tenant)
            if freq.on_token is not None:
                freq.on_token(tok)

    def _on_token(self, rep: Replica, freq: _FleetRequest):
        """The engine-side stream callback of ``freq`` on ``rep``: over
        mesh slices on several ranks the tokens go to the replica's
        outbox, and :meth:`_share` streams them on every rank."""
        if rep.idx in self._planes:
            return lambda tok, f=freq.frid: rep.outbox.append((f, tok))
        return self._wrap_on_token(freq)

    def _has_cache(self, rep: Replica) -> bool:
        if isinstance(rep.engine, SliceProxy):
            return bool(rep.engine._view["has_cache"])
        return rep.engine.cache is not None

    def _hit_len(self, rep: Replica, tokens: Sequence[int]) -> int:
        """Tokens of ``tokens`` cached on ``rep``: every rank of its slice
        looks them up (a lookup touches the cache's LRU order), and the
        slice's first rank broadcasts its count."""
        plane = self._planes.get(rep.idx)
        hit = None
        if plane is None or dist.get_rank() in plane[2]:
            hit = rep.engine.cache.lookup(list(tokens))[1]
        if plane is None:
            return hit
        box = [hit]
        dist.broadcast_object_list(box, src=plane[1], group=plane[0])
        return hit if hit is not None else box[0]

    def _transfer(self, src: Replica, dest: Replica, export, apply):
        """Move pages from ``src`` to ``dest``: ``apply(dest engine,
        export(src engine))``.  Returns (what ``apply`` returned, the
        exported blob or None where this process exported none).  Over
        mesh slices on several ranks each source rank exports its own
        KV-head shard, sends it over the plane to the destination rank
        at the same position of its slice, and that rank applies it; the
        destination's first rank broadcasts its result, which every rank
        outside the destination slice returns."""
        sp, dp = self._planes.get(src.idx), self._planes.get(dest.idx)
        if sp is None:
            blob = export(src.engine)
            return apply(dest.engine, blob), blob
        me, group = dist.get_rank(), sp[0]
        blob = out = None
        if me in sp[2]:
            blob = export(src.engine)
            dist.send_object_list([blob], dst=dp[2][sp[2].index(me)],
                                  group=group)
        if me in dp[2]:
            box = [None]
            dist.recv_object_list(box, src=sp[2][dp[2].index(me)],
                                  group=group)
            out = apply(dest.engine, box[0])
        box = [out]
        dist.broadcast_object_list(box, src=dp[1], group=group)
        return (out if me in dp[2] else box[0]), blob

    def _share(self, rep: Replica, erid: Optional[int] = None):
        """After a call that changed replica ``rep``, in a fleet over
        mesh slices on several ranks: broadcast the outcome from the
        slice's first rank (``erid``, the rid the call was about, joins
        the statuses it carries), let a proxy take it, and stream its
        tokens on every rank.  Returns ``erid``, on a proxy the first
        rank's (engine rids count per process, so a proxy keys the
        replica's requests by the first rank's).  A no-op in one
        process."""
        plane = self._planes.get(rep.idx)
        if plane is None:
            return erid
        view = _broadcast_view(rep.engine, plane, rep.rid_map, erid,
                               rep.outbox)
        rep.outbox = []
        for frid, tok in view["tokens"]:
            self._stream(self._requests[frid], tok)
        return view["erid"] if isinstance(rep.engine, SliceProxy) else erid

    def _dispatch(self, freq: _FleetRequest, now: float) -> bool:
        """Route and submit; on engine-side REJECT (backpressure, drain
        race) the next-best replica is tried — the overflow path — and
        only when every READY replica refuses is the fleet rid REJECTED."""
        tried: Set[int] = set()
        while True:
            idx, hashes, affinity, seed_from = self._route(freq.prompt,
                                                           tried)
            if idx is None:
                self._finish(freq, RequestStatus.REJECTED, now)
                return False
            rep = self.replicas[idx]
            freq.attempt_tokens = 0
            remaining = None
            if freq.deadline_at is not None:
                remaining = freq.deadline_at - now   # may be <= 0: the
                #                     engine times it out on its next tick
            erid = self._share(rep, rep.engine.submit(
                freq.prompt, freq.max_tokens,
                on_token=self._on_token(rep, freq),
                deadline_s=remaining, now=now, tenant=freq.tenant))
            if rep.engine.status(erid) is RequestStatus.REJECTED:
                tried.add(idx)
                continue
            freq.replica, freq.erid = idx, erid
            record_transition("request_status", str(freq.status), "queued",
                              registry=self.registry)
            freq.status = RequestStatus.QUEUED
            rep.rid_map[erid] = freq.frid
            if self.routing == "affinity":
                self._record_owner(hashes, idx)   # RR never reads the map
            self.metrics.on_route(affinity)
            self.tracer.instant("route", cat="fleet", replica=idx,
                                frid=freq.frid, erid=erid,
                                affinity=affinity,
                                attempt=freq.resubmits)
            if seed_from is not None and self._disagg and \
                    self.migrate_budget > 0:
                # the prefix owner warms the chosen target through the
                # page plane — paced by the destination's migrate
                # budget, racing the request's own admission (a seed
                # that lands first saves the whole prefix re-prefill;
                # one that loses still warms the cache for the NEXT
                # prompt sharing the prefix)
                self._enqueue_seed(seed_from, idx, freq.prompt)
            return True

    def _resubmit(self, freq: _FleetRequest, now: float) -> None:
        if freq.resubmits >= self.resubmit_budget:
            # budget burned: a terminal FAILED, never an infinite
            # kill->resubmit->kill loop.  Checked BEFORE counting, so
            # `resubmits` reports re-dispatches that actually happened
            # (the documented meaning), not refused ones.
            self._finish(freq, RequestStatus.FAILED, now)
            return
        freq.resubmits += 1
        self.metrics.on_resubmit()
        self.registry.counter("fleet_resubmits_total",
                              "death-driven re-dispatches").inc()
        self.tracer.instant("resubmit", cat="fleet", frid=freq.frid,
                            attempt=freq.resubmits)
        if self._dispatch(freq, now) and freq.replica is not None:
            # re-adopt surviving pages: before the target
            # engine's next tick can admit (and re-prefill) the replayed
            # request, seed its cache from whichever surviving replica
            # still holds the deepest cached prefix — typically the
            # prefill replica whose parked pages outlived the dead
            # decoder.  Synchronous on purpose: this races admission
            # within the same fleet tick, and it is already budgeted by
            # the resubmit budget that gated this very call.
            self._seed_for_resubmit(freq)

    def _harvest(self, rep: Replica, now: float) -> None:
        """Pull terminal engine statuses up into fleet statuses; mirror
        live ones for observability."""
        done: List[Tuple[int, int, RequestStatus]] = []
        for erid, frid in rep.rid_map.items():
            st = rep.engine.status(erid)
            if st.terminal:
                done.append((erid, frid, st))
            else:
                freq = self._requests[frid]
                if freq.status is not st:
                    record_transition("request_status", str(freq.status),
                                      str(st), registry=self.registry)
                freq.status = st
        for erid, frid, st in done:
            del rep.rid_map[erid]
            freq = self._requests[frid]
            if freq.finished:
                # the rid map said this engine rid still owned the fleet
                # rid, yet the fleet already finished it elsewhere: an
                # idempotence violation the conservation check must see
                self.metrics.duplicate_completions += 1
                continue
            if st is RequestStatus.COMPLETED:
                freq.result = list(rep.engine.result(erid))
                self._finish(freq, st, now)
            elif st is RequestStatus.REJECTED:
                # post-admission REJECT = the engine shed it (unmeetable
                # deadline).  The deadline carries over resubmits, so
                # re-dispatching a lost cause would only burn budget.
                self._finish(freq, st, now, shed=True)
            else:                 # TIMED_OUT / FAILED / CANCELLED
                self._finish(freq, st, now)

    def _finish(self, freq: _FleetRequest, status: RequestStatus,
                now: float, shed: bool = False) -> None:
        """THE fleet terminal transition (mirrors the engine's _finish):
        stamp, count, unbind, retire — and count a second transition
        instead of silently overwriting it."""
        if freq.finished:
            self.metrics.duplicate_completions += 1
            return
        # a terminal transition aborts any in-flight chain handoff for
        # this rid — the pump would only discover a dangling transfer
        # later, and the migration ledger must balance at ANY drain
        if self._mig_pending.pop(freq.frid, None) is not None:
            self.metrics.on_migration_aborted()
            record_transition("migration_transfer", "started", "aborted",
                              registry=self.registry)
            self.tracer.instant("migrate_abort", cat="fleet",
                                frid=freq.frid, reason="terminal")
        record_transition("request_status", str(freq.status), str(status),
                          registry=self.registry)
        freq.status = status
        freq.terminal_transitions += 1
        freq.finished_at = now
        freq.replica = None
        freq.erid = None
        self._live.discard(freq.frid)
        self.metrics.on_terminal(status, shed=shed)
        self.tracer.async_end("fleet_request", id=freq.frid,
                              id_space="frid", status=str(status),
                              resubmits=freq.resubmits,
                              tokens=freq.emitted)
        self._retired.append(freq.frid)
        while len(self._retired) > self.max_retained:
            self._requests.pop(self._retired.popleft(), None)

    # ---- page migration ----------------------------------------

    def _enqueue_seed(self, src_idx: int, dest_idx: int,
                      prompt: Sequence[int]) -> None:
        """Queue a cross-replica prefix warm: ``src`` (the affinity
        owner) will push its cached prefix of ``prompt`` into ``dest``'s
        PrefixCache through the page plane.  Seeds ride the same
        per-destination credit as chain handoffs but are opportunistic —
        they drop silently when stale and never enter the migration
        ledger."""
        t = _Transfer(kind="seed", src=src_idx, dest=dest_idx, seq=-1,
                      tokens=[int(x) for x in prompt],
                      pages=max(1, len(prompt) // self._page_size()))
        self._mig_queues.setdefault(dest_idx, deque()).append(t)
        self.tracer.instant("seed_enqueue", cat="fleet", src=src_idx,
                            dest=dest_idx, tokens=len(t.tokens))

    def _scan_migratable(self) -> None:
        """Enqueue chain handoffs: every request on a prefill-class
        replica that has finished its prefill (first token emitted)
        moves to the least-loaded decode replica.  Runs after the
        engines step so a prefill completed THIS tick is picked up
        immediately; the transfer itself clears at the next tick's pump,
        charged against the destination's page credit."""
        if not (self._disagg and self.migrate_budget > 0):
            return
        decode_ready = [r for r in self.replicas
                        if r.state is ReplicaState.READY and
                        r.role == "decode"]
        if not decode_ready:
            return                 # no decode class left: prefill
            #                        replicas finish their own requests
        page = self._page_size()
        for rep in self.replicas:
            if rep.role != "prefill" or rep.state is ReplicaState.DEAD:
                continue
            for erid in rep.engine.migratable_rids():
                frid = rep.rid_map.get(erid)
                if frid is None:
                    continue
                freq = self._requests.get(frid)
                if freq is None or freq.finished or \
                        frid in self._mig_pending:
                    continue
                # least-loaded decode target, pending transfers included
                # (else every handoff this tick piles on one replica)
                dest = min(decode_ready, key=lambda r:
                           (len(self._mig_queues.get(r.idx, ())),) +
                           r.load_key())
                ereq = rep.engine._requests[erid]
                pages = -(-(ereq.cache_len + 1) // page)
                seq = self._mig_seq      # chain-only numbering: the
                self._mig_seq += 1       # fault plan's drop schedule
                #                          addresses the Nth HANDOFF
                t = _Transfer(kind="chain", src=rep.idx, dest=dest.idx,
                              seq=seq, frid=frid, erid=erid, pages=pages)
                self._mig_pending[frid] = t
                self._mig_queues.setdefault(dest.idx, deque()).append(t)
                self.metrics.on_migration_start()
                self.tracer.instant("migrate_start", cat="fleet",
                                    frid=frid, src=rep.idx, dest=dest.idx,
                                    seq=seq, pages=pages)

    def _pump_migrations(self, now: float) -> None:
        """Apply pending transfers, bounded per destination per tick by
        ``migrate_budget`` pages — the transfer plane's admission
        control, charged to the DESTINATION exactly like chunked
        prefill.  Unspent credit accrues while a transfer waits (a blob
        bigger than the budget lands after ceil(pages/budget) ticks) and
        resets when the queue drains, so an idle destination never banks
        a burst."""
        for dest_idx in list(self._mig_queues):
            q = self._mig_queues[dest_idx]
            credit = self._mig_credit.get(dest_idx, 0) + \
                self.migrate_budget
            while q:
                t = q[0]
                if t.kind == "chain" and \
                        self._mig_pending.get(t.frid) is not t:
                    q.popleft()       # aborted elsewhere (terminal rid)
                    continue
                viable, pages = self._transfer_viable(t)
                if not viable:
                    q.popleft()
                    self._abort_transfer(t, reason="stale")
                    continue
                if pages > credit:
                    break             # out of credit: resume next tick
                q.popleft()
                credit -= pages
                if t.kind == "seed":
                    self._apply_seed(t)
                elif self._apply_chain(t, now) == "retry":
                    # destination full right now (no slot / pages):
                    # refund and retry next tick — the source keeps
                    # decoding meanwhile, nothing is lost
                    q.appendleft(t)
                    credit += pages
                    break
            if q:
                self._mig_credit[dest_idx] = credit
            else:
                del self._mig_queues[dest_idx]
                self._mig_credit.pop(dest_idx, None)

    def _transfer_viable(self, t: _Transfer) -> Tuple[bool, int]:
        """(still worth applying?, pages to charge).  Chain transfers
        re-read the source request's CURRENT page count — it grew by its
        ongoing decode since enqueue."""
        dest = self.replicas[t.dest]
        if dest.state is not ReplicaState.READY:
            return False, 0
        src = self.replicas[t.src]
        if t.kind == "seed":
            if src.state is ReplicaState.DEAD or not self._has_cache(src):
                return False, 0
            return True, max(1, t.pages)
        freq = self._requests.get(t.frid)
        if freq is None or freq.finished or freq.replica != t.src or \
                freq.erid != t.erid or src.state is ReplicaState.DEAD:
            return False, 0           # rebound (death resubmit) or gone
        ereq = src.engine._requests.get(t.erid)
        if ereq is None or ereq.status is not RequestStatus.RUNNING or \
                ereq.prefilling or not ereq.generated:
            return False, 0
        return True, -(-(ereq.cache_len + 1) // self._page_size())

    def _abort_transfer(self, t: _Transfer, reason: str) -> None:
        if t.kind != "chain":
            return                    # seeds drop silently
        if self._mig_pending.pop(t.frid, None) is not None:
            self.metrics.on_migration_aborted()
            record_transition("migration_transfer", "started", "aborted",
                              registry=self.registry)
            self.tracer.instant("migrate_abort", cat="fleet",
                                frid=t.frid, reason=reason)

    def _apply_chain(self, t: _Transfer, now: float) -> str:
        """Execute one chain handoff.  Returns "retry" when the
        destination cannot host it right now; "done" otherwise (applied,
        or dropped-in-flight -> re-prefill fallback)."""
        src = self.replicas[t.src]
        dest = self.replicas[t.dest]
        freq = self._requests[t.frid]
        with self.tracer.span("migrate", cat="fleet", frid=t.frid,
                              src=t.src, dest=t.dest, seq=t.seq):
            # the export is a pure read: a blob dropped in flight is
            # never exported
            if self.faults is not None and \
                    self.faults.drop_migration(t.seq):
                # blob lost in flight: the source copy is already
                # committed to cancellation (the handoff was its exit),
                # so fall back to a plain re-prefill on the destination.
                # The exactly-once fence replays the already-emitted
                # tokens silently; greedy determinism makes the stream
                # identical.
                self._mig_pending.pop(t.frid, None)
                src.rid_map.pop(t.erid, None)
                if not src.engine.status(t.erid).terminal:
                    src.engine.cancel(t.erid, now=now)
                    self._share(src, t.erid)
                freq.replica = None
                freq.erid = None
                freq.attempt_tokens = 0
                remaining = None
                if freq.deadline_at is not None:
                    remaining = freq.deadline_at - now
                erid2 = self._share(dest, dest.engine.submit(
                    freq.prompt, freq.max_tokens,
                    on_token=self._on_token(dest, freq),
                    deadline_s=remaining, now=now, tenant=freq.tenant))
                if dest.engine.status(erid2) is RequestStatus.REJECTED:
                    self._dispatch(freq, now)     # full re-route
                else:
                    freq.replica, freq.erid = t.dest, erid2
                    record_transition("request_status", str(freq.status),
                                      "queued", registry=self.registry)
                    freq.status = RequestStatus.QUEUED
                    dest.rid_map[erid2] = t.frid
                self.metrics.on_migration_fallback()
                record_transition("migration_transfer", "started",
                                  "fallback", registry=self.registry)
                self.tracer.instant("migrate_fallback", cat="fleet",
                                    frid=t.frid, seq=t.seq)
                return "done"
            on_token = self._on_token(dest, freq)

            def splice(engine, blob):
                # a shard's bytes times the slice's ranks: the whole
                # chain's, as one process moves it
                return (import_chain(engine, blob, on_token=on_token,
                                     now=now), blob.num_pages,
                        blob.nbytes * engine.tp, len(blob.generated))

            (rid2, num_pages, nbytes, n_gen), blob = self._transfer(
                src, dest, lambda engine: export_chain(engine, t.erid),
                splice)
            rid2 = self._share(dest, rid2)
            if rid2 is None:
                return "retry"
            # the CURRENT attempt has materialized len(generated) tokens
            # — NOT freq.emitted: a handoff of a mid-replay resubmit
            # (emitted > generated) would otherwise mis-index the
            # destination's next token and forward the wrong one
            freq.attempt_tokens = n_gen
            self._mig_pending.pop(t.frid, None)
            # unbind BEFORE cancelling so _harvest never reads the
            # source's CANCELLED as this fleet rid's terminal status
            src.rid_map.pop(t.erid, None)
            if not src.engine.status(t.erid).terminal:
                # the source's full prefix pages stay parked in its
                # PrefixCache (RECLAIMABLE) — still exportable as seeds
                src.engine.cancel(t.erid, now=now)
                self._share(src, t.erid)
            freq.replica, freq.erid = t.dest, rid2
            record_transition("request_status", str(freq.status), "running",
                              registry=self.registry)
            freq.status = RequestStatus.RUNNING
            dest.rid_map[rid2] = t.frid
            if blob is not None and src.engine.host_tier is not None \
                    and src.engine.cache is not None:
                # the chain now lives on the destination: drop any host
                # copies the source spilled for it, so a later warm
                # restart of the source cannot re-adopt pages the
                # migration already handed off (double-adopt)
                src.engine.host_tier.forget(src.engine.cache.chain_keys(
                    blob.prompt + blob.generated))
            if self.routing == "affinity":
                # the chain's pages now live on the decode replica: it
                # is the deepest owner for this prompt's prefix
                self._record_owner(
                    prefix_chain_hashes(freq.prompt, self._page_size()),
                    t.dest)
            self.metrics.on_migration_applied(num_pages, nbytes)
            record_transition("migration_transfer", "started", "applied",
                              registry=self.registry)
            self.tracer.instant("migrate_apply", cat="fleet", frid=t.frid,
                                src=t.src, dest=t.dest,
                                pages=num_pages, bytes=nbytes)
        return "done"

    def _seed(self, src: Replica, dest: Replica,
              tokens: Sequence[int]) -> Tuple[int, int]:
        """Seed ``dest``'s cache with ``src``'s cached prefix of
        ``tokens``: (blocks, bytes), (0, 0) when ``src`` holds none."""

        def splice(engine, blob):
            if blob is None:
                return 0, 0           # the owner evicted it meanwhile
            blocks, nbytes = import_prefix(engine, blob)
            return blocks, nbytes * engine.tp

        (blocks, nbytes), _ = self._transfer(
            src, dest, lambda engine: export_prefix(engine, tokens), splice)
        self._share(dest)
        return blocks, nbytes

    def _apply_seed(self, t: _Transfer) -> None:
        blocks, nbytes = self._seed(self.replicas[t.src],
                                    self.replicas[t.dest], t.tokens)
        if blocks:
            self.metrics.on_seed(blocks, nbytes)
            self.tracer.instant("seed_apply", cat="fleet", src=t.src,
                                dest=t.dest, blocks=blocks, bytes=nbytes)

    def _seed_for_resubmit(self, freq: _FleetRequest) -> None:
        """Re-adopt surviving pages after a death resubmit: seed the
        resubmit target's cache from whichever live replica holds the
        DEEPEST cached prefix of the prompt, so the replay stitches onto
        imported pages instead of re-prefilling from token 0."""
        if not (self._disagg and self.migrate_budget > 0):
            return
        dest = self.replicas[freq.replica]
        if not self._has_cache(dest):
            return
        page = self._page_size()
        best, best_len = None, self._hit_len(dest, freq.prompt)
        for r in self.replicas:
            if r.idx == dest.idx or r.state is ReplicaState.DEAD or \
                    not self._has_cache(r):
                continue
            hit_len = self._hit_len(r, freq.prompt)
            if hit_len > best_len:
                best, best_len = r, hit_len
        if best is None or best_len < page:
            return                    # nobody holds more than the target
        blocks, nbytes = self._seed(best, dest, freq.prompt)
        if blocks:
            self.metrics.on_seed(blocks, nbytes)
            self.metrics.on_migration_resubmit()
            self.tracer.instant("readopt", cat="fleet", frid=freq.frid,
                                src=best.idx, dest=dest.idx,
                                blocks=blocks, bytes=nbytes)

    # ---- invariants / health ----------------------------------------------

    def check_fleet_conservation(self) -> None:
        """Fleet-wide conservation, valid at drain (raises
        :class:`PageLeakError` tagged ``FLEET-LEAK``):

        - every retained fleet rid sits at EXACTLY one terminal status
          (one terminal transition — no double completion, no overwrite,
          no rid left in flight);
        - ``duplicate_completions`` stayed 0;
        - every replica's pool — DEAD ones included, because death
          fencing cancels their in-flight work — passes the engine's
          PAGE/REF-LEAK check with zero live refs."""
        problems: List[str] = []
        for fr in self._requests.values():
            if not fr.status.terminal or fr.terminal_transitions != 1:
                problems.append(
                    f"frid {fr.frid}: status={fr.status} "
                    f"terminal_transitions={fr.terminal_transitions}")
        if self.metrics.duplicate_completions:
            problems.append(f"{self.metrics.duplicate_completions} "
                            "duplicate completions")
        for rep in self.replicas:
            try:
                rep.engine.check_page_conservation()
            except PageLeakError as e:
                problems.append(f"replica {rep.idx}: {e}")
            refs = rep.engine.pool.total_refs
            if refs != 0:
                problems.append(f"replica {rep.idx}: {refs} live page "
                                "refs after fleet drain")
        if problems:
            # flight recorder: ship the event history with the report
            # (once per router; no-op when tracing is off)
            if "FLEET-LEAK" not in self._postmortems_dumped:
                self._postmortems_dumped.add("FLEET-LEAK")
                self.tracer.dump_postmortem("FLEET-LEAK")
            raise PageLeakError("FLEET-LEAK: " + "; ".join(problems))

    def healthz(self) -> Dict[str, object]:
        """Fleet liveness snapshot: aggregate ok, per-replica state +
        load signals, and the idempotence counter."""
        reps = {}
        ok = True
        tenants: Dict[str, Dict[str, int]] = {}
        for rep in self.replicas:
            hz = rep.engine.healthz()
            if rep.state is not ReplicaState.DEAD and not hz["ok"]:
                ok = False
            # per-tenant fleet aggregation: sum each
            # replica's tenant_counts — dead replicas included, since
            # their historical deadline misses are still real
            for t, counts in hz["tenants"].items():
                agg = tenants.setdefault(
                    t, {"running": 0, "queued": 0, "pages_in_use": 0,
                        "pages_host": 0, "deadline_misses": 0,
                        "buffered": 0})
                for k, v in counts.items():
                    agg[k] = agg.get(k, 0) + v
            reps[rep.idx] = {
                "state": rep.state.value,
                "role": rep.role,
                "ok": hz["ok"],
                "queue_depth": hz["queue_depth"],
                "running": hz["running"],
                "free_pages": hz["free_pages"],
                "pages_host": hz.get("pages_host", 0),
                "prefill_backlog_tokens": hz["prefill_backlog_tokens"],
                "prefix_hit_rate": round(
                    rep.engine.metrics.prefix_hit_rate(), 4),
                "dead_reason": rep.dead_reason,
            }
        if self.metrics.duplicate_completions:
            ok = False
        if self.wfq is not None:
            for t, n in self.wfq.backlog().items():
                agg = tenants.setdefault(
                    t, {"running": 0, "queued": 0, "pages_in_use": 0,
                        "pages_host": 0, "deadline_misses": 0,
                        "buffered": 0})
                agg["buffered"] = n
        return {
            "ok": ok,
            "tick": self._tick,
            "in_flight": len(self._live),
            "ready": sum(1 for r in self.replicas
                         if r.state is ReplicaState.READY),
            "replicas": reps,
            "duplicate_completions": self.metrics.duplicate_completions,
            "deadline_miss_rate": round(
                self.metrics.deadline_miss_rate(), 4),
            # control-plane surfaces
            "tenants": tenants,
            "admission_ledger": self.ledger.snapshot(),
        }

    def snapshot(self) -> Dict[str, object]:
        """Fleet metrics + per-replica prefix stats in one JSON-able
        dict (the bench's one-line contract)."""
        snap = self.metrics.snapshot()
        requested = sum(r.engine.metrics.prefix_requested_tokens
                        for r in self.replicas)
        saved = sum(r.engine.metrics.prefill_tokens_saved
                    for r in self.replicas)
        snap["fleet_prefix_hit_rate"] = round(
            saved / requested, 4) if requested else 0.0
        snap["per_replica_prefix_hit_rate"] = [
            round(r.engine.metrics.prefix_hit_rate(), 4)
            for r in self.replicas]
        snap["replica_states"] = [r.state.value for r in self.replicas]
        if self.autoscaler is not None:
            snap["control_scale_ups"] = self.autoscaler.scale_ups
            snap["control_scale_downs"] = self.autoscaler.scale_downs
            snap["control_replica_ticks"] = self.autoscaler.replica_ticks
        # keep the unified registry current: fleet counters land next to
        # the replicas' serving_* series and stage histograms, so one
        # scrape surface (registry.snapshot()/to_text()) has it all
        self.metrics.publish(self.registry)
        return snap

    def metrics_text(self) -> str:
        """Prometheus-style exposition of the fleet's unified registry
        (publishes the latest fleet + per-replica counters first)."""
        self.metrics.publish(self.registry)
        for rep in self.replicas:
            rep.engine.metrics.publish(self.registry, replica=rep.idx)
        return self.registry.to_text()


# ---------------------------------------------------------------------------
# standalone gate: main(["check"])
# ---------------------------------------------------------------------------


def _selfcheck(device: DeviceLike = None) -> int:
    """Replay a small seeded kill-chaos trace and run the fleet
    conservation check, on ``device`` (default ``cuda``) — the JAX
    package's FLEET-LEAK gate.  Returns 0 (clean) or 1 (findings); a
    crash propagates as 2."""
    import numpy as np

    from paddle_tpu_torch.serving._gate import gate_model
    from paddle_tpu_torch.serving.faults import ManualClock

    model = gate_model(device)
    plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                          kill_at={6: 0})

    def mk(i, time_fn):
        return ServingEngine(model, eos_id=1, page_size=4, num_pages=32,
                             max_pages_per_seq=8, max_slots=4,
                             buckets=(8, 16), time_fn=time_fn,
                             device=device)

    fleet = FleetRouter(mk, 3, heartbeat_s=0.05, resubmit_budget=2,
                        faults=plan)
    rng = np.random.RandomState(0)
    system = rng.randint(2, 64, size=8).tolist()    # 2 full pages shared
    frids = [fleet.submit(system + rng.randint(2, 64, size=4).tolist(),
                          max_tokens=6) for _ in range(9)]
    fleet.run(max_ticks=500)        # drain runs check_fleet_conservation
    if fleet.has_work:
        print("FLEET-LEAK: fleet failed to drain within 500 ticks")
        return 1
    snap = fleet.snapshot()
    bad = [f for f in frids if not fleet.status(f).terminal]
    if bad or snap["fleet_duplicate_completions"]:
        print(f"FLEET-LEAK: non-terminal={bad} "
              f"dups={snap['fleet_duplicate_completions']}")
        return 1
    print(f"fleet-check ok: {snap['fleet_completed']} completed, "
          f"{snap['fleet_resubmits']} resubmits after 1 injected kill, "
          f"0 duplicate completions, 0 leaks across "
          f"{len(fleet.replicas)} replicas")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``check [--device D]``: the FLEET-LEAK gate (exit 0 clean, 1
    findings, 2 a crash).  Importable, so callers run it through
    ``python -c "...fleet.main(['check'])"`` — ``python -m`` would
    execute a second copy of this module beside the one
    ``paddle_tpu_torch.serving`` imported, with duplicate
    FleetRouter/ReplicaState classes."""
    from paddle_tpu_torch.serving._gate import run_gate

    return run_gate(argv, "fleet",
                    "python -m paddle_tpu_torch.serving.fleet check "
                    "[--device cpu|cuda]", _selfcheck)


if __name__ == "__main__":
    import sys

    sys.exit(main())
