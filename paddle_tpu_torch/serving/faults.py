"""Deterministic fault injection for the serving engine.

A copy of ``paddle_tpu/serving/faults.py``: it is pure Python with numpy,
and its seeded streams are the reference's ``RandomState(seed)``,
``(seed + 1)``, ``(seed + 2)`` and ``(seed + 3)``, so a fault trace
replays the same on both packages.  The lease machinery of
``master/service.py`` takes an injectable ``time_fn``; this module is
the serving analog: a seedable :class:`FaultPlan` threaded
through ``ServingEngine(faults=...)`` so every guardrail (deadlines,
watchdog, tick retry, NaN isolation, load shedding) is exercised by CI
without wall-clock dependence.

Injection points (all host-side, all deterministic):

- **clock** — a :class:`ManualClock` the engine reads instead of
  ``time.monotonic``; it advances ``tick_s`` per engine tick plus any
  extra from ``slow_ticks`` (tick -> added seconds), so deadline and
  queue-wait paths fire on chosen ticks.
- **decode-step exceptions** — ``decode_errors`` (tick -> number of
  attempts that raise :class:`InjectedDeviceError`) and/or a seeded
  ``decode_error_rate``; the engine's tick-level retry absorbs
  transient ones, persistent ones feed the watchdog.
- **NaN logits** — rids in ``nan_rids`` get their decode-logits row
  overwritten with NaN *before* the engine's finite-guard runs, proving
  the guard fails only the poisoned slot.
- **page-pool pressure** — ``page_pressure=(start_tick, end_tick, n)``
  steals up to ``n`` pages from the pool for the window, forcing
  growth-time preemption and admission stalls; the pages are returned
  at ``end_tick`` (or at drain) and counted by the leak checker while
  held.
- **prefix-cache hash collisions** — ``hash_collisions=True`` replaces
  the cache's chained block hash with a constant, so EVERY block keys
  identically; the cache's token verification must turn the collisions
  into misses, proving a hash break degrades throughput, never
  correctness.
- **cache eviction storm** — ``cache_storm=(start_tick, end_tick)``
  flushes every refcount-0 cached page each tick of the window,
  exercising eviction/re-insert churn and the REF-LEAK invariant.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = ["FaultPlan", "FleetFaultPlan", "ManualClock",
           "InjectedDeviceError", "PageLeakError"]


class InjectedDeviceError(RuntimeError):
    """A fault-plan-injected transient device failure (the stand-in for a
    step that dies before it runs: a launch error, a lost context), raised
    by the engine's step retry loop and absorbed there."""


class PageLeakError(AssertionError):
    """Free-list conservation violated.  The message always contains the
    literal token of the check that tripped (``PAGE-LEAK``, ``REF-LEAK``,
    ``HOSTTIER-LEAK``, ``FLEET-LEAK``, ``MIGRATE-LEAK``, ``CONTROL-LEAK``)
    so CI logs can be grepped."""


class ManualClock:
    """A monotonic clock the test (or the engine, via a FaultPlan)
    advances by hand — the serving twin of ``time_fn`` in
    ``master/service.py``."""

    def __init__(self, start: float = 0.0, tick_s: float = 0.001):
        self.t = float(start)
        self.tick_s = float(tick_s)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


@dataclass
class FaultPlan:
    """A seeded, replayable schedule of injected failures.

    Mutable on purpose: rids are assigned at ``submit``, so tests poison
    them after submission (``plan.poison_nan(rid)``).  Randomized
    injection (``decode_error_rate``) draws from its own
    ``RandomState(seed)``, one draw per tick, so a plan replays
    identically across runs.
    """

    seed: int = 0
    clock: Optional[ManualClock] = None
    nan_rids: Set[int] = field(default_factory=set)
    # tick -> how many decode attempts at that tick raise (1 = transient,
    # absorbed by the engine's retry; >= retry budget = persistent)
    decode_errors: Dict[int, int] = field(default_factory=dict)
    decode_error_rate: float = 0.0
    slow_ticks: Dict[int, float] = field(default_factory=dict)
    page_pressure: Optional[Tuple[int, int, int]] = None
    held_pages: List[int] = field(default_factory=list)
    # prefix-cache faults
    hash_collisions: bool = False
    cache_storm: Optional[Tuple[int, int]] = None
    # host-tier faults: keyed by SPILL SEQUENCE number (the
    # tier's monotonically increasing per-engine counter), not by tick —
    # a spill's commit slides under slow-I/O windows, its seq doesn't.
    # ``torn_spill_at`` zeroes the tail half of the staged V bytes at
    # commit; ``bitflip_spill_at`` XORs one seeded byte of K; both are
    # taken AFTER the checksum, so verification must catch them.
    # ``slow_host_io=(start_tick, end_tick)`` stalls the depth-one
    # writer's pump for the window (counted as spill_stall_ticks).
    torn_spill_at: Set[int] = field(default_factory=set)
    bitflip_spill_at: Set[int] = field(default_factory=set)
    slow_host_io: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        # separate stream for host-tier byte offsets (same pattern as
        # the fleet plan's migration/storm RNGs): adding host faults
        # never perturbs the decode-error schedule
        self._host_rng = np.random.RandomState(self.seed + 3)
        self._rate_fail_tick: int = -1

    # ---- hooks the engine calls ------------------------------------------

    def poison_nan(self, rid: int) -> "FaultPlan":
        self.nan_rids.add(rid)
        return self

    def tick_begin(self, tick: int) -> None:
        """Advance the injected clock for this tick (base tick_s plus any
        scheduled slowness).  No-op without a ManualClock."""
        if self.clock is not None:
            self.clock.advance(self.clock.tick_s +
                               self.slow_ticks.get(tick, 0.0))

    def decode_should_fail(self, tick: int, attempt: int) -> bool:
        budget = self.decode_errors.get(tick, 0)
        if attempt < budget:
            return True
        if self.decode_error_rate > 0.0:
            if self._rate_fail_tick < tick:
                # one draw per tick regardless of retries, so the retry
                # path doesn't perturb the random schedule
                self._rate_fail_tick = tick
                self._rate_hit = bool(self._rng.random_sample() <
                                      self.decode_error_rate)
            # a random hit poisons exactly the first attempt (transient)
            return self._rate_hit and attempt == 0 and budget == 0
        return False

    def apply_page_pressure(self, tick: int, pool) -> None:
        """Steal up to ``n`` pages across the window, return them at the
        end.  Acquisition retries every tick of the window and
        accumulates — a pool that is fully busy at the start tick still
        gets squeezed as pages free up, so the pressure engages exactly
        when contention is highest."""
        if self.page_pressure is None:
            return
        start, end, n = self.page_pressure
        if start <= tick < end:
            want = int(n) - len(self.held_pages)
            if want > 0 and pool.num_free > 0:
                got = pool.alloc(min(want, pool.num_free))
                if got:
                    self.held_pages.extend(got)
        elif tick >= end and self.held_pages:
            self.release_pressure(pool)

    def release_pressure(self, pool) -> None:
        if self.held_pages:
            pool.free(self.held_pages)
            self.held_pages = []

    def cache_hash_fn(self):
        """The prefix cache's hash override: a constant under
        ``hash_collisions`` (every block collides; token verification
        must carry correctness alone), else None (default hash)."""
        if self.hash_collisions:
            return lambda prev, block: 0xC0111DE
        return None

    def spill_is_torn(self, seq: int) -> bool:
        """True when host-tier spill number ``seq`` commits torn (its
        tail bytes never land)."""
        return seq in self.torn_spill_at

    def spill_bitflip_offset(self, seq: int, nbytes: int) -> Optional[int]:
        """Byte offset to corrupt in spill ``seq``'s K payload, or None.
        One draw from the dedicated host RNG per scheduled flip — drawn
        only for scheduled seqs, so the schedule replays identically
        regardless of how many clean spills interleave."""
        if seq not in self.bitflip_spill_at:
            return None
        return int(self._host_rng.randint(max(1, int(nbytes))))

    def host_io_stalled(self, tick: int) -> bool:
        """True inside the slow-host-I/O window: the depth-one writer's
        pump skips this tick (the staged spill rides along)."""
        if self.slow_host_io is None:
            return False
        start, end = self.slow_host_io
        return start <= tick < end

    def apply_cache_storm(self, tick: int, cache) -> int:
        """Inside the ``cache_storm`` window, flush every reclaimable
        cached page this tick; returns how many were evicted."""
        if cache is None or self.cache_storm is None:
            return 0
        start, end = self.cache_storm
        if start <= tick < end:
            return cache.flush()
        return 0


@dataclass
class FleetFaultPlan:
    """Fleet-level injected failures (``FleetRouter(faults=...)``): the
    per-engine :class:`FaultPlan` kills ticks and slots; this one kills
    REPLICAS.  Same determinism contract — one injected clock the fleet
    advances per tick, scheduled faults keyed by fleet tick, and a
    seeded RNG for the randomized flavor — so a chaos trace replays
    bit-identically.

    Injection points (all host-side):

    - **replica kill** — ``kill_at`` (fleet tick -> replica index)
      marks the replica DEAD at the top of that tick, before it steps:
      its in-flight requests resubmit to survivors.  ``kill_rate`` draws
      once per tick from ``RandomState(seed)`` and kills one seeded-
      random READY replica on a hit.
    - **slow replica** — ``slow_replicas`` (replica index -> period):
      the replica only steps every ``period`` fleet ticks, so its queue
      backs up and healthz-driven balancing must route around it.
    - **heartbeat partition** — ``partitions`` (replica index ->
      (start_tick, end_tick)): the replica's heartbeats are suppressed
      for the window.  Longer than the lease TTL, the fleet declares it
      DEAD; when the partition heals, its stale lease token can no
      longer ack (the zombie-fencing contract from master/service.py).
    - **migration drop** — ``drop_migration_at`` (migration sequence
      numbers) and/or a seeded ``migration_drop_rate``: the page blob is
      lost in flight between export and import, and the router must fall
      back to re-prefilling on the destination (counted as
      ``migration_fallbacks``) with the exactly-once token stream
      preserved.  Draws come from a SEPARATE ``RandomState(seed + 1)``
      so adding migration faults never perturbs the kill schedule.
    - **tenant storm** — ``tenant_storm`` ((tenant, start_tick,
      end_tick, multiplier)): one tenant's arrival rate multiplies by
      ``multiplier`` (plus seeded 0/+1 jitter) for every tick in the
      window — the adversarial load swing the control plane's WFQ must
      isolate.  Jitter draws come from a SEPARATE
      ``RandomState(seed + 2)`` (same pattern as the migration stream)
      so adding a storm never perturbs kill or migration schedules.
    """

    seed: int = 0
    clock: Optional[ManualClock] = None
    kill_at: Dict[int, int] = field(default_factory=dict)
    kill_rate: float = 0.0
    slow_replicas: Dict[int, int] = field(default_factory=dict)
    partitions: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    # page-migration faults
    migration_drop_rate: float = 0.0
    drop_migration_at: Set[int] = field(default_factory=set)
    # multi-tenant storm: (tenant, start_tick, end_tick,
    # multiplier) — None disables
    tenant_storm: Optional[Tuple[str, int, int, int]] = None

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        self._mig_rng = np.random.RandomState(self.seed + 1)
        self._storm_rng = np.random.RandomState(self.seed + 2)

    def tick_begin(self, tick: int) -> None:
        """Advance the injected clock for this fleet tick (all replicas
        share it).  No-op without a ManualClock."""
        if self.clock is not None:
            self.clock.advance(self.clock.tick_s)

    def kills(self, tick: int, ready: List[int]) -> List[int]:
        """Replica indices to kill at this tick: the scheduled one plus
        at most one seeded-random victim from ``ready``."""
        out: List[int] = []
        if tick in self.kill_at:
            out.append(self.kill_at[tick])
        if self.kill_rate > 0.0 and ready:
            # one draw per tick whether or not it hits, so the schedule
            # is independent of fleet state
            hit = bool(self._rng.random_sample() < self.kill_rate)
            pick = int(self._rng.randint(len(ready)))
            if hit:
                out.append(ready[pick])
        return out

    def replica_steps(self, idx: int, tick: int) -> bool:
        """False when a slow replica skips this fleet tick."""
        period = self.slow_replicas.get(idx, 1)
        return period <= 1 or tick % period == 0

    def heartbeat_blocked(self, idx: int, tick: int) -> bool:
        win = self.partitions.get(idx)
        return win is not None and win[0] <= tick < win[1]

    def drop_migration(self, seq: int) -> bool:
        """True when migration number ``seq`` (the router's monotonically
        increasing per-fleet counter) loses its blob in flight.  One
        draw per call from the dedicated migration RNG, whether or not
        ``migration_drop_rate`` is set, so scheduled and randomized
        flavors replay identically when combined."""
        hit = bool(self._mig_rng.random_sample() < self.migration_drop_rate)
        return seq in self.drop_migration_at or hit

    def storm_factor(self, tick: int, tenant: str) -> int:
        """Arrival-rate multiplier for ``tenant`` at ``tick``: 1 outside
        the storm window (or for other tenants), ``multiplier`` plus
        seeded 0/+1 jitter inside it.  One jitter draw per call whenever
        a storm is configured — window hit or not — so the stream stays
        aligned across replays regardless of who asks on which tick."""
        if self.tenant_storm is None:
            return 1
        who, start, end, mult = self.tenant_storm
        jitter = int(self._storm_rng.randint(2))
        if tenant != who or not (start <= tick < end):
            return 1
        return max(1, int(mult) + jitter)
