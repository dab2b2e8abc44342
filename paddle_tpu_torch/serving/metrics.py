"""Serving metrics: the counters the bench (and any scraper) reads (a
copy of ``ServingMetrics`` and ``FleetMetrics`` from
``paddle_tpu/serving/metrics.py``, which is pure Python).

Kept deliberately flat — ``snapshot()`` returns one JSON-able dict so
a bench and an external exporter see the same numbers.  Time
handling: the engine stamps events with its clock (``time.monotonic``
or an injected ``ManualClock``) and the
throughput window runs from the first submission to the last emitted
token, so idle tails (drained engine waiting for arrivals) don't
deflate tokens/s.

SLO counters (round 8): every terminal status is counted —
``completed`` / ``timed_out`` / ``cancelled`` / ``failed`` /
``rejected`` — plus ``shed`` (queued requests early-rejected because
their deadline became unmeetable), ``retries`` (decode ticks re-run
after a transient device error), queue-wait p95, and
``deadline_miss_rate`` = (timed_out + shed) / (completed + timed_out +
shed): of the demand that wanted completion, the fraction that missed.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Sequence

# latency percentiles run over a bounded recent window, not full
# history: a long-lived engine must not grow metric memory per request
# (mirrors the engine's max_retained eviction) nor pay an ever-larger
# sort per snapshot
_WINDOW = 4096


def _p95(xs: Sequence[float]) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(0.95 * len(s)))]


class ServingMetrics:
    def __init__(self, pool_pages: int):
        self.pool_pages = max(1, pool_pages)
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.timed_out = 0
        self.cancelled = 0
        self.failed = 0
        self.shed = 0                 # early-rejected: deadline unmeetable
        self.retries = 0              # decode tick retries (transient errors)
        self.preemptions = 0
        self.ticks = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0       # tokens actually forwarded at prefill
        # unified-step shape (round 12): dispatches and row mix — the
        # whole point of the ragged kernel is fewer dispatches per unit
        # of work, so the bench reads these directly
        self.step_dispatches = 0      # unified-step device dispatches
        self.decode_rows = 0          # decode/verify rows shipped across
        #                               steps (k1 per speculating slot)
        self.decode_slots = 0         # slot participations (one per
        #                               running slot per step)
        self.prefill_rows = 0         # prefill-chunk rows shipped (padded)
        self.prefill_pad_rows = 0     # of the bucket, padding/alignment
        # speculative decoding (round 18)
        self.spec_ticks = 0           # verify ticks with >= 1 drafted token
        self.spec_tokens_proposed = 0  # drafted tokens shipped to verify
        self.spec_tokens_accepted = 0  # of those, accepted
        self.spec_rollbacks = 0       # verify walks that rejected >= 1 draft
        self.spec_suspended = 0       # slot-ticks speculation was suspended
        #                               (page pressure / no lookahead room)
        self.spec_cow_forks = 0       # verify-time COW forks (shared tail)
        self.draft_steps = 0          # draft-model dispatches (gauge)
        self.draft_time_s = 0.0       # wall time inside them (gauge)
        # prefix caching (round 9)
        self.prefix_requested_tokens = 0  # cache_tokens summed at admission
        self.prefill_tokens_saved = 0     # of those, served from the cache
        self.cow_forks = 0            # copy-on-write page forks
        self.cache_evictions = 0      # gauge: cache's cumulative evictions
        # hierarchical host tier (round 21): gauges stamped from
        # HostPageTier.snapshot() each tick / healthz — zeros with the
        # tier off, so the scrape schema is stable either way
        self.pages_host = 0           # gauge: host-resident spilled pages
        self.host_swap_ins = 0        # verified pages promoted to device
        self.host_swap_outs = 0       # pages ever spilled (staged)
        self.host_hits = 0            # swap-in events serving a request
        self.host_corrupt = 0         # checksum failures (never served)
        self.host_dropped = 0         # host-LRU drops / forgets
        self.spill_stall_ticks = 0    # pump ticks lost to slow host I/O
        self.queue_depth = 0          # gauge: last tick
        self.pages_in_use = 0         # gauge: last tick, LIVE holders only
        self.pages_cached = 0         # gauge: last tick, prefix-cache pages
        self.peak_pages_in_use = 0
        self.ttft_s = deque(maxlen=_WINDOW)
        self.queue_wait_s = deque(maxlen=_WINDOW)
        # multi-tenant series (round 17): deadline misses (timed_out +
        # shed) and queue-wait windows keyed by tenant — published as
        # LABELED series so one scrape surface splits SLO attainment by
        # tenant without N registries
        self.tenant_deadline_misses: Dict[str, int] = {}
        self.tenant_queue_wait_s: Dict[str, deque] = {}
        self._first_event_at: Optional[float] = None
        self._last_token_at: Optional[float] = None

    # ---- event hooks (called by the engine) ------------------------------

    def on_submit(self, now: float, accepted: bool) -> None:
        self.submitted += 1
        if not accepted:
            self.rejected += 1
        if self._first_event_at is None:
            self._first_event_at = now

    def on_prefill(self, n_tokens: int) -> None:
        self.prefill_tokens += n_tokens

    def on_step(self, n_decode_rows: int, n_prefill_rows: int,
                n_pad_rows: int, n_slots: Optional[int] = None) -> None:
        """One unified-step dispatch: how many decode/verify rows and
        (padded) prefill rows rode it, and how much of the prefill
        bucket was padding.  ``n_slots`` is the running-slot
        participation count — equal to the row count without
        speculation, 1/k1 of it with (each speculating slot ships k1
        verify rows).  ``fuse_tick=False`` (the v1 two-dispatch
        control) calls this twice per busy tick — the dispatch-count
        delta IS the A/B."""
        self.step_dispatches += 1
        self.decode_rows += n_decode_rows
        self.decode_slots += n_slots if n_slots is not None \
            else n_decode_rows
        self.prefill_rows += n_prefill_rows
        self.prefill_pad_rows += max(0, n_pad_rows)

    def on_prefix(self, requested: int, saved: int) -> None:
        """One admission's prefix-cache outcome: ``requested`` tokens
        wanted materializing, ``saved`` of them came stitched from the
        cache (0 on a miss or with caching off).  Re-admissions after
        preemption count again — saved recompute is still saved work."""
        self.prefix_requested_tokens += requested
        self.prefill_tokens_saved += saved

    def on_cow(self) -> None:
        self.cow_forks += 1

    def on_spec(self, proposed: int, accepted: int) -> None:
        """One slot's verify outcome this tick: ``proposed`` drafts rode
        the widened step, ``accepted`` of them survived the walk (a
        shortfall is a rollback)."""
        if proposed > 0:
            self.spec_ticks += 1
        self.spec_tokens_proposed += proposed
        self.spec_tokens_accepted += accepted
        if accepted < proposed:
            self.spec_rollbacks += 1

    def on_spec_suspend(self, n: int = 1) -> None:
        self.spec_suspended += n

    def on_spec_cow(self) -> None:
        self.spec_cow_forks += 1
        self.cow_forks += 1

    def on_draft(self, steps: int, seconds: float) -> None:
        """Absolute draft-proposer counters (gauges, stamped per tick)."""
        self.draft_steps = steps
        self.draft_time_s = seconds

    def on_admit(self, queue_wait_s: float) -> None:
        self.queue_wait_s.append(max(0.0, queue_wait_s))

    def on_tenant_admit(self, tenant: str, queue_wait_s: float) -> None:
        """Per-tenant half of :meth:`on_admit` (separate hook so legacy
        callers without tenant identity change nothing)."""
        self.tenant_queue_wait_s.setdefault(
            tenant, deque(maxlen=_WINDOW)).append(max(0.0, queue_wait_s))

    def on_tenant_miss(self, tenant: str) -> None:
        """A deadline miss (TIMED_OUT or shed) billed to ``tenant``."""
        self.tenant_deadline_misses[tenant] = \
            self.tenant_deadline_misses.get(tenant, 0) + 1

    def on_token(self, now: float, ttft_s: Optional[float] = None) -> None:
        self.tokens_generated += 1
        self._last_token_at = now
        if ttft_s is not None:
            self.ttft_s.append(ttft_s)

    def on_complete(self) -> None:
        self.completed += 1

    def on_timeout(self) -> None:
        self.timed_out += 1

    def on_cancel(self) -> None:
        self.cancelled += 1

    def on_fail(self) -> None:
        self.failed += 1

    def on_shed(self) -> None:
        self.shed += 1

    def on_retry(self) -> None:
        self.retries += 1

    def on_preempt(self, n: int) -> None:
        self.preemptions += n

    def on_host_tier(self, snap: Dict[str, int], host_hits: int) -> None:
        """Stamp the host-tier gauges from ``HostPageTier.snapshot()``
        plus the engine's hit counter (a hit is a swap-in EVENT that
        served a request; the tier only sees pages)."""
        self.pages_host = snap.get("pages_host", 0)
        self.host_swap_ins = snap.get("host_swap_ins", 0)
        self.host_swap_outs = snap.get("host_swap_outs", 0)
        self.host_corrupt = snap.get("host_corrupt", 0)
        self.host_dropped = snap.get("host_dropped", 0)
        self.spill_stall_ticks = snap.get("spill_stall_ticks", 0)
        self.host_hits = int(host_hits)

    def on_tick(self, queue_depth: int, pages_in_use: int,
                pages_cached: int = 0, cache_evictions: int = 0) -> None:
        self.ticks += 1
        self.queue_depth = queue_depth
        self.pages_in_use = pages_in_use
        self.pages_cached = pages_cached
        self.cache_evictions = cache_evictions
        self.peak_pages_in_use = max(self.peak_pages_in_use, pages_in_use)

    # ---- scrape ----------------------------------------------------------

    def tokens_per_s(self) -> float:
        if (self._first_event_at is None or self._last_token_at is None or
                self._last_token_at <= self._first_event_at):
            return 0.0
        return self.tokens_generated / (self._last_token_at -
                                        self._first_event_at)

    def ttft_ms_mean(self) -> float:
        if not self.ttft_s:
            return 0.0
        return 1000.0 * sum(self.ttft_s) / len(self.ttft_s)

    def ttft_ms_p95(self) -> float:
        return 1000.0 * _p95(self.ttft_s)

    def queue_wait_ms_p95(self) -> float:
        return 1000.0 * _p95(self.queue_wait_s)

    def deadline_miss_rate(self) -> float:
        demand = self.completed + self.timed_out + self.shed
        if demand == 0:
            return 0.0
        return (self.timed_out + self.shed) / demand

    def spec_acceptance_rate(self) -> float:
        """Of all drafted tokens shipped to verify, the fraction
        accepted — the number the 2-3x decode-multiplication claim
        rides on (tokens per verify tick = 1 + rate * k)."""
        if self.spec_tokens_proposed == 0:
            return 0.0
        return self.spec_tokens_accepted / self.spec_tokens_proposed

    def prefix_hit_rate(self) -> float:
        """Token-level hit rate: of all the prefill tokens admissions
        asked for, the fraction served from the prefix cache."""
        if self.prefix_requested_tokens == 0:
            return 0.0
        return self.prefill_tokens_saved / self.prefix_requested_tokens

    def publish(self, registry, **labels) -> None:
        """Publish every :meth:`snapshot` value into an obs
        :class:`~paddle_tpu_torch.obs.registry.MetricsRegistry` as gauges
        named ``serving_<key>`` (labels — typically ``replica=idx`` —
        keep multi-engine series apart).  Duck-typed on the registry so
        this module stays importable without obs."""
        for k, v in self.snapshot().items():
            registry.gauge("serving_" + k).labels(**labels).set(v)
        # tenant-labeled series (round 17): the per-tenant SLO split on
        # the SAME registry — publish is idempotent (gauges), so a
        # healthz probe and a scraper read identical numbers
        for t, n in self.tenant_deadline_misses.items():
            registry.gauge(
                "serving_deadline_miss_total",
                "deadline misses (timed_out + shed) by tenant"
            ).labels(tenant=t, **labels).set(n)
        for t, w in self.tenant_queue_wait_s.items():
            registry.gauge(
                "serving_queue_wait_ms",
                "p95 admission queue wait by tenant (recent window)"
            ).labels(tenant=t, **labels).set(round(1000.0 * _p95(w), 3))

    def snapshot(self) -> Dict[str, float]:
        return {
            "tokens_per_s": round(self.tokens_per_s(), 2),
            "ttft_ms_mean": round(self.ttft_ms_mean(), 3),
            "ttft_ms_p95": round(self.ttft_ms_p95(), 3),
            "queue_wait_ms_p95": round(self.queue_wait_ms_p95(), 3),
            "tokens_generated": self.tokens_generated,
            "prefill_tokens": self.prefill_tokens,
            "step_dispatches": self.step_dispatches,
            "decode_rows": self.decode_rows,
            "decode_slots": self.decode_slots,
            "prefill_rows": self.prefill_rows,
            "prefill_pad_rows": self.prefill_pad_rows,
            "prefix_hit_rate": round(self.prefix_hit_rate(), 4),
            "spec_ticks": self.spec_ticks,
            "spec_tokens_proposed": self.spec_tokens_proposed,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "spec_acceptance_rate": round(self.spec_acceptance_rate(), 4),
            "spec_rollbacks": self.spec_rollbacks,
            "spec_suspended": self.spec_suspended,
            "spec_cow_forks": self.spec_cow_forks,
            "draft_steps": self.draft_steps,
            "draft_time_s": round(self.draft_time_s, 6),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "cow_forks": self.cow_forks,
            "cache_evictions": self.cache_evictions,
            "pages_cached": self.pages_cached,
            "pages_host": self.pages_host,
            "host_swap_ins": self.host_swap_ins,
            "host_swap_outs": self.host_swap_outs,
            "host_hits": self.host_hits,
            "host_corrupt": self.host_corrupt,
            "host_dropped": self.host_dropped,
            "spill_stall_ticks": self.spill_stall_ticks,
            "requests_submitted": self.submitted,
            "requests_rejected": self.rejected,
            "requests_completed": self.completed,
            "requests_timed_out": self.timed_out,
            "requests_cancelled": self.cancelled,
            "requests_failed": self.failed,
            "requests_shed": self.shed,
            "deadline_miss_rate": round(self.deadline_miss_rate(), 4),
            "retries": self.retries,
            "preemptions": self.preemptions,
            "ticks": self.ticks,
            "queue_depth": self.queue_depth,
            "page_occupancy": round(self.pages_in_use / self.pool_pages, 4),
            "page_occupancy_peak": round(
                self.peak_pages_in_use / self.pool_pages, 4),
        }


class FleetMetrics:
    """Fleet-level counters (round 11): what the fleet bench and an
    external scraper read about the WHOLE deployment, as opposed to the
    per-replica :class:`ServingMetrics` each engine keeps.

    The load-bearing invariants live here as plain counters so the
    conservation check can assert them:

    - ``duplicate_completions`` MUST stay 0 — one fleet rid completes at
      most once, no matter how many replicas died under it;
    - ``resubmits`` counts death-driven re-dispatches (budgeted by the
      router; exhaustion ends in FAILED, never an infinite loop);
    - ``fleet_tokens_per_s`` runs over EMITTED tokens — the exactly-once
      stream the router forwards — so a request replayed on a survivor
      after a kill counts each token once, not once per attempt.
    """

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.timed_out = 0
        self.cancelled = 0
        self.failed = 0
        self.rejected = 0            # refused at (re-)dispatch: no capacity
        self.shed = 0                # engine-judged unmeetable deadline
        self.resubmits = 0           # death-driven re-dispatches
        self.duplicate_completions = 0   # idempotence violation: MUST be 0
        self.routed = 0              # successful dispatches (incl. resubmit)
        self.affinity_hits = 0       # of those, routed to the prefix owner
        self.tokens_emitted = 0      # exactly-once stream, all requests
        self.replicas_joined = 0
        self.replicas_dead = 0       # killed / lease-expired
        self.replicas_drained = 0    # clean DRAINING -> DEAD retirements
        # page-migration plane (round 16).  The conservation invariant:
        # every started migration ends exactly one way —
        #   migrations_started == applied + fallbacks + aborted
        # (applied = chain spliced into the destination; fallback = blob
        # dropped in flight, destination re-prefills; aborted = the
        # source request reached a terminal status before the transfer
        # cleared admission).
        self.migrations_started = 0
        self.migrations_applied = 0
        self.migration_fallbacks = 0
        self.migrations_aborted = 0
        self.pages_migrated = 0      # pages spliced by applied handoffs
        self.migration_bytes = 0     # host-blob payload bytes, applied only
        self.cross_replica_seeds = 0  # prefix exports that warmed a peer
        self.seed_pages = 0
        self.seed_bytes = 0
        self.migration_resubmits = 0  # death resubmits that re-adopted pages
        # crash-warm restart (round 21): a dead replica's host tier
        # outlives its engine; restart_replica re-verifies and re-adopts
        # it instead of starting cold
        self.warm_restarts = 0        # restart_replica calls that adopted
        self.pages_restored = 0       # host pages verified + re-adopted
        # multi-tenant split (round 17): exactly-once emitted tokens by
        # tenant — same stream as ``tokens_emitted``, partitioned so the
        # scrape surface can bill goodput per tenant
        self.tenant_tokens: Dict[str, int] = {}
        self._first_event_at: Optional[float] = None
        self._last_token_at: Optional[float] = None

    # ---- event hooks (called by the FleetRouter) --------------------------

    def on_submit(self, now: float) -> None:
        self.submitted += 1
        if self._first_event_at is None:
            self._first_event_at = now

    def on_route(self, affinity: bool) -> None:
        self.routed += 1
        if affinity:
            self.affinity_hits += 1

    def on_resubmit(self) -> None:
        self.resubmits += 1

    def on_migration_start(self) -> None:
        self.migrations_started += 1

    def on_migration_applied(self, pages: int, nbytes: int) -> None:
        self.migrations_applied += 1
        self.pages_migrated += int(pages)
        self.migration_bytes += int(nbytes)

    def on_migration_fallback(self) -> None:
        self.migration_fallbacks += 1

    def on_migration_aborted(self) -> None:
        self.migrations_aborted += 1

    def on_seed(self, pages: int, nbytes: int) -> None:
        self.cross_replica_seeds += 1
        self.seed_pages += int(pages)
        self.seed_bytes += int(nbytes)

    def on_migration_resubmit(self) -> None:
        self.migration_resubmits += 1

    def on_warm_restart(self, pages: int) -> None:
        self.warm_restarts += 1
        self.pages_restored += int(pages)

    def on_token(self, now: float, tenant: Optional[str] = None) -> None:
        self.tokens_emitted += 1
        if tenant is not None:
            self.tenant_tokens[tenant] = self.tenant_tokens.get(tenant, 0) + 1
        self._last_token_at = now

    def on_terminal(self, status, shed: bool = False) -> None:
        if shed:
            self.shed += 1
            return
        key = {"completed": "completed", "timed_out": "timed_out",
               "cancelled": "cancelled", "failed": "failed",
               "rejected": "rejected"}[str(status)]
        setattr(self, key, getattr(self, key) + 1)

    # ---- scrape ----------------------------------------------------------

    def fleet_tokens_per_s(self) -> float:
        if (self._first_event_at is None or self._last_token_at is None or
                self._last_token_at <= self._first_event_at):
            return 0.0
        return self.tokens_emitted / (self._last_token_at -
                                      self._first_event_at)

    def deadline_miss_rate(self) -> float:
        """Of the demand that wanted completion, the fraction that
        missed — same definition as the per-engine metric, but over
        fleet terminal statuses.  An engine-side TIMED_OUT is harvested
        as fleet-terminal even on a dying replica (deadlines carry over
        as absolute times, so the resubmit could never make it): it
        counts as a miss, never as timeout-then-recover."""
        demand = self.completed + self.timed_out + self.shed
        if demand == 0:
            return 0.0
        return (self.timed_out + self.shed) / demand

    def publish(self, registry, **labels) -> None:
        """Publish every :meth:`snapshot` value (already
        ``fleet_``-prefixed) into an obs registry as gauges — the
        fleet-level half of the one-scrape-surface contract."""
        for k, v in self.snapshot().items():
            registry.gauge(k).labels(**labels).set(v)
        # tenant-labeled goodput (round 17): the exactly-once token
        # stream split by tenant, one labeled gauge per tenant on the
        # same registry (idempotent re-publish, like every fleet gauge)
        for t, n in self.tenant_tokens.items():
            registry.gauge(
                "fleet_tokens_total",
                "exactly-once emitted tokens by tenant"
            ).labels(tenant=t, **labels).set(n)

    def snapshot(self) -> Dict[str, float]:
        return {
            "fleet_tokens_per_s": round(self.fleet_tokens_per_s(), 2),
            "fleet_tokens_emitted": self.tokens_emitted,
            "fleet_submitted": self.submitted,
            "fleet_completed": self.completed,
            "fleet_timed_out": self.timed_out,
            "fleet_cancelled": self.cancelled,
            "fleet_failed": self.failed,
            "fleet_rejected": self.rejected,
            "fleet_shed": self.shed,
            "fleet_deadline_miss_rate": round(self.deadline_miss_rate(), 4),
            "fleet_resubmits": self.resubmits,
            "fleet_duplicate_completions": self.duplicate_completions,
            "fleet_routed": self.routed,
            "fleet_affinity_hits": self.affinity_hits,
            "fleet_replicas_joined": self.replicas_joined,
            "fleet_replicas_dead": self.replicas_dead,
            "fleet_replicas_drained": self.replicas_drained,
            "fleet_migrations_started": self.migrations_started,
            "fleet_migrations_applied": self.migrations_applied,
            "fleet_migration_fallbacks": self.migration_fallbacks,
            "fleet_migrations_aborted": self.migrations_aborted,
            "fleet_pages_migrated": self.pages_migrated,
            "fleet_migration_bytes": self.migration_bytes,
            "fleet_cross_replica_seeds": self.cross_replica_seeds,
            "fleet_seed_pages": self.seed_pages,
            "fleet_seed_bytes": self.seed_bytes,
            "fleet_migration_resubmits": self.migration_resubmits,
            "fleet_warm_restarts": self.warm_restarts,
            "fleet_pages_restored": self.pages_restored,
        }
