"""Serving metrics: the counters the bench (and any scraper) reads (a
copy of ``ServingMetrics`` from ``paddle_tpu/serving/metrics.py``, which
is pure Python; ``FleetMetrics`` comes with the fleet slice).

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
