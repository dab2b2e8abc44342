"""Serving metrics: the counters a bench or scraper reads (the
``ServingMetrics`` half of ``paddle_tpu/serving/metrics.py``, without the
counters of the parts not ported yet: speculation, the host tier,
tenants, fleets).

``snapshot()`` returns one flat JSON-able dict.  The engine stamps events
with its clock and the throughput window runs from the first submission
to the last emitted token, so idle tails don't deflate tokens/s.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Sequence

# latency percentiles run over a bounded recent window, not full history
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
        self.preemptions = 0
        self.ticks = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0       # tokens actually forwarded at prefill
        self.step_dispatches = 0      # unified-step device dispatches
        self.decode_rows = 0          # decode rows shipped across steps
        self.decode_slots = 0         # slot participations
        self.prefill_rows = 0         # prefill-chunk rows shipped (padded)
        self.prefill_pad_rows = 0     # of the bucket, padding/alignment
        self.prefix_requested_tokens = 0  # cache_tokens summed at admission
        self.prefill_tokens_saved = 0     # of those, served from the cache
        self.cow_forks = 0            # copy-on-write page forks
        self.cache_evictions = 0      # gauge: cache's cumulative evictions
        self.queue_depth = 0          # gauge: last tick
        self.pages_in_use = 0         # gauge: last tick, live holders only
        self.pages_cached = 0         # gauge: last tick, prefix-cache pages
        self.peak_pages_in_use = 0
        self.ttft_s = deque(maxlen=_WINDOW)
        self.queue_wait_s = deque(maxlen=_WINDOW)
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
        """One unified-step dispatch and its row mix."""
        self.step_dispatches += 1
        self.decode_rows += n_decode_rows
        self.decode_slots += n_slots if n_slots is not None \
            else n_decode_rows
        self.prefill_rows += n_prefill_rows
        self.prefill_pad_rows += max(0, n_pad_rows)

    def on_prefix(self, requested: int, saved: int) -> None:
        self.prefix_requested_tokens += requested
        self.prefill_tokens_saved += saved

    def on_cow(self) -> None:
        self.cow_forks += 1

    def on_admit(self, queue_wait_s: float) -> None:
        self.queue_wait_s.append(max(0.0, queue_wait_s))

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

    def on_preempt(self, n: int) -> None:
        self.preemptions += n

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

    def prefix_hit_rate(self) -> float:
        """Of all prefill tokens admissions asked for, the fraction served
        from the prefix cache."""
        if self.prefix_requested_tokens == 0:
            return 0.0
        return self.prefill_tokens_saved / self.prefix_requested_tokens

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
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "cow_forks": self.cow_forks,
            "cache_evictions": self.cache_evictions,
            "pages_cached": self.pages_cached,
            "requests_submitted": self.submitted,
            "requests_rejected": self.rejected,
            "requests_completed": self.completed,
            "requests_timed_out": self.timed_out,
            "requests_cancelled": self.cancelled,
            "requests_failed": self.failed,
            "requests_shed": self.shed,
            "deadline_miss_rate": round(self.deadline_miss_rate(), 4),
            "preemptions": self.preemptions,
            "ticks": self.ticks,
            "queue_depth": self.queue_depth,
            "page_occupancy": round(self.pages_in_use / self.pool_pages, 4),
            "page_occupancy_peak": round(
                self.peak_pages_in_use / self.pool_pages, 4),
        }
