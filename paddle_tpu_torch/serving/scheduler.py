"""Continuous-batching scheduler: the host-side policy of the serving
engine (a copy of ``paddle_tpu/serving/scheduler.py``, which is pure
Python; only the imports differ).

The reference served generation through ``SequenceGenerator``
(paddle/api/SequenceGenerator.cpp:38-96) — one request at a time, one
host->C++ forward per token.  Here requests arrive and finish at
different times and the chip must stay busy throughout, so scheduling is
continuous: every engine tick (1) admits queued requests while slots AND
pages are available, (2) prefills them bucketed to a small ladder of
padded lengths (one jit specialization per bucket), (3) runs ONE fused
decode step over all running sequences, (4) retires sequences on EOS or
``max_tokens`` and returns their pages, and (5) when the page pool runs
dry mid-decode, preempts the youngest running sequence (its pages are
freed, its tokens re-queued for re-prefill — the recompute flavour of
vLLM-style preemption) so the oldest requests always make progress.

Robustness policy (the SLO layer the engine drives):

- every request carries a terminal-status :class:`RequestStatus` and
  optional queue/total deadlines;
- re-prefill recomputes are CAPPED per request
  (``SchedulerConfig.preempt_budget``): a request that has burned its
  budget is never chosen as a preemption victim again and requeues with
  escalated priority (ahead of every non-escalated entry), so
  youngest-first preemption cannot livelock a long prompt;
- ``release`` takes the terminal status, so timeout/cancel/failure all
  share one slot-and-pages return path.

This module is pure bookkeeping — no torch.  The engine owns the device
step and calls into the scheduler for decisions, so the policy is
testable without a model.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Deque, Dict, List, Optional, Tuple

from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.serving.kv_cache import PagePool, PrefixCache

_rid_counter = itertools.count()


class RequestStatus(str, Enum):
    """Request lifecycle.  ``str``-valued so existing comparisons against
    the literal strings keep working (``req.status == "queued"``)."""

    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"      # evicted, waiting to re-prefill
    COMPLETED = "completed"
    TIMED_OUT = "timed_out"
    CANCELLED = "cancelled"
    REJECTED = "rejected"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL

    def __str__(self) -> str:  # "completed", not "RequestStatus.COMPLETED"
        return self.value


_TERMINAL = frozenset({RequestStatus.COMPLETED, RequestStatus.TIMED_OUT,
                       RequestStatus.CANCELLED, RequestStatus.REJECTED,
                       RequestStatus.FAILED})


@dataclass
class Request:
    """One generation request and its runtime bookkeeping."""

    prompt: List[int]
    max_tokens: int
    on_token: Optional[Callable[[int], None]] = None
    # sampling policy (None = greedy argmax, the parity-test contract);
    # a SamplingParams from serving.speculate with seeded per-position
    # RNG streams, so replays are bit-identical
    sampling: Optional[object] = None
    # multi-tenant identity (round 17): who this request bills to.  The
    # control plane (serving/control.py) keys SLO deadlines, quotas and
    # preemption precedence on it; it survives preemption, death
    # resubmission and chain migration unchanged.
    tenant: str = "default"
    rid: int = field(default_factory=lambda: next(_rid_counter))
    # SLOs (absolute times on the engine's clock; None = unbounded)
    queue_deadline_at: Optional[float] = None   # must be admitted by
    deadline_at: Optional[float] = None         # must finish by

    # runtime state (owned by the scheduler/engine)
    generated: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    cache_len: int = 0              # tokens currently materialized in KV
    status: RequestStatus = RequestStatus.QUEUED
    submitted_at: Optional[float] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    preemptions: int = 0
    escalated: bool = False         # preempt budget burned: never a victim
    last_progress_tick: int = 0     # engine tick of the last emitted token
    # prefix caching + chunked prefill (round 9)
    cached_len: int = 0             # prefix tokens stitched from the cache
    cow_src: Optional[int] = None   # shared page to COW-fork before prefill
    prefilling: bool = False        # admitted but chunks still
    #                                 materializing; False once decoding
    # cache-insert chain cursor (engine-owned, reset per admission):
    # chunk j's insert resumes hashing where chunk j-1 stopped
    chain_hash: Optional[int] = None
    chain_blocks: int = 0
    # speculative decoding (round 18): per-request acceptance counters
    # (the per-slot acceptance-rate observable)
    spec_proposed: int = 0          # drafted tokens shipped to verify
    spec_accepted: int = 0          # of those, accepted

    @property
    def cache_tokens(self) -> List[int]:
        """Tokens that must be in the KV cache before the next decode:
        the prompt plus everything generated so far (after a preemption
        the whole list is re-prefilled and the prefill's last-position
        logits produce the NEXT, not-yet-emitted token)."""
        return self.prompt + self.generated

    @property
    def finished(self) -> bool:
        return self.status in _TERMINAL

    @property
    def tokens_remaining(self) -> int:
        return max(0, self.max_tokens - len(self.generated))


@dataclass(frozen=True)
class SchedulerConfig:
    max_slots: int
    page_size: int
    max_pages_per_seq: int
    max_queue: Optional[int] = None     # None = unbounded queueing
    preempt_budget: Optional[int] = None  # None = unlimited re-prefills

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq


class ContinuousBatchingScheduler:
    """Queue + slot + page bookkeeping.  All methods are host-side and
    cheap; device work happens in the engine between calls."""

    def __init__(self, pool: PagePool, cfg: SchedulerConfig,
                 cache: Optional[PrefixCache] = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self.pool = pool
        self.cfg = cfg
        self.cache = cache          # prefix cache; None = caching off
        self.tracer = None          # obs hook, bound by the engine; None
        #                             (tracing off) costs one is-None
        #                             check on the preempt edge
        # injectable clock (engine passes its own — possibly a
        # ManualClock); only the submit(now=None) fallback reads it
        self._time = time_fn
        self.queue: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}       # slot -> request
        self._free_slots: List[int] = list(range(cfg.max_slots - 1, -1, -1))
        self.preemption_count = 0
        # tenant preemption precedence (round 17): a callable
        # ``tenant -> rank`` bound by the control plane (higher rank =
        # victimized FIRST, so batch-class slots evict before
        # interactive ones).  None — the default — ranks every tenant
        # equally and preserves the classic pure-youngest-first policy.
        self.precedence_fn: Optional[Callable[[str], int]] = None
        # O(1) load probe for class-aware fleet routing (round 16):
        # prompt tokens still to prefill across queued + running
        # requests, maintained incrementally on every cache_len edge
        # (submit/admit/chunk/preempt/release).  ``recompute_backlog``
        # is the audit-time ground truth.
        self.prefill_backlog_tokens = 0

    # ---- admission -------------------------------------------------------

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Enqueue, or refuse.  Refusal (returns False, status
        ``REJECTED``) happens for requests that could NEVER run — longer
        than ``max_seq_len`` or needing more pages than the pool owns —
        and as backpressure when the queue is at ``max_queue``."""
        enforce_that(len(req.prompt) >= 1, "empty prompt", context="serving")
        enforce_that(req.max_tokens >= 1, "max_tokens must be >= 1",
                     context="serving")
        req.submitted_at = self._time() if now is None else now
        total = len(req.prompt) + req.max_tokens
        if total > self.cfg.max_seq_len or \
                self._pages_for(total) > self.pool.num_usable:
            req.status = RequestStatus.REJECTED
            return False
        if self.cfg.max_queue is not None and \
                len(self.queue) >= self.cfg.max_queue:
            req.status = RequestStatus.REJECTED
            return False
        req.status = RequestStatus.QUEUED
        self.queue.append(req)
        self._backlog_enter(req)
        return True

    # ---- prefill-backlog accounting (round 16) ----------------------------
    #
    # Invariant: ``prefill_backlog_tokens`` equals the sum over every
    # queued-or-running request of ``max(0, len(prompt) - cache_len)`` —
    # the prompt tokens the engine still owes a prefill.  Decoding
    # requests (cache_len >= prompt) contribute 0, so the number is the
    # pure prefill debt the fleet router reads before dispatching a
    # prompt to a prefill-class replica.

    def _backlog_enter(self, req: Request) -> None:
        self.prefill_backlog_tokens += max(0,
                                           len(req.prompt) - req.cache_len)

    def _backlog_leave(self, req: Request) -> None:
        self.prefill_backlog_tokens -= max(0,
                                           len(req.prompt) - req.cache_len)

    def note_prefill_progress(self, req: Request, old_cache_len: int) -> None:
        """Re-account a tracked request after its ``cache_len`` moved
        (admission stitch, a finished prefill chunk, a preemption reset).
        The engine calls this from ``_finish_chunk``; the scheduler's
        own edges call it internally."""
        plen = len(req.prompt)
        self.prefill_backlog_tokens += (max(0, plen - req.cache_len)
                                        - max(0, plen - old_cache_len))

    def recompute_backlog(self) -> int:
        """Ground-truth backlog (O(requests)); the migrate conservation
        checker compares this against the incremental counter."""
        live = list(self.queue) + list(self.running.values())
        return sum(max(0, len(r.prompt) - r.cache_len) for r in live)

    def _pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.page_size)  # ceil

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Allocate with cache pressure relief: when the free list is
        short, evict LRU refcount-0 cached pages to cover the shortfall
        before giving up — cached pages are an opportunistic reserve,
        never a reason to refuse admission or trigger preemption."""
        if self.cache is not None and n > self.pool.num_free:
            self.cache.evict(n - self.pool.num_free)
        return self.pool.alloc(n)

    def admit(self) -> List[Request]:
        """Move queued requests into slots while a slot AND the pages for
        their (re-)prefill are available.  FIFO with head-of-line
        blocking: a big request at the head waits rather than being
        starved by small ones slipping past it.

        The allocation covers ``cache_tokens + 1`` — the prefill plus
        the first decode append — so a freshly-admitted request can
        never be the growth victim of the very tick that paid for its
        prefill (the engine runs growth/preemption BEFORE admission).

        With a prefix cache, the request is charged only its NEW pages:
        the longest verified cached prefix is stitched in as shared
        pages (ref'd, not copied) and the prefill starts at
        ``cached_len``.  A full-cover hit (every page of ``cache_tokens``
        cached) marks the last shared page for a copy-on-write fork —
        the tail must recompute the final position's logits, and its KV
        write may not land in a page other sequences read."""
        admitted: List[Request] = []
        page = self.cfg.page_size
        while self.queue and self._free_slots:
            req = self.queue[0]
            toks = req.cache_tokens
            total = self._pages_for(len(toks) + 1)
            shared: List[int] = []
            stitched = 0
            cow_src = None
            if self.cache is not None:
                hit_pages, hit_len = self.cache.lookup(toks)
                if hit_pages and hit_len >= len(toks):
                    # full cover: fork the last shared page, recompute
                    # only the final token (its logits seed decoding)
                    cow_src = hit_pages[-1]
                    shared = hit_pages[:-1]
                    stitched = len(toks) - 1
                else:
                    shared = hit_pages
                    stitched = hit_len
            # pin the stitched pages (and the COW fork source — it is
            # read by the engine's fork, after this call returns) BEFORE
            # allocating: _alloc may evict refcount-0 cached pages, and
            # without the pin it could evict and re-grant the very pages
            # this hit is about to share.  On refusal the pins are
            # dropped, restoring the exact prior state (all-or-nothing).
            self.pool.ref(shared)
            if cow_src is not None:
                self.pool.ref([cow_src])
            new = self._alloc(total - len(shared))
            if new is None:
                self.pool.free(shared)
                if cow_src is not None:
                    self.pool.free([cow_src])
                break
            self.queue.popleft()
            if self.cache is not None:
                # admission committed: NOW touch the LRU order and the
                # hit/miss counters, exactly once per stitch (the probe
                # above was a pure read; the pins above guarantee the
                # re-walk sees the same entries)
                self.cache.lookup(toks, touch=True)
            req.pages = shared + new     # page j holds tokens [jP, jP+P)
            old_len = req.cache_len      # 0 (fresh or preempt-reset)
            req.cached_len = stitched
            req.cache_len = stitched     # engine prefills from here on
            self.note_prefill_progress(req, old_len)
            req.cow_src = cow_src        # fork target is new[0] (engine)
            req.slot = self._free_slots.pop()
            req.status = RequestStatus.RUNNING
            self.running[req.slot] = req
            admitted.append(req)
        return admitted

    def drop_queued(self, req: Request, status: RequestStatus) -> None:
        """Remove a not-yet-admitted request from the queue with a
        terminal status (deadline shed, cancellation)."""
        enforce_that(status in _TERMINAL, "drop_queued needs a terminal "
                     "status", context="serving")
        try:
            self.queue.remove(req)
            self._backlog_leave(req)
        except ValueError:
            pass
        req.status = status

    # ---- decode-time growth / preemption --------------------------------

    def ensure_decode_pages(self) -> List[Request]:
        """Before a decode tick: every running sequence whose next append
        lands on a page boundary needs one more page.  Oldest requests
        are served first; when the pool is dry, refcount-0 cached pages
        are LRU-evicted first, and only then is the YOUNGEST running
        sequence still under its preemption budget preempted (pages
        unref'd, tokens re-queued at the front) until the growth fits.
        A grower with no eligible victim preempts ITSELF — correctness
        (the append must land on an owned page) beats its budget.
        Returns the preempted requests."""
        preempted: List[Request] = []
        for req in sorted(self.running.values(),
                          key=lambda r: (r.submitted_at, r.rid)):
            if req.status is not RequestStatus.RUNNING:
                continue  # preempted below while an older one grew
            if req.cache_len < len(req.pages) * self.cfg.page_size:
                continue
            while True:
                got = self._alloc(1)
                if got is not None:
                    req.pages.extend(got)
                    break
                victim = self._youngest_victim(exclude=req)
                if victim is None:
                    victim = req  # alone (or peers exempt): requeue itself
                self._preempt(victim)
                preempted.append(victim)
                if victim is req:
                    break
        return preempted

    def alloc_pages(self, n: int) -> Optional[List[int]]:
        """Public allocation seam for engine-side page needs outside
        admission/growth (the verify-time COW fork): same cache-evict
        relief as every other allocation, never preemption.  Returns
        the pages at refcount 1, or None."""
        return self._alloc(n)

    def grant_lookahead(self, req: Request, k: int) -> int:
        """Charge pages for ``k`` speculative lookahead tokens beyond
        the base decode append — OPPORTUNISTICALLY: cached pages may be
        LRU-evicted to cover it (via ``_alloc``) but nothing is ever
        preempted for speculation, so under page pressure the grant
        shrinks and the engine speculates less (down to the plain
        1-token decode, which ``ensure_decode_pages`` already
        guaranteed).  Returns the lookahead that actually fits —
        ``min(k, owned page room - 1)``, also bounded by the page-table
        width."""
        page = self.cfg.page_size
        want = req.cache_len + int(k) + 1
        while len(req.pages) * page < want:
            if len(req.pages) >= self.cfg.max_pages_per_seq:
                break
            got = self._alloc(1)
            if got is None:
                break
            req.pages.extend(got)
        return max(0, min(int(k),
                          len(req.pages) * page - req.cache_len - 1))

    def rollback_pages(self, req: Request) -> int:
        """Roll a speculating request's page table back to its length:
        free lookahead pages past what ``cache_len + 1`` (the next
        decode append — the same charge admission makes) needs.  Only
        ever frees pages past the materialized length, so stitched
        prefix pages (always a prefix of the table, below ``cache_len``)
        can never be touched.  Returns how many pages went back."""
        needed = max(1, self._pages_for(req.cache_len + 1))
        if len(req.pages) <= needed:
            return 0
        extra = req.pages[needed:]
        del req.pages[needed:]
        self.pool.free(extra)
        return len(extra)

    def _youngest_victim(self, exclude: Request) -> Optional[Request]:
        budget = self.cfg.preempt_budget
        cands = [r for r in self.running.values()
                 if r is not exclude and not r.escalated and
                 (budget is None or r.preemptions < budget)]
        if not cands:
            return None
        # precedence leads the key: with a control plane bound, the
        # highest-rank tenant class (batch) is victimized before any
        # lower-rank one (interactive), and only WITHIN a rank does the
        # classic youngest-first rule pick
        rank = self.precedence_fn or (lambda tenant: 0)
        return max(cands, key=lambda r: (rank(r.tenant), r.submitted_at,
                                         r.rid))

    def _preempt(self, req: Request) -> None:
        if self.tracer is not None:
            self.tracer.instant("preempt", rid=req.rid, slot=req.slot,
                                preemptions=req.preemptions + 1)
        self._release_slot_and_pages(req)
        old_len = req.cache_len
        req.cache_len = 0
        self.note_prefill_progress(req, old_len)  # re-owes its prefill
        req.cached_len = 0
        req.cow_src = None
        req.prefilling = False       # re-stitched at re-admission
        req.status = RequestStatus.PREEMPTED
        req.preemptions += 1
        self.preemption_count += 1
        if self.cfg.preempt_budget is not None and \
                req.preemptions >= self.cfg.preempt_budget:
            req.escalated = True
        self._requeue_front(req)

    def _requeue_front(self, req: Request) -> None:
        """Preempted requests go back to the front; an escalated request
        jumps ahead of everything, a normal one slots in after the
        leading escalated run (escalation is a real priority, not just a
        no-more-preemptions flag)."""
        if req.escalated:
            self.queue.appendleft(req)
            return
        i = 0
        for r in self.queue:
            if not r.escalated:
                break
            i += 1
        self.queue.insert(i, req)

    # ---- completion ------------------------------------------------------

    def release(self, req: Request,
                status: RequestStatus = RequestStatus.COMPLETED) -> None:
        """Return a sequence's slot and pages to the pool with its
        terminal status — completion, timeout, cancellation, and failure
        all exit through here so none of them can leak."""
        enforce_that(status in _TERMINAL, "release needs a terminal status",
                     context="serving")
        self._backlog_leave(req)
        self._release_slot_and_pages(req)
        req.status = status

    def _release_slot_and_pages(self, req: Request) -> None:
        if req.cow_src is not None:
            # admission pinned the fork source; if the request exits
            # before the engine ran the fork, drop the pin here
            self.pool.free([req.cow_src])
            req.cow_src = None
        if req.pages:
            self.pool.free(req.pages)
            req.pages = []
        if req.slot is not None:
            del self.running[req.slot]
            self._free_slots.append(req.slot)
            req.slot = None

    # ---- views -----------------------------------------------------------

    def running_requests(self) -> List[Request]:
        return [self.running[s] for s in sorted(self.running)]

    def queued_requests(self) -> List[Request]:
        return list(self.queue)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)


def pack_prefill_chunks(prefilling: List[Request], chunk: int, align: int,
                        budget: int) -> Tuple[List[Tuple[Request, int, int,
                                                         int]], int]:
    """Select which prefill chunks ride in THIS tick's unified step.

    Each prefilling request contributes one chunk of at most ``chunk``
    tokens (0 = its whole remainder), padded up to ``align`` rows (the
    ragged kernel's one-sequence-per-block packing; 1 on the reference
    path).  Chunks pack greedily in the given order until ``budget``
    rows — the engine orders candidates oldest-progress-first, so a
    request crowded out this tick is first in line next tick and the
    per-tick prefill row count (hence the jit bucket) stays bounded.
    The FIRST chunk always packs even if it alone exceeds the budget
    (``bucket_for`` rounds the oversize up), so progress is guaranteed.

    Returns ``([(request, start, n_tokens, n_rows)], total_rows)``;
    this is scheduling policy, so it lives here with the rest of it.
    """
    out: List[Tuple[Request, int, int, int]] = []
    total = 0
    for req in prefilling:
        remaining = len(req.cache_tokens) - req.cache_len
        if remaining <= 0:
            continue
        n = remaining if chunk <= 0 else min(chunk, remaining)
        rows = -(-n // align) * align
        if out and total + rows > budget:
            break
        out.append((req, req.cache_len, n, rows))
        total += rows
    return out, total


def bucket_for(length: int, buckets: Tuple[int, ...], max_len: int) -> int:
    """Smallest bucket >= length; lengths beyond the ladder round up to
    the next page-agnostic multiple of the largest bucket, capped at
    ``max_len`` (so the number of prefill jit specializations stays
    O(len(buckets) + max_len / max(buckets)))."""
    for b in sorted(buckets):
        if length <= b <= max_len:
            return b
    top = max(buckets) if buckets else max_len
    return min(max_len, -(-length // top) * top)
