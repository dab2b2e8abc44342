"""The fleet traffic that ``chip_smoke.py`` checks on the card, in one
place so the script, a profiler and the CPU tests run the same requests.

The model is the serve workload's headline ``DecoderLM`` (d 2048, 8
layers, 16 heads of 128, vocab 32768, seed-0 weights), shared by every
replica; each replica owns its pool.  Every replica has the same engine
geometry — page 128, prefill chunk 256, ``max_pages_per_seq`` 8,
``max_slots`` 4, f32 pool of 41 pages (40 usable), no EOS — because a
greedy replay on a survivor repeats the tokens already streamed only if
it takes the same path through the ragged kernel, whose key spans follow
from ``max_pages_per_seq * page``.

Two traffics, each a list of ``(arrival_s, prompt, tenant)`` with Poisson
arrivals on the fleet's ``ManualClock`` (20 ms a fleet tick):

- :func:`fleet_traffic` — 6 tenants, each with a 512-token system prompt
  (4 full pages; 24 prefix pages against 40 a replica), drawn from
  ``SEED + 70``; 24 requests of a tenant's prompt plus a 16-128-token
  tail at 50 requests/s;
- :func:`disagg_traffic` — 24 requests, 70% on one hot 512-token prompt
  and the rest on three cold 256-token prompts, 16-128-token tails, at
  60 requests/s.

:func:`run` drives a traffic through a :class:`FleetRouter` (submitting
each request at the first fleet tick whose clock has reached its
arrival) and returns the per-request streams, results, the clock's
first-token times and the drive's :func:`ledger`.  With no EOS every
request runs its full 32 tokens, so routing, migration and resubmission
depend on the traffic alone, not on the tokens: the fleet's ledger at a
narrow width on the CPU is the card's, and :data:`LEDGERS` holds it for
both.

Usage::

    model = serve_workload.build_model(dev)
    fleet = build_fleet(model, dev, routing="affinity", kill_at={25: 0})
    out = run(fleet, fleet_traffic())
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.tools.serve_workload import MODEL, NO_EOS, SEED

VOCAB = MODEL["vocab_size"]
REPLICAS = 4
NUM_PAGES = 41           # 40 usable a replica
PAGES_PER_SEQ = 8
MAX_SLOTS = 4
NEW_TOKENS = 32
TICK_S = 0.02            # the fleet clock's step
N_REQUESTS = 24
TAIL = (16, 128)         # prompt tail lengths, both ends included
TENANTS = 6
SYSTEM_LEN = 512
FLEET_RATE = 50.0        # requests a second
KILL_AT = {25: 0}        # fleet tick -> replica
HOT_SHARE = 0.7
HOT_LEN, COLD_LEN, N_COLD = 512, 256, 3
DISAGG_RATE = 60.0
ROLES = ("prefill", "prefill", "decode", "decode")
MIGRATE_BUDGET = 16
DISAGG_KILL_AT = {13: 3}  # a decode replica holding handed-off chains

Traffic = List[Tuple[float, List[int], str]]

# each drive's ledger (:func:`ledger`), fixed by the traffic: ticks,
# engine steps (the ragged kernel runs once a layer a step), the injected
# clock's TTFT p95 and the fleet's routing, kill and migration counters
_COUNTERS = ("resubmits", "prefix_hit_rate", "affinity_hits",
             "replicas_dead", "migrations_started", "migrations_applied",
             "migrations_aborted", "pages_migrated", "cross_replica_seeds",
             "migration_resubmits")


def _ledger(ticks, steps, ttft, *counters):
    return dict(ticks=ticks, steps=steps, ttft_ms_p95=ttft,
                **dict(zip(_COUNTERS, counters)))


LEDGERS = {
    "fleet_affinity": _ledger(101, 275, 554.0, 4, 0.6195, 21, 1,
                              0, 0, 0, 0, 0, 0),
    "fleet_round_robin": _ledger(83, 253, 593.0, 6, 0.279, 0, 1,
                                 0, 0, 0, 0, 0, 0),
    "disagg_unified": _ledger(101, 248, 1080.0, 0, 0.6574, 19, 0,
                              0, 0, 0, 0, 0, 0),
    "disagg_roles": _ledger(74, 223, 460.0, 0, 0.6998, 14, 0,
                            24, 24, 0, 108, 2, 0),
    "disagg_int8": _ledger(74, 223, 460.0, 0, 0.6998, 14, 0,
                           24, 24, 0, 108, 2, 0),
    "disagg_kill": _ledger(99, 249, 617.0, 4, 0.7259, 18, 1,
                           29, 25, 4, 115, 2, 1),
}


def _arrivals(rng, rate: float) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, N_REQUESTS))


def _tail(rng) -> List[int]:
    return rng.integers(2, VOCAB, int(rng.integers(TAIL[0], TAIL[1] + 1))
                        ).tolist()


def fleet_traffic() -> Traffic:
    """Tenant ``t<i>``'s system prompt plus a tail, ``N_REQUESTS``
    requests at ``FLEET_RATE``, drawn from ``SEED + 70``."""
    rng = np.random.default_rng(SEED + 70)
    systems = [rng.integers(2, VOCAB, SYSTEM_LEN).tolist()
               for _ in range(TENANTS)]
    at = _arrivals(rng, FLEET_RATE)
    out = []
    for i in range(N_REQUESTS):
        t = int(rng.integers(TENANTS))
        out.append((float(at[i]), systems[t] + _tail(rng), f"t{t}"))
    return out


def disagg_traffic() -> Traffic:
    """70% on one hot 512-token prompt, the rest on three cold 256-token
    prompts, each plus a tail, ``N_REQUESTS`` requests at
    ``DISAGG_RATE``, drawn from ``SEED + 71``."""
    rng = np.random.default_rng(SEED + 71)
    hot = rng.integers(2, VOCAB, HOT_LEN).tolist()
    cold = [rng.integers(2, VOCAB, COLD_LEN).tolist() for _ in range(N_COLD)]
    at = _arrivals(rng, DISAGG_RATE)
    out = []
    for i in range(N_REQUESTS):
        if rng.random() < HOT_SHARE:
            base, tenant = hot, "hot"
        else:
            c = int(rng.integers(N_COLD))
            base, tenant = cold[c], f"cold{c}"
        out.append((float(at[i]), base + _tail(rng), tenant))
    return out


def build_fleet(model, dev, *, routing: str = "affinity",
                kill_at: Optional[Dict[int, int]] = None,
                roles: Optional[Sequence[str]] = None,
                kv_dtype: str = "float32"):
    """A :class:`FleetRouter` of ``REPLICAS`` engines sharing ``model``,
    every one the same geometry (``kv_dtype`` pools of ``NUM_PAGES``
    pages, the ragged kernel), on one ``ManualClock(tick_s=TICK_S)``
    under ``FleetFaultPlan(0, kill_at)``, migrating at most
    ``MIGRATE_BUDGET`` chains a tick when ``roles`` split the fleet."""
    from paddle_tpu_torch.serving import (FleetFaultPlan, FleetRouter,
                                          ManualClock, ServingEngine)

    def make_engine(i, time_fn):
        return ServingEngine(model, eos_id=NO_EOS, num_pages=NUM_PAGES,
                             max_pages_per_seq=PAGES_PER_SEQ,
                             max_slots=MAX_SLOTS, kv_dtype=kv_dtype,
                             use_kernel=True, time_fn=time_fn, device=dev)

    plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=TICK_S),
                          kill_at=dict(kill_at or {}))
    return FleetRouter(make_engine, REPLICAS, routing=routing, faults=plan,
                       roles=roles, migrate_budget=MIGRATE_BUDGET)


def run(fleet, traffic: Traffic, max_ticks: int = 2000) -> dict:
    """Submit each request at the first fleet tick whose clock has reached
    its arrival, tick until drained (``FleetRouter.run``'s conservation
    check included).  Returns the streams, results, statuses and
    first-token clock times by request, the submit times, the ticks and
    the host wall seconds."""
    clock = fleet.faults.clock
    n = len(traffic)
    streams: List[List[int]] = [[] for _ in range(n)]
    first_at: List[Optional[float]] = [None] * n
    submitted_at: List[float] = [0.0] * n
    frids: List[int] = []

    def on_token(i):
        def cb(tok: int) -> None:
            if first_at[i] is None:
                first_at[i] = clock()
            streams[i].append(tok)
        return cb

    t0 = time.perf_counter()
    ticks = 0
    nxt = 0
    while nxt < n or fleet.has_work:
        while nxt < n and traffic[nxt][0] <= clock():
            _, prompt, tenant = traffic[nxt]
            submitted_at[nxt] = clock()
            frids.append(fleet.submit(prompt, max_tokens=NEW_TOKENS,
                                      on_token=on_token(nxt),
                                      tenant=tenant))
            nxt += 1
        fleet.step()
        ticks += 1
        if ticks >= max_ticks:
            raise AssertionError(f"fleet not drained in {max_ticks} ticks")
    wall = time.perf_counter() - t0
    fleet.run()                     # drained: the conservation check
    ttft = [f - s for f, s in zip(first_at, submitted_at) if f is not None]
    return {"frids": frids, "streams": streams,
            "ledger": ledger(fleet, ticks, ttft),
            "results": [fleet.result(f) for f in frids],
            "status": [str(fleet.status(f)) for f in frids],
            "prompts": [p for _, p, _ in traffic],
            "ttft_s": ttft, "ticks": ticks, "wall_s": wall,
            "tokens": sum(len(s) for s in streams),
            "snapshot": fleet.snapshot()}


def ledger(fleet, ticks: int, ttft_s: Sequence[float]) -> dict:
    """A drained drive's entry of :data:`LEDGERS` (TTFT in ms on the
    injected clock, rounded to 1e-6 ms: the clock's float sums)."""
    snap = fleet.snapshot()
    return _ledger(ticks,
                   sum(r.engine.metrics.step_dispatches
                       for r in fleet.replicas),
                   round(1e3 * float(np.percentile(ttft_s, 95)), 6),
                   *(snap["fleet_" + k] for k in _COUNTERS))
