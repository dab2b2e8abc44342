"""``paddle_tpu_torch.serving.faults`` (``FaultPlan``) driving the port's
engine, against the JAX package's engine under the same plan, on the
CPU with the same numpy weights.

Each scenario runs one engine per package on the plan's ``ManualClock``
and compares per-request statuses, token streams and results (by
submission order), ``metrics.snapshot()``, the registry's text
exposition after ``healthz()``, and the host tier's ledger where there
is one — exact equality (tokens, counters, injected-clock times).
Scenarios: transient decode errors absorbed by the step retry (tokens
equal to a fault-free run), persistent errors past the retry budget (the
watchdog fails the stalled slots), a seeded error rate, NaN poisoning of
one rid, page pressure forcing preemption, a cache eviction storm,
constant-hash collisions, slow ticks against deadlines, torn and
bit-flipped host spills with a slow-I/O window, and the reference's
speculation cases (``test_serving_spec.py:406, 429, 446``: NaN
mid-verify, transient errors with speculation, preemption with
speculation).  Also the ``FaultPlan``/``FleetFaultPlan`` seeded streams
on both packages, and ``kv_cache.main(["check", "--device=cpu"])``
printing JAX's ledger.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest

from torch_serving_util import (Side, assert_same, gate_params,
                                no_retrace_sites, prompts, run_both)

EOS = 1
ENGINE = dict(eos_id=EOS, page_size=4, num_pages=32, max_pages_per_seq=8,
              max_slots=3, buckets=(8, 16))


@pytest.fixture(scope="module")
def weights():
    return gate_params()


def _run(side, plan_kw, n=4, max_tokens=10, engine_kw=None, shared=0,
         poison=None, deadline_s=None, seed=4, sequenced=False,
         waves=1):
    """One engine under ``FaultPlan(**plan_kw)``; ``poison`` (index, tick)
    poisons that request's rid at that tick; ``waves`` > 1 serves the
    same prompts again after each drain."""
    plan = side.FaultPlan(seed=1, clock=side.ManualClock(tick_s=0.01),
                          **plan_kw)
    eng = side.engine(faults=plan, **dict(ENGINE, **(engine_kw or {})))
    ps = prompts(np.random.RandomState(seed), n, shared=shared, lo=4,
                 hi=12) * waves
    streams = [[] for _ in ps]
    rids = []
    tick = 0
    for w in range(waves):
        for p, s in list(zip(ps, streams))[w * n:(w + 1) * n]:
            rids.append(eng.submit(p, max_tokens=max_tokens,
                                   on_token=s.append, deadline_s=deadline_s))
            if sequenced:
                eng.step()
        while eng.has_work:
            if poison is not None and tick == poison[1]:
                plan.poison_nan(rids[poison[0]])
            eng.step()
            tick += 1
            assert tick < 500
        eng.run()
    hz = eng.healthz()
    out = {"status": [str(eng.status(r)) for r in rids],
           "results": [eng.result(r) for r in rids],
           "streams": streams, "snapshot": eng.metrics.snapshot(),
           "exposition": eng.registry.to_text(), "ok": hz["ok"],
           "held": list(plan.held_pages)}
    if eng.host_tier is not None:
        out["tier"] = eng.host_tier.snapshot()
    assert eng.pool.total_refs == 0
    return out


SPEC = dict(spec_mode="ngram", spec_k=3)
TIER = dict(host_tier_bytes=1 << 20, swap_in_budget=4)

SCENARIOS = {
    "clean": dict(plan_kw={}),
    "transient_errors": dict(plan_kw=dict(decode_errors={2: 1, 5: 2})),
    "persistent_errors": dict(plan_kw=dict(
        decode_errors={t: 3 for t in range(3, 8)}),
        engine_kw=dict(watchdog_ticks=3)),
    "error_rate": dict(plan_kw=dict(decode_error_rate=0.3)),
    "nan_poison": dict(plan_kw={}, poison=(1, 3)),
    "page_pressure": dict(plan_kw=dict(page_pressure=(2, 12, 20)),
                          engine_kw=dict(num_pages=24)),
    "cache_storm": dict(plan_kw=dict(cache_storm=(0, 1000)), shared=8,
                        sequenced=True, waves=2),
    "hash_collisions": dict(plan_kw=dict(hash_collisions=True), shared=8,
                            sequenced=True, waves=2),
    "slow_ticks": dict(plan_kw=dict(slow_ticks={3: 0.3, 6: 0.5}),
                       deadline_s=0.4),
    "host_spill_faults": dict(
        plan_kw=dict(torn_spill_at={0}, bitflip_spill_at={1},
                     slow_host_io=(0, 1000), cache_storm=(0, 1000)),
        engine_kw=TIER, shared=8, sequenced=True, waves=3),
    "spec_nan_mid_verify": dict(plan_kw={}, poison=(1, 2),
                                engine_kw=SPEC, max_tokens=14),
    "spec_transient_errors": dict(plan_kw=dict(decode_errors={2: 1, 5: 2}),
                                  engine_kw=SPEC, max_tokens=12),
    "spec_preemption": dict(plan_kw=dict(page_pressure=(3, 12, 30)),
                            engine_kw=dict(SPEC, num_pages=36, max_slots=2),
                            max_tokens=12),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fault_scenario_matches_jax(weights, name):
    kw = SCENARIOS[name]
    got = run_both(weights, lambda side: _run(side, **kw))
    assert_same(got)
    port = got["port"]
    assert port["ok"] and port["held"] == []
    snap = port["snapshot"]
    if name in ("transient_errors", "error_rate", "spec_transient_errors"):
        assert snap["retries"] >= 1
        assert set(port["status"]) == {"completed"}
    if name == "persistent_errors":
        assert "failed" in port["status"]
    if name in ("nan_poison", "spec_nan_mid_verify"):
        assert port["status"][1] == "failed"
        assert port["status"].count("failed") == 1
    if name in ("page_pressure", "spec_preemption"):
        assert snap["preemptions"] >= 1
    if name == "cache_storm":
        assert snap["cache_evictions"] >= 1
    if name == "slow_ticks":
        assert "timed_out" in port["status"] or snap["shed"] >= 1
    if name == "host_spill_faults":
        assert port["tier"]["host_corrupt"] >= 1
        assert port["tier"]["spill_stall_ticks"] >= 1
    if name in ("transient_errors", "spec_transient_errors", "error_rate",
                "page_pressure", "spec_preemption", "hash_collisions",
                "cache_storm"):
        # faults absorbed: the same tokens as the fault-free engine
        clean = _run(Side("port", weights),
                     plan_kw={}, **{k: v for k, v in kw.items()
                                    if k != "plan_kw"})
        assert port["results"] == clean["results"]
    if name.startswith("spec"):
        assert snap["spec_tokens_proposed"] > 0


def _plan_streams(side):
    p = side.FaultPlan(seed=7, decode_error_rate=0.4,
                       bitflip_spill_at={1, 3})
    fails = [p.decode_should_fail(t, a) for t in range(12) for a in (0, 1)]
    offs = [p.spill_bitflip_offset(s, 4096) for s in range(5)]
    f = side.FleetFaultPlan(seed=7, kill_rate=0.3, migration_drop_rate=0.5,
                            tenant_storm=("x", 2, 5, 3),
                            slow_replicas={1: 3}, partitions={0: (2, 4)})
    kills = [f.kills(t, [0, 1, 2]) for t in range(12)]
    drops = [f.drop_migration(s) for s in range(8)]
    storm = [f.storm_factor(t, w) for t in range(7) for w in ("x", "y")]
    steps = [f.replica_steps(1, t) for t in range(6)]
    blocked = [f.heartbeat_blocked(0, t) for t in range(6)]
    clock = side.ManualClock(start=1.5, tick_s=0.25)
    f2 = side.FleetFaultPlan(clock=clock)
    f2.tick_begin(0)
    f2.tick_begin(1)
    return [fails, offs, kills, drops, storm, steps, blocked, clock()]


def test_fault_plan_streams_match_jax(weights):
    got = {n: _plan_streams(Side(n, weights)) for n in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert got["port"][-1] == 2.0


def test_kv_cache_gate_matches_jax(capsys):
    from paddle_tpu.serving.kv_cache import main as jax_main
    from paddle_tpu_torch.serving.kv_cache import main as port_main

    with no_retrace_sites():
        rc_j = jax_main(["check"])
    out_j = capsys.readouterr().out
    rc_p = port_main(["check", "--device=cpu"])
    out_p = capsys.readouterr().out
    assert (rc_p, out_p) == (rc_j, out_j)
    assert rc_p == 0 and "kv-cache check ok" in out_p
