"""``paddle_tpu_torch.serving.fleet`` against the JAX package's fleet, on
the CPU.

Each scenario is written once (a function of a ``Side``) and driven on
both packages with the same numpy weights (the JAX package's seed-0
draw) on a ``ManualClock``; the per-request terminal statuses, token
streams and results (by submission order), ``snapshot()``,
``healthz()``, ``metrics_text()`` and the recorded lifecycle
transitions must be equal, with no undeclared transition.  Only tokens
and integer counters are compared, and times on the injected clock,
which both packages compute in the same float order — so equality is
exact, no tolerance.  Scenarios: prefix affinity and round-robin, a
kill with exactly-once streams, a drain and a join, a lease lost to a
heartbeat partition, the resubmit budget ending FAILED, cancel,
deadlines carried over a resubmit, a warm restart through
``HostPageTier.adopt``, seeded chaos (kill rate, a slow replica), and
a kill while the slots speculate.

Also: the fleet gate (``fleet.main(["check", "--device=cpu"])``) and
``obs.cli.seeded_chaos`` print the same ledgers as the JAX package's
(its events and Chrome JSON too), the gates' weights file holds the JAX
package's seed-0 draw, and ``over_mesh_slices`` at tp 1 equals JAX's
(a tp the ranks cannot host raises in JAX's words).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import json

import numpy as np
import pytest

from torch_serving_util import (CFG, Side, assert_same, gate_params,
                                no_retrace_sites, normalized_events,
                                observe, prompts, run_both)

EOS = 1
PAGE = 4
ENGINE = dict(eos_id=EOS, page_size=PAGE, num_pages=32, max_pages_per_seq=8,
              max_slots=2, buckets=(4, 8))


@pytest.fixture(scope="module")
def weights():
    return gate_params()


def _fleet(side, n=2, plan=None, engine_kw=None, **kw):
    if plan is None:
        plan = side.FleetFaultPlan(clock=side.ManualClock(tick_s=0.01))
    ekw = dict(ENGINE, **(engine_kw or {}))
    kw.setdefault("heartbeat_s", 0.05)
    kw.setdefault("resubmit_budget", 2)
    return side.FleetRouter(side.maker(**ekw), n, faults=plan, **kw), plan


def _submit_all(fl, ps, max_tokens, **kw):
    streams = [[] for _ in ps]
    frids = [fl.submit(p, max_tokens=max_tokens, on_token=s.append, **kw)
             for p, s in zip(ps, streams)]
    return frids, streams


def _drained(side, fl, out):
    assert not fl.has_work
    fl.check_fleet_conservation()
    for rep in fl.replicas:
        assert rep.engine.pool.total_refs == 0
    return out


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def routing(policy):
    def scenario(side):
        """Shared-prefix traffic in two waves (the second after the first
        has owners) over 3 replicas."""
        rng = np.random.RandomState(4)
        fl, _ = _fleet(side, n=3, routing=policy, overflow_queue_depth=64)
        ps = prompts(rng, 4, shared=2 * PAGE)
        frids, streams = _submit_all(fl, ps, 5)
        for _ in range(3):
            fl.step()
        ps2 = prompts(rng, 4, shared=0) + [ps[0][:2 * PAGE] + [9, 9, 9]]
        f2, s2 = _submit_all(fl, ps2, 5)
        fl.run(max_ticks=400)
        return _drained(side, fl, observe(fl, frids + f2, streams + s2))
    return scenario


def kill_resubmit(side):
    """Kill the replica holding running decodes; streams stay exactly
    once and results match."""
    rng = np.random.RandomState(2)
    fl, _ = _fleet(side, n=2)
    ps = prompts(rng, 4, shared=PAGE)
    frids, streams = _submit_all(fl, ps, 12)
    for _ in range(3):
        fl.step()
    fl.kill_replica(fl._requests[frids[0]].replica, "kill mid-decode")
    fl.run(max_ticks=400)
    out = observe(fl, frids, streams)
    assert out["snapshot"]["fleet_resubmits"] >= 1
    assert out["streams"] == out["results"]
    return _drained(side, fl, out)


def drain_and_join(side):
    """Drain replica 0 mid-trace (its work finishes, it retires), join a
    new replica (JOINING, then READY a tick later), submit more."""
    rng = np.random.RandomState(1)
    fl, _ = _fleet(side, n=2)
    frids, streams = _submit_all(fl, prompts(rng, 3), 4)
    fl.step()
    fl.drain_replica(0)
    idx = fl.add_replica()
    states = [str(fl.replica_state(idx))]
    fl.step()
    states.append(str(fl.replica_state(idx)))
    f2, s2 = _submit_all(fl, prompts(rng, 3), 4)
    fl.run(max_ticks=400)
    out = observe(fl, frids + f2, streams + s2)
    out["join_states"] = states
    return _drained(side, fl, out)


def partition(side):
    """A heartbeat partition longer than the lease TTL kills replica 0;
    its stale token can no longer ack."""
    plan = side.FleetFaultPlan(clock=side.ManualClock(tick_s=0.01),
                               partitions={0: (1, 10_000)})
    fl, _ = _fleet(side, n=2, plan=plan, heartbeat_s=0.03)
    slot, token = fl.replicas[0].slot, fl.replicas[0].token
    frids, streams = _submit_all(fl, [[5, 6, 7], [8, 9, 10, 11]], 25)
    fl.run(max_ticks=400)
    out = observe(fl, frids, streams)
    out["zombie_ack"] = fl._lease.heartbeat(slot, token)
    return _drained(side, fl, out)


def budget_failed(side):
    """Serial kills burn a budget of one: the request ends FAILED."""
    fl, _ = _fleet(side, n=3, resubmit_budget=1)
    frids, streams = _submit_all(fl, [[3, 4, 5, 6], [7, 8, 9]], 8)
    fl.step()
    fl.kill_replica(fl._requests[frids[0]].replica)
    fl.step()
    fl.kill_replica(fl._requests[frids[0]].replica)
    fl.run(max_ticks=400)
    return _drained(side, fl, observe(fl, frids, streams))


def cancel(side):
    """Cancel a running request and a queued one (max_slots 2 per
    replica, so the fifth request queues)."""
    rng = np.random.RandomState(6)
    fl, _ = _fleet(side, n=2)
    frids, streams = _submit_all(fl, prompts(rng, 5), 10)
    fl.step()
    fl.step()
    out_cancel = [fl.cancel(frids[0]), fl.cancel(frids[4]),
                  fl.cancel(frids[0])]
    fl.run(max_ticks=400)
    out = observe(fl, frids, streams)
    out["cancel_returns"] = out_cancel
    return _drained(side, fl, out)


def deadlines(side):
    """A deadline carried over a death resubmit (no fresh budget), and a
    request whose deadline cannot be met from submit."""
    fl, _ = _fleet(side, n=2)
    frids, streams = _submit_all(fl, [[2, 3, 4, 5]], 20, deadline_s=0.12)
    f2, s2 = _submit_all(fl, [[6, 7, 8]], 4, deadline_s=1.0)
    for _ in range(4):
        fl.step()
    fl.kill_replica(fl._requests[frids[0]].replica)
    f3, s3 = _submit_all(fl, [[9, 10, 11]], 30, deadline_s=0.0)
    fl.run(max_ticks=400)
    return _drained(side, fl, observe(fl, frids + f2 + f3,
                                      streams + s2 + s3))


def warm_restart(side):
    """Serve, spill the cache to the host tier, kill the replica, restart
    it warm (``restart_replica``: the successor adopts the host tier),
    drain the other and serve the same prompt again."""
    prompt = np.random.RandomState(0).randint(2, 64, size=16).tolist()
    fl, _ = _fleet(side, n=2, engine_kw=dict(
        num_pages=32, max_slots=4, buckets=(8, 16),
        host_tier_bytes=1 << 20, swap_in_budget=4))
    f1, s1 = _submit_all(fl, [prompt], 6)
    fl.run(max_ticks=200)
    victim = next(r.idx for r in fl.replicas
                  if r.engine.cache is not None and len(r.engine.cache))
    fl.replicas[victim].engine.cache.flush()
    fl.kill_replica(victim)
    new_idx = fl.restart_replica(victim)
    fl.drain_replica(1 - victim)
    for _ in range(5):
        fl.step()
    f2, s2 = _submit_all(fl, [prompt], 6)
    fl.run(max_ticks=200)
    out = observe(fl, f1 + f2, s1 + s2)
    tier = fl.replicas[new_idx].engine.host_tier
    out["tier"] = [tier.adopted, tier.restored, tier.swap_ins,
                   fl.replicas[victim].engine.host_tier.handed_off]
    assert out["snapshot"]["fleet_pages_restored"] > 0
    assert out["results"][0] == out["results"][1]
    return _drained(side, fl, out)


def chaos(side):
    """A seeded kill rate, a slow replica and a partition over 3
    replicas, with deadlines."""
    plan = side.FleetFaultPlan(seed=3, clock=side.ManualClock(tick_s=0.01),
                               kill_rate=0.08, slow_replicas={1: 2},
                               partitions={2: (20, 40)})
    fl, _ = _fleet(side, n=3, plan=plan, heartbeat_s=0.04,
                   resubmit_budget=3)
    rng = np.random.RandomState(9)
    frids, streams = [], []
    for wave in range(3):
        f, s = _submit_all(fl, prompts(rng, 4, shared=PAGE), 8,
                           deadline_s=2.0 if wave == 1 else None)
        frids += f
        streams += s
        for _ in range(6):
            fl.step()
        if sum(r.state is side.ReplicaState.READY
               for r in fl.replicas) < 2:
            fl.add_replica()
    fl.run(max_ticks=800)
    return _drained(side, fl, observe(fl, frids, streams))


def spec_kill(side):
    """A replica dies while its slots speculate (several tokens a tick):
    the replay's stream stays exactly once (``test_serving_spec.py``'s
    fleet case)."""
    plan = side.FleetFaultPlan(clock=side.ManualClock(tick_s=0.01),
                               kill_at={6: 0})
    fl = side.FleetRouter(side.maker(
        eos_id=EOS, page_size=8, num_pages=64, max_pages_per_seq=12,
        max_slots=2, buckets=(8, 16), spec_mode="ngram", spec_k=3),
        2, faults=plan, heartbeat_s=0.05, resubmit_budget=2)
    rng = np.random.RandomState(8)
    ps = [rng.randint(2, 64, size=3).tolist() * 3 for _ in range(6)]
    frids, streams = _submit_all(fl, ps, 14)
    fl.run(max_ticks=500)
    out = observe(fl, frids, streams)
    out["spec_accepted"] = sum(r.engine.metrics.spec_tokens_accepted
                               for r in fl.replicas)
    assert out["spec_accepted"] > 0 and out["streams"] == out["results"]
    return _drained(side, fl, out)


SCENARIOS = {"affinity": routing("affinity"),
             "round_robin": routing("round_robin"),
             "kill_resubmit": kill_resubmit, "drain_and_join": drain_and_join,
             "partition": partition, "budget_failed": budget_failed,
             "cancel": cancel, "deadlines": deadlines,
             "warm_restart": warm_restart, "chaos": chaos,
             "spec_kill": spec_kill}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_scenario_matches_jax(weights, name):
    got = run_both(weights, SCENARIOS[name])
    assert_same(got)
    port = got["port"]
    assert all(s in ("completed", "failed", "cancelled", "timed_out",
                     "rejected") for s in port["status"])
    assert port["snapshot"]["fleet_duplicate_completions"] == 0
    if name == "affinity":
        assert port["snapshot"]["fleet_affinity_hits"] > 0
    if name == "partition":
        assert port["zombie_ack"] is False
        assert "lease" in port["dead_reasons"][0]
    if name == "budget_failed":
        assert port["status"][0] == "failed"
    if name == "drain_and_join":
        assert port["join_states"] == ["joining", "ready"]
        assert port["replica_states"][0] == "dead"
    if name in ("kill_resubmit", "partition", "chaos", "spec_kill"):
        assert port["snapshot"]["fleet_resubmits"] >= 1


def test_affinity_hits_at_least_round_robin(weights):
    side = Side("port", weights)
    hit = {}
    for policy in ("affinity", "round_robin"):
        hit[policy] = routing(policy)(side)["snapshot"][
            "fleet_prefix_hit_rate"]
    assert hit["affinity"] >= hit["round_robin"]


def test_drained_replica_releases_its_pool(weights):
    """A replica retired by a drain frees its device pool as a killed one
    does once reaped; the survivor keeps its pool and the fleet's
    conservation check still reads both."""
    side = Side("port", weights)
    rng = np.random.RandomState(1)
    fl, _ = _fleet(side, n=2)
    _submit_all(fl, prompts(rng, 3), 4)
    fl.step()
    fl.drain_replica(0)
    assert fl.replicas[0].engine._kv is not None      # work still running
    fl.run(max_ticks=400)
    _drained(side, fl, None)
    assert [str(r.state) for r in fl.replicas] == ["dead", "ready"]
    assert [r.engine._kv is None for r in fl.replicas] == [True, False]


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------


def test_gate_weights_are_the_jax_seed0_draw():
    from torch_serving_util import gate_params as port_weights
    from torch_gate_weights import jax_gate_weights

    want = jax_gate_weights(CFG["max_positions"])
    got = port_weights()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_fleet_gate_matches_jax(capsys):
    from paddle_tpu.serving.fleet import main as jax_main
    from paddle_tpu_torch.serving.fleet import main as port_main

    with no_retrace_sites():
        rc_j = jax_main(["check"])
    out_j = capsys.readouterr().out
    rc_p = port_main(["check", "--device=cpu"])
    out_p = capsys.readouterr().out
    assert (rc_p, out_p) == (rc_j, out_j)
    assert rc_p == 0 and "fleet-check ok" in out_p
    assert port_main(["nope"]) == 2


def test_seeded_chaos_matches_jax(tmp_path, capsys):
    import paddle_tpu.obs as jobs
    import paddle_tpu_torch.obs as tobs
    from paddle_tpu.obs.cli import seeded_chaos as jax_chaos
    from paddle_tpu_torch.obs.cli import main as obs_main
    from paddle_tpu_torch.obs.cli import seeded_chaos as port_chaos

    with no_retrace_sites():
        jt, jfl, jfrids = jax_chaos()
    tt, tfl, tfrids = port_chaos(device="cpu")
    assert normalized_events(tt.events) == normalized_events(jt.events)
    a = json.loads(tobs.dumps_chrome(tt.events))
    b = json.loads(jobs.dumps_chrome(jt.events))
    assert len(a["traceEvents"]) == len(b["traceEvents"]) > 0
    assert [str(tfl.status(f)) for f in tfrids] == \
        [str(jfl.status(f)) for f in jfrids]
    assert [tfl.result(f) for f in tfrids] == [jfl.result(f) for f in jfrids]
    assert tfl.snapshot() == jfl.snapshot()
    snap = tfl.snapshot()
    assert snap["fleet_replicas_dead"] == 2 and snap["fleet_resubmits"] > 0
    out = str(tmp_path / "chaos.json")
    assert obs_main(["chaos", "-o", out, "--device", "cpu"]) == 0
    assert "10/10 completed" in capsys.readouterr().out
    assert json.loads(open(out).read())["traceEvents"]


def test_over_mesh_slices_names_the_parallel_slice(weights):
    """``over_mesh_slices`` is ported (its multi-rank run is
    ``tests/test_torch_serving_tp.py``): at tp 1 it is a fleet of plain
    replicas equal to JAX's, and a tp the ranks cannot host raises in
    JAX's words."""
    import jax

    from paddle_tpu.platform.enforce import EnforceError as JEnforceError
    from paddle_tpu_torch.platform.enforce import EnforceError

    def scenario(side):
        plan = side.FleetFaultPlan(clock=side.ManualClock(tick_s=0.01),
                                   kill_at={4: 0})
        mk = side.maker(**ENGINE)
        fl = side.FleetRouter.over_mesh_slices(
            lambda i, t, mesh: mk(i, t), tp=1, num_replicas=2,
            heartbeat_s=0.05, resubmit_budget=2, faults=plan)
        frids, streams = _submit_all(
            fl, prompts(np.random.RandomState(6), 4, shared=PAGE), 6)
        fl.run(max_ticks=400)
        return _drained(side, fl, observe(fl, frids, streams))

    assert_same(run_both(weights, scenario))
    msgs = []
    for side, err, kw in (("port", EnforceError, {}),
                          ("jax", JEnforceError,
                           {"devices": jax.devices()[:1]})):
        with pytest.raises(err) as e:
            Side(side, weights).FleetRouter.over_mesh_slices(
                lambda i, t, m: None, tp=2, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "cannot host even one 2-chip slice" in msgs[0]
