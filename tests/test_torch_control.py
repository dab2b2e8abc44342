"""``paddle_tpu_torch.serving.control`` against the JAX package's tenant
control plane, on the CPU, with the same numpy weights and
``ManualClock`` traces.

- The pure parts on both packages: ``TenantRegistry.from_flag`` (classes,
  deadlines, weights, precedence), the WFQ's service order, removal and
  expiry, the token bucket on an injected clock, the admission ledger.
- Fleet drives compared key by key (statuses, streams, results,
  ``snapshot()``, ``healthz()`` with its per-tenant split and admission
  ledger, ``metrics_text()``, lifecycle transitions, none undeclared):
  quota deferral, a one-tenant storm under WFQ (the other tenants keep
  their deadlines), buffered requests expiring and cancelled, growth
  preemption with the registry bound to the scheduler, autoscale up
  under a storm and down after it, and a scale-up while a replica dies.
- The victim rule on both packages: an older batch-class slot is
  preempted before a younger interactive one (youngest-first without a
  registry).  Exact equality: only tokens,
  counters and injected-clock times are compared.
- ``control.main(["check", "--device=cpu"])`` prints JAX's ledger.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest

from torch_serving_util import (Side, assert_same, gate_params,
                                no_retrace_sites, observe, run_both)

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
    kw.setdefault("heartbeat_s", 0.05)
    kw.setdefault("resubmit_budget", 2)
    return side.FleetRouter(side.maker(**dict(ENGINE, **(engine_kw or {}))),
                            n, faults=plan, **kw), plan


def _storm_drive(fl, plan, tenants, storm_ticks=6, max_tokens=3, seed=0):
    """Every other tick of the storm window each tenant submits
    ``storm_factor`` requests; then drain."""
    rng = np.random.RandomState(seed)
    frids, streams = [], []
    tick = 0
    while tick < storm_ticks or fl.has_work:
        if tick < storm_ticks and tick % 2 == 0:
            for tenant in tenants:
                for _ in range(plan.storm_factor(tick, tenant)):
                    s = []
                    frids.append(fl.submit(
                        rng.randint(2, 64, size=6).tolist(),
                        max_tokens=max_tokens, tenant=tenant,
                        on_token=s.append))
                    streams.append(s)
        fl.step()
        tick += 1
        assert tick < 800, "fleet failed to drain"
    return frids, streams


def _pure_registry(side):
    reg = side.TenantRegistry.from_flag("alice:interactive, bulk:batch,carol,")
    reg.register("dave", "standard", deadline_s=7.0,
                 quota_tokens_per_s=100.0, burst_tokens=30.0)
    takes = [reg.admit_quota("dave", c, t) for c, t in
             ((20, 0.0), (20, 0.05), (20, 0.1), (5, 0.1), (30, 1.0))]
    return {"tenants": reg.tenants(),
            "policy": [(reg.deadline_s(t), reg.weight(t), reg.precedence(t))
                       for t in ("alice", "bulk", "carol", "dave", "eve")],
            "takes": takes}


def _pure_wfq(side):
    q = side.control.WeightedFairQueue()
    for i in range(8):
        q.push("alice", 8, 4.0, ("a", i))
        q.push("bob", 8 + i, 1.0, ("b", i))
    for i in range(20):
        q.push("storm", 3, 1.0, ("s", i))
    order = [q.pop() for _ in range(12)]
    removed = q.remove(("b", 7))
    expired = q.expire(lambda item: item[0] == "s" and item[1] % 3 == 0)
    rest = []
    while len(q):
        rest.append(q.pop())
    led = side.control.AdmissionLedger()
    for t, n in (("x", 3), ("y", 2)):
        for _ in range(n):
            led.on_submit(t)
    led.on_admit("x")
    led.on_quota_deferred("x")
    led.on_shed("y")
    return {"order": order, "removed": removed, "expired": expired,
            "rest": rest, "empty_pop": q.pop(),
            "ledger": led.snapshot(), "problems": led.problems()}


@pytest.mark.parametrize("part", ["registry", "wfq"])
def test_pure_control_parts_match_jax(weights, part):
    fn = {"registry": _pure_registry, "wfq": _pure_wfq}[part]
    got = {name: fn(Side(name, weights)) for name in ("jax", "port")}
    assert got["port"] == got["jax"]
    if part == "registry":
        assert got["port"]["policy"][0] == (0.5, 4.0, 0)
        assert False in got["port"]["takes"]
    else:
        assert len(got["port"]["problems"]) == 2


# ---------------------------------------------------------------------------
# fleet drives
# ---------------------------------------------------------------------------


def quota(side):
    reg = side.TenantRegistry()
    reg.register("metered", "standard", quota_tokens_per_s=200.0,
                 burst_tokens=30.0)
    fl, _ = _fleet(side, tenants=reg)
    rng = np.random.RandomState(1)
    frids, streams = [], []
    for i in range(8):
        s = []
        frids.append(fl.submit(rng.randint(2, 64, size=6).tolist(),
                               max_tokens=6, on_token=s.append,
                               tenant="metered" if i % 2 else "free"))
        streams.append(s)
        fl.step()
    fl.run(max_ticks=400)
    side.control.check_control_conservation(fl)
    return observe(fl, frids, streams)


def storm_wfq(side):
    reg = side.TenantRegistry()
    reg.register("alice", "interactive", deadline_s=0.6)
    reg.register("bob", "standard", deadline_s=0.6)
    reg.register("storm", "batch")
    plan = side.FleetFaultPlan(seed=0, clock=side.ManualClock(tick_s=0.02),
                               tenant_storm=("storm", 0, 6, 10))
    fl, _ = _fleet(side, plan=plan, tenants=reg, wfq=True)
    frids, streams = _storm_drive(fl, plan, ("alice", "bob", "storm"))
    side.control.check_control_conservation(fl)
    return observe(fl, frids, streams)


def wfq_expire_cancel(side):
    fl, _ = _fleet(side, n=1, tenants=side.TenantRegistry(), wfq=True)
    busy = [fl.submit([2, 3, 4, 5], max_tokens=6, tenant="t")
            for _ in range(4)]
    fl.step()
    doomed = fl.submit([2, 3, 4], max_tokens=2, tenant="t", deadline_s=0.01)
    victim = fl.submit([2, 3, 4, 5], max_tokens=2, tenant="t")
    cancelled = fl.cancel(victim)
    fl.run(max_ticks=400)
    side.control.check_control_conservation(fl)
    out = observe(fl, busy + [doomed, victim])
    out["cancelled"] = cancelled
    return out


def precedence(side):
    """Two slots and a small pool with the tenant registry bound to the
    scheduler: growth preempts (the victim rule itself is held below)."""
    reg = side.TenantRegistry()
    reg.register("bulk", "batch")
    reg.register("vip", "interactive", deadline_s=None)
    plan = side.FleetFaultPlan(clock=side.ManualClock(tick_s=0.01))
    fl, _ = _fleet(side, n=1, plan=plan, tenants=reg,
                   engine_kw=dict(num_pages=9, max_slots=2,
                                  prefix_cache=False))
    rng = np.random.RandomState(2)
    frids = [fl.submit(rng.randint(2, 64, size=6).tolist(), max_tokens=14,
                       tenant=t) for t in ("bulk", "vip")]
    fl.run(max_ticks=400)
    side.control.check_control_conservation(fl)
    out = observe(fl, frids)
    eng = fl.replicas[0].engine
    out["preempted"] = [eng._requests[r].preemptions
                        if r in eng._requests else None
                        for r in sorted(fl.replicas[0].engine._requests)]
    return out


def _autoscaled(side):
    """A storm scales one replica up to three; an idle tail scales it
    back down.  Returns the fleet, its rids and streams."""
    reg = side.TenantRegistry()
    reg.register("storm", "batch")
    plan = side.FleetFaultPlan(seed=0, clock=side.ManualClock(tick_s=0.02),
                               tenant_storm=("storm", 0, 6, 10))
    fl, _ = _fleet(side, n=1, plan=plan, tenants=reg, wfq=True,
                   autoscale=side.AutoscalePolicy(
                       min_replicas=1, max_replicas=3, buffered_hi=2,
                       cooldown_ticks=2))
    frids, streams = _storm_drive(fl, plan, ("storm",))
    for _ in range(10):                 # idle tail: the cold path
        fl.step()
    return fl, frids, streams


def autoscale(side):
    fl, frids, streams = _autoscaled(side)
    side.control.check_control_conservation(fl)
    out = observe(fl, frids, streams)
    out["scaler"] = [fl.autoscaler.scale_ups, fl.autoscaler.scale_downs,
                     fl.autoscaler.replica_ticks]
    return out


def scale_up_under_kill(side):
    reg = side.TenantRegistry()
    reg.register("a", "standard")
    reg.register("b", "standard")
    plan = side.FleetFaultPlan(seed=0, clock=side.ManualClock(tick_s=0.02),
                               kill_at={4: 0}, tenant_storm=("b", 0, 6, 6))
    fl, _ = _fleet(side, n=2, plan=plan, tenants=reg, wfq=True,
                   autoscale=side.AutoscalePolicy(
                       min_replicas=2, max_replicas=4, buffered_hi=2,
                       cooldown_ticks=2))
    frids, streams = _storm_drive(fl, plan, ("a", "b"))
    side.control.check_control_conservation(fl)
    out = observe(fl, frids, streams)
    out["scaler"] = [fl.autoscaler.scale_ups, fl.autoscaler.scale_downs]
    return out


SCENARIOS = {"quota": quota, "storm_wfq": storm_wfq,
             "wfq_expire_cancel": wfq_expire_cancel,
             "precedence": precedence, "autoscale": autoscale,
             "scale_up_under_kill": scale_up_under_kill}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_control_scenario_matches_jax(weights, name):
    got = run_both(weights, SCENARIOS[name])
    assert_same(got)
    port = got["port"]
    led = port["healthz"]["admission_ledger"]
    tenants = port["healthz"]["tenants"]
    if name == "quota":
        assert led["metered"]["quota_deferred"] >= 1
    if name == "storm_wfq":
        assert tenants["alice"]["deadline_misses"] == 0
        assert tenants["bob"]["deadline_misses"] == 0
        assert led["storm"]["submitted"] > 5 * led["alice"]["submitted"]
    if name == "wfq_expire_cancel":
        assert led["t"]["shed"] == 2 and port["cancelled"]
        assert port["status"][-2:] == ["timed_out", "cancelled"]
    if name == "precedence":
        assert sum(port["preempted"]) >= 1
        assert port["status"] == ["completed", "completed"]
    if name in ("autoscale", "scale_up_under_kill"):
        assert port["scaler"][0] >= 1
    if name == "autoscale":
        assert port["scaler"][1] >= 1
    if name == "scale_up_under_kill":
        assert port["snapshot"]["fleet_replicas_dead"] >= 1
        done = [s == "completed" for s in port["status"]]
        assert all(st == r for st, r, ok in zip(
            port["streams"], port["results"], done) if ok)


def _victims(side):
    """The scheduler's victim rule with and without the registry: an
    OLDER batch-class slot goes before a younger interactive one; with
    no registry, youngest-first."""
    fl, _ = _fleet(side, n=1, tenants=side.TenantRegistry())
    sched = fl.replicas[0].engine.scheduler
    reg = fl.tenants
    reg.register("bulk", "batch")
    reg.register("vip", "interactive")
    Request = side.serving.Request
    batch = Request(prompt=[2, 3], max_tokens=2, tenant="bulk")
    batch.submitted_at, batch.slot = 1.0, 0
    inter = Request(prompt=[2, 3], max_tokens=2, tenant="vip")
    inter.submitted_at, inter.slot = 2.0, 1
    sched.running = {0: batch, 1: inter}
    probe = Request(prompt=[2], max_tokens=1, tenant="vip")
    with_reg = sched._youngest_victim(exclude=probe).tenant
    sched.precedence_fn = None
    without = sched._youngest_victim(exclude=probe).tenant
    sched.running = {}
    return with_reg, without


def test_scaled_down_replica_releases_its_pool(weights):
    """The autoscaler's scale-down retires a replica through a drain; the
    retired replica's device pool is freed, the live ones' kept."""
    fl, _, _ = _autoscaled(Side("port", weights))
    assert fl.autoscaler.scale_downs >= 1
    dead = [str(r.state) == "dead" for r in fl.replicas]
    assert any(dead) and not all(dead)
    assert [r.engine._kv is None for r in fl.replicas] == dead
    for rep in fl.replicas:
        assert rep.engine.pool.total_refs == 0


def test_preemption_precedence_matches_jax(weights):
    got = {n: _victims(Side(n, weights)) for n in ("jax", "port")}
    assert got["port"] == got["jax"] == ("bulk", "vip")


def test_control_gate_matches_jax(capsys):
    from paddle_tpu.serving.control import main as jax_main
    from paddle_tpu_torch.serving.control import main as port_main

    with no_retrace_sites():
        rc_j = jax_main(["check"])
    out_j = capsys.readouterr().out
    rc_p = port_main(["check", "--device=cpu"])
    out_p = capsys.readouterr().out
    assert (rc_p, out_p) == (rc_j, out_j)
    assert rc_p == 0 and "control-check ok" in out_p
