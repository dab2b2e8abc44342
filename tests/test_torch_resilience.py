"""The port's fault-tolerant training runtime
(``paddle_tpu_torch/resilience``) on the CPU: the counterparts of
``tests/test_resilience.py`` (its three loader tests live in
``tests/test_torch_checkpoint.py``), and parity with the JAX package.

- TrainFaultPlan: order-independent draws, fire-once kills, the control
  twin; the port's draws, kills and injections equal the JAX package's
  for the same seed;
- the bad-step guard: a skipped step is a bit-exact no-op on params,
  slots, the step counter and model state, with the verdict read to the
  host once a guarded step (the port's design, in place of the JAX
  package's one-compile seal), rollback hysteresis + postmortem +
  supervisor recovery; skips under NaN and under ``max_norm`` and the
  rollback step match the JAX package's;
- AsyncCheckpointer: durable pipelined writes, writer errors surface at
  the next wait;
- step-granular resume: a kill mid-pass resumes bit-identically (sync
  and async saves), the exact-boundary cursor, the argument exclusions;
  the elastic path with pipelined acks;
- the seeded chaos replay: no problems, and its costs and bad-step
  counts equal the JAX package's replay on the same numpy weights; the
  ``check`` CLI exits 0.

Tolerances: within the port every comparison is bit-exact
(``assert_array_equal``).  Against the JAX package (both at the f32
policy), parameters, slots, batch norm's statistics and costs within
1e-5 relative + 1e-6 absolute (the f32 level of
``tests/test_torch_optimizers.py``); step counters, bad-step counts,
deaths and the fault plan's decisions are equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import resilience as jres
from paddle_tpu.platform.flags import FLAGS as JFLAGS
from paddle_tpu.resilience import chaos as jchaos

import paddle_tpu_torch as paddle
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.resilience import (AsyncCheckpointer, BadStepGuard,
                                         BadStepRollback,
                                         InjectedTrainerDeath, ManualClock,
                                         TrainFaultPlan, run_supervised)
from paddle_tpu_torch.resilience import chaos as tchaos
from paddle_tpu_torch.resilience.chaos import _dataset as _data
from paddle_tpu_torch.resilience.chaos import _slots
from paddle_tpu_torch.resilience.chaos import _snap as _params

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def f32():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _build(**kw):
    return tchaos._build_trainer(device="cpu", **kw)


def _reader(data, batch=8):
    return paddle.batch(lambda: iter(data), batch)


def _assert_tree_equal(a, b, msg=""):
    assert set(a) == set(b), msg
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg} {k}")


def _assert_tree_close(a, b, msg=""):
    assert set(a) == set(b), msg
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{msg} {k}")


def _jax_weights(seed=5):
    """The JAX chaos classifier's seeded init, as numpy."""
    j = jchaos._build_trainer(seed=seed)
    return {k: np.asarray(j.parameters[k]) for k in j.parameters.names()}


# ---------------------------------------------------------------------------
# TrainFaultPlan
# ---------------------------------------------------------------------------


def test_fault_plan_draws_are_order_independent():
    a = TrainFaultPlan(seed=7, bad_rate=0.3)
    b = a.control_twin()
    fwd = [a.grad_inject(s) for s in range(40)]
    rev = [a.grad_inject(s) for s in reversed(range(40))][::-1]
    twin = [b.grad_inject(s) for s in range(40)]
    assert repr(fwd) == repr(rev) == repr(twin)
    assert any(v != 0.0 for v in fwd), "rate 0.3 over 40 steps must hit"
    assert not b.kill_at and b.kill_rate == 0.0 and not b.kill_save_at


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_fault_plan_draws_match_jax(seed):
    """Draw for draw: the same poisoned steps, kills and save kills."""
    def trace(mod):
        plan = mod.TrainFaultPlan(seed=seed, bad_rate=0.3, kill_rate=0.2,
                                  kill_at={3}, bad_steps={5},
                                  bad_value=float("inf"),
                                  kill_save_at={2: "state"})
        out = []
        for step in list(range(64)) + [3, 10, 11]:
            try:
                plan.step_begin(step)
                out.append((step, "ok", plan.grad_inject(step)))
            except mod.InjectedTrainerDeath as e:
                out.append((step, "death", str(e)))
        for ck in (1, 2, 2):
            for phase in ("params", "state", "meta"):
                try:
                    plan.save_hook(ck)(phase)
                except mod.InjectedTrainerDeath as e:
                    out.append((ck, phase, str(e)))
        return out

    assert repr(trace(jres.faults)) == repr(
        trace(sys.modules["paddle_tpu_torch.resilience.faults"]))


def test_fault_plan_kills_fire_once():
    plan = TrainFaultPlan(kill_at={3})
    plan.step_begin(2)
    with pytest.raises(InjectedTrainerDeath):
        plan.step_begin(3)
    plan.step_begin(3)   # the resumed re-run of step 3 survives
    plan.step_begin(4)


def test_fault_plan_clock_and_slow_steps():
    clk = ManualClock(tick_s=0.5)
    plan = TrainFaultPlan(clock=clk, slow_steps={1: 4.0})
    plan.step_begin(0)
    assert clk() == 0.5
    plan.step_begin(1)
    assert clk() == 5.0


def test_fault_plan_requires_guard_for_poison():
    with pytest.raises(EnforceError):
        _build(guard=None, faults=TrainFaultPlan(bad_steps={1}))


def test_guard_from_the_flags():
    """guard=None: the train_bad_step_* flags decide, as in the JAX
    package ('off' by default: no guard, no verdict read)."""
    assert _build()._guard is None
    old = (TFLAGS.train_bad_step_policy, TFLAGS.train_bad_step_max_norm,
           TFLAGS.train_bad_step_window)
    TFLAGS.train_bad_step_policy = "rollback"
    TFLAGS.train_bad_step_max_norm = 5.0
    TFLAGS.train_bad_step_window = 4
    try:
        g = _build(faults=TrainFaultPlan(bad_steps={1}))._guard
    finally:
        (TFLAGS.train_bad_step_policy, TFLAGS.train_bad_step_max_norm,
         TFLAGS.train_bad_step_window) = old
    assert g == BadStepGuard(policy="rollback", max_norm=5.0,
                             rollback_after=4)


def test_guard_rejects_nonpositive_rollback_window():
    with pytest.raises(ValueError):
        BadStepGuard(policy="rollback", rollback_after=0)


# ---------------------------------------------------------------------------
# bad-step guard
# ---------------------------------------------------------------------------


def test_skip_leaves_params_slots_and_state_untouched():
    """A poisoned step is a bit-exact no-op on params, optimizer slots
    AND the step counter."""
    data = _data(n=24)
    plan = TrainFaultPlan(bad_steps={1})
    sgd = _build(guard=BadStepGuard(), faults=plan)
    sgd.train(_reader(data), num_passes=1)
    assert sgd.bad_steps_total == 1
    # twin: the same run whose reader omits batch 1
    twin = _build(guard=BadStepGuard())
    twin.train(paddle.batch(lambda: iter(data[0:8] + data[16:24]), 8),
               num_passes=1)
    _assert_tree_equal(_params(sgd), _params(twin), "params")
    _assert_tree_equal(_slots(sgd), _slots(twin), "slots")
    assert sgd.opt_state["step"] == twin.opt_state["step"] == 2


def test_guard_max_norm_skips_finite_spikes():
    data = _data(n=16)
    sgd = _build(guard=BadStepGuard(max_norm=1e-9))
    before = _params(sgd)
    sgd.train(_reader(data), num_passes=1)
    assert sgd.bad_steps_total == 2, "every step exceeds a 1e-9 norm cap"
    _assert_tree_equal(_params(sgd), before, "params moved past the cap")


def test_guarded_step_reads_the_verdict_once():
    """The port's design in place of the JAX package's one-compile seal:
    a guarded step reads its verdict to the host exactly once (poisoned
    or not), an unguarded step never; no extra read per pass."""
    data = _data(n=32)                                # 4 steps a pass
    sgd = _build(guard=BadStepGuard(),
                 faults=TrainFaultPlan(bad_steps={1, 6}))
    sgd.train(_reader(data), num_passes=2)
    assert sgd.verdict_reads == 8
    assert sgd.bad_steps_total == 2
    plain = _build()
    plain.train(_reader(data), num_passes=2)
    assert plain.verdict_reads == 0


def test_select_good_and_guard_outputs_match_jax():
    """The tree select (a host verdict, and a 0-d tensor per leaf) and
    the counters, against the JAX package's functions."""
    import torch

    from paddle_tpu_torch.resilience import guard as tguard

    rng = np.random.RandomState(0)
    new = {"w": rng.randn(3, 2).astype(np.float32),
           "s": {"v": rng.randn(4).astype(np.float32)}}
    old = {"w": rng.randn(3, 2).astype(np.float32),
           "s": {"v": rng.randn(4).astype(np.float32)}}

    def torch_tree(t):
        return {k: torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(v) for k, v in t.items()}

    def flat(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, p + k + "/") if isinstance(v, dict)
                       else {p + k: np.asarray(v)})
        return out

    for good in (True, False):
        want = flat(jres.guard.select_good(np.bool_(good), new, old))
        for verdict in (good, torch.tensor(good)):
            got = flat(tguard.select_good(verdict, torch_tree(new),
                                          torch_tree(old)))
            _assert_tree_equal(got, want, f"select {verdict!r}")
        state = {"bad_consec": 2, "bad_total": 5}
        jout = jres.guard.guard_outputs(
            np.bool_(good), {k: np.int32(v) for k, v in state.items()})
        assert tguard.guard_outputs(good, state) == \
            {k: int(v) for k, v in jout.items()}


def test_rollback_policy_raises_and_dumps_postmortem(capsys):
    from paddle_tpu_torch.obs.trace import Tracer

    data = _data(n=40)
    plan = TrainFaultPlan(bad_steps={1, 2, 3})
    tracer = Tracer(time_fn=lambda: 0.0)
    sgd = _build(guard=BadStepGuard(policy="rollback", rollback_after=3,
                                    check_every=1),
                 faults=plan, tracer=tracer)
    with pytest.raises(BadStepRollback):
        sgd.train(_reader(data), num_passes=1)
    out = capsys.readouterr().out
    assert "OBS-POSTMORTEM" in out
    names = [e.name for e in tracer.events] + [e.name for e in tracer.ring]
    assert "bad_step_rollback" in names


def test_supervisor_recovers_from_rollback(tmp_path):
    data = _data(n=40)
    plan = TrainFaultPlan(bad_steps={2, 3, 4})
    save = str(tmp_path / "ck")

    def attempt(i):
        sgd = _build(guard=BadStepGuard(policy="rollback",
                                        rollback_after=3, check_every=1),
                     faults=plan)
        sgd.train(_reader(data), num_passes=2, save_dir=save,
                  save_period_steps=2, resume=True, async_save=False)
        return sgd

    def clear_fault(attempt_no, exc):
        plan.bad_steps.clear()   # the glitch passed

    report, sgd = run_supervised(attempt, max_restarts=3,
                                 on_restart=clear_fault)
    assert report.completed and report.rollbacks == 1
    for k, v in _params(sgd).items():
        assert np.isfinite(v).all(), k


def _bn_model(pkg):
    pkg.topology.reset_name_scope()
    layer = pkg.layer
    x = layer.data(name="x", type=pkg.data_type.dense_vector(8))
    y = layer.data(name="y", type=pkg.data_type.integer_value(2))
    # no bias before the norm: its gradient is ~0, which Adam would
    # amplify into noise
    h = layer.batch_norm(layer.fc(x, size=16, act="linear",
                                  bias_attr=False), act="relu")
    return layer.classification_cost(input=layer.fc(h, size=2), label=y)


RULES = {"momentum": lambda p: p.optimizer.Momentum(momentum=0.9,
                                                    learning_rate=0.1),
         "adam": lambda p: p.optimizer.Adam(learning_rate=1e-2)}
TRIGGERS = {
    # NaN on step 1; a finite spike on step 2 over a max_norm that the
    # clean steps stay under
    "nan": (dict(bad_steps={1}), dict()),
    "max_norm": (dict(bad_steps={2}, bad_value=1e3), dict(max_norm=50.0)),
}


@pytest.mark.parametrize("trigger", sorted(TRIGGERS))
@pytest.mark.parametrize("rule", sorted(RULES))
def test_skip_step_matches_jax(rule, trigger):
    """Batch norm classifier, 4 steps with one poisoned: params, slots,
    moving statistics and the step counter against the JAX package's."""
    plan_kw, guard_kw = TRIGGERS[trigger]
    data = _data(seed=2, n=32)
    jcost = _bn_model(jpaddle)
    jparams = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology([jcost]), seed=3)
    weights = {k: np.asarray(jparams[k]) for k in jparams.names()}
    j = jpaddle.trainer.SGD(
        cost=jcost, parameters=jparams, update_equation=RULES[rule](jpaddle),
        guard=jres.BadStepGuard(**guard_kw),
        faults=jres.TrainFaultPlan(**plan_kw))
    j.train(jpaddle.batch(lambda: iter(data), 8), num_passes=1)
    tcost = _bn_model(paddle)
    t = paddle.trainer.SGD(
        cost=tcost, device="cpu",
        parameters=paddle.convert.parameters_from_numpy(weights, "cpu"),
        update_equation=RULES[rule](paddle),
        guard=BadStepGuard(**guard_kw), faults=TrainFaultPlan(**plan_kw))
    t.train(_reader(data), num_passes=1)
    assert j.bad_steps_total == t.bad_steps_total == 1
    assert int(j.opt_state["step"]) == t.opt_state["step"] == 3
    _assert_tree_close(
        {k: np.asarray(j.parameters[k]) for k in j.parameters.names()},
        _params(t), "params")
    _assert_tree_close(
        {f"{s}/{k}": np.asarray(v) for s, d in j.opt_state["slots"].items()
         for k, v in d.items()}, _slots(t), "slots")
    _assert_tree_close(
        {f"{n}/{k}": np.asarray(v) for n, d in j.model_state.items()
         for k, v in d.items()},
        {f"{n}/{k}": v.numpy() for n, d in t.model_state.items()
         for k, v in d.items()}, "model state")


def test_rollback_matches_jax():
    """The same streak raises BadStepRollback at the same global step in
    both packages (the check runs at the JAX package's read-backs)."""
    data = _data(n=64)
    got = {}
    for name, mod, build, batch in (
            ("jax", jres, jchaos._build_trainer, jpaddle.batch),
            ("port", sys.modules["paddle_tpu_torch.resilience"], _build,
             paddle.batch)):
        sgd = build(guard=mod.BadStepGuard(policy="rollback",
                                           rollback_after=2),
                    faults=mod.TrainFaultPlan(bad_steps={3, 4, 5}))
        with pytest.raises(mod.BadStepRollback) as e:
            sgd.train(batch(lambda: iter(data), 8), num_passes=1)
        got[name] = (sgd._global_step, str(e.value))
    assert got["jax"] == got["port"]


# ---------------------------------------------------------------------------
# checkpoint commit protocol + the async writer
# ---------------------------------------------------------------------------


def test_kill_between_blob_and_meta_keeps_previous_latest(tmp_path):
    sgd = _build()
    ckpt.save_checkpoint(str(tmp_path), 0, sgd.parameters,
                         opt_state=sgd.opt_state, extra_meta={"tag": 0})

    class Boom(RuntimeError):
        pass

    def hook(phase):
        if phase == "meta":
            raise Boom()

    with pytest.raises(Boom):
        ckpt.save_checkpoint(str(tmp_path), 1, sgd.parameters,
                             opt_state=sgd.opt_state, commit_hook=hook)
    assert os.path.exists(ckpt.pass_dir(str(tmp_path), 1) + "/state.pkl")
    assert not os.path.exists(ckpt.pass_dir(str(tmp_path), 1)
                              + "/meta.json")
    assert ckpt.latest_pass(str(tmp_path)) == 0
    _, _, _, meta = ckpt.load_checkpoint(str(tmp_path), device="cpu")
    assert meta["tag"] == 0
    assert ckpt.verify_pass_dir(str(tmp_path), 1) == "missing meta.json"


def test_async_checkpointer_durability_and_error_surface(tmp_path):
    from paddle_tpu_torch.analysis.concurrency import lifecycle

    sgd = _build()
    ck = AsyncCheckpointer(keep=0)
    lifecycle.reset_recorder()
    ck.save(str(tmp_path), 0, sgd.parameters, opt_state=sgd.opt_state)
    ck.wait()
    assert ck.commits == 1
    assert ckpt.verify_pass_dir(str(tmp_path), 0) is None

    def hook(phase):
        if phase == "state":
            raise InjectedTrainerDeath("writer killed")

    ck.save(str(tmp_path), 1, sgd.parameters, commit_hook=hook)
    with pytest.raises(InjectedTrainerDeath):
        ck.wait()
    ck.wait()   # error is consumed, not sticky
    assert ckpt.latest_pass(str(tmp_path)) == 0
    # every phase it went through is a declared checkpoint_commit edge
    assert lifecycle.undeclared_transitions() == []


# ---------------------------------------------------------------------------
# step-granular resume parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_save", [False, True],
                         ids=["sync", "async"])
def test_midpass_kill_resume_bit_identical(tmp_path, async_save):
    data = _data(n=48)                       # 6 steps/pass
    ref = _build()
    ref.train(_reader(data), num_passes=2)

    save = str(tmp_path / f"ck_{async_save}")
    plan = TrainFaultPlan(kill_at={4, 9})

    def attempt(i):
        sgd = _build(faults=plan)
        sgd.train(_reader(data), num_passes=2, save_dir=save,
                  save_period_steps=2, resume=True, async_save=async_save)
        return sgd

    report, got = run_supervised(attempt, max_restarts=4)
    assert report.deaths == 2
    _assert_tree_equal(_params(got), _params(ref), "resume parity")
    _assert_tree_equal(_slots(got), _slots(ref), "slot parity")
    assert got.opt_state["step"] == ref.opt_state["step"] == 12


def test_async_save_false_overrides_previous_async_train(tmp_path):
    data = _data(n=16)
    save = str(tmp_path / "ck")
    sgd = _build()
    sgd.train(_reader(data), num_passes=1, save_dir=save,
              save_period_steps=1, resume=True, async_save=True)
    assert sgd._async_ckpt is not None
    sgd.train(_reader(data), num_passes=1, save_dir=save,
              save_period_steps=1, resume=True, async_save=False)
    assert sgd._async_ckpt is None, "stale async writer leaked"
    assert ckpt.load_latest(save, device="cpu") is not None


def test_exact_boundary_resume_does_not_refire_pass_events(tmp_path):
    data = _data(n=48)                      # 6 steps/pass
    save = str(tmp_path / "ck")
    plan = TrainFaultPlan(kill_save_at={2: "meta"})
    sgd_a = _build(faults=plan)
    with pytest.raises(InjectedTrainerDeath):
        sgd_a.train(_reader(data), num_passes=2, save_dir=save,
                    save_period_steps=3, resume=True, async_save=False)

    events = []

    def rec(ev):
        if isinstance(ev, (paddle.event.BeginPass, paddle.event.EndPass)):
            events.append((type(ev).__name__, ev.pass_id))

    sgd_b = _build()
    sgd_b.train(_reader(data), num_passes=2, save_dir=save,
                save_period_steps=3, resume=True, async_save=False,
                event_handler=rec)
    assert events == [("BeginPass", 1), ("EndPass", 1)], events
    ref = _build()
    ref.train(_reader(data), num_passes=2)
    _assert_tree_equal(_params(sgd_b), _params(ref), "boundary resume")


def test_resume_and_start_pass_are_exclusive(tmp_path):
    sgd = _build()
    with pytest.raises(EnforceError):
        sgd.train(_reader(_data()), num_passes=2, resume=True,
                  start_pass=1, save_dir=str(tmp_path))
    with pytest.raises(EnforceError):
        sgd.train(_reader(_data()), num_passes=1, resume=True)
    with pytest.raises(EnforceError):
        sgd.train(_reader(_data()), num_passes=1, save_period_steps=2)


# ---------------------------------------------------------------------------
# elastic path: injected deaths + pipelined async acks
# ---------------------------------------------------------------------------


def _write_recordio(tmp_path, data):
    from paddle_tpu_torch.master.recordio import recordio_write

    p = str(tmp_path / "train.recordio")
    recordio_write(p, [(",".join(f"{v:.6f}" for v in x) + f"|{y}").encode()
                       for x, y in data])
    return p


def _parse(rec):
    xs, label = rec.decode().split("|")
    return (np.asarray([float(v) for v in xs.split(",")], np.float32),
            int(label))


def test_elastic_injected_death_resume_parity_async(tmp_path):
    from paddle_tpu_torch.master.client import MasterClient
    from paddle_tpu_torch.master.service import Service

    clk = ManualClock(start=1000.0)
    data = _data(n=64, seed=3)
    path = _write_recordio(tmp_path, data)

    def fresh():
        svc = Service(chunks_per_task=8, timeout_s=1e6, time_fn=clk)
        svc.set_dataset([path])              # 8 tasks
        return svc

    ref = _build(seed=9)
    ref.train(master=MasterClient(service=fresh()), record_parser=_parse,
              num_passes=1, heartbeat_ttl_s=1e9)

    svc = fresh()
    save = str(tmp_path / "ck")
    sgd_a = _build(seed=9, faults=TrainFaultPlan(kill_at={5}))
    with pytest.raises(InjectedTrainerDeath):
        sgd_a.train(master=MasterClient(service=svc), record_parser=_parse,
                    num_passes=1, save_dir=save, heartbeat_ttl_s=10.0,
                    saving_period=2, async_save=True)
    assert svc.progress()["pending"] > 0, "the dead trainer holds tasks"
    clk.advance(11.0)                        # lease lapses -> requeue

    sgd_b = _build(seed=9)
    sgd_b.train(master=MasterClient(service=svc), record_parser=_parse,
                num_passes=1, save_dir=save, heartbeat_ttl_s=1e9,
                saving_period=2, async_save=True)
    _assert_tree_equal(_params(sgd_b), _params(ref), "elastic parity")
    prog = svc.progress()
    assert prog["pending"] == 0 and prog["todo"] == 0


# ---------------------------------------------------------------------------
# seeded chaos acceptance replay
# ---------------------------------------------------------------------------


def test_seeded_chaos_acceptance(tmp_path):
    out = tchaos.seeded_chaos(str(tmp_path / "chaos"), device="cpu")
    assert out["problems"] == []
    assert out["train_chaos_parity_ok"] == 1
    assert out["train_chaos_deaths"] == 4
    assert out["train_chaos_ckpt_corrupt_surviving"] == 0
    probe = tchaos.torn_save_probe(str(tmp_path / "torn"), device="cpu")
    assert probe["problems"] == [] and probe["torn_save_ok"] == 1
    from paddle_tpu_torch.obs import default_registry

    snap = default_registry().snapshot()
    assert snap.get("train_supervised_restarts{kind=death}") == 4.0
    assert snap.get("train_supervised_completed") == 1.0


def test_seeded_chaos_matches_jax(tmp_path, monkeypatch):
    """The JAX package's replay and the port's on the JAX classifier's
    numpy weights: the same deaths, restarts and skipped steps, costs per
    (pass, batch) within the f32 bound."""
    jcosts = {}
    recorder = jchaos._cost_recorder

    def recording(out):
        inner = recorder(out)

        def handler(ev):
            inner(ev)
            jcosts.update(out)
        return handler

    monkeypatch.setattr(jchaos, "_cost_recorder", recording)
    jout = jchaos.seeded_chaos(str(tmp_path / "jax"))
    tout = tchaos.seeded_chaos(str(tmp_path / "port"), device="cpu",
                               weights=_jax_weights())
    assert jout["problems"] == tout["problems"] == []
    for key in ("train_chaos_steps", "train_chaos_deaths",
                "train_chaos_restarts", "train_chaos_bad_steps_skipped",
                "train_chaos_ckpt_corrupt_surviving"):
        assert jout[key] == tout[key], key
    assert sorted(tout["costs"]) == sorted(f"{p}/{b}" for p, b in jcosts)
    for (p, b), c in jcosts.items():
        np.testing.assert_allclose(tout["costs"][f"{p}/{b}"], c, rtol=RTOL,
                                   atol=ATOL, err_msg=f"cost {p}/{b}")


def test_resilience_check_cli_exits_0():
    out = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.resilience",
                          "check", "--device=cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "resilience check ok: 4 injected deaths resumed" in out.stdout
    assert "CKPT-CORRUPT" not in out.stdout
