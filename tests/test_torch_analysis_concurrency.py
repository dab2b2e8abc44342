"""The port's concurrency auditor (``paddle_tpu_torch.analysis.
concurrency``) against the JAX package's: the 34 cases of
``tests/test_analysis_concurrency.py`` — one seeded-bad case per rule
class (unguarded access to a declared field, empty serialized
justification, malformed annotation, REQUIRES call site outside the
lock, undeclared enum assignment sites, broken checkpoint phase order,
undeclared runtime transitions, the order-sensitive ToyOrderDrive), the
clean pins over the port's tree, and the explorer's exact counts — with
the JAX package's results beside the port's where both run the same
input.  The fleet drives run on the CPU (``device="cpu"``) at the tiny
model's width, its weights one seeded numpy draw handed to both
packages."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import textwrap

import numpy as np
import pytest

from paddle_tpu.analysis.concurrency import guards as jguards
from paddle_tpu.analysis.concurrency import lifecycle as jlifecycle
from paddle_tpu.analysis.concurrency import schedules as JS
from paddle_tpu_torch.analysis.concurrency import RULE_NAMES, guards, \
    lifecycle
from paddle_tpu_torch.analysis.concurrency import schedules as S
from paddle_tpu_torch.analysis.concurrency.guards import (
    check_guards_source, run_guard_check)
from paddle_tpu_torch.analysis.concurrency.lifecycle import (
    MACHINES, record_transition, recorder, reset_recorder, run_static_check,
    runtime_diagnostics)
from paddle_tpu_torch.analysis.concurrency.schedules import (
    ToyOrderDrive, enumerate_schedules, explore_drive)
from paddle_tpu_torch.analysis.diagnostics import Severity
from paddle_tpu_torch.platform.flags import FLAGS

pytestmark = [pytest.mark.conc, pytest.mark.analysis]


def _src(body: str) -> str:
    return textwrap.dedent(body)


def _both_guards(src: str):
    """(port diagnostics, JAX diagnostics, annotation counts) of one
    source: the same messages in both."""
    diags, n = check_guards_source(src, path="t.py")
    jdiags, jn = jguards.check_guards_source(src, path="t.py")
    assert [d.message for d in diags] == [d.message for d in jdiags]
    assert n == jn
    return diags, n


# ---------------------------------------------------------------------------
# CONC-AUDIT: the guarded_by lock-discipline checker
# ---------------------------------------------------------------------------


class TestGuards:
    def test_unguarded_access_fires(self):
        diags, n = _both_guards(_src("""\
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._n = 0          # guarded_by(_lock)

                def bump(self):
                    self._n += 1
            """))
        assert n == 1
        assert len(diags) == 1
        assert diags[0].code == "CONC-AUDIT"
        assert "guarded_by(_lock)" in diags[0].message
        assert "t.py:9" in diags[0].message

    def test_with_lock_and_init_access_clean(self):
        diags, n = _both_guards(_src("""\
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._n = 0          # guarded_by(_lock)
                    self._n += 1         # __init__ is pre-publication

                def bump(self):
                    with self._lock:
                        self._n += 1
            """))
        assert n == 1
        assert diags == []

    def test_allow_escape_suppresses(self):
        diags, _ = _both_guards(_src("""\
            class C:
                def __init__(self):
                    self._n = 0          # guarded_by(_lock)

                def peek(self):
                    # racy read is tolerable: monotonic counter, display only
                    return self._n       # lint: allow(guarded-by)
            """))
        assert diags == []

    def test_empty_serialized_justification_fires(self):
        diags, _ = _both_guards(_src("""\
            class C:
                def __init__(self):
                    self._n = 0          # guarded_by(serialized:)
            """))
        assert len(diags) == 1
        assert "needs a justification" in diags[0].message

    def test_malformed_annotation_fires(self):
        diags, _ = _both_guards(_src("""\
            class C:
                def __init__(self):
                    self._n = 0          # guarded_by(the lock over there)
            """))
        assert len(diags) == 1
        assert "malformed" in diags[0].message

    def test_cross_object_serialized_access_fires(self):
        diags, _ = _both_guards(_src("""\
            class Tier:
                def __init__(self):
                    self._index = {}     # guarded_by(serialized: tick loop owns the tier)

            class Engine:
                def adopt(self, other):
                    return dict(other._index)
            """))
        assert len(diags) == 1
        assert "cross-object access" in diags[0].message

    def test_caller_form_checks_call_sites_not_body(self):
        diags, n = _both_guards(_src("""\
            import threading

            class C:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._n = 0          # guarded_by(_lock)

                # guarded_by(caller: _lock)
                def _bump_locked(self):
                    self._n += 1         # body proves under REQUIRES

                def good(self):
                    with self._lock:
                        self._bump_locked()

                def bad(self):
                    self._bump_locked()
            """))
        assert n == 2
        assert len(diags) == 1
        assert "_bump_locked" in diags[0].message
        assert "t.py:17" in diags[0].message

    def test_repo_guard_check_clean(self):
        """The port's tree: every annotation proven, and every threaded
        module of the JAX package's list (the jit retrace auditor aside,
        which the port does not have) declares its discipline."""
        assert run_guard_check() == []
        ported = {m.replace("paddle_tpu/", "paddle_tpu_torch/", 1)
                  for m in jguards.REQUIRED_MODULES
                  if m != "paddle_tpu/analysis/retrace.py"}
        assert set(guards.REQUIRED_MODULES) == ported

    def test_coverage_rule_fires_for_unannotated_module(self, monkeypatch):
        monkeypatch.setattr(
            guards, "REQUIRED_MODULES",
            guards.REQUIRED_MODULES + ("paddle_tpu_torch/platform/flags.py",))
        diags = run_guard_check()
        assert len(diags) == 1
        assert "declares no guarded_by" in diags[0].message
        assert "platform/flags.py" in diags[0].message


# ---------------------------------------------------------------------------
# PROTO-AUDIT static: declared tables vs assignment sites
# ---------------------------------------------------------------------------


def _msgs(diags):
    return [d.message.replace("paddle_tpu_torch/", "paddle_tpu/")
            for d in diags]


class TestLifecycleStatic:
    def test_repo_static_check_clean(self):
        assert run_static_check() == []

    def test_machine_tables_are_closed(self):
        def table(machines):
            return {k: (m.states, m.initial, m.terminal, m.edges)
                    for k, m in machines.items()}

        assert table(MACHINES) == table(jlifecycle.MACHINES)
        for spec in MACHINES.values():
            for src, dst in spec.edges:
                assert src in spec.states, (spec.name, src)
                assert dst in spec.states, (spec.name, dst)
            assert spec.initial in spec.states
            for term in spec.terminal:
                outgoing = [e for e in spec.edges if e[0] == term]
                # replica_lifecycle's dead is terminal for conservation
                # purposes but re-enters through restart_replica
                allowed = [("dead", "joining")] \
                    if spec.name == "replica_lifecycle" else []
                assert outgoing == allowed, \
                    f"{spec.name}: terminal {term} has outgoing {outgoing}"

    def test_undeclared_replica_state_fires(self):
        src = "rep.state = ReplicaState.ZOMBIE\n"
        diags = lifecycle._check_replica_lifecycle(
            {"paddle_tpu_torch/serving/fleet.py": src})
        assert len(diags) == 1
        assert diags[0].code == "PROTO-AUDIT"
        assert "ZOMBIE" in diags[0].message
        assert _msgs(diags) == _msgs(jlifecycle._check_replica_lifecycle(
            {"paddle_tpu/serving/fleet.py": src}))

    def test_undeclared_status_and_terminal_drift_fire(self):
        src = _src("""\
            req.status = RequestStatus.LIMBO
            _TERMINAL = frozenset({RequestStatus.COMPLETED})
            """)
        diags = lifecycle._check_request_status(
            {"paddle_tpu_torch/serving/scheduler.py": src})
        msgs = "\n".join(d.message for d in diags)
        assert len(diags) == 2
        assert "LIMBO" in msgs
        assert "drifted" in msgs
        assert _msgs(diags) == _msgs(jlifecycle._check_request_status(
            {"paddle_tpu/serving/scheduler.py": src}))

    def test_migration_marker_probes_fire(self):
        src = _src("""\
            m.on_migration_start()
            m.on_migration_applied()
            m.on_migration_vanished()
            """)
        diags = lifecycle._check_migration_transfer(
            {"paddle_tpu_torch/serving/fleet.py": src})
        msgs = "\n".join(d.message for d in diags)
        # missing fallback + aborted terminals, one undeclared marker
        assert len(diags) == 3
        assert "fallback" in msgs and "aborted" in msgs
        assert "on_migration_vanished" in msgs
        assert _msgs(diags) == _msgs(jlifecycle._check_migration_transfer(
            {"paddle_tpu/serving/fleet.py": src}))

    def test_checkpoint_phase_order_violation_fires(self):
        src = _src("""\
            ckpt.write_checkpoint(root)
            ckpt.snapshot_checkpoint(params)
            ckpt.prune_checkpoints(root)
            """)
        diags = lifecycle._check_checkpoint_commit(
            {"paddle_tpu_torch/resilience/checkpointer.py": src})
        assert len(diags) == 1
        assert "phase order" in diags[0].message
        assert _msgs(diags) == _msgs(jlifecycle._check_checkpoint_commit(
            {"paddle_tpu/resilience/checkpointer.py": src}))


# ---------------------------------------------------------------------------
# PROTO-AUDIT dynamic: the transition recorder
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_recorder():
    reset_recorder()
    yield
    reset_recorder()


class TestRecorder:
    def test_declared_edge_clean(self, fresh_recorder):
        assert record_transition("replica_lifecycle", "joining", "ready")
        assert runtime_diagnostics() == []

    def test_undeclared_edge_fires(self, fresh_recorder):
        assert not record_transition("replica_lifecycle", "ready",
                                     "joining")
        diags = runtime_diagnostics()
        assert len(diags) == 1
        assert diags[0].severity is Severity.ERROR
        assert "replica_lifecycle: ready -> joining" in diags[0].message

    def test_self_loop_skipped(self, fresh_recorder):
        assert record_transition("request_status", "running", "running")
        assert recorder().counts() == {}

    def test_unknown_machine_is_undeclared(self, fresh_recorder):
        assert not record_transition("coffee_machine", "idle", "brewing")
        assert len(runtime_diagnostics()) == 1

    def test_duplicate_undeclared_edges_deduplicated(self, fresh_recorder):
        record_transition("migration_transfer", "applied", "started")
        record_transition("migration_transfer", "applied", "started")
        assert len(runtime_diagnostics()) == 1

    def test_registry_counters_published(self, fresh_recorder):
        from paddle_tpu_torch.obs import MetricsRegistry
        reg = MetricsRegistry()
        record_transition("replica_lifecycle", "joining", "ready",
                          registry=reg)
        record_transition("replica_lifecycle", "ready", "joining",
                          registry=reg)
        snap = reg.snapshot()
        assert snap["lifecycle_transitions_total{dst=ready,"
                    "machine=replica_lifecycle,src=joining}"] == 1.0
        assert snap["lifecycle_undeclared_total"
                    "{machine=replica_lifecycle}"] == 1.0


# ---------------------------------------------------------------------------
# SCHED-AUDIT: the schedule-permutation explorer
# ---------------------------------------------------------------------------


class TestScheduleEnumeration:
    def test_site_perms_deterministic_and_capped(self):
        for names in (("a", "b"), ("a", "b", "c"), tuple("abcd")):
            assert S._site_perms(names) == JS._site_perms(names)
        assert S._site_perms(("a", "b")) == [("b", "a")]
        perms = S._site_perms(("a", "b", "c"))
        assert len(perms) == 5          # 3! - canonical = 5, under cap
        assert perms[0] == ("a", "c", "b")
        assert len(S._site_perms(tuple("abcd"))) == 5   # capped

    def test_exact_schedule_counts(self):
        sites = [("phases", 0, ("a", "b", "c")), ("replicas", 1, (0, 1))]
        # singles: 5 perms for the 3-name site + 1 swap = 6; pairs:
        # cross-site only (one order per ordering point) = 5 * 1 = 5
        for budget, want in ((100, 11), (8, 8)):
            got = enumerate_schedules(sites, budget=budget)
            assert len(got) == want
            assert got == JS.enumerate_schedules(sites, budget=budget)
        assert enumerate_schedules([], budget=8) == []

    def test_singles_come_before_pairs(self):
        sites = [("phases", 0, ("a", "b")), ("phases", 1, ("a", "b"))]
        scheds = enumerate_schedules(sites, budget=10)
        assert [len(d) for d in scheds] == [1, 1, 2]
        assert scheds == JS.enumerate_schedules(sites, budget=10)


class TestToyDrive:
    def test_divergence_caught_with_minimal_delta(self):
        explored, diags = explore_drive(ToyOrderDrive(), budget=16)
        jexplored, jdiags = JS.explore_drive(JS.ToyOrderDrive(), budget=16)
        # max_findings=3 stops the walk after three divergent singles
        assert explored == jexplored == 3
        assert [d.message for d in diags] == [d.message for d in jdiags]
        assert len(diags) == 3
        assert all(d.severity is Severity.ERROR for d in diags)
        assert all(d.code == "SCHED-AUDIT" for d in diags)
        assert "tick 0 phases order ['dbl', 'inc']" in diags[0].message
        assert "diverged" in diags[0].message

    def test_commuting_twin_clean_but_coverage_warns(self):
        explored, diags = explore_drive(ToyOrderDrive(commuting=True),
                                        budget=16)
        assert explored == 6            # 3 singles + 3 cross-tick pairs
        assert len(diags) == 1
        assert diags[0].severity is Severity.WARNING
        assert "coverage bar is 50" in diags[0].message

    def test_budget_truncates_exploration(self):
        explored, diags = explore_drive(ToyOrderDrive(commuting=True),
                                        budget=2)
        assert explored == 2
        assert diags == []              # bar relaxes to min(50, budget)


@pytest.fixture(scope="module")
def jax_kill_partition_record():
    """The JAX package's kill-partition drive on the port's tiny model's
    numpy weights: its canonical fingerprint and hot sites."""
    import jax.numpy as jnp

    from paddle_tpu.serving import DecoderLM as JaxLM

    from paddle_tpu_torch import convert

    weights = {k: v.detach().numpy() for k, v in
               convert.decoder_lm_state(S._model("cpu")).items()}
    jmodel = JaxLM(vocab_size=32, num_layers=1, num_heads=2, head_dim=4,
                   max_positions=64)
    saved = JS._MODEL, JS._CACHE_ON
    JS._MODEL = (jmodel, {k: jnp.asarray(v) for k, v in weights.items()})
    JS._CACHE_ON = True     # no persistent compile cache outside this test
    try:
        return JS._drive_fleet_kill_partition().record()
    finally:
        JS._MODEL, JS._CACHE_ON = saved


class TestFleetDrives:
    def test_flag_default_covers_the_bar(self):
        assert int(FLAGS.conc_audit_max_schedules) == 64
        assert S.MIN_SCHEDULES_PER_DRIVE == JS.MIN_SCHEDULES_PER_DRIVE == 50

    def test_kill_partition_drive_clean_under_small_budget(
            self, jax_kill_partition_record):
        drive = S._drive_fleet_kill_partition("cpu")
        base, sites = drive.record()
        jbase, jsites = jax_kill_partition_record
        # the same hot sites and terminal outcome as the JAX package's
        # drive on the same weights
        assert sites == jsites
        assert base == jbase
        explored, diags = explore_drive(drive, budget=4)
        assert explored == 4            # the JAX package's pinned count
        assert diags == []

    def test_invalid_delta_is_ignored_not_applied(self):
        drive = S._drive_fleet_kill_partition("cpu")
        base, sites = drive.record()
        assert len(sites) >= 2          # kill+partition overlap is hot
        kind, tick, names = sites[0]
        # not a permutation of the canonical names: replay must keep
        # the canonical order rather than drop/duplicate replicas
        fp = drive.replay({(kind, tick): tuple(names) + (names[0],)})
        assert fp == base

    @pytest.mark.slow
    def test_all_drives_clean_at_full_budget(self):
        for drive in S.default_drives("cpu"):
            explored, diags = explore_drive(drive)
            assert explored == 64, (drive.name, explored)
            assert diags == [], (drive.name, diags)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


class TestCli:
    def test_unknown_rule_exits_2(self, capsys):
        from paddle_tpu_torch.analysis.cli import main
        assert main(["concurrency", "--rule", "bogus"]) == 2
        assert "unknown rule" in capsys.readouterr().err

    def test_static_rules_exit_0_on_clean_repo(self, capsys):
        from paddle_tpu_torch.analysis.cli import main
        rc = main(["concurrency", "--rule", "guarded-by",
                   "--rule", "state-table"])
        assert rc == 0
        assert "concurrency audit ok" in capsys.readouterr().out

    def test_rule_names_cover_all_families(self):
        from paddle_tpu.analysis.concurrency import RULE_NAMES as JRULES
        assert RULE_NAMES == JRULES == (
            "guarded-by", "state-table", "transition-runtime",
            "schedule-permute")


def test_runtime_rules_drive_the_port_fleet_on_the_cpu(capsys):
    """``concurrency --rule transition-runtime --device cpu`` runs the four
    chaos drives once each through the port's fleet: every transition
    declared, exit 0; the jaxpr auditors' commands raise, naming the
    slice that is left."""
    from paddle_tpu_torch.analysis.cli import main
    from paddle_tpu_torch.platform.enforce import EnforceError

    assert main(["concurrency", "--rule", "transition-runtime",
                 "--device", "cpu"]) == 0
    counts = recorder().counts()
    assert any(m == "replica_lifecycle" for m, _, _ in counts)
    assert np.sum(list(counts.values())) > 0
    for cmd in ("xla", "sharding"):
        with pytest.raises(EnforceError, match="jaxpr auditors"):
            main([cmd])
