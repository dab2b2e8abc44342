"""The seeded training-chaos replay: one scenario, three consumers (the
port of ``paddle_tpu/resilience/chaos.py``).

``seeded_chaos`` trains a small classifier twice under the SAME seeded
gradient-poison schedule:

- **control** — uninterrupted, no checkpoints, bad-step guard on;
- **chaos** — kill-at-step deaths, a slow-step window, a kill between
  blob write and meta commit, step-granular async checkpoints, and the
  resume supervisor restarting after every death.

The acceptance bar: the chaos run's final parameters and optimizer slots
are BIT-IDENTICAL to the control's, its per-step loss trajectory matches
exactly, every injected non-finite step was skipped with slots
untouched, every death resumed from a verified checkpoint, no surviving
artifact is corrupt, and the torn save left the previous checkpoint
loadable.  ``python -m paddle_tpu_torch.resilience check`` turns any
violation into exit 1; ``chip_smoke.py`` runs it on the card;
tests/test_torch_resilience.py pins the pieces individually and holds the
replay against the JAX package's on the same numpy weights.

Shared by the CLI, chip_smoke and the tests so "bit-identical across
chaos" has ONE definition.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from paddle_tpu_torch.platform.device import DeviceLike

__all__ = ["seeded_chaos", "torn_save_probe"]

# the default plan: 24 global steps (3 passes x 8), three scheduled
# deaths each with a durable checkpoint behind it, three poisoned steps
# (one NaN pair mid-pass-0, one lone Inf in pass 1), one slow-step
# window, and checkpoint id 4 killed between state blob and meta commit
KILLS = (4, 11, 17)
BAD_STEPS = (5, 6, 13)
SLOW_STEPS = {9: 2.0}
KILL_SAVE = {4: "meta"}


def _build_trainer(guard=None, faults=None, tracer=None, seed=5, lr=0.1,
                   device: DeviceLike = None, weights=None):
    """The scenario's small classifier — ONE definition shared by the
    CLI gate, chip_smoke and tests/test_torch_resilience.py.  Its weights
    are the port's own seeded init, or ``weights`` (name -> numpy array)
    when given: the cross-package tests hand both packages the same
    arrays."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import convert, layer, optimizer, trainer

    paddle.topology.reset_name_scope()
    x = layer.data(name="x", type=paddle.data_type.dense_vector(8))
    y = layer.data(name="y", type=paddle.data_type.integer_value(2))
    cost = layer.classification_cost(
        input=layer.fc(input=layer.fc(input=x, size=16, act="relu"),
                       size=2), label=y)
    if weights is not None:
        params = convert.parameters_from_numpy(weights, device)
    else:
        params = paddle.Parameters.from_topology(
            paddle.topology.Topology([cost]), seed=seed, device=device)
    return trainer.SGD(cost=cost, parameters=params,
                       update_equation=optimizer.Momentum(
                           momentum=0.9, learning_rate=lr),
                       guard=guard, faults=faults, tracer=tracer,
                       device=device)


def _dataset(seed: int = 0, n: int = 32):
    import numpy as np

    rng = np.random.RandomState(seed)
    w = rng.randn(8)
    return [(x.astype(np.float32), int(x @ w > 0))
            for x in rng.randn(n, 8)]


def _snap(sgd) -> Dict[str, "object"]:
    return {k: sgd.parameters.get(k) for k in sgd.parameters.names()}


def _slots(sgd) -> Dict[str, "object"]:
    return {f"{s}/{k}": v.detach().cpu().numpy()
            for s, d in sgd.opt_state["slots"].items()
            for k, v in d.items()}


def _cost_recorder(out: Dict):
    from paddle_tpu_torch import event as v2_event

    def handler(ev) -> None:
        if isinstance(ev, v2_event.EndIteration):
            # keyed by (pass, batch): a chaos run re-executes lost steps
            # after each resume; last-write-wins is exactly the "what
            # the run actually applied" trajectory to pin vs control
            out[(ev.pass_id, ev.batch_id)] = float(ev.cost)

    return handler


def seeded_chaos(save_dir: str, *, seed: int = 0, passes: int = 3,
                 batch: int = 8, samples: int = 64,
                 save_period_steps: int = 3, async_save: bool = True,
                 keep: int = 3, max_restarts: int = 10,
                 device: DeviceLike = None, weights=None) -> Dict:
    """Run control + chaos (see module doc) on ``device`` (``cuda``
    unless asked), from ``weights`` when given; returns a metrics dict
    with a ``problems`` list (empty = every acceptance assertion held)."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.resilience.faults import (ManualClock,
                                                    TrainFaultPlan)
    from paddle_tpu_torch.resilience.guard import BadStepGuard
    from paddle_tpu_torch.resilience.supervisor import run_supervised

    data = _dataset(seed, samples)
    reader = paddle.batch(lambda: iter(data), batch)
    guard = BadStepGuard(policy="skip")

    plan = TrainFaultPlan(seed=seed, clock=ManualClock(tick_s=0.01),
                          kill_at=set(KILLS), bad_steps=set(BAD_STEPS),
                          slow_steps=dict(SLOW_STEPS),
                          kill_save_at=dict(KILL_SAVE))

    def build(faults):
        return _build_trainer(guard, faults=faults, device=device,
                              weights=weights)

    # ---- control: same poison, no kills, no checkpoints ------------------
    control_costs: Dict = {}
    control = build(plan.control_twin())
    control.train(reader, num_passes=passes,
                  event_handler=_cost_recorder(control_costs))
    control_params, control_slots = _snap(control), _slots(control)
    control_bad = getattr(control, "bad_steps_total", 0)

    # ---- chaos: supervised across deaths ---------------------------------
    chaos_costs: Dict = {}
    resumed_fresh = {"n": 0}   # attempts that found NO checkpoint
    bad_per_attempt: List[int] = []

    def attempt(i: int):
        sgd = build(plan)
        if i > 0 and not any(
                ckpt.verify_pass_dir(save_dir, pid) is None
                for pid in ckpt._pass_ids(save_dir)):
            # metadata-level probe (md5 results are stat-cached): no
            # second full deserialization next to train()'s own load
            resumed_fresh["n"] += 1
        try:
            sgd.train(reader, num_passes=passes, save_dir=save_dir,
                      save_period_steps=save_period_steps, resume=True,
                      async_save=async_save, keep=keep,
                      event_handler=_cost_recorder(chaos_costs))
        finally:
            # per-attempt skip count (flushed at each pass end); re-run
            # windows legitimately re-skip, so the cross-attempt sum is
            # >= the schedule, never ==
            bad_per_attempt.append(getattr(sgd, "bad_steps_total", 0))
        return sgd

    report, chaos = run_supervised(attempt, max_restarts=max_restarts)
    chaos_params, chaos_slots = _snap(chaos), _slots(chaos)
    chaos_bad = sum(bad_per_attempt)

    # one scrape surface: the chaos run's recovery history lands on the
    # default registry next to serving/trainer metrics
    from paddle_tpu_torch.obs import default_registry, publish_resilience

    publish_resilience(default_registry(), checkpointer=chaos._async_ckpt,
                       report=report)

    # ---- acceptance assertions -------------------------------------------
    problems: List[str] = []
    bitwise = all(np.array_equal(control_params[k], chaos_params[k])
                  for k in control_params)
    if not bitwise:
        problems.append("final params NOT bit-identical to the "
                        "uninterrupted control")
    if set(control_slots) != set(chaos_slots) or not all(
            np.array_equal(control_slots[k], chaos_slots[k])
            for k in control_slots):
        problems.append("final optimizer slots diverged from control "
                        "(a skipped bad step touched state)")
    if control_costs != chaos_costs:
        diff = [k for k in sorted(set(control_costs) | set(chaos_costs))
                if control_costs.get(k) != chaos_costs.get(k)]
        problems.append(f"loss trajectory diverged at {diff[:4]}")
    if control_bad != len(BAD_STEPS) or chaos_bad < len(BAD_STEPS):
        problems.append(f"bad-step count wrong: control={control_bad} "
                        f"(expected {len(BAD_STEPS)}), chaos skipped "
                        f"{chaos_bad} (expected >= {len(BAD_STEPS)})")
    expected_deaths = len(KILLS) + len(KILL_SAVE)
    if report.deaths != expected_deaths or not report.completed:
        problems.append(f"supervisor saw {report.deaths} deaths "
                        f"(expected {expected_deaths}), "
                        f"completed={report.completed}")
    if resumed_fresh["n"]:
        problems.append(f"{resumed_fresh['n']} restart(s) found no "
                        "checkpoint — a death was not covered by a "
                        "durable artifact")
    # every surviving meta-bearing artifact must verify clean
    corrupt = [pid for pid in ckpt._pass_ids(save_dir)
               if ckpt.verify_pass_dir(save_dir, pid)
               not in (None, "missing meta.json")]
    if corrupt:
        problems.append(f"surviving corrupt checkpoint dirs: {corrupt}")

    ck = chaos._async_ckpt
    return {
        "train_chaos_parity_ok": int(bitwise and not problems),
        "train_chaos_steps": passes * (samples // batch),
        "train_chaos_deaths": report.deaths,
        "train_chaos_restarts": report.restarts,
        "train_chaos_bad_steps_skipped": chaos_bad,
        "train_chaos_ckpt_corrupt_surviving": len(corrupt),
        "train_chaos_ckpt_saves": ck.saves if ck is not None else 0,
        "train_chaos_ckpt_stall_s": round(ck.stall_s, 4)
        if ck is not None else None,
        "train_chaos_ckpt_write_s": round(ck.write_s, 4)
        if ck is not None else None,
        "costs": {f"{p}/{b}": c for (p, b), c in sorted(chaos_costs.items())},
        "problems": problems,
    }


def torn_save_probe(save_dir: str, *, seed: int = 1,
                    device: DeviceLike = None, weights=None) -> Dict:
    """The commit-protocol pin, end to end: kill checkpoint N between
    the state blob and the meta commit, and prove the PREVIOUS
    checkpoint is still ``latest`` and loadable.  Returns a dict with a
    ``problems`` list (the ``check`` CLI folds it into exit 1)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.resilience.faults import (InjectedTrainerDeath,
                                                    TrainFaultPlan)
    from paddle_tpu_torch.resilience.guard import BadStepGuard

    problems: List[str] = []
    data = _dataset(seed, 32)
    reader = paddle.batch(lambda: iter(data), 8)   # 4 steps/pass
    plan = TrainFaultPlan(seed=seed, kill_save_at={1: "meta"})
    sgd = _build_trainer(BadStepGuard(), faults=plan, device=device,
                         weights=weights)
    died = False
    try:
        # sync saves: the death fires inside write_checkpoint itself
        sgd.train(reader, num_passes=2, save_dir=save_dir,
                  save_period_steps=2, resume=True, async_save=False,
                  keep=0)
    except InjectedTrainerDeath:
        died = True
    if not died:
        problems.append("kill-during-save never fired")
    latest = ckpt.latest_pass(save_dir)
    if latest != 0:
        problems.append(f"torn save did not leave checkpoint 0 as "
                        f"latest (got {latest})")
    got: Optional[tuple] = ckpt.load_latest(save_dir, device=device)
    if got is None:
        problems.append("previous checkpoint not loadable after the "
                        "torn save")
    reason = ckpt.verify_pass_dir(save_dir, 1)
    if reason != "missing meta.json":
        problems.append(f"torn dir should be meta-less, verify said "
                        f"{reason!r}")
    # a resumed run overwrites the torn dir and completes
    sgd2 = _build_trainer(BadStepGuard(), faults=plan, device=device,
                          weights=weights)
    sgd2.train(reader, num_passes=2, save_dir=save_dir,
               save_period_steps=2, resume=True, async_save=False, keep=0)
    if ckpt.verify_pass_dir(save_dir, 1) is not None:
        problems.append("resume did not rewrite the torn checkpoint dir")
    return {"torn_save_ok": int(not problems), "problems": problems}
