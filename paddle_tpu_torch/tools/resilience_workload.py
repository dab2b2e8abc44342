"""The resilience slice's card workloads: ``chip_smoke.py``'s
``train_resume``, ``resilience_chaos`` and ``train_elastic`` phases, and
``tests/test_torch_resilience_cuda.py`` at 2 blocks.

- :func:`resume_run`: the headline transformer (``train_workload``: d
  2048, 16 heads, vocab 32768, 8 x 1024 tokens, Momentum 0.9 at 1e-3) on
  one repeated batch, one pass of :data:`RESUME_STEPS` steps with NaN
  poison at global step :data:`BAD_STEP` under ``BadStepGuard("skip")``.
  The control runs under the plan's control twin without checkpoints; the
  chaos run dies at global step :data:`KILL_AT`, saves every
  :data:`SAVE_PERIOD` steps asynchronously (``keep`` :data:`KEEP`) and is
  restarted by ``run_supervised`` with a fresh trainer from the same
  weights: two full checkpoints written, one loaded, a mid-pass cursor
  (step-in-pass 3) and one replayed step.  Every parameter and Momentum
  slot must equal the control's under ``torch.equal``.
- :func:`step_ms`: guarded and unguarded step time on the same weights.
- :func:`chaos_run`: ``resilience.chaos.seeded_chaos`` and
  ``torn_save_probe`` with the reference's default plan.
- :func:`elastic_run`: a narrow transformer (:data:`ELASTIC_MODEL`, 2 x
  256 tokens a task: the protocol is under test, not the width) trained
  from 8 recordio tasks through an in-process ``master.Service`` on an
  injected clock, killed at step :data:`ELASTIC_KILL_AT` with async
  checkpoints every :data:`ELASTIC_SAVING_PERIOD` tasks; the lease lapses
  and a replacement trainer finishes the pass.  Its params must equal a
  straight run's under ``torch.equal``, every task acked once, and one
  ``MasterClient`` round trip goes over a ``MasterServer`` on localhost.

Each returns a dict with a ``problems`` list (empty = every gate held).
Checkpoints go under a fresh ``tempfile.mkdtemp()``, removed at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from paddle_tpu_torch.tools import train_workload as tw

RESUME_STEPS, BAD_STEP, KILL_AT, SAVE_PERIOD, KEEP = 5, 1, 4, 3, 2
# step_ms: steps a window (the first untimed), windows per trainer
TIMED_STEPS, TIMED_WINDOWS = 6, 4

ELASTIC_MODEL = dict(vocab_size=1024, d_model=256, n_layers=2, n_heads=4,
                     max_len=256)
ELASTIC_TASKS, ELASTIC_BATCH, ELASTIC_SEQ = 8, 2, 256
ELASTIC_KILL_AT, ELASTIC_SAVING_PERIOD = 5, 2
ELASTIC_SEED = 3


def _state(sgd, clone: bool = True) -> Dict[str, object]:
    """Every parameter, optimizer slot and model-state tensor of ``sgd``
    (clones unless ``clone=False``) and its optimizer step count."""
    out: Dict[str, object] = {"step": int(sgd.opt_state["step"])}
    for k, v in sgd.parameters.items():
        out[f"param/{k}"] = v.detach().clone() if clone else v
    for s, d in sgd.opt_state["slots"].items():
        for k, v in d.items():
            out[f"slot/{s}/{k}"] = v.clone() if clone else v
    for layer, slots in sgd.model_state.items():
        for k, v in slots.items():
            out[f"model_state/{layer}/{k}"] = v.clone() if clone else v
    return out


def _differ(a: Dict[str, object], b: Dict[str, object]) -> List[str]:
    """Keys whose values are not bit-identical."""
    keys = sorted(set(a) | set(b))
    return [k for k in keys if k not in a or k not in b or (
        not torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] != b[k])]


_DISK_TIMERS = ("checkpoint_write", "checkpoint_md5", "checkpoint_verify",
                "checkpoint_read")


def _disk_seconds() -> Dict[str, float]:
    """The checkpoint disk phases' seconds so far (``platform.stats``)."""
    from paddle_tpu_torch.platform import stats

    out = {}
    for name in _DISK_TIMERS:
        entry = stats.timer_stats().get(name)
        out[name[len("checkpoint_"):]] = entry.total if entry else 0.0
    return out


def _disk(path: str) -> Dict[str, float]:
    du = shutil.disk_usage(path)
    return {"path": path, "total_gb": du.total / 1e9,
            "free_gb": du.free / 1e9}


def resume_run(device, n_layers: int = tw.MODEL["n_layers"]) -> dict:
    """The kill-and-resume run against its uninterrupted control (see the
    module doc); the numbers ``chip_smoke.py`` prints beside the gates."""
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch import event
    from paddle_tpu_torch.resilience import (BadStepGuard, TrainFaultPlan,
                                             run_supervised)

    problems: List[str] = []
    reader = tw.repeat_reader(tw.lm_samples(tw.SEED + 1), RESUME_STEPS)
    plan = TrainFaultPlan(seed=0, kill_at={KILL_AT}, bad_steps={BAD_STEP})
    guard = BadStepGuard("skip")
    t0 = time.perf_counter()
    control = tw.build_trainer(device, n_layers, faults=plan.control_twin(),
                               guard=guard)
    init = {k: v.detach().clone() for k, v in control.parameters.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    tw.reset_flash_launches()
    steps_run = [0]

    # ---- control: the poison, no kills, no checkpoints -------------------
    control_costs: Dict = {}
    before: Dict[str, object] = {}
    untouched: List[List[str]] = []

    def on_control(ev):
        if isinstance(ev, event.BeginIteration) and ev.batch_id == BAD_STEP:
            before.update(_state(control))
        elif isinstance(ev, event.EndIteration):
            steps_run[0] += 1
            control_costs[(ev.pass_id, ev.batch_id)] = float(ev.cost)
            if ev.batch_id == BAD_STEP:
                untouched.append(_differ(before, _state(control, False)))
                before.clear()

    control.train(reader, num_passes=1, event_handler=on_control,
                  feeding=tw.FEEDING)

    # ---- chaos: killed at KILL_AT, resumed by the supervisor -------------
    save_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_resume_")
    disk = _disk(save_dir)
    chaos_costs: Dict = {}
    attempts: List[dict] = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def attempt(i: int):
        if i:
            # a replacement worker is a fresh process: nothing verified
            ckpt._VERIFY_OK_CACHE.clear()
        info: dict = {"attempt": i}
        attempts.append(info)
        sgd = tw.build_trainer(device, n_layers, weights=init, faults=plan,
                               guard=guard)
        io0 = _disk_seconds()
        t_train = [0.0]

        def on_chaos(ev):
            if isinstance(ev, event.BeginIteration) and "resume_s" not in info:
                # train() called -> its first step: the load, its verify
                # and the copy into the live tensors
                info["resume_s"] = time.perf_counter() - t_train[0]
                info["load_io_s"] = {k: v - io0[k] for k, v in
                                     _disk_seconds().items()}
                info["first_batch"] = ev.batch_id
            elif isinstance(ev, event.EndIteration):
                steps_run[0] += 1
                chaos_costs[(ev.pass_id, ev.batch_id)] = float(ev.cost)

        try:
            t_train[0] = time.perf_counter()
            sgd.train(reader, num_passes=1, save_dir=save_dir,
                      save_period_steps=SAVE_PERIOD, resume=True,
                      async_save=True, keep=KEEP, event_handler=on_chaos,
                      feeding=tw.FEEDING)
        finally:
            ck = sgd._async_ckpt
            info.update(saves=ck.saves, bytes=ck.last_bytes,
                        snapshot_ms=[1e3 * s for s in ck.snapshots],
                        stall_s=ck.stall_s, write_s=ck.write_s,
                        bad_steps=sgd.bad_steps_total,
                        io_s={k: v - io0[k]
                              for k, v in _disk_seconds().items()})
        return sgd

    report, chaos = run_supervised(attempt, max_restarts=2)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 \
        if device.type == "cuda" else None
    launches = tw.flash_launches()
    left = sorted(os.listdir(save_dir))

    # ---- gates ------------------------------------------------------------
    differ = _differ(_state(control, False), _state(chaos, False))
    if differ:
        problems.append(f"chaos run differs from the control in "
                        f"{len(differ)} tensors, e.g. {differ[:3]}")
    if control_costs != chaos_costs:
        problems.append(f"costs differ: control {control_costs}, chaos "
                        f"{chaos_costs}")
    chaos_bad = sum(a["bad_steps"] for a in attempts)
    if control.bad_steps_total != 1 or chaos_bad != 1:
        problems.append(f"bad steps skipped: control "
                        f"{control.bad_steps_total}, chaos {chaos_bad}, "
                        "expected 1 each")
    if untouched != [[]]:
        problems.append(f"the poisoned step changed {untouched}")
    if not (report.completed and report.deaths == 1 and
            report.restarts == 1):
        problems.append(f"supervisor: {report}")
    if len(attempts) != 2 or attempts[1].get("first_batch") != SAVE_PERIOD:
        problems.append("the restart did not resume from the step-"
                        f"{SAVE_PERIOD} checkpoint: {attempts}")
    for name, n in launches.items():
        if n != n_layers * steps_run[0]:
            problems.append(f"{name} launched {n} times, expected "
                            f"{n_layers} x {steps_run[0]} steps")
    shutil.rmtree(save_dir, ignore_errors=True)
    del control, chaos
    return {"layers": n_layers, "steps": RESUME_STEPS, "setup_s": setup_s,
            "disk": disk, "checkpoint_bytes": attempts[0]["bytes"],
            "attempts": attempts, "restarts": report.restarts,
            "steps_run": steps_run[0], "left_in_save_dir": left,
            "costs": {f"{p}/{b}": c for (p, b), c in
                      sorted(chaos_costs.items())},
            "kernel_launches": launches, "peak_memory_gb": peak,
            "init": init, "problems": problems}


def step_ms(device, init, n_layers: int = tw.MODEL["n_layers"]) -> dict:
    """Mean step time, guarded (``BadStepGuard("skip")``, no poison) and
    unguarded, on trainers built from the same weights:
    :data:`TIMED_STEPS` steps back to back per window, timed from the end
    of the first step (after a synchronize) to the end of the last,
    :data:`TIMED_WINDOWS` windows a trainer, alternating; medians over
    the windows."""
    from paddle_tpu_torch import event
    from paddle_tpu_torch.resilience import BadStepGuard

    reader = tw.repeat_reader(tw.lm_samples(tw.SEED + 1), TIMED_STEPS)
    trainers = {"unguarded": tw.build_trainer(device, n_layers,
                                              weights=init),
                "guarded": tw.build_trainer(device, n_layers, weights=init,
                                            guard=BadStepGuard("skip"))}
    times: Dict[str, List[float]] = {k: [] for k in trainers}
    for _ in range(TIMED_WINDOWS):
        for name, sgd in trainers.items():
            t = [0.0]

            def on(ev):
                if isinstance(ev, event.EndIteration) and ev.batch_id == 0:
                    float(ev.cost)
                    torch.cuda.synchronize(device)
                    t[0] = time.perf_counter()

            sgd.train(reader, num_passes=1, event_handler=on,
                      feeding=tw.FEEDING)
            torch.cuda.synchronize(device)
            times[name].append(1e3 * (time.perf_counter() - t[0])
                               / (TIMED_STEPS - 1))
    reads = {k: sgd.verdict_reads for k, sgd in trainers.items()}
    del trainers
    return {f"{k}_step_ms": float(np.median(v)) for k, v in times.items()} \
        | {f"{k}_step_ms_windows": v for k, v in times.items()} \
        | {"verdict_reads": reads,
           "steps_per_window": TIMED_STEPS, "windows": TIMED_WINDOWS}


def chaos_run(device) -> dict:
    """``seeded_chaos`` and ``torn_save_probe`` with the reference's
    default plan on ``device``."""
    from paddle_tpu_torch.resilience.chaos import (seeded_chaos,
                                                   torn_save_probe)

    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_chaos_")
    try:
        out = seeded_chaos(os.path.join(tmp, "chaos"), device=device)
        probe = torn_save_probe(os.path.join(tmp, "torn"), seed=1,
                                device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["problems"] = list(out["problems"]) + list(probe["problems"])
    out["torn_save_ok"] = probe["torn_save_ok"]
    out.pop("costs")
    return out


def _elastic_trainer(device, weights=None, faults=None):
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    *_, cost = transformer.build(**ELASTIC_MODEL)
    if weights is None:
        params = Parameters.from_topology(topology.Topology([cost]),
                                          seed=ELASTIC_SEED, device=device)
    else:
        params = Parameters()
        for name, value in weights.items():
            params[name] = value.detach().clone()
    return trainer.SGD(cost, params, optimizer.Momentum(
        momentum=tw.MOMENTUM, learning_rate=tw.LEARNING_RATE),
        faults=faults, device=device)


def _parse(rec: bytes):
    return tuple(json.loads(rec))


def elastic_run(device) -> dict:
    """The elastic kill-and-rejoin run against a straight run (see the
    module doc)."""
    from paddle_tpu_torch import event
    from paddle_tpu_torch.master import (MasterClient, MasterServer,
                                         Service, recordio_write)
    from paddle_tpu_torch.resilience import (InjectedTrainerDeath,
                                             ManualClock, TrainFaultPlan)

    problems: List[str] = []
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_elastic_")
    disk = _disk(tmp)
    path = os.path.join(tmp, "train.recordio")
    samples = tw.lm_samples(ELASTIC_SEED, bs=ELASTIC_TASKS * ELASTIC_BATCH,
                            seq=ELASTIC_SEQ,
                            vocab=ELASTIC_MODEL["vocab_size"])
    recordio_write(path, [json.dumps(s).encode() for s in samples])
    clock = ManualClock(start=1000.0)
    acks: Dict[int, int] = {}

    class CountingService(Service):
        """Counts each task's successful acks."""

        def task_finished(self, task_id: int) -> bool:
            ok = super().task_finished(task_id)
            if ok:
                acks[task_id] = acks.get(task_id, 0) + 1
            return ok

    def fresh(cls=Service):
        svc = cls(chunks_per_task=ELASTIC_BATCH, timeout_s=1e6,
                  time_fn=clock)
        svc.set_dataset([path])
        return svc

    steps_run = [0]

    def count(ev):
        if isinstance(ev, event.EndIteration):
            steps_run[0] += 1

    kw = dict(record_parser=_parse, num_passes=1, feeding=tw.FEEDING,
              event_handler=count)
    tw.reset_flash_launches()
    t0 = time.perf_counter()
    straight = _elastic_trainer(device)
    init = {k: v.detach().clone() for k, v in straight.parameters.items()}
    straight.train(master=MasterClient(service=fresh()),
                   heartbeat_ttl_s=1e9, **kw)
    save_dir = os.path.join(tmp, "ck")
    svc = fresh(CountingService)
    dead = _elastic_trainer(device, weights=init,
                            faults=TrainFaultPlan(kill_at={ELASTIC_KILL_AT}))
    died = False
    try:
        dead.train(master=MasterClient(service=svc), save_dir=save_dir,
                   heartbeat_ttl_s=10.0,
                   saving_period=ELASTIC_SAVING_PERIOD, async_save=True,
                   **kw)
    except InjectedTrainerDeath:
        died = True
    held = svc.progress()["pending"]
    clock.advance(11.0)                      # the dead trainer's lease lapses
    rejoined = _elastic_trainer(device, weights=init)
    rejoined.train(master=MasterClient(service=svc), save_dir=save_dir,
                   heartbeat_ttl_s=1e9, saving_period=ELASTIC_SAVING_PERIOD,
                   async_save=True, **kw)
    seconds = time.perf_counter() - t0
    launches = tw.flash_launches()
    progress = svc.progress()
    srv = MasterServer(service=svc).start()
    try:
        client = MasterClient(srv.address)
        over_tcp = client.progress()
        client.close()
    finally:
        srv.stop()
    shutil.rmtree(tmp, ignore_errors=True)

    differ = [k for k in straight.parameters.keys()
              if not torch.equal(straight.parameters[k],
                                 rejoined.parameters[k])]
    if differ:
        problems.append(f"rejoined params differ from the straight run's "
                        f"in {differ[:3]}")
    if not died or held == 0:
        problems.append(f"the kill did not leave tasks held (died {died}, "
                        f"pending {held})")
    if progress["pending"] or progress["todo"]:
        problems.append(f"tasks left: {progress}")
    if sorted(acks) != list(range(ELASTIC_TASKS)) or \
            set(acks.values()) != {1}:
        problems.append(f"acks per task {acks}")
    if over_tcp != progress:
        problems.append(f"progress over TCP {over_tcp} != {progress}")
    layers = ELASTIC_MODEL["n_layers"]
    for name, n in launches.items():
        if n != layers * steps_run[0]:
            problems.append(f"{name} launched {n} times, expected "
                            f"{layers} x {steps_run[0]} steps")
    return {"model": ELASTIC_MODEL, "tasks": ELASTIC_TASKS,
            "batch": ELASTIC_BATCH, "seq": ELASTIC_SEQ, "disk": disk,
            "steps_run": steps_run[0], "pending_at_death": held,
            "progress": progress, "progress_over_tcp": over_tcp,
            "acks": acks, "kernel_launches": launches,
            "seconds": seconds, "problems": problems}
