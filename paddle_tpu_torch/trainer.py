"""SGD trainer with events (the port of ``paddle_tpu/trainer.py``: ``SGD``
with ``train``, ``test``, one ``step``, evaluators, prefetch and the
logging flags, and the alternating multi-task trainer
``MultiTaskTrainer`` with its ``TaskSpec``).

One step is the forward of the topology (the costs and every metric node
of ``extra_layers``/``metrics`` in one pass), ``torch.autograd.grad`` of
the summed costs, and the optimizer's in-place update.  The trainer holds
the model state (batch norm's moving statistics, ``model_state``) on its
device; a step threads it through ``forward_with_state(train=True)`` and
commits the new slots only after the update, so a step that raises leaves
the statistics as they were, as the JAX step's functional state does.
Its dropout masks come from the ``seed`` flag and the step count.

The JAX step is one jitted program that donates the old parameter and
slot buffers (trainer.py:448-451); the port runs eagerly and updates the
same tensors in place under ``torch.no_grad()``, which keeps one copy of
the weights as donation does.  A step returns its cost and each metric
(the mean over the batch's valid examples or tokens, detached, never part
of the cost) as 0-d device tensors and never waits for the card: events
convert on first access, and a pass's costs and metrics cross to the host
in one transfer a ``log_period`` window and one at the pass's end, where
``EndPass`` averages them in float64 as the JAX package's ``np.mean``
over floats does.  ``test`` returns the mean of its batches' costs and
metrics the same way.  With ``test_reader``, ``EndPass`` carries the
test's metrics, not the pass's, as in the JAX package.

Fault-tolerant training (the resilience slice): ``SGD(faults=, guard=)``
takes a seeded :class:`~paddle_tpu_torch.resilience.TrainFaultPlan` and a
:class:`~paddle_tpu_torch.resilience.BadStepGuard` (``guard=None`` falls
back to the ``train_bad_step_policy`` flag).  A guarded step adds the
plan's poison to the gradients, screens them with one global f32 sum of
squares and reads the verdict to the host once; a bad step runs no
update, so params, slots, the step counter and model state stay as they
were (see :mod:`paddle_tpu_torch.resilience.guard`).  ``train`` saves
checkpoints per pass (``save_dir``/``saving_period``, resumed by
``start_pass``) or every ``save_period_steps`` steps with a resume
cursor (``resume=True``; sync or ``async_save``, pruned to ``keep``), in
the JAX package's on-disk format (:mod:`paddle_tpu_torch.checkpoint`).
With ``master=`` it trains from an elastic task queue
(:mod:`paddle_tpu_torch.master`): one step a task, each task acked only
after a durable checkpoint covers it.

Not yet ported: meshes and data parallelism (``mesh``, ``zero``,
``zero_axis``, ``pipeline``, also the multi-task trainer's ``mesh``:
A12).  Passing one raises, naming its slice.  ``tracer`` puts the
guard and checkpoint edges on an obs timeline; each pass publishes the
timer table into the obs registry, and ``obs.trainer_event_bridge`` puts
passes and iterations on a trace timeline.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.obs.registry import default_registry
from paddle_tpu_torch.obs.trace import NULL_TRACER
from paddle_tpu_torch.platform import plog, stats
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import (enforce_that,
                                              refuse_unported)
from paddle_tpu_torch.resilience.guard import (guard_init, guard_outputs,
                                               screen_grads, select_good)
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.sequence import SequenceBatch
from paddle_tpu_torch.topology import LayerOutput, Topology


def _reduce_cost(value) -> torch.Tensor:
    """Summed cost over the batch's valid tokens (or examples) divided by
    the number of sequences (examples), as the reference divides the
    summed cost by the batch size — not a mean over tokens."""
    if isinstance(value, SequenceBatch):
        d = value.data.reshape(value.capacity, -1).sum(-1) \
            if value.data.dim() > 1 else value.data
        total = torch.where(value.valid_mask, d, torch.zeros_like(d)).sum()
        return total / max(value.num_seqs, 1)
    return value.mean()


def _metric_scalar(value) -> torch.Tensor:
    """Mean of a metric node's output over valid examples or tokens."""
    if isinstance(value, SequenceBatch):
        d = value.data.reshape(value.capacity, -1).sum(-1) \
            if value.data.dim() > 1 else value.data
        total = torch.where(value.valid_mask, d, torch.zeros_like(d)).sum()
        count = value.valid_mask.sum()
        return total / torch.clamp(count, min=1)
    return value.mean()


_A12 = "the parallel slice (A12)"


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """``t`` lives on ``dev`` (``cuda`` without an index means the
    current card)."""
    if t.device.type != dev.type:
        return False
    if dev.type == "cuda" and dev.index is None:
        return t.device.index == torch.cuda.current_device()
    return dev.type == "cpu" or t.device.index == dev.index


def _check_parameters(specs, parameters: Parameters,
                      device: torch.device) -> None:
    """Every parameter the topology declares is in ``parameters`` and on
    ``device``."""
    for name in specs:
        enforce_that(name in parameters,
                     f"no parameter {name!r} for the cost's topology",
                     context="trainer")
        enforce_that(_on_device(parameters[name], device),
                     f"parameter {name!r} is on {parameters[name].device}, "
                     f"the trainer on {device}", context="trainer")


def _host_floats(values: List[torch.Tensor]) -> List[float]:
    """0-d tensors as Python floats, in one transfer."""
    return torch.stack(values).cpu().tolist() if values else []


class SGD:
    """``SGD(cost, parameters, update_equation).train(reader, ...)``.

    Runs on ``device`` (``cuda`` unless asked), where ``parameters`` must
    already live.  ``cost`` is one cost node or a list of them (summed).
    ``metrics`` maps display names to metric nodes (see
    :mod:`paddle_tpu_torch.evaluator`); ``extra_layers`` adds nodes under
    their own names."""

    def __init__(self, cost, parameters: Parameters,
                 update_equation: Optimizer,
                 extra_layers: Optional[Sequence[LayerOutput]] = None,
                 is_local: bool = True, mesh=None,
                 metrics: Optional[Dict[str, LayerOutput]] = None,
                 zero_axis: Optional[str] = None, zero: Optional[int] = None,
                 pipeline=None, faults=None, guard=None, tracer=None,
                 device: DeviceLike = None):
        refuse_unported("SGD", "trainer", mesh=(mesh, None, _A12),
                        zero_axis=(zero_axis, None, _A12),
                        zero=(zero, None, _A12),
                        pipeline=(pipeline, None, _A12))
        self._tracer = tracer if tracer is not None else NULL_TRACER
        costs = [cost] if isinstance(cost, LayerOutput) else list(cost)
        self.metrics = dict(metrics or {})
        for n in (extra_layers or []):
            self.metrics.setdefault(n.name, n)
        self.device = resolve_device(device)
        self.topology = Topology(costs + list(self.metrics.values()))
        self._n_costs = len(costs)
        self.parameters = parameters
        specs = self.topology.param_specs()
        _check_parameters(specs, parameters, self.device)
        self._names = sorted(specs)
        self.optimizer = update_equation
        self.optimizer.set_param_specs(specs)
        self.opt_state = self.optimizer.init_state(
            {k: parameters[k] for k in self._names})
        self.model_state = self.topology.init_state(self.device)
        # captured at the first train(): the logging cadence and the
        # step's gradient statistics must agree
        self._stats_period: Optional[int] = None
        # fault-tolerant runtime (paddle_tpu_torch.resilience): a seeded
        # TrainFaultPlan drives injected deaths/NaNs/slow steps, the
        # BadStepGuard screens every step; guard=None falls back to
        # FLAGS.train_bad_step_policy ("off" by default: the unguarded
        # step, no read of a verdict)
        self._faults = faults
        if guard is None:
            policy = str(FLAGS.train_bad_step_policy or "off")
            if policy != "off":
                from paddle_tpu_torch.resilience.guard import BadStepGuard

                guard = BadStepGuard(
                    policy=policy,
                    max_norm=float(FLAGS.train_bad_step_max_norm),
                    rollback_after=int(FLAGS.train_bad_step_window))
        if faults is not None and faults.injects_grads():
            enforce_that(guard is not None,
                         "TrainFaultPlan injects non-finite gradients "
                         "but no bad-step guard is set — pass "
                         "SGD(guard=BadStepGuard()) (or set "
                         "FLAGS.train_bad_step_policy) so the poison "
                         "is screened instead of corrupting optimizer "
                         "slots", context="trainer")
        self._guard = guard
        self._global_step = 0
        self._bad_steps_seen = 0   # per-train()-call counter mark
        self.bad_steps_total = 0   # lifetime skipped-step count
        self.verdict_reads = 0     # guarded steps' host reads of `good`
        self._async_ckpt = None

    def _step(self, feeds: Dict[str, object], gstate=None):
        """(cost, {metric: value}) of one forward, backward and update,
        every value a 0-d device tensor; ``__param_stats__`` holds each
        gradient's mean and max |g| when the stats flag is on.  With a
        guard state (``gstate``, see :func:`resilience.guard.guard_init`)
        the gradients take its ``inject`` and are screened; a bad step
        runs no update and keeps the old model state."""
        params = {k: self.parameters[k].requires_grad_(True)
                  for k in self._names}
        step = self.opt_state["step"]
        outs, new_state = self.topology.forward_with_state(
            params, self.model_state, feeds, train=True,
            seed=(FLAGS.seed or 0) * 1_000_003 + step)
        total = _reduce_cost(outs[0])
        for o in outs[1:self._n_costs]:
            total = total + _reduce_cost(o)
        grads = torch.autograd.grad(total, [params[k] for k in self._names],
                                    allow_unused=True)
        grads = dict(zip(self._names, grads))
        if gstate is not None:
            grads, good_t, _ = screen_grads(grads, gstate["inject"],
                                            self._guard.max_norm)
        with torch.no_grad():
            metric_vals: Dict[str, Any] = {
                name: _metric_scalar(o) for name, o in
                zip(self.metrics, outs[self._n_costs:])}
            if self._stats_period:
                zero = torch.zeros((), device=self.device)
                metric_vals["__param_stats__"] = {
                    k: ((g.abs().mean(), g.abs().max()) if g is not None
                        else (zero, zero)) for k, g in grads.items()}
        good = True
        if gstate is not None:
            # the guarded step's one wait for the card
            good = bool(good_t)
            self.verdict_reads += 1
            gstate.update(guard_outputs(good, gstate))
        if good:
            self.optimizer.apply(params, grads, self.opt_state)
        self.model_state = select_good(good, new_state, self.model_state)
        return total.detach(), metric_vals

    def step(self, feeds: Dict[str, object]) -> torch.Tensor:
        """One forward, backward and update on converted ``feeds`` (under
        the guard when one is set: a bad step is skipped and counted in
        ``bad_steps_total``); returns the cost (0-d tensor on the
        device)."""
        gstate = guard_init() if self._guard is not None else None
        loss = self._step(feeds, gstate)[0]
        if gstate is not None:
            self.bad_steps_total += gstate["bad_total"]
        return loss

    def train(self, reader=None, num_passes: int = 1, event_handler=None,
              feeding=None, test_reader=None, save_dir: Optional[str] = None,
              start_pass: int = 0, saving_period: int = 1, master=None,
              record_parser=None, heartbeat_ttl_s: Optional[float] = None,
              prefetch: int = 0, save_period_steps: int = 0,
              resume: bool = False, async_save: Optional[bool] = None,
              keep: Optional[int] = None) -> None:
        """``num_passes`` passes over ``reader`` (a callable returning an
        iterator of sample batches), firing BeginPass, BeginIteration,
        EndIteration and EndPass on ``event_handler``; ``test_reader``
        runs :meth:`test` at each pass's end; ``prefetch > 0`` keeps that
        many batches fed and copied ahead on a producer thread
        (:func:`paddle_tpu_torch.reader.prefetch.device_prefetch`).

        ``save_dir``/``start_pass``/``saving_period`` are the reference
        trainer's --save_dir/--start_pass/--saving_period: checkpoints
        (params + optimizer state + model state) land in
        save_dir/pass-%05d every ``saving_period`` passes, and
        ``start_pass`` resumes from pass ``start_pass - 1``'s.
        ``num_passes`` is the TOTAL pass count.

        Fault-tolerant mode: with ``save_period_steps=N`` checkpoints are
        step-granular — every N steps (and at each pass end) a checkpoint
        carrying a ``cursor`` (pass id, step-in-pass, global step) is
        written under a monotonically increasing id; ``resume=True``
        restores the newest INTACT checkpoint (corrupt dirs are rejected
        with a CKPT-CORRUPT line and the next-older one wins) and
        fast-forwards the reader without converting the skipped batches,
        so a killed run re-joins mid-pass and ends equal to an
        uninterrupted one.  ``async_save=True`` (default
        ``FLAGS.train_ckpt_async``) writes on a background thread
        (:class:`~paddle_tpu_torch.resilience.AsyncCheckpointer`):
        training stalls only for the device->host snapshot, and ``train``
        returns only once the newest checkpoint is durable.  ``keep``
        bounds the checkpoint dir (verified-aware pruning; default
        ``FLAGS.train_ckpt_keep``).

        With ``master=MasterClient(...)`` training is elastic and
        task-driven instead (see :meth:`_train_elastic`): batches come
        from master tasks (``record_parser`` maps each record's bytes to
        a sample), the lease is heartbeat per batch with
        ``heartbeat_ttl_s``, and a lapsed lease re-registers and resumes
        from the latest checkpoint in ``save_dir``."""
        use_async = bool(FLAGS.train_ckpt_async) if async_save is None \
            else bool(async_save)
        keep = int(FLAGS.train_ckpt_keep) if keep is None else int(keep)
        if master is not None:
            enforce_that(record_parser is not None,
                         "master= training needs record_parser=",
                         context="trainer")
            enforce_that(start_pass == 0, "start_pass is reader-path only; "
                         "elastic training resumes from save_dir "
                         "automatically", context="trainer")
            enforce_that(save_period_steps == 0,
                         "save_period_steps is reader-path only; elastic "
                         "training checkpoints per saving_period tasks",
                         context="trainer")
            return self._train_elastic(master, record_parser, num_passes,
                                       event_handler, feeding, save_dir,
                                       heartbeat_ttl_s, saving_period,
                                       test_reader, use_async, keep)
        enforce_that(reader is not None, "train() needs a reader "
                     "(or master=)", context="trainer")
        enforce_that(not (resume and start_pass > 0),
                     "resume= (step-granular, cursor-driven) and "
                     "start_pass= (pass-granular) are exclusive",
                     context="trainer")
        # silently no-opping these would make a supervised run restart
        # from scratch on every death
        enforce_that(not (resume and save_dir is None),
                     "resume=True needs save_dir= (nothing to resume "
                     "from otherwise)", context="trainer")
        enforce_that(not (save_period_steps > 0 and save_dir is None),
                     "save_period_steps needs save_dir=",
                     context="trainer")
        handler = event_handler or _default_event_handler
        if self._stats_period is None:
            self._stats_period = int(FLAGS.show_parameter_stats_period or 0)
        period = self._stats_period
        log = plog.logger()
        feeder = self._make_feeder(feeding)

        from paddle_tpu_torch import checkpoint as ckpt

        if save_dir is not None and start_pass > 0:
            import os

            # resume from exactly pass start_pass-1 (newer checkpoints may
            # exist when re-branching; silently training from fresh init
            # would overwrite them with garbage)
            want = start_pass - 1
            enforce_that(os.path.isdir(ckpt.pass_dir(save_dir, want)),
                         f"start_pass={start_pass} but no checkpoint "
                         f"pass-{want:05d} under {save_dir}",
                         context="trainer")
            self.load_checkpoint(save_dir, want)

        resume_pass, resume_step = start_pass, 0
        if resume:
            loaded = ckpt.load_latest(save_dir, device="cpu")
            if loaded is not None:
                self.apply_checkpoint(loaded)
                meta = loaded[3]
                cur = meta.get("cursor") or {}
                # a cursor-less (per-pass) checkpoint resumes at the pass
                # AFTER the one it closed
                resume_pass = int(cur.get("pass_id",
                                          meta.get("pass_id", -1) + 1))
                resume_step = int(cur.get("step_in_pass", 0))
                log.info("resumed from checkpoint (pass %d, step-in-pass "
                         "%d, global step %d)", resume_pass, resume_step,
                         self._global_step)
                self._tracer.instant("train_resume", cat="train",
                                     pass_id=resume_pass,
                                     step=self._global_step)
        step_saves = save_dir is not None and save_period_steps > 0
        ck_next = 0
        if step_saves:
            # monotonic checkpoint counter above every existing dir
            lp = ckpt.latest_pass(save_dir)
            ck_next = (lp + 1) if lp is not None else 0
        # per-call checkpointer: a previous train() call's async writer
        # must neither leak into this call nor race it — settle and
        # rebuild from this call's arguments
        if self._async_ckpt is not None:
            self._drain_async_writer("superseded by a new train() call")
            self._async_ckpt = None
        if step_saves and use_async:
            from paddle_tpu_torch.resilience.checkpointer import \
                AsyncCheckpointer

            self._async_ckpt = AsyncCheckpointer(keep=keep)
        gstate = guard_init() if self._guard is not None else None
        self._bad_steps_seen = 0
        faults = self._faults

        def save_cursor(pass_id: int, step_in_pass: int) -> None:
            """One step-granular checkpoint (sync or async) carrying the
            resume cursor; checkpoint ids are a monotonic counter, not
            pass ids, so mid-pass saves never collide."""
            nonlocal ck_next
            self._save_with_cursor(save_dir, ck_next, pass_id,
                                   step_in_pass, keep)
            ck_next += 1

        try:
            for pass_id in range(resume_pass, num_passes):
                skip = resume_step if pass_id == resume_pass else 0
                raw_it = reader()
                if skip:
                    # fast-forward the data cursor: the resumed pass
                    # consumed `skip` batches before the checkpoint, so
                    # drop them unconverted
                    for _ in range(skip):
                        if next(raw_it, None) is None:
                            break
                    peek = next(raw_it, None)
                    if peek is None:
                        # the cursor sits exactly at the pass boundary
                        # (the pass-end save was torn): the pass already
                        # completed AND fired its events — repair the
                        # boundary cursor and move on without re-firing
                        # BeginPass/EndPass over an empty replay
                        if step_saves:
                            save_cursor(pass_id + 1, 0)
                        continue
                    raw_it = itertools.chain([peek], raw_it)
                handler(v2_event.BeginPass(pass_id))
                pass_costs: List[float] = []
                pass_metrics: Dict[str, List[float]] = {n: [] for n in
                                                         self.metrics}
                pending: List[torch.Tensor] = []
                pending_metrics: Dict[str, List[torch.Tensor]] = {
                    n: [] for n in self.metrics}

                def flush():
                    pass_costs.extend(_host_floats(pending))
                    pending.clear()
                    for k, buf in pending_metrics.items():
                        pass_metrics[k].extend(_host_floats(buf))
                        buf.clear()

                if prefetch > 0:
                    from paddle_tpu_torch.reader.prefetch import \
                        device_prefetch

                    host = self._make_feeder(feeding, torch.device("cpu"))
                    feed_it = device_prefetch(raw_it, size=prefetch,
                                              transform=host.feed,
                                              device=self.device)
                else:
                    feed_it = (feeder.feed(b) for b in raw_it)
                for batch_id, feeds in enumerate(feed_it, start=skip):
                    if faults is not None:
                        # injected clock tick + scheduled death, BEFORE
                        # the step runs (a killed step's work is lost and
                        # must replay from the last checkpoint)
                        faults.step_begin(self._global_step)
                    handler(v2_event.BeginIteration(pass_id, batch_id))
                    if gstate is not None:
                        gstate["inject"] = float(
                            faults.grad_inject(self._global_step)
                            if faults is not None else 0.0)
                    loss, metric_vals = self._step(feeds, gstate)
                    self._global_step += 1
                    pstats = metric_vals.pop("__param_stats__", None)
                    if pstats is not None and (batch_id + 1) % period == 0:
                        for k in sorted(pstats):
                            avg_abs, max_abs = pstats[k]
                            log.info("Param %s avgAbsGrad=%.6g "
                                     "maxAbsGrad=%.6g",
                                     k, float(avg_abs), float(max_abs))
                    pending.append(loss)
                    for k, v in metric_vals.items():
                        pending_metrics[k].append(v)
                    handler(v2_event.EndIteration(pass_id, batch_id, loss,
                                                  metric_vals))
                    if step_saves and (batch_id + 1) % save_period_steps == 0:
                        save_cursor(pass_id, batch_id + 1)
                    if gstate is not None:
                        self._guard_check(gstate)
                    if FLAGS.log_period and \
                            (batch_id + 1) % FLAGS.log_period == 0:
                        flush()
                        mtxt = " ".join(
                            f"{k}={np.mean(v[-FLAGS.log_period:]):.5f}"
                            for k, v in pass_metrics.items())
                        log.info("Pass %d, Batch %d, Cost %.5f %s", pass_id,
                                 batch_id,
                                 np.mean(pass_costs[-FLAGS.log_period:]),
                                 mtxt)
                flush()
                if test_reader is not None:
                    tr = self.test(test_reader, feeding)
                    handler(v2_event.EndPass(pass_id, tr.metrics,
                                             self.parameters))
                else:
                    handler(v2_event.EndPass(
                        pass_id, {k: float(np.mean(v)) if v else 0.0
                                  for k, v in pass_metrics.items()},
                        self.parameters))
                if gstate is not None:
                    # before the pass-end save: a save-kill must not
                    # swallow this pass's bad-step accounting
                    self._flush_guard_stats(gstate)
                if step_saves:
                    # pass boundary in cursor terms: next pass, step 0
                    save_cursor(pass_id + 1, 0)
                elif save_dir is not None \
                        and (pass_id + 1) % saving_period == 0:
                    self.save_checkpoint(save_dir, pass_id)
                # the per-batch timers land next to the serving metrics on
                # one scrape surface
                stats.timer_stats().publish(default_registry(),
                                            prefix="trainer_")
        except BaseException:
            # unwind (injected death, rollback, real error): let the
            # in-flight background write finish — deterministic, and a
            # half-written artifact would otherwise race the resume —
            # and loudly report (not raise) any recorded writer failure
            self._drain_async_writer("train loop unwinding")
            if gstate is not None:
                self._flush_guard_stats(gstate)
            raise
        if self._async_ckpt is not None:
            # durability barrier: train() returning means the newest
            # checkpoint is committed (writer errors surface here)
            self._async_ckpt.wait()

    # ------------------------------------------------------------------
    # bad-step guard + cursor-checkpoint plumbing
    # ------------------------------------------------------------------

    def _guard_check(self, gstate) -> None:
        """Rollback-policy hysteresis check every ``guard.cadence``
        steps (where the JAX package reads its device counter back).  A
        streak of ``rollback_after`` bad steps dumps the flight recorder
        and raises BadStepRollback — the supervisor restarts from the
        newest verified checkpoint."""
        g = self._guard
        if g is None or g.policy != "rollback" \
                or self._global_step % g.cadence:
            return
        consec = int(gstate["bad_consec"])
        if consec < g.rollback_after:
            return
        from paddle_tpu_torch.resilience.faults import BadStepRollback

        self._tracer.instant("bad_step_rollback", cat="train",
                             consec=consec, step=self._global_step)
        if getattr(self._tracer, "enabled", False):
            self._tracer.dump_postmortem("bad-step-rollback")
        default_registry().counter(
            "train_rollbacks_total",
            "bad-step guard rollbacks to the last good checkpoint").inc()
        raise BadStepRollback(
            f"{consec} consecutive bad steps (>= {g.rollback_after}) at "
            f"global step {self._global_step}: rolling back to the last "
            "verified checkpoint")

    def _flush_guard_stats(self, gstate) -> None:
        """Bad-step accounting once a pass, and when a train() call
        unwinds (the verdicts are host ints here, so a dead attempt's
        skipped steps are counted too; the JAX package reads its device
        counter once a pass and loses them): newly skipped steps land on
        the obs timeline and the unified registry, and
        ``self.bad_steps_total`` accumulates the lifetime count (the
        per-call counter restarts at 0 on every train() call; the
        watermark ``_bad_steps_seen`` is reset with it)."""
        total = int(gstate["bad_total"])
        new = total - self._bad_steps_seen
        if new > 0:
            self.bad_steps_total += new
            self._tracer.instant("bad_steps_skipped", cat="train",
                                 count=new, total=self.bad_steps_total,
                                 step=self._global_step)
            default_registry().counter(
                "train_bad_steps_total",
                "train steps skipped by the bad-step guard "
                "(non-finite or over-norm gradients)").inc(new)
        self._bad_steps_seen = total

    def _drain_async_writer(self, why: str) -> None:
        """Join the in-flight async write and LOUDLY report — never
        raise — a recorded writer failure.  Used wherever the
        checkpointer is being discarded or the loop is already
        unwinding: the failed artifact is uncommitted (resume falls
        back to the previous checkpoint), but the failure must not die
        silently with the object."""
        ck = self._async_ckpt
        if ck is None:
            return
        ck.drain()
        err = ck.take_error()
        if err is not None:
            plog.logger().warning(
                "async checkpoint writer failed (%s): %r — artifact "
                "left uncommitted; resume falls back to the previous "
                "checkpoint", why, err)
            self._tracer.instant("ckpt_write_failed", cat="train",
                                 why=why)

    def _save_ckpt(self, root: str, ck_id: int, extra_meta: Dict,
                   keep: int) -> None:
        """One checkpoint of the live state, sync or async
        (``self._async_ckpt``), under the fault plan's save hook."""
        from paddle_tpu_torch import checkpoint as ckpt

        hook = self._faults.save_hook(ck_id) \
            if self._faults is not None else None
        with self._tracer.span("checkpoint_save", cat="train", ck=ck_id,
                               step=self._global_step):
            if self._async_ckpt is not None:
                self._async_ckpt.save(
                    root, ck_id, self.parameters, opt_state=self.opt_state,
                    model_state=self.model_state, extra_meta=extra_meta,
                    commit_hook=hook)
            else:
                ckpt.save_checkpoint(
                    root, ck_id, self.parameters, opt_state=self.opt_state,
                    model_state=self.model_state, extra_meta=extra_meta,
                    commit_hook=hook)
                if keep > 0:
                    ckpt.prune_checkpoints(root, keep=keep)

    def _save_with_cursor(self, root: str, ck_id: int, pass_id: int,
                          step_in_pass: int, keep: int) -> None:
        """One step-granular checkpoint whose cursor records what a
        replacement trainer needs to continue the SAME run: pass id,
        step-in-pass (the data cursor) and global step (the fault
        plan's clock).  The dropout stream needs no key: it follows the
        optimizer's step count, which the state carries."""
        self._save_ckpt(root, ck_id, {"cursor": {
            "pass_id": int(pass_id), "step_in_pass": int(step_in_pass),
            "global_step": int(self._global_step)}}, keep)

    def _train_elastic(self, master, record_parser, num_passes: int,
                       event_handler, feeding, save_dir: Optional[str],
                       ttl_s: Optional[float], saving_period: int,
                       test_reader, use_async: bool = False,
                       keep: int = 2) -> None:
        """Task-driven elastic training.

        One SGD step per master task; the step counter (== applied task
        count along this trainer lineage) drives the fault plan and is
        persisted in checkpoint meta, so a replacement trainer resumes
        the SAME run — final params equal an uninterrupted run
        (single-lineage guarantee — with several concurrent trainers a
        requeued task may be re-run by a peer, the reference's async
        tolerance).

        Ack protocol: tasks are acked ONLY after a checkpoint covering
        them is durable (``saving_period`` = tasks per checkpoint; every
        task when save_dir is unset).  The checkpoint meta records the
        covered-but-possibly-unacked task ids with their epoch, plus the
        in-progress pass and the next step, so a crash in ANY window —
        before the step, or after the checkpoint but before the acks —
        resumes without losing or double-applying a task.  Old
        checkpoints are pruned, never below two.

        Async mode (``use_async``) PIPELINES the durability: flush N
        waits out write N-1, acks the tasks write N-1 covered, then
        submits write N and keeps training — "ack strictly after
        durable" holds with the disk write off the step path.
        """
        from paddle_tpu_torch import checkpoint as ckpt

        handler = event_handler or _default_event_handler
        feeder = self._make_feeder(feeding)
        log = plog.logger()
        saving_period = max(1, int(saving_period))
        faults = self._faults
        # per-call checkpointer (same contract as the reader path); the
        # async prune budget keeps the sync path's >= 2 insurance floor
        if self._async_ckpt is not None:
            self._drain_async_writer("superseded by a new train() call")
            self._async_ckpt = None
        if save_dir is not None and use_async:
            from paddle_tpu_torch.resilience.checkpointer import \
                AsyncCheckpointer

            # keep=0 stays "pruning disabled"; only a positive budget
            # gets the >= 2 floor
            self._async_ckpt = AsyncCheckpointer(
                keep=keep if keep == 0 else max(2, keep))

        def resume_state():
            """-> (next_step, skip_set, pass_id, next_ckpt_id)."""
            latest = ckpt.latest_pass(save_dir) if save_dir else None
            if latest is None:
                return 0, set(), 0, 0
            loaded = ckpt.load_checkpoint(save_dir, device="cpu")
            self.apply_checkpoint(loaded)
            meta = loaded[3]
            log.info("elastic: resumed from checkpoint %d (pass %d, "
                     "next step %d)", latest, meta.get("pass_id", 0),
                     meta.get("next_step", latest + 1))
            skip = {(tid, meta.get("epoch", 0))
                    for tid in meta.get("task_ids", [])}
            return (meta.get("next_step", latest + 1), skip,
                    meta.get("pass_id", 0), latest + 1)

        if getattr(master, "_slot", None) is None:
            master.register(ttl_s=ttl_s)
        step, skip_set, pass_id, ck_id = resume_state()
        self._global_step = step
        gstate = guard_init() if self._guard is not None else None
        self._bad_steps_seen = 0
        unacked: List[int] = []
        # async pipelining: tasks covered by the in-flight (submitted,
        # not yet provably durable) checkpoint — acked at the NEXT flush
        # once that write has committed
        covered: List[int] = []

        def settle_covered() -> None:
            """The durability-then-ack invariant, in ONE place: wait the
            in-flight write durable (writer errors raise HERE, on the
            training thread), then — and only then — ack the tasks that
            write covered."""
            self._async_ckpt.wait()
            for tid in covered:
                master.ack_task(tid)
            covered.clear()

        def flush(meta_pass: int, epoch: int, final: bool = False) -> None:
            """Checkpoint the current state, then ack everything a
            DURABLE checkpoint covers.  On the async path the write of
            flush N commits in the background while training continues;
            flush N+1 (or the ``final`` drain) waits it out and acks its
            tasks."""
            nonlocal ck_id
            if save_dir is None:
                for tid in unacked:
                    master.ack_task(tid)
                unacked.clear()
                return
            meta = {"next_step": step, "pass_id": meta_pass,
                    "epoch": epoch}
            if self._async_ckpt is not None:
                # the lease math: a task acks at the latest one full
                # flush window after its write submits, so the master's
                # timeout_s must cover saving_period steps + one write
                settle_covered()                 # previous write durable
                covered[:] = list(unacked)
                unacked.clear()
                meta["task_ids"] = list(covered)
                self._save_ckpt(save_dir, ck_id, meta, keep)
                ck_id += 1
                if final:
                    settle_covered()
                return
            meta["task_ids"] = list(unacked)
            self._save_ckpt(save_dir, ck_id, meta,
                            max(2, keep) if keep > 0 else 0)
            ck_id += 1
            for tid in unacked:
                master.ack_task(tid)
            unacked.clear()

        try:
            while pass_id < num_passes:
                master.begin_pass()
                handler(v2_event.BeginPass(pass_id))
                pending_costs: List[torch.Tensor] = []
                batch_id = 0
                epoch = 0
                rejoined = False
                resumed_acks = False
                while True:
                    if not master.heartbeat(ttl_s=ttl_s):
                        # declared dead (a long pause): durable state is
                        # required to rejoin
                        enforce_that(save_dir is not None,
                                     "elastic lease lost with no save_dir: "
                                     "cannot resume; pass save_dir= to "
                                     "train(master=...)", context="trainer")
                        log.info("elastic: lease lost, re-registering")
                        # settle the in-flight write before reloading; its
                        # outcome is superseded by the reload either way
                        self._drain_async_writer("lease lost, rejoining")
                        master.register(ttl_s=ttl_s)
                        unacked.clear()
                        covered.clear()
                        step, skip_set, pass_id, ck_id = resume_state()
                        self._global_step = step
                        rejoined = True
                        break
                    status, got = master.try_next_task()
                    if status == "done":
                        if resumed_acks and batch_id == 0:
                            # the only thing this pass did was ack stale
                            # tasks from the PREVIOUS pass (crash at a
                            # pass boundary): the queue just drained, so
                            # recycle it and actually train this pass
                            master.begin_pass()
                            resumed_acks = False
                            continue
                        break
                    if status == "empty":
                        # possibly blocked on our own unacked tasks: flush
                        if unacked:
                            flush(pass_id, epoch)
                        elif covered and self._async_ckpt is not None:
                            # the queue tail: only the in-flight write's
                            # tasks are outstanding — wait it durable and
                            # ack them, or the poll would spin forever
                            settle_covered()
                        else:
                            master.poll_wait()   # jittered backoff
                        continue
                    task_id, epoch, records = got
                    master.poll_reset()
                    if skip_set:
                        if (task_id, epoch) in skip_set:
                            # already applied inside the restored
                            # checkpoint (crash hit between write and
                            # ack): ack, skip
                            skip_set.discard((task_id, epoch))
                            log.info("elastic: task %d already in "
                                     "checkpoint, skipping", task_id)
                            master.ack_task(task_id)
                            resumed_acks = True
                            continue
                        # requeued tasks come back FIRST; a non-match
                        # means the remaining skip entries are stale
                        skip_set.clear()
                    if faults is not None:
                        # injected clock + scheduled death BEFORE the
                        # batch is parsed or BeginIteration fires; the
                        # task stays leased-but-unacked, so it requeues
                        # when the lease lapses
                        faults.step_begin(step)
                    batch = [record_parser(r) for r in records]
                    handler(v2_event.BeginIteration(pass_id, batch_id))
                    if gstate is not None:
                        gstate["inject"] = float(
                            faults.grad_inject(step)
                            if faults is not None else 0.0)
                    loss, metric_vals = self._step(feeder.feed(batch),
                                                   gstate)
                    metric_vals.pop("__param_stats__", None)
                    step += 1
                    self._global_step = step
                    unacked.append(task_id)
                    if len(unacked) >= saving_period:
                        flush(pass_id, epoch)
                    elif covered and self._async_ckpt is not None \
                            and self._async_ckpt.idle():
                        # early ack: the background write already
                        # committed, so its tasks need not stay leased
                        # until the next flush
                        settle_covered()
                    if gstate is not None:
                        self._guard_check(gstate)
                    batch_id += 1
                    pending_costs.append(loss)
                    handler(v2_event.EndIteration(pass_id, batch_id - 1,
                                                  loss, metric_vals))
                    if FLAGS.log_period and batch_id % FLAGS.log_period == 0:
                        window = pending_costs[-FLAGS.log_period:]
                        log.info("Elastic pass %d, Batch %d, Cost %.5f",
                                 pass_id, batch_id - 1,
                                 float(np.mean(_host_floats(window))))
                if rejoined:
                    continue  # restart the (possibly different) pass
                # pass complete: flush leftovers, mark the NEXT pass
                # durable so a crash right here doesn't re-run this pass
                # on resume (final=True drains the async pipeline)
                pass_id += 1
                flush(pass_id, epoch, final=True)
                if gstate is not None:
                    self._flush_guard_stats(gstate)
                stats.timer_stats().publish(default_registry(),
                                            prefix="trainer_")
                if test_reader is not None:
                    tr = self.test(test_reader, feeding)
                    handler(v2_event.EndPass(pass_id - 1, tr.metrics,
                                             self.parameters))
                else:
                    handler(v2_event.EndPass(pass_id - 1, {},
                                             self.parameters))
        except BaseException:
            # unwind (injected death, rollback, real error): let the
            # in-flight write finish — its meta either commits (resume
            # skips its tasks) or not (they replay) — loudly reporting
            # any recorded writer failure
            self._drain_async_writer("elastic loop unwinding")
            if gstate is not None:
                self._flush_guard_stats(gstate)
            raise

    def test(self, reader, feeding=None) -> v2_event.TestResult:
        """Costs and metrics of every batch of ``reader`` in inference
        mode (batch norm on its moving statistics, no dropout), averaged
        over the batches."""
        feeder = self._make_feeder(feeding)
        params = {k: self.parameters[k] for k in self._names}
        costs: List[torch.Tensor] = []
        metrics: Dict[str, List[torch.Tensor]] = {n: [] for n in
                                                   self.metrics}
        with torch.no_grad():
            for data_batch in reader():
                outs, _ = self.topology.forward_with_state(
                    params, self.model_state, feeder.feed(data_batch),
                    train=False)
                total = _reduce_cost(outs[0])
                for o in outs[1:self._n_costs]:
                    total = total + _reduce_cost(o)
                costs.append(total)
                for name, o in zip(self.metrics, outs[self._n_costs:]):
                    metrics[name].append(_metric_scalar(o))
        cost_vals = _host_floats(costs)
        result = {k: float(np.mean(v)) if v else 0.0
                  for k, v in ((k, _host_floats(b))
                               for k, b in metrics.items())}
        return v2_event.TestResult(
            float(np.mean(cost_vals)) if cost_vals else 0.0, result)

    def save_parameter_to_tar(self, f) -> None:
        self.parameters.to_tar(f)

    # ------------------------------------------------------------------
    # checkpoint/resume incl. optimizer state (paddle_tpu_torch.checkpoint)
    # ------------------------------------------------------------------

    def save_checkpoint(self, root: str, pass_id: int) -> str:
        from paddle_tpu_torch import checkpoint as ckpt

        return ckpt.save_checkpoint(root, pass_id, self.parameters,
                                    opt_state=self.opt_state,
                                    model_state=self.model_state)

    def load_checkpoint(self, root: str,
                        pass_id: Optional[int] = None) -> None:
        from paddle_tpu_torch import checkpoint as ckpt

        self.apply_checkpoint(ckpt.load_checkpoint(root, pass_id,
                                                   device="cpu"))

    def apply_checkpoint(self, loaded) -> None:
        """Apply an already-read ``checkpoint.load_checkpoint`` result
        (this package's or the JAX package's) to the live trainer.

        Every parameter and every optimizer-state tensor is copied INTO
        the tensor the trainer already holds (shapes must match: a
        checkpoint of another model or optimizer raises), ``"step"``
        becomes the port's host int, the model state is rebuilt on the
        trainer's device, and a step cursor in the meta sets the global
        step.  Split from :meth:`load_checkpoint` so callers can separate
        disk-read failures from apply failures."""
        from paddle_tpu_torch.convert import state_from_numpy

        params, opt_state, model_state, meta = loaded
        with torch.no_grad():
            for name, value in params.items():
                enforce_that(name in self.parameters,
                             f"checkpoint parameter {name!r} is not in "
                             "the trainer's parameters", context="trainer")
                _copy_into(self.parameters[name], value, name)
            if opt_state is not None:
                self.opt_state = _assign_state(self.opt_state, opt_state,
                                               ())
        if model_state is not None:
            self.model_state = state_from_numpy(model_state, self.device)
        cur = meta.get("cursor") or {}
        if "global_step" in cur:
            self._global_step = int(cur["global_step"])

    def _make_feeder(self, feeding, device: DeviceLike = None) -> DataFeeder:
        data_types = [(n.name, n.input_type)
                      for n in self.topology.data_nodes]
        return DataFeeder(data_types, feeding, device=device or self.device)


def _copy_into(dst: torch.Tensor, src, what: str) -> None:
    """``dst.copy_(src)`` (a tensor or a numpy array) with the shapes held
    equal: copy_ would broadcast."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.asarray(src))
    enforce_that(tuple(src.shape) == tuple(dst.shape),
                 f"checkpoint {what}: shape {tuple(src.shape)} != "
                 f"{tuple(dst.shape)}", context="trainer")
    dst.copy_(src)


def _assign_state(live, loaded, path):
    """The optimizer state ``live`` with the checkpoint's numpy tree
    ``loaded`` written into its tensors in place (same keys required);
    ``"step"`` becomes a host int."""
    what = "/".join(map(str, ("opt_state",) + path))
    if path == ("step",):
        return int(np.asarray(loaded))
    if isinstance(live, dict):
        enforce_that(isinstance(loaded, dict) and
                     set(loaded) == set(live),
                     f"checkpoint {what}: keys "
                     f"{sorted(loaded) if isinstance(loaded, dict) else loaded!r}"
                     f" != the optimizer's {sorted(live)}",
                     context="trainer")
        return {k: _assign_state(v, loaded[k], path + (k,))
                for k, v in live.items()}
    enforce_that(isinstance(live, torch.Tensor),
                 f"checkpoint {what}: unexpected state leaf {live!r}",
                 context="trainer")
    _copy_into(live, loaded, what)
    return live


def _default_event_handler(ev) -> None:
    pass


# ---------------------------------------------------------------------------
# Multi-task / alternating training (the GAN capability)
# ---------------------------------------------------------------------------


class TaskSpec:
    """One optimization task: a cost node, its optimizer, and which
    parameters it updates: ``trainable`` is a name prefix, a collection of
    names, a predicate on a name, or None (every parameter)."""

    def __init__(self, name: str, cost, update_equation: Optimizer,
                 trainable=None):
        self.name = name
        self.cost = cost
        self.optimizer = update_equation
        if trainable is None:
            self.trainable = lambda pname: True
        elif isinstance(trainable, str):
            prefix = trainable
            self.trainable = lambda pname: pname.startswith(prefix)
        elif isinstance(trainable, (list, tuple, set, frozenset)):
            names = set(trainable)
            self.trainable = lambda pname: pname in names
        else:
            self.trainable = trainable


class MultiTaskTrainer:
    """Alternating training of several cost graphs over ONE shared
    ``Parameters`` (the GAN loop: generator and discriminator trained in
    turn against shared weights).

    Each task has its own topology, and its own optimizer state over its
    trainable subset of the store (every stored name the task's
    ``trainable`` accepts), with its own step count (Adam's bias
    correction reads it).  A step differentiates the task's cost with
    ``torch.autograd.grad`` over the trainable tensors only; the other
    parameters enter the graph detached, are read and never updated.
    Every step draws a fresh seed; model-state slots a step updates are
    copied into the other tasks' state maps by node name.  Runs on
    ``device`` (``cuda`` unless asked), where ``parameters`` live::

        t = MultiTaskTrainer([
            TaskSpec("d", d_cost, Adam(learning_rate=2e-4), trainable="dis_"),
            TaskSpec("g", g_cost, Adam(learning_rate=2e-4), trainable="gen_"),
        ], parameters)
        d_loss = t.step("d", {"pixel": real, "noise": z, ...})
    """

    def __init__(self, tasks: Sequence[TaskSpec], parameters: Parameters,
                 device: DeviceLike = None):
        enforce_that(len(tasks) > 0, "need at least one task",
                     context="MultiTaskTrainer")
        self.device = resolve_device(device)
        self.tasks = {t.name: t for t in tasks}
        self.parameters = parameters
        self._topos: Dict[str, Topology] = {}
        self._trainable: Dict[str, list] = {}
        self._opt_states: Dict[str, Any] = {}
        self._model_states: Dict[str, Any] = {}
        self._counts: Dict[str, int] = {}
        self._steps = 0          # across tasks: each step's fresh seed
        for t in tasks:
            topo = Topology([t.cost])
            specs = topo.param_specs()
            _check_parameters(specs, parameters, self.device)
            self._topos[t.name] = topo
            t.optimizer.set_param_specs(specs)
            names = sorted(k for k in parameters.keys() if t.trainable(k))
            enforce_that(len(names) > 0,
                         f"task {t.name!r} trains no parameters",
                         context="MultiTaskTrainer")
            self._trainable[t.name] = names
            self._opt_states[t.name] = t.optimizer.init_state(
                {k: parameters[k] for k in names})
            self._model_states[t.name] = topo.init_state(self.device)
            self._counts[t.name] = 0

    def step(self, name: str, feeds: Dict[str, object]) -> float:
        """One optimization step of the named task; returns its cost.
        ``feeds`` maps data layer names to tensors or numpy arrays (moved
        to the trainer's device).  The other tasks' parameters flow
        through the graph but are not updated."""
        enforce_that(name in self.tasks, f"unknown task {name!r}",
                     context="MultiTaskTrainer")
        feeds = {k: torch.as_tensor(v, device=self.device)
                 if isinstance(v, np.ndarray) else v
                 for k, v in feeds.items()}
        task = self.tasks[name]
        topo = self._topos[name]
        names = self._trainable[name]
        train_set = set(names)
        params = {k: (self.parameters[k].requires_grad_(True)
                      if k in train_set else self.parameters[k].detach())
                  for k in topo.param_specs()}
        seed = (FLAGS.seed or 0) * 1_000_003 + self._steps
        outs, new_state = topo.forward_with_state(
            params, self._model_states[name], feeds, train=True, seed=seed)
        total = _reduce_cost(outs[0])
        wrt = [k for k in names if k in params]
        grads = dict(zip(wrt, torch.autograd.grad(
            total, [params[k] for k in wrt], allow_unused=True)))
        task.optimizer.apply({k: self.parameters[k] for k in names}, grads,
                             self._opt_states[name])
        self._model_states[name] = new_state
        # stateful slots shared across task graphs by node name
        for other, st in self._model_states.items():
            if other != name:
                for node_name, slots in new_state.items():
                    if node_name in st:
                        st[node_name] = slots
        self._counts[name] += 1
        self._steps += 1
        return float(total.detach())

    def steps_run(self, name: str) -> int:
        return self._counts[name]
