"""Trainer-event -> obs-span bridge: training and serving share one
timeline format (the port of ``paddle_tpu/obs/bridge.py`` over the
port's :mod:`paddle_tpu_torch.event`).

The v2 trainer already fires :mod:`paddle_tpu_torch.event` objects
(BeginPass / EndPass / BeginIteration / EndIteration / TestResult) at
every loop edge; this module turns an ordinary ``event_handler`` into
one that ALSO records those edges as obs spans, so a training run
exports through the same ``obs.export`` pipeline as a serving chaos
replay:

- each pass becomes an async ``train_pass`` span (``b``/``e`` paired by
  pass id);
- each iteration becomes a complete ``train_iteration`` span (begin at
  BeginIteration, closed at EndIteration);
- TestResult becomes a ``test_result`` instant.

Usage::

    tracer = Tracer(registry=obs.default_registry())
    trainer.train(reader, event_handler=trainer_event_bridge(tracer,
                                                             my_handler))

The bridge never reads the event's lazy ``.cost``/``.metrics``
properties — those force a device sync the trainer deliberately avoids
per batch — so wrapping a handler adds zero host syncs.
"""

from __future__ import annotations

from typing import Callable, Optional

from paddle_tpu_torch import event as v2_event

__all__ = ["trainer_event_bridge", "publish_resilience"]


def trainer_event_bridge(tracer, handler: Optional[Callable] = None,
                         registry=None) -> Callable:
    """Wrap ``handler`` (or nothing) so trainer events are mirrored as
    obs spans on ``tracer``.  ``registry`` additionally counts passes /
    iterations (defaults to the tracer's registry, if any)."""
    reg = registry if registry is not None else getattr(tracer, "registry",
                                                        None)

    def on_event(ev) -> None:
        if isinstance(ev, v2_event.BeginPass):
            tracer.async_begin("train_pass", id=ev.pass_id,
                               id_space="pass", cat="train",
                               pass_id=ev.pass_id)
        elif isinstance(ev, v2_event.EndPass):
            tracer.async_end("train_pass", id=ev.pass_id,
                             id_space="pass", cat="train",
                             pass_id=ev.pass_id)
            if reg is not None:
                reg.counter("train_passes_total",
                            "completed training passes").inc()
        elif isinstance(ev, v2_event.BeginIteration):
            tracer.begin("train_iteration", key=(ev.pass_id, ev.batch_id),
                         cat="train", pass_id=ev.pass_id,
                         batch=ev.batch_id)
        elif isinstance(ev, v2_event.EndIteration):
            tracer.end("train_iteration", key=(ev.pass_id, ev.batch_id),
                       cat="train")
            if reg is not None:
                reg.counter("train_iterations_total",
                            "completed training iterations").inc()
        elif isinstance(ev, v2_event.TestResult):
            tracer.instant("test_result", cat="train")
        if handler is not None:
            handler(ev)

    return on_event


def publish_resilience(registry, checkpointer=None, report=None) -> None:
    """Land the fault-tolerant-training numbers on a unified
    :class:`~paddle_tpu_torch.obs.registry.MetricsRegistry` — the same
    one-scrape-surface contract ``ServingMetrics.publish`` /
    ``StatSet.publish`` follow, so a supervised run's recovery history
    exports next to its serving twin.

    ``checkpointer`` (a ``resilience.AsyncCheckpointer``) contributes
    the async-save split — ``train_ckpt_stall_seconds_total`` (what the
    train loop actually waited: snapshot + pipeline waits) vs
    ``train_ckpt_write_seconds_total`` (background disk time) — plus
    save/commit counts; ``report`` (a ``resilience.RunReport``)
    contributes restart counts by kind and the completed flag.  The
    live per-event counters (``train_bad_steps_total``,
    ``train_rollbacks_total``, ``train_restarts_total``) are published
    by the trainer/supervisor as they happen; this call adds the
    end-of-run aggregates.

    It only reads the attributes named above: the port's
    :class:`~paddle_tpu_torch.resilience.AsyncCheckpointer` and
    :class:`~paddle_tpu_torch.resilience.RunReport` (as
    ``resilience.chaos.seeded_chaos`` passes them), or any objects
    carrying them."""
    # gauges, so the names deliberately avoid the Prometheus counter
    # `_total` suffix — rate()/increase() tooling keys on that spelling
    if checkpointer is not None:
        registry.gauge(
            "train_ckpt_saves",
            "checkpoint saves submitted by the async checkpointer"
        ).set(checkpointer.saves)
        registry.gauge(
            "train_ckpt_commits",
            "checkpoint writes fully committed (meta durable)"
        ).set(checkpointer.commits)
        registry.gauge(
            "train_ckpt_stall_seconds",
            "train-loop seconds spent waiting on checkpointing "
            "(device->host snapshot + pipeline waits)"
        ).set(checkpointer.stall_s)
        registry.gauge(
            "train_ckpt_write_seconds",
            "background seconds spent writing checkpoint blobs"
        ).set(checkpointer.write_s)
    if report is not None:
        g = registry.gauge(
            "train_supervised_restarts",
            "restarts observed by the resume supervisor, by kind")
        g.labels(kind="death").set(report.deaths)
        g.labels(kind="rollback").set(report.rollbacks)
        registry.gauge(
            "train_supervised_completed",
            "1 when the supervised training fn ran to completion"
        ).set(1.0 if report.completed else 0.0)
