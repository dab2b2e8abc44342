"""paddle_tpu_torch.obs — request-scoped tracing, unified metrics, and a
flight recorder (the port of ``paddle_tpu/obs``; pure Python, copied).

Three pieces, one timeline:

- :mod:`~paddle_tpu_torch.obs.trace` — the span :class:`Tracer` on the
  injected clock (``FLAGS.obs_trace`` gates it at construction; the
  :data:`NULL_TRACER` singleton makes the off state a true no-op) plus
  the bounded flight-recorder ring that auto-dumps a postmortem file
  when a conservation invariant (PAGE-LEAK / REF-LEAK / FLEET-LEAK)
  trips;
- :mod:`~paddle_tpu_torch.obs.registry` — counter/gauge/histogram
  :class:`MetricsRegistry` that ``ServingMetrics`` / ``FleetMetrics`` /
  ``platform.stats.StatSet`` publish into, with one ``snapshot()`` /
  ``to_text()`` scrape surface;
- :mod:`~paddle_tpu_torch.obs.export` — Chrome-trace/Perfetto JSON exporter
  (replicas -> processes, slots -> threads), byte-deterministic across
  seeded replays; ``python -m paddle_tpu_torch.obs export`` is the CLI.

:mod:`~paddle_tpu_torch.obs.bridge` connects the v2 trainer's event stream to
the same span format, so training and serving traces open in the same
Perfetto view.
"""

from paddle_tpu_torch.obs.bridge import (publish_resilience,
                                         trainer_event_bridge)
from paddle_tpu_torch.obs.export import (chrome_trace, dumps_chrome,
                                         load_events, save_chrome_trace,
                                         save_events)
from paddle_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                           MetricsRegistry, default_registry)
from paddle_tpu_torch.obs.trace import NULL_TRACER, Event, Tracer, tracer_for

__all__ = [
    "Event", "Tracer", "NULL_TRACER", "tracer_for",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "chrome_trace", "dumps_chrome", "save_chrome_trace", "save_events",
    "load_events", "trainer_event_bridge", "publish_resilience",
]
