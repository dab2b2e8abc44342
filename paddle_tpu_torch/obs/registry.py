"""Unified metrics registry: counter / gauge / histogram with labeled
series, one ``snapshot()`` / ``to_text()`` surface (a copy of
``paddle_tpu/obs/registry.py``, which is pure Python).

Before this module every layer kept its own counters —
``ServingMetrics`` (per engine), ``FleetMetrics`` (per router),
``platform/stats.StatSet`` (the trainer's timer table), the engine's
``healthz()`` — each with a private dict shape, so a scraper (or
``bench.py``) had to know every layer's spelling.  Now each of those
*publishes into* one :class:`MetricsRegistry` (``ServingMetrics.publish``
/ ``FleetMetrics.publish`` / ``StatSet.publish``) and everything reads
one surface:

- ``snapshot()`` — flat JSON-able dict ``{"name{k=v,...}": value}``
  (histograms contribute ``_count`` / ``_sum`` / ``_max`` series), the
  shape ``bench.py`` workers and ``healthz()`` consume;
- ``to_text()`` — Prometheus-style exposition for an external scraper.

Series are keyed by sorted label tuples, so two publishers using the
same labels in different order land on the same series.  All operations
are plain host dict math — safe on the serving tick hot path — and the
registry never reads the clock: time enters only through observed
values, so the repo's injectable-clock contract is preserved.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _label_str_quoted(key: LabelKey) -> str:
    """Exposition-format spelling: label VALUES are double-quoted
    (``replica="0"``) — a real Prometheus scraper rejects the whole
    scrape otherwise.  ``snapshot()`` keys keep the unquoted spelling
    (the compact bench/healthz dict contract)."""
    return ",".join(f'{k}="{v}"' for k, v in key)


class _Metric:
    """Shared series bookkeeping.  ``labels(**kv)`` returns the series
    for that label set (created on first use); calling the value methods
    directly on the metric addresses the label-less series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        # one lock per metric, SHARED with every series it creates: a
        # scrape (snapshot/to_text) and a writer thread (checkpoint
        # writer bumping a counter, a master handler observing a
        # latency) race on the same series fields, and `value += n` /
        # the histogram's count-then-sum-then-bucket walk are not
        # atomic — the CONC-AUDIT fix that replaced the old unlocked
        # series (lost increments, torn count/sum pairs under scrape).
        self._series: Dict[LabelKey, object] = {}   # guarded_by(_lock)

    def _new_series(self):
        raise NotImplementedError

    def labels(self, **kv):
        key = _label_key(kv)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._new_series()
            return s

    def series(self) -> List[Tuple[LabelKey, object]]:
        with self._lock:
            return sorted(self._series.items())


class _CounterSeries:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock                 # the owning metric's lock
        self.value = 0.0                  # guarded_by(_lock)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Counter(_Metric):
    """Monotonic counter."""

    kind = "counter"

    def _new_series(self):
        return _CounterSeries(self._lock)

    def inc(self, n: float = 1.0) -> None:
        self.labels().inc(n)

    @property
    def value(self) -> float:
        s = self.labels()
        with s._lock:
            return s.value


class _GaugeSeries:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock                 # the owning metric's lock
        self.value = 0.0                  # guarded_by(_lock)

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge(_Metric):
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def _new_series(self):
        return _GaugeSeries(self._lock)

    def set(self, v: float) -> None:
        self.labels().set(v)

    @property
    def value(self) -> float:
        s = self.labels()
        with s._lock:
            return s.value


class _HistogramSeries:
    __slots__ = ("_lock", "buckets", "counts", "count", "sum", "max")

    def __init__(self, buckets: Sequence[float], lock: threading.Lock):
        self._lock = lock                 # the owning metric's lock
        self.buckets = tuple(buckets)     # immutable after init
        self.counts = [0] * (len(self.buckets) + 1)  # guarded_by(_lock)
        self.count = 0                    # guarded_by(_lock)
        self.sum = 0.0                    # guarded_by(_lock)
        self.max = 0.0                    # guarded_by(_lock)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)
            for i, edge in enumerate(self.buckets):
                if v <= edge:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0


class Histogram(_Metric):
    """Fixed-bucket histogram (count / sum / max / per-bucket counts)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(buckets)

    def _new_series(self):
        return _HistogramSeries(self.buckets, self._lock)

    def observe(self, v: float) -> None:
        self.labels().observe(v)


class MetricsRegistry:
    """Name -> metric table with get-or-create accessors.  A name keeps
    the kind it was first created with; asking for it as a different
    kind is a programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}   # guarded_by(_lock)

    def _get(self, name: str, cls, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ---- the one scrape surface ------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{"name{labels}": value}`` dict (deterministic order:
        names, then label keys).  Histograms flatten to ``_count`` /
        ``_sum`` / ``_max`` entries, so the whole snapshot is one level
        of JSON-able floats — the ``bench.py`` one-line contract."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            for key, s in m.series():
                tag = f"{m.name}{{{_label_str(key)}}}" if key else m.name
                if m.kind == "histogram":
                    with s._lock:     # count/sum/max read as one unit
                        out[tag + "_count"] = s.count
                        out[tag + "_sum"] = s.sum
                        out[tag + "_max"] = s.max
                else:
                    with s._lock:
                        out[tag] = s.value
        return out

    def to_text(self) -> str:
        """Prometheus-style text exposition (# HELP / # TYPE then one
        line per series), deterministically ordered."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, s in m.series():
                lbl = "{" + _label_str_quoted(key) + "}" if key else ""
                extra = "," + _label_str_quoted(key) if key else ""
                if m.kind == "histogram":
                    with s._lock:     # one consistent bucket/count/sum view
                        counts = list(s.counts)
                        count, total = s.count, s.sum
                    acc = 0
                    for edge, c in zip(s.buckets, counts):
                        acc += c
                        lines.append(f'{m.name}_bucket{{le="{edge}"'
                                     f"{extra}}} {acc}")
                    lines.append(f'{m.name}_bucket{{le="+Inf"'
                                 f"{extra}}} {count}")
                    lines.append(f"{m.name}_count{lbl} {count}")
                    lines.append(f"{m.name}_sum{lbl} {total}")
                else:
                    with s._lock:
                        lines.append(f"{m.name}{lbl} {s.value}")
        return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry: layers with no owning engine/router
    (the trainer's StatSet publish, ad-hoc tooling) publish here."""
    return _DEFAULT
