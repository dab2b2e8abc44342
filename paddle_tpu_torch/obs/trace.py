"""Request-scoped span tracer + flight recorder (a copy of
``paddle_tpu/obs/trace.py``, which is pure Python; only the flags it
reads are the port's).

One seeded chaos replay used to leave its evidence scattered across
``ServingMetrics``, ``FleetMetrics.snapshot()``, ``healthz()`` and the
retrace auditor — none of which could answer "what happened to fleet
rid 17 between admission and its resubmit to replica 2".  The tracer
turns every lifecycle edge into a structured :class:`Event` on ONE
timeline:

- request edges: ``submit`` -> ``route`` -> ``admit`` ->
  ``prefill_chunk`` -> ``decode_tick`` -> ``preempt`` / ``resubmit`` ->
  ``terminal``, with a ``fleet_request`` async root span per fleet rid
  (begin at ``FleetRouter.submit``, end at its single terminal
  transition — the exactly-once invariant made visible);
- fleet control edges: replica join/ready/fence/reap/drain, lease
  register/renew-reject/expire/drop;
- pool edges: ``page_alloc`` / ``page_ref`` / ``page_free`` /
  ``page_evict``;
- speculation and host-tier edges: ``spec_accept`` /
  ``spec_rollback`` / ``spec_cow``, ``host_spill`` / ``host_swap_in`` /
  ``host_drop`` / ``HOSTTIER-CORRUPT``.

Design contracts (the same ones the rest of the repo pins):

- **injected clock only** — the tracer stamps events with the
  ``time_fn`` it was built on (a fleet/fault-plan ``ManualClock`` in
  tests, ``time.monotonic`` as the injectable default in production).
- **zero overhead when off** — ``tracer_for`` returns the
  :data:`NULL_TRACER` singleton unless ``FLAGS.obs_trace`` is on
  (checked at construction).  Every null method is a constant no-op
  returning a shared context manager; no event objects, no clock reads,
  no device work.
- **determinism** — events carry only deterministic payloads (ticks,
  slots, page ids, seeded reasons); process-global rid counters are
  normalized away at export time, so two replays of the same seeded
  ``FleetFaultPlan`` export byte-identical Chrome traces
  (``obs.export``).

The **flight recorder** is the tracer's bounded ring
(``FLAGS.obs_ring_size`` most recent events).  ``dump_postmortem``
writes the ring to ``FLAGS.obs_dump_dir`` and prints a grep-able
``OBS-POSTMORTEM: <path>`` line; the engine and fleet call it when a
tier-1 ladder invariant (PAGE-LEAK / REF-LEAK / FLEET-LEAK) trips, so a
leak report arrives WITH the event history that produced it.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from paddle_tpu_torch.platform.flags import FLAGS

__all__ = ["Event", "Tracer", "NULL_TRACER", "tracer_for"]

_POSTMORTEM_SEQ = itertools.count()


@dataclass
class Event:
    """One structured trace event.

    ``kind`` follows the Chrome trace phase alphabet the exporter maps
    to directly: ``"X"`` complete span (with ``dur``), ``"i"`` instant,
    ``"b"``/``"e"`` async span begin/end (paired by ``id`` within
    ``id_space``).  ``replica``/``slot`` become the exporter's
    process/thread lanes; everything else rides in ``args``."""

    kind: str
    name: str
    ts: float
    cat: str = "serving"
    dur: float = 0.0
    replica: Optional[int] = None
    slot: Optional[int] = None
    id: Optional[int] = None
    id_space: str = "rid"
    args: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {"kind": self.kind, "name": self.name,
                                "ts": self.ts, "cat": self.cat}
        if self.kind == "X":
            d["dur"] = self.dur
        if self.replica is not None:
            d["replica"] = self.replica
        if self.slot is not None:
            d["slot"] = self.slot
        if self.id is not None:
            d["id"] = self.id
            d["id_space"] = self.id_space
        if self.args:
            d["args"] = {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in sorted(self.args.items())}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Event":
        return cls(kind=d["kind"], name=d["name"], ts=float(d["ts"]),
                   cat=d.get("cat", "serving"), dur=float(d.get("dur", 0.0)),
                   replica=d.get("replica"), slot=d.get("slot"),
                   id=d.get("id"), id_space=d.get("id_space", "rid"),
                   args=dict(d.get("args", {})))


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_replica", "_slot", "_args",
                 "_start")

    def __init__(self, tracer, name, cat, replica, slot, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._replica = replica
        self._slot = slot
        self._args = args
        self._start = 0.0

    def __enter__(self):
        self._start = self._tracer._time()
        return self

    def __exit__(self, *exc):
        t = self._tracer
        end = t._time()
        t._record(Event(kind="X", name=self._name, ts=self._start,
                        cat=self._cat, dur=max(0.0, end - self._start),
                        replica=self._replica, slot=self._slot,
                        args=self._args))
        return False


class Tracer:
    """Span/event recorder on an injected clock (see module doc).

    ``keep_all=True`` (the default) retains the full event list for
    export; the bounded ring (the flight recorder) always holds the
    most recent ``ring_size`` events either way, so a long-running
    production tracer can run ``keep_all=False`` and still dump a
    postmortem."""

    enabled = True

    def __init__(self, time_fn: Optional[Callable[[], float]] = None,
                 ring_size: Optional[int] = None,
                 registry=None, keep_all: bool = True):
        self._time = time_fn or time.monotonic
        if ring_size is None:
            ring_size = int(FLAGS.obs_ring_size)
        self.ring_size = max(1, int(ring_size))
        self._keep_all = bool(keep_all)
        self.registry = registry
        self._lock = threading.Lock()
        # one tracer is shared by every replica's engine AND the master
        # handler threads (the fleet hands out scoped() views of the
        # same base), so the event stores only move under the lock
        # guarded_by(_lock)
        self.ring: Deque[Event] = deque(maxlen=self.ring_size)
        self.events: List[Event] = []                # guarded_by(_lock)
        self._open: Dict[Tuple, Tuple[float, Dict[str, object],
                                      Optional[int], Optional[int],
                                      str]] = {}    # guarded_by(_lock)
        # events past ring_size (keep_all=False)
        self.dropped = 0                             # guarded_by(_lock)
        self.last_postmortem: Optional[str] = None   # guarded_by(_lock)

    # ---- recording --------------------------------------------------------

    def _record(self, ev: Event) -> None:
        with self._lock:
            if self._keep_all:
                self.events.append(ev)
            if len(self.ring) == self.ring_size:
                # counts events displaced OUT of the ring in both modes,
                # so a postmortem's dropped_before_ring is honest even
                # when keep_all retains the full list elsewhere
                self.dropped += 1
            self.ring.append(ev)
        reg = self.registry
        if reg is not None and ev.kind == "X":
            reg.histogram("obs_span_seconds",
                          "duration of traced spans by name").labels(
                name=ev.name).observe(ev.dur)

    def span(self, name: str, cat: str = "serving",
             replica: Optional[int] = None, slot: Optional[int] = None,
             **args) -> _Span:
        """``with tracer.span("decode_tick", tick=7): ...`` — records one
        complete event whose duration is measured on the injected clock
        (zero-width under a ManualClock that advances per tick, real
        durations on a wall clock)."""
        return _Span(self, name, cat, replica, slot, args)

    def instant(self, name: str, cat: str = "serving",
                replica: Optional[int] = None, slot: Optional[int] = None,
                **args) -> None:
        self._record(Event(kind="i", name=name, ts=self._time(), cat=cat,
                           replica=replica, slot=slot, args=args))

    def begin(self, name: str, key=None, cat: str = "serving",
              replica: Optional[int] = None, slot: Optional[int] = None,
              **args) -> None:
        """Open an explicit span (the trainer event bridge's idiom, where
        begin and end happen in different callbacks).  ``key`` pairs it
        with the matching :meth:`end`; defaults to the name alone."""
        with self._lock:
            self._open[(name, key)] = (self._time(), dict(args),
                                       replica, slot, cat)

    def end(self, name: str, key=None, cat: Optional[str] = None,
            **args) -> None:
        """Close a :meth:`begin` span.  The category recorded is the one
        ``begin`` opened with unless ``cat`` overrides it here."""
        with self._lock:
            opened = self._open.pop((name, key), None)
        now = self._time()
        if opened is None:
            start, base, replica, slot, opened_cat = now, {}, None, None, \
                "serving"
        else:
            start, base, replica, slot, opened_cat = opened
        base.update(args)
        self._record(Event(kind="X", name=name, ts=start,
                           cat=cat if cat is not None else opened_cat,
                           dur=max(0.0, now - start), replica=replica,
                           slot=slot, args=base))

    def async_begin(self, name: str, id: int, id_space: str = "rid",
                    cat: str = "request", replica: Optional[int] = None,
                    **args) -> None:
        """Begin a root-level async span (e.g. one ``fleet_request`` per
        fleet rid) — paired with :meth:`async_end` by ``id`` at export."""
        self._record(Event(kind="b", name=name, ts=self._time(), cat=cat,
                           replica=replica, id=int(id), id_space=id_space,
                           args=args))

    def async_end(self, name: str, id: int, id_space: str = "rid",
                  cat: str = "request", replica: Optional[int] = None,
                  **args) -> None:
        self._record(Event(kind="e", name=name, ts=self._time(), cat=cat,
                           replica=replica, id=int(id), id_space=id_space,
                           args=args))

    # ---- views / scoping --------------------------------------------------

    def scoped(self, **labels) -> "_ScopedTracer":
        """A view of this tracer with ``replica=``/``slot=`` defaults
        bound (the fleet hands each engine ``scoped(replica=idx)``, so
        engine-side instrumentation needs no fleet awareness)."""
        return _ScopedTracer(self, labels)

    @property
    def base(self) -> "Tracer":
        return self

    # ---- persistence ------------------------------------------------------

    def save(self, path: str) -> str:
        """Write the full event list as JSONL (one event dict per line)
        — the raw format ``python -m paddle_tpu_torch.obs export`` consumes.
        One writer: delegates to :func:`obs.export.save_events` so the
        on-disk shape cannot diverge between the two entry points."""
        from paddle_tpu_torch.obs.export import save_events
        with self._lock:
            evs = list(self.events if self._keep_all else self.ring)
        return save_events(evs, path)

    def dump_postmortem(self, reason: str,
                        dump_dir: Optional[str] = None) -> str:
        """Flight-recorder dump: write the ring (the most recent
        ``ring_size`` events) plus the reason to a postmortem file under
        ``FLAGS.obs_dump_dir`` and print the grep-able
        ``OBS-POSTMORTEM: <path>`` line.
        Filenames use a process-global sequence, not the wall clock."""
        d = dump_dir or str(FLAGS.obs_dump_dir)
        os.makedirs(d, exist_ok=True)
        slug = "".join(c if c.isalnum() else "-" for c in reason.lower())
        path = os.path.join(
            d, f"postmortem-{slug[:40]}-{next(_POSTMORTEM_SEQ):04d}.json")
        with self._lock:
            payload = {"reason": reason, "ring_size": self.ring_size,
                       "dropped_before_ring": self.dropped,
                       "events": [ev.to_dict() for ev in self.ring]}
        with open(path, "w") as f:
            json.dump(payload, f, sort_keys=True, separators=(",", ":"))
        with self._lock:
            self.last_postmortem = path
        print(f"OBS-POSTMORTEM: {path}", flush=True)
        return path


class _ScopedTracer:
    """Label-binding proxy over a :class:`Tracer` (or another scope).
    Every call forwards to the base with the bound ``replica``/``slot``
    filled in unless the call site overrides them."""

    __slots__ = ("_base", "_labels")
    enabled = True

    def __init__(self, base: Tracer, labels: Dict[str, object]):
        self._base = base
        self._labels = {k: v for k, v in labels.items()
                        if k in ("replica", "slot")}

    @property
    def base(self) -> Tracer:
        return self._base

    @property
    def registry(self):
        return self._base.registry

    def span(self, name: str, **kw):
        merged = dict(self._labels)
        merged.update(kw)
        return self._base.span(name, **merged)

    def instant(self, name: str, **kw) -> None:
        merged = dict(self._labels)
        merged.update(kw)
        self._base.instant(name, **merged)

    def begin(self, name: str, **kw) -> None:
        merged = dict(self._labels)
        merged.update(kw)
        self._base.begin(name, **merged)

    def end(self, name: str, **kw) -> None:
        self._base.end(name, **kw)

    def async_begin(self, name: str, id: int, **kw) -> None:
        merged = dict(self._labels)
        merged.update(kw)
        self._base.async_begin(name, id, **merged)

    def async_end(self, name: str, id: int, **kw) -> None:
        merged = dict(self._labels)
        merged.update(kw)
        self._base.async_end(name, id, **merged)

    def scoped(self, **labels) -> "_ScopedTracer":
        merged = dict(self._labels)
        merged.update(labels)
        return _ScopedTracer(self._base, merged)

    def dump_postmortem(self, reason: str,
                        dump_dir: Optional[str] = None) -> str:
        return self._base.dump_postmortem(reason, dump_dir)

    def save(self, path: str) -> str:
        return self._base.save(path)


class _NullContext:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class _NullTracer:
    """The obs-off tracer: every method is a constant no-op.  One shared
    instance (:data:`NULL_TRACER`) serves the whole process, so a
    disabled engine pays one attribute call per instrumentation point —
    no events, no clock reads, no device work."""

    enabled = False
    registry = None
    ring: Deque = deque(maxlen=1)
    events: List = []
    last_postmortem = None

    @property
    def base(self) -> "_NullTracer":
        return self

    def span(self, name: str, **kw) -> _NullContext:
        return _NULL_CTX

    def instant(self, name: str, **kw) -> None:
        pass

    def begin(self, name: str, **kw) -> None:
        pass

    def end(self, name: str, **kw) -> None:
        pass

    def async_begin(self, name: str, id: int, **kw) -> None:
        pass

    def async_end(self, name: str, id: int, **kw) -> None:
        pass

    def scoped(self, **labels) -> "_NullTracer":
        return self

    def dump_postmortem(self, reason: str,
                        dump_dir: Optional[str] = None) -> None:
        return None

    def save(self, path: str) -> None:
        return None


NULL_TRACER = _NullTracer()


def tracer_for(time_fn: Optional[Callable[[], float]] = None,
               registry=None):
    """The construction-time gate (construction-time):
    a real :class:`Tracer` on ``time_fn`` when ``FLAGS.obs_trace`` is
    on, the shared :data:`NULL_TRACER` otherwise.  Engines and routers
    call this once at construction — flip the flag BEFORE building the
    engine being traced."""
    if not getattr(FLAGS, "obs_trace", False):
        return NULL_TRACER
    # keep_all=False (FLAGS.obs_keep_all off) bounds a long-running
    # service's tracing memory to the flight-recorder ring; the default
    # retains everything for whole-replay export
    return Tracer(time_fn=time_fn, registry=registry,
                  keep_all=bool(getattr(FLAGS, "obs_keep_all", True)))
