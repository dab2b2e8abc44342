"""Chrome-trace / Perfetto JSON exporter for obs events (a copy of
``paddle_tpu/obs/export.py``, which is pure Python).

Maps the tracer's :class:`~paddle_tpu_torch.obs.trace.Event` stream to the
Chrome Trace Event Format (the JSON flavour ``ui.perfetto.dev`` and
``chrome://tracing`` both load):

- **replicas -> processes**: every event's ``replica`` becomes its
  ``pid`` (``0`` for engine-less / single-engine events), with
  ``process_name`` metadata ``"replica N"``;
- **slots -> threads**: ``slot`` becomes ``tid + 1`` with
  ``thread_name`` ``"slot N"``; slot-less control events (submit,
  route, lease transitions) run on the reserved ``tid 0`` control
  lane;
- span events (``X``) keep their injected-clock timestamps and
  durations (microseconds), instants map to ``ph: "i"``, and the
  fleet's per-rid root spans map to async ``b``/``e`` pairs so
  Perfetto draws one bar per fleet request spanning admission to its
  terminal transition, resubmits and all.

**Determinism**: ``dumps_chrome`` emits byte-identical JSON for two
replays of the same seeded ``FleetFaultPlan`` trace.  The only
replay-varying values a trace contains are the process-global rid
counters (engine rids and fleet rids keep counting across replays), so
export renormalizes them: each distinct rid is renamed to its dense
first-appearance index, separately per id space (``rid`` for engine
rids — ``erid`` args share the map — and ``frid`` for fleet rids).
Event order, injected-clock timestamps, slots, page ids and seeded
fault reasons are deterministic already; JSON is dumped with sorted
keys and fixed separators.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from paddle_tpu_torch.obs.trace import Event

__all__ = ["chrome_trace", "dumps_chrome", "save_chrome_trace",
           "load_events", "save_events"]

# args keys that carry replay-varying rid counters, and the id space
# whose normalization map they share
_NORMALIZED_ARGS = {"rid": "rid", "erid": "rid", "frid": "frid"}


def _ts_us(ts: float) -> int:
    return int(round(ts * 1e6))


def chrome_trace(events: Sequence[Event],
                 normalize_ids: bool = True) -> Dict[str, object]:
    """Build the Chrome trace dict (``{"traceEvents": [...]}``).  With
    ``normalize_ids`` (the default) rid-valued ids and args are renamed
    to dense per-space indices in first-appearance order, which is what
    makes two seeded replays export identically."""
    maps: Dict[str, Dict[int, int]] = {}

    def norm(space: str, v):
        if not normalize_ids or not isinstance(v, int):
            return v
        m = maps.setdefault(space, {})
        if v not in m:
            m[v] = len(m)
        return m[v]

    pids = set()
    tids = set()          # (pid, tid)
    out: List[Dict[str, object]] = []
    for ev in events:
        pid = int(ev.replica) if ev.replica is not None else 0
        tid = int(ev.slot) + 1 if ev.slot is not None else 0
        pids.add(pid)
        tids.add((pid, tid))
        args = {}
        for k in sorted(ev.args):
            v = ev.args[k]
            if k in _NORMALIZED_ARGS:
                v = norm(_NORMALIZED_ARGS[k], v)
            args[k] = list(v) if isinstance(v, tuple) else v
        rec: Dict[str, object] = {"name": ev.name, "cat": ev.cat,
                                  "ts": _ts_us(ev.ts), "pid": pid,
                                  "tid": tid}
        if args:
            rec["args"] = args
        if ev.kind == "X":
            rec["ph"] = "X"
            rec["dur"] = max(0, _ts_us(ev.ts + ev.dur) - _ts_us(ev.ts))
        elif ev.kind == "i":
            rec["ph"] = "i"
            rec["s"] = "t"
        elif ev.kind in ("b", "e"):
            rec["ph"] = ev.kind
            rec["id"] = norm(ev.id_space, ev.id)
        else:
            continue
        out.append(rec)
    meta: List[Dict[str, object]] = []
    for pid in sorted(pids):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "args": {"name": f"replica {pid}"}})
    for pid, tid in sorted(tids):
        name = "control" if tid == 0 else f"slot {tid - 1}"
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def dumps_chrome(events: Sequence[Event],
                 normalize_ids: bool = True) -> str:
    """Deterministic serialization of :func:`chrome_trace` (sorted keys,
    fixed separators) — the byte-for-byte replay contract."""
    return json.dumps(chrome_trace(events, normalize_ids=normalize_ids),
                      sort_keys=True, separators=(",", ":"))


def save_chrome_trace(events: Sequence[Event], path: str,
                      normalize_ids: bool = True) -> str:
    with open(path, "w") as f:
        f.write(dumps_chrome(events, normalize_ids=normalize_ids))
    return path


def save_events(events: Sequence[Event], path: str) -> str:
    """Raw JSONL event dump (``Tracer.save`` shape)."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev.to_dict(), sort_keys=True,
                               separators=(",", ":")) + "\n")
    return path


def load_events(path: str) -> List[Event]:
    """Read raw events back: JSONL (``Tracer.save``) or a postmortem
    dump (``{"reason": ..., "events": [...]}``)."""
    with open(path) as f:
        text = f.read()
    try:
        payload = json.loads(text)
    except json.JSONDecodeError:
        payload = None
    if isinstance(payload, dict) and "events" in payload:
        return [Event.from_dict(d) for d in payload["events"]]
    if isinstance(payload, dict):       # a single-event JSONL file
        return [Event.from_dict(payload)]
    out: List[Event] = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            out.append(Event.from_dict(json.loads(line)))
    return out
