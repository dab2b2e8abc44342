"""Named timers (the port of ``paddle_tpu/platform/stats.py``; reference:
paddle/utils/Stat.h's REGISTER_TIMER and StatSet): a context-manager
timer adding into a global table, a text report, publication into a
metrics registry, and a profiler trace window.

The card runs work asynchronously: a bare timer around a step measures
its launches.  ``timer(..., block=<tensor(s) or a callable giving
them>)`` waits for the card holding them before the clock stops."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class StatEntry:
    total: float = 0.0
    count: int = 0
    max: float = 0.0
    min: float = float("inf")

    def add(self, seconds: float) -> None:
        self.total += seconds
        self.count += 1
        self.max = max(self.max, seconds)
        self.min = min(self.min, seconds)

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


def _wait_for(value) -> None:
    """Wait for the card of every CUDA tensor in ``value`` (a tensor, or
    a list, tuple or dict of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            # the deliberate end-of-window sync of timer(block=...)
            torch.cuda.synchronize(value.device)  # lint: allow(host-sync)
    elif isinstance(value, dict):
        for v in value.values():
            _wait_for(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _wait_for(v)


class StatSet:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, StatEntry] = {}   # guarded_by(_lock)

    @contextlib.contextmanager
    def timer(self, name: str, block=None):
        """Time a window into entry ``name``; with ``block`` (tensors, or a
        callable returning them once the body has run) wait for their
        card first.  A body that raises is timed without the wait."""
        start = time.perf_counter()
        ok = False
        try:
            yield
            ok = True
        finally:
            if ok and block is not None:
                _wait_for(block() if callable(block) else block)
            elapsed = time.perf_counter() - start
            with self._lock:
                self._entries.setdefault(name, StatEntry()).add(elapsed)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._entries.setdefault(name, StatEntry()).add(seconds)

    def get(self, name: str) -> Optional[StatEntry]:
        """A copy of one entry, taken under the lock."""
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                return None
            return StatEntry(total=e.total, count=e.count, max=e.max,
                             min=e.min)

    def snapshot(self) -> Dict[str, StatEntry]:
        """Copies of every entry, taken under the lock."""
        with self._lock:
            return {name: StatEntry(total=e.total, count=e.count,
                                    max=e.max, min=e.min)
                    for name, e in self._entries.items()}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()

    def publish(self, registry, prefix: str = "stat_", **labels) -> None:
        """Each timer as ``<prefix>seconds_total``, ``<prefix>calls`` and
        ``<prefix>seconds_max`` gauges labeled ``name=<timer>`` in a
        registry with ``gauge(name).labels(**labels).set(value)``."""
        for name, e in sorted(self.snapshot().items()):
            lbl = dict(labels, name=name)
            registry.gauge(prefix + "seconds_total").labels(**lbl).set(
                e.total)
            registry.gauge(prefix + "calls").labels(**lbl).set(e.count)
            registry.gauge(prefix + "seconds_max").labels(**lbl).set(e.max)

    def report(self) -> str:
        """The table the reference's StatSet prints."""
        lines = ["======= StatSet ======="]
        lines.append(f"{'name':<40} {'calls':>8} {'total(ms)':>12} "
                     f"{'avg(ms)':>10} {'max(ms)':>10}")
        for name, e in sorted(self.snapshot().items()):
            lines.append(
                f"{name:<40} {e.count:>8} {e.total * 1e3:>12.3f} "
                f"{e.avg * 1e3:>10.3f} {e.max * 1e3:>10.3f}")
        return "\n".join(lines)


_GLOBAL = StatSet()


def timer(name: str, block=None):
    """``with timer('forwardBackward'): ...`` into the global set."""
    return _GLOBAL.timer(name, block=block)


def add_sample(name: str, seconds: float) -> None:
    _GLOBAL.add(name, seconds)


def timer_stats() -> StatSet:
    return _GLOBAL


def reset_stats() -> None:
    _GLOBAL.reset()


@contextlib.contextmanager
def profiler_window(logdir: str):
    """A ``torch.profiler`` window (host and card) written to
    ``logdir/trace.json`` as a Chrome trace when it closes."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
