"""Device-prefetching input pipeline (the port of
``paddle_tpu/reader/prefetch.py``: ``device_put_feeds`` and
``device_prefetch``).

A producer thread drains the batch iterator, runs the host-side
``transform`` (a ``DataFeeder`` on the host) and copies each batch to the
device, keeping ``size`` batches ahead of the consumer; its first error is
handed to the consumer, which raises it after the batches before it; a
consumer that stops early (break, exception, close) stops the producer and
drops its queued batches.

On a card the producer works under a side stream: the feeder's host
tensors are pinned and copied with ``non_blocking=True`` on that stream,
and an event recorded after each batch's copies goes with it.  The
consumer makes its current stream wait on that event and calls
``record_stream`` on every tensor of the batch (``SequenceBatch`` fields
included), so the caching allocator does not hand the memory back to the
side stream while the step still reads it.  The port's ``DataFeeder``
builds every tensor on the host from numpy and never reads a value back
from the card, so the copies are the only device work the producer does.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Optional

import torch

from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.sequence import SequenceBatch


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_put_feeds(feeds, device: DeviceLike = None):
    """Copy one feed dict's host tensors (and ``SequenceBatch`` fields) to
    ``device`` (``cuda`` unless asked): pinned and ``non_blocking`` on a
    card, so the copies run on the current stream without stopping the
    host."""
    dev = resolve_device(device)
    out = {}
    for k, v in feeds.items():
        if isinstance(v, SequenceBatch):
            out[k] = dataclasses.replace(
                v, data=_to_device(v.data, dev),
                segment_ids=_to_device(v.segment_ids, dev),
                lengths=_to_device(v.lengths, dev),
                sub_segment_ids=None if v.sub_segment_ids is None
                else _to_device(v.sub_segment_ids, dev))
        elif isinstance(v, torch.Tensor):
            out[k] = _to_device(v, dev)
        else:
            out[k] = v
    return out


def _tensors(feeds):
    for v in feeds.values():
        if isinstance(v, SequenceBatch):
            yield from (t for t in (v.data, v.segment_ids, v.lengths,
                                    v.sub_segment_ids) if t is not None)
        elif isinstance(v, torch.Tensor):
            yield v


class _ErrorBox:
    """Producer-to-consumer exception hand-off: the producer stores at
    most one exception (the first); the consumer takes it after the end
    sentinel."""

    def __init__(self):
        self._lock = threading.Lock()
        self._err: Optional[BaseException] = None   # guarded_by(_lock)

    def set(self, exc: BaseException) -> None:
        with self._lock:
            if self._err is None:
                self._err = exc

    def take(self) -> Optional[BaseException]:
        with self._lock:
            err, self._err = self._err, None
            return err


def device_prefetch(feed_iter: Iterable, size: int = 2,
                    transform: Optional[Callable] = None,
                    device: DeviceLike = None):
    """Iterate feed dicts with ``size`` batches resident ahead of use.

    A daemon thread drains ``feed_iter``, runs ``transform`` on each item
    (e.g. a host ``DataFeeder``'s ``feed``) and
    :func:`device_put_feeds` to ``device`` (``cuda`` unless asked) into a
    bounded queue; on a card both run under a side stream."""
    dev = resolve_device(device)
    side = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    end = object()
    err_box = _ErrorBox()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce(item):
        if transform is not None:
            item = transform(item)
        return device_put_feeds(item, dev)

    def producer():
        try:
            for item in feed_iter:
                if stop.is_set():
                    return
                if side is None:
                    ready = None
                    feeds = produce(item)
                else:
                    with torch.cuda.stream(side):
                        feeds = produce(item)
                        ready = torch.cuda.Event()
                        ready.record(side)
                if not put((feeds, ready)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err_box.set(e)
        finally:
            put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                err = err_box.take()
                if err is not None:
                    raise err
                return
            feeds, ready = item
            if ready is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ready)
                for tensor in _tensors(feeds):
                    if tensor.is_cuda:
                        tensor.record_stream(cur)
            yield feeds
    finally:
        # the consumer stopped (end, break, exception, close): unblock the
        # producer and drop its queued batches
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
