"""Reader decorators (a copy of ``paddle_tpu/reader/decorator.py``:
map_readers, shuffle, chain, compose, buffered, firstn, xmap_readers).

``shuffle`` draws from Python's ``random`` module as the reference does,
so one ``random.seed`` gives both packages the same order."""

from __future__ import annotations

import itertools
import queue
import random
import threading
from typing import Callable, List


def map_readers(func: Callable, *readers):
    """Apply func elementwise across several readers' outputs."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size: int):
    """Pool-based shuffle with a bounded buffer."""

    def shuffled_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return shuffled_reader


def chain(*readers):
    def chained():
        return itertools.chain(*[r() for r in readers])

    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment: bool = True):
    """Zip several readers into tuple samples (flattening tuple items)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*rs):
                if any(i is None for i in items):
                    raise ComposeNotAligned("readers have different lengths")
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())

    return composed


def buffered(reader, size: int):
    """Prefetch into a bounded queue on a background thread — the async
    double-buffering the reference's DataProvider pool thread did
    (PyDataProvider2.cpp:334-400)."""

    class _End:
        pass

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)

        def fill():
            try:
                for item in reader():
                    q.put(item)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _End:
                break
            yield item

    return buffered_reader


def firstn(reader, n: int):
    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper: Callable, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """Parallel map over a reader with worker threads (reference used
    processes/threads; threads suffice since mappers are usually IO/numpy)."""

    class _End:
        pass

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feed():
            for i, item in enumerate(reader()):
                in_q.put((i, item))
            for _ in range(process_num):
                in_q.put(_End)

        def work():
            while True:
                got = in_q.get()
                if got is _End:
                    out_q.put(_End)
                    return
                i, item = got
                out_q.put((i, mapper(item)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        done = 0
        if order:
            import heapq

            heap: List = []
            next_idx = 0
            while done < process_num:
                got = out_q.get()
                if got is _End:
                    done += 1
                    continue
                heapq.heappush(heap, got)
                while heap and heap[0][0] == next_idx:
                    _, item = heapq.heappop(heap)
                    yield item
                    next_idx += 1
            while heap:
                _, item = heapq.heappop(heap)
                yield item
        else:
            while done < process_num:
                got = out_q.get()
                if got is _End:
                    done += 1
                    continue
                yield got[1]

    return xreader
