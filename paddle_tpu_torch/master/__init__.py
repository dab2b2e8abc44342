"""Elastic input service (a copy of ``paddle_tpu/master``: it is pure
Python) — the analog of the reference's Go master (reference: go/master/service.go, go/master/c/client.go,
python/paddle/v2/master/client.py:15-80).

The reference dispatches dataset *chunks* as tasks through three queues
(todo/pending/done) with timeout requeue, per-task failure caps, and an
etcd-persisted state snapshot.  Here the same task lifecycle lives in
:class:`Service` (pure Python, file-snapshot instead of etcd), served
either in-process (the ``inmem_store.go`` analog) or over TCP by
:class:`MasterServer` (a thin length-prefixed-JSON protocol that the C++
server in ``native/master`` also speaks).

Records themselves travel out-of-band: the master hands out chunk
*metadata* (path, offset, count) and the trainer-side
:class:`MasterClient` reads the recordio file locally — exactly the
reference's design (go/master/service.go:106 partitions chunks; the
trainer reads via the recordio library).
"""

from .recordio import recordio_write, recordio_read_chunk, recordio_index
from .service import Task, Service, LeaseTable, MAX_TASK_FAILURES
from .server import MasterServer
from .client import MasterClient, MasterRetryExhausted

__all__ = [
    "recordio_write",
    "recordio_read_chunk",
    "recordio_index",
    "Task",
    "Service",
    "LeaseTable",
    "MasterServer",
    "MasterClient",
    "MasterRetryExhausted",
    "MAX_TASK_FAILURES",
]
