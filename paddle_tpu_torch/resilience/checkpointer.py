"""Async checkpoint writer: training stalls only for the device->host
copy, never the disk write (the port of
``paddle_tpu/resilience/checkpointer.py``).

The synchronous ``checkpoint.save_checkpoint`` copies to host, tars,
pickles AND md5s while the train loop waits.  The
:class:`AsyncCheckpointer` splits that along the line
``checkpoint.snapshot_checkpoint`` / ``checkpoint.write_checkpoint``
already draws:

- :meth:`save` runs the SNAPSHOT phase inline (the device->host copy
  must have landed before the train loop updates those tensors in place
  in its next step) into pinned host buffers it reuses from save to save,
  and hands the host-resident payload to ONE background writer thread
  for the tar/pkl/meta commit (tmp+rename+md5, meta last);
- depth-one pipelining: a new :meth:`save` first waits out the previous
  write, so at most one write is in flight, commit order equals submit
  order, and the pinned buffers are free again before they are
  overwritten;
- :meth:`wait` is the durability barrier (the elastic trainer acks
  master tasks only past it) and the error surface: a writer-thread
  failure — including an injected
  :class:`~paddle_tpu_torch.resilience.faults.InjectedTrainerDeath` from
  a ``kill_save_at`` plan — is re-raised HERE, on the training thread,
  at the next durability point.  A failed write never turns into a
  synchronous one; it leaves a meta-less dir the commit protocol already
  tolerates, and the previous checkpoint stays ``latest``.

Timing is host wall time (``time.perf_counter``): ``stall_s`` totals what
the train loop actually waited (snapshot + any wait on a previous write),
``snapshot_s`` the device->host copies alone (``snapshots`` lists each),
``write_s`` the background disk time.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch.analysis.concurrency.lifecycle import record_transition

__all__ = ["AsyncCheckpointer"]


class AsyncCheckpointer:
    """Depth-one pipelined checkpoint writer (see module doc).

    ``keep``: prune budget applied after every successful commit (only
    VERIFIED dirs count toward it — see ``checkpoint.prune_checkpoints``).
    0 disables pruning.
    """

    def __init__(self, keep: int = 2):
        self.keep = int(keep)
        # no lock: with ONE writer in flight at a time, the join() in
        # wait()/drain() is the happens-before edge for everything the
        # writer thread touches (_error, commits, write_s, last_path);
        # a concurrent scrape of the counters may read a stale value,
        # never a torn one (they are plain ints/floats)
        # guarded_by(serialized: depth-one writer; join happens-before)
        self._thread: Optional[threading.Thread] = None
        # guarded_by(serialized: depth-one writer; join happens-before)
        self._error: Optional[BaseException] = None
        self._buffers = ckpt.HostBuffers()
        # counters (host-side bookkeeping, read by chip_smoke and tests)
        self.saves = 0   # guarded_by(serialized: training thread only)
        # guarded_by(serialized: writer thread, join() happens-before)
        self.commits = 0
        self.stall_s = 0.0   # guarded_by(serialized: training thread only)
        # guarded_by(serialized: training thread only)
        self.snapshot_s = 0.0
        # guarded_by(serialized: training thread only)
        self.snapshots: List[float] = []   # seconds of each snapshot
        # guarded_by(serialized: writer thread, join() happens-before)
        self.write_s = 0.0
        # guarded_by(serialized: writer thread, join() happens-before)
        self.last_path: Optional[str] = None
        # guarded_by(serialized: training thread only)
        self.last_bytes = 0

    # ---- durability barrier ----------------------------------------------

    def wait(self) -> None:
        """Block until the in-flight write (if any) committed; re-raise
        the writer's failure on THIS thread.  The durability point: an
        elastic trainer acks only past it, and a train loop returns
        only past it."""
        t = self._thread
        if t is not None:
            t0 = time.perf_counter()     # lint: allow(wall-clock)
            t.join()
            self.stall_s += time.perf_counter() - t0  # lint: allow(wall-clock)
            self._thread = None
        err = self._error
        if err is not None:
            self._error = None
            raise err

    def drain(self) -> None:
        """Best-effort join WITHOUT re-raising (the death-path cleanup:
        when the train loop is already unwinding on an injected death,
        the in-flight write is allowed to finish — deterministic — and
        any writer error is kept recorded for the next wait())."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None

    def idle(self) -> bool:
        """True when no write is in flight (non-blocking): the elastic
        trainer polls this once per step to ack a committed write's
        tasks EARLY instead of holding them leased until the next
        flush."""
        t = self._thread
        return t is None or not t.is_alive()

    def take_error(self) -> Optional[BaseException]:
        """Pop the recorded writer error without raising — for a caller
        about to DISCARD this checkpointer (per-call rebuild, unwind):
        a failed write must at least be reported loudly, never
        silently dropped with the object."""
        err = self._error
        self._error = None
        return err

    # ---- save -------------------------------------------------------------

    def save(self, root: str, pass_id: int, parameters,
             opt_state: Any = None, model_state: Any = None,
             extra_meta: Optional[Dict] = None, shard_plan: Any = None,
             commit_hook: Optional[Callable[[str], None]] = None) -> None:
        """Snapshot now (blocking: device->host into the reused pinned
        buffers), write in the background.  Waits out the previous write
        first, so callers get depth-one pipelining and in-order commits
        for free."""
        self.wait()
        record_transition("checkpoint_commit", "idle", "snapshot")
        # the stall and write seconds are honest wall time: they measure
        # the host's copy and the disk, which no injected clock models
        t0 = time.perf_counter()         # lint: allow(wall-clock)
        host = ckpt.snapshot_checkpoint(parameters, opt_state=opt_state,
                                        model_state=model_state,
                                        shard_plan=shard_plan,
                                        buffers=self._buffers)
        dt = time.perf_counter() - t0    # lint: allow(wall-clock)
        self.snapshot_s += dt
        self.snapshots.append(dt)
        self.stall_s += dt
        self.saves += 1
        self.last_bytes = host.nbytes()
        record_transition("checkpoint_commit", "snapshot", "write")

        def _write() -> None:
            w0 = time.perf_counter()     # lint: allow(wall-clock)
            try:
                path = ckpt.write_checkpoint(root, pass_id, host,
                                             extra_meta=extra_meta,
                                             commit_hook=commit_hook)
                record_transition("checkpoint_commit", "write", "commit")
                if self.keep > 0:
                    record_transition("checkpoint_commit", "commit",
                                      "prune")
                    ckpt.prune_checkpoints(root, keep=self.keep)
                    record_transition("checkpoint_commit", "prune",
                                      "idle")
                else:
                    record_transition("checkpoint_commit", "commit",
                                      "idle")
                self.commits += 1
                self.last_path = path
            except BaseException as e:   # surfaces at the next wait()
                record_transition("checkpoint_commit", "write", "failed")
                record_transition("checkpoint_commit", "failed", "idle")
                self._error = e
            finally:
                self.write_s += time.perf_counter() - w0  # lint: allow(wall-clock)

        t = threading.Thread(target=_write, name="ckpt-writer", daemon=True)
        self._thread = t
        t.start()
