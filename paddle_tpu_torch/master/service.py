"""Task-queue service: the Go master's state machine in Python.

Mirrors go/master/service.go —
  - dataset partitioning into chunk tasks         (service.go:106)
  - todo/pending/done queues with timeout requeue (service.go:313-356)
  - per-task failure count and discard            (service.go:368-448)
  - state snapshot persisted on every mutation    (service.go:207,
    etcd_client.go:96-129 — here a JSON file written atomically)
  - RequestSaveModel dedup so only one trainer
    saves the model at a time                     (service.go:474)
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field, asdict
from typing import Dict, List, Optional, Sequence, Tuple

from .recordio import recordio_index

MAX_TASK_FAILURES = 3


class LeaseTable:
    """Slot + token TTL leases — the etcd lease-id analog, factored out
    of :class:`Service` so the serving fleet's replica lifecycle
    (``paddle_tpu_torch/serving/fleet.py``) and the training master's trainer
    membership run the SAME state machine.

    Semantics (go/pserver/etcd_client.go:67-166):

    - ``register`` claims the smallest free slot and mints a fresh
      token; slots are REUSED after expiry, so the token is what makes
      an owner unique across reclamations;
    - ``heartbeat`` renews only when the presented token matches the
      slot's CURRENT token AND the lease is still live — a zombie
      renewing by slot number alone (its lease lapsed, possibly
      reclaimed by a new owner) gets False and must re-register.  The
      deadline is re-checked directly in ``heartbeat`` (not only via the
      ``expire`` sweep), so a renewal racing slot reclamation can never
      resurrect an expired lease;
    - ``expire`` sweeps lapsed leases and returns the freed slots so the
      owner (task queue, fleet router) can requeue that member's
      in-flight work.  ``register``/``heartbeat``/``members`` sweep
      internally too, and those calls discard the return value — an
      owner that must never miss a freed slot (the master requeues the
      dead trainer's tasks) passes ``on_expire``, which fires for every
      freed slot on EVERY sweep, internal ones included.

    Not thread-safe by itself: :class:`Service` calls it under its own
    lock; the serving fleet is single-threaded on the engine tick loop.
    """

    def __init__(self, ttl_s: float, time_fn=time.time, on_expire=None,
                 tracer=None):
        self.ttl_s = float(ttl_s)
        self._time = time_fn
        self._on_expire = on_expire
        # obs hook (paddle_tpu_torch.obs): lease transitions — register,
        # zombie-rejected renewal, expiry, drop — land on the fleet
        # trace timeline.  None (the default, and the training master's
        # setting) costs one is-None check per transition.  Tokens are
        # NEVER recorded: slots identify members on the timeline.
        self.tracer = tracer
        # slot -> (lease deadline, lease token); callers serialize:
        # Service wraps every call in its RLock, and the serving fleet
        # drives its own table from the single engine tick thread
        # guarded_by(serialized: callers hold Service RLock / tick loop)
        self._members: Dict[int, Tuple[float, str]] = {}

    def register(self, ttl_s: Optional[float] = None) -> Tuple[int, str]:
        import secrets

        self.expire()
        slot = 0
        while slot in self._members:
            slot += 1
        token = secrets.token_hex(8)
        self._members[slot] = (self._time() + float(ttl_s or self.ttl_s),
                               token)
        if self.tracer is not None:
            self.tracer.instant("lease_register", cat="lease", lease=slot)
        return slot, token

    def heartbeat(self, slot: int, token: str,
                  ttl_s: Optional[float] = None) -> bool:
        """Renew a lease.  False = the lease is gone: expired, or the
        slot was reclaimed by a new owner whose token doesn't match."""
        self.expire()
        now = self._time()
        ent = self._members.get(slot)
        if ent is None or ent[1] != token or ent[0] <= now:
            if self.tracer is not None:
                self.tracer.instant("lease_reject", cat="lease",
                                    lease=slot)
            return False
        self._members[slot] = (now + float(ttl_s or self.ttl_s), token)
        return True

    def alive(self, slot: int, token: str) -> bool:
        """Liveness probe without renewal (the fleet's per-tick death
        sweep reads this; only heartbeats extend the deadline)."""
        self.expire()
        ent = self._members.get(slot)
        return ent is not None and ent[1] == token

    def drop(self, slot: int, token: str) -> bool:
        """Explicitly release a lease (clean drain / fleet fencing of a
        killed replica).  Token-checked like heartbeat, so a zombie
        can't evict the slot's new owner."""
        ent = self._members.get(slot)
        if ent is None or ent[1] != token:
            return False
        del self._members[slot]
        if self.tracer is not None:
            self.tracer.instant("lease_drop", cat="lease", lease=slot)
        return True

    def members(self) -> List[int]:
        self.expire()
        return sorted(self._members)

    def expire(self) -> List[int]:
        """Sweep lapsed leases; returns the slots freed this call (and
        reports each to ``on_expire`` after the table is consistent, so
        the hook can re-register without racing the sweep)."""
        now = self._time()
        dead = [s for s, (dl, _) in self._members.items() if dl <= now]
        for slot in dead:
            del self._members[slot]
        if self.tracer is not None:
            for slot in dead:
                self.tracer.instant("lease_expire", cat="lease",
                                    lease=slot)
        if self._on_expire is not None:
            for slot in dead:
                self._on_expire(slot)
        return dead


@dataclass
class Chunk:
    path: str
    offset: int
    count: int


@dataclass
class Task:
    id: int
    epoch: int = 0
    num_failures: int = 0
    chunks: List[Chunk] = field(default_factory=list)


class Service:
    """In-memory task queue with optional file snapshot.

    ``time_fn`` is injectable for deterministic timeout tests (the Go
    tests drive timeouts the same way via internal hooks,
    service_internal_test.go).
    """

    def __init__(self, chunks_per_task: int = 8, timeout_s: float = 60.0,
                 max_failures: int = MAX_TASK_FAILURES,
                 snapshot_path: Optional[str] = None, time_fn=time.time):
        self.chunks_per_task = max(1, int(chunks_per_task))
        self.timeout_s = timeout_s
        self.max_failures = max_failures
        self.snapshot_path = snapshot_path
        self._time = time_fn
        self._lock = threading.RLock()

        self._todo: List[Task] = []   # guarded_by(_lock)
        # task id -> (task, deadline)
        # guarded_by(_lock)
        self._pending: Dict[int, Tuple[Task, float]] = {}
        self._done: List[Task] = []   # guarded_by(_lock)
        self._dataset_set = False   # guarded_by(_lock)
        self._dataset_paths: List[str] = []   # guarded_by(_lock)
        self._next_id = 0   # guarded_by(_lock)
        self._pass_no = 0   # guarded_by(_lock)
        # save-model dedup: time until which save requests are "taken"
        self._save_until = 0.0   # guarded_by(_lock)
        # trainer membership: the etcd Register/lease analog
        # (go/pserver/etcd_client.go:67-166 — each trainer holds an index
        # slot under a TTL lease; a missed heartbeat frees the slot and
        # requeues the trainer's in-flight tasks)
        self.lease_ttl_s = 3 * self.timeout_s if self.timeout_s else 180.0
        # the etcd Register/lease analog, shared with the serving fleet:
        # slots are REUSED after expiry, so a zombie trainer renewing by
        # slot number alone could hijack the slot's new owner —
        # heartbeats must present the token they registered with
        # guarded_by(_lock)
        self._leases = LeaseTable(self.lease_ttl_s, time_fn=time_fn,
                                  on_expire=self._requeue_dead_member)
        # task id -> owner slot (for prompt requeue on lease expiry)
        self._owners: Dict[int, Optional[int]] = {}   # guarded_by(_lock)

        if snapshot_path and os.path.exists(snapshot_path):
            self._recover(snapshot_path)

    # ---- dataset -----------------------------------------------------------

    def set_dataset(self, paths: Sequence[str]) -> int:
        """Partition recordio files into chunk tasks. Idempotent: only the
        first caller's dataset wins (service.go SetDataset does the same so
        N trainers can race to init)."""
        with self._lock:
            paths = list(paths)
            if self._dataset_set:
                if paths == self._dataset_paths:
                    return len(self._todo)
                # different dataset than the (possibly recovered) state:
                # re-partition from scratch rather than serving stale chunks
                self._todo, self._pending, self._done = [], {}, []
                self._next_id = 0
                self._pass_no = 0
            tasks: List[Task] = []
            for path in paths:
                offsets = recordio_index(path)
                i = 0
                while i < len(offsets):
                    n = min(self.chunks_per_task, len(offsets) - i)
                    tasks.append(Task(id=self._next_id, chunks=[
                        Chunk(path=path, offset=offsets[i], count=n)]))
                    self._next_id += 1
                    i += n
            self._todo = tasks
            self._dataset_set = True
            self._dataset_paths = paths
            self._snapshot()
            return len(tasks)

    # ---- membership (etcd Register/lease analog) ---------------------------

    def register(self, ttl_s: Optional[float] = None) -> Tuple[int, str]:
        """Claim the smallest free trainer slot under a lease
        (etcd_client.go:67-166's idx-slot transaction). Returns
        (slot, lease_token); heartbeats must present both. Re-registering
        after a crash gets a fresh slot+token; the dead slot's lease
        expires on its own and its tasks requeue."""
        with self._lock:
            # LeaseTable.register sweeps internally; the on_expire hook
            # requeues any freed member's tasks, so no extra sweep here
            return self._leases.register(ttl_s)

    def heartbeat(self, slot: int, token: str,
                  ttl_s: Optional[float] = None) -> bool:
        """Renew a lease. False = this trainer's lease is gone (expired, or
        the slot was reclaimed by a new owner — the token mismatch rejects
        the zombie even when the slot number is live again) — it was
        declared dead and must re-register and resume from checkpoint."""
        with self._lock:
            return self._leases.heartbeat(slot, token, ttl_s)

    def members(self) -> List[int]:
        with self._lock:
            return self._leases.members()

    # guarded_by(caller: _lock)
    def _expire_members(self) -> None:
        self._leases.expire()

    # guarded_by(caller: _lock)
    def _requeue_dead_member(self, slot: int) -> None:
        """on_expire hook: runs for every freed slot on EVERY lease
        sweep — including the ones LeaseTable does internally inside
        register/heartbeat/members, so a lease that lapses between our
        own sweep and the inner one still requeues promptly instead of
        waiting for the slow per-task timeout path.  Always called
        under self._lock (every LeaseTable call site holds it)."""
        # a dead trainer's tasks go back to the FRONT of todo: the
        # pass re-runs them promptly, preserving task order for the
        # surviving trainers (crash-resume determinism)
        held = [tid for tid, owner in self._owners.items()
                if owner == slot and tid in self._pending]
        for tid in sorted(held, reverse=True):
            task, _ = self._pending.pop(tid)
            task.num_failures += 1
            if task.num_failures >= self.max_failures:
                self._done.append(task)
                self._maybe_new_pass()
            else:
                self._todo.insert(0, task)
        if held:
            self._snapshot()

    # ---- task lifecycle ----------------------------------------------------

    def get_task(self, owner: Optional[int] = None) -> Optional[Task]:
        """Pop a todo task into pending (with deadline). Returns None when
        nothing is available right now — caller should retry or treat an
        all-done pass as end-of-data (see all_done). ``owner`` ties the
        lease to the task so a dead trainer's work requeues immediately."""
        with self._lock:
            self._check_timeouts()
            self._expire_members()
            if not self._todo:
                return None
            task = self._todo.pop(0)
            self._pending[task.id] = (task, self._time() + self.timeout_s)
            self._owners[task.id] = owner
            self._snapshot()
            return task

    def task_finished(self, task_id: int) -> bool:
        with self._lock:
            ent = self._pending.pop(task_id, None)
            self._owners.pop(task_id, None)
            if ent is None:
                return False
            task = ent[0]
            task.num_failures = 0
            self._done.append(task)
            self._maybe_new_pass()
            self._snapshot()
            return True

    def task_failed(self, task_id: int) -> bool:
        """Requeue a failed task, or discard it past the failure cap
        (service.go:448 discards and counts it done)."""
        with self._lock:
            ent = self._pending.pop(task_id, None)
            if ent is None:
                return False
            task = ent[0]
            task.num_failures += 1
            if task.num_failures >= self.max_failures:
                self._done.append(task)
                self._maybe_new_pass()
            else:
                self._todo.append(task)
            self._snapshot()
            return True

    def all_done(self) -> bool:
        """True when the current pass has been fully consumed."""
        with self._lock:
            self._check_timeouts()
            return self._dataset_set and not self._todo and not self._pending

    def new_pass(self) -> None:
        """Recycle done tasks into todo for the next epoch."""
        with self._lock:
            self._start_new_pass()
            self._snapshot()

    # ---- save-model dedup --------------------------------------------------

    def request_save_model(self, block_s: float) -> bool:
        """First trainer to ask within a window gets True (service.go:474)."""
        with self._lock:
            now = self._time()
            if now < self._save_until:
                return False
            self._save_until = now + block_s
            return True

    # ---- internals ---------------------------------------------------------

    # guarded_by(caller: _lock)
    def _check_timeouts(self) -> None:
        now = self._time()
        expired = [tid for tid, (_, dl) in self._pending.items() if dl <= now]
        for tid in expired:
            task, _ = self._pending.pop(tid)
            task.num_failures += 1
            if task.num_failures >= self.max_failures:
                self._done.append(task)
                self._maybe_new_pass()
            else:
                self._todo.append(task)
        if expired:
            self._snapshot()

    # guarded_by(caller: _lock)
    def _maybe_new_pass(self) -> None:
        if self._dataset_set and not self._todo and not self._pending:
            # pass complete; tasks stay in done until new_pass() recycles
            self._pass_no += 1

    # guarded_by(caller: _lock)
    def _start_new_pass(self) -> None:
        for t in self._done:
            t.epoch += 1
            t.num_failures = 0
        self._todo.extend(self._done)
        self._done = []

    # ---- snapshot / recover ------------------------------------------------

    # guarded_by(caller: _lock)
    def _state(self) -> dict:
        return {
            "todo": [asdict(t) for t in self._todo],
            "pending": [asdict(t) for t, _ in self._pending.values()],
            "done": [asdict(t) for t in self._done],
            "dataset_set": self._dataset_set,
            "dataset_paths": self._dataset_paths,
            "next_id": self._next_id,
            "pass_no": self._pass_no,
        }

    # guarded_by(caller: _lock)
    def _snapshot(self) -> None:
        """Persist the queue state atomically (etcd_client.go:96-129).

        tmp + fsync + rename: the tempfile gets a UNIQUE name (a fixed
        ``.tmp`` suffix would let two masters pointed at one path — or a
        snapshot racing a crash-restart's first write — clobber each
        other mid-write) and is fsynced before the rename, so a kill at
        ANY point leaves either the previous complete snapshot or the
        new complete one, never a truncated file.  A kill between write
        and rename only leaks a stray tempfile."""
        if not self.snapshot_path:
            return
        import tempfile

        d = os.path.dirname(os.path.abspath(self.snapshot_path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._state(), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # guarded_by(caller: _lock)  (also run from __init__, pre-publication)
    def _recover(self, path: str) -> None:
        """Rebuild the queue from a snapshot; a corrupt/torn snapshot
        (pre-hardening truncation, disk damage) starts CLEAN instead of
        crashing — the dataset re-partitions on the next set_dataset,
        exactly like a first boot, and a grep-able line records that
        recovery discarded state."""
        try:
            with open(path) as f:
                st = json.load(f)

            def mk(d):
                return Task(id=d["id"], epoch=d["epoch"],
                            num_failures=d["num_failures"],
                            chunks=[Chunk(**c) for c in d["chunks"]])

            # pending tasks at crash time go back to todo (the Go master
            # does the same on snapshot recovery: leases died with the
            # process)
            todo = [mk(d) for d in st["todo"]] \
                + [mk(d) for d in st["pending"]]
            done = [mk(d) for d in st["done"]]
            dataset_set = bool(st["dataset_set"])
            dataset_paths = st.get("dataset_paths", [])
            next_id = int(st["next_id"])
            pass_no = int(st["pass_no"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f"MASTER-SNAPSHOT-CORRUPT: {path} ({type(e).__name__}: "
                  f"{e}) — rebuilding the task queue from a clean state",
                  flush=True)
            return
        self._todo = todo
        self._done = done
        self._dataset_set = dataset_set
        self._dataset_paths = dataset_paths
        self._next_id = next_id
        self._pass_no = pass_no

    # ---- progress (the step-cursor's task-queue position) ------------------

    def progress(self) -> dict:
        """Queue position snapshot: how far the current pass has
        advanced.  The trainer's step-granular checkpoint cursor records
        this next to (pass, step, rng) so a resume report can show WHERE
        in the dataset the run died, and the resilience CLI surfaces it."""
        with self._lock:
            self._check_timeouts()
            return {"pass_no": self._pass_no,
                    "todo": len(self._todo),
                    "pending": len(self._pending),
                    "done": len(self._done)}


def dispatch(svc: "Service", method, params):
    """The RPC method table (go/master net/rpc surface analog) — shared by
    the TCP server handler and the client's in-process transport so the
    wire protocol has exactly one definition."""
    params = params or {}
    if method == "set_dataset":
        return svc.set_dataset(params["paths"])
    if method == "get_task":
        owner = params.get("owner")
        task = svc.get_task(None if owner is None else int(owner))
        if task is None:
            return None
        return {"id": task.id, "epoch": task.epoch,
                "chunks": [{"path": c.path, "offset": c.offset,
                            "count": c.count} for c in task.chunks]}
    if method == "task_finished":
        return svc.task_finished(int(params["task_id"]))
    if method == "task_failed":
        return svc.task_failed(int(params["task_id"]))
    if method == "all_done":
        return svc.all_done()
    if method == "new_pass":
        svc.new_pass()
        return True
    if method == "request_save_model":
        return svc.request_save_model(float(params.get("block_s", 60.0)))
    if method == "register":
        slot, token = svc.register(params.get("ttl_s"))
        return {"slot": slot, "token": token}
    if method == "heartbeat":
        return svc.heartbeat(int(params["slot"]), str(params["token"]),
                             params.get("ttl_s"))
    if method == "members":
        return svc.members()
    if method == "progress":
        return svc.progress()
    if method == "ping":
        return "pong"
    raise ValueError(f"unknown method {method!r}")
