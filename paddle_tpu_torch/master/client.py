"""Trainer-side master client (reference:
python/paddle/v2/master/client.py:15-80 over go/master/c/client.go).

``MasterClient(None)`` runs against an in-process Service (the
inmem_store analog used throughout the reference's tests); passing an
``"host:port"`` string talks to a MasterServer (Python or C++) over TCP.

``next_record()`` drives the task lifecycle: fetch a task, stream its
chunks from local recordio files, report task_finished, and return None
at end of pass.

Transient failures (dropped connections, a master mid-restart, an empty
todo queue while peers hold leases) are retried with CAPPED EXPONENTIAL
BACKOFF + DECORRELATED JITTER — ``sleep = min(cap, uniform(base,
3 * prev))`` — instead of a fixed-interval poll, so a restarting master
isn't hammered by a synchronized trainer fleet.  ``retry_budget`` bounds
consecutive failed attempts; exhausting it raises
:class:`MasterRetryExhausted` with the last underlying error, so a
wedged master surfaces as a clear trainer error instead of a silent
infinite loop.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Callable, List, Optional

from .recordio import recordio_read_chunk
from .service import Service, dispatch
from .server import send_msg, recv_msg


class MasterRetryExhausted(ConnectionError):
    """The client's retry budget ran out without a successful call."""


class _Backoff:
    """Capped exponential backoff with decorrelated jitter (the AWS
    architecture-blog flavor: each sleep draws uniform(base, 3 * prev),
    clamped to cap — successive clients decorrelate instead of
    thundering back in lockstep).  ``budget`` caps consecutive sleeps;
    ``reset()`` (on success) restores the full budget and the base
    interval.  ``sleep_fn`` is injectable so tests drive retries without
    wall-clock sleeping."""

    def __init__(self, base_s: float, cap_s: float,
                 budget: Optional[int] = None,
                 seed: Optional[int] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.base_s = max(1e-4, float(base_s))
        self.cap_s = max(self.base_s, float(cap_s))
        self.budget = budget
        # seed=None -> OS entropy: every client in a fleet draws a
        # DIFFERENT jitter sequence (a shared fixed seed would put the
        # whole fleet back in lockstep, recreating the thundering herd
        # the jitter exists to break). Pass a seed for replayable tests.
        self._rng = random.Random(seed)
        self._sleep_fn = sleep_fn
        self.reset()

    def reset(self) -> None:
        self.attempts = 0
        self._prev = self.base_s

    def sleep(self, why: str = "") -> None:
        self.attempts += 1
        if self.budget is not None and self.attempts > self.budget:
            raise MasterRetryExhausted(
                f"master retry budget ({self.budget}) exhausted"
                f"{': ' + why if why else ''}")
        self._prev = min(self.cap_s,
                         self._rng.uniform(self.base_s, 3.0 * self._prev))
        self._sleep_fn(self._prev)


class _InprocTransport:
    def __init__(self, service: Optional[Service] = None):
        self.service = service or Service()

    def call(self, method: str, **params):
        return dispatch(self.service, method, params)


class _TcpTransport:
    """TCP transport with reconnect-on-failure.  A dropped connection
    (master restart, flaky network) triggers backoff + reconnect and a
    re-send of the in-flight call.  At-least-once caveat: a call that
    reached the master before the drop may execute twice — idempotent
    methods tolerate this (set_dataset dedups, task_finished/failed on a
    non-pending id is a no-op False).  ``get_task`` is NOT idempotent (a
    blind re-send would lease a SECOND task while the lost response's
    lease silently burns that task's failure budget on expiry), so a
    lost get_task response is reported as None — "nothing available" —
    and the caller's poll loop retries; the orphaned lease requeues via
    the server's normal timeout path.  ``register`` is re-sent: a lost
    response may strand one unowned slot, but the caller needs the
    slot/token to proceed and the stray slot self-heals when its TTL
    lease expires — the least-bad option without server-side request
    dedup."""

    _LEASING_METHODS = frozenset({"get_task"})

    def __init__(self, addr: str, timeout_s: float = 30.0,
                 backoff: Optional[_Backoff] = None):
        host, port = addr.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout_s = timeout_s
        self._backoff = backoff or _Backoff(0.05, 2.0)
        self._sock: Optional[socket.socket] = None
        self._send_attempted = False
        self._connect()

    def _connect(self) -> None:
        """(Re)establish the connection, backing off between attempts;
        raises MasterRetryExhausted when the budget runs out."""
        self.close()
        while True:
            try:
                self._sock = socket.create_connection(
                    self._addr, timeout=self._timeout_s)
                self._sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                return
            except OSError as e:
                self._sock = None
                self._backoff.sleep(f"connect to {self._addr}: {e}")

    def call(self, method: str, **params):
        while True:
            self._send_attempted = False
            try:
                if self._sock is None:
                    self._connect()
                return self.call_once(method, **params)
            except (ConnectionError, OSError) as e:
                self._backoff.sleep(f"call {method}: {e}")
                self._connect()
                # only once bytes may actually have left (the send was
                # attempted) is a leasing call ambiguous; a connect-time
                # failure provably never reached the master, so re-send
                if self._send_attempted and \
                        method in self._LEASING_METHODS:
                    return None

    def call_once(self, method: str, **params):
        """One attempt, no backoff and no reconnect — the shutdown path
        (a dead master must not stall ``close()`` through a retry
        budget)."""
        if self._sock is None:
            raise ConnectionError("not connected")
        self._send_attempted = True
        send_msg(self._sock, {"method": method, "params": params})
        resp = recv_msg(self._sock)
        if resp is None:
            raise ConnectionError("master connection closed")
        self._backoff.reset()
        if not resp.get("ok"):
            raise RuntimeError(f"master error: {resp.get('error')}")
        return resp.get("result")

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


DEFAULT_TRANSPORT_RETRY_BUDGET = 30


class MasterClient:
    """``retry_budget`` semantics: when left at None, TRANSPORT failures
    (connect / dropped call) still get a finite default budget
    (:data:`DEFAULT_TRANSPORT_RETRY_BUDGET` — a permanently-dead master
    must surface as :class:`MasterRetryExhausted`, not a silent forever
    loop), while the task POLL loop stays unbounded (waiting out peers
    that hold long-running tasks is legitimate, and the old fixed-poll
    behavior waited forever too).  An explicit ``retry_budget`` bounds
    both."""

    def __init__(self, addr: Optional[str] = None,
                 service: Optional[Service] = None,
                 poll_interval_s: float = 0.05,
                 retry_cap_s: float = 2.0,
                 retry_budget: Optional[int] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        # two independent backoff states: transport-level reconnects and
        # the task-poll loop each get the full budget, both using
        # poll_interval_s as the base interval (OS-entropy jitter, so a
        # trainer fleet decorrelates)
        self._poll_backoff = _Backoff(poll_interval_s, retry_cap_s,
                                      budget=retry_budget,
                                      sleep_fn=sleep_fn)
        if addr:
            transport_budget = retry_budget if retry_budget is not None \
                else DEFAULT_TRANSPORT_RETRY_BUDGET
            self._t = _TcpTransport(addr, backoff=_Backoff(
                poll_interval_s, retry_cap_s, budget=transport_budget,
                sleep_fn=sleep_fn))
        else:
            self._t = _InprocTransport(service)
        self._records: List[bytes] = []
        self._task_id: Optional[int] = None
        self._slot: Optional[int] = None
        self._token: Optional[str] = None

    # -- polling -------------------------------------------------------------

    def poll_wait(self) -> None:
        """Back off before re-asking for work (the master had nothing —
        peers hold the pending tasks).  Jittered and counted against the
        poll retry budget, exactly like ``next_record``'s internal loop;
        callers driving ``try_next_task`` themselves (the elastic
        trainer) use this instead of a fixed sleep."""
        self._poll_backoff.sleep("waiting for an available task")

    def poll_reset(self) -> None:
        """Work arrived: restore the poll backoff to its base interval
        and refund the budget."""
        self._poll_backoff.reset()

    # -- dataset / records ---------------------------------------------------

    def set_dataset(self, paths) -> int:
        if isinstance(paths, str):
            paths = paths.split(",")
        return self._t.call("set_dataset", paths=list(paths))

    def next_record(self) -> Optional[bytes]:
        """Next record of the current pass, or None when the pass is done."""
        while not self._records:
            if not self._fetch_task():
                return None
        return self._records.pop(0)

    def try_next_task(self):
        """ONE non-blocking task-fetch attempt with NO implicit ack —
        the elastic trainer acks explicitly (ack_task) only after the
        covering checkpoint is durable, so a crash never acks unapplied
        work. Returns:

        - ("task", (task_id, epoch, records)) — a task to process;
        - ("empty", None) — nothing available NOW (other trainers hold
          pending tasks, or the caller itself holds unacked ones);
        - ("done", None)  — the pass is fully consumed.
        """
        task = self._t.call("get_task", owner=self._slot)
        if task is None:
            return (("done" if self._t.call("all_done") else "empty"), None)
        recs: List[bytes] = []
        try:
            for c in task["chunks"]:
                got = recordio_read_chunk(c["path"], c["offset"], c["count"])
                recs.extend(g if isinstance(g, bytes) else bytes(g)
                            for g in got)
        except OSError:
            self._t.call("task_failed", task_id=task["id"])
            return ("empty", None)
        return ("task", (task["id"], task.get("epoch", 0), recs))

    def ack_task(self, task_id: int) -> None:
        """Report a task finished (explicit-ack path of try_next_task)."""
        self._t.call("task_finished", task_id=task_id)
        if self._task_id == task_id:
            self._task_id = None

    def task_failed(self) -> None:
        """Report the in-flight task failed (fault-injection / error paths)."""
        if self._task_id is not None:
            self._t.call("task_failed", task_id=self._task_id)
            self._task_id = None
            self._records = []

    # -- membership (etcd Register/lease analog) -----------------------------

    def register(self, ttl_s: Optional[float] = None) -> int:
        """Join the job: claim a trainer slot under a lease. Tasks fetched
        afterwards are owned by this slot and requeue promptly if the
        lease lapses (go/pserver/etcd_client.go:67-166)."""
        got = self._t.call("register", ttl_s=ttl_s)
        self._slot, self._token = got["slot"], got["token"]
        return self._slot

    def heartbeat(self, ttl_s: Optional[float] = None) -> bool:
        """Renew the lease. False means this trainer was declared dead
        (lease lapsed — even if the slot number was since reclaimed by a
        new trainer, the token mismatch rejects the zombie) — it must
        re-register and resume from its last checkpoint."""
        if self._slot is None:
            return False
        ok = self._t.call("heartbeat", slot=self._slot, token=self._token,
                          ttl_s=ttl_s)
        if not ok:
            self._slot = None
            self._token = None
            self._task_id = None
            self._records = []
        return ok

    def members(self) -> List[int]:
        return self._t.call("members")

    def progress(self) -> dict:
        """Queue position of the current pass ({pass_no, todo, pending,
        done}) — the task-queue component of the step-granular
        checkpoint cursor, and what the resilience CLI reports while a
        supervised run recovers."""
        return self._t.call("progress")

    # -- pass control --------------------------------------------------------

    def begin_pass(self) -> None:
        """Recycle the task queue if the previous pass fully completed.
        Safe under multiple trainers: new_pass only fires when todo and
        pending are both empty, so exactly one epoch boundary happens."""
        if self._t.call("all_done"):
            self._t.call("new_pass")

    def new_pass(self) -> None:
        self._t.call("new_pass")

    def request_save_model(self, block_s: float = 60.0) -> bool:
        return self._t.call("request_save_model", block_s=block_s)

    def close(self) -> None:
        # release an in-flight task immediately rather than letting its
        # lease time out and re-serve already-consumed records.  ONE
        # attempt, no retry loop: shutdown against a dead master must
        # fail fast, not sit out the whole transport backoff budget
        try:
            if self._task_id is not None:
                once = getattr(self._t, "call_once", self._t.call)
                once("task_failed", task_id=self._task_id)
        except (ConnectionError, RuntimeError, OSError):
            pass
        self._task_id = None
        self._records = []
        if hasattr(self._t, "close"):
            self._t.close()

    # -- internals -----------------------------------------------------------

    def _fetch_task(self) -> bool:
        """Load the next task's records. False at end of pass."""
        if self._task_id is not None:
            self._t.call("task_finished", task_id=self._task_id)
            self._task_id = None
        while True:
            task = self._t.call("get_task", owner=self._slot)
            if task is not None:
                self.poll_reset()
                break
            if self._t.call("all_done"):
                self.poll_reset()
                return False
            # other workers hold pending tasks: poll with backoff+jitter
            self.poll_wait()
        recs: List[bytes] = []
        try:
            for c in task["chunks"]:
                got = recordio_read_chunk(c["path"], c["offset"], c["count"])
                recs.extend(g if isinstance(g, bytes) else bytes(g)
                            for g in got)
        except OSError:
            self._t.call("task_failed", task_id=task["id"])
            return True  # try another task
        self._task_id = task["id"]
        self._records = recs
        return True
