"""The port's elastic input master (``paddle_tpu_torch/master``, a copy of
the JAX package's pure-Python master) on the CPU.

The counterparts of ``tests/test_master.py`` (below, run on the port's
modules) and of ``tests/test_elastic_recovery.py`` (the membership
protocol and kill/resume through ``SGD.train(master=...)`` on the port's
trainer, each resumed run bit-identical to a straight one), and parity
with the JAX package: the same calls on both packages' ``Service`` give
the same task order, epochs, chunks and progress, exactly; both
clients stream the same records in the same order; the elastic trainer
matches the JAX package's on the same numpy weights (f32, 1e-5 relative
+ 1e-6 absolute, the level of ``tests/test_torch_optimizers.py``).

The reference's own description of what it tests follows.

Elastic input master tests (reference:
go/master/service_internal_test.go — task lifecycle incl. timeout and
failure requeue; client_internal_test.go — end-to-end with in-mem store),
plus client-side retry behavior: capped exponential backoff with
decorrelated jitter, reconnect through a flaky server, and a clear
error when the retry budget runs out (all with an injected sleep_fn —
no wall-clock sleeping)."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import os
import socket
import threading

import numpy as np
import pytest

from paddle_tpu import master as jmaster
from paddle_tpu.platform.flags import FLAGS as JFLAGS
from paddle_tpu.resilience import chaos as jchaos

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import master as tmaster
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.resilience import chaos as tchaos
from paddle_tpu_torch.master import (MasterClient, MasterRetryExhausted,
                                     MasterServer, Service, recordio_index,
                                     recordio_read_chunk, recordio_write)
from paddle_tpu_torch.master.server import recv_msg, send_msg
from paddle_tpu_torch.master.service import dispatch
from paddle_tpu_torch.reader import creator


@pytest.fixture
def dataset(tmp_path):
    paths = []
    for i in range(2):
        p = str(tmp_path / f"part-{i}.rio")
        recordio_write(p, [f"rec-{i}-{j}".encode() for j in range(10)])
        paths.append(p)
    return paths


def test_recordio_roundtrip(tmp_path):
    p = str(tmp_path / "x.rio")
    recs = [b"a", b"bb" * 100, b""]
    assert recordio_write(p, recs) == 3
    offs = recordio_index(p)
    assert len(offs) == 3
    assert recordio_read_chunk(p, offs[0], 3) == recs
    assert recordio_read_chunk(p, offs[1], 1) == [recs[1]]


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_task_lifecycle_and_timeout(dataset):
    clock = FakeClock()
    svc = Service(chunks_per_task=4, timeout_s=10.0, time_fn=clock)
    n = svc.set_dataset(dataset)
    assert n == 6  # 20 records / 4 per chunk-task... 3 chunks per file
    # second set_dataset is a no-op (racing trainers)
    assert svc.set_dataset(dataset) == 6

    t1 = svc.get_task()
    assert t1 is not None and t1.chunks
    assert svc.task_finished(t1.id)
    assert not svc.task_finished(t1.id)  # not pending anymore

    t2 = svc.get_task()
    clock.t += 11.0  # expire the lease
    t3 = svc.get_task()
    assert t3 is not None
    # eventually the timed-out t2 comes back around
    seen = {t3.id}
    while True:
        t = svc.get_task()
        if t is None:
            break
        seen.add(t.id)
        svc.task_finished(t.id)
    assert t2.id in seen
    svc.task_finished(t3.id)
    assert svc.all_done()


def test_failure_cap_discards(dataset):
    svc = Service(chunks_per_task=100, max_failures=2)
    svc.set_dataset(dataset[:1])  # one task
    t = svc.get_task()
    svc.task_failed(t.id)     # 1st failure -> requeued
    t = svc.get_task()
    assert t is not None
    svc.task_failed(t.id)     # 2nd failure -> discarded as done
    assert svc.get_task() is None
    assert svc.all_done()


def test_new_pass_recycles(dataset):
    svc = Service(chunks_per_task=100)
    svc.set_dataset(dataset[:1])
    t = svc.get_task()
    svc.task_finished(t.id)
    assert svc.all_done()
    svc.new_pass()
    t2 = svc.get_task()
    assert t2 is not None and t2.epoch == 1


def test_snapshot_recover(dataset, tmp_path):
    snap = str(tmp_path / "state.json")
    svc = Service(chunks_per_task=4, snapshot_path=snap)
    svc.set_dataset(dataset)
    t = svc.get_task()      # leave one pending at "crash" time
    svc2 = Service(chunks_per_task=4, snapshot_path=snap)
    # pending task returned to todo on recovery; dataset not re-partitioned
    assert svc2.set_dataset(dataset) == 6
    ids = set()
    while True:
        t2 = svc2.get_task()
        if t2 is None:
            break
        ids.add(t2.id)
        svc2.task_finished(t2.id)
    assert t.id in ids and len(ids) == 6


def test_corrupt_snapshot_recovers_clean(dataset, tmp_path, capsys):
    """A torn/corrupt snapshot (truncated mid-write by a pre-hardening
    kill, or disk damage) must rebuild the queue from a clean state —
    loudly — instead of crashing the master at boot; the next
    set_dataset re-partitions like a first boot."""
    snap = str(tmp_path / "state.json")
    svc = Service(chunks_per_task=4, snapshot_path=snap)
    svc.set_dataset(dataset)
    svc.get_task()
    body = open(snap).read()
    for garbage in (body[:len(body) // 2],    # truncated mid-write
                    '{"todo": [',             # syntactically torn
                    '{"done": []}'):          # valid JSON, missing keys
        with open(snap, "w") as f:
            f.write(garbage)
        svc2 = Service(chunks_per_task=4, snapshot_path=snap)
        assert "MASTER-SNAPSHOT-CORRUPT" in capsys.readouterr().out
        assert svc2.set_dataset(dataset) == 6, "clean re-partition"
        t = svc2.get_task()
        assert t is not None and svc2.task_finished(t.id)
        # the recovered service keeps snapshotting atomically: its own
        # writes produce a loadable file again (5 todo: one task done)
        svc3 = Service(chunks_per_task=4, snapshot_path=snap)
        assert svc3.set_dataset(dataset) == 5  # idempotent: state kept
        assert capsys.readouterr().out == ""


def test_snapshot_has_no_fixed_tmp_name(dataset, tmp_path):
    """The snapshot tempfile is unique per write (mkstemp), so two
    services pointed at one path — or a write racing a crash-restart —
    can never clobber each other's half-written tmp; only complete
    renames land."""
    snap = str(tmp_path / "state.json")
    svc = Service(chunks_per_task=4, snapshot_path=snap)
    svc.set_dataset(dataset)
    assert not os.path.exists(snap + ".tmp")
    leftovers = [f for f in os.listdir(str(tmp_path))
                 if f.endswith(".tmp")]
    assert leftovers == []


def test_progress_reports_queue_position(dataset):
    svc = Service(chunks_per_task=4)
    assert svc.progress() == {"pass_no": 0, "todo": 0, "pending": 0,
                              "done": 0}
    svc.set_dataset(dataset)
    t = svc.get_task()
    assert svc.progress() == {"pass_no": 0, "todo": 5, "pending": 1,
                              "done": 0}
    svc.task_finished(t.id)
    assert svc.progress()["done"] == 1
    c = MasterClient(service=svc)
    assert c.progress()["todo"] == 5


def test_save_model_dedup():
    clock = FakeClock()
    svc = Service(time_fn=clock)
    assert svc.request_save_model(60.0)
    assert not svc.request_save_model(60.0)
    clock.t += 61
    assert svc.request_save_model(60.0)


def test_tcp_server_end_to_end(dataset):
    srv = MasterServer().start()
    try:
        c = MasterClient(srv.address)
        c.set_dataset(dataset)
        got = []
        while True:
            r = c.next_record()
            if r is None:
                break
            got.append(r)
        assert sorted(got) == sorted(
            f"rec-{i}-{j}".encode() for i in range(2) for j in range(10))
        c.close()
    finally:
        srv.stop()


def test_cloud_reader_inproc(dataset):
    reader = creator.cloud_reader(dataset)
    got = list(reader())
    assert sorted(got) == sorted(
        f"rec-{i}-{j}".encode() for i in range(2) for j in range(10))


class _FlakyMaster:
    """A TCP master that accepts-and-closes the first ``drop_first_n``
    connections, then speaks the real protocol against a Service — the
    crash-looping-master stand-in for the client's reconnect path."""

    def __init__(self, svc: Service, drop_first_n: int):
        self.svc = svc
        self.drops_left = drop_first_n
        # methods to execute server-side ONCE and then drop the
        # connection WITHOUT replying — the lost-response case
        self.lose_response_once = set()
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self.address = f"127.0.0.1:{self._lsock.getsockname()[1]}"
        self._stop = False
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while not self._stop:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            if self.drops_left > 0:
                self.drops_left -= 1
                conn.close()
                continue
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        while True:
            try:
                req = recv_msg(conn)
            except (ConnectionError, OSError):
                return
            if req is None:
                return
            try:
                result = dispatch(self.svc, req.get("method"),
                                  req.get("params"))
                resp = {"ok": True, "result": result}
            except Exception as e:
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if req.get("method") in self.lose_response_once:
                self.lose_response_once.discard(req.get("method"))
                conn.close()           # executed, but the reply is lost
                return
            try:
                send_msg(conn, resp)
            except (ConnectionError, OSError):
                return

    def stop(self):
        self._stop = True
        try:
            self._lsock.close()
        except OSError:
            pass


def test_client_reconnects_through_flaky_server(dataset):
    fm = _FlakyMaster(Service(chunks_per_task=100), drop_first_n=3)
    sleeps = []
    try:
        c = MasterClient(fm.address, poll_interval_s=0.001, retry_budget=20,
                         sleep_fn=sleeps.append)
        c.set_dataset(dataset[:1])      # rides through the dropped conns
        recs = []
        while True:
            r = c.next_record()
            if r is None:
                break
            recs.append(r)
        assert sorted(recs) == sorted(
            f"rec-0-{j}".encode() for j in range(10))
        assert fm.drops_left == 0       # the drops actually happened
        assert sleeps                   # and backoff absorbed them
        assert all(s <= 2.0 for s in sleeps)
        c.close()
    finally:
        fm.stop()


def test_retry_budget_exhausted_raises_clear_error():
    fm = _FlakyMaster(Service(), drop_first_n=10 ** 9)   # always drops
    sleeps = []
    try:
        c = MasterClient(fm.address, poll_interval_s=0.001, retry_budget=3,
                         sleep_fn=sleeps.append)
        with pytest.raises(MasterRetryExhausted):
            c.set_dataset(["/nonexistent"])
        assert len(sleeps) == 3         # the whole budget, then the error
    finally:
        fm.stop()


def test_poll_backoff_budget_when_peers_hold_tasks(dataset):
    svc = Service(chunks_per_task=100, timeout_s=1e6)
    svc.set_dataset(dataset[:1])
    held = svc.get_task()               # a "peer" holds the only task
    assert held is not None
    sleeps = []
    c = MasterClient(service=svc, poll_interval_s=0.001, retry_budget=5,
                     sleep_fn=sleeps.append)
    with pytest.raises(MasterRetryExhausted):
        c.next_record()
    assert len(sleeps) == 5
    # the peer crashes (task requeued): a fresh client gets the task
    svc.task_failed(held.id)
    c2 = MasterClient(service=svc)
    assert c2.next_record() is not None


def test_lost_get_task_response_is_not_blindly_resent(dataset):
    # the master leases task A but the reply is lost in a connection
    # drop: the client must NOT blind-resend get_task (that would lease
    # a second task while A burns failure budget) — it reports "nothing
    # available", and A requeues through the normal lease timeout, so
    # every record still arrives exactly once
    svc = Service(chunks_per_task=100, timeout_s=0.05)
    fm = _FlakyMaster(svc, drop_first_n=0)
    try:
        c = MasterClient(fm.address, poll_interval_s=0.001,
                         sleep_fn=lambda s: None)
        c.set_dataset(dataset[:1])
        fm.lose_response_once.add("get_task")
        recs = []
        while True:
            r = c.next_record()
            if r is None:
                break
            recs.append(r)
        assert sorted(recs) == sorted(
            f"rec-0-{j}".encode() for j in range(10))
        assert not fm.lose_response_once      # the drop really happened
        c.close()
    finally:
        fm.stop()


def test_close_fails_fast_against_dead_master():
    # shutdown must NOT sit out the transport retry budget: one attempt,
    # zero backoff sleeps, then give up quietly
    fm = _FlakyMaster(Service(), drop_first_n=10 ** 9)
    sleeps = []
    try:
        c = MasterClient(fm.address, poll_interval_s=0.001,
                         sleep_fn=sleeps.append)
        c._task_id = 7                  # pretend a task is in flight
        c.close()                       # swallowed single failure
        assert sleeps == []
        assert c._task_id is None
    finally:
        fm.stop()


def test_poll_wait_public_api_for_elastic_trainer(dataset):
    # the elastic trainer's empty-queue wait goes through poll_wait /
    # poll_reset (it used to reach into master._poll for a fixed sleep)
    svc = Service(chunks_per_task=100, timeout_s=1e6)
    svc.set_dataset(dataset[:1])
    held = svc.get_task()               # a peer holds the only task
    assert held is not None
    sleeps = []
    c = MasterClient(service=svc, poll_interval_s=0.001, retry_budget=2,
                     sleep_fn=sleeps.append)
    status, got = c.try_next_task()
    assert status == "empty" and got is None
    c.poll_wait()
    c.poll_wait()
    with pytest.raises(MasterRetryExhausted):
        c.poll_wait()                   # budget of 2 spent
    c.poll_reset()
    c.poll_wait()                       # refunded
    assert len(sleeps) == 3


def test_backoff_is_jittered_capped_and_resets():
    from paddle_tpu_torch.master.client import _Backoff

    sleeps = []
    b = _Backoff(0.01, 0.5, budget=None, seed=3, sleep_fn=sleeps.append)
    for _ in range(50):
        b.sleep()
    assert 0.01 <= min(sleeps) and max(sleeps) <= 0.5
    assert len(set(sleeps)) > 10        # decorrelated, not a fixed ladder
    b.reset()
    b.sleep()
    assert sleeps[-1] <= 3 * 0.01       # reset returned to the base range


def test_dead_master_trips_default_transport_budget():
    # no explicit retry_budget: a master that is simply GONE must still
    # surface as MasterRetryExhausted (finite default transport budget),
    # not spin forever
    from paddle_tpu_torch.master.client import DEFAULT_TRANSPORT_RETRY_BUDGET

    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    port = lsock.getsockname()[1]
    lsock.close()                   # nothing listens here anymore
    sleeps = []
    with pytest.raises(MasterRetryExhausted):
        MasterClient(f"127.0.0.1:{port}", poll_interval_s=0.001,
                     sleep_fn=sleeps.append)
    assert len(sleeps) == DEFAULT_TRANSPORT_RETRY_BUDGET


def test_backoff_decorrelates_across_clients():
    # unseeded clients must NOT share a jitter sequence (a fleet in
    # lockstep would thunder back at a restarting master together)
    from paddle_tpu_torch.master.client import _Backoff

    s1, s2 = [], []
    b1 = _Backoff(0.01, 0.5, sleep_fn=s1.append)
    b2 = _Backoff(0.01, 0.5, sleep_fn=s2.append)
    for _ in range(8):
        b1.sleep()
        b2.sleep()
    assert s1 != s2


def test_concurrent_trainers_consume_each_record_once(tmp_path):
    """4 trainer threads over ONE TCP master: every record of the pass is
    delivered exactly once across the fleet (the reference's multi-trainer
    dispatch invariant, go/master/service.go todo/pending/done)."""
    import threading

    paths = []
    for i in range(3):
        p = str(tmp_path / f"c{i}.rio")
        recordio_write(p, [f"r-{i}-{j}".encode() for j in range(40)])
        paths.append(p)

    # pin BOTH leases long: the trainer TTL below and the task timeout
    # here — a CI pause past the default 60s task lease would requeue a
    # held task and spuriously fail the exactly-once assertion
    svc = Service(chunks_per_task=7, timeout_s=1e6)
    srv = MasterServer(service=svc).start()
    try:
        boot = MasterClient(srv.address)
        boot.set_dataset(paths)
        boot.close()

        got = []
        lock = threading.Lock()
        errs = []

        def worker():
            try:
                c = MasterClient(srv.address)
                c.register(ttl_s=1e6)
                while True:
                    rec = c.next_record()
                    if rec is None:
                        break
                    with lock:
                        got.append(rec)
                c.close()
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "worker thread hung"
        assert not errs, errs
        want = sorted(f"r-{i}-{j}".encode() for i in range(3)
                      for j in range(40))
        assert sorted(got) == want, (
            f"{len(got)} records delivered, {len(want)} expected "
            "(duplicates or losses under concurrency)")
    finally:
        srv.stop()


def test_zombie_token_heartbeat_rejected_end_to_end(dataset):
    """The lease-token fence, end-to-end through MasterClient.heartbeat:
    trainer A's lease lapses, trainer B reclaims the SAME slot number,
    and A's renewal — racing the reclamation with a stale token — must
    return False (A is a zombie: it re-registers, its in-flight task
    already requeued).  B's own heartbeat keeps working."""
    clk = FakeClock()
    svc = Service(chunks_per_task=1, timeout_s=10.0, time_fn=clk)
    a = MasterClient(None, service=svc)
    a.set_dataset(dataset)
    slot_a = a.register(ttl_s=5.0)
    task = svc.get_task(owner=slot_a)       # A holds a task lease too
    assert task is not None

    clk.t += 6.0                            # A's lease lapses silently
    b = MasterClient(None, service=svc)
    slot_b = b.register(ttl_s=5.0)
    assert slot_b == slot_a                 # the slot number is REUSED

    # the zombie's renewal races the reclamation: same slot, stale token
    assert a.heartbeat() is False
    # the client noticed it was declared dead and dropped its identity
    assert a._slot is None and a._token is None
    # the new owner is untouched by the zombie's attempt
    assert b.heartbeat() is True
    # A's task requeued when its lease expired — the next fetch re-serves
    # it instead of losing it
    ids = set()
    while True:
        t = svc.get_task(owner=slot_b)
        if t is None:
            break
        ids.add(t.id)
    assert task.id in ids


def test_lease_lapse_inside_inner_sweep_still_requeues(dataset):
    """A lease that lapses BETWEEN Service's own expiry sweep and the
    sweep LeaseTable runs internally (inside heartbeat/register/members)
    must still requeue the dead member's in-flight tasks promptly — the
    freed slot is not silently discarded by the inner sweep, leaving the
    task to the slow per-task timeout path."""
    class SteppingClock:
        # advances a little on EVERY read, like a real clock: that is
        # exactly what opens the window between the two sweeps
        def __init__(self):
            self.now = 0.0
            self.step = 0.0

        def __call__(self):
            self.now += self.step
            return self.now

    clk = SteppingClock()
    svc = Service(chunks_per_task=1, timeout_s=1000.0, time_fn=clk)
    svc.set_dataset(dataset)
    ttl = svc.lease_ttl_s                    # 3 * timeout_s = 3000
    slot_a, tok_a = svc.register()           # deadline_a = ttl
    slot_b, tok_b = svc.register()
    task = svc.get_task(owner=slot_a)
    assert task is not None
    clk.now = 10.0
    assert svc.heartbeat(slot_b, tok_b)      # B renews: deadline ~ttl+10

    # park just short of A's deadline and arm the per-read step so the
    # deadline falls between Service._expire_members (A still alive)
    # and the inner LeaseTable sweep (A lapsed)
    clk.now = ttl - 0.5
    clk.step = 0.3
    assert svc.heartbeat(slot_b, tok_b)      # B fine; A dies INSIDE here
    clk.step = 0.0

    assert svc.heartbeat(slot_a, tok_a) is False   # A is gone
    # the requeue happened inside that heartbeat call, not lazily later:
    # A's task is already back in todo with a failure charged
    assert task.id not in svc._pending
    assert svc._todo and svc._todo[0].id == task.id
    assert svc._todo[0].num_failures == 1


def test_lease_table_on_expire_fires_on_internal_sweeps():
    """The on_expire hook runs on EVERY sweep, including the ones
    register/heartbeat/members do internally, so no freed slot is ever
    dropped on the floor."""
    from paddle_tpu_torch.master import LeaseTable

    clk = FakeClock()
    freed = []
    lt = LeaseTable(ttl_s=5.0, time_fn=clk, on_expire=freed.append)
    slot, _tok = lt.register()
    clk.t += 6.0
    slot2, _tok2 = lt.register()             # internal sweep frees `slot`
    assert freed == [slot]
    assert slot2 == slot                     # and the slot is reusable


def test_lease_table_heartbeat_never_resurrects_expired_lease():
    """LeaseTable.heartbeat re-checks the deadline itself: a renewal
    arriving exactly when the lease lapsed is refused even though the
    slot has not been reclaimed by anyone yet."""
    from paddle_tpu_torch.master import LeaseTable

    clk = FakeClock()
    lt = LeaseTable(ttl_s=5.0, time_fn=clk)
    slot, token = lt.register()
    assert lt.heartbeat(slot, token) is True
    clk.t += 5.0                            # dl <= now: lapsed, unswept
    assert lt.heartbeat(slot, token) is False
    assert lt.members() == []
    # re-registering mints a fresh token on the same slot; the old token
    # stays dead forever
    slot2, token2 = lt.register()
    assert slot2 == slot
    assert lt.heartbeat(slot, token) is False
    assert lt.heartbeat(slot2, token2) is True
    assert lt.drop(slot2, token) is False   # stale token can't evict
    assert lt.drop(slot2, token2) is True


# ---------------------------------------------------------------------------
# parity with the JAX package's master
# ---------------------------------------------------------------------------


def _service_script(mod, paths):
    """One fixed sequence of Service calls; every observable result."""
    clock = FakeClock()
    svc = mod.Service(chunks_per_task=3, timeout_s=10.0, max_failures=2,
                      time_fn=clock)
    out = [svc.set_dataset(paths), svc.progress()]

    def got(t):
        return None if t is None else (t.id, t.epoch, t.num_failures, [
            (os.path.basename(c.path), c.offset, c.count) for c in t.chunks])

    a, tok_a = svc.register(ttl_s=5.0)
    b, tok_b = svc.register(ttl_s=1e6)
    out.append((a, b))
    ta = [svc.get_task(owner=a) for _ in range(2)]
    tb = [svc.get_task(owner=b) for _ in range(2)]
    out += [got(t) for t in ta + tb]
    out += [svc.task_finished(tb[0].id), svc.task_failed(tb[1].id),
            svc.task_finished(tb[0].id), svc.progress()]
    clock.t += 6.0                           # a's lease lapses
    out += [svc.heartbeat(a, tok_a), svc.heartbeat(b, tok_b),
            svc.members(), svc.progress()]
    while True:
        t = svc.get_task(owner=b)
        out.append(got(t))
        if t is None:
            break
        if t.id % 3 == 1 and t.num_failures == 0:
            svc.task_failed(t.id)
        else:
            svc.task_finished(t.id)
    out += [svc.all_done(), svc.progress()]
    svc.new_pass()
    out += [got(svc.get_task(owner=b)), svc.progress()]
    clock.t += 11.0                          # a pending task times out
    out += [got(svc.get_task(owner=b)), svc.progress(),
            svc.request_save_model(5.0), svc.request_save_model(5.0)]
    return out


def test_service_calls_match_jax(dataset):
    """The same calls on both packages' Service: the same task order,
    epochs, chunks, failures, memberships and progress."""
    assert _service_script(tmaster, dataset) == \
        _service_script(jmaster, dataset)


def test_client_records_and_dispatch_match_jax(dataset, tmp_path):
    def stream(mod):
        c = mod.MasterClient(service=mod.Service(chunks_per_task=4))
        c.set_dataset(dataset)
        recs = []
        for _ in range(2):                   # two passes
            c.begin_pass()
            while (r := c.next_record()) is not None:
                recs.append(r)
        return recs, c.progress()

    assert stream(tmaster) == stream(jmaster)
    svc_t, svc_j = tmaster.Service(), jmaster.Service()
    for method, params in (("set_dataset", {"paths": dataset}),
                           ("get_task", {"owner": None}), ("progress", {}),
                           ("task_finished", {"task_id": 0}),
                           ("all_done", {}), ("ping", None)):
        assert tmaster.service.dispatch(svc_t, method, params) == \
            jmaster.service.dispatch(svc_j, method, params)
    with pytest.raises(ValueError, match="unknown method"):
        dispatch(svc_t, "nope", {})


# ---------------------------------------------------------------------------
# tests/test_elastic_recovery.py's counterparts: membership and the
# elastic trainer
# ---------------------------------------------------------------------------


def test_register_assigns_smallest_free_slot():
    clk = FakeClock()
    svc = Service(time_fn=clk)
    (a, tok_a), (b, _), (c, tok_c) = (svc.register(), svc.register(),
                                      svc.register())
    assert (a, b, c) == (0, 1, 2)
    clk.t += 1.0
    assert svc.heartbeat(0, tok_a, ttl_s=1e6)
    assert svc.heartbeat(2, tok_c, ttl_s=1e6)
    clk.t += svc.lease_ttl_s  # b's lease lapses (0/2 renewed long)
    assert svc.heartbeat(0, tok_a, ttl_s=1e6)
    assert svc.heartbeat(2, tok_c, ttl_s=1e6)
    assert svc.members() == [0, 2]
    slot, token = svc.register()
    assert slot == 1
    assert not svc.heartbeat(5, "bogus"), "unknown slot must not heartbeat"
    assert not svc.heartbeat(1, "stale-token")
    assert svc.heartbeat(1, token)


def test_dead_trainer_tasks_requeue_to_front(tmp_path):
    clk = FakeClock()
    svc = Service(chunks_per_task=2, timeout_s=1e6, time_fn=clk)
    p = str(tmp_path / "data")
    recordio_write(p, [f"r{i}".encode() for i in range(8)])  # 4 tasks
    svc.set_dataset([p])
    dead, _ = svc.register(ttl_s=10.0)
    live, _ = svc.register(ttl_s=1e6)
    t0 = svc.get_task(owner=dead)
    t1 = svc.get_task(owner=live)
    assert t0.id == 0 and t1.id == 1
    clk.t += 11.0                        # dead's lease lapses
    nxt = svc.get_task(owner=live)       # requeued task 0 comes FIRST
    assert nxt.id == 0, "dead trainer's task must be redelivered first"
    assert svc.members() == [live]
    assert t1.id in svc._pending


@pytest.fixture
def f32():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _write_dataset(path, rng, n=96):
    """Linearly-separable records 'x1,...,x8|label'."""
    w = rng.randn(8)
    recs = []
    for _ in range(n):
        x = rng.randn(8).astype(np.float32)
        recs.append((",".join(f"{v:.6f}" for v in x)
                     + f"|{int(x @ w > 0)}").encode())
    recordio_write(path, recs)


def _parse(rec):
    xs, label = rec.decode().split("|")
    return (np.asarray([float(v) for v in xs.split(",")], np.float32),
            int(label))


class _Crash(Exception):
    """Injected trainer crash from an event handler."""


def _crash_at(event_type, batch_id):
    def handler(ev):
        if isinstance(ev, event_type) and ev.batch_id == batch_id:
            raise _Crash()

    return handler


def _make_sgd(weights=None):
    return tchaos._build_trainer(device="cpu", weights=weights)


def _params(sgd):
    return {k: sgd.parameters.get(k) for k in sgd.parameters.names()}


def _run_straight(svc, num_passes=1):
    sgd = _make_sgd()
    sgd.train(master=MasterClient(service=svc), record_parser=_parse,
              num_passes=num_passes, heartbeat_ttl_s=1e9)
    return _params(sgd)


def _crash_resume_case(tmp_path, clk, svc, crash_event, crash_batch,
                       num_passes=1, saving_period=1, tag=""):
    ck_dir = str(tmp_path /
                 f"ckpt_{crash_event.__name__}_{crash_batch}_{tag}")
    sgd_a = _make_sgd()
    with pytest.raises(_Crash):
        sgd_a.train(master=MasterClient(service=svc), record_parser=_parse,
                    num_passes=num_passes, save_dir=ck_dir,
                    heartbeat_ttl_s=10.0, saving_period=saving_period,
                    event_handler=_crash_at(crash_event, crash_batch))
    clk.t += 11.0   # A's lease lapses -> its in-flight task refronts
    sgd_b = _make_sgd()
    sgd_b.train(master=MasterClient(service=svc), record_parser=_parse,
                num_passes=num_passes, save_dir=ck_dir,
                heartbeat_ttl_s=1e9, saving_period=saving_period)
    return _params(sgd_b)


def _assert_same(got, want, msg):
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")


def test_kill_trainer_resume_parity(tmp_path):
    """Crash/resume through SGD.train(master=...): trainer A dies
    mid-pass (holding a task it never stepped, and after a checkpoint but
    before its ack), its lease lapses, trainer B resumes from the
    checkpoint: the same bits as a straight run."""
    rng = np.random.RandomState(0)
    data_path = str(tmp_path / "train.recordio")
    _write_dataset(data_path, rng)
    clk = FakeClock()

    def fresh():
        svc = Service(chunks_per_task=16, timeout_s=1e6, time_fn=clk)
        svc.set_dataset([data_path])   # 96 recs / 16 = 6 tasks
        return svc

    ref = _run_straight(fresh())
    _assert_same(_crash_resume_case(tmp_path, clk, fresh(),
                                    tpaddle.event.BeginIteration, 2),
                 ref, "begin-crash")
    _assert_same(_crash_resume_case(tmp_path, clk, fresh(),
                                    tpaddle.event.EndIteration, 1),
                 ref, "end-crash")


def test_elastic_multipass_and_periodic_checkpoint_parity(tmp_path):
    rng = np.random.RandomState(1)
    data_path = str(tmp_path / "train.recordio")
    _write_dataset(data_path, rng)
    clk = FakeClock()

    def fresh():
        svc = Service(chunks_per_task=16, timeout_s=1e6, time_fn=clk)
        svc.set_dataset([data_path])   # 6 tasks/pass
        return svc

    ref2 = _run_straight(fresh(), num_passes=2)
    svc = fresh()

    def crash_in_pass1(ev):
        if isinstance(ev, tpaddle.event.BeginIteration) \
                and ev.pass_id == 1 and ev.batch_id == 1:
            raise _Crash()

    ck_dir = str(tmp_path / "ckpt_mp")
    sgd_a = _make_sgd()
    with pytest.raises(_Crash):
        sgd_a.train(master=MasterClient(service=svc), record_parser=_parse,
                    num_passes=2, save_dir=ck_dir, heartbeat_ttl_s=10.0,
                    event_handler=crash_in_pass1)
    clk.t += 11.0
    sgd_b = _make_sgd()
    sgd_b.train(master=MasterClient(service=svc), record_parser=_parse,
                num_passes=2, save_dir=ck_dir, heartbeat_ttl_s=1e9)
    _assert_same(_params(sgd_b), ref2, "multipass")

    ref1 = _run_straight(fresh(), num_passes=1)
    got = _crash_resume_case(tmp_path, clk, fresh(),
                             tpaddle.event.BeginIteration, 3,
                             saving_period=2, tag="sp2")
    _assert_same(got, ref1, "period2")


def test_elastic_train_matches_jax(tmp_path, f32):
    """Two passes through SGD.train(master=...) in both packages from the
    JAX classifier's weights, the same tasks in the same order: the same
    parameters within the f32 bound."""
    data_path = str(tmp_path / "train.recordio")
    _write_dataset(data_path, np.random.RandomState(2), n=64)
    j = jchaos._build_trainer(seed=5)
    weights = {k: np.asarray(j.parameters[k]) for k in j.parameters.names()}
    t = _make_sgd(weights)
    for sgd, mod in ((j, jmaster), (t, tmaster)):
        svc = mod.Service(chunks_per_task=8, timeout_s=1e6)
        svc.set_dataset([data_path])
        sgd.train(master=mod.MasterClient(service=svc), record_parser=_parse,
                  num_passes=2, heartbeat_ttl_s=1e9)
    got = _params(t)
    for k in weights:
        np.testing.assert_allclose(got[k], np.asarray(j.parameters[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
