"""The master's lease table (``LeaseTable`` of
``paddle_tpu/master/service.py``, copied: it is pure Python).  The serving
fleet's replica lifecycle runs on it.  The rest of the master — the task
queue service, its client and the recordio chunking — is not ported yet
(ROADMAP A13)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

__all__ = ["LeaseTable"]


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
