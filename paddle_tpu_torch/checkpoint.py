"""Checkpoint/resume with optimizer state (the port of
``paddle_tpu/checkpoint.py``).

Layout per checkpoint, the JAX package's::

    <dir>/pass-00007/
        params.tar      # weights (Parameters.to_tar's format)
        state.pkl       # optimizer slots + model state (numpy trees)
        meta.json       # pass id, md5 of both blobs, timestamp, cursor

``state.pkl`` pickles numpy trees, never tensors: the optimizer state in
the JAX package's layout (``{"step": int32[], "slots": {slot: {name:
array}}, ...}``, :func:`paddle_tpu_torch.convert.opt_state_to_numpy`) and
the model state as ``{layer: {slot: array}}``.  So each package reads the
other's checkpoints.  numpy has no bfloat16: a bf16 tensor in the state
raises (every state the port trains is float32).

Commit protocol (tmp+rename, made kill-precise):

1. ``params.tar`` is written to a tempfile and renamed into place;
2. ``state.pkl`` likewise;
3. ``meta.json`` — carrying the md5 of both blobs, computed by reading
   each blob back (the two on a thread each) — is written LAST, again
   tmp+rename.

A checkpoint exists only once its meta commits: a kill at any earlier
point leaves a meta-less dir that every reader skips (the previous
checkpoint stays ``latest``), and a kill mid-prune or a torn blob is
caught by the md5 verify and rejected with a grep-able ``CKPT-CORRUPT``
line instead of crashing the resume.

The save is split in two halves so a background writer can own the slow
one (:class:`paddle_tpu_torch.resilience.AsyncCheckpointer`):

- :func:`snapshot_checkpoint` — the device -> host copy, the only part
  that must stall training.  The port's step updates its tensors in
  place, so the snapshot is a finished host copy (never a view, never a
  copy still in flight) before the next step runs; with
  :class:`HostBuffers` it lands in pinned buffers that are reused from
  save to save;
- :func:`write_checkpoint` — pure disk I/O over the host snapshot,
  thread-safe, honoring the commit protocol above.

``extra_meta`` may carry a ``cursor`` dict (pass id, step-in-pass, global
step) — the step-granular resume contract ``trainer.SGD.train(resume=True)``
reads back.  The JAX package's cursor also holds its PRNG key (``rng``);
the port has none (a step's dropout seed comes from the ``seed`` flag and
the optimizer's step count, which the state carries), so it writes no
key and ignores one on read.

The disk phases time themselves into the ``platform.stats`` timers
``checkpoint_write`` (the two blobs), ``checkpoint_md5`` (hashing them
after a write), ``checkpoint_verify`` (the md5 read-back of a verify)
and ``checkpoint_read`` (a load's reads).

``shard_plan`` (a :class:`~paddle_tpu_torch.parallel.zero.ZeroPlan`):
the snapshot all-gathers ZeRO-1's flat slot chunks back to whole
parameter shapes (a collective: every rank of the plan's axis takes the
snapshot), so the file is the same whatever the layout and a run saved
on N ranks resumes on M; the plan's ``shard_state`` cuts a loaded state
again.  The trainer gathers the other split weights itself and writes
from the mesh's first rank only, sync or async: an async write runs on
that rank's writer thread, and every rank of the mesh meets the writer
at a barrier once it has waited the write out, when ``train()`` returns
and before a resume reads, so no rank reads a checkpoint before it is
committed.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.convert import map_tree, check_saveable
from paddle_tpu_torch.parameters import Parameters, write_tar
from paddle_tpu_torch.platform.device import DeviceLike
from paddle_tpu_torch.platform import stats
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that

_PASS_RE = re.compile(r"^pass-(\d{5})$")

# write_checkpoint announces these phases to its commit_hook, in order;
# a fault plan killing at "meta" simulates the classic torn save: both
# blobs durable, meta missing, previous checkpoint still latest
COMMIT_PHASES = ("params", "state", "meta", "done")

def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _md5_both(paths: List[str]) -> List[Optional[str]]:
    """The md5s of ``paths`` (the two blobs), read back and hashed on a
    thread each (hashlib releases the GIL over large chunks); None for a
    path that does not exist."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        futs = [pool.submit(_md5, p) if os.path.exists(p) else None
                for p in paths]
        return [f.result() if f is not None else None for f in futs]


def _atomic_write(path: str, writer) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def pass_dir(root: str, pass_id: int) -> str:
    return os.path.join(root, f"pass-{pass_id:05d}")


# ---------------------------------------------------------------------------
# snapshot (device -> host) / write (host -> disk) split
# ---------------------------------------------------------------------------


class HostBuffers:
    """Pinned host tensors reused across snapshots (one per tree path).

    Owned by one depth-one pipeline (the :class:`AsyncCheckpointer`): a
    snapshot overwrites the buffers only after the write of the previous
    one has ended, so a snapshot's arrays stay valid until the next
    snapshot into the same buffers."""

    def __init__(self):
        self._bufs: Dict[Tuple, torch.Tensor] = {}

    def copy(self, key: Tuple, t: torch.Tensor) -> np.ndarray:
        buf = self._bufs.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._bufs[key] = buf
        buf.copy_(t.detach())      # synchronous: the copy has landed
        return buf.numpy()


@dataclass
class HostCheckpoint:
    """A fully host-resident checkpoint payload: everything
    :func:`write_checkpoint` needs, holding NO device tensor and no view
    of a live one — safe to hand to a background writer thread while the
    training loop keeps updating its tensors in place."""

    params: Dict[str, np.ndarray]
    opt_state: Any = None
    model_state: Any = None

    def nbytes(self) -> int:
        total = [0]

        def count(v, path):
            if isinstance(v, np.ndarray):
                total[0] += v.nbytes

        map_tree(count, [self.params, self.opt_state, self.model_state])
        return total[0]


def _host_tree(tree, root: str, buffers: Optional[HostBuffers]):
    """Host copies of a tree's tensors (into ``buffers`` for device
    tensors when given); the optimizer's ``"step"`` becomes the JAX
    package's int32 0-d array."""
    def leaf(v, path):
        if isinstance(v, torch.Tensor):
            check_saveable(v, "/".join(map(str, (root,) + path)))
            if buffers is not None and v.device.type == "cuda":
                return buffers.copy((root,) + path, v)
            return v.detach().to("cpu", copy=True).numpy()
        if root == "opt_state" and path == ("step",):
            return np.asarray(v, np.int32)
        return v if v is None else np.asarray(v)

    return None if tree is None else map_tree(leaf, tree)


def snapshot_checkpoint(parameters, opt_state: Any = None,
                        model_state: Any = None, shard_plan: Any = None,
                        buffers: Optional[HostBuffers] = None
                        ) -> HostCheckpoint:
    """Device -> host copy of the full training state (the only phase of
    an async save that stalls the train loop).  Each copy has landed when
    this returns.  ``buffers``: pinned buffers to copy device tensors
    into, reused across snapshots (see :class:`HostBuffers`).
    ``shard_plan``: ZeRO-1 slot chunks are gathered to whole tensors."""
    if shard_plan is not None and opt_state is not None:
        enforce_that(hasattr(shard_plan, "gather_state"),
                     "shard_plan takes a parallel.zero.ZeroPlan, got "
                     f"{type(shard_plan).__name__}", context="checkpoint")
        opt_state = shard_plan.gather_state(opt_state)
    params = parameters.as_dict() if hasattr(parameters, "as_dict") \
        else dict(parameters)
    return HostCheckpoint(params=_host_tree(params, "params", buffers),
                          opt_state=_host_tree(opt_state, "opt_state",
                                               buffers),
                          model_state=_host_tree(model_state, "model_state",
                                                 buffers))


def write_checkpoint(root: str, pass_id: int, host: HostCheckpoint,
                     extra_meta: Optional[Dict] = None,
                     commit_hook: Optional[Callable[[str], None]] = None
                     ) -> str:
    """Write a host snapshot to ``pass_dir(root, pass_id)`` under the
    tmp+rename+md5 commit protocol (meta.json LAST — see module doc).
    Pure disk I/O: thread-safe against a training loop that keeps
    running, and re-entrant over a torn dir from an earlier kill (the
    same pass id simply overwrites the debris).

    ``commit_hook`` is called with each :data:`COMMIT_PHASES` name just
    BEFORE that phase's write ("done" fires after the meta commit) — the
    fault-injection seam ``TrainFaultPlan.save_hook`` uses to kill a
    save at a chosen point."""
    hook = commit_hook if commit_hook is not None else (lambda phase: None)
    d = pass_dir(root, pass_id)
    os.makedirs(d, exist_ok=True)
    params_path = os.path.join(d, "params.tar")
    state_path = os.path.join(d, "state.pkl")
    with stats.timer("checkpoint_write"):
        hook("params")
        _atomic_write(params_path,
                      lambda f: write_tar(host.params.items(), f))
        hook("state")
        # protocol 5 writes the arrays' buffers without an extra copy;
        # any pickle reader loads it
        _atomic_write(state_path, lambda f: pickle.dump(
            {"opt_state": host.opt_state,
             "model_state": host.model_state}, f, protocol=5))
    with stats.timer("checkpoint_md5"):
        params_md5, state_md5 = _md5_both([params_path, state_path])
    meta = {"pass_id": pass_id,
            "params_md5": params_md5,
            "state_md5": state_md5,
            "timestamp": time.time()}
    meta.update(extra_meta or {})
    hook("meta")
    _atomic_write(os.path.join(d, "meta.json"),
                  lambda f: f.write(json.dumps(meta).encode()))
    hook("done")
    return d


def save_checkpoint(root: str, pass_id: int, parameters,
                    opt_state: Any = None, model_state: Any = None,
                    extra_meta: Optional[Dict] = None,
                    shard_plan: Any = None,
                    commit_hook: Optional[Callable[[str], None]] = None
                    ) -> str:
    """Synchronous save: snapshot + write in one call (the
    AsyncCheckpointer calls the two halves itself)."""
    return write_checkpoint(
        root, pass_id,
        snapshot_checkpoint(parameters, opt_state=opt_state,
                            model_state=model_state, shard_plan=shard_plan),
        extra_meta=extra_meta, commit_hook=commit_hook)


# ---------------------------------------------------------------------------
# verify / load / prune
# ---------------------------------------------------------------------------


def _pass_ids(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(root)
                  if (m := _PASS_RE.match(name)))


# committed checkpoint dirs are immutable (same-id rewrites go through
# tmp+rename, changing inode mtimes), so a successful verify is cached
# by the three files' stat signature — repeat prunes/loads over the
# same artifacts skip the full md5 read-back.  Only SUCCESS is cached:
# failures are cheap to recompute and may be fixed by an overwrite.
_VERIFY_OK_CACHE: Dict[str, Tuple] = {}


def _stat_sig(d: str) -> Optional[Tuple]:
    try:
        sig = []
        for name in ("meta.json", "params.tar", "state.pkl"):
            st = os.stat(os.path.join(d, name))
            sig.append((name, st.st_size, st.st_mtime_ns))
        return tuple(sig)
    except OSError:
        return None


def verify_pass_dir(root: str, pass_id: int) -> Optional[str]:
    """Integrity check of one checkpoint dir, runnable without loading.
    Returns None when the artifact is intact, else a short reason string:
    missing/corrupt meta.json (a kill before the meta commit), or a
    missing/torn blob (a torn prune, a partially-synced copy)."""
    d = pass_dir(root, pass_id)
    sig = _stat_sig(d)
    if sig is not None and _VERIFY_OK_CACHE.get(d) == sig:
        return None
    meta_path = os.path.join(d, "meta.json")
    if not os.path.exists(meta_path):
        return "missing meta.json"
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return "corrupt meta.json"
    blobs = (("params.tar", "params_md5"), ("state.pkl", "state_md5"))
    with stats.timer("checkpoint_verify"):
        digests = _md5_both([os.path.join(d, b) for b, _ in blobs])
    for (blob, key), digest in zip(blobs, digests):
        if key not in meta:
            return f"meta.json missing {key}"
        if not os.path.exists(os.path.join(d, blob)):
            return f"missing {blob}"
        if digest != meta[key]:
            return f"md5 mismatch on {blob}"
    if sig is not None:
        if len(_VERIFY_OK_CACHE) > 256:
            _VERIFY_OK_CACHE.clear()
        _VERIFY_OK_CACHE[d] = sig
    return None


def _report_corrupt(d: str, reason: str) -> None:
    # grep-able: the resilience checker (python -m
    # paddle_tpu_torch.resilience check) counts these lines
    print(f"CKPT-CORRUPT: {d} ({reason})", flush=True)


def latest_pass(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = _PASS_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, "meta.json")):
            p = int(m.group(1))
            best = p if best is None else max(best, p)
    return best


def prune_checkpoints(root: str, keep: int = 2) -> None:
    """Delete old checkpoints, never the newest VERIFIED one: only dirs
    that pass :func:`verify_pass_dir` count toward ``keep``, so corrupt
    young dirs (a torn prune, a kill-during-save) cannot cause the only
    good artifact to be reaped.  Unverified dirs NEWER than the oldest
    kept verified checkpoint are left alone too (they may be saves in
    flight); older debris is swept.  With no verified dir at all the
    id-order rule applies (nothing is provably better than anything
    else)."""
    import shutil

    ids = _pass_ids(root)
    if not ids:
        return
    if keep <= 0:
        victims = ids
    else:
        # newest-first with early stop: verification runs only until
        # `keep` intact dirs are found — old dirs below the cut are
        # deleted without ever being hashed
        kept: List[int] = []
        for pid in reversed(ids):
            if verify_pass_dir(root, pid) is None:
                kept.append(pid)
                if len(kept) >= keep:
                    break
        if not kept:
            victims = ids[:-keep]
        else:
            cut = kept[-1]
            victims = [pid for pid in ids if pid < cut]
    for pid in victims:
        _VERIFY_OK_CACHE.pop(pass_dir(root, pid), None)
        shutil.rmtree(pass_dir(root, pid), ignore_errors=True)


def _read_checkpoint(d: str, device: DeviceLike
                     ) -> Tuple[Parameters, Any, Any, Dict]:
    with stats.timer("checkpoint_read"):
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(d, "params.tar"), "rb") as f:
            params = Parameters.from_tar(f, device=device)
        with open(os.path.join(d, "state.pkl"), "rb") as f:
            st = pickle.load(f)
    return params, st["opt_state"], st["model_state"], meta


def load_latest(root: str, device: DeviceLike = None
                ) -> Optional[Tuple[Parameters, Any, Any, Dict]]:
    """Newest INTACT checkpoint under ``root``, or None when no usable
    one exists.  Walks newest -> oldest: a dir whose meta never
    committed (kill-during-save) is skipped silently — that is the
    commit protocol working as designed — while a meta-bearing dir with
    missing/torn blobs is rejected with a ``CKPT-CORRUPT`` line and the
    walk falls back to the next-older artifact instead of crashing the
    resume.  See :func:`load_checkpoint` for what it returns."""
    for pid in reversed(_pass_ids(root)):
        reason = verify_pass_dir(root, pid)
        if reason is None:
            return _read_checkpoint(pass_dir(root, pid), device)
        if reason != "missing meta.json":
            _report_corrupt(pass_dir(root, pid), reason)
    return None


def load_checkpoint(root: str, pass_id: Optional[int] = None,
                    device: DeviceLike = None
                    ) -> Tuple[Parameters, Any, Any, Dict]:
    """Returns (parameters, opt_state, model_state, meta), md5-verified:
    the parameters on ``device`` (``cuda`` unless asked), the two states
    as the numpy trees the file holds (the JAX package's layout;
    ``convert.opt_state_from_numpy``/``state_from_numpy`` make them the
    port's, as ``SGD.apply_checkpoint`` does).  With ``pass_id=None``
    the newest intact checkpoint wins — corrupt dirs are rejected with a
    ``CKPT-CORRUPT`` line and the next-older artifact is used.  An
    EXPLICIT ``pass_id`` that fails verification raises (the caller
    asked for that artifact specifically; silently substituting another
    would resume from the wrong state)."""
    if pass_id is None:
        got = load_latest(root, device)
        enforce_that(got is not None,
                     f"no intact checkpoints under {root}",
                     context="checkpoint")
        return got
    d = pass_dir(root, pass_id)
    reason = verify_pass_dir(root, pass_id)
    if reason is not None:
        _report_corrupt(d, reason)
        raise EnforceError(f"CKPT-CORRUPT: corrupt checkpoint {d} "
                           f"({reason})", context="checkpoint")
    return _read_checkpoint(d, device)
