"""Page-migration plane: live KV handoff between ServingEngine replicas
(the port of ``paddle_tpu/serving/migrate.py``), for the disaggregated
prefill/decode fleet.

A request's KV state is already self-describing at page granularity —
the paged pool gives every sequence an explicit page table with
refcounts, int8 pages carry their scales beside them, and the
:class:`~paddle_tpu_torch.serving.kv_cache.PrefixCache` keys full pages by a
chained block hash that is identical on every replica.  This module
turns that into a transfer plane:

- :func:`export_chain` serializes one RUNNING request's whole chain —
  K/V page tensors as STORED (no re-quantization: an int8 page moves as
  int8 bytes plus its f32 scales, (D + 4) / 4D of the f32 bytes), the token
  stream, the chain-hash cursor, and sampling/position state — into a
  host-side :class:`MigrationBlob`;
- :func:`import_chain` splices a blob into ANOTHER engine: pages
  allocated at refcount 1 through the scheduler's normal seam (cache
  eviction relief included), payload written into the pool in place
  (``kv_cache.write_pages``: uploads ordered on the current stream, ahead
  of the destination's next step), the request registered directly
  into a free slot as a decoding (non-prefilling) sequence, and its
  full pages re-inserted into the destination's PrefixCache so the
  migrated prefix is immediately hittable;
- :func:`export_prefix` / :func:`import_prefix` move just a CACHED
  prefix between replicas (cross-replica seeding): only the blocks the
  destination does not already hold are transferred, the spliced pages
  are inserted into the destination cache and then parked at
  refcount 0 (RECLAIMABLE) — an opportunistic warm, never a holder.

Because both halves run through the ordinary PagePool/PrefixCache
bookkeeping (alloc/ref/free/mark_cached), the existing PAGE/REF-LEAK
conservation checks keep holding on BOTH pools mid-migration.
:func:`check_migration_conservation` adds the fleet-level half: every
started migration ends exactly one way (applied, fallback, or aborted),
no transfer is left pending at drain, and every replica's incremental
``prefill_backlog_tokens`` probe matches its ground-truth recompute.
Violations raise :class:`~paddle_tpu_torch.serving.faults.PageLeakError`
tagged ``MIGRATE-LEAK``, and ``python -c "...migrate.main(['check'])"``
replays a seeded disaggregated chaos trace as a standalone gate.

The blob's payload is host memory: CPU tensors from ``read_pages``
(pinned when read from a CUDA pool), since numpy has no bfloat16.  Its
``head_dim`` is the model's; the payload's last dimension is the pool's
``pool_head_dim`` (the head dim padded to a multiple of 8), and the
geometry check compares both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from paddle_tpu_torch.platform.device import DeviceLike
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.serving.faults import PageLeakError
from paddle_tpu_torch.serving.kv_cache import _nbytes, read_pages
from paddle_tpu_torch.serving.scheduler import Request, RequestStatus

__all__ = ["MigrationBlob", "export_chain", "import_chain",
           "export_prefix", "import_prefix",
           "check_migration_conservation", "main"]


@dataclass
class MigrationBlob:
    """A self-describing host-side page-chain snapshot.

    Geometry fields pin the pool layout the payload was read from; the
    importer refuses a mismatched engine rather than splicing garbage.
    ``k``/``v`` are ``[L, P, page, H_kv, pool_head_dim]`` host tensors
    in the pool's STORED dtype; ``k_scale``/``v_scale`` ride along
    (``[L, P, page, H_kv]`` f32) for quantized pools and are None
    otherwise.
    """

    kind: str                      # "chain" (live request) | "prefix"
    page_size: int
    num_layers: int
    kv_heads: int
    head_dim: int                  # the model's head dim
    pool_head_dim: int             # the payload's (padded) last dim
    kv_dtype: str                  # stored dtype name, e.g. "int8"
    quantized: bool
    # request / prefix state
    prompt: List[int]
    generated: List[int]
    max_tokens: int
    cache_len: int                 # tokens materialized in the payload
    sampling: Optional[object] = None
    deadline_at: Optional[float] = None
    chain_blocks: int = 0          # PrefixCache hash cursor at export
    chain_hash: Optional[int] = None
    # tenant identity: a migrated chain keeps billing to its
    # original tenant on the destination — SLO deadlines, quotas and
    # preemption precedence follow the request across replicas
    tenant: str = "default"
    # page payload
    k: object = None
    v: object = None
    k_scale: object = None
    v_scale: object = None

    @property
    def num_pages(self) -> int:
        return 0 if self.k is None else int(self.k.shape[1])

    @property
    def nbytes(self) -> int:
        """Interconnect bytes this blob costs: payload arrays only (the
        token/cursor metadata is noise next to page tensors)."""
        return sum(_nbytes(a) for a in (self.k, self.v, self.k_scale,
                                        self.v_scale) if a is not None)


def _geometry_of(engine) -> Tuple[int, int, int, int, int, str, bool]:
    cfg = engine.kv_cfg
    return (cfg.page_size, cfg.num_layers, cfg.kv_heads, cfg.head_dim,
            cfg.pool_head_dim, str(cfg.dtype).replace("torch.", ""),
            cfg.quantized)


def _check_geometry(engine, blob: MigrationBlob) -> None:
    page, layers, kv_heads, head_dim, pool_d, dtype, quant = \
        _geometry_of(engine)
    enforce_that(
        (blob.page_size, blob.num_layers, blob.kv_heads, blob.head_dim,
         blob.pool_head_dim, blob.kv_dtype, blob.quantized) ==
        (page, layers, kv_heads, head_dim, pool_d, dtype, quant),
        f"migration blob geometry (page={blob.page_size} L={blob.num_layers}"
        f" H_kv={blob.kv_heads} D={blob.head_dim} "
        f"pool_D={blob.pool_head_dim} dtype={blob.kv_dtype}) "
        f"does not match the destination pool (page={page} L={layers} "
        f"H_kv={kv_heads} D={head_dim} pool_D={pool_d} dtype={dtype})",
        context="serving-migrate")


# ---------------------------------------------------------------------------
# chain handoff: a live decoding request moves engines whole
# ---------------------------------------------------------------------------


def export_chain(engine, rid: int) -> MigrationBlob:
    """Snapshot request ``rid``'s page chain off ``engine`` into a
    host blob.  The request must be migration-eligible (RUNNING, prefill
    fully materialized, first token emitted — see
    ``ServingEngine.migratable_rids``); the source keeps running, so the
    export is a pure read and the caller decides when (if ever) to
    cancel the source copy."""
    req = engine._requests[rid]
    enforce_that(req.status is RequestStatus.RUNNING and
                 not req.prefilling and bool(req.generated),
                 f"rid {rid} is not migration-eligible "
                 f"(status={req.status} prefilling={req.prefilling} "
                 f"generated={len(req.generated)})",
                 context="serving-migrate")
    page, layers, kv_heads, head_dim, pool_d, dtype, quant = \
        _geometry_of(engine)
    n = -(-req.cache_len // page)          # pages covering cache_len
    k, v, k_scale, v_scale = read_pages(engine._kv, req.pages[:n])
    return MigrationBlob(
        kind="chain", page_size=page, num_layers=layers,
        kv_heads=kv_heads, head_dim=head_dim, pool_head_dim=pool_d,
        kv_dtype=dtype,
        quantized=quant, prompt=list(req.prompt),
        generated=list(req.generated), max_tokens=req.max_tokens,
        cache_len=req.cache_len, sampling=req.sampling,
        deadline_at=req.deadline_at, chain_blocks=req.chain_blocks,
        chain_hash=req.chain_hash, tenant=req.tenant, k=k, v=v,
        k_scale=k_scale, v_scale=v_scale)


def import_chain(engine, blob: MigrationBlob, *, on_token=None,
                 now: Optional[float] = None) -> Optional[int]:
    """Splice a chain blob into ``engine`` as a live decoding request.

    Returns the new engine rid, or None when the destination cannot
    host it right now (no free slot, or the page allocation — after
    cache-eviction relief — comes up short); the caller retries later
    or falls back to a re-prefill.  On success the request holds its
    pages at refcount 1 like any admitted sequence (so the existing
    PAGE/REF-LEAK conservation holds unchanged), its full pages are
    re-inserted into the destination PrefixCache, and the next engine
    tick decodes it — no prefill, no queue wait."""
    _check_geometry(engine, blob)
    enforce_that(blob.kind == "chain", "import_chain needs a chain blob",
                 context="serving-migrate")
    now = engine._time() if now is None else now
    sched = engine.scheduler
    cfg = engine.kv_cfg
    if len(blob.prompt) + blob.max_tokens > cfg.max_seq_len:
        return None                      # destination could never run it
    if not sched._free_slots:
        return None
    # charge cache_len + 1, exactly like admission: the freshly-imported
    # request must not become a growth victim on its very first tick
    total = -(-(blob.cache_len + 1) // cfg.page_size)
    if total > cfg.max_pages_per_seq:
        return None
    pages = sched.alloc_pages(total)
    if pages is None:
        return None
    engine.apply_imported_pages(pages[:blob.num_pages], blob.k, blob.v,
                                blob.k_scale, blob.v_scale)
    req = Request(prompt=list(blob.prompt), max_tokens=blob.max_tokens,
                  on_token=on_token, sampling=blob.sampling,
                  tenant=blob.tenant)
    req.generated = list(blob.generated)
    req.pages = pages
    req.cache_len = blob.cache_len
    req.status = RequestStatus.RUNNING
    req.prefilling = False
    req.deadline_at = blob.deadline_at
    req.submitted_at = now
    req.admitted_at = now
    req.first_token_at = now             # its first token landed upstream
    req.last_progress_tick = engine._tick
    req.slot = sched._free_slots.pop()
    sched.running[req.slot] = req
    sched._backlog_enter(req)            # contributes 0 (prefill is done)
    engine._requests[req.rid] = req
    if engine.cache is not None:
        # full pages become hittable HERE immediately; idempotent insert
        # keeps any entry the destination already owns (our page for
        # that block simply stays uncached — the request holds it)
        req.chain_hash, req.chain_blocks = engine.cache.insert(
            req.cache_tokens, req.pages, req.cache_len)
    engine._tracer.instant("import_chain", rid=req.rid,
                           pages=blob.num_pages, tokens=blob.cache_len)
    return req.rid


# ---------------------------------------------------------------------------
# prefix seeding: a cached prefix warms a peer replica's cache
# ---------------------------------------------------------------------------


def export_prefix(engine, tokens: Sequence[int]) -> Optional[MigrationBlob]:
    """Snapshot the longest CACHED full-page prefix of ``tokens`` from
    ``engine``'s PrefixCache into a prefix blob (pure read — refcounts
    untouched).  None when the engine caches nothing useful."""
    if engine.cache is None:
        return None
    page, layers, kv_heads, head_dim, pool_d, dtype, quant = \
        _geometry_of(engine)
    hit_pages, hit_len = engine.cache.lookup(list(tokens))
    blocks = hit_len // page
    if blocks == 0:
        return None
    k, v, k_scale, v_scale = read_pages(engine._kv, hit_pages[:blocks])
    covered = [int(t) for t in tokens[:blocks * page]]
    return MigrationBlob(
        kind="prefix", page_size=page, num_layers=layers,
        kv_heads=kv_heads, head_dim=head_dim, pool_head_dim=pool_d,
        kv_dtype=dtype,
        quantized=quant, prompt=covered, generated=[], max_tokens=0,
        cache_len=blocks * page, k=k, v=v, k_scale=k_scale,
        v_scale=v_scale)


def import_prefix(engine, blob: MigrationBlob) -> Tuple[int, int]:
    """Seed ``engine``'s PrefixCache from a prefix blob.  Only blocks
    the destination does not already verify locally are spliced (chains
    are prefix-closed, so the missing blocks are exactly the tail);
    the new pages are inserted as cached and then freed to refcount 0 —
    parked RECLAIMABLE, evictable under pressure like any cached page.
    Returns ``(blocks_seeded, payload_bytes_transferred)``; ``(0, 0)``
    when the destination already covers the prefix or has no room."""
    if engine.cache is None:
        return 0, 0
    _check_geometry(engine, blob)
    enforce_that(blob.kind == "prefix", "import_prefix needs a prefix blob",
                 context="serving-migrate")
    page = blob.page_size
    tokens = blob.prompt
    total_blocks = blob.cache_len // page
    dest_pages, dest_len = engine.cache.lookup(tokens)
    start = dest_len // page
    if start >= total_blocks:
        return 0, 0
    need = total_blocks - start
    new = engine.scheduler.alloc_pages(need)
    if new is None:
        return 0, 0
    payload = [None if a is None else a[:, start:total_blocks]
               for a in (blob.k, blob.v, blob.k_scale, blob.v_scale)]
    engine.apply_imported_pages(new, *payload)
    full = list(dest_pages[:start]) + new
    engine.cache.insert(tokens, full, total_blocks * page)
    # insert marked the pages it actually took as cached; free() parks
    # those at refcount 0 (RECLAIMABLE) and returns any it did NOT take
    # (a racing identical entry) straight to the free list — no leak
    # either way
    engine.pool.free(new)
    nbytes = sum(_nbytes(a) for a in payload if a is not None)
    engine._tracer.instant("import_prefix", blocks=need, bytes=nbytes)
    return need, nbytes


# ---------------------------------------------------------------------------
# conservation
# ---------------------------------------------------------------------------


def check_migration_conservation(router) -> None:
    """Migration-plane conservation over a (drained) fleet.  Raises
    :class:`PageLeakError` tagged ``MIGRATE-LEAK`` when:

    - the migration ledger does not balance: every started chain
      handoff must end exactly one way,
      ``migrations_started == applied + fallbacks + aborted``;
    - a chain transfer is still pending after its fleet request
      finished (an in-flight migration that can never resolve);
    - any replica's incremental ``prefill_backlog_tokens`` probe has
      drifted from its ground-truth recompute (the O(1) number the
      router balances on would be lying).
    """
    problems: List[str] = []
    m = router.metrics
    ended = (m.migrations_applied + m.migration_fallbacks +
             m.migrations_aborted)
    if m.migrations_started != ended:
        problems.append(
            f"migration ledger unbalanced: started={m.migrations_started} "
            f"!= applied={m.migrations_applied} + "
            f"fallbacks={m.migration_fallbacks} + "
            f"aborted={m.migrations_aborted}")
    pending = getattr(router, "_mig_pending", {})
    if pending:
        problems.append(f"{len(pending)} chain transfers still pending "
                        f"(frids {sorted(pending)})")
    for rep in router.replicas:
        sched = rep.engine.scheduler
        got = sched.prefill_backlog_tokens
        want = sched.recompute_backlog()
        if got != want:
            problems.append(f"replica {rep.idx}: prefill_backlog_tokens="
                            f"{got} but recompute says {want}")
    if problems:
        if "MIGRATE-LEAK" not in router._postmortems_dumped:
            router._postmortems_dumped.add("MIGRATE-LEAK")
            router.tracer.dump_postmortem("MIGRATE-LEAK")
        raise PageLeakError("MIGRATE-LEAK: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# standalone gate: python -c "...migrate.main(['check'])"
# ---------------------------------------------------------------------------


def _selfcheck(device: DeviceLike = None) -> int:
    """Replay a seeded disaggregated trace — 2 prefill + 2 decode
    replicas, shared system prefix, one injected decode-replica kill,
    one scheduled in-flight blob drop, a second submission wave once
    owners exist (so affinity seeding fires) — then run the migration
    AND fleet conservation checks, on ``device`` (default ``cuda``) —
    the JAX package's MIGRATE-LEAK gate.  Returns 0 (clean) or 1
    (findings); a crash propagates as 2."""
    import numpy as np

    from paddle_tpu_torch.serving._gate import gate_model
    from paddle_tpu_torch.serving.engine import ServingEngine
    from paddle_tpu_torch.serving.faults import FleetFaultPlan, ManualClock
    from paddle_tpu_torch.serving.fleet import FleetRouter

    model = gate_model(device)
    plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                          kill_at={6: 2}, drop_migration_at={1})

    def mk(i, time_fn):
        return ServingEngine(model, eos_id=1, page_size=4, num_pages=32,
                             max_pages_per_seq=8, max_slots=4,
                             buckets=(8, 16), time_fn=time_fn,
                             device=device)

    fleet = FleetRouter(mk, 4, heartbeat_s=0.05, resubmit_budget=2,
                        faults=plan,
                        roles=("prefill", "prefill", "decode", "decode"),
                        migrate_budget=8)
    rng = np.random.RandomState(0)
    system = rng.randint(2, 64, size=8).tolist()    # 2 full pages shared
    frids = [fleet.submit(system + rng.randint(2, 64, size=4).tolist(),
                          max_tokens=6) for _ in range(6)]
    for _ in range(4):             # let the first chains migrate, so the
        fleet.step()               # second wave sees decode-side owners
    frids += [fleet.submit(system + rng.randint(2, 64, size=4).tolist(),
                           max_tokens=6) for _ in range(3)]
    fleet.run(max_ticks=800)       # drain runs check_fleet_conservation
    if fleet.has_work:
        print("MIGRATE-LEAK: disaggregated fleet failed to drain "
              "within 800 ticks")
        return 1
    check_migration_conservation(fleet)
    snap = fleet.snapshot()
    bad = [f for f in frids if not fleet.status(f).terminal]
    if bad or snap["fleet_duplicate_completions"]:
        print(f"MIGRATE-LEAK: non-terminal={bad} "
              f"dups={snap['fleet_duplicate_completions']}")
        return 1
    if snap["fleet_migrations_applied"] == 0:
        print("MIGRATE-LEAK: disaggregated replay applied 0 chain "
              "migrations — the prefill->decode handoff never ran")
        return 1
    if snap["fleet_migration_fallbacks"] == 0:
        print("MIGRATE-LEAK: the scheduled blob drop produced no "
              "re-prefill fallback")
        return 1
    if snap["fleet_cross_replica_seeds"] == 0:
        print("MIGRATE-LEAK: the second submission wave produced no "
              "cross-replica prefix seeds")
        return 1
    if snap["fleet_migration_resubmits"] == 0:
        print("MIGRATE-LEAK: the injected decode kill produced no "
              "page re-adoption on resubmit")
        return 1
    print(f"migrate-check ok: {snap['fleet_completed']} completed, "
          f"{snap['fleet_migrations_applied']} chain migrations "
          f"({snap['fleet_pages_migrated']} pages, "
          f"{snap['fleet_migration_bytes']} B), "
          f"{snap['fleet_migration_fallbacks']} drop fallback, "
          f"{snap['fleet_migrations_aborted']} aborted, "
          f"{snap['fleet_cross_replica_seeds']} seed(s), "
          f"{snap['fleet_migration_resubmits']} re-adopt resubmit(s) "
          "after 1 injected kill, 0 leaks")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``check [--device D]``: the MIGRATE-LEAK gate (exit 0 clean, 1
    findings, 2 a crash); importable, like ``kv_cache.main``."""
    from paddle_tpu_torch.serving._gate import run_gate

    return run_gate(argv, "migrate",
                    "python -c \"from paddle_tpu_torch.serving.migrate "
                    "import main; main(['check'])\"", _selfcheck)


if __name__ == "__main__":
    import sys

    sys.exit(main())
