"""``paddle_tpu_torch.serving.migrate`` against the JAX package's page
migration plane, on the CPU, with the same numpy weights.

- Chain handoffs between two engines for f32, bf16 and int8 pools: the
  blob's geometry, token state and byte count equal the JAX blob's; its
  payload equals the JAX payload within the pool dtype's rounding (f32
  1e-5 abs; bf16 one bf16 step of the value + 1e-6; int8 codes within
  one step and scales 1e-5 rel — K/V come from two implementations'
  f32 sums); the destination's pages read back bit-identical to the
  blob; the handed-off stream and the destination's result equal JAX's.
- Prefix export/import (cross-replica seeding) for the three dtypes:
  blocks seeded, bytes, and the warmed engine's hit and tokens.
- A disaggregated fleet (2 prefill + 2 decode replicas) with a dropped
  blob (re-prefill fallback) and a decode replica killed while
  transfers are pending: the fleet's ledgers, ``metrics_text()`` and
  lifecycle transitions equal JAX's, and the migration ledger balances.
- Geometry refusals (dtype, page size) raise in both packages.
- ``migrate.main(["check", "--device=cpu"])`` prints JAX's ledger.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from torch_serving_util import (Side, assert_same, gate_params,
                                no_retrace_sites, np_array, observe,
                                prompts, run_both)

EOS = 1
PAGE = 4
ENGINE = dict(eos_id=EOS, page_size=PAGE, num_pages=32, max_pages_per_seq=8,
              max_slots=4, buckets=(8, 16))


@pytest.fixture(scope="module")
def weights():
    return gate_params()


def _engine(side, **kw):
    """An engine on its own 10 ms-a-tick injected clock."""
    plan = side.FaultPlan(clock=side.ManualClock(tick_s=0.01))
    return side.engine(faults=plan, **dict(ENGINE, **kw))


def _prompt(n=13, seed=0):
    return np.random.RandomState(seed).randint(2, 64, size=n).tolist()


def _handoff(side, kv_dtype):
    """Serve on ``src`` until the request is migratable, export, import
    into ``dst``, cancel the source and drain."""
    mig = side.migrate
    src = _engine(side, kv_dtype=kv_dtype)
    dst = _engine(side, kv_dtype=kv_dtype)
    stream = []
    rid = src.submit(_prompt(), max_tokens=10, on_token=stream.append)
    while rid not in src.migratable_rids():
        src.step()
    for _ in range(2):
        src.step()
    blob = mig.export_chain(src, rid)
    rid2 = mig.import_chain(dst, blob, on_token=stream.append)
    src.cancel(rid)
    src.run()
    dst.run()
    dst.check_page_conservation()
    src.check_page_conservation()
    return src, dst, blob, rid2, stream


def _blob_state(blob):
    return {k: getattr(blob, k) for k in (
        "kind", "page_size", "num_layers", "kv_heads", "head_dim",
        "kv_dtype", "quantized", "prompt", "generated", "max_tokens",
        "cache_len", "chain_blocks", "chain_hash", "tenant", "num_pages",
        "nbytes")}


def _raw(t):
    return t.contiguous().view(-1).view(torch.uint8).numpy()


def _payload_close(got, want, kv_dtype):
    for name in ("k", "v", "k_scale", "v_scale"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None
            continue
        g, w = np_array(g), np_array(w)
        assert g.shape == w.shape, name
        if kv_dtype == "int8" and name in ("k", "v"):
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() \
                <= 1, name
        elif kv_dtype == "int8":
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=name)
        elif kv_dtype == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=2 ** -8, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_chain_handoff_matches_jax(weights, kv_dtype):
    from paddle_tpu_torch.serving.kv_cache import read_pages

    out = {}
    for name in ("jax", "port"):
        side = Side(name, weights)
        with side.isolated():
            src, dst, blob, rid2, stream = _handoff(side, kv_dtype)
            out[name] = (blob, stream, dst.result(rid2),
                         dst.metrics.snapshot())
    (jb, js, jres, jsnap), (tb, ts, tres, tsnap) = out["jax"], out["port"]
    assert _blob_state(tb) == _blob_state(jb)
    assert tb.pool_head_dim == tb.head_dim == 8
    _payload_close(tb, jb, kv_dtype)
    assert ts == js and tres == jres and len(tres) == 10
    assert tsnap == jsnap
    # a fresh destination's pages, read back, are the blob's bit for bit
    side = Side("port", weights)
    dst = _engine(side, kv_dtype=kv_dtype)
    rid = side.migrate.import_chain(dst, tb)
    back = read_pages(dst._kv, dst._requests[rid].pages[:tb.num_pages])
    for a, b in zip(back, (tb.k, tb.v, tb.k_scale, tb.v_scale)):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and np.array_equal(_raw(a), _raw(b))
    dst.cancel(rid)
    dst.check_page_conservation()


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_prefix_seed_matches_jax(weights, kv_dtype):
    def scenario(side):
        mig = side.migrate
        src = _engine(side, kv_dtype=kv_dtype)
        dst = _engine(side, kv_dtype=kv_dtype)
        p = _prompt(14, seed=3)
        src.submit(p, max_tokens=3)
        src.run()
        blob = mig.export_prefix(src, p + [5, 6])
        seeded = mig.import_prefix(dst, blob)
        again = mig.import_prefix(dst, blob)     # already covered: (0, 0)
        rid = dst.submit(p + [5, 6], max_tokens=4)
        dst.run()
        dst.check_page_conservation()
        return {"blob": {k: v for k, v in _blob_state(blob).items()},
                "seeded": list(seeded), "again": list(again),
                "hits": dst.cache.hits, "result": dst.result(rid),
                "snap": dst.metrics.snapshot()}

    got = run_both(weights, scenario)
    assert_same(got)
    assert got["port"]["seeded"][0] == 3 and got["port"]["hits"] >= 1
    assert got["port"]["again"] == [0, 0]


def _disagg(side, plan, n_requests=8):
    fl = side.FleetRouter(side.maker(**ENGINE), 4, heartbeat_s=0.05,
                          resubmit_budget=2, faults=plan,
                          roles=("prefill", "prefill", "decode", "decode"),
                          migrate_budget=8)
    rng = np.random.RandomState(0)
    ps = prompts(rng, n_requests, shared=2 * PAGE, lo=3, hi=6)
    streams = [[] for _ in ps]
    frids = []
    for i, (p, s) in enumerate(zip(ps, streams)):
        frids.append(fl.submit(p, max_tokens=8, on_token=s.append))
        if i == n_requests // 2:
            for _ in range(4):
                fl.step()
    return fl, frids, streams


def disagg_drop(side):
    plan = side.FleetFaultPlan(seed=0, clock=side.ManualClock(tick_s=0.01),
                               drop_migration_at={1})
    fl, frids, streams = _disagg(side, plan)
    fl.run(max_ticks=800)
    side.migrate.check_migration_conservation(fl)
    out = observe(fl, frids, streams)
    assert out["streams"] == out["results"]
    return out


def disagg_kill_in_flight(side):
    """Kill decode replica 2 at the tick after transfers to it were
    enqueued: pending handoffs abort, its requests resubmit (re-adopting
    prefix pages from a surviving replica)."""
    plan = side.FleetFaultPlan(seed=0, clock=side.ManualClock(tick_s=0.01))
    fl, frids, streams = _disagg(side, plan)
    for _ in range(30):
        if 2 in fl._mig_queues:
            break
        fl.step()
    fl.kill_replica(2, "killed mid-transfer")
    fl.run(max_ticks=800)
    side.migrate.check_migration_conservation(fl)
    return observe(fl, frids, streams)


@pytest.mark.parametrize("name", ["disagg_drop", "disagg_kill_in_flight"])
def test_disaggregated_fleet_matches_jax(weights, name):
    scenario = {"disagg_drop": disagg_drop,
                "disagg_kill_in_flight": disagg_kill_in_flight}[name]
    got = run_both(weights, scenario)
    assert_same(got)
    snap = got["port"]["snapshot"]
    assert snap["fleet_migrations_applied"] > 0
    assert snap["fleet_migrations_started"] == (
        snap["fleet_migrations_applied"] + snap["fleet_migration_fallbacks"]
        + snap["fleet_migrations_aborted"])
    if name == "disagg_drop":
        assert snap["fleet_migration_fallbacks"] == 1
    else:
        assert snap["fleet_replicas_dead"] == 1
        assert snap["fleet_resubmits"] + snap["fleet_migrations_aborted"] > 0


@pytest.mark.parametrize("side_name", ["jax", "port"])
def test_geometry_refusal(weights, side_name):
    side = Side(side_name, weights)
    src = _engine(side)
    rid = src.submit(_prompt(), max_tokens=6)
    while rid not in src.migratable_rids():
        src.step()
    blob = side.migrate.export_chain(src, rid)
    for kw in (dict(kv_dtype="int8"), dict(page_size=8)):
        dst = _engine(side, **kw)
        with pytest.raises(Exception, match="geometry"):
            side.migrate.import_chain(dst, blob)
    src.cancel(rid)
    src.check_page_conservation()


def test_int8_blob_bytes_ratio_matches_jax(weights):
    ratio = {}
    for name in ("jax", "port"):
        side = Side(name, weights)
        nbytes = {}
        for dt in ("float32", "int8"):
            _, _, blob, _, _ = _handoff(side, dt)
            nbytes[dt] = blob.nbytes
        ratio[name] = nbytes["int8"] / nbytes["float32"]
    d = 8
    assert ratio["port"] == ratio["jax"] == (d + 4) / (4 * d)


def test_migrate_gate_matches_jax(capsys):
    from paddle_tpu.serving.migrate import main as jax_main
    from paddle_tpu_torch.serving.migrate import main as port_main

    with no_retrace_sites():
        rc_j = jax_main(["check"])
    out_j = capsys.readouterr().out
    rc_p = port_main(["check", "--device=cpu"])
    out_p = capsys.readouterr().out
    assert (rc_p, out_p) == (rc_j, out_j)
    assert rc_p == 0 and "migrate-check ok" in out_p
