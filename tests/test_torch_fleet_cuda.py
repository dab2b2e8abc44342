"""The fleet slice on the card: pages written into a second engine's pool
by the migration plane and read by the ragged kernel (B4), and several
engines on one card stepped in turn by one router.

- ``export_chain``/``import_chain`` between two CUDA engines on f32, bf16
  and int8 pools: B4 launched over the imported pages right after the
  import (the uploads are ``non_blocking`` copies ordered on the current
  stream; nothing synchronizes between them and the kernel) equals the
  plain version on the same inputs (``ragged_cases.check``'s tolerances:
  1e-4 abs + rel on f32 and int8 pages, 1e-3 on bf16 pages against the
  plain version that rounds P as the kernel does); the pages read back
  bit-identical to the blob's; the destination finishes the request with
  the tokens the source alone would have produced.
- ``import_prefix`` seeding on the card, then a request stitched onto
  the seeded pages gives the cold engine's tokens.
- A small fleet on the card (kill, resubmit, warm restart through the
  host tier, a disaggregated drive): every request completed, each
  stream equal to its result, conservation on every pool, the dead
  replica's pool released, B4 once a layer a step of every replica.

Every test needs a CUDA device and skips without one (the kernel has no
CPU mode).  The file imports neither ``jax`` nor ``paddle_tpu``::

    python -m pytest tests/test_torch_fleet_cuda.py -q --noconftest
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import decoder_lm_from_numpy, init_numpy_params
from paddle_tpu_torch.serving import (BLOCK_ROWS, DecoderLM, FleetFaultPlan,
                                      FleetRouter, ManualClock,
                                      ServingEngine, export_chain,
                                      export_prefix, import_chain,
                                      import_prefix)
from paddle_tpu_torch.serving import decode_attention as tda
from paddle_tpu_torch.serving.kv_cache import NULL_PAGE, read_pages
from paddle_tpu_torch.tools import ragged_cases as rc

pytestmark = pytest.mark.cuda

VOCAB = 512
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, head_dim=32,
           max_positions=512)
PAGE = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    m = DecoderLM(**CFG, device=cuda)
    return decoder_lm_from_numpy(init_numpy_params(m, 0), m)


def _engine(model, cuda, **kw):
    kw.setdefault("num_pages", 40)
    return ServingEngine(model, eos_id=-1, page_size=PAGE,
                         max_pages_per_seq=8, max_slots=4, device=cuda, **kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(2, VOCAB, n).tolist()


def _raw(t):
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_b4_over_imported_pages_matches_the_plain_version(cuda, model,
                                                          kv_dtype):
    src = _engine(model, cuda, kv_dtype=kv_dtype)
    dst = _engine(model, cuda, kv_dtype=kv_dtype)
    alone = _engine(model, cuda, kv_dtype=kv_dtype)
    prompt = _prompt(77)
    ra = alone.submit(prompt, max_tokens=12)
    alone.run()
    rid = src.submit(prompt, max_tokens=12)
    while rid not in src.migratable_rids():
        src.step()
    src.step()
    blob = export_chain(src, rid)
    src.cancel(rid)
    rid2 = import_chain(dst, blob)
    req = dst._requests[rid2]
    n = req.cache_len
    table = torch.full((1, 8), NULL_PAGE, dtype=torch.int32)
    table[0, :len(req.pages)] = torch.tensor(req.pages)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for layer in range(CFG["num_layers"]):
        case = {"q": torch.randn((BLOCK_ROWS, CFG["num_heads"],
                                  CFG["head_dim"]), generator=gen,
                                 device=cuda),
                "k_pages": dst._kv.k[layer], "v_pages": dst._kv.v[layer],
                "page_table": table.to(cuda),
                "kv_lens": torch.tensor([n], dtype=torch.int32, device=cuda),
                "row_seq": torch.zeros(BLOCK_ROWS, dtype=torch.int32,
                                       device=cuda),
                "qpos": torch.arange(n - BLOCK_ROWS, n, dtype=torch.int32,
                                     device=cuda)}
        if dst._kv.quantized:
            case["k_scale"] = dst._kv.k_scale[layer]
            case["v_scale"] = dst._kv.v_scale[layer]
        before = tda.ragged_paged_attention_kernel.launches
        got = tda.ragged_paged_attention_kernel(*rc.args(case),
                                                **rc.scales(case))
        torch.cuda.synchronize()
        assert tda.ragged_paged_attention_kernel.launches == before + 1
        res = rc.check(case, got)
        assert res["within_tolerance"], res
    back = read_pages(dst._kv, req.pages[:blob.num_pages])
    for a, b in zip(back, (blob.k, blob.v, blob.k_scale, blob.v_scale)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and torch.equal(_raw(a), _raw(b))
    dst.run()
    src.run()
    assert dst.result(rid2) == alone.result(ra)
    for e in (src, dst, alone):
        assert e.pool.total_refs == 0 and e.healthz()["ok"]


def test_prefix_seed_on_the_card_gives_the_cold_tokens(cuda, model):
    src = _engine(model, cuda)
    dst = _engine(model, cuda)
    cold = _engine(model, cuda, prefix_cache=False)
    p = _prompt(70, seed=3)
    src.submit(p, max_tokens=2)
    src.run()
    blocks, nbytes = import_prefix(dst, export_prefix(src, p + [5, 6]))
    assert blocks == 70 // PAGE and nbytes > 0
    rid = dst.submit(p + [5, 6], max_tokens=10)
    rc_ = cold.submit(p + [5, 6], max_tokens=10)
    dst.run()
    cold.run()
    assert dst.cache.hits >= 1
    assert dst.result(rid) == cold.result(rc_)


# the victim holds running requests at tick 6 (with no EOS the fleet's
# ledger follows from the traffic: checked on the CPU)
@pytest.mark.parametrize("roles,victim", [
    (None, 0), (("prefill", "decode", "decode"), 1)])
def test_small_fleet_on_the_card(cuda, model, roles, victim):
    plan = FleetFaultPlan(clock=ManualClock(tick_s=0.01),
                          kill_at={6: victim})
    fl = FleetRouter(
        lambda i, t: _engine(model, cuda, time_fn=t,
                             host_tier_bytes=1 << 24),
        3, faults=plan, heartbeat_s=0.05, roles=roles, migrate_budget=8)
    streams = [[] for _ in range(8)]
    tda.ragged_paged_attention_kernel.launches = 0
    frids = [fl.submit(_prompt(40, seed=1)[:32] + _prompt(9 + i, seed=i),
                       max_tokens=16, on_token=s.append)
             for i, s in enumerate(streams)]
    fl.run(max_ticks=500)
    torch.cuda.synchronize()
    steps = sum(r.engine.metrics.step_dispatches for r in fl.replicas)
    assert tda.ragged_paged_attention_kernel.launches == \
        CFG["num_layers"] * steps > 0
    fl.check_fleet_conservation()
    assert fl.replicas[victim].engine._kv is None   # released at the reap
    snap = fl.snapshot()
    assert snap["fleet_resubmits"] >= 1 and \
        snap["fleet_duplicate_completions"] == 0
    if roles:
        assert snap["fleet_migrations_applied"] > 0
    for f, s in zip(frids, streams):
        assert str(fl.status(f)) == "completed"
        assert fl.result(f) == s
    # warm restart: the dead replica's host tier is adopted
    new = fl.restart_replica(victim)
    fl.step()
    assert str(fl.replica_state(new)) == "ready"
    f = fl.submit(_prompt(40, seed=1), max_tokens=4)
    fl.run(max_ticks=100)
    assert str(fl.status(f)) == "completed"
    fl.check_fleet_conservation()
