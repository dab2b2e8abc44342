"""Speculative decoding in the port against the JAX package, on the CPU.

A tiny ``DecoderLM`` (2 layers, 2 heads of 16, vocab 64, as in the JAX
package's own speculation tests) with JAX's seed-0 weights carried
across as numpy:

- ``NGramProposer`` proposals equal JAX's on seeded histories;
- n-gram and draft-model greedy streams equal JAX's engine token for
  token and equal the port's own engine with speculation off (both row
  packings of the port);
- sampled (temperature, top-k, top-p, per-request seeds) n-gram replays
  equal JAX's tokens, and the spec counters of ``ServingMetrics`` equal
  JAX's snapshot;
- lookahead grant and rollback pages, suspension under page pressure,
  the verify's copy-on-write fork of a shared page, and the draft state
  released at preemption;
- the engine arguments of later slices raise, naming the slice.

Token streams are compared exactly; the JAX engine runs its plain
attention (``use_kernel=False``), which computes what its Pallas kernel
does.  The tests of the JAX package that need its ``FaultPlan`` or its
fleet wait for those slices (ROADMAP.md).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import jax
import pytest

from conftest import assert_serving_drained
from paddle_tpu.serving import DecoderLM as JaxLM
from paddle_tpu.serving import NGramProposer as JaxNGram
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import decoder_lm_from_numpy
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import (DecoderLM, NGramProposer,
                                      RequestStatus, SamplingParams,
                                      ServingEngine)

EOS = 1
CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=16,
           max_positions=256)
ENGINE = dict(eos_id=EOS, page_size=8, num_pages=96, max_pages_per_seq=16,
              max_slots=4, buckets=(8, 16, 32))
SPEC_KEYS = ("spec_ticks", "spec_tokens_proposed", "spec_tokens_accepted",
             "spec_acceptance_rate", "spec_rollbacks", "spec_suspended",
             "spec_cow_forks", "draft_steps", "tokens_generated",
             "step_dispatches", "decode_rows", "decode_slots", "ticks")


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**CFG)
    params = {k: np.asarray(v) for k, v in
              jm.init_params(jax.random.PRNGKey(0)).items()}
    tm = decoder_lm_from_numpy(params, DecoderLM(**CFG, device="cpu"))
    return jm, params, tm


def _prompts(seed, n=4, lo=4, hi=20):
    rng = np.random.RandomState(seed)
    out = [rng.randint(2, 64, size=rng.randint(lo, hi)).tolist()
           for _ in range(n)]
    # a repeated motif, so that prompt lookup hits
    out.append(rng.randint(2, 64, size=3).tolist() * 4)
    return out


def _drive(eng, prompts, max_tokens, sampling=None):
    rids = [eng.submit(p, max_tokens=max_tokens,
                       sampling=None if sampling is None
                       else sampling(i))
            for i, p in enumerate(prompts)]
    res = eng.run(max_ticks=500)
    # either package's enum: compare by value
    assert all(eng.status(r).value == "completed" for r in rids)
    return [res[r] for r in rids]


def _port(tm, **kw):
    return ServingEngine(tm, device="cpu", **dict(ENGINE, **kw))


def _jax(models, **kw):
    jm, params, _ = models
    return JaxEngine(jm, params, use_kernel=False, **dict(ENGINE, **kw))


def test_ngram_proposals_match_jax():
    rng = np.random.RandomState(3)
    for _ in range(40):
        motif = rng.randint(2, 9, size=rng.randint(1, 5)).tolist()
        hist = (motif * rng.randint(1, 5) +
                rng.randint(2, 9, size=rng.randint(0, 6)).tolist() + motif)
        for n in (1, 2, 3):
            for k in (0, 1, 3, 5):
                assert NGramProposer(n).propose_one(hist, k) == \
                    JaxNGram(n).propose_one(hist, k)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_greedy_spec_streams_match_jax_and_spec_off(models, mode):
    jm, params, tm = models
    prompts = _prompts(0)
    draft = {} if mode == "ngram" else dict(
        jax=dict(draft_model=jm, draft_params=params),
        port=dict(draft_model=DecoderLM(**CFG, device="cpu"),
                  draft_params=params))
    jeng = _jax(models, spec_mode=mode, spec_k=3,
                **draft.get("jax", {}))
    want = _drive(jeng, prompts, 16)
    off = _drive(_port(tm), prompts, 16)
    assert off == want
    for use_kernel in (False, True):
        teng = _port(tm, spec_mode=mode, spec_k=3, use_kernel=use_kernel,
                     **draft.get("port", {}))
        assert _drive(teng, prompts, 16) == want
        assert_serving_drained(teng)
        snap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
        assert {k: snap[k] for k in SPEC_KEYS} == \
            {k: jsnap[k] for k in SPEC_KEYS}
        assert snap["spec_tokens_accepted"] > 0
        if mode == "draft":
            # the draft is the target itself: it accepts what it drafts
            assert snap["spec_acceptance_rate"] > 0.9
            assert teng._proposer.pool.total_refs == 0


def test_sampled_spec_replays_match_jax(models):
    _, _, tm = models
    prompts = _prompts(2)

    def port_sp(i):
        return SamplingParams(temperature=0.8, top_k=20, top_p=0.95,
                              seed=40 + i)

    def jax_sp(i):
        return JaxSampling(temperature=0.8, top_k=20, top_p=0.95,
                           seed=40 + i)

    want = _drive(_jax(models, spec_mode="ngram", spec_k=3), prompts, 12,
                  jax_sp)
    a = _drive(_port(tm, spec_mode="ngram", spec_k=3), prompts, 12,
               port_sp)
    b = _drive(_port(tm, spec_mode="ngram", spec_k=3), prompts, 12,
               port_sp)
    assert a == b == want
    assert a != _drive(_port(tm), prompts, 12)       # really sampled


def test_spec_metrics_published_through_healthz(models):
    _, _, tm = models
    eng = _port(tm, spec_mode="ngram", spec_k=3)
    rid = eng.submit([4, 5] * 4, max_tokens=12)
    eng.run()
    hz = eng.healthz()
    assert hz["ok"]
    for key in ("serving_spec_tokens_proposed",
                "serving_spec_acceptance_rate", "serving_spec_rollbacks"):
        assert key in hz["metrics"]
    req = eng._requests[rid]
    assert req.spec_proposed >= req.spec_accepted > 0
    assert eng._k1 == 4 and _port(tm)._k1 == 1


def test_lookahead_grant_and_rollback_pages(models):
    _, _, tm = models
    eng = _port(tm, spec_mode="ngram", spec_k=4)
    rid = eng.submit([3, 4] * 4, max_tokens=2)
    eng.step()
    req = eng._requests[rid]
    base, live0 = len(req.pages), eng.pool.num_live
    assert eng.scheduler.grant_lookahead(req, 16) >= 1
    assert len(req.pages) > base
    assert eng.pool.num_live == live0 + (len(req.pages) - base)
    assert eng.scheduler.rollback_pages(req) > 0
    assert len(req.pages) == max(
        1, -(-(req.cache_len + 1) // eng.kv_cfg.page_size))
    assert eng.pool.num_live == live0
    eng.run()
    assert_serving_drained(eng)


def test_speculation_suspended_under_page_pressure(models):
    """Six usable pages and two slots of repetitive prompts: once both
    slots hold three pages the free list is dry and speculation is
    suspended; every stream still equals speculation off."""
    _, _, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, 64, size=3).tolist() * 4 for _ in range(4)]
    want = _drive(_port(tm), prompts, 12)
    eng = _port(tm, num_pages=7, max_pages_per_seq=6, max_slots=2,
                spec_mode="ngram", spec_k=4, prefix_cache=False)
    assert _drive(eng, prompts, 12) == want
    assert eng.metrics.spec_suspended > 0
    assert_serving_drained(eng)


def test_cow_guard_forks_shared_verify_page(models):
    _, _, tm = models
    eng = _port(tm, spec_mode="ngram", spec_k=3)
    rid = eng.submit([5, 6] * 3, max_tokens=16)
    for _ in range(4):
        eng.step()
    req = eng._requests[rid]
    assert req.status is RequestStatus.RUNNING and not req.prefilling
    tail = req.cache_len // eng.kv_cfg.page_size
    shared = req.pages[tail]
    eng.pool.ref([shared])                     # a second holder
    before = eng._kv.k[:, shared].clone()
    forks = eng.metrics.spec_cow_forks
    for _ in range(6):
        eng.step()
    assert eng.metrics.spec_cow_forks > forks
    assert req.pages[tail] != shared
    assert bool((eng._kv.k[:, shared] == before).all())
    assert eng.pool.refcount(shared) == 1
    eng.pool.free([shared])
    eng.run()
    assert_serving_drained(eng)


def test_preemption_releases_draft_state(models):
    """Pages taken from the pool mid-run force growth preemption while
    the draft proposer speculates: a preempted request's draft cache is
    released at once, and every stream still completes."""
    _, params, tm = models
    eng = _port(tm, num_pages=10, max_pages_per_seq=8, max_slots=2,
                prefix_cache=False, spec_mode="draft", spec_k=2,
                draft_model=tm, draft_params=tm, draft_pool_pages=64)
    rids = [eng.submit([6, 7] * 4, max_tokens=12) for _ in range(4)]
    eng.step()
    eng.step()
    held = eng.pool.alloc(eng.pool.num_free)
    saw = False
    for _ in range(20):
        eng.step()
        for rid in rids:
            if eng.status(rid) is RequestStatus.PREEMPTED:
                saw = True
                assert rid not in eng._proposer._state
        if saw:
            break
    assert saw, "taking the free pages preempted nothing"
    eng.pool.free(held)
    eng.run()
    assert all(eng.status(r) is RequestStatus.COMPLETED for r in rids)
    assert eng._proposer.pool.total_refs == 0
    assert_serving_drained(eng)


def test_engine_arguments_of_later_slices_raise(models):
    """The compiled-path budgets (A13) still raise; ``mesh``/``tp_axis``
    are ported (``tests/test_torch_serving_tp.py`` holds them against
    JAX): a mesh that is not a ``Mesh`` or lacks the axis raises, and
    ``tp_axis`` alone is JAX's default."""
    from paddle_tpu_torch.parallel import make_mesh

    _, params, tm = models
    for kw, part in ((dict(mesh=object()), "parallel.Mesh"),
                     (dict(mesh=make_mesh((1,), ("data",))),
                      "no 'model' axis"),
                     (dict(xla_flops=1e9), "A13"),
                     (dict(role="router"), "prefill/decode/unified")):
        with pytest.raises(EnforceError, match=part):
            _port(tm, **kw)
    assert _port(tm, tp_axis="model").tp == 1
    with pytest.raises(EnforceError, match="draft_model"):
        _port(tm, spec_mode="draft")
    small = DecoderLM(**dict(CFG, vocab_size=32), device="cpu")
    with pytest.raises(EnforceError, match="vocab"):
        _port(tm, spec_mode="draft", draft_model=small,
              draft_params=small)
    with pytest.raises(EnforceError, match="spec_mode"):
        _port(tm, spec_mode="medusa")


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_pool_bytes_max_queue_fuse_tick_and_max_retained_match_jax(
        models, kv_dtype):
    """The engine arguments this slice adds, against JAX's engine:
    ``pool_bytes`` sizes the same pool, ``max_queue`` refuses the same
    submits, ``fuse_tick=False`` runs prefill and decode as two steps
    with the same tokens and dispatch count, and ``max_retained`` forgets
    the oldest results."""
    jm, params, tm = models
    kw = dict(ENGINE, num_pages=None, pool_bytes=1 << 20, max_queue=2,
              fuse_tick=False, max_retained=3, dtype=kv_dtype,
              spec_mode="ngram", spec_k=2)
    jeng = JaxEngine(jm, params, use_kernel=False, **kw)
    teng = ServingEngine(tm, device="cpu", **kw)
    assert teng.pool.num_pages == jeng.pool.num_pages
    prompts = _prompts(6)

    def run(eng):
        # a refused submit is terminal at once: its status is known now
        stat = [eng.status(eng.submit(p, max_tokens=6)).value
                for p in prompts]
        out = eng.run()
        return stat, out, sorted(eng._requests)

    tstat, tout, tkept = run(teng)
    jstat, jout, jkept = run(jeng)
    assert tstat == jstat and tstat.count("rejected") == 3
    assert len(tkept) == len(jkept) == 3          # max_retained
    assert sorted(tout.values()) == sorted(jout.values())
    snap, jsnap = teng.metrics.snapshot(), jeng.metrics.snapshot()
    for k in ("step_dispatches", "tokens_generated", "requests_rejected",
              "requests_completed", "spec_tokens_accepted"):
        assert snap[k] == jsnap[k], k
    assert_serving_drained(teng)
