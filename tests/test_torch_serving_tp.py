"""Tensor-parallel serving in the port against the JAX package's, on the
CPU (the port's side in 4 gloo ranks started once for the file, the JAX
side on its virtual devices, the same numpy weights in both):

- greedy tokens of the engine over a 'model' axis of 1, 2 and 4 ranks
  (both row packings) equal JAX's TP engines', its replicated engine's
  and its non-paged oracle's; an int8 pool and a GQA model (4 heads over
  2 KV heads) at tp 2 equal JAX's; each shard's full-forward logits
  equal JAX's model's within ``LOGIT_TOL`` (f32 sums split over ranks);
- ``ragged_paged_attention_tp`` on each rank's heads equals JAX's
  shard_map over the same mesh;
- ``validate_tp``'s four refusals and the mesh without a 'model' axis,
  in JAX's words; the per-rank pool bytes, ``pages_for_budget`` and the
  engine's ``pool_bytes`` sizing against JAX's;
- the COW fork and prefix hit on the split pool, the tp-2 chaos spot run
  (statuses, results, the retry), against JAX's;
- ``FleetRouter.over_mesh_slices`` on 4 ranks at tp 2 with slice 0
  killed at tick 6: every rank's router equal, conservation, no
  duplicate completion, results and snapshot equal to JAX's fleet on 4
  devices;
- C9: the same fleet with roles (prefill and decode slices on int8
  pages: chains and prefix seeds sent between the slices' processes
  shard by shard, a blob dropped, the decode slice killed) and with the
  autoscaler (its idle slice drained), every rank equal to JAX's.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.ops.attention import mha_reference as jmha
from paddle_tpu.parallel.mesh import make_mesh as jmake_mesh
from paddle_tpu.platform.enforce import EnforceError as JEnforceError
from paddle_tpu.serving import DecoderLM as JDecoderLM
from paddle_tpu.serving import FaultPlan as JFaultPlan
from paddle_tpu.serving import FleetRouter as JFleetRouter
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.decode_attention import \
    ragged_paged_attention_tp as jattn_tp
from paddle_tpu.serving.engine import validate_tp as jvalidate_tp
from paddle_tpu.serving.faults import FleetFaultPlan as JFleetFaultPlan
from paddle_tpu.serving.faults import ManualClock as JManualClock
from paddle_tpu.serving.kv_cache import PagedKVConfig as JPagedKVConfig
from paddle_tpu.serving.kv_cache import pages_for_budget as jpages_for_budget

from paddle_tpu_torch.convert import init_numpy_params
from paddle_tpu_torch.parallel import make_mesh
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import DecoderLM, PagedKVConfig, \
    ServingEngine, pages_for_budget, validate_tp
from paddle_tpu_torch.serving.kv_cache import kv_pool_sharding, \
    kv_pool_specs

import torch_parallel_ranks as R
from conftest import assert_serving_drained
from torch_parallel_util import launch

EOS = 1
# the shard's logits against JAX's whole model: f32 products summed over
# 1, 2 or 4 ranks' parts in another order
LOGIT_TOL = 1e-5


def _cfg(num_heads=4, num_kv_heads=None, layers=2):
    return dict(vocab_size=64, num_layers=layers, num_heads=num_heads,
                num_kv_heads=num_kv_heads, head_dim=8, max_positions=128)


def _params(cfg, seed=0):
    return init_numpy_params(JDecoderLM(**cfg), seed)


def _prompts(seed, n, lo, hi):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 64, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


MHA, GQA = _cfg(), _cfg(num_kv_heads=2)
PROMPTS = _prompts(42, 5, 4, 20)
LOGIT_PROMPT = [5, 9, 17, 3, 44, 21, 8]
BUDGET = 48 * JPagedKVConfig(num_layers=2, num_heads=4, head_dim=8,
                             page_size=4, num_pages=2,
                             max_pages_per_seq=1).bytes_per_page()


def _attn_case():
    rng = np.random.RandomState(7)
    h, kvh, d, pages, page = 4, 2, 8, 6, 8
    t = 16
    qpos = np.full((t,), -1, np.int32)
    qpos[0:4] = np.arange(16, 20)
    qpos[8:12] = np.arange(8, 12)
    return dict(q=rng.randn(t, h, d).astype(np.float32),
                kp=rng.randn(pages, page, kvh, d).astype(np.float32),
                vp=rng.randn(pages, page, kvh, d).astype(np.float32),
                table=np.array([[1, 2, 3], [4, 5, 0]], np.int32),
                lens=np.array([20, 12], np.int32),
                row_seq=np.repeat(np.arange(2, dtype=np.int32), 8),
                qpos=qpos)


def _cow_prompts():
    rng = np.random.RandomState(3)
    shared = rng.randint(2, 64, size=8).tolist()     # two full pages
    tail = rng.randint(2, 64, size=9).tolist()
    return [shared, shared, shared + tail]


def _fleet_prompts():
    rng = np.random.RandomState(5)
    system = rng.randint(2, 64, size=8).tolist()
    return [system + rng.randint(2, 64, size=4).tolist() for _ in range(9)]


def _c9_waves():
    """Three waves, each sharing a 2-page system prompt: the first and
    the third one prompt, the second another."""
    rng = np.random.RandomState(9)
    first, second = (rng.randint(2, 64, size=8).tolist() for _ in "ab")
    return [[system + rng.randint(2, 64, size=4).tolist()
             for _ in range(n)]
            for system, n in ((first, 4), (second, 3), (first, 2))]


CASES = [dict(key=f"mha{tp}", tp=tp, cfg=MHA, prompts=PROMPTS)
         for tp in (1, 2, 4)] + [
    dict(key="int8", tp=2, cfg=MHA, prompts=PROMPTS,
         kw=dict(kv_dtype="int8")),
    dict(key="gqa", tp=2, cfg=GQA, prompts=PROMPTS),
    dict(key="budget", tp=2, cfg=MHA, prompts=PROMPTS[:1],
         kw=dict(num_pages=None, pool_bytes=BUDGET))]
FLEET_CFG = _cfg(layers=1)


@pytest.fixture(scope="module")
def launched():
    params = {"mha": _params(MHA), "gqa": _params(GQA),
              "fleet": _params(FLEET_CFG)}
    cases = [dict(c, params=params["gqa" if c["cfg"] is GQA else "mha"])
             for c in CASES]
    return launch([("serving_tp_cases", dict(
        cases=cases, logit_prompt=LOGIT_PROMPT, attn=_attn_case(),
        cow=dict(cfg=GQA, params=params["gqa"], prompts=_cow_prompts()),
        chaos=dict(cfg=GQA, params=params["gqa"],
                   prompts=_prompts(11, 6, 4, 24)),
        fleet=dict(cfg=FLEET_CFG, params=params["fleet"],
                   prompts=_fleet_prompts(), waves=_c9_waves())))])


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jmesh(tp):
    return jmake_mesh((tp,), ("model",), jax.devices()[:tp])


def _jengine(cfg, params, mesh=None, **kw):
    model = JDecoderLM(**cfg)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    kw = dict(R.TP_ENGINE, **kw)
    return JServingEngine(model, p, mesh=mesh, **kw), model, p


def _jserve(eng, prompts, max_tokens=8):
    rids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    res = eng.run(max_ticks=500)
    assert_serving_drained(eng)
    return [res[r] for r in rids]


def _jforward(model):
    """JAX's non-paged causal forward over a fixed 64-token window (one
    compile; a row's logits see only the tokens up to it, so the pad
    after the prompt changes nothing)."""
    @jax.jit
    def fwd(params, t):
        x = model.embed(params, t, jnp.arange(t.shape[1])[None])
        for layer in range(model.num_layers):
            q, k, v = model.qkv(params, layer, x)
            x = model.attn_out(params, layer, jmha(q, k, v, causal=True), x)
        return model.logits(params, x[0])

    def logits(params, tokens):
        t = np.zeros((1, 64), np.int32)
        t[0, :len(tokens)] = tokens
        return np.asarray(fwd(params, jnp.asarray(t)))[len(tokens) - 1]

    return logits


def _jgreedy(logits, params, prompt, max_tokens):
    """JAX's non-paged greedy oracle (``greedy_decode_reference``'s loop)
    on the jitted forward ``logits``."""
    toks, out = list(prompt), []
    for _ in range(max_tokens):
        nxt = int(np.argmax(logits(params, toks)))
        out.append(nxt)
        toks.append(nxt)
        if nxt == EOS:
            break
    return out


@pytest.fixture(scope="module")
def jax_runs(launched):
    out = {}
    params = {"mha": _params(MHA), "gqa": _params(GQA)}
    eng, model, p = _jengine(MHA, params["mha"])
    out["replicated"] = _jserve(eng, PROMPTS)
    fwd = _jforward(model)
    out["oracle"] = [_jgreedy(fwd, p, q, 8) for q in PROMPTS]
    out["logits_mha"] = fwd(p, LOGIT_PROMPT)
    for c in CASES:
        name = "gqa" if c["cfg"] is GQA else "mha"
        eng, model, p = _jengine(c["cfg"], params[name],
                                 mesh=_jmesh(c["tp"]), **c.get("kw", {}))
        if c["key"] != "budget":                 # its pool sizing only
            out[c["key"]] = _jserve(eng, c["prompts"])
        out[c["key"] + "_kv_bytes"] = eng.healthz()["kv_bytes"]
        out[c["key"] + "_pages"] = eng.pool.num_usable
        out[c["key"] + "_comm"] = eng.tp_step_comm_bytes(100)
    _, model, p = _jengine(GQA, params["gqa"])
    out["logits_gqa"] = _jforward(model)(p, LOGIT_PROMPT)
    a = _attn_case()
    out["attn"] = np.asarray(jattn_tp(
        _jmesh(2), "model", a["q"], a["kp"], a["vp"], a["table"],
        a["lens"], a["row_seq"], a["qpos"], use_kernel=True,
        interpret=True))
    # the COW fork and the prefix hit
    eng, _, _ = _jengine(GQA, params["gqa"], mesh=_jmesh(2))
    toks = []
    for q in _cow_prompts():
        rid = eng.submit(q, max_tokens=6)
        toks.append(eng.run(max_ticks=400)[rid])
    snap = eng.metrics.snapshot()
    out["cow"] = (toks, snap["cow_forks"], snap["prefix_hit_rate"])
    # the chaos spot run
    faults = JFaultPlan(decode_errors={3: 1}, page_pressure=(2, 8, 12))
    eng, _, _ = _jengine(GQA, params["gqa"], mesh=_jmesh(2),
                         kv_dtype="int8", faults=faults)
    rids = [eng.submit(q, max_tokens=8) for q in _prompts(11, 6, 4, 24)]
    eng.step()
    faults.poison_nan(rids[2])
    eng.run(max_ticks=800)
    assert_serving_drained(eng)
    out["chaos"] = ([str(eng.status(r)) for r in rids],
                    [eng.result(r) for r in rids], eng.metrics.retries)
    # the fleet over 2-device slices
    fmodel = JDecoderLM(**FLEET_CFG)
    fp = {k: jnp.asarray(v) for k, v in _params(FLEET_CFG).items()}
    plan = JFleetFaultPlan(seed=0, clock=JManualClock(tick_s=0.01),
                           kill_at={6: 0})

    def mk(i, time_fn, mesh):
        return JServingEngine(fmodel, fp, eos_id=EOS, page_size=4,
                              num_pages=32, max_pages_per_seq=8,
                              max_slots=4, buckets=(8, 16),
                              time_fn=time_fn, mesh=mesh)

    fl = JFleetRouter.over_mesh_slices(
        mk, tp=2, devices=jax.devices()[:4], heartbeat_s=0.05,
        resubmit_budget=2, faults=plan)
    frids = [fl.submit(q, max_tokens=6) for q in _fleet_prompts()]
    fl.run(max_ticks=500)
    fl.check_fleet_conservation()
    out["fleet"] = dict(status=[str(fl.status(f)) for f in frids],
                        results=[fl.result(f) for f in frids],
                        snapshot=fl.snapshot(),
                        states=[str(r.state) for r in fl.replicas])
    # C9's drives, the same function the ranks run
    from paddle_tpu.serving.control import AutoscalePolicy as JPolicy

    def mk_c9(i, time_fn, mesh, kv_dtype, num_pages):
        kw = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
        return JServingEngine(fmodel, fp, eos_id=EOS, page_size=4,
                              num_pages=num_pages, max_pages_per_seq=8,
                              max_slots=4, buckets=(8, 16),
                              time_fn=time_fn, mesh=mesh, **kw)

    out["c9"] = R.slice_fleet_scenarios(
        _JSlices, JManualClock, JFleetFaultPlan, JPolicy, mk_c9,
        {"waves": _c9_waves()})
    return out


class _JSlices:
    """JAX's ``FleetRouter`` over the first 4 virtual devices."""

    @staticmethod
    def over_mesh_slices(mk, **kw):
        return JFleetRouter.over_mesh_slices(mk, devices=jax.devices()[:4],
                                             **kw)


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    return [r["serving_tp_cases"] for r in launched.wait()]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_greedy_tokens_at_tp_equal_jax_tp_replicated_and_oracle(
        ranks, jax_runs, tp):
    # the oracle: greedy_decode_reference's loop over JAX's non-paged
    # forward (jitted once over a fixed window, where the reference's
    # eager loop compiles once a length)
    assert jax_runs["replicated"] == jax_runs["oracle"]
    assert jax_runs[f"mha{tp}"] == jax_runs["replicated"]
    for res in ranks[:tp]:
        assert res[f"mha{tp}_tp"] == tp
        for packing in ("k0", "k1"):
            assert res[f"mha{tp}_{packing}"] == jax_runs[f"mha{tp}"]
        # the shard holds its columns only; the logits are JAX's
        assert res[f"mha{tp}_wq"] == (32, 32 // tp)
        assert res[f"mha{tp}_pool"][3] == 4 // tp
        np.testing.assert_allclose(res[f"mha{tp}_logits"],
                                   jax_runs["logits_mha"], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        assert res[f"mha{tp}_comm"] == jax_runs[f"mha{tp}_comm"]
    for res in ranks[tp:]:
        assert f"mha{tp}_k0" not in res


@pytest.mark.parametrize("key", ["int8", "gqa"])
def test_int8_pool_and_gqa_at_tp2_equal_jax(ranks, jax_runs, key):
    for res in ranks[:2]:
        assert res[f"{key}_k0"] == res[f"{key}_k1"] == jax_runs[key]
        assert res[f"{key}_kv_bytes"] == jax_runs[f"{key}_kv_bytes"]
    np.testing.assert_allclose(ranks[0]["gqa_logits"],
                               jax_runs["logits_gqa"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert ranks[0]["gqa_pool"][3] == 1          # one KV head a rank


def test_attention_on_each_ranks_heads_equals_jax(ranks, jax_runs):
    a = _attn_case()
    real = a["qpos"] >= 0
    for r in range(2):
        want = jax_runs["attn"][:, 2 * r:2 * r + 2]
        np.testing.assert_allclose(ranks[r]["attn"][real], want[real],
                                   rtol=2e-5, atol=2e-5)


def test_cow_fork_and_prefix_hit_on_the_split_pool(ranks, jax_runs):
    toks, forks, rate = jax_runs["cow"]
    for res in ranks[:2]:
        assert res["cow_tokens"] == toks
        assert res["cow_tokens"][0] == res["cow_tokens"][1]
        assert res["cow_forks"] == forks >= 1
        assert res["cow_hit_rate"] == rate > 0


def test_chaos_spot_run_at_tp2_equals_jax(ranks, jax_runs):
    status, results, retries = jax_runs["chaos"]
    for res in ranks[:2]:
        assert res["chaos_status"] == status
        assert res["chaos_status"][2] == "failed"
        assert res["chaos_results"] == results
        assert res["chaos_retries"] == retries >= 1


def test_pool_bytes_budget_accounts_tp(ranks, jax_runs):
    for res in ranks[:2]:
        assert res["budget_pages"] == jax_runs["budget_pages"] == 95
        assert res["budget_kv_bytes"] == jax_runs["budget_kv_bytes"]
        assert res["budget_kv_bytes"] <= BUDGET
        assert res["budget_tp"] == 2


# ---------------------------------------------------------------------------
# the fleet over mesh slices
# ---------------------------------------------------------------------------


def test_fleet_over_mesh_slices_equals_jax(ranks, jax_runs):
    want = jax_runs["fleet"]
    for r, res in enumerate(ranks):
        assert res["fleet_n"] == 2 and res["fleet_tp"] == [2, 2]
        # slice 0 is ranks 0-1, slice 1 ranks 2-3; the others keep a proxy
        assert res["fleet_proxy"] == [r >= 2, r < 2]
        # every rank streams each request's tokens once, proxies included
        assert res["fleet_streams"] == ranks[0]["fleet_streams"]
        assert res["fleet_snapshot"] == ranks[0]["fleet_snapshot"]
        assert res["fleet_status"] == want["status"]
        assert res["fleet_results"] == want["results"]
        assert res["fleet_states"] == want["states"] == ["dead", "ready"]
    # the exactly-once fence: a completed request streamed its result
    for got, res in zip(ranks[0]["fleet_streams"], want["results"]):
        if res is not None:
            assert got == res
    snap = ranks[0]["fleet_snapshot"]
    assert snap["fleet_duplicate_completions"] == 0
    assert snap["fleet_completed"] >= 8
    assert snap == want["snapshot"]


@pytest.mark.parametrize("drive", ["disagg", "autoscale"])
def test_fleet_roles_and_autoscaler_over_mesh_slices_equal_jax(
        ranks, jax_runs, drive):
    """C9: over 2 slices of 2 ranks, a disaggregated fleet (prefill and
    decode slices, int8 pages: chains and prefix seeds move between the
    slices' processes shard by shard, blob 1 dropped in flight, the
    decode slice killed) and an autoscaled fleet that drains its idle
    slice: every rank's streams, statuses, results, replica states and
    snapshot equal JAX's ``over_mesh_slices`` on 4 devices."""
    want = jax_runs["c9"][drive]
    for res in ranks:
        got = res["c9"][drive]
        for k in ("streams", "status", "results", "states", "roles",
                  "snapshot", "autoscale"):
            assert got[k] == want[k], (drive, k)
    snap = want["snapshot"]
    assert snap["fleet_duplicate_completions"] == 0
    assert set(want["status"]) == {"completed"}
    for got, res in zip(want["streams"], want["results"]):
        assert got == res
    if drive == "disagg":
        assert want["states"] == ["ready", "dead"]
        assert snap["fleet_migrations_applied"] >= 1
        assert snap["fleet_migration_fallbacks"] == 1
        assert snap["fleet_cross_replica_seeds"] >= 1
    else:
        assert want["states"] == ["ready", "dead"]
        assert want["autoscale"][1] == 1 and want["autoscale"][0] == 0


def test_engine_refuses_a_rank_outside_its_mesh(ranks):
    # ranks 2-3 lie outside the 2-rank mesh: the fleet keeps a proxy
    # there, and a direct build is refused
    assert all("outside_error" not in res for res in ranks[:2])
    for res in ranks[2:]:
        assert "this rank is outside the engine's mesh" in \
            res["outside_error"]


# ---------------------------------------------------------------------------
# validation and per-rank bytes (one process)
# ---------------------------------------------------------------------------


def _both_raise(port_call, jax_call):
    with pytest.raises(EnforceError) as pe:
        port_call()
    with pytest.raises(JEnforceError) as je:
        jax_call()
    assert str(pe.value) == str(je.value)
    return str(pe.value)


@pytest.mark.parametrize("case", ["heads", "gqa_corner", "kv_heads", "ffn"])
def test_validate_tp_refuses_in_jax_words(case):
    cfg, tp = {"heads": (_cfg(num_heads=3), 2),
               "gqa_corner": (_cfg(num_kv_heads=2), 4),
               "kv_heads": (_cfg(num_heads=6, num_kv_heads=3), 2),
               "ffn": (_cfg(), 4)}[case]
    pm, jm = DecoderLM(**cfg, device="cpu"), JDecoderLM(**cfg)
    if case == "ffn":
        pm.ffn_dim = jm.ffn_dim = 6
    msg = _both_raise(lambda: validate_tp(pm, tp),
                      lambda: jvalidate_tp(jm, tp))
    if case != "ffn":
        _both_raise(lambda: pm.shard_plan(tp=tp),
                    lambda: jm.shard_plan(tp=tp))
    assert {"heads": "divides 3", "gqa_corner": "lower tp",
            "kv_heads": "num_kv_heads (3)", "ffn": "FFN width (6)"}[
        case] in msg


def test_engine_refuses_a_mesh_without_the_model_axis():
    params = _params(MHA)
    pm = DecoderLM(**MHA, device="cpu")
    _both_raise(
        lambda: ServingEngine(pm, mesh=make_mesh((1,), ("data",)),
                              device="cpu", **R.TP_ENGINE),
        lambda: _jengine(MHA, params, mesh=jmake_mesh(
            (2,), ("data",), jax.devices()[:2])))
    plan = pm.shard_plan(tp=2)
    assert plan == JDecoderLM(**MHA).shard_plan(tp=2)
    assert kv_pool_specs("model") == (None, None, None, "model")
    assert kv_pool_sharding(make_mesh((1,), ("model",)), "model", 4) == \
        (slice(None),) * 3 + (slice(0, 4),)


def test_bytes_per_page_and_budget_per_rank_equal_jax():
    base = dict(num_layers=2, num_heads=4, head_dim=16, page_size=16,
                num_pages=8, max_pages_per_seq=4, num_kv_heads=2)
    for dt, tp in (("float32", 1), ("float32", 2), ("int8", 1),
                   ("int8", 2)):
        p = PagedKVConfig(dtype=getattr(__import__("torch"), dt), tp=tp,
                          **base)
        j = JPagedKVConfig(dtype=getattr(np, dt), tp=tp, **base)
        assert p.bytes_per_page() == j.bytes_per_page(), (dt, tp)
        assert p.kv_bytes() == j.kv_bytes(), (dt, tp)
    args = dict(num_layers=2, num_heads=4, head_dim=16, page_size=16,
                num_kv_heads=2)
    for dt in ("float32", "int8"):
        for tp in (1, 2):
            assert pages_for_budget(64 * 8192, dtype=dt, tp=tp, **args) \
                == jpages_for_budget(64 * 8192, dtype=dt, tp=tp, **args)
    _both_raise(lambda: PagedKVConfig(num_layers=1, num_heads=4,
                                      head_dim=8, page_size=4, num_pages=8,
                                      max_pages_per_seq=2, num_kv_heads=2,
                                      tp=4),
                lambda: JPagedKVConfig(num_layers=1, num_heads=4,
                                       head_dim=8, page_size=4, num_pages=8,
                                       max_pages_per_seq=2, num_kv_heads=2,
                                       tp=4))
