"""The port's GPipe pipeline against the JAX package's, on the CPU.

The port's side runs in 4 gloo ranks started once for the file
(``torch_parallel_util.launch``); the JAX side runs here on the virtual
8-device mesh.  Both packages get the same numpy weights and feeds.

- ``pipeline_apply`` of ``tanh(x @ w + b)`` stages at 2 stages (two
  layers a stage) and 4, plain and remat: outputs and every stage's
  weight gradients against JAX's pipeline and the sequential run, 1e-5
  (f32; the sums differ only in order).
- ``SGD(pipeline=)`` on the zoo transformer (vocab 32, d 16, 4 layers, 2
  heads, 8 tokens, batch 8), 3 Adam steps on one batch: at 4 stages, at 2
  stages x 2 data ranks, at 2 with remat, at 4 under ZeRO-1, each against
  JAX's pipeline trainer (a 2 x 4 data x stage mesh) and against the
  port's sequential trainer.  Losses 1e-4 relative: JAX's stages run
  ``mha_reference``, the port's its flash attention's plain version, both
  exact f32 attention; Adam's per-element rescale turns the ~1e-7
  differences into the measured ~1e-6 on weights, held at 1e-4 in
  norm.
- A 4-stage checkpoint loads into a 2-stage trainer bit for bit and
  steps on.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import pipeline_apply as jpipeline_apply
from paddle_tpu.parallel import stack_stage_params as jstack
from paddle_tpu.parallel.pipeline import PipelineConfig as JPipelineConfig

import torch_parallel_ranks as R
from torch_parallel_util import cat, f32_policy, launch

L, M, MB, D = 4, 6, 8, 16
VOCAB, T = R.LM["vocab_size"], R.LM["max_len"]
STEPS = 3
LOSS_RTOL = 1e-4
PARAM_RTOL = 1e-4


def _tanh_data():
    rng = np.random.RandomState(0)
    ws = [(rng.randn(D, D) * 0.5).astype(np.float32) for _ in range(L)]
    bs = [(rng.randn(D) * 0.1).astype(np.float32) for _ in range(L)]
    mbs = rng.randn(M, MB, D).astype(np.float32)
    tgt = rng.randn(M, MB, D).astype(np.float32)
    return ws, bs, mbs, tgt


def _samples(n=8, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, VOCAB, size=T)
        out.append((toks.tolist(), list(range(T)),
                    np.roll(toks, -1).tolist()))
    return out


def _lm_params():
    jpaddle.topology.reset_name_scope()
    _, _, _, _, cost = jtransformer.build(**R.LM)
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology([cost]), seed=0)
    return {k: np.asarray(v) for k, v in params.as_dict().items()}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    ws, bs, mbs, tgt = _tanh_data()
    ck = str(tmp_path_factory.mktemp("pipe_ckpt"))
    return launch([
        ("pipeline_cases", dict(ws=ws, bs=bs, mbs=mbs, tgt=tgt)),
        ("pipeline_sgd_cases", dict(params_np=_lm_params(),
                                    samples=_samples(), ckpt_dir=ck,
                                    steps=STEPS))])


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    # the JAX runs are computed while the ranks work
    return launched.wait()


def _jstage(p, x):
    w, b = p
    for j in range(w.shape[0]):
        x = jnp.tanh(x @ w[j] + b[j])
    return x


def _jax_pipeline(s, remat):
    ws, bs, mbs, tgt = _tanh_data()
    per = L // s
    mesh = jmake_mesh((s,), ("stage",), jax.devices()[:s])
    stacked = jstack([(jnp.stack(ws[i * per:(i + 1) * per]),
                       jnp.stack(bs[i * per:(i + 1) * per]))
                      for i in range(s)], mesh)

    def loss(p):
        y = jpipeline_apply(mesh, _jstage, p, jnp.asarray(mbs),
                            remat=remat)
        return jnp.mean((y - tgt) ** 2), y

    (_, y), g = jax.value_and_grad(loss, has_aux=True)(stacked)
    return (np.asarray(y), np.asarray(g[0]).reshape(L, D, D),
            np.asarray(g[1]).reshape(L, D))


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_apply_matches_jax_and_the_sequential_run(ranks, s, remat):
    ws, bs, mbs, tgt = _tanh_data()
    want_y, want_dw, want_db = _jax_pipeline(s, remat)
    res = [r["pipeline_cases"] for r in ranks]
    k = f"s{s}_r{int(remat)}"
    for r in range(s):
        np.testing.assert_allclose(res[r][f"{k}_y"], want_y, atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(cat(res, f"{k}_dw", s), want_dw, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cat(res, f"{k}_db", s), want_db, atol=1e-5,
                               rtol=1e-5)
    # the sequential oracle
    x = mbs
    for w, b in zip(ws, bs):
        x = np.tanh(x @ w + b)
    np.testing.assert_allclose(res[0][f"{k}_y"], x, atol=1e-5, rtol=1e-5)


def _jax_pipeline_sgd(pipeline):
    jpaddle.topology.reset_name_scope()
    _, _, _, _, cost = jtransformer.build(**R.LM)
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology([cost]), seed=0)
    kw = {} if pipeline is None else {"pipeline": pipeline}
    sgd = jtrainer.SGD(cost=cost, parameters=params,
                       update_equation=jopt.Adam(learning_rate=1e-2), **kw)
    step = sgd._build_step()
    feeder = sgd._make_feeder({"tokens": 0, "pos": 1, "target": 2})
    feeds = sgd._shard_feeds(feeder.feed(_samples()))
    p, o, m = sgd.parameters.as_dict(), sgd.opt_state, sgd.model_state
    key = jax.random.PRNGKey(0)
    losses = []
    for _ in range(STEPS):
        loss, p, o, m = [*step(p, o, m, key, feeds)][:4]
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def jax_runs():
    with f32_policy():
        pipe = _jax_pipeline_sgd(JPipelineConfig(
            num_stages=4, microbatches=4, n_layers=L, n_heads=2))
        seq = _jax_pipeline_sgd(None)
    return pipe, seq


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("key", ["s4", "s2", "s2_remat", "s4_zero"])
def test_pipeline_trainer_matches_jax(ranks, jax_runs, key):
    (jl, jp), (sl, _) = jax_runs
    res = ranks[0]["pipeline_sgd_cases"]
    np.testing.assert_allclose(res[f"{key}_losses"], jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(res[f"{key}_losses"], sl, rtol=LOSS_RTOL)
    assert res[f"{key}_losses"][-1] < res[f"{key}_losses"][0]
    got = res[f"{key}_params"]
    assert set(got) == set(jp)
    for name, v in jp.items():
        assert _rel(got[name], v) <= PARAM_RTOL, name
    # each rank holds its stage's layers only
    stages = 4 if key.startswith("s4") else 2
    assert res[f"{key}_local_wq"][0] == L // stages


def test_pipeline_checkpoint_crosses_stage_counts(ranks):
    res = ranks[0]["pipeline_sgd_cases"]
    for name, v in res["s4_params"].items():
        np.testing.assert_array_equal(res["reload_params"][name], v,
                                      err_msg=name)
    assert np.isfinite(res["reload_cost"])
