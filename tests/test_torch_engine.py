"""The port's serving slice against the JAX package, end to end on the CPU.

- ``DecoderLM`` pieces (``embed``/``qkv``/``attn_out``/``logits``) and the
  non-paged greedy oracle against the JAX model, weights carried across by
  ``decoder_lm_from_numpy`` (1e-5: f32 matmuls summed in another order);
- the port's ``ServingEngine`` against the JAX ``ServingEngine`` on one
  mixed workload — chunked prefill riding decode steps, a prefix shared by
  a later arrival, a full-cover hit that copy-on-write forks — for f32 and
  int8 pools and for both row packings: TOKEN-IDENTICAL outputs and page
  conservation after the drain;
- the host paths the port carries (cancel, deadlines, the finite-logits
  guard, the progress watchdog, healthz);
- the device default: ``cuda`` unless the caller asks for the CPU, and a
  raise without CUDA;
- import hygiene: the port and ``chip_smoke.py`` import neither ``jax``
  nor ``paddle_tpu``.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import ast
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import assert_serving_drained
from paddle_tpu.serving import DecoderLM as JaxLM
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import greedy_decode_reference as jax_greedy
from paddle_tpu_torch.convert import decoder_lm_from_numpy, init_numpy_params
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import (DecoderLM, ManualClock, RequestStatus,
                                      ServingEngine, greedy_decode_reference,
                                      init_kv_pages, PagedKVConfig)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
           max_positions=128, num_kv_heads=2)
ENGINE = dict(eos_id=1, page_size=8, num_pages=40, max_pages_per_seq=8,
              max_slots=4, buckets=(8, 16, 32), prefill_chunk=16)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**CFG)
    params = {k: np.asarray(v) for k, v in
              jm.init_params(jax.random.PRNGKey(0)).items()}
    tm = decoder_lm_from_numpy(params, DecoderLM(**CFG, device="cpu"))
    return jm, {k: jnp.asarray(v) for k, v in params.items()}, tm


def test_decoder_lm_pieces_match_jax(models):
    jm, params, tm = models
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, size=(2, 5)).astype(np.int32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    jx = jm.embed(params, jnp.asarray(tokens), jnp.asarray(pos))
    tx = tm.embed(torch.from_numpy(tokens), torch.from_numpy(pos))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    for layer in range(CFG["num_layers"]):
        for a, b in zip(tm.qkv(layer, tx), jm.qkv(params, layer, jx)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        ctx = rng.randn(2, 5, 4, 16).astype(np.float32)
        jx = jm.attn_out(params, layer, jnp.asarray(ctx), jx)
        tx = tm.attn_out(layer, torch.from_numpy(ctx), tx)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tm.logits(tx).numpy(),
                               np.asarray(jm.logits(params, jx)), **TOL)
    # the JAX oracle retraces at every length, so keep it short
    prompt = rng.randint(2, 64, size=5).tolist()
    assert greedy_decode_reference(tm, prompt, 3, 1) == \
        jax_greedy(jm, params, prompt, 3, 1)


def test_init_numpy_params_round_trips(models):
    _, _, tm = models
    p = init_numpy_params(tm, seed=3)
    m = decoder_lm_from_numpy(p, DecoderLM(**CFG, device="cpu"))
    np.testing.assert_array_equal(m.layers[1].w2.numpy(), p["l1.w2"])
    assert float(np.std(p["emb"])) == pytest.approx(0.02, rel=0.05)
    bad = dict(p, extra=p["out"])
    with pytest.raises(EnforceError, match="unexpected"):
        decoder_lm_from_numpy(bad, m)


def _mixed_traffic(eng):
    """Long prompts chunking while short ones decode, then a prompt that
    shares a cached 16-token prefix and one whose every page is cached
    (a full-cover hit: COW fork), each submitted after the prefix's
    prefill finished.  Returns the outputs in submission order."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(2, 64, size=16).tolist()
    prompts = [rng.randint(2, 64, size=n).tolist()
               for n in (3, 26, 5, 19, 2, 11)]
    rids = []
    for i, p in enumerate(prompts + [prefix + [7, 8, 9]]):
        rids.append(eng.submit(p, max_tokens=10 if len(p) < 8 else 4))
        if i % 2:
            eng.step()                 # interleave arrivals with ticks
    for _ in range(4):
        eng.step()                     # the prefix's pages get indexed
    rids.append(eng.submit(prefix + [11], max_tokens=5))
    rids.append(eng.submit(list(prefix), max_tokens=5))
    eng.run(max_ticks=400)
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["compact", "kernel_packing"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_engine_token_identical_to_jax(models, kv_dtype, use_kernel):
    jm, params, tm = models
    jeng = JaxEngine(jm, params, kv_dtype=kv_dtype, use_kernel=use_kernel,
                     **ENGINE)
    teng = ServingEngine(tm, kv_dtype=kv_dtype, use_kernel=use_kernel,
                         device="cpu", **ENGINE)
    want = _mixed_traffic(jeng)
    got = _mixed_traffic(teng)
    assert all(toks for toks in got)
    assert got == want
    assert_serving_drained(teng)
    jm_, tm_ = jeng.metrics, teng.metrics
    assert tm_.prefill_tokens_saved == jm_.prefill_tokens_saved > 0
    assert tm_.cow_forks == jm_.cow_forks > 0
    assert tm_.step_dispatches == jm_.step_dispatches
    assert (tm_.prefill_rows, tm_.prefill_pad_rows) == \
        (jm_.prefill_rows, jm_.prefill_pad_rows)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["compact", "kernel_packing"])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_bf16_decoder_lm_serves_token_identical_to_its_oracle(models,
                                                              kv_dtype,
                                                              use_kernel):
    """A bf16 ``DecoderLM`` (the JAX weights cast to bf16) through both row
    packings and over f32 and bf16 pools: the attention takes bf16
    queries and returns bf16, the host reads the logits widened to f32,
    and every request is token-identical to the port's non-paged greedy
    oracle on the same model."""
    _, _, tm = models
    params = {k: v.float().numpy() for k, v in tm.state_dict().items()}
    bf = DecoderLM(**CFG, device="cpu", dtype=torch.bfloat16)
    bf.load_state_dict({k: torch.from_numpy(v).to(torch.bfloat16)
                        for k, v in params.items()})
    eng = ServingEngine(bf, kv_dtype=kv_dtype, use_kernel=use_kernel,
                        device="cpu", **ENGINE)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(2, 64, size=n).tolist() for n in (3, 26, 11)]
    rids = [eng.submit(p, max_tokens=6) for p in prompts]
    eng.run(max_ticks=200)
    assert_serving_drained(eng)
    for prompt, rid in zip(prompts, rids):
        want = greedy_decode_reference(bf, prompt, 6, ENGINE["eos_id"])
        assert eng.result(rid) == want


def _engine(tm, **kw):
    return ServingEngine(tm, device="cpu", **dict(ENGINE, **kw))


def test_cancel_and_deadlines(models):
    _, _, tm = models
    clock = ManualClock()
    eng = _engine(tm, max_slots=1, time_fn=clock)
    a = eng.submit([5, 6, 7], max_tokens=20)
    b = eng.submit([8, 9], max_tokens=3, queue_deadline_s=0.5)
    c = eng.submit([10, 11], max_tokens=3)
    eng.step()
    assert eng.status(a) is RequestStatus.RUNNING
    assert eng.cancel(c) and eng.status(c) is RequestStatus.CANCELLED
    clock.advance(1.0)
    eng.step()                          # b never got the one slot in time
    assert eng.status(b) is RequestStatus.TIMED_OUT
    assert eng.cancel(a) and not eng.cancel(a)
    assert eng.result(a) is None
    eng.run()
    assert_serving_drained(eng)
    snap = eng.metrics.snapshot()
    assert (snap["requests_cancelled"], snap["requests_timed_out"]) == (2, 1)
    with pytest.raises(KeyError):
        eng.status(10 ** 9)


def test_finite_guard_fails_only_the_poisoned_slot(models, monkeypatch):
    _, _, tm = models
    eng = _engine(tm)
    good = eng.submit([5, 6, 7], max_tokens=6)
    bad = eng.submit([8, 9, 10], max_tokens=6)
    eng.step()                          # both prefilled, first tokens out
    slot = eng._requests[bad].slot
    step = eng._step

    def poisoned(*args):
        d, p = step(*args)
        d = d.copy()
        d[slot] = np.nan
        return d, p

    monkeypatch.setattr(eng, "_step", poisoned)
    eng.run()
    assert eng.status(bad) is RequestStatus.FAILED
    assert eng.status(good) is RequestStatus.COMPLETED
    assert len(eng.result(good)) == 6
    assert_serving_drained(eng)


def test_retry_then_watchdog(models, monkeypatch):
    """A step that makes no progress (stood in for by a ``_do_step``
    that does nothing) fails the request once the watchdog's ticks pass,
    and the pages come back."""
    _, _, tm = models
    eng = _engine(tm, watchdog_ticks=3)
    rid = eng.submit([5, 6, 7], max_tokens=6)
    monkeypatch.setattr(eng, "_do_step", lambda *args: None)
    eng.run(max_ticks=10)
    assert eng.status(rid) is RequestStatus.FAILED
    assert eng.metrics.ticks <= 4
    health = eng.healthz()
    assert health["ok"] and health["status_counts"] == {"failed": 1}
    assert health["pages_in_use"] == 0 and health["kv_dtype"] == "float32"


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(EnforceError, match="device='cpu'"):
        DecoderLM(**CFG)
    cfg = PagedKVConfig(num_layers=1, num_heads=2, head_dim=8, page_size=4,
                        num_pages=4, max_pages_per_seq=2)
    with pytest.raises(EnforceError, match="CUDA is not available"):
        init_kv_pages(cfg)
    model = DecoderLM(**CFG, device="cpu")
    with pytest.raises(EnforceError, match="CUDA is not available"):
        ServingEngine(model, eos_id=1)
    assert init_kv_pages(cfg, device="cpu").k.device.type == "cpu"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    # exact module or dotted prefix: "paddle_tpu_torch" is allowed
    return name in ("jax", "paddle_tpu") or \
        name.startswith(("jax.", "paddle_tpu."))


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # the sixth, eighth, ninth, tenth, eleventh, twelfth, thirteenth,
    # fourteenth, fifteenth and sixteenth slices' modules (parallel/,
    # reader/, dataset/, image.py, obs/, cli.py, utils.py, the fleet,
    # analysis/, master/, checkpoint.py, resilience/, platform/virtual.py,
    # parallel/local_sgd.py, tools/tp_workload.py, fluid/, the program
    # verifier and tools/fluid_workload.py among them) are walked too
    names = {str(f.relative_to(REPO)) for f in files}
    assert names >= {f"paddle_tpu_torch/{m}.py" for m in (
        "models/deepfm", "models/gan", "models/vae",
        "models/traffic_prediction", "parallel/sparse",
        "tools/ctr_workload", "tools/gan_vae_workload",
        "tools/profile_ctr", "models/transformer", "topology", "ops/losses",
        "tools/transformer_nmt_workload", "tools/profile_transformer_nmt",
        "evaluator", "optimizer", "reader/__init__", "reader/decorator",
        "reader/creator", "reader/prefetch", "dataset/__init__",
        "dataset/common", "dataset/_synth", "dataset/mnist", "dataset/cifar",
        "dataset/uci_housing", "dataset/imdb", "dataset/imikolov",
        "dataset/sentiment", "dataset/wmt14", "dataset/conll05",
        "dataset/movielens", "dataset/mq2007", "platform/plog",
        "tools/v2_loop_workload", "image", "dataset/flowers",
        "dataset/voc2012", "ops/detection", "platform/stats", "plot",
        "tools/layer_cases", "tools/detection_workload",
        "tools/vgg_workload", "tools/profile_vgg_reader",
        "tools/profiling", "tools/vgg_grad_spread", "layer",
        "networks", "data_type",
        "data_feeder", "obs/__init__", "obs/__main__", "obs/trace",
        "obs/registry", "obs/export", "obs/bridge", "obs/cli", "cli",
        "utils", "__main__", "serving/speculate", "serving/kv_cache",
        "serving/metrics", "tools/spec_workload", "serving/fleet",
        "serving/migrate", "serving/control", "serving/faults",
        "serving/_gate", "analysis/__init__", "analysis/concurrency/__init__",
        "analysis/concurrency/lifecycle", "master/__init__",
        "master/service", "tools/fleet_workload", "checkpoint",
        "convert", "trainer", "parameters", "platform/flags",
        "resilience/__init__", "resilience/__main__", "resilience/faults",
        "resilience/guard", "resilience/checkpointer",
        "resilience/supervisor", "resilience/chaos", "resilience/cli",
        "master/recordio", "master/server", "master/client",
        "tools/resilience_workload", "tools/train_workload",
        "parallel/__init__", "parallel/compat", "parallel/comm",
        "parallel/mesh", "parallel/api", "parallel/placement",
        "parallel/zero", "parallel/moe", "parallel/pipeline",
        "parallel/ring", "platform/virtual", "platform/device",
        "tools/parallel_workload", "parallel/local_sgd",
        "tools/tp_workload", "serving/engine", "serving/decode_attention",
        "fluid/__init__", "fluid/framework", "fluid/ops", "fluid/backward",
        "fluid/executor", "fluid/layers", "fluid/optimizer", "fluid/io",
        "analysis/program_check", "analysis/diagnostics",
        "tools/fluid_workload")}
    bad = {str(f.relative_to(REPO)): n for f in files
           for n in _imports(f) if _forbidden(n)}
    assert bad == {}
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, paddle_tpu_torch.convert,"
            " paddle_tpu_torch.kernels.build, paddle_tpu_torch.recurrent,"
            " paddle_tpu_torch.generation, paddle_tpu_torch.inference,"
            " paddle_tpu_torch.models.seq2seq,"
            " paddle_tpu_torch.tools.nmt_workload,"
            " paddle_tpu_torch.tools.profile_nmt,"
            " paddle_tpu_torch.models.deepfm, paddle_tpu_torch.models.gan,"
            " paddle_tpu_torch.models.vae,"
            " paddle_tpu_torch.models.traffic_prediction,"
            " paddle_tpu_torch.parallel.sparse,"
            " paddle_tpu_torch.tools.ctr_workload,"
            " paddle_tpu_torch.tools.gan_vae_workload,"
            " paddle_tpu_torch.tools.profile_ctr,"
            " paddle_tpu_torch.tools.repro,"
            " paddle_tpu_torch.models.transformer,"
            " paddle_tpu_torch.tools.transformer_nmt_workload,"
            " paddle_tpu_torch.tools.profile_transformer_nmt,"
            " paddle_tpu_torch.evaluator, paddle_tpu_torch.reader,"
            " paddle_tpu_torch.reader.prefetch, paddle_tpu_torch.dataset,"
            " paddle_tpu_torch.platform.plog,"
            " paddle_tpu_torch.tools.v2_loop_workload,"
            " paddle_tpu_torch.image, paddle_tpu_torch.dataset.flowers,"
            " paddle_tpu_torch.dataset.voc2012,"
            " paddle_tpu_torch.ops.detection,"
            " paddle_tpu_torch.platform.stats, paddle_tpu_torch.plot,"
            " paddle_tpu_torch.tools.layer_cases,"
            " paddle_tpu_torch.tools.detection_workload,"
            " paddle_tpu_torch.tools.vgg_workload,"
            " paddle_tpu_torch.tools.profile_vgg_reader,"
            " paddle_tpu_torch.tools.profiling,"
            " paddle_tpu_torch.tools.vgg_grad_spread,"
            " paddle_tpu_torch.obs, paddle_tpu_torch.obs.cli,"
            " paddle_tpu_torch.cli, paddle_tpu_torch.utils,"
            " paddle_tpu_torch.tools.spec_workload,"
            " paddle_tpu_torch.serving.fleet, paddle_tpu_torch.serving.migrate,"
            " paddle_tpu_torch.serving.control, paddle_tpu_torch.serving.faults,"
            " paddle_tpu_torch.analysis.concurrency.lifecycle,"
            " paddle_tpu_torch.master.service,"
            " paddle_tpu_torch.tools.fleet_workload,"
            " paddle_tpu_torch.checkpoint, paddle_tpu_torch.resilience,"
            " paddle_tpu_torch.resilience.chaos,"
            " paddle_tpu_torch.resilience.cli,"
            " paddle_tpu_torch.master.recordio,"
            " paddle_tpu_torch.master.server,"
            " paddle_tpu_torch.master.client,"
            " paddle_tpu_torch.tools.resilience_workload,"
            " paddle_tpu_torch.parallel, paddle_tpu_torch.parallel.compat,"
            " paddle_tpu_torch.parallel.comm,"
            " paddle_tpu_torch.parallel.mesh, paddle_tpu_torch.parallel.api,"
            " paddle_tpu_torch.parallel.placement,"
            " paddle_tpu_torch.parallel.zero, paddle_tpu_torch.parallel.moe,"
            " paddle_tpu_torch.parallel.pipeline,"
            " paddle_tpu_torch.parallel.ring,"
            " paddle_tpu_torch.platform.virtual,"
            " paddle_tpu_torch.tools.parallel_workload,"
            " paddle_tpu_torch.parallel.local_sgd,"
            " paddle_tpu_torch.tools.tp_workload,"
            " paddle_tpu_torch.fluid, paddle_tpu_torch.fluid.framework,"
            " paddle_tpu_torch.fluid.ops, paddle_tpu_torch.fluid.backward,"
            " paddle_tpu_torch.fluid.executor, paddle_tpu_torch.fluid.layers,"
            " paddle_tpu_torch.fluid.optimizer, paddle_tpu_torch.fluid.io,"
            " paddle_tpu_torch.analysis.program_check,"
            " paddle_tpu_torch.analysis.diagnostics,"
            " paddle_tpu_torch.tools.fluid_workload, chip_smoke; "
            "print(sorted(m for m in sys.modules if m in ('jax', "
            "'paddle_tpu') or m.startswith(('jax.', 'paddle_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sampling_helpers_match_jax():
    """Token choice is host numpy in both packages: greedy argmax, seeded
    per-position draws and the verify walk give the same tokens."""
    from paddle_tpu.serving import speculate as jspec
    from paddle_tpu_torch.serving import speculate as tspec

    rng = np.random.RandomState(4)
    rows = rng.randn(4, 64).astype(np.float32)
    for temp, top_k, top_p in ((0.0, 0, 1.0), (0.8, 0, 1.0), (1.2, 5, 0.9)):
        ts = tspec.SamplingParams(temperature=temp, top_k=top_k,
                                  top_p=top_p, seed=11)
        js = jspec.SamplingParams(temperature=temp, top_k=top_k,
                                  top_p=top_p, seed=11)
        for pos in range(3):
            assert tspec.next_token(rows[pos], ts, pos) == \
                jspec.next_token(rows[pos], js, pos)
        if temp > 0:
            np.testing.assert_array_equal(tspec.warp_probs(rows[0], ts),
                                          jspec.warp_probs(rows[0], js))
        drafts = [int(np.argmax(rows[0])), 3, 9]
        assert tspec.accept_tokens(rows, drafts, None, ts, 2, 1) == \
            jspec.accept_tokens(rows, drafts, None, js, 2, 1)
    with pytest.raises(EnforceError, match="top_p"):
        tspec.SamplingParams(top_p=0.0)
