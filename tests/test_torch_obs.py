"""``paddle_tpu_torch.obs`` against the JAX package's ``obs``, on the CPU.

- On a ``ManualClock`` the same seeded serving drive (prefix sharing,
  chunked prefill, n-gram speculation) gives the same event list in both
  packages — rids compared by first appearance, since both packages
  count rids process-wide — and byte-identical Chrome JSON;
- the registry's text exposition after ``healthz()`` is identical (the
  JAX drive runs with the process-global retrace auditor emptied,
  ``torch_serving_util.no_retrace_sites``: an earlier JAX test with
  ``FLAGS.jit_audit`` on would otherwise add its sites to the JAX
  side's exposition);
- ``trainer_event_bridge`` over ``SGD.train`` gives the same spans;
- the obs CLI's ``export`` exit codes, and ``chaos`` replaying the seeded
  fleet trace on the CPU (its parity with JAX's replay is held in
  ``test_torch_fleet.py``);
- the tracer's ring, postmortem and the null tracer.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import io
import json

import numpy as np
import jax
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.obs as jobs
from paddle_tpu.serving import DecoderLM as JaxLM
from paddle_tpu.serving import ManualClock as JaxClock
from paddle_tpu.serving import ServingEngine as JaxEngine

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.obs as tobs
from paddle_tpu_torch.convert import decoder_lm_from_numpy
from paddle_tpu_torch.obs.cli import main as obs_main
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.serving import (DecoderLM, ManualClock,
                                      ServingEngine)

from torch_serving_util import no_retrace_sites

CFG = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
           max_positions=128)
ENGINE = dict(eos_id=1, page_size=4, num_pages=32, max_pages_per_seq=8,
              max_slots=4, buckets=(8, 16), spec_mode="ngram", spec_k=3)


@pytest.fixture(scope="module")
def weights():
    jm = JaxLM(**CFG)
    params = {k: np.asarray(v) for k, v in
              jm.init_params(jax.random.PRNGKey(0)).items()}
    return jm, params


def _drive(make_engine, clock, tracer):
    """Two prompts sharing two full pages arrive a tick apart, then a
    repeated motif; the clock moves 10 ms a tick."""
    eng = make_engine(clock, tracer)
    rng = np.random.RandomState(5)
    system = rng.randint(2, 64, size=8).tolist()
    prompts = [system + rng.randint(2, 64, size=5).tolist(),
               system + rng.randint(2, 64, size=3).tolist(),
               [7, 8, 9] * 4]
    for p in prompts:
        eng.submit(p, max_tokens=8)
        eng.step()
        clock.advance(0.01)
    while eng.has_work:
        eng.step()
        clock.advance(0.01)
    eng.run()
    return eng, eng.healthz()


def _normalized(events):
    """Event dicts with rids renamed by first appearance."""
    seen = {}
    out = []
    for e in events:
        d = e.to_dict()
        args = d.get("args", {})
        if "rid" in args:
            args["rid"] = seen.setdefault(args["rid"], len(seen))
        out.append(d)
    return out


@pytest.fixture(scope="module")
def drives(weights):
    jm, params = weights
    tm = decoder_lm_from_numpy(params, DecoderLM(**CFG, device="cpu"))

    def port(clock, tracer):
        return ServingEngine(tm, time_fn=clock, tracer=tracer,
                             registry=tracer.registry, device="cpu",
                             **ENGINE)

    def jax_(clock, tracer):
        return JaxEngine(jm, params, time_fn=clock, tracer=tracer,
                         registry=tracer.registry, use_kernel=False,
                         **ENGINE)

    out = {}
    for name, mk, clk, obs in (("port", port, ManualClock(), tobs),
                               ("jax", jax_, JaxClock(), jobs)):
        tracer = obs.Tracer(time_fn=clk, registry=obs.MetricsRegistry())
        with no_retrace_sites():
            eng, hz = _drive(mk, clk, tracer)
        out[name] = (tracer, eng, hz)
    return out


def test_serving_trace_matches_jax_event_for_event(drives):
    (tt, _, thz), (jt, _, jhz) = drives["port"], drives["jax"]
    assert _normalized(tt.events) == _normalized(jt.events)
    names = {e.name for e in tt.events}
    assert names >= {"submit", "admit", "prefill_chunk", "decode_tick",
                     "first_token", "terminal", "page_alloc", "page_free",
                     "page_ref", "spec_accept"}
    assert tobs.dumps_chrome(tt.events) == jobs.dumps_chrome(jt.events)
    assert thz["ok"] and jhz["ok"]


def test_registry_exposition_matches_jax(drives):
    (tt, teng, thz), (jt, jeng, jhz) = drives["port"], drives["jax"]
    assert teng.registry.to_text() == jeng.registry.to_text()
    assert thz["metrics"] == jhz["metrics"]
    assert thz["metrics"]["serving_spec_tokens_accepted"] > 0
    assert "serving_stage_seconds{stage=queue}_count" in thz["metrics"]


def _bridged_train(pkg, obs, clock, tar=None):
    pkg.topology.reset_name_scope()
    layer, dt = pkg.layer, pkg.data_type
    x = layer.data(name="x", type=dt.dense_vector(4))
    y = layer.data(name="y", type=dt.dense_vector(1))
    cost = layer.square_error_cost(input=layer.fc(input=x, size=1), label=y)
    dev = {} if pkg is jpaddle else {"device": "cpu"}
    if tar is None:
        buf = io.BytesIO()
        pkg.Parameters.from_topology(pkg.topology.Topology([cost]),
                                     seed=3).to_tar(buf)
        tar = buf.getvalue()
    params = pkg.Parameters.from_tar(io.BytesIO(tar), **dev)
    sgd = pkg.trainer.SGD(cost=cost, parameters=params,
                          update_equation=pkg.optimizer.Momentum(
                              learning_rate=0.01), **dev)
    rng = np.random.RandomState(0)
    data = [(rng.randn(4).astype(np.float32),
             rng.randn(1).astype(np.float32)) for _ in range(12)]

    def reader():
        for i in range(0, len(data), 4):
            yield data[i:i + 4]

    reg = obs.MetricsRegistry()
    tracer = obs.Tracer(time_fn=clock, registry=reg)

    def tick(ev):
        clock.advance(0.01)

    sgd.train(reader, num_passes=2,
              event_handler=obs.trainer_event_bridge(tracer, tick))
    return tracer, reg, tar


def test_trainer_event_bridge_over_sgd_train_matches_jax():
    jt, jreg, tar = _bridged_train(jpaddle, jobs, JaxClock())
    tt, treg, _ = _bridged_train(tpaddle, tobs, ManualClock(), tar)
    assert [e.to_dict() for e in tt.events] == \
        [e.to_dict() for e in jt.events]
    assert [e.name for e in tt.events].count("train_iteration") == 6
    snap = treg.snapshot()
    assert snap["train_iterations_total"] == 6
    assert snap["train_passes_total"] == 2
    assert tobs.dumps_chrome(tt.events) == jobs.dumps_chrome(jt.events)


def test_sgd_takes_a_tracer():
    tpaddle.topology.reset_name_scope()
    x = tpaddle.layer.data(name="x", type=tpaddle.data_type.dense_vector(2))
    cost = tpaddle.layer.square_error_cost(
        input=tpaddle.layer.fc(input=x, size=1),
        label=tpaddle.layer.data(name="y",
                                 type=tpaddle.data_type.dense_vector(1)))
    buf = io.BytesIO()
    jpaddle.topology.reset_name_scope()
    jx = jpaddle.layer.data(name="x", type=jpaddle.data_type.dense_vector(2))
    jcost = jpaddle.layer.square_error_cost(
        input=jpaddle.layer.fc(input=jx, size=1),
        label=jpaddle.layer.data(name="y",
                                 type=jpaddle.data_type.dense_vector(1)))
    jpaddle.Parameters.from_topology(jpaddle.topology.Topology([jcost]),
                                     seed=1).to_tar(buf)
    params = tpaddle.Parameters.from_tar(io.BytesIO(buf.getvalue()),
                                         device="cpu")
    tracer = tobs.Tracer(time_fn=ManualClock())
    sgd = tpaddle.trainer.SGD(cost=cost, parameters=params,
                              update_equation=tpaddle.optimizer.Momentum(
                                  learning_rate=0.01),
                              tracer=tracer, device="cpu")
    assert sgd._tracer is tracer


def test_cli_export_exit_codes_and_chaos_names_the_fleet_slice(tmp_path,
                                                               capsys):
    clk = ManualClock()
    t = tobs.Tracer(time_fn=clk)
    t.instant("submit", rid=1)
    with t.span("decode_tick", tick=0):
        clk.advance(0.01)
    src = t.save(str(tmp_path / "events.jsonl"))
    out = str(tmp_path / "trace.json")
    assert obs_main(["export", src, "-o", out]) == 0
    trace = json.loads(open(out).read())
    assert any(e.get("name") == "decode_tick" for e in trace["traceEvents"])
    assert tobs.load_events(src)[1].name == "decode_tick"
    pm = t.dump_postmortem("PAGE-LEAK", dump_dir=str(tmp_path))
    assert obs_main(["export", pm, "-o", str(tmp_path / "pm.json")]) == 0
    assert obs_main(["export", src, "-o"]) == 0
    assert obs_main(["export"]) == 2
    assert obs_main([]) == 2
    assert obs_main(["nope"]) == 2
    capsys.readouterr()
    out = str(tmp_path / "chaos.json")
    assert obs_main(["chaos", "-o", out, "--device", "cpu"]) == 0
    assert "10/10 completed" in capsys.readouterr().out
    assert json.loads(open(out).read())["traceEvents"]


def test_ring_postmortem_and_null_tracer(tmp_path):
    t = tobs.Tracer(time_fn=ManualClock(), ring_size=3, keep_all=False)
    for i in range(5):
        t.instant("x", i=i)
    assert len(t.ring) == 3 and t.dropped == 2 and t.events == []
    path = t.dump_postmortem("REF-LEAK", dump_dir=str(tmp_path))
    dumped = json.loads(open(path).read())
    assert dumped["reason"] == "REF-LEAK" and len(dumped["events"]) == 3
    null = tobs.NULL_TRACER
    with null.span("decode_tick"):
        null.instant("submit")
    assert null.events == [] and not null.enabled
    old = FLAGS.obs_trace
    try:
        FLAGS.obs_trace = False
        assert tobs.tracer_for() is null
        FLAGS.obs_trace = True
        assert tobs.tracer_for().enabled
    finally:
        FLAGS.obs_trace = old
