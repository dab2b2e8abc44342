"""Batch statistics pooled over a 'data' axis, and async checkpoints on
a mesh, in the port against the JAX package on the CPU (the port's side
in 2 gloo ranks started once for the file, each holding its rows of one
global batch; JAX on the whole batch, as its GSPMD counts it):

- ``moe_ffn_reference(group=)``: each rank's rows of the output, the
  global aux loss, drop rate and expert fractions, and the gradients of
  the global ``sum(y * dy) + aux`` (x's rows, the router and experts'
  summed over the ranks) equal JAX's dense MoE on the global batch, top-1
  and top-2 and with capacity dropping tokens;
- a training ``batch_norm`` under ``SGD(mesh=data_parallel_mesh())``: 3
  Sgd steps' costs, the weights and the moving statistics equal JAX's
  trainer on the global batch;
- ``SGD.train(async_save=True)`` on the 2-rank mesh, the writer held
  1.5 s before its last save: right after ``train()`` returns the other
  rank already sees the newest checkpoint, and a ``resume=True`` trainer
  on each rank starts from the same cursor and ends on the same weights.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import trainer as jtrainer
from paddle_tpu.parallel import moe as jmoe

import paddle_tpu_torch as tpaddle

import torch_parallel_ranks as R
from torch_parallel_util import f32_policy, launch

WORLD = 2
# f32 sums over each rank's rows, then over the ranks
TOL = 1e-5
MOE_CASES = [dict(key="top1", k=1, cf=1.25), dict(key="top2", k=2, cf=1.25),
             dict(key="drop", k=1, cf=0.5)]
BN_STEPS = 3
SAVE_DELAY_S = 1.5


def _moe_inputs():
    rng = np.random.RandomState(0)
    t, d, h, e = 16, 8, 16, 4
    return dict(x=rng.randn(t, d).astype(np.float32),
                router=rng.randn(d, e).astype(np.float32),
                w1=(rng.randn(e, d, h) * 0.3).astype(np.float32),
                b1=(rng.randn(e, h) * 0.1).astype(np.float32),
                w2=(rng.randn(e, h, d) * 0.3).astype(np.float32),
                b2=(rng.randn(e, d) * 0.1).astype(np.float32),
                dy=rng.randn(t, d).astype(np.float32))


def _bn_params():
    with f32_policy():
        cost = R.bn_graph(tpaddle)
        p = tpaddle.Parameters.from_topology(
            tpaddle.topology.Topology([cost]), seed=1, device="cpu")
    return {k: p.get(k) for k in p.names()}


def _bn_rows():
    rng = np.random.RandomState(2)
    x = (rng.randn(8, 8) * 2.0 + 1.0).astype(np.float32)
    return [(x[i], int(i % 4)) for i in range(8)]


def _dp_params():
    cost = R._dp_cost()
    p = tpaddle.Parameters.from_topology(tpaddle.topology.Topology([cost]),
                                         seed=3, device="cpu")
    return {k: p.get(k) for k in p.names()}


def _dp_batches():
    rng = np.random.RandomState(4)
    return [(rng.randn(8, 16).astype(np.float32), rng.randint(0, 4, 8))
            for _ in range(4)]


@pytest.fixture(scope="module")
def save_dir():
    d = tempfile.mkdtemp(prefix="ptt_async_ckpt_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def launched(save_dir):
    return launch([
        ("pooled_moe_cases", dict(_moe_inputs(), cases=MOE_CASES)),
        ("bn_train_case", dict(params_np=_bn_params(), rows=_bn_rows(),
                               steps=BN_STEPS)),
        ("async_ckpt_case", dict(params_np=_dp_params(),
                                 batches=_dp_batches(), save_dir=save_dir,
                                 delay=SAVE_DELAY_S))], world=WORLD)


@pytest.fixture(scope="module")
def jax_runs(launched):
    out = {}
    a = _moe_inputs()
    names = ("router", "w1", "b1", "w2", "b2")
    for c in MOE_CASES:
        def loss(x, *p):
            y, aux = jmoe.moe_ffn_reference(
                x, jmoe.MoEParams(*p), capacity_factor=c["cf"],
                top_k=c["k"])
            return jnp.sum(y * a["dy"]) + aux

        args = [jnp.asarray(a["x"])] + [jnp.asarray(a[n]) for n in names]
        y, aux, st = jmoe.moe_ffn_reference(
            args[0], jmoe.MoEParams(*args[1:]), capacity_factor=c["cf"],
            top_k=c["k"], return_stats=True)
        grads = jax.grad(loss, argnums=tuple(range(6)))(*args)
        out[c["key"]] = dict(
            y=np.asarray(y), aux=float(aux),
            drop=float(st["drop_rate"]),
            fraction=np.asarray(st["expert_fraction"]),
            dx=np.asarray(grads[0]),
            **{f"d{n}": np.asarray(g) for n, g in zip(names, grads[1:])})
    with f32_policy():
        jpaddle.topology.reset_name_scope()
        layer = jpaddle.layer
        x = layer.data(name="x", type=jpaddle.data_type.dense_vector(8))
        y = layer.data(name="y", type=jpaddle.data_type.integer_value(4))
        h = layer.fc(input=x, size=8, act="relu", name="bn_fc")
        h = layer.batch_norm(input=h, name="bn")
        cost = layer.classification_cost(
            input=layer.fc(input=h, size=4, name="bn_head"), label=y)
        params = jpaddle.Parameters.from_topology(
            jpaddle.topology.Topology([cost]), seed=1)
        for k, v in _bn_params().items():
            params[k] = v
        sgd = jtrainer.SGD(cost=cost, parameters=params,
                           update_equation=jopt.Sgd(learning_rate=0.1))
        costs = []
        sgd.train(lambda: iter([_bn_rows()] * BN_STEPS), num_passes=1,
                  feeding={"x": 0, "y": 1},
                  event_handler=lambda ev: costs.append(float(ev.cost))
                  if type(ev).__name__ == "EndIteration" else None)
        out["bn"] = dict(costs=costs,
                         params={k: np.asarray(params[k])
                                 for k in params.names()},
                         state={s: np.asarray(v) for s, v in
                                sgd.model_state["bn"].items()})
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    return launched.wait()


@pytest.mark.parametrize("case", [c["key"] for c in MOE_CASES])
def test_pooled_moe_ffn_equals_jax_on_the_global_batch(ranks, jax_runs,
                                                       case):
    want = jax_runs[case]
    n = want["y"].shape[0] // WORLD
    for r, all_res in enumerate(ranks):
        res = {k[len(case) + 1:]: v for k, v in
               all_res["pooled_moe_cases"].items() if k.startswith(case)}
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(res["y"], want["y"][rows], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(res["dx"], want["dx"][rows], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(res["aux"], want["aux"], rtol=TOL)
        np.testing.assert_allclose(res["drop"], want["drop"], atol=1e-7)
        np.testing.assert_allclose(res["fraction"], want["fraction"],
                                   atol=1e-7)
    if case == "drop":
        assert want["drop"] > 0.0
    # each rank's weight gradients are its rows' part; their sum JAX's
    for name in ("router", "w1", "b1", "w2", "b2"):
        got = sum(res["pooled_moe_cases"][f"{case}_d{name}"]
                  for res in ranks)
        np.testing.assert_allclose(got, want[f"d{name}"], rtol=TOL,
                                   atol=TOL)


def test_training_batch_norm_pools_its_statistics(ranks, jax_runs):
    want = jax_runs["bn"]
    for all_res in ranks:
        res = all_res["bn_train_case"]
        np.testing.assert_allclose(res["costs"], want["costs"], rtol=TOL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(res["params"][k], v, rtol=TOL,
                                       atol=1e-6)
        for s in ("moving_mean", "moving_var"):
            np.testing.assert_allclose(res["state"][s], want["state"][s],
                                       rtol=TOL, atol=1e-6)


def test_async_checkpoints_are_committed_for_every_rank(ranks):
    got = [r["async_ckpt_case"] for r in ranks]
    for res in got:
        # train() returned: every rank already sees the newest checkpoint
        assert res["latest"] == res["newest_written"], res["latest"]
    assert got[0]["cursor"] == got[1]["cursor"] == {
        "pass_id": 1, "step_in_pass": 0, "global_step": 4}
    assert got[0]["resumed_steps"] == got[1]["resumed_steps"] == 8
    for k, v in got[0]["resumed_params"].items():
        np.testing.assert_array_equal(got[1]["resumed_params"][k], v)
