"""The port's data parallelism, ZeRO-1 and layout-free checkpoints
against the JAX package's, on the CPU.

The port's side runs in 4 gloo ranks started once for the file; the JAX
side on the virtual mesh's first 4 devices.  The model is
``tests/test_dp_parity.py``'s (fc 16 -> 32 relu -> fc 4, classification
cost), 4 batches of 32, the JAX initializer's weights.

- ZeRO plans: entries (shape, size, padding, sharded) equal JAX's
  ``build_zero_plan`` over a data axis of 4, and each rank's slot bytes
  equal JAX's ``opt_state_bytes_per_device`` (1/4 of the replicated
  bytes);
- DP and DP + ZeRO-1 over 4 ranks, Momentum and Adam through
  ``SGD.train``: the weights against JAX's mesh run and the port's one
  device run, at ``test_dp_parity.py``'s tolerances (rtol 2e-5, atol
  2e-6); DP with ``zero_axis='data'`` (weights split, gathered for the
  forward) against JAX's;
- a ZeRO checkpoint saved on 4 ranks resumes on 2 and on 1 rank (one
  more Adam step: costs and weights equal JAX's run resumed from the
  same file, 1e-5 / 1e-4 relative), and the JAX package's ZeRO
  checkpoint resumes on 4 ranks (the step count, weights after a step).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import layer as jlayer
from paddle_tpu import optimizer as jopt
from paddle_tpu import trainer as jtrainer
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.zero import (build_zero_plan as jbuild_zero_plan,
                                      opt_state_bytes_per_device as jbytes)

from torch_parallel_util import f32_policy, launch

DP_RTOL, DP_ATOL = 2e-5, 2e-6
COST_RTOL, PARAM_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def f32():
    with f32_policy():
        yield


def _jcost():
    jpaddle.topology.reset_name_scope()
    x = jlayer.data(name="x", type=jpaddle.data_type.dense_vector(16))
    y = jlayer.data(name="y", type=jpaddle.data_type.integer_value(4))
    h = jlayer.fc(input=x, size=32, act="relu")
    return jlayer.classification_cost(input=jlayer.fc(input=h, size=4),
                                      label=y)


def _params():
    cost = _jcost()
    p = jpaddle.Parameters.from_topology(jpaddle.topology.Topology([cost]),
                                         seed=7)
    return {k: np.asarray(v) for k, v in p.as_dict().items()}


def _batches():
    rng = np.random.RandomState(0)
    return [(rng.randn(32, 16).astype(np.float32),
             rng.randint(4, size=32).astype(np.int64)) for _ in range(4)]


def _samples(b):
    return [(x, int(y)) for x, y in zip(*b)]


def _jsgd(mesh, opt, zero=None, zero_axis=None):
    cost = _jcost()
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology([cost]), seed=7)
    o = jopt.Momentum(momentum=0.9, learning_rate=0.05) \
        if opt == "momentum" else jopt.Adam(learning_rate=1e-2)
    return jtrainer.SGD(cost=cost, parameters=params, update_equation=o,
                        mesh=mesh, zero=zero, zero_axis=zero_axis)


def _jtrain(sgd, batches):
    data = [_samples(b) for b in batches]
    sgd.train(lambda: iter(data), num_passes=1,
              event_handler=lambda ev: None)
    return {k: np.asarray(sgd.parameters[k]) for k in
            sgd.parameters.names()}


def _mesh4():
    return jmake_mesh((4,), ("data",), jax.devices()[:4])


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """JAX's ZeRO run on 4 devices, 2 Adam steps, saved; and its own
    continuation by one step (the port must land there from the file)."""
    d = str(tmp_path_factory.mktemp("jax_zero"))
    with f32_policy():
        sgd = _jsgd(_mesh4(), "adam", 1)
        _jtrain(sgd, _batches()[:2])
        sgd.save_checkpoint(d, 0)
        cont = _jtrain(sgd, _batches()[2:3])
    return d, cont


@pytest.fixture(scope="module")
def launched(jax_ckpt, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("port_zero"))
    return ck, launch([("zero_cases", dict(
        params_np=_params(), batches=_batches(), ckpt_dir=ck,
        jax_ckpt_dir=jax_ckpt[0]))])


@pytest.fixture(scope="module")
def jax_runs(launched):
    out = {}
    with f32_policy():
        for opt in ("momentum", "adam"):
            out[f"{opt}_one"] = _jtrain(_jsgd(None, opt), _batches())
            for zero in (None, 1):
                sgd = _jsgd(_mesh4(), opt, zero)
                out[f"{opt}_z{zero or 0}"] = _jtrain(sgd, _batches())
                out[f"{opt}_z{zero or 0}_bytes"] = jbytes(
                    sgd.opt_state["slots"])
        out["zero_axis"] = _jtrain(_jsgd(_mesh4(), "momentum",
                                         zero_axis="data"), _batches())
        out["plan"] = jbuild_zero_plan(_mesh4(), _jsgd(None, "adam")
                                       .parameters.as_dict())
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    return [r["zero_cases"] for r in launched[1].wait()]


def test_zero_plan_matches_jax(ranks, jax_runs):
    got = ranks[0]["plan"]
    want = jax_runs["plan"].entries
    assert set(got) == set(want)
    for k, e in want.items():
        assert tuple(got[k]) == (tuple(e.shape), e.size, e.padded,
                                 e.sharded), k
    for opt in ("momentum", "adam"):
        for z in (0, 1):
            for r in ranks:
                assert r[f"{opt}_z{z}_slot_bytes"] == \
                    jax_runs[f"{opt}_z{z}_bytes"], (opt, z)
        assert ranks[0][f"{opt}_z1_slot_bytes"] * 4 == \
            ranks[0][f"{opt}_z0_slot_bytes"]


@pytest.mark.parametrize("opt", ["momentum", "adam"])
@pytest.mark.parametrize("zero", [0, 1])
def test_data_parallel_training_matches_jax_and_one_device(ranks, jax_runs,
                                                           opt, zero):
    want = jax_runs[f"{opt}_z{zero}"]
    one = jax_runs[f"{opt}_one"]
    for r in ranks:
        got = r[f"{opt}_z{zero}_params"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=DP_RTOL,
                                       atol=DP_ATOL, err_msg=k)
            np.testing.assert_allclose(got[k], one[k], rtol=DP_RTOL,
                                       atol=DP_ATOL, err_msg=k)


@pytest.mark.parametrize("zero", [0, 1])
def test_zero_axis_splits_weights_and_matches_jax(ranks, jax_runs, zero):
    """``zero_axis='data'``: each weight's largest dim divisible by 4 is
    split over the data axis (fc_0.w0 [16, 32] -> [16, 8]; fc_1.b [4]
    -> [1]) and gathered for the forward (its backward reduce-scatters);
    with and without ZeRO-1 the weights after a pass match JAX's."""
    want = jax_runs["zero_axis"]
    for r in ranks:
        assert r["zero_axis_local"] == {"fc_0.w0": (16, 8), "fc_0.b": (8,),
                                        "fc_1.w0": (8, 4), "fc_1.b": (1,)}
        for k in want:
            np.testing.assert_allclose(r[f"zero_axis_z{zero}_params"][k],
                                       want[k], rtol=DP_RTOL, atol=DP_ATOL,
                                       err_msg=k)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("n", [2, 1])
def test_zero_checkpoint_from_four_ranks_resumes_on_fewer(ranks, launched,
                                                          n):
    """The port's 4-rank ZeRO checkpoint, resumed by the port on n ranks
    and by JAX on its 4-device mesh: one more step lands on the same
    cost and weights."""
    res = ranks[0]
    with f32_policy():
        sgd = _jsgd(_mesh4(), "adam", 1)
        sgd.load_checkpoint(launched[0], 0)
        for k, v in res["saved_params"].items():
            np.testing.assert_array_equal(np.asarray(sgd.parameters[k]), v)
        step = sgd._build_step()
        feeds = sgd._shard_feeds(sgd._make_feeder(None).feed(
            _samples(_batches()[2])))
        loss, p = step(sgd.parameters.as_dict(), sgd.opt_state,
                       sgd.model_state, jax.random.PRNGKey(0), feeds)[:2]
    assert res[f"resume{n}_cost"] == pytest.approx(float(loss),
                                                   rel=COST_RTOL)
    for k, v in p.items():
        assert _rel(res[f"resume{n}_params"][k], v) <= PARAM_RTOL, k


def test_jax_zero_checkpoint_resumes_on_four_ranks(ranks, jax_ckpt):
    res = ranks[0]
    assert res["from_jax_step"] == 2
    for k, v in jax_ckpt[1].items():
        assert _rel(res["from_jax_params"][k], v) <= PARAM_RTOL, k
