"""``parallel/local_sgd.py`` in the port against the JAX package's, on
JAX's three cases (``tests/test_local_sgd.py``) over a 4-rank 'data'
axis (the port's side in 4 gloo ranks started once for the file; JAX on
a 4-device mesh of its virtual devices):

- ``sync_period=1`` equals plain synchronous SGD and JAX's run;
- ``sync_period=4`` over 40 steps: the losses JAX's, converged, the
  replicas equal right after a sync step;
- ``lagged_grad_discard_ratio``: a rank whose batch is poisoned is
  skipped, as in JAX's run, clean, poisoned and guarded.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.local_sgd import LocalSGD as JLocalSGD

from torch_parallel_util import launch

TOL = 1e-5


def _cases():
    rng = np.random.RandomState(0)
    d = 4
    true_w = rng.randn(d, 1).astype(np.float32)

    def batch(n):
        x = rng.randn(n, d).astype(np.float32)
        return x, x @ true_w

    sync1 = dict(lr=0.1, w0=np.zeros((d, 1), np.float32),
                 steps=[batch(32) for _ in range(6)])
    converge = dict(w0=np.zeros((d, 1), np.float32),
                    steps=[batch(64) for _ in range(40)])
    x = rng.randn(64, 2).astype(np.float32)
    x_bad = x.copy()
    x_bad[24:32] *= 1000.0                  # half of rank 1's rows
    discard = dict(x=x, x_bad=x_bad, y=np.zeros((64, 1), np.float32))
    return dict(sync1=sync1, converge=converge, discard=discard)


CASES = _cases()


@pytest.fixture(scope="module")
def launched():
    return launch([("local_sgd_cases", CASES)])


def _grad_fn(params, feeds):
    x, y = feeds["x"], feeds["y"]
    loss = jnp.mean(jnp.square(x @ params["w"] - y))
    g = jax.grad(lambda p: jnp.mean(jnp.square(x @ p["w"] - y)))(params)
    return loss, g


@pytest.fixture(scope="module")
def jax_runs(launched):
    mesh = jmake_mesh((4,), ("data",), jax.devices()[:4])
    out = {}
    c = CASES["sync1"]
    w = jnp.asarray(c["w0"])
    for x, y in c["steps"]:
        w = w - c["lr"] * jax.grad(
            lambda p: jnp.mean(jnp.square(x @ p - y)))(w)
    out["sync1_plain"] = np.asarray(w)
    ls = JLocalSGD(mesh, sync_period=1, learning_rate=c["lr"])
    st = ls.replicate({"w": jnp.asarray(c["w0"])})
    fn = ls.make_step(_grad_fn)
    for i, (x, y) in enumerate(c["steps"]):
        st, _ = fn(st, jnp.asarray(i), {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
    out["sync1"] = np.asarray(ls.average(st)["w"])
    c = CASES["converge"]
    ls = JLocalSGD(mesh, sync_period=4, learning_rate=0.1)
    st = ls.replicate({"w": jnp.asarray(c["w0"])})
    fn = ls.make_step(_grad_fn)
    losses = []
    for i, (x, y) in enumerate(c["steps"]):
        st, loss = fn(st, jnp.asarray(i), {"x": jnp.asarray(x),
                                           "y": jnp.asarray(y)})
        losses.append(float(loss))
    out["converge_losses"] = np.asarray(losses)
    out["converge_w"] = np.asarray(st["w"])
    c = CASES["discard"]
    for key, ratio, x in (("clean", 0.0, c["x"]),
                          ("poisoned", 0.0, c["x_bad"]),
                          ("guarded", 3.0, c["x_bad"])):
        ls = JLocalSGD(mesh, sync_period=1, learning_rate=0.01,
                       lagged_grad_discard_ratio=ratio)
        st = ls.replicate({"w": jnp.ones((2, 1), jnp.float32)})
        st, _ = ls.make_step(_grad_fn)(st, jnp.asarray(0), {
            "x": jnp.asarray(x), "y": jnp.asarray(c["y"])})
        out[f"discard_{key}"] = np.asarray(ls.average(st)["w"])
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    return [r["local_sgd_cases"] for r in launched.wait()]


def test_sync_period_one_matches_synchronous(ranks, jax_runs):
    np.testing.assert_allclose(jax_runs["sync1"], jax_runs["sync1_plain"],
                               atol=TOL, rtol=TOL)
    for res in ranks:
        np.testing.assert_allclose(res["sync1"], jax_runs["sync1_plain"],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(res["sync1"], jax_runs["sync1"],
                                   atol=TOL, rtol=TOL)


def test_local_sgd_converges_with_period(ranks, jax_runs):
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["converge_losses"],
                                   jax_runs["converge_losses"], rtol=1e-4,
                                   atol=1e-7)
        assert res["converge_losses"][-1] < 1e-2 * res["converge_losses"][0]
        # the replicas agree right after a sync step (i=39)
        np.testing.assert_allclose(res["converge_w"], ranks[0]["converge_w"],
                                   atol=1e-6)
        np.testing.assert_allclose(res["converge_w"],
                                   jax_runs["converge_w"][r], atol=TOL,
                                   rtol=TOL)


def test_lagged_grad_discard(ranks, jax_runs):
    for res in ranks:
        for key in ("clean", "poisoned", "guarded"):
            np.testing.assert_allclose(res[f"discard_{key}"],
                                       jax_runs[f"discard_{key}"],
                                       rtol=1e-4, atol=1e-6)
        clean, bad = res["discard_clean"], res["discard_poisoned"]
        assert np.abs(bad).max() > 10 * np.abs(clean).max()
        assert np.abs(res["discard_guarded"] - clean).max() < \
            np.abs(bad - clean).max() * 0.01
