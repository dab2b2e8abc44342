"""The port's mixture of experts against the JAX package's, on the CPU.

- ``moe_ffn_reference`` (the dense path) at top-1 and top-2, with a
  capacity that drops tokens and without: output, aux loss, drop rate,
  and the gradients of sum(y * dy) + aux for x and every weight;
- ``layer.moe_ffn`` in a topology (a packed sequence input: padding
  slots route and are zeroed): its output, aux cost and gradients;
- ``transformer.build(moe_experts=4)`` at 2 layers: 3 Adam steps of the
  multi-cost SGD (cross-entropy + one aux cost a block) against JAX's;
- expert-parallel ``moe_ffn`` over an 'expert' axis of 2 and 4 gloo
  ranks (started once for the file) against JAX's ``moe_ffn`` on its
  virtual mesh at the same axis size (capacity per source chunk in both,
  drops included) and, where nothing drops, against the dense path;
- the MoE LM trained 2 Adam steps through ``SGD(mesh=)`` over an expert
  axis of 2 (each rank holding its two experts) against JAX's
  ``SGD(mesh=)`` on the same axis, and one step on a ``data`` 2 x
  ``expert`` 2 mesh (C10) against JAX's on that mesh.

f32 in both packages (``use_bf16`` off).  Tolerances: 1e-5 on outputs
and gradients (the einsums sum in different orders); the trainers' costs
1e-5 relative and weights 1e-4 relative in norm (Adam's rescale of
~1e-7 gradient differences).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import layer as jlayer
from paddle_tpu import optimizer as jopt
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import moe as jmoe

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.convert import parameters_from_numpy
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import moe as tmoe

import torch_parallel_ranks as R
from torch_parallel_util import cat, f32_policy, launch

T, D, HID, E = 32, 8, 16, 8
TOL = 1e-5
COST_RTOL = 1e-5
PARAM_RTOL = 1e-4
# expert-parallel cases: axis size, top-k, capacity factor (1.0 drops)
EP_CASES = [dict(n=2, k=1, cf=8.0, key="n2_k1_free"),
            dict(n=2, k=2, cf=1.0, key="n2_k2_drop"),
            dict(n=4, k=1, cf=1.0, key="n4_k1_drop"),
            dict(n=4, k=2, cf=8.0, key="n4_k2_free")]


@pytest.fixture(autouse=True)
def f32():
    with f32_policy():
        yield


def _moe_data():
    rng = np.random.RandomState(5)
    x = rng.randn(T, D).astype(np.float32)
    w = dict(router=(rng.randn(D, E) * 0.5).astype(np.float32),
             w1=(rng.randn(E, D, HID) * 0.5).astype(np.float32),
             b1=(rng.randn(E, HID) * 0.1).astype(np.float32),
             w2=(rng.randn(E, HID, D) * 0.5).astype(np.float32),
             b2=(rng.randn(E, D) * 0.1).astype(np.float32))
    dy = rng.randn(T, D).astype(np.float32)
    return x, w, dy


def _samples(n=8, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, R.LM["vocab_size"], size=R.LM["max_len"])
        out.append((toks.tolist(), list(range(R.LM["max_len"])),
                    np.roll(toks, -1).tolist()))
    return out


def _moe_lm_params():
    jpaddle.topology.reset_name_scope()
    geom = dict(R.LM, n_layers=2, moe_experts=4)
    _, _, _, _, costs = jtransformer.build(**geom)
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology(costs), seed=0)
    return {k: np.asarray(v) for k, v in params.as_dict().items()}


@pytest.fixture(scope="module")
def launched():
    x, w, dy = _moe_data()
    return launch([
        ("moe_cases", dict(x=x, dy=dy, cases=EP_CASES, **w)),
        ("moe_lm_cases", dict(params_np=_moe_lm_params(),
                              samples=_samples()))])


def _jax_moe(fn, x, w, dy, **kw):
    """(y, aux, drop, grads) of JAX's ``fn`` (jitted)."""
    def loss(x_, p):
        y, aux, st = fn(x_, jmoe.MoEParams(**p), **kw)
        return jnp.sum(y * dy) + aux, (y, aux, st["drop_rate"])

    (_, (y, aux, drop)), (gx, gp) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    grads = {"x": np.asarray(gx)}
    grads.update({k: np.asarray(v) for k, v in gp.items()})
    return np.asarray(y), float(aux), float(drop), grads


def _port_moe_reference(x, w, dy, cf, k):
    xt = torch.tensor(x, requires_grad=True)
    p = tmoe.MoEParams(**{n: torch.tensor(v, requires_grad=True)
                          for n, v in w.items()})
    y, aux, st = tmoe.moe_ffn_reference(xt, p, capacity_factor=cf,
                                        top_k=k, return_stats=True)
    ((y * torch.tensor(dy)).sum() + aux).backward()
    grads = {"x": xt.grad.numpy()}
    grads.update({n: getattr(p, n).grad.numpy() for n in w})
    return y.detach().numpy(), float(aux), float(st["drop_rate"]), grads


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 8.0], ids=["drop", "free"])
def test_dense_moe_matches_jax(k, cf):
    x, w, dy = _moe_data()
    jy, jaux, jdrop, jg = _jax_moe(
        lambda x_, p, **kw: jmoe.moe_ffn_reference(x_, p, **kw), x, w, dy,
        capacity_factor=cf, top_k=k, return_stats=True)
    ty, taux, tdrop, tg = _port_moe_reference(x, w, dy, cf, k)
    np.testing.assert_allclose(ty, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux, jaux, rtol=TOL)
    assert tdrop == pytest.approx(jdrop, abs=1e-7)
    assert (tdrop > 0) == (cf == 1.0)
    for n, g in jg.items():
        np.testing.assert_allclose(tg[n], g, atol=TOL, rtol=TOL, err_msg=n)


def _moe_graph(L, dt):
    x = L.data(name="x", type=dt.dense_vector_sequence(D))
    return L.moe_ffn(x, num_experts=4, expert_hidden=HID, top_k=2,
                     capacity_factor=1.0, name="moe")


def test_moe_layer_matches_jax():
    from paddle_tpu import data_type as jdt
    from paddle_tpu.data_feeder import DataFeeder as JFeeder
    from paddle_tpu_torch import data_type as tdt
    from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder

    rng = np.random.RandomState(2)
    batch = [(rng.randn(n, D).astype(np.float32),) for n in (5, 9, 3)]
    jpaddle.topology.reset_name_scope()
    jout, jaux = _moe_graph(jlayer, jdt)
    jt = jpaddle.topology.Topology([jout, jaux])
    arrays = {k: np.asarray(v) for k, v in jpaddle.Parameters.from_topology(
        jt, seed=3).as_dict().items()}
    tpaddle.topology.reset_name_scope()
    tout, taux = _moe_graph(tlayer, tdt)
    tt = tpaddle.topology.Topology([tout, taux])
    assert set(tt.param_specs()) == set(arrays)
    jfeeds = JFeeder([("x", jdt.dense_vector_sequence(D))])(batch)
    tfeeds = TFeeder([("x", tdt.dense_vector_sequence(D))],
                     device="cpu")(batch)
    wgt = rng.randn(jfeeds["x"].data.shape[0], D).astype(np.float32)

    def jloss(p):
        o, a = jt.forward(p, {}, jfeeds)[0]
        return jnp.sum(o.data * wgt) + jnp.sum(a), (o.data, a)

    # jitted: eager JAX compiles op by op
    (_, (jo, ja)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    params = parameters_from_numpy(arrays, device="cpu")
    tp = {k: params[k].requires_grad_(True) for k in arrays}
    to, ta = tt.forward(tp, tfeeds)
    ((to.data * torch.tensor(wgt)).sum() + ta.sum()).backward()
    valid = np.asarray(jfeeds["x"].valid_mask)
    np.testing.assert_allclose(to.data.detach().numpy()[valid],
                               np.asarray(jo)[valid], atol=TOL, rtol=TOL)
    assert not to.data.detach().numpy()[~valid].any()
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja),
                               rtol=TOL)
    for k in arrays:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=TOL, rtol=TOL, err_msg=k)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_moe_lm(mesh, steps):
    jpaddle.topology.reset_name_scope()
    _, _, _, _, costs = jtransformer.build(**dict(R.LM, n_layers=2,
                                                  moe_experts=4))
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology(costs), seed=0)
    sgd = jtrainer.SGD(cost=costs, parameters=params,
                       update_equation=jopt.Adam(learning_rate=1e-2),
                       mesh=mesh)
    step = sgd._build_step()
    feeds = sgd._shard_feeds(sgd._make_feeder(
        {"tokens": 0, "pos": 1, "target": 2}).feed(_samples()))
    p, o, m = sgd.parameters.as_dict(), sgd.opt_state, sgd.model_state
    losses = []
    for _ in range(steps):
        loss, p, o, m = [*step(p, o, m, jax.random.PRNGKey(0), feeds)][:4]
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


def test_moe_transformer_three_steps_match_jax():
    jl, jp = _jax_moe_lm(None, 3)
    tpaddle.topology.reset_name_scope()
    _, _, _, _, costs = ttransformer.build(**dict(R.LM, n_layers=2,
                                                  moe_experts=4))
    assert isinstance(costs, list) and len(costs) == 3
    params = parameters_from_numpy(_moe_lm_params(), "cpu")
    sgd = ttrainer.SGD(cost=costs, parameters=params,
                       update_equation=topt.Adam(learning_rate=1e-2),
                       device="cpu")
    feeds = sgd._make_feeder({"tokens": 0, "pos": 1, "target": 2}).feed(
        _samples())
    tl = [float(sgd.step(feeds)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=COST_RTOL)
    for k, v in jp.items():
        assert _rel(params.get(k), v) <= PARAM_RTOL, k


@pytest.fixture(scope="module")
def jax_ep():
    x, w, dy = _moe_data()
    out = {}
    with f32_policy():
        for c in EP_CASES:
            mesh = jmake_mesh((c["n"],), ("expert",),
                              jax.devices()[:c["n"]])
            out[c["key"]] = _jax_moe(
                lambda x_, p, mesh=mesh, **kw: jmoe.moe_ffn(mesh, x_, p,
                                                            **kw),
                x, w, dy, axis="expert", capacity_factor=c["cf"],
                top_k=c["k"], return_stats=True)
        out["lm2"] = _jax_moe_lm(
            jmake_mesh((2,), ("expert",), jax.devices()[:2]), 2)
        out["dx"] = _jax_moe_lm(
            jmake_mesh((2, 2), ("data", "expert"), jax.devices()[:4]), 1)
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_ep):
    return launched.wait()


@pytest.mark.parametrize("case", EP_CASES, ids=[c["key"] for c in EP_CASES])
def test_expert_parallel_moe_matches_jax(ranks, jax_ep, case):
    x, w, dy = _moe_data()
    key, n = case["key"], case["n"]
    res = [r["moe_cases"] for r in ranks]
    jy, jaux, jdrop, jg = jax_ep[key]
    for r in range(n):
        np.testing.assert_allclose(res[r][f"{key}_y"], jy, atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(res[r][f"{key}_aux"], jaux, rtol=TOL)
        assert float(res[r][f"{key}_drop"]) == pytest.approx(jdrop,
                                                             abs=1e-7)
        np.testing.assert_allclose(res[r][f"{key}_dx"], jg["x"], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(res[r][f"{key}_drouter"], jg["router"],
                                   atol=TOL, rtol=TOL)
    for name in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(cat(res, f"{key}_d{name}", n), jg[name],
                                   atol=TOL, rtol=TOL, err_msg=name)
    if case["cf"] > 1.0:
        # nothing drops: the dense path computes the same
        dy_, daux, _, _ = _port_moe_reference(x, w, dy, case["cf"],
                                              case["k"])
        assert jdrop == 0.0
        np.testing.assert_allclose(res[0][f"{key}_y"], dy_, atol=TOL,
                                   rtol=TOL)
    else:
        assert jdrop > 0.0


@pytest.mark.parametrize("n", [2])
def test_moe_lm_on_an_expert_mesh_matches_jax(ranks, jax_ep, n):
    res = ranks[0]["moe_lm_cases"]
    jl, jp = jax_ep[f"lm{n}"]
    np.testing.assert_allclose(res[f"e{n}_losses"], jl, rtol=COST_RTOL)
    assert res[f"e{n}_local_w1"][0] == 4 // n
    for k, v in jp.items():
        assert _rel(res[f"e{n}_params"][k], v) <= PARAM_RTOL, k


def test_moe_lm_on_a_data_by_expert_mesh_matches_jax(ranks, jax_ep):
    """C10: ``moe_ffn`` on a mesh that splits the batch over 'data' and
    the experts over 'expert' (2 x 2 ranks) gathers the data ranks' rows
    and routes the global token set, as JAX's GSPMD does: one Adam step's
    cost (cross-entropy plus the two blocks' aux costs) and the whole
    weights after it equal JAX's ``SGD(mesh=)`` on the same mesh, on
    every rank (the router's and experts' gradients counted once)."""
    jl, jp = jax_ep["dx"]
    for res in (r["moe_lm_cases"] for r in ranks):
        np.testing.assert_allclose(res["dx_losses"], jl, rtol=COST_RTOL)
        assert res["dx_local_w1"][0] == 2
        for k, v in jp.items():
            assert _rel(res["dx_params"][k], v) <= PARAM_RTOL, k
