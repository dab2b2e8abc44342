"""The port's meshes, placement plans, tensor parallelism, ``init``'s mesh
flags and ``MultiTaskTrainer(mesh=)`` against the JAX package's, on the
CPU (the port's side in 4 gloo ranks started once for the file).

- ``make_mesh``, ``hybrid_mesh``, ``mesh_slices``: each rank's
  coordinates and axis groups equal the device layout of JAX's mesh;
  ``param_sharding`` with ``zero_axis`` picks JAX's dims;
- the placement plans (``plan_param_attrs``, ``leading_axis_plan``, the
  pipeline and expert plans, ``stage_attrs``, ``MoEConfig``), the
  closed-form bytes of ``moe_contract``/``pipeline_contract`` and
  ``record_moe_stats``' registry series equal JAX's;
- ``init(mesh_shape="2,2", mesh_axes="data,model")`` builds that mesh
  over the 4 ranks; a mesh larger than the job raises; two plain
  processes join one job through ``init(coordinator_address=,
  num_processes=, process_id=)``;
- ``model_parallel_mlp`` (hidden 16, 16) over a 2-rank 'model' axis, 3
  Adam steps: costs and weights against JAX's run on a 2-device 'model'
  mesh and against the port's plain MLP on one device (1e-5 costs, 1e-4
  weights in norm: Adam's rescale of ~1e-7 differences), each rank
  holding half of every weight;
- the GAN through ``MultiTaskTrainer(mesh=)`` over 2 data ranks, two
  alternating Adam pairs: costs and weights against JAX's trainer;
- batch norm and ``moe_ffn`` train on those 2 data ranks with their
  batch statistics pooled over them: one Sgd step equals JAX's on the
  global batch.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import gan as jgan
from paddle_tpu.parallel import api as japi
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.parallel import placement as jplacement

from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.parallel import moe as tmoe
from paddle_tpu_torch.parallel import placement as tplacement

import torch_parallel_ranks as R
from torch_parallel_util import f32_policy, launch

COST_RTOL, PARAM_RTOL = 1e-5, 1e-4
GAN = dict(noise_dim=4, data_dim=2, gen_dims=(8,), dis_dims=(8,))


@pytest.fixture(autouse=True)
def f32():
    with f32_policy():
        yield


def _jtp_cost(mp):
    from paddle_tpu import layer

    jpaddle.topology.reset_name_scope()
    x = layer.data(name="x", type=jpaddle.data_type.dense_vector(
        R.TP["in_dim"]))
    y = layer.data(name="y", type=jpaddle.data_type.integer_value(
        R.TP["out_dim"]))
    if mp:
        logits = jplacement.model_parallel_mlp(x, R.TP["hidden"],
                                               R.TP["out_dim"], axis="model")
    else:
        net = x
        for i, h in enumerate(R.TP["hidden"]):
            net = layer.fc(input=net, size=h, act="relu", name=f"mp_fc{i}")
        logits = layer.fc(input=net, size=R.TP["out_dim"], name="mp_out")
    return layer.classification_cost(input=logits, label=y)


def _tp_params():
    cost = _jtp_cost(True)
    p = jpaddle.Parameters.from_topology(jpaddle.topology.Topology([cost]),
                                         seed=11)
    return {k: np.asarray(v) for k, v in p.as_dict().items()}


def _tp_batches():
    rng = np.random.RandomState(7)
    w = rng.randn(R.TP["in_dim"], R.TP["out_dim"])
    out = []
    for _ in range(3):
        xs = rng.randn(16, R.TP["in_dim"]).astype(np.float32)
        out.append((xs, np.argmax(xs @ w, axis=1)))
    return out


def _gan_params():
    jpaddle.topology.reset_name_scope()
    _, _, _, d, g = jgan.build(**GAN)
    p = jpaddle.Parameters.from_topology(jpaddle.topology.Topology([d, g]),
                                         seed=1)
    return {k: np.asarray(v) for k, v in p.as_dict().items()}


def _gan_feeds():
    rs = np.random.RandomState(0)
    out = []
    for task in ("d", "g", "d", "g"):
        f = {"noise": rs.randn(8, 4).astype(np.float32),
             "label_one": np.ones((8, 1), np.float32)}
        if task == "d":
            f["pixel"] = rs.randn(8, 2).astype(np.float32)
            f["label_zero"] = np.zeros((8, 1), np.float32)
        out.append((task, f))
    return out


@pytest.fixture(scope="module")
def launched():
    return launch([("mesh_cases", dict(
        tp_params=_tp_params(), tp_batches=_tp_batches(),
        gan_params=_gan_params(), gan_feeds=_gan_feeds()))])


def _jtrain_tp(mp, mesh):
    cost = _jtp_cost(mp)
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology([cost]), seed=11)
    sgd = jtrainer.SGD(cost=cost, parameters=params,
                       update_equation=jopt.Adam(learning_rate=1e-2),
                       mesh=mesh)
    costs = []
    data = [[(x, int(y)) for x, y in zip(*b)] for b in _tp_batches()]

    def handler(ev):
        if type(ev).__name__ == "EndIteration":
            costs.append(float(ev.cost))

    sgd.train(lambda: iter(data), num_passes=1, event_handler=handler)
    return costs, {k: np.asarray(sgd.parameters[k])
                   for k in sgd.parameters.names()}


@pytest.fixture(scope="module")
def jax_runs(launched):
    out = {}
    with f32_policy():
        out["tp"] = _jtrain_tp(True, jmesh.make_mesh(
            (2,), ("model",), jax.devices()[:2]))
        out["plain"] = _jtrain_tp(False, None)
        jpaddle.topology.reset_name_scope()
        _, _, _, d, g = jgan.build(**GAN)
        gp = jpaddle.Parameters.from_topology(
            jpaddle.topology.Topology([d, g]), seed=1)
        mt = jtrainer.MultiTaskTrainer(
            [jtrainer.TaskSpec("d", d, jopt.Adam(learning_rate=1e-2),
                               trainable="dis_"),
             jtrainer.TaskSpec("g", g, jopt.Adam(learning_rate=1e-2),
                               trainable="gen_")], gp)
        out["gan_costs"] = [mt.step(t, f) for t, f in _gan_feeds()]
        out["gan_params"] = {k: np.asarray(v)
                             for k, v in gp.as_dict().items()}
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_runs):
    return [r["mesh_cases"] for r in launched.wait()]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_mesh_layouts_match_jax(ranks):
    devs = jax.devices()[:4]
    ids = {d.id: i for i, d in enumerate(devs)}
    j22 = np.vectorize(lambda d: ids[d.id])(
        jmesh.make_mesh((2, 2), ("data", "model"), devs).devices)
    for r, res in enumerate(ranks):
        pos = tuple(int(c) for c in np.argwhere(j22 == r)[0])
        for i, a in enumerate(("data", "model")):
            coord, line = res["m22"][a]
            assert coord == pos[i]
            want = np.moveaxis(j22, i, -1)[pos[:i] + pos[i + 1:]]
            assert list(line) == want.tolist()
    # DataParallel: this rank's rows over 'data'
    for r, res in enumerate(ranks):
        i = res["m22"]["data"][0]
        np.testing.assert_array_equal(res["dp_rows"],
                                      np.arange(8.0)[4 * i:4 * i + 4])
        assert res["dp_devices"] == 4
    jh = jmesh.hybrid_mesh((1, 2), (2, 1), ("data", "model"), devs)
    assert ranks[0]["hybrid"] == np.vectorize(
        lambda d: ids[d.id])(jh.devices).tolist()
    js = jmesh.mesh_slices(2, devices=devs)
    assert ranks[0]["slices"] == [
        np.vectorize(lambda d: ids[d.id])(m.devices).tolist() for m in js]


def test_param_sharding_matches_jax(ranks):
    import jax.numpy as jnp

    mesh = jmesh.make_mesh((2, 2), ("data", "model"), jax.devices()[:4])
    want = japi.param_sharding(
        mesh, {"w": jnp.zeros((6, 4)), "v": jnp.zeros((3, 5)),
               "s": jnp.zeros(())}, zero_axis="data")
    got = ranks[0]["sharding"]
    for k, sh in want.items():
        assert tuple(got[k]) == tuple(sh.spec) + (None,) * (
            len(got[k]) - len(tuple(sh.spec))), k


def test_placement_plans_match_jax():
    params = {"a": np.zeros((4, 3)), "b": np.zeros((4,))}
    assert tplacement.leading_axis_plan(params, "stage") == \
        jplacement.leading_axis_plan(params, "stage")
    for fn in ("pipeline_param_attrs", "expert_param_attrs"):
        got = getattr(tplacement, fn)(params)
        want = getattr(jplacement, fn)(params)
        assert {k: tuple(v.attr.sharding) for k, v in got.items()} == \
            {k: tuple(v.attr.sharding) for k, v in want.items()}
    plan = {"x": (None, "model"), "y": (None, None), "z": ("data",)}
    assert {k: tuple(v.attr.sharding) for k, v in
            tplacement.plan_param_attrs(plan).items()} == \
        {k: tuple(v.attr.sharding) for k, v in
         jplacement.plan_param_attrs(plan).items()}
    for part in ("col", "row"):
        tp, tl = tplacement.stage_attrs(part, "model")
        jp, jl = jplacement.stage_attrs(part, "model")
        assert tuple(tp.sharding) == tuple(jp.sharding)
        assert tuple(tl.sharding) == tuple(jl.sharding)
    with pytest.raises(ValueError):
        tplacement.stage_attrs("diag")
    assert tplacement.KNOWN_AXES == jplacement.KNOWN_AXES
    tc = tmoe.MoEConfig(num_experts=4, top_k=2)
    jc = jmoe.MoEConfig(num_experts=4, top_k=2)
    assert tc.param_plan("blk0_moe.") == jc.param_plan("blk0_moe.")
    assert {k: tuple(v.sharding) for k, v in tc.param_attrs().items()} == \
        {k: tuple(v.sharding) for k, v in jc.param_attrs().items()}


def test_init_builds_the_mesh_from_its_flags(ranks):
    shape, devices = ranks[0]["init_mesh"]
    assert shape == {"data": 2, "model": 2}
    assert devices == [[0, 1], [2, 3]]
    assert "needs 8 devices, found 4" in ranks[0]["init_8"]


def test_model_parallel_mlp_matches_jax_and_one_device(ranks, jax_runs):
    jc, jp = jax_runs["tp"]
    pc, pp = jax_runs["plain"]
    for res in ranks[:2]:
        np.testing.assert_allclose(res["tp_costs"], jc, rtol=COST_RTOL)
        np.testing.assert_allclose(res["tp_costs"], pc, rtol=COST_RTOL)
        for k in jp:
            assert _rel(res["tp_params"][k], jp[k]) <= PARAM_RTOL, k
            assert _rel(res["tp_params"][k], pp[k]) <= PARAM_RTOL, k
        # every weight is split: each rank holds half
        for k, shape in res["tp_local"].items():
            assert int(np.prod(shape)) * 2 == jp[k].size or \
                k in ("mp_fc1.b", "mp_out.b"), k


def test_multitask_trainer_on_a_data_mesh_matches_jax(ranks, jax_runs):
    for res in ranks[:2]:
        np.testing.assert_allclose(res["gan_costs"], jax_runs["gan_costs"],
                                   rtol=COST_RTOL)
        for k, v in jax_runs["gan_params"].items():
            assert _rel(res["gan_params"][k], v) <= PARAM_RTOL, k


def _jbatch_stat_step(layer_name, init, rows):
    """JAX's one Sgd step of the layer's graph on the whole batch (its
    GSPMD counts the statistics over the global batch): (cost, weights
    after)."""
    from paddle_tpu import layer
    from paddle_tpu.models import transformer as jtransformer

    jpaddle.topology.reset_name_scope()
    if layer_name == "batch_norm":
        x = layer.data(name="x", type=jpaddle.data_type.dense_vector(4))
        y = layer.data(name="y", type=jpaddle.data_type.integer_value(2))
        h = layer.batch_norm(input=layer.fc(input=x, size=8))
        cost = layer.classification_cost(input=layer.fc(input=h, size=2),
                                         label=y)
    else:
        *_, cost = jtransformer.build(**dict(R.LM, n_layers=1,
                                             moe_experts=2))
    costs = cost if isinstance(cost, list) else [cost]
    params = jpaddle.Parameters.from_topology(
        jpaddle.topology.Topology(costs), seed=0)
    for k, v in init.items():
        params[k] = v
    sgd = jtrainer.SGD(cost=cost, parameters=params,
                       update_equation=jopt.Sgd(learning_rate=0.1))
    got = []
    sgd.train(lambda: iter([[tuple(r) for r in rows]]), num_passes=1,
              event_handler=lambda ev: got.append(float(ev.cost))
              if type(ev).__name__ == "EndIteration" else None)
    return got[0], {k: np.asarray(params[k]) for k in params.names()}


@pytest.mark.parametrize("layer_name", ["batch_norm", "moe_ffn"])
def test_batch_statistics_refuse_a_split_data_axis(ranks, layer_name):
    """Once refused on a split data axis, both layers now pool their
    statistics over it: the 2-rank step equals JAX's on the whole
    batch."""
    res0 = ranks[0]["refusals"][layer_name]
    with f32_policy():
        cost, after = _jbatch_stat_step(layer_name, res0["init"],
                                        res0["rows"])
    for res in ranks[:2]:
        got = res["refusals"][layer_name]
        assert got["error"] == "no error", got["error"]
        np.testing.assert_allclose(got["cost"], cost, rtol=COST_RTOL)
        # Sgd, not Adam: the bias before batch norm has a zero gradient,
        # whose rounding noise Adam would scale up to a full step
        for k, v in after.items():
            np.testing.assert_allclose(got["after"][k], v, rtol=PARAM_RTOL,
                                       atol=1e-6, err_msg=k)


def test_mesh_argument_is_checked():
    import paddle_tpu_torch as tpaddle
    from paddle_tpu_torch import optimizer as topt

    cost = R._dp_cost()
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([cost]), device="cpu")
    with pytest.raises(Exception, match="parallel.Mesh"):
        ttrainer.SGD(cost, params, topt.Sgd(), mesh=object(), device="cpu")
    with pytest.raises(Exception, match="parallel.Mesh"):
        ttrainer.MultiTaskTrainer(
            [ttrainer.TaskSpec("t", cost, topt.Sgd())], params,
            mesh=object(), device="cpu")


def test_rank_side_modules_import_no_jax():
    """A gloo rank is a port process: the modules it imports
    (``torch_parallel_ranks``, ``torch_threads``) import neither ``jax``
    nor ``paddle_tpu``."""
    import ast
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("torch_parallel_ranks.py", "torch_threads.py"):
        with open(os.path.join(here, name)) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names] + [
            n.module for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m in ("jax", "paddle_tpu")
                    or m.startswith(("jax.", "paddle_tpu."))], name


def test_comm_budgets_and_moe_stats_match_jax():
    """``moe_contract``/``pipeline_contract``'s closed-form bytes equal
    JAX's, and ``record_moe_stats`` lands the same gauges and counter."""
    import types

    from paddle_tpu.obs.registry import MetricsRegistry as JRegistry
    from paddle_tpu.parallel import pipeline as jpipeline
    from paddle_tpu_torch.obs.registry import MetricsRegistry as TRegistry
    from paddle_tpu_torch.parallel import pipeline as tpipeline

    for n in (1, 2, 4):
        jm = jmesh.make_mesh((n,), ("expert",), jax.devices()[:n])
        tm = types.SimpleNamespace(shape={"expert": n},
                                   axis_names=("expert",))
        for stats in (False, True):
            assert tmoe.moe_contract(tm, "expert", 8, 40, 16, stats) \
                .comm_bytes == jmoe.moe_contract(jm, "expert", 8, 40, 16,
                                                 stats).comm_bytes
        jp = jmesh.make_mesh((n,), ("stage",), jax.devices()[:n])
        tp = types.SimpleNamespace(shape={"stage": n}, axis_names=("stage",))
        args = (6, (8, 16), np.float32, (), np.float32)
        assert tpipeline.pipeline_contract(tp, "stage", *args).comm_bytes \
            == jpipeline.pipeline_contract(jp, "stage", *args).comm_bytes
    stats = {"drop_rate": 0.25,
             "expert_fraction": np.array([0.5, 0.25, 0.125, 0.125])}
    jreg, treg = JRegistry(), TRegistry()
    jmoe.record_moe_stats(stats, registry=jreg)
    tmoe.record_moe_stats(stats, registry=treg)
    assert treg.snapshot() == jreg.snapshot()


_JOIN = r"""
import sys
import torch
import torch.distributed as dist
import paddle_tpu_torch as paddle
from paddle_tpu_torch.platform import device

pid, port = int(sys.argv[1]), sys.argv[2]
paddle.init(device="cpu", coordinator_address=f"127.0.0.1:{port}",
            num_processes=2, process_id=pid, mesh_shape="2",
            mesh_axes="data")
mesh = device.default_mesh()
t = torch.full((3,), float(pid + 1))
dist.all_reduce(t, group=mesh.group("data"))
print(dist.get_world_size(), dict(mesh.shape), t.tolist(), flush=True)
dist.destroy_process_group()
"""


def test_init_joins_a_two_process_job():
    """``init(coordinator_address=, num_processes=, process_id=)`` joins
    two real processes through a TCP store (JAX's
    ``tests/test_multiprocess.py`` shape); the default mesh spans both
    and an all-reduce over its axis sees both."""
    import os
    import subprocess
    import sys

    from paddle_tpu_torch.platform.virtual import free_port

    port = str(free_port())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, "-c", _JOIN, str(i), port],
                              env=env, cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "2 {'data': 2} [3.0, 3.0, 3.0]", out
