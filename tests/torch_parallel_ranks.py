"""The port's side of the parallel tests: functions that run in each of
N gloo ranks (``paddle_tpu_torch.platform.virtual.start_ranks``).

Every function takes ``rank`` and ``world`` plus numpy inputs the test
made from a seed, builds the meshes it needs (every rank builds every
mesh, in the same order: ``new_group``'s contract), runs the port and
returns numpy arrays; the test holds them against the JAX package on its
virtual mesh.  This module imports torch and the port only: a rank never
imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.platform.flags import FLAGS


def run_all(rank, world, calls):
    """Several of this module's functions in one launch: ``calls`` is a
    list of (function name, kwargs); returns {name: result}."""
    mod = globals()
    return {name: mod[name](rank=rank, world=world, **kw)
            for name, kw in calls}


def _t(a, grad=False):
    t = torch.as_tensor(np.asarray(a))
    return t.requires_grad_(True) if grad else t


def _f32():
    FLAGS.use_bf16 = False


# ---------------------------------------------------------------------------
# ring and Ulysses attention
# ---------------------------------------------------------------------------


def ring_cases(rank, world, q, k, v, seg, dout, sizes=(2, 4)):
    """Ring and Ulysses outputs and q/k/v gradients (of sum(out * dout))
    over a 'seq' axis of each size, causal and not; each rank returns
    its sequence chunk's."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.ring import (ring_attention,
                                                ulysses_attention)

    _f32()
    meshes = {n: make_mesh((n,), ("seq",)) for n in sizes}
    out: Dict[str, np.ndarray] = {}
    for n, mesh in meshes.items():
        if not mesh.member:
            continue
        s = q.shape[1] // n
        cut = slice(rank * s, (rank + 1) * s)
        for fn_name, fn in (("ring", ring_attention),
                            ("ulysses", ulysses_attention)):
            for causal in (False, True):
                ql, kl, vl = (_t(a[:, cut], grad=True) for a in (q, k, v))
                o = fn(ql, kl, vl, mesh, axis="seq",
                       segment_ids=_t(seg[:, cut]), causal=causal)
                (o * _t(dout[:, cut])).sum().backward()
                key = f"{fn_name}_n{n}_c{int(causal)}"
                out[key] = o.detach().numpy()
                for name, t in (("dq", ql), ("dk", kl), ("dv", vl)):
                    out[f"{key}_{name}"] = t.grad.numpy()
    return out


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------


def moe_cases(rank, world, x, router, w1, b1, w2, b2, dy, cases):
    """Expert-parallel ``moe_ffn`` over an 'expert' axis of each case's
    size: output, aux loss, and the gradients of sum(y * dy) + aux for x,
    the router and this rank's experts."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.moe import (MoEParams, local_experts,
                                               moe_ffn)

    _f32()
    out: Dict[str, np.ndarray] = {}
    meshes = {n: make_mesh((n,), ("expert",))
              for n in sorted({c["n"] for c in cases})}
    for c in cases:
        mesh = meshes[c["n"]]
        if not mesh.member:
            continue
        xt = _t(x, grad=True)
        p = MoEParams(*(_t(a, grad=True) for a in local_experts(
            MoEParams(router, w1, b1, w2, b2), mesh)))
        y, aux, st = moe_ffn(mesh, xt, p, axis="expert",
                             capacity_factor=c["cf"], top_k=c["k"],
                             return_stats=True)
        ((y * _t(dy)).sum() + aux).backward()
        key = c["key"]
        out[f"{key}_y"] = y.detach().numpy()
        out[f"{key}_aux"] = aux.detach().numpy()
        out[f"{key}_drop"] = st["drop_rate"].detach().numpy()
        out[f"{key}_dx"] = xt.grad.numpy()
        for name, t in zip(("router", "w1", "b1", "w2", "b2"), p):
            out[f"{key}_d{name}"] = t.grad.numpy()
    return out


# ---------------------------------------------------------------------------
# the GPipe pipeline
# ---------------------------------------------------------------------------


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_cases(rank, world, ws, bs, mbs, tgt, sizes=(2, 4)):
    """``pipeline_apply`` of ``tanh(x @ w + b)`` stages over a 'stage'
    axis of each size (S stages a run, ``len(ws) / S`` layers a stage):
    the [M, mb, D] outputs, and the gradients of the mean squared error
    against ``tgt`` for this rank's stage weights, plain and remat."""
    from paddle_tpu_torch.parallel import (make_mesh, pipeline_apply,
                                           stack_stage_params)

    _f32()
    out: Dict[str, np.ndarray] = {}
    meshes = {s: make_mesh((s,), ("stage",)) for s in sizes}
    n_layers = len(ws)
    for s, mesh in meshes.items():
        if not mesh.member:
            continue
        per = n_layers // s
        local = stack_stage_params(
            [{"w": _t(np.stack(ws[j * per:(j + 1) * per])),
              "b": _t(np.stack(bs[j * per:(j + 1) * per]))}
             for j in range(s)], mesh, axis="stage")
        w = local["w"].requires_grad_(True)
        b = local["b"].requires_grad_(True)

        def stage_fn(p, x):
            for j in range(per):
                x = _tanh_stage({"w": p["w"][j], "b": p["b"][j]}, x)
            return x

        for remat in (False, True):
            w.grad = b.grad = None
            y = pipeline_apply(mesh, stage_fn, {"w": w, "b": b}, _t(mbs),
                               axis="stage", remat=remat)
            ((y - _t(tgt)) ** 2).mean().backward()
            key = f"s{s}_r{int(remat)}"
            out[f"{key}_y"] = y.detach().numpy()
            out[f"{key}_dw"] = w.grad[0].numpy()
            out[f"{key}_db"] = b.grad[0].numpy()
    return out


# ---------------------------------------------------------------------------
# data parallelism, ZeRO-1 and checkpoints across layouts
# ---------------------------------------------------------------------------


def _dp_cost():
    """``tests/test_dp_parity.py``'s model: fc(16 -> 32, relu) -> fc(4)
    -> classification cost."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import layer

    paddle.topology.reset_name_scope()
    x = layer.data(name="x", type=paddle.data_type.dense_vector(16))
    y = layer.data(name="y", type=paddle.data_type.integer_value(4))
    h = layer.fc(input=x, size=32, act="relu")
    return layer.classification_cost(input=layer.fc(input=h, size=4),
                                     label=y)


def _optimizer(name):
    from paddle_tpu_torch import optimizer

    if name == "momentum":
        return optimizer.Momentum(momentum=0.9, learning_rate=0.05)
    return optimizer.Adam(learning_rate=1e-2)


def _dp_sgd(params_np, mesh, opt, zero=None, zero_axis=None):
    from paddle_tpu_torch import trainer
    from paddle_tpu_torch.convert import parameters_from_numpy

    cost = _dp_cost()
    params = parameters_from_numpy(params_np, "cpu")
    return trainer.SGD(cost=cost, parameters=params,
                       update_equation=_optimizer(opt), mesh=mesh,
                       zero=zero, zero_axis=zero_axis, device="cpu"), params


def _batches(batches):
    return [[(np.asarray(x, np.float32), int(y)) for x, y in zip(bx, by)]
            for bx, by in batches]


def _whole(sgd):
    """The trainer's weights and slots, gathered whole (collectives)."""
    params, opt = sgd._ckpt_view()
    if sgd._zero_plan is not None:
        opt = sgd._zero_plan.gather_state(opt)
    return ({k: v.detach().numpy().copy() for k, v in dict(params).items()},
            {f"{s}/{k}": v.detach().numpy().copy()
             for s, d in opt["slots"].items() for k, v in d.items()})


def zero_cases(rank, world, params_np, batches, ckpt_dir, jax_ckpt_dir):
    """DP and DP + ZeRO-1 training over 4 ranks (Momentum and Adam) with
    the slot bytes each rank holds, and DP with ``zero_axis='data'`` (each
    weight's largest dim split, gathered for the forward); a ZeRO
    checkpoint saved on 4 ranks resumed on 2 and on 1; the JAX package's
    ZeRO checkpoint resumed on 4."""
    from paddle_tpu_torch.parallel import (build_zero_plan,
                                           data_parallel_mesh, make_mesh,
                                           opt_state_bytes_per_device)

    _f32()
    out: Dict[str, object] = {}
    data = _batches(batches)
    m4 = data_parallel_mesh()
    m2 = make_mesh((2,), ("data",))
    m1 = make_mesh((1,), ("data",))
    for opt in ("momentum", "adam"):
        for zero in (None, 1):
            sgd, params = _dp_sgd(params_np, m4, opt, zero)
            sgd.train(lambda: iter(data), num_passes=1,
                      event_handler=lambda ev: None)
            p, slots = _whole(sgd)
            key = f"{opt}_z{zero or 0}"
            out[f"{key}_params"] = p
            out[f"{key}_slot_bytes"] = opt_state_bytes_per_device(
                sgd.opt_state["slots"])
    for zero in (None, 1):
        sgd, params = _dp_sgd(params_np, m4, "momentum", zero,
                              zero_axis="data")
        out["zero_axis_local"] = {k: tuple(params[k].shape)
                                  for k in params.names()}
        sgd.train(lambda: iter(data), num_passes=1,
                  event_handler=lambda ev: None)
        out[f"zero_axis_z{zero or 0}_params"], _ = _whole(sgd)
    # the plan's entries over 4 ranks
    plan = build_zero_plan(m4, {k: _t(v) for k, v in params_np.items()})
    out["plan"] = {k: (e.shape, e.size, e.padded, e.sharded)
                   for k, e in plan.entries.items()}
    # ZeRO on 4 ranks, 2 steps, saved; resumed on 2 and 1 for one step
    sgd, _ = _dp_sgd(params_np, m4, "adam", 1)
    for b in data[:2]:
        sgd.step(sgd._make_feeder(None).feed(b))
    sgd.save_checkpoint(ckpt_dir, 0)
    out["saved_params"], out["saved_slots"] = _whole(sgd)
    for n, mesh in ((2, m2), (1, m1)):
        if not mesh.member:
            continue
        sgd2, _ = _dp_sgd(params_np, mesh, "adam", 1)
        sgd2.load_checkpoint(ckpt_dir, 0)
        cost = sgd2.step(sgd2._make_feeder(None).feed(data[2]))
        out[f"resume{n}_cost"] = float(cost)
        out[f"resume{n}_params"], out[f"resume{n}_slots"] = _whole(sgd2)
    # the JAX package's ZeRO checkpoint, resumed here on 4 ranks
    sgd4, _ = _dp_sgd(params_np, m4, "adam", 1)
    sgd4.load_checkpoint(jax_ckpt_dir, 0)
    out["from_jax_step"] = sgd4.opt_state["step"]
    cost = sgd4.step(sgd4._make_feeder(None).feed(data[2]))
    out["from_jax_cost"] = float(cost)
    out["from_jax_params"], _ = _whole(sgd4)
    return out


# ---------------------------------------------------------------------------
# SGD(pipeline=) and the MoE LM on an expert mesh
# ---------------------------------------------------------------------------

LM = dict(vocab_size=32, d_model=16, n_layers=4, n_heads=2, max_len=8)


def _lm_sgd(params_np, mesh=None, pipeline=None, moe_experts=0,
            zero=None):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer, trainer
    from paddle_tpu_torch.convert import parameters_from_numpy
    from paddle_tpu_torch.models import transformer

    paddle.topology.reset_name_scope()
    geom = dict(LM)
    if moe_experts:
        geom.update(n_layers=2, moe_experts=moe_experts)
    _, _, _, _, cost = transformer.build(**geom)
    params = parameters_from_numpy(params_np, "cpu")
    return trainer.SGD(cost=cost, parameters=params,
                       update_equation=optimizer.Adam(learning_rate=1e-2),
                       mesh=mesh, pipeline=pipeline, zero=zero,
                       device="cpu")


def _lm_feeds(sgd, samples):
    return sgd._make_feeder({"tokens": 0, "pos": 1, "target": 2}).feed(
        [tuple(list(x) for x in s) for s in samples])


def pipeline_sgd_cases(rank, world, params_np, samples, ckpt_dir,
                       steps=3):
    """``SGD(pipeline=)`` losses over ``steps`` Adam steps on one batch
    at 4 stages (a (1, 4) data x stage mesh), at 2 stages with 2 data
    ranks and with remat, and at 4 stages under ZeRO-1; the whole
    weights after; a 4-stage checkpoint loaded by a 2-stage trainer."""
    from paddle_tpu_torch.parallel import PipelineConfig

    _f32()
    out: Dict[str, object] = {}
    cfgs = {"s4": (PipelineConfig(num_stages=4, microbatches=4,
                                  n_layers=4, n_heads=2), None),
            "s2": (PipelineConfig(num_stages=2, microbatches=2,
                                  n_layers=4, n_heads=2), None),
            "s2_remat": (PipelineConfig(num_stages=2, microbatches=2,
                                        n_layers=4, n_heads=2,
                                        remat=True), None),
            "s4_zero": (PipelineConfig(num_stages=4, microbatches=4,
                                       n_layers=4, n_heads=2), 1)}
    for key, (cfg, zero) in cfgs.items():
        sgd = _lm_sgd(params_np, pipeline=cfg, zero=zero)
        feeds = _lm_feeds(sgd, samples)
        out[f"{key}_losses"] = [float(sgd.step(feeds))
                                for _ in range(steps)]
        out[f"{key}_params"], _ = _whole(sgd)
        out[f"{key}_local_wq"] = tuple(
            sgd.parameters["pipe_body.attn.wq"].shape)
        if key == "s4":
            sgd.save_checkpoint(ckpt_dir, 0)
    sgd2 = _lm_sgd(params_np, pipeline=cfgs["s2"][0])
    sgd2.load_checkpoint(ckpt_dir, 0)
    out["reload_params"], _ = _whole(sgd2)
    out["reload_cost"] = float(sgd2.step(_lm_feeds(sgd2, samples)))
    return out


def moe_lm_cases(rank, world, params_np, samples, steps=2):
    """The 2-layer MoE LM (4 experts) trained ``steps`` Adam steps over an
    'expert' axis of 2 (the expert-parallel layer path, experts cut to
    each rank's two); losses and the whole weights."""
    from paddle_tpu_torch.parallel import make_mesh

    _f32()
    out: Dict[str, object] = {}
    for n in (2,):
        mesh = make_mesh((n,), ("expert",))
        if not mesh.member:
            continue
        sgd = _lm_sgd(params_np, mesh=mesh, moe_experts=4)
        feeds = _lm_feeds(sgd, samples)
        out[f"e{n}_losses"] = [float(sgd.step(feeds)) for _ in range(steps)]
        out[f"e{n}_params"], _ = _whole(sgd)
        out[f"e{n}_local_w1"] = tuple(sgd.parameters["blk0_moe.w1"].shape)
    return out


# ---------------------------------------------------------------------------
# mesh helpers, init's flags, tensor parallelism, MultiTaskTrainer(mesh=)
# ---------------------------------------------------------------------------

TP = dict(hidden=[16, 16], in_dim=8, out_dim=4)


def _tp_cost(mp: bool):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import layer
    from paddle_tpu_torch.parallel import model_parallel_mlp

    paddle.topology.reset_name_scope()
    x = layer.data(name="x", type=paddle.data_type.dense_vector(
        TP["in_dim"]))
    y = layer.data(name="y", type=paddle.data_type.integer_value(
        TP["out_dim"]))
    if mp:
        logits = model_parallel_mlp(x, TP["hidden"], TP["out_dim"],
                                    axis="model")
    else:
        net = x
        for i, h in enumerate(TP["hidden"]):
            net = layer.fc(input=net, size=h, act="relu", name=f"mp_fc{i}")
        logits = layer.fc(input=net, size=TP["out_dim"], name="mp_out")
    return layer.classification_cost(input=logits, label=y)


def mesh_cases(rank, world, tp_params, tp_batches, gan_params, gan_feeds):
    """Mesh geometry, ``init``'s mesh flags, ``model_parallel_mlp`` over a
    2-rank 'model' axis (3 Adam steps, whole weights after, each rank's
    weight part shapes), and the GAN's alternating Adam steps through
    ``MultiTaskTrainer(mesh=)`` over 2 data ranks."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer, trainer
    from paddle_tpu_torch.convert import parameters_from_numpy
    from paddle_tpu_torch.models import gan
    from paddle_tpu_torch.parallel import (hybrid_mesh, make_mesh,
                                           mesh_slices)
    from paddle_tpu_torch.platform import device as pdevice

    _f32()
    out: Dict[str, object] = {}
    m22 = make_mesh((2, 2), ("data", "model"))
    out["m22"] = {a: (m22.coord(a), m22.axis_ranks(a))
                  for a in m22.axis_names}
    from paddle_tpu_torch.parallel import DataParallel

    dp = DataParallel(m22, "data")
    out["dp_rows"] = dp.shard_feeds({"x": _t(np.arange(8.0))})["x"]
    out["dp_devices"] = dp.num_devices
    hy = hybrid_mesh((1, 2), (2, 1), ("data", "model"))
    out["hybrid"] = hy.devices.tolist()
    out["slices"] = [s.devices.tolist() for s in mesh_slices(2)]
    from paddle_tpu_torch.parallel import param_sharding

    out["sharding"] = param_sharding(
        m22, {"w": _t(np.zeros((6, 4))), "v": _t(np.zeros((3, 5))),
              "s": _t(np.zeros(()))}, zero_axis="data")
    paddle.init(device="cpu", mesh_shape="2,2", mesh_axes="data,model")
    dm = pdevice.default_mesh()
    out["init_mesh"] = (dict(dm.shape), dm.devices.tolist())
    try:
        paddle.init(device="cpu", mesh_shape="8")
        out["init_8"] = "no error"
    except Exception as e:   # noqa: BLE001 - the message is the result
        out["init_8"] = str(e)
    paddle.init(device="cpu", mesh_shape="", mesh_axes="data")
    # tensor parallelism over ranks 0-1
    m2 = make_mesh((2,), ("model",))
    if m2.member:
        cost = _tp_cost(True)
        params = parameters_from_numpy(tp_params, "cpu")
        sgd = trainer.SGD(cost=cost, parameters=params,
                          update_equation=optimizer.Adam(learning_rate=1e-2),
                          mesh=m2, device="cpu")
        out["tp_local"] = {k: tuple(params[k].shape)
                           for k in params.names()}
        data = _batches(tp_batches)
        out["tp_costs"] = []
        def handler(ev):
            if type(ev).__name__ == "EndIteration":
                out["tp_costs"].append(float(ev.cost))

        sgd.train(lambda: iter(data), num_passes=1, event_handler=handler)
        out["tp_params"], _ = _whole(sgd)
    # MultiTaskTrainer(mesh=) over 2 data ranks
    md = make_mesh((2,), ("data",))
    if md.member:
        paddle.topology.reset_name_scope()
        _, _, _, d_cost, g_cost = gan.build(
            noise_dim=4, data_dim=2, gen_dims=(8,), dis_dims=(8,))
        gp = parameters_from_numpy(gan_params, "cpu")
        mt = trainer.MultiTaskTrainer(
            [trainer.TaskSpec("d", d_cost, optimizer.Adam(learning_rate=1e-2),
                              trainable="dis_"),
             trainer.TaskSpec("g", g_cost, optimizer.Adam(learning_rate=1e-2),
                              trainable="gen_")], gp, mesh=md, device="cpu")
        out["gan_costs"] = [mt.step(task, feeds) for task, feeds in gan_feeds]
        out["gan_params"] = {k: gp.get(k) for k in gp.names()}
        out["refusals"] = _batch_stat_refusals(md)
    return out


def _batch_stat_refusals(mesh):
    """One SGD step of batch norm's and the MoE LM's training graphs on
    a split data axis: each must refuse (its statistics would be each
    rank's); {layer: the error's text}."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import layer, optimizer, topology, trainer
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.platform.enforce import EnforceError

    def bn_cost():
        x = layer.data(name="x", type=paddle.data_type.dense_vector(4))
        y = layer.data(name="y", type=paddle.data_type.integer_value(2))
        h = layer.batch_norm(input=layer.fc(input=x, size=8))
        return layer.classification_cost(input=layer.fc(input=h, size=2),
                                         label=y), \
            [(np.full(4, i, np.float32), i % 2) for i in range(4)]

    def moe_cost():
        *_, cost = transformer.build(**dict(LM, n_layers=1, moe_experts=2))
        return cost, [([1, 2, 3], [0, 1, 2], [2, 3, 4])] * 4

    out = {}
    for name, build in (("batch_norm", bn_cost), ("moe_ffn", moe_cost)):
        topology.reset_name_scope()
        cost, rows = build()
        costs = cost if isinstance(cost, list) else [cost]
        params = Parameters.from_topology(topology.Topology(costs), seed=0,
                                          device="cpu")
        sgd = trainer.SGD(cost=cost, parameters=params,
                          update_equation=optimizer.Adam(learning_rate=1e-2),
                          mesh=mesh, device="cpu")
        try:
            sgd.step(sgd._make_feeder(None).feed(rows))
            out[name] = "no error"
        except EnforceError as e:
            out[name] = str(e)
    return out
