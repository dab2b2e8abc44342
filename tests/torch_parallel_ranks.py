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
    # C10: a data x expert mesh, each data rank on its half of the batch
    mesh = make_mesh((2, 2), ("data", "expert"))
    sgd = _lm_sgd(params_np, mesh=mesh, moe_experts=4)
    feeds = _lm_feeds(sgd, samples)
    out["dx_losses"] = [float(sgd.step(feeds))]
    out["dx_params"], _ = _whole(sgd)
    out["dx_local_w1"] = tuple(sgd.parameters["blk0_moe.w1"].shape)
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
    """One Sgd step of batch norm's and the MoE LM's training graphs on
    a split data axis, their statistics pooled over it: {layer: {"error":
    the error's text or "no error", "rows": the global batch, "init" and
    "after": the weights, "cost": the global cost}}."""
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
            [(np.arange(4, dtype=np.float32) * (i + 1) - i, i % 2)
             for i in range(4)]

    def moe_cost():
        *_, cost = transformer.build(**dict(LM, n_layers=1, moe_experts=2))
        return cost, [([1, 2, 3], [0, 1, 2], [2, 3, 4]),
                      ([4, 5, 6], [0, 1, 2], [5, 6, 7]),
                      ([7, 1, 9], [0, 1, 2], [1, 9, 2]),
                      ([3, 3, 8], [0, 1, 2], [3, 8, 4])]

    out = {}
    for name, build in (("batch_norm", bn_cost), ("moe_ffn", moe_cost)):
        topology.reset_name_scope()
        cost, rows = build()
        costs = cost if isinstance(cost, list) else [cost]
        params = Parameters.from_topology(topology.Topology(costs), seed=0,
                                          device="cpu")
        res = {"rows": rows, "init": {k: params.get(k).copy()
                                      for k in params.names()}}
        sgd = trainer.SGD(cost=cost, parameters=params,
                          update_equation=optimizer.Sgd(learning_rate=0.1),
                          mesh=mesh, device="cpu")
        try:
            res["cost"] = float(sgd.step(sgd._make_feeder(None).feed(rows)))
            res["error"] = "no error"
        except EnforceError as e:
            res["error"] = str(e)
        res["after"] = {k: params.get(k) for k in params.names()}
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving: the engine, its attention and the fleet over
# mesh slices
# ---------------------------------------------------------------------------

TP_ENGINE = dict(eos_id=1, page_size=4, num_pages=64, max_pages_per_seq=12,
                 max_slots=4, buckets=(4, 8, 16), prefill_chunk=8)


def _serving_model(params, cfg):
    from paddle_tpu_torch.convert import decoder_lm_from_numpy
    from paddle_tpu_torch.serving import DecoderLM

    return decoder_lm_from_numpy(params, DecoderLM(**cfg, device="cpu"))


def _drained(eng):
    assert eng.pool.total_refs == 0
    assert eng.pool.num_free + eng.pool.num_reclaimable == \
        eng.pool.num_usable
    eng.check_page_conservation()


def _tp_engine(model, mesh, **kw):
    from paddle_tpu_torch.serving import ServingEngine

    return ServingEngine(model, mesh=mesh, device="cpu",
                         **dict(TP_ENGINE, **kw))


def _serve_prompts(eng, prompts, max_tokens=8):
    rids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    res = eng.run(max_ticks=500)
    _drained(eng)
    return [res[r] for r in rids]


def slice_fleet_drive(FleetRouter, make_engine, prompts, waves,
                      tail_ticks=0, **kw):
    """One drive of a fleet over 2-way mesh slices, written once for
    both packages (``FleetRouter``/``make_engine`` are the package's):
    each wave of ``prompts`` is submitted after ``waves``' ticks, then
    the fleet runs to its drain and ``tail_ticks`` idle ticks more;
    returns the streams, statuses, results, states, snapshot and the
    autoscaler's counters."""
    fl = FleetRouter.over_mesh_slices(make_engine, tp=2, **kw)
    streams: Dict[int, list] = {}
    frids = []
    for wave, ticks in zip(prompts, waves):
        for _ in range(ticks):
            fl.step()
        if callable(wave):
            wave = wave(prompts[0], streams)
        frids += [fl.submit(p, max_tokens=6,
                            on_token=lambda t, i=len(frids) + j:
                            streams.setdefault(i, []).append(t))
                  for j, p in enumerate(wave)]
    fl.run(max_ticks=500)
    for _ in range(tail_ticks):
        fl.step()
    fl.check_fleet_conservation()
    auto = fl.autoscaler
    return dict(
        streams=[streams.get(i, []) for i in range(len(frids))],
        status=[str(fl.status(f)) for f in frids],
        results=[fl.result(f) for f in frids],
        states=[str(r.state) for r in fl.replicas],
        roles=[r.role for r in fl.replicas],
        snapshot=fl.snapshot(),
        autoscale=None if auto is None else (
            auto.scale_ups, auto.scale_downs, auto.replica_ticks))


KILL_TICK, WAVE_TICKS = 14, (0, 6, 6)


def slice_fleet_scenarios(FleetRouter, ManualClock, FleetFaultPlan,
                          AutoscalePolicy, make_engine, fleet):
    """C9's two drives over 2 slices of 2: a disaggregated fleet (roles
    prefill and decode, int8 pages, blob 1 dropped in flight, three
    waves, the decode slice killed at ``KILL_TICK``) and an autoscaled
    unified fleet that drains its idle second slice."""
    plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                          kill_at={KILL_TICK: 1}, drop_migration_at={1})
    # the prefill slice's small pool evicts the first wave's parked
    # prefix under the second wave, so the third wave's prompts are
    # seeded from the decode slice's cache
    disagg = slice_fleet_drive(
        FleetRouter, lambda i, t, m: make_engine(
            i, t, m, "int8", 12 if i == 0 else 32),
        fleet["waves"], WAVE_TICKS, faults=plan, heartbeat_s=0.05,
        resubmit_budget=2, roles=("prefill", "decode"), migrate_budget=8)
    auto = slice_fleet_drive(
        FleetRouter, lambda i, t, m: make_engine(i, t, m, None, 32),
        fleet["waves"][:1], (0,), tail_ticks=4,
        faults=FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01)),
        heartbeat_s=0.05, autoscale=AutoscalePolicy(
            min_replicas=1, max_replicas=2, queue_wait_hi_ms=1e9,
            cooldown_ticks=1))
    return {"disagg": disagg, "autoscale": auto}


def serving_tp_cases(rank, world, cases, logit_prompt, attn, cow, chaos,
                     fleet):
    """The tensor-parallel engine over a 'model' axis of each case's tp
    (greedy tokens with the compact and the kernel row packing, the
    shard's full-forward logits, its per-rank pool bytes), the per-rank
    attention over tp 2, the COW fork and prefix hit and the chaos spot
    run at tp 2, and a fleet over 2-rank mesh slices with slice 0 killed
    at tick 6."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.serving import (FaultPlan, FleetFaultPlan,
                                          FleetRouter, ManualClock,
                                          reference_logits)
    from paddle_tpu_torch.serving.fleet import SliceProxy
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_tp

    meshes = {n: make_mesh((n,), ("model",)) for n in (1, 2, 4)}
    out: Dict[str, object] = {}
    for c in cases:
        mesh, key = meshes[c["tp"]], c["key"]
        if not mesh.member:
            continue
        model = _serving_model(c["params"], c["cfg"])
        for use_kernel in (False, True):
            eng = _tp_engine(model, mesh, use_kernel=use_kernel,
                             **c.get("kw", {}))
            out[f"{key}_k{int(use_kernel)}"] = _serve_prompts(
                eng, c["prompts"])
        hz = eng.healthz()
        out[f"{key}_tp"], out[f"{key}_kv_bytes"] = hz["tp"], hz["kv_bytes"]
        out[f"{key}_pages"] = eng.pool.num_usable
        out[f"{key}_logits"] = reference_logits(eng.model, logit_prompt)
        out[f"{key}_wq"] = tuple(eng.model.layers[0].wq.shape)
        out[f"{key}_pool"] = tuple(eng._kv.k.shape)
        out[f"{key}_comm"] = eng.tp_step_comm_bytes(100)
    m2 = meshes[2]
    if m2.member:
        n = m2.axis_size("model")
        hs = attn["q"].shape[1] // n
        ks = attn["kp"].shape[2] // n
        lo, klo = m2.coord("model") * hs, m2.coord("model") * ks
        got = ragged_paged_attention_tp(
            m2, "model", _t(attn["q"][:, lo:lo + hs]),
            _t(attn["kp"][:, :, klo:klo + ks]),
            _t(attn["vp"][:, :, klo:klo + ks]), _t(attn["table"]),
            _t(attn["lens"]), _t(attn["row_seq"]), _t(attn["qpos"]),
            use_kernel=True)
        out["attn"] = got
        # the COW fork and a prefix hit on the split pool
        model = _serving_model(cow["params"], cow["cfg"])
        eng = _tp_engine(model, m2)
        toks = []
        for p in cow["prompts"]:
            rid = eng.submit(p, max_tokens=6)
            toks.append(eng.run(max_ticks=400)[rid])
        _drained(eng)
        snap = eng.metrics.snapshot()
        out["cow_tokens"] = toks
        out["cow_forks"] = snap["cow_forks"]
        out["cow_hit_rate"] = snap["prefix_hit_rate"]
        # the chaos spot run: a transient decode error, page pressure, a
        # poisoned slot on an int8 split pool
        model = _serving_model(chaos["params"], chaos["cfg"])
        faults = FaultPlan(decode_errors={3: 1}, page_pressure=(2, 8, 12))
        eng = _tp_engine(model, m2, kv_dtype="int8", faults=faults)
        rids = [eng.submit(p, max_tokens=8) for p in chaos["prompts"]]
        eng.step()
        faults.poison_nan(rids[2])
        eng.run(max_ticks=800)
        _drained(eng)
        out["chaos_status"] = [str(eng.status(r)) for r in rids]
        out["chaos_results"] = [eng.result(r) for r in rids]
        out["chaos_retries"] = eng.metrics.retries
    else:
        # only the mesh's ranks build its engine
        from paddle_tpu_torch.platform.enforce import EnforceError

        try:
            _tp_engine(_serving_model(cow["params"], cow["cfg"]), m2)
        except EnforceError as e:
            out["outside_error"] = str(e)
    # a fleet whose replica is a 2-rank slice, on every rank
    model = _serving_model(fleet["params"], fleet["cfg"])
    plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                          kill_at={6: 0})

    def mk(i, time_fn, mesh):
        return _tp_engine(model, mesh, time_fn=time_fn, num_pages=32,
                          max_pages_per_seq=8, buckets=(8, 16),
                          prefill_chunk=None)

    fl = FleetRouter.over_mesh_slices(mk, tp=2, heartbeat_s=0.05,
                                      resubmit_budget=2, faults=plan)
    streams: Dict[int, list] = {}
    frids = [fl.submit(p, max_tokens=6,
                       on_token=lambda t, i=i: streams.setdefault(
                           i, []).append(t))
             for i, p in enumerate(fleet["prompts"])]
    fl.run(max_ticks=500)
    fl.check_fleet_conservation()
    out["fleet_n"] = len(fl.replicas)
    out["fleet_tp"] = [r.engine.tp for r in fl.replicas]
    out["fleet_proxy"] = [isinstance(r.engine, SliceProxy)
                          for r in fl.replicas]
    out["fleet_streams"] = [streams.get(i, []) for i in range(len(frids))]
    out["fleet_status"] = [str(fl.status(f)) for f in frids]
    out["fleet_results"] = [fl.result(f) for f in frids]
    out["fleet_snapshot"] = fl.snapshot()
    out["fleet_states"] = [str(r.state) for r in fl.replicas]
    # C9: roles, page migration and the autoscaler over the slices
    from paddle_tpu_torch.serving.control import AutoscalePolicy

    def mk_c9(i, time_fn, mesh, kv_dtype, num_pages):
        kw = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
        return _tp_engine(model, mesh, time_fn=time_fn, num_pages=num_pages,
                          max_pages_per_seq=8, buckets=(8, 16),
                          prefill_chunk=None, **kw)

    out["c9"] = slice_fleet_scenarios(FleetRouter, ManualClock,
                                      FleetFaultPlan, AutoscalePolicy,
                                      mk_c9, fleet)
    return out


# ---------------------------------------------------------------------------
# row-sharded sparse tables
# ---------------------------------------------------------------------------


def sparse_cases(rank, world, lookup, batch, a2a, update, train, updater):
    """``sharded_lookup`` (whole ids, and ids split over 'data'),
    ``alltoall_lookup`` over a 4-rank 'model' axis, ``sharded_row_update``,
    10 steps of sharded embedding regression and the meshed
    ``SparseEmbeddingUpdater``, each rank returning its own rows."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import sparse as sp

    m22 = make_mesh((2, 2), ("data", "model"))
    m4 = make_mesh((4,), ("model",))
    out: Dict[str, object] = {}
    shard = sp.shard_table(m22, _t(lookup["table"]), "model")
    out["lookup"] = sp.sharded_lookup(m22, shard, _t(lookup["ids"]),
                                      axis="model")
    d = m22.coord("data")
    ids = batch["ids"].reshape(2, -1)[d]
    out["batch"] = sp.sharded_lookup(
        m22, sp.shard_table(m22, _t(batch["table"]), "model"), _t(ids),
        axis="model")
    k = a2a["ids"].shape[0] // 4
    out["a2a"] = sp.alltoall_lookup(
        m4, sp.shard_table(m4, _t(a2a["table"]), "model"),
        _t(a2a["ids"][rank * k:(rank + 1) * k]), axis="model")
    out["update"] = sp.sharded_row_update(
        m22, sp.shard_table(m22, _t(update["table"]), "model"),
        sp.SelectedRows(_t(update["ids"]), _t(update["rows"]),
                        update["table"].shape[0]), 0.5, axis="model")
    tab = sp.shard_table(m22, _t(train["table"]), "model")
    for ids, tgt in train["steps"]:
        rows = sp.sharded_lookup(m22, tab, _t(ids),
                                 axis="model").requires_grad_(True)
        d_rows, = torch.autograd.grad(torch.mean((rows - _t(tgt)) ** 2),
                                      rows)
        sp.sharded_row_update(
            m22, tab, sp.SelectedRows(_t(ids), d_rows,
                                      train["table"].shape[0]),
            train["lr"], axis="model")
    out["train"] = tab
    upd = sp.SparseEmbeddingUpdater(mesh=m22, sparse_params=("emb",))
    emb = sp.shard_table(m22, _t(updater["p"]), "model")
    upd.apply({"emb": emb}, {"emb": _t(updater["g"])}, lr=0.1,
              ids={"emb": _t(updater["ids"])})
    out["updater"] = emb
    w = _t(updater["p"]).clone()
    upd.apply({"w": w}, {"w": _t(updater["g"])}, lr=0.1)
    out["updater_dense"] = w
    return out


# ---------------------------------------------------------------------------
# local SGD
# ---------------------------------------------------------------------------


def _quad_grad(params, feeds):
    w = params["w"].detach().requires_grad_(True)
    loss = torch.mean((feeds["x"] @ w - feeds["y"]) ** 2)
    g, = torch.autograd.grad(loss, w)
    return loss.detach(), {"w": g}


def local_sgd_cases(rank, world, sync1, converge, discard):
    """JAX's three LocalSGD cases over a 4-rank 'data' axis: sync_period
    1 against plain SGD, sync_period 4 over 40 steps, and the lagged
    gradient discard."""
    from paddle_tpu_torch.parallel import LocalSGD, make_mesh

    mesh = make_mesh((4,), ("data",))
    out: Dict[str, object] = {}
    ls = LocalSGD(mesh, sync_period=1, learning_rate=sync1["lr"])
    params = ls.replicate({"w": _t(sync1["w0"])})
    step = ls.make_step(_quad_grad)
    for i, (x, y) in enumerate(sync1["steps"]):
        params, _ = step(params, i, {"x": _t(x), "y": _t(y)})
    out["sync1"] = ls.average(params)["w"]
    ls = LocalSGD(mesh, sync_period=4, learning_rate=0.1)
    params = ls.replicate({"w": _t(converge["w0"])})
    step = ls.make_step(_quad_grad)
    losses = []
    for i, (x, y) in enumerate(converge["steps"]):
        params, loss = step(params, i, {"x": _t(x), "y": _t(y)})
        losses.append(float(loss))
    out["converge_losses"] = losses
    out["converge_w"] = params["w"]
    for key, ratio, x in (("clean", 0.0, discard["x"]),
                          ("poisoned", 0.0, discard["x_bad"]),
                          ("guarded", 3.0, discard["x_bad"])):
        ls = LocalSGD(mesh, sync_period=1, learning_rate=0.01,
                      lagged_grad_discard_ratio=ratio)
        params = ls.replicate({"w": torch.ones(2, 1)})
        params, _ = ls.make_step(_quad_grad)(
            params, 0, {"x": _t(x), "y": _t(discard["y"])})
        out[f"discard_{key}"] = ls.average(params)["w"]
    return out


# ---------------------------------------------------------------------------
# batch statistics pooled over 'data', and async checkpoints on a mesh
# ---------------------------------------------------------------------------


def pooled_moe_cases(rank, world, x, router, w1, b1, w2, b2, dy, cases):
    """``moe_ffn_reference(group=)`` over a 2-rank 'data' axis, each rank
    on its rows of the global batch: its rows' output, the global aux
    loss and drop rate, and the gradients of the global
    sum(y * dy) + aux (each rank's part: its rows, aux / N)."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.moe import MoEParams, moe_ffn_reference

    _f32()
    mesh = make_mesh((world,), ("data",))
    group = mesh.group("data")
    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    out: Dict[str, np.ndarray] = {}
    for c in cases:
        xt = _t(x[rows], grad=True)
        p = MoEParams(*(_t(a, grad=True) for a in (router, w1, b1, w2, b2)))
        y, aux, st = moe_ffn_reference(xt, p, capacity_factor=c["cf"],
                                       top_k=c["k"], return_stats=True,
                                       group=group)
        ((y * _t(dy[rows])).sum() + aux / world).backward()
        key = c["key"]
        out[f"{key}_y"] = y.detach()
        out[f"{key}_aux"] = aux.detach()
        out[f"{key}_drop"] = st["drop_rate"]
        out[f"{key}_fraction"] = st["expert_fraction"]
        out[f"{key}_dx"] = xt.grad
        for name, t in zip(("router", "w1", "b1", "w2", "b2"), p):
            out[f"{key}_d{name}"] = t.grad
    return out


def bn_graph(paddle):
    """fc(8, relu) -> batch_norm -> fc(4) -> classification cost, named
    so both packages key the weights alike."""
    layer = paddle.layer
    paddle.topology.reset_name_scope()
    x = layer.data(name="x", type=paddle.data_type.dense_vector(8))
    y = layer.data(name="y", type=paddle.data_type.integer_value(4))
    h = layer.fc(input=x, size=8, act="relu", name="bn_fc")
    h = layer.batch_norm(input=h, name="bn")
    return layer.classification_cost(
        input=layer.fc(input=h, size=4, name="bn_head"), label=y)


def bn_train_case(rank, world, params_np, rows, steps):
    """A training ``batch_norm`` under ``SGD(mesh=data_parallel_mesh())``
    over 2 ranks, ``steps`` Sgd steps on one global batch: the costs,
    the weights and the moving statistics (the global batch's)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer, trainer
    from paddle_tpu_torch.convert import parameters_from_numpy
    from paddle_tpu_torch.parallel import data_parallel_mesh

    _f32()
    cost = bn_graph(paddle)
    params = parameters_from_numpy(params_np, "cpu")
    sgd = trainer.SGD(cost=cost, parameters=params,
                      update_equation=optimizer.Sgd(learning_rate=0.1),
                      mesh=data_parallel_mesh(), device="cpu")
    feeds = sgd._make_feeder({"x": 0, "y": 1}).feed(
        [(np.asarray(a, np.float32), int(b)) for a, b in rows])
    costs = [float(sgd.step(feeds)) for _ in range(steps)]
    return {"costs": costs,
            "params": {k: params.get(k) for k in params.names()},
            "state": {s: v for s, v in sgd.model_state["bn"].items()}}


def _slow_saves(ck_id: int, delay: float):
    """A ``TrainFaultPlan`` whose save hook holds the writer ``delay``
    seconds before it writes checkpoint ``ck_id``."""
    import time

    from paddle_tpu_torch.resilience.faults import TrainFaultPlan

    class Slow(TrainFaultPlan):
        def save_hook(self, ck):
            base = TrainFaultPlan.save_hook(self, ck)

            def hook(phase):
                if ck == ck_id and phase == "params":
                    time.sleep(delay)
                base(phase)
            return hook

    return Slow()


def async_ckpt_case(rank, world, params_np, batches, save_dir, delay):
    """``SGD.train(async_save=True, save_period_steps=1)`` over a 2-rank
    'data' mesh, the writer held ``delay`` s before the last save: the
    newest checkpoint each rank sees right after ``train()`` returns, and
    the cursor a ``resume=True`` trainer on each rank starts from."""
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.parallel import data_parallel_mesh

    _f32()
    mesh = data_parallel_mesh()
    data = _batches(batches)
    last = len(data)                   # ids 0..n-1 per step, n at pass end
    sgd, _ = _dp_sgd(params_np, mesh, "momentum")
    sgd._faults = _slow_saves(last, delay)
    sgd.train(lambda: iter(data), num_passes=1, save_dir=save_dir,
              save_period_steps=1, async_save=True, keep=0)
    seen = ckpt.latest_pass(save_dir)
    loaded = ckpt.load_latest(save_dir, device="cpu")
    sgd2, _ = _dp_sgd(params_np, mesh, "momentum")
    sgd2.train(lambda: iter(data), num_passes=2, save_dir=save_dir,
               save_period_steps=1, async_save=True, keep=0, resume=True)
    return {"latest": seen, "newest_written": last,
            "cursor": loaded[3]["cursor"],
            "resumed_steps": sgd2._global_step,
            "resumed_params": _whole(sgd2)[0]}
