"""The parallel slice's workloads on one card, shared by ``chip_smoke.py``
and ``tests/test_torch_parallel_cuda.py``.

- ``train_moe``: bench.py's MoE configuration (bench.py:2099-2100):
  ``transformer.build`` at d_model 1024, 8 layers, 16 heads, seq 1024,
  vocab 32768, 8 experts, top-1, batch 4, trained through ``SGD``
  without a mesh (the dense dispatch, as the JAX package runs without an
  expert axis) with the headline's bf16 policy and Momentum 0.9 at 1e-3
  (``train_workload``); and its dense twin (``moe_experts=0``) at the
  same width.  :func:`moe_parity_step` holds a 2-layer, d 128, 4-expert
  copy's step on the card against the CPU path.
- ``parallel_world1``: a real one-rank NCCL process group
  (:func:`nccl_world1`); the headline transformer under
  ``SGD(mesh=data_parallel_mesh(), zero=1)`` and under
  ``SGD(pipeline=PipelineConfig(microbatches=4))`` against its no-mesh
  run from the same weights (:func:`headline_runs`), and the MoE layer on
  an ``expert`` axis of one rank against the dense path
  (:func:`moe_layer_world1`); DeepFM's full-width factor table through
  the row-sharded lookups and update on a 'model' axis of one
  (:func:`sparse_world1`), ``LocalSGD`` at ``sync_period`` 1 against
  plain SGD (:func:`local_sgd_world1`), and batch norm's and the MoE
  dispatch's statistics pooled over a 'data' axis of one against their
  unpooled runs (:func:`pooled_stats_world1`).  NCCL refuses two ranks
  on one device, so a one-card run stops at one rank; several ranks are
  the CPU gloo tests' (``tests/test_torch_parallel_*.py``,
  ``tests/test_torch_local_sgd.py``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.tools import train_workload as tw
from paddle_tpu_torch.tools.nmt_workload import f32_policy

MOE_MODEL = dict(vocab_size=32768, d_model=1024, n_layers=8, n_heads=16,
                 max_len=1024)
MOE_EXPERTS, MOE_TOP_K = 8, 1
MOE_BATCH, MOE_SEQ = 4, 1024
MOE_PARITY = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                  max_len=128, moe_experts=4)
MOE_PARITY_BATCH = 4
# the one-rank runs: steps from one set of weights
WORLD1_STEPS = 3
WORLD1_MICROBATCHES = 4


def numpy_weights(costs, seed: int) -> Dict[str, np.ndarray]:
    """The topology's weights from ``Parameters.from_topology`` on the
    host, as numpy: the same numbers on every device."""
    from paddle_tpu_torch import topology
    from paddle_tpu_torch.parameters import Parameters

    p = Parameters.from_topology(topology.Topology(costs), seed=seed,
                                 device="cpu")
    return {k: p.get(k) for k in p.names()}


def _costs(cfg) -> list:
    from paddle_tpu_torch import topology
    from paddle_tpu_torch.models import transformer

    topology.reset_name_scope()
    *_, cost = transformer.build(**cfg)
    return cost if isinstance(cost, list) else [cost]


def moe_trainer(device, moe_experts: int = MOE_EXPERTS,
                n_layers: int = MOE_MODEL["n_layers"],
                weights: Optional[Dict[str, np.ndarray]] = None, **cfg):
    """``SGD`` over the MoE LM (``moe_experts=0``: its dense twin) at
    bench.py's MoE width, Momentum as the headline's."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.convert import parameters_from_numpy
    from paddle_tpu_torch.parameters import Parameters

    geom = dict(MOE_MODEL, n_layers=n_layers, moe_experts=moe_experts,
                moe_top_k=MOE_TOP_K)
    geom.update(cfg)
    costs = _costs(geom)
    if weights is None:
        params = Parameters.from_topology(topology.Topology(costs),
                                          seed=tw.SEED, device=device)
    else:
        params = parameters_from_numpy(weights, device)
    return trainer.SGD(costs, params, optimizer.Momentum(
        momentum=tw.MOMENTUM, learning_rate=tw.LEARNING_RATE),
        device=device)


def moe_samples(seed: int, bs: int = MOE_BATCH, seq: int = MOE_SEQ,
                vocab: int = MOE_MODEL["vocab_size"]):
    return tw.lm_samples(seed, bs=bs, seq=seq, vocab=vocab)


def moe_parity_step(device) -> dict:
    """One Momentum step of the 2-layer, d 128, 4-expert LM on ``device``
    and on the CPU from the same numpy weights and batch, f32 (TF32 off
    on the card): the costs and each weight's update."""
    cfg = dict(MOE_PARITY)
    weights = numpy_weights(_costs(dict(cfg)), tw.SEED)
    samples = moe_samples(tw.SEED + 3, bs=MOE_PARITY_BATCH,
                          seq=cfg["max_len"], vocab=cfg["vocab_size"])
    out = {}
    with f32_policy():
        for dev in (device, torch.device("cpu")):
            sgd = moe_trainer(dev, weights=weights, **cfg)
            feeds = sgd._make_feeder(tw.FEEDING).feed(samples)
            cost = float(sgd.step(feeds))
            out[dev.type] = (cost, {k: sgd.parameters.get(k) - w
                                    for k, w in weights.items()})
    (gc, gu), (cc, cu) = out[device.type], out["cpu"]
    rel = {k: float(np.linalg.norm(gu[k] - cu[k])
                    / max(np.linalg.norm(cu[k]), 1e-30)) for k in cu}
    return {"cost_card": gc, "cost_cpu": cc,
            "cost_rel_diff": abs(gc - cc) / abs(cc),
            "update_rel_diff_max": max(rel.values()),
            "update_rel_diff_worst": max(rel, key=rel.get)}


# ---------------------------------------------------------------------------
# one-rank NCCL runs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def nccl_world1():
    """A one-rank NCCL process group on the current card over a TCP
    store on 127.0.0.1, destroyed on exit."""
    import torch.distributed as dist

    from paddle_tpu_torch.platform.virtual import free_port

    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _headline(device, weights, n_layers: int, **sgd_kw):
    from paddle_tpu_torch import optimizer, trainer
    from paddle_tpu_torch.convert import parameters_from_numpy

    costs = _costs(dict(tw.MODEL, n_layers=n_layers))
    params = parameters_from_numpy(weights, device)
    return trainer.SGD(costs[0], params, optimizer.Momentum(
        momentum=tw.MOMENTUM, learning_rate=tw.LEARNING_RATE),
        device=device, **sgd_kw)


def headline_runs(device, n_layers: int = tw.MODEL["n_layers"]) -> dict:
    """The headline transformer from one set of weights, ``WORLD1_STEPS``
    steps
    on one batch: without a mesh, under ``SGD(mesh=data_parallel_mesh(),
    zero=1)`` and under ``SGD(pipeline=PipelineConfig(microbatches=4))``
    (call inside :func:`nccl_world1`).  Per run: costs, step ms, the
    flash launches, and each run's weights' largest relative difference
    from the no-mesh run's."""
    from paddle_tpu_torch.parallel import (PipelineConfig,
                                           data_parallel_mesh)

    weights = numpy_weights(_costs(dict(tw.MODEL, n_layers=n_layers)),
                            tw.SEED)
    samples = tw.lm_samples(tw.SEED + 1)
    runs = {"no_mesh": {}, "dp_zero1": {
        "mesh": data_parallel_mesh(), "zero": 1},
        "pipeline": {"pipeline": PipelineConfig(
            microbatches=WORLD1_MICROBATCHES, n_layers=n_layers,
            n_heads=tw.MODEL["n_heads"])}}
    out: Dict[str, dict] = {}
    final: Dict[str, Dict[str, np.ndarray]] = {}
    for name, kw in runs.items():
        sgd = _headline(device, weights, n_layers, **kw)
        feeds = sgd._make_feeder(tw.FEEDING).feed(samples)
        tw.reset_flash_launches()
        costs, ms = [], []
        for _ in range(WORLD1_STEPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            costs.append(float(sgd.step(feeds)))
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = tw.flash_launches()
        params, _ = sgd._ckpt_view()
        final[name] = _unstack({k: v.detach().float().cpu().numpy()
                                for k, v in dict(params).items()})
        out[name] = {"costs": costs, "step_ms": ms, "launches": launches}
        del sgd, params
        torch.cuda.empty_cache()
    for name in ("dp_zero1", "pipeline"):
        ref = final["no_mesh"]
        out[name]["cost_rel_diff"] = max(
            abs(a - b) / abs(b) for a, b in zip(out[name]["costs"],
                                                out["no_mesh"]["costs"]))
        out[name]["param_rel_diff_max"] = max(
            float(np.linalg.norm(final[name][k] - ref[k])
                  / max(np.linalg.norm(ref[k] - weights[k]), 1e-30))
            for k in ref)
    return out


def _unstack(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``pipe_body.<suffix>`` [L, ...] stacks back to ``blk{i}_<suffix>``."""
    out = {}
    for k, v in params.items():
        if k.startswith("pipe_body."):
            for i in range(v.shape[0]):
                out[f"blk{i}_{k[len('pipe_body.'):]}"] = v[i]
        else:
            out[k] = v
    return out


def moe_layer_world1(device, tokens: int = 4096,
                     d: int = MOE_MODEL["d_model"]) -> dict:
    """The expert-parallel ``moe_ffn`` over an ``expert`` axis of one
    rank (its two ``all_to_all_single`` calls on NCCL) against the dense
    path on the same inputs at the MoE LM's width: output, aux loss and
    gradients (of sum(y * dy) + aux), f32 (call inside
    :func:`nccl_world1`)."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.moe import (MoEParams, init_moe_params,
                                               moe_ffn, moe_ffn_reference)

    mesh = make_mesh((1,), ("expert",))
    base = init_moe_params(tw.SEED, d, 4 * d, MOE_EXPERTS, device=device)
    rng = np.random.RandomState(tw.SEED + 4)
    x0 = torch.as_tensor(rng.randn(tokens, d).astype(np.float32),
                         device=device)
    dy = torch.as_tensor(rng.randn(tokens, d).astype(np.float32),
                         device=device)
    res = {}
    for name in ("ep", "dense"):
        x = x0.clone().requires_grad_(True)
        p = MoEParams(*(t.clone().requires_grad_(True) for t in base))
        if name == "ep":
            y, aux = moe_ffn(mesh, x, p, axis="expert")
        else:
            y, aux = moe_ffn_reference(x, p)
        ((y * dy).sum() + aux).backward()
        res[name] = [y.detach(), aux.detach(), x.grad] + [t.grad for t in p]
    errs = [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
            for a, b in zip(res["ep"], res["dense"])]
    return {"tokens": tokens, "d_model": d, "experts": MOE_EXPERTS,
            "max_rel_err": max(errs),
            "names": ["y", "aux", "dx", "drouter", "dw1", "db1", "dw2",
                      "db2"], "rel_errs": errs}


def events_ms(fn, reps: int = 10) -> float:
    """Card ms of one call: ``reps`` calls back to back between two CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def sparse_world1(device) -> dict:
    """DeepFM's factor table at Criteo's width (``ctr_workload``: 33.76 M
    rows x 10, f32) row-sharded over a 'model' axis of one rank:
    ``sharded_lookup`` and ``alltoall_lookup`` of one batch's ids (4096 x
    39) against the plain gather, ``sharded_row_update`` against
    ``sgd_update_rows`` (each must equal to the bit: the all-reduce and
    the reduce-scatter of one rank are identities), and the card ms of
    each (call inside :func:`nccl_world1`)."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import sparse as sp
    from paddle_tpu_torch.tools import ctr_workload as cw

    mesh = make_mesh((1,), ("model",))
    gen = torch.Generator(device=device).manual_seed(tw.SEED + 7)
    table = torch.randn((cw.VOCAB, cw.FACTOR), generator=gen,
                        device=device)
    ids = torch.randint(0, cw.VOCAB, (cw.BATCH * cw.FIELDS,),
                        generator=gen, device=device)
    rows = torch.randn((ids.numel(), cw.FACTOR), generator=gen,
                       device=device)
    grad = sp.SelectedRows(ids, rows, cw.VOCAB)
    shard = sp.shard_table(mesh, table)
    want = table.index_select(0, ids)
    res = {"rows": cw.VOCAB, "dim": cw.FACTOR, "ids": ids.numel()}
    res["lookup_equal"] = bool(torch.equal(
        sp.sharded_lookup(mesh, shard, ids), want))
    res["alltoall_equal"] = bool(torch.equal(
        sp.alltoall_lookup(mesh, shard, ids), want))
    got = sp.sharded_row_update(mesh, shard.clone(), grad, 0.05)
    res["row_update_equal"] = bool(torch.equal(
        got, sp.sgd_update_rows(table.clone(), grad, 0.05)))
    del got
    res["lookup_ms"] = events_ms(lambda: sp.sharded_lookup(mesh, shard,
                                                            ids))
    res["alltoall_ms"] = events_ms(lambda: sp.alltoall_lookup(mesh, shard,
                                                               ids))
    res["row_update_ms"] = events_ms(lambda: sp.sharded_row_update(
        mesh, shard, grad, 0.05))
    res["plain_gather_ms"] = events_ms(lambda: table.index_select(0, ids))
    del table, shard
    torch.cuda.empty_cache()
    return res


def local_sgd_world1(device, steps: int = 6) -> dict:
    """``LocalSGD(sync_period=1)`` over a 'data' axis of one rank against
    plain SGD on the same quadratic problem on the card (must equal to
    the bit: the averaging all-reduce of one rank is an identity and the
    mean divides by 1)."""
    from paddle_tpu_torch.parallel import LocalSGD, make_mesh

    mesh = make_mesh((1,), ("data",))
    gen = torch.Generator(device=device).manual_seed(tw.SEED + 8)
    true_w = torch.randn((256, 1), generator=gen, device=device)
    batches = []
    for _ in range(steps):
        x = torch.randn((4096, 256), generator=gen, device=device)
        batches.append((x, x @ true_w))

    def grad_fn(params, feeds):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean((feeds["x"] @ w - feeds["y"]) ** 2)
        g, = torch.autograd.grad(loss, w)
        return loss.detach(), {"w": g}

    w = torch.zeros((256, 1), device=device)
    for x, y in batches:
        w = w - 0.1 * grad_fn({"w": w}, {"x": x, "y": y})[1]["w"]
    ls = LocalSGD(mesh, sync_period=1, learning_rate=0.1)
    params = ls.replicate({"w": torch.zeros((256, 1), device=device)})
    step = ls.make_step(grad_fn)
    for i, (x, y) in enumerate(batches):
        params, _ = step(params, i, {"x": x, "y": y})
    got = ls.average(params)["w"]
    return {"steps": steps, "equal": bool(torch.equal(got, w)),
            "max_abs_diff": float((got - w).abs().max())}


def pooled_stats_world1(device, tokens: int = 4096,
                        d: int = MOE_MODEL["d_model"]) -> dict:
    """Batch norm's and the MoE dispatch's statistics pooled over a
    'data' axis of one rank (``group=`` the axis's NCCL group) against
    their unpooled runs on the same inputs: batch norm's plain version at
    [4096, 1024] (must equal to the bit) and its cuDNN path (error), the
    MoE LM's layer (8 experts, top-1, f32) with its gradients (relative
    error, from the global means' other rounding)."""
    from paddle_tpu_torch.ops import norm as pnorm
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.moe import (MoEParams, init_moe_params,
                                               moe_ffn_reference)

    mesh = make_mesh((1,), ("data",))
    group = mesh.group("data")
    gen = torch.Generator(device=device).manual_seed(tw.SEED + 9)
    x = torch.randn((tokens, d), generator=gen, device=device) * 3 + 1
    gamma = torch.rand((d,), generator=gen, device=device) + 0.5
    beta = torch.randn((d,), generator=gen, device=device)
    mm, mv = torch.zeros(d, device=device), torch.ones(d, device=device)
    kw = dict(train=True, momentum=0.9)
    pooled = pnorm.batch_norm_reference(x, gamma, beta, mm, mv, group=group,
                                        **kw)
    plain = pnorm.batch_norm_reference(x, gamma, beta, mm, mv, **kw)
    cudnn = pnorm.batch_norm(x, gamma, beta, mm, mv, **kw)
    res = {"bn": {"shape": [tokens, d],
                  "equal": all(bool(torch.equal(a, b))
                               for a, b in zip(pooled, plain)),
                  "vs_cudnn_max_abs": max(float((a - b).abs().max())
                                          for a, b in zip(pooled, cudnn))}}
    base = init_moe_params(tw.SEED, d, 4 * d, MOE_EXPERTS, device=device)
    dy = torch.randn((tokens, d), generator=gen, device=device)
    outs = {}
    for name, g in (("pooled", group), ("plain", None)):
        xi = x.clone().requires_grad_(True)
        p = MoEParams(*(t.clone().requires_grad_(True) for t in base))
        y, aux, st = moe_ffn_reference(xi, p, return_stats=True, group=g)
        ((y * dy).sum() + aux).backward()
        outs[name] = [y.detach(), aux.detach(), st["drop_rate"], xi.grad] \
            + [t.grad for t in p]
    errs = [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
            for a, b in zip(outs["pooled"], outs["plain"])]
    res["moe"] = {"tokens": tokens, "d_model": d, "experts": MOE_EXPERTS,
                  "names": ["y", "aux", "drop_rate", "dx", "drouter", "dw1",
                            "db1", "dw2", "db2"], "rel_errs": errs,
                  "max_rel_err": max(errs)}
    return res
