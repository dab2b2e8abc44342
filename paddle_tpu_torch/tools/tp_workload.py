"""The tensor-parallel serving workload ``chip_smoke.py`` drives: the serve
phase's model and requests (``tools/serve_workload.py``: the headline
``DecoderLM`` at d 2048, 16 heads of 128, 8 layers, vocab 32768, FFN
8192, f32 weights from seed 0; 8 requests of 96-896 tokens plus the
prefix sharer, 32 new tokens each, on a 129-page pool) through
``ServingEngine(mesh=make_mesh((2,), ("model",)), tp_axis="model")``.

Each rank builds only its shard (``DecoderLM(tp_mesh=)`` loaded from the
numpy weights by ``decoder_lm_from_numpy``): 8 query and 8 KV heads, 4096
FFN columns, and a ``[8, 129, 128, 8, 128]`` f32 K and V pool shard.  On
one card the two ranks share the device.  NCCL refuses two ranks on one
device, so they join by gloo, whose ``all_reduce`` takes CUDA tensors
(through host copies): the attention, the projections and the per-shard
ragged kernel all run on the card, and each step's two all-reduces a
layer go through the host.  Its wall time is two processes time-sharing
one card with their reductions through gloo, not a tensor-parallel
speed.

Run by ``chip_smoke.py`` as::

    start_ranks("paddle_tpu_torch.tools.tp_workload:serve_tp_rank", TP,
                device="cuda").wait()
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

TP = 2
AXIS = "model"
# the step (0-based) whose layer-0 ragged kernel call each rank holds
# against the plain version on its shard: a step that carries prefill
# chunks beside decode rows
CHECK_STEP = 2
ROUTE = ("gloo all_reduce on CUDA tensors, two ranks sharing card 0 "
         "(NCCL takes one rank a card)")


def tp_model(mesh, dev, model_cfg=None):
    """This rank's shard of the serve workload's model (or of
    ``model_cfg``), loaded straight from the seed's numpy weights (the
    whole model is never built on the card)."""
    from paddle_tpu_torch.convert import decoder_lm_from_numpy, \
        init_numpy_params
    from paddle_tpu_torch.serving import DecoderLM
    from paddle_tpu_torch.tools import serve_workload as sw

    model = DecoderLM(**(model_cfg or sw.MODEL), device=dev, tp_mesh=mesh,
                      tp_axis=AXIS)
    return decoder_lm_from_numpy(init_numpy_params(model, sw.SEED), model)


def _warm_up(model, mesh, dev) -> None:
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.tools import serve_workload as sw

    eng = ServingEngine(model, eos_id=sw.NO_EOS, num_pages=17,
                        max_pages_per_seq=sw.PAGES_PER_SEQ, use_kernel=True,
                        device=dev, mesh=mesh, tp_axis=AXIS)
    for n in (300, 20):
        eng.submit(list(range(2, 2 + n)), max_tokens=4)
    eng.run()


def _kernel_check(args, kw) -> Dict[str, object]:
    """The rank's captured ragged kernel call against its plain version on
    the same shard inputs: error at the serve cases' tolerance, card ms
    of both (CUDA events, the calls back to back), and the least time for
    the shard's bytes and operations (``ragged_cases.roofline``)."""
    from paddle_tpu_torch.serving.decode_attention import (
        ragged_paged_attention_kernel, ragged_paged_attention_reference)
    from paddle_tpu_torch.tools import ragged_cases as rc
    from paddle_tpu_torch.tools.parallel_workload import events_ms

    case = dict(zip(rc.ARGS, args))
    case.update({k: v for k, v in kw.items() if v is not None})
    sc = rc.scales(case)
    got = ragged_paged_attention_kernel(*rc.args(case), **sc)
    torch.cuda.synchronize()
    res = {"q": list(case["q"].shape), "pages": list(case["k_pages"].shape),
           "real_rows": int((case["qpos"] >= 0).sum()),
           **rc.check(case, got)}
    res["ms"] = events_ms(
        lambda: ragged_paged_attention_kernel(*rc.args(case), **sc), 20)
    res["plain_ms"] = events_ms(
        lambda: ragged_paged_attention_reference(*rc.args(case), **sc), 3)
    res.update(rc.roofline(case))
    return res


def _checks_in_turn(rank: int, world: int, case) -> Dict[str, object]:
    """:func:`_kernel_check` on each rank in turn, the others waiting at a
    barrier, so no rank's timing shares the card with another's."""
    import torch.distributed as dist

    res: Dict[str, object] = {}
    for r in range(world):
        dist.barrier()
        if r == rank:
            res = _kernel_check(*case)
    dist.barrier()
    return res


def serve_tp_rank(rank: int, world: int, check_step: int = CHECK_STEP,
                  device: str = "cuda", model_cfg=None) -> Dict[str, object]:
    """One rank of the tensor-parallel serve: its tokens, the ragged
    kernel's launches, each step's rows and all-reduce calls and bytes
    beside ``tp_step_comm_bytes``, page conservation, the wall time with
    the time spent in the all-reduces (the card synchronized around
    each), and its layer-0 kernel call at ``check_step`` held against the
    plain version (on a card; ``device="cpu"`` runs the plain attention
    and no check).  ``model_cfg`` narrows the model (the serve
    workload's vocabulary and positions kept)."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.serving import engine as engine_mod
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel
    from paddle_tpu_torch.tools import serve_workload as sw

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    mesh = make_mesh((world,), (AXIS,))
    t0 = time.perf_counter()
    model = tp_model(mesh, dev, model_cfg)
    load_s = time.perf_counter() - t0
    _warm_up(model, mesh, dev)
    eng = sw.make_engine(model, dev, mesh=mesh, tp_axis=AXIS)

    steps: List[tuple] = []
    engine_step = eng._step

    def counted_step(*a):
        rows = a[0].size + a[3].size        # decode rows + prefill rows
        calls, nbytes = model.allreduce_calls, model.allreduce_bytes
        out = engine_step(*a)
        steps.append((rows, model.allreduce_calls - calls,
                      model.allreduce_bytes - nbytes))
        return out

    captured: Dict[str, tuple] = {}
    attn = engine_mod.ragged_paged_attention_tp

    def capturing_attn(mesh_, axis, *args, **kw):
        if len(steps) == check_step and "case" not in captured:
            captured["case"] = (
                tuple(x.clone() for x in args),
                {k: (v.clone() if v is not None else None)
                 for k, v in kw.items()})
        return attn(mesh_, axis, *args, **kw)

    coll = [0.0]
    psum = model._tp_psum

    def timed_psum(x):
        sync()
        t = time.perf_counter()
        y = psum(x)
        sync()
        coll[0] += time.perf_counter() - t
        return y

    eng._step = counted_step
    engine_mod.ragged_paged_attention_tp = capturing_attn
    model._tp_psum = timed_psum
    model.allreduce_calls = model.allreduce_bytes = 0
    try:
        sync()
        kernel.launches = 0
        t0 = time.perf_counter()
        wl = sw.Workload(eng)
        while not wl.done:
            wl.step()
        sync()
        wall = time.perf_counter() - t0
        launches = kernel.launches
    finally:
        engine_mod.ragged_paged_attention_tp = attn
    eng.check_page_conservation()
    m = eng.metrics
    layers = model.num_layers
    link = [2.0 * nbytes * (world - 1) / world for _, _, nbytes in steps]
    comm_ok = all(calls == 2 * layers and abs(got - eng.tp_step_comm_bytes(
        rows)) <= 1e-6 * max(got, 1.0)
        for (rows, calls, _), got in zip(steps, link))
    outputs = [eng.result(r) for r in wl.rids]
    return {"rank": rank, "tp": eng.tp, "outputs": outputs,
            "kernel_launches": launches,
            "launches_expected": layers * m.step_dispatches,
            "steps": m.step_dispatches, "recorded_steps": len(steps),
            "allreduce_calls": [c for _, c, _ in steps],
            "step_rows": [r for r, _, _ in steps],
            "allreduce_link_bytes": float(sum(link)),
            "tp_step_comm_bytes": float(sum(
                eng.tp_step_comm_bytes(r) for r, _, _ in steps)),
            "comm_matches_closed_form": comm_ok,
            "conservation": eng.healthz()["ok"],
            "drained": not eng.has_work and all(
                o is not None and len(o) == sw.NEW_TOKENS for o in outputs),
            "kv_bytes_per_rank": eng.kv_cfg.kv_bytes(),
            "pool_shard": list(eng._kv.k.shape),
            "wq_shard": list(model.layers[0].wq.shape),
            "load_s": load_s, "wall_s": wall,
            "tokens_per_s": m.tokens_per_s(),
            "allreduce_s": coll[0],
            "allreduce_share": coll[0] / wall if wall > 0 else 0.0,
            "kernel_check": _checks_in_turn(rank, world, captured["case"])
            if cuda else None,
            "route": ROUTE if cuda else "gloo all_reduce on the CPU"}


def replay_parting(model, prompt: List[int], tp_tokens: List[int],
                   want: List[int]) -> Dict[str, object]:
    """Where the tensor-parallel tokens part from the one-process engine's:
    the one-process reference's logits at that step (the non-paged
    forward over the prompt and the common tokens), its top-2 gap and
    whether the two picks are its top two."""
    from paddle_tpu_torch.serving import reference_logits

    j = next((k for k, (a, b) in enumerate(zip(tp_tokens, want)) if a != b),
             min(len(tp_tokens), len(want)))
    logits = reference_logits(model, list(prompt) + list(want[:j]))
    order = np.argsort(logits)[::-1]
    top, second = float(logits[order[0]]), float(logits[order[1]])
    picks = {int(tp_tokens[j]), int(want[j])} if j < min(
        len(tp_tokens), len(want)) else set()
    return {"first_diff": j, "top_logit": top, "top2_gap": top - second,
            "picks_are_top2": picks <= {int(order[0]), int(order[1])}}
