"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) once on one GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs a CUDA
device and ``nvcc`` and exits non-zero without them (or outside a
checkout of the repository).  Phases, each fatal on failure:

1. card: ``nvidia-smi`` name and power limit; TF32 switched off for
   matmuls and cuDNN so f32 means f32;
2. build: every ``paddle_tpu_torch/csrc/*.cu``, one ``nvcc`` each, in
   parallel;
3. kernels: the ragged paged-attention kernel against its plain PyTorch
   version at the serving shapes (H=16, D=128, page 128, 8 pages a
   sequence; ``tools/ragged_cases.py``) — decode-only, mixed
   prefill+decode, GQA 4, int8 and bf16 pages, bf16 queries on bf16 pages
   (the tensor-core path, decode and mixed) and on f32 pages, and the
   mixed step at G 3 (12 heads over 4 KV heads), G 16 (one KV head) and
   head dims 16, 32, 64 and 256 — with error, kernel time, plain time and
   the roofline bound;
4. serve: a full-width DecoderLM (vocab 32768, d 2048, 8 layers, 16
   heads) with random weights from a seed, through the port's
   ServingEngine at the flag defaults with a 129-page pool: 8 requests,
   chunked prefill mixed with decode and a shared 512-token prefix; the
   run must drain with page conservation, launch the kernel once per
   layer per step, and match the port's own greedy reference;
5. int8 serve: a short serve on an int8 pool plus the QUANT-DRIFT check;
   then ``DecoderLM`` at its defaults (2 layers, 2 heads of head_dim 16)
   and its bf16 version, each served briefly and held to the greedy
   oracle;
6. flash_kernels: the flash-attention forward, dK/dV and dQ kernels
   against their plain PyTorch versions on the same inputs: the training
   path's q/k/v [1, 8192, 16, 128] bf16 with 8 causal segments of 1024,
   ragged segments with padding as the feeder packs them, f32 causal
   segments at a smaller S (head dims 128 and 64), non-causal
   cross-attention with Sq != Sk, causal with Sk > Sq (f32, and bf16 with
   Sq an odd number of 64-row tiles), bf16 causal segments at head dim
   64, and the CUDA-core route at head dims 32 and 256 and at Sq 96;
   with error, kernel time, plain time, the roofline bound, the
   interior and boundary tile pairs and, on the training case,
   ``scaled_dot_product_attention`` forward, backward alone and both as
   the library yardsticks; the kernels line carries ptxas's registers and
   spills of each flash and RNN kernel;
7. train: the full-width transformer LM (vocab 32768, d 2048, 8 layers,
   16 heads) with random weights from a seed, trained through the port's
   v2 surface (``Parameters.from_topology``, ``trainer.SGD.train``,
   ``Momentum(0.9, 1e-3)``) on one batch of 8 x 1024 tokens repeated for
   6 steps: finite costs, the last below the first, each flash kernel
   launched 8 layers x 6 steps times;
8. train_parity: a 2-layer model at the same width, batch 2 x 1024, 3
   steps through the kernels against the same steps through the plain
   flash versions on the card, with the same weights and feeds;
9. rnn_kernels: the fused LSTM step (B5), the one-launch GRU step (B6)
   and the two-launch GRU step (B7 then B8) against their plain PyTorch
   versions on the same inputs: B5 at B 64 with H 512 and 1280, acts on
   and off, and a bf16 xp; B6 at H 512 and B7 + B8 at H 1280, acts on and
   off; with error, card time, plain time, the roofline bound, the SM
   clock read after the case's timings and, for B5, cuDNN's ``nn.LSTM``
   forward over T = 128 steps divided by T;
10. train_lstm: bench.py's IMDB text classifier (``models/text_lstm``,
    dict 30000, embedding 128, 2 x LSTM h 512, max pooling, fc(2)) with
    random weights from a seed, trained through ``SGD.train`` with
    ``Momentum(0.9, 0.01)`` on one batch of 64 sequences of 100 tokens
    repeated for 6 steps: finite, falling costs, B5 launched 2 layers x
    128 steps x 6 times (the feeder buckets 100 to 128);
11. train_gru: the same classifier with ``simple_gru`` layers, at h 512
    (2 layers, 6 steps, B6 only) and at h 1280 (1 layer, 3 steps, B7 and
    B8 only), each with finite, falling costs and exact launch counts;
12. rnn_parity: the LSTM and the GRU classifier at full width, batch 16,
    3 steps through the kernels against the same steps through the plain
    versions on the card (``rnn_workload.plain_rnn_path``).

Every line of output is one JSON object; the one before the last lists
the kernels, the last is ``{"ok": true, "device": {...}}``.  The serve
workload lives in ``paddle_tpu_torch/tools/serve_workload.py``, shared
with the profiler ``python -m paddle_tpu_torch.tools.profile_serve``; the
training workload and the flash cases in
``paddle_tpu_torch/tools/train_workload.py``; the recurrent workload and
the RNN cases in ``paddle_tpu_torch/tools/rnn_workload.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# the port must come from this checkout; outside it this import fails
from paddle_tpu_torch.tools import ragged_cases as rc
from paddle_tpu_torch.tools import rnn_workload as rw
from paddle_tpu_torch.tools import train_workload as tw
from paddle_tpu_torch.tools.compare_flash import card_ms, sm_clock
from paddle_tpu_torch.tools.serve_workload import (MODEL, NEW_TOKENS, NO_EOS,
                                                   PREFIX_LEN, Workload,
                                                   build_model, make_engine,
                                                   warm_up)

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): the roofline bound of a kernel is the larger of bytes / HBM rate
# and, summed over its products, operations / peak rate of their operand
# type (f32 on the CUDA cores; bf16 on the tensor cores)
HBM_BYTES_PER_S = rc.HBM_BYTES_PER_S
F32_FLOPS_PER_S = rc.F32_FLOPS_PER_S
BF16_FLOPS_PER_S = rc.BF16_FLOPS_PER_S

SEED = 0
H = rc.H


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean card time of one call over ``reps`` calls run back to back
    between two CUDA events, after warm-up.  The host enqueues ahead of
    the card, so a wrapper's own host work (argument checks, launching its
    small helper ops) shows only where it outlasts the card's work; a
    synchronize after every call would add it to each reading."""
    for _ in range(warmup):
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


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------

def run_kernel_cases(dev):
    """Every case of ``ragged_cases`` through the kernel and the plain
    version on the card; raises if any case is outside its tolerance.
    ``ms`` is card time (:func:`device_ms`: the kernel's plan, attention
    and merge launches); ``host_ms`` is the call back to back between CUDA
    events (:func:`time_ms`), which also holds the wrapper's host work
    where that outlasts the card's; ``plain_ms`` is the plain version's,
    between CUDA events (milliseconds of card work, outlasting its host
    work)."""
    from paddle_tpu_torch.serving.decode_attention import (
        ragged_paged_attention_kernel, ragged_paged_attention_reference)

    results = []
    for name, case in rc.kernel_cases(dev):
        args, kw = rc.args(case), rc.scales(case)
        got = ragged_paged_attention_kernel(*args, **kw)
        torch.cuda.synchronize()
        real = case["qpos"] >= 0
        res = {"phase": "kernel", "case": name,
               "q": str(case["q"].dtype).replace("torch.", ""),
               "pages": str(case["k_pages"].dtype).replace("torch.", ""),
               "rows": int(case["q"].shape[0]),
               "real_rows": int(real.sum()),
               "heads": int(case["q"].shape[1]),
               "kv_heads": int(case["k_pages"].shape[2]),
               "head_dim": int(case["q"].shape[2]),
               **rc.check(case, got),
               "ms": device_ms(lambda: ragged_paged_attention_kernel(
                   *args, **kw), reps=30, what=f"{name} kernel"),
               "host_ms": time_ms(lambda: ragged_paged_attention_kernel(
                   *args, **kw)),
               "plain_ms": time_ms(
                   lambda: ragged_paged_attention_reference(*args, **kw),
                   reps=3, warmup=1),
               "library_ms": None}
        res.update(rc.roofline(case))
        emit(res)
        if not res["within_tolerance"]:
            raise AssertionError(f"kernel case {name} outside tolerance: "
                                 f"max abs err {res['max_abs_err']}")
        results.append(res)
    return results


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def check_against_reference(model, prompts, outputs,
                            new_tokens: int = NEW_TOKENS) -> list:
    """Every request's tokens against the port's non-paged greedy oracle
    on the card.  A mismatch passes only as a near tie: the oracle's
    top-two logit gap at the first differing position under 1e-3 of its
    top logit (f32 sums taken in another order can flip such a tie)."""
    from paddle_tpu_torch.serving import greedy_decode_reference, \
        reference_logits

    ties = []
    for i, (prompt, got) in enumerate(zip(prompts, outputs)):
        want = greedy_decode_reference(model, prompt, new_tokens, NO_EOS)
        if got == want:
            continue
        j = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        logits = reference_logits(model, prompt + want[:j])
        top2 = np.sort(logits)[-2:]
        gap, top = float(top2[1] - top2[0]), float(top2[1])
        tie = {"phase": "serve", "request": i, "first_diff": j,
               "top_logit": top, "top2_gap": gap,
               "near_tie": gap < 1e-3 * abs(top)}
        emit(tie)
        if not tie["near_tie"]:
            raise AssertionError(f"request {i} differs from the greedy "
                                 f"reference at token {j} (gap {gap})")
        ties.append(tie)
    return ties


def serve(model, dev) -> dict:
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    warm_up(model, dev)
    eng = make_engine(model, dev)
    step_ms = {True: [], False: []}     # by "carried prefill rows"

    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    wl = Workload(eng)
    while not wl.done:
        rows, steps = eng.metrics.prefill_rows, eng.metrics.step_dispatches
        t = time.perf_counter()
        wl.step()                       # ends in the logits' host copy
        if eng.metrics.step_dispatches > steps:
            step_ms[eng.metrics.prefill_rows > rows].append(
                1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    eng.check_page_conservation()
    m = eng.metrics
    outputs = [eng.result(r) for r in wl.rids]
    done = all(o is not None and len(o) == NEW_TOKENS for o in outputs)
    res = {"phase": "serve", "requests": len(wl.rids),
           "completed": m.completed,
           "drained": not eng.has_work and done,
           "conservation": eng.healthz()["ok"], "ticks": m.ticks,
           "steps": m.step_dispatches, "kernel_launches": launches,
           "launches_expected": MODEL["num_layers"] * m.step_dispatches,
           "tokens_per_s": m.tokens_per_s(), "wall_s": wall,
           "ttft_ms_mean": m.ttft_ms_mean(), "ttft_ms_p95": m.ttft_ms_p95(),
           "prefix_hits": eng.cache.hits,
           "prefill_tokens_saved": m.prefill_tokens_saved,
           "prefill_tokens": m.prefill_tokens,
           "prefill_steps": len(step_ms[True]),
           "prefill_step_ms_mean": float(np.mean(step_ms[True])),
           "decode_steps": len(step_ms[False]),
           "decode_step_ms_median": float(np.median(step_ms[False]))}
    emit(res)
    if not res["drained"] or not res["conservation"]:
        raise AssertionError("serve did not drain cleanly")
    if launches != res["launches_expected"] or launches == 0:
        raise AssertionError(f"kernel launches {launches} != layers x "
                             f"steps {res['launches_expected']}")
    if res["prefix_hits"] < 1 or res["prefill_tokens_saved"] < PREFIX_LEN:
        raise AssertionError("the shared prefix was not served from cache")
    t1 = time.perf_counter()
    ties = check_against_reference(model, wl.prompts, outputs)
    emit({"phase": "serve_reference", "requests": len(wl.prompts),
          "identical": len(wl.prompts) - len(ties), "near_ties": len(ties),
          "seconds": time.perf_counter() - t1})
    return res


def serve_int8(model, dev) -> dict:
    from paddle_tpu_torch.serving import check_quant_drift
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(2, MODEL["vocab_size"], n).tolist()
               for n in (100, 300, 520, 64)]
    eng = make_engine(model, dev, kv_dtype="int8")
    kernel.launches = 0
    rids = [eng.submit(p, max_tokens=8) for p in prompts]
    eng.run()
    launches = kernel.launches
    outputs = [eng.result(r) for r in rids]
    case = rc.build_case(np.random.default_rng(SEED), rc.MIXED_SEQS, H, dev)
    drift = check_quant_drift(*rc.args(case))
    res = {"phase": "serve_int8", "requests": len(rids),
           "completed": eng.metrics.completed,
           "drained": not eng.has_work and all(
               o is not None and len(o) == 8 for o in outputs),
           "conservation": eng.healthz()["ok"],
           "kernel_launches": launches,
           "launches_expected": MODEL["num_layers"] *
           eng.metrics.step_dispatches,
           "kv_bytes": eng.kv_cfg.kv_bytes(), "quant_drift": drift}
    emit(res)
    if not (res["drained"] and res["conservation"]) or \
            launches != res["launches_expected"]:
        raise AssertionError("int8 serve failed")
    return res


SMALL_SERVE_TOKENS = 16


def serve_small(dev) -> list:
    """``DecoderLM`` at its defaults (2 layers, 2 heads of head_dim 16)
    with the serve workload's vocabulary, in f32 and in bf16, served on
    the card at the engine's flag defaults: 4 requests of 16 new tokens,
    the ragged kernel launched once a layer a step, tokens equal to the
    greedy oracle (near ties as in the full-width serve)."""
    from paddle_tpu_torch.convert import decoder_lm_from_numpy, \
        init_numpy_params
    from paddle_tpu_torch.serving import DecoderLM, ServingEngine
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    out = []
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(2, MODEL["vocab_size"], n).tolist()
               for n in (40, 300, 7, 130)]
    for dtype in (torch.float32, torch.bfloat16):
        model = DecoderLM(vocab_size=MODEL["vocab_size"], device=dev,
                          dtype=dtype)
        decoder_lm_from_numpy(init_numpy_params(model, SEED), model)
        eng = ServingEngine(model, eos_id=NO_EOS, num_pages=33,
                            max_pages_per_seq=8, device=dev)
        kernel.launches = 0
        rids = [eng.submit(p, max_tokens=SMALL_SERVE_TOKENS)
                for p in prompts]
        eng.run()
        launches = kernel.launches
        outputs = [eng.result(r) for r in rids]
        ties = check_against_reference(model, prompts, outputs,
                                       SMALL_SERVE_TOKENS)
        res = {"phase": "serve_small", "dtype": str(dtype).replace(
            "torch.", ""), "head_dim": model.head_dim,
            "heads": model.num_heads, "layers": model.num_layers,
            "requests": len(rids),
            "drained": not eng.has_work and all(
                o is not None and len(o) == SMALL_SERVE_TOKENS
                for o in outputs),
            "conservation": eng.healthz()["ok"],
            "kernel_launches": launches,
            "launches_expected": model.num_layers *
            eng.metrics.step_dispatches,
            "identical": len(prompts) - len(ties), "near_ties": len(ties)}
        emit(res)
        if not (res["drained"] and res["conservation"]) or launches == 0 \
                or launches != res["launches_expected"]:
            raise AssertionError(f"{dtype} DecoderLM serve failed")
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# flash attention kernels
# ---------------------------------------------------------------------------

FLASH_KERNELS = ("flash_fwd", "flash_bwd_kv", "flash_bwd_dq")
# the mangled name of each kernel that case a runs, in ptxas's report
FLASH_PTXAS = {"flash_fwd": "flash_fwd_wgmma_kernelILi128",
               "flash_bwd_kv": "flash_bwd_kv_wgmma_kernelILi128",
               "flash_bwd_dq": "flash_bwd_dq_wgmma_kernelILi128"}
LIBRARY_KEYS = ("library_fwd_ms", "library_bwd_ms", "library_fwd_bwd_ms")


def ptxas_of(source: str, kernel: str):
    """ptxas's registers and spills of the kernel of ``csrc/<source>.cu``
    whose mangled name holds ``kernel``, or None."""
    from paddle_tpu_torch.kernels import build

    found = [v for k, v in build.ptxas_report(source).items() if kernel in k]
    return found[0] if found else None


def flash_bound(case, which: str) -> dict:
    """Least time for one flash function on ``case``: each input read once
    and each output written once (q, k, v, dO in their type; segment ids,
    lse and delta in 4 bytes), and the products of the (query, key) pairs
    the mask keeps, 2 flops a multiply-add — forward QK^T and PV (4 x
    pairs x D), dK/dV the recomputed QK^T, dO V^T, P^T dO and dS^T Q (8 x),
    dQ QK^T, dO V^T and dS K (6 x) — at the peak rate of the inputs' type
    (bf16 tensor cores, or f32)."""
    b, sq, h, d = case.q.shape
    sk = case.k.shape[1]
    es = case.q.element_size()
    qb, kb = b * sq * h * d * es, b * sk * h * d * es
    row = 4 * b * h * sq                       # lse or delta
    seg = 4 * b * (sq + sk)
    pairs = tw.live_pairs(case.q_seg.cpu().numpy(), case.kv_seg.cpu().numpy(),
                          case.causal) * h
    nbytes, mults = {
        "flash_fwd": (qb + 2 * kb + seg + qb + row, 4),
        "flash_bwd_kv": (2 * qb + 2 * kb + 2 * row + seg + 2 * kb, 8),
        "flash_bwd_dq": (2 * qb + 2 * kb + 2 * row + seg + qb, 6),
    }[which]
    flops = mults * pairs * d
    rate = BF16_FLOPS_PER_S if case.q.dtype == torch.bfloat16 \
        else F32_FLOPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops, "live_pairs": pairs}


def device_ms(fn, reps: int = 10, what: str = "") -> float:
    """Card time of one call: one call's worth of each CUDA kernel's mean
    record over ``reps`` calls under ``torch.profiler``, after one warm-up
    call (``compare_flash.card_ms``).  It leaves out the host's work
    between kernels, which for a small kernel's wrapper or a call through
    autograd can be longer than the kernels themselves.  Where the trace
    lost kernel records, or caught too little in a few tries (the calls
    are then timed back to back with CUDA events instead), a line naming
    ``what`` says so."""
    ms, timer = card_ms(fn, reps)
    if timer != "profiler":
        emit({"timer": timer, "what": what, "ms": ms})
    return ms


def sdpa_ms(case) -> dict:
    """``scaled_dot_product_attention(is_causal=True)`` on the [B, H, S, D]
    view of the equal-length batch (case a): card time of the forward, of
    the backward alone (through a saved forward, the yardstick of dK/dV
    and dQ), and of forward plus backward (of the three kernels
    together).  Timed here only; the port never calls it."""
    import torch.nn.functional as F

    shape = (tw.BATCH, tw.SEQ) + tuple(case.q.shape[2:])
    q, k, v, do = (x.reshape(shape).transpose(1, 2).contiguous()
                   for x in (case.q, case.k, case.v, case.dout))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    saved = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def bwd():
        torch.autograd.grad(saved, (qg, kg, vg), do, retain_graph=True)

    return {"library_fwd_ms": device_ms(fwd, what="sdpa_fwd"),
            "library_bwd_ms": device_ms(bwd, what="sdpa_bwd"),
            "library_fwd_bwd_ms": device_ms(fwd_bwd, what="sdpa_fwd_bwd"),
            "library_out": fwd().transpose(1, 2).reshape(case.q.shape)}


def run_flash_cases(dev) -> dict:
    """Each flash kernel against its plain version on every case; raises
    if any output is outside its tolerance.  Times are card time
    (:func:`device_ms`): the wrapper's kernel with its small helper ops,
    the plain version's kernels, the library call's kernels.  Returns
    the results by case name."""
    from paddle_tpu_torch.ops import attention as A

    results = {}
    for name in tw.FLASH_CASES:
        case = tw.flash_case(name, dev)
        cfg = dict(causal=case.causal, sm_scale=case.sm_scale)
        fwd_args = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
        o_ref, lse_ref = A.flash_fwd_reference(*fwd_args, **cfg)
        o, lse = A.flash_fwd_kernel(*fwd_args, **cfg)
        bwd_args = fwd_args + (case.dout, lse_ref,
                               A.attention_delta(o_ref, case.dout))
        dk_ref, dv_ref = A.flash_bwd_kv_reference(*bwd_args, **cfg)
        dk, dv = A.flash_bwd_kv_kernel(*bwd_args, **cfg)
        dq_ref = A.flash_bwd_dq_reference(*bwd_args, **cfg)
        dq = A.flash_bwd_dq_kernel(*bwd_args, **cfg)
        torch.cuda.synchronize()
        errs = {"o": tw.flash_error(o, o_ref),
                "lse": tw.flash_error(lse, lse_ref),
                "dk": tw.flash_error(dk, dk_ref),
                "dv": tw.flash_error(dv, dv_ref),
                "dq": tw.flash_error(dq, dq_ref)}
        kernels = {
            "flash_fwd": (A.flash_fwd_kernel, A.flash_fwd_reference,
                          fwd_args, ("o", "lse")),
            "flash_bwd_kv": (A.flash_bwd_kv_kernel, A.flash_bwd_kv_reference,
                             bwd_args, ("dk", "dv")),
            "flash_bwd_dq": (A.flash_bwd_dq_kernel, A.flash_bwd_dq_reference,
                             bwd_args, ("dq",)),
        }
        res = {"phase": "flash_kernels", "case": case.name,
               "dtype": str(case.q.dtype).replace("torch.", ""),
               "route": A.kernel_route(tuple(case.q.shape),
                                       tuple(case.k.shape), case.q.dtype,
                                       False),
               "q": list(case.q.shape), "k": list(case.k.shape),
               "causal": case.causal, "errors": errs}
        for kname, (kern, plain, args, outs) in kernels.items():
            res[kname] = {
                "max_abs_err": max(errs[o]["max_abs_err"] for o in outs),
                "ms": device_ms(lambda: kern(*args, **cfg), reps=20,
                                what=f"{name} {kname}"),
                "plain_ms": device_ms(lambda: plain(*args, **cfg), reps=3,
                                      what=f"{name} {kname} plain"),
                **flash_bound(case, kname)}
        kinds = A.tile_pair_kinds(case.q_seg, case.kv_seg, case.causal,
                                  A.kernel_tile(case.q.shape[3]))
        res["tile_pairs"] = {kind: int((kinds == code).sum()) for kind, code
                             in (("interior", A.PAIR_INTERIOR),
                                 ("boundary", A.PAIR_BOUNDARY))}
        if case.name.startswith("a_"):
            lib = sdpa_ms(case)
            for key in LIBRARY_KEYS:
                res[key] = lib[key]
            res["library_out_max_abs_diff"] = float(
                (lib["library_out"].float() - o.float()).abs().max())
        ok = all(e["within_tolerance"] for e in errs.values())
        res["within_tolerance"] = ok
        emit(res)
        if not ok:
            raise AssertionError(f"flash case {case.name} outside tolerance")
        results[case.name] = res
    return results


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6          # the first is the untimed warm-up
PARITY_LAYERS, PARITY_BATCH, PARITY_STEPS = 2, 2, 3
# kernel path against the plain flash path, per-step cost, relative:
# both run bf16 flash inputs with P and dS rounded at the same places; the
# kernels sum in another order, so a few bf16 roundings flip (on an H100:
# 1.7e-6 with the CUDA-core kernels, 2.2e-5 with the tensor-core ones)
PARITY_RTOL = 2e-4


def _flash_launches():
    from paddle_tpu_torch.ops import attention as A

    return {"flash_fwd": A.flash_fwd_kernel.launches,
            "flash_bwd_kv": A.flash_bwd_kv_kernel.launches,
            "flash_bwd_dq": A.flash_bwd_dq_kernel.launches}


def _reset_flash_launches() -> None:
    from paddle_tpu_torch.ops import attention as A

    for kern in (A.flash_fwd_kernel, A.flash_bwd_kv_kernel,
                 A.flash_bwd_dq_kernel):
        kern.launches = 0


def _train_costs(sgd, samples, steps, workload=tw):
    """Train ``steps`` steps on one batch through ``SGD.train``; per step
    the cost and the host time from BeginIteration to the cost on the
    host (feeding, forward, backward, update).  ``workload`` gives the
    reader and the feeding."""
    from paddle_tpu_torch import event

    costs, step_ms, t = [], [], [0.0]

    def handler(ev):
        if isinstance(ev, event.BeginIteration):
            torch.cuda.synchronize()
            t[0] = time.perf_counter()
        elif isinstance(ev, event.EndIteration):
            costs.append(ev.cost)              # waits for the card
            step_ms.append(1e3 * (time.perf_counter() - t[0]))

    sgd.train(workload.repeat_reader(samples, steps), num_passes=1,
              event_handler=handler, feeding=workload.FEEDING)
    return costs, step_ms


def train(dev) -> dict:
    t0 = time.perf_counter()
    sgd = tw.build_trainer(dev)
    samples = tw.lm_samples(tw.SEED + 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_launches()
    costs, step_ms = _train_costs(sgd, samples, TRAIN_STEPS)
    launches = _flash_launches()
    timed = step_ms[1:]
    res = {"phase": "train", "model": tw.MODEL, "batch": tw.BATCH,
           "seq": tw.SEQ, "steps": TRAIN_STEPS, "costs": costs,
           "step_ms": step_ms, "step_ms_median": float(np.median(timed)),
           "tokens_per_s": tw.BATCH * tw.SEQ / (np.median(timed) / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "parameters": sum(p.numel() for p in sgd.parameters.as_dict()
                             .values()),
           "setup_s": setup_s, "kernel_launches": launches,
           "launches_expected": tw.MODEL["n_layers"] * TRAIN_STEPS}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"training did not learn: costs {costs}")
    for name, n in launches.items():
        if n != res["launches_expected"]:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{res['launches_expected']}")
    return res


def train_parity(dev) -> dict:
    samples = tw.lm_samples(tw.SEED + 2, bs=PARITY_BATCH)
    sgd = tw.build_trainer(dev, n_layers=PARITY_LAYERS)
    before = _flash_launches()
    kernel_costs, _ = _train_costs(sgd, samples, PARITY_STEPS)
    used = {k: v - before[k] for k, v in _flash_launches().items()}
    del sgd
    sgd = tw.build_trainer(dev, n_layers=PARITY_LAYERS)
    with tw.plain_flash_path():
        plain_costs, _ = _train_costs(sgd, samples, PARITY_STEPS)
    del sgd
    rel = [abs(a - b) / abs(b) for a, b in zip(kernel_costs, plain_costs)]
    res = {"phase": "train_parity", "layers": PARITY_LAYERS,
           "batch": PARITY_BATCH, "steps": PARITY_STEPS,
           "kernel_costs": kernel_costs, "plain_costs": plain_costs,
           "max_rel_diff": max(rel), "rtol": PARITY_RTOL,
           "kernel_launches": used}
    emit(res)
    if max(rel) > PARITY_RTOL or any(
            n != PARITY_LAYERS * PARITY_STEPS for n in used.values()):
        raise AssertionError("kernel path and plain path disagree")
    return res


# ---------------------------------------------------------------------------
# recurrent kernels and training
# ---------------------------------------------------------------------------

RNN_REPLACES = {"lstm_step": "paddle_tpu/ops/rnn.py:80",
                "gru_step": "paddle_tpu/ops/rnn.py:212",
                "gru_zr": "paddle_tpu/ops/rnn.py:234",
                "gru_cand": "paddle_tpu/ops/rnn.py:244"}
# the mangled name of each kernel that its main-path case (f32) runs
RNN_PTXAS = {"lstm_step": "lstm_step_kernelIfLb1E",
             "gru_step": "gru_step_kernelIfLb1E",
             "gru_zr": "gru_zr_kernelIfLb1E",
             "gru_cand": "gru_cand_kernelIfE"}
GRU_NO_LIBRARY = ("no PyTorch call computes this function: torch.nn.GRU "
                  "applies the reset gate after the product, r(h W_hn + "
                  "b_hn), Paddle's GRU before it, (r h) W_c")


def rnn_bound(case, kernel: str) -> dict:
    """Least time for one call: bytes (each input read once, each output
    written once) at 3.35 TB/s against the recurrent product's f32
    operations at 67 TFLOP/s."""
    nbytes, flops = rw.case_io(case, kernel)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def cudnn_lstm_step_ms(B: int, H: int, dev) -> float:
    """Card time of cuDNN's ``torch.nn.LSTM`` forward (input size H, the
    same gate order and activations, plus the input projection) over
    [B, T = 128, H], divided by T.  Timed here only; the port never
    calls it."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    lstm = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    x = torch.randn((B, rw.STEPS_T, H), generator=gen).to(dev)
    with torch.no_grad():
        return device_ms(lambda: lstm(x), reps=5,
                         what=f"cudnn_lstm H {H}") / rw.STEPS_T


def _rnn_case_calls(case):
    """{kernel: (kernel call, plain call, {output: (got, want)})} of one
    case; the two-launch GRU case runs B8 on B7's plain outputs."""
    from paddle_tpu_torch.ops import rnn as R

    kind, save, H = case["kind"], case["save_acts"], case["H"]
    xp, h, w, b = case["xp"], case["h"], case["w_h"], case["bias"]
    if kind == "lstm_step":
        a = (xp, h, case["c"], w, b)
        got = R.lstm_step_kernel(*a, save_acts=save)
        want = R.lstm_step_reference(*a, save_acts=save)
        outs = {"h": (got[0], want[0]), "c": (got[1], want[1])}
        if save:
            outs["acts"] = (got[2], want[2])
        return {kind: (lambda: R.lstm_step_kernel(*a, save_acts=save),
                       lambda: R.lstm_step_reference(*a, save_acts=save),
                       outs)}
    a = (xp, h, w, b)
    if kind == "gru_step":
        got = R.gru_step_kernel(*a, save_acts=save)
        want = R.gru_step_reference(*a, save_acts=save)
        outs = {"h": (got[0], want[0])}
        if save:
            outs["acts"] = (got[1], want[1])
        return {kind: (lambda: R.gru_step_kernel(*a, save_acts=save),
                       lambda: R.gru_step_reference(*a, save_acts=save),
                       outs)}
    zrc_k, rh_k = R.gru_zr_kernel(*a)
    zrc_p, rh_p = R.gru_zr_reference(*a)
    zk, zp = zrc_p.clone(), zrc_p.clone()
    nh_k = R.gru_cand_kernel(rh_p, xp, w, b, zk, h, save_c=save)
    nh_p = R.gru_cand_reference(rh_p, xp, w, b, zp, h, save_c=save)
    cand = {"h": (nh_k, nh_p)}
    if save:
        cand["c"] = (zk[:, 2 * H:], zp[:, 2 * H:])
    return {
        "gru_zr": (lambda: R.gru_zr_kernel(*a), lambda: R.gru_zr_reference(*a),
                   {"zr": (zrc_k[:, :2 * H], zrc_p[:, :2 * H]),
                    "rh": (rh_k, rh_p)}),
        "gru_cand": (lambda: R.gru_cand_kernel(rh_p, xp, w, b, zk, h,
                                               save_c=save),
                     lambda: R.gru_cand_reference(rh_p, xp, w, b, zp, h,
                                                  save_c=save), cand)}


def run_rnn_cases(dev) -> dict:
    """Each RNN kernel against its plain version on every case; raises
    if any output is outside its tolerance.  Card time (:func:`device_ms`)
    of the wrapper's kernel and of the plain version's kernels.  Returns
    {case: {kernel: result}}."""
    results = {}
    lib_ms = {H: cudnn_lstm_step_ms(rw.BATCH, H, dev) for H in (512, 1280)}
    for name in rw.RNN_CASES:
        case = rw.rnn_case(name, dev)
        calls = _rnn_case_calls(case)
        torch.cuda.synchronize()
        res = {"phase": "rnn_kernels", "case": name, "B": case["B"],
               "H": case["H"], "xp_dtype": str(case["xp"].dtype).replace(
                   "torch.", ""), "save_acts": case["save_acts"]}
        ok = True
        for kname, (kern, plain, outs) in calls.items():
            errs = {o: rw.rnn_error(g, w) for o, (g, w) in outs.items()}
            ok = ok and all(e["within_tolerance"] for e in errs.values())
            res[kname] = {
                "errors": errs,
                "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                "ms": device_ms(kern, reps=20, what=f"{name} {kname}"),
                "plain_ms": device_ms(plain, reps=5,
                                      what=f"{name} {kname} plain"),
                "library_ms": (lib_ms[case["H"]] if kname == "lstm_step"
                               else None),
                **rnn_bound(case, kname)}
        res["within_tolerance"] = ok
        res["sm_clock"] = sm_clock()   # just after the case's timings
        emit(res)
        if not ok:
            raise AssertionError(f"RNN case {name} outside tolerance")
        results[name] = res
    return results


RNN_TRAIN_STEPS = 6      # the first is the untimed warm-up
GRU_RUNS = (  # (hidden, layers, steps, the kernels that must launch)
    (512, 2, 6, ("gru_step",)),
    (1280, 1, 3, ("gru_zr", "gru_cand")))
RNN_PARITY_BATCH, RNN_PARITY_STEPS = 16, 3
# kernel path against the plain path, per-step cost, relative: both do
# the recurrent products in f32 (the kernels sum in another order); the
# rest of the step is the same torch code
RNN_PARITY_RTOL = 1e-4


def _rnn_train(dev, cell: str, steps: int, kernels, **cfg) -> dict:
    """Train one classifier ``steps`` steps on one batch, counts set to 0
    just before; checks finite, falling costs and that exactly
    ``kernels`` launched, each layers x 128 x steps times."""
    t0 = time.perf_counter()
    sgd = rw.build_trainer(dev, cell, **cfg)
    batch = rw.samples(rw.SEED + 1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rw.reset_launches()
    costs, step_ms = _train_costs(sgd, batch, steps, rw)
    used = rw.launches()
    layers = cfg.get("num_layers", rw.MODEL["num_layers"])
    expected = {k: (layers * rw.STEPS_T * steps if k in kernels else 0)
                for k in used}
    med = float(np.median(step_ms[1:]))
    res = {"phase": f"train_{cell}", "model": dict(rw.MODEL, **cfg),
           "batch": rw.BATCH, "seq": rw.SEQ, "time_steps": rw.STEPS_T,
           "steps": steps, "costs": costs, "step_ms": step_ms,
           "ms_per_batch": med, "sequences_per_s": rw.BATCH / (med / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
           "parameters": sum(p.numel() for p in sgd.parameters.as_dict()
                             .values()),
           "setup_s": setup_s, "kernel_launches": used,
           "launches_expected": expected}
    emit(res)
    if not all(np.isfinite(costs)) or not costs[-1] < costs[0]:
        raise AssertionError(f"{cell} training did not learn: {costs}")
    if used != expected:
        raise AssertionError(f"{cell} launches {used}, expected {expected}")
    return res


def train_lstm(dev) -> dict:
    return _rnn_train(dev, "lstm", RNN_TRAIN_STEPS, ("lstm_step",))


def train_gru(dev) -> list:
    return [_rnn_train(dev, "gru", steps, kernels, hidden=hidden,
                       num_layers=layers)
            for hidden, layers, steps, kernels in GRU_RUNS]


def rnn_parity(dev) -> list:
    out = []
    batch = rw.samples(rw.SEED + 2, bs=RNN_PARITY_BATCH)
    for cell in ("lstm", "gru"):
        sgd = rw.build_trainer(dev, cell)
        before = rw.launches()
        kernel_costs, _ = _train_costs(sgd, batch, RNN_PARITY_STEPS, rw)
        used = {k: v - before[k] for k, v in rw.launches().items()}
        del sgd
        sgd = rw.build_trainer(dev, cell)
        with rw.plain_rnn_path():
            plain_costs, _ = _train_costs(sgd, batch, RNN_PARITY_STEPS, rw)
        del sgd
        rel = [abs(a - b) / abs(b) for a, b in zip(kernel_costs, plain_costs)]
        # at batch 16 the GRU takes B6 at h 512
        kern = "lstm_step" if cell == "lstm" else "gru_step"
        expected = {k: (rw.MODEL["num_layers"] * rw.STEPS_T *
                        RNN_PARITY_STEPS if k == kern else 0) for k in used}
        res = {"phase": "rnn_parity", "cell": cell,
               "layers": rw.MODEL["num_layers"],
               "hidden": rw.MODEL["hidden"], "batch": RNN_PARITY_BATCH,
               "steps": RNN_PARITY_STEPS, "kernel_costs": kernel_costs,
               "plain_costs": plain_costs, "max_rel_diff": max(rel),
               "rtol": RNN_PARITY_RTOL, "kernel_launches": used,
               "launches_expected": expected}
        emit(res)
        if max(rel) > RNN_PARITY_RTOL or used != expected:
            raise AssertionError(f"{cell}: kernel path and plain path "
                                 "disagree")
        out.append(res)
    return out


def rnn_kernel_lines(cases, trained_lstm, trained_gru) -> list:
    """The ``kernels`` entries of B5-B8: launches from the training runs
    of the main path, the rest from their main-path case."""
    launched = dict(trained_lstm["kernel_launches"])
    for run in trained_gru:
        for k, n in run["kernel_launches"].items():
            launched[k] = launched.get(k, 0) + n
    lines = []
    for kname, cname in rw.MAIN_CASE.items():
        r = cases[cname][kname]
        lines.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rnn_cells.cu",
            "replaces": RNN_REPLACES[kname], "launches": launched[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "ptxas": ptxas_of("rnn_cells", RNN_PTXAS[kname]),
            "library": ("torch.nn.LSTM forward (cuDNN) over [64, 128, "
                        f"{cases[cname]['H']}], per step"
                        if kname == "lstm_step" else GRU_NO_LIBRARY),
            "case": cname})
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script drives the port on "
              "a GPU", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]})

    t0 = time.perf_counter()
    build.build(build.sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {n: round(s, 3) for n, (s, _) in
                      build.BUILD_LOG.items()},
          "ptxas": [line.strip() for _, log in build.BUILD_LOG.values()
                    for line in log.splitlines() if "registers" in line
                    or "spill" in line]})

    cases = run_kernel_cases(dev)
    model = build_model(dev)
    served = serve(model, dev)
    serve_int8(model, dev)
    del model
    torch.cuda.empty_cache()
    serve_small(dev)

    flash = run_flash_cases(dev)
    trained = train(dev)
    train_parity(dev)
    torch.cuda.empty_cache()

    rnn_cases = run_rnn_cases(dev)
    trained_lstm = train_lstm(dev)
    trained_gru = train_gru(dev)
    rnn_parity(dev)

    main_case = next(c for c in cases if c["case"] == "mixed_f32")
    decode_case = next(c for c in cases if c["case"] == "decode_f32")
    kernels = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/serving/decode_attention.py:173",
        "launches": served["kernel_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["pages"] == c["q"] == "float32"),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "case": "mixed_f32",
        "decode_f32": {k: decode_case[k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by")}}]
    flash_main = flash["a_bf16_8x1024_causal"]
    replaces = {"flash_fwd": "paddle_tpu/ops/attention.py:142",
                "flash_bwd_kv": "paddle_tpu/ops/attention.py:289",
                "flash_bwd_dq": "paddle_tpu/ops/attention.py:353"}
    for name in FLASH_KERNELS:
        r = flash_main[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_sm90.cu",
            "replaces": replaces[name],
            "launches": trained["kernel_launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # the forward alone for the forward kernel; the backward alone
            # (dK/dV and dQ together) for the backward ones
            "library_ms": (flash_main["library_fwd_ms"]
                           if name == "flash_fwd"
                           else flash_main["library_bwd_ms"]),
            **{key: flash_main[key] for key in LIBRARY_KEYS},
            "library": "scaled_dot_product_attention(is_causal=True) on "
                       "[8, 16, 1024, 128], " + (
                           "forward" if name == "flash_fwd"
                           else "backward of a saved forward"),
            "ptxas": ptxas_of("flash_attention_sm90", FLASH_PTXAS[name]),
            "case": "a_bf16_8x1024_causal"})
    kernels += rnn_kernel_lines(rnn_cases, trained_lstm, trained_gru)
    emit({"phase": "done", "seconds_total": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
