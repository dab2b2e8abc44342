"""The serving engine's upper tier at the headline width, in one place:
speculative decoding (n-gram and draft proposers), sampled speculation,
the host page tier and a traced drive.  ``chip_smoke.py`` runs these
phases on the card; the functions take the model and the engine's
arguments, so a CPU test drives them at a small width.

The target is ``serve_workload``'s headline ``DecoderLM`` (d 2048, 8
layers, 16 heads of 128, vocab 32768) on its engine (page 128, 8 slots,
a 129-page f32 pool, 8 pages a sequence).  The speculation traffic is the
serve phase's 8 prompts plus 4 prompts built from repeated motifs, so
that prompt lookup hits, all submitted at once, 32 new tokens each.  The
draft model is a 2-layer ``DecoderLM`` at d 1024 (8 heads of 128) over
the same vocabulary with its own seeded numpy weights.

Usage::

    model = serve_workload.build_model(dev)
    off = drive(serve_workload.make_engine(model, dev), spec_prompts())
    on = drive(serve_workload.make_engine(model, dev, spec_mode="ngram",
                                          spec_k=4, spec_ngram=3),
               spec_prompts())
    assert on["outputs"] == off["outputs"]
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from paddle_tpu_torch.tools import serve_workload as sw

SEED = 0
SPEC_K = 4
SPEC_NGRAM = 3
MOTIF_PROMPTS = 4
MOTIF_LENS = (3, 5, 8, 13)          # motif lengths of the 4 prompts
MOTIF_REPEATS = 24
DRAFT = dict(num_layers=2, num_heads=8, head_dim=128, ffn_mult=4,
             max_positions=1024)
SAMPLING = dict(temperature=0.8, top_p=0.95)
SAMPLED_TOKENS = 16                 # new tokens a request when sampling
# the host-tier drive: a 12-usable-page pool, 2 slots; the sharer's
# 4-page prefix is evicted by two 640-token fillers and comes back from
# the host tier, which holds HOST_PAGES pages
HOST_PAGES = 32
HOST_POOL_PAGES = 13
HOST_PREFIX = 512
HOST_TAILS = (64, 100)
HOST_FILLERS = (640, 640)
HOST_NEW_TOKENS = 8
# the int8 host format's bound on a swapped-in value, in quantization
# steps: one half, plus the f32 rounding of x / step and of q * step at
# |x / step| <= 127 (127 * 2**-23 each, ~1.5e-5 a step; a full-width run
# read 0.5000057)
INT8_STEP_BOUND = 0.5 + 1e-4
# the spans and instants a traced speculative drive must hold
TRACE_NAMES = ("submit", "admit", "prefill_chunk", "decode_tick",
               "first_token", "terminal", "spec_accept", "page_alloc",
               "page_free")


def motif_prompts(vocab: int, n: int = MOTIF_PROMPTS) -> List[List[int]]:
    """Prompts of a random motif repeated: prompt lookup finds what
    followed the current suffix, and the model, once it repeats, repeats
    the motif too."""
    rng = np.random.default_rng(SEED + 11)
    out = []
    for i in range(n):
        motif = rng.integers(2, vocab, MOTIF_LENS[i % len(MOTIF_LENS)])
        out.append(np.tile(motif, MOTIF_REPEATS)[:MOTIF_REPEATS * 4]
                   .tolist())
    return out


def spec_prompts(vocab: int = sw.MODEL["vocab_size"]) -> List[List[int]]:
    """The serve phase's 8 prompts (its first seven and the sharer) and
    the motif prompts."""
    first, sharer = sw.prompts()
    return first + [sharer] + motif_prompts(vocab)


def drive(engine, prompts, max_tokens: int = sw.NEW_TOKENS,
          sampling: Optional[Callable[[int], object]] = None) -> Dict:
    """Submit every prompt at once and run the engine dry: outputs (in
    submission order), wall seconds, ticks, steps and the metrics
    snapshot.  ``sampling(i)`` gives request i's SamplingParams."""
    import torch

    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_kernel as kernel

    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_tokens=max_tokens,
                          sampling=None if sampling is None
                          else sampling(i))
            for i, p in enumerate(prompts)]
    engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = engine.metrics
    outputs = [engine.result(r) for r in rids]
    return {"outputs": outputs, "wall_s": wall, "ticks": m.ticks,
            "steps": m.step_dispatches, "launches": kernel.launches,
            "tokens": sum(len(o or ()) for o in outputs),
            "tokens_per_s": sum(len(o or ()) for o in outputs) / wall,
            "snapshot": m.snapshot(),
            "completed": all(o is not None and len(o) == max_tokens
                             for o in outputs)}


def build_draft(dev, vocab: int = sw.MODEL["vocab_size"], **cfg):
    """The draft ``DecoderLM`` and its seeded numpy weights (the engine
    loads them: ``ServingEngine(draft_model=, draft_params=)``)."""
    from paddle_tpu_torch.convert import init_numpy_params
    from paddle_tpu_torch.serving import DecoderLM

    model = DecoderLM(vocab_size=vocab, **dict(DRAFT, **cfg), device=dev)
    return model, init_numpy_params(model, SEED + 7)


def first_difference(a: List[int], b: List[int]) -> Optional[int]:
    """The first position where two token streams differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


# ---------------------------------------------------------------------------
# the host tier
# ---------------------------------------------------------------------------

def host_prompts(vocab: int, prefix: int = HOST_PREFIX,
                 tails=HOST_TAILS, fillers=HOST_FILLERS):
    """(the first request, the fillers, the sharer): the first and the
    sharer share a ``prefix``-token prefix."""
    rng = np.random.default_rng(SEED + 13)
    pre = rng.integers(2, vocab, prefix).tolist()
    first = pre + rng.integers(2, vocab, tails[0]).tolist()
    fill = [rng.integers(2, vocab, n).tolist() for n in fillers]
    sharer = pre + rng.integers(2, vocab, tails[1]).tolist()
    return first, fill, sharer


def host_tier_drive(engine, first, fillers, sharer,
                    new_tokens: int = HOST_NEW_TOKENS,
                    corrupt: bool = False) -> Dict:
    """The first request, then the fillers (which evict its cached
    prefix pages: they spill to the host tier), then the sharer, whose
    prefix the host tier swaps back in.  Returns the sharer's tokens,
    the tier's snapshot, the prefix pages as they were before eviction
    and as the sharer's table holds them after the swap-in (host copies),
    and whether the drive conserved pages.  ``corrupt`` flips one byte of
    the first prefix block's host record after its commit."""
    import torch

    from paddle_tpu_torch.serving.kv_cache import read_pages

    eng = engine
    page = eng.kv_cfg.page_size
    nblocks = (first_difference(first, sharer) or 0) // page
    r0 = eng.submit(first, max_tokens=new_tokens)
    eng.run()
    before = read_pages(eng._kv, eng.cache.lookup(first)[0][:nblocks])
    for f in fillers:
        eng.submit(f, max_tokens=new_tokens)
    eng.run()
    eng.host_tier.flush()
    if corrupt:
        key = eng.cache.chain_keys(sharer)[0]
        rec = eng.host_tier._index[key]
        rec.k.reshape(-1).view(torch.uint8)[7] ^= 0x40
    rs = eng.submit(sharer, max_tokens=new_tokens)
    swapped, after = [], None
    while eng.has_work:
        eng.step()
        req = eng._requests[rs]
        if not swapped and req.slot is not None:
            hit = req.cached_len // page
            swapped = list(req.pages[:hit])
            after = read_pages(eng._kv, swapped) if swapped else None
    eng.run()
    eng.check_page_conservation()
    return {"first": eng.result(r0), "sharer": eng.result(rs),
            "snapshot": eng.host_tier.snapshot(),
            "host_hits": eng._host_hits, "swapped_pages": len(swapped),
            "before": before, "after": after}


def int8_page_error(before, after) -> Dict:
    """Swapped-in K/V (the int8 host copy dequantized on promotion)
    against the pages before eviction: the largest error relative to the
    quantization step of its row (``amax / 127``), which the int8 rule
    bounds by one half (see :data:`INT8_STEP_BOUND`: plus the f32 rounding
    of ``x / step`` and ``q * step``)."""
    worst = 0.0
    for a, b in zip(before[:2], after[:2]):
        a, b = a.float(), b.float()
        step = a.abs().amax(dim=-1, keepdim=True).clamp(min=1e-20) / 127.0
        worst = max(worst, float(((b - a).abs() / step).max()))
    return {"max_err_in_steps": worst}
