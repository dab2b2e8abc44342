"""The full-width training workload that ``chip_smoke.py`` drives, and the
flash-attention kernel cases it checks, in one place so the script and
``tests/test_torch_kernels_cuda.py`` run the same shapes.

The model is the repo's headline transformer config (bench.py:428-431,
first tier): ``transformer.build(vocab 32768, d_model 2048, 8 layers, 16
heads, max_len 1024)`` trained with ``Momentum(0.9)`` (bench.py:89-94) at
the flag defaults (bf16 matmul and attention inputs, f32 residual
stream).  The learning rate is 1e-3, not bench.py's 0.01: the cost is
the per-sequence sum of 1024 token losses (``trainer._reduce_cost``, as
in the JAX package), so its gradient is ~1024 times a mean loss's, and
at 0.01 the cost of a repeated batch rises after the second step; a
step's work, and so its time, does not depend on the rate.  A batch is
8 random sequences of 1024 tokens with next-token targets
(bench.py:393-396), which the feeder packs into one
8192-slot ``SequenceBatch``: every attention call is then q/k/v [1, 8192,
16, 128] bf16 with 8 causal segments of 1024.

Usage::

    sgd = build_trainer(torch.device("cuda"))
    sgd.train(repeat_reader(lm_samples(SEED + 1), steps), feeding=FEEDING)
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from paddle_tpu_torch.tools import transformer_nmt_workload as tnw

MODEL = dict(vocab_size=32768, d_model=2048, n_layers=8, n_heads=16,
             max_len=1024)
BATCH, SEQ = 8, 1024
SEED = 0                 # weights; the batch uses SEED + 1
FEEDING = {"tokens": 0, "pos": 1, "target": 2}
MOMENTUM, LEARNING_RATE = 0.9, 1e-3


def lm_samples(seed: int, bs: int = BATCH, seq: int = SEQ,
               vocab: int = MODEL["vocab_size"]):
    """``bs`` random sequences of ``seq`` tokens as (tokens, positions,
    next-token targets) samples."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(bs):
        t = rng.randint(0, vocab, size=seq)
        samples.append((t.tolist(), list(range(seq)),
                        np.roll(t, -1).tolist()))
    return samples


def repeat_reader(samples, steps: int):
    """A reader that yields the same batch ``steps`` times."""
    return lambda: iter([samples] * steps)


def flash_launches() -> dict:
    """The flash kernels' (B1-B3) launch counts."""
    from paddle_tpu_torch.ops import attention as A

    return {"flash_fwd": A.flash_fwd_kernel.launches,
            "flash_bwd_kv": A.flash_bwd_kv_kernel.launches,
            "flash_bwd_dq": A.flash_bwd_dq_kernel.launches}


def reset_flash_launches() -> None:
    from paddle_tpu_torch.ops import attention as A

    for kern in (A.flash_fwd_kernel, A.flash_bwd_kv_kernel,
                 A.flash_bwd_dq_kernel):
        kern.launches = 0


def build_trainer(device, n_layers: int = MODEL["n_layers"],
                  seed: int = SEED, weights=None, faults=None, guard=None,
                  **levers):
    """``trainer.SGD`` over ``transformer.build`` at the workload's width
    with ``n_layers`` blocks, weights from ``seed`` (or copies of
    ``weights``, name -> tensor, when given: a fresh trainer from weights
    drawn once), on ``device``; ``faults`` and ``guard`` go to ``SGD``;
    ``levers``: ``build``'s ``fused_head``, ``remat`` and ``dropout``."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    cfg = dict(MODEL, n_layers=n_layers, **levers)
    *_, cost = transformer.build(**cfg)
    if weights is None:
        params = Parameters.from_topology(topology.Topology([cost]),
                                          seed=seed, device=device)
    else:
        params = Parameters()
        for name, value in weights.items():
            params[name] = value.detach().clone()
    return trainer.SGD(cost, params, optimizer.Momentum(
        momentum=MOMENTUM, learning_rate=LEARNING_RATE), faults=faults,
        guard=guard, device=device)


# multi_head_attention at the head dims the kernels run on zero columns
# (12), at their compiled width 512 (320) and on the wide kernels (640):
# one block, vocab 1024, 2 sequences of 256 tokens, 3 Momentum steps
HEAD_DIM_MODELS = {12: dict(d_model=48, n_heads=4),
                   320: dict(d_model=640, n_heads=2),
                   640: dict(d_model=1280, n_heads=2)}
HEAD_DIM_BATCH, HEAD_DIM_SEQ, HEAD_DIM_VOCAB = 2, 256, 1024


def head_dim_trainer(device, head_dim: int, seed: int = SEED):
    """``trainer.SGD`` over a one-block ``transformer.build`` whose
    attention runs at ``head_dim`` (:data:`HEAD_DIM_MODELS`), weights
    from ``seed`` (drawn on the host: the same on every device)."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    *_, cost = transformer.build(vocab_size=HEAD_DIM_VOCAB, n_layers=1,
                                 max_len=HEAD_DIM_SEQ,
                                 **HEAD_DIM_MODELS[head_dim])
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return trainer.SGD(cost, params, optimizer.Momentum(
        momentum=MOMENTUM, learning_rate=LEARNING_RATE), device=device)


@contextlib.contextmanager
def plain_flash_path():
    """Route the layers' flash attention through the plain versions on
    the card (``flash_attention_reference``): the path the kernel path
    is held against in a training run."""
    from paddle_tpu_torch.ops import attention

    kernels = attention.flash_attention
    attention.flash_attention = attention.flash_attention_reference
    try:
        yield
    finally:
        attention.flash_attention = kernels


# ---------------------------------------------------------------------------
# flash-attention kernel cases
# ---------------------------------------------------------------------------


@dataclass
class FlashCase:
    name: str
    q: torch.Tensor          # [B, Sq, H, D]
    k: torch.Tensor          # [B, Sk, H, D]
    v: torch.Tensor
    dout: torch.Tensor       # [B, Sq, H, D]
    q_seg: torch.Tensor      # [B, Sq] int32
    kv_seg: torch.Tensor     # [B, Sk] int32
    causal: bool

    @property
    def sm_scale(self) -> float:
        return float(self.q.shape[-1]) ** -0.5


def packed_segments(lengths: Sequence[int], capacity: int) -> np.ndarray:
    """[1, capacity] segment ids as the feeder packs ``lengths``: the
    slots past the last sequence take the id ``len(lengths)``."""
    seg = np.full((1, capacity), len(lengths), np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[0, off:off + n] = i
        off += n
    return seg


# the feeder's packing of 8 ragged sequences (6561 tokens) into 8192 slots
RAGGED_LENGTHS = (1000, 700, 1024, 513, 900, 1024, 800, 600)
_S = BATCH * SEQ
# one Transformer-base translation batch: 80 sources and 80 targets of
# 10-81 tokens, each side packed into 4096 slots
_NMT_SRC, _NMT_TRG = tnw.batch_lengths()
# name: (dtype, Sq, Sk, H, D, causal, packed lengths or None[, the keys'
# packed lengths]); None means no segment ids (one segment); without the
# keys' own lengths, Sk == Sq shares the queries' ids and Sk != Sq is one
# segment
FLASH_CASES = {
    # (a) the training path: 8 causal segments of 1024 in 8192 slots
    "a_bf16_8x1024_causal": ("bfloat16", _S, _S, 16, 128, True,
                             (SEQ,) * BATCH),
    # (b) ragged segments and a padding segment, as the feeder packs them
    "b_bf16_ragged_padded": ("bfloat16", _S, _S, 16, 128, True,
                             RAGGED_LENGTHS),
    # (c) f32, causal segments at a smaller S, head dims 128 and 64
    "c_f32_segments_causal": ("float32", 2048, 2048, 16, 128, True,
                              (600, 1000, 300)),
    "c_f32_segments_causal_d64": ("float32", 2048, 2048, 16, 64, True,
                                  (600, 1000, 300)),
    # (d) non-causal cross-attention, Sq != Sk
    "d_bf16_cross": ("bfloat16", 1024, 2048, 16, 128, False, None),
    "d_f32_cross": ("float32", 1024, 2048, 16, 128, False, None),
    # (e) causal cross-attention with Sk > Sq
    "e_f32_causal_sk_gt_sq": ("float32", 512, 2048, 16, 128, True, None),
    # (f) the wgmma kernels at head dim 64: bf16 causal segments
    "f_bf16_segments_causal_d64": ("bfloat16", 2048, 2048, 16, 64, True,
                                   (600, 1000, 300)),
    # (g) bf16 causal cross-attention with Sk > Sq and Sq an odd number of
    # 64-row tiles (the forward's last block holds one query tile)
    "g_bf16_causal_cross_sq576": ("bfloat16", 576, 2048, 16, 128, True,
                                  None),
    # (h) bf16 non-causal segments, as `layer.multi_head_attention` runs
    # them: a warpgroup's last tile is followed by many the other one's
    # alone (query tile 8 of segment 0 beside tile 9, which reaches into
    # segment 1), so the held stage comes round in the ring again
    "h_bf16_segments_noncausal": ("bfloat16", 2048, 2048, 16, 128, False,
                                  (600, 1000, 300)),
    # (i, j) the CUDA-core kernels at the head dims the wgmma ones do not
    # take, as `layer.multi_head_attention` gives them: size 256 over 8
    # heads (head dim 32) and size 2048 over 8 heads (head dim 256)
    "i_bf16_segments_causal_d32": ("bfloat16", 2048, 2048, 8, 32, True,
                                   (600, 1000, 300)),
    "j_bf16_segments_causal_d256": ("bfloat16", 2048, 2048, 8, 256, True,
                                    (600, 1000, 300)),
    # (k) a length that is not whole 64-row tiles: 96 queries and keys
    "k_bf16_causal_s96": ("bfloat16", 96, 96, 16, 128, True, None),
    # (l, m) head dims between the CUDA-core kernels' compiled widths, run
    # by the kernels at widths 128 and 64 with their columns past the head
    # dim zero: size 384 over 4 heads (head dim 96), and head dim 48 in f32
    "l_bf16_segments_causal_d96": ("bfloat16", 2048, 2048, 4, 96, True,
                                   (600, 1000, 300)),
    "m_f32_segments_causal_d48": ("float32", 2048, 2048, 8, 48, True,
                                  (600, 1000, 300)),
    # (n, o, p) the translation model's three attentions at head dim 64:
    # encoder self-attention over the sources' segments, cross-attention
    # of the targets' packing against the sources' (segment i against
    # segment i, each buffer's padding a segment of its own), and causal
    # decoder self-attention over the targets' segments
    "n_bf16_enc_segments": ("bfloat16", 4096, 4096, 8, 64, False,
                            _NMT_SRC),
    "o_bf16_cross": ("bfloat16", 4096, 4096, 8, 64, False, _NMT_TRG,
                     _NMT_SRC),
    "p_bf16_dec_causal_segments": ("bfloat16", 4096, 4096, 8, 64, True,
                                   _NMT_TRG),
}
# the translation model's cases, and the training case whose times the
# kernels line reports beside them
NMT_FLASH_CASES = ("n_bf16_enc_segments", "o_bf16_cross",
                   "p_bf16_dec_causal_segments")


# head dims the kernels run on inputs widened with zero columns (12 and
# 100, to 16 and 104) and at the compiled width 512 (320), each in f32 and
# bf16 over causal segments
C4_FLASH_CASES = {
    f"c4_{dtype[:4]}_segments_causal_d{d}": (dtype, 1024, 1024, 4, d, True,
                                             (300, 500, 200))
    for d in (12, 100, 320) for dtype in ("float32", "bfloat16")}


# head dims above 512, on the wide kernels (chunks of 512 columns), each
# in f32 and bf16 over causal segments
C4_WIDE_FLASH_CASES = {
    f"c4_{dtype[:4]}_segments_causal_d{d}": (dtype, 512, 512, 4, d, True,
                                             (150, 250, 100))
    for d in (640, 1024) for dtype in ("float32", "bfloat16")}
_TABLES = (FLASH_CASES, C4_FLASH_CASES, C4_WIDE_FLASH_CASES)


def _case(name: str):
    """(the case's entry, the seed of its draws)."""
    base = 0
    for table in _TABLES:
        if name in table:
            return table[name], [SEED, base + sorted(table).index(name)]
        base += len(table)
    raise KeyError(name)


def case_segments(name: str):
    """The named case's (q_seg [1, Sq], kv_seg [1, Sk]) int32 arrays."""
    _, sq, sk, _, _, _, lengths, *kv_lengths = _case(name)[0]
    q_seg = (np.zeros((1, sq), np.int32) if lengths is None
             else packed_segments(lengths, sq))
    if kv_lengths:
        kv_seg = packed_segments(kv_lengths[0], sk)
    else:
        kv_seg = q_seg if sq == sk else np.zeros((1, sk), np.int32)
    return q_seg, kv_seg


def flash_case(name: str, device) -> FlashCase:
    """The named case's inputs on ``device``, drawn from a seed."""
    (dtype, sq, sk, h, d, causal, *_), seed = _case(name)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)

    def t(a, to=dt):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, to)

    def normal(s):
        return t(rng.standard_normal((1, s, h, d), np.float32))

    q_seg, kv_seg = case_segments(name)
    return FlashCase(name=name, q=normal(sq), k=normal(sk), v=normal(sk),
                     dout=normal(sq), q_seg=t(q_seg, torch.int32),
                     kv_seg=t(kv_seg, torch.int32), causal=causal)


# f32 outputs (and lse, f32 in every case) against the plain version:
# 1e-4 abs + rel.  bf16 outputs (O, dQ, dK, dV):
# |err| <= 2**-7 |want| + 2e-3 max|want|: one bf16 step at the element's own
# magnitude, for an output whose f32 sum, taken in another order, rounds to
# the other neighbour, plus 2e-3 of the tensor's largest magnitude for
# elements summed from many bf16-rounded P or dS terms that cancel.  The
# plain version rounds P and dS to bf16 where the kernels do, at the
# kernels' 64-key tiles (the same running maxima), and sums in f32.  On an
# H100 the largest error over this limit came to 0.57 (bf16
# cross-attention dQ); over 2e-3 max|want| alone it would have been 1.2
# (dV, one bf16 step at a value above 4).
FLASH_TOL_F32 = (1e-4, 1e-4)
FLASH_TOL_BF16 = (2e-3, 2.0 ** -7)   # (of max|want|, of |want|)


def flash_error(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max abs error of a kernel output against the plain version's, the
    largest error over its limit, and whether every element is within
    the tolerance above (and finite)."""
    err = (got.float() - want.float()).abs()
    want = want.float()
    if got.dtype == torch.bfloat16:
        limit = FLASH_TOL_BF16[0] * want.abs().max() + \
            FLASH_TOL_BF16[1] * want.abs()
    else:
        limit = FLASH_TOL_F32[0] + FLASH_TOL_F32[1] * want.abs()
    return {"max_abs_err": float(err.max()),
            "max_abs_want": float(want.abs().max()),
            "worst_err_over_limit": float((err / limit).max()),
            "within_tolerance": bool((err <= limit).all()) and
            bool(torch.isfinite(got).all())}


def live_pairs(q_seg: np.ndarray, kv_seg: np.ndarray, causal: bool) -> int:
    """(query, key) pairs the mask keeps, summed over the batch: same
    segment id and, under ``causal``, key index <= query index."""
    total = 0
    for qs, ks in zip(q_seg, kv_seg):
        for sid in np.unique(qs):
            qpos = np.flatnonzero(qs == sid)
            kpos = np.flatnonzero(ks == sid)
            if causal:
                total += int(np.searchsorted(kpos, qpos, side="right").sum())
            else:
                total += len(qpos) * len(kpos)
    return total


# ---------------------------------------------------------------------------
# decoding the headline LM from the trainer's parameter dict
# ---------------------------------------------------------------------------

# greedy: 64 tokens after a 32-token prompt; beam 4 over 32 tokens, one
# prompt and a batch of 8, eos 0, length penalty 1
DECODE_PROMPT, DECODE_NEW = 32, 64
BEAM, BEAM_NEW, BEAM_BATCH, BEAM_EOS = 4, 32, 8, 0
BEAM_STOP_AT = 24        # the stop_condition ends every beam after step 24
# a card token that is not the CPU's argmax passes as a near tie: the
# CPU's top logit above the card token's by under 1e-3 of the top logit
# (the serve phase's rule); a beam run whose tokens differ passes when a
# step's k-th and (k+1)-th candidate totals lay within BEAM_TIE_ATOL
# (f32 sums in another order move a 32-token total by ~1e-5)
NEAR_TIE_RTOL, BEAM_TIE_ATOL, BEAM_SCORE_RTOL = 1e-3, 1e-3, 1e-5


def decode_params(device, seed: int = SEED):
    """``transformer.build`` parameters at the workload's width from
    ``seed`` (drawn on the host), on ``device``, as a name -> tensor
    dict."""
    from paddle_tpu_torch import topology
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    *_, cost = transformer.build(**MODEL)
    return Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                    device=device).as_dict()


def decode_prompts(seed: int, n: int, length: int = DECODE_PROMPT):
    """``n`` prompts of ``length`` token ids drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, MODEL["vocab_size"], size=(n, length)).tolist()


def decode_kw():
    return dict(n_layers=MODEL["n_layers"], n_heads=MODEL["n_heads"],
                max_len=MODEL["max_len"])


class BanAndStop:
    """The beam run's hooks: ``adjust`` bans token ``banned`` (None: no
    token) from every live beam; ``stop`` ends every beam after step
    ``stop_at``.  With
    ``record`` on, ``adjust`` also keeps each step's selection margin
    (:attr:`gaps`: the k-th best candidate total over the (k+1)-th, after
    done beams are frozen to ``eos_id``), one device scalar a step."""

    def __init__(self, banned: int, eos_id: int = BEAM_EOS,
                 stop_at: int = BEAM_STOP_AT, record: bool = False):
        self.banned, self.eos_id, self.stop_at = banned, eos_id, stop_at
        self.record = record
        self.gaps = []

    def adjust(self, logp, beam):
        if self.banned is not None:
            logp = logp.clone()
            logp[:, self.banned] = -1e30
        if self.record:
            k, v = logp.shape
            eos_row = torch.full((v,), -1e30, device=logp.device)
            eos_row[self.eos_id] = 0.0
            cand = beam.scores[:, None] + torch.where(
                beam.finished[:, None], eos_row, logp)
            top = torch.topk(cand.reshape(-1), k + 1).values
            self.gaps.append(top[k - 1] - top[k])
        return logp

    def stop(self, beam):
        return beam.t >= self.stop_at

    def hooks(self):
        return dict(candidate_adjust=self.adjust, stop_condition=self.stop)


def replay_greedy(params, prompt, tokens, *, n_layers: int, n_heads: int,
                  **_decode) -> dict:
    """The CPU path's logits over ``prompt + tokens`` in one pass (the
    stack of ``transformer.block_apply`` under the f32 policy, as the
    decoders compute), and at each generated
    position whether ``tokens`` holds the argmax or a near tie
    (:data:`NEAR_TIE_RTOL`).  ``params``: the model's tensors on the
    CPU; the rest: :func:`decode_kw`."""
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.tools.nmt_workload import f32_policy

    seq = torch.tensor(list(prompt) + list(tokens))
    n = len(prompt)
    with torch.no_grad(), f32_policy():
        x = params["tok_embed.w"][seq] + \
            params["pos_embed.w"][torch.arange(len(seq))]
        for stage in transformer.stage_params(params, n_layers):
            x = transformer.block_apply(stage, x, n_heads=n_heads)
        logits = transformer._logits(params, x)[n - 1:-1]
    want = logits.argmax(dim=-1)
    top = logits.max(dim=-1).values
    picked = logits[torch.arange(len(tokens)), torch.tensor(tokens)]
    gap = top - picked
    diff = want != torch.tensor(tokens)
    ties = diff & (gap < NEAR_TIE_RTOL * top.abs())
    return {"positions": len(tokens), "argmax_equal": int((~diff).sum()),
            "near_ties": int(ties.sum()),
            "worst_gap_over_limit": float((gap / (NEAR_TIE_RTOL *
                                                  top.abs())).max()),
            "ok": bool((~diff | ties).all())}


def beams_agree(got, want, gaps) -> dict:
    """Two beam runs' (tokens, score) of one prompt: equal tokens and
    scores within :data:`BEAM_SCORE_RTOL`, or tokens that part only after
    a step whose selection margin (``gaps``, the reference run's) lay
    within :data:`BEAM_TIE_ATOL`."""
    (gt, gs), (wt, ws) = got, want
    first = next((i for i, (a, b) in enumerate(zip(gt, wt)) if a != b),
                 None)
    margin = float(min(float(g) for g in gaps[:first + 1])) \
        if first is not None else None
    score_rel = abs(float(gs) - float(ws)) / max(abs(float(ws)), 1e-30)
    ok = (score_rel <= BEAM_SCORE_RTOL if first is None
          else margin < BEAM_TIE_ATOL)
    return {"tokens_equal": first is None, "first_diff": first,
            "margin_there": margin, "score_rel_diff": score_rel, "ok": ok}
