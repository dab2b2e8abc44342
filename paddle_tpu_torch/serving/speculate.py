"""Token choice for the serving engine: greedy argmax and seeded sampling
(the sampling half of ``paddle_tpu/serving/speculate.py``, in numpy; the
n-gram and draft-model proposers are not ported yet).

All of it runs on the host over numpy logits, so ties break exactly as in
the JAX package (``np.argmax`` takes the first maximum) and a sampled
draw is a pure function of (request seed, token position).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.platform.enforce import enforce_that

__all__ = ["SamplingParams", "accept_tokens", "next_token", "position_rng",
           "warp_probs"]

# RNG stream ids: one MT19937 stream per (seed, token position, role)
_STREAM_ACCEPT = 0      # accept/residual/bonus draws (the emission side)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy.  ``temperature <= 0`` is greedy;
    ``top_k``/``top_p`` restrict the warped support (0 / 1.0 = off);
    ``seed`` keys the per-position RNG streams."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        enforce_that(self.temperature >= 0.0,
                     "temperature must be >= 0", context="serving-spec")
        enforce_that(self.top_k >= 0, "top_k must be >= 0",
                     context="serving-spec")
        enforce_that(0.0 < self.top_p <= 1.0,
                     "top_p must be in (0, 1]", context="serving-spec")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def position_rng(seed: int, position: int, stream: int = _STREAM_ACCEPT
                 ) -> np.random.RandomState:
    """Counter-based RNG: one deterministic stream per (seed, position,
    stream) — no state carried across tokens."""
    return np.random.RandomState(
        [int(seed) & 0xFFFFFFFF, int(position) & 0xFFFFFFFF,
         0x5BEC0DE ^ int(stream)])


def warp_probs(logits: np.ndarray, s: SamplingParams) -> np.ndarray:
    """Temperature, then top-k, then nucleus truncation, renormalized —
    f64 throughout so replays cannot diverge on rounding."""
    z = np.asarray(logits, np.float64)
    z = z / max(float(s.temperature), 1e-6)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    if s.top_k and s.top_k < p.size:
        cut = np.partition(p, -s.top_k)[-s.top_k]
        p = np.where(p >= cut, p, 0.0)
    if s.top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        csum = np.cumsum(p[order])
        keep_n = int(np.searchsorted(csum, s.top_p, side="left")) + 1
        mask = np.zeros_like(p)
        mask[order[:keep_n]] = 1.0
        p = p * mask
    tot = p.sum()
    if tot <= 0.0:              # degenerate logits: fall back to argmax
        p = np.zeros_like(p)
        p[int(np.argmax(logits))] = 1.0
        return p
    return p / tot


def _draw(probs: np.ndarray, rng: np.random.RandomState) -> int:
    csum = np.cumsum(probs)
    u = rng.random_sample() * csum[-1]
    return int(min(np.searchsorted(csum, u, side="right"),
                   probs.size - 1))


def next_token(logits: np.ndarray, sampling: Optional[SamplingParams],
               position: int) -> int:
    """One emission: argmax when greedy, else a seeded draw from the
    warped distribution.  ``position`` indexes the token in the request's
    generated stream (the RNG counter)."""
    if sampling is None or sampling.greedy:
        return int(np.argmax(logits))
    rng = position_rng(sampling.seed, position)
    return _draw(warp_probs(logits, sampling), rng)


def accept_tokens(rows: np.ndarray, drafts: Sequence[int],
                  draft_probs: Optional[np.ndarray],
                  sampling: Optional[SamplingParams],
                  position: int, eos_id: int) -> Tuple[List[int], int]:
    """The verify walk: score ``drafts`` against the target logits
    ``rows`` ``[len(drafts) + 1, V]`` and return ``(emitted tokens,
    accepted draft count)``.  With no drafts this is exactly one
    :func:`next_token` emission.  Greedy accepts while the argmax agrees;
    sampled uses standard rejection sampling against the warped target
    (``draft_probs`` None = a point-mass proposer).  An accepted EOS ends
    the walk."""
    emitted: List[int] = []
    greedy = sampling is None or sampling.greedy
    for i, d in enumerate(drafts):
        d = int(d)
        if greedy:
            g = int(np.argmax(rows[i]))
            if g != d:
                emitted.append(g)
                return emitted, i
        else:
            p = warp_probs(rows[i], sampling)
            if draft_probs is not None:
                q = np.asarray(draft_probs[i], np.float64)
            else:
                q = np.zeros(p.shape, np.float64)
                q[d] = 1.0
            rng = position_rng(sampling.seed, position + i)
            ratio = 0.0 if q[d] <= 0.0 else min(1.0, p[d] / q[d])
            if rng.random_sample() >= ratio:
                resid = np.maximum(p - q, 0.0)
                tot = resid.sum()
                emitted.append(_draw(resid / tot if tot > 0.0 else p, rng))
                return emitted, i
        emitted.append(d)
        if d == eos_id:
            return emitted, i + 1
    k = len(drafts)
    if greedy:
        emitted.append(int(np.argmax(rows[k])))
    else:
        rng = position_rng(sampling.seed, position + k)
        emitted.append(_draw(warp_probs(rows[k], sampling), rng))
    return emitted, k
