"""Speculative decoding and token choice for the serving engine (the
port of ``paddle_tpu/serving/speculate.py``).

A cheap *proposer* drafts up to ``k`` tokens per running slot, the
target model scores all ``k+1`` positions in ONE widened unified step
(each speculating slot ships ``k+1`` verify rows, which the ragged
kernel takes as one block of rows at consecutive positions), and the
engine accepts the longest agreeing prefix plus one bonus token,
rolling the rejected suffix back.  Every tick still emits at least one
token.

Two proposers:

- :class:`NGramProposer` — prompt lookup: match the last ``n`` tokens of
  the slot's own history against earlier occurrences and propose what
  followed.  No model cost.
- :class:`DraftProposer` — a small draft ``DecoderLM`` with its OWN
  paged pool (the engine's ``KVPages``/``PagePool`` machinery,
  conservation-checked the same way); each of its steps runs the ragged
  paged attention (the CUDA kernel on the card).

Token choice runs on the host over numpy logits, so ties break exactly
as in the JAX package (``np.argmax`` takes the first maximum) and a
sampled draw is a pure function of (request seed, token position,
stream).  Greedy acceptance is exact match, so greedy output is
token-identical to decoding without speculation; sampled acceptance is
rejection sampling against the warped target distribution.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.platform.flags import FLAGS

__all__ = ["DraftProposer", "NGramProposer", "Proposer", "SamplingParams",
           "accept_tokens", "next_token", "position_rng", "warp_probs"]

# RNG stream ids: one MT19937 stream per (seed, token position, role)
_STREAM_ACCEPT = 0      # accept/residual/bonus draws (the emission side)
_STREAM_DRAFT = 1       # the draft model's own proposal draws


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
                # draft_probs is the host array of one readback a step
                q = np.asarray(draft_probs[i], np.float64)  # lint: allow(host-sync)
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


# ---------------------------------------------------------------------------
# Proposers
# ---------------------------------------------------------------------------


class Proposer:
    """Structural proposer contract the engine drives.  ``propose``
    returns ``{rid: (drafts, warped proposal probs or None)}`` for the
    eligible requests; ``commit``/``release``/``check_conservation``
    are state hooks only the draft-model proposer needs."""

    def propose(self, requests, k_for
                ) -> Dict[int, Tuple[List[int], Optional[np.ndarray]]]:
        raise NotImplementedError

    def commit(self, req) -> None:      # accepted history is now truth
        pass

    def release(self, rid: int) -> None:
        pass

    def check_conservation(self) -> None:
        pass


class NGramProposer(Proposer):
    """Prompt-lookup speculation: match the last ``n`` tokens of the
    slot's own prompt+output history against earlier occurrences (the
    most recent match with a full ``k``-token continuation wins; falls
    back to shorter suffixes down to 1) and propose what followed."""

    def __init__(self, n: Optional[int] = None):
        self.n = int(n if n is not None else FLAGS.serving_spec_ngram)
        enforce_that(self.n >= 1, "n-gram size must be >= 1",
                     context="serving-spec")

    def propose_one(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        ln = len(h)
        if k <= 0 or ln < 2:
            return []
        for size in range(min(self.n, ln - 1), 0, -1):
            tail = h[ln - size:]
            # the most recent earlier occurrence WITH a full k-token
            # continuation wins; matches cut short by the history's end
            # win only if nothing fuller exists
            best = None
            for end in range(ln - 1, size - 1, -1):
                if h[end - size:end] == tail:
                    cont = min(k, ln - end)
                    if best is None or cont > best[1]:
                        best = (end, cont)
                    if cont >= k:
                        break
            if best is not None:
                end, cont = best
                return h[end:end + cont]
        return []

    def propose(self, requests, k_for):
        out = {}
        for req in requests:
            drafts = self.propose_one(req.cache_tokens, k_for(req))
            if drafts:
                out[req.rid] = (drafts, None)
        return out


@dataclass
class _DraftSeq:
    """Per-request draft-model cache state: ``tokens`` is the history
    whose K/V is materialized in ``pages`` (positions 0..len-1)."""

    tokens: List[int]
    pages: List[int]


class DraftProposer(Proposer):
    """Draft-model speculation: a small ``DecoderLM`` over its OWN paged
    pool.

    Per tick the engine hands it the running slots; for each it (1)
    teacher-forces any history its cache has not materialized — batched
    across slots, in a small ladder of row buckets — and (2) drafts
    ``k`` tokens autoregressively (greedy argmax, or seeded draws from
    its warped distribution when the request samples, returning the
    warped proposal rows for rejection sampling).  After the verify,
    :meth:`commit` rolls the state back to the accepted history and
    frees lookahead pages past it, so the draft pool obeys the same
    conservation arithmetic as the main pool
    (:meth:`check_conservation`).

    Each draft step is one forward of the draft model over ``[B, R]``
    slot-major rows: K/V written with ``append_token``, attention through
    ``ragged_paged_attention`` (on the card the CUDA kernel, each slot's
    ``R`` rows padded to whole kernel blocks)."""

    # catch-up row buckets per slot (rows beyond the top take more
    # steps); drafting itself always uses the 1-row shape
    CATCHUP_BUCKETS = (1, 8, 32, 128)

    def __init__(self, model, *, page_size: int, num_pages: int,
                 max_pages_per_seq: int, max_slots: int,
                 use_kernel: Optional[bool] = None):
        from paddle_tpu_torch.serving.decode_attention import attention_path
        from paddle_tpu_torch.serving.kv_cache import (PagedKVConfig,
                                                       PagePool,
                                                       init_kv_pages)

        self.model = model
        self.device = model.device
        self.cfg = PagedKVConfig(
            num_layers=model.num_layers, num_heads=model.num_heads,
            head_dim=model.head_dim, page_size=int(page_size),
            num_pages=int(num_pages),
            max_pages_per_seq=int(max_pages_per_seq),
            num_kv_heads=int(model.num_kv_heads))
        self._kv = init_kv_pages(self.cfg, device=self.device)
        self.pool = PagePool(int(num_pages))
        self.max_slots = int(max_slots)
        self._kernel_packing = attention_path(
            model.head_dim, int(page_size), num_heads=model.num_heads,
            num_kv_heads=int(model.num_kv_heads), device=self.device,
            use_kernel=use_kernel) == "kernel"
        self._state: Dict[int, _DraftSeq] = {}
        self._fns: Dict[int, object] = {}
        self.steps = 0               # draft-model dispatches
        self.step_time_s = 0.0       # wall time inside them (host read)

    # ---- the draft step --------------------------------------------------

    def _fn(self, rows: int):
        """The draft step for ``rows`` rows per slot (one per bucket)."""
        fn = self._fns.get(rows)
        if fn is not None:
            return fn
        from paddle_tpu_torch.serving.decode_attention import (
            _ragged_reference_blocked, expand_decode_rows,
            ragged_paged_attention)
        from paddle_tpu_torch.serving.kv_cache import NULL_PAGE, append_token

        model, cfg = self.model, self.cfg
        b, page, r = self.max_slots, cfg.page_size, int(rows)
        kernel = self._kernel_packing

        @torch.inference_mode()
        def raw(kv, tokens, pos, valid, table, att_lens):
            # tokens/pos/valid: [B * R] slot-major rows; att_lens: [B]
            # valid K/V per slot AFTER this step's writes.  Returns
            # logits for EVERY row ([B, R, V]) — catch-up reads each
            # slot's last valid row, drafting reads row 0.
            p = pos.clamp(min=0)
            seq = torch.arange(b, device=tokens.device).repeat_interleave(r)
            x = model.embed(tokens, p)
            pages = torch.where(valid, table[seq, p // page], NULL_PAGE)
            offs = p % page
            qpos = torch.where(valid, p, -1)
            wmask = valid[:, None, None]
            for l in range(cfg.num_layers):
                q, k, vv = model.qkv(l, x)
                append_token(kv, l, torch.where(wmask, k, 0.0),
                             torch.where(wmask, vv, 0.0), pages, offs)
                ks = kv.k_scale[l] if kv.quantized else None
                vs = kv.v_scale[l] if kv.quantized else None
                if kernel:
                    h, d = q.shape[1], q.shape[2]
                    qe, rs, qp = expand_decode_rows(q, qpos,
                                                    rows_per_seq=r)
                    ctx = ragged_paged_attention(
                        qe, kv.k[l], kv.v[l], table, att_lens, rs, qp,
                        k_scale=ks, v_scale=vs)
                    ctx = ctx.reshape(b, -1, h, d)[:, :r].reshape(
                        b * r, h, d)
                else:
                    ctx = _ragged_reference_blocked(
                        q, kv.k[l], kv.v[l], table, att_lens, seq, qpos,
                        k_scale=ks, v_scale=vs)
                x = model.attn_out(l, ctx, x)
            return model.logits(x).reshape(b, r, -1)

        self._fns[rows] = raw
        return raw

    def _dispatch(self, rows: int, tokens, pos, valid, table, att_lens):
        # honest wall time of the draft's step (its cost to the target),
        # which no injected clock models
        t0 = time.perf_counter()   # lint: allow(wall-clock)
        host = [tokens.reshape(-1), pos.reshape(-1),
                valid.reshape(-1).astype(np.int32), att_lens,
                table.reshape(-1)]
        # ONE host->device copy for the step's index arrays
        packed = torch.from_numpy(
            np.concatenate(host).astype(np.int32)).to(self.device)
        t, p, v, att, tab = torch.split(packed, [len(a) for a in host])
        logits = self._fn(rows)(self._kv, t.long(), p.long(), v != 0,
                                tab.reshape(self.max_slots, -1), att)
        out = logits.float().cpu().numpy()
        self.steps += 1
        self.step_time_s += time.perf_counter() - t0  # lint: allow(wall-clock)
        return out

    # ---- host-side state -------------------------------------------------

    def _ensure_pages(self, st: _DraftSeq, upto_len: int) -> bool:
        """Grow ``st.pages`` to cover ``upto_len`` tokens; False if the
        draft pool is dry or the table is full (the slot skips this tick
        — speculation, not correctness)."""
        page = self.cfg.page_size
        while len(st.pages) * page < upto_len:
            if len(st.pages) >= self.cfg.max_pages_per_seq:
                return False
            got = self.pool.alloc(1)
            if got is None:
                return False
            st.pages.extend(got)
        return True

    def _bucket(self, need: int) -> int:
        for bkt in self.CATCHUP_BUCKETS:
            if need <= bkt:
                return bkt
        return self.CATCHUP_BUCKETS[-1]

    def _arrays(self, rows: int):
        b = self.max_slots
        return (np.zeros((b, rows), np.int32), np.zeros((b, rows), np.int32),
                np.zeros((b, rows), bool),
                np.zeros((b, self.cfg.max_pages_per_seq), np.int32),
                np.zeros((b,), np.int32))

    def propose(self, requests, k_for):
        reqs = [r for r in requests if k_for(r) > 0]
        for req in reqs:
            if req.rid not in self._state:
                self._state[req.rid] = _DraftSeq(tokens=[], pages=[])
        # ---- phase 1: batched teacher-forced catch-up -------------------
        while True:
            needs = {}
            for req in reqs:
                st = self._state[req.rid]
                hist = req.cache_tokens
                # a diverged stored suffix (rejected drafts) is simply
                # re-forced: truncate to the common prefix first
                cp = _common_prefix(st.tokens, hist)
                del st.tokens[cp:]
                gap = len(hist) - len(st.tokens)
                if gap > 0:
                    needs[req.rid] = gap
            if not needs:
                break
            bkt = self._bucket(max(needs.values()))
            tokens, pos, valid, table, att = self._arrays(bkt)
            rows_of = {}
            for slot, req in enumerate(reqs):
                gap = needs.get(req.rid, 0)
                if gap <= 0:
                    continue
                st = self._state[req.rid]
                n = min(gap, bkt)
                start = len(st.tokens)
                if not self._ensure_pages(st, start + n):
                    needs.pop(req.rid, None)   # dry pool: skip this slot
                    continue
                hist = req.cache_tokens
                tokens[slot, :n] = hist[start:start + n]
                pos[slot, :n] = np.arange(start, start + n)
                valid[slot, :n] = True
                table[slot, :len(st.pages)] = st.pages
                att[slot] = start + n
                rows_of[slot] = (req, n)
            if not rows_of:
                break
            self._dispatch(bkt, tokens, pos, valid, table, att)
            for slot, (req, n) in rows_of.items():
                st = self._state[req.rid]
                hist = req.cache_tokens
                st.tokens.extend(hist[len(st.tokens):len(st.tokens) + n])
        # ---- phase 2: autoregressive drafting ---------------------------
        out: Dict[int, Tuple[List[int], Optional[np.ndarray]]] = {}
        live = [req for req in reqs
                if self._state[req.rid].tokens and
                self._state[req.rid].tokens == list(req.cache_tokens)]
        if not live:
            return out
        drafts = {req.rid: [] for req in live}
        probs: Dict[int, Optional[List[np.ndarray]]] = \
            {req.rid: [] for req in live}
        kmax = max(k_for(r) for r in live)
        for step in range(kmax):
            tokens, pos, valid, table, att = self._arrays(1)
            active = []
            for slot, req in enumerate(live):
                if len(drafts[req.rid]) < step:
                    continue            # this slot stopped drafting
                if step >= k_for(req):
                    continue
                st = self._state[req.rid]
                # the row feeds the LAST known token; its logits draft
                # the next
                feed = (st.tokens + drafts[req.rid])[-1]
                p = len(st.tokens) + len(drafts[req.rid]) - 1
                if not self._ensure_pages(st, p + 1):
                    continue
                tokens[slot, 0] = feed
                pos[slot, 0] = p
                valid[slot, 0] = True
                table[slot, :len(st.pages)] = st.pages
                att[slot] = p + 1
                active.append((slot, req))
            if not active:
                break
            logits = self._dispatch(1, tokens, pos, valid, table, att)
            for slot, req in active:
                row = logits[slot, 0]
                s = req.sampling
                base = len(req.generated)
                if s is None or s.greedy:
                    tok = int(np.argmax(row))
                    probs[req.rid] = None   # point mass: exact-match walk
                else:
                    wp = warp_probs(row, s)
                    rng = position_rng(s.seed, base + step, _STREAM_DRAFT)
                    tok = _draw(wp, rng)
                    probs[req.rid].append(wp)
                drafts[req.rid].append(tok)
        for req in live:
            dr = drafts[req.rid]
            if not dr:
                continue
            pr = probs[req.rid]
            out[req.rid] = (list(dr), np.stack(pr) if pr else None)
            # materialized are ONLY the drafts whose K/V was written:
            # step j FEEDS (and writes) token j-1, so the last draft was
            # produced but never fed
            self._state[req.rid].tokens.extend(dr[:-1])
        return out

    def commit(self, req) -> None:
        """Verify finished: roll the draft state back to the accepted
        history (a rejected suffix is re-forced next tick) and free
        lookahead pages past it."""
        st = self._state.get(req.rid)
        if st is None:
            return
        cp = _common_prefix(st.tokens, req.cache_tokens)
        del st.tokens[cp:]
        needed = -(-len(st.tokens) // self.cfg.page_size)
        if len(st.pages) > needed:
            extra = st.pages[needed:]
            del st.pages[needed:]
            self.pool.free(extra)

    def release(self, rid: int) -> None:
        st = self._state.pop(rid, None)
        if st is not None and st.pages:
            self.pool.free(st.pages)

    def check_conservation(self) -> None:
        """The draft pool's REF-LEAK twin: pages held by live draft
        states equal the pool's refcounts (no sharing, no cache)."""
        from paddle_tpu_torch.serving.faults import PageLeakError

        held = sum(len(st.pages) for st in self._state.values())
        if held != self.pool.total_refs:
            raise PageLeakError(
                f"REF-LEAK: draft pool held={held} "
                f"refs={self.pool.total_refs} free={self.pool.num_free} "
                f"usable={self.pool.num_usable}")
        if self.pool.num_free + self.pool.num_in_use != \
                self.pool.num_usable:
            raise PageLeakError(
                f"PAGE-LEAK: draft pool free={self.pool.num_free} "
                f"in_use={self.pool.num_in_use} "
                f"usable={self.pool.num_usable}")


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
