"""ServingEngine: paged-KV continuous-batching inference (the port of
``paddle_tpu/serving/engine.py``).

Usage::

    model = DecoderLM(vocab_size=512, num_layers=2, num_heads=2,
                      head_dim=16, device="cuda")
    decoder_lm_from_numpy(params, model)       # paddle_tpu_torch.convert
    eng = ServingEngine(model, eos_id=1, device="cuda")
    rid = eng.submit([7, 12, 3], max_tokens=32)
    results = eng.run()          # {rid: [generated tokens...]}
    eng.status(rid)              # RequestStatus.COMPLETED
    eng.metrics.snapshot()       # tokens/s, TTFT, SLO counters, ...

Every tick runs ONE unified step: the decode tokens of the running slots
and every selected prefill chunk are embedded together, their K/V are
scattered into the paged pool (quantized on write for int8 pools), and
one ragged paged attention per layer covers the whole mixed batch.  On
CUDA that attention is the hand-written kernel
``csrc/ragged_paged_attention.cu``; on the CPU its plain version.

Host logic is the JAX engine's: admission with prefix caching
(refcount-shared full pages, copy-on-write fork on a full-cover hit),
chunked prefill, youngest-first preemption, queue/total deadlines with
unmeetable-deadline shedding, ``cancel``, a finite-logits guard that
fails only the poisoned slot, a progress watchdog, and free-list
conservation after every drain.  Greedy choice runs on host numpy
(``np.argmax``), so ties break as in the JAX package.

Not ported yet (see ROADMAP.md): tensor parallelism, speculative
decoding, the fault plan and its step retry, the host-RAM tier, page
migration, tracing and the compiled-path auditors.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.ops.attention import mha_reference
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.serving.decode_attention import (
    BLOCK_ROWS, _ragged_reference_blocked, attention_path,
    expand_decode_rows, ragged_paged_attention)
from paddle_tpu_torch.serving.faults import PageLeakError
from paddle_tpu_torch.serving.kv_cache import (NULL_PAGE, KVPages,
                                               PagedKVConfig, PagePool,
                                               PrefixCache, append_token,
                                               fork_page, init_kv_pages,
                                               resolve_kv_dtype, zero_pages)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                Request, RequestStatus,
                                                SchedulerConfig, bucket_for,
                                                pack_prefill_chunks)
from paddle_tpu_torch.serving.speculate import SamplingParams, next_token

__all__ = ["DecoderLM", "ServingEngine", "greedy_decode_reference",
           "reference_logits"]


def _rms(x, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


class _Block(nn.Module):
    """One decoder layer's projections, in the JAX package's x @ W
    layout (``[in, out]``)."""

    def __init__(self, e: int, kv: int, f: int, device, dtype):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device,
                                            dtype=dtype),
                                requires_grad=False)

        self.wq, self.wk, self.wv = p(e, e), p(e, kv), p(e, kv)
        self.wo, self.w1, self.w2 = p(e, e), p(e, f), p(f, e)


class DecoderLM(nn.Module):
    """A compact pre-norm decoder-only transformer LM: token + position
    embeddings, per layer parameter-free RMSNorm -> Q/K/V (GQA when
    ``num_kv_heads < num_heads``) -> attention -> output projection ->
    residual -> RMSNorm -> FFN with tanh-approximate GELU -> residual,
    then RMSNorm -> vocab projection.

    Parameters are allocated zeroed on ``device`` (default ``cuda``);
    load weights with :func:`paddle_tpu_torch.convert.decoder_lm_from_numpy`.
    The methods mirror the JAX model's ``DecodeModel`` contract with the
    parameters held by the module: ``embed``, ``qkv``, ``attn_out``,
    ``logits``, each shape-polymorphic over leading dims."""

    def __init__(self, vocab_size: int, num_layers: int = 2,
                 num_heads: int = 2, head_dim: int = 16,
                 ffn_mult: int = 4, max_positions: int = 1024,
                 num_kv_heads: Optional[int] = None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = int(num_kv_heads or num_heads)
        enforce_that(num_heads % self.num_kv_heads == 0,
                     f"num_kv_heads ({self.num_kv_heads}) must divide "
                     f"num_heads ({num_heads})", context="serving")
        self.head_dim = head_dim
        self.embed_dim = num_heads * head_dim
        self.kv_dim = self.num_kv_heads * head_dim
        self.ffn_dim = ffn_mult * self.embed_dim
        self.max_positions = max_positions
        dev = resolve_device(device)
        e, v = self.embed_dim, vocab_size
        self.emb = nn.Parameter(torch.zeros(v, e, device=dev, dtype=dtype),
                                requires_grad=False)
        self.pos = nn.Parameter(torch.zeros(max_positions, e, device=dev,
                                            dtype=dtype),
                                requires_grad=False)
        self.layers = nn.ModuleList(
            _Block(e, self.kv_dim, self.ffn_dim, dev, dtype)
            for _ in range(num_layers))
        self.out = nn.Parameter(torch.zeros(e, v, device=dev, dtype=dtype),
                                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def embed(self, tokens, positions):
        return self.emb[tokens] + self.pos[positions]

    def qkv(self, layer: int, x):
        blk = self.layers[layer]
        h, kvh, d = self.num_heads, self.num_kv_heads, self.head_dim
        xn = _rms(x)
        q = (xn @ blk.wq).reshape(x.shape[:-1] + (h, d))
        k = (xn @ blk.wk).reshape(x.shape[:-1] + (kvh, d))
        v = (xn @ blk.wv).reshape(x.shape[:-1] + (kvh, d))
        return q, k, v

    def attn_out(self, layer: int, ctx, x):
        blk = self.layers[layer]
        flat = ctx.reshape(x.shape[:-1] + (self.embed_dim,))
        a = x + flat @ blk.wo
        up = _rms(a) @ blk.w1
        # jax.nn.gelu's default is the tanh approximation
        return a + F.gelu(up, approximate="tanh") @ blk.w2

    def logits(self, x):
        return _rms(x) @ self.out


@torch.inference_mode()
def reference_logits(model: DecoderLM, tokens: Sequence[int]) -> np.ndarray:
    """Last-position logits of the full causal forward over ``tokens``
    (``mha_reference``, no KV cache) as a host array."""
    dev = model.device
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)[None]
    pos = torch.arange(t.shape[1], device=dev)[None]
    x = model.embed(t, pos)
    for l in range(model.num_layers):
        q, k, v = model.qkv(l, x)
        ctx = mha_reference(q, k, v, causal=True)
        x = model.attn_out(l, ctx, x)
    return model.logits(x[0, -1]).float().cpu().numpy()


def greedy_decode_reference(model: DecoderLM, prompt: List[int],
                            max_tokens: int, eos_id: int) -> List[int]:
    """The NON-paged oracle: re-run the full causal forward over the whole
    history each step and extend greedily — slow by construction, it is
    the parity target for the engine's paged path."""
    tokens = list(prompt)
    out: List[int] = []
    for _ in range(max_tokens):
        nxt = int(np.argmax(reference_logits(model, tokens)))
        out.append(nxt)
        tokens.append(nxt)
        if nxt == eos_id:
            break
    return out


# terminal requests kept for status()/result() before the oldest go
_MAX_RETAINED = 10000


def _parse_buckets(spec: str) -> Tuple[int, ...]:
    return tuple(sorted(int(t) for t in spec.split(",") if t.strip()))


class ServingEngine:
    """Paged-KV continuous-batching inference engine (see module doc).

    ``device`` (default ``cuda``) must be the model's device.
    ``use_kernel`` picks the row packing through ``attention_path``: on
    CUDA the kernel's packing always (``False`` raises); on the CPU the
    compact packing unless ``use_kernel=True``, which runs the kernel's
    packing with the plain attention standing in for the kernel."""

    def __init__(self, model: DecoderLM, *, eos_id: int,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 kv_dtype=None,
                 use_kernel: Optional[bool] = None,
                 watchdog_ticks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        enforce_that(model.device.type == self.device.type,
                     f"model is on {model.device}, engine on {self.device}",
                     context="serving")
        self.eos_id = int(eos_id)
        self.model = model
        page_size = int(page_size or FLAGS.serving_page_size)
        max_slots = int(max_slots or FLAGS.serving_max_slots)
        kv_dtype = resolve_kv_dtype(kv_dtype if kv_dtype is not None
                                    else FLAGS.serving_kv_dtype)
        num_kv_heads = int(model.num_kv_heads)
        num_pages = int(num_pages or FLAGS.serving_max_pages)
        if max_pages_per_seq is None:
            # default: one sequence may claim up to half the usable pool
            max_pages_per_seq = max(1, (num_pages - 1) // 2)
        preempt_budget = int(FLAGS.serving_preempt_budget)
        if watchdog_ticks is None:
            watchdog_ticks = int(FLAGS.serving_watchdog_ticks)
        # 0 = disabled, for both
        self.queue_deadline_s = float(FLAGS.serving_queue_deadline_s) or None
        self.watchdog_ticks = int(watchdog_ticks)
        self._time = time_fn or time.monotonic
        self.kv_cfg = PagedKVConfig(
            num_layers=model.num_layers, num_heads=model.num_heads,
            head_dim=model.head_dim, page_size=page_size,
            num_pages=num_pages, max_pages_per_seq=int(max_pages_per_seq),
            dtype=kv_dtype, num_kv_heads=num_kv_heads)
        self._kv: KVPages = init_kv_pages(self.kv_cfg, device=self.device)
        self.pool = PagePool(num_pages)
        if prefill_chunk is None:
            prefill_chunk = int(FLAGS.serving_prefill_chunk)
        self._prefill_chunk = max(0, int(prefill_chunk))
        self.cache: Optional[PrefixCache] = None
        if FLAGS.serving_prefix_cache:
            self.cache = PrefixCache(self.pool, page_size)
        self.scheduler = ContinuousBatchingScheduler(
            self.pool, SchedulerConfig(
                max_slots=max_slots, page_size=page_size,
                max_pages_per_seq=int(max_pages_per_seq),
                preempt_budget=preempt_budget if preempt_budget > 0
                else None),
            cache=self.cache, time_fn=self._time)
        self.metrics = ServingMetrics(pool_pages=self.pool.num_usable)
        # row packing, decided ONCE through the single chooser
        self._ragged_kernel = attention_path(
            model.head_dim, page_size, num_heads=model.num_heads,
            num_kv_heads=num_kv_heads, device=self.device,
            use_kernel=use_kernel) == "kernel"
        self._buckets = tuple(sorted(int(b) for b in buckets)) if buckets \
            else _parse_buckets(FLAGS.serving_prefill_buckets)
        self._max_slots = max_slots
        # prefill-row packing: the kernel needs each sequence's rows
        # padded to whole BLOCK_ROWS blocks
        self._row_align = BLOCK_ROWS if self._ragged_kernel else 1
        top = max(self._buckets) if self._buckets else \
            self.kv_cfg.max_seq_len
        chunk_rows = self._prefill_chunk if self._prefill_chunk > 0 \
            else self.kv_cfg.max_seq_len
        chunk_rows = -(-chunk_rows // self._row_align) * self._row_align
        self._prefill_budget = max(top, chunk_rows)
        self._results: Dict[int, List[int]] = {}
        self._requests: Dict[int, Request] = {}
        # terminal rids in retirement order; oldest evicted past
        # _MAX_RETAINED so a long-running engine's memory stays bounded
        self._retired: Deque[int] = deque()
        self._tick = 0
        self._last_tick_at: Optional[float] = None
        self._prev_tick_busy = False
        self._tick_dur_ema = 0.0      # drives the unmeetable-deadline shed

    # ---- the unified device step -----------------------------------------

    def _attend(self, layer: int, q, table, att_lens, row_seq, qpos):
        """One ragged paged attention over the tick's mixed row stack.
        The compact packing feeds ``[B + pb]`` rows as-is; the kernel
        packing expands each slot's decode row to a whole BLOCK_ROWS
        block (prefill rows are already block-aligned by the packer) and
        slices the context back out."""
        kv = self._kv
        ks = kv.k_scale[layer] if kv.quantized else None
        vs = kv.v_scale[layer] if kv.quantized else None
        if not self._ragged_kernel:
            return _ragged_reference_blocked(
                q, kv.k[layer], kv.v[layer], table, att_lens, row_seq,
                qpos, k_scale=ks, v_scale=vs)
        b = self._max_slots
        h, d = q.shape[1], q.shape[2]
        qd, rsd, qpd = expand_decode_rows(q[:b], qpos[:b])
        ctx = ragged_paged_attention(
            torch.cat([qd, q[b:]]), kv.k[layer], kv.v[layer], table,
            att_lens, torch.cat([rsd, row_seq[b:]]),
            torch.cat([qpd, qpos[b:]]), k_scale=ks, v_scale=vs)
        cd = ctx[:b * BLOCK_ROWS].reshape(b, BLOCK_ROWS, h, d)[:, 0]
        return torch.cat([cd, ctx[b * BLOCK_ROWS:]])

    @torch.inference_mode()
    def _step(self, d_tokens, d_pos, d_valid, p_tokens, p_qpos, p_seq,
              p_last, table, att_lens) -> Tuple[np.ndarray, np.ndarray]:
        """The unified per-tick step.  d_*: [B] — slot ``s``'s decode
        token, its position, and whether the slot decodes; p_*: [pb] —
        packed prefill rows (qpos -1 = padding; padding keeps the owning
        slot so kernel blocks stay sequence-uniform); p_last: [B] — row
        of each slot's chunk-final row in the packed stack; table:
        [B, Pm]; att_lens: [B] — valid KV per slot AFTER this step's
        writes.  Masked rows write ZEROS to the null page.  Returns host
        logits for the B decode rows and each slot's chunk-final row."""
        model, page, b = self.model, self.kv_cfg.page_size, self._max_slots
        d_seq = np.arange(b)
        p_act = p_qpos >= 0
        pq = np.maximum(p_qpos, 0)
        pages = np.concatenate([
            np.where(d_valid, table[d_seq, d_pos // page], NULL_PAGE),
            np.where(p_act, table[p_seq, pq // page], NULL_PAGE)])
        host = [np.concatenate([d_tokens, p_tokens]),          # tokens
                np.concatenate([d_pos, pq]),                   # positions
                pages,
                np.concatenate([d_pos % page, pq % page]),     # offsets
                np.concatenate([d_valid, p_act]),              # write mask
                np.concatenate([d_seq, p_seq]),                # row_seq
                np.concatenate([np.where(d_valid, d_pos, -1), p_qpos]),
                np.concatenate([d_seq, p_last]),               # logit rows
                att_lens, table.reshape(-1)]
        # ONE host->device copy for the step's index arrays
        packed = torch.from_numpy(
            np.concatenate(host).astype(np.int32)).to(self.device)
        (tokens, pos, pages, offs, wmask, row_seq, qpos, sel, att_lens,
         table) = torch.split(packed, [len(a) for a in host])
        table = table.reshape(b, -1)
        wmask = (wmask != 0)[:, None, None]
        x = model.embed(tokens, pos)
        for l in range(model.num_layers):
            q, k, v = model.qkv(l, x)
            append_token(self._kv, l, torch.where(wmask, k, 0.0),
                         torch.where(wmask, v, 0.0), pages, offs)
            ctx = self._attend(l, q, table, att_lens, row_seq, qpos)
            x = model.attn_out(l, ctx, x)
        # the step's one sync; bf16 logits widen exactly to f32
        logits = model.logits(x[sel]).float().cpu().numpy()
        return logits[:b], logits[b:]

    # ---- user surface ----------------------------------------------------

    def submit(self, prompt: Sequence[int], max_tokens: int,
               on_token: Optional[Callable[[int], None]] = None,
               now: Optional[float] = None,
               queue_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               sampling: Optional[SamplingParams] = None) -> int:
        """Queue a request and return its rid — always, even when it is
        refused (status ``REJECTED``).  ``queue_deadline_s`` bounds the
        wait for admission, ``deadline_s`` submit-to-last-token; either
        lapsing marks it ``TIMED_OUT``.  ``sampling`` None (or
        temperature 0) is greedy argmax."""
        req = Request(prompt=list(int(t) for t in prompt),
                      max_tokens=int(max_tokens), on_token=on_token,
                      sampling=sampling)
        t = self._time() if now is None else now
        if queue_deadline_s is None:
            queue_deadline_s = self.queue_deadline_s
        if queue_deadline_s is not None:
            req.queue_deadline_at = t + float(queue_deadline_s)
        if deadline_s is not None:
            req.deadline_at = t + float(deadline_s)
        ok = self.scheduler.submit(req, now=t)
        self.metrics.on_submit(t, ok)
        self._requests[req.rid] = req
        if not ok:
            self._retire(req)
        return req.rid

    def _finish(self, req: Request, status: RequestStatus, now: float,
                shed: bool = False) -> None:
        """THE terminal-transition path: return the slot and pages — or
        leave the queue — stamp, count, retire."""
        if status is RequestStatus.FAILED and req.pages:
            # a FAILED request may have written non-finite K/V: scrub its
            # UNCACHED pages so re-granted ones can't leak inf into the
            # next owner's masked reads (cached pages were finite-vouched
            # at insertion and may be shared right now)
            suspect = [p for p in req.pages if not self.pool.is_cached(p)]
            if suspect:
                zero_pages(self._kv, suspect)
        if req.slot is not None:
            self.scheduler.release(req, status)
        else:
            self.scheduler.drop_queued(req, status)
        req.finished_at = now
        hook = self.metrics.on_shed if shed else {
            RequestStatus.COMPLETED: self.metrics.on_complete,
            RequestStatus.TIMED_OUT: self.metrics.on_timeout,
            RequestStatus.CANCELLED: self.metrics.on_cancel,
            RequestStatus.FAILED: self.metrics.on_fail,
        }[status]
        hook()
        self._retire(req)

    def _retire(self, req: Request) -> None:
        self._retired.append(req.rid)
        while len(self._retired) > _MAX_RETAINED:
            old = self._retired.popleft()
            self._requests.pop(old, None)
            self._results.pop(old, None)

    def cancel(self, rid: int, now: Optional[float] = None) -> bool:
        """Cancel a request (queued: leaves the queue; running: releases
        its slot and pages now).  False if already terminal; KeyError for
        an unknown rid."""
        req = self._requests[rid]
        if req.finished:
            return False
        now = self._time() if now is None else now
        self._finish(req, RequestStatus.CANCELLED, now)
        return True

    def status(self, rid: int) -> RequestStatus:
        return self._requests[rid].status

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def step(self, now: Optional[float] = None) -> bool:
        """One engine tick: shed expired/unmeetable work, grow/preempt,
        admit, then one unified step over every running slot and the
        selected prefill chunks; then the watchdog.  Returns True if any
        work remains."""
        tick, sched, m = self._tick, self.scheduler, self.metrics
        now = self._time() if now is None else now
        # the shed estimator learns tick duration only from ticks that
        # followed a BUSY tick (idle polling gaps would inflate it)
        if (self._last_tick_at is not None and now > self._last_tick_at
                and self._prev_tick_busy):
            dur = now - self._last_tick_at
            self._tick_dur_ema = dur if self._tick_dur_ema == 0.0 else \
                0.5 * self._tick_dur_ema + 0.5 * dur
        self._last_tick_at = now
        self._enforce_deadlines(now)
        # growth/preemption BEFORE admission: a tick must not pay for a
        # new request's prefill and then preempt it to grow older ones
        m.on_preempt(len(sched.ensure_decode_pages()))
        admitted = sched.admit()
        for req in admitted:
            if req.admitted_at is None:
                wait = now - (req.submitted_at
                              if req.submitted_at is not None else now)
                m.on_admit(wait)
                req.admitted_at = now
            req.last_progress_tick = tick
            self._begin_prefill(req)
        # oldest-progress-first, so a chunk crowded out by the row
        # budget is first in line next tick
        prefilling = sorted(
            (r for r in sched.running_requests()
             if r.status is RequestStatus.RUNNING and r.prefilling),
            key=lambda r: (r.last_progress_tick, r.slot))
        chunks, total_rows = pack_prefill_chunks(
            prefilling, self._prefill_chunk, self._row_align,
            self._prefill_budget)
        running = [r for r in sched.running_requests()
                   if r.status is RequestStatus.RUNNING
                   and not r.prefilling and r.generated]
        if running or chunks:
            self._do_step(running, chunks, total_rows)
        self._prev_tick_busy = (bool(running) or bool(admitted) or
                                bool(prefilling))
        self._watchdog_sweep(tick)
        m.on_tick(sched.queue_depth, self.pool.num_live,
                  self.pool.num_cached,
                  self.cache.evictions if self.cache is not None else 0)
        self._tick = tick + 1
        return self.has_work

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Tick until drained (or ``max_ticks``); returns {rid: generated
        tokens} for everything completed so far.  A full drain asserts
        free-list conservation (:class:`PageLeakError`)."""
        ticks = 0
        while self.has_work:
            self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        if not self.has_work:
            self.check_page_conservation()
        return dict(self._results)

    def result(self, rid: int) -> Optional[List[int]]:
        """Generated tokens of a COMPLETED rid; None while in flight or
        after a non-completed terminal status; KeyError if unknown."""
        if rid not in self._requests:
            raise KeyError(rid)
        return self._results.get(rid)

    # ---- invariants / health --------------------------------------------

    def check_page_conservation(self) -> None:
        """``PAGE-LEAK``: every usable page is free or tracked in use.
        ``REF-LEAK``: the pool's total refcount equals the references
        actually held — one per page-table entry of every running or
        queued request, plus an admission-time COW pin."""
        pool = self.pool
        if pool.num_free + pool.num_in_use != pool.num_usable:
            raise PageLeakError(
                f"PAGE-LEAK: free={pool.num_free} in_use={pool.num_in_use} "
                f"usable={pool.num_usable}")
        live = (list(self.scheduler.running.values()) +
                list(self.scheduler.queue))
        held = sum(len(r.pages) for r in live)
        held += sum(1 for r in live if r.cow_src is not None)
        if held != pool.total_refs:
            raise PageLeakError(
                f"REF-LEAK: held={held} refs={pool.total_refs} "
                f"cached={pool.num_cached} free={pool.num_free} "
                f"usable={pool.num_usable}")

    def healthz(self) -> Dict[str, object]:
        """Liveness snapshot: pool state, conservation, metrics."""
        m = self.metrics
        counts: Dict[str, int] = {}
        for key, val in (("completed", m.completed),
                         ("timed_out", m.timed_out),
                         ("cancelled", m.cancelled),
                         ("failed", m.failed),
                         ("rejected", m.rejected + m.shed)):
            if val:
                counts[key] = val
        for req in (list(self.scheduler.queue) +
                    list(self.scheduler.running.values())):
            counts[req.status.value] = counts.get(req.status.value, 0) + 1
        try:
            self.check_page_conservation()
            leak = False
        except PageLeakError:
            leak = True
        return {
            "ok": not leak,
            "metrics": m.snapshot(),
            "tick": self._tick,
            "queue_depth": self.scheduler.queue_depth,
            "running": len(self.scheduler.running),
            "free_pages": self.pool.num_free,
            "pages_in_use": self.pool.num_live,
            "pages_cached": self.pool.num_cached,
            "pages_reclaimable": self.pool.num_reclaimable,
            "pages_total": self.pool.num_usable,
            "kv_dtype": str(self.kv_cfg.dtype).replace("torch.", ""),
            "kv_bytes": self.kv_cfg.kv_bytes(),
            "cache_hits": self.cache.hits if self.cache is not None else 0,
            "cache_misses": (self.cache.misses
                             if self.cache is not None else 0),
            "page_leak": leak,
            "status_counts": counts,
            "deadline_miss_rate": round(m.deadline_miss_rate(), 4),
        }

    # ---- internals -------------------------------------------------------

    def _enforce_deadlines(self, now: float) -> None:
        sched = self.scheduler
        for req in list(sched.running.values()):
            if req.deadline_at is not None and now >= req.deadline_at:
                self._finish(req, RequestStatus.TIMED_OUT, now)
        for req in sched.queued_requests():
            # the queue deadline is an ADMISSION SLO: a preempted request
            # back in the queue is judged only by its total deadline
            expired = (req.deadline_at is not None and
                       now >= req.deadline_at) or \
                      (req.admitted_at is None and
                       req.queue_deadline_at is not None and
                       now >= req.queue_deadline_at)
            if expired:
                self._finish(req, RequestStatus.TIMED_OUT, now)
                continue
            # shed on the worst-case length: at one token per tick, a
            # request running to max_tokens cannot meet its deadline
            if (req.deadline_at is not None and self._tick_dur_ema > 0.0
                    and now + req.tokens_remaining * self._tick_dur_ema
                    > req.deadline_at):
                self._finish(req, RequestStatus.REJECTED, now, shed=True)

    def _watchdog_sweep(self, tick: int) -> None:
        if self.watchdog_ticks <= 0:
            return
        for req in list(self.scheduler.running.values()):
            if tick - req.last_progress_tick >= self.watchdog_ticks:
                self._finish(req, RequestStatus.FAILED, self._time())

    def _begin_prefill(self, req: Request) -> None:
        """Stitch-time work for a newly (re-)admitted request: record the
        prefix-cache outcome, run the COW fork, arm the chunked prefill."""
        req.prefilling = True
        req.chain_hash, req.chain_blocks = None, 0   # fresh insert cursor
        self.metrics.on_prefix(len(req.cache_tokens), req.cached_len)
        if req.cow_src is not None:
            # full-cover hit: the tail's one token rewrites a position
            # INSIDE the last shared page — fork it into the request's
            # first private page before anything is written
            dst = req.pages[req.cache_len // self.kv_cfg.page_size]
            fork_page(self._kv, req.cow_src, dst)
            # the fork consumed the source: drop the admission-time pin
            self.pool.free([req.cow_src])
            req.cow_src = None
            self.metrics.on_cow()

    def _do_step(self, running: List[Request], chunks,
                 total_rows: int) -> None:
        """Assemble and run ONE unified step, then walk its results:
        chunk bookkeeping first (cache inserts, finite guard, final-chunk
        first token), decode emissions second."""
        b, cfg = self._max_slots, self.kv_cfg
        d_tokens = np.zeros((b,), np.int32)
        d_pos = np.zeros((b,), np.int32)
        d_valid = np.zeros((b,), bool)
        att_lens = np.zeros((b,), np.int32)
        table = np.full((b, cfg.max_pages_per_seq), NULL_PAGE, np.int32)
        for req in running:
            s = req.slot
            d_tokens[s] = req.generated[-1]
            d_pos[s] = req.cache_len
            d_valid[s] = True
            att_lens[s] = req.cache_len + 1
            table[s, :len(req.pages)] = req.pages
        pb = 0
        if chunks:
            pb = bucket_for(total_rows, self._buckets,
                            max(cfg.max_seq_len, total_rows))
            if self._ragged_kernel:  # whole blocks only (kernel packing)
                pb = -(-pb // BLOCK_ROWS) * BLOCK_ROWS
        p_tokens = np.zeros((pb,), np.int32)
        p_qpos = np.full((pb,), -1, np.int32)
        p_seq = np.zeros((pb,), np.int32)
        p_last = np.zeros((b,), np.int32)
        off = 0
        for req, start, n, rows in chunks:
            s = req.slot
            p_tokens[off:off + n] = req.cache_tokens[start:start + n]
            p_qpos[off:off + n] = np.arange(start, start + n)
            # padding rows keep the owning slot so each kernel block
            # stays sequence-uniform (their qpos -1 masks them out)
            p_seq[off:off + rows] = s
            # absolute row in the step's stack (behind the B decode rows)
            p_last[s] = b + off + n - 1
            att_lens[s] = start + n
            table[s, :len(req.pages)] = req.pages
            off += rows
        d_logits, p_logits = self._step(d_tokens, d_pos, d_valid, p_tokens,
                                        p_qpos, p_seq, p_last, table,
                                        att_lens)
        self.metrics.on_step(len(running), total_rows,
                             pb - sum(c[2] for c in chunks),
                             n_slots=len(running))
        # stamp AFTER the sync so TTFT includes the step compute
        now = self._time()
        for req, start, n, _rows in chunks:
            if req.status is not RequestStatus.RUNNING:
                continue    # cancelled from an earlier chunk's on_token
            self._finish_chunk(req, start, n, p_logits[req.slot], now)
        for req in running:
            if req.status is not RequestStatus.RUNNING:
                continue    # cancelled from another slot's on_token
            row = d_logits[req.slot]
            if not np.isfinite(row).all():
                # poisoned slot: fail ONLY this request — its uncached
                # pages are scrubbed by _finish, the batch keeps going
                self._finish(req, RequestStatus.FAILED, now)
                continue
            req.cache_len += 1
            self._emit(req, next_token(row, req.sampling,
                                       len(req.generated)), now)

    def _finish_chunk(self, req: Request, start: int, n: int, logits,
                      now: float) -> None:
        """Post-step bookkeeping for one prefill chunk: advance the
        materialized length, guard, index the newly completed full pages,
        and on the final chunk emit the first token."""
        toks = req.cache_tokens
        req.cache_len = start + n
        self.scheduler.note_prefill_progress(req, start)
        self.metrics.on_prefill(n)
        req.last_progress_tick = self._tick   # chunks are progress too
        if not np.isfinite(logits).all():
            if self.cache is not None:
                # forget ONLY the pages the failing chunk wrote: earlier
                # chunks passed their own guard and may be shared now
                self.cache.forget(
                    req.pages[start // self.kv_cfg.page_size:])
            req.prefilling = False
            self._finish(req, RequestStatus.FAILED, now)
            return
        if self.cache is not None:
            # newly completed FULL pages — now finite-vouched — become
            # hittable immediately; the chain cursor keeps it O(chunk)
            req.chain_hash, req.chain_blocks = self.cache.insert(
                toks, req.pages, req.cache_len,
                from_block=req.chain_blocks, prev_hash=req.chain_hash)
        if req.cache_len < len(toks):
            return                            # more chunks, later ticks
        req.prefilling = False
        self._emit(req, next_token(logits, req.sampling,
                                   len(req.generated)), now)

    def _emit(self, req: Request, tok: int, now: float) -> None:
        req.generated.append(tok)
        req.last_progress_tick = self._tick
        ttft = None
        if req.first_token_at is None:
            req.first_token_at = now
            ttft = max(0.0, now - (req.submitted_at
                                   if req.submitted_at is not None else now))
        self.metrics.on_token(now, ttft)
        if req.on_token is not None:
            req.on_token(tok)
            if req.finished:
                return   # the callback cancelled this request: keep it
        if tok == self.eos_id or len(req.generated) >= req.max_tokens:
            self._results[req.rid] = list(req.generated)
            self._finish(req, RequestStatus.COMPLETED, now)
