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

Speculative decoding (``spec_mode="ngram"|"draft"``): a proposer drafts
up to ``spec_k`` tokens per running slot, the SAME unified step verifies
all ``1 + spec_k`` positions of a slot (one kernel block of rows at
consecutive positions), the longest agreeing prefix is accepted and
rejected lookahead pages roll back; a verify that would write into a
shared page forks it first.  The host tier (``host_tier_bytes``):
evicted cached pages demote to pinned host memory, checksummed, and the
head-of-queue request's lookup swaps a verified continuation back in.
``tracer``/``registry`` put every lifecycle edge on one obs timeline and
the metrics on one scrape surface.

Robustness: every failure path is driven deterministically by a
:class:`~paddle_tpu_torch.serving.faults.FaultPlan` (``faults``: an
injected clock, decode-step errors absorbed by the step retry
(``decode_retries``, ``transient_errors``), NaN logits, page pressure,
prefix-hash collisions, cache storms, torn and flipped host spills).
The fleet reads ``role`` (prefill/decode/unified), ``drain()``,
``load()`` and ``tenant_counts()``, and moves live requests between
engines through ``migratable_rids()`` and ``apply_imported_pages()``
(``serving/migrate.py``).

Tensor-parallel serving (``ServingEngine(mesh=, tp_axis=)``): the model
is placed megatron-style over a ``model`` mesh axis of ``tp`` ranks — the
Q/K/V and FFN-up projections split by columns (whole query heads, KV
heads and FFN columns per rank), the attention-output and FFN-down
projections by rows, each followed by exactly one all-reduce over the
axis — with :meth:`DecoderLM.shard_plan` the one source of the placement.
The paged pool is split on its KV-head dim the same way (``[L, P, page,
H_kv / tp, D]`` per rank, int8 scales with their heads), so every pool
byte count is per rank, and each rank launches the ragged kernel on its
own head shard (:func:`ragged_paged_attention_tp`); no collective crosses
attention.  Every rank of the axis runs the same host scheduling: the
logits are the same on every rank after the last reduction, so every
rank picks the same token.  Prefix caching and its copy-on-write fork,
chunked prefill, int8 pools and the fault plans all run on the split
layout.  Every rank of the mesh builds the engine; a rank outside it
holds none (:meth:`FleetRouter.over_mesh_slices
<paddle_tpu_torch.serving.fleet.FleetRouter.over_mesh_slices>` keeps a
proxy of the replica there).

Not ported yet (see ROADMAP.md): the compiled-path auditors' budgets
(``xla_*``), which come with the jaxpr auditors, the last slice of the
analysis package.  Passing one of those raises, naming that slice.
"""

from __future__ import annotations

import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Protocol,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.convert import decoder_lm_from_numpy
from paddle_tpu_torch.obs.registry import MetricsRegistry
from paddle_tpu_torch.obs.trace import NULL_TRACER, tracer_for
from paddle_tpu_torch.ops.attention import mha_reference
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import (enforce_that,
                                              refuse_unported)
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.serving.decode_attention import (
    BLOCK_ROWS, _ragged_reference_blocked, attention_path,
    expand_decode_rows, ragged_paged_attention, ragged_paged_attention_tp)
from paddle_tpu_torch.serving.faults import (FaultPlan,
                                             InjectedDeviceError,
                                             PageLeakError)
from paddle_tpu_torch.serving.kv_cache import (NULL_PAGE, _CHAIN_SEED,
                                               HostPageTier, KVPages,
                                               PagedKVConfig, PagePool,
                                               PrefixCache, append_token,
                                               dequantize_kv, fork_page,
                                               init_kv_pages,
                                               pages_for_budget,
                                               pages_spanned, read_pages,
                                               resolve_kv_dtype, write_pages,
                                               zero_pages)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                Request, RequestStatus,
                                                SchedulerConfig, bucket_for,
                                                pack_prefill_chunks)
from paddle_tpu_torch.serving.speculate import (DraftProposer,
                                                NGramProposer,
                                                SamplingParams,
                                                accept_tokens, next_token)

__all__ = ["DecodeModel", "DecoderLM", "ServingEngine",
           "greedy_decode_reference", "reference_logits", "validate_tp"]

_SPEC_MODES = ("off", "ngram", "draft")


class DecodeModel(Protocol):
    """The structural contract the engine drives (the JAX package's
    ``DecodeModel``, with the parameters held by the module).  Methods
    are shape-polymorphic over leading dims:

    - ``num_layers``, ``num_heads``, ``head_dim``, ``vocab_size``,
      ``num_kv_heads`` (GQA: K/V carry this many heads, dividing
      ``num_heads``) and ``device``;
    - ``embed(tokens, positions) -> [..., E]``;
    - ``qkv(layer, x) -> (q, k, v)`` — q ``[..., H, D]``, k/v
      ``[..., H_kv, D]``;
    - ``attn_out(layer, ctx, x) -> [..., E]`` — attention output
      combined with the residual stream;
    - ``logits(x) -> [..., vocab_size]``.

    :class:`DecoderLM` is the built-in implementation."""

    num_layers: int
    num_heads: int
    head_dim: int
    vocab_size: int
    num_kv_heads: int

    @property
    def device(self) -> torch.device: ...

    def embed(self, tokens, positions): ...

    def qkv(self, layer: int, x): ...

    def attn_out(self, layer: int, ctx, x): ...

    def logits(self, x): ...


def validate_tp(model, tp: int, axis: str = "model") -> None:
    """Fail fast, with a fix in the message, on a model whose geometry
    cannot split ``tp`` ways over ``axis``: attention sharding moves whole
    query and KV heads per rank and FFN sharding whole columns, so each of
    those counts must divide.  Checked by ``ServingEngine(mesh=)`` and by
    :meth:`DecoderLM.shard_plan` both."""
    tp = int(tp)
    enforce_that(tp >= 1, f"tensor-parallel degree must be >= 1, got {tp}",
                 context="serving-tp")
    if tp == 1:
        return
    h = int(model.num_heads)
    kvh = int(getattr(model, "num_kv_heads", 0) or h)
    enforce_that(
        h % tp == 0,
        f"num_heads ({h}) is not divisible by the {axis!r} mesh axis "
        f"size ({tp}): tensor parallelism places whole attention heads "
        f"per chip — pick a tp that divides {h}, or resize the model",
        context="serving-tp")
    enforce_that(
        tp <= kvh,
        f"GQA corner: tp={tp} exceeds num_kv_heads ({kvh}) — a KV head "
        "cannot split below one per chip and this engine does not "
        f"replicate KV heads across the {axis!r} axis; lower tp to at "
        f"most {kvh}, or serve a model with more KV heads",
        context="serving-tp")
    enforce_that(
        kvh % tp == 0,
        f"num_kv_heads ({kvh}) is not divisible by the {axis!r} mesh "
        f"axis size ({tp}): the paged KV pool shards whole KV heads per "
        f"chip — pick a tp that divides {kvh}", context="serving-tp")
    ffn = int(getattr(model, "ffn_dim", 0) or 0)
    if ffn:
        enforce_that(
            ffn % tp == 0,
            f"FFN width ({ffn}) is not divisible by the {axis!r} mesh "
            f"axis size ({tp}): the column-parallel up projection places "
            f"whole FFN columns per chip — pick a tp that divides {ffn}",
            context="serving-tp")


def tp_slice(x, spec: Tuple, axis: str, tp: int, rank: int):
    """Rank ``rank``'s part of a whole weight ``x`` (a tensor or a numpy
    array) under its :meth:`DecoderLM.shard_plan` spec: the chunk of the
    dim named ``axis``, or ``x`` itself for a replicated weight."""
    for dim, a in enumerate(spec):
        if a == axis and tp > 1:
            per = x.shape[dim] // tp
            idx = [slice(None)] * len(x.shape)
            idx[dim] = slice(rank * per, (rank + 1) * per)
            return x[tuple(idx)]
    return x


def _rms(x, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


class _Block(nn.Module):
    """One decoder layer's projections, in the JAX package's x @ W
    layout (``[in, out]``); ``q``, ``kv`` and ``f`` are this rank's query,
    KV and FFN columns (the whole widths off a mesh)."""

    def __init__(self, e: int, q: int, kv: int, f: int, device, dtype):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device,
                                            dtype=dtype),
                                requires_grad=False)

        self.wq, self.wk, self.wv = p(e, q), p(e, kv), p(e, kv)
        self.wo, self.w1, self.w2 = p(q, e), p(e, f), p(f, e)


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
    ``logits``, each shape-polymorphic over leading dims.

    ``tp_mesh`` (with ``tp_axis``) builds this rank's tensor-parallel
    shard directly (:meth:`shard_plan`: its columns of ``wq/wk/wv/w1``,
    its rows of ``wo/w2``, ``emb/pos/out`` whole), so a rank never holds
    the whole model; :meth:`bind_tp` cuts one out of a whole model.  The
    shard's ``qkv`` returns its heads and ``attn_out`` takes them, each
    row-split product followed by one all-reduce over the axis
    (``allreduce_calls`` and ``allreduce_bytes`` count them)."""

    def __init__(self, vocab_size: int, num_layers: int = 2,
                 num_heads: int = 2, head_dim: int = 16,
                 ffn_mult: int = 4, max_positions: int = 1024,
                 num_kv_heads: Optional[int] = None, *,
                 device: DeviceLike = None, dtype=torch.float32,
                 tp_mesh=None, tp_axis: str = "model"):
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
        # tensor-parallel binding (tp 1 and no group off a mesh)
        self.tp, self.tp_rank = 1, 0
        self._tp_mesh, self._tp_axis, self._tp_group = None, None, None
        self.allreduce_calls = 0
        self.allreduce_bytes = 0
        if tp_mesh is not None:
            self.tp = tp_mesh.axis_size(tp_axis)
            validate_tp(self, self.tp, tp_axis)
            enforce_that(tp_mesh.member, f"rank {tp_mesh.rank} holds no "
                         f"shard of {tp_mesh!r}", context="serving-tp")
            self.tp_rank = tp_mesh.coord(tp_axis)
            self._tp_mesh, self._tp_axis = tp_mesh, tp_axis
            self._tp_group = tp_mesh.group(tp_axis)
        dev = resolve_device(device)
        e, v, n = self.embed_dim, vocab_size, self.tp
        self.emb = nn.Parameter(torch.zeros(v, e, device=dev, dtype=dtype),
                                requires_grad=False)
        self.pos = nn.Parameter(torch.zeros(max_positions, e, device=dev,
                                            dtype=dtype),
                                requires_grad=False)
        self.layers = nn.ModuleList(
            _Block(e, e // n, self.kv_dim // n, self.ffn_dim // n, dev,
                   dtype)
            for _ in range(num_layers))
        self.out = nn.Parameter(torch.zeros(e, v, device=dev, dtype=dtype),
                                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.emb.device

    # ---- tensor-parallel placement (the megatron plan) -------------------

    def shard_plan(self, axis: str = "model",
                   tp: Optional[int] = None) -> Dict[str, Tuple]:
        """Megatron placement over ``axis``: ``{param name: per-dim spec}``
        — Q/K/V and FFN-up column-parallel (output features split), the
        attention-output and FFN-down row-parallel (input features split,
        one all-reduce after each), embeddings, positions and the vocab
        head replicated.  ``tp`` (when given) validates divisibility."""
        if tp is not None:
            validate_tp(self, tp, axis)
        plan: Dict[str, Tuple] = {"emb": (), "pos": (), "out": ()}
        for l in range(self.num_layers):
            plan[f"l{l}.wq"] = (None, axis)
            plan[f"l{l}.wk"] = (None, axis)
            plan[f"l{l}.wv"] = (None, axis)
            plan[f"l{l}.wo"] = (axis, None)
            plan[f"l{l}.w1"] = (None, axis)
            plan[f"l{l}.w2"] = (axis, None)
        return plan

    @torch.no_grad()
    def bind_tp(self, mesh, axis: str = "model") -> "DecoderLM":
        """A new module holding this rank's shard of this (whole) model
        over ``axis`` of ``mesh`` (:meth:`shard_plan`); ``self`` is not
        changed, so it can go on backing an engine without a mesh."""
        from paddle_tpu_torch.convert import decoder_lm_state

        enforce_that(self.tp == 1, "bind_tp takes a whole model; this "
                     f"one is already a {self.tp}-way shard",
                     context="serving-tp")
        m = DecoderLM(self.vocab_size, self.num_layers, self.num_heads,
                      self.head_dim, self.ffn_dim // self.embed_dim,
                      self.max_positions, self.num_kv_heads,
                      device=self.device, dtype=self.emb.dtype,
                      tp_mesh=mesh, tp_axis=axis)
        plan = m.shard_plan(axis)
        whole = decoder_lm_state(self)
        for name, dst in decoder_lm_state(m).items():
            dst.copy_(tp_slice(whole[name], plan[name], axis, m.tp,
                               m.tp_rank))
        return m

    def _tp_psum(self, x):
        """The megatron ``g`` after a row-split product: the partial sums
        all-reduced over the tensor-parallel axis (nothing off a mesh)."""
        if self._tp_group is None:
            return x
        from paddle_tpu_torch.parallel.comm import all_reduce_

        self.allreduce_calls += 1
        self.allreduce_bytes += x.numel() * x.element_size()
        return all_reduce_(x.contiguous(), self._tp_group)

    def embed(self, tokens, positions):
        return self.emb[tokens] + self.pos[positions]

    def qkv(self, layer: int, x):
        blk = self.layers[layer]
        n, d = self.tp, self.head_dim
        h, kvh = self.num_heads // n, self.num_kv_heads // n
        xn = _rms(x)
        q = (xn @ blk.wq).reshape(x.shape[:-1] + (h, d))
        k = (xn @ blk.wk).reshape(x.shape[:-1] + (kvh, d))
        v = (xn @ blk.wv).reshape(x.shape[:-1] + (kvh, d))
        return q, k, v

    def attn_out(self, layer: int, ctx, x):
        blk = self.layers[layer]
        flat = ctx.reshape(x.shape[:-1] + (self.embed_dim // self.tp,))
        a = x + self._tp_psum(flat @ blk.wo)
        up = _rms(a) @ blk.w1
        # jax.nn.gelu's default is the tanh approximation
        return a + self._tp_psum(F.gelu(up, approximate="tanh") @ blk.w2)

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


def _parse_buckets(spec: str) -> Tuple[int, ...]:
    return tuple(sorted(int(t) for t in spec.split(",") if t.strip()))


_JAXPR_AUDITORS = ("the jaxpr auditors (retrace, xla, sharding), the last "
                   "slice of the analysis package")


class ServingEngine:
    """Paged-KV continuous-batching inference engine (see module doc).

    ``device`` (default ``cuda``) must be the model's device.
    ``use_kernel`` picks the row packing through ``attention_path``: on
    CUDA the kernel's packing always (``False`` raises); on the CPU the
    compact packing unless ``use_kernel=True``, which runs the kernel's
    packing with the plain attention standing in for the kernel.
    ``draft_params`` is the draft's numpy dict (loaded into
    ``draft_model``) or a built model, whose weights are used as they
    are.

    ``mesh`` with a ``tp_axis`` axis of ``tp`` ranks serves tensor-
    parallel (module doc): ``model`` is a whole ``DecoderLM``, bound to
    this rank's shard here (:meth:`DecoderLM.bind_tp`), or already a
    shard built over the same mesh (``DecoderLM(tp_mesh=)``).  Only the
    mesh's ranks build it."""

    def __init__(self, model: DecodeModel, *, eos_id: int,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_pages_per_seq: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: Optional[int] = None,
                 dtype=None, kv_dtype=None,
                 pool_bytes: Optional[int] = None,
                 fuse_tick: bool = True,
                 use_kernel: Optional[bool] = None,
                 queue_deadline_s: Optional[float] = None,
                 preempt_budget: Optional[int] = None,
                 watchdog_ticks: Optional[int] = None,
                 decode_retries: int = 2,
                 transient_errors: Tuple[type, ...] = (InjectedDeviceError,),
                 max_retained: int = 10000,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 faults: Optional[FaultPlan] = None,
                 time_fn: Optional[Callable[[], float]] = None,
                 tracer=None, registry: Optional[MetricsRegistry] = None,
                 mesh=None, tp_axis: str = "model",
                 spec_mode: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 draft_model=None, draft_params=None,
                 draft_pool_pages: Optional[int] = None,
                 xla_peak_bytes: Optional[int] = None,
                 xla_flops: Optional[float] = None,
                 xla_comm_bytes: Optional[float] = None,
                 role: str = "unified",
                 host_tier_bytes: Optional[int] = None,
                 swap_in_budget: Optional[int] = None,
                 host_kv_dtype: Optional[str] = None,
                 device: DeviceLike = None):
        refuse_unported(
            "ServingEngine", "serving",
            xla_peak_bytes=(xla_peak_bytes, None, _JAXPR_AUDITORS),
            xla_flops=(xla_flops, None, _JAXPR_AUDITORS),
            xla_comm_bytes=(xla_comm_bytes, None, _JAXPR_AUDITORS))
        self.device = resolve_device(device)
        enforce_that(model.device.type == self.device.type,
                     f"model is on {model.device}, engine on {self.device}",
                     context="serving")
        self.eos_id = int(eos_id)
        # fleet class: "prefill" replicas hand requests off to "decode"
        # replicas after the first token through the page-migration plane
        # (serving/migrate.py); "unified" runs both phases.  The engine
        # treats every role alike — the FleetRouter reads it to route
        self.role = str(role)
        enforce_that(self.role in ("prefill", "decode", "unified"),
                     f"role must be prefill/decode/unified, got {role!r}",
                     context="serving")
        # tensor-parallel placement: with a mesh the megatron shard_plan
        # places heads and FFN columns over the tp axis and the pool
        # splits its KV-head dim the same way; every byte count below is
        # per rank
        self.mesh = mesh
        self.tp_axis = str(tp_axis)
        self.tp = 1
        enforce_that(mesh is not None or int(getattr(model, "tp", 1)) == 1,
                     f"the model is a {getattr(model, 'tp', 1)}-way "
                     "tensor-parallel shard: serve it with "
                     "ServingEngine(mesh=) over its mesh",
                     context="serving-tp")
        if mesh is not None:
            from paddle_tpu_torch.parallel.mesh import Mesh

            enforce_that(isinstance(mesh, Mesh),
                         "mesh= takes a paddle_tpu_torch.parallel.Mesh "
                         "(make_mesh((tp,), ('model',)) ...), got "
                         f"{type(mesh).__name__}", context="serving-tp")
            enforce_that(
                self.tp_axis in mesh.axis_names,
                f"mesh has no {self.tp_axis!r} axis (axes: "
                f"{tuple(mesh.axis_names)}) — build one with "
                "make_mesh((tp,), ('model',))", context="serving-tp")
            self.tp = int(mesh.shape[self.tp_axis])
            validate_tp(model, self.tp, self.tp_axis)
            enforce_that(
                hasattr(model, "shard_plan"),
                "ServingEngine(mesh=...) needs the model to expose "
                "shard_plan(axis, tp) (see the DecodeModel contract); "
                f"{type(model).__name__} does not", context="serving-tp")
            enforce_that(mesh.member,
                         f"this rank is outside the engine's mesh {mesh!r}:"
                         " only the mesh's ranks build the engine",
                         context="serving-tp")
            bound = int(getattr(model, "tp", 1))
            if bound == 1:
                model = model.bind_tp(mesh, self.tp_axis)
            else:
                enforce_that(
                    bound == self.tp and list(model._tp_mesh.axis_ranks(
                        model._tp_axis)) == mesh.axis_ranks(self.tp_axis),
                    f"the model is a {bound}-way shard over "
                    f"{getattr(model, '_tp_mesh', None)!r}; this engine's "
                    f"mesh is {mesh!r}", context="serving-tp")
        self.model = model
        page_size = int(page_size or FLAGS.serving_page_size)
        max_slots = int(max_slots or FLAGS.serving_max_slots)
        # KV storage dtype: kv_dtype > the older dtype argument > flag
        if kv_dtype is None:
            kv_dtype = dtype if dtype is not None else FLAGS.serving_kv_dtype
        kv_dtype = resolve_kv_dtype(kv_dtype)
        num_kv_heads = int(model.num_kv_heads)
        if num_pages is None and pool_bytes is not None:
            # size the pool by BYTES: int8 pages admit ~4x the f32 pages
            num_pages = pages_for_budget(
                pool_bytes, model.num_layers, model.num_heads,
                model.head_dim, page_size, kv_dtype,
                num_kv_heads=num_kv_heads, tp=self.tp)
        num_pages = int(num_pages or FLAGS.serving_max_pages)
        if max_pages_per_seq is None:
            # default: one sequence may claim up to half the usable pool
            max_pages_per_seq = max(1, (num_pages - 1) // 2)
        if queue_deadline_s is None:
            queue_deadline_s = float(FLAGS.serving_queue_deadline_s)
        if preempt_budget is None:
            preempt_budget = int(FLAGS.serving_preempt_budget)
        if watchdog_ticks is None:
            watchdog_ticks = int(FLAGS.serving_watchdog_ticks)
        self.queue_deadline_s = queue_deadline_s or None   # 0 = disabled
        self.watchdog_ticks = int(watchdog_ticks)          # 0 = disabled
        self.decode_retries = max(0, int(decode_retries))
        # the exceptions the step retry treats as transient.  Default:
        # only the fault plan's injected error, raised BEFORE the step
        # runs; a real failure mid-step may have written part of the
        # tick's K/V in place, so widening the set to device errors
        # would need a pool snapshot this engine does not take
        self.transient_errors = tuple(transient_errors)
        self.max_retained = max(1, int(max_retained))
        self.faults = faults
        # clock precedence: fault-plan clock > explicit time_fn > monotonic
        if faults is not None and faults.clock is not None:
            self._time = faults.clock
        else:
            self._time = time_fn or time.monotonic
        self.kv_cfg = PagedKVConfig(
            num_layers=model.num_layers, num_heads=model.num_heads,
            head_dim=model.head_dim, page_size=page_size,
            num_pages=num_pages, max_pages_per_seq=int(max_pages_per_seq),
            dtype=kv_dtype, num_kv_heads=num_kv_heads, tp=self.tp)
        self._kv: KVPages = init_kv_pages(self.kv_cfg, device=self.device,
                                          mesh=mesh, axis=self.tp_axis)
        self.pool = PagePool(num_pages)
        if prefix_cache is None:
            prefix_cache = bool(FLAGS.serving_prefix_cache)
        if prefill_chunk is None:
            prefill_chunk = int(FLAGS.serving_prefill_chunk)
        self._prefill_chunk = max(0, int(prefill_chunk))
        self.cache: Optional[PrefixCache] = None
        if prefix_cache:
            hash_fn = faults.cache_hash_fn() if faults is not None else None
            self.cache = PrefixCache(self.pool, page_size, hash_fn=hash_fn)
        # the host tier: evicted reclaimable pages demote to pinned host
        # memory (checksummed) instead of being destroyed; lookups that
        # run off the device index swap the continuation back in.  Off
        # unless a byte budget is set
        self.host_tier: Optional[HostPageTier] = None
        self._swap_in_budget = int(
            swap_in_budget if swap_in_budget is not None
            else FLAGS.serving_swap_in_budget)
        self._host_hits = 0   # swap-in events that promoted >= 1 page
        host_bytes = int(host_tier_bytes if host_tier_bytes is not None
                         else FLAGS.serving_host_tier_bytes)
        if self.cache is not None and host_bytes > 0:
            self.host_tier = HostPageTier(
                host_bytes, dtype=str(host_kv_dtype if host_kv_dtype
                                      is not None
                                      else FLAGS.serving_host_kv_dtype),
                faults=faults)
            self.cache.host_tier = self.host_tier
            self.cache.page_reader = \
                lambda pages: read_pages(self._kv, pages)
        self.scheduler = ContinuousBatchingScheduler(
            self.pool, SchedulerConfig(
                max_slots=max_slots, page_size=page_size,
                max_pages_per_seq=int(max_pages_per_seq),
                max_queue=max_queue,
                preempt_budget=preempt_budget if preempt_budget > 0
                else None),
            cache=self.cache, time_fn=self._time)
        self.metrics = ServingMetrics(pool_pages=self.pool.num_usable)
        # obs: the tracer (FLAGS.obs_trace read here, at construction)
        # and the registry the stage histograms and healthz publish into
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._reg_labels: Dict[str, str] = {}
        self._tracer = NULL_TRACER
        self._postmortems_dumped: set = set()
        self.set_tracer(tracer if tracer is not None
                        else tracer_for(self._time, registry=self.registry))
        # row packing, decided ONCE through the single chooser
        self._ragged_kernel = attention_path(
            model.head_dim, page_size, num_heads=model.num_heads // self.tp,
            num_kv_heads=self.kv_cfg.local_kv_heads, device=self.device,
            use_kernel=use_kernel) == "kernel"
        self._buckets = tuple(sorted(int(b) for b in buckets)) if buckets \
            else _parse_buckets(FLAGS.serving_prefill_buckets)
        self._max_slots = max_slots
        self._fuse_tick = bool(fuse_tick)
        # prefill-row packing: the kernel needs each sequence's rows
        # padded to whole BLOCK_ROWS blocks
        self._row_align = BLOCK_ROWS if self._ragged_kernel else 1
        top = max(self._buckets) if self._buckets else \
            self.kv_cfg.max_seq_len
        chunk_rows = self._prefill_chunk if self._prefill_chunk > 0 \
            else self.kv_cfg.max_seq_len
        chunk_rows = -(-chunk_rows // self._row_align) * self._row_align
        self._prefill_budget = max(top, chunk_rows)
        # speculative decoding: a proposer drafts up to spec_k tokens per
        # running slot per tick and ONE widened step verifies all k+1
        # positions of each slot
        self.spec_mode = str(spec_mode if spec_mode is not None
                             else FLAGS.serving_spec_mode)
        enforce_that(self.spec_mode in _SPEC_MODES,
                     f"spec_mode must be one of {_SPEC_MODES}, got "
                     f"{self.spec_mode!r}", context="serving-spec")
        self.spec_k = int(spec_k if spec_k is not None
                          else FLAGS.serving_spec_k)
        enforce_that(self.spec_mode == "off" or self.spec_k >= 1,
                     "spec_k must be >= 1 when speculation is on",
                     context="serving-spec")
        self._proposer = None
        if self.spec_mode == "ngram":
            self._proposer = NGramProposer(n=spec_ngram)
        elif self.spec_mode == "draft":
            enforce_that(
                draft_model is not None and draft_params is not None,
                "spec_mode='draft' needs ServingEngine(draft_model=, "
                "draft_params=) — a small DecoderLM sharing the target's "
                "vocabulary, and its numpy weights (or a built model)",
                context="serving-spec")
            if isinstance(draft_params, nn.Module):
                draft_model = draft_params
            else:
                decoder_lm_from_numpy(draft_params, draft_model)
            enforce_that(
                int(draft_model.vocab_size) == int(model.vocab_size),
                f"draft vocab ({draft_model.vocab_size}) must equal the "
                f"target vocab ({model.vocab_size})",
                context="serving-spec")
            enforce_that(draft_model.device.type == self.device.type,
                         f"draft model is on {draft_model.device}, engine "
                         f"on {self.device}", context="serving-spec")
            self._proposer = DraftProposer(
                draft_model, page_size=page_size,
                num_pages=int(draft_pool_pages or num_pages),
                max_pages_per_seq=int(max_pages_per_seq),
                max_slots=max_slots, use_kernel=use_kernel)
        # verify rows per decode slot: 1 (plain decode) + spec_k drafts
        self._k1 = 1 + (self.spec_k if self._proposer is not None else 0)
        self._results: Dict[int, List[int]] = {}
        self._requests: Dict[int, Request] = {}
        # terminal rids in retirement order; oldest evicted past
        # max_retained so a long-running engine's memory stays bounded
        self._retired: Deque[int] = deque()
        self._tick = 0
        self._last_tick_at: Optional[float] = None
        self._prev_tick_busy = False
        self._tick_dur_ema = 0.0      # drives the unmeetable-deadline shed
        self._draining = False        # drain(): REJECT new submits

    # ---- observability wiring -------------------------------------------

    def set_tracer(self, tracer) -> None:
        """(Re)bind the engine's span tracer.  The pool, scheduler, prefix
        cache and host tier get the raw hook (None when tracing is off,
        so their hot paths pay one is-None check)."""
        self._tracer = tracer if tracer is not None else NULL_TRACER
        hook = self._tracer if self._tracer.enabled else None
        self.pool.tracer = hook
        self.scheduler.tracer = hook
        if self.cache is not None:
            self.cache.tracer = hook
        if self.host_tier is not None:
            self.host_tier.tracer = hook

    def set_registry(self, registry: MetricsRegistry, **labels) -> None:
        """(Re)bind the metrics registry; later stage observations and
        healthz publishes land there, under ``labels``."""
        self.registry = registry
        self._reg_labels = {k: str(v) for k, v in labels.items()}

    def _observe_stage(self, stage: str, seconds: float) -> None:
        """Per-stage latency (queue / prefill / decode) on the engine's
        clock, into the registry."""
        self.registry.histogram(
            "serving_stage_seconds",
            "request time per lifecycle stage").labels(
            stage=stage, **self._reg_labels).observe(max(0.0, seconds))

    def _dump_postmortem(self, reason: str) -> None:
        """Flight-recorder dump on a tripped conservation check — once
        per reason per engine."""
        if reason not in self._postmortems_dumped:
            self._postmortems_dumped.add(reason)
            self._tracer.dump_postmortem(reason)

    # ---- the unified device step -----------------------------------------

    def _attend(self, layer: int, q, table, att_lens, row_seq, qpos,
                k1: int = 1):
        """One ragged paged attention over the tick's mixed row stack.
        The compact packing feeds ``[B * k1 + pb]`` rows as they are; the
        kernel packing expands each slot's ``k1`` decode/verify rows to
        whole BLOCK_ROWS blocks (prefill rows are already block-aligned
        by the packer) and slices the context back out."""
        kv = self._kv
        ks = kv.k_scale[layer] if kv.quantized else None
        vs = kv.v_scale[layer] if kv.quantized else None
        if not self._ragged_kernel:
            return _ragged_reference_blocked(
                q, kv.k[layer], kv.v[layer], table, att_lens, row_seq,
                qpos, k_scale=ks, v_scale=vs)
        b = self._max_slots
        bd = b * k1                           # compact decode/verify rows
        rbk = -(-k1 // BLOCK_ROWS) * BLOCK_ROWS   # padded rows per slot
        h, d = q.shape[1], q.shape[2]
        qd, rsd, qpd = expand_decode_rows(q[:bd], qpos[:bd],
                                          rows_per_seq=k1)
        args = (torch.cat([qd, q[bd:]]), kv.k[layer], kv.v[layer], table,
                att_lens, torch.cat([rsd, row_seq[bd:]]),
                torch.cat([qpd, qpos[bd:]]))
        if self.mesh is not None:
            # this rank's head shard against its pool shard
            ctx = ragged_paged_attention_tp(self.mesh, self.tp_axis, *args,
                                            k_scale=ks, v_scale=vs)
        else:
            ctx = ragged_paged_attention(*args, k_scale=ks, v_scale=vs)
        cd = ctx[:b * rbk].reshape(b, rbk, h, d)[:, :k1].reshape(bd, h, d)
        return torch.cat([cd, ctx[b * rbk:]])

    @torch.inference_mode()
    def _step(self, d_tokens, d_pos, d_valid, p_tokens, p_qpos, p_seq,
              p_last, table, att_lens) -> Tuple[np.ndarray, np.ndarray]:
        """The unified per-tick step.  d_*: [B, k1] — slot ``s``'s row 0
        is its plain decode token, rows 1.. its drafted lookahead
        (invalid rows write the null page); p_*: [pb] — packed prefill
        rows (qpos -1 = padding; padding keeps the owning slot so kernel
        blocks stay sequence-uniform); p_last: [B] — row of each slot's
        chunk-final row in the packed stack; table: [B, Pm]; att_lens:
        [B] — valid KV per slot AFTER this step's writes.  Prior context,
        in-chunk causality and in-verify causality (draft ``i`` sees
        drafts ``< i``) all come from the one ``token <= position`` mask.
        Returns host logits ``[B, k1, V]`` for the decode/verify rows and
        ``[B, V]`` for each slot's chunk-final row."""
        model, page, b = self.model, self.kv_cfg.page_size, self._max_slots
        k1 = d_tokens.shape[1]
        bd = b * k1
        d_seq = np.repeat(np.arange(b), k1)
        dt, dp, dv = (d_tokens.reshape(bd), d_pos.reshape(bd),
                      d_valid.reshape(bd))
        p_act = p_qpos >= 0
        pq = np.maximum(p_qpos, 0)
        pages = np.concatenate([
            np.where(dv, table[d_seq, dp // page], NULL_PAGE),
            np.where(p_act, table[p_seq, pq // page], NULL_PAGE)])
        host = [np.concatenate([dt, p_tokens]),                # tokens
                np.concatenate([dp, pq]),                      # positions
                pages,
                np.concatenate([dp % page, pq % page]),        # offsets
                np.concatenate([dv, p_act]),                   # write mask
                np.concatenate([d_seq, p_seq]),                # row_seq
                np.concatenate([np.where(dv, dp, -1), p_qpos]),
                np.concatenate([np.arange(bd), p_last]),       # logit rows
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
            ctx = self._attend(l, q, table, att_lens, row_seq, qpos, k1)
            x = model.attn_out(l, ctx, x)
        # the step's one sync; bf16 logits widen exactly to f32
        logits = model.logits(x[sel]).float().cpu().numpy()
        return logits[:bd].reshape(b, k1, -1), logits[bd:]

    def tp_step_comm_bytes(self, rows: int) -> float:
        """Closed-form collective bytes of one step under ``tp``-way
        tensor parallelism: each layer pays exactly two row-parallel
        all-reduces (the attention-output and FFN-down products), each
        moving ``2 * b * (N-1)/N`` bytes over the axis for the ``[rows,
        E]`` f32 activation of ``b = 4 * rows * E`` bytes.  Attention is
        head-local and the pool ops are per-rank, so nothing else crosses
        the axis."""
        if self.tp <= 1:
            return 0.0
        e = int(getattr(self.model, "embed_dim", 0)
                or self.model.num_heads * self.model.head_dim)
        psum = 2.0 * (4.0 * rows * e) * (self.tp - 1) / self.tp
        return float(self.model.num_layers * 2 * psum)

    # ---- user surface ----------------------------------------------------

    def submit(self, prompt: Sequence[int], max_tokens: int,
               on_token: Optional[Callable[[int], None]] = None,
               now: Optional[float] = None,
               queue_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               sampling: Optional[SamplingParams] = None,
               tenant: str = "default") -> int:
        """Queue a request and return its rid — always, even when it is
        refused (status ``REJECTED``).  ``queue_deadline_s`` bounds the
        wait for admission, ``deadline_s`` submit-to-last-token; either
        lapsing marks it ``TIMED_OUT``.  ``sampling`` None (or
        temperature 0) is greedy argmax.  ``tenant`` is the billing
        identity the per-tenant counters split by."""
        req = Request(prompt=list(int(t) for t in prompt),
                      max_tokens=int(max_tokens), on_token=on_token,
                      sampling=sampling, tenant=str(tenant))
        t = self._time() if now is None else now
        if queue_deadline_s is None:
            queue_deadline_s = self.queue_deadline_s
        if queue_deadline_s is not None:
            req.queue_deadline_at = t + float(queue_deadline_s)
        if deadline_s is not None:
            req.deadline_at = t + float(deadline_s)
        if self._draining:
            # drain mode: admission is closed.  Queued and running work
            # keeps going; new demand is REJECTED (the fleet router reads
            # that as "route elsewhere")
            req.submitted_at = t
            req.status = RequestStatus.REJECTED
            ok = False
        else:
            ok = self.scheduler.submit(req, now=t)
        self.metrics.on_submit(t, ok)
        self._requests[req.rid] = req
        self._tracer.instant("submit", rid=req.rid, tokens=len(req.prompt),
                             max_tokens=req.max_tokens, accepted=ok)
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
        if self._proposer is not None:
            # drop any draft-model cache state (its pages return to the
            # draft pool); a no-op for the n-gram proposer
            self._proposer.release(req.rid)
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
        if shed or status is RequestStatus.TIMED_OUT:
            self.metrics.on_tenant_miss(req.tenant)
        if req.first_token_at is not None:
            self._observe_stage("decode", now - req.first_token_at)
        self._tracer.instant("terminal", rid=req.rid, status=str(status),
                             shed=shed, tokens=len(req.generated))
        self._retire(req)

    def _retire(self, req: Request) -> None:
        self._retired.append(req.rid)
        while len(self._retired) > self.max_retained:
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

    def drain(self, on: bool = True) -> None:
        """Toggle drain mode: while draining every new ``submit`` is
        REJECTED, but requests already queued or running finish (the
        drain stops new demand, not accepted work).  ``drain(False)``
        reopens admission."""
        self._draining = bool(on)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def step(self, now: Optional[float] = None) -> bool:
        """One engine tick: shed expired/unmeetable work, grow/preempt,
        advance the host tier, admit, draft, then one unified step over
        every running slot (widened to its verify rows) and the selected
        prefill chunks; then the watchdog.  Returns True if any work
        remains."""
        enforce_that(self._kv is not None,
                     "this engine's pool was released (release_pool)",
                     context="serving")
        tick, sched, m = self._tick, self.scheduler, self.metrics
        if self.faults is not None:
            self.faults.tick_begin(tick)
            self.faults.apply_page_pressure(tick, self.pool)
            self.faults.apply_cache_storm(tick, self.cache)
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
        preempted = sched.ensure_decode_pages()
        m.on_preempt(len(preempted))
        if self._proposer is not None:
            for req in preempted:
                # a preempted request re-prefills later; its draft cache
                # would only pin draft-pool pages meanwhile
                self._proposer.release(req.rid)
        # host tier BEFORE admission: commit the staged spill and swap in
        # verified host pages for the head of the queue, so the
        # admission lookup below sees them as ordinary device hits
        self._pump_host_tier(tick)
        admitted = sched.admit()
        for req in admitted:
            if req.admitted_at is None:
                wait = now - (req.submitted_at
                              if req.submitted_at is not None else now)
                m.on_admit(wait)
                m.on_tenant_admit(req.tenant, wait)
                self._observe_stage("queue", wait)
                req.admitted_at = now
            req.last_progress_tick = tick
            self._tracer.instant("admit", rid=req.rid, slot=req.slot,
                                 cached=req.cached_len, tick=tick)
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
        # drafting mutates proposer state: it runs once a tick, before
        # the retry loop
        drafts = self._propose_drafts(running,
                                      under_pressure=bool(preempted))
        if running or chunks:
            for req, start, n, _ in chunks:
                self._tracer.instant("prefill_chunk", rid=req.rid,
                                     slot=req.slot, start=start, n=n,
                                     tick=tick)
            with self._tracer.span("decode_tick", tick=tick,
                                   n=len(running),
                                   prefill_rows=total_rows):
                if self._fuse_tick or not (running and chunks):
                    self._step_with_retry(running, chunks, total_rows,
                                          tick, drafts)
                else:
                    # fuse_tick=False: prefill and decode as separate
                    # steps (same math, token-identical)
                    self._step_with_retry([], chunks, total_rows, tick, {})
                    self._step_with_retry(running, [], 0, tick, drafts)
        self._prev_tick_busy = (bool(running) or bool(admitted) or
                                bool(prefilling))
        self._watchdog_sweep(tick)
        m.on_tick(sched.queue_depth, self.pool.num_live,
                  self.pool.num_cached,
                  self.cache.evictions if self.cache is not None else 0)
        if self.host_tier is not None:
            m.on_host_tier(self.host_tier.snapshot(), self._host_hits)
        self._tick = tick + 1
        return self.has_work

    def run(self, max_ticks: Optional[int] = None) -> Dict[int, List[int]]:
        """Tick until drained (or ``max_ticks``); returns {rid: generated
        tokens} for everything completed so far.  A full drain releases
        any fault-plan page pressure, commits the host tier's staged spill
        and asserts conservation (:class:`PageLeakError`)."""
        ticks = 0
        while self.has_work:
            self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        if not self.has_work:
            if self.faults is not None:
                self.faults.release_pressure(self.pool)
            if self.host_tier is not None:
                self.host_tier.flush()
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
        queued request, plus an admission-time COW pin, plus one per
        fault-plan pressure page.  The draft pool and the host tier
        (``HOSTTIER-LEAK``) balance too."""
        pool = self.pool
        if pool.num_free + pool.num_in_use != pool.num_usable:
            self._dump_postmortem("PAGE-LEAK")
            raise PageLeakError(
                f"PAGE-LEAK: free={pool.num_free} in_use={pool.num_in_use} "
                f"usable={pool.num_usable}")
        live = (list(self.scheduler.running.values()) +
                list(self.scheduler.queue))
        held = sum(len(r.pages) for r in live)
        held += sum(1 for r in live if r.cow_src is not None)
        if self.faults is not None:
            held += len(self.faults.held_pages)
        if held != pool.total_refs:
            self._dump_postmortem("REF-LEAK")
            raise PageLeakError(
                f"REF-LEAK: held={held} refs={pool.total_refs} "
                f"cached={pool.num_cached} free={pool.num_free} "
                f"usable={pool.num_usable}")
        if self._proposer is not None:
            self._proposer.check_conservation()
        if self.host_tier is not None:
            try:
                self.host_tier.check()
            except PageLeakError:
                self._dump_postmortem("HOSTTIER-LEAK")
                raise

    def healthz(self) -> Dict[str, object]:
        """Liveness snapshot: pool state, conservation, and the metrics
        published into the registry (its flat snapshot)."""
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
        tier = self.host_tier
        if tier is not None:
            m.on_host_tier(tier.snapshot(), self._host_hits)
        m.publish(self.registry, **self._reg_labels)
        return {
            "ok": not leak,
            "metrics": self.registry.snapshot(),
            "tick": self._tick,
            "queue_depth": self.scheduler.queue_depth,
            "running": len(self.scheduler.running),
            "draining": self._draining,
            "free_pages": self.pool.num_free,
            "pages_free": self.pool.num_free,
            "pages_in_use": self.pool.num_live,
            "pages_cached": self.pool.num_cached,
            "pages_reclaimable": self.pool.num_reclaimable,
            "pages_total": self.pool.num_usable,
            "kv_dtype": str(self.kv_cfg.dtype).replace("torch.", ""),
            # per-rank pool bytes: under TP each rank holds 1/tp of every
            # page's KV heads (scales with them)
            "kv_bytes": self.kv_cfg.kv_bytes(),
            "tp": self.tp,
            "cache_hits": self.cache.hits if self.cache is not None else 0,
            "cache_misses": (self.cache.misses
                             if self.cache is not None else 0),
            "pages_host": len(tier) if tier is not None else 0,
            "host_swap_ins": tier.swap_ins if tier is not None else 0,
            "host_swap_outs": tier.spills if tier is not None else 0,
            "host_hits": self._host_hits,
            "host_corrupt": tier.corrupt if tier is not None else 0,
            "spill_stall_ticks": (tier.spill_stall_ticks
                                  if tier is not None else 0),
            "page_leak": leak,
            "status_counts": counts,
            "deadline_miss_rate": round(m.deadline_miss_rate(), 4),
            "prefill_backlog_tokens":
                self.scheduler.prefill_backlog_tokens,
            "role": self.role,
            "tenants": self.tenant_counts(),
        }

    def load(self) -> Dict[str, object]:
        """Cheap load probe: the queue_depth / running / free_pages
        numbers ``healthz`` reports, without its conservation scan — the
        fleet router reads this once per candidate replica per submit.
        Also the prompt tokens still owed a prefill, the role, the drain
        state, the host tier's depth and the per-tenant split."""
        return {"queue_depth": self.scheduler.queue_depth,
                "running": len(self.scheduler.running),
                "free_pages": self.pool.num_free,
                "prefill_backlog_tokens":
                    self.scheduler.prefill_backlog_tokens,
                "role": self.role,
                "draining": self._draining,
                "pages_host": (len(self.host_tier)
                               if self.host_tier is not None else 0),
                "tenants": self.tenant_counts()}

    def tenant_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant split: running, queued and pages_in_use from the
        live scans, pages_host from the host tier, deadline_misses from
        the metrics counter.  A tenant appears once it has been live,
        admitted or missed a deadline ("default" covers callers that
        never pass ``tenant=``)."""
        out: Dict[str, Dict[str, int]] = {}

        def _slot(t: str) -> Dict[str, int]:
            return out.setdefault(t, {"running": 0, "queued": 0,
                                      "pages_in_use": 0,
                                      "pages_host": 0,
                                      "deadline_misses": 0})

        for req in self.scheduler.running.values():
            s = _slot(req.tenant)
            s["running"] += 1
            s["pages_in_use"] += len(req.pages)
        for req in self.scheduler.queued_requests():
            _slot(req.tenant)["queued"] += 1
        for t, n in self.metrics.tenant_deadline_misses.items():
            _slot(t)["deadline_misses"] = n
        if self.host_tier is not None:
            for t, n in self.host_tier.resident_by_tenant.items():
                _slot(t)["pages_host"] = n
        # tenants whose work all completed still report a zero-miss row
        for t in self.metrics.tenant_queue_wait_s:
            _slot(t)
        return out

    # ---- the page-migration plane ------------------------------------------

    def migratable_rids(self) -> List[int]:
        """Requests eligible for a chain handoff to a decode replica:
        RUNNING, prefill fully materialized, first token emitted (so the
        destination starts from a decodable state)."""
        return [r.rid for r in self.scheduler.running_requests()
                if r.status is RequestStatus.RUNNING and not r.prefilling
                and r.generated]

    def release_pool(self) -> None:
        """Drop the device pool (and a draft model's) of an engine that
        will not step again — a fleet replica fenced dead and reaped — so
        its memory returns to the allocator for the rest of the run.  The
        host-side bookkeeping (free list, scheduler, host tier) stays, so
        the conservation checks still read it."""
        enforce_that(not self.has_work,
                     "release_pool on an engine with work in flight",
                     context="serving")
        self._kv = None
        if isinstance(self._proposer, DraftProposer):
            self._proposer._kv = None

    def apply_imported_pages(self, page_ids: Sequence[int], k, v,
                             k_scale=None, v_scale=None) -> None:
        """Splice host page payloads (STORED values from ``read_pages``
        on the source engine, numpy arrays or CPU tensors) into this
        engine's pool at ``page_ids``, in place (:func:`write_pages`).
        The uploads are ordered on the current stream ahead of the next
        step's attention, which reads the pages on that same stream."""
        if len(page_ids) == 0:
            return
        write_pages(self._kv, list(page_ids), k, v, k_scale, v_scale)

    # ---- the host tier ---------------------------------------------------

    def _pump_host_tier(self, tick: int) -> None:
        """One tick of host-tier work, before admission: advance the
        depth-one spill writer, then — for the head-of-queue request
        only — walk the host index past the device index's longest hit
        and promote up to ``swap_in_budget`` verified pages back into the
        pool.  Promoted pages are inserted into the device index and
        parked reclaimable, so the admission lookup right after treats
        them like any other cached prefix.  A checksum mismatch counts
        HOSTTIER-CORRUPT and ends the swap-in there: corruption degrades
        to a shorter hit, never to wrong K/V."""
        tier, cache, sched = self.host_tier, self.cache, self.scheduler
        if tier is None or cache is None:
            return
        tier.pump(tick)
        if self._swap_in_budget <= 0 or not sched.queue:
            return
        req = sched.queue[0]
        toks = req.cache_tokens
        page = self.kv_cfg.page_size
        nblocks = len(toks) // page
        if nblocks == 0 or len(tier) == 0:
            return
        _, hit_len = cache.lookup(toks)       # pure probe, no LRU churn
        j = hit_len // page
        if j >= nblocks:
            return
        keys = cache.chain_keys(toks)
        h = _CHAIN_SEED if j == 0 else keys[j - 1]
        probe: List[Tuple[int, int, Tuple[int, ...]]] = []
        jj, hh = j, h
        while jj < nblocks and len(probe) < self._swap_in_budget:
            block = tuple(toks[jj * page:(jj + 1) * page])
            if tier.peek(keys[jj], hh, block) is None:
                break
            probe.append((keys[jj], hh, block))
            hh = keys[jj]
            jj += 1
        if not probe:
            return
        # device pages first (the ladder may evict-and-spill to make
        # room); under pressure the records stay host-resident
        new = sched.alloc_pages(len(probe))
        if new is None:
            return
        got = []
        for key, prev, block in probe:
            rec = tier.take_verified(key, prev, block)
            if rec is None:
                break                  # HOSTTIER-CORRUPT: chain ends here
            got.append(rec)
        used, unused = new[:len(got)], new[len(got):]
        if got:
            self._swap_in(used, got)
            # pages[] is indexed by block: blocks < j are device-resident
            # already (NULL_PAGE padding keeps the indices aligned)
            cache.insert(toks, [NULL_PAGE] * j + used,
                         upto=(j + len(got)) * page, from_block=j,
                         prev_hash=h, tenant=req.tenant)
            self._host_hits += 1
            self._tracer.instant("host_swap_in", rid=req.rid,
                                 n=len(got), tick=tick)
        if used:
            # park the promoted pages reclaimable (insert registered them
            # cached; dropping our alloc ref leaves refcount 0)
            self.pool.free(used)
        if unused:
            self.pool.free(unused)

    def _swap_in(self, page_ids: List[int], recs) -> None:
        """Upload host records into device pages: one pinned staging
        buffer per array and ``non_blocking`` copies on the current
        stream; int8 host records under a float pool are dequantized on
        the card with the pool's own rule."""
        pin = self.device.type == "cuda"

        def stack(xs):
            shape = (xs[0].shape[0], len(xs)) + tuple(xs[0].shape[2:])
            return torch.cat(xs, dim=1, out=torch.empty(
                shape, dtype=xs[0].dtype, pin_memory=pin))

        k, v = stack([r.k for r in recs]), stack([r.v for r in recs])
        ks = vs = None
        if recs[0].k_scale is not None:
            ks = stack([r.k_scale for r in recs])
            vs = stack([r.v_scale for r in recs])
        if not self.kv_cfg.quantized and ks is not None:
            dev = self.device
            k = dequantize_kv(k.to(dev, non_blocking=True),
                              ks.to(dev, non_blocking=True))
            v = dequantize_kv(v.to(dev, non_blocking=True),
                              vs.to(dev, non_blocking=True))
            ks = vs = None
        write_pages(self._kv, page_ids, k, v, ks, vs)

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

    def _propose_drafts(self, running: List[Request],
                        under_pressure: bool) -> Dict[int, Tuple]:
        """Per-tick speculation: ask the proposer for up to ``spec_k``
        drafts per running slot, charge lookahead pages (opportunistic —
        never by preemption) and privatize any shared page the verify
        would write (:meth:`_cow_guard`).  Under page pressure (a
        preemption ran this tick, or the pool is dry) speculation is
        suspended: the tick degrades to plain 1-row decode.  Returns
        ``{rid: (draft tokens, warped proposal probs or None)}``."""
        if self._proposer is None or not running:
            return {}
        m = self.metrics
        if under_pressure or self.pool.num_free == 0:
            m.on_spec_suspend(len(running))
            return {}
        caps = {req.rid: max(0, min(self.spec_k,
                                    req.tokens_remaining - 1,
                                    self.kv_cfg.max_seq_len
                                    - req.cache_len - 1))
                for req in running}
        eligible = [r for r in running if caps[r.rid] > 0]
        proposals = self._proposer.propose(eligible,
                                           lambda r: caps[r.rid]) \
            if eligible else {}
        drafts: Dict[int, Tuple] = {}
        for req in running:
            got = proposals.get(req.rid, ((), None))
            toks, probs = list(got[0])[:caps[req.rid]], got[1]
            if toks:
                granted = self.scheduler.grant_lookahead(req, len(toks))
                if granted < len(toks):
                    m.on_spec_suspend()       # page-pressure shrink
                    toks = toks[:granted]
            # the guard covers the base decode row too (toks may be
            # empty): a speculating engine never writes a verify row
            # into a cached or shared page un-forked
            toks = self._cow_guard(req, toks)
            if toks:
                drafts[req.rid] = (
                    toks, None if probs is None else probs[:len(toks)])
        if isinstance(self._proposer, DraftProposer):
            m.on_draft(self._proposer.steps, self._proposer.step_time_s)
        return drafts

    def _cow_guard(self, req: Request, toks: List[int]) -> List[int]:
        """Copy-on-write guard for the verify's multi-token write: every
        page the ``len(toks) + 1`` rows would touch that is cached or
        shared is forked into a private copy first (table entry swapped,
        our reference moved), so a rejected branch never dirties K/V
        another holder reads.  If no page is free for the fork, the
        lookahead stops short of the shared page."""
        page = self.kv_cfg.page_size
        for idx in pages_spanned(req.cache_len, len(toks) + 1, page):
            src = req.pages[idx]
            if not self.pool.is_cached(src) and \
                    self.pool.refcount(src) <= 1:
                continue
            got = self.scheduler.alloc_pages(1)
            if got is None:
                self.metrics.on_spec_suspend()
                return toks[:max(0, idx * page - 1 - req.cache_len)]
            fork_page(self._kv, src, got[0])
            self.pool.free([src])     # drop OUR ref; sharers keep theirs
            req.pages[idx] = got[0]
            self.metrics.on_spec_cow()
            self._tracer.instant("spec_cow", rid=req.rid, src=src,
                                 dst=got[0])
        return toks

    def _step_with_retry(self, running: List[Request], chunks, total_rows,
                         tick: int, drafts: Dict[int, Tuple]) -> None:
        """One unified step; an error of ``transient_errors`` (the fault
        plan's injected one, raised before the step runs) re-runs the
        whole step, up to ``decode_retries`` times — a retried tick gives
        the tokens of one that did not fail.  Past the budget the tick is
        lost and the watchdog counts the stall."""
        attempt = 0
        while True:
            try:
                if self.faults is not None and \
                        self.faults.decode_should_fail(tick, attempt):
                    raise InjectedDeviceError(f"injected @ tick {tick} "
                                              f"attempt {attempt}")
                self._do_step(running, chunks, total_rows, drafts)
                return
            except self.transient_errors:
                attempt += 1
                if attempt > self.decode_retries:
                    return
                self.metrics.on_retry()

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
                 total_rows: int, drafts: Dict[int, Tuple]) -> None:
        """Assemble and run ONE unified step, then walk its results:
        chunk bookkeeping first (cache inserts, finite guard, final-chunk
        first token), decode/verify emissions second.  With speculation
        slot ``s`` ships ``1 + len(drafts[s])`` rows; the accept walk
        emits the longest agreeing prefix plus one bonus/corrected token,
        and a partial acceptance rolls the lookahead pages back."""
        b, k1, cfg = self._max_slots, self._k1, self.kv_cfg
        d_tokens = np.zeros((b, k1), np.int32)
        d_pos = np.zeros((b, k1), np.int32)
        d_valid = np.zeros((b, k1), bool)
        att_lens = np.zeros((b,), np.int32)
        table = np.full((b, cfg.max_pages_per_seq), NULL_PAGE, np.int32)
        for req in running:
            s = req.slot
            dr = drafts.get(req.rid, ((), None))[0]
            n = 1 + len(dr)
            d_tokens[s, 0] = req.generated[-1]
            d_tokens[s, 1:n] = dr
            d_pos[s, :n] = req.cache_len + np.arange(n)
            d_valid[s, :n] = True
            att_lens[s] = req.cache_len + n
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
            # absolute row in the step's stack (behind the B*k1
            # decode/verify rows)
            p_last[s] = b * k1 + off + n - 1
            att_lens[s] = start + n
            table[s, :len(req.pages)] = req.pages
            off += rows
        d_logits, p_logits = self._step(d_tokens, d_pos, d_valid, p_tokens,
                                        p_qpos, p_seq, p_last, table,
                                        att_lens)
        self.metrics.on_step(
            sum(1 + len(drafts.get(r.rid, ((),))[0]) for r in running),
            total_rows, pb - sum(c[2] for c in chunks),
            n_slots=len(running))
        # stamp AFTER the sync so TTFT includes the step compute
        now = self._time()
        for req, start, n, _rows in chunks:
            if req.status is not RequestStatus.RUNNING:
                continue    # cancelled from an earlier chunk's on_token
            self._finish_chunk(req, start, n, p_logits[req.slot], now)
        if self.faults is not None and self.faults.nan_rids:
            poisoned = [r for r in running
                        if r.rid in self.faults.nan_rids]
            if poisoned:              # only then pay for a writable copy
                d_logits = d_logits.copy()
                for req in poisoned:
                    d_logits[req.slot] = np.nan
        for req in running:
            if req.status is not RequestStatus.RUNNING:
                continue    # cancelled from another slot's on_token
            dr, dprobs = drafts.get(req.rid, ((), None))
            rows = d_logits[req.slot, :1 + len(dr)]
            if not np.isfinite(rows).all():
                # poisoned slot (possibly mid-verify): fail ONLY this
                # request — its uncached pages are scrubbed by _finish
                self._finish(req, RequestStatus.FAILED, now)
                continue
            emitted, accepted = accept_tokens(
                rows, dr, dprobs, req.sampling, len(req.generated),
                self.eos_id)
            req.cache_len += accepted + 1
            if dr:
                req.spec_proposed += len(dr)
                req.spec_accepted += accepted
                self.metrics.on_spec(len(dr), accepted)
                self._tracer.instant("spec_accept", rid=req.rid,
                                     proposed=len(dr), accepted=accepted)
                if accepted < len(dr):
                    # rejected branch: return the lookahead pages past
                    # the accepted length (the rolled-back rows' K/V is
                    # masked junk the next real tokens overwrite)
                    self.scheduler.rollback_pages(req)
                    self._tracer.instant("spec_rollback", rid=req.rid,
                                         rejected=len(dr) - accepted)
            for tok in emitted:
                self._emit(req, tok, now)
                if req.finished:
                    break
            if not req.finished and self._proposer is not None:
                # accepted history is now truth: the draft proposer
                # rolls its own cache back to it (no-op for n-gram)
                self._proposer.commit(req)

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
                from_block=req.chain_blocks, prev_hash=req.chain_hash,
                tenant=req.tenant)
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
            self._observe_stage("prefill", now - (
                req.admitted_at if req.admitted_at is not None else now))
            self._tracer.instant("first_token", rid=req.rid, slot=req.slot)
        self.metrics.on_token(now, ttft)
        if req.on_token is not None:
            req.on_token(tok)
            if req.finished:
                return   # the callback cancelled this request: keep it
        if tok == self.eos_id or len(req.generated) >= req.max_tokens:
            self._results[req.rid] = list(req.generated)
            self._finish(req, RequestStatus.COMPLETED, now)
