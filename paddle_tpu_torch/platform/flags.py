"""Global flag registry — the gflags analog (a copy of the registry in
``paddle_tpu/platform/flags.py``, holding only the flags the port reads).

Values come from the defaults below, overridden by the environment
(``PADDLE_TPU_TORCH_<NAME>``) and then by ``FLAGS.<name> = value``.  The
defaults are the JAX package's, so an engine built with no arguments has
the same geometry in both packages.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict

from paddle_tpu_torch.platform.enforce import EnforceError

_ENV_PREFIX = "PADDLE_TPU_TORCH_"


@dataclass
class _FlagSpec:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


class _Flags:
    """Typed global flags with attribute access (``FLAGS.serving_page_size``)."""

    def __init__(self):
        object.__setattr__(self, "_specs", {})
        object.__setattr__(self, "_values", {})

    def define(self, name: str, default: Any, help: str = "",
               parser=None) -> None:
        if parser is None:
            if isinstance(default, bool):
                parser = _parse_bool
            elif isinstance(default, int):
                parser = int
            elif isinstance(default, float):
                parser = float
            else:
                parser = str
        self._specs[name] = _FlagSpec(name, default, parser, help)
        env = os.environ.get(_ENV_PREFIX + name.upper())
        self._values[name] = parser(env) if env is not None else default

    def set(self, name: str, value: Any) -> None:
        if name not in self._specs:
            raise EnforceError(f"unknown flag {name!r}", context="flags")
        self._values[name] = value

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.set(k, v)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self.set(name, value)


FLAGS = _Flags()

FLAGS.define("serving_page_size", 128,
             "paged-KV cache page size in tokens (serving engine)")
FLAGS.define("serving_max_pages", 512,
             "total pages in the serving KV pool (page 0 is reserved as "
             "the null page that masked/inactive writes land on)")
FLAGS.define("serving_max_slots", 8,
             "maximum concurrently-decoding sequences per engine tick "
             "(the static batch dimension of the unified step)")
FLAGS.define("serving_prefill_buckets", "32,64,128,256,512",
             "comma ladder of padded prefill row counts: each tick's "
             "packed prefill rows pad to the smallest bucket that holds "
             "them")
FLAGS.define("serving_prefix_cache", True,
             "automatic prefix caching over full KV pages (chained "
             "token-block hashes, refcount-shared pages, COW fork on a "
             "full-cover hit)")
FLAGS.define("serving_prefill_chunk", 256,
             "chunked prefill: at most this many prompt tokens per "
             "request per tick ride the unified step; 0 disables "
             "chunking", parser=int)
FLAGS.define("serving_kv_dtype", "float32",
             "storage dtype of the paged KV pool: float32 | bfloat16 | "
             "int8 (int8 adds per-token, per-kv-head f32 scales)")
FLAGS.define("serving_queue_deadline_s", 0.0,
             "default per-request admission deadline in seconds; 0 "
             "disables", parser=float)
FLAGS.define("serving_preempt_budget", 3,
             "max re-prefill recomputes per request before it escalates; "
             "0 = unlimited", parser=int)
FLAGS.define("serving_watchdog_ticks", 16,
             "a RUNNING request that makes no progress for this many "
             "ticks is FAILED; 0 disables", parser=int)

# training slices (the JAX defaults of paddle_tpu/platform/flags.py)
FLAGS.define("seed", 0,
             "global random seed: each training step draws its dropout "
             "masks from it and the step count")
FLAGS.define("log_period", 100,
             "log the mean cost and metrics of the last N batches every N "
             "batches (one read of the card per window)")
FLAGS.define("log_level", "INFO", "logging level of the port's logger")
FLAGS.define("show_parameter_stats_period", 0,
             "log each parameter's mean and max |gradient| every N "
             "batches (0 = off)")
FLAGS.define("use_pallas", True,
             "take the fused recurrent steps where the JAX package takes "
             "its Pallas kernels (the hand-written CUDA kernels on the "
             "card, their plain versions on the host); off = the plain "
             "cells with identical semantics")
FLAGS.define("use_bf16", True,
             "compute matmuls in bfloat16 with f32 accumulation; q/k/v "
             "ride bf16 into flash attention")
FLAGS.define("bf16_activations", True,
             "store inter-layer image activations (conv, pool and "
             "batch-norm outputs) in bfloat16; batch-norm statistics, "
             "losses and parameters stay f32. Only active when use_bf16 "
             "is also on.")
FLAGS.define("bf16_dense_activations", False,
             "store fc/embedding/attention outputs (the transformer "
             "residual stream) in bfloat16; norm statistics and losses "
             "still reduce in f32. Only active when use_bf16 is also on.")
FLAGS.define("attn_block", 0,
             "flash-attention tile edge of the plain version's key "
             "blocks; 0 = auto: the largest of 512/256/128 that divides "
             "the sequence. The CUDA kernels keep their own 64-row tiles.",
             parser=int)
FLAGS.define("attn_pv_f32", False,
             "keep the flash-attention P and dS operands in f32 instead of "
             "rounding them to the inputs' dtype before the PV, dV, dK and "
             "dQ products")

# the serving engine's upper tier: speculation and the host page tier
FLAGS.define("serving_spec_mode", "off",
             "speculative decoding: off | ngram | draft. 'ngram' drafts "
             "by prompt lookup over a slot's own history; 'draft' runs a "
             "small draft DecoderLM (ServingEngine(draft_model=, "
             "draft_params=)) over its own paged pool. One widened step "
             "verifies all k+1 positions per slot, the longest agreeing "
             "prefix is accepted, and greedy output stays token-identical "
             "to decoding without speculation")
FLAGS.define("serving_spec_k", 4,
             "speculation depth: drafted tokens per slot per tick "
             "(lookahead pages are charged opportunistically, never by "
             "preemption)", parser=int)
FLAGS.define("serving_spec_ngram", 3,
             "n-gram size of the prompt-lookup proposer (falls back to "
             "shorter suffixes down to 1)", parser=int)
FLAGS.define("serving_host_tier_bytes", 0,
             "byte budget of the host-RAM spill tier under the device "
             "page pool: evicted reclaimable pages demote to pinned host "
             "memory, checksummed, and a prefix lookup that runs off the "
             "device index swaps the verified continuation back in. "
             "0 disables", parser=int)
FLAGS.define("serving_swap_in_budget", 8,
             "host-tier pages promoted back to the device pool per tick "
             "for the head-of-queue request; 0 = spill only", parser=int)
FLAGS.define("serving_host_kv_dtype", "stored",
             "host-tier format: 'stored' keeps the pool's bytes verbatim "
             "(swap-in is bit-identical); 'int8' transcodes float pages "
             "to int8 + per-token f32 scales on spill")

# obs: tracing and the metrics registry
FLAGS.define("obs_trace", False,
             "request-scoped span tracing (paddle_tpu_torch.obs), read "
             "when an engine is built: on = a real Tracer on the engine's "
             "clock; off = the shared NULL_TRACER, a no-op")
FLAGS.define("obs_keep_all", True,
             "flag-built tracers keep the full event list for export; off "
             "keeps only the bounded flight-recorder ring")
FLAGS.define("obs_ring_size", 4096,
             "flight-recorder depth: the most recent events kept in a "
             "bounded ring and dumped when a conservation check trips",
             parser=int)
FLAGS.define("obs_dump_dir",
             os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_obs"),
             "directory for flight-recorder postmortem dumps")

# the v2 flags that no module reads (kept so configs that set them load)
FLAGS.define("test_period", 0,
             "run the tester every N batches (0 = per pass)", parser=int)
FLAGS.define("show_layer_stat", False,
             "print per-layer output stats each log period")
FLAGS.define("save_dir", "./output", "default checkpoint output directory")
FLAGS.define("prealloc_mem", False,
             "kept for configs that set it; it has no effect on torch's "
             "caching allocator, which grows its pool on demand")
