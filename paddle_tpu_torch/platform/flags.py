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
FLAGS.define("mesh_shape", "",
             "comma dims of the default device mesh, e.g. '8' or '2,4' "
             "(a mesh's devices are the job's ranks); empty = one axis "
             "over every rank")
FLAGS.define("mesh_axes", "data", "comma axis names matching mesh_shape")
FLAGS.define("zero_stage", 0,
             "cross-replica sharded weight update (arXiv 2004.13336): "
             "0 = replicated optimizer state (default), 1 = ZeRO-1 — "
             "reduce-scatter grads, update a 1/N optimizer-state shard "
             "per replica over the 'data' mesh axis, all-gather updated "
             "weights. Per-trainer override: SGD(zero=...).")
FLAGS.define("pipeline_stages", 0,
             "pipeline-parallel stage count S for SGD(pipeline=...). 0 = "
             "derive: the PipelineConfig's num_stages, else the mesh's "
             "'stage' axis size, else every rank. The model's layer "
             "count must divide by S (each stage holds L/S consecutive "
             "blocks).", parser=int)
FLAGS.define("pipeline_microbatches", 8,
             "GPipe microbatch count M per pipeline-parallel train step "
             "(PipelineConfig(microbatches=0) reads this). The batch "
             "must divide by M; bubble fraction is (S-1)/(M+S-1).",
             parser=int)
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

# the fleet: replicas, leases, roles, migration and the tenant control
# plane (serving/fleet.py, migrate.py, control.py)
FLAGS.define("serving_fleet_replicas", 4,
             "default replica count for FleetRouter: N ServingEngine "
             "replicas behind one prefix-affinity front-door. Traffic "
             "routes by chained prompt-block hash (the PrefixCache key "
             "chain) with healthz-driven load balancing as tiebreak and "
             "overflow; a dead replica's in-flight requests resubmit to "
             "survivors.", parser=int)
FLAGS.define("serving_fleet_heartbeat_s", 1.0,
             "fleet replica lease scale on the fleet's (possibly "
             "injected) clock: the lease TTL is 3x this. Leases renew "
             "every fleet tick (renewal is a cheap host op; only a "
             "heartbeat-partition fault blocks it), so a replica dies "
             "when its renewals stop for the TTL — then its token is "
             "dropped (a zombie can never ack after its slot is "
             "reclaimed) and its in-flight requests resubmit. On a "
             "wall clock set this above the worst-case single tick "
             "(first-compile spikes), since a tick longer than the TTL "
             "lapses every lease mid-tick.", parser=float)
FLAGS.define("serving_fleet_resubmit_budget", 2,
             "max death-driven resubmits per fleet request. A request "
             "whose replica dies is resubmitted to a survivor with its "
             "ORIGINAL absolute deadline at most this many times, then "
             "FAILED — bounded recovery, never an infinite "
             "kill->resubmit loop. 0 = fail on the first death.",
             parser=int)
FLAGS.define("serving_fleet_roles", "",
             "comma-separated replica role list for a disaggregated "
             "fleet ('prefill,prefill,decode,decode'); shorter lists "
             "pad with 'unified', empty = every replica unified (the "
             "classic fleet). Prompts route to prefill/unified "
             "replicas; a prefill-class replica hands each request off "
             "to the least-loaded decode-class replica after its first "
             "token via the page-migration plane (export_chain/"
             "import_chain), so long prefills never steal verify-row "
             "budget from chatty decoders.")
FLAGS.define("serving_migrate_budget", 16,
             "page-migration admission budget: KV pages a DESTINATION "
             "replica accepts per fleet tick across in-flight "
             "migrations (chain handoffs and cross-replica prefix "
             "seeds). Charged like chunked prefill — a blob of n pages "
             "waits ceil(n/budget) ticks in the destination's transfer "
             "queue and never blocks its decode tick. 0 disables "
             "migration (prefill-class replicas then decode their own "
             "requests to completion).", parser=int)
FLAGS.define("serving_tenant_classes", "",
             "multi-tenant SLO registry for the fleet control plane "
             "(serving/control.py): a comma list of 'name:class' pairs "
             "('alice:interactive,bulk:batch'; a bare name means "
             "standard). Classes bind latency-tier deadlines "
             "(interactive 0.5s / standard 2s / batch none), WFQ "
             "weights (4/2/1) and preemption precedence (batch slots "
             "are victimized first). Empty = no registry: submits keep "
             "their explicit deadlines, quotas and precedence are off. "
             "Unknown tenants auto-register as standard on first "
             "touch.")
FLAGS.define("serving_wfq", False,
             "weighted fair queuing at the FleetRouter: submits buffer "
             "in per-tenant virtual-time queues (prompt-token-weighted "
             "service, weights from the tenant registry) and release "
             "to dispatch each tick bounded by the READY replicas' "
             "admission slack — one tenant's 10x prompt storm backlogs "
             "only its own queue while other tenants keep their "
             "deadline SLO. Off = the classic submit->dispatch FIFO.")
FLAGS.define("serving_autoscale", False,
             "fleet autoscaler policy loop (serving/control.py "
             "Autoscaler) on the fleet's injected clock: joins a "
             "replica when any pressure signal breaches its hi "
             "threshold (queue_wait_ms_p95, live-page fraction, "
             "prefill backlog, WFQ backlog, fresh deadline misses) and "
             "drains the newest idle replica when the fleet is "
             "provably idle — never the last prefill-capable replica "
             "of a disaggregated fleet. Hysteresis via "
             "serving_autoscale_cooldown.")
FLAGS.define("serving_autoscale_cooldown", 10,
             "autoscaler hysteresis: fleet ticks with NO scaling "
             "action after any join/drain, so one pressure spike "
             "cannot flap the fleet size tick-over-tick.", parser=int)
# resilience: the bad-step guard and step-granular checkpoints
FLAGS.define("train_bad_step_policy", "off",
             "default bad-step guard for trainer.SGD (per-trainer "
             "override: SGD(guard=BadStepGuard(...))): 'off' = the "
             "classic unguarded step; 'skip' = screen the gradients with "
             "one global-norm + finiteness reduction after the backward "
             "and skip bad steps (params, optimizer slots, the step "
             "counter and model state untouched; the verdict is read to "
             "the host once a step); 'rollback' = skip, plus K "
             "consecutive bad steps (train_bad_step_window) dump a "
             "flight-recorder postmortem and raise BadStepRollback so "
             "the resilience supervisor restarts from the last verified "
             "checkpoint.")
FLAGS.define("train_bad_step_max_norm", 0.0,
             "bad-step guard: global gradient-norm ceiling — a FINITE "
             "step whose grad norm exceeds this is also skipped "
             "(0 = finiteness check only). Unlike "
             "gradient_clipping_threshold this does not rescale; it "
             "refuses the step.", parser=float)
FLAGS.define("train_bad_step_window", 3,
             "bad-step guard hysteresis: under policy 'rollback', this "
             "many CONSECUTIVE bad steps trigger the rollback. Also the "
             "default cadence of the rollback check "
             "(BadStepGuard.check_every).", parser=int)
FLAGS.define("train_ckpt_async", False,
             "write training checkpoints on a background thread "
             "(resilience.AsyncCheckpointer): the train loop stalls "
             "only for the device->host snapshot, never the "
             "tar/pkl/md5/meta disk commit. Depth-one pipelined — a new "
             "save first waits out the previous write, and the elastic "
             "trainer acks master tasks only past that durability "
             "barrier. Per-call override: train(async_save=...).")
FLAGS.define("train_ckpt_keep", 2,
             "checkpoint prune budget for step-granular training saves: "
             "keep this many newest VERIFIED checkpoints (corrupt dirs "
             "never count toward the budget, so torn young saves cannot "
             "reap the only good artifact). 0 disables pruning. "
             "Per-call override: train(keep=...).", parser=int)
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

# fluid: the static verifier's gate before a program's first run
FLAGS.define("fluid_verify", "warn",
             "static program verification before Executor.run first runs "
             "a fluid Program: 'warn' (default) logs every diagnostic "
             "the paddle_tpu_torch.analysis verifier finds, 'strict' "
             "raises on ERROR diagnostics (shape/dtype conflicts, "
             "def-before-use, dangling fetches, duplicate writers), "
             "'off' disables.  Runs once per (program, feed-shape) key, "
             "so steady state pays nothing.")

# the v2 flags that no module reads (kept so configs that set them load)
FLAGS.define("test_period", 0,
             "run the tester every N batches (0 = per pass)", parser=int)
FLAGS.define("show_layer_stat", False,
             "print per-layer output stats each log period")
FLAGS.define("save_dir", "./output", "default checkpoint output directory")
FLAGS.define("prealloc_mem", False,
             "kept for configs that set it; it has no effect on torch's "
             "caching allocator, which grows its pool on demand")
