"""paddle_tpu_torch.serving — paged-KV continuous-batching inference on
PyTorch/CUDA: block-paged KV storage (``kv_cache``), the ragged paged
attention kernel and its plain version (``decode_attention``), the
continuous-batching scheduler (``scheduler``), token choice
and speculation (``speculate``), the metrics (``metrics``), the
user-facing :class:`ServingEngine` (``engine``), the fault plans
(``faults``), and the fleet: :class:`FleetRouter` (``fleet``), the
page-migration plane (``migrate``) and the tenant control plane
(``control``).
"""

from paddle_tpu_torch.serving.decode_attention import (
    BLOCK_ROWS, QUANT_DRIFT_BOUND, attention_path, check_quant_drift,
    expand_decode_rows, paged_decode_attention, quant_parity_error,
    ragged_paged_attention, ragged_paged_attention_kernel,
    ragged_paged_attention_reference, ragged_paged_attention_tp)
from paddle_tpu_torch.serving.control import (DEFAULT_CLASSES,
                                              AdmissionLedger, Autoscaler,
                                              AutoscalePolicy, TenantClass,
                                              TenantRegistry, TenantSpec,
                                              WeightedFairQueue,
                                              check_control_conservation)
from paddle_tpu_torch.serving.engine import (DecodeModel, DecoderLM,
                                             ServingEngine,
                                             greedy_decode_reference,
                                             reference_logits, validate_tp)
from paddle_tpu_torch.serving.faults import (FaultPlan, FleetFaultPlan,
                                             InjectedDeviceError,
                                             ManualClock, PageLeakError)
from paddle_tpu_torch.serving.fleet import (FleetRouter, Replica,
                                            ReplicaState)
from paddle_tpu_torch.serving.kv_cache import (NULL_PAGE, HostPageTier,
                                               KVPages, PagedKVConfig,
                                               PagePool, PrefixCache,
                                               append_token, dequantize_kv,
                                               fork_page, gather_kv,
                                               init_kv_pages,
                                               kv_pool_sharding,
                                               kv_pool_specs,
                                               page_checksum,
                                               pages_for_budget,
                                               pages_spanned,
                                               prefix_chain_hashes,
                                               quantize_kv, read_pages,
                                               resolve_kv_dtype,
                                               write_pages, write_prompt,
                                               zero_pages)
from paddle_tpu_torch.serving.metrics import FleetMetrics, ServingMetrics
from paddle_tpu_torch.serving.migrate import (MigrationBlob,
                                              check_migration_conservation,
                                              export_chain, export_prefix,
                                              import_chain, import_prefix)
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                Request, RequestStatus,
                                                SchedulerConfig, bucket_for,
                                                pack_prefill_chunks)
from paddle_tpu_torch.serving.speculate import (DraftProposer,
                                                NGramProposer, Proposer,
                                                SamplingParams,
                                                accept_tokens, next_token,
                                                warp_probs)

__all__ = [
    "ServingEngine", "DecodeModel", "DecoderLM", "greedy_decode_reference",
    "reference_logits", "validate_tp",
    "ragged_paged_attention", "ragged_paged_attention_kernel",
    "ragged_paged_attention_tp", "kv_pool_specs", "kv_pool_sharding",
    "ragged_paged_attention_reference", "paged_decode_attention",
    "attention_path", "expand_decode_rows", "BLOCK_ROWS",
    "QUANT_DRIFT_BOUND", "quant_parity_error", "check_quant_drift",
    "PagedKVConfig", "KVPages", "PagePool", "PrefixCache", "NULL_PAGE",
    "init_kv_pages", "append_token", "write_prompt", "zero_pages",
    "fork_page", "pages_spanned", "prefix_chain_hashes", "quantize_kv",
    "dequantize_kv", "pages_for_budget", "resolve_kv_dtype",
    "read_pages", "write_pages", "gather_kv", "page_checksum",
    "HostPageTier",
    "ContinuousBatchingScheduler", "Request", "RequestStatus",
    "SchedulerConfig", "bucket_for", "pack_prefill_chunks",
    "ServingMetrics", "FleetMetrics",
    "FaultPlan", "FleetFaultPlan", "InjectedDeviceError", "ManualClock",
    "PageLeakError",
    "FleetRouter", "Replica", "ReplicaState",
    "MigrationBlob", "export_chain", "import_chain", "export_prefix",
    "import_prefix", "check_migration_conservation",
    "TenantClass", "TenantSpec", "TenantRegistry", "DEFAULT_CLASSES",
    "AdmissionLedger", "WeightedFairQueue", "AutoscalePolicy", "Autoscaler",
    "check_control_conservation", "SamplingParams", "accept_tokens", "next_token",
    "warp_probs", "Proposer", "NGramProposer", "DraftProposer",
]
