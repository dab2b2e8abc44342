"""paddle_tpu_torch.serving — paged-KV continuous-batching inference on
PyTorch/CUDA: block-paged KV storage (``kv_cache``), the ragged paged
attention kernel and its plain version (``decode_attention``), the
continuous-batching scheduler (``scheduler``), token choice
(``speculate``) and the user-facing :class:`ServingEngine` (``engine``).
"""

from paddle_tpu_torch.serving.decode_attention import (
    BLOCK_ROWS, QUANT_DRIFT_BOUND, attention_path, check_quant_drift,
    expand_decode_rows, paged_decode_attention, quant_parity_error,
    ragged_paged_attention, ragged_paged_attention_kernel,
    ragged_paged_attention_reference)
from paddle_tpu_torch.serving.engine import (DecoderLM, ServingEngine,
                                             greedy_decode_reference,
                                             reference_logits)
from paddle_tpu_torch.serving.faults import (InjectedDeviceError,
                                             ManualClock, PageLeakError)
from paddle_tpu_torch.serving.kv_cache import (NULL_PAGE, KVPages,
                                               PagedKVConfig, PagePool,
                                               PrefixCache, append_token,
                                               dequantize_kv, fork_page,
                                               init_kv_pages,
                                               pages_for_budget,
                                               pages_spanned,
                                               prefix_chain_hashes,
                                               quantize_kv, resolve_kv_dtype,
                                               write_prompt, zero_pages)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                                Request, RequestStatus,
                                                SchedulerConfig, bucket_for,
                                                pack_prefill_chunks)
from paddle_tpu_torch.serving.speculate import (SamplingParams,
                                                accept_tokens, next_token,
                                                warp_probs)

__all__ = [
    "ServingEngine", "DecoderLM", "greedy_decode_reference",
    "reference_logits",
    "ragged_paged_attention", "ragged_paged_attention_kernel",
    "ragged_paged_attention_reference", "paged_decode_attention",
    "attention_path", "expand_decode_rows", "BLOCK_ROWS",
    "QUANT_DRIFT_BOUND", "quant_parity_error", "check_quant_drift",
    "PagedKVConfig", "KVPages", "PagePool", "PrefixCache", "NULL_PAGE",
    "init_kv_pages", "append_token", "write_prompt", "zero_pages",
    "fork_page", "pages_spanned", "prefix_chain_hashes", "quantize_kv",
    "dequantize_kv", "pages_for_budget", "resolve_kv_dtype",
    "ContinuousBatchingScheduler", "Request", "RequestStatus",
    "SchedulerConfig", "bucket_for", "pack_prefill_chunks",
    "ServingMetrics", "InjectedDeviceError", "ManualClock",
    "PageLeakError", "SamplingParams", "accept_tokens", "next_token",
    "warp_probs",
]
