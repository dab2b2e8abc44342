"""Ragged paged attention: ONE kernel for mixed prefill + decode (the
port of ``paddle_tpu/serving/decode_attention.py``).

The query batch is a flat ``[T, H, D]`` row stack: decode slots
contribute one row each, in-flight prefill chunks up to
``serving_prefill_chunk`` rows each.  A row->sequence map (``row_seq``)
and a per-row absolute position (``qpos``, -1 for padding) drive ONE
mask — token ``t`` is visible to the row at position ``p`` iff
``t <= p`` — which covers decode length masking, in-chunk causality and
cached-prefix offsets alike.  GQA: query head ``h`` reads KV head
``h // (H // H_kv)``.  int8 pools carry per-token, per-kv-head f32
scales and are dequantized as ``q * scale``.

Two implementations of the same function:

- :func:`ragged_paged_attention_kernel` launches the hand-written CUDA
  kernel ``csrc/ragged_paged_attention.cu`` (the Hopper counterpart of
  the Pallas ``_ragged_kernel``) at every head dim, any group and page
  size, f32 or bf16 queries: a plan of work items,
  persistent attention blocks over each sequence's tokens split into
  spans of :func:`kernel_split_tokens`, and a merge of the spans.  Head
  dims up to 256 run on kernels compiled at 16, 32, 64, 128 and 256, the
  columns past the head dim zero-filled as they are loaded; above 256 the
  attention blocks are the simple wide kernel, one block per row, head
  and span (above 512 one per row, head, span and chunk of 512 output
  columns).  The pool's rows are :func:`padded_head_dim` wide (the
  port's ``kv_cache`` allocates them so, the columns past the head dim
  zero), and a head dim that is not a multiple of 8 runs on q widened
  to that width: the pool is never copied.  It needs block-uniform
  packing: rows come in :data:`BLOCK_ROWS` blocks, each block one
  sequence's.
- :func:`ragged_paged_attention_reference` is the plain PyTorch version:
  page-table gather plus a masked softmax in f32.

:func:`ragged_paged_attention` dispatches by device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises — there
is no fallback that would hide the kernel on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import build
# the head dims the CUDA kernel takes are the flash kernels': every one,
# run at padded_head_dim (the next multiple of 8)
from paddle_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE,
                                            HEAD_DIM_LIMIT, KERNEL_WIDTHS,
                                            kernel_width, padded_head_dim,
                                            widen_head_dim)
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.serving.kv_cache import dequantize_kv, quantize_kv

BLOCK_ROWS = 8   # rows per kernel block; one sequence per block

# the int8 parity harness's logit-error bound (see the JAX package: the
# per-token amax/127 scheme lands well under 2% on gaussian K/V; 5%
# leaves slack without letting a broken quant path slip through)
QUANT_DRIFT_BOUND = 0.05

# tokens per online-softmax tile of the CUDA kernel (KT in the source): the
# tile whose running maximum P is rounded against on bf16 pages
KERNEL_TILE_TOKENS = 32
# the kernel splits each sequence's tokens into spans of at least this many
# tokens (a multiple of the tile), and into at most KERNEL_MAX_SPLITS spans
KERNEL_SPLIT_TOKENS = 128
KERNEL_MAX_SPLITS = 16

_PAGE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Dispatch gate
# ---------------------------------------------------------------------------

def kernel_shape_error(head_dim: int, num_heads: int,
                       num_kv_heads: int) -> Optional[str]:
    """None when the CUDA kernel takes these shapes, else why not (with
    the limit).  Any page size and any group G = num_heads / num_kv_heads
    work."""
    if head_dim < 1:
        return (f"ragged kernel takes head_dim {HEAD_DIM_LIMIT}, got "
                f"{head_dim}")
    if num_kv_heads < 1 or num_heads % num_kv_heads != 0:
        return (f"ragged kernel needs num_kv_heads dividing num_heads, got "
                f"num_heads={num_heads}, num_kv_heads={num_kv_heads}")
    return None


def kernel_split_tokens(max_tokens: int) -> int:
    """Tokens of one span of the CUDA kernel's split token axis, for a
    page table covering ``max_tokens`` (``Pm * page``) tokens: at least
    :data:`KERNEL_SPLIT_TOKENS`, a multiple of the tile, and few enough
    that at most :data:`KERNEL_MAX_SPLITS` spans cover the table."""
    per = -(-int(max_tokens) // KERNEL_MAX_SPLITS)
    per = -(-per // KERNEL_TILE_TOKENS) * KERNEL_TILE_TOKENS
    return max(KERNEL_SPLIT_TOKENS, per)


def attention_path(head_dim: int, page_size: int, *, num_heads: int,
                   num_kv_heads: int, device: DeviceLike = None,
                   use_kernel: Optional[bool] = None) -> str:
    """THE chooser of the row packing every paged-attention caller uses.
    Returns ``"kernel"`` (block-uniform :data:`BLOCK_ROWS` packing) or
    ``"reference"`` (compact rows).

    On the CPU the plain version computes either way; ``use_kernel=True``
    selects the kernel's packing so CPU runs cover it.  On CUDA the
    answer is always ``"kernel"``: ``use_kernel=False`` and shapes the
    kernel does not take raise, with the limit in the message."""
    enforce_that(page_size >= 1, "page_size must be positive",
                 context="serving")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "kernel" if use_kernel else "reference"
    enforce_that(use_kernel is not False,
                 "use_kernel=False on a CUDA device: the port serves "
                 "through the ragged CUDA kernel on the card (the plain "
                 "version runs for CPU tensors only)", context="serving")
    why = kernel_shape_error(head_dim, num_heads, num_kv_heads)
    enforce_that(why is None, str(why), context="serving")
    return "kernel"


# ---------------------------------------------------------------------------
# Plain version (CPU path, parity oracle)
# ---------------------------------------------------------------------------

def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     kv_lens, row_seq, qpos, *,
                                     k_scale=None, v_scale=None,
                                     sm_scale: Optional[float] = None,
                                     round_p_tile: Optional[int] = None,
                                     round_p_span: Optional[int] = None):
    """Gather-then-mask version of the ragged kernel.

    q: [T, H, D] (f32 or bf16); k_pages/v_pages: [num_pages, page, H_kv,
    D or :func:`padded_head_dim` (D)] (one layer's pool slice, columns
    past D zero; int8 with ``k_scale``/``v_scale`` [num_pages, page,
    H_kv]); page_table: [S, Pm]; kv_lens: [S] — valid
    cached tokens per sequence after this step's writes; row_seq: [T];
    qpos: [T] (-1 = padded row).  Returns [T, H, D] in q's dtype; scores
    and sums are f32.  Padded rows return an arbitrary finite value;
    callers never read them.

    ``round_p_tile`` mirrors a kernel's rounding on bf16 pages, which
    this version otherwise leaves out: the kernel takes the online
    softmax over tiles of this many tokens, casts each tile's
    unnormalised probabilities (against the running maximum) to bf16
    before the PV product and keeps the normaliser in f32
    (``p.astype(vb.dtype)`` of the TPU kernel, whose tile is the page;
    :data:`KERNEL_TILE_TOKENS` for the CUDA kernel).  ``round_p_span``
    restarts the running maximum every that many tokens, as the CUDA
    kernel's split token axis does (:func:`kernel_split_tokens`).  Neither
    changes anything for f32 or int8 pages."""
    t, h, d = q.shape
    _, page, kvh, _ = k_pages.shape
    pm = page_table.shape[1]
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    k_pages, v_pages = k_pages[..., :d], v_pages[..., :d]
    rs = row_seq.long()
    pt = page_table.long()[rs]                     # [T, Pm]
    k = k_pages[pt]                                # [T, Pm, page, KVH, D]
    v = v_pages[pt]
    if k_scale is not None:
        k = dequantize_kv(k, k_scale[pt])
        v = dequantize_kv(v, v_scale[pt])
    k = k.reshape(t, pm * page, kvh, d).float()
    v = v.reshape(t, pm * page, kvh, d).float()
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)   # GQA head replication
        v = v.repeat_interleave(h // kvh, dim=2)
    tok = torch.arange(pm * page, device=q.device)
    live = ((tok[None, :] <= qpos.long()[:, None]) &
            (tok[None, :] < kv_lens.long()[rs][:, None]))
    s = torch.einsum("thd,tkhd->thk", q.float(), k) * sm_scale
    s = torch.where(live[:, None, :], s,
                    torch.full_like(s, DEFAULT_MASK_VALUE))
    if round_p_tile and v_pages.dtype == torch.bfloat16:
        n, tile = s.shape[-1], int(round_p_tile)
        nt = -(-n // tile)
        tile_max = F.pad(s, (0, nt * tile - n), value=-math.inf).reshape(
            t, h, nt, tile).amax(dim=-1)
        per = -(-int(round_p_span) // tile) if round_p_span else nt
        ns = -(-nt // per)
        run = torch.cummax(F.pad(tile_max, (0, ns * per - nt),
                                 value=-math.inf).reshape(t, h, ns, per),
                           dim=-1).values.reshape(t, h, ns * per)[..., :nt]
        m_tok = run.repeat_interleave(tile, dim=-1)[..., :n]
        e = torch.exp(s - m_tok)             # P as each tile computes it
        w = torch.exp(m_tok - tile_max.amax(-1, keepdim=True))  # rescaling
        out = torch.einsum("thk,tkhd->thd",
                           e.to(torch.bfloat16).float() * w, v)
        out = out / (e * w).sum(dim=-1)[..., None]
    else:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("thk,tkhd->thd", p, v)
    return out.to(q.dtype)


_REF_ROW_BLOCK = 64   # plain-path row block: bounds the per-row K/V gather


def _ragged_reference_blocked(q, k_pages, v_pages, page_table, kv_lens,
                              row_seq, qpos, k_scale=None, v_scale=None,
                              sm_scale=None, block: int = _REF_ROW_BLOCK):
    """The plain version evaluated in row blocks: rows are independent,
    so the results are identical while the transient gather stays at
    ``block`` copies of a page chain instead of one per row."""
    outs = [ragged_paged_attention_reference(
        q[i:i + block], k_pages, v_pages, page_table, kv_lens,
        row_seq[i:i + block], qpos[i:i + block], k_scale=k_scale,
        v_scale=v_scale, sm_scale=sm_scale)
        for i in range(0, q.shape[0], block)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_RPA_SIGNATURES = {
    # q, k_pages, v_pages, k_scale, v_scale, page_table, kv_lens, row_seq,
    # qpos, out, ws_acc, ws_ml, plan, T, H, KVH, D, page, Pm, span, splits,
    # max_items, page dtype, q dtype, sm_scale, stream -> cudaError_t
    "rpa_launch": ([_VOIDP] * 13 + [_INT] * 11 + [ctypes.c_float, _VOIDP],
                   _INT),
    "rpa_error_string": ([_INT], ctypes.c_char_p),
}


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _kernel_args_error(q, k_pages, v_pages, page_table, kv_lens, row_seq,
                       qpos, k_scale, v_scale) -> Optional[str]:
    """None when the CUDA kernel takes these arguments, else why not (the
    message is built only then: the checks run on every launch)."""
    t, h, d = q.shape
    num_pages, page, kvh, dk = k_pages.shape
    dev = q.device
    if dev.type != "cuda":
        return f"the ragged kernel runs on CUDA tensors, got {dev}"
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("kv_lens", kv_lens),
                    ("row_seq", row_seq), ("qpos", qpos)):
        if x.device != dev:
            return f"{name} is on {x.device}, q on {dev}"
    if q.dtype not in _Q_DTYPE_CODE:
        return f"ragged kernel takes f32 or bf16 queries, got {q.dtype}"
    why = kernel_shape_error(d, h, kvh)
    if why is not None:
        return why
    if not (k_pages.dtype in _PAGE_DTYPE_CODE and
            v_pages.dtype == k_pages.dtype and
            v_pages.shape == k_pages.shape and dk == padded_head_dim(d)):
        return (f"pages must be matching f32/bf16/int8 [P, page, H_kv, "
                f"{padded_head_dim(d)}] (head_dim {d} padded to a "
                f"multiple of 8), got {k_pages.dtype} "
                f"{tuple(k_pages.shape)} and {v_pages.dtype} "
                f"{tuple(v_pages.shape)}")
    if t % BLOCK_ROWS:
        return (f"ragged kernel rows ({t}) must pack to BLOCK_ROWS "
                f"({BLOCK_ROWS})")
    if not (kv_lens.shape == page_table.shape[:1] and
            row_seq.shape == q.shape[:1] and qpos.shape == q.shape[:1]):
        return "kv_lens must be [S], row_seq and qpos [T]"
    quantized = k_pages.dtype == torch.int8
    if (k_scale is not None) != quantized or \
            (v_scale is not None) != quantized:
        return "int8 pages need k_scale and v_scale; float pages take none"
    for x in ((k_scale, v_scale) if quantized else ()):
        if not (x.dtype == torch.float32 and x.device == dev and
                tuple(x.shape) == (num_pages, page, kvh) and
                x.is_contiguous()):
            return "scales must be contiguous f32 [P, page, H_kv] on q's " \
                   "device"
    if not (q.is_contiguous() and k_pages.is_contiguous() and
            v_pages.is_contiguous()):
        return "q and pages must be contiguous"
    if (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        return ("q and pages must be 16-byte aligned (the kernel moves "
                "16-byte chunks)")
    return None


def ragged_paged_attention_kernel(q, k_pages, v_pages, page_table, kv_lens,
                                  row_seq, qpos, *, k_scale=None,
                                  v_scale=None,
                                  sm_scale: Optional[float] = None):
    """Launch ``csrc/ragged_paged_attention.cu`` on CUDA tensors (same
    arguments as :func:`ragged_paged_attention_reference`; q f32 or bf16,
    pages f32/bf16/int8 at :func:`padded_head_dim`, head_dim
    :data:`HEAD_DIM_LIMIT`; output in q's dtype).  bf16 queries on bf16 pages take bf16 tensor-core
    products; every other pairing computes in f32: items of more than 16
    score rows as 3xTF32 tensor-core products (about 22 bits of each f32
    product), decode-sized ones on the CUDA cores.  Requires block-uniform
    packing: ``T`` a
    multiple of :data:`BLOCK_ROWS` and each aligned block of rows one
    sequence's (the block reads its sequence as
    ``row_seq[blk * BLOCK_ROWS]``).  Raises on anything the kernel does
    not take.  Each launch adds one to
    ``ragged_paged_attention_kernel.launches``."""
    why = _kernel_args_error(q, k_pages, v_pages, page_table, kv_lens,
                             row_seq, qpos, k_scale, v_scale)
    if why is not None:
        raise EnforceError(why, context="serving")
    t, h, d = q.shape
    _, page, kvh, dp = k_pages.shape
    pm = page_table.shape[1]
    dev = q.device
    quantized = k_scale is not None
    if sm_scale is None:
        sm_scale = float(d) ** -0.5
    if dp != d:
        out = ragged_paged_attention_kernel(
            widen_head_dim(q, dp), k_pages, v_pages, page_table, kv_lens,
            row_seq, qpos, k_scale=k_scale, v_scale=v_scale,
            sm_scale=sm_scale)
        return out[..., :d].contiguous()
    pt, ln, rs, qp = (_i32(page_table), _i32(kv_lens), _i32(row_seq),
                      _i32(qpos))
    out = torch.empty_like(q)
    if t == 0:
        return out
    span = kernel_split_tokens(pm * page)
    splits = -(-(pm * page) // span)
    # one scratch tensor: the partials of the rows whose tokens take more
    # than one span ([splits, T, H, D] acc and [splits, T, H, 2] (m, l),
    # f32), then the plan (a run of r row blocks has at most
    # ceil(8 r G / 64) chunks of score rows, each at most `splits` items:
    # int4 items, then three counters)
    max_items = (t // BLOCK_ROWS) * (-(-(h // kvh) // 8) + 1) * splits
    n_acc, n_ml = splits * t * h * d, splits * t * h * 2
    scratch = torch.empty(n_acc + n_ml + 4 * max_items + 4,
                          dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    lib = build.load("ragged_paged_attention", _RPA_SIGNATURES)
    rc = lib.rpa_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        pt.data_ptr(), ln.data_ptr(), rs.data_ptr(), qp.data_ptr(),
        out.data_ptr(), base, base + 4 * n_acc, base + 4 * (n_acc + n_ml),
        t, h, kvh, d, page, pm, span, splits, max_items,
        _PAGE_DTYPE_CODE[k_pages.dtype], _Q_DTYPE_CODE[q.dtype],
        float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("ragged_paged_attention launch failed: "
                           + lib.rpa_error_string(rc).decode())
    ragged_paged_attention_kernel.launches += 1
    return out


ragged_paged_attention_kernel.launches = 0


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def ragged_paged_attention(q, k_pages, v_pages, page_table, kv_lens,
                           row_seq, qpos, *, k_scale=None, v_scale=None,
                           sm_scale: Optional[float] = None):
    """Ragged paged attention over a sequence-packed mixed batch (see
    :func:`ragged_paged_attention_reference` for shapes and semantics).
    CUDA tensors launch the kernel (block-uniform packing required) or
    raise; CPU tensors take the plain version, row-blocked."""
    if q.is_cuda:
        return ragged_paged_attention_kernel(
            q, k_pages, v_pages, page_table, kv_lens, row_seq, qpos,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)
    return _ragged_reference_blocked(
        q, k_pages, v_pages, page_table, kv_lens, row_seq, qpos,
        k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)


def quant_parity_error(q, k_pages, v_pages, page_table, kv_lens, row_seq,
                       qpos, *, sm_scale: Optional[float] = None) -> float:
    """Max relative error int8 quantization adds to ragged attention
    output: f32 pages vs the SAME pages int8-roundtripped through
    :func:`~kv_cache.quantize_kv`.  Padded rows are excluded."""
    out32 = ragged_paged_attention_reference(
        q, k_pages, v_pages, page_table, kv_lens, row_seq, qpos,
        sm_scale=sm_scale)
    kq, ks = quantize_kv(k_pages)
    vq, vs = quantize_kv(v_pages)
    out8 = ragged_paged_attention_reference(
        q, kq, vq, page_table, kv_lens, row_seq, qpos,
        k_scale=ks, v_scale=vs, sm_scale=sm_scale)
    real = qpos >= 0
    denom = max(float(out32[real].abs().max()), 1e-20)
    return float((out8[real] - out32[real]).abs().max()) / denom


def check_quant_drift(q, k_pages, v_pages, page_table, kv_lens, row_seq,
                      qpos, *, bound: float = QUANT_DRIFT_BOUND,
                      sm_scale: Optional[float] = None) -> float:
    """Assert the parity error stays under ``bound``; the failure message
    carries the literal ``QUANT-DRIFT`` tag."""
    err = quant_parity_error(q, k_pages, v_pages, page_table, kv_lens,
                             row_seq, qpos, sm_scale=sm_scale)
    if err > bound:
        raise AssertionError(
            f"QUANT-DRIFT: int8 KV parity error {err:.4f} exceeds the "
            f"logit-error bound {bound:.4f}")
    return err


# ---------------------------------------------------------------------------
# Decode-only view
# ---------------------------------------------------------------------------

def expand_decode_rows(q, qpos, rows_per_seq: int = 1):
    """Pad per-sequence decode rows to whole :data:`BLOCK_ROWS` blocks —
    THE one copy of the kernel's one-sequence-per-block packing for
    decode rows.  ``q`` is ``[B * rows_per_seq, H, D]`` sequence-major;
    returns ``(q_expanded, row_seq, qpos_expanded)`` with padding rows at
    qpos -1.  Callers slice results back by reshaping to
    ``[B, padded_rows, ...]`` and taking ``[:, :rows_per_seq]``."""
    rps = int(rows_per_seq)
    bt, h, d = q.shape
    b = bt // rps
    rbk = -(-rps // BLOCK_ROWS) * BLOCK_ROWS
    row_seq = torch.arange(b, dtype=torch.int32,
                           device=q.device).repeat_interleave(rbk)
    qpos = qpos.to(torch.int32)
    if rbk == rps:
        return q, row_seq, qpos
    pad = rbk - rps
    qe = torch.cat([q.reshape(b, rps, h, d),
                    q.new_zeros(b, pad, h, d)], dim=1).reshape(b * rbk, h, d)
    qp = torch.cat([qpos.reshape(b, rps),
                    qpos.new_full((b, pad), -1)], dim=1).reshape(b * rbk)
    return qe, row_seq, qp


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           sm_scale: Optional[float] = None,
                           k_scale=None, v_scale=None):
    """Decode-only attention: one row per sequence at position
    ``lengths - 1`` (q: [B, H, D]; lengths include the row's own K/V).
    CUDA tensors go through the ragged kernel with the decode packing of
    :func:`expand_decode_rows`; CPU tensors take the plain version."""
    lengths = lengths.to(torch.int32)
    if not q.is_cuda:
        row_seq = torch.arange(q.shape[0], dtype=torch.int32,
                               device=q.device)
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, lengths, row_seq, lengths - 1,
            k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)
    qe, row_seq, qpos = expand_decode_rows(q, lengths - 1)
    out = ragged_paged_attention_kernel(
        qe, k_pages, v_pages, page_table, lengths, row_seq, qpos,
        k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)
    return out[::BLOCK_ROWS]
