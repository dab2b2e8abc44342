"""Blockwise (flash) attention — the port of ``paddle_tpu/ops/attention.py``.

Two implementations of each of the module's three functions:

- the hand-written CUDA kernels (:func:`flash_fwd_kernel`,
  :func:`flash_bwd_kv_kernel`, :func:`flash_bwd_dq_kernel`), the Hopper
  counterparts of the Pallas ``_flash_fwd_kernel``,
  ``_flash_bwd_kv_kernel`` and ``_flash_bwd_dq_kernel``, at every head
  dim (a head dim that is not a multiple of 8 runs on copies of q, k, v
  and dO widened with zero columns to :func:`padded_head_dim`; up to 512
  on the kernels compiled at :func:`kernel_width`, above it on the wide
  kernels, chunks of :data:`WIDE_CHUNK` columns) and any lengths.  bf16 at head dim
  64 or 128 on whole 64-row tiles runs on the tensor cores, all three as
  wgmma kernels fed by TMA (``csrc/flash_attention_sm90.cu``); every other
  shape, f32, and bf16 under ``attn_pv_f32`` run on the CUDA cores
  (``csrc/flash_attention.cu``); :func:`kernel_route` names the route;
- their plain PyTorch versions (:func:`flash_fwd_reference`,
  :func:`flash_bwd_kv_reference`, :func:`flash_bwd_dq_reference`): a loop
  over key blocks, as the JAX package's plain backward ``_flash_bwd`` is,
  so no more than one block of scores ever exists.

:func:`flash_attention` (the JAX signature) is a ``torch.autograd.Function``:
its forward runs the forward function and saves ``lse``; its backward
computes ``delta = rowsum(dO * O)`` in f32 with plain torch, as JAX does
outside its kernels, then the dK/dV and dQ functions.  A CPU tensor takes
the plain versions; a CUDA tensor launches the kernels or raises — there
is no fallback, and shapes the kernels do not take raise with the limit
in the message.

Rounding follows the JAX kernels (``_pv_operands``): with bf16 inputs the
softmax probabilities are rounded to bf16 before the PV and dV products
and dS before the dK and dQ products, unless ``FLAGS.attn_pv_f32``; all
sums are f32.  Both versions do so.

A row whose segment matches no key at all (never on the LM path, where
every token sees itself) is the one place the two differ: the plain
version, like JAX's plain ``mha_reference``, averages V over every key;
the kernels, like the Pallas ones, average over the keys of the tiles
they visit.  Its gradients are zero in both.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.platform.flags import FLAGS

# a finite "minus infinity": a fully masked softmax row degenerates to
# uniform instead of NaN, exactly as in the JAX package
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# what the CUDA kernels take: every head dim, f32 or bf16 (one type for q,
# k, v and dO), any lengths; the kernels run head dims that are multiples
# of 8 (others on inputs widened with zero columns to the next one), the
# CUDA-core ones compiled at KERNEL_WIDTHS, the one at the least width >=
# the head dim running it, its columns past the head dim zero, and head
# dims above the last width on the wide kernels, which stream the head dim
# in chunks of WIDE_CHUNK columns; the wgmma kernels take bf16 with P and
# dS rounded at WGMMA_HEAD_DIMS on lengths in whole KERNEL_TILE-row tiles
KERNEL_TILE = 64
KERNEL_WIDTHS = (16, 32, 64, 128, 256, 512)
WIDE_CHUNK = 512
HEAD_DIM_LIMIT = "of at least 1"
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q, k, v, segment_ids=None, kv_segment_ids=None,
                  causal: bool = False, sm_scale: Optional[float] = None):
    """Plain multi-head attention.

    q: (B, Sq, H, D); k, v: (B, Sk, H_kv, D); segment_ids: (B, Sq),
    kv_segment_ids: (B, Sk).  Returns (B, Sq, H, D) in q's dtype.

    GQA: with H_kv dividing H, query head h reads KV head h // (H // H_kv)
    — the heads are replicated here, so this stays the oracle for the
    serving kernel's head-group packing."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    mask = None
    if segment_ids is not None:
        kv_seg = segment_ids if kv_segment_ids is None else kv_segment_ids
        mask = segment_ids[:, None, :, None] == kv_seg[:, None, None, :]
    if causal:
        cm = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                        device=q.device).tril()[None, None]
        mask = cm if mask is None else (mask & cm)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, parity oracle of the kernels)
# ---------------------------------------------------------------------------

def _pv_round(x, dtype, pv_f32: bool):
    """P or dS as the product that takes it sees it: rounded to the input
    dtype unless ``pv_f32`` (JAX ``_pv_operands``)."""
    if pv_f32 or dtype == torch.float32:
        return x
    return x.to(dtype).float()


def _key_blocks(seq_k: int, block_k: Optional[int], head_dim: int):
    """Key blocks of ``block_k`` (default :func:`kernel_tile`), the last
    one shorter where it does not divide ``seq_k``, as the kernels' last
    tile."""
    if block_k is None:
        block_k = kernel_tile(head_dim)
    bk = min(int(block_k), seq_k)
    return [(j, min(j + bk, seq_k)) for j in range(0, seq_k, bk)]


def _block_mask(q_seg, kv_seg, j0, j1, causal):
    """[B, 1, Sq, bk] live mask of key block [j0, j1)."""
    mask = q_seg[:, None, :, None] == kv_seg[:, None, None, j0:j1]
    if causal:
        qi = torch.arange(q_seg.shape[1], device=q_seg.device)
        kj = torch.arange(j0, j1, device=q_seg.device)
        mask = mask & (qi[:, None] >= kj[None, :])
    return mask


@torch.no_grad()
def flash_fwd_reference(q, k, v, q_seg, kv_seg, *, causal: bool,
                        sm_scale: float, block_k: Optional[int] = None,
                        pv_f32: bool = False) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Plain forward: (O [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32).

    Online softmax over key blocks of ``block_k``: scores in f32, masked
    scores at :data:`DEFAULT_MASK_VALUE`, P rounded before PV as the
    kernel does.  ``block_k`` defaults to the kernels' tile
    (:func:`kernel_tile`), where the running maxima and so the rounded P
    are the CUDA kernels'."""
    dt = q.dtype
    qf = q.float().transpose(1, 2)                       # [B, H, Sq, D]
    b, h, sq, d = qf.shape
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for j0, j1 in _key_blocks(k.shape[1], block_k, q.shape[-1]):
        kb = k[:, j0:j1].float().transpose(1, 2)
        vb = v[:, j0:j1].float().transpose(1, 2)
        s = torch.matmul(qf, kb.transpose(-1, -2)) * sm_scale
        s = torch.where(_block_mask(q_seg, kv_seg, j0, j1, causal), s,
                        torch.full_like(s, DEFAULT_MASK_VALUE))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            _pv_round(p, dt, pv_f32), vb)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).transpose(1, 2).to(dt)
    return out.contiguous(), (m + torch.log(l)).contiguous()


def _bwd_block(qf, kb, vb, dof, lse, delta, mask, sm_scale):
    """Recompute one key block's P and dS ([B, H, Sq, bk], f32)."""
    s = torch.matmul(qf, kb.transpose(-1, -2)) * sm_scale
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.matmul(dof, vb.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds


@torch.no_grad()
def flash_bwd_kv_reference(q, k, v, q_seg, kv_seg, dout, lse, delta, *,
                           causal: bool, sm_scale: float,
                           block_k: Optional[int] = None,
                           pv_f32: bool = False):
    """Plain dK/dV ([B, Sk, H, D] in k's and v's dtypes), block by block
    over keys: dV = round(P)^T dO, dK = round(dS)^T Q."""
    dt = q.dtype
    qf = q.float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    dks, dvs = [], []
    for j0, j1 in _key_blocks(k.shape[1], block_k, q.shape[-1]):
        kb = k[:, j0:j1].float().transpose(1, 2)
        vb = v[:, j0:j1].float().transpose(1, 2)
        p, ds = _bwd_block(qf, kb, vb, dof, lse, delta,
                           _block_mask(q_seg, kv_seg, j0, j1, causal),
                           sm_scale)
        dvs.append(torch.matmul(_pv_round(p, dt, pv_f32).transpose(-1, -2),
                                dof))
        dks.append(torch.matmul(_pv_round(ds, dt, pv_f32).transpose(-1, -2),
                                qf))
    dk = torch.cat(dks, dim=2).transpose(1, 2).to(k.dtype)
    dv = torch.cat(dvs, dim=2).transpose(1, 2).to(v.dtype)
    return dk.contiguous(), dv.contiguous()


@torch.no_grad()
def flash_bwd_dq_reference(q, k, v, q_seg, kv_seg, dout, lse, delta, *,
                           causal: bool, sm_scale: float,
                           block_k: Optional[int] = None,
                           pv_f32: bool = False):
    """Plain dQ ([B, Sq, H, D] in q's dtype), summed over key blocks:
    dQ = sum round(dS) K."""
    dt = q.dtype
    qf = q.float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    dq = torch.zeros_like(qf)
    for j0, j1 in _key_blocks(k.shape[1], block_k, q.shape[-1]):
        kb = k[:, j0:j1].float().transpose(1, 2)
        vb = v[:, j0:j1].float().transpose(1, 2)
        _, ds = _bwd_block(qf, kb, vb, dof, lse, delta,
                           _block_mask(q_seg, kv_seg, j0, j1, causal),
                           sm_scale)
        dq = dq + torch.matmul(_pv_round(ds, dt, pv_f32), kb)
    return dq.transpose(1, 2).to(dt).contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    # q k v qrange krange qseg kseg o lse | B Sq Sk H D dtype causal pv_f32
    "flash_fwd": ([_VOIDP] * 9 + [_INT] * 8 + [ctypes.c_float, _VOIDP],
                  _INT),
    # q k v dout lse delta qrange krange qseg kseg dk dv | ...
    "flash_bwd_kv": ([_VOIDP] * 12 + [_INT] * 8 + [ctypes.c_float, _VOIDP],
                     _INT),
    # q k v dout lse delta qrange krange qseg kseg dq | ...
    "flash_bwd_dq": ([_VOIDP] * 11 + [_INT] * 8 + [ctypes.c_float, _VOIDP],
                     _INT),
    "flash_error_string": ([_INT], ctypes.c_char_p),
}


def kernel_shape_error(q_shape, k_shape, dtype) -> Optional[str]:
    """None when the CUDA kernels take these shapes and dtype, else why
    not (with the limit)."""
    b, sq, h, d = q_shape
    if dtype not in _DTYPE_CODE:
        return f"flash kernels take float32 or bfloat16, got {dtype}"
    if d < 1:
        return f"flash kernels take head_dim {HEAD_DIM_LIMIT}, got {d}"
    if k_shape[0] != b or k_shape[2] != h or k_shape[3] != d:
        return (f"k/v must be [B, Sk, H, D] matching q {tuple(q_shape)}, got "
                f"{tuple(k_shape)} (the flash kernels take no GQA)")
    if sq <= 0 or k_shape[1] <= 0:
        return f"flash kernels take positive lengths, got Sq={sq}, " \
               f"Sk={k_shape[1]}"
    if h > 65535 or b > 65535:
        return f"flash kernels take at most 65535 heads and batches"
    return None


def kernel_route(q_shape, k_shape, dtype, pv_f32: bool) -> str:
    """The one library each shape goes to: ``"flash_attention_sm90"`` (the
    wgmma kernels) for bf16 with P and dS rounded at head dim 64 or 128
    with Sq and Sk in whole :data:`KERNEL_TILE`-row tiles; else
    ``"flash_attention"`` (the CUDA-core kernels: f32, ``pv_f32``, every
    other head dim, and lengths that end in a partial tile).  Both export
    the same C entries."""
    if (dtype == torch.bfloat16 and not pv_f32 and
            q_shape[3] in WGMMA_HEAD_DIMS and
            q_shape[1] % KERNEL_TILE == 0 and k_shape[1] % KERNEL_TILE == 0):
        return "flash_attention_sm90"
    return "flash_attention"


def padded_head_dim(head_dim: int) -> int:
    """The head dim the kernels run ``head_dim`` at: the next multiple of
    8 (rows of 16 bytes in f32, 8 in bf16), the columns past ``head_dim``
    zero.  Zero columns of q and k add nothing to q.k, those of v give
    output columns that are cut off; the scale stays the true head
    dim's."""
    return -(-int(head_dim) // 8) * 8


def kernel_width(head_dim: int) -> Optional[int]:
    """The compiled width of the CUDA-core kernel that runs ``head_dim``
    (the least of :data:`KERNEL_WIDTHS` not below it), or None for a head
    dim no compiled width takes: below 1, or above the last width, where
    the wide kernels run it in chunks of :data:`WIDE_CHUNK` columns."""
    if not 1 <= head_dim <= KERNEL_WIDTHS[-1]:
        return None
    return next(w for w in KERNEL_WIDTHS if w >= head_dim)


def kernel_tile(head_dim: int) -> int:
    """Rows of the kernels' query and key tiles at ``head_dim``: 64, 32
    above 128 and 16 above 256, where the CUDA-core kernels run at widths
    256 and 512 and the wide kernels in chunks of 512 (four f32 tiles of
    256 columns fit shared memory at 32 rows, of 512 at 16).  The plain versions round P and dS at the
    kernels' running maxima with ``block_k`` set to it."""
    if head_dim > 256:
        return 16
    return 32 if head_dim > 128 else KERNEL_TILE


def widen_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns appended to ``width`` (itself if it has
    them)."""
    pad = width - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _check(tensors, q, k, seg_q, seg_k):
    dev = q.device
    enforce_that(dev.type == "cuda", "the flash kernels run on CUDA tensors, "
                 f"got {dev}", context="flash_attention")
    why = kernel_shape_error(tuple(q.shape), tuple(k.shape), q.dtype)
    enforce_that(why is None, str(why), context="flash_attention")
    for name, x in tensors.items():
        enforce_that(x.device == dev and x.is_contiguous(),
                     f"{name} must be contiguous on {dev}",
                     context="flash_attention")
        enforce_that(x.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                     "aligned (the kernels move 8- and 16-byte words)",
                     context="flash_attention")
    for name, x, n in (("q_seg", seg_q, q.shape[1]),
                       ("kv_seg", seg_k, k.shape[1])):
        enforce_that(x.dtype == torch.int32 and tuple(x.shape) ==
                     (q.shape[0], n) and x.device == dev and
                     x.is_contiguous(), f"{name} must be contiguous int32 "
                     f"[{q.shape[0]}, {n}] on {dev}",
                     context="flash_attention")


def _tile_ranges(seg, tile: int = KERNEL_TILE):
    """Per-tile [min, max] of the segment ids, [B, ceil(S / tile), 2]
    int32 (a last partial tile over its own ids only): the kernels skip a
    (query tile, key tile) pair whose ranges are disjoint (JAX
    ``_seg_live``)."""
    pad = -seg.shape[1] % tile
    if pad:
        seg = torch.cat([seg, seg[:, -1:].expand(-1, pad)], dim=1)
    t = seg.reshape(seg.shape[0], -1, tile)
    return torch.stack([t.amin(-1), t.amax(-1)], -1).to(
        torch.int32).contiguous()


# how the kernels treat a (query tile, key tile) pair
PAIR_SKIPPED, PAIR_INTERIOR, PAIR_BOUNDARY = 0, 1, 2


def tile_pair_kinds(q_seg, kv_seg, causal: bool,
                    tile: int = KERNEL_TILE) -> torch.Tensor:
    """[B, Sq / tile, Sk / tile] int8: how every flash kernel treats each
    (query tile, key tile) pair of ``tile`` rows (the kernels' tile is
    :func:`kernel_tile`).  Skipped:
    the segment-id ranges are disjoint, or under ``causal`` the key tile
    lies past the query tile's diagonal.  Interior: one segment on both
    sides and, under ``causal``, the key tile wholly below the diagonal,
    so every pair is live and the wgmma kernels build no mask.  Boundary:
    the rest, masked element by element.  This is the rule of
    ``pair_live`` and ``pair_interior`` in ``csrc/flash_attention_sm90.cu``
    written out for tests and records; the kernels compute it themselves
    from the per-tile ranges."""
    qr = _tile_ranges(q_seg, tile)[:, :, None]       # [B, nqt, 1, 2]
    kr = _tile_ranges(kv_seg, tile)[:, None]         # [B, 1, nkt, 2]
    live = (qr[..., 1] >= kr[..., 0]) & (qr[..., 0] <= kr[..., 1])
    interior = ((qr[..., 0] == qr[..., 1]) & (kr[..., 0] == kr[..., 1]) &
                (qr[..., 0] == kr[..., 0]))
    if causal:
        qt = torch.arange(qr.shape[1], device=q_seg.device)[:, None]
        kt = torch.arange(kr.shape[2], device=q_seg.device)[None, :]
        live = live & (kt <= qt)
        interior = interior & (kt < qt)
    kinds = torch.full(live.shape, PAIR_SKIPPED, dtype=torch.int8,
                       device=q_seg.device)
    kinds[live] = PAIR_BOUNDARY
    kinds[live & interior] = PAIR_INTERIOR
    return kinds


def _library(q, k, pv_f32: bool):
    """The built library a launch goes to (:func:`kernel_route`)."""
    return build.load(kernel_route(tuple(q.shape), tuple(k.shape), q.dtype,
                                   pv_f32), _SIGNATURES)


def _ranges(q, q_seg, kv_seg):
    """Both segment-id range arrays at the kernels' tile."""
    tile = kernel_tile(q.shape[3])
    return _tile_ranges(q_seg, tile), _tile_ranges(kv_seg, tile)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.flash_error_string(rc).decode())


def _geometry(q, k, causal, pv_f32, sm_scale):
    b, sq, h, d = q.shape
    return [b, sq, k.shape[1], h, d, _DTYPE_CODE[q.dtype], int(causal),
            int(pv_f32), float(sm_scale), _stream(q.device)]


def flash_fwd_kernel(q, k, v, q_seg, kv_seg, *, causal: bool,
                     sm_scale: float, pv_f32: bool = False):
    """Launch the forward kernel on CUDA tensors; same arguments and
    results as :func:`flash_fwd_reference`.  Each launch adds one to
    ``flash_fwd_kernel.launches``."""
    _check({"q": q, "k": k, "v": v}, q, k, q_seg, kv_seg)
    enforce_that(k.dtype == q.dtype and v.dtype == q.dtype and
                 v.shape == k.shape, "q, k, v must share one dtype and k, v "
                 "one shape", context="flash_attention")
    d = q.shape[3]
    if d % 8:
        dp = padded_head_dim(d)
        out, lse = flash_fwd_kernel(
            *(widen_head_dim(x, dp) for x in (q, k, v)), q_seg, kv_seg,
            causal=causal, sm_scale=sm_scale, pv_f32=pv_f32)
        return out[..., :d].contiguous(), lse
    lib = _library(q, k, pv_f32)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # the ranges stay referenced until the launch: a freed block could be
    # handed to the next allocation before the kernel reads it
    qr, kr = _ranges(q, q_seg, kv_seg)
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       qr.data_ptr(), kr.data_ptr(), q_seg.data_ptr(),
                       kv_seg.data_ptr(), out.data_ptr(), lse.data_ptr(),
                       *_geometry(q, k, causal, pv_f32, sm_scale))
    _raise_on(lib, rc, "flash_fwd")
    flash_fwd_kernel.launches += 1
    return out, lse


def _check_bwd(q, k, v, q_seg, kv_seg, dout, lse, delta):
    _check({"q": q, "k": k, "v": v, "dout": dout, "lse": lse,
            "delta": delta}, q, k, q_seg, kv_seg)
    enforce_that(k.dtype == q.dtype and v.dtype == q.dtype and
                 dout.dtype == q.dtype and v.shape == k.shape and
                 dout.shape == q.shape, "q, k, v, dout must share one dtype, "
                 "k and v one shape, dout q's", context="flash_attention")
    b, sq, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        enforce_that(x.dtype == torch.float32 and
                     tuple(x.shape) == (b, h, sq),
                     f"{name} must be f32 [{b}, {h}, {sq}]",
                     context="flash_attention")


def flash_bwd_kv_kernel(q, k, v, q_seg, kv_seg, dout, lse, delta, *,
                        causal: bool, sm_scale: float, pv_f32: bool = False):
    """Launch the dK/dV kernel on CUDA tensors; same arguments and
    results as :func:`flash_bwd_kv_reference`.  Each launch adds one to
    ``flash_bwd_kv_kernel.launches``."""
    _check_bwd(q, k, v, q_seg, kv_seg, dout, lse, delta)
    d = q.shape[3]
    if d % 8:
        dp = padded_head_dim(d)
        dk, dv = flash_bwd_kv_kernel(
            *(widen_head_dim(x, dp) for x in (q, k, v)), q_seg, kv_seg,
            widen_head_dim(dout, dp), lse, delta, causal=causal,
            sm_scale=sm_scale, pv_f32=pv_f32)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    lib = _library(q, k, pv_f32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    qr, kr = _ranges(q, q_seg, kv_seg)
    rc = lib.flash_bwd_kv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          qr.data_ptr(), kr.data_ptr(), q_seg.data_ptr(),
                          kv_seg.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          *_geometry(q, k, causal, pv_f32, sm_scale))
    _raise_on(lib, rc, "flash_bwd_kv")
    flash_bwd_kv_kernel.launches += 1
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, q_seg, kv_seg, dout, lse, delta, *,
                        causal: bool, sm_scale: float, pv_f32: bool = False):
    """Launch the dQ kernel on CUDA tensors; same arguments and results
    as :func:`flash_bwd_dq_reference`.  Each launch adds one to
    ``flash_bwd_dq_kernel.launches``."""
    _check_bwd(q, k, v, q_seg, kv_seg, dout, lse, delta)
    d = q.shape[3]
    if d % 8:
        dp = padded_head_dim(d)
        dq = flash_bwd_dq_kernel(
            *(widen_head_dim(x, dp) for x in (q, k, v)), q_seg, kv_seg,
            widen_head_dim(dout, dp), lse, delta, causal=causal,
            sm_scale=sm_scale, pv_f32=pv_f32)
        return dq[..., :d].contiguous()
    lib = _library(q, k, pv_f32)
    dq = torch.empty_like(q)
    qr, kr = _ranges(q, q_seg, kv_seg)
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          qr.data_ptr(), kr.data_ptr(), q_seg.data_ptr(),
                          kv_seg.data_ptr(), dq.data_ptr(),
                          *_geometry(q, k, causal, pv_f32, sm_scale))
    _raise_on(lib, rc, "flash_bwd_dq")
    flash_bwd_dq_kernel.launches += 1
    return dq


flash_fwd_kernel.launches = 0
flash_bwd_kv_kernel.launches = 0
flash_bwd_dq_kernel.launches = 0


def attention_delta(out, dout):
    """``delta = rowsum(dO * O)`` in f32, [B, H, Sq] (computed outside the
    kernels, as JAX does)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: forward saves (q, k, v, segments, O, lse);
    backward recomputes P blockwise in the dK/dV and dQ functions.
    ``plain`` picks the plain versions, else the CUDA kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sm_scale, block_k,
                pv_f32, plain):
        cfg = dict(causal=causal, sm_scale=sm_scale, pv_f32=pv_f32)
        if plain:
            out, lse = flash_fwd_reference(q, k, v, q_seg, kv_seg,
                                           block_k=block_k, **cfg)
        else:
            out, lse = flash_fwd_kernel(q, k, v, q_seg, kv_seg, **cfg)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.cfg = cfg
        ctx.block_k = block_k
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        args = (q, k, v, q_seg, kv_seg, dout, lse, attention_delta(out, dout))
        if ctx.plain:
            dk, dv = flash_bwd_kv_reference(*args, block_k=ctx.block_k,
                                            **ctx.cfg)
            dq = flash_bwd_dq_reference(*args, block_k=ctx.block_k,
                                        **ctx.cfg)
        else:
            dk, dv = flash_bwd_kv_kernel(*args, **ctx.cfg)
            dq = flash_bwd_dq_kernel(*args, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None, None


def _auto_block(seq: int) -> int:
    """JAX's default tile edge: the flag's edge, else the largest of
    512/256/128 dividing the sequence (clamped to it by the caller).  It
    sets the plain version's key block; the kernels keep their own."""
    preferred = (int(FLAGS.attn_block),) if FLAGS.attn_block else ()
    for edge in preferred + (512, 256, 128):
        if seq % edge == 0:
            return edge
    return 128


def _apply(plain, q, k, v, segment_ids, kv_segment_ids, causal, sm_scale,
           block_k):
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    # one dtype for q, k, v (the kernels take their operands as they are)
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if block_k is None:
        block_k = _auto_block(k.shape[1])
    b, sq = q.shape[0], q.shape[1]
    if segment_ids is None:
        q_seg = torch.zeros((b, sq), dtype=torch.int32, device=q.device)
        kv_seg = torch.zeros((b, k.shape[1]), dtype=torch.int32,
                             device=q.device)
    else:
        q_seg = segment_ids.to(torch.int32).contiguous()
        kv_seg = (q_seg if kv_segment_ids is None
                  else kv_segment_ids.to(torch.int32).contiguous())
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), q_seg, kv_seg, bool(causal),
                                 float(sm_scale), int(block_k),
                                 bool(FLAGS.attn_pv_f32), bool(plain))


def flash_attention(q, k, v, segment_ids=None, kv_segment_ids=None,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None):
    """Blockwise multi-head attention with a flash backward.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D).  segment_ids: (B, Sq) int
    packed-sequence ids — tokens attend only within their own segment;
    None means full attention.  kv_segment_ids: (B, Sk), default
    segment_ids.  causal: lower-triangular masking on absolute positions
    in the packed buffer.  ``block_q``/``block_k`` keep the JAX signature
    and set the plain version's key block; the CUDA kernels tile at
    :func:`kernel_tile`.  ``FLAGS.attn_pv_f32`` keeps P and dS in f32.

    CPU tensors take the plain versions; CUDA tensors launch the three
    kernels or raise."""
    del block_q   # the plain version loops over key blocks only
    return _apply(not q.is_cuda, q, k, v, segment_ids, kv_segment_ids,
                  causal, sm_scale, block_k)


def flash_attention_reference(q, k, v, segment_ids=None,
                              kv_segment_ids=None, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              block_k: Optional[int] = None):
    """:func:`flash_attention` through the plain versions on any device:
    the oracle the card's kernel path is held against.  The port's layers
    never call it."""
    return _apply(True, q, k, v, segment_ids, kv_segment_ids, causal,
                  sm_scale, block_k)
