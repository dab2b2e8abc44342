"""Sequence parallelism: ring attention and Ulysses (the port of
``paddle_tpu/parallel/ring.py``).

Both take the rank's own sequence chunk: q, k, v (B, S/N, H, D) and
segment ids (B, S/N), chunk i of the sequence on the rank at coordinate
i of ``axis``, and return the rank's chunk of the output.

- :func:`ring_attention`: K/V (and their segment ids) go round the ring
  by send/recv (``batch_isend_irecv``), one hop a step; each step
  attends the local queries to the visiting chunk in f32 torch ops
  (``_chunk_attn``) and merges the partial softmax sums online
  (``_merge``).  Causal masking uses global positions.  The backward is
  autograd's through the ops and the hops' reverse sends.
- :func:`ulysses_attention`: two ``all_to_all_single`` calls swap the
  split from sequence to heads, each rank runs the port's
  ``flash_attention`` (the CUDA kernels on the card) over the whole
  sequence for H/N heads, and two more swap it back.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE,
                                            flash_attention)
from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.platform.enforce import enforce_that


def _chunk_attn(q, k, v, q_seg, k_seg, q_off: int, k_off: int,
                causal: bool, sm_scale: float):
    """One q chunk against one kv chunk: (acc (B,Sq,H,D), m, l (B,H,Sq)),
    offsets are the chunks' global token positions."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    mask = q_seg[:, None, :, None] == k_seg[:, None, None, :]
    if causal:
        q_ids = q_off + torch.arange(q.shape[1], device=q.device)
        k_ids = k_off + torch.arange(k.shape[1], device=q.device)
        mask = mask & (q_ids[None, None, :, None]
                       >= k_ids[None, None, None, :])
    s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return acc, m, l


def _merge(acc, m, l, acc2, m2, l2):
    m_new = torch.maximum(m, m2)
    a1 = torch.exp(m - m_new)
    a2 = torch.exp(m2 - m_new)
    l_new = l * a1 + l2 * a2
    acc_new = (acc * a1.transpose(1, 2)[..., None]
               + acc2 * a2.transpose(1, 2)[..., None])
    return acc_new, m_new, l_new


def ring_attention(q, k, v, mesh, axis: str = "seq", segment_ids=None,
                   causal: bool = False, sm_scale: Optional[float] = None):
    """Ring self-attention over sequence chunks (see the module doc)."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    n = mesh.axis_size(axis)
    idx = mesh.coord(axis)
    ranks = mesh.axis_ranks(axis)
    batch, local, heads, head_dim = q.shape
    if segment_ids is None:
        segment_ids = torch.zeros((batch, local), dtype=torch.int32,
                                  device=q.device)
    seg = segment_ids.to(torch.int32)
    q_off = idx * local
    acc = torch.zeros((batch, local, heads, head_dim), dtype=torch.float32,
                      device=q.device)
    m = torch.full((batch, heads, local), float("-inf"),
                   dtype=torch.float32, device=q.device)
    l = torch.zeros((batch, heads, local), dtype=torch.float32,
                    device=q.device)
    kc, vc, segc = k, v, seg
    perm = [(i, (i + 1) % n) for i in range(n)]
    for t in range(n):
        src = (idx - t) % n          # the rank this kv chunk came from
        acc2, m2, l2 = _chunk_attn(q, kc, vc, seg, segc, q_off, src * local,
                                   causal, sm_scale)
        acc, m, l = _merge(acc, m, l, acc2, m2, l2)
        if t < n - 1:
            kc = comm.ppermute(kc, ranks, perm)
            vc = comm.ppermute(vc, ranks, perm)
            segc = comm.ppermute(segc, ranks, perm)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _seq_to_heads(x, n: int, group):
    """(B, S/n, H, D) per rank -> (B, S, H/n, D): all-to-all over the
    head chunks."""
    b, s_loc, h, d = x.shape
    x = x.reshape(b, s_loc, n, h // n, d).permute(2, 0, 1, 3, 4)
    x = comm.all_to_all(x.contiguous(), group)   # [source seq chunk, ...]
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * s_loc, h // n, d)


def _heads_to_seq(x, n: int, group):
    """(B, S, H/n, D) per rank -> (B, S/n, H, D)."""
    b, s, h_loc, d = x.shape
    x = x.reshape(b, n, s // n, h_loc, d).permute(1, 0, 2, 3, 4)
    x = comm.all_to_all(x.contiguous(), group)   # [source head chunk, ...]
    return x.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h_loc, d)


def ulysses_attention(q, k, v, mesh, axis: str = "seq", segment_ids=None,
                      causal: bool = False, sm_scale: Optional[float] = None,
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None):
    """DeepSpeed-Ulysses sequence parallelism (see the module doc); the
    head count must divide by the axis size."""
    n = mesh.axis_size(axis)
    group = mesh.group(axis)
    batch, local, heads, _ = q.shape
    enforce_that(heads % n == 0,
                 f"heads {heads} must divide over {axis}={n}",
                 context="ulysses")
    if segment_ids is None:
        segment_ids = torch.zeros((batch, local), dtype=torch.int32,
                                  device=q.device)
    seg_full = comm.all_gather_dim(segment_ids.to(torch.int32), 1, group)
    qh = _seq_to_heads(q, n, group)
    kh = _seq_to_heads(k, n, group)
    vh = _seq_to_heads(v, n, group)
    out = flash_attention(qh, kh, vh, segment_ids=seg_full, causal=causal,
                          sm_scale=sm_scale, block_q=block_q,
                          block_k=block_k)
    return _heads_to_seq(out, n, group)
