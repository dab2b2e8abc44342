"""Plain multi-head attention — the oracle half of
``paddle_tpu/ops/attention.py`` (``DEFAULT_MASK_VALUE`` and
``mha_reference``).  The flash-attention kernels of that module belong to
the training slice and are not ported yet."""

from __future__ import annotations

from typing import Optional

import torch

# a finite "minus infinity": a fully masked softmax row degenerates to
# uniform instead of NaN, exactly as in the JAX package
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


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
