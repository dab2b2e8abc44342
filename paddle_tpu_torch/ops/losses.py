"""Losses (the port of ``paddle_tpu/ops/losses.py:23-33``,
``softmax_cross_entropy`` only so far)."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``logsumexp(logits) - logits[label]``, always in f32 (a
    bf16 logsumexp over a 32k vocabulary loses the loss's low bits)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - picked
