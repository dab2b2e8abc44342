"""Losses (the port of ``paddle_tpu/ops/losses.py:23-55``:
``softmax_cross_entropy``, ``sigmoid_cross_entropy_with_logits`` and
``multi_binary_label_cross_entropy``)."""

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


def sigmoid_cross_entropy_with_logits(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``max(x, 0) - x y + log1p(exp(-|x|))`` (the stable
    form), summed over the last dim, in the logits' dtype."""
    loss = (torch.clamp(logits, min=0) - logits * labels +
            torch.log1p(torch.exp(-logits.abs())))
    return loss.sum(dim=-1)


def multi_binary_label_cross_entropy(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    return sigmoid_cross_entropy_with_logits(logits, labels)
