"""Normalization (the port of ``paddle_tpu/ops/norm.py:66-76``,
``layer_norm`` only; batch norm waits for the convnet slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-row normalization over the last axis: statistics in f32
    (population variance), output in the input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(),
                     eps)
    return y.to(x.dtype)
