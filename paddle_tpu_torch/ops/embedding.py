"""Table lookup (the port of ``paddle_tpu/ops/embedding.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: [V, D], ids: int [...].  Out-of-range ids clamp to the
    table, as in the JAX package."""
    return F.embedding(ids.long().clamp(0, table.shape[0] - 1), table)
