"""Normalization (the port of ``paddle_tpu/ops/norm.py``).

Batch norm is functional, as in the JAX package: :func:`batch_norm`
returns (y, new moving mean, new moving var) and leaves the moving
statistics it was given untouched, so the trainer threads them through
its state and commits them after a step.  On the card it is
``F.batch_norm`` (cuDNN or PyTorch's channels-last kernels) on the NHWC
map's channels-last view, handed copies of the moving statistics since it
updates its running buffers in place; on the host it is the JAX
package's formula, :func:`batch_norm_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """[N, ..., C] -> its [N, C, ...] view (no copy)."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               moving_mean: torch.Tensor, moving_var: torch.Tensor, *,
               train: bool, momentum: float = 0.9, eps: float = 1e-5,
               use_global_stats: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize over every axis but the last (channel) one; [N, C] or
    [N, H, W, C].  Batch statistics in f32, the biased variance to
    normalize and the unbiased one (n / (n - 1)) for the moving update
    ``new = momentum * old + (1 - momentum) * batch``; y in x's dtype."""
    if not x.is_cuda:
        return batch_norm_reference(x, gamma, beta, moving_mean, moving_var,
                                    train=train, momentum=momentum, eps=eps,
                                    use_global_stats=use_global_stats)
    use_batch_stats = train and not (use_global_stats or False)
    new_mean, new_var = moving_mean.clone(), moving_var.clone()
    # torch's momentum weighs the batch: 1 - the JAX package's fraction
    y = F.batch_norm(_channels_first(x), new_mean, new_var, gamma, beta,
                     training=use_batch_stats, momentum=1.0 - momentum,
                     eps=eps)
    y = y.permute(0, *range(2, y.dim()), 1)
    if not use_batch_stats:
        return y, moving_mean, moving_var
    return y, new_mean, new_var


def batch_norm_reference(x, gamma, beta, moving_mean, moving_var, *,
                         train: bool, momentum: float = 0.9,
                         eps: float = 1e-5,
                         use_global_stats: Optional[bool] = None):
    """The JAX package's batch norm (``ops/norm.py:21-72``): one pass of
    f32 sums about the moving mean as a pilot, the affine folded into a
    per-channel f32 scale and bias."""
    reduce_dims = tuple(range(x.dim() - 1))
    use_batch_stats = train and not (use_global_stats or False)
    n = x.numel() // x.shape[-1]
    if use_batch_stats:
        pilot = moving_mean.detach().float()
        d = x.float() - pilot
        s1 = d.sum(reduce_dims)
        s2 = d.square().sum(reduce_dims)
        mean = pilot + s1 / n
        var = torch.clamp(s2 / n - (s1 / n).square(), min=0.0)
        unbiased = var * (n / max(1, n - 1))
        new_mean = momentum * moving_mean + (1.0 - momentum) * mean.detach()
        new_var = momentum * moving_var + (1.0 - momentum) * unbiased.detach()
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    scale = torch.rsqrt(var + eps) * gamma.float()
    bias = beta.float() - mean * scale
    y = (x.float() * scale + bias).to(x.dtype)
    return y, new_mean, new_var


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-row normalization over the last axis: statistics in f32
    (population variance), output in the input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(),
                     eps)
    return y.to(x.dtype)


def cross_map_norm(x: torch.Tensor, size: int = 5, scale: float = 1e-4,
                   power: float = 0.75) -> torch.Tensor:
    """Local response normalization across channels, x [N, H, W, C]:
    ``x / (1 + scale * sum of x ** 2 over the channel window) ** power``,
    the window padded (size // 2, size - 1 - size // 2); in f32, cast back
    to x's dtype."""
    x32 = x.float()
    half = size // 2
    sq = F.pad(x32.square(), (half, size - 1 - half))
    c = x.shape[-1]
    acc = sq[..., 0:c]
    for i in range(1, size):
        acc = acc + sq[..., i:i + c]
    return (x32 / (1.0 + scale * acc).pow(power)).to(x.dtype)


def sum_to_one_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows scaled to sum 1."""
    return x / (x.sum(-1, keepdim=True) + eps)


def row_l2_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rows scaled to unit L2 norm."""
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + eps)
