"""Pooling (the port of ``paddle_tpu/ops/pool.py``).

Maps are NHWC; the torch pooling functions get the map's NCHW view, a
``channels_last`` tensor, so no map is transposed (average pooling with
padding pads a copy: see :func:`avg_pool2d`).  Output sizes are floor
mode, max pooling pads with -inf, and average pooling sums in f32 and
leaves padding out of the count only where there is padding, as in the
JAX package.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _geometry(window, stride, padding):
    k = _pair(window)
    s = _pair(stride if stride is not None else window)
    p = _pair(padding)
    return k, s, p


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, window: IntOr2, stride: IntOr2 = None,
               padding: IntOr2 = 0) -> torch.Tensor:
    """x: [N, H, W, C]."""
    k, s, p = _geometry(window, stride, padding)
    xc = _nchw(x)
    if p[0] > k[0] // 2 or p[1] > k[1] // 2:
        # torch pads at most half a window; pad with -inf explicitly
        xc = F.pad(xc, (p[1], p[1], p[0], p[0]), value=float("-inf"))
        p = (0, 0)
    return _nhwc(F.max_pool2d(xc, k, s, p))


def avg_pool2d(x: torch.Tensor, window: IntOr2, stride: IntOr2 = None,
               padding: IntOr2 = 0, *,
               exclude_padding: bool = True) -> torch.Tensor:
    """Mean over each window, summed in f32 and cast back to x's dtype;
    with padding, ``exclude_padding`` divides by the window's cells inside
    the map.  The padding is explicit zeros, the pool itself unpadded:
    PyTorch 2.11's CUDA average pool computes wrong gradients for a
    channels-last map it pads itself (either ``count_include_pad``)."""
    k, s, p = _geometry(window, stride, padding)
    pad = (0, 0, p[1], p[1], p[0], p[0])
    xf = F.pad(x.float(), pad) if p[0] or p[1] else x.float()
    y = F.avg_pool2d(_nchw(xf), k, s)
    if exclude_padding and (p[0] or p[1]):
        # the share of each window's cells that lie inside the map
        inside = F.pad(torch.ones((1, x.shape[1], x.shape[2], 1),
                                  dtype=xf.dtype, device=x.device), pad)
        y = y / F.avg_pool2d(_nchw(inside), k, s)
    return _nhwc(y).to(x.dtype)


def max_pool2d_with_index(x: torch.Tensor, window: IntOr2,
                          stride: IntOr2 = None, padding: IntOr2 = 0):
    """(pooled, int32 flat index h * W + w of each window's maximum within
    its source map)."""
    k, s, p = _geometry(window, stride, padding)
    vals, idx = F.max_pool2d(_nchw(x), k, s, p, return_indices=True)
    return _nhwc(vals), _nhwc(idx).to(torch.int32)


def spatial_pyramid_pool(x: torch.Tensor, pyramid_height: int,
                         pool_type: str = "max") -> torch.Tensor:
    """Concatenated bins at scales 1, 2, 4, ...: x [N, H, W, C] -> [N,
    sum(4 ** level) * C]; each level pads H and W up to a multiple of its
    bin count (-inf for max, left out of the count for avg)."""
    n, h, w, c = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        hh = -(-h // bins) * bins
        ww = -(-w // bins) * bins
        grid = (n, bins, hh // bins, bins, ww // bins, c)
        if pool_type == "max":
            xp = F.pad(x, (0, 0, 0, ww - w, 0, hh - h), value=float("-inf"))
            r = xp.reshape(grid).amax((2, 4))
        else:
            xp = F.pad(x.float(), (0, 0, 0, ww - w, 0, hh - h))
            cnt = F.pad(torch.ones((1, h, w, 1), device=x.device),
                        (0, 0, 0, ww - w, 0, hh - h))
            total = xp.reshape(grid).sum((2, 4))
            d = cnt.reshape(1, bins, hh // bins, bins, ww // bins, 1).sum(
                (2, 4))
            r = (total / d).to(x.dtype)
        outs.append(r.reshape(n, -1))
    return torch.cat(outs, dim=-1)


def maxout(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Max over channel groups: [N, H, W, C] -> [N, H, W, C / groups]."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w, c // groups, groups).amax(-1)


def unpool2d(pooled: torch.Tensor, indices: torch.Tensor,
             out_hw: Tuple[int, int]) -> torch.Tensor:
    """Scatter pooled values back to their argmax positions (the inverse
    of :func:`max_pool2d_with_index`)."""
    n, oh, ow, c = pooled.shape
    h, w = out_hw
    flat = torch.zeros((n, h * w, c), dtype=pooled.dtype,
                       device=pooled.device)
    flat = flat.scatter_add(1, indices.reshape(n, oh * ow, c).long(),
                            pooled.reshape(n, oh * ow, c))
    return flat.reshape(n, h, w, c)
