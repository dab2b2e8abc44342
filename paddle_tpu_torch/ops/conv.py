"""Convolutions (the port of ``paddle_tpu/ops/conv.py``).

Activations are NHWC and weights HWIO, as in the JAX package.  cuDNN is
handed ``x.permute(0, 3, 1, 2)``, an NCHW view of a contiguous NHWC tensor
and so already a ``channels_last`` tensor, and the weight as an OIHW
``channels_last`` copy (made in the same pass as the bf16 cast); it then
runs its NHWC kernels, and the output's NHWC view is contiguous again.  No
activation is transposed: the only copy per conv is the weight's.

Dtype policy (``ops/conv.py:29-46,64-68`` of the JAX package): under
``FLAGS.use_bf16`` inputs and weights are cast to bf16 and the conv's own
output is bf16 (f32 accumulation inside); the result is then cast to
``out_dtype``, else to :func:`activation_dtype`.  On the card a bf16 conv
is cuDNN's; on the host the bf16-rounded operands are widened exactly,
convolved in f32 and the result rounded to bf16, as the JAX package's
bf16 conv does on the CPU.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.platform.flags import FLAGS

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_dtype(x: torch.Tensor) -> torch.dtype:
    if FLAGS.use_bf16 and x.dtype in (torch.float32, torch.bfloat16):
        return torch.bfloat16
    return x.dtype


def activation_dtype() -> torch.dtype:
    """Storage dtype of inter-layer image activations: bf16 only under
    ``use_bf16`` and ``bf16_activations``; batch-norm statistics, losses
    and parameters stay f32."""
    if FLAGS.use_bf16 and FLAGS.bf16_activations:
        return torch.bfloat16
    return torch.float32


def _operands(x: torch.Tensor, w: torch.Tensor, w_perm, memory_format):
    """(x in the compute dtype as a channels-last N C ... view, w permuted
    to ``w_perm`` and copied channels-last in the compute dtype)."""
    ct = _conv_dtype(x)
    nd = x.dim()
    xc = x.to(ct).permute(0, nd - 1, *range(1, nd - 1))
    wc = w.permute(*w_perm).to(ct, memory_format=memory_format)
    return xc, wc


def _run(fn, xc, wc, **kw) -> torch.Tensor:
    """``fn`` (a torch conv) on the compute-dtype operands; on the host a
    bf16 conv is f32 arithmetic on the exact widening, rounded once."""
    if xc.dtype == torch.bfloat16 and not xc.is_cuda:
        return fn(xc.float(), wc.float(), **kw).to(torch.bfloat16)
    return fn(xc, wc, **kw)


def _nhwc(y: torch.Tensor, out_dtype) -> torch.Tensor:
    y = y.permute(0, *range(2, y.dim()), 1)
    return y.to(out_dtype if out_dtype is not None else activation_dtype())


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: IntOr2 = 1,
           padding: Union[str, IntOr2] = 0, dilation: IntOr2 = 1,
           groups: int = 1, out_dtype=None) -> torch.Tensor:
    """x: [N, H, W, C], w: [kh, kw, Cin/groups, Cout] -> [N, H', W',
    Cout]."""
    pad = padding.lower() if isinstance(padding, str) else _pair(padding)
    xc, wc = _operands(x, w, (3, 2, 0, 1), torch.channels_last)
    y = _run(F.conv2d, xc, wc, stride=_pair(stride), padding=pad,
             dilation=_pair(dilation), groups=groups)
    return _nhwc(y, out_dtype)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *,
                     stride: IntOr2 = 1, padding: IntOr2 = 0,
                     out_dtype=None) -> torch.Tensor:
    """Transposed conv, w: [kh, kw, Cin, Cout] with Cin = x's channels.
    The JAX package convolves the stride-dilated input with the flipped
    kernel at padding k - 1 - p; that is ``conv_transpose2d`` with the
    kernel unflipped as [Cin, Cout, kh, kw] at padding p."""
    xc, wc = _operands(x, w, (2, 3, 0, 1), torch.channels_last)
    y = _run(F.conv_transpose2d, xc, wc, stride=_pair(stride),
             padding=_pair(padding))
    return _nhwc(y, out_dtype)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                     stride: IntOr2 = 1,
                     padding: Union[str, IntOr2] = 0) -> torch.Tensor:
    """Depthwise conv, w: [kh, kw, C, channel_multiplier]: a grouped conv
    with groups = C."""
    c = x.shape[-1]
    kh, kw, _, m = w.shape
    return conv2d(x, w.reshape(kh, kw, 1, c * m), stride=stride,
                  padding=padding, groups=c)


def conv3d(x: torch.Tensor, w: torch.Tensor, *, stride=1,
           padding=0) -> torch.Tensor:
    """3-D conv, x: [N, D, H, W, C], w: [kd, kh, kw, Cin, Cout]."""
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    if isinstance(padding, str):
        pad = padding.lower()
    else:
        pad = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    xc, wc = _operands(x, w, (4, 3, 0, 1, 2), torch.channels_last_3d)
    return _nhwc(_run(F.conv3d, xc, wc, stride=s, padding=pad), None)


def row_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row (lookahead) convolution over time: x [B, T, D], w
    [future_context, D], y[t] = sum_k x[t + k] * w[k]."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, 0, k - 1))
    stacked = torch.stack([xp[:, i:i + t] for i in range(k)], dim=0)
    return torch.einsum("kbtd,kd->btd", stacked, w.to(x.dtype))


def block_expand(x: torch.Tensor, block: Tuple[int, int],
                 stride: Tuple[int, int],
                 padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """im2col as a layer: x [N, H, W, C] -> [N, blocks_h * blocks_w,
    bh * bw * C], each block's features in (C, bh, bw) order, the order
    of ``lax.conv_general_dilated_patches`` and of ``F.unfold``."""
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel_size=tuple(block),
                    stride=tuple(stride), padding=tuple(padding))
    return cols.transpose(1, 2)
