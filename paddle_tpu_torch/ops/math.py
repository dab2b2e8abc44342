"""Dense math under the bf16 policy and dropout (the port of
``paddle_tpu/ops/math.py``: ``compute_dtype``, ``matmul``,
``dense_activation_dtype``, ``fc``, ``outer_product_update`` and
``dropout``).

The JAX package multiplies bf16 inputs with f32 accumulation
(``preferred_element_type``) and returns the f32 accumulator unrounded.  A
bf16 ``torch.matmul`` would round its result to bf16, so:

- on the card, a bf16 product is ``torch.mm(..., out_dtype=torch.float32)``
  (cuBLAS bf16 tensor cores, f32 accumulate, f32 out).  That overload has
  no autograd formula, so :class:`_MatmulF32Out` gives it one: each
  backward product rounds the f32 cotangent to bf16 and runs the same
  way, and the gradient is cast to its input's dtype as JAX's transpose
  rule does.  (JAX on the TPU rounds f32 product operands to bf16 too, at
  its default precision.)
- on the host, where ``mm``'s ``out_dtype`` has no kernel, the bf16-rounded
  inputs are widened exactly and multiplied in f32; autograd then
  computes the backward products in f32, as JAX on the CPU does.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.platform.flags import FLAGS


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """Matmul INPUT dtype under the global policy (bf16 when
    ``FLAGS.use_bf16``; accumulation stays f32)."""
    if FLAGS.use_bf16 and x.dtype in (torch.float32, torch.bfloat16):
        return torch.bfloat16
    return x.dtype


def dense_activation_dtype() -> torch.dtype:
    """Storage dtype of fc/embedding/attention outputs (the transformer
    residual stream): bf16 only under ``use_bf16`` and
    ``bf16_dense_activations``."""
    if FLAGS.use_bf16 and FLAGS.bf16_dense_activations:
        return torch.bfloat16
    return torch.float32


class _MatmulF32Out(torch.autograd.Function):
    """[M, K] x [K, N] bf16 -> [M, N] f32 on the card."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
           trans_b: bool = False, out_dtype=torch.float32) -> torch.Tensor:
    """``a @ b`` with inputs in :func:`compute_dtype` (of ``a``) and an
    f32 result that is not rounded to the input dtype."""
    if trans_a:
        a = a.transpose(-1, -2)
    if trans_b:
        b = b.transpose(-1, -2)
    ct = compute_dtype(a)
    a, b = a.to(ct), b.to(ct)
    if ct == torch.bfloat16:
        if a.is_cuda and b.dim() == 2:
            y = _MatmulF32Out.apply(a.reshape(-1, a.shape[-1]), b)
            y = y.reshape(*a.shape[:-1], b.shape[-1])
        else:
            # exact widening: the product of two bf16 values is exact in
            # f32, so only the sums round, in f32
            y = torch.matmul(a.float(), b.float())
    else:
        y = torch.matmul(a, b)
    return y.to(out_dtype)


def fc(x: torch.Tensor, w: torch.Tensor,
       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` under the policy, the f32 accumulator returned."""
    y = matmul(x, w)
    if b is not None:
        y = y + b
    return y


def outer_product_update(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x^T y``: the sum over rows of the rows' outer products."""
    return matmul(x, y, trans_a=True)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            train: bool) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, the mask drawn from ``generator``
    (a CUDA generator for a CUDA tensor); the identity at ``train=False``
    or rate 0.  The JAX package draws its mask from a PRNG key, which
    torch cannot replay: the semantics are the same, the bits are not."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)
                       ).to(x.dtype)
