"""Activation descriptors (the port of ``paddle_tpu/activation.py``: all
sixteen).

GELU is the tanh approximation: ``jax.nn.gelu`` defaults to it, and the
exact erf form would not match the JAX package.  The clipped forms
(``brelu``, ``softrelu``) clip through ``torch.maximum``/``torch.minimum``
on tensor bounds, whose gradient splits a tie in half as ``jnp.clip``'s
does (``torch.clamp`` passes it whole), and ``abs`` is a select whose
gradient at 0 is 1, as ``jnp.abs``'s is.  ``SigmoidActivation.fn``
is ``torch.sigmoid`` and ``TanhActivation.fn`` ``torch.tanh`` themselves:
the recurrent scans recognise the default gate triple by identity, as
JAX's ``_use_fused`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class BaseActivation:
    name = "base"
    fn = None  # staticmethod (x) -> x

    def __repr__(self):
        return f"{type(self).__name__}()"


class LinearActivation(BaseActivation):
    name = "linear"
    fn = staticmethod(lambda x: x)


class SigmoidActivation(BaseActivation):
    name = "sigmoid"
    fn = staticmethod(torch.sigmoid)


class TanhActivation(BaseActivation):
    name = "tanh"
    fn = staticmethod(torch.tanh)


class STanhActivation(BaseActivation):
    """Scaled tanh: 1.7159 * tanh(2x/3)."""

    name = "stanh"
    fn = staticmethod(lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0))


class ReluActivation(BaseActivation):
    name = "relu"
    fn = staticmethod(torch.relu)


def _clip(x, lo: float, hi: float):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


class BReluActivation(BaseActivation):
    """Bounded relu: min(max(x, 0), 24)."""

    name = "brelu"
    fn = staticmethod(lambda x: _clip(x, 0.0, 24.0))


class SoftReluActivation(BaseActivation):
    """log(1 + e^x), the input clipped to +-40 as in the reference."""

    name = "softrelu"
    fn = staticmethod(lambda x: torch.log1p(torch.exp(_clip(x, -40.0, 40.0))))


class SoftmaxActivation(BaseActivation):
    name = "softmax"
    fn = staticmethod(lambda x: torch.softmax(x, dim=-1))


class SequenceSoftmaxActivation(BaseActivation):
    """Softmax over each variable-length sequence's scalar scores; it
    needs the segment ids, so the layers resolve it
    (``ops/sequence_ops.sequence_softmax``)."""

    name = "sequence_softmax"
    fn = None


class AbsActivation(BaseActivation):
    name = "abs"
    fn = staticmethod(lambda x: torch.where(x >= 0, x, -x))


class SquareActivation(BaseActivation):
    name = "square"
    fn = staticmethod(torch.square)


class ExpActivation(BaseActivation):
    name = "exponential"
    fn = staticmethod(torch.exp)


class ReciprocalActivation(BaseActivation):
    name = "reciprocal"
    fn = staticmethod(torch.reciprocal)


class SqrtActivation(BaseActivation):
    name = "sqrt"
    fn = staticmethod(torch.sqrt)


class LogActivation(BaseActivation):
    name = "log"
    fn = staticmethod(torch.log)


class GeluActivation(BaseActivation):
    """GELU, tanh form (``jax.nn.gelu(approximate=True)``)."""

    name = "gelu"
    fn = staticmethod(lambda x: F.gelu(x, approximate="tanh"))


_REGISTRY = {cls.name: cls for cls in
             (LinearActivation, SigmoidActivation, TanhActivation,
              STanhActivation, ReluActivation, BReluActivation,
              SoftReluActivation, SoftmaxActivation,
              SequenceSoftmaxActivation, AbsActivation, SquareActivation,
              ExpActivation, ReciprocalActivation, SqrtActivation,
              LogActivation, GeluActivation)}


def get(name_or_act):
    """Resolve an activation descriptor from a name, class, or instance."""
    if name_or_act is None:
        return LinearActivation()
    if isinstance(name_or_act, BaseActivation):
        return name_or_act
    if isinstance(name_or_act, type) and issubclass(name_or_act,
                                                    BaseActivation):
        return name_or_act()
    if isinstance(name_or_act, str):
        if name_or_act not in _REGISTRY:
            raise KeyError(f"unknown activation {name_or_act!r}")
        return _REGISTRY[name_or_act]()
    raise TypeError(f"cannot resolve activation from {name_or_act!r}")
