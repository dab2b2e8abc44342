"""Activation descriptors (the port of ``paddle_tpu/activation.py``, the
seven the transformer, the recurrent layers and attention read).

GELU is the tanh approximation: ``jax.nn.gelu`` defaults to it, and the
exact erf form would not match the JAX package.  ``SigmoidActivation.fn``
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


class ReluActivation(BaseActivation):
    name = "relu"
    fn = staticmethod(torch.relu)


class SoftmaxActivation(BaseActivation):
    name = "softmax"
    fn = staticmethod(lambda x: torch.softmax(x, dim=-1))


class SequenceSoftmaxActivation(BaseActivation):
    """Softmax over each variable-length sequence's scalar scores; it
    needs the segment ids, so the layers resolve it
    (``ops/sequence_ops.sequence_softmax``)."""

    name = "sequence_softmax"
    fn = None


class GeluActivation(BaseActivation):
    """GELU, tanh form (``jax.nn.gelu(approximate=True)``)."""

    name = "gelu"
    fn = staticmethod(lambda x: F.gelu(x, approximate="tanh"))


_REGISTRY = {cls.name: cls for cls in
             (LinearActivation, SigmoidActivation, TanhActivation,
              ReluActivation, SoftmaxActivation, SequenceSoftmaxActivation,
              GeluActivation)}


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
            raise KeyError(f"unknown activation {name_or_act!r} (the port "
                           f"has {sorted(_REGISTRY)} so far)")
        return _REGISTRY[name_or_act]()
    raise TypeError(f"cannot resolve activation from {name_or_act!r}")
