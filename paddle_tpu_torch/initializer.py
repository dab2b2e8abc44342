"""Parameter initializers (the port of ``paddle_tpu/initializer.py``).

Each is ``(generator, shape, dtype) -> tensor`` with the JAX package's
distribution, drawn on the host from a ``torch.Generator`` so a seed gives
the same weights whatever device they go to.  The numbers differ from the
JAX package's (a torch generator cannot replay a JAX PRNG key): weights
cross between the packages as numpy, through ``Parameters.to_tar``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _fan_in_out(shape: Sequence[int]):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels [h, w, cin, cout] (the JAX package's HWIO layout)
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


class Initializer:
    def __call__(self, generator: torch.Generator, shape,
                 dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, generator, shape, dtype=torch.float32):
        x = torch.rand(tuple(shape), generator=generator)
        return (self.low + x * (self.high - self.low)).to(dtype)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, generator, shape, dtype=torch.float32):
        x = torch.randn(tuple(shape), generator=generator)
        return (self.mean + self.std * x).to(dtype)


class XavierUniform(Initializer):
    """The default weight initializer: U(-l, l), l = sqrt(6 / (fan_in +
    fan_out))."""

    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fan_in_out(shape)
        limit = math.sqrt(6.0 / max(1, fan_in + fan_out))
        x = torch.rand(tuple(shape), generator=generator)
        return (x * (2.0 * limit) - limit).to(dtype)


class FanInNormal(Initializer):
    """N(0, 1/fan_in): the reference's std-based ``initial_smart``."""

    def __call__(self, generator, shape, dtype=torch.float32):
        fan_in, _ = _fan_in_out(shape)
        std = 1.0 / math.sqrt(max(1, fan_in))
        return (std * torch.randn(tuple(shape), generator=generator)).to(
            dtype)


def default_weight_init() -> Initializer:
    return XavierUniform()


def default_bias_init() -> Initializer:
    return Constant(0.0)


def to_initializer(arg) -> Initializer:
    if arg is None:
        return default_weight_init()
    if isinstance(arg, Initializer):
        return arg
    if isinstance(arg, (int, float)):
        return Constant(float(arg))
    raise TypeError(f"cannot convert {arg!r} to Initializer")
