"""Pooling descriptors for sequence pooling and image pooling (a copy of
``paddle_tpu/pooling.py``).

Reference: python/paddle/trainer_config_helpers/poolings.py (MaxPooling,
AvgPooling, SumPooling, SquareRootNPooling, CudnnMaxPooling/CudnnAvgPooling).
"""

from __future__ import annotations


class BasePoolingType:
    name = "base"


class MaxPooling(BasePoolingType):
    name = "max"

    def __init__(self, output_max_index: bool = False):
        self.output_max_index = output_max_index


class AvgPooling(BasePoolingType):
    name = "avg"


class SumPooling(BasePoolingType):
    name = "sum"


class SqrtNPooling(BasePoolingType):
    """sum / sqrt(len) — the reference's SquareRootNPooling."""

    name = "sqrtn"


def get(arg) -> BasePoolingType:
    if arg is None:
        return MaxPooling()
    if isinstance(arg, BasePoolingType):
        return arg
    if isinstance(arg, type) and issubclass(arg, BasePoolingType):
        return arg()
    if isinstance(arg, str):
        table = {c.name: c for c in [MaxPooling, AvgPooling, SumPooling, SqrtNPooling]}
        return table[arg]()
    raise TypeError(f"cannot resolve pooling from {arg!r}")
