"""Input type descriptors for data layers and the DataFeeder (a copy of
``paddle_tpu/data_type.py``: dense vectors, sparse binary and sparse
float vectors, integer values, and their sequence and nested-sequence
forms)."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class SeqKind(Enum):
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class SlotKind(Enum):
    DENSE = 0
    SPARSE_BINARY = 1
    SPARSE_FLOAT = 2
    INDEX = 3


@dataclass(frozen=True)
class InputType:
    dim: int
    slot: SlotKind
    seq: SeqKind = SeqKind.NO_SEQUENCE


def dense_vector(dim: int) -> InputType:
    return InputType(dim, SlotKind.DENSE)


def dense_array(dim: int) -> InputType:  # alias used by some v2 code
    return InputType(dim, SlotKind.DENSE)


def dense_vector_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.DENSE, SeqKind.SEQUENCE)


def sparse_binary_vector(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_BINARY)


def sparse_float_vector(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_FLOAT)


def integer_value(value_range: int) -> InputType:
    return InputType(value_range, SlotKind.INDEX)


def sparse_binary_vector_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_BINARY, SeqKind.SEQUENCE)


def sparse_float_vector_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.SPARSE_FLOAT, SeqKind.SEQUENCE)


def integer_value_sequence(value_range: int) -> InputType:
    return InputType(value_range, SlotKind.INDEX, SeqKind.SEQUENCE)


def dense_vector_sub_sequence(dim: int) -> InputType:
    return InputType(dim, SlotKind.DENSE, SeqKind.SUB_SEQUENCE)


def integer_value_sub_sequence(value_range: int) -> InputType:
    return InputType(value_range, SlotKind.INDEX, SeqKind.SUB_SEQUENCE)
