"""Reader protocol: a reader is a zero-argument callable returning an
iterable of samples (the port of ``paddle_tpu/reader``)."""

from paddle_tpu_torch.reader.decorator import (buffered, chain, compose,
                                               firstn, map_readers, shuffle,
                                               xmap_readers)
from paddle_tpu_torch.reader import creator

__all__ = ["buffered", "chain", "compose", "firstn", "map_readers", "shuffle",
           "xmap_readers", "creator"]
