"""Reader creators (a copy of ``paddle_tpu/reader/creator.py``: np_array,
text_file, recordio; ``cloud_reader`` needs the elastic master and raises
until it is ported)."""

from __future__ import annotations



def np_array(x):
    """Reader over rows of a numpy array."""

    def reader():
        import numpy as np

        arr = np.asarray(x)
        for row in arr:
            yield row

    return reader


def text_file(path: str):
    """Reader yielding stripped lines."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size: int = 100):
    """Reader over simple length-prefixed record files (our recordio analog:
    8-byte little-endian length + payload per record; see
    paddle_tpu.master.recordio_write)."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        import struct

        for path in paths:
            with open(path, "rb") as f:
                while True:
                    header = f.read(8)
                    if len(header) < 8:
                        break
                    (n,) = struct.unpack("<Q", header)
                    yield f.read(n)

    return reader


def cloud_reader(paths, etcd_endpoints=None, timeout_sec: int = 5,
                 buf_size: int = 64):
    """Task-dispatched reader backed by the elastic input master."""
    from paddle_tpu_torch.platform.enforce import EnforceError

    raise EnforceError("cloud_reader needs the elastic master (master/), "
                       "which comes with the tail slice (A13)",
                       context="reader")
