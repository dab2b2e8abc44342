"""Reader creators (a copy of ``paddle_tpu/reader/creator.py``: np_array,
text_file, recordio and ``cloud_reader`` over the port's elastic master,
:mod:`paddle_tpu_torch.master`)."""

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
    paddle_tpu_torch.master.recordio_write)."""
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
    """Task-dispatched reader backed by the elastic input master
    (reference: cloud_reader via go master client, creator.py:91-112).

    Here the master is the in-repo task-queue service
    (paddle_tpu_torch.master.MasterClient); etcd is replaced by its
    address (None: an in-process master)."""

    def reader():
        from paddle_tpu_torch.master import MasterClient

        client = MasterClient(etcd_endpoints)
        try:
            client.set_dataset(paths)
            client.begin_pass()  # recycle tasks if a prior pass finished
            while True:
                rec = client.next_record()
                if rec is None:
                    break
                yield rec
        finally:
            client.close()

    return reader
