"""Minimal recordio: length-prefixed records in a flat file.

Format: per record, an 8-byte little-endian u64 payload length followed by
the payload bytes.  The reference uses the recordio chunk library
(go/master/service.go:106 partitions by chunks); ours indexes byte offsets
so the master can hand out (path, offset, count) chunk specs and clients
can seek directly.
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Tuple

_HDR = struct.Struct("<Q")


def recordio_write(path: str, records: Iterable[bytes]) -> int:
    """Write records; returns the number written."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            if isinstance(rec, str):
                rec = rec.encode("utf-8")
            f.write(_HDR.pack(len(rec)))
            f.write(rec)
            n += 1
    return n


def recordio_index(path: str) -> List[int]:
    """Byte offset of every record in the file."""
    offsets = []
    with open(path, "rb") as f:
        pos = 0
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            offsets.append(pos)
            (n,) = _HDR.unpack(hdr)
            f.seek(n, 1)
            pos += _HDR.size + n
    return offsets


def recordio_read_chunk(path: str, offset: int, count: int) -> List[bytes]:
    """Read `count` consecutive records starting at byte `offset`."""
    out: List[bytes] = []
    with open(path, "rb") as f:
        f.seek(offset)
        for _ in range(count):
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break
            (n,) = _HDR.unpack(hdr)
            out.append(f.read(n))
    return out
