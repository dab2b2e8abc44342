"""Dataset cache/download helpers (reference: v2/dataset/common.py — DATA_HOME
cache, md5-verified download, cluster split helpers)."""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List

DATA_HOME = os.path.expanduser(os.environ.get("PADDLE_TPU_DATA_HOME",
                                              "~/.cache/paddle_tpu/dataset"))


def data_home() -> str:
    os.makedirs(DATA_HOME, exist_ok=True)
    return DATA_HOME


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: str) -> str:
    """Download with cache + md5 check; raises with a clear message when the
    environment has no egress (callers fall back to synthetic data)."""
    dirname = os.path.join(data_home(), module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(dirname, url.split("/")[-1])
    if os.path.exists(filename) and (not md5sum or md5file(filename) == md5sum):
        return filename
    import urllib.request

    # fetch to a temp name + atomic rename: an interrupted transfer must
    # never leave a truncated file that a later call (especially one with
    # no md5, e.g. sentiment) would trust as a valid cache hit
    part = filename + ".part"
    try:
        urllib.request.urlretrieve(url, part)
        if md5sum and md5file(part) != md5sum:
            raise IOError(f"md5 mismatch for {url}")
        os.replace(part, filename)
    finally:
        if os.path.exists(part):
            os.remove(part)
    return filename


def split(reader: Callable, line_count: int, suffix: str = "%05d.pickle",
          dumper=None) -> List[str]:
    """Split reader output into chunk files (cluster data prep helper)."""
    import pickle

    dumper = dumper or pickle.dump
    files = []
    buf = []
    idx = 0
    for item in reader():
        buf.append(item)
        if len(buf) == line_count:
            path = os.path.join(data_home(), suffix % idx)
            with open(path, "wb") as f:
                dumper(buf, f)
            files.append(path)
            buf, idx = [], idx + 1
    if buf:
        path = os.path.join(data_home(), suffix % idx)
        with open(path, "wb") as f:
            dumper(buf, f)
        files.append(path)
    return files


def cluster_files_reader(files_pattern: str, trainer_count: int,
                         trainer_id: int, loader=None):
    """Read this trainer's shard of chunk files (reference:
    common.py cluster_files_reader)."""
    import glob
    import pickle

    loader = loader or pickle.load

    def reader():
        paths = sorted(glob.glob(files_pattern))
        for i, path in enumerate(paths):
            if i % trainer_count == trainer_id:
                with open(path, "rb") as f:
                    for item in loader(f):
                        yield item

    return reader
