"""WMT-14 fr-en translation dataset.

Reference: python/paddle/v2/dataset/wmt14.py (shrunk wmt14.tgz with
src.dict/trg.dict + tab-separated parallel files; samples are
(src_ids with <s>/<e>, <s>+trg_ids, trg_ids+<e>), len>80 dropped).
Real pipeline with a synthetic fallback when offline.
"""

from __future__ import annotations

import tarfile
from typing import Dict, Tuple

import numpy as np

from paddle_tpu_torch.dataset import common

URL_TRAIN = "http://paddlepaddle.cdn.bcebos.com/demo/wmt_shrinked_data/wmt14.tgz"
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"
URL_DEV_TEST = ("http://www-lium.univ-lemans.fr/~schwenk/"
                "cslm_joint_paper/data/dev+test.tgz")
MD5_DEV_TEST = "7d7897317ddd8ba0ae5c5fa7248d3ff5"

DICT_SIZE = 30000
START = "<s>"
END = "<e>"
UNK = "<unk>"
START_IDX = 0
END_IDX = 1
UNK_IDX = 2


def read_dicts_from_tar(tar_path: str, dict_size: int
                        ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """First ``dict_size`` lines of the bundled src.dict / trg.dict."""
    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.decode("utf-8", errors="ignore").strip()] = i
        return out

    with tarfile.open(tar_path) as f:
        src_name = [m.name for m in f if m.name.endswith("src.dict")]
        trg_name = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_name) == 1 and len(trg_name) == 1
        return (to_dict(f.extractfile(src_name[0]), dict_size),
                to_dict(f.extractfile(trg_name[0]), dict_size))


def parse_lines(lines, src_dict: Dict[str, int], trg_dict: Dict[str, int],
                max_len: int = 80):
    """'src\\ttrg' lines -> (src_ids, trg_ids, trg_ids_next) samples."""
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="ignore")
        parts = line.strip().split("\t")
        if len(parts) != 2:
            continue
        src_words = parts[0].split()
        src_ids = [src_dict.get(w, UNK_IDX)
                   for w in [START] + src_words + [END]]
        trg_ids = [trg_dict.get(w, UNK_IDX) for w in parts[1].split()]
        if len(src_ids) > max_len or len(trg_ids) > max_len:
            continue
        yield (src_ids, [trg_dict[START]] + trg_ids,
               trg_ids + [trg_dict[END]])


def _real_reader(tar_path: str, file_suffix: str, dict_size: int):
    # dicts parsed once at creator time, not per epoch inside reader()
    src_dict, trg_dict = read_dicts_from_tar(tar_path, dict_size)

    def reader():
        with tarfile.open(tar_path) as f:
            names = [m.name for m in f if m.name.endswith(file_suffix)]
            for name in names:
                yield from parse_lines(f.extractfile(name), src_dict,
                                       trg_dict)

    return reader


def _synthetic(n, seed, dict_size):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        slen = int(rng.randint(3, 25))
        src = [int(t) for t in rng.randint(3, dict_size, slen)]
        # toy "translation": reversed + offset
        trg = [(t + 7) % (dict_size - 3) + 3 for t in reversed(src)]
        yield (src, [START_IDX] + trg, trg + [END_IDX])


def get_dict(dict_size: int = DICT_SIZE):
    path = common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
    return read_dicts_from_tar(path, dict_size)


def train(dict_size: int = DICT_SIZE):
    try:
        path = common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
    except Exception:
        return lambda: _synthetic(2048, 50, dict_size)
    return _real_reader(path, "train/train", dict_size)


def test(dict_size: int = DICT_SIZE):
    try:
        path = common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
    except Exception:
        return lambda: _synthetic(256, 51, dict_size)
    return _real_reader(path, "test/test", dict_size)


def gen(dict_size: int = DICT_SIZE):
    try:
        path = common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
    except Exception:
        return lambda: _synthetic(64, 52, dict_size)
    return _real_reader(path, "gen/gen", dict_size)


def fetch() -> None:
    common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
