"""PTB (imikolov) language-model dataset — n-grams or seq pairs.

Reference: python/paddle/v2/dataset/imikolov.py (simple-examples.tgz,
freq-sorted dict over train+valid with one <s>/<e> counted per line and
<unk> last, NGRAM sliding windows / SEQ src-trg pairs). Real pipeline with
a synthetic fallback when offline.
"""

from __future__ import annotations

import collections
import tarfile
from typing import Dict, Iterator

import numpy as np

from paddle_tpu_torch.dataset import common

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"

TRAIN_FILE = "./simple-examples/data/ptb.train.txt"
VALID_FILE = "./simple-examples/data/ptb.valid.txt"


class DataType:
    NGRAM = 1
    SEQ = 2


def word_count(lines: Iterator, word_freq=None) -> Dict[str, int]:
    """Count words plus one <s>/<e> per line (sentence markers)."""
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="ignore")
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def build_dict_from_files(trainf, testf, min_word_freq: int) -> Dict[str, int]:
    word_freq = word_count(testf, word_count(trainf))
    word_freq.pop("<unk>", None)  # re-added as the last index below
    kept = [(w, f) for w, f in word_freq.items() if f > min_word_freq]
    kept.sort(key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def build_dict(min_word_freq: int = 50) -> Dict[str, int]:
    try:
        path = common.download(URL, "imikolov", MD5)
        with tarfile.open(path) as tf:
            return build_dict_from_files(tf.extractfile(TRAIN_FILE),
                                         tf.extractfile(VALID_FILE),
                                         min_word_freq)
    except Exception:
        d = {f"w{i}": i for i in range(1999)}
        d["<unk>"] = 1999
        return d


def parse_lines(lines, word_idx: Dict[str, int], n: int, data_type: int):
    """Core parse: NGRAM -> sliding ID windows over '<s> line <e>';
    SEQ -> (<s>+ids, ids+<e>) pairs, skipping sequences longer than n."""
    unk = word_idx["<unk>"]
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="ignore")
        words = line.strip().split()
        if data_type == DataType.NGRAM:
            assert n > -1, "Invalid gram length"
            toks = ["<s>"] + words + ["<e>"]
            if len(toks) >= n:
                ids = [word_idx.get(w, unk) for w in toks]
                for i in range(n, len(ids) + 1):
                    yield tuple(ids[i - n:i])
        elif data_type == DataType.SEQ:
            ids = [word_idx.get(w, unk) for w in words]
            src = [word_idx["<s>"]] + ids
            trg = ids + [word_idx["<e>"]]
            if n > 0 and len(src) > n:
                continue
            yield src, trg
        else:
            raise ValueError(f"unknown data type {data_type}")


def _real_reader(filename: str, word_idx, n, data_type):
    def reader():
        path = common.download(URL, "imikolov", MD5)
        with tarfile.open(path) as tf:
            yield from parse_lines(tf.extractfile(filename), word_idx, n,
                                   data_type)

    return reader


def _synth_reader(word_idx, n, data_type, count, seed):
    """Markov-ish synthetic n-grams / sequences (offline CI fallback)."""
    def reader():
        rng = np.random.RandomState(seed)
        dim = len(word_idx)
        trans = rng.randint(0, dim, size=(dim,))
        for _ in range(count):
            start = int(rng.randint(dim))
            gram = [start]
            for _ in range(max(n - 1, 4)):
                gram.append(int((trans[gram[-1]] + rng.randint(3)) % dim))
            if data_type == DataType.NGRAM:
                yield tuple(gram[:n])
            else:
                yield gram, gram[1:] + [gram[0]]

    return reader


def train(word_idx: Dict[str, int], n: int, data_type: int = DataType.NGRAM):
    try:
        common.download(URL, "imikolov", MD5)
    except Exception:
        return _synth_reader(word_idx, n, data_type, 4096, 20)
    return _real_reader(TRAIN_FILE, word_idx, n, data_type)


def test(word_idx: Dict[str, int], n: int, data_type: int = DataType.NGRAM):
    try:
        common.download(URL, "imikolov", MD5)
    except Exception:
        return _synth_reader(word_idx, n, data_type, 512, 21)
    return _real_reader(VALID_FILE, word_idx, n, data_type)


def fetch() -> None:
    common.download(URL, "imikolov", MD5)
