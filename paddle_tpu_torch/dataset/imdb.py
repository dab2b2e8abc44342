"""IMDB sentiment dataset — aclImdb tarball -> tokenized ID sequences.

Reference: python/paddle/v2/dataset/imdb.py:1-120 (streaming tar tokenizer,
frequency-sorted dict with <unk> last, pos=0/neg=1 labels). Real pipeline
with a deterministic synthetic fallback when the environment has no egress.
"""

from __future__ import annotations

import collections
import re
import string
import tarfile
from typing import Dict, Iterator, List, Tuple

from paddle_tpu_torch.dataset import _synth, common

URL = "http://ai.stanford.edu/%7Eamaas/data/sentiment/aclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"

WORD_DIM = 5147  # offline-fallback dict size ballpark

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def tokenize(pattern, tar_path: str = None) -> Iterator[List[str]]:
    """Stream docs whose member name matches ``pattern`` from the tarball;
    lowercase, strip punctuation, whitespace-tokenize. Sequential tar access
    (``next()``) — random access on an 80k-member tgz thrashes the disk."""
    tar_path = tar_path or common.download(URL, "imdb", MD5)
    with tarfile.open(tar_path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if pattern.match(tf.name):
                text = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="ignore")
                yield text.rstrip("\n\r").translate(_PUNCT_TABLE).lower().split()
            tf = tarf.next()


def build_dict(pattern, cutoff: int, tar_path: str = None) -> Dict[str, int]:
    """Frequency-sorted word dict (ties broken alphabetically), words with
    freq <= cutoff dropped, '<unk>' appended last."""
    word_freq: Dict[str, int] = collections.defaultdict(int)
    for doc in tokenize(pattern, tar_path):
        for word in doc:
            word_freq[word] += 1
    kept = [(w, f) for w, f in word_freq.items() if f > cutoff]
    kept.sort(key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _real_reader(pos_re: str, neg_re: str, word_idx: Dict[str, int],
                 tar_path: str = None):
    """Alternate pos (label 0) / neg (label 1) docs — the reference
    interleaves the two streams so minibatches stay class-balanced."""
    unk = word_idx["<unk>"]

    def reader() -> Iterator[Tuple[List[int], int]]:
        streams = [tokenize(re.compile(pos_re), tar_path),
                   tokenize(re.compile(neg_re), tar_path)]
        done = [False, False]
        i = 0
        while not all(done):
            if not done[i % 2]:
                doc = next(streams[i % 2], None)
                if doc is None:
                    done[i % 2] = True
                else:
                    yield [word_idx.get(w, unk) for w in doc], i % 2
            i += 1

    return reader


def word_dict(cutoff: int = 150) -> Dict[str, int]:
    try:
        return build_dict(
            re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
            cutoff)
    except Exception:
        d = {f"w{i}": i for i in range(WORD_DIM - 1)}
        d["<unk>"] = WORD_DIM - 1
        return d


def train(word_idx: Dict[str, int] = None):
    dim = len(word_idx) if word_idx else WORD_DIM
    try:
        common.download(URL, "imdb", MD5)
    except Exception:
        return lambda: _synth.seq_classification(2048, dim, 2, seed=10,
                                                 max_len=100)
    return _real_reader(r"aclImdb/train/pos/.*\.txt$",
                        r"aclImdb/train/neg/.*\.txt$",
                        word_idx or word_dict())


def test(word_idx: Dict[str, int] = None):
    dim = len(word_idx) if word_idx else WORD_DIM
    try:
        common.download(URL, "imdb", MD5)
    except Exception:
        return lambda: _synth.seq_classification(256, dim, 2, seed=11,
                                                 max_len=100)
    return _real_reader(r"aclImdb/test/pos/.*\.txt$",
                        r"aclImdb/test/neg/.*\.txt$",
                        word_idx or word_dict())


def fetch() -> None:
    common.download(URL, "imdb", MD5)
