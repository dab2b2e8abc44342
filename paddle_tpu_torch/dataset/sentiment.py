"""NLTK movie_reviews sentiment dataset.

Reference: python/paddle/v2/dataset/sentiment.py (nltk movie_reviews corpus,
freq-sorted word dict, neg/pos interleaved; first 1600 train / last 400
test; label 0=neg 1=pos). The corpus is a plain zip of
movie_reviews/{neg,pos}/*.txt — parsed directly (no nltk dependency) with
a synthetic fallback when offline.
"""

from __future__ import annotations

import collections
import zipfile
from typing import Dict, Iterator, List, Tuple

from paddle_tpu_torch.dataset import _synth, common

URL = ("https://raw.githubusercontent.com/nltk/nltk_data/gh-pages/"
       "packages/corpora/movie_reviews.zip")
MD5 = ""  # nltk publishes no stable md5; cache by name only

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000

WORD_DIM = 1500  # offline-fallback dict size


def _tokenize(text: str) -> List[str]:
    # the corpus ships pre-tokenized (tokens separated by whitespace /
    # newlines); lowercase to match the reference's word dict
    return text.lower().split()


def iter_documents(zip_path: str) -> Iterator[Tuple[List[str], int]]:
    """Yield (tokens, label) interleaved neg/pos (label 0=neg, 1=pos),
    ordered by filename within each class (cross-reading keeps the
    train/test split class-balanced)."""
    with zipfile.ZipFile(zip_path) as z:
        names = sorted(z.namelist())
        neg = [n for n in names if "/neg/" in n and n.endswith(".txt")]
        pos = [n for n in names if "/pos/" in n and n.endswith(".txt")]
        for n_name, p_name in zip(neg, pos):
            yield _tokenize(z.read(n_name).decode("utf-8", "ignore")), 0
            yield _tokenize(z.read(p_name).decode("utf-8", "ignore")), 1


def build_word_dict(zip_path: str) -> Dict[str, int]:
    freq: Dict[str, int] = collections.defaultdict(int)
    for tokens, _ in iter_documents(zip_path):
        for w in tokens:
            freq[w] += 1
    kept = sorted(freq.items(), key=lambda x: (-x[1], x[0]))
    return {w: i for i, (w, _) in enumerate(kept)}


def get_word_dict() -> Dict[str, int]:
    try:
        return build_word_dict(common.download(URL, "sentiment", MD5))
    except Exception:
        return {f"w{i}": i for i in range(WORD_DIM)}


def _real_reader(lo: int, hi: int, word_dict: Dict[str, int]):
    def reader():
        zip_path = common.download(URL, "sentiment", MD5)
        for i, (tokens, label) in enumerate(iter_documents(zip_path)):
            if lo <= i < hi:
                yield [word_dict[w] for w in tokens if w in word_dict], label

    return reader


def train(word_dict: Dict[str, int] = None):
    try:
        common.download(URL, "sentiment", MD5)
    except Exception:
        dim = len(word_dict) if word_dict else WORD_DIM
        return lambda: _synth.seq_classification(1024, dim, 2, seed=80)
    return _real_reader(0, NUM_TRAINING_INSTANCES, word_dict or get_word_dict())


def test(word_dict: Dict[str, int] = None):
    try:
        common.download(URL, "sentiment", MD5)
    except Exception:
        dim = len(word_dict) if word_dict else WORD_DIM
        return lambda: _synth.seq_classification(128, dim, 2, seed=81)
    return _real_reader(NUM_TRAINING_INSTANCES, NUM_TOTAL_INSTANCES,
                        word_dict or get_word_dict())


def fetch() -> None:
    common.download(URL, "sentiment", MD5)
