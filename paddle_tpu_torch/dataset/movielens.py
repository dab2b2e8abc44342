"""MovieLens-1M rating prediction dataset.

Reference: python/paddle/v2/dataset/movielens.py (ml-1m.zip with
movies.dat/users.dat/ratings.dat in ``::``-separated format; 90/10
train/test split by seeded shuffle; samples are
(user_id, gender, age_idx, job, movie_id, category_ids, title_word_ids,
score)). Real pipeline with a synthetic fallback when offline.
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List

import numpy as np

from paddle_tpu_torch.dataset import common

URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

MAX_USER = 6040
MAX_MOVIE = 3952

AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]

_TITLE_YEAR_RE = re.compile(r"^(.*)\((\d+)\)$")

_META = None  # lazily-parsed (movie_info, user_info, title_dict, cat_dict)


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, cat_dict, title_dict):
        return [self.index, [cat_dict[c] for c in self.categories],
                [title_dict[w.lower()] for w in self.title.split()]]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = AGE_TABLE.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


def parse_movies(lines) -> Dict[int, MovieInfo]:
    """movies.dat: 'id::Title (Year)::Cat|Cat' lines."""
    movies = {}
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("latin1")
        line = line.strip()
        if not line:
            continue
        mid, title, cats = line.split("::")
        m = _TITLE_YEAR_RE.match(title)
        title = m.group(1).strip() if m else title
        movies[int(mid)] = MovieInfo(mid, cats.split("|"), title)
    return movies


def parse_users(lines) -> Dict[int, UserInfo]:
    """users.dat: 'id::gender::age::job::zip' lines."""
    users = {}
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("latin1")
        line = line.strip()
        if not line:
            continue
        uid, gender, age, job, _zip = line.split("::")
        users[int(uid)] = UserInfo(uid, gender, age, job)
    return users


def _load_meta():
    global _META
    if _META is not None:
        return _META
    path = common.download(URL, "movielens", MD5)
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/movies.dat") as f:
            movies = parse_movies(f)
        with z.open("ml-1m/users.dat") as f:
            users = parse_users(f)
    title_words = sorted({w.lower() for m in movies.values()
                          for w in m.title.split()})
    categories = sorted({c for m in movies.values() for c in m.categories})
    _META = (movies, users, {w: i for i, w in enumerate(title_words)},
             {c: i for i, c in enumerate(categories)})
    return _META


def _ratings(is_test: bool, test_ratio: float = 0.1, seed: int = 0):
    movies, users, title_dict, cat_dict = _load_meta()
    path = common.download(URL, "movielens", MD5)
    rng = np.random.RandomState(seed)
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/ratings.dat") as f:
            for line in f:
                line = line.decode("latin1").strip()
                if not line:
                    continue
                if (rng.rand() < test_ratio) != is_test:
                    continue
                uid, mid, rating, _ts = line.split("::")
                usr = users[int(uid)]
                mov = movies[int(mid)]
                yield tuple(usr.value()
                            + mov.value(cat_dict, title_dict)
                            + [float(rating)])


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    user_bias = rng.randn(MAX_USER + 1)
    movie_bias = rng.randn(MAX_MOVIE + 1)
    for _ in range(n):
        u = int(rng.randint(1, MAX_USER + 1))
        m = int(rng.randint(1, MAX_MOVIE + 1))
        gender = int(rng.randint(2))
        age = int(rng.randint(len(AGE_TABLE)))
        job = int(rng.randint(21))
        category = [int(rng.randint(19))]
        title = [int(rng.randint(1000)) for _ in range(3)]
        score = float(np.clip(3 + user_bias[u] + movie_bias[m]
                              + 0.3 * rng.randn(), 1, 5))
        yield u, gender, age, job, m, category, title, score


def train():
    try:
        common.download(URL, "movielens", MD5)
    except Exception:
        return lambda: _synthetic(4096, 30)
    return lambda: _ratings(is_test=False)


def test():
    try:
        common.download(URL, "movielens", MD5)
    except Exception:
        return lambda: _synthetic(512, 31)
    return lambda: _ratings(is_test=True)


# ---- metadata accessors (reference API surface) ---------------------------


def movie_info() -> Dict[int, MovieInfo]:
    return _load_meta()[0]


def user_info() -> Dict[int, UserInfo]:
    return _load_meta()[1]


def get_movie_title_dict() -> Dict[str, int]:
    try:
        return _load_meta()[2]
    except Exception:
        return {f"t{i}": i for i in range(1000)}


def movie_categories() -> Dict[str, int]:
    try:
        return _load_meta()[3]
    except Exception:
        return {f"c{i}": i for i in range(19)}


def max_user_id() -> int:
    try:
        return max(u.index for u in _load_meta()[1].values())
    except Exception:
        return MAX_USER


def max_movie_id() -> int:
    try:
        return max(m.index for m in _load_meta()[0].values())
    except Exception:
        return MAX_MOVIE


def max_job_id() -> int:
    try:
        return max(u.job_id for u in _load_meta()[1].values())
    except Exception:
        return 20


def age_table() -> List[int]:
    return list(AGE_TABLE)


def fetch() -> None:
    common.download(URL, "movielens", MD5)
