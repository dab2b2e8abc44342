"""MQ2007 learning-to-rank dataset (LETOR 4.0).

Reference: python/paddle/v2/dataset/mq2007.py (MQ2007.rar, svmlight-style
'rel qid:N 1:f 2:f ... #docid' lines, 46 features; pointwise / pairwise /
listwise sample generators over per-query groups). The .rar needs an
extractor (`unrar`/`bsdtar`/`7z` — python rarfile is not available here);
the LETOR text parser itself is fully implemented and unit-tested on
fixtures, with a synthetic fallback when offline.
"""

from __future__ import annotations

import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.dataset import common

URL = ("http://www.bigdatalab.ac.cn/benchmark/upload/download_source/"
       "7b6dbbe2-842c-11e4-a536-bcaec51b9163_MQ2007.rar")
MD5 = "7be1640ae95c6408dab0ae7207bdc706"

FEATURE_DIM = 46


def parse_letor_line(line: str) -> Optional[Tuple[int, int, np.ndarray]]:
    """'rel qid:N 1:f ... 46:f #comment' -> (relevance, query_id, features)."""
    body = line.split("#", 1)[0].strip()
    if not body:
        return None
    parts = body.split()
    if len(parts) != FEATURE_DIM + 2:
        return None
    rel = int(parts[0])
    qid = int(parts[1].split(":")[1])
    feats = np.asarray([float(p.split(":")[1]) for p in parts[2:]],
                       np.float32)
    return rel, qid, feats


def group_by_query(lines) -> Iterator[List[Tuple[float, np.ndarray]]]:
    """Group consecutive lines by qid -> list of (relevance, features),
    sorted best-first within the group (the reference's _correct_ranking_)."""
    cur_qid, group = None, []
    for line in lines:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="ignore")
        parsed = parse_letor_line(line)
        if parsed is None:
            continue
        rel, qid, feats = parsed
        if cur_qid is not None and qid != cur_qid and group:
            group.sort(key=lambda x: -x[0])
            yield group
            group = []
        cur_qid = qid
        group.append((float(rel), feats))
    if group:
        group.sort(key=lambda x: -x[0])
        yield group


def gen_point(group):
    """Pointwise: (relevance, features) per doc."""
    for rel, feats in group:
        yield rel, feats


def gen_pair(group, partial_order: str = "full"):
    """Pairwise: (left_feats, right_feats, 1.0) with left ranked higher."""
    n = len(group)
    idx_pairs = ([(i, i + 1) for i in range(n - 1)]
                 if partial_order == "neighbour"
                 else [(i, j) for i in range(n) for j in range(i + 1, n)])
    for i, j in idx_pairs:
        li, fi = group[i]
        lj, fj = group[j]
        if li > lj:
            yield fi, fj, 1.0
        elif li < lj:
            yield fj, fi, 1.0


def gen_list(group):
    """Listwise: the whole per-query group as [(rel, feats), ...]."""
    yield list(group)


_GENERATORS = {"pointwise": gen_point, "pairwise": gen_pair,
               "listwise": gen_list}


def _extract_rar(rar_path: str) -> Optional[str]:
    """Try external extractors; returns the extraction dir or None."""
    out_dir = os.path.dirname(rar_path)
    marker = os.path.join(out_dir, "MQ2007")
    if os.path.isdir(marker):
        return out_dir
    for cmd in (["unrar", "x", "-o+", rar_path, out_dir + "/"],
                ["bsdtar", "-xf", rar_path, "-C", out_dir],
                ["7z", "x", "-y", f"-o{out_dir}", rar_path]):
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=600)
            if r.returncode == 0 and os.path.isdir(marker):
                return out_dir
        except Exception:
            continue
    return None


def _real_reader(fold_file: str, fmt: str):
    gen = _GENERATORS[fmt]

    def reader():
        with open(fold_file) as f:
            for group in group_by_query(f):
                yield from gen(group)

    return reader


def _synthetic_queries(n_queries, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(FEATURE_DIM)
    for _ in range(n_queries):
        n_docs = int(rng.randint(5, 20))
        feats = rng.randn(n_docs, FEATURE_DIM).astype(np.float32)
        scores = feats @ w + 0.5 * rng.randn(n_docs)
        rels = np.digitize(scores, np.percentile(scores, [33, 66]))
        group = sorted(((float(rels[i]), feats[i]) for i in range(n_docs)),
                       key=lambda x: -x[0])
        yield group


def _synth_reader(n_queries, seed, fmt):
    gen = _GENERATORS[fmt]

    def reader():
        for group in _synthetic_queries(n_queries, seed):
            yield from gen(group)

    return reader


def _fold_path(split: str) -> Optional[str]:
    try:
        rar = common.download(URL, "MQ2007", MD5)
        root = _extract_rar(rar)
        if root is None:
            return None
        path = os.path.join(root, "MQ2007", "Fold1", f"{split}.txt")
        return path if os.path.exists(path) else None
    except Exception:
        return None


def train(format: str = "pairwise"):
    fold = _fold_path("train")
    if fold is None:
        return _synth_reader(512, 90, format)
    return _real_reader(fold, format)


def test(format: str = "pairwise"):
    fold = _fold_path("test")
    if fold is None:
        return _synth_reader(64, 91, format)
    return _real_reader(fold, format)


def fetch() -> None:
    common.download(URL, "MQ2007", MD5)
