"""CoNLL-05 semantic role labeling dataset.

Reference: python/paddle/v2/dataset/conll05.py (public test tarball with
words.gz/props.gz, star-bracket props -> BIO tags, context-window sample
construction). Samples are 9-tuples:
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, label_ids)
where every ctx/pred slot is broadcast to sentence length (the SRL demo's
input layout). Real pipeline with a synthetic fallback when offline.
"""

from __future__ import annotations

import gzip
import itertools
import tarfile
from typing import Dict, Iterator, List, Tuple

import numpy as np

from paddle_tpu_torch.dataset import common

DATA_URL = "http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz"
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
WORDDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
                "srl_dict_and_embedding/wordDict.txt")
WORDDICT_MD5 = "ea7fb7d4c75cc6254716f0177a506baa"
VERBDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
                "srl_dict_and_embedding/verbDict.txt")
VERBDICT_MD5 = "0d2977293bbb6cbefab5b0f97db1e77c"
TRGDICT_URL = ("http://paddlepaddle.bj.bcebos.com/demo/"
               "srl_dict_and_embedding/targetDict.txt")
TRGDICT_MD5 = "d8c7f03ceb5fc2e5a0fa7503a4353751"
EMB_URL = "http://paddlepaddle.bj.bcebos.com/demo/srl_dict_and_embedding/emb"
EMB_MD5 = "bf436eb0faa1f6f9103017f8be57cdb7"

WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"

UNK_IDX = 0

# offline-fallback dims
WORD_DIM = 4000
LABEL_DIM = 67
PRED_DIM = 300


def load_dict(filename: str) -> Dict[str, int]:
    """One token per line -> zero-based index map."""
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def props_to_bio(prop_columns: List[List[str]]) -> Iterator[Tuple[int, List[str]]]:
    """Convert star-bracket proposition columns to BIO tag sequences.

    Column 0 holds the verbs ('-' for non-predicates); columns 1.. hold one
    argument layer per predicate in star notation: '(A0*', '*', '*)' ...
    Yields (predicate_index_in_verb_column, bio_tags).
    """
    verbs = [v for v in prop_columns[0] if v != "-"]
    for i, col in enumerate(prop_columns[1:]):
        cur, inside = "O", False
        tags: List[str] = []
        for tok in col:
            if tok == "*":
                tags.append("I-" + cur if inside else "O")
            elif tok == "*)":
                tags.append("I-" + cur)
                inside = False
            elif "(" in tok and ")" in tok:
                cur = tok[1:tok.find("*")]
                tags.append("B-" + cur)
                inside = False
            elif "(" in tok:
                cur = tok[1:tok.find("*")]
                tags.append("B-" + cur)
                inside = True
            else:
                raise ValueError(f"unexpected prop label {tok!r}")
        yield verbs[i], tags


def corpus_reader(words_lines, props_lines):
    """Pair a words stream with a props stream; blank line = sentence end.
    Yields (sentence_words, predicate, bio_tags) per predicate."""
    sentence: List[str] = []
    columns: List[List[str]] = []
    for word, prop in itertools.zip_longest(words_lines, props_lines,
                                            fillvalue=""):
        if isinstance(word, bytes):
            word = word.decode("utf-8", errors="ignore")
        if isinstance(prop, bytes):
            prop = prop.decode("utf-8", errors="ignore")
        word = word.strip()
        fields = prop.strip().split()
        if not fields:  # end of sentence
            if columns:
                ncol = len(columns[0])
                col_major = [[row[i] for row in columns] for i in range(ncol)]
                for verb, tags in props_to_bio(col_major):
                    yield sentence, verb, tags
            sentence, columns = [], []
        else:
            sentence.append(word)
            columns.append(fields)


def make_sample(sentence: List[str], predicate: str, tags: List[str],
                word_dict: Dict[str, int], verb_dict: Dict[str, int],
                label_dict: Dict[str, int]):
    """Context-window sample construction: 5 context words around the
    predicate (bos/eos beyond the edges), a +-2 window mark vector, all
    broadcast to sentence length."""
    sen_len = len(sentence)
    v = tags.index("B-V")
    mark = [0] * sen_len

    def ctx(offset, fallback):
        i = v + offset
        if 0 <= i < sen_len:
            mark[i] = 1
            return sentence[i]
        return fallback

    ctx_0 = ctx(0, None)
    ctx_n1 = ctx(-1, "bos")
    ctx_n2 = ctx(-2, "bos")
    ctx_p1 = ctx(1, "eos")
    ctx_p2 = ctx(2, "eos")

    word_ids = [word_dict.get(w, UNK_IDX) for w in sentence]
    bcast = lambda w: [word_dict.get(w, UNK_IDX)] * sen_len
    pred_ids = [verb_dict.get(predicate, 0)] * sen_len
    label_ids = [label_dict[t] for t in tags]
    return (word_ids, bcast(ctx_n2), bcast(ctx_n1), bcast(ctx_0),
            bcast(ctx_p1), bcast(ctx_p2), pred_ids, mark, label_ids)


def _real_reader(tar_path: str, word_dict, verb_dict, label_dict):
    def reader():
        with tarfile.open(tar_path) as tf:
            wf = tf.extractfile(WORDS_NAME)
            pf = tf.extractfile(PROPS_NAME)
            with gzip.GzipFile(fileobj=wf) as words, \
                    gzip.GzipFile(fileobj=pf) as props:
                for sentence, verb, tags in corpus_reader(words, props):
                    yield make_sample(sentence, verb, tags, word_dict,
                                      verb_dict, label_dict)

    return reader


def get_dict():
    """(word_dict, verb_dict, label_dict) — downloaded, or synthetic dims."""
    try:
        return _real_dicts()
    except Exception:
        return ({f"w{i}": i for i in range(WORD_DIM)},
                {f"v{i}": i for i in range(PRED_DIM)},
                {f"l{i}": i for i in range(LABEL_DIM)})


def get_embedding() -> str:
    return common.download(EMB_URL, "conll05st", EMB_MD5)


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(5, 30))
        words = [int(w) for w in rng.randint(0, WORD_DIM, length)]
        v = int(rng.randint(length))
        mark = [0] * length
        for off in (-2, -1, 0, 1, 2):
            if 0 <= v + off < length:
                mark[v + off] = 1
        bcast = lambda: [int(rng.randint(WORD_DIM))] * length
        pred = [int(rng.randint(PRED_DIM))] * length
        labels = [int(l) for l in rng.randint(0, LABEL_DIM, length)]
        yield (words, bcast(), bcast(), bcast(), bcast(), bcast(), pred,
               mark, labels)


def _real_dicts():
    """Real dicts or raise — never pair the real corpus with synthetic
    dicts (make_sample would KeyError on real BIO tags mid-iteration)."""
    return (load_dict(common.download(WORDDICT_URL, "conll05st",
                                      WORDDICT_MD5)),
            load_dict(common.download(VERBDICT_URL, "conll05st",
                                      VERBDICT_MD5)),
            load_dict(common.download(TRGDICT_URL, "conll05st",
                                      TRGDICT_MD5)))


def test():
    """CoNLL-05 ships only its test split publicly (the reference notes the
    train set is licensed); `train()` mirrors it for demo parity."""
    try:
        path = common.download(DATA_URL, "conll05st", DATA_MD5)
        word_dict, verb_dict, label_dict = _real_dicts()
    except Exception:
        return lambda: _synthetic(128, 41)
    return _real_reader(path, word_dict, verb_dict, label_dict)


def train():
    try:
        path = common.download(DATA_URL, "conll05st", DATA_MD5)
        word_dict, verb_dict, label_dict = _real_dicts()
    except Exception:
        return lambda: _synthetic(1024, 40)
    return _real_reader(path, word_dict, verb_dict, label_dict)


def fetch() -> None:
    for url, name, md5 in ((WORDDICT_URL, "conll05st", WORDDICT_MD5),
                           (VERBDICT_URL, "conll05st", VERBDICT_MD5),
                           (TRGDICT_URL, "conll05st", TRGDICT_MD5),
                           (EMB_URL, "conll05st", EMB_MD5),
                           (DATA_URL, "conll05st", DATA_MD5)):
        common.download(url, name, md5)
