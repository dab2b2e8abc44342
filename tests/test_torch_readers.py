"""The port's readers, datasets and prefetch against the JAX package's,
on the CPU.

Every reader decorator and creator gives JAX's samples under one
``random.seed``; every ported dataset's synthetic fallback gives JAX's
first 64 samples (and dictionaries) exactly; the real parsers read the
same tiny archives, built here in the reference's formats, to the same
samples; ``device_prefetch`` gives the sequential feeds, hands a
producer's error to the consumer after the batches before it, and stops
its producer when the consumer stops early.  ``common.download`` refuses
in both packages, so no test reaches the network.
"""

import gzip
import io
import os
import random
import re
import struct
import tarfile
import threading
import zipfile

import numpy as np
import pytest
import torch

from paddle_tpu import reader as jreader
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import (cifar as jcifar, conll05 as jconll05,
                                imdb as jimdb, imikolov as jimikolov,
                                mnist as jmnist, movielens as jmovielens,
                                mq2007 as jmq2007, sentiment as jsentiment,
                                uci_housing as juci, wmt14 as jwmt14)

from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.dataset import (cifar as tcifar, conll05 as tconll05,
                                      imdb as timdb, imikolov as timikolov,
                                      mnist as tmnist,
                                      movielens as tmovielens,
                                      mq2007 as tmq2007,
                                      sentiment as tsentiment,
                                      uci_housing as tuci, wmt14 as twmt14)
from paddle_tpu_torch.reader.prefetch import device_prefetch


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise IOError("offline: the tests never download")

    for common in (jcommon, tcommon):
        monkeypatch.setattr(common, "download", refuse)
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path / "home"))


def _same(a, b) -> bool:
    """Equal samples: tuples and lists item by item, arrays exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _first(reader, n=64):
    out = []
    for s in reader():
        out.append(s)
        if len(out) == n:
            break
    return out


# ---------------------------------------------------------------------------
# decorators and creators
# ---------------------------------------------------------------------------

def _numbers(n=50):
    return lambda: iter(range(n))


def _words():
    return lambda: iter(["a", "b", "c", "d", "e"])


DECORATORS = {
    "map_readers": lambda r: r.map_readers(lambda a, b: (a * 2, b),
                                           _numbers(), _words()),
    "shuffle": lambda r: r.shuffle(_numbers(), buf_size=16),
    "shuffle_whole": lambda r: r.shuffle(_numbers(), buf_size=100),
    "chain": lambda r: r.chain(_numbers(3), _words(), _numbers(2)),
    "compose": lambda r: r.compose(_numbers(5), _words(),
                                   lambda: iter([(1, 2)] * 5)),
    "compose_unchecked": lambda r: r.compose(_numbers(9), _words(),
                                             check_alignment=False),
    "buffered": lambda r: r.buffered(_numbers(), size=4),
    "firstn": lambda r: r.firstn(_numbers(), 7),
    "xmap_ordered": lambda r: r.xmap_readers(lambda x: x * x, _numbers(), 3,
                                             4, order=True),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_decorator_matches_jax(name):
    random.seed(5)
    want = list(DECORATORS[name](jreader)())
    random.seed(5)
    got = list(DECORATORS[name](treader)())
    assert got == want


def test_xmap_unordered_and_compose_alignment_match_jax():
    want = sorted(jreader.xmap_readers(lambda x: -x, _numbers(), 4, 2)())
    got = sorted(treader.xmap_readers(lambda x: -x, _numbers(), 4, 2)())
    assert got == want
    for r in (jreader, treader):
        with pytest.raises(ValueError, match="different lengths"):
            list(r.compose(_numbers(3), _numbers(4))())


def test_creators_match_jax(tmp_path):
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert _same(list(treader.creator.np_array(arr)()),
                 list(jreader.creator.np_array(arr)()))
    text = tmp_path / "lines.txt"
    text.write_text("first\nsecond line\n\nlast")
    assert list(treader.creator.text_file(str(text))()) == \
        list(jreader.creator.text_file(str(text))()) == \
        ["first", "second line", "", "last"]
    paths = []
    for i in range(2):
        p = tmp_path / f"part{i}.rec"
        with open(p, "wb") as f:
            for rec in (b"alpha%d" % i, b"", b"\x00\x01" * 5):
                f.write(struct.pack("<Q", len(rec)) + rec)
        paths.append(str(p))
    want = list(jreader.creator.recordio(",".join(paths))())
    assert list(treader.creator.recordio(",".join(paths))()) == want
    assert list(treader.creator.recordio(paths)()) == want
    assert len(want) == 6
    with pytest.raises(Exception, match="A13"):
        treader.creator.cloud_reader(paths)


# ---------------------------------------------------------------------------
# synthetic fallbacks: the first 64 samples of every ported dataset
# ---------------------------------------------------------------------------

FALLBACKS = {
    "mnist.train": lambda m: m["mnist"].train(),
    "mnist.test": lambda m: m["mnist"].test(),
    "cifar.train10": lambda m: m["cifar"].train10(),
    "cifar.test10": lambda m: m["cifar"].test10(),
    "cifar.train100": lambda m: m["cifar"].train100(),
    "cifar.test100": lambda m: m["cifar"].test100(),
    "uci_housing.train": lambda m: m["uci"].train(),
    "uci_housing.test": lambda m: m["uci"].test(),
    "imdb.train": lambda m: m["imdb"].train(m["imdb"].word_dict()),
    "imdb.test": lambda m: m["imdb"].test(),
    "imikolov.train": lambda m: m["imikolov"].train(
        m["imikolov"].build_dict(), 5),
    "imikolov.test_seq": lambda m: m["imikolov"].test(
        m["imikolov"].build_dict(), 0, m["imikolov"].DataType.SEQ),
    "sentiment.train": lambda m: m["sentiment"].train(),
    "sentiment.test": lambda m: m["sentiment"].test(
        m["sentiment"].get_word_dict()),
    "wmt14.train": lambda m: m["wmt14"].train(),
    "wmt14.test": lambda m: m["wmt14"].test(1000),
    "wmt14.gen": lambda m: m["wmt14"].gen(),
    "conll05.train": lambda m: m["conll05"].train(),
    "conll05.test": lambda m: m["conll05"].test(),
    "movielens.train": lambda m: m["movielens"].train(),
    "movielens.test": lambda m: m["movielens"].test(),
    "mq2007.train_pairwise": lambda m: m["mq2007"].train(),
    "mq2007.train_pointwise": lambda m: m["mq2007"].train(
        format="pointwise"),
    "mq2007.test_listwise": lambda m: m["mq2007"].test(format="listwise"),
}
JAX_MODULES = {"mnist": jmnist, "cifar": jcifar, "uci": juci, "imdb": jimdb,
               "imikolov": jimikolov, "sentiment": jsentiment,
               "wmt14": jwmt14, "conll05": jconll05,
               "movielens": jmovielens, "mq2007": jmq2007}
PORT_MODULES = {"mnist": tmnist, "cifar": tcifar, "uci": tuci,
                "imdb": timdb, "imikolov": timikolov,
                "sentiment": tsentiment, "wmt14": twmt14,
                "conll05": tconll05, "movielens": tmovielens,
                "mq2007": tmq2007}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_synthetic_fallback_matches_jax(name):
    want = _first(FALLBACKS[name](JAX_MODULES))
    got = _first(FALLBACKS[name](PORT_MODULES))
    assert len(got) == len(want) > 0
    assert _same(got, want)


def test_dictionaries_and_data_home_match_jax():
    assert timdb.word_dict() == jimdb.word_dict()
    assert len(timdb.word_dict()) == 5147
    assert timikolov.build_dict() == jimikolov.build_dict()
    assert tsentiment.get_word_dict() == jsentiment.get_word_dict()
    # wmt14's dictionaries have no fallback: offline both packages raise
    for mod in (twmt14, jwmt14):
        with pytest.raises(IOError, match="offline"):
            mod.get_dict()
    assert _same(tconll05.get_dict(), jconll05.get_dict())
    # the same variable and default directory: files placed once serve
    # both packages
    assert tcommon.DATA_HOME == jcommon.DATA_HOME
    assert tcommon.data_home() == jcommon.data_home()


# ---------------------------------------------------------------------------
# the real parsers on tiny archives in the reference's formats
# ---------------------------------------------------------------------------

def _add_bytes(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _imdb_tar(tmp_path):
    path = str(tmp_path / "aclImdb.tar.gz")
    docs = {
        "aclImdb/train/pos/0_9.txt": b"A great, GREAT movie!",
        "aclImdb/train/pos/1_8.txt": b"great fun; truly great",
        "aclImdb/train/neg/0_2.txt": b"terrible movie. boring",
        "aclImdb/train/neg/1_1.txt": b"boring and terrible...",
        "aclImdb/test/pos/0_10.txt": b"great",
        "aclImdb/test/neg/0_1.txt": b"terrible",
    }
    with tarfile.open(path, "w:gz") as tf:
        for name, data in docs.items():
            _add_bytes(tf, name, data)
    return path


def test_imdb_parser_matches_jax(tmp_path):
    tar = _imdb_tar(tmp_path)
    pat = re.compile(r"aclImdb/train/.*\.txt$")
    d = timdb.build_dict(pat, 0, tar_path=tar)
    assert d == jimdb.build_dict(pat, 0, tar_path=tar)
    assert list(timdb.tokenize(pat, tar_path=tar)) == \
        list(jimdb.tokenize(pat, tar_path=tar))
    args = (r"aclImdb/train/pos/.*\.txt$", r"aclImdb/train/neg/.*\.txt$", d)
    got = list(timdb._real_reader(*args, tar_path=tar)())
    assert got == list(jimdb._real_reader(*args, tar_path=tar)())
    assert [lab for _, lab in got] == [0, 1, 0, 1]


def test_imikolov_parser_matches_jax():
    train, test = [b"the cat sat", b"the dog sat"], [b"the cat ran"]
    d = timikolov.build_dict_from_files(train, test, min_word_freq=0)
    assert d == jimikolov.build_dict_from_files(train, test, 0)
    for n, kind in ((2, timikolov.DataType.NGRAM),
                    (0, timikolov.DataType.SEQ)):
        assert list(timikolov.parse_lines(train, d, n, kind)) == \
            list(jimikolov.parse_lines(train, d, n, kind))


def test_wmt14_parser_matches_jax(tmp_path):
    path = str(tmp_path / "wmt14.tgz")
    with tarfile.open(path, "w:gz") as tf:
        _add_bytes(tf, "wmt14/train/src.dict", b"<s>\n<e>\n<unk>\nle\nchat\n")
        _add_bytes(tf, "wmt14/train/trg.dict", b"<s>\n<e>\n<unk>\nthe\ncat\n")
        _add_bytes(tf, "wmt14/train/train",
                   b"le chat\tthe cat\nle inconnu\tthe cat\n")
    dicts = twmt14.read_dicts_from_tar(path, 30000)
    assert dicts == jwmt14.read_dicts_from_tar(path, 30000)
    with tarfile.open(path) as f:
        lines = list(f.extractfile("wmt14/train/train"))
    got = list(twmt14.parse_lines(lines, *dicts))
    assert got == list(jwmt14.parse_lines(lines, *dicts))
    assert got[0][0] == [0, 3, 4, 1]


def test_conll05_parser_matches_jax():
    words = [b"He", b"ate", b"rice", b""]
    props = [b"-  *", b"eat  (V*)", b"-  (A1*)", b""]
    got = list(tconll05.corpus_reader(words, props))
    assert got == list(jconll05.corpus_reader(words, props))
    wd = {"He": 1, "ate": 2, "rice": 3, "bos": 4, "eos": 5}
    vd, ld = {"eat": 0}, {"O": 0, "B-V": 1, "B-A1": 2}
    assert tconll05.make_sample(*got[0], wd, vd, ld) == \
        jconll05.make_sample(*got[0], wd, vd, ld)
    cols = [["-", "run", "-", "jump"], ["(A0*", "*", "*)", "*"],
            ["*", "(A1*)", "*", "(V*)"]]
    assert list(tconll05.props_to_bio(cols)) == \
        list(jconll05.props_to_bio(cols))


def test_movielens_parsers_match_jax():
    movies = [b"1::Toy Story (1995)::Animation|Comedy",
              b"2::Jumanji (1995)::Adventure"]
    users = [b"1::F::1::10::48067", b"2::M::56::16::70072"]
    tm, jm = tmovielens.parse_movies(movies), jmovielens.parse_movies(movies)
    assert {k: (v.title, v.categories) for k, v in tm.items()} == \
        {k: (v.title, v.categories) for k, v in jm.items()}
    tu, ju = tmovielens.parse_users(users), jmovielens.parse_users(users)
    assert {k: v.value() for k, v in tu.items()} == \
        {k: v.value() for k, v in ju.items()}


def _letor_line(rel, qid, seed):
    rng = np.random.RandomState(seed)
    feats = " ".join(f"{i + 1}:{rng.rand():.6f}"
                     for i in range(jmq2007.FEATURE_DIM))
    return f"{rel} qid:{qid} {feats} #docid = G{qid}-{seed}"


def test_mq2007_parser_matches_jax():
    lines = [_letor_line(2, 10, 1), _letor_line(0, 10, 2),
             _letor_line(1, 10, 3), _letor_line(1, 20, 4),
             _letor_line(0, 20, 5), "# comment only", "1 qid:3 1:0.5"]
    for line in lines:
        assert _same(tmq2007.parse_letor_line(line),
                     jmq2007.parse_letor_line(line))
    tg = list(tmq2007.group_by_query(lines[:5]))
    assert _same(tg, list(jmq2007.group_by_query(lines[:5])))
    for gen in ("gen_point", "gen_pair", "gen_list"):
        assert _same(list(getattr(tmq2007, gen)(tg[0])),
                     list(getattr(jmq2007, gen)(tg[0])))


def test_sentiment_parser_matches_jax(tmp_path):
    path = str(tmp_path / "movie_reviews.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("movie_reviews/neg/cv000.txt", "bad awful bad")
        z.writestr("movie_reviews/neg/cv001.txt", "awful")
        z.writestr("movie_reviews/pos/cv000.txt", "good nice good")
        z.writestr("movie_reviews/pos/cv001.txt", "nice")
    assert list(tsentiment.iter_documents(path)) == \
        list(jsentiment.iter_documents(path))
    assert tsentiment.build_word_dict(path) == \
        jsentiment.build_word_dict(path)


def test_mnist_idx_parser_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (3, 28, 28)).astype(np.uint8)
    labs = np.array([7, 0, 3], np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 3) + labs.tobytes())
    got, want = tmnist._parse_idx(ip, lp), jmnist._parse_idx(ip, lp)
    assert _same(list(got), list(want))
    assert got[0].shape == (3, 784)


def test_common_md5_and_split_match_jax(tmp_path):
    p = tmp_path / "blob.bin"
    p.write_bytes(b"paddle" * 1000)
    assert tcommon.md5file(str(p)) == jcommon.md5file(str(p))
    files = tcommon.split(lambda: iter(range(10)), 4, suffix="t%05d.pkl")
    assert [os.path.basename(f) for f in files] == \
        ["t00000.pkl", "t00001.pkl", "t00002.pkl"]
    shard = tcommon.cluster_files_reader(
        os.path.join(tcommon.DATA_HOME, "t*.pkl"), 2, 1)
    assert list(shard()) == [4, 5, 6, 7]


# ---------------------------------------------------------------------------
# device_prefetch
# ---------------------------------------------------------------------------

def _feeder():
    return DataFeeder([("x", tdt.dense_vector(3)),
                       ("w", tdt.integer_value_sequence(9))], device="cpu")


def _batches(n=6):
    rng = np.random.RandomState(0)
    return [[(rng.randn(3).astype(np.float32),
              rng.randint(0, 9, int(rng.randint(1, 5))).tolist())
             for _ in range(4)] for _ in range(n)]


def test_device_prefetch_equals_the_sequential_feed():
    feeder = _feeder()
    want = [feeder.feed(b) for b in _batches()]
    got = list(device_prefetch(iter(_batches()), size=2,
                               transform=feeder.feed, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g["x"], w["x"])
        for field in ("data", "segment_ids", "lengths"):
            assert torch.equal(getattr(g["w"], field),
                               getattr(w["w"], field))
        assert g["w"].max_len == w["w"].max_len


def test_device_prefetch_hands_over_the_producers_error():
    def bad():
        yield from _batches(2)
        raise RuntimeError("boom")

    it = device_prefetch(bad(), size=1, transform=_feeder().feed,
                         device="cpu")
    assert len([next(it), next(it)]) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_device_prefetch_stops_its_producer_on_early_close():
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield {"x": torch.full((2,), float(i))}
            i += 1

    before = threading.active_count()
    it = device_prefetch(endless(), size=2, device="cpu")
    assert float(next(it)["x"][0]) == 0.0
    it.close()
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=2.0)
    assert threading.active_count() <= before
    assert len(pulled) <= 5          # at most the queue's worth beyond one


def test_train_with_prefetch_gives_the_same_bits():
    import paddle_tpu_torch as paddle

    def run(prefetch):
        paddle.topology.reset_name_scope()
        x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(3))
        w = paddle.layer.data(
            name="w", type=paddle.data_type.integer_value_sequence(9))
        emb = paddle.layer.pooling(input=paddle.layer.embedding(
            input=w, size=4), pooling_type=paddle.pooling.SumPooling())
        y = paddle.layer.fc(input=[x, emb], size=1)
        cost = paddle.layer.fc(input=y, size=1)
        params = paddle.Parameters.from_topology(
            paddle.topology.Topology([cost]), seed=3, device="cpu")
        sgd = paddle.trainer.SGD(cost, params, paddle.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1), device="cpu")
        costs = []
        sgd.train(lambda: iter(_batches()), num_passes=2, prefetch=prefetch,
                  event_handler=lambda ev: costs.append(ev.cost) if
                  isinstance(ev, paddle.event.EndIteration) else None)
        return costs, {k: v.clone() for k, v in params.as_dict().items()}

    c0, p0 = run(0)
    c2, p2 = run(2)
    assert c2 == c0 and len(c0) == 12
    for k in p0:
        assert torch.equal(p2[k], p0[k])
