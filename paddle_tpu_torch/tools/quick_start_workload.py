"""The quick_start text classifiers that ``chip_smoke.py`` drives.

Every architecture of ``models/quick_start`` (v1_api_demo/quick_start's
``trainer_config.{lr,emb,cnn,lstm,bidi-lstm,db-lstm,resnet-lstm}.py``) at
the demo's width: a dictionary of 30000 words, embeddings of 128, batch
128, Adam at 2e-3 (the demo's settings without its L2 and gradient
clipping).  ``lr`` reads a dense bag of words of 30000.

The demo's reviews are not in the repository: a review is a seeded
synthetic one of 10 to 100 tokens whose label says whether most of its
words come from the first half of the dictionary.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import optimizer, topology, trainer
from paddle_tpu_torch.convert import parameters_from_numpy
from paddle_tpu_torch.models import quick_start
from paddle_tpu_torch.tools.ctr_workload import numpy_params

DEMO = dict(dict_size=30000, emb_size=128)
BATCH, LEARNING_RATE = 128, 2e-3
SEED = 0              # weights; the data uses SEED + 1
FEEDING = None        # the data layers' declaration order


def repeat_reader(batch, steps: int):
    """A reader that yields the same batch ``steps`` times."""
    return lambda: iter([batch] * steps)


def reviews(rs, n: int, dict_size: int, lo: int = 10, hi: int = 101):
    """``n`` (token ids, label) samples of ``lo`` to ``hi - 1`` tokens."""
    out = []
    for _ in range(n):
        label = int(rs.randint(2))
        length = int(rs.randint(lo, hi))
        half = dict_size // 2
        lean = rs.rand(length) < 0.7
        toks = np.where(lean == bool(label), rs.randint(0, half, length),
                        rs.randint(half, dict_size, length))
        out.append((toks.tolist(), label))
    return out


def bag_of_words(samples, dict_size: int):
    """The ``lr`` architecture's samples: each review as a dense count
    vector of ``dict_size``."""
    out = []
    for toks, label in samples:
        bow = np.zeros(dict_size, np.float32)
        np.add.at(bow, np.asarray(toks), 1.0)
        out.append((bow, label))
    return out


def batch(arch: str, dims=None, bs: int = BATCH, seed: int = SEED + 1):
    dims = dims or DEMO
    rows = reviews(np.random.RandomState(seed), bs, dims["dict_size"])
    return bag_of_words(rows, dims["dict_size"]) if arch == "lr" else rows


def build_trainer(arch: str, device, dims=None,
                  learning_rate: float = LEARNING_RATE):
    """(SGD over ``arch``'s cost at ``dims`` (the demo's by default), its
    output node)."""
    topology.reset_name_scope()
    _, _, output, cost = quick_start.build(arch, **(dims or DEMO))
    specs = topology.Topology([cost]).param_specs()
    params = parameters_from_numpy(numpy_params(specs, SEED), device=device)
    sgd = trainer.SGD(cost, params,
                      optimizer.Adam(learning_rate=learning_rate),
                      device=device)
    return sgd, output
