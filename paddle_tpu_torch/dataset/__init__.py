"""Datasets (a copy of ``paddle_tpu/dataset``: common, mnist, cifar,
uci_housing, imdb, imikolov, movielens, conll05, wmt14, sentiment,
mq2007, and flowers and voc2012, which read images through
``image.py``).

Each module downloads its data when it can, with an md5-checked cache
under ``common.DATA_HOME`` (``$PADDLE_TPU_DATA_HOME``, default
``~/.cache/paddle_tpu/dataset``: the JAX package's, so files placed once
serve both packages), and falls back to the same seeded synthetic
samples as the JAX package when the download fails.  A caller that must
not reach the network replaces ``common.download`` with a function that
raises, as the tests do.
"""

from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.dataset import cifar
from paddle_tpu_torch.dataset import uci_housing
from paddle_tpu_torch.dataset import imdb
from paddle_tpu_torch.dataset import imikolov
from paddle_tpu_torch.dataset import movielens
from paddle_tpu_torch.dataset import conll05
from paddle_tpu_torch.dataset import wmt14
from paddle_tpu_torch.dataset import sentiment
from paddle_tpu_torch.dataset import mq2007
from paddle_tpu_torch.dataset import flowers
from paddle_tpu_torch.dataset import voc2012

__all__ = ["common", "mnist", "cifar", "uci_housing", "imdb", "imikolov",
           "movielens", "conll05", "wmt14", "sentiment", "mq2007",
           "flowers", "voc2012"]
