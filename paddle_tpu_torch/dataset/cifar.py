"""CIFAR-10/100 (reference: v2/dataset/cifar.py). Synthetic fallback offline."""
import numpy as np

from paddle_tpu_torch.dataset import common

URL10 = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
MD5_10 = "c58f30108f718f92721af3b95e74349a"
URL100 = "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz"
MD5_100 = "eb9058c3a382ffc7106e4002c42a8d85"


def _synthetic(n, num_classes, seed):
    rng = np.random.RandomState(seed)
    templates = rng.randn(num_classes, 3072).astype(np.float32)
    labels = rng.randint(0, num_classes, n)
    imgs = np.tanh(templates[labels] * 0.4 +
                   rng.randn(n, 3072).astype(np.float32) * 0.4)
    for i in range(n):
        yield imgs[i], int(labels[i])


def _real_reader(url, md5, sub_name, batch_names):
    import pickle
    import tarfile

    path = common.download(url, "cifar", md5)

    def reader():
        with tarfile.open(path) as tar:
            for m in tar.getmembers():
                if any(b in m.name for b in batch_names):
                    d = pickle.load(tar.extractfile(m), encoding="bytes")
                    labels = d.get(b"labels", d.get(b"fine_labels"))
                    for img, lab in zip(d[b"data"], labels):
                        yield (img.astype(np.float32) / 255.0, int(lab))

    return reader


def train10():
    try:
        return _real_reader(URL10, MD5_10, "cifar-10", ["data_batch"])
    except Exception:
        return lambda: _synthetic(4096, 10, 0)


def test10():
    try:
        return _real_reader(URL10, MD5_10, "cifar-10", ["test_batch"])
    except Exception:
        return lambda: _synthetic(512, 10, 1)


def train100():
    try:
        return _real_reader(URL100, MD5_100, "cifar-100", ["train"])
    except Exception:
        return lambda: _synthetic(4096, 100, 2)


def test100():
    try:
        return _real_reader(URL100, MD5_100, "cifar-100", ["test"])
    except Exception:
        return lambda: _synthetic(512, 100, 3)
