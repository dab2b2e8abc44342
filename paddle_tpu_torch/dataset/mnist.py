"""MNIST dataset (reference: v2/dataset/mnist.py).

Samples: (image: float32[784] scaled to [-1,1], label: int). Falls back to a
deterministic synthetic digit set when offline (no egress in CI).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from paddle_tpu_torch.dataset import common

URL_PREFIX = "https://storage.googleapis.com/cvdf-datasets/mnist/"
TRAIN_IMAGE = ("train-images-idx3-ubyte.gz", "f68b3c2dcbeaaa9fbdd348bbdeb94873")
TRAIN_LABEL = ("train-labels-idx1-ubyte.gz", "d53e105ee54ea40749a09fcbcd1e9432")
TEST_IMAGE = ("t10k-images-idx3-ubyte.gz", "9fb629c4189551a2d022fa330f9573f3")
TEST_LABEL = ("t10k-labels-idx1-ubyte.gz", "ec29112dd5afa0611ce80d1b7f02629c")


def _parse_idx(images_path: str, labels_path: str):
    with gzip.open(images_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    with gzip.open(labels_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8)
    images = images.astype(np.float32) / 255.0 * 2.0 - 1.0
    return images, labels.astype(np.int64)


def _synthetic(n: int, seed: int):
    """Deterministic class-structured fake digits: each class k is a distinct
    smoothed template + noise, so simple models actually learn. Templates are
    seed-independent so train/test share the class structure."""
    templates = np.random.RandomState(1234).randn(10, 784).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n)
    images = templates[labels] * 0.5 + rng.randn(n, 784).astype(np.float32) * 0.3
    images = np.tanh(images)
    return images.astype(np.float32), labels.astype(np.int64)


def _reader(images, labels):
    def reader():
        for img, lab in zip(images, labels):
            yield img, int(lab)

    return reader


def _load(image_meta, label_meta, synth_n, synth_seed):
    try:
        img_path = common.download(URL_PREFIX + image_meta[0], "mnist", image_meta[1])
        lab_path = common.download(URL_PREFIX + label_meta[0], "mnist", label_meta[1])
        return _parse_idx(img_path, lab_path)
    except Exception:
        return _synthetic(synth_n, synth_seed)


def train():
    images, labels = _load(TRAIN_IMAGE, TRAIN_LABEL, 8192, 0)
    return _reader(images, labels)


def test():
    images, labels = _load(TEST_IMAGE, TEST_LABEL, 1024, 1)
    return _reader(images, labels)
