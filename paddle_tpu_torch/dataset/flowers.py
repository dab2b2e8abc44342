"""Oxford-102 flowers (a copy of ``paddle_tpu/dataset/flowers.py``;
reference: v2/dataset/flowers.py): 102flowers.tgz with the
imagelabels.mat and setid.mat split files; the splits swapped as the
reference swaps them ('tstid', the larger, trains).  Samples are (the
image through ``image.simple_transform`` at 256 / 224 less the BGR
ImageNet mean, flattened HWC float32; the 0-based label).  Offline it
yields the JAX package's synthetic 3 x 32 x 32 samples (not VGG's input
size)."""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from paddle_tpu_torch import image as pimage
from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.reader.decorator import map_readers, xmap_readers

DATA_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/102flowers.tgz"
LABEL_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/imagelabels.mat"
SETID_URL = "http://www.robots.ox.ac.uk/~vgg/data/flowers/102/setid.mat"
DATA_MD5 = "52808999861908f626f3c1f4e79d11fa"
LABEL_MD5 = "e0620be6f572b9609742df49c70aed4d"
SETID_MD5 = "a5357ecc9cb78c4bef273ce3793fc85c"

TRAIN_FLAG = "tstid"
TEST_FLAG = "trnid"
VALID_FLAG = "valid"

# ImageNet channel means in BGR order (OpenCV's decode order)
MEAN_BGR = [103.94, 116.78, 123.68]


def default_mapper(is_train: bool, sample):
    img_bytes, label = sample
    img = pimage.load_image_bytes(img_bytes)
    mean = MEAN_BGR if pimage.channel_order() == "BGR" else MEAN_BGR[::-1]
    img = pimage.simple_transform(img, 256, 224, is_train, mean=mean)
    return img.flatten().astype(np.float32), label


train_mapper = functools.partial(default_mapper, True)
test_mapper = functools.partial(default_mapper, False)


def split_img2label(label_mat_path: str, setid_mat_path: str,
                    flag: str) -> Dict[str, int]:
    """jpg member name -> 1-based label for the split ``flag``."""
    import scipy.io as scio

    labels = scio.loadmat(label_mat_path)["labels"][0]
    indexes = scio.loadmat(setid_mat_path)[flag][0]
    return {f"jpg/image_{i:05d}.jpg": int(labels[i - 1]) for i in indexes}


def _reader_creator(data_file, label_file, setid_file, flag, mapper,
                    buffered_size=1024, use_xmap=True):
    import pickle

    img2label = split_img2label(label_file, setid_file, flag)
    file_list = pimage.batch_images_from_tar(data_file, flag, img2label)

    def reader():
        with open(file_list) as flist:
            for batch_path in flist:
                with open(batch_path.strip(), "rb") as f:
                    batch = pickle.load(f)
                for sample, label in zip(batch["data"], batch["label"]):
                    yield sample, int(label) - 1

    if use_xmap:
        import multiprocessing

        return xmap_readers(mapper, reader, multiprocessing.cpu_count(),
                            buffered_size)
    return map_readers(mapper, reader)


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    templates = rng.randn(102, 3 * 32 * 32).astype(np.float32)
    for _ in range(n):
        lab = int(rng.randint(102))
        img = np.tanh(templates[lab] * 0.4 + rng.randn(3 * 32 * 32) * 0.4)
        yield img.astype(np.float32), lab


def _make(flag, mapper, buffered_size, use_xmap, synth_n, synth_seed):
    try:
        data = common.download(DATA_URL, "flowers", DATA_MD5)
        label = common.download(LABEL_URL, "flowers", LABEL_MD5)
        setid = common.download(SETID_URL, "flowers", SETID_MD5)
    except Exception:
        return lambda: _synthetic(synth_n, synth_seed)
    return _reader_creator(data, label, setid, flag, mapper, buffered_size,
                           use_xmap)


def train(mapper=train_mapper, buffered_size=1024, use_xmap=True):
    return _make(TRAIN_FLAG, mapper, buffered_size, use_xmap, 1024, 60)


def test(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    return _make(TEST_FLAG, mapper, buffered_size, use_xmap, 128, 61)


def valid(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    return _make(VALID_FLAG, mapper, buffered_size, use_xmap, 128, 62)


def fetch() -> None:
    common.download(DATA_URL, "flowers", DATA_MD5)
    common.download(LABEL_URL, "flowers", LABEL_MD5)
    common.download(SETID_URL, "flowers", SETID_MD5)
