"""PASCAL VOC2012 segmentation (a copy of
``paddle_tpu/dataset/voc2012.py``; reference: v2/dataset/voc2012.py): the
trainval tar's Segmentation image sets pair JPEGImages/<name>.jpg with
the palette-indexed SegmentationClass/<name>.png; samples are (image HWC
uint8, label HW class ids, 255 void).  Offline it yields the JAX
package's synthetic 32 x 32 samples."""

from __future__ import annotations

import tarfile

import numpy as np

from paddle_tpu_torch import image as pimage
from paddle_tpu_torch.dataset import common

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")
VOC_MD5 = "6cd6e144f989b92b3379bac3b3de84fd"

SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"


def _decode_png_indexed(data: bytes) -> np.ndarray:
    """Palette PNG -> HW index array (class ids, 255 = void)."""
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def reader_creator(tar_path: str, sub_name: str):
    def reader():
        with tarfile.open(tar_path) as tf:
            members = {m.name: m for m in tf.getmembers()}
            sets = tf.extractfile(members[SET_FILE.format(sub_name)])
            for line in sets:
                name = line.decode("utf-8").strip()
                if not name:
                    continue
                img_bytes = tf.extractfile(
                    members[DATA_FILE.format(name)]).read()
                lab_bytes = tf.extractfile(
                    members[LABEL_FILE.format(name)]).read()
                yield (pimage.load_image_bytes(img_bytes),
                       _decode_png_indexed(lab_bytes))

    return reader


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        img = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
        seg = rng.randint(0, 21, (32, 32)).astype(np.uint8)
        yield img, seg


def _make(sub_name, synth_n, synth_seed):
    try:
        path = common.download(VOC_URL, "voc2012", VOC_MD5)
    except Exception:
        return lambda: _synthetic(synth_n, synth_seed)
    return reader_creator(path, sub_name)


def train():
    return _make("trainval", 256, 70)


def test():
    return _make("train", 64, 71)


def val():
    return _make("val", 64, 72)


def fetch() -> None:
    common.download(VOC_URL, "voc2012", VOC_MD5)
