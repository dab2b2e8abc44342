"""Image preprocessing (the port of ``paddle_tpu/image.py``): decode,
resize the short edge, crop, flip, mean and layout steps on numpy HWC
images, and packing a tar of images into pickled batches.

Decoding and resizing take OpenCV when it is installed (BGR, as the
reference) and Pillow otherwise (RGB), the JAX package's order; each is
imported when first needed.  Where neither is installed,
:func:`load_image_bytes` and :func:`resize_short` raise and name both:
they never guess a decode.  The other steps are numpy alone.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Dict, Optional

import numpy as np

from paddle_tpu_torch.platform.enforce import EnforceError

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw", "to_hwc",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar",
]


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _pil():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _no_decoder(what: str) -> EnforceError:
    return EnforceError(f"{what} needs an image decoder: neither OpenCV "
                        "(cv2) nor Pillow (PIL) is installed", context="image")


def channel_order() -> str:
    """The channel order :func:`load_image_bytes` gives: BGR from OpenCV,
    RGB from Pillow.  Per-channel constants (means) must follow it."""
    return "BGR" if _cv2() is not None else "RGB"


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """Raw bytes -> HWC uint8 (HW if gray)."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8),
                           1 if is_color else 0)
        if img is None:
            raise IOError("cv2 could not decode image bytes")
        return img
    image = _pil()
    if image is None:
        raise _no_decoder("load_image_bytes")
    import io

    img = image.open(io.BytesIO(data))
    return np.asarray(img.convert("RGB" if is_color else "L"))


def load_image(path: str, is_color: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def _resize(im: np.ndarray, w: int, h: int) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(im, (w, h), interpolation=cv2.INTER_LANCZOS4)
    image = _pil()
    if image is None:
        raise _no_decoder("resize_short")
    mode = "L" if im.ndim == 2 else "RGB"
    return np.asarray(image.fromarray(im, mode).resize((w, h),
                                                        image.LANCZOS))


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Resized so the SHORT edge is ``size``, the aspect ratio kept."""
    h, w = im.shape[:2]
    if h > w:
        new_w, new_h = size, int(round(h * size / w))
    else:
        new_w, new_h = int(round(w * size / h)), size
    return _resize(im, new_w, new_h)


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """HWC -> CHW (the reference's storage layout)."""
    assert im.ndim == len(order)
    return im.transpose(order)


def to_hwc(im: np.ndarray) -> np.ndarray:
    """CHW -> HWC."""
    assert im.ndim == 3
    return im.transpose(1, 2, 0)


def center_crop(im: np.ndarray, size: int,
                is_color: bool = True) -> np.ndarray:
    h, w = im.shape[:2]
    h0, w0 = (h - size) // 2, (w - size) // 2
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """A ``size`` square at a random offset (``rng``, else numpy's global
    stream: the row offset drawn first)."""
    rng = rng or np.random
    h, w = im.shape[:2]
    h0 = rng.randint(0, h - size + 1)
    w0 = rng.randint(0, w - size + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    return im[:, ::-1]


def simple_transform(im: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool, is_color: bool = True,
                     mean: Optional[np.ndarray] = None,
                     layout: str = "HWC",
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """resize_short, a random (training: then a coin flip for the mirror)
    or centre crop, float32, less ``mean`` (a per-channel mean on the HWC
    axis, else per pixel), then ``layout`` ("HWC" or "CHW")."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if rng.randint(2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            im -= mean.reshape(1, 1, -1)
        else:
            im -= mean
    if layout == "CHW" and im.ndim == 3:
        im = to_chw(im)
    return im


def load_and_transform(path: str, resize_size: int, crop_size: int,
                       is_train: bool, is_color: bool = True,
                       mean=None, layout: str = "HWC") -> np.ndarray:
    return simple_transform(load_image(path, is_color), resize_size,
                            crop_size, is_train, is_color, mean, layout)


def batch_images_from_tar(data_file: str, dataset_name: str,
                          img2label: Dict[str, int],
                          num_per_batch: int = 1024) -> str:
    """The tar's images named in ``img2label`` packed into pickled batch
    files (raw bytes and labels) beside the tar; returns the list file
    naming them.  An existing pack is reused."""
    batch_dir = data_file + "_batch"
    out_path = os.path.join(batch_dir, dataset_name)
    meta_file = os.path.join(batch_dir, dataset_name + ".txt")
    if os.path.exists(out_path):
        return meta_file
    os.makedirs(out_path)
    data, labels, file_id = [], [], 0

    def dump():
        nonlocal data, labels, file_id
        with open(os.path.join(out_path, f"batch_{file_id}"), "wb") as f:
            pickle.dump({"label": labels, "data": data}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        file_id += 1
        data, labels = [], []

    with tarfile.open(data_file) as tf:
        for mem in tf.getmembers():
            if mem.name in img2label:
                data.append(tf.extractfile(mem).read())
                labels.append(img2label[mem.name])
                if len(data) == num_per_batch:
                    dump()
    if data:
        dump()
    with open(meta_file, "a") as meta:
        for fname in sorted(os.listdir(out_path)):
            meta.write(os.path.abspath(os.path.join(out_path, fname)) + "\n")
    return meta_file
