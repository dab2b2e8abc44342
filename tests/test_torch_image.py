"""``image.py``, ``dataset/flowers.py``, ``dataset/voc2012.py``,
``plot.py`` and ``platform/stats.py``, the port against the JAX package
on the CPU.

The image steps run on the same arrays with the same ``RandomState``
seeds and must give the same arrays, decoding and resizing through
OpenCV where it is installed and through Pillow with OpenCV hidden (in
both packages: the JAX package's module attribute ``cv2`` and the port's
``_cv2`` patched); without either decoder the port's
``load_image_bytes`` and ``resize_short`` raise and name both.  The datasets: both packages' ``common.download`` refuse
(``monkeypatch``) and ``DATA_HOME`` points at ``tmp_path``, so each
yields its synthetic fallback, held sample for sample; the real readers
run on tiny archives written here (flowers' tgz with its two .mat files,
VOC's tar with a segmentation set), each package on its own copy.  The
plotter's text fallback and the timers' report read the same.
"""

import io
import os
import pickle
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from paddle_tpu import image as jimage
from paddle_tpu import plot as jplot
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.dataset import flowers as jflowers
from paddle_tpu.dataset import voc2012 as jvoc
from paddle_tpu.platform import stats as jstats

from paddle_tpu_torch import image as timage
from paddle_tpu_torch import plot as tplot
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.dataset import flowers as tflowers
from paddle_tpu_torch.dataset import voc2012 as tvoc
from paddle_tpu_torch.platform import stats as tstats


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _image(h=37, w=53, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("decoder", ["installed", "pillow"])
def test_decode_and_resize_match_jax(decoder, monkeypatch):
    if decoder == "pillow":
        monkeypatch.setattr(jimage, "cv2", None)
        monkeypatch.setattr(timage, "_cv2", lambda: None)
        assert timage.channel_order() == "RGB"
    img = _image()
    data = _png(img)
    assert timage.channel_order() == jimage.channel_order()
    np.testing.assert_array_equal(timage.load_image_bytes(data),
                                  jimage.load_image_bytes(data))
    np.testing.assert_array_equal(timage.load_image_bytes(data, False),
                                  jimage.load_image_bytes(data, False))
    for size in (16, 40):
        got = timage.resize_short(img, size)
        np.testing.assert_array_equal(got, jimage.resize_short(img, size))
        assert min(got.shape[:2]) == size
    gray = img[..., 0]
    np.testing.assert_array_equal(timage.resize_short(gray, 20),
                                  jimage.resize_short(gray, 20))


# a per-pixel mean applies before the transpose, so it comes in HWC only
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("layout,mean", [("HWC", None), ("CHW", None),
                                         ("HWC", "channel"),
                                         ("CHW", "channel"),
                                         ("HWC", "pixel")])
def test_simple_transform_matches_jax(is_train, layout, mean):
    img = _image(seed=1)
    if mean == "channel":
        m = np.asarray([103.94, 116.78, 123.68], np.float32)
    elif mean == "pixel":
        m = np.random.RandomState(2).rand(24, 24, 3).astype(np.float32)
    else:
        m = None
    got = timage.simple_transform(img, 30, 24, is_train, mean=m,
                                  layout=layout,
                                  rng=np.random.RandomState(3))
    want = jimage.simple_transform(img, 30, 24, is_train, mean=m,
                                   layout=layout,
                                   rng=np.random.RandomState(3))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_crops_flips_and_layouts_match_jax(tmp_path):
    img = _image(seed=4)
    for fn in (lambda m: m.center_crop(img, 20),
               lambda m: m.random_crop(img, 20,
                                       rng=np.random.RandomState(5)),
               lambda m: m.left_right_flip(img),
               lambda m: m.to_chw(img),
               lambda m: m.to_hwc(m.to_chw(img))):
        np.testing.assert_array_equal(fn(timage), fn(jimage))
    path = tmp_path / "a.png"
    path.write_bytes(_png(img))
    np.testing.assert_array_equal(
        timage.load_and_transform(str(path), 32, 28, False, layout="CHW"),
        jimage.load_and_transform(str(path), 32, 28, False, layout="CHW"))


def test_without_a_decoder_the_port_raises_and_names_both(monkeypatch):
    monkeypatch.setattr(timage, "_cv2", lambda: None)
    monkeypatch.setattr(timage, "_pil", lambda: None)
    with pytest.raises(Exception, match="cv2.*PIL"):
        timage.load_image_bytes(_png(_image()))
    with pytest.raises(Exception, match="cv2.*PIL"):
        timage.resize_short(_image(), 16)
    # the numpy steps need no decoder
    assert timage.center_crop(_image(), 8).shape == (8, 8, 3)


def _tar(path, members):
    with tarfile.open(path, "w:gz" if path.endswith("gz") else "w") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def test_batch_images_from_tar_matches_jax(tmp_path):
    members = {f"jpg/image_{i:05d}.jpg": _png(_image(8, 9, i))
               for i in range(1, 6)}
    img2label = {n: i % 3 for i, n in enumerate(members)}
    out = {}
    for tag, mod in (("t", timage), ("j", jimage)):
        d = tmp_path / tag
        d.mkdir()
        tar = str(d / "imgs.tgz")
        _tar(tar, members)
        meta = mod.batch_images_from_tar(tar, "train", img2label,
                                         num_per_batch=2)
        files = open(meta).read().split()
        out[tag] = [pickle.load(open(f, "rb")) for f in files]
        assert mod.batch_images_from_tar(tar, "train", img2label) == meta
    assert out["t"] == out["j"] and len(out["t"]) == 3


@pytest.fixture
def offline(monkeypatch, tmp_path):
    def refuse(url, module_name, md5sum):
        raise IOError("offline")

    for mod in (tcommon, jcommon):
        monkeypatch.setattr(mod, "download", refuse)
        monkeypatch.setattr(mod, "DATA_HOME", str(tmp_path))


@pytest.mark.parametrize("split", ["train", "test", "valid"])
def test_flowers_fallback_matches_jax(offline, split):
    got = list(getattr(tflowers, split)()())
    want = list(getattr(jflowers, split)()())
    assert len(got) == len(want) and len(got) in (1024, 128)
    for (gi, gl), (wi, wl) in zip(got[:64], want[:64]):
        assert gl == wl and gi.shape == (3 * 32 * 32,)
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_voc2012_fallback_matches_jax(offline, split):
    got = list(getattr(tvoc, split)()())
    want = list(getattr(jvoc, split)()())
    assert len(got) == len(want)
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)


def _flowers_files(d):
    """A 6-image 102flowers.tgz with its label and split .mat files."""
    import scipy.io as scio

    d.mkdir()
    members = {f"jpg/image_{i:05d}.jpg": _png(_image(40, 48, i))
               for i in range(1, 7)}
    _tar(str(d / "102flowers.tgz"), members)
    scio.savemat(str(d / "imagelabels.mat"),
                 {"labels": np.array([[3, 1, 102, 7, 1, 5]])})
    scio.savemat(str(d / "setid.mat"),
                 {"tstid": np.array([[1, 2, 3, 5]]),
                  "trnid": np.array([[4]]), "valid": np.array([[6]])})
    return [str(d / n) for n in ("102flowers.tgz", "imagelabels.mat",
                                 "setid.mat")]


def test_flowers_real_reader_matches_jax(tmp_path):
    runs = {}
    for tag, mod in (("t", tflowers), ("j", jflowers)):
        files = _flowers_files(tmp_path / tag)
        assert mod.split_img2label(files[1], files[2], "tstid") == \
            jflowers.split_img2label(files[1], files[2], "tstid")
        reader = mod._reader_creator(*files, mod.TEST_FLAG,
                                     mod.test_mapper, use_xmap=False)
        runs[tag] = list(reader())
        raw = mod._reader_creator(*files, mod.TRAIN_FLAG, lambda s: s,
                                  use_xmap=False)
        runs[tag + "raw"] = [(len(b), lab) for b, lab in raw()]
    assert runs["traw"] == runs["jraw"] == [(len(_png(_image(40, 48, i))),
                                             lab) for i, lab in
                                            ((1, 2), (2, 0), (3, 101),
                                             (5, 0))]
    (gi, gl), = runs["t"]
    (wi, wl), = runs["j"]
    assert gl == wl == 6 and gi.shape == (224 * 224 * 3,)
    np.testing.assert_array_equal(gi, wi)


def test_voc2012_real_reader_matches_jax(tmp_path):
    members = {"VOCdevkit/VOC2012/ImageSets/Segmentation/val.txt":
               b"a\n\nb\n"}
    for i, name in enumerate("ab"):
        members[f"VOCdevkit/VOC2012/JPEGImages/{name}.jpg"] = \
            _png(_image(12, 10, i))
        seg = Image.fromarray(np.random.RandomState(i).randint(
            0, 21, (12, 10)).astype(np.uint8), mode="P")
        buf = io.BytesIO()
        seg.save(buf, format="PNG")
        members[f"VOCdevkit/VOC2012/SegmentationClass/{name}.png"] = \
            buf.getvalue()
    tar = str(tmp_path / "voc.tar")
    _tar(tar, members)
    got = list(tvoc.reader_creator(tar, "val")())
    want = list(jvoc.reader_creator(tar, "val")())
    assert len(got) == len(want) == 2
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
        assert gs.shape == (12, 10)


def test_ploter_matches_jax(tmp_path, monkeypatch, capsys):
    texts = []
    for mod in (tplot, jplot):
        p = mod.Ploter("train", "test")
        for i in range(3):
            p.append("train", i, 1.0 / (i + 1))
        p.append("test", 2, 0.25)
        p.plot(str(tmp_path / f"{mod.__name__}.png"))
        assert os.path.exists(tmp_path / f"{mod.__name__}.png")
        monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
        p.plot()
        monkeypatch.undo()
        p.reset()
        assert p.data == {"train": ([], []), "test": ([], [])}
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and "[plot] train: 3 points" in texts[0]


class _Registry:
    def __init__(self):
        self.values = {}

    def gauge(self, name):
        reg = self

        class _G:
            def labels(self, **lbl):
                class _S:
                    def set(self, v):
                        reg.values[(name, tuple(sorted(lbl.items())))] = v
                return _S()
        return _G()


def test_stats_match_jax(tmp_path):
    sets = (tstats.StatSet(), jstats.StatSet())
    for s in sets:
        for name, secs in (("fwd", 0.25), ("bwd", 0.5), ("fwd", 0.125)):
            s.add(name, secs)
    assert sets[0].report() == sets[1].report()
    for name in ("fwd", "bwd", "none"):
        a, b = sets[0].get(name), sets[1].get(name)
        assert (a is None and b is None) or vars(a) == vars(b)
    regs = (_Registry(), _Registry())
    for s, r in zip(sets, regs):
        s.publish(r, run="x")
    assert regs[0].values == regs[1].values and regs[0].values
    st = tstats.StatSet()
    with st.timer("step", block=lambda: torch.ones(3)):
        pass
    with pytest.raises(RuntimeError):
        with st.timer("step", block=lambda: 1 / 0):
            raise RuntimeError("body")
    assert st.get("step").count == 2
    tstats.reset_stats()
    with tstats.timer("g"):
        pass
    tstats.add_sample("g", 0.5)
    assert tstats.timer_stats().get("g").count == 2
    tstats.reset_stats()
    assert tstats.timer_stats().snapshot() == {}
    with tstats.profiler_window(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").exists()
