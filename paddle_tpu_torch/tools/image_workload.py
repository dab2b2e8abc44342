"""The image training cells that ``chip_smoke.py`` and
``tools/profile_image.py`` drive, in one place.

Each cell is one model of the zoo at bench.py's shape, trained with
``Momentum(0.9, 0.01)`` (bench.py:89-94) at the flag defaults (bf16 conv
operands and bf16 maps, f32 parameters and batch-norm statistics), random
weights from seed 0 and seeded random images and labels:

=========  =====  =====  ==============================================
model      image  batch  source
=========  =====  =====  ==============================================
resnet50   224    128    bench.py ``worker_resnet50`` (the headline)
alexnet    227    128    bench.py ``worker_alexnet``
googlenet  224    64     bench.py ``worker_convnets``
smallnet   32     64     bench.py ``worker_convnets``
lenet      28     64     (none; the MNIST demo's net)
=========  =====  =====  ==============================================

A step is timed as bench.py times one (bench.py:138-165): the feeds are
device-resident ``[B, H, W, C]`` maps, which ``layer._to_nhwc`` passes
through, and one warm-up step precedes the timed ones; the timed value is
the median of the steps' host-clock times, each step ending in
``torch.cuda.synchronize()``.  :func:`configure_cudnn` turns on cuDNN's
algorithm search (``cudnn.benchmark``) for these fixed shapes; the
package itself never sets it.

Usage::

    configure_cudnn()
    sgd = build_trainer("resnet50", torch.device("cuda"))
    costs, step_ms = time_steps(sgd, device_feeds("resnet50", dev), 6)
"""

from __future__ import annotations

import numpy as np
import torch

MODELS = {
    "resnet50": dict(module="resnet", kw={"depth": 50}, img=224,
                     batch=128, classes=1000, channels=3),
    "alexnet": dict(module="alexnet", kw={}, img=227, batch=128,
                    classes=1000, channels=3),
    "googlenet": dict(module="googlenet", kw={}, img=224, batch=64,
                      classes=1000, channels=3),
    "smallnet": dict(module="smallnet", kw={}, img=32, batch=64,
                     classes=10, channels=3),
    "lenet": dict(module="lenet", kw={}, img=28, batch=64, classes=10,
                  channels=1, feed="pixel"),
}
HEADLINE = "resnet50"
SEED = 0                 # weights; images and labels use SEED + 1 and up
MOMENTUM, LEARNING_RATE = 0.9, 0.01
# ResNet-50's forward, 2 x multiply-adds per 224 px image (bench.py:192);
# a training step counts it 3 times
RESNET50_FWD_FLOP_PER_IMAGE = 4.089e9


def configure_cudnn() -> dict:
    """Set cuDNN's algorithm search for the cells' fixed shapes; returns
    the settings for the phase's record."""
    torch.backends.cudnn.benchmark = True
    return {"cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}


def build_trainer(name: str, device, seed: int = SEED, **overrides):
    """``trainer.SGD`` over the cell's model (``overrides`` replace the
    build arguments, e.g. ``img_size`` or ``depth``), weights from
    ``seed``, on ``device``."""
    import importlib

    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.parameters import Parameters

    cell = MODELS[name]
    module = importlib.import_module(
        f"paddle_tpu_torch.models.{cell['module']}")
    kw = {**cell["kw"], "img_size": cell["img"], **overrides}
    topology.reset_name_scope()
    *_, cost = module.build(**kw)
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return trainer.SGD(cost, params, optimizer.Momentum(
        momentum=MOMENTUM, learning_rate=LEARNING_RATE), device=device)


def device_feeds(name: str, device, seed: int = SEED + 1,
                 batch: int = None, img: int = None) -> dict:
    """Random ``[B, H, W, C]`` images and labels on ``device``."""
    cell = MODELS[name]
    b, s = batch or cell["batch"], img or cell["img"]
    rng = np.random.RandomState(seed)
    images = rng.randn(b, s, s, cell["channels"]).astype(np.float32)
    labels = rng.randint(0, cell["classes"], size=b).astype(np.int32)
    return {cell.get("feed", "image"): torch.from_numpy(images).to(device),
            "label": torch.from_numpy(labels).to(device)}


def flat_samples(name: str, seed: int, batch: int = None,
                 img: int = None):
    """One batch of (flat CHW row, label) samples, the reference's dense
    image slot, for ``SGD.train`` through the ``DataFeeder``."""
    cell = MODELS[name]
    b, s = batch or cell["batch"], img or cell["img"]
    rng = np.random.RandomState(seed)
    return [(rng.randn(cell["channels"] * s * s).astype(np.float32),
             int(rng.randint(cell["classes"]))) for _ in range(b)]


def time_steps(sgd, feeds: dict, steps: int, warmup: int = 1):
    """``warmup`` untimed steps, then ``steps`` timed ones: (every step's
    cost as a float, the timed steps' host ms, each ending in
    ``torch.cuda.synchronize()``)."""
    import time

    costs, step_ms = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = sgd.step(feeds)
        torch.cuda.synchronize()
        if i >= warmup:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        costs.append(float(cost))
    return costs, step_ms
