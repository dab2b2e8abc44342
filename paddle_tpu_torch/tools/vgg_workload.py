"""VGG-16 on Flowers-102 through the v2 loop: the tenth slice's
full-width path, which ``chip_smoke.py``'s ``vgg16`` phase drives and
the CPU tests drive at a narrow size.

* Model: ``networks.vgg_16_network(image, num_channels=3,
  num_classes=102)`` at 224 x 224 (Simonyan & Zisserman, "Very Deep
  Convolutional Networks", 2015, configuration D; Flowers-102's classes),
  the two 0.5 dropouts the network fixes, under the bf16 policy.  The
  network ends in a softmax, so the cost is ``cross_entropy_cost`` on its
  probabilities (the reference's ``classification_cost`` on a softmax
  output is that cross entropy).
* Optimizer: ``Momentum(0.9)`` at learning rate 1e-2 with
  ``L2Regularization(5e-4)`` (the paper's section 3.1), batch 64.
* Samples: seeded 256 x 256 x 3 uint8 images, made in bulk, mapped
  through ``image.py``'s training steps: ``random_crop`` to 224,
  ``left_right_flip`` on a coin, less ``dataset.flowers``'s BGR mean,
  CHW order, flattened (the reference's dense image slot).  The mapper
  starts at the short edge of 256 and leaves out decoding and
  ``resize_short``, which need OpenCV or Pillow: a card's machine is not
  promised either (``chip_smoke.py`` records the decoder ``image.py``
  finds there).
* Readers: ``batch(shuffle(map_readers(mapper, images), 128), 64)``: the
  shuffle buffer holds two batches, so a pass of many batches is many
  buffers, and a producer thread (``prefetch``) maps the next buffer
  while the steps run.  :class:`StepClock` times such a pass from the end
  of its first batch (the first buffer's fill and the first step left
  out) to its end.
* Device feeds: the same batch as ``[B, H, W, C]`` tensors on the card,
  for ``SGD.step``.
* Card time by group (:func:`group`): the convolutions (forward and
  backward), the fc products, the optimizer's update (in its profiler
  range) and the rest (ReLU, pools, dropout, softmax, casts and layout
  copies: "elementwise").
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

SEED = 0
IMG, SHORT_EDGE, CHANNELS, CLASSES, BATCH = 224, 256, 3, 102, 64
MOMENTUM, LEARNING_RATE, L2 = 0.9, 1e-2, 5e-4
SHUFFLE_BUF = 128
GROUPS = ("convolutions", "fc_products", "elementwise", "optimizer")


def build(img: int = IMG, classes: int = CLASSES):
    """(image data layer, label, the softmax output, the cost)."""
    from paddle_tpu_torch import data_type, layer, networks

    image = layer.data(name="image",
                       type=data_type.dense_vector(CHANNELS * img * img),
                       height=img, width=img)
    label = layer.data(name="label", type=data_type.integer_value(classes))
    probs = networks.vgg_16_network(image, num_channels=CHANNELS,
                                    num_classes=classes)
    cost = layer.cross_entropy_cost(input=probs, label=label, name="cost")
    return image, label, probs, cost


def optimizer(learning_rate: float = LEARNING_RATE,
              momentum: float = MOMENTUM):
    from paddle_tpu_torch import optimizer as opt

    return opt.Momentum(momentum=momentum, learning_rate=learning_rate,
                        regularization=opt.L2Regularization(L2))


def trainer(device, seed: int = SEED, img: int = IMG,
            classes: int = CLASSES,
            learning_rate: float = LEARNING_RATE,
            momentum: float = MOMENTUM):
    """``trainer.SGD`` over VGG-16 (top-1 error as an extra layer),
    weights from ``seed``, on ``device``."""
    from paddle_tpu_torch import evaluator, topology
    from paddle_tpu_torch import trainer as tr
    from paddle_tpu_torch.parameters import Parameters

    topology.reset_name_scope()
    _, label, probs, cost = build(img, classes)
    err = evaluator.classification_error(input=probs, label=label,
                                         name="top1_error")
    params = Parameters.from_topology(topology.Topology([cost]), seed=seed,
                                      device=device)
    return tr.SGD(cost, params, optimizer(learning_rate, momentum),
                  extra_layers=[err], device=device)


# the fall gate's trajectory: a fresh trainer's FALL_STEPS costs on one
# repeated batch with the SAME dropout masks at every step and plain SGD
# (no momentum to overshoot), so the steps descend one fixed function.
# Fresh masks move a step's cost by up to ~0.1 on their own (a copy at
# learning rate 0 read 4.73-4.85); Momentum 0.9 at LEARNING_RATE, or at
# 2e-3, overshoots at the 7th step by a run-to-run amount; under fixed
# masks the batch is memorized fast, and at 5e-3 the costs fell below 1
# by the 5th step, where two runs parted (one rose back to 2.0), so the
# rate keeps all 7 steps in the smooth first stretch of the descent
FALL_MOMENTUM, FALL_LR, FALL_STEPS = 0.0, 1e-3, 7


def fall_costs(device, feeds) -> List[float]:
    """A fresh trainer's ``FALL_STEPS`` costs on ``feeds`` at ``FALL_LR``
    and ``FALL_MOMENTUM``, one step each, every step under the same
    dropout masks (:class:`SharedMasks` reseeded before each)."""
    from paddle_tpu_torch.ops import math as pmath

    sgd = trainer(device, learning_rate=FALL_LR, momentum=FALL_MOMENTUM)
    masks, saved = SharedMasks(), pmath.dropout
    pmath.dropout = masks
    try:
        costs = []
        for _ in range(FALL_STEPS):
            masks.reset()
            costs.append(float(sgd.step(feeds)))
    finally:
        pmath.dropout = saved
    return costs


def raw_images(n: int, seed: int, edge: int = SHORT_EDGE,
               classes: int = CLASSES) -> List[Tuple[np.ndarray, int]]:
    """``n`` (HWC uint8 image at the short edge, label) samples, made in
    one draw."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, edge, edge, CHANNELS), dtype=np.uint8)
    labels = rng.randint(0, classes, n)
    return [(imgs[i], int(labels[i])) for i in range(n)]


def mapper(seed: int, crop: int = IMG):
    """The training mapper: (uint8 HWC, label) -> (flat CHW f32, label),
    its crops and flips drawn from a ``RandomState(seed)``."""
    from paddle_tpu_torch import image
    from paddle_tpu_torch.dataset import flowers

    rng = np.random.RandomState(seed)
    mean = np.asarray(flowers.MEAN_BGR, np.float32).reshape(1, 1, -1)

    def apply(sample):
        im, label = sample
        im = image.random_crop(im, crop, rng=rng)
        if rng.randint(2) == 0:
            im = image.left_right_flip(im)
        im = im.astype(np.float32) - mean
        return image.to_chw(im).reshape(-1), label

    return apply


def train_reader(samples, seed: int, batch: int = BATCH,
                 crop: int = IMG, buf: int = SHUFFLE_BUF):
    """``batch(shuffle(map_readers(mapper, samples), buf), batch)``."""
    from paddle_tpu_torch import minibatch, reader

    mapped = reader.map_readers(mapper(seed, crop), lambda: iter(samples))
    return minibatch.batch(reader.shuffle(mapped, buf_size=buf), batch)


def device_feeds(batch_samples, device) -> Dict[str, torch.Tensor]:
    """A batch of mapped samples as [B, H, W, C] images and labels on
    ``device`` (the layout the convolutions take)."""
    flat = np.stack([s[0] for s in batch_samples])
    b = flat.shape[0]
    img = int(round((flat.shape[1] / CHANNELS) ** 0.5))
    nhwc = flat.reshape(b, CHANNELS, img, img).transpose(0, 2, 3, 1)
    labels = np.asarray([s[1] for s in batch_samples], np.int32)
    return {"image": torch.from_numpy(np.ascontiguousarray(nhwc)).to(device),
            "label": torch.from_numpy(labels).to(device)}


class StepClock:
    """An ``SGD.train`` event handler timing a pass on the host clock
    from the end of its first batch (the card drained there) to the end
    of the pass (the card drained), over the steps between.  It keeps
    every ``EndIteration`` and reads the costs after the run, so the loop
    never waits for the card.  Needs a CUDA device."""

    def __init__(self):
        self.iters: list = []
        self.t0 = self.t1 = None
        self.steps = 0

    def __call__(self, ev):
        from paddle_tpu_torch import event

        if isinstance(ev, event.EndIteration):
            self.iters.append(ev)
            if self.t0 is None:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            else:
                self.steps += 1
        elif isinstance(ev, event.EndPass):
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()

    def ms_a_step(self) -> float:
        return 1e3 * (self.t1 - self.t0) / self.steps

    def costs(self) -> List[float]:
        return [float(ev.cost) for ev in self.iters]


class SharedMasks:
    """A stand-in for ``ops.math.dropout`` drawing its masks from one CPU
    generator, reseeded by :meth:`reset`: two runs that reset it draw the
    same masks in the same order, whatever their device (the card-against-
    CPU step)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.gen = torch.Generator()

    def reset(self):
        self.gen.manual_seed(self.seed)

    def __call__(self, x, rate, generator, train):
        if not train or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = (torch.rand(x.shape, generator=self.gen) < keep).to(x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def step_flops(img: int = IMG, batch: int = BATCH,
               classes: int = CLASSES) -> float:
    """Floating-point operations of one training step (forward, and a
    backward of twice the forward's products): 2 x the multiply-adds of
    every conv and fc, times 3."""
    macs, c, s = 0, CHANNELS, img
    for filters, n in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(n):
            macs += s * s * 9 * c * filters
            c = filters
        s //= 2
    macs += s * s * c * 4096 + 4096 * 4096 + 4096 * classes
    return 3.0 * 2.0 * macs * batch


def parameter_count(img: int = IMG, classes: int = CLASSES) -> int:
    n, c = 0, CHANNELS
    for filters, k in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(k):
            n += 9 * c * filters + filters
            c = filters
    s = img // 32
    return n + (s * s * c + 1) * 4096 + 4097 * 4096 + 4097 * classes


def group(ops) -> str:
    """A kernel's group from the ops that launched it (innermost first)."""
    from paddle_tpu_torch.tools.profiling import OPTIMIZER_RANGE

    low = [op.lower() for op in ops]
    if OPTIMIZER_RANGE in low:
        return "optimizer"
    if any("convolution" in op for op in low):
        return "convolutions"
    if any(op in ("aten::mm", "aten::addmm", "aten::matmul", "aten::bmm")
           for op in low):
        return "fc_products"
    return "elementwise"


def breakdown(prof, steps: int, wall_ms: float) -> dict:
    """Busy ms, idle share and card ms and launches a step by
    :func:`group`, of a profile of ``steps`` steps."""
    from paddle_tpu_torch.tools import profiling

    return profiling.breakdown(prof, steps, wall_ms, group, GROUPS)
