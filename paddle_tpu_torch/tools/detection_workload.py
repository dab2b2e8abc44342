"""SSD300's detection shapes for the card (Liu et al., "SSD: Single Shot
MultiBox Detector", 2016, section 3, the VOC model): feature maps 38, 19,
10, 5, 3 and 1 of a 300-pixel image, min sizes 30/60/111/162/213/264,
max sizes 60/111/162/213/264/315, aspect ratios {2}, {2, 3}, {2, 3},
{2, 3}, {2}, {2}: 8732 priors; 21 classes (VOC's 20 and background),
batch 32, up to 16 gt boxes an image.  ``chip_smoke.py``'s ``detection``
phase runs ``multibox_loss`` (forward and gradient), ``detection_output``
(NMS at 0.45, confidence 0.01, keep_top_k 200) and ``detection_map`` on
these inputs, card against the CPU path.

Inputs are seeded: location predictions N(0, 0.5); confidence logits
N(0, 1) with the background's raised by 2 (most priors lean to the
background, as a trained head's do); each image 1-8 gt boxes of random
classes and sizes, the rest of its 16 rows padding (class -1).
"""

from __future__ import annotations

import numpy as np
import torch

IMG = 300
MAPS = [(38, 30.0, 60.0, (2.0,)), (19, 60.0, 111.0, (2.0, 3.0)),
        (10, 111.0, 162.0, (2.0, 3.0)), (5, 162.0, 213.0, (2.0, 3.0)),
        (3, 213.0, 264.0, (2.0,)), (1, 264.0, 315.0, (2.0,))]
CLASSES, BATCH, MAX_BOXES = 21, 32, 16
NMS, CONFIDENCE, KEEP_TOP_K = 0.45, 0.01, 200
SEED = 0


def priors():
    """(boxes [8732, 4], variances [8732, 4]) as numpy."""
    from paddle_tpu_torch.ops import detection as pdet

    parts = [pdet.prior_boxes(f, f, IMG, IMG, [lo], [hi], list(ars))
             for f, lo, hi, ars in MAPS]
    return (np.concatenate([b for b, _ in parts]),
            np.concatenate([v for _, v in parts]))


def inputs(seed: int = SEED, batch: int = BATCH):
    """(loc [B, P, 4], conf [B, P, C], gt [B, MAX_BOXES, 5]) as numpy."""
    rng = np.random.RandomState(seed)
    p = priors()[0].shape[0]
    loc = (0.5 * rng.randn(batch, p, 4)).astype(np.float32)
    conf = rng.randn(batch, p, CLASSES).astype(np.float32)
    conf[..., 0] += 2.0
    gt = np.full((batch, MAX_BOXES, 5), -1.0, np.float32)
    for b in range(batch):
        n = rng.randint(1, 9)
        lo = rng.rand(n, 2) * 0.7
        size = 0.05 + rng.rand(n, 2) * 0.55
        hi = np.minimum(lo + size, 1.0)
        gt[b, :n, 0] = rng.randint(1, CLASSES, n)
        gt[b, :n, 1:] = np.concatenate([lo, hi], 1)
    return loc, conf, gt


def multibox(loc, conf, gt, prior_boxes, prior_var):
    """Per-example SSD loss of tensors (``ops/detection.multibox_loss``)."""
    from paddle_tpu_torch.ops import detection as pdet

    return pdet.multibox_loss(loc, conf, prior_boxes, prior_var,
                              gt[..., 1:5],
                              torch.clamp(gt[..., 0], min=0).to(torch.int32),
                              gt[..., 0] >= 0, CLASSES)


def detections(loc, conf, prior_boxes, prior_var):
    from paddle_tpu_torch.ops import detection as pdet

    return pdet.detection_output(loc, conf, prior_boxes, prior_var, CLASSES,
                                 NMS, CONFIDENCE, KEEP_TOP_K)


def sorted_rows(d: np.ndarray) -> np.ndarray:
    """An example's valid detection rows [K, 6], sorted by label, then
    box: two runs' detections compare row for row though equal scores
    left them in another order."""
    d = d[d[:, 0] >= 0]
    return d[np.lexsort((d[:, 5], d[:, 4], d[:, 3], d[:, 2], d[:, 0]))]


def map_topology():
    """``evaluator.detection_map`` over data layers of detections and
    gts, and the feeding slots."""
    from paddle_tpu_torch import data_type, evaluator, layer, topology

    topology.reset_name_scope()
    det = layer.data(name="det",
                     type=data_type.dense_vector(KEEP_TOP_K * 6))
    gt = layer.data(name="gt", type=data_type.dense_vector(MAX_BOXES * 5))
    node = evaluator.detection_map(det, gt, num_classes=CLASSES,
                                   keep_top_k=KEEP_TOP_K,
                                   max_boxes=MAX_BOXES)
    return topology.Topology([node])


def mean_ap(topo, dets: torch.Tensor, gt: torch.Tensor) -> float:
    b = dets.shape[0]
    with torch.no_grad():
        out = topo.forward({}, {"det": dets.reshape(b, -1),
                                "gt": gt.reshape(b, -1)})[0]
    return float(out[0])
