"""SSD detection math (the port of ``paddle_tpu/ops/detection.py``):
prior boxes, IoU, box coding, prior matching, the multibox loss, NMS and
the detection output.

The JAX package computes one example at a time under ``vmap``; here each
function takes a batch ``[B, ...]`` and every step runs on the whole
batch at once.  Ties are broken as the JAX package breaks them:
``torch.argmax`` returns the first maximum as ``jnp.argmax`` does, and
both orderings (hard-negative ranks and the final cut to ``keep_top_k``)
are stable sorts, as ``jnp.argsort`` and ``lax.top_k`` order equal
values by index (``torch.topk`` promises no tie order on CUDA).

NMS needs the IoU of the box it keeps against every box.  The JAX
package computes the whole [P, P] matrix once an example (305 MB at
SSD300's 8732 priors, 9.8 GB for a batch of 32); here each round of the
loop computes only the kept boxes' rows, [B, C, P], with the same
arithmetic, so the values are the same bits and the batch needs no
chunking.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# prior (anchor) boxes: host numpy, as in the JAX package
# ---------------------------------------------------------------------------


def prior_boxes(feat_h: int, feat_w: int, img_h: int, img_w: int,
                min_sizes: Sequence[float], max_sizes: Sequence[float],
                aspect_ratios: Sequence[float],
                variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                clip: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The prior grid of a feature map: (boxes [P, 4] as normalized
    xmin/ymin/xmax/ymax, variances [P, 4]).  Each cell has one prior per
    min size, one per sqrt(min * max) and two per extra aspect ratio (r
    and 1 / r)."""
    ars = [1.0]
    for r in aspect_ratios:
        if not any(abs(r - a) < 1e-6 for a in ars):
            ars.append(float(r))
            ars.append(1.0 / float(r))
    boxes = []
    for y in range(feat_h):
        for x in range(feat_w):
            cx = (x + 0.5) / feat_w
            cy = (y + 0.5) / feat_h
            for i, ms in enumerate(min_sizes):
                boxes.append([cx - ms / img_w / 2, cy - ms / img_h / 2,
                              cx + ms / img_w / 2, cy + ms / img_h / 2])
                if i < len(max_sizes):
                    s = float(np.sqrt(ms * max_sizes[i]))
                    boxes.append([cx - s / img_w / 2, cy - s / img_h / 2,
                                  cx + s / img_w / 2, cy + s / img_h / 2])
                for r in ars[1:]:
                    rw = ms * float(np.sqrt(r))
                    rh = ms / float(np.sqrt(r))
                    boxes.append([cx - rw / img_w / 2, cy - rh / img_h / 2,
                                  cx + rw / img_w / 2, cy + rh / img_h / 2])
    out = np.asarray(boxes, np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    var = np.tile(np.asarray(variances, np.float32)[None, :],
                  (out.shape[0], 1))
    return out, var


def num_priors_per_cell(min_sizes, max_sizes, aspect_ratios) -> int:
    ars = {1.0}
    for r in aspect_ratios:
        ars.add(float(r))
        ars.add(1.0 / float(r))
    return len(min_sizes) + min(len(max_sizes), len(min_sizes)) \
        + len(min_sizes) * (len(ars) - 1)


# ---------------------------------------------------------------------------
# IoU and box coding
# ---------------------------------------------------------------------------


def _area(b: torch.Tensor) -> torch.Tensor:
    return torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., Na, 4] x [..., Nb, 4] -> [..., Na, Nb] IoU (0 where the union
    is empty)."""
    area_a, area_b = _area(a), _area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _iou_rows(sel: torch.Tensor, boxes: torch.Tensor,
              area_b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes ``sel`` [B, C, 4] against ``boxes`` [B, P, 4] (their
    areas ``area_b`` [B, 1, P]) -> [B, C, P]: the rows
    ``iou_matrix(boxes, boxes)[j]`` of the selected boxes, by the same
    arithmetic."""
    area_a = _area(sel)[..., None]                     # [B, C, 1]
    lt = torch.maximum(sel[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(sel[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _centers(priors: torch.Tensor):
    pw = priors[..., 2] - priors[..., 0]
    ph = priors[..., 3] - priors[..., 1]
    pcx = (priors[..., 0] + priors[..., 2]) / 2
    pcy = (priors[..., 1] + priors[..., 3]) / 2
    return pw, ph, pcx, pcy


def encode_boxes(gt: torch.Tensor, priors: torch.Tensor,
                 variances: torch.Tensor) -> torch.Tensor:
    """Ground-truth boxes [..., P, 4] -> regression targets against the
    priors [P, 4], divided by the variances."""
    pw, ph, pcx, pcy = _centers(priors)
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-8)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    t = torch.stack([(gcx - pcx) / pw, (gcy - pcy) / ph,
                     torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    return t / variances


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances: torch.Tensor) -> torch.Tensor:
    """Regression predictions [..., P, 4] -> boxes."""
    pw, ph, pcx, pcy = _centers(priors)
    v = variances
    cx = v[..., 0] * loc[..., 0] * pw + pcx
    cy = v[..., 1] * loc[..., 1] * ph + pcy
    w = torch.exp(v[..., 2] * loc[..., 2]) * pw
    h = torch.exp(v[..., 3] * loc[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


# ---------------------------------------------------------------------------
# matching and the multibox loss
# ---------------------------------------------------------------------------


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, overlap_threshold: float = 0.5):
    """Per-prediction and bipartite matching for a batch: ``gt_boxes``
    [B, G, 4] with validity [B, G].  Returns (match [B, P] int32, the gt
    index or -1; the best IoU [B, P]).

    A prior matches its best valid gt at IoU >= the threshold; then every
    valid gt that overlaps some prior claims its best prior.  Where two
    gts claim one prior the later gt holds it (the order JAX's scatter
    writes in on the CPU)."""
    P, G = priors.shape[-2], gt_boxes.shape[1]
    iou = iou_matrix(priors, gt_boxes)                      # [B, P, G]
    iou = torch.where(gt_valid[:, None, :], iou, iou.new_full((), -1.0))
    best_iou = iou.amax(dim=2)
    best_gt = torch.argmax(iou, dim=2)       # the first of equal maxima
    match = torch.where(best_iou >= overlap_threshold, best_gt,
                        best_gt.new_full((), -1))
    best_prior = torch.argmax(iou, dim=1)                    # [B, G]
    claim = gt_valid & (iou.max(dim=1).values > 0)
    p_idx = torch.arange(P, device=priors.device)
    g_idx = torch.arange(1, G + 1, device=priors.device)
    claims = (best_prior[:, :, None] == p_idx) & claim[:, :, None]
    last = torch.where(claims, g_idx[None, :, None], 0).amax(dim=1)
    match = torch.where(last > 0, last - 1, match)
    return match.to(torch.int32), best_iou


def multibox_loss(loc_pred: torch.Tensor, conf_pred: torch.Tensor,
                  priors: torch.Tensor, prior_var: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_valid: torch.Tensor, num_classes: int,
                  overlap_threshold: float = 0.5,
                  neg_pos_ratio: float = 3.0,
                  background_id: int = 0) -> torch.Tensor:
    """SSD loss per example [B]: the matched priors' smooth L1 on the
    encoded boxes plus the softmax cross entropy of the matched priors
    and of the hardest negatives (``neg_pos_ratio`` a positive, ranked by
    their loss in a stable descending sort), over the positives' count.
    Shapes: loc_pred [B, P, 4], conf_pred [B, P, C], gt_boxes [B, G, 4],
    gt_labels [B, G] (excluding background), gt_valid [B, G]."""
    B, P = loc_pred.shape[0], priors.shape[0]
    match, _ = match_priors(priors, gt_boxes, gt_valid, overlap_threshold)
    pos = match >= 0
    num_pos = pos.sum(dim=1)

    safe = torch.clamp(match, min=0).long()
    matched = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    target_box = encode_boxes(matched, priors, prior_var)
    diff = loc_pred - target_box
    ad = diff.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5).sum(-1)
    loc_loss = torch.where(pos, sl1, torch.zeros_like(sl1)).sum(dim=1)

    labels = torch.gather(gt_labels.long(), 1, safe)
    target_cls = torch.where(pos, labels, labels.new_full((),
                                                          background_id))
    logp = torch.log_softmax(conf_pred, dim=-1)
    xent = -torch.gather(logp, 2, target_cls[..., None])[..., 0]
    neg_score = torch.where(pos, xent.new_full((), -float("inf")), xent)
    order = torch.sort(neg_score, dim=1, descending=True,
                       stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=order.device).expand(B, P))
    num_neg = torch.minimum((neg_pos_ratio * num_pos.float()).to(
        torch.int32), P - num_pos)
    neg = (~pos) & (rank < num_neg[:, None])
    conf_loss = torch.where(pos | neg, xent, torch.zeros_like(xent)).sum(1)
    denom = torch.clamp(num_pos.to(loc_loss.dtype), min=1.0)
    return (conf_loss + loc_loss) / denom


# ---------------------------------------------------------------------------
# NMS and the detection output
# ---------------------------------------------------------------------------


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_keep: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of every (example, class) at once: ``boxes`` [B, P, 4],
    ``scores`` [B, C, P] (-inf marks a box out of the running).  Each of
    ``max_keep`` rounds keeps the best live box of each row (the first
    of equal scores) and kills it and every box at IoU >= the threshold.
    Returns (keep_idx [B, C, max_keep] int64, -1 padded; keep_ok
    [B, C, max_keep])."""
    B, C, P = scores.shape
    alive = torch.ones((B, C, P), dtype=torch.bool, device=scores.device)
    keep_idx = torch.full((B, C, max_keep), -1, dtype=torch.long,
                          device=scores.device)
    keep_ok = torch.zeros((B, C, max_keep), dtype=torch.bool,
                          device=scores.device)
    neg_inf = scores.new_full((), -float("inf"))
    # rounds past the most live boxes of any row keep nothing: one read
    rounds = min(max_keep, int((scores > neg_inf).sum(-1).max()))
    p_idx = torch.arange(P, device=scores.device)
    areas = _area(boxes)[:, None, :]
    for i in range(rounds):
        masked = torch.where(alive, scores, neg_inf)
        j = torch.argmax(masked, dim=-1)                       # [B, C]
        ok = torch.gather(masked, 2, j[..., None])[..., 0] > neg_inf
        keep_idx[:, :, i] = torch.where(ok, j, j.new_full((), -1))
        keep_ok[:, :, i] = ok
        sel = torch.gather(boxes, 1, j[..., None].expand(-1, -1, 4))
        kill = (_iou_rows(sel, boxes, areas) >= iou_threshold) | \
            (p_idx == j[..., None])
        alive = alive & (~kill | ~ok[..., None])
    return keep_idx, keep_ok


def detection_output(loc_pred: torch.Tensor, conf_pred: torch.Tensor,
                     priors: torch.Tensor, prior_var: torch.Tensor,
                     num_classes: int, nms_threshold: float = 0.45,
                     confidence_threshold: float = 0.01,
                     keep_top_k: int = 100,
                     background_id: int = 0) -> torch.Tensor:
    """Detections [B, keep_top_k, 6] = (label, score, xmin, ymin, xmax,
    ymax), an empty row all -1: decode, softmax, NMS of each class (up to
    ``keep_top_k`` boxes), then the ``keep_top_k`` best over the classes
    in a stable descending sort."""
    B, P = loc_pred.shape[:2]
    boxes = decode_boxes(loc_pred, priors, prior_var)          # [B, P, 4]
    probs = torch.softmax(conf_pred, dim=-1)                   # [B, P, C]
    cls_ids = [c for c in range(num_classes) if c != background_id]
    cls = torch.tensor(cls_ids, device=loc_pred.device)
    pc = probs[:, :, cls].transpose(1, 2)                      # [B, C', P]
    scores = torch.where(pc >= confidence_threshold, pc,
                         pc.new_full((), -float("inf")))
    keep_idx, keep_ok = nms(boxes, scores, nms_threshold, keep_top_k)
    safe = torch.clamp(keep_idx, min=0)                       # [B, C', K]
    kept_scores = torch.gather(pc, 2, safe)
    kept_boxes = torch.gather(
        boxes[:, None].expand(-1, len(cls_ids), -1, -1), 2,
        safe[..., None].expand(-1, -1, -1, 4))
    label = cls.to(torch.float32)[None, :, None].expand_as(kept_scores)
    det = torch.cat([label[..., None], kept_scores[..., None], kept_boxes],
                    dim=-1)                                    # [B, C', K, 6]
    det = torch.where(keep_ok[..., None], det, det.new_full((), -1.0))
    dets = det.reshape(B, -1, 6)
    score = torch.where(dets[..., 0] >= 0, dets[..., 1],
                        dets.new_full((), -float("inf")))
    top = torch.sort(score, dim=1, descending=True,
                     stable=True).indices[:, :keep_top_k]
    out = torch.gather(dets, 1, top[..., None].expand(-1, -1, 6))
    ok = torch.isfinite(torch.gather(score, 1, top))
    return torch.where(ok[..., None], out, out.new_full((), -1.0))
