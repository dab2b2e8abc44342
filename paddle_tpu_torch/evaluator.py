"""Evaluators: metric nodes the topology computes in the same forward as
the cost (the port of ``paddle_tpu/evaluator.py``, every evaluator).

Each evaluator returns a ``LayerOutput`` flagged ``is_metric``; pass them
to ``trainer.SGD(..., extra_layers=[...])``.  The trainer reduces a
metric's output to a 0-d tensor per batch (the mean over valid examples
or tokens), detached, outside the summed cost, and never reads it back
until an event's ``metrics`` or the pass's end asks.  Ties are broken as
the JAX package breaks them: stable sorts for ``auc`` and ``rankauc``
(``jnp.argsort`` is stable), the lower index first among equal scores
for ``classification_error(top_k > 1)`` (``lax.top_k``), the first
maximum for the argmaxes.  The printers write to standard output, which
reads the value back from the card: they are debugging aids.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from paddle_tpu_torch.ops import detection as pdet
from paddle_tpu_torch.ops import losses as ploss
from paddle_tpu_torch.sequence import SequenceBatch
from paddle_tpu_torch.topology import LayerOutput, unique_name

__all__ = ["classification_error", "sum", "column_sum", "auc",
           "precision_recall", "pnpair", "seq_classification_error",
           "value_printer", "maxid_printer", "rankauc", "chunk",
           "ctc_edit_distance", "gradient_printer", "max_frame_printer",
           "seq_text_printer", "classification_error_printer",
           "detection_map"]


def _data_of(v):
    return v.data if isinstance(v, SequenceBatch) else v


def _metric_node(name, ltype, inputs, fn) -> LayerOutput:
    node = LayerOutput(name=name, layer_type=ltype, inputs=inputs, fn=fn,
                       size=1)
    node.is_metric = True
    return node


def _show(name: str, text: str, value: torch.Tensor) -> None:
    """``jax.debug.print(name + text, v)``: the value as numpy prints it."""
    print(name + text.format(value.detach().cpu().numpy()))


def classification_error(input, label, top_k: int = 1, weight=None,
                         name: Optional[str] = None) -> LayerOutput:
    """Top-k error rate, optionally weighted per example."""
    name = name or unique_name("classification_error_evaluator")
    inputs = [input, label] + ([weight] if weight is not None else [])

    def compute(ctx, p, ins):
        logits, lab = ins[0], ins[1]

        def f(lg, lb):
            lb = lb.reshape(lb.shape[0]).to(torch.int32)
            return ploss.classification_error(lg, lb, top_k)

        if isinstance(logits, SequenceBatch):
            err = f(logits.data, _data_of(lab))
            return logits.with_data(torch.where(
                logits.valid_mask, err, torch.zeros_like(err)))
        err = f(logits, lab)
        if weight is not None:
            err = err * _data_of(ins[2]).reshape(-1)
        return err

    return _metric_node(name, "classification_error_evaluator", inputs,
                        compute)


def seq_classification_error(input, label,
                             name: Optional[str] = None) -> LayerOutput:
    """Per-sequence error: a sequence is wrong if any token is."""
    name = name or unique_name("seq_classification_error_evaluator")

    def compute(ctx, p, ins):
        sb, lab = ins[0], ins[1]
        err = ploss.classification_error(sb.data, _data_of(lab).reshape(-1))
        n = sb.num_seqs
        seg = torch.where(sb.valid_mask, sb.segment_ids,
                          torch.full_like(sb.segment_ids, n)).long()
        vals = torch.where(sb.valid_mask, err, torch.zeros_like(err))
        # segment_max: an empty segment keeps -inf, as jax.ops.segment_max
        out = torch.full((n + 1,), float("-inf"), dtype=vals.dtype,
                         device=vals.device)
        return out.scatter_reduce(0, seg, vals, "amax")[:n]

    return _metric_node(name, "seq_classification_error_evaluator",
                        [input, label], compute)


def sum(input, name: Optional[str] = None) -> LayerOutput:
    """Per-example sum of the input's features."""
    name = name or unique_name("sum_evaluator")

    def compute(ctx, p, ins):
        v = ins[0]
        d = _data_of(v)
        out = d.reshape(d.shape[0], -1).sum(-1)
        if isinstance(v, SequenceBatch):
            return v.with_data(torch.where(v.valid_mask, out,
                                           torch.zeros_like(out)))
        return out

    return _metric_node(name, "sum_evaluator", [input], compute)


def column_sum(input, name: Optional[str] = None) -> LayerOutput:
    """Per-row mean of the input's columns."""
    name = name or unique_name("column_sum_evaluator")

    def compute(ctx, p, ins):
        return _data_of(ins[0]).mean(-1)

    return _metric_node(name, "column_sum_evaluator", [input], compute)


def auc(input, label, name: Optional[str] = None) -> LayerOutput:
    """Batch AUC by the Mann-Whitney U statistic on the class-1 score."""
    name = name or unique_name("auc_evaluator")

    def compute(ctx, p, ins):
        scores = _data_of(ins[0])
        if scores.dim() > 1 and scores.shape[-1] > 1:
            scores = scores[..., 1]
        scores = scores.reshape(-1)
        y = _data_of(ins[1]).reshape(-1).to(torch.float32)
        order = torch.argsort(scores, stable=True)
        ranks = torch.zeros_like(scores).index_put(
            (order,), torch.arange(1, scores.shape[0] + 1,
                                   dtype=scores.dtype, device=scores.device))
        n_pos = torch.sum(y)
        n_neg = y.shape[0] - n_pos
        u = torch.sum(ranks * y) - n_pos * (n_pos + 1) / 2.0
        auc_val = torch.where((n_pos > 0) & (n_neg > 0),
                              u / torch.clamp(n_pos * n_neg, min=1.0),
                              torch.full_like(u, 0.5))
        return auc_val.reshape(1)

    return _metric_node(name, "auc_evaluator", [input, label], compute)


def pnpair(input, label, query_id, name: Optional[str] = None) -> LayerOutput:
    """Share of correctly ordered (positive, negative) pairs within each
    query, over the batch."""
    name = name or unique_name("pnpair_evaluator")

    def compute(ctx, p, ins):
        s = _data_of(ins[0]).reshape(-1)
        y = _data_of(ins[1]).reshape(-1).to(torch.float32)
        q = _data_of(ins[2]).reshape(-1)
        same_q = q[:, None] == q[None, :]
        better = (y[:, None] > y[None, :]) & same_q
        one, zero = s.new_ones(()), s.new_zeros(())
        correct = torch.sum(torch.where(better & (s[:, None] > s[None, :]),
                                        one, zero))
        total = torch.clamp(torch.sum(torch.where(better, one, zero)),
                            min=1.0)
        return (correct / total).reshape(1)

    return _metric_node(name, "pnpair_evaluator", [input, label, query_id],
                        compute)


def precision_recall(input, label, name: Optional[str] = None) -> LayerOutput:
    """F1 of the positive class of a binary problem."""
    name = name or unique_name("precision_recall_evaluator")

    def compute(ctx, p, ins):
        logits = _data_of(ins[0])
        y = _data_of(ins[1]).reshape(-1).to(torch.int32)
        pred = torch.argmax(logits, -1).to(torch.int32)

        def count(c):
            return torch.sum(c.to(torch.float32))

        tp = count((pred == 1) & (y == 1))
        fp = count((pred == 1) & (y == 0))
        fn = count((pred == 0) & (y == 1))
        prec = tp / torch.clamp(tp + fp, min=1.0)
        rec = tp / torch.clamp(tp + fn, min=1.0)
        f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-6)
        return f1.reshape(1)

    return _metric_node(name, "precision_recall_evaluator", [input, label],
                        compute)


def value_printer(input, name: Optional[str] = None) -> LayerOutput:
    """Prints the input's value."""
    name = name or unique_name("value_printer_evaluator")

    def compute(ctx, p, ins):
        v = _data_of(ins[0])
        _show(name, ": {}", v)
        return v.new_zeros((1,), dtype=torch.float32)

    return _metric_node(name, "value_printer_evaluator", [input], compute)


def maxid_printer(input, name: Optional[str] = None) -> LayerOutput:
    """Prints the argmax ids of the input's rows."""
    name = name or unique_name("maxid_printer_evaluator")

    def compute(ctx, p, ins):
        v = _data_of(ins[0])
        _show(name, ": {}", torch.argmax(v, -1))
        return v.new_zeros((1,), dtype=torch.float32)

    return _metric_node(name, "maxid_printer_evaluator", [input], compute)


def rankauc(input, label, weight=None,
            name: Optional[str] = None) -> LayerOutput:
    """Weighted AUC over raw ranking scores with the tie correction: a
    stable sort, each element's tie group by ``searchsorted``, and
    ``sum_neg w_n (P_above + P_equal / 2) / (W_pos W_neg)``."""
    name = name or unique_name("rankauc_evaluator")
    inputs = [input, label] + ([weight] if weight is not None else [])

    def compute(ctx, p, ins):
        score = _data_of(ins[0]).reshape(-1)
        y = _data_of(ins[1]).reshape(-1).to(torch.float32)
        w = (_data_of(ins[2]).reshape(-1) if weight is not None
             else torch.ones_like(score))
        pos_w = w * y
        neg_w = w * (1.0 - y)
        order = torch.argsort(score, stable=True)
        s_ = score[order].contiguous()
        pw, nw = pos_w[order], neg_w[order]
        cpos = torch.cumsum(pw, 0)
        total_pos = cpos[-1]
        total_neg = torch.sum(nw)
        lo = torch.searchsorted(s_, s_, right=False)
        hi = torch.searchsorted(s_, s_, right=True)
        pos_below = torch.where(lo > 0, cpos[torch.clamp(lo - 1, min=0)],
                                torch.zeros_like(cpos))
        pos_in_group = cpos[hi - 1] - pos_below
        pos_above = total_pos - pos_below - pos_in_group
        num = torch.sum(nw * (pos_above + 0.5 * pos_in_group))
        den = torch.clamp(total_pos * total_neg, min=1e-8)
        return (num / den).reshape(1)

    return _metric_node(name, "rankauc_evaluator", inputs, compute)


def chunk(input, label, num_chunk_types: int, chunk_scheme: str = "IOB",
          name: Optional[str] = None) -> LayerOutput:
    """Chunk F1 for sequence labeling (conlleval's rule: a chunk is right
    when its start, end and type all agree).  IOB ids: 2t = B-t,
    2t + 1 = I-t, 2T = O; plain ids: t = the chunk type, T = O."""
    name = name or unique_name("chunk_evaluator")
    if chunk_scheme not in ("IOB", "plain"):
        raise ValueError(f"unsupported chunk scheme {chunk_scheme}")
    plain = chunk_scheme == "plain"
    O = num_chunk_types if plain else 2 * num_chunk_types

    def type_of(tags):
        return tags if plain else tags // 2

    def starts_of(tags, prev_tags, valid):
        in_c = tags < O
        prev_in = prev_tags < O
        if plain:
            cont = in_c & prev_in & (prev_tags == tags)
            return valid & in_c & ~cont
        is_b = (tags % 2 == 0) & in_c
        is_i = (tags % 2 == 1) & in_c
        cont = is_i & prev_in & (type_of(prev_tags) == type_of(tags))
        return valid & (is_b | (is_i & ~cont))

    def compute(ctx, p, ins):
        pred_v, lab_v = ins[0], ins[1]
        pred = _data_of(pred_v)
        if pred.dim() > 1 and pred.shape[-1] > 1:
            pred = torch.argmax(pred, -1)
        pred = pred.reshape(-1).to(torch.int32)
        lab = _data_of(lab_v).reshape(-1).to(torch.int32)
        if isinstance(pred_v, SequenceBatch):
            seg = pred_v.segment_ids
            valid = pred_v.valid_mask
        else:
            seg = torch.zeros_like(pred)
            valid = torch.ones_like(pred, dtype=torch.bool)
        n = pred.shape[0]
        dev = pred.device
        idx = torch.arange(n, device=dev)

        def const(v, like):
            return torch.full((1,), v, dtype=like.dtype, device=dev)

        def shift_prev(tags):
            prev = torch.cat([const(O, tags), tags[:-1]])
            prev_seg = torch.cat([const(-1, seg), seg[:-1]])
            return torch.where(seg != prev_seg, const(O, tags), prev)

        def ends_of(tags, starts):
            in_c = valid & (tags < O)
            nxt_start = torch.cat([starts[1:], const(True, starts)])
            nxt_tag = torch.cat([tags[1:], const(O, tags)])
            nxt_seg = torch.cat([seg[1:], const(-1, seg)])
            nxt_valid = torch.cat([valid[1:], const(False, valid)])
            broken = nxt_start | (nxt_tag >= O) | (nxt_seg != seg) | \
                ~nxt_valid
            return in_c & broken

        ps = starts_of(pred, shift_prev(pred), valid)
        ls = starts_of(lab, shift_prev(lab), valid)
        pe = ends_of(pred, ps)
        le = ends_of(lab, ls)
        minus = torch.full_like(idx, -1)
        last_ps = torch.cummax(torch.where(ps, idx, minus), 0).values
        last_ls = torch.cummax(torch.where(ls, idx, minus), 0).values
        safe_p = torch.clamp(last_ps, min=0)
        safe_l = torch.clamp(last_ls, min=0)
        type_eq = type_of(pred[safe_p]) == type_of(lab[safe_l])
        hit = pe & le & (last_ps == last_ls) & (last_ps >= 0) & type_eq
        correct = torch.sum(hit.to(torch.float32))
        n_pred = torch.clamp(torch.sum(ps.to(torch.float32)), min=1e-8)
        n_lab = torch.clamp(torch.sum(ls.to(torch.float32)), min=1e-8)
        return (2 * correct / (n_pred + n_lab)).reshape(1)

    return _metric_node(name, "chunk_evaluator", [input, label], compute)


def ctc_edit_distance(input, label, blank: Optional[int] = None,
                      name: Optional[str] = None) -> LayerOutput:
    """Mean normalized edit distance between the CTC best-path decode of
    ``input`` (a probability sequence [tokens, C]; blank defaults to
    C - 1) and ``label``.  Every sequence at once: each decode and label
    compacted to the front of a row by a stable sort, then the
    Levenshtein rows over the label's static capacity, masked past each
    label's length; a row's recurrence ``new[i+1] = min(a[i], new[i] + 1)``
    is ``cummin(b - i) + i``, exact on integer-valued f32."""
    name = name or unique_name("ctc_edit_distance_evaluator")

    def compute(ctx, p, ins):
        probs, lab = ins[0], ins[1]
        blank_id = blank if blank is not None else probs.data.shape[-1] - 1
        path = torch.argmax(probs.data, -1).to(torch.int32)     # [capP]
        labd = _data_of(lab).reshape(-1).to(torch.int32)
        n_seq = probs.num_seqs
        capP, capL = path.shape[0], labd.shape[0]
        dev = path.device
        s = torch.arange(n_seq, device=dev)[:, None]
        in_s = probs.segment_ids[None, :] == s                  # [n, capP]
        prev = torch.cat([path.new_full((1,), -1), path[:-1]])
        prev_in = torch.cat([in_s.new_zeros((n_seq, 1)), in_s[:, :-1]], 1)
        keep = in_s & (path != blank_id)[None] & \
            ((path != prev)[None] | ~prev_in)
        order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
        dec = torch.where(keep.gather(1, order), path[order],
                          path.new_full((), -1))
        m = keep.sum(1)
        lab_in = lab.segment_ids[None, :] == s                  # [n, capL]
        order_l = torch.argsort((~lab_in).to(torch.int32), dim=1,
                                stable=True)
        ref = torch.where(lab_in.gather(1, order_l), labd[order_l],
                          labd.new_full((), -2))
        n_ref = lab_in.sum(1)
        ar = torch.arange(capP + 1, dtype=torch.float32, device=dev)
        row = ar.expand(n_seq, capP + 1)
        for j in range(capL):
            sub = row[:, :-1] + (dec != ref[:, j:j + 1]).to(torch.float32)
            dele = row[:, 1:] + 1.0
            b = torch.cat([row[:, :1] + 1.0, torch.minimum(sub, dele)], 1)
            new = torch.cummin(b - ar, dim=1).values + ar
            row = torch.where((j < n_ref)[:, None], new, row)
        dist = row.gather(1, m[:, None])[:, 0]
        return torch.mean(dist / torch.clamp(n_ref.to(torch.float32),
                                             min=1.0)).reshape(1)

    return _metric_node(name, "ctc_edit_distance_evaluator", [input, label],
                        compute)


# recall points of the 11-point interpolated AP: jnp.linspace(0, 1, 11)'s
# float32 values, i * float32(0.1)
_AP_POINTS = np.arange(11, dtype=np.float32) * np.float32(0.1)


def detection_map(detections, label, num_classes: int, keep_top_k: int,
                  max_boxes: int = 16, overlap_threshold: float = 0.5,
                  background_id: int = 0,
                  name: Optional[str] = None) -> LayerOutput:
    """11-point interpolated mAP over a batch.  ``detections`` is a
    ``detection_output`` layer ([B, keep_top_k * 6] rows of label, score,
    box); ``label`` the dense [B, max_boxes * 5] ground truth (class,
    box), class < 0 padding.  Each example's detections, in their
    (score-sorted) order, take the unused gt of their class they overlap
    most (the first of equal overlaps) at IoU >= the threshold; then all
    detections are ranked by score in a stable sort and each class's AP
    is the mean over 11 recall points of the best precision at that
    recall or above; classes without gt are left out of the mean."""
    name = name or unique_name("detection_map_evaluator")

    def compute(ctx, p, ins):
        det = _data_of(ins[0]).reshape(-1, keep_top_k, 6)
        B = det.shape[0]
        gt = _data_of(ins[1]).reshape(B, max_boxes, 5)
        iou = pdet.iou_matrix(det[..., 2:6], gt[..., 1:5])    # [B, K, G]
        ok = (det[..., 0:1] == gt[:, None, :, 0]) & \
            (gt[:, None, :, 0] >= 0)
        cand = iou * torch.where(ok, 1.0, 0.0)
        used = torch.zeros((B, max_boxes), dtype=torch.bool,
                           device=det.device)
        hits = []
        for k in range(keep_top_k):
            row = torch.where(used, torch.zeros_like(cand[:, k]), cand[:, k])
            j = torch.argmax(row, dim=1, keepdim=True)
            hit = (torch.gather(row, 1, j)[:, 0] >= overlap_threshold) & \
                (det[:, k, 0] >= 0)
            used = used | (torch.nn.functional.one_hot(
                j[:, 0], max_boxes).bool() & hit[:, None])
            hits.append(hit)
        tp = torch.stack(hits, dim=1).reshape(-1).to(torch.float32)
        scores = torch.where(det[..., 0] >= 0, det[..., 1],
                             det.new_full((), -float("inf"))).reshape(-1)
        order = torch.sort(scores, descending=True, stable=True).indices
        tp_sorted = tp[order]
        valid = torch.isfinite(scores[order])
        cls_sorted = det[..., 0].reshape(-1)[order]
        cls = torch.tensor([c for c in range(num_classes)
                            if c != background_id], dtype=torch.float32,
                           device=det.device)[:, None]          # [C', 1]
        sel = (cls_sorted[None, :] == cls) & valid[None, :]
        cum_tp = torch.cumsum(torch.where(sel, tp_sorted, 0.0), dim=1)
        cum_n = torch.cumsum(sel.to(torch.float32), dim=1)
        n_gt = (gt[None, :, :, 0] == cls[:, :, None]).to(
            torch.float32).sum(dim=(1, 2))                      # [C']
        prec = cum_tp / torch.clamp(cum_n, min=1.0)
        rec = cum_tp / torch.clamp(n_gt, min=1.0)[:, None]
        pts = torch.from_numpy(_AP_POINTS).to(det.device)
        best = torch.where(rec[:, None, :] >= pts[None, :, None],
                           prec[:, None, :], 0.0).amax(dim=2)   # [C', 11]
        ap = torch.where(n_gt > 0, best.mean(dim=1),
                         best.new_full((), float("nan")))
        return torch.nanmean(ap).reshape(1)

    return _metric_node(name, "detection_map_evaluator",
                        [detections, label], compute)


class _GradientProbe(torch.autograd.Function):
    """Identity whose backward prints the gradient flowing through it."""

    @staticmethod
    def forward(ctx, x, name: str):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _show(ctx.name, " grad: {}", g)
        return g, None


def gradient_printer(input, name: Optional[str] = None) -> LayerOutput:
    """Prints the gradient flowing through this node in the backward."""
    name = name or unique_name("gradient_printer_evaluator")

    def compute(ctx, p, ins):
        v = ins[0]
        d = _GradientProbe.apply(_data_of(v), name)
        return v.with_data(d) if isinstance(v, SequenceBatch) else d

    node = _metric_node(name, "gradient_printer_evaluator", [input], compute)
    node.size = input.size
    node.is_sequence = input.is_sequence
    return node


def max_frame_printer(input, name: Optional[str] = None) -> LayerOutput:
    """Prints the index of the frame holding the largest value."""
    name = name or unique_name("max_frame_printer_evaluator")

    def compute(ctx, p, ins):
        v = ins[0]
        d = _data_of(v)
        score = d.reshape(d.shape[0], -1).max(-1).values
        if isinstance(v, SequenceBatch):
            score = torch.where(v.valid_mask, score,
                                torch.full_like(score, float("-inf")))
        _show(name, ": frame {}", torch.argmax(score))
        return d.new_zeros((1,), dtype=torch.float32)

    return _metric_node(name, "max_frame_printer_evaluator", [input],
                        compute)


def seq_text_printer(input, name: Optional[str] = None) -> LayerOutput:
    """Prints token ids (the argmax of each row of a dense input)."""
    name = name or unique_name("seq_text_printer_evaluator")

    def compute(ctx, p, ins):
        d = _data_of(ins[0])
        ids = d if d.dim() == 1 else torch.argmax(d, -1)
        _show(name, ": {}", ids)
        return d.new_zeros((1,), dtype=torch.float32)

    return _metric_node(name, "seq_text_printer_evaluator", [input],
                        compute)


def classification_error_printer(input, label,
                                 name: Optional[str] = None) -> LayerOutput:
    """Prints the per-example 0/1 error vector."""
    name = name or unique_name("classification_error_printer_evaluator")

    def compute(ctx, p, ins):
        logits = _data_of(ins[0])
        y = _data_of(ins[1]).reshape(-1).to(torch.int32)
        err = torch.argmax(logits, -1).to(torch.int32) != y
        _show(name, ": {}", err.to(torch.int32))
        return logits.new_zeros((1,), dtype=torch.float32)

    return _metric_node(name, "classification_error_printer_evaluator",
                        [input, label], compute)
