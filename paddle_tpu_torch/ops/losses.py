"""Losses (the port of ``paddle_tpu/ops/losses.py:23-55,142-219``:
``softmax_cross_entropy``, ``sigmoid_cross_entropy_with_logits``,
``multi_binary_label_cross_entropy`` and ``cross_entropy_over_beam``)."""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``logsumexp(logits) - logits[label]``, always in f32 (a
    bf16 logsumexp over a 32k vocabulary loses the loss's low bits)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - picked


def sigmoid_cross_entropy_with_logits(logits: torch.Tensor,
                                      labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``max(x, 0) - x y + log1p(exp(-|x|))`` (the stable
    form), summed over the last dim, in the logits' dtype."""
    loss = (torch.clamp(logits, min=0) - logits * labels +
            torch.log1p(torch.exp(-logits.abs())))
    return loss.sum(dim=-1)


def multi_binary_label_cross_entropy(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    return sigmoid_cross_entropy_with_logits(logits, labels)


def cross_entropy_over_beam(beams) -> torch.Tensor:
    """Globally normalized beam cost, per sequence [B].

    ``beams``: one tuple a beam expansion, ``(scores [B, N_t], selected
    [B, K_t], gold [B])`` or with ``parents [B, K_t]``, the beam slot of
    the previous expansion each candidate extends.  A candidate path's
    score is the sum of its expansions' scores along the parent links
    (without links every candidate extends the gold prefix); at the
    decisive expansion (the first where the gold path falls off the
    beam, else the last) the cost is the softmax cross entropy of the
    gold path against the beam's paths, gold's in-beam copy masked and
    the gold path appended as the last logit.  The gold slot is the first
    candidate that is the gold path (``argmax`` over the matches, the
    first of equal maxima)."""
    neg = -1e9
    kmax = max(int(b[1].shape[1]) for b in beams)
    batch = beams[0][0].shape[0]
    dev = beams[0][0].device
    gold_in, logits_t = [], []
    path = None
    gold_prefix = torch.zeros((batch,), dtype=beams[0][0].dtype, device=dev)
    gold_slot_prev = None
    for b in beams:
        scores, selected, gold = b[0], b[1].long(), b[2].long()
        parents = b[3].long() if len(b) > 3 else None
        k = selected.shape[1]
        beam_scores = torch.gather(scores, 1, selected)
        if path is None or parents is None:
            path_t = gold_prefix[:, None] + beam_scores
        else:
            path_t = torch.gather(path, 1, parents) + beam_scores
        gold_score = torch.gather(scores, 1, gold[:, None])[:, 0]
        gold_prefix = gold_prefix + gold_score
        dup = selected == gold[:, None]
        if parents is not None and gold_slot_prev is not None:
            dup = dup & (parents == gold_slot_prev[:, None])
        gold_slot_prev = torch.argmax(dup.to(torch.int32), dim=1)
        gold_in.append(dup.any(dim=1))
        masked = torch.where(dup, torch.full_like(path_t, neg), path_t)
        if k < kmax:
            fill = torch.full((batch, kmax - k), neg, dtype=path_t.dtype,
                              device=dev)
            masked = torch.cat([masked, fill], dim=1)
            path_t = torch.cat([path_t, fill], dim=1)
        path = path_t
        logits_t.append(torch.cat([masked, gold_prefix[:, None]], dim=1))
    gold_in = torch.stack(gold_in, dim=1)                # [B, T]
    logits = torch.stack(logits_t, dim=1)                # [B, T, K + 1]
    fell = (~gold_in).any(dim=1)
    first_off = torch.argmax((~gold_in).to(torch.int32), dim=1)
    f = torch.where(fell, first_off, gold_in.shape[1] - 1)
    picked = torch.gather(
        logits, 1, f[:, None, None].expand(-1, 1, logits.shape[2]))[:, 0]
    return softmax_cross_entropy(
        picked, torch.full((batch,), picked.shape[1] - 1, dtype=torch.long,
                           device=dev))
