"""Losses (the port of ``paddle_tpu/ops/losses.py``: the per-example
costs ``softmax_cross_entropy``, ``soft_cross_entropy``,
``sigmoid_cross_entropy_with_logits``,
``multi_binary_label_cross_entropy``, ``square_error``,
``squared_l2_distance``, ``huber_regression``, ``huber_classification``,
``smooth_l1``, ``rank_cost``, ``margin_rank_loss``,
``cosine_similarity``, ``classification_error``,
``cross_entropy_with_selfnorm`` and ``cross_entropy_over_beam``; the CTC
loss of ``optax.ctc_loss``, which the JAX package's ``ctc`` layer calls;
the
blockwise LM-head cross entropy ``lm_head_xent``)."""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops import math as pmath


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``logsumexp(logits) - logits[label]``, always in f32 (a
    bf16 logsumexp over a 32k vocabulary loses the loss's low bits)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - picked


def soft_cross_entropy(probs_or_logits: torch.Tensor,
                       soft_labels: torch.Tensor, *,
                       from_logits: bool = True) -> torch.Tensor:
    """``-sum(labels * log p)`` a row, p the softmax of logits or the
    given probabilities clipped to [1e-10, 1]."""
    if from_logits:
        logp = torch.log_softmax(probs_or_logits, dim=-1)
    else:
        logp = torch.log(clip(probs_or_logits, 1e-10, 1.0))
    return -(soft_labels * logp).sum(dim=-1)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: a value on a bound passes half its gradient, as the
    max/min pair JAX differentiates splits a tie."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                         x.new_tensor(hi))


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


def square_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``0.5 ||p - t||^2`` over every axis but the first."""
    d = pred - target
    return 0.5 * d.square().sum(dim=tuple(range(1, d.dim())))


def squared_l2_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).square().sum(dim=-1)


def huber_regression(pred: torch.Tensor, target: torch.Tensor,
                     delta: float = 1.0) -> torch.Tensor:
    """Quadratic within ``delta`` of the target, linear beyond, summed
    over the last axis."""
    d = (pred - target).abs()
    quad = 0.5 * d.square()
    lin = delta * (d - 0.5 * delta)
    return torch.where(d <= delta, quad, lin).sum(dim=-1)


def huber_classification(pred: torch.Tensor,
                         label01: torch.Tensor) -> torch.Tensor:
    """Two-class huber on y = 2 label - 1: -4 z below z = -1, (1 - z)^2
    up to 1, 0 above, z = y pred."""
    y = 2.0 * label01.to(pred.dtype) - 1.0
    z = y * pred[..., 0] if pred.dim() > label01.dim() else y * pred
    return torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, (1.0 - z).square(),
                                   torch.zeros_like(z)))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              sigma: float = 1.0) -> torch.Tensor:
    """Smooth L1 at ``sigma``, summed over every axis but the first."""
    s2 = sigma * sigma
    d = (pred - target).abs()
    loss = torch.where(d < 1.0 / s2, 0.5 * s2 * d.square(), d - 0.5 / s2)
    return loss.sum(dim=tuple(range(1, loss.dim())))


def rank_cost(left: torch.Tensor, right: torch.Tensor, label: torch.Tensor,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise ranking cost ``log(1 + e^o) - t o``, o = left - right,
    in its stable form; optionally weighted per pair.  ``torch.maximum``
    splits a tie's gradient as ``jnp.maximum`` does."""
    o = (left - right).reshape(left.shape[0])
    t = label.reshape(label.shape[0]).to(o.dtype)
    c = torch.log1p(torch.exp(-o.abs())) + torch.maximum(o, o.new_zeros(())) \
        - t * o
    if weight is not None:
        c = c * weight.reshape(weight.shape[0])
    return c


def margin_rank_loss(left: torch.Tensor, right: torch.Tensor,
                     label: torch.Tensor,
                     margin: float = 0.0) -> torch.Tensor:
    """``max(0, -y (left - right) + margin)``."""
    y = label.reshape(label.shape[0]).to(left.dtype)
    o = (left - right).reshape(left.shape[0])
    h = -y * o + margin
    return torch.maximum(h, h.new_zeros(()))


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0,
                      eps: float = 1e-8) -> torch.Tensor:
    """``scale a.b / sqrt(|a|^2 |b|^2 + eps)`` over the last axis."""
    num = (a * b).sum(dim=-1)
    den = torch.sqrt((a * a).sum(-1) * (b * b).sum(-1) + eps)
    return scale * num / den


def cross_entropy_with_selfnorm(logits: torch.Tensor, labels: torch.Tensor,
                                alpha: float = 0.1) -> torch.Tensor:
    """Softmax cross entropy plus ``alpha logZ^2`` (self-normalization)."""
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - picked) + alpha * logz.square()


def _logaddexp_tail(phi: torch.Tensor, added: torch.Tensor) -> torch.Tensor:
    """``phi[:, 1:]`` log-added ``added``, ``phi[:, :1]`` kept."""
    return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0, log_epsilon: float = -1e5) -> torch.Tensor:
    """CTC negative log-likelihood per sequence [B] (``optax.ctc_loss``,
    the JAX package's CTC): logits [B, T, K] unnormalized, paddings 1.0
    on padded frames [B, T] and labels [B, N] (labels right-padded).  The
    alpha recursion over blank and label states runs a frame at a time
    in log space, ``log_epsilon`` standing for log 0, so an alignment that
    cannot exist (a label longer than its input) gives a large finite
    loss, not ``inf``.  Each label's log-probability is picked by a
    one-hot product (exact, and its gradient a plain sum: no scattered
    adds whose order could vary)."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_paddings.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype)
    repeat = torch.cat([repeat, repeat.new_zeros((B, 1))], dim=1)
    logprobs_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)
    one_hot = torch.nn.functional.one_hot(labels.long(), K).to(
        logprobs.dtype)                                        # [B, N, K]
    logprobs_emit = (logprobs[:, :, None, :] * one_hot[:, None]).sum(-1)
    logprobs_emit = logprobs_emit.transpose(0, 1)              # [T, B, N]
    phi = torch.full((B, N + 1), log_epsilon, dtype=logprobs.dtype,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), log_epsilon, dtype=logprobs.dtype,
                      device=logits.device)
    pads = logit_paddings.transpose(0, 1).to(logprobs.dtype)
    for t in range(T):
        prev_phi_orig = phi
        prev_phi = _logaddexp_tail(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi = logprobs_emit[t], logprobs_phi[t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    emit + lp_emit)
        next_phi = prev_phi + lp_phi
        next_phi = _logaddexp_tail(
            next_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        pad = pads[t][:, None]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = _logaddexp_tail(phi, emit)
    pick = torch.nn.functional.one_hot(labellens, N + 1).to(last.dtype)
    return -(last * pick).sum(-1)


def classification_error(logits_or_probs: torch.Tensor,
                         labels: torch.Tensor, top_k: int = 1
                         ) -> torch.Tensor:
    """0/1 error per example: the label is not the argmax (the first
    maximum, as ``jnp.argmax``), or not among the ``top_k`` largest,
    where a stable descending sort puts the lower index first among equal
    values as ``lax.top_k`` does (``torch.topk`` gives no tie order)."""
    if top_k == 1:
        pred = torch.argmax(logits_or_probs, dim=-1)
        return (pred != labels.to(pred.dtype)).to(torch.float32)
    idx = torch.sort(logits_or_probs, dim=-1, descending=True,
                     stable=True).indices[..., :top_k]
    hit = (idx == labels[..., None].to(idx.dtype)).any(dim=-1)
    return (~hit).to(torch.float32)


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


# ---------------------------------------------------------------------------
# blockwise LM-head cross entropy: the [N, V] logits never exist whole
# ---------------------------------------------------------------------------

_PAD_NEG = -1e30   # the padded columns' bias: exp() underflows to 0


def _lm_blocks(v: int, block_v: int):
    """(block_v, n_blocks): ``block_v <= 0`` or above ``v`` is one block;
    the last block is padded to full width, not shrunk."""
    if block_v <= 0 or block_v > v:
        block_v = v
    return block_v, -(-v // block_v)


def _block_wb(w, b, j: int, bv: int):
    """Block j's weight columns and bias, the columns past V zero and their
    bias -1e30 (JAX's ``_padded_wb`` taken a block at a time)."""
    wj, bj = w[:, j * bv:(j + 1) * bv], b[j * bv:(j + 1) * bv]
    pad = bv - wj.shape[1]
    if pad:
        wj = torch.cat([wj, wj.new_zeros((wj.shape[0], pad))], dim=1)
        bj = torch.cat([bj, bj.new_full((pad,), _PAD_NEG)])
    return wj, bj


def _block_logits(xc, w, b, j: int, bv: int):
    """[N, bv] f32 logits of block j: ``xc`` is x in the compute dtype,
    the product accumulates in f32 (``ops/math.matmul``)."""
    wj, bj = _block_wb(w, b, j, bv)
    return pmath.matmul(xc, wj) + bj.float()


def _in_block(labels, j: int, bv: int):
    """(labels inside block j, their column in it, clipped into range)."""
    in_blk = (labels >= j * bv) & (labels < (j + 1) * bv)
    return in_blk, torch.clamp(labels - j * bv, 0, bv - 1)


class _LmHeadXent(torch.autograd.Function):
    """JAX's ``custom_vjp``: the forward keeps the online logsumexp's
    ``logz``; the backward recomputes each block's softmax from it."""

    @staticmethod
    def forward(ctx, x, w, b, labels, block_v):
        bv, nb = _lm_blocks(w.shape[1], block_v)
        xc = x.to(pmath.compute_dtype(x))
        n = x.shape[0]
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros((n,), device=x.device)
        picked = torch.zeros((n,), device=x.device)
        for j in range(nb):
            lg = _block_logits(xc, w, b, j, bv)
            new_m = torch.maximum(m, lg.max(dim=-1).values)
            s = s * torch.exp(m - new_m) + \
                torch.exp(lg - new_m[:, None]).sum(dim=-1)
            m = new_m
            in_blk, idx = _in_block(labels, j, bv)
            pick = torch.gather(lg, 1, idx[:, None])[:, 0]
            picked = torch.where(in_blk, pick, picked)
        logz = m + torch.log(s)
        ctx.save_for_backward(x, w, b, labels, logz)
        ctx.block_v = block_v
        return logz - picked

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, logz = ctx.saved_tensors
        v = w.shape[1]
        bv, nb = _lm_blocks(v, ctx.block_v)
        ct = pmath.compute_dtype(x)
        xc = x.to(ct)
        gf = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = w.new_zeros((w.shape[0], nb * bv))
        db = b.new_zeros((nb * bv,))
        cols = torch.arange(bv, device=x.device)
        for j in range(nb):
            lg = _block_logits(xc, w, b, j, bv)
            p = torch.exp(lg - logz[:, None])
            in_blk, idx = _in_block(labels, j, bv)
            onehot = (cols[None, :] == idx[:, None]) & in_blk[:, None]
            dlg = (p - onehot.float()) * gf[:, None]
            wj, _ = _block_wb(w, b, j, bv)
            dx = dx + pmath.matmul(dlg.to(ct), wj.to(ct), trans_b=True)
            dw[:, j * bv:(j + 1) * bv] = pmath.matmul(
                xc, dlg.to(ct), trans_a=True).to(dw.dtype)
            db[j * bv:(j + 1) * bv] = dlg.sum(dim=0).to(db.dtype)
        # the pad columns' gradients are exactly 0: cut them
        return dx.to(x.dtype), dw[:, :v], db[:v], None, None


def lm_head_xent(x: torch.Tensor, w: torch.Tensor, b, labels: torch.Tensor,
                 block_v: int = 4096) -> torch.Tensor:
    """Per-token ``logsumexp(x W + b) - (x W + b)[label]`` in f32, computed
    over vocabulary blocks of ``block_v`` columns with an online
    logsumexp, so neither pass holds the [N, V] logits: the backward
    recomputes each block from the saved ``logz``.  x: [N, D]; w: [D, V];
    b: [V] or None; labels: [N] int.  The products follow the bf16
    policy (``ops/math.matmul``); a label outside [0, V) picks 0."""
    if b is None:
        b = torch.zeros((w.shape[1],), dtype=torch.float32, device=w.device)
    return _LmHeadXent.apply(x, w, b, labels.long(), int(block_v))
