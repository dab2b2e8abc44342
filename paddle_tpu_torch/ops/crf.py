"""The linear-chain CRF (the port of ``paddle_tpu/layer.py:1523-1610``:
``_crf_forward``, ``_crf_viterbi``).

The JAX package runs both recursions as ``lax.scan`` over the padded
frames; here they are Python loops over the same frames, with the same
operations in the same order.  No Pallas kernel is involved.

- The gold path's score picks its emission, transition, start and stop
  terms through one-hot products (a one-hot row times a matrix selects a
  row exactly), so the gradients are dense products and sum in a fixed
  order on the card, where an indexed gather's backward would add in
  atomic order.
- A masked frame carries alpha (and the last gold label) unchanged and
  gets the identity backpointer, so a sequence's path ends at its length.
- Viterbi takes the first of equal maxima (``torch.argmax``, as
  ``jnp.argmax``); the backtrack ends at the first frame's state.  A
  length-1 batch runs no loop step.
"""

from __future__ import annotations

import torch


def _one_hot(labels: torch.Tensor, k: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels.long(), k).to(dtype)


def crf_forward(emissions, mask, transitions, start, stop, labels):
    """Negative log-likelihood of ``labels`` per sequence [B].

    emissions [B, T, K], mask [B, T] bool, labels [B, T] int;
    transitions [K, K] (from, to), start and stop [K]."""
    B, T, K = emissions.shape
    oh_e = _one_hot(labels, K, emissions.dtype)              # [B, T, K]
    oh_p = _one_hot(labels, K, transitions.dtype)
    prev = oh_p[:, 0]
    gold = (start[None, :] * prev).sum(-1) + \
        (emissions[:, 0] * oh_e[:, 0]).sum(-1)
    for t in range(1, T):
        e = (emissions[:, t] * oh_e[:, t]).sum(-1)
        tr = (torch.matmul(prev, transitions) * oh_p[:, t]).sum(-1)
        m = mask[:, t]
        gold = gold + m.to(e.dtype) * (e + tr)
        prev = torch.where(m[:, None], oh_p[:, t], prev)
    gold = gold + (stop[None, :] * prev).sum(-1)

    alpha = start[None, :] + emissions[:, 0]
    for t in range(1, T):
        scores = alpha[:, :, None] + transitions[None] + \
            emissions[:, t][:, None, :]
        alpha = torch.where(mask[:, t][:, None],
                            torch.logsumexp(scores, dim=1), alpha)
    logz = torch.logsumexp(alpha + stop[None, :], dim=-1)
    return logz - gold


@torch.no_grad()
def crf_viterbi(emissions, mask, transitions, start, stop) -> torch.Tensor:
    """The best path [B, T] int32 (positions past a sequence's length
    repeat its last state)."""
    B, T, K = emissions.shape
    alpha = start[None, :] + emissions[:, 0]
    ident = torch.arange(K, device=emissions.device)[None, :].expand(B, K)
    bps = []
    for t in range(1, T):
        scores = alpha[:, :, None] + transitions[None] + \
            emissions[:, t][:, None, :]
        m = mask[:, t][:, None]
        bps.append(torch.where(m, torch.argmax(scores, dim=1), ident))
        alpha = torch.where(m, scores.amax(dim=1), alpha)
    cur = torch.argmax(alpha + stop[None, :], dim=-1)
    path = [None] * T
    for t in range(T - 1, 0, -1):
        path[t] = cur
        cur = torch.gather(bps[t - 1], 1, cur[:, None])[:, 0]
    path[0] = cur
    return torch.stack(path, dim=1).to(torch.int32)
