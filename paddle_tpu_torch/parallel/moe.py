"""Mixture-of-experts FFN, dense and expert-parallel (the port of
``paddle_tpu/parallel/moe.py``).

Switch-style top-1 or GShard-style top-2 routing (the two gates
renormalized to sum to 1) into per-expert two-layer FFNs with a capacity
of ``ceil(T / E * capacity_factor)`` slots an expert; tokens past it are
dropped and come out as zeros (the caller adds the residual).  Slots are
claimed choice-major: every token's first choice before any token's
second.

- :func:`moe_ffn_reference` is the dense single-device formulation (and
  the oracle);
- :func:`moe_ffn` is the expert-parallel path over a mesh axis: the
  tokens, whole on every rank of the axis, are cut into one chunk a rank,
  each chunk is routed and packed into per-expert capacity buffers, one
  ``all_to_all_single`` sends each expert's buffer to the rank that holds
  it, the rank's E/N experts run on the buffers of every source, a second
  ``all_to_all_single`` brings the results back, and the gated combine
  plus an all-gather gives every rank the whole output again.  Capacity
  is per source chunk (``ceil(T/N / E * capacity_factor)``), as in JAX's.

Expert weights are stacked on the leading dim (``w1`` [E, D, H] ...); on
the expert-parallel path each rank holds its own E/N experts, the plan
:meth:`MoEConfig.param_plan` declares.  The router stays whole; its
gradient sums over the ranks' token chunks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.parallel import comm
from paddle_tpu_torch.platform.enforce import enforce_that


def _factor(n: int) -> float:
    return 0.0 if n <= 1 else (n - 1) / n


@dataclass(frozen=True)
class CommBudget:
    """The closed-form bytes one dispatch moves over its axis (the
    arXiv 2112.09017 cost model the JAX package's sharding auditor
    prices with), beside the mesh geometry it was priced for."""

    comm_bytes: float
    mesh_axes: Tuple[Tuple[str, int], ...]


def moe_contract(mesh, axis: str, e: int, cap: int, d: int,
                 with_stats: bool = False) -> CommBudget:
    """Bytes of one expert-parallel dispatch: the dispatch and combine
    all-to-alls of the [E, C, D] f32 buffer (``b (n-1)/n`` each), the two
    aux-statistic means over [E] f32 (all-reduces: ``2 b (n-1)/n``), and
    the drop-rate mean with ``with_stats``.  The port also all-gathers
    the [T, D] output back to every rank, which JAX leaves sharded; that
    is not in the budget."""
    n = int(mesh.shape[axis])
    f = _factor(n)
    comm_b = 2.0 * (e * cap * d * 4) * f + 2.0 * (2.0 * 4 * e * f)
    if with_stats:
        comm_b += 2.0 * 4 * f
    return CommBudget(comm_bytes=comm_b, mesh_axes=tuple(
        (a, int(mesh.shape[a])) for a in mesh.axis_names))


@dataclass(frozen=True)
class MoEConfig:
    """Routing hyperparameters and expert placement of a zoo MoE block
    (``expert_hidden`` 0: the layer derives it from the model width)."""

    num_experts: int
    expert_hidden: int = 0
    capacity_factor: float = 1.25
    top_k: int = 1
    axis: str = "expert"
    aux_weight: float = 0.01

    def param_plan(self, prefix: str = "") -> Dict[str, Tuple]:
        """{name: per-dim axes} of the expert weights (the router is
        whole: no entry)."""
        ax = self.axis
        return {f"{prefix}w1": (ax, None, None), f"{prefix}b1": (ax, None),
                f"{prefix}w2": (ax, None, None), f"{prefix}b2": (ax, None)}

    def param_attrs(self, prefix: str = "") -> Dict[str, object]:
        from paddle_tpu_torch.parallel.placement import plan_param_attrs

        return {k: v.attr
                for k, v in plan_param_attrs(self.param_plan(prefix)).items()}


class MoEParams(NamedTuple):
    """router [D, E]; w1 [E, D, H], b1 [E, H], w2 [E, H, D], b2 [E, D]
    (E: the experts this rank holds on the expert-parallel path)."""

    router: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def init_moe_params(seed: int, d_model: int, hidden: int, num_experts: int,
                    scale: float = 0.02, device=None) -> MoEParams:
    """Normal(0, scale) router and expert matrices from a numpy seed,
    zero biases."""
    from paddle_tpu_torch.platform.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return MoEParams(
        router=t(rng.randn(d_model, num_experts) * scale),
        w1=t(rng.randn(num_experts, d_model, hidden) * scale),
        b1=t(np.zeros((num_experts, hidden))),
        w2=t(rng.randn(num_experts, hidden, d_model) * scale),
        b2=t(np.zeros((num_experts, d_model))))


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _route_topk(x, router_w, k: int):
    """(experts [T, k], gates [T, k], probs [T, E]); k > 1 renormalizes
    the winning gates to sum to 1.  Ties go to the lower expert id, as
    ``lax.top_k`` breaks them (a padding slot's zero row ties every
    expert): a stable descending sort."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :k], experts[:, :k]
    if k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return experts, gates, probs


def _aux_stats(probs, expert):
    """(fraction of tokens routed to each expert, mean prob of each)."""
    e = probs.shape[-1]
    onehot = F.one_hot(expert, e).float()
    return onehot.mean(dim=0), probs.mean(dim=0)


def aux_load_balance_loss(probs, expert):
    """Switch aux loss: E * sum_e fraction_e * mean_prob_e."""
    fraction, mean_prob = _aux_stats(probs, expert)
    return probs.shape[-1] * torch.sum(fraction * mean_prob)


def _dispatch_mask_topk(experts, num_experts: int, capacity: int,
                        group=None):
    """[T, k, E, C] dispatch tensor: slot = rank of the (token, choice)
    within its expert, choice-major; past capacity -> dropped.  With a
    data-parallel ``group`` the tokens are this rank's rows of a global
    batch ordered by rank: the per-rank counts are all-gathered, and each
    slot is the (token, choice)'s rank in the global batch."""
    t, k = experts.shape
    onehot = F.one_hot(experts, num_experts).to(torch.int32)   # [T,k,E]
    if group is None:
        flat = onehot.transpose(0, 1).reshape(k * t, num_experts)
        pos = (torch.cumsum(flat, dim=0) - 1).reshape(k, t, num_experts)
    else:
        # each choice's local ranks, then every rank's earlier choices
        # and the earlier ranks' same choice ahead of them
        me = comm.group_rank(group)
        pos = torch.cumsum(onehot.transpose(0, 1), dim=1) - 1  # [k,T,E]
        every = comm.all_gather_flat(onehot.sum(dim=0)[None],
                                     group)                    # [N,k,E]
        total = every.sum(dim=0)
        before = torch.cumsum(total, dim=0) - total
        pos = pos + (before + every[:me].sum(dim=0))[:, None, :]
    pos = pos.transpose(0, 1)                                  # [T,k,E]
    keep = (pos < capacity) & (onehot > 0)
    slot = torch.clamp(pos, 0, capacity - 1).long()
    disp = F.one_hot(slot, capacity).float()                   # [T,k,E,C]
    return disp * keep[..., None].float()


def _drop_rate(disp, t: int, k: int):
    return 1.0 - torch.sum(disp) / float(t * k)


def _expert_ffn(buf, w1, b1, w2, b2, act):
    """buf [E_loc, N, D] through each local expert's FFN."""
    h = act(torch.einsum("end,edh->enh", buf, w1.float())
            + b1.float()[:, None, :])
    return torch.einsum("enh,ehd->end", h, w2.float()) \
        + b2.float()[:, None, :]


def _capacity(t: int, e: int, capacity_factor: float) -> int:
    return max(1, math.ceil(t / e * capacity_factor))


def moe_ffn_reference(x: torch.Tensor, params: MoEParams,
                      capacity_factor: float = 1.25, act=_gelu,
                      top_k: int = 1, return_stats: bool = False,
                      group=None):
    """Dense formulation: x [T, D] -> (y [T, D], aux loss), plus a
    ``{"drop_rate", "expert_fraction"}`` dict with ``return_stats``.

    ``group``: a data-parallel group whose ranks each hold their rows of
    one global batch (rank r's after rank r-1's).  Capacity, slots, drops
    and the aux loss are then the global batch's, as the JAX package's
    GSPMD computes them: the per-rank expert counts are all-gathered for
    the global slots, and the routing sums pooled (:func:`comm.pooled_sum`,
    whose backward sums every rank's gradient).  Each rank returns its
    rows' outputs and the global aux loss."""
    t, _ = x.shape
    e = params.router.shape[1]
    n_all = t
    if group is not None:
        n_all = int(comm.all_reduce_(torch.tensor(
            [t], dtype=torch.int64, device=x.device), group)[0])
    cap = _capacity(n_all, e, capacity_factor)
    experts, gates, probs = _route_topk(x, params.router, top_k)
    disp = _dispatch_mask_topk(experts, e, cap, group)
    buf = torch.einsum("tkec,td->ecd", disp, x.float())
    out = _expert_ffn(buf, params.w1, params.b1, params.w2, params.b2, act)
    wdisp = disp * gates[:, :, None, None]
    y = torch.einsum("tkec,ecd->td", wdisp, out)
    if group is None:
        fraction, mean_prob = _aux_stats(probs, experts[:, 0])
        drop = _drop_rate(disp, t, top_k) if return_stats else None
    else:
        onehot = F.one_hot(experts[:, 0], e).float()
        fraction = comm.all_reduce_(onehot.sum(dim=0), group) / n_all
        mean_prob = comm.pooled_sum(probs.sum(dim=0), group) / n_all
        drop = (1.0 - comm.all_reduce_(disp.sum().detach(), group)
                / float(n_all * top_k)) if return_stats else None
    aux = e * torch.sum(fraction * mean_prob)
    if not return_stats:
        return y.to(x.dtype), aux
    return y.to(x.dtype), aux, {"drop_rate": drop,
                                "expert_fraction": fraction}


def moe_ffn(mesh, x: torch.Tensor, params: MoEParams, axis: str = "expert",
            capacity_factor: float = 1.25, act=_gelu, top_k: int = 1,
            return_stats: bool = False):
    """Expert-parallel FFN over ``axis``: x [T, D] whole on every rank of
    the axis (T divisible by its size N), ``params`` holding this rank's
    E/N experts.  Returns (y [T, D] whole, aux loss) with the routing
    statistics pooled over the axis (means of the per-chunk fractions and
    probabilities, then the product, as JAX's pmean'd aux)."""
    n = mesh.axis_size(axis)
    group = mesh.group(axis)
    t, d = x.shape
    e_loc = params.w1.shape[0]
    e = params.router.shape[1]
    enforce_that(t % n == 0, f"tokens {t} not divisible by {axis}={n}",
                 context="moe")
    enforce_that(e % n == 0, f"experts {e} not divisible by {axis}={n}",
                 context="moe")
    enforce_that(e_loc * n == e,
                 f"this rank holds {e_loc} experts; {axis}={n} over {e} "
                 f"experts needs {e // n}", context="moe")
    t_loc = t // n
    cap = _capacity(t_loc, e, capacity_factor)
    xl = comm.scatter_replicated(x, 0, group)
    router = comm.enter_sharded(params.router, group)
    experts, gates, probs = _route_topk(xl, router, top_k)
    disp = _dispatch_mask_topk(experts, e, cap)            # [T_loc,k,E,C]
    buf = torch.einsum("tkec,td->ecd", disp, xl.float())   # [E, C, D]
    # rank s sends the buffers of rank r's experts to r
    buf = comm.all_to_all(buf.reshape(n, e_loc, cap, d), group)
    # [source, E_loc, C, D]: fold the sources into the capacity dim
    buf = buf.transpose(0, 1).reshape(e_loc, n * cap, d)
    out = _expert_ffn(buf, params.w1, params.b1, params.w2, params.b2, act)
    out = out.reshape(e_loc, n, cap, d).transpose(0, 1).contiguous()
    out = comm.all_to_all(out, group)        # [owner, E_loc, C, D]
    out = out.reshape(e, cap, d)             # owner * E_loc + local = id
    wdisp = disp * gates[:, :, None, None]
    y = torch.einsum("tkec,ecd->td", wdisp, out).to(x.dtype)
    fraction, mean_prob = _aux_stats(probs, experts[:, 0])
    fraction = comm.mean_replicated(fraction, group)
    mean_prob = comm.mean_replicated(mean_prob, group)
    aux = e * torch.sum(fraction * mean_prob)
    y = comm.gather_replicated(y, 0, group)
    if not return_stats:
        return y, aux
    drop = comm.mean_replicated(_drop_rate(disp, t_loc, top_k), group)
    return y, aux, {"drop_rate": drop, "expert_fraction": fraction}


def local_experts(params: MoEParams, mesh, axis: str = "expert"
                  ) -> MoEParams:
    """This rank's E/N experts of whole-expert ``params``."""
    n = mesh.axis_size(axis)
    i = mesh.coord(axis)
    e = params.w1.shape[0]
    k = e // n
    cut = [v[i * k:(i + 1) * k] for v in params[1:]]
    return MoEParams(params.router, *cut)


def record_moe_stats(stats, registry=None, prefix: str = "moe") -> None:
    """One step's routing statistics onto the obs registry:
    ``{prefix}_drop_rate`` and ``{prefix}_expert_load_imbalance`` (max
    expert fraction times E: 1.0 is balanced) gauges, and the
    ``{prefix}_dropped_tokens`` counter of cumulative drop mass."""
    from paddle_tpu_torch.obs.registry import default_registry

    reg = registry if registry is not None else default_registry()
    drop = float(stats["drop_rate"])
    reg.gauge(f"{prefix}_drop_rate",
              "fraction of (token, choice) MoE dispatch slots dropped "
              "past expert capacity in the last recorded step").set(drop)
    frac = stats.get("expert_fraction")
    if frac is not None:
        f = np.asarray(frac.detach().cpu() if isinstance(frac, torch.Tensor)
                       else frac, dtype=np.float64)
        if f.size:
            reg.gauge(f"{prefix}_expert_load_imbalance",
                      "max expert routing fraction relative to uniform "
                      "(1.0 = balanced)").set(float(f.max() * f.size))
    if drop > 0.0:
        reg.counter(f"{prefix}_dropped_tokens",
                    "cumulative dropped MoE dispatch mass").inc(drop)
