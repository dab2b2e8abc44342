"""Optimizers, learning-rate schedules and regularizers (the port of
``paddle_tpu/optimizer.py``: the base pipeline, the nine rules ``Sgd``,
``Momentum``, ``SparseMomentum``, ``Adagrad``, ``AdaDelta``, ``RMSProp``,
``DecayedAdagrad``, ``Adam``, ``Adamax``, the eight schedules, the L1/L2
regularizers and ``ModelAverage``).

The JAX package's ``apply`` is a pure function returning new parameters
and slots, and its trainer donates the old buffers.  Here ``apply``
updates the parameter and slot tensors in place, under
``torch.no_grad()``: that is what donation buys the JAX step (no second
copy of the weights), done the PyTorch way.

The pipeline's order is the JAX package's (``optimizer.py:198-271``):
the global-norm clip on the raw gradients (the per-tensor sums added in
the parameters' order); then per tensor the static skip, the
per-parameter clip, ``g += l2 p`` and ``g += l1 sign(p)`` (a
``ParamAttr``'s decay overrides the regularizer's), the prune mask, the
learning rate times the parameter's multiplier, the rule, the mask
again; then ``ModelAverage``.  A schedule computes its multiplier in f32
as JAX does, on a 0-d tensor on the parameters' device, so a step never
reads the card; with the constant schedule the rate stays a Python float
(rounded to f32 where the JAX package rounds it), and with no lever set
``Sgd``, ``Momentum`` and ``Adam`` run the very operations they ran
before the levers existed.  SparseMomentum's scalar recursions stay 0-d
f32 device tensors, chosen by masked selects.  Prune masks are value
quantiles on the full tensor with ``jnp.quantile``'s f32 linear
interpolation, computed through a sort (``torch.quantile`` refuses
inputs above 2^24 elements).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch.platform.enforce import EnforceError, enforce_that
from paddle_tpu_torch.topology import ParamSpec

Rate = Union[float, torch.Tensor]

# ---------------------------------------------------------------------------
# learning-rate schedules
# ---------------------------------------------------------------------------


def make_lr_schedule(args: Dict[str, Any]
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (f32 0-d tensor) -> f32 lr multiplier, from the v1 config keys
    ``learning_rate_schedule`` (constant, poly, caffe_poly, exp, discexp,
    linear, manual, pass_manual), ``learning_rate_decay_a``/``_b`` and
    ``learning_rate_args``."""
    kind = args.get("learning_rate_schedule", "constant")
    a = float(args.get("learning_rate_decay_a", 0.0))
    b = float(args.get("learning_rate_decay_b", 0.0))
    spec = args.get("learning_rate_args", "")

    if kind == "constant":
        return lambda step: torch.ones_like(step)
    if kind == "poly":
        return lambda step: torch.pow(1.0 + a * step, -b)
    if kind == "caffe_poly":
        return lambda step: torch.pow(
            torch.clamp(1.0 - step / a, min=0.0), b)
    if kind == "exp":
        return lambda step: torch.pow(a, step / b)
    if kind == "discexp":
        return lambda step: torch.pow(a, torch.floor(step / b))
    if kind == "linear":
        return lambda step: torch.clamp(1.0 - a * step, min=b)
    if kind in ("manual", "pass_manual"):
        # "seg1:lr1,seg2:lr2,..."
        segs = []
        for part in str(spec).split(","):
            if not part:
                continue
            s, lr = part.split(":")
            segs.append((float(s), float(lr)))
        enforce_that(len(segs) > 0, f"empty {kind} schedule",
                     context="optimizer")
        bounds = np.asarray([s for s, _ in segs], np.float32)
        rates = np.asarray([r for _, r in segs], np.float32)
        on_device: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

        def manual(step):
            # the tables cross to the step's device once, not every step
            if step.device not in on_device:
                on_device[step.device] = (
                    torch.from_numpy(bounds).to(step.device),
                    torch.from_numpy(rates).to(step.device))
            bt, rt = on_device[step.device]
            idx = torch.searchsorted(bt, step.reshape(1), right=False)
            idx = torch.clamp(idx, max=len(segs) - 1)
            return rt[idx].reshape(())

        return manual
    raise EnforceError(f"unknown lr schedule {kind!r}", context="optimizer")


def quantile_f32(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x.ravel(), q)`` (linear interpolation) in f32: the
    position ``q (n - 1)``, its floor and ceiling and their weights in
    f32, the two order statistics from a sort; indices clamped into the
    array as XLA's gather clamps them.  XLA contracts the interpolation
    ``lo * lw + hi * hw`` into one fused multiply-add over the rounded
    ``lo * lw``; the product is exact in f64, so the f64 sum rounded to
    f32 gives the same bits."""
    a = x.reshape(-1).to(torch.float32)
    n = a.numel()
    s = torch.sort(a).values
    nf = torch.full((), float(n), dtype=torch.float32, device=a.device)
    pos = torch.full((), float(q), dtype=torch.float32,
                     device=a.device) * (nf - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    zero = torch.zeros_like(nf)
    li = torch.minimum(torch.maximum(low, zero), nf - 1).long().clamp(
        0, n - 1)
    hi = torch.minimum(torch.maximum(high, zero), nf - 1).long().clamp(
        0, n - 1)
    return (s[hi].double() * hw.double() + (s[li] * lw).double()).to(
        torch.float32)


# ---------------------------------------------------------------------------
# base optimizer
# ---------------------------------------------------------------------------


def _device_of(params: Dict[str, torch.Tensor]) -> torch.device:
    for p in params.values():
        return p.device
    return torch.device("cpu")


class Optimizer:
    """Base: the schedule, the clips, decay, prune masks, per-parameter
    multipliers and static parameters around the subclass's elementwise
    ``_update``, then model averaging."""

    def __init__(self, learning_rate: float = 1e-3, regularization=None,
                 gradient_clipping_threshold: float = 0.0,
                 model_average=None, **sched_args):
        self.learning_rate = float(learning_rate)
        self._constant = sched_args.get("learning_rate_schedule",
                                        "constant") == "constant"
        self.schedule = make_lr_schedule(sched_args)
        self.regularization = regularization
        self.global_clip = float(gradient_clipping_threshold or 0.0)
        self.model_average = model_average
        self._specs: Dict[str, ParamSpec] = {}

    # -- wiring ------------------------------------------------------------

    def set_param_specs(self, specs: Dict[str, ParamSpec]) -> None:
        self._specs = dict(specs)

    def _attr(self, name):
        spec = self._specs.get(name)
        return spec.attr if spec is not None else None

    def set_zero_plan(self, plan) -> None:
        raise EnforceError("ZeRO-1 optimizer-state sharding needs a device "
                           "mesh: it comes with the parallel slice (A12)",
                           context="optimizer")

    # -- slots -------------------------------------------------------------

    def slot_names(self) -> Tuple[str, ...]:
        return ()

    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """``{"step": 0, "slots": {slot: {name: tensor}}}``, plus
        ``prune_masks`` for hooked parameters and ``avg``/``avg_count``
        under ``ModelAverage``."""
        masks = self._make_prune_masks(params)
        state = self._init_state(params)
        if masks:
            state["prune_masks"] = masks
        return state

    def _init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        state = {"step": 0,
                 "slots": {s: {k: torch.zeros_like(v)
                               for k, v in params.items()}
                           for s in self.slot_names()}}
        if self.model_average is not None:
            state["avg"] = {k: v.detach().clone() for k, v in params.items()}
            state["avg_count"] = torch.zeros((), dtype=torch.float32,
                                             device=_device_of(params))
        return state

    def _make_prune_masks(self, params) -> Dict[str, torch.Tensor]:
        """Static pruning masks from the initial weights: keep the
        entries with |value| at or above the ``sparsity_ratio`` quantile."""
        from paddle_tpu_torch.attr import HookAttr

        masks = {}
        for name, p in params.items():
            attr = self._attr(name)
            if attr is None:
                continue
            for hook in HookAttr.to_hooks(getattr(attr, "update_hooks",
                                                  None)):
                enforce_that(hook.type == "pruning",
                             f"unknown update hook {hook.type!r}",
                             context="optimizer")
                with torch.no_grad():
                    thresh = quantile_f32(p.detach().abs(),
                                          float(hook.sparsity_ratio))
                    masks[name] = (p.detach().abs() >= thresh).to(p.dtype)
        return masks

    def prune_mask(self, state, name: str):
        return state.get("prune_masks", {}).get(name)

    # -- update ------------------------------------------------------------

    def _update(self, p: torch.Tensor, g: torch.Tensor,
                slots: Dict[str, torch.Tensor], lr: Rate, step: int) -> None:
        """Update ``p`` and ``slots`` in place; ``lr`` is a Python float
        (constant schedule) or an f32 0-d tensor."""
        raise NotImplementedError

    # scalar recursions computed once per apply (SparseMomentum's
    # alpha/beta/tau); default: stateless
    def _pre_update(self, state, base_lr: Rate):
        return None

    def _post_update(self, state, aux) -> None:
        pass

    def _base_lr(self, step: int, device: torch.device) -> Rate:
        if self._constant:
            return self.learning_rate
        step_t = torch.full((), float(step), dtype=torch.float32,
                            device=device)
        return self.learning_rate * self.schedule(step_t)

    def _regularization(self, attr) -> Tuple[float, float]:
        l1 = l2 = 0.0
        if self.regularization is not None:
            l1 = getattr(self.regularization, "l1", 0.0)
            l2 = getattr(self.regularization, "l2", 0.0)
        if attr is not None:
            l1 = attr.l1_decay or l1
            l2 = attr.l2_decay or l2
        return l1, l2

    @staticmethod
    def _scaled(base_lr: Rate, mult: float) -> Rate:
        if mult == 1.0:
            return base_lr
        if isinstance(base_lr, torch.Tensor):
            return base_lr * mult
        # the JAX package multiplies the f32 rate by the multiplier in f32
        return float(np.float32(base_lr) * np.float32(mult))

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, Optional[torch.Tensor]],
              state: Dict[str, Any]) -> None:
        """One update of every parameter, in place; a missing gradient
        (a parameter the cost does not reach) counts as zero."""
        step = state["step"]
        device = _device_of(params)
        base_lr = self._base_lr(step, device)
        aux = self._pre_update(state, base_lr)
        self._aux = aux
        gs = {}
        for name, p in params.items():
            g = grads.get(name)
            gs[name] = torch.zeros_like(p) if g is None else g
        if self.global_clip > 0.0:
            total = None
            for g in gs.values():
                s = torch.sum(torch.square(g))
                total = s if total is None else total + s
            gnorm = torch.sqrt(total)
            scale = torch.clamp(
                self.global_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            gs = {k: g * scale for k, g in gs.items()}
        for name, p in params.items():
            attr = self._attr(name)
            if attr is not None and attr.is_static:
                continue
            g = gs[name]
            if attr is not None and attr.gradient_clipping_threshold > 0.0:
                t = attr.gradient_clipping_threshold
                g = torch.clamp(g, -t, t)
            l1, l2 = self._regularization(attr)
            if l2:
                g = g + l2 * p
            if l1:
                g = g + l1 * torch.sign(p)
            mask = self.prune_mask(state, name)
            if mask is not None:
                g = g * mask
            lr = self._scaled(base_lr, attr.learning_rate
                              if attr is not None else 1.0)
            self._update(p, g.to(p.dtype), {s: state["slots"][s][name]
                                             for s in self.slot_names()},
                         lr, step)
            if mask is not None:
                p.mul_(mask)
        state["step"] = step + 1
        self._post_update(state, aux)
        if self.model_average is not None:
            w = self.model_average.average_window
            c = state["avg_count"]
            decay = torch.clamp(c / (c + 1.0),
                                max=1.0 - 1.0 / max(1.0, w * 1000))
            for k, p in params.items():
                a = state["avg"][k]
                a.copy_(decay * a + (1 - decay) * p)
            state["avg_count"] = c + 1.0


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


class Sgd(Optimizer):
    """Plain SGD: ``p -= lr * g``."""

    def _update(self, p, g, slots, lr, step):
        p.sub_(lr * g)


class Momentum(Optimizer):
    """Heavy-ball momentum: ``m = momentum * m - lr * g; p += m``.
    ``sparse`` is carried as the JAX package carries it."""

    def __init__(self, momentum: float = 0.9, sparse: bool = False, **kw):
        super().__init__(**kw)
        self.momentum = momentum
        self.sparse = sparse

    def slot_names(self):
        return ("momentum",)

    def _update(self, p, g, slots, lr, step):
        m = slots["momentum"]
        if isinstance(lr, torch.Tensor):
            m.mul_(self.momentum).sub_(lr * g)
        else:
            m.mul_(self.momentum).sub_(g, alpha=lr)
        p.add_(m)


class SparseMomentum(Optimizer):
    """Lazy momentum in two additive accumulators u, v and the scalar
    recursions (reference SparseMomentumParameterOptimizer)::

        tau_t = tau_{t-1} + beta_{t-1} / alpha_{t-1}
        alpha_t = alpha_{t-1} / k,   beta_t = beta_{t-1} / (1 + lambda lr)
        u_t = u_{t-1} - alpha_t lr g_t,   v_t = v_{t-1} + tau_t alpha_t lr g_t
        theta_t = (tau_t / beta_t + 1 / alpha_t) u_t + v_t / beta_t

    equal to heavy-ball momentum at decay 0.  Past ``threshold`` the
    scalars restart (u /= alpha, v = theta) by masked selects."""

    def __init__(self, momentum: float = 0.9, decay_rate: float = 0.0,
                 threshold: float = 1e6, **kw):
        super().__init__(**kw)
        enforce_that(0.0 < momentum < 1.0,
                     "SparseMomentum needs 0 < momentum < 1",
                     context="optimizer")
        self.momentum = momentum
        self.decay_rate = decay_rate
        self.threshold = threshold

    def slot_names(self):
        return ("u", "v")

    def _init_state(self, params):
        state = super()._init_state(params)
        # v_0 = theta_0 (the reference's first-touch assign)
        state["slots"]["v"] = {k: v.detach().clone()
                               for k, v in params.items()}
        dev = _device_of(params)
        one = torch.ones((), dtype=torch.float32, device=dev)
        state["sm"] = {"alpha": one, "beta": one.clone(), "tau": -one}
        return state

    def _pre_update(self, state, base_lr):
        sm = state["sm"]
        lr = base_lr if isinstance(base_lr, torch.Tensor) else torch.full(
            (), base_lr, dtype=torch.float32, device=sm["alpha"].device)
        tau = sm["tau"] + sm["beta"] / sm["alpha"]
        alpha = sm["alpha"] / self.momentum
        beta = sm["beta"] / (1.0 + self.decay_rate * lr)
        return {"tau": tau, "alpha": alpha, "beta": beta, "lr": lr}

    def _update(self, p, g, slots, lr, step):
        a = self._aux
        tau, alpha, beta = a["tau"], a["alpha"], a["beta"]
        # per-parameter multipliers scale g through lr / base_lr
        scale = lr / torch.clamp(a["lr"], min=1e-30)
        u = slots["u"] - alpha * a["lr"] * scale * g
        v = slots["v"] + tau * alpha * a["lr"] * scale * g
        theta = (tau / beta + 1.0 / alpha) * u + v / beta
        restart = alpha > self.threshold
        slots["u"].copy_(torch.where(restart, u / alpha, u))
        slots["v"].copy_(torch.where(restart, theta, v))
        p.copy_(theta)

    def _post_update(self, state, aux) -> None:
        restart = aux["alpha"] > self.threshold
        one = torch.ones_like(aux["alpha"])
        state["sm"] = {"alpha": torch.where(restart, one, aux["alpha"]),
                       "beta": torch.where(restart, one, aux["beta"]),
                       "tau": torch.where(restart, -one, aux["tau"])}


class Adagrad(Optimizer):
    def __init__(self, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.eps = epsilon

    def slot_names(self):
        return ("accum",)

    def _update(self, p, g, slots, lr, step):
        acc = slots["accum"]
        acc.add_(torch.square(g))
        p.sub_(lr * g / (torch.sqrt(acc) + self.eps))


class AdaDelta(Optimizer):
    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def slot_names(self):
        return ("accum_g", "accum_dx")

    def _update(self, p, g, slots, lr, step):
        ag, adx = slots["accum_g"], slots["accum_dx"]
        ag.copy_(self.rho * ag + (1 - self.rho) * torch.square(g))
        dx = -torch.sqrt((adx + self.eps) / (ag + self.eps)) * g
        adx.copy_(self.rho * adx + (1 - self.rho) * torch.square(dx))
        p.add_(lr * dx)


class RMSProp(Optimizer):
    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def slot_names(self):
        return ("accum_g", "accum_mean")

    def _update(self, p, g, slots, lr, step):
        ag, am = slots["accum_g"], slots["accum_mean"]
        ag.copy_(self.rho * ag + (1 - self.rho) * torch.square(g))
        am.copy_(self.rho * am + (1 - self.rho) * g)
        denom = torch.sqrt(ag - torch.square(am) + self.eps)
        p.sub_(lr * g / denom)


class DecayedAdagrad(Optimizer):
    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6, **kw):
        super().__init__(**kw)
        self.rho, self.eps = rho, epsilon

    def slot_names(self):
        return ("accum",)

    def _update(self, p, g, slots, lr, step):
        acc = slots["accum"]
        acc.copy_(self.rho * acc + (1 - self.rho) * torch.square(g))
        p.sub_(lr * g / torch.sqrt(acc + self.eps))


class Adam(Optimizer):
    """Adam with bias correction: ``p -= lr * mhat / (sqrt(vhat) + eps)``."""

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw):
        super().__init__(**kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def slot_names(self):
        return ("m", "v")

    def _update(self, p, g, slots, lr, step):
        t = step + 1
        m, v = slots["m"], slots["v"]
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        denom = (v / (1 - self.b2 ** t)).sqrt_().add_(self.eps)
        p.sub_(lr * (m / (1 - self.b1 ** t)) / denom)


class Adamax(Optimizer):
    def __init__(self, beta1: float = 0.9, beta2: float = 0.999, **kw):
        super().__init__(**kw)
        self.b1, self.b2 = beta1, beta2

    def slot_names(self):
        return ("m", "u")

    def _update(self, p, g, slots, lr, step):
        m, u = slots["m"], slots["u"]
        t = torch.full((), step + 1.0, dtype=torch.float32, device=p.device)
        m.copy_(self.b1 * m + (1 - self.b1) * g)
        u.copy_(torch.maximum(self.b2 * u, torch.abs(g)))
        p.sub_((lr / (1.0 - torch.pow(self.b1, t))) * m / (u + 1e-12))


# ---------------------------------------------------------------------------
# regularization / model average config objects
# ---------------------------------------------------------------------------


class L2Regularization:
    def __init__(self, rate: float):
        self.l1, self.l2 = 0.0, rate


class L1Regularization:
    def __init__(self, rate: float):
        self.l1, self.l2 = rate, 0.0


class L1L2Regularization:
    def __init__(self, l1: float, l2: float):
        self.l1, self.l2 = l1, l2


class ModelAverage:
    """Running average of the parameters (``state["avg"]``), decay
    ``min(c / (c + 1), 1 - 1 / max(1, 1000 w))`` after ``c`` updates."""

    def __init__(self, average_window: float = 0.1,
                 max_average_window: Optional[int] = None):
        self.average_window = average_window
        self.max_average_window = max_average_window
