"""Optimizers (the port of ``paddle_tpu/optimizer.py``: the base class,
``Sgd``, ``Momentum`` and ``Adam``).

The JAX package's ``apply`` is a pure function returning new parameters
and slots, and its trainer donates the old buffers.  Here ``apply``
updates the parameter and slot tensors in place, under
``torch.no_grad()``: that is what donation buys the JAX step (no second
copy of the weights), done the PyTorch way.

The learning rate is constant; a parameter's ``ParamAttr`` adds its
learning-rate multiplier and ``is_static``.  Schedules, regularizers,
clipping, model averaging, pruning hooks and the other optimizers wait
for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from paddle_tpu_torch.topology import ParamSpec


class Optimizer:
    """Base: per-parameter multipliers and static parameters around the
    subclass's elementwise ``_update``."""

    def __init__(self, learning_rate: float = 1e-3):
        self.learning_rate = float(learning_rate)
        self._specs: Dict[str, ParamSpec] = {}

    def set_param_specs(self, specs: Dict[str, ParamSpec]) -> None:
        self._specs = dict(specs)

    def _attr(self, name):
        spec = self._specs.get(name)
        return spec.attr if spec is not None else None

    def slot_names(self) -> Tuple[str, ...]:
        return ()

    def init_state(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """``{"step": 0, "slots": {slot: {name: zeros}}}``."""
        return {"step": 0,
                "slots": {s: {k: torch.zeros_like(v)
                              for k, v in params.items()}
                          for s in self.slot_names()}}

    def _update(self, p: torch.Tensor, g: torch.Tensor,
                slots: Dict[str, torch.Tensor], lr: float, step: int) -> None:
        """Update ``p`` and ``slots`` in place."""
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, Optional[torch.Tensor]],
              state: Dict[str, Any]) -> None:
        """One update of every parameter, in place; a missing gradient
        (a parameter the cost does not reach) counts as zero."""
        step = state["step"]
        for name, p in params.items():
            attr = self._attr(name)
            if attr is not None and attr.is_static:
                continue
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            lr = self.learning_rate * (attr.learning_rate
                                       if attr is not None else 1.0)
            self._update(p, g, {s: state["slots"][s][name]
                                for s in self.slot_names()}, lr, step)
        state["step"] = step + 1


class Sgd(Optimizer):
    """Plain SGD: ``p -= lr * g``."""

    def _update(self, p, g, slots, lr, step):
        p.sub_(lr * g)


class Momentum(Optimizer):
    """Heavy-ball momentum: ``m = momentum * m - lr * g; p += m``."""

    def __init__(self, momentum: float = 0.9, **kw):
        super().__init__(**kw)
        self.momentum = momentum

    def slot_names(self):
        return ("momentum",)

    def _update(self, p, g, slots, lr, step):
        m = slots["momentum"]
        m.mul_(self.momentum).sub_(g, alpha=lr)
        p.add_(m)


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
