"""Whether a training step is a function of its inputs on the card: two
steps from one state (parameters, optimizer moments and step count) on
one batch, compared to the bit.  ``chip_smoke.py`` and
``tests/test_torch_ctr_cuda.py`` hold the NMT and DeepFM steps to it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _snapshot(sgd):
    return ({k: v.detach().clone() for k, v in sgd.parameters.items()},
            {s: {k: v.clone() for k, v in d.items()}
             for s, d in sgd.opt_state["slots"].items()},
            sgd.opt_state["step"])


@torch.no_grad()
def _restore(sgd, snap) -> None:
    params, slots, step = snap
    for k, v in params.items():
        sgd.parameters[k].copy_(v)
    for s, d in slots.items():
        for k, v in d.items():
            sgd.opt_state["slots"][s][k].copy_(v)
    sgd.opt_state["step"] = step


def step_twice(sgd, feeds: Dict[str, object]) -> Tuple[bool, List[str]]:
    """(whether the two costs are the same bits, the parameters that
    differ after the two steps) of two ``sgd.step(feeds)`` from the
    trainer's present state; the trainer is left as a step leaves it."""
    snap = _snapshot(sgd)
    first_cost = sgd.step(feeds).clone()
    first = {k: v.detach().clone() for k, v in sgd.parameters.items()}
    _restore(sgd, snap)
    second_cost = sgd.step(feeds)
    differ = [k for k, v in sgd.parameters.items()
              if not torch.equal(v.detach(), first[k])]
    return bool(torch.equal(first_cost, second_cost)), differ
