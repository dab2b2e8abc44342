"""SGD trainer with events (the port of ``paddle_tpu/trainer.py``: ``SGD``
with ``train`` and one ``step``).

One step is the forward of the topology, ``torch.autograd.grad`` of the
summed costs, and the optimizer's in-place update.  The trainer holds the
model state (batch norm's moving statistics, ``model_state``) on its
device; a step threads it through ``forward_with_state(train=True)`` and
commits the new slots only after the update, so a step that raises leaves
the statistics as they were, as the JAX step's functional state does.
Its dropout masks come from the ``seed`` flag and the step count.

The JAX step is one jitted program that donates the old parameter and
slot buffers (trainer.py:448-451); the port runs eagerly and updates the
same tensors in place under ``torch.no_grad()``, which keeps one copy of
the weights as donation does.  A step returns its cost as a 0-d device tensor and
never waits for the card; ``EndIteration.cost`` converts on first access.

Not yet ported: meshes and data parallelism, ZeRO, the pipeline path,
the bad-step guard and fault plans, checkpointing, the elastic master,
metrics/evaluators and ``test``.
"""

from __future__ import annotations

from typing import Dict

import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.sequence import SequenceBatch
from paddle_tpu_torch.topology import LayerOutput, Topology


def _reduce_cost(value) -> torch.Tensor:
    """Summed cost over the batch's valid tokens (or examples) divided by
    the number of sequences (examples), as the reference divides the
    summed cost by the batch size — not a mean over tokens."""
    if isinstance(value, SequenceBatch):
        d = value.data.reshape(value.capacity, -1).sum(-1) \
            if value.data.dim() > 1 else value.data
        total = torch.where(value.valid_mask, d, torch.zeros_like(d)).sum()
        return total / max(value.num_seqs, 1)
    return value.mean()


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """``t`` lives on ``dev`` (``cuda`` without an index means the
    current card)."""
    if t.device.type != dev.type:
        return False
    if dev.type == "cuda" and dev.index is None:
        return t.device.index == torch.cuda.current_device()
    return dev.type == "cpu" or t.device.index == dev.index


class SGD:
    """``SGD(cost, parameters, update_equation).train(reader, ...)``.

    Runs on ``device`` (``cuda`` unless asked), where ``parameters`` must
    already live.  ``cost`` is one cost node or a list of them (summed)."""

    def __init__(self, cost, parameters: Parameters,
                 update_equation: Optimizer, device: DeviceLike = None):
        costs = [cost] if isinstance(cost, LayerOutput) else list(cost)
        self.device = resolve_device(device)
        self.topology = Topology(costs)
        self._n_costs = len(costs)
        self.parameters = parameters
        specs = self.topology.param_specs()
        for name in specs:
            enforce_that(name in parameters,
                         f"no parameter {name!r} for the cost's topology",
                         context="trainer")
            enforce_that(_on_device(parameters[name], self.device),
                         f"parameter {name!r} is on "
                         f"{parameters[name].device}, the trainer on "
                         f"{self.device}", context="trainer")
        self._names = sorted(specs)
        self.optimizer = update_equation
        self.optimizer.set_param_specs(specs)
        self.opt_state = self.optimizer.init_state(
            {k: parameters[k] for k in self._names})
        self.model_state = self.topology.init_state(self.device)

    def step(self, feeds: Dict[str, object]) -> torch.Tensor:
        """One forward, backward and update on converted ``feeds``;
        returns the cost (0-d tensor on the device)."""
        params = {k: self.parameters[k].requires_grad_(True)
                  for k in self._names}
        step = self.opt_state["step"]
        outs, new_state = self.topology.forward_with_state(
            params, self.model_state, feeds, train=True,
            seed=(FLAGS.seed or 0) * 1_000_003 + step)
        total = _reduce_cost(outs[0])
        for o in outs[1:self._n_costs]:
            total = total + _reduce_cost(o)
        grads = torch.autograd.grad(total, [params[k] for k in self._names],
                                    allow_unused=True)
        self.optimizer.apply(params, dict(zip(self._names, grads)),
                             self.opt_state)
        self.model_state = new_state
        return total.detach()

    def train(self, reader, num_passes: int = 1, event_handler=None,
              feeding=None) -> None:
        """``num_passes`` passes over ``reader`` (a callable returning an
        iterator of sample batches), firing BeginPass, BeginIteration,
        EndIteration and EndPass on ``event_handler``."""
        handler = event_handler or (lambda ev: None)
        feeder = self._make_feeder(feeding)
        for pass_id in range(num_passes):
            handler(v2_event.BeginPass(pass_id))
            for batch_id, batch in enumerate(reader()):
                handler(v2_event.BeginIteration(pass_id, batch_id))
                cost = self.step(feeder.feed(batch))
                handler(v2_event.EndIteration(pass_id, batch_id, cost))
            handler(v2_event.EndPass(pass_id, {}, self.parameters))

    def _make_feeder(self, feeding) -> DataFeeder:
        data_types = [(n.name, n.input_type)
                      for n in self.topology.data_nodes]
        return DataFeeder(data_types, feeding, device=self.device)
