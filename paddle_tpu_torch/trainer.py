"""SGD trainer with events (the port of ``paddle_tpu/trainer.py``: ``SGD``
with ``train`` and one ``step``, and the alternating multi-task trainer
``MultiTaskTrainer`` with its ``TaskSpec``).

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

Not yet ported: meshes and data parallelism (also the multi-task
trainer's ``mesh``), ZeRO, the pipeline path,
the bad-step guard and fault plans, checkpointing, the elastic master,
metrics/evaluators and ``test``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
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


def _check_parameters(specs, parameters: Parameters,
                      device: torch.device) -> None:
    """Every parameter the topology declares is in ``parameters`` and on
    ``device``."""
    for name in specs:
        enforce_that(name in parameters,
                     f"no parameter {name!r} for the cost's topology",
                     context="trainer")
        enforce_that(_on_device(parameters[name], device),
                     f"parameter {name!r} is on {parameters[name].device}, "
                     f"the trainer on {device}", context="trainer")


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
        _check_parameters(specs, parameters, self.device)
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


# ---------------------------------------------------------------------------
# Multi-task / alternating training (the GAN capability)
# ---------------------------------------------------------------------------


class TaskSpec:
    """One optimization task: a cost node, its optimizer, and which
    parameters it updates: ``trainable`` is a name prefix, a collection of
    names, a predicate on a name, or None (every parameter)."""

    def __init__(self, name: str, cost, update_equation: Optimizer,
                 trainable=None):
        self.name = name
        self.cost = cost
        self.optimizer = update_equation
        if trainable is None:
            self.trainable = lambda pname: True
        elif isinstance(trainable, str):
            prefix = trainable
            self.trainable = lambda pname: pname.startswith(prefix)
        elif isinstance(trainable, (list, tuple, set, frozenset)):
            names = set(trainable)
            self.trainable = lambda pname: pname in names
        else:
            self.trainable = trainable


class MultiTaskTrainer:
    """Alternating training of several cost graphs over ONE shared
    ``Parameters`` (the GAN loop: generator and discriminator trained in
    turn against shared weights).

    Each task has its own topology, and its own optimizer state over its
    trainable subset of the store (every stored name the task's
    ``trainable`` accepts), with its own step count (Adam's bias
    correction reads it).  A step differentiates the task's cost with
    ``torch.autograd.grad`` over the trainable tensors only; the other
    parameters enter the graph detached, are read and never updated.
    Every step draws a fresh seed; model-state slots a step updates are
    copied into the other tasks' state maps by node name.  Runs on
    ``device`` (``cuda`` unless asked), where ``parameters`` live::

        t = MultiTaskTrainer([
            TaskSpec("d", d_cost, Adam(learning_rate=2e-4), trainable="dis_"),
            TaskSpec("g", g_cost, Adam(learning_rate=2e-4), trainable="gen_"),
        ], parameters)
        d_loss = t.step("d", {"pixel": real, "noise": z, ...})
    """

    def __init__(self, tasks: Sequence[TaskSpec], parameters: Parameters,
                 device: DeviceLike = None):
        enforce_that(len(tasks) > 0, "need at least one task",
                     context="MultiTaskTrainer")
        self.device = resolve_device(device)
        self.tasks = {t.name: t for t in tasks}
        self.parameters = parameters
        self._topos: Dict[str, Topology] = {}
        self._trainable: Dict[str, list] = {}
        self._opt_states: Dict[str, Any] = {}
        self._model_states: Dict[str, Any] = {}
        self._counts: Dict[str, int] = {}
        self._steps = 0          # across tasks: each step's fresh seed
        for t in tasks:
            topo = Topology([t.cost])
            specs = topo.param_specs()
            _check_parameters(specs, parameters, self.device)
            self._topos[t.name] = topo
            t.optimizer.set_param_specs(specs)
            names = sorted(k for k in parameters.keys() if t.trainable(k))
            enforce_that(len(names) > 0,
                         f"task {t.name!r} trains no parameters",
                         context="MultiTaskTrainer")
            self._trainable[t.name] = names
            self._opt_states[t.name] = t.optimizer.init_state(
                {k: parameters[k] for k in names})
            self._model_states[t.name] = topo.init_state(self.device)
            self._counts[t.name] = 0

    def step(self, name: str, feeds: Dict[str, object]) -> float:
        """One optimization step of the named task; returns its cost.
        ``feeds`` maps data layer names to tensors or numpy arrays (moved
        to the trainer's device).  The other tasks' parameters flow
        through the graph but are not updated."""
        enforce_that(name in self.tasks, f"unknown task {name!r}",
                     context="MultiTaskTrainer")
        feeds = {k: torch.as_tensor(v, device=self.device)
                 if isinstance(v, np.ndarray) else v
                 for k, v in feeds.items()}
        task = self.tasks[name]
        topo = self._topos[name]
        names = self._trainable[name]
        train_set = set(names)
        params = {k: (self.parameters[k].requires_grad_(True)
                      if k in train_set else self.parameters[k].detach())
                  for k in topo.param_specs()}
        seed = (FLAGS.seed or 0) * 1_000_003 + self._steps
        outs, new_state = topo.forward_with_state(
            params, self._model_states[name], feeds, train=True, seed=seed)
        total = _reduce_cost(outs[0])
        wrt = [k for k in names if k in params]
        grads = dict(zip(wrt, torch.autograd.grad(
            total, [params[k] for k in wrt], allow_unused=True)))
        task.optimizer.apply({k: self.parameters[k] for k in names}, grads,
                             self._opt_states[name])
        self._model_states[name] = new_state
        # stateful slots shared across task graphs by node name
        for other, st in self._model_states.items():
            if other != name:
                for node_name, slots in new_state.items():
                    if node_name in st:
                        st[node_name] = slots
        self._counts[name] += 1
        self._steps += 1
        return float(total.detach())

    def steps_run(self, name: str) -> int:
        return self._counts[name]
