"""SGD trainer with events (the port of ``paddle_tpu/trainer.py``: ``SGD``
with ``train``, ``test``, one ``step``, evaluators, prefetch and the
logging flags, and the alternating multi-task trainer
``MultiTaskTrainer`` with its ``TaskSpec``).

One step is the forward of the topology (the costs and every metric node
of ``extra_layers``/``metrics`` in one pass), ``torch.autograd.grad`` of
the summed costs, and the optimizer's in-place update.  The trainer holds
the model state (batch norm's moving statistics, ``model_state``) on its
device; a step threads it through ``forward_with_state(train=True)`` and
commits the new slots only after the update, so a step that raises leaves
the statistics as they were, as the JAX step's functional state does.
Its dropout masks come from the ``seed`` flag and the step count.

The JAX step is one jitted program that donates the old parameter and
slot buffers (trainer.py:448-451); the port runs eagerly and updates the
same tensors in place under ``torch.no_grad()``, which keeps one copy of
the weights as donation does.  A step returns its cost and each metric
(the mean over the batch's valid examples or tokens, detached, never part
of the cost) as 0-d device tensors and never waits for the card: events
convert on first access, and a pass's costs and metrics cross to the host
in one transfer a ``log_period`` window and one at the pass's end, where
``EndPass`` averages them in float64 as the JAX package's ``np.mean``
over floats does.  ``test`` returns the mean of its batches' costs and
metrics the same way.  With ``test_reader``, ``EndPass`` carries the
test's metrics, not the pass's, as in the JAX package.

Not yet ported: meshes and data parallelism (``mesh``, ``zero``,
``zero_axis``, ``pipeline``, also the multi-task trainer's ``mesh``:
A12), the bad-step guard, fault plans and checkpointing (``guard``,
``faults``, ``save_dir`` and the other checkpoint arguments: A11), the
elastic master (``master``: A13) and the obs tracer (``tracer``: A10).
Passing one raises, naming its slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.platform import plog
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


def _metric_scalar(value) -> torch.Tensor:
    """Mean of a metric node's output over valid examples or tokens."""
    if isinstance(value, SequenceBatch):
        d = value.data.reshape(value.capacity, -1).sum(-1) \
            if value.data.dim() > 1 else value.data
        total = torch.where(value.valid_mask, d, torch.zeros_like(d)).sum()
        count = value.valid_mask.sum()
        return total / torch.clamp(count, min=1)
    return value.mean()


def _refuse(where: str, **given) -> None:
    """Raise for an argument of a slice not ported yet (``given``: name ->
    (value passed, its no-op default, the slice))."""
    for name, (value, default, part) in given.items():
        enforce_that(value is default or value == default,
                     f"{where}({name}=...) is not ported yet: it comes with "
                     f"{part}", context="trainer")


_A11 = "the resilience slice (A11)"
_A12 = "the parallel slice (A12)"


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


def _host_floats(values: List[torch.Tensor]) -> List[float]:
    """0-d tensors as Python floats, in one transfer."""
    return torch.stack(values).cpu().tolist() if values else []


class SGD:
    """``SGD(cost, parameters, update_equation).train(reader, ...)``.

    Runs on ``device`` (``cuda`` unless asked), where ``parameters`` must
    already live.  ``cost`` is one cost node or a list of them (summed).
    ``metrics`` maps display names to metric nodes (see
    :mod:`paddle_tpu_torch.evaluator`); ``extra_layers`` adds nodes under
    their own names."""

    def __init__(self, cost, parameters: Parameters,
                 update_equation: Optimizer,
                 extra_layers: Optional[Sequence[LayerOutput]] = None,
                 is_local: bool = True, mesh=None,
                 metrics: Optional[Dict[str, LayerOutput]] = None,
                 zero_axis: Optional[str] = None, zero: Optional[int] = None,
                 pipeline=None, faults=None, guard=None, tracer=None,
                 device: DeviceLike = None):
        _refuse("SGD", mesh=(mesh, None, _A12),
                zero_axis=(zero_axis, None, _A12), zero=(zero, None, _A12),
                pipeline=(pipeline, None, _A12),
                faults=(faults, None, _A11), guard=(guard, None, _A11),
                tracer=(tracer, None, "the obs slice (A10)"))
        costs = [cost] if isinstance(cost, LayerOutput) else list(cost)
        self.metrics = dict(metrics or {})
        for n in (extra_layers or []):
            self.metrics.setdefault(n.name, n)
        self.device = resolve_device(device)
        self.topology = Topology(costs + list(self.metrics.values()))
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
        # captured at the first train(): the logging cadence and the
        # step's gradient statistics must agree
        self._stats_period: Optional[int] = None

    def _step(self, feeds: Dict[str, object]):
        """(cost, {metric: value}) of one forward, backward and update,
        every value a 0-d device tensor; ``__param_stats__`` holds each
        gradient's mean and max |g| when the stats flag is on."""
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
        grads = dict(zip(self._names, grads))
        with torch.no_grad():
            metric_vals: Dict[str, Any] = {
                name: _metric_scalar(o) for name, o in
                zip(self.metrics, outs[self._n_costs:])}
            if self._stats_period:
                zero = torch.zeros((), device=self.device)
                metric_vals["__param_stats__"] = {
                    k: ((g.abs().mean(), g.abs().max()) if g is not None
                        else (zero, zero)) for k, g in grads.items()}
        self.optimizer.apply(params, grads, self.opt_state)
        self.model_state = new_state
        return total.detach(), metric_vals

    def step(self, feeds: Dict[str, object]) -> torch.Tensor:
        """One forward, backward and update on converted ``feeds``;
        returns the cost (0-d tensor on the device)."""
        return self._step(feeds)[0]

    def train(self, reader=None, num_passes: int = 1, event_handler=None,
              feeding=None, test_reader=None, save_dir: Optional[str] = None,
              start_pass: int = 0, saving_period: int = 1, master=None,
              record_parser=None, heartbeat_ttl_s: Optional[float] = None,
              prefetch: int = 0, save_period_steps: int = 0,
              resume: bool = False, async_save: Optional[bool] = None,
              keep: Optional[int] = None) -> None:
        """``num_passes`` passes over ``reader`` (a callable returning an
        iterator of sample batches), firing BeginPass, BeginIteration,
        EndIteration and EndPass on ``event_handler``; ``test_reader``
        runs :meth:`test` at each pass's end; ``prefetch > 0`` keeps that
        many batches fed and copied ahead on a producer thread
        (:func:`paddle_tpu_torch.reader.prefetch.device_prefetch`)."""
        _refuse("train", save_dir=(save_dir, None, _A11),
                start_pass=(start_pass, 0, _A11),
                save_period_steps=(save_period_steps, 0, _A11),
                resume=(resume, False, _A11),
                async_save=(async_save, None, _A11), keep=(keep, None, _A11),
                master=(master, None, "the tail slice (A13)"),
                record_parser=(record_parser, None, "the tail slice (A13)"),
                heartbeat_ttl_s=(heartbeat_ttl_s, None,
                                 "the tail slice (A13)"))
        enforce_that(reader is not None, "train() needs a reader",
                     context="trainer")
        handler = event_handler or _default_event_handler
        if self._stats_period is None:
            self._stats_period = int(FLAGS.show_parameter_stats_period or 0)
        period = self._stats_period
        log = plog.logger()
        feeder = self._make_feeder(feeding)
        for pass_id in range(num_passes):
            handler(v2_event.BeginPass(pass_id))
            pass_costs: List[float] = []
            pass_metrics: Dict[str, List[float]] = {n: [] for n in
                                                     self.metrics}
            pending: List[torch.Tensor] = []
            pending_metrics: Dict[str, List[torch.Tensor]] = {
                n: [] for n in self.metrics}

            def flush():
                pass_costs.extend(_host_floats(pending))
                pending.clear()
                for k, buf in pending_metrics.items():
                    pass_metrics[k].extend(_host_floats(buf))
                    buf.clear()

            raw_it = reader()
            if prefetch > 0:
                from paddle_tpu_torch.reader.prefetch import device_prefetch

                host = self._make_feeder(feeding, torch.device("cpu"))
                feed_it = device_prefetch(raw_it, size=prefetch,
                                          transform=host.feed,
                                          device=self.device)
            else:
                feed_it = (feeder.feed(b) for b in raw_it)
            for batch_id, feeds in enumerate(feed_it):
                handler(v2_event.BeginIteration(pass_id, batch_id))
                loss, metric_vals = self._step(feeds)
                pstats = metric_vals.pop("__param_stats__", None)
                if pstats is not None and (batch_id + 1) % period == 0:
                    for k in sorted(pstats):
                        avg_abs, max_abs = pstats[k]
                        log.info("Param %s avgAbsGrad=%.6g maxAbsGrad=%.6g",
                                 k, float(avg_abs), float(max_abs))
                pending.append(loss)
                for k, v in metric_vals.items():
                    pending_metrics[k].append(v)
                handler(v2_event.EndIteration(pass_id, batch_id, loss,
                                              metric_vals))
                if FLAGS.log_period and \
                        (batch_id + 1) % FLAGS.log_period == 0:
                    flush()
                    mtxt = " ".join(
                        f"{k}={np.mean(v[-FLAGS.log_period:]):.5f}"
                        for k, v in pass_metrics.items())
                    log.info("Pass %d, Batch %d, Cost %.5f %s", pass_id,
                             batch_id,
                             np.mean(pass_costs[-FLAGS.log_period:]), mtxt)
            flush()
            if test_reader is not None:
                tr = self.test(test_reader, feeding)
                handler(v2_event.EndPass(pass_id, tr.metrics,
                                         self.parameters))
            else:
                handler(v2_event.EndPass(
                    pass_id, {k: float(np.mean(v)) if v else 0.0
                              for k, v in pass_metrics.items()},
                    self.parameters))

    def test(self, reader, feeding=None) -> v2_event.TestResult:
        """Costs and metrics of every batch of ``reader`` in inference
        mode (batch norm on its moving statistics, no dropout), averaged
        over the batches."""
        feeder = self._make_feeder(feeding)
        params = {k: self.parameters[k] for k in self._names}
        costs: List[torch.Tensor] = []
        metrics: Dict[str, List[torch.Tensor]] = {n: [] for n in
                                                   self.metrics}
        with torch.no_grad():
            for data_batch in reader():
                outs, _ = self.topology.forward_with_state(
                    params, self.model_state, feeder.feed(data_batch),
                    train=False)
                total = _reduce_cost(outs[0])
                for o in outs[1:self._n_costs]:
                    total = total + _reduce_cost(o)
                costs.append(total)
                for name, o in zip(self.metrics, outs[self._n_costs:]):
                    metrics[name].append(_metric_scalar(o))
        cost_vals = _host_floats(costs)
        result = {k: float(np.mean(v)) if v else 0.0
                  for k, v in ((k, _host_floats(b))
                               for k, b in metrics.items())}
        return v2_event.TestResult(
            float(np.mean(cost_vals)) if cost_vals else 0.0, result)

    def save_parameter_to_tar(self, f) -> None:
        self.parameters.to_tar(f)

    def _make_feeder(self, feeding, device: DeviceLike = None) -> DataFeeder:
        data_types = [(n.name, n.input_type)
                      for n in self.topology.data_nodes]
        return DataFeeder(data_types, feeding, device=device or self.device)


def _default_event_handler(ev) -> None:
    pass


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
