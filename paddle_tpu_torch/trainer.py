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

Fault-tolerant training (the resilience slice): ``SGD(faults=, guard=)``
takes a seeded :class:`~paddle_tpu_torch.resilience.TrainFaultPlan` and a
:class:`~paddle_tpu_torch.resilience.BadStepGuard` (``guard=None`` falls
back to the ``train_bad_step_policy`` flag).  A guarded step adds the
plan's poison to the gradients, screens them with one global f32 sum of
squares and reads the verdict to the host once; a bad step runs no
update, so params, slots, the step counter and model state stay as they
were (see :mod:`paddle_tpu_torch.resilience.guard`).  ``train`` saves
checkpoints per pass (``save_dir``/``saving_period``, resumed by
``start_pass``) or every ``save_period_steps`` steps with a resume
cursor (``resume=True``; sync or ``async_save``, pruned to ``keep``), in
the JAX package's on-disk format (:mod:`paddle_tpu_torch.checkpoint`).
With ``master=`` it trains from an elastic task queue
(:mod:`paddle_tpu_torch.master`): one step a task, each task acked only
after a durable checkpoint covers it.

Parallel training (the parallel slice, :mod:`paddle_tpu_torch.parallel`):
``mesh=`` (a :class:`~paddle_tpu_torch.parallel.mesh.Mesh` over the job's
ranks) makes each rank train on its rows of the global batch over the
``data`` axis, with its loss scaled to 1/N of the global one and the
gradients summed over ``data`` (the psum GSPMD inserts in JAX); weights
with a declared split (expert, model, stage) are cut to the rank's part
and the layers run their parallel paths.  ``zero=1`` (or the
``zero_stage`` flag) shards the optimizer state over ``data`` (ZeRO-1,
:mod:`~paddle_tpu_torch.parallel.zero`); ``zero_axis`` splits each
weight's largest dim over an axis and gathers it for the forward.
``pipeline=PipelineConfig(...)`` repacks the zoo transformer's
``blk{i}_*`` weights into ``pipe_body.*`` [L, ...] stacks split over
``stage`` and trains through the GPipe schedule
(:mod:`~paddle_tpu_torch.parallel.pipeline`).  Checkpoints hold whole
tensors: split parts and ZeRO chunks are gathered on save (the mesh's
first rank writes) and cut on load, so a run saved on N ranks resumes on
M.  ``MultiTaskTrainer(mesh=)`` is data-parallel the same way.
``tracer`` puts the
guard and checkpoint edges on an obs timeline; each pass publishes the
timer table into the obs registry, and ``obs.trainer_event_bridge`` puts
passes and iterations on a trace timeline.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import Parameters
from paddle_tpu_torch.obs.registry import default_registry
from paddle_tpu_torch.obs.trace import NULL_TRACER
from paddle_tpu_torch.platform import plog, stats
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that
from paddle_tpu_torch.resilience.guard import (guard_init, guard_outputs,
                                               screen_grads, select_good)
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


def _check_mesh(mesh) -> None:
    if mesh is None:
        return
    from paddle_tpu_torch.parallel.mesh import Mesh

    enforce_that(isinstance(mesh, Mesh),
                 "mesh= takes a paddle_tpu_torch.parallel.Mesh (make_mesh, "
                 f"data_parallel_mesh ...), got {type(mesh).__name__}",
                 context="trainer")
    enforce_that(mesh.member, f"rank {mesh.rank} is not in {mesh!r}",
                 context="trainer")


def _pipe_embed(fp, mb):
    """The pipeline's first-stage hook: token + position embeddings of a
    padded microbatch (the ``embedding`` layers and their ``addto``)."""
    from paddle_tpu_torch.ops import math as pmath
    from paddle_tpu_torch.ops.embedding import embedding_lookup

    dt = pmath.dense_activation_dtype()
    return (embedding_lookup(fp["tok_embed.w"], mb["tokens"]).to(dt)
            + embedding_lookup(fp["pos_embed.w"], mb["pos"]).to(dt))


def _pipe_head(lp, y, mb):
    """The pipeline's last-stage hook: final norm, the vocab head and the
    cross-entropy summed over the microbatch's valid tokens."""
    from paddle_tpu_torch.ops import math as pmath
    from paddle_tpu_torch.ops.losses import softmax_cross_entropy
    from paddle_tpu_torch.ops.norm import layer_norm

    h = layer_norm(y, lp["final_ln.gamma"], lp["final_ln.beta"], eps=1e-5)
    logits = (pmath.matmul(h, lp["lm_head.w0"]) + lp["lm_head.b"]).to(
        pmath.dense_activation_dtype())
    xe = softmax_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               mb["target"].reshape(-1))
    xe = xe.reshape(mb["target"].shape)
    return torch.where(mb["mask"], xe, torch.zeros_like(xe)).sum()


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
        self._tracer = tracer if tracer is not None else NULL_TRACER
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
        self._pipeline = None
        self._pipe_specs: Dict[str, Any] = {}
        if pipeline is not None:
            mesh = self._setup_pipeline(pipeline, mesh)
            self._names = sorted(parameters.names())
        _check_mesh(mesh)
        self.mesh = mesh
        self._zero_axis = zero_axis
        self._placement = None
        if mesh is not None:
            from paddle_tpu_torch.parallel.api import MeshPlacement

            self._placement = MeshPlacement(
                mesh, {k: parameters[k] for k in self._names},
                specs=self._param_specs(), zero_axis=zero_axis)
        self._zero_plan = None
        stage = int(FLAGS.zero_stage if zero is None else zero)
        if stage:
            enforce_that(stage == 1, f"zero_stage={stage} not implemented "
                         "(0 = off, 1 = optimizer-state sharding)",
                         context="trainer")
            usable = mesh is not None and "data" in mesh.axis_names
            # an explicit zero= that cannot take effect is an error; the
            # process-wide flag stays permissive for meshless tools
            enforce_that(usable or zero is None,
                         "zero=1 needs mesh= with a 'data' axis (got "
                         + ("no mesh" if mesh is None else
                            f"axes {tuple(mesh.axis_names)}") + ")",
                         context="trainer")
            if usable:
                from paddle_tpu_torch.parallel.zero import build_zero_plan

                # planned on the whole shapes, as JAX's global arrays
                self._zero_plan = build_zero_plan(
                    mesh, {k: parameters[k] for k in self._names},
                    specs=self._param_specs(), zero_axis=zero_axis)
        if self._placement is not None:
            # commit the weights to the mesh (split ones cut to this
            # rank's part) before the optimizer makes its slots from them
            self._placement.place(parameters)
        self.optimizer = update_equation
        self.optimizer.set_param_specs(specs)
        # unconditional: a reused optimizer must not keep an earlier
        # trainer's plan
        self.optimizer.set_zero_plan(self._zero_plan)
        self.opt_state = self.optimizer.init_state(
            {k: parameters[k] for k in self._names})
        self.model_state = self.topology.init_state(self.device)
        # captured at the first train(): the logging cadence and the
        # step's gradient statistics must agree
        self._stats_period: Optional[int] = None
        # fault-tolerant runtime (paddle_tpu_torch.resilience): a seeded
        # TrainFaultPlan drives injected deaths/NaNs/slow steps, the
        # BadStepGuard screens every step; guard=None falls back to
        # FLAGS.train_bad_step_policy ("off" by default: the unguarded
        # step, no read of a verdict)
        self._faults = faults
        if guard is None:
            policy = str(FLAGS.train_bad_step_policy or "off")
            if policy != "off":
                from paddle_tpu_torch.resilience.guard import BadStepGuard

                guard = BadStepGuard(
                    policy=policy,
                    max_norm=float(FLAGS.train_bad_step_max_norm),
                    rollback_after=int(FLAGS.train_bad_step_window))
        if faults is not None and faults.injects_grads():
            enforce_that(guard is not None,
                         "TrainFaultPlan injects non-finite gradients "
                         "but no bad-step guard is set — pass "
                         "SGD(guard=BadStepGuard()) (or set "
                         "FLAGS.train_bad_step_policy) so the poison "
                         "is screened instead of corrupting optimizer "
                         "slots", context="trainer")
        self._guard = guard
        self._global_step = 0
        self._bad_steps_seen = 0   # per-train()-call counter mark
        self.bad_steps_total = 0   # lifetime skipped-step count
        self.verdict_reads = 0     # guarded steps' host reads of `good`
        self._async_ckpt = None

    # ------------------------------------------------------------------
    # pipeline parallelism (stage x data)
    # ------------------------------------------------------------------

    def _param_specs(self):
        """The topology's specs with the pipeline plan's: the one spec
        dict the placement and the ZeRO plan read."""
        specs = dict(self.topology.param_specs())
        specs.update(self._pipe_specs)
        return specs

    def _setup_pipeline(self, cfg, mesh):
        """Resolve the pipeline geometry, build (or check) the (data,
        stage) mesh, and repack the body's ``blk{i}_<suffix>`` weights
        into ``pipe_body.<suffix>`` [L, ...] stacks, whose plan splits
        the layer dim over ``stage``.  The stacks are whole in a
        checkpoint, so it reloads into any stage count dividing L."""
        import re

        from paddle_tpu_torch.parallel import placement
        from paddle_tpu_torch.parallel.mesh import make_mesh, world_size
        from paddle_tpu_torch.parallel.pipeline import PipelineConfig

        enforce_that(isinstance(cfg, PipelineConfig),
                     "pipeline= takes a parallel.PipelineConfig, got "
                     f"{type(cfg).__name__}", context="trainer")
        enforce_that(not self.metrics and self._n_costs == 1,
                     "pipeline= supports a single cost and no metric "
                     "layers (the loss rides the last-stage boundary "
                     "hook, not topology.forward)", context="trainer")
        axis = str(cfg.axis)
        pat = re.compile(r"^blk(\d+)_(.+)$")
        groups: Dict[str, Dict[int, str]] = {}
        for name in self.parameters.names():
            mt = pat.match(name)
            if mt:
                groups.setdefault(mt.group(2), {})[int(mt.group(1))] = name
        enforce_that(bool(groups),
                     "pipeline= found no blk{i}_* body parameters — the "
                     "pipeline trainer partitions the model-zoo "
                     "transformer naming convention "
                     "(models/transformer.build)", context="trainer")
        n_layers = int(cfg.n_layers) or (
            max(i for d in groups.values() for i in d) + 1)
        for suffix, d in groups.items():
            enforce_that(sorted(d) == list(range(n_layers)),
                         f"blk*_{suffix} layer ids {sorted(d)} do not "
                         f"cover 0..{n_layers - 1}", context="trainer")
        s = int(cfg.num_stages) or int(FLAGS.pipeline_stages)
        if not s:
            s = (int(mesh.shape[axis])
                 if mesh is not None and axis in mesh.axis_names
                 else world_size())
        m = int(cfg.microbatches) or int(FLAGS.pipeline_microbatches)
        enforce_that(m >= 1, f"pipeline_microbatches={m} must be >= 1",
                     context="trainer")
        enforce_that(n_layers % s == 0,
                     f"n_layers={n_layers} does not divide into "
                     f"num_stages={s}", context="trainer")
        if mesh is None:
            ndev = world_size()
            enforce_that(ndev % s == 0,
                         f"{ndev} devices do not divide into "
                         f"num_stages={s}", context="trainer")
            mesh = make_mesh((ndev // s, s), ("data", axis))
        enforce_that(axis in mesh.axis_names
                     and int(mesh.shape[axis]) == s,
                     f"mesh axes {dict(mesh.shape)} lack {axis!r}={s}",
                     context="trainer")
        stacked = {}
        for suffix, d in sorted(groups.items()):
            vals = [self.parameters.pop(d[i]) for i in range(n_layers)]
            stacked[f"pipe_body.{suffix}"] = torch.stack(vals)
        for k, v in stacked.items():
            self.parameters.place(k, v)
        self._pipe_specs = placement.pipeline_param_attrs(stacked, axis=axis)
        self._pipeline = cfg
        self._pipe_geom = dict(axis=axis, s=s, m=m, layers=n_layers,
                               heads=int(cfg.n_heads),
                               remat=bool(cfg.remat))
        return mesh

    def _pipeline_loss(self, params, feeds) -> torch.Tensor:
        """The topology's cost through the GPipe schedule: the padded
        feeds split into M microbatches, the embedding on the first stage,
        final norm + head + cross-entropy (the sum over valid tokens) on
        the last; divided by the rank's sequence count, as
        ``_reduce_cost`` divides a sequence cost."""
        from paddle_tpu_torch.models.transformer import block_apply
        from paddle_tpu_torch.parallel.pipeline import pipeline_apply

        g = self._pipe_geom
        m, per_stage = g["m"], g["layers"] // g["s"]
        n_heads = g["heads"]

        def padded(name):
            v, mask = feeds[name].to_padded()
            return (v[..., 0] if v.dim() == 3 else v), mask

        tok, mask = padded("tokens")
        pos, _ = padded("pos")
        tgt, _ = padded("target")
        b = int(tok.shape[0])
        enforce_that(b % m == 0,
                     f"batch of {b} sequences does not divide into "
                     f"pipeline_microbatches={m}", context="trainer")

        def split(a):
            return a.reshape((m, b // m) + tuple(a.shape[1:]))

        mbs = {"tokens": split(tok), "pos": split(pos),
               "target": split(tgt), "mask": split(mask)}
        stk = {k[len("pipe_body."):]: v.reshape((1, per_stage)
                                                 + tuple(v.shape[1:]))
               for k, v in params.items() if k.startswith("pipe_body.")}

        def stage_fn(blocks, x):
            for j in range(per_stage):
                x = block_apply({k: v[j] for k, v in blocks.items()}, x,
                                n_heads=n_heads)
            return x

        first_p = {k: params[k] for k in ("tok_embed.w", "pos_embed.w")}
        last_p = {k: params[k] for k in ("final_ln.gamma", "final_ln.beta",
                                         "lm_head.w0", "lm_head.b")}
        sums = pipeline_apply(self.mesh, stage_fn, stk, mbs,
                              axis=g["axis"], first_fn=_pipe_embed,
                              first_params=first_p, last_fn=_pipe_head,
                              last_params=last_p, remat=g["remat"])
        return sums.sum() / b

    def _step(self, feeds: Dict[str, object], gstate=None):
        """(cost, {metric: value}) of one forward, backward and update,
        every value a 0-d device tensor; ``__param_stats__`` holds each
        gradient's mean and max |g| when the stats flag is on.  With a
        guard state (``gstate``, see :func:`resilience.guard.guard_init`)
        the gradients take its ``inject`` and are screened; a bad step
        runs no update and keeps the old model state.  On a mesh the
        rank steps on its rows of the global batch; the cost and metrics
        returned are the global means."""
        mp = self._placement
        if mp is not None:
            feeds = mp.shard_feeds(feeds)
        params = {k: self.parameters[k].requires_grad_(True)
                  for k in self._names}
        step = self.opt_state["step"]
        outs: List[Any] = []
        new_state = self.model_state
        if self._pipeline is not None:
            total = self._pipeline_loss(params, feeds)
        else:
            fwd = mp.forward_params(params) if mp is not None else params
            outs, new_state = self.topology.forward_with_state(
                fwd, self.model_state, feeds, train=True,
                seed=(FLAGS.seed or 0) * 1_000_003 + step, mesh=self.mesh)
            total = _reduce_cost(outs[0])
            for o in outs[1:self._n_costs]:
                total = total + _reduce_cost(o)
        dp_n = mp.dp_n if mp is not None else 1
        # each rank's loss is 1/N of the global batch's: its gradients,
        # summed over 'data', are the global loss's
        grads = torch.autograd.grad(total / dp_n if dp_n > 1 else total,
                                    [params[k] for k in self._names],
                                    allow_unused=True)
        grads = dict(zip(self._names, grads))
        if mp is not None and self._zero_plan is None:
            mp.reduce_grads(grads)
        if gstate is not None:
            grads, good_t, _ = screen_grads(grads, gstate["inject"],
                                            self._guard.max_norm)
            if self._zero_plan is not None and dp_n > 1:
                # ZeRO sums the gradients inside the update: each rank
                # screened its own, so a step is good only where all are
                from paddle_tpu_torch.parallel.comm import all_reduce_

                good_t = all_reduce_(good_t.to(torch.float32),
                                     mp.dp_group,
                                     torch.distributed.ReduceOp.MIN) > 0
        with torch.no_grad():
            metric_vals: Dict[str, Any] = {
                name: _metric_scalar(o) for name, o in
                zip(self.metrics, outs[self._n_costs:])}
            if mp is not None:
                metric_vals = {k: mp.mean_over_data(v)
                               for k, v in metric_vals.items()}
            if self._stats_period:
                zero = torch.zeros((), device=self.device)
                metric_vals["__param_stats__"] = {
                    k: ((g.abs().mean(), g.abs().max()) if g is not None
                        else (zero, zero)) for k, g in grads.items()}
        good = True
        if gstate is not None:
            # the guarded step's one wait for the card
            good = bool(good_t)
            self.verdict_reads += 1
            gstate.update(guard_outputs(good, gstate))
        if good:
            self.optimizer.apply(params, grads, self.opt_state)
        self.model_state = select_good(good, new_state, self.model_state)
        cost = mp.mean_over_data(total) if mp is not None \
            else total.detach()
        return cost, metric_vals

    def step(self, feeds: Dict[str, object]) -> torch.Tensor:
        """One forward, backward and update on converted ``feeds`` (under
        the guard when one is set: a bad step is skipped and counted in
        ``bad_steps_total``); returns the cost (0-d tensor on the
        device)."""
        gstate = guard_init() if self._guard is not None else None
        loss = self._step(feeds, gstate)[0]
        if gstate is not None:
            self.bad_steps_total += gstate["bad_total"]
        return loss

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
        (:func:`paddle_tpu_torch.reader.prefetch.device_prefetch`).

        ``save_dir``/``start_pass``/``saving_period`` are the reference
        trainer's --save_dir/--start_pass/--saving_period: checkpoints
        (params + optimizer state + model state) land in
        save_dir/pass-%05d every ``saving_period`` passes, and
        ``start_pass`` resumes from pass ``start_pass - 1``'s.
        ``num_passes`` is the TOTAL pass count.

        Fault-tolerant mode: with ``save_period_steps=N`` checkpoints are
        step-granular — every N steps (and at each pass end) a checkpoint
        carrying a ``cursor`` (pass id, step-in-pass, global step) is
        written under a monotonically increasing id; ``resume=True``
        restores the newest INTACT checkpoint (corrupt dirs are rejected
        with a CKPT-CORRUPT line and the next-older one wins) and
        fast-forwards the reader without converting the skipped batches,
        so a killed run re-joins mid-pass and ends equal to an
        uninterrupted one.  ``async_save=True`` (default
        ``FLAGS.train_ckpt_async``) writes on a background thread
        (:class:`~paddle_tpu_torch.resilience.AsyncCheckpointer`):
        training stalls only for the device->host snapshot, and ``train``
        returns only once the newest checkpoint is durable.  ``keep``
        bounds the checkpoint dir (verified-aware pruning; default
        ``FLAGS.train_ckpt_keep``).

        With ``master=MasterClient(...)`` training is elastic and
        task-driven instead (see :meth:`_train_elastic`): batches come
        from master tasks (``record_parser`` maps each record's bytes to
        a sample), the lease is heartbeat per batch with
        ``heartbeat_ttl_s``, and a lapsed lease re-registers and resumes
        from the latest checkpoint in ``save_dir``."""
        use_async = bool(FLAGS.train_ckpt_async) if async_save is None \
            else bool(async_save)
        keep = int(FLAGS.train_ckpt_keep) if keep is None else int(keep)
        if master is not None:
            enforce_that(record_parser is not None,
                         "master= training needs record_parser=",
                         context="trainer")
            enforce_that(start_pass == 0, "start_pass is reader-path only; "
                         "elastic training resumes from save_dir "
                         "automatically", context="trainer")
            enforce_that(save_period_steps == 0,
                         "save_period_steps is reader-path only; elastic "
                         "training checkpoints per saving_period tasks",
                         context="trainer")
            return self._train_elastic(master, record_parser, num_passes,
                                       event_handler, feeding, save_dir,
                                       heartbeat_ttl_s, saving_period,
                                       test_reader, use_async, keep)
        enforce_that(reader is not None, "train() needs a reader "
                     "(or master=)", context="trainer")
        enforce_that(not (resume and start_pass > 0),
                     "resume= (step-granular, cursor-driven) and "
                     "start_pass= (pass-granular) are exclusive",
                     context="trainer")
        # silently no-opping these would make a supervised run restart
        # from scratch on every death
        enforce_that(not (resume and save_dir is None),
                     "resume=True needs save_dir= (nothing to resume "
                     "from otherwise)", context="trainer")
        enforce_that(not (save_period_steps > 0 and save_dir is None),
                     "save_period_steps needs save_dir=",
                     context="trainer")
        handler = event_handler or _default_event_handler
        if self._stats_period is None:
            self._stats_period = int(FLAGS.show_parameter_stats_period or 0)
        period = self._stats_period
        log = plog.logger()
        feeder = self._make_feeder(feeding)

        from paddle_tpu_torch import checkpoint as ckpt

        if save_dir is not None and start_pass > 0:
            import os

            # resume from exactly pass start_pass-1 (newer checkpoints may
            # exist when re-branching; silently training from fresh init
            # would overwrite them with garbage)
            want = start_pass - 1
            enforce_that(os.path.isdir(ckpt.pass_dir(save_dir, want)),
                         f"start_pass={start_pass} but no checkpoint "
                         f"pass-{want:05d} under {save_dir}",
                         context="trainer")
            self.load_checkpoint(save_dir, want)

        resume_pass, resume_step = start_pass, 0
        if resume:
            # an earlier call's async write may still be in flight on the
            # writer: every rank reads only once it has committed
            self._drain_async_writer("resuming")
            self._mesh_barrier()
            loaded = ckpt.load_latest(save_dir, device="cpu")
            if loaded is not None:
                self.apply_checkpoint(loaded)
                meta = loaded[3]
                cur = meta.get("cursor") or {}
                # a cursor-less (per-pass) checkpoint resumes at the pass
                # AFTER the one it closed
                resume_pass = int(cur.get("pass_id",
                                          meta.get("pass_id", -1) + 1))
                resume_step = int(cur.get("step_in_pass", 0))
                log.info("resumed from checkpoint (pass %d, step-in-pass "
                         "%d, global step %d)", resume_pass, resume_step,
                         self._global_step)
                self._tracer.instant("train_resume", cat="train",
                                     pass_id=resume_pass,
                                     step=self._global_step)
        step_saves = save_dir is not None and save_period_steps > 0
        ck_next = 0
        if step_saves:
            # monotonic checkpoint counter above every existing dir
            lp = ckpt.latest_pass(save_dir)
            ck_next = (lp + 1) if lp is not None else 0
        # per-call checkpointer: a previous train() call's async writer
        # must neither leak into this call nor race it — settle and
        # rebuild from this call's arguments
        if self._async_ckpt is not None:
            self._drain_async_writer("superseded by a new train() call")
            self._async_ckpt = None
        if step_saves and use_async:
            from paddle_tpu_torch.resilience.checkpointer import \
                AsyncCheckpointer

            self._async_ckpt = AsyncCheckpointer(keep=keep)
        gstate = guard_init() if self._guard is not None else None
        self._bad_steps_seen = 0
        faults = self._faults

        def save_cursor(pass_id: int, step_in_pass: int) -> None:
            """One step-granular checkpoint (sync or async) carrying the
            resume cursor; checkpoint ids are a monotonic counter, not
            pass ids, so mid-pass saves never collide."""
            nonlocal ck_next
            self._save_with_cursor(save_dir, ck_next, pass_id,
                                   step_in_pass, keep)
            ck_next += 1

        try:
            for pass_id in range(resume_pass, num_passes):
                skip = resume_step if pass_id == resume_pass else 0
                raw_it = reader()
                if skip:
                    # fast-forward the data cursor: the resumed pass
                    # consumed `skip` batches before the checkpoint, so
                    # drop them unconverted
                    for _ in range(skip):
                        if next(raw_it, None) is None:
                            break
                    peek = next(raw_it, None)
                    if peek is None:
                        # the cursor sits exactly at the pass boundary
                        # (the pass-end save was torn): the pass already
                        # completed AND fired its events — repair the
                        # boundary cursor and move on without re-firing
                        # BeginPass/EndPass over an empty replay
                        if step_saves:
                            save_cursor(pass_id + 1, 0)
                        continue
                    raw_it = itertools.chain([peek], raw_it)
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

                if prefetch > 0:
                    from paddle_tpu_torch.reader.prefetch import \
                        device_prefetch

                    host = self._make_feeder(feeding, torch.device("cpu"))
                    feed_it = device_prefetch(raw_it, size=prefetch,
                                              transform=host.feed,
                                              device=self.device)
                else:
                    feed_it = (feeder.feed(b) for b in raw_it)
                for batch_id, feeds in enumerate(feed_it, start=skip):
                    if faults is not None:
                        # injected clock tick + scheduled death, BEFORE
                        # the step runs (a killed step's work is lost and
                        # must replay from the last checkpoint)
                        faults.step_begin(self._global_step)
                    handler(v2_event.BeginIteration(pass_id, batch_id))
                    if gstate is not None:
                        gstate["inject"] = float(
                            faults.grad_inject(self._global_step)
                            if faults is not None else 0.0)
                    loss, metric_vals = self._step(feeds, gstate)
                    self._global_step += 1
                    pstats = metric_vals.pop("__param_stats__", None)
                    if pstats is not None and (batch_id + 1) % period == 0:
                        for k in sorted(pstats):
                            avg_abs, max_abs = pstats[k]
                            log.info("Param %s avgAbsGrad=%.6g "
                                     "maxAbsGrad=%.6g",
                                     k, float(avg_abs), float(max_abs))
                    pending.append(loss)
                    for k, v in metric_vals.items():
                        pending_metrics[k].append(v)
                    handler(v2_event.EndIteration(pass_id, batch_id, loss,
                                                  metric_vals))
                    if step_saves and (batch_id + 1) % save_period_steps == 0:
                        save_cursor(pass_id, batch_id + 1)
                    if gstate is not None:
                        self._guard_check(gstate)
                    if FLAGS.log_period and \
                            (batch_id + 1) % FLAGS.log_period == 0:
                        flush()
                        mtxt = " ".join(
                            f"{k}={np.mean(v[-FLAGS.log_period:]):.5f}"
                            for k, v in pass_metrics.items())
                        log.info("Pass %d, Batch %d, Cost %.5f %s", pass_id,
                                 batch_id,
                                 np.mean(pass_costs[-FLAGS.log_period:]),
                                 mtxt)
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
                if gstate is not None:
                    # before the pass-end save: a save-kill must not
                    # swallow this pass's bad-step accounting
                    self._flush_guard_stats(gstate)
                if step_saves:
                    # pass boundary in cursor terms: next pass, step 0
                    save_cursor(pass_id + 1, 0)
                elif save_dir is not None \
                        and (pass_id + 1) % saving_period == 0:
                    self.save_checkpoint(save_dir, pass_id)
                # the per-batch timers land next to the serving metrics on
                # one scrape surface
                stats.timer_stats().publish(default_registry(),
                                            prefix="trainer_")
        except BaseException:
            # unwind (injected death, rollback, real error): let the
            # in-flight background write finish — deterministic, and a
            # half-written artifact would otherwise race the resume —
            # and loudly report (not raise) any recorded writer failure
            self._drain_async_writer("train loop unwinding")
            if gstate is not None:
                self._flush_guard_stats(gstate)
            raise
        if self._async_ckpt is not None:
            # durability barrier: train() returning means the newest
            # checkpoint is committed (writer errors surface here, on the
            # writer); on a mesh no rank returns before the writer has
            # waited, so none reads a checkpoint that is still being
            # written
            try:
                self._async_ckpt.wait()
            finally:
                self._mesh_barrier()

    # ------------------------------------------------------------------
    # bad-step guard + cursor-checkpoint plumbing
    # ------------------------------------------------------------------

    def _guard_check(self, gstate) -> None:
        """Rollback-policy hysteresis check every ``guard.cadence``
        steps (where the JAX package reads its device counter back).  A
        streak of ``rollback_after`` bad steps dumps the flight recorder
        and raises BadStepRollback — the supervisor restarts from the
        newest verified checkpoint."""
        g = self._guard
        if g is None or g.policy != "rollback" \
                or self._global_step % g.cadence:
            return
        consec = int(gstate["bad_consec"])
        if consec < g.rollback_after:
            return
        from paddle_tpu_torch.resilience.faults import BadStepRollback

        self._tracer.instant("bad_step_rollback", cat="train",
                             consec=consec, step=self._global_step)
        if getattr(self._tracer, "enabled", False):
            self._tracer.dump_postmortem("bad-step-rollback")
        default_registry().counter(
            "train_rollbacks_total",
            "bad-step guard rollbacks to the last good checkpoint").inc()
        raise BadStepRollback(
            f"{consec} consecutive bad steps (>= {g.rollback_after}) at "
            f"global step {self._global_step}: rolling back to the last "
            "verified checkpoint")

    def _flush_guard_stats(self, gstate) -> None:
        """Bad-step accounting once a pass, and when a train() call
        unwinds (the verdicts are host ints here, so a dead attempt's
        skipped steps are counted too; the JAX package reads its device
        counter once a pass and loses them): newly skipped steps land on
        the obs timeline and the unified registry, and
        ``self.bad_steps_total`` accumulates the lifetime count (the
        per-call counter restarts at 0 on every train() call; the
        watermark ``_bad_steps_seen`` is reset with it)."""
        total = int(gstate["bad_total"])
        new = total - self._bad_steps_seen
        if new > 0:
            self.bad_steps_total += new
            self._tracer.instant("bad_steps_skipped", cat="train",
                                 count=new, total=self.bad_steps_total,
                                 step=self._global_step)
            default_registry().counter(
                "train_bad_steps_total",
                "train steps skipped by the bad-step guard "
                "(non-finite or over-norm gradients)").inc(new)
        self._bad_steps_seen = total

    def _drain_async_writer(self, why: str) -> None:
        """Join the in-flight async write and LOUDLY report — never
        raise — a recorded writer failure.  Used wherever the
        checkpointer is being discarded or the loop is already
        unwinding: the failed artifact is uncommitted (resume falls
        back to the previous checkpoint), but the failure must not die
        silently with the object."""
        ck = self._async_ckpt
        if ck is None:
            return
        ck.drain()
        err = ck.take_error()
        if err is not None:
            plog.logger().warning(
                "async checkpoint writer failed (%s): %r — artifact "
                "left uncommitted; resume falls back to the previous "
                "checkpoint", why, err)
            self._tracer.instant("ckpt_write_failed", cat="train",
                                 why=why)

    def _save_ckpt(self, root: str, ck_id: int, extra_meta: Dict,
                   keep: int) -> None:
        """One checkpoint of the live state, sync or async
        (``self._async_ckpt``), under the fault plan's save hook."""
        from paddle_tpu_torch import checkpoint as ckpt

        hook = self._faults.save_hook(ck_id) \
            if self._faults is not None else None
        params, opt = self._ckpt_view()
        plan = self._zero_plan
        with self._tracer.span("checkpoint_save", cat="train", ck=ck_id,
                               step=self._global_step):
            if not self._ckpt_writer():
                # the gathers are collectives; the first rank writes
                ckpt.snapshot_checkpoint(params, opt_state=opt,
                                         shard_plan=plan)
            elif self._async_ckpt is not None:
                self._async_ckpt.save(
                    root, ck_id, params, opt_state=opt,
                    model_state=self.model_state, extra_meta=extra_meta,
                    shard_plan=plan, commit_hook=hook)
            else:
                ckpt.save_checkpoint(
                    root, ck_id, params, opt_state=opt,
                    model_state=self.model_state, extra_meta=extra_meta,
                    shard_plan=plan, commit_hook=hook)
                if keep > 0:
                    ckpt.prune_checkpoints(root, keep=keep)
            self._ckpt_barrier()

    def _ckpt_view(self):
        """(params, opt_state) with every split weight and its slots
        gathered whole (collectives on a mesh; ZeRO's flat chunks are
        left to the checkpoint's ``shard_plan``)."""
        mp = self._placement
        if mp is None:
            return self.parameters, self.opt_state
        return (mp.whole_params(self.parameters.as_dict()),
                mp.whole_state(self.opt_state))

    def _ckpt_writer(self) -> bool:
        return self._placement is None or self._placement.writer

    def _ckpt_barrier(self) -> None:
        """On a mesh of several ranks nobody reads a checkpoint before
        the writer has committed it (sync saves; an async save keeps its
        depth-one pipelining, and its ranks meet in :meth:`_mesh_barrier`
        when train() returns or resumes)."""
        if self._async_ckpt is None:
            self._mesh_barrier()

    def _mesh_barrier(self) -> None:
        """Every rank of a mesh of several waits here for the others."""
        if self.mesh is not None and self.mesh.size > 1:
            torch.distributed.barrier(group=self.mesh.whole_group)

    def _save_with_cursor(self, root: str, ck_id: int, pass_id: int,
                          step_in_pass: int, keep: int) -> None:
        """One step-granular checkpoint whose cursor records what a
        replacement trainer needs to continue the SAME run: pass id,
        step-in-pass (the data cursor) and global step (the fault
        plan's clock).  The dropout stream needs no key: it follows the
        optimizer's step count, which the state carries."""
        self._save_ckpt(root, ck_id, {"cursor": {
            "pass_id": int(pass_id), "step_in_pass": int(step_in_pass),
            "global_step": int(self._global_step)}}, keep)

    def _train_elastic(self, master, record_parser, num_passes: int,
                       event_handler, feeding, save_dir: Optional[str],
                       ttl_s: Optional[float], saving_period: int,
                       test_reader, use_async: bool = False,
                       keep: int = 2) -> None:
        """Task-driven elastic training.

        One SGD step per master task; the step counter (== applied task
        count along this trainer lineage) drives the fault plan and is
        persisted in checkpoint meta, so a replacement trainer resumes
        the SAME run — final params equal an uninterrupted run
        (single-lineage guarantee — with several concurrent trainers a
        requeued task may be re-run by a peer, the reference's async
        tolerance).

        Ack protocol: tasks are acked ONLY after a checkpoint covering
        them is durable (``saving_period`` = tasks per checkpoint; every
        task when save_dir is unset).  The checkpoint meta records the
        covered-but-possibly-unacked task ids with their epoch, plus the
        in-progress pass and the next step, so a crash in ANY window —
        before the step, or after the checkpoint but before the acks —
        resumes without losing or double-applying a task.  Old
        checkpoints are pruned, never below two.

        Async mode (``use_async``) PIPELINES the durability: flush N
        waits out write N-1, acks the tasks write N-1 covered, then
        submits write N and keeps training — "ack strictly after
        durable" holds with the disk write off the step path.
        """
        from paddle_tpu_torch import checkpoint as ckpt

        handler = event_handler or _default_event_handler
        feeder = self._make_feeder(feeding)
        log = plog.logger()
        saving_period = max(1, int(saving_period))
        faults = self._faults
        # per-call checkpointer (same contract as the reader path); the
        # async prune budget keeps the sync path's >= 2 insurance floor
        if self._async_ckpt is not None:
            self._drain_async_writer("superseded by a new train() call")
            self._async_ckpt = None
        if save_dir is not None and use_async:
            from paddle_tpu_torch.resilience.checkpointer import \
                AsyncCheckpointer

            # keep=0 stays "pruning disabled"; only a positive budget
            # gets the >= 2 floor
            self._async_ckpt = AsyncCheckpointer(
                keep=keep if keep == 0 else max(2, keep))

        def resume_state():
            """-> (next_step, skip_set, pass_id, next_ckpt_id)."""
            latest = ckpt.latest_pass(save_dir) if save_dir else None
            if latest is None:
                return 0, set(), 0, 0
            loaded = ckpt.load_checkpoint(save_dir, device="cpu")
            self.apply_checkpoint(loaded)
            meta = loaded[3]
            log.info("elastic: resumed from checkpoint %d (pass %d, "
                     "next step %d)", latest, meta.get("pass_id", 0),
                     meta.get("next_step", latest + 1))
            skip = {(tid, meta.get("epoch", 0))
                    for tid in meta.get("task_ids", [])}
            return (meta.get("next_step", latest + 1), skip,
                    meta.get("pass_id", 0), latest + 1)

        if getattr(master, "_slot", None) is None:
            master.register(ttl_s=ttl_s)
        step, skip_set, pass_id, ck_id = resume_state()
        self._global_step = step
        gstate = guard_init() if self._guard is not None else None
        self._bad_steps_seen = 0
        unacked: List[int] = []
        # async pipelining: tasks covered by the in-flight (submitted,
        # not yet provably durable) checkpoint — acked at the NEXT flush
        # once that write has committed
        covered: List[int] = []

        def settle_covered() -> None:
            """The durability-then-ack invariant, in ONE place: wait the
            in-flight write durable (writer errors raise HERE, on the
            training thread), then — and only then — ack the tasks that
            write covered."""
            self._async_ckpt.wait()
            for tid in covered:
                master.ack_task(tid)
            covered.clear()

        def flush(meta_pass: int, epoch: int, final: bool = False) -> None:
            """Checkpoint the current state, then ack everything a
            DURABLE checkpoint covers.  On the async path the write of
            flush N commits in the background while training continues;
            flush N+1 (or the ``final`` drain) waits it out and acks its
            tasks."""
            nonlocal ck_id
            if save_dir is None:
                for tid in unacked:
                    master.ack_task(tid)
                unacked.clear()
                return
            meta = {"next_step": step, "pass_id": meta_pass,
                    "epoch": epoch}
            if self._async_ckpt is not None:
                # the lease math: a task acks at the latest one full
                # flush window after its write submits, so the master's
                # timeout_s must cover saving_period steps + one write
                settle_covered()                 # previous write durable
                covered[:] = list(unacked)
                unacked.clear()
                meta["task_ids"] = list(covered)
                self._save_ckpt(save_dir, ck_id, meta, keep)
                ck_id += 1
                if final:
                    settle_covered()
                return
            meta["task_ids"] = list(unacked)
            self._save_ckpt(save_dir, ck_id, meta,
                            max(2, keep) if keep > 0 else 0)
            ck_id += 1
            for tid in unacked:
                master.ack_task(tid)
            unacked.clear()

        try:
            while pass_id < num_passes:
                master.begin_pass()
                handler(v2_event.BeginPass(pass_id))
                pending_costs: List[torch.Tensor] = []
                batch_id = 0
                epoch = 0
                rejoined = False
                resumed_acks = False
                while True:
                    if not master.heartbeat(ttl_s=ttl_s):
                        # declared dead (a long pause): durable state is
                        # required to rejoin
                        enforce_that(save_dir is not None,
                                     "elastic lease lost with no save_dir: "
                                     "cannot resume; pass save_dir= to "
                                     "train(master=...)", context="trainer")
                        log.info("elastic: lease lost, re-registering")
                        # settle the in-flight write before reloading; its
                        # outcome is superseded by the reload either way
                        self._drain_async_writer("lease lost, rejoining")
                        master.register(ttl_s=ttl_s)
                        unacked.clear()
                        covered.clear()
                        step, skip_set, pass_id, ck_id = resume_state()
                        self._global_step = step
                        rejoined = True
                        break
                    status, got = master.try_next_task()
                    if status == "done":
                        if resumed_acks and batch_id == 0:
                            # the only thing this pass did was ack stale
                            # tasks from the PREVIOUS pass (crash at a
                            # pass boundary): the queue just drained, so
                            # recycle it and actually train this pass
                            master.begin_pass()
                            resumed_acks = False
                            continue
                        break
                    if status == "empty":
                        # possibly blocked on our own unacked tasks: flush
                        if unacked:
                            flush(pass_id, epoch)
                        elif covered and self._async_ckpt is not None:
                            # the queue tail: only the in-flight write's
                            # tasks are outstanding — wait it durable and
                            # ack them, or the poll would spin forever
                            settle_covered()
                        else:
                            master.poll_wait()   # jittered backoff
                        continue
                    task_id, epoch, records = got
                    master.poll_reset()
                    if skip_set:
                        if (task_id, epoch) in skip_set:
                            # already applied inside the restored
                            # checkpoint (crash hit between write and
                            # ack): ack, skip
                            skip_set.discard((task_id, epoch))
                            log.info("elastic: task %d already in "
                                     "checkpoint, skipping", task_id)
                            master.ack_task(task_id)
                            resumed_acks = True
                            continue
                        # requeued tasks come back FIRST; a non-match
                        # means the remaining skip entries are stale
                        skip_set.clear()
                    if faults is not None:
                        # injected clock + scheduled death BEFORE the
                        # batch is parsed or BeginIteration fires; the
                        # task stays leased-but-unacked, so it requeues
                        # when the lease lapses
                        faults.step_begin(step)
                    batch = [record_parser(r) for r in records]
                    handler(v2_event.BeginIteration(pass_id, batch_id))
                    if gstate is not None:
                        gstate["inject"] = float(
                            faults.grad_inject(step)
                            if faults is not None else 0.0)
                    loss, metric_vals = self._step(feeder.feed(batch),
                                                   gstate)
                    metric_vals.pop("__param_stats__", None)
                    step += 1
                    self._global_step = step
                    unacked.append(task_id)
                    if len(unacked) >= saving_period:
                        flush(pass_id, epoch)
                    elif covered and self._async_ckpt is not None \
                            and self._async_ckpt.idle():
                        # early ack: the background write already
                        # committed, so its tasks need not stay leased
                        # until the next flush
                        settle_covered()
                    if gstate is not None:
                        self._guard_check(gstate)
                    batch_id += 1
                    pending_costs.append(loss)
                    handler(v2_event.EndIteration(pass_id, batch_id - 1,
                                                  loss, metric_vals))
                    if FLAGS.log_period and batch_id % FLAGS.log_period == 0:
                        window = pending_costs[-FLAGS.log_period:]
                        log.info("Elastic pass %d, Batch %d, Cost %.5f",
                                 pass_id, batch_id - 1,
                                 float(np.mean(_host_floats(window))))
                if rejoined:
                    continue  # restart the (possibly different) pass
                # pass complete: flush leftovers, mark the NEXT pass
                # durable so a crash right here doesn't re-run this pass
                # on resume (final=True drains the async pipeline)
                pass_id += 1
                flush(pass_id, epoch, final=True)
                if gstate is not None:
                    self._flush_guard_stats(gstate)
                stats.timer_stats().publish(default_registry(),
                                            prefix="trainer_")
                if test_reader is not None:
                    tr = self.test(test_reader, feeding)
                    handler(v2_event.EndPass(pass_id - 1, tr.metrics,
                                             self.parameters))
                else:
                    handler(v2_event.EndPass(pass_id - 1, {},
                                             self.parameters))
        except BaseException:
            # unwind (injected death, rollback, real error): let the
            # in-flight write finish — its meta either commits (resume
            # skips its tasks) or not (they replay) — loudly reporting
            # any recorded writer failure
            self._drain_async_writer("elastic loop unwinding")
            if gstate is not None:
                self._flush_guard_stats(gstate)
            raise

    def test(self, reader, feeding=None) -> v2_event.TestResult:
        """Costs and metrics of every batch of ``reader`` in inference
        mode (batch norm on its moving statistics, no dropout), averaged
        over the batches (on a mesh: each rank tests its rows, the means
        are global)."""
        enforce_that(self._pipeline is None,
                     "test() is not supported under pipeline= (the "
                     "repacked body has no topology.forward view) — "
                     "evaluate with a sequential trainer sharing the "
                     "checkpoint", context="trainer")
        feeder = self._make_feeder(feeding)
        mp = self._placement
        params = {k: self.parameters[k] for k in self._names}
        costs: List[torch.Tensor] = []
        metrics: Dict[str, List[torch.Tensor]] = {n: [] for n in
                                                   self.metrics}
        with torch.no_grad():
            if mp is not None:
                params = mp.forward_params(params)
            for data_batch in reader():
                feeds = feeder.feed(data_batch)
                if mp is not None:
                    feeds = mp.shard_feeds(feeds)
                outs, _ = self.topology.forward_with_state(
                    params, self.model_state, feeds, train=False,
                    mesh=self.mesh)
                total = _reduce_cost(outs[0])
                for o in outs[1:self._n_costs]:
                    total = total + _reduce_cost(o)
                costs.append(mp.mean_over_data(total) if mp is not None
                             else total)
                for name, o in zip(self.metrics, outs[self._n_costs:]):
                    v = _metric_scalar(o)
                    metrics[name].append(mp.mean_over_data(v)
                                         if mp is not None else v)
        cost_vals = _host_floats(costs)
        result = {k: float(np.mean(v)) if v else 0.0
                  for k, v in ((k, _host_floats(b))
                               for k, b in metrics.items())}
        return v2_event.TestResult(
            float(np.mean(cost_vals)) if cost_vals else 0.0, result)

    def save_parameter_to_tar(self, f) -> None:
        self.parameters.to_tar(f)

    # ------------------------------------------------------------------
    # checkpoint/resume incl. optimizer state (paddle_tpu_torch.checkpoint)
    # ------------------------------------------------------------------

    def save_checkpoint(self, root: str, pass_id: int) -> str:
        """A checkpoint of the whole state under ``root`` (on a mesh:
        gathered from every rank, written by the first)."""
        from paddle_tpu_torch import checkpoint as ckpt

        params, opt = self._ckpt_view()
        if self._ckpt_writer():
            path = ckpt.save_checkpoint(root, pass_id, params,
                                        opt_state=opt,
                                        model_state=self.model_state,
                                        shard_plan=self._zero_plan)
        else:
            ckpt.snapshot_checkpoint(params, opt_state=opt,
                                     shard_plan=self._zero_plan)
            path = ckpt.pass_dir(root, pass_id)
        self._ckpt_barrier()
        return path

    def load_checkpoint(self, root: str,
                        pass_id: Optional[int] = None) -> None:
        from paddle_tpu_torch import checkpoint as ckpt

        self.apply_checkpoint(ckpt.load_checkpoint(root, pass_id,
                                                   device="cpu"))

    def apply_checkpoint(self, loaded) -> None:
        """Apply an already-read ``checkpoint.load_checkpoint`` result
        (this package's or the JAX package's) to the live trainer.

        Every parameter and every optimizer-state tensor is copied INTO
        the tensor the trainer already holds (shapes must match: a
        checkpoint of another model or optimizer raises), ``"step"``
        becomes the port's host int, the model state is rebuilt on the
        trainer's device, and a step cursor in the meta sets the global
        step.  Split from :meth:`load_checkpoint` so callers can separate
        disk-read failures from apply failures."""
        from paddle_tpu_torch.convert import state_from_numpy

        params, opt_state, model_state, meta = loaded
        mp = self._placement
        if mp is not None:
            # whole tensors from the file -> this rank's parts
            params = mp.local_params(params)
            if opt_state is not None:
                if self._zero_plan is not None:
                    opt_state = self._zero_plan.shard_state(opt_state)
                opt_state = mp.local_state(opt_state)
        with torch.no_grad():
            for name, value in params.items():
                enforce_that(name in self.parameters,
                             f"checkpoint parameter {name!r} is not in "
                             "the trainer's parameters", context="trainer")
                _copy_into(self.parameters[name], value, name)
            if opt_state is not None:
                self.opt_state = _assign_state(self.opt_state, opt_state,
                                               ())
        if model_state is not None:
            self.model_state = state_from_numpy(model_state, self.device)
        cur = meta.get("cursor") or {}
        if "global_step" in cur:
            self._global_step = int(cur["global_step"])

    def _make_feeder(self, feeding, device: DeviceLike = None) -> DataFeeder:
        data_types = [(n.name, n.input_type)
                      for n in self.topology.data_nodes]
        return DataFeeder(data_types, feeding, device=device or self.device)


def _copy_into(dst: torch.Tensor, src, what: str) -> None:
    """``dst.copy_(src)`` (a tensor or a numpy array) with the shapes held
    equal: copy_ would broadcast."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.asarray(src))
    enforce_that(tuple(src.shape) == tuple(dst.shape),
                 f"checkpoint {what}: shape {tuple(src.shape)} != "
                 f"{tuple(dst.shape)}", context="trainer")
    dst.copy_(src)


def _assign_state(live, loaded, path):
    """The optimizer state ``live`` with the checkpoint's numpy tree
    ``loaded`` written into its tensors in place (same keys required);
    ``"step"`` becomes a host int."""
    what = "/".join(map(str, ("opt_state",) + path))
    if path == ("step",):
        return int(np.asarray(loaded))
    if isinstance(live, dict):
        enforce_that(isinstance(loaded, dict) and
                     set(loaded) == set(live),
                     f"checkpoint {what}: keys "
                     f"{sorted(loaded) if isinstance(loaded, dict) else loaded!r}"
                     f" != the optimizer's {sorted(live)}",
                     context="trainer")
        return {k: _assign_state(v, loaded[k], path + (k,))
                for k, v in live.items()}
    enforce_that(isinstance(live, torch.Tensor),
                 f"checkpoint {what}: unexpected state leaf {live!r}",
                 context="trainer")
    _copy_into(live, loaded, what)
    return live


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
    ``device`` (``cuda`` unless asked), where ``parameters`` live.  With
    ``mesh=`` a step is data-parallel: each rank takes its rows of the
    feeds over ``data`` and the gradients are summed over it (the cost
    returned is the global mean)::

        t = MultiTaskTrainer([
            TaskSpec("d", d_cost, Adam(learning_rate=2e-4), trainable="dis_"),
            TaskSpec("g", g_cost, Adam(learning_rate=2e-4), trainable="gen_"),
        ], parameters)
        d_loss = t.step("d", {"pixel": real, "noise": z, ...})
    """

    def __init__(self, tasks: Sequence[TaskSpec], parameters: Parameters,
                 mesh=None, device: DeviceLike = None):
        enforce_that(len(tasks) > 0, "need at least one task",
                     context="MultiTaskTrainer")
        self.device = resolve_device(device)
        self.tasks = {t.name: t for t in tasks}
        self.parameters = parameters
        _check_mesh(mesh)
        self.mesh = mesh
        self._placement = None
        if mesh is not None:
            from paddle_tpu_torch.parallel.api import MeshPlacement

            specs: Dict[str, Any] = {}
            for t in tasks:
                specs.update(Topology([t.cost]).param_specs())
            self._placement = MeshPlacement(mesh, parameters.as_dict(),
                                            specs=specs)
            self._placement.place(parameters)
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
        mp = self._placement
        if mp is not None:
            feeds = mp.shard_feeds(feeds)
        task = self.tasks[name]
        topo = self._topos[name]
        names = self._trainable[name]
        train_set = set(names)
        params = {k: (self.parameters[k].requires_grad_(True)
                      if k in train_set else self.parameters[k].detach())
                  for k in topo.param_specs()}
        if mp is not None:
            params = mp.forward_params(params)
        seed = (FLAGS.seed or 0) * 1_000_003 + self._steps
        outs, new_state = topo.forward_with_state(
            params, self._model_states[name], feeds, train=True, seed=seed,
            mesh=self.mesh)
        total = _reduce_cost(outs[0])
        dp_n = mp.dp_n if mp is not None else 1
        wrt = [k for k in names if k in params]
        grads = dict(zip(wrt, torch.autograd.grad(
            total / dp_n if dp_n > 1 else total,
            [params[k] for k in wrt], allow_unused=True)))
        if mp is not None:
            mp.reduce_grads(grads)
            total = mp.mean_over_data(total)
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
