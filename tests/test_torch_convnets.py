"""The port's convnet slice against the JAX package, on the CPU.

Both packages build the five image models of the zoo at a small size --
LeNet at 28 px and SmallNet at 32 px (batch 4), ResNet-18 and ResNet-50
at 64 px (batch 4), AlexNet at 67 px, its smallest size that keeps every
layer, and GoogLeNet at 64 px (batch 2) -- and take 5 steps of
``Momentum(0.9, 0.01)`` (bench.py's optimizer) on the same numpy batches,
fed as flat CHW rows through both ``DataFeeder``s.  The weights are drawn
once per model from seed 0 (the port's initializers, which draw the JAX
package's distributions) and cross into both packages through one tar in
the JAX package's format (``Parameters.to_tar``/``from_tar``).  AlexNet's
and GoogLeNet's dropout is patched to the identity in both packages for
the run (a torch generator cannot replay a JAX PRNG key); the port's
dropout has its own tests here and in ``test_torch_conv_ops.py``.
ResNet's smallest maps at 64 px are 2 x 2, so each channel's batch
statistics run over 16 values.

In f32 the models without batch norm train 5 free-running steps through
both ``trainer.SGD.train`` loops.  The ResNets are held step by step on
the JAX package's trajectory instead: before each of its 5 steps the
port's ``SGD.step`` takes the JAX run's parameters and moving statistics
(its Momentum slots its own), and the two costs, new statistics and
parameter updates are compared.  Run free, the two trajectories part, and
not through a fault of the port: the JAX package's one-pass batch
statistics (sums about the moving mean, 0 at the start) lose up to
7.6e-5 of a normalized value to XLA's f32 sums (measured against float64
on ResNet-18's maps; the port's torch sums lose 3.7e-6); that flips a
few ReLUs, and 5 steps at lr 0.01 amplify a flip until the JAX package
run from weights perturbed by 1e-7 itself parts from its own run by
1.2e-3 in cost (the last two tests here measure both).

In f32 a parameter's update is not held tensor by tensor at 1e-3 for
GoogLeNet and the ResNets: a ReLU input within f32 rounding of 0 that
one package rounds to the other side moves the gradients of the tensors
before it by about 1%, and the JAX package's own first f32 update of
ResNet-50 parts from its float64 one by 5.4e-2 on some tensor
(``test_jax_f32_resnet_first_update_parts_from_its_float64``).  These
three models are held tensor by tensor in float64 instead: both packages
run with every f32 cast widened to float64 by runtime patches
(``jax_in_float64``, ``port_in_float64``; no file of either package
changes) and train 5 free-running steps through their trainers.  That
holds every gradient of the backward pass (batch norm's gamma, beta and
input gradients, the residual ``addto``, ``concat``, LRN, the convs,
``fc`` over the NHWC flatten) and the Momentum update.

Tolerances, the measured worst case in brackets:
- f32 (``use_bf16`` off in both): costs within 1e-4 relative per step
  (free-running 7.6e-7; ResNets on the JAX trajectory 2.4e-5); the
  moving statistics within 1e-3 relative in norm after every step
  (1.2e-4); each parameter's update (p_5 - p_0 free-running, p_new -
  p_old per step on the trajectory), tensor by tensor, within 1e-3
  relative in norm for LeNet, SmallNet and AlexNet (6.8e-6) and within
  1e-1 for GoogLeNet (4.6e-2, its conv biases, whose whole value is the
  5 updates) and the ResNets (ResNet-18 1.4e-2, ResNet-50 5.3e-2).
- float64: costs, every moving statistic after every step and each
  parameter's update p_5 - p_0, tensor by tensor, within 1e-6 relative
  in norm (GoogLeNet 4.5e-14, ResNet-18 3.1e-13, ResNet-50 3.7e-8: its
  depth carries the last digits' differences furthest).
- bf16 policy (``use_bf16`` and ``bf16_activations`` on, the default):
  costs within 2e-2 relative per step (free-running 1.3e-3; ResNet-18 on
  the JAX trajectory 3.2e-3; ResNet-50 at 128 px, its first step,
  7.2e-3): bf16 operands and bf16 maps in both, every conv output and
  gradient rounded to bf16, and an f32 sum taken in another order can
  cross a rounding step (2 ** -8 of the value), which batch norm
  amplifies.  ResNet-50 is held at 128 px (4 x 4 maps, 64 values a
  channel): at 64 px its first cost parts from the JAX package's by
  percents, and the port's own first cost moves by more than 1e-2 when
  its weights move by 1e-7
  (``test_resnet50_bf16_cost_moves_by_percents_under_a_1e_7_change``).
"""
import contextlib
import functools
import io

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import data_feeder as jfeeder
from paddle_tpu import event as jevent
from paddle_tpu import minibatch as jminibatch
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import alexnet as jalexnet
from paddle_tpu.models import googlenet as jgooglenet
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import smallnet as jsmallnet
from paddle_tpu.ops import math as jmath
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import data_feeder as tfeeder
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.convert import parameters_from_numpy, state_from_numpy
from paddle_tpu_torch.models import alexnet as talexnet
from paddle_tpu_torch.models import googlenet as tgooglenet
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import smallnet as tsmallnet
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.parameters import Parameters as TParameters
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

from torch_float64 import jax_in_float64, port_in_float64

# name: (JAX module, port module, image size, batch, build kwargs,
#        dropout in the model)
MODELS = {
    "lenet": (jlenet, tlenet, 28, 4, {}, False),
    "smallnet": (jsmallnet, tsmallnet, 32, 4, {}, False),
    "resnet18": (jresnet, tresnet, 64, 4, {"depth": 18}, False),
    "resnet50": (jresnet, tresnet, 64, 4, {"depth": 50}, False),
    "alexnet": (jalexnet, talexnet, 67, 2, {}, True),
    "googlenet": (jgooglenet, tgooglenet, 64, 2, {}, True),
}
# ResNet-50 under the bf16 policy is held at 128 px, where its smallest
# maps are 4 x 4 and each channel's batch statistics run over 64 values
CONFIGS = {**MODELS,
           "resnet50@128": (jresnet, tresnet, 128, 4, {"depth": 50}, False)}
STEPS = 5
F32_COST_RTOL = 1e-4
PARAM_RTOL = 1e-3
F32_UPDATE_RTOL = 1e-1
# the models whose f32 updates agree tensor by tensor within PARAM_RTOL;
# the others are held so in float64 (see the module docstring)
F32_EXACT = ("alexnet", "lenet", "smallnet")
F64_RTOL = 1e-6
BF16_COST_RTOL = 2e-2


@contextlib.contextmanager
def bf16_policy(on: bool):
    names = ("use_bf16", "bf16_activations")
    old = [(getattr(JFLAGS, n), getattr(TFLAGS, n)) for n in names]
    for n in names:
        setattr(JFLAGS, n, on)
        setattr(TFLAGS, n, on)
    try:
        yield
    finally:
        for n, (j, t) in zip(names, old):
            setattr(JFLAGS, n, j)
            setattr(TFLAGS, n, t)


def _build(pkg, name):
    jmod, tmod, img, _, kw, _ = CONFIGS[name]
    if pkg == "jax":
        jtopo.reset_name_scope()
        return jmod.build(img_size=img, **kw)
    ttopo.reset_name_scope()
    return tmod.build(img_size=img, **kw)


@functools.lru_cache(maxsize=None)
def _tar(name) -> bytes:
    """The model's weights from seed 0 as one tar in the JAX package's
    format."""
    cost = _build("torch", name)[-1]
    buf = io.BytesIO()
    TParameters.from_topology(ttopo.Topology([cost]), seed=0,
                              device="cpu").to_tar(buf)
    return buf.getvalue()


def _batches(name, seed=1):
    """``STEPS`` batches of (flat CHW row, label) samples."""
    _, _, img, bs, _, _ = CONFIGS[name]
    classes = 10 if name in ("lenet", "smallnet") else 1000
    chans = 1 if name == "lenet" else 3
    rng = np.random.RandomState(seed)
    return [[(rng.randn(chans * img * img).astype(np.float32),
              int(rng.randint(classes))) for _ in range(bs)]
            for _ in range(STEPS)]


def _train(sgd, event_mod, minibatch_mod, batches):
    costs = []

    def handler(ev):
        if isinstance(ev, event_mod.EndIteration):
            costs.append(float(ev.cost))

    samples = [s for b in batches for s in b]
    sgd.train(minibatch_mod.batch(lambda: iter(samples), len(batches[0])),
              num_passes=1, event_handler=handler)
    return np.asarray(costs)


def _no_dropout(monkeypatch):
    monkeypatch.setattr(jmath, "dropout", lambda x, rate, key, train: x)
    monkeypatch.setattr(tmath, "dropout", lambda x, rate, gen, train: x)


def _train_both(name, use_bf16, monkeypatch):
    if MODELS[name][5]:
        _no_dropout(monkeypatch)
    batches = _batches(name)
    tar = _tar(name)
    with bf16_policy(use_bf16):
        jcost = _build("jax", name)[-1]
        jsgd = jtrainer.SGD(cost=jcost,
                            parameters=JParameters.from_tar(io.BytesIO(tar)),
                            update_equation=jopt.Momentum(
                                momentum=0.9, learning_rate=0.01))
        jcosts = _train(jsgd, jevent, jminibatch, batches)
        tcost = _build("torch", name)[-1]
        tsgd = ttrainer.SGD(tcost, TParameters.from_tar(io.BytesIO(tar),
                                                        device="cpu"),
                            topt.Momentum(momentum=0.9, learning_rate=0.01),
                            device="cpu")
        tcosts = _train(tsgd, tevent, tminibatch, batches)
    return jsgd, tsgd, jcosts, tcosts


def _rel_norm(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _state_errors(tstate, jstate):
    """Relative error in norm of every moving statistic, the JAX package's
    crossed into the port's with ``state_from_numpy``."""
    jstate = state_from_numpy(
        {layer: {s: np.asarray(v) for s, v in slots.items()}
         for layer, slots in jstate.items()}, device="cpu")
    assert set(jstate) == set(tstate)
    return {(layer, s): _rel_norm(tstate[layer][s].numpy(), want.numpy())
            for layer, slots in jstate.items() for s, want in slots.items()}


NO_BATCH_NORM = ("alexnet", "googlenet", "lenet", "smallnet")
RESNETS = ("resnet18", "resnet50")


@pytest.mark.parametrize("name", NO_BATCH_NORM)
def test_training_matches_jax_f32(name, monkeypatch):
    """5 free-running steps through both ``SGD.train`` loops: the costs
    within 1e-4 and each parameter's update p_5 - p_0 within
    ``F32_UPDATE_RTOL`` relative in norm, tensor by tensor."""
    jsgd, tsgd, jcosts, tcosts = _train_both(name, False, monkeypatch)
    assert len(jcosts) == len(tcosts) == STEPS
    np.testing.assert_allclose(tcosts, jcosts, rtol=F32_COST_RTOL)
    p0 = TParameters.from_tar(io.BytesIO(_tar(name)), device="cpu")
    jparams = jsgd.parameters.as_dict()
    assert set(tsgd.parameters.keys()) == set(jparams)
    rtol = PARAM_RTOL if name in F32_EXACT else F32_UPDATE_RTOL
    for k, v in jparams.items():
        err = _rel_norm(tsgd.parameters.get(k) - p0.get(k),
                        np.asarray(v) - p0.get(k))
        assert err <= rtol, (k, err)


@pytest.mark.parametrize("name", NO_BATCH_NORM)
def test_training_matches_jax_bf16_policy(name, monkeypatch):
    _, _, jcosts, tcosts = _train_both(name, True, monkeypatch)
    assert np.all(np.isfinite(tcosts))
    np.testing.assert_allclose(tcosts, jcosts, rtol=BF16_COST_RTOL)


def _wide(feeds, dtype):
    return {k: v.astype(dtype) if np.asarray(v).dtype == np.float32 else v
            for k, v in feeds.items()}


def _numpy_state(state):
    return {k: {s: np.array(v) for s, v in d.items()}
            for k, d in state.items()}


MODES = {"f32": (False, np.float32), "bf16": (True, np.float32),
         "f64": (False, np.float64)}


def _mode(mode):
    """(bf16 policy flags, float64 patches) of a run mode."""
    use_bf16, dtype = MODES[mode]
    return bf16_policy(use_bf16), (jax_in_float64() if dtype == np.float64
                                   else contextlib.nullcontext())


@functools.lru_cache(maxsize=None)
def _jax_step(name, mode):
    """The JAX package's trainer in ``mode`` from the tar: (its compiled
    step, its feeder, its first parameters, Momentum slots and moving
    statistics)."""
    dtype = MODES[mode][1]
    policy, wide = _mode(mode)
    with policy, wide:
        jimages, jlabel, _, jcost = _build("jax", name)
        params = JParameters.from_tar(io.BytesIO(_tar(name)))
        for k in list(params.keys()):
            params[k] = np.asarray(params[k], dtype)
        jsgd = jtrainer.SGD(cost=jcost, parameters=params,
                            update_equation=jopt.Momentum(
                                momentum=0.9, learning_rate=0.01))
        feeder = jfeeder.DataFeeder([(jimages.name, jimages.input_type),
                                     (jlabel.name, jlabel.input_type)])
        state = jax.tree.map(lambda v: v.astype(dtype), jsgd.model_state)
        return (jsgd._build_step(), feeder, jsgd.parameters.as_dict(),
                jsgd.opt_state, state)


def _jax_run(name, mode, params=None, steps=STEPS):
    """``steps`` steps of the JAX package's compiled step on
    ``_batches(name)`` from ``params`` (default: the tar's): (costs,
    parameters before each step and after the last, moving statistics
    likewise), as numpy."""
    dtype = MODES[mode][1]
    step, feeder, p, opt, state = _jax_step(name, mode)
    p = p if params is None else params
    policy, wide = _mode(mode)
    costs, ps, states = [], [{k: np.array(v) for k, v in p.items()}], \
        [_numpy_state(state)]
    with policy, wide:
        for batch in _batches(name)[:steps]:
            loss, p, opt, state, _ = step(p, opt, state,
                                          jax.random.PRNGKey(0),
                                          _wide(feeder.feed(batch), dtype))
            costs.append(float(loss))
            ps.append({k: np.array(v) for k, v in p.items()})
            states.append(_numpy_state(state))
    return costs, ps, states


@functools.lru_cache(maxsize=None)
def _jax_trajectory(name, mode, steps=STEPS):
    """:func:`_jax_run` from the tar, kept for the tests that read it."""
    return _jax_run(name, mode, steps=steps)


def _port_trainer(name, dtype):
    params = TParameters.from_tar(io.BytesIO(_tar(name)), device="cpu")
    for k in list(params.keys()):
        params[k] = params[k].to(dtype)
    tsgd = ttrainer.SGD(_build("torch", name)[-1], params,
                        topt.Momentum(momentum=0.9, learning_rate=0.01),
                        device="cpu")
    tsgd.model_state = {layer: {s: v.to(dtype) for s, v in slots.items()}
                        for layer, slots in tsgd.model_state.items()}
    return tsgd


def _torch_dtype(mode):
    return torch.float64 if MODES[mode][1] == np.float64 else torch.float32


def _port_on_jax_trajectory(name, mode, steps=STEPS, reference=None):
    """Before each of the JAX package's steps the port's ``SGD.step``
    takes that step's parameters and moving statistics and runs it on the
    same batch (its Momentum slots its own): per step (JAX cost, port
    cost, JAX statistics after, port statistics after, {parameter:
    relative error in norm of the port's update p_new - p_old against the
    JAX package's, or against ``reference``'s run of the step}).  The
    updates are taken in float64."""
    dtype = _torch_dtype(mode)
    costs, ps, states = _jax_trajectory(name, mode, steps)
    ref = ps if reference is None else reference[1]
    policy, _ = _mode(mode)
    rows = []
    with policy, (port_in_float64() if dtype == torch.float64
                  else contextlib.nullcontext()):
        tsgd = _port_trainer(name, dtype)
        feeder = tsgd._make_feeder(None)
        for i, batch in enumerate(_batches(name)[:steps]):
            p0 = ps[i]
            with torch.no_grad():
                for k, v in p0.items():
                    tsgd.parameters[k].copy_(torch.from_numpy(v))
            tsgd.model_state = {
                layer: {s: v.to(dtype) for s, v in slots.items()}
                for layer, slots in state_from_numpy(
                    states[i], device="cpu").items()}
            feeds = {k: v.to(dtype) if v.is_floating_point() else v
                     for k, v in feeder.feed(batch).items()}
            tloss = float(tsgd.step(feeds))
            errors = {k: _rel_norm(
                tsgd.parameters.get(k).astype(np.float64) - p0[k],
                ref[i + 1][k].astype(np.float64) - ref[i][k])
                for k in p0}
            rows.append((costs[i], tloss, states[i + 1], tsgd.model_state,
                         errors))
    return rows


@pytest.mark.parametrize("name", RESNETS)
def test_resnet_steps_match_jax_on_its_trajectory_f32(name):
    """Each of the 5 steps from the JAX package's parameters and moving
    statistics of that step: the cost within 1e-4, the new moving
    statistics within 1e-3 and each parameter's update within
    ``F32_UPDATE_RTOL`` relative in norm.  (Run free, the two
    trajectories part: see the module docstring.)"""
    for i, (jloss, tloss, jstate, tstate, errors) in enumerate(
            _port_on_jax_trajectory(name, "f32")):
        assert abs(tloss - jloss) <= F32_COST_RTOL * abs(jloss), \
            (i, tloss, jloss)
        for key, err in _state_errors(tstate, jstate).items():
            assert err <= PARAM_RTOL, (i, key, err)
        for key, err in errors.items():
            assert err <= F32_UPDATE_RTOL, (i, key, err)
        assert all(torch.count_nonzero(d["moving_mean"]) > 0
                   for d in tstate.values())


def test_resnet18_steps_match_jax_on_its_trajectory_bf16_policy():
    for i, (jloss, tloss, *_) in enumerate(_port_on_jax_trajectory(
            "resnet18", "bf16")):
        assert abs(tloss - jloss) <= BF16_COST_RTOL * abs(jloss), \
            (i, tloss, jloss)


def test_resnet50_first_step_matches_jax_bf16_policy_at_128px():
    """ResNet-50 under the bf16 policy at 128 px, where its smallest maps
    are 4 x 4 and each channel's batch statistics run over 64 values: the
    first step's cost within ``BF16_COST_RTOL`` (measured 7.2e-3; at 64 px
    it parts by 3.3%, at 96 px by 2.2%: see the next test)."""
    for i, (jloss, tloss, *_) in enumerate(_port_on_jax_trajectory(
            "resnet50@128", "bf16", steps=1)):
        assert abs(tloss - jloss) <= BF16_COST_RTOL * abs(jloss), \
            (i, tloss, jloss)


def test_resnet50_bf16_cost_moves_by_percents_under_a_1e_7_change():
    """Why ResNet-50 is held under the bf16 policy at 128 px: at 64 px
    (2 x 2 maps, 16 values a channel) the port's own first cost moves by
    more than 1e-2 when its weights move by 1e-7 relative (measured 3.2%,
    2.3%, 2.1% for three draws), as much as it parts from the JAX
    package's (3.3%): an f32 sum taken in another order crosses a bf16
    rounding step, and batch norm over 16 values carries it on."""
    batch = _batches("resnet50")[0]
    costs = []
    with bf16_policy(True):
        for eps in (0.0, 1e-7):
            tsgd = _port_trainer("resnet50", torch.float32)
            rng = np.random.RandomState(5)
            with torch.no_grad():
                for k in tsgd._names:
                    v = tsgd.parameters[k]
                    v.mul_(1 + eps * torch.from_numpy(
                        rng.randn(*v.shape).astype(np.float32)))
            costs.append(float(tsgd.step(
                tsgd._make_feeder(None).feed(batch))))
    assert abs(costs[1] - costs[0]) > 1e-2 * abs(costs[0]), costs


@pytest.mark.parametrize("name", ("googlenet",) + RESNETS)
def test_training_matches_jax_in_float64(name, monkeypatch):
    """Both packages in float64 (``jax_in_float64``, ``port_in_float64``)
    train 5 free-running steps from the tar through their trainers: every
    cost and every moving statistic after every step, and every
    parameter's update p_5 - p_0, tensor by tensor, within ``F64_RTOL``
    relative (in norm).  In float64 no ReLU input lies within rounding of
    0 and no one-pass statistic loses digits, so the two agree to the
    last digits a 5-step run keeps; this holds every gradient (batch
    norm's, the residual ``addto``'s, ``concat``'s, LRN's, the convs',
    ``fc`` over the NHWC flatten) and the Momentum update."""
    if MODELS[name][5]:
        _no_dropout(monkeypatch)
    jcosts, jparams, jstates = _jax_trajectory(name, "f64")
    with bf16_policy(False), port_in_float64():
        tsgd = _port_trainer(name, torch.float64)
        feeder = tsgd._make_feeder(None)
        for i, batch in enumerate(_batches(name)):
            feeds = {k: v.double() if v.is_floating_point() else v
                     for k, v in feeder.feed(batch).items()}
            tloss = float(tsgd.step(feeds))
            assert abs(tloss - jcosts[i]) <= F64_RTOL * abs(jcosts[i]), \
                (i, tloss, jcosts[i])
            for key, err in _state_errors(tsgd.model_state,
                                          jstates[i + 1]).items():
                assert err <= F64_RTOL, (i, key, err)
    p0, p5 = jparams[0], jparams[-1]
    assert set(tsgd.parameters.keys()) == set(p5)
    for k in p5:
        err = _rel_norm(tsgd.parameters.get(k) - p0[k], p5[k] - p0[k])
        assert err <= F64_RTOL, (k, err)


@pytest.mark.parametrize("name", RESNETS)
def test_jax_f32_resnet_first_update_parts_from_its_float64(name):
    """Why the ResNets' f32 updates are held at ``F32_UPDATE_RTOL`` and
    per tensor at ``PARAM_RTOL`` only in float64: from the tar, the first
    f32 update of either package parts from the JAX package's float64
    one by more than 1e-2 on some tensor (measured: ResNet-18, the JAX
    package's 4.2e-4 and the port's 1.4e-2; ResNet-50, 5.4e-2 and
    1.8e-2), each within ``F32_UPDATE_RTOL``."""
    _, j32, _ = _jax_trajectory(name, "f32")
    j64 = _jax_trajectory(name, "f64")
    jerr = max(_rel_norm(j32[1][k].astype(np.float64) - j32[0][k],
                         j64[1][1][k] - j64[1][0][k]) for k in j32[0])
    terr = max(_port_on_jax_trajectory(name, "f32", steps=1,
                                       reference=j64)[0][4].values())
    assert max(jerr, terr) > 1e-2, (jerr, terr)
    assert max(jerr, terr) <= F32_UPDATE_RTOL, (jerr, terr)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_declare_the_jax_parameters_and_state(name):
    """Same parameter names and shapes (conv weights HWIO
    [kh, kw, Cin / groups, Cout]) and the same state slots."""
    jtopology = jtopo.Topology([_build("jax", name)[-1]])
    ttopology = ttopo.Topology([_build("torch", name)[-1]])
    assert {k: tuple(s.shape) for k, s in jtopology.param_specs().items()} \
        == {k: tuple(s.shape) for k, s in ttopology.param_specs().items()}
    assert {k: {s: (tuple(v.shape), v.init_value) for s, v in d.items()}
            for k, d in jtopology.state_specs().items()} == \
        {k: {s: (tuple(v.shape), v.init_value) for s, v in d.items()}
         for k, d in ttopology.state_specs().items()}


def test_eval_forward_with_the_jax_state_matches_jax():
    """After 3 training steps in the JAX package, its weights and moving
    statistics cross into the port (``parameters_from_numpy``,
    ``state_from_numpy``) and a ``train=False`` forward of ResNet-18 gives
    the JAX package's logits; the forward leaves the state as it was."""
    _, jparams, jstates = _jax_trajectory("resnet18", "f32")
    with bf16_policy(False):
        jimages, jlabel, jlogits, jcost = _build("jax", "resnet18")
        feeds = jfeeder.DataFeeder([("image", jimages.input_type),
                                    ("label", jlabel.input_type)]).feed(
            _batches("resnet18", seed=2)[0])
        jtopology = jtopo.Topology([jlogits])
        jout, _ = jax.jit(lambda p, s, f: jtopology.forward(
            p, s, f, train=False))(jparams[3], jstates[3], feeds)

        timages, tlabel, tlogits, _ = _build("torch", "resnet18")
        params = parameters_from_numpy(jparams[3], device="cpu")
        state = state_from_numpy(jstates[3], device="cpu")
        tfeeds = {k: torch.from_numpy(np.array(v))
                  for k, v in feeds.items()}
        ttopology = ttopo.Topology([tlogits])
        tout, new_state = ttopology.forward_with_state(
            params.as_dict(), state, tfeeds, train=False)
    want = np.asarray(jout[0])
    np.testing.assert_allclose(tout[0].detach().numpy(), want,
                               atol=1e-4 * np.abs(want).max())
    for k, d in state.items():
        for s, v in d.items():
            assert new_state[k][s] is v


def test_dense_feeder_matches_jax_and_flat_rows_equal_nhwc_maps():
    """Flat CHW rows go through both feeders as the same [B, dim] f32
    tensor; a layer fed the rows computes what it computes on the same
    images given as [B, H, W, C] maps (the 4-D pass-through)."""
    batch = _batches("smallnet")[0]
    jtypes = [(n.name, n.input_type) for n in _build("jax", "smallnet")[:2]]
    timages, tlabel, tlogits, _ = _build("torch", "smallnet")
    ttypes = [(n.name, n.input_type) for n in (timages, tlabel)]
    jfeeds = jfeeder.DataFeeder(jtypes).feed(batch)
    tfeeds = tfeeder.DataFeeder(ttypes, device="cpu").feed(batch)
    assert tfeeds["image"].dtype == torch.float32
    assert tuple(tfeeds["image"].shape) == (4, 3 * 32 * 32)
    np.testing.assert_array_equal(tfeeds["image"].numpy(),
                                  np.asarray(jfeeds["image"]))
    np.testing.assert_array_equal(tfeeds["label"].numpy(),
                                  np.asarray(jfeeds["label"]))
    params = TParameters.from_topology(ttopo.Topology([tlogits]), seed=0,
                                       device="cpu").as_dict()
    topology = ttopo.Topology([tlogits])
    flat = topology.forward(params, {"image": tfeeds["image"]})[0]
    maps = tfeeds["image"].reshape(4, 3, 32, 32).permute(0, 2, 3, 1)
    nhwc = topology.forward(params, {"image": maps.contiguous()})[0]
    torch.testing.assert_close(flat, nhwc)


def test_trainer_commits_state_only_after_a_step_that_finishes(monkeypatch):
    """A step that raises after the forward leaves the moving statistics
    as they were; one that finishes commits them."""
    name = "resnet18"
    cost = _build("torch", name)[-1]
    sgd = ttrainer.SGD(cost, TParameters.from_tar(io.BytesIO(_tar(name)),
                                                  device="cpu"),
                       topt.Momentum(momentum=0.9, learning_rate=0.01),
                       device="cpu")
    before = {k: dict(d) for k, d in sgd.model_state.items()}
    feeds = sgd._make_feeder(None).feed(_batches(name)[0])

    def boom(*a, **k):
        raise RuntimeError("update failed")

    with monkeypatch.context() as m:
        m.setattr(sgd.optimizer, "apply", boom)
        with pytest.raises(RuntimeError, match="update failed"):
            sgd.step(feeds)
    assert all(sgd.model_state[k][s] is v for k, d in before.items()
               for s, v in d.items())
    sgd.step(feeds)
    assert all(not torch.equal(sgd.model_state[k]["moving_mean"],
                               before[k]["moving_mean"]) for k in before)


def test_dropout_layers_draw_one_stream_per_node_and_step():
    """The port's dropout layers at their real rates: masks differ across
    nodes and steps, repeat for the same node and step seed, and are off
    at ``train=False``."""
    from paddle_tpu_torch import data_type, layer

    ttopo.reset_name_scope()
    x = layer.data(name="x", type=data_type.dense_vector(4096))
    a = layer.dropout(x, 0.5)
    b = layer.dropout(x, 0.5)
    topology = ttopo.Topology([a, b])
    feeds = {"x": torch.ones(2, 4096)}
    a0, b0 = topology.forward({}, feeds, train=True, seed=0)
    a0b, _ = topology.forward({}, feeds, train=True, seed=0)
    a1, _ = topology.forward({}, feeds, train=True, seed=1)
    assert torch.equal(a0, a0b)
    assert not torch.equal(a0, b0) and not torch.equal(a0, a1)
    assert set(torch.unique(a0).tolist()) == {0.0, 2.0}
    ev = topology.forward({}, feeds, train=False)
    assert all(torch.equal(v, feeds["x"]) for v in ev)


def test_resnet18_batch_statistics_against_float64():
    """Why the ResNets are held step by step: on ResNet-18's maps at the
    first step (moving mean 0, so no pilot), the JAX package's one-pass
    f32 batch norm strays further from a float64 batch norm than the
    port's (measured on conv_3: 7.6e-5 against 3.7e-6 of a normalized
    value)."""
    from paddle_tpu.ops import norm as jnorm
    from paddle_tpu_torch.ops import norm as tnorm

    with bf16_policy(False):
        jimages, jlabel, _, jcost = _build("jax", "resnet18")
        jtopology = jtopo.Topology([jcost])
        params = JParameters.from_tar(io.BytesIO(_tar("resnet18"))).as_dict()
        feeds = jfeeder.DataFeeder([("image", jimages.input_type),
                                    ("label", jlabel.input_type)]).feed(
            _batches("resnet18")[0])
        node = jtopology.by_name["conv_3"]
        x = np.array(jax.jit(lambda p: jtopology.forward(
            p, jtopology.init_state(), feeds, train=True,
            outputs=[node])[0][0])(params))
    c = x.shape[-1]
    x64 = x.astype(np.float64).reshape(-1, c)
    exact = ((x64 - x64.mean(0)) / np.sqrt(x64.var(0) + 1e-5)).reshape(
        x.shape)
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    jy = np.asarray(jax.jit(lambda a: jnorm.batch_norm(
        a, ones, zeros, zeros, ones, train=True)[0])(x))
    ty = tnorm.batch_norm(torch.from_numpy(x), torch.from_numpy(ones),
                          torch.from_numpy(zeros), torch.from_numpy(zeros),
                          torch.from_numpy(ones), train=True)[0].numpy()
    jerr, terr = np.abs(jy - exact).max(), np.abs(ty - exact).max()
    assert terr < 1e-5 < jerr < 1e-3, (terr, jerr)


def test_jax_resnet18_parts_from_itself_under_a_1e_7_perturbation():
    """Why the ResNets are not held free-running: the JAX package's own
    5 steps from weights perturbed by 1e-7 (relative) part from its run
    from the tar by more than the cost tolerance (measured 1.2e-3)."""
    costs = np.asarray(_jax_trajectory("resnet18", "f32")[0])
    rng = np.random.RandomState(5)
    params = {k: np.asarray(v) * (1 + 1e-7 * rng.randn(*v.shape)).astype(
        np.float32) for k, v in _jax_step("resnet18", "f32")[2].items()}
    moved = np.asarray(_jax_run("resnet18", "f32", params)[0])
    rel = np.abs(moved - costs) / np.abs(costs)
    assert rel[0] < 1e-4 and rel.max() > 1e-4, rel
