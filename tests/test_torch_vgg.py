"""VGG-16 (``networks.vgg_16_network``), the port against the JAX package
on the CPU, at its published widths (13 convolutions of 64-512 filters,
fc 4096, 4096, 102) on 32-pixel images, batch 2, f32 policy.

The weights cross as numpy from the JAX initializer
(``convert.parameters_from_numpy``); the samples are ``tools/
vgg_workload``'s training mapper's (a random 32-pixel crop of a seeded
40-pixel image, a coin-flip mirror, less the BGR mean, CHW order) fed
through each package's ``DataFeeder``.  The forward in test mode (no
dropout) holds at 1e-5; two ``Momentum(0.9, 1e-2)`` + ``L2(5e-4)`` steps
hold the costs at 1e-5 and each parameter's update (its value after the
steps less its value before) at 1e-4 relative in norm to JAX's.
``vgg_16_network`` fixes its dropout at 0.5, and the two packages cannot
share masks (``jax.random`` against ``torch.Generator``), so for the
steps both packages' ``dropout`` is patched to the identity at run time
(the JAX package's ``ops/math.dropout`` through the module, which
``layer.dropout`` calls; no file of it changed).  The JAX steps run as
one compiled step each.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import data_type as jdt
from paddle_tpu import event as jevent
from paddle_tpu import layer as jlayer
from paddle_tpu import networks as jnetworks
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.data_feeder import DataFeeder as JFeeder
from paddle_tpu.ops import math as jmath
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch import convert
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.tools import vgg_workload as vw

IMG, EDGE, BATCH, STEPS = 32, 40, 2, 2
# UPDATE_RTOL: each parameter's change over the two steps against JAX's,
# in norm; the worst read 1.2e-5 (conv_1.w), the biases 3.5e-8-2.3e-6
RTOL, UPDATE_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    yield
    JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _jax_build():
    jtopo.reset_name_scope()
    image = jlayer.data(name="image",
                        type=jdt.dense_vector(3 * IMG * IMG), height=IMG,
                        width=IMG)
    label = jlayer.data(name="label", type=jdt.integer_value(vw.CLASSES))
    probs = jnetworks.vgg_16_network(image, num_channels=3,
                                     num_classes=vw.CLASSES)
    cost = jlayer.cross_entropy_cost(input=probs, label=label, name="cost")
    return probs, cost


def _batches(n=STEPS):
    samples = vw.raw_images(n * BATCH, 5, edge=EDGE)
    mapped = [vw.mapper(6, crop=IMG)(s) for s in samples]
    return [mapped[i * BATCH:(i + 1) * BATCH] for i in range(n)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def weights():
    _, cost = _jax_build()
    jparams = JParameters.from_topology(jtopo.Topology([cost]), seed=0)
    return {k: np.array(v) for k, v in jparams.as_dict().items()}


def test_vgg16_is_the_published_network(weights):
    ttopo.reset_name_scope()
    _, _, _, cost = vw.build(img=IMG)
    assert set(ttopo.Topology([cost]).param_specs()) == set(weights)
    convs = [k for k in weights if k.startswith("conv") and k.endswith(".w")]
    assert len(convs) == 13
    fcs = sorted(v.shape for k, v in weights.items()
                 if k.startswith("fc") and k.endswith(".w0"))
    assert fcs == sorted([(512, 4096), (4096, 4096), (4096, vw.CLASSES)])
    # at 224 px: 134.7 M parameters, fc6 25088 x 4096
    assert vw.parameter_count() == 134_678_438


def test_vgg16_forward_in_test_mode_matches_jax(weights):
    batch = _batches(1)[0]
    probs, _ = _jax_build()
    jt = jtopo.Topology([probs])
    jfeeds = JFeeder([("image", jdt.dense_vector(3 * IMG * IMG))])(
        [(s[0],) for s in batch])
    want = np.asarray(jt.forward({k: jnp.asarray(v) for k, v in
                                  weights.items() if k in jt.param_specs()},
                                 jt.init_state(), jfeeds)[0][0])
    ttopo.reset_name_scope()
    _, _, tprobs, _ = vw.build(img=IMG)
    tt = ttopo.Topology([tprobs])
    tparams = convert.parameters_from_numpy(weights, device="cpu")
    tfeeds = TFeeder([("image", tt.data_nodes[0].input_type)],
                     device="cpu")([(s[0],) for s in batch])
    got = tt.forward({k: tparams[k] for k in tt.param_specs()},
                     tfeeds)[0].detach().numpy()
    assert got.shape == (BATCH, vw.CLASSES)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def _costs(sgd, event_mod, batches):
    costs = []
    sgd.train(lambda: iter(batches), event_handler=lambda ev:
              costs.append(float(ev.cost))
              if isinstance(ev, event_mod.EndIteration) else None)
    return np.asarray(costs)


def test_vgg16_momentum_l2_steps_match_jax(weights, monkeypatch):
    no_dropout = (lambda x, rate, key, train: x)
    monkeypatch.setattr(jmath, "dropout", no_dropout)
    monkeypatch.setattr(tmath, "dropout", no_dropout)
    batches = _batches()
    _, jcost = _jax_build()
    jparams = JParameters.from_topology(jtopo.Topology([jcost]), seed=0)
    jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                        update_equation=jopt.Momentum(
                            momentum=vw.MOMENTUM,
                            learning_rate=vw.LEARNING_RATE,
                            regularization=jopt.L2Regularization(vw.L2)))
    jc = _costs(jsgd, jevent, batches)
    ttopo.reset_name_scope()
    _, _, _, tcost = vw.build(img=IMG)
    tparams = convert.parameters_from_numpy(weights, device="cpu")
    tsgd = ttrainer.SGD(tcost, tparams, vw.optimizer(), device="cpu")
    tc = _costs(tsgd, tevent, batches)
    assert len(tc) == STEPS and np.isfinite(tc).all()
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    jd = jsgd.parameters.as_dict()
    assert set(jd) == set(tparams.keys())
    for k, v in jd.items():
        assert not np.array_equal(np.asarray(v), weights[k]), k
        w0 = weights[k].astype(np.float64)
        err = _rel(tparams[k].detach().numpy() - w0, np.asarray(v) - w0)
        assert err <= UPDATE_RTOL, (k, err)
