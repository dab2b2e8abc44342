"""The v2 training loop around the model, the port against the JAX
package on the CPU: ``batch(reader.shuffle(dataset...))`` into
``SGD(extra_layers=[evaluator...])``, ``train(test_reader=)``, ``test``,
``infer``; the narrow IMDB classifier under Adam + L2 + ModelAverage
with classification_error and auc; ``ExtraAttr.error_clipping_threshold``;
the nine activations the slice adds; ``init``; the parameter-statistics
log lines.

Weights cross through the tar format; one ``random.seed`` gives both
packages' ``reader.shuffle`` the same order, and the datasets are their
synthetic fallbacks (``common.download`` refuses in both packages, so no
test reaches the network).  Tolerances: costs, metrics and parameters
within 1e-5 relative (f32, the two frameworks sum in other orders), a
cost also within 1e-6 absolute: the synthetic digits are learned within
a pass, and a cost near 0 is the difference of two O(1) f32 terms
(logsumexp less the picked logit), resolved to a few 1e-7 (measured:
6e-8 apart at costs of 5e-6); metrics that count examples
(classification errors) are equal.
"""

import io
import logging
import random
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu import activation as jact
from paddle_tpu import attr as jattr
from paddle_tpu.dataset import common as jcommon
from paddle_tpu.platform.flags import FLAGS as JFLAGS

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import activation as tact
from paddle_tpu_torch import attr as tattr
from paddle_tpu_torch import initializer as tinit
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.platform import device as tdevice
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

RTOL = 1e-5
COST_ATOL = 1e-6


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """Both packages' datasets take their synthetic fallbacks."""
    def refuse(*args, **kwargs):
        raise IOError("offline: the tests never download")

    for common in (jcommon, tcommon):
        monkeypatch.setattr(common, "download", refuse)
        monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))


@pytest.fixture
def f32():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _mlp(pkg):
    pkg.topology.reset_name_scope()
    layer, dt = pkg.layer, pkg.data_type
    images = layer.data(name="pixel", type=dt.dense_vector(784))
    label = layer.data(name="label", type=dt.integer_value(10))
    hidden = layer.fc(input=images, size=64, act="relu", name="hidden")
    logits = layer.fc(input=hidden, size=10, name="logits")
    cost = layer.classification_cost(input=logits, label=label, name="cost")
    err = pkg.evaluator.classification_error(input=logits, label=label,
                                             name="err")
    top3 = pkg.evaluator.classification_error(input=logits, label=label,
                                              top_k=3, name="top3")
    return logits, cost, [err, top3]


def _jax_tar(topo) -> bytes:
    buf = io.BytesIO()
    jpaddle.Parameters.from_topology(topo, seed=7).to_tar(buf)
    return buf.getvalue()


def _mnist_run(pkg, tar, **dev):
    logits, cost, extra = _mlp(pkg)
    params = pkg.Parameters.from_tar(io.BytesIO(tar), **dev)
    sgd = pkg.trainer.SGD(cost=cost, parameters=params,
                          update_equation=pkg.optimizer.Momentum(
                              momentum=0.9, learning_rate=0.05),
                          extra_layers=extra, **dev)
    train_reader = pkg.batch(pkg.reader.shuffle(pkg.reader.firstn(
        pkg.dataset.mnist.train(), 1280), buf_size=512), 64)
    test_reader = pkg.batch(pkg.reader.firstn(pkg.dataset.mnist.test(),
                                              256), 64)
    seen = {"costs": [], "iter_metrics": [], "end_pass": []}

    def handler(ev):
        if isinstance(ev, pkg.event.EndIteration):
            seen["costs"].append(ev.cost)
            seen["iter_metrics"].append(dict(ev.metrics))
        elif isinstance(ev, pkg.event.EndPass):
            seen["end_pass"].append(dict(ev.metrics))

    random.seed(11)
    sgd.train(train_reader, num_passes=1, event_handler=handler)
    random.seed(12)
    sgd.train(train_reader, num_passes=1, event_handler=handler,
              test_reader=test_reader)
    result = sgd.test(test_reader)
    rng = np.random.RandomState(3)
    probe = [(rng.randn(784).astype(np.float32),) for _ in range(4)]
    out = pkg.infer(output_layer=logits, parameters=params, input=probe,
                    **dev)
    return seen, result, np.asarray(out), sgd


def test_mnist_loop_matches_jax(f32):
    """Per-step costs and metrics, EndPass (the pass's means, then with a
    test_reader the test's), TestResult and infer, same weights."""
    _, jcost, jextra = _mlp(jpaddle)
    tar = _jax_tar(jpaddle.topology.Topology([jcost] + jextra))
    jseen, jres, jout, _ = _mnist_run(jpaddle, tar)
    tseen, tres, tout, tsgd = _mnist_run(tpaddle, tar, device="cpu")
    assert len(tseen["costs"]) == len(jseen["costs"]) == 40
    np.testing.assert_allclose(tseen["costs"], jseen["costs"], rtol=RTOL,
                               atol=COST_ATOL)
    assert tseen["iter_metrics"] == jseen["iter_metrics"]
    assert len(tseen["end_pass"]) == 2
    for t, j in zip(tseen["end_pass"], jseen["end_pass"]):
        assert t.keys() == j.keys() == {"err", "top3"}
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL)
    # EndPass under test_reader carries the test's metrics
    assert tseen["end_pass"][1] == pytest.approx(tres.metrics, rel=RTOL)
    np.testing.assert_allclose(tres.cost, jres.cost, rtol=RTOL,
                               atol=COST_ATOL)
    assert tres.metrics.keys() == {"err", "top3"}
    for k in jres.metrics:
        np.testing.assert_allclose(tres.metrics[k], jres.metrics[k],
                                   rtol=RTOL)
    assert tres.metrics["err"] < 0.5
    np.testing.assert_allclose(tout, jout, rtol=RTOL, atol=1e-5)
    buf = io.BytesIO()
    tsgd.save_parameter_to_tar(buf)
    again = tpaddle.Parameters.from_tar(io.BytesIO(buf.getvalue()),
                                        device="cpu")
    for name in tsgd.parameters.names():
        assert torch.equal(again[name], tsgd.parameters[name])


# ---------------------------------------------------------------------------
# narrow IMDB classifier: Adam + L2 + ModelAverage, error and auc
# ---------------------------------------------------------------------------

DICT, EMB, HIDDEN = 512, 16, 32


def _sentiment(pkg):
    pkg.topology.reset_name_scope()
    layer = pkg.layer
    words = layer.data(name="words",
                       type=pkg.data_type.integer_value_sequence(DICT))
    label = layer.data(name="label", type=pkg.data_type.integer_value(2))
    net = layer.embedding(input=words, size=EMB, name="emb")
    for i in range(2):
        net = pkg.networks.simple_lstm(input=net, size=HIDDEN,
                                       name=f"lstm{i}")
    pooled = layer.pooling(input=net, name="pool",
                           pooling_type=pkg.pooling.MaxPooling())
    logits = layer.fc(input=pooled, size=2, name="logits")
    cost = layer.classification_cost(input=logits, label=label, name="cost")
    probs = layer.mixed(input=[layer.identity_projection(logits)],
                        act=pkg.activation.SoftmaxActivation(), name="probs")
    extra = [pkg.evaluator.classification_error(input=logits, label=label,
                                                name="error"),
             pkg.evaluator.auc(input=probs, label=label, name="auc")]
    return cost, extra


def _seq_batches(n_batches=3, bs=8):
    """Batches of ``bs`` sequences of 17-30 tokens: one feeder capacity
    (256) and one max_len bucket (32), so JAX compiles its step once."""
    rng = np.random.RandomState(4)
    return [[(rng.randint(0, DICT, size=int(rng.randint(17, 31))).tolist(),
              int(rng.randint(2))) for _ in range(bs)]
            for _ in range(n_batches)]


def _sentiment_run(pkg, tar, batches, **dev):
    cost, extra = _sentiment(pkg)
    params = pkg.Parameters.from_tar(io.BytesIO(tar), **dev)
    opt = pkg.optimizer.Adam(
        learning_rate=2e-3,
        regularization=pkg.optimizer.L2Regularization(8e-4),
        model_average=pkg.optimizer.ModelAverage(average_window=0.5))
    sgd = pkg.trainer.SGD(cost=cost, parameters=params, update_equation=opt,
                          extra_layers=extra, **dev)
    costs, metrics = [], []

    def handler(ev):
        if isinstance(ev, pkg.event.EndIteration):
            costs.append(ev.cost)
            metrics.append(dict(ev.metrics))

    sgd.train(lambda: iter(batches), num_passes=1, event_handler=handler,
              feeding={"words": 0, "label": 1})
    return costs, metrics, sgd


def test_narrow_sentiment_adam_l2_model_average_matches_jax(f32):
    jcost, jextra = _sentiment(jpaddle)
    tar = _jax_tar(jpaddle.topology.Topology([jcost] + jextra))
    batches = _seq_batches()
    jc, jm, jsgd = _sentiment_run(jpaddle, tar, batches)
    tc, tm, tsgd = _sentiment_run(tpaddle, tar, batches, device="cpu")
    np.testing.assert_allclose(tc, jc, rtol=RTOL)
    for t, j in zip(tm, jm):
        assert t["error"] == j["error"]
        np.testing.assert_allclose(t["auc"], j["auc"], rtol=RTOL)
        assert 0.0 <= t["auc"] <= 1.0
    javg = jsgd.opt_state["avg"]
    for name in tsgd.parameters.names():
        want = np.asarray(jsgd.parameters[name])
        np.testing.assert_allclose(tsgd.parameters.get(name), want,
                                   rtol=RTOL, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(tsgd.opt_state["avg"][name].numpy(),
                                   np.asarray(javg[name]), rtol=RTOL,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# error clipping, activations, initializers
# ---------------------------------------------------------------------------

def _clip_graph(pkg, attr_mod, threshold):
    pkg.topology.reset_name_scope()
    layer = pkg.layer
    x = layer.data(name="x", type=pkg.data_type.dense_vector(6))
    y = layer.data(name="y", type=pkg.data_type.integer_value(3))
    h = layer.fc(input=x, size=5, act="tanh", name="h",
                 layer_attr=attr_mod.ExtraAttr(
                     error_clipping_threshold=threshold))
    logits = layer.fc(input=h, size=3, name="out")
    return layer.classification_cost(input=logits, label=y, name="cost")


def _port_grads(tar, x, y, threshold):
    cost = _clip_graph(tpaddle, tattr, threshold)
    topo = tpaddle.topology.Topology([cost])
    params = tpaddle.Parameters.from_tar(io.BytesIO(tar), device="cpu")
    p = {k: params[k].requires_grad_(True) for k in params.names()}
    out = topo.forward(p, {"x": torch.from_numpy(x),
                           "y": torch.from_numpy(y)}, train=True)[0]
    names = sorted(p)
    return dict(zip(names, torch.autograd.grad(out.mean(),
                                               [p[k] for k in names])))


@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_error_clipping_gradients_match_jax(threshold, f32):
    jcost = _clip_graph(jpaddle, jattr, threshold)
    jtopo = jpaddle.topology.Topology([jcost])
    tar = _jax_tar(jtopo)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32) * 3
    y = np.array([0, 2, 1, 2], np.int32)
    jparams = jpaddle.Parameters.from_tar(io.BytesIO(tar)).as_dict()

    def jloss(p):
        outs, _ = jtopo.forward(p, jtopo.init_state(),
                                {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                                train=True, rng=jax.random.PRNGKey(0))
        return jnp.mean(outs[0])

    jg = jax.jit(jax.grad(jloss))(jparams)
    tg = _port_grads(tar, x, y, threshold)
    for k in tg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    if threshold:
        # the clip binds: the first layer's gradient is not the free one
        free = _port_grads(tar, x, y, 0.0)
        assert not torch.allclose(free["h.w0"], tg["h.w0"])


ACTS = ["stanh", "brelu", "softrelu", "abs", "square", "exponential",
        "reciprocal", "sqrt", "log"]
# every bound the clipped forms have, and both sides of each
EDGES = np.array([-41., -40., -39.5, -3., -1., -0.5, 0., 0.5, 1., 3., 23.5,
                  24., 24.5, 39.5, 40., 41.], np.float32)
POSITIVE = np.array([0.01, 0.1, 0.5, 1., 2., 3., 10., 24., 40.], np.float32)


@pytest.mark.parametrize("name", ACTS)
def test_activation_and_gradient_match_jax(name):
    x = POSITIVE if name in ("reciprocal", "sqrt", "log") else EDGES
    if name == "exponential":
        x = np.clip(x, -10.0, 10.0)
    w = np.linspace(0.5, 1.5, x.size).astype(np.float32)
    jf = jact.get(name).fn
    tf = tact.get(name).fn
    jval, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(jf(v) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    tval = torch.sum(tf(xt) * torch.from_numpy(w))
    tgrad, = torch.autograd.grad(tval, xt)
    np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-30)
    assert type(tact.get(name)).__name__ == type(jact.get(name)).__name__


def test_uniform_and_fan_in_normal_initializers():
    g = torch.Generator().manual_seed(0)
    u = tinit.Uniform(-0.25, 0.75)(g, (200, 300))
    assert u.shape == (200, 300) and u.dtype == torch.float32
    assert float(u.min()) >= -0.25 and float(u.max()) < 0.75
    assert abs(float(u.mean()) - 0.25) < 0.01
    n = tinit.FanInNormal()(g, (400, 250), dtype=torch.bfloat16)
    assert n.dtype == torch.bfloat16
    assert abs(float(n.float().std()) - 1.0 / 20.0) < 0.002


# ---------------------------------------------------------------------------
# init, flags, logging
# ---------------------------------------------------------------------------

def test_init_sets_flags_and_finds_the_host():
    old = TFLAGS.log_period
    try:
        tpaddle.init(device="cpu", log_period=7)
        assert TFLAGS.log_period == 7
        assert tdevice.device_count() == 1
        assert tdevice.devices() == [torch.device("cpu")]
        assert tdevice.platform_name() == "cpu"
    finally:
        TFLAGS.log_period = old


@pytest.mark.parametrize("kw, match", [
    ({"mesh_shape": "2"}, "A12"), ({"mesh_axes": "data"}, "A12"),
    ({"coordinator_address": "localhost:1"}, "A12"),
    ({"num_processes": 2}, "A12"), ({"platform": "cpu"}, "no meaning"),
    ({"check_nan": True}, "no meaning"), ({"no_such_flag": 1}, "unknown")])
def test_init_refuses_what_the_port_cannot_do(kw, match):
    with pytest.raises(Exception, match=match):
        tpaddle.init(device="cpu", **kw)


def test_init_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="CUDA is not available"):
        tpaddle.init()


def _stats_lines(pkg, logger_name, caplog, tar):
    cost = _clip_graph(pkg, jattr if pkg is jpaddle else tattr, 0.0)
    dev = {} if pkg is jpaddle else {"device": "cpu"}
    params = pkg.Parameters.from_tar(io.BytesIO(tar), **dev)
    sgd = pkg.trainer.SGD(cost=cost, parameters=params,
                          update_equation=pkg.optimizer.Sgd(
                              learning_rate=0.1), **dev)
    rng = np.random.RandomState(2)
    data = [(rng.randn(6).astype(np.float32), int(rng.randint(3)))
            for _ in range(32)]
    log = logging.getLogger(logger_name)
    log.addHandler(caplog.handler)
    try:
        sgd.train(pkg.batch(lambda: iter(data), 8), num_passes=1)
    finally:
        log.removeHandler(caplog.handler)
    return [r.getMessage() for r in caplog.records
            if r.name == logger_name and "avgAbsGrad" in r.getMessage()]


def test_param_stats_log_lines_match_jax(caplog, f32):
    tar = _jax_tar(jpaddle.topology.Topology([_clip_graph(jpaddle, jattr,
                                                          0.0)]))
    old = (JFLAGS.show_parameter_stats_period,
           TFLAGS.show_parameter_stats_period)
    JFLAGS.show_parameter_stats_period = 2
    TFLAGS.show_parameter_stats_period = 2
    caplog.set_level(logging.INFO)
    try:
        jl = _stats_lines(jpaddle, "paddle_tpu", caplog, tar)
        caplog.clear()
        tl = _stats_lines(tpaddle, "paddle_tpu_torch", caplog, tar)
    finally:
        (JFLAGS.show_parameter_stats_period,
         TFLAGS.show_parameter_stats_period) = old
    # 4 batches, every 2nd logs one line per parameter (4 parameters)
    assert len(tl) == len(jl) == 8
    pat = re.compile(r"Param (\S+) avgAbsGrad=(\S+) maxAbsGrad=(\S+)")
    for t, j in zip(tl, jl):
        mt, mj = pat.match(t), pat.match(j)
        assert mt.group(1) == mj.group(1)
        np.testing.assert_allclose(
            [float(mt.group(2)), float(mt.group(3))],
            [float(mj.group(2)), float(mj.group(3))], rtol=RTOL)


def test_log_period_lines_report_cost_and_metrics(caplog):
    _, cost, extra = _mlp(tpaddle)
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([cost]), seed=1, device="cpu")
    sgd = tpaddle.trainer.SGD(cost, params, tpaddle.optimizer.Sgd(
        learning_rate=0.01), extra_layers=extra, device="cpu")
    old = TFLAGS.log_period
    TFLAGS.log_period = 2
    log = logging.getLogger("paddle_tpu_torch")
    log.addHandler(caplog.handler)
    caplog.set_level(logging.INFO)
    try:
        sgd.train(tpaddle.batch(tpaddle.reader.firstn(
            tpaddle.dataset.mnist.train(), 256), 64), num_passes=1)
    finally:
        TFLAGS.log_period = old
        log.removeHandler(caplog.handler)
    lines = [r.getMessage() for r in caplog.records if "Batch" in
             r.getMessage()]
    assert len(lines) == 2
    assert re.match(r"Pass 0, Batch 1, Cost [0-9.]+ err=[0-9.]+ "
                    r"top3=[0-9.]+", lines[0])


@pytest.mark.parametrize("kw", [{"save_dir": "x"}, {"resume": True},
                                {"master": object()}, {"keep": 2}])
def test_train_refuses_the_later_slices_arguments(kw):
    _, cost, _ = _mlp(tpaddle)
    params = tpaddle.Parameters.from_topology(
        tpaddle.topology.Topology([cost]), device="cpu")
    sgd = tpaddle.trainer.SGD(cost, params, tpaddle.optimizer.Sgd(),
                              device="cpu")
    with pytest.raises(Exception, match="A1[13]"):
        sgd.train(lambda: iter([]), **kw)
