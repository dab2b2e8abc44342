"""The port's evaluators against the JAX package's, on the CPU.

Every case of ``tools/v2_loop_workload.EVALUATOR_CASES`` (the cases the
card runs too) is built in both packages from the same samples through
each package's ``DataFeeder``: dense and packed inputs, forced ties for
``auc``, ``rankauc``, ``pnpair`` and the top-5 error, ``chunk`` in IOB
(integer and dense predictions) and plain, ``ctc_edit_distance`` over
decodes and labels of 1-12 and 1-7 tokens, and the printers, whose
output must read the same.  Values within 1e-6 relative (f32; counts and
ranks are exact); each package's trainer reduces the output to the same
metric.  The breadth gate: every name in the port's ``evaluator.__all__``
has a case, and that list is JAX's (``detection_map`` included since the
tenth slice: the ``voc_detection_map`` case, scores tied on 4 levels).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import evaluator as jevaluator
from paddle_tpu import trainer as jtrainer
from paddle_tpu.data_feeder import DataFeeder as JFeeder
from paddle_tpu.sequence import SequenceBatch as JSeq

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import evaluator as tevaluator
from paddle_tpu_torch.ops import losses as tlosses
from paddle_tpu_torch.tools import v2_loop_workload as vw

from paddle_tpu.ops import losses as jlosses

RTOL, ATOL = 1e-6, 1e-7


def _jax_evaluate(name):
    jpaddle.topology.reset_name_scope()
    node, samples = vw.EVALUATOR_CASES[name](jpaddle, name)
    topo = jpaddle.topology.Topology([node])
    feeder = JFeeder([(n.name, n.input_type) for n in topo.data_nodes])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        value = topo.forward({}, topo.init_state(), feeder.feed(samples),
                             train=False)[0][0]
        metric = float(jtrainer._metric_scalar(value))
        jax.effects_barrier()
    if isinstance(value, JSeq):
        value = np.asarray(value.data)[np.asarray(value.valid_mask)]
    return np.asarray(value), metric, out.getvalue()


@pytest.mark.parametrize("name", sorted(vw.EVALUATOR_CASES))
def test_evaluator_case_matches_jax(name):
    want, want_metric, want_text = _jax_evaluate(name)
    got, metric, text = vw.evaluate(name, "cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(metric, want_metric, rtol=RTOL, atol=ATOL)
    assert text == want_text
    if "printer" in name:
        assert text.startswith(name)


def test_every_public_evaluator_has_a_case():
    """The breadth gate: JAX's evaluators, each exercised by a case."""
    assert set(tevaluator.__all__) == set(jevaluator.__all__)
    assert set(vw.CASE_EVALUATOR) == set(vw.EVALUATOR_CASES)
    # gradient_printer prints in the backward: its own test below
    assert set(vw.CASE_EVALUATOR.values()) | {"gradient_printer"} == \
        set(tevaluator.__all__)
    for name in tevaluator.__all__:
        assert callable(getattr(tevaluator, name))


def test_detection_map_names_its_slice():
    """``detection_map`` came with the tenth slice (A9's second half,
    with ``ops/detection.py``): it builds a metric node over a
    ``detection_output``-shaped layer and a gt layer."""
    from paddle_tpu_torch import data_type, layer
    det = layer.data(name="det", type=data_type.dense_vector(6))
    gt = layer.data(name="gt", type=data_type.dense_vector(5))
    node = tevaluator.detection_map(det, gt, num_classes=2, keep_top_k=1,
                                    max_boxes=1)
    assert node.is_metric and node.inputs == [det, gt]


def _grad_graph(pkg):
    pkg.topology.reset_name_scope()
    x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(3))
    h = pkg.layer.fc(input=x, size=3, name="h", bias_attr=False)
    probe = pkg.evaluator.gradient_printer(input=h, name="probe")
    return pkg.layer.fc(input=probe, size=2, name="out",
                        bias_attr=False), probe


def test_gradient_printer_prints_the_gradient_as_jax_does(capfd):
    rng = np.random.RandomState(0)
    w = {"h.w0": rng.randn(3, 3).astype(np.float32),
         "out.w0": (np.arange(6, dtype=np.float32).reshape(3, 2) / 4)}
    x = np.array([[1.0, -2.0, 0.5], [0.0, 3.0, -1.0]], np.float32)
    out, probe = _grad_graph(jpaddle)
    assert probe.is_metric and probe.size == 3
    topo = jpaddle.topology.Topology([out])

    def loss(p):
        return jnp.sum(topo.forward(p, {}, {"x": jnp.asarray(x)})[0][0])

    jax.grad(loss)({k: jnp.asarray(v) for k, v in w.items()})
    jax.effects_barrier()
    want = capfd.readouterr().out
    out, probe = _grad_graph(tpaddle)
    topo = tpaddle.topology.Topology([out])
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    torch.sum(topo.forward(p, {"x": torch.from_numpy(x)})[0]).backward()
    got = capfd.readouterr().out
    assert got == want
    assert got.startswith("probe grad: [[0.25 1.25 2.25]")


@pytest.mark.parametrize("k", [1, 3, 5])
def test_classification_error_op_breaks_ties_as_top_k(k):
    rng = np.random.RandomState(k)
    x = (rng.randint(0, 2, (64, 8)) * 1.0).astype(np.float32)
    y = rng.randint(0, 8, 64).astype(np.int32)
    want = np.asarray(jlosses.classification_error(jnp.asarray(x),
                                                   jnp.asarray(y), k))
    got = tlosses.classification_error(torch.from_numpy(x),
                                       torch.from_numpy(y), k).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lengths", [[1], [3, 1, 4], [12, 12], [2, 9, 5, 7]])
def test_ctc_edit_distance_at_several_lengths(lengths):
    """Decodes against labels of other lengths, against a plain
    Levenshtein on the host."""
    rng = np.random.RandomState(len(lengths))
    classes = 4
    samples = [(list(rng.rand(n, classes).astype(np.float32)),
                rng.randint(0, classes - 1, int(rng.randint(1, 8))).tolist())
               for n in lengths]

    def collapse(probs):
        path = np.argmax(np.stack(probs), -1)
        out, prev = [], -1
        for t in path:
            if t != prev and t != classes - 1:
                out.append(int(t))
            prev = t
        return out

    def lev(a, b):
        d = np.arange(len(a) + 1, dtype=float)
        for j, r in enumerate(b):
            new = np.empty_like(d)
            new[0] = j + 1
            for i in range(len(a)):
                new[i + 1] = min(d[i] + (a[i] != r), d[i + 1] + 1,
                                 new[i] + 1)
            d = new
        return d[len(a)]

    want = np.mean([lev(collapse(p), lab) / max(len(lab), 1)
                    for p, lab in samples])
    for pkg, feeder_kw in ((jpaddle, {}), (tpaddle, {"device": "cpu"})):
        pkg.topology.reset_name_scope()
        x = pkg.layer.data(name="x",
                           type=pkg.data_type.dense_vector_sequence(classes))
        y = pkg.layer.data(name="y",
                           type=pkg.data_type.integer_value_sequence(3))
        node = pkg.evaluator.ctc_edit_distance(input=x, label=y)
        topo = pkg.topology.Topology([node])
        feeds = pkg.DataFeeder([("x", x.input_type), ("y", y.input_type)],
                               **feeder_kw).feed(samples)
        if pkg is jpaddle:
            got = topo.forward({}, {}, feeds)[0][0]
        else:
            got = topo.forward({}, feeds)[0]
        np.testing.assert_allclose(np.asarray(got)[0], want, rtol=1e-6)


def test_metric_outputs_never_enter_the_cost():
    """The trainer's gradient is the cost's alone: a run with the metric
    nodes gives the same parameters as one without."""
    results = []
    for extra in (False, True):
        tpaddle.topology.reset_name_scope()
        L, dt = tpaddle.layer, tpaddle.data_type
        x = L.data(name="x", type=dt.dense_vector(4))
        y = L.data(name="y", type=dt.integer_value(3))
        logits = L.fc(input=x, size=3, name="fc")
        cost = L.classification_cost(input=logits, label=y)
        nodes = [tevaluator.classification_error(input=logits, label=y),
                 tevaluator.sum(input=logits)] if extra else None
        params = tpaddle.Parameters.from_topology(
            tpaddle.topology.Topology([cost]), seed=1, device="cpu")
        sgd = tpaddle.trainer.SGD(cost, params, tpaddle.optimizer.Sgd(
            learning_rate=0.1), extra_layers=nodes, device="cpu")
        rng = np.random.RandomState(0)
        data = [(rng.randn(4).astype(np.float32), int(rng.randint(3)))
                for _ in range(16)]
        sgd.train(tpaddle.batch(lambda: iter(data), 8), num_passes=1)
        results.append({k: v.detach().clone()
                        for k, v in params.as_dict().items()})
    for k in results[0]:
        assert torch.equal(results[0][k], results[1][k])
