"""The port's CTR slice against the JAX package, on the CPU:
``layer.slope_intercept``, ``multi_binary_label_cross_entropy_cost``,
DeepFM (``models/deepfm``) and the traffic forecaster
(``models/traffic_prediction``).

The same numpy inputs and weights go through both packages: the JAX
``Parameters.from_topology`` weights cross by name through
``convert.parameters_from_numpy``, and the same sample batches go through
both ``trainer.SGD.train`` loops with Adam (f32: ``use_bf16`` off in
both).

Tolerances (f32): costs within 1e-5 relative, every parameter after the
steps within 1e-4 relative in norm.

At Criteo's field count and tower (39 fields, 400-400-400, V 512) the two
packages part after the second step: one of the 12,800 pre-activations of
the tower's first layer lies at 1.0e-9 (median 0.04), a ReLU tie that f32
rounding decides.  The port's gradient of that layer agrees with its own
float64 gradient to 6.2e-8 and the JAX package's f32 one is 1.5e-2 from it
(measured), so one element of the first Adam moments differs, and the
third cost parts by 4.1e-4, the first layer's weights by 3.6e-2 in norm.
That case is held in f32 for its first two costs and then with both
packages in float64 (``tests/torch_float64.py``), where the tie has one
answer, at the same bounds.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import data_type as jdt
from paddle_tpu import event as jevent
from paddle_tpu import layer as jlayer
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import traffic_prediction as jtraffic
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

import torch

from paddle_tpu_torch import convert
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import minibatch as tminibatch
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import traffic_prediction as ttraffic
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

from torch_float64 import jax_in_float64, port_in_float64

COST_RTOL = 1e-5
PARAM_RTOL = 1e-4


@contextlib.contextmanager
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _forward_both(build, feeds):
    """Build the graph in both packages with ``build(layer_module,
    data_type_module)`` -> output node; forward the numpy ``feeds``."""
    jtopo.reset_name_scope()
    jout = build(jlayer, jdt)
    ttopo.reset_name_scope()
    tout = build(tlayer, tdt)
    jt, tt = jtopo.Topology([jout]), ttopo.Topology([tout])
    jparams = {k: np.asarray(v) for k, v in
               JParameters.from_topology(jt, seed=0).as_dict().items()}
    tparams = convert.parameters_from_numpy(jparams, device="cpu")
    jv, _ = jt.forward(jparams, {}, {k: jnp.asarray(v)
                                      for k, v in feeds.items()})
    tv = tt.forward(tparams.as_dict(),
                    {k: torch.from_numpy(v) for k, v in feeds.items()})
    return np.asarray(jv[0]), tv[0].numpy()


def test_slope_intercept_matches_jax():
    x = np.random.RandomState(0).randn(6, 5).astype(np.float32)

    def build(L, dt):
        inp = L.data(name="x", type=dt.dense_vector(5))
        return L.slope_intercept(inp, slope=-1.5, intercept=0.25)

    want, got = _forward_both(build, {"x": x})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, -1.5 * x + 0.25, rtol=1e-6)


def test_multi_binary_label_xent_matches_jax_on_multi_label_rows():
    rs = np.random.RandomState(1)
    logits = (rs.randn(8, 3) * 30).astype(np.float32)   # |x| large: stable
    labels = (rs.rand(8, 3) > 0.5).astype(np.float32)

    def build(L, dt):
        lg = L.data(name="lg", type=dt.dense_vector(3))
        lb = L.data(name="lb", type=dt.dense_vector(3))
        return L.multi_binary_label_cross_entropy_cost(input=lg, label=lb)

    want, got = _forward_both(build, {"lg": logits, "lb": labels})
    assert got.shape == (8,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=COST_RTOL, atol=1e-6)


def test_multi_binary_label_xent_reshapes_an_integer_label():
    """An integer [B] label against [B, 1] logits is reshaped, not
    broadcast to [B, B]."""
    rs = np.random.RandomState(2)
    logits = rs.randn(7, 1).astype(np.float32)
    labels = rs.randint(0, 2, (7,)).astype(np.int32)

    def build(L, dt):
        lg = L.data(name="lg", type=dt.dense_vector(1))
        lb = L.data(name="lb", type=dt.integer_value(2))
        return L.multi_binary_label_cross_entropy_cost(input=lg, label=lb)

    want, got = _forward_both(build, {"lg": logits, "lb": labels})
    assert got.shape == (7,)
    x, y = logits[:, 0].astype(np.float64), labels.astype(np.float64)
    np.testing.assert_allclose(got, np.logaddexp(0, x) - x * y, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)


def _train(sgd, event_mod, reader):
    costs = []
    sgd.train(reader, num_passes=1, event_handler=lambda ev:
              costs.append(float(ev.cost))
              if isinstance(ev, event_mod.EndIteration) else None)
    return np.asarray(costs)


def _train_both(build, data, batch, lr=1e-2, float64=False):
    """3 Adam steps (one per batch of ``data``) in both packages from the
    JAX initializer's weights, in f32 or with both packages in float64;
    returns (jax costs, port costs, jax params, port params)."""
    wide = ((jax_in_float64(), port_in_float64()) if float64 else
            (contextlib.nullcontext(), contextlib.nullcontext()))
    with f32_policy(), wide[0], wide[1]:
        jtopo.reset_name_scope()
        jcost = build(jdeepfm, jtraffic)
        jparams = JParameters.from_topology(jtopo.Topology(jcost), seed=0)
        dtype = np.float64 if float64 else np.float32
        for k in list(jparams.keys()):
            jparams[k] = np.asarray(jparams[k], dtype)
        arrays = {k: np.array(v) for k, v in jparams.as_dict().items()}
        jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                            update_equation=jopt.Adam(learning_rate=lr))
        jcosts = _train(jsgd, jevent,
                        jpaddle.batch(lambda: iter(data), batch))
        ttopo.reset_name_scope()
        tcost = build(tdeepfm, ttraffic)
        tparams = convert.parameters_from_numpy(arrays, device="cpu")
        tsgd = ttrainer.SGD(tcost, tparams, topt.Adam(learning_rate=lr),
                            device="cpu")
        tcosts = _train(tsgd, tevent,
                        tminibatch.batch(lambda: iter(data), batch))
    return jcosts, tcosts, jsgd.parameters, tparams


def _assert_params_match(jparams, tparams):
    jd = jparams.as_dict()
    assert set(jd) == set(tparams.keys())
    for k, v in jd.items():
        err = _rel(tparams[k].detach().numpy(), np.asarray(v))
        assert err <= PARAM_RTOL, (k, err)


def _ctr_data(fields, vocab, n, seed):
    """Rows (id_0, ..., id_{F-1}, click): clicks follow low field-0 ids."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (n, fields))
    return [tuple(int(x) for x in row) + (int(row[0] < vocab // 2),)
            for row in ids]


def _deepfm(fields, vocab, factor, deep):
    def build(deepfm, _traffic):
        return [deepfm.build(num_fields=fields, vocab_size=vocab,
                             factor_dim=factor, deep_layers=deep)[3]]
    return build


def test_deepfm_three_adam_steps_match_jax():
    fields, vocab, factor, batch, steps = 4, 64, 4, 32, 3
    data = _ctr_data(fields, vocab, batch * steps, seed=fields)
    jcosts, tcosts, jp, tp = _train_both(
        _deepfm(fields, vocab, factor, (16,)), data, batch)
    assert len(tcosts) == steps and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=COST_RTOL)
    _assert_params_match(jp, tp)
    # the shared tables are one parameter each
    assert tp["deepfm.w1"].shape == (vocab, 1)
    assert tp["deepfm.v"].shape == (vocab, factor)


def test_deepfm_criteo_width_three_adam_steps_match_jax():
    """39 fields, k 10, the 400-400-400 tower, V 512: the f32 runs' first
    two costs, then the 3 steps with both packages in float64 (see the
    module docstring)."""
    fields, vocab, factor, batch, steps = 39, 512, 10, 32, 3
    data = _ctr_data(fields, vocab, batch * steps, seed=fields)
    build = _deepfm(fields, vocab, factor, (400, 400, 400))
    jcosts, tcosts, _, _ = _train_both(build, data, batch)
    np.testing.assert_allclose(tcosts[:2], jcosts[:2], rtol=COST_RTOL)
    jcosts, tcosts, jp, tp = _train_both(build, data, batch, float64=True)
    assert len(tcosts) == steps and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=COST_RTOL)
    _assert_params_match(jp, tp)


def test_traffic_prediction_four_horizons_match_jax():
    batch, steps, horizons, term = 16, 3, 4, 24
    rs = np.random.RandomState(3)
    data = [(rs.randn(term).astype(np.float32),) +
            tuple(int(x) for x in rs.randint(0, 4, horizons))
            for _ in range(batch * steps)]

    def build(_deepfm, traffic):
        return traffic.build(term_num=term, forecasting_num=horizons)[3]

    jcosts, tcosts, jp, tp = _train_both(build, data, batch)
    assert len(tcosts) == steps and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=COST_RTOL)
    _assert_params_match(jp, tp)
    # every head's first projection weight is the one shared parameter
    assert not any(k.startswith("link_vec_") and k.endswith(".w0")
                   for k in tp.keys())
    assert tp["_link_vec.w"].shape == (term, 16)
