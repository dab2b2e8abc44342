"""The port's ``mixed`` layer with every projection and operator, and
``networks.sequence_conv_pool``, against the JAX package, on the CPU.

Each case builds one ``mixed`` node in both packages, gives both the JAX
initializer's weights and the same seeded numpy feeds, and compares the
output and the gradients of a weighted sum of it with respect to every
parameter: within 1e-6 (absolute and relative).  ``context_projection``
runs at starts -2, 0 and +1, with and without ``padding_attr``: the
``pad`` parameter it then declares is read by neither package, so its
gradient is zero in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import data_type as jdt
from paddle_tpu import layer as jlayer
from paddle_tpu import networks as jnetworks
from paddle_tpu import topology as jtopo
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

import torch

from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import networks as tnetworks
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.sequence import SequenceBatch

TOL = 1e-6
D = 6


@pytest.fixture(autouse=True)
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    yield
    JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _value(v):
    return v.data if hasattr(v, "data") and not isinstance(
        v, (np.ndarray, torch.Tensor)) else v


def _both(build, slots, batch, seed=0):
    """Forward ``build(L, dt, networks) -> node`` in both packages on the
    fed ``batch``; returns (jax out, port out, jax grads, port grads) of
    ``sum(out * w)`` with w a fixed random weighting."""
    jtopo.reset_name_scope()
    jnode = build(jlayer, jdt, jnetworks)
    ttopo.reset_name_scope()
    tnode = build(tlayer, tdt, tnetworks)
    jt, tt = jtopo.Topology([jnode]), ttopo.Topology([tnode])
    assert set(jt.param_specs()) == set(tt.param_specs())
    arrays = {k: np.asarray(v) for k, v in
              JParameters.from_topology(jt, seed=seed).as_dict().items()}
    jfeeds = jpaddle.DataFeeder([(n, getattr(jdt, f)(d))
                                 for n, f, d in slots])(batch)
    tfeeds = DataFeeder([(n, getattr(tdt, f)(d)) for n, f, d in slots],
                        device="cpu")(batch)

    def jout(p):
        return _value(jt.forward(p, {}, jfeeds)[0][0])

    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = np.asarray(jax.jit(jout)(jp))
    wts = np.random.RandomState(7).randn(*want.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jout(p) * wts)))(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    got = _value(tt.forward(tp, tfeeds)[0])
    loss = (got * torch.from_numpy(wts)).sum()
    if loss.requires_grad:          # identity projections have no weight
        loss.backward()
    tgrads = {k: (t.grad.numpy() if t.grad is not None else
                  np.zeros_like(arrays[k])) for k, t in tp.items()}
    return want, got.detach().numpy(), jgrads, tgrads


def _check(want, got, jgrads, tgrads):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert set(jgrads) == set(tgrads)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], np.asarray(jgrads[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def _dense_batch(n=4, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.randn(D).astype(np.float32).tolist(),
             rs.randn(D).astype(np.float32).tolist(),
             int(rs.randint(0, 11))) for _ in range(n)]


DENSE_SLOTS = [("x", "dense_vector", D), ("y", "dense_vector", D),
               ("ids", "integer_value", 11)]


@pytest.mark.parametrize("kind", ["full", "trans_full", "identity",
                                  "identity_offset", "slice", "dotmul",
                                  "scaling", "table", "dotmul_operator",
                                  "all_with_bias"])
def test_projection_and_operator_match_jax(kind):
    def build(L, dt, _nets):
        x = L.data(name="x", type=dt.dense_vector(D))
        y = L.data(name="y", type=dt.dense_vector(D))
        ids = L.data(name="ids", type=dt.integer_value(11))
        comps = {
            "full": [L.full_matrix_projection(x, size=5)],
            "trans_full": [L.trans_full_matrix_projection(x, size=5)],
            "identity": [L.identity_projection(x), y],
            "identity_offset": [L.identity_projection(x, offset=2, size=3)],
            "slice": [L.slice_projection(x, [(0, 2), (3, 6)])],
            "dotmul": [L.dotmul_projection(x)],
            "scaling": [L.scaling_projection(y)],
            "table": [L.table_projection(ids, size=D)],
            "dotmul_operator": [L.dotmul_operator(x, y, scale=0.5)],
            "all_with_bias": [L.full_matrix_projection(x, size=D),
                              L.trans_full_matrix_projection(y, size=D),
                              L.dotmul_operator(x, y, scale=2.0),
                              L.dotmul_projection(y),
                              L.scaling_projection(x),
                              L.table_projection(ids, size=D)],
        }[kind]
        return L.mixed(input=comps, act="tanh",
                       bias_attr=kind == "all_with_bias")

    _check(*_both(build, DENSE_SLOTS, _dense_batch()))


def test_conv_operator_matches_jax():
    """Each sample's image convolved with the filter a layer computes for
    it (flat CHW rows in)."""
    c, h, k, nf = 2, 5, 3, 4

    def build(L, dt, _nets):
        img = L.data(name="img", type=dt.dense_vector(c * h * h))
        z = L.data(name="z", type=dt.dense_vector(3))
        filt = L.fc(input=z, size=k * k * c * nf, name="filter_fc")
        return L.mixed(input=[L.conv_operator(img, filt, filter_size=k,
                                              num_filters=nf,
                                              num_channels=c, padding=1)],
                       size=h * h * nf)

    rs = np.random.RandomState(3)
    batch = [(rs.randn(c * h * h).astype(np.float32).tolist(),
              rs.randn(3).astype(np.float32).tolist()) for _ in range(3)]
    slots = [("img", "dense_vector", c * h * h), ("z", "dense_vector", 3)]
    _check(*_both(build, slots, batch))


SEQ_SLOTS = [("w", "integer_value_sequence", 30)]


def _seq_batch(lens=(5, 1, 3, 7), seed=2):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 30, n).tolist(),) for n in lens]


@pytest.mark.parametrize("start", [-2, 0, 1])
@pytest.mark.parametrize("padding", [False, True])
def test_context_projection_matches_jax(start, padding):
    def build(L, dt, _nets):
        w = L.data(name="w", type=dt.integer_value_sequence(30))
        emb = L.embedding(input=w, size=4, name="emb")
        proj = L.context_projection(emb, context_len=3, context_start=start,
                                    padding_attr=padding)
        return L.mixed(size=12, input=[proj])

    want, got, jgrads, tgrads = _both(build, SEQ_SLOTS, _seq_batch())
    _check(want, got, jgrads, tgrads)
    pads = [k for k in tgrads if k.endswith("_pad")]
    assert bool(pads) == padding
    for k in pads:
        assert not tgrads[k].any() and not np.asarray(jgrads[k]).any()


def test_sequence_conv_pool_matches_jax():
    def build(L, dt, nets):
        w = L.data(name="w", type=dt.integer_value_sequence(30))
        emb = L.embedding(input=w, size=4)
        return nets.sequence_conv_pool(emb, context_len=3, hidden_size=8)

    _check(*_both(build, SEQ_SLOTS, _seq_batch()))


def test_dense_sequence_slot_feeds_as_jax():
    """A ``dense_vector_sequence`` slot: the same capacity, ids, lengths,
    max_len bucket and rows as the JAX feeder."""
    rs = np.random.RandomState(5)
    batch = [(rs.randn(n, 3).astype(np.float32).tolist(),) for n in (4, 9, 2)]
    j = jpaddle.DataFeeder([("v", jdt.dense_vector_sequence(3))])(batch)["v"]
    t = DataFeeder([("v", tdt.dense_vector_sequence(3))],
                   device="cpu")(batch)["v"]
    assert isinstance(t, SequenceBatch) and t.max_len == j.max_len
    for a in ("data", "segment_ids", "lengths"):
        np.testing.assert_array_equal(getattr(t, a).numpy(),
                                      np.asarray(getattr(j, a)))
