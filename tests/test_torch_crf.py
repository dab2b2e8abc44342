"""The port's linear-chain CRF and the two CRF taggers against the JAX
package, on the CPU.

- ``ops/crf.crf_forward`` / ``crf_viterbi`` against the JAX package's
  ``_crf_forward`` / ``_crf_viterbi`` on random emissions, lengths 1..T
  with masked tails: costs and gradients within 1e-5 relative (1e-6
  absolute), paths equal; Viterbi against a brute-force enumeration of
  every tag path, and on a forced tie (equal emissions, equal
  transitions), where the first maximum decides in both packages.
- ``layer.crf`` / ``layer.crf_decoding`` with a ``ParamAttr`` name: the
  prefixed parameters are one set, read by both layers.
- ``models/sequence_tagging`` (the CoNLL-2000 chunker's model at a small
  width) and ``models/srl`` (depth 3, so layers 1 reverse) trained 3
  Adam steps in both packages from the JAX initializer's weights (f32
  policy): costs within 1e-5 relative, every parameter within 1e-4
  relative in norm, and the decoded paths of the trained weights equal.
  Every batch packs to one capacity and one ``max_len`` bucket, so the
  JAX step compiles once.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import attr as jattr
from paddle_tpu import data_type as jdt
from paddle_tpu import event as jevent
from paddle_tpu import layer as jlayer
from paddle_tpu import optimizer as jopt
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.models import sequence_tagging as jtagging
from paddle_tpu.models import srl as jsrl
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS

import torch

from paddle_tpu_torch import attr as tattr
from paddle_tpu_torch import convert
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.models import sequence_tagging as ttagging
from paddle_tpu_torch.models import srl as tsrl
from paddle_tpu_torch.ops import crf as tcrf
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.tools import srl_workload as sw

RTOL = 1e-5
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


def _crf_inputs(seed, B=5, T=7, K=6):
    rs = np.random.RandomState(seed)
    em = rs.randn(B, T, K).astype(np.float32)
    tr = rs.randn(K, K).astype(np.float32)
    start = rs.randn(K).astype(np.float32)
    stop = rs.randn(K).astype(np.float32)
    lengths = np.array([T, 1, 3, T - 1, 2][:B])
    mask = np.arange(T)[None, :] < lengths[:, None]
    labels = rs.randint(0, K, (B, T)).astype(np.int32)
    return em, mask, tr, start, stop, labels


def test_crf_forward_and_gradients_match_jax():
    em, mask, tr, start, stop, labels = _crf_inputs(0)

    def jloss(e, t, s0, s1):
        return jnp.sum(jlayer._crf_forward(e, jnp.asarray(mask), t, s0, s1,
                                           jnp.asarray(labels)) *
                       jnp.arange(1.0, 6.0))

    want = np.asarray(jax.jit(jlayer._crf_forward)(
        *(jnp.asarray(x) for x in (em, mask, tr, start, stop, labels))))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(x) for x in (em, tr, start, stop)))
    ts = [torch.tensor(x, requires_grad=True) for x in (em, tr, start, stop)]
    got = tcrf.crf_forward(ts[0], torch.from_numpy(mask), ts[1], ts[2],
                           ts[3], torch.from_numpy(labels))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=1e-6)
    (got * torch.arange(1.0, 6.0)).sum().backward()
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=1e-6)
    # a masked tail's emissions take no gradient
    assert not ts[0].grad[1, 1:].any()


def _brute_force(em, mask, tr, start, stop, b):
    length = int(mask[b].sum())
    best, best_s = None, -np.inf
    for path in itertools.product(range(em.shape[2]), repeat=length):
        s = start[path[0]] + em[b, 0, path[0]]
        for t in range(1, length):
            s += tr[path[t - 1], path[t]] + em[b, t, path[t]]
        s += stop[path[-1]]
        if s > best_s:
            best, best_s = path, s
    return best


def test_viterbi_matches_jax_and_brute_force():
    em, mask, tr, start, stop, _ = _crf_inputs(1, B=4, T=5, K=4)
    want = np.asarray(jax.jit(jlayer._crf_viterbi)(
        *(jnp.asarray(x) for x in (em, mask, tr, start, stop))))
    got = tcrf.crf_viterbi(*(torch.from_numpy(x) for x in
                             (em, mask, tr, start, stop))).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for b in range(4):
        length = int(mask[b].sum())
        assert tuple(got[b, :length]) == \
            _brute_force(em, mask, tr, start, stop, b), b


@pytest.mark.parametrize("T", [1, 6])
def test_viterbi_tie_takes_the_first_maximum_as_jax(T):
    """Equal emissions and transitions make every path tie: both packages
    take the first maximum at every argmax (all zeros), and a length-1
    batch runs no loop step."""
    B, K = 3, 5
    em = np.ones((B, T, K), np.float32)
    tr = np.full((K, K), 0.5, np.float32)
    start = np.zeros(K, np.float32)
    stop = np.zeros(K, np.float32)
    mask = np.arange(T)[None, :] < np.array([T, max(1, T - 2), 1])[:, None]
    want = np.asarray(jax.jit(jlayer._crf_viterbi)(
        *(jnp.asarray(x) for x in (em, mask, tr, start, stop))))
    got = tcrf.crf_viterbi(*(torch.from_numpy(x) for x in
                             (em, mask, tr, start, stop))).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.any()
    # a partial tie: two best emissions per frame, the lower id wins
    em2 = np.zeros((B, T, K), np.float32)
    em2[..., 2] = em2[..., 4] = 1.0
    want2 = np.asarray(jax.jit(jlayer._crf_viterbi)(
        *(jnp.asarray(x) for x in (em2, mask, tr, start, stop))))
    got2 = tcrf.crf_viterbi(*(torch.from_numpy(x) for x in
                              (em2, mask, tr, start, stop))).numpy()
    np.testing.assert_array_equal(got2, want2)
    assert (got2 == 2).all()


def _seq_feed(L, dt, K):
    word = L.data(name="em", type=dt.dense_vector_sequence(K))
    label = L.data(name="label", type=dt.integer_value_sequence(K))
    return word, label


def test_crf_layers_share_prefixed_parameters_and_match_jax():
    K = 4
    rs = np.random.RandomState(2)
    batch = [(rs.randn(n, K).astype(np.float32).tolist(),
              rs.randint(0, K, n).tolist()) for n in (5, 1, 3)]

    def build(L, dt, attr_mod):
        em, label = _seq_feed(L, dt, K)
        shared = attr_mod.ParamAttr(name="tag")
        cost = L.crf(input=em, label=label, size=K, param_attr=shared)
        dec = L.crf_decoding(input=em, size=K, param_attr=shared)
        err = L.crf_decoding(input=em, size=K, label=label,
                             param_attr=shared)
        return cost, dec, err

    with f32_policy():
        jtopo.reset_name_scope()
        jnodes = build(jlayer, jdt, jattr)
        ttopo.reset_name_scope()
        tnodes = build(tlayer, tdt, tattr)
        jt, tt = jtopo.Topology(list(jnodes)), ttopo.Topology(list(tnodes))
        assert set(tt.param_specs()) == set(jt.param_specs()) == {
            "tag.transitions", "tag.start", "tag.stop"}
        jparams = {k: np.asarray(v) for k, v in
                   JParameters.from_topology(jt, seed=3).as_dict().items()}
        tparams = convert.parameters_from_numpy(jparams, device="cpu")
        jfeeds = jpaddle.DataFeeder([("em", jdt.dense_vector_sequence(K)),
                                     ("label",
                                      jdt.integer_value_sequence(K))])(batch)
        from paddle_tpu_torch.data_feeder import DataFeeder
        tfeeds = DataFeeder([("em", tdt.dense_vector_sequence(K)),
                             ("label", tdt.integer_value_sequence(K))],
                            device="cpu")(batch)
        jv, _ = jax.jit(lambda p, f: jt.forward(p, {}, f))(
            {k: jnp.asarray(v) for k, v in jparams.items()}, jfeeds)
        tv = tt.forward(tparams.as_dict(), tfeeds)
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv[0]), rtol=RTOL)
    for j, t in zip(jv[1:], tv[1:]):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.segment_ids.numpy(),
                                      np.asarray(j.segment_ids))
    assert tv[1].data.dtype == torch.int32
    assert tv[2].data.dtype == torch.float32


# ---------------------------------------------------------------------------
# the taggers, 3 Adam steps
# ---------------------------------------------------------------------------


def _train(sgd, event_mod, reader, feeding=None):
    costs = []
    sgd.train(reader, num_passes=1, feeding=feeding,
              event_handler=lambda ev: costs.append(float(ev.cost))
              if isinstance(ev, event_mod.EndIteration) else None)
    return np.asarray(costs)


def _train_both(build, batches, lr):
    """3 Adam steps in both packages from the JAX initializer's weights;
    ``build(model_module)`` -> (cost, decoded).  Returns the costs, the
    trained parameters and each package's decoded paths of the batches
    (data, segment ids) on the trained weights."""
    with f32_policy():
        jtopo.reset_name_scope()
        jcost, jdec = build(jsrl, jtagging)
        jparams = JParameters.from_topology(jtopo.Topology([jcost]), seed=0)
        arrays = {k: np.array(v) for k, v in jparams.as_dict().items()}
        jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                            update_equation=jopt.Adam(learning_rate=lr))
        jcosts = _train(jsgd, jevent, lambda: iter(batches))
        ttopo.reset_name_scope()
        tcost, tdec = build(tsrl, ttagging)
        tparams = convert.parameters_from_numpy(arrays, device="cpu")
        tsgd = ttrainer.SGD(tcost, tparams, topt.Adam(learning_rate=lr),
                            device="cpu")
        tcosts = _train(tsgd, tevent, lambda: iter(batches))
        jtop, ttop = jtopo.Topology([jdec]), ttopo.Topology([tdec])
        jfeeds = jsgd._make_feeder(None).feed(batches[0])
        tfeeds = tsgd._make_feeder(None).feed(batches[0])
        jout, _ = jax.jit(jtop.forward)(
            jsgd.parameters.as_dict(), jsgd.model_state,
            {n.name: jfeeds[n.name] for n in jtop.data_nodes})
        tout = ttop.forward(tsgd.parameters.as_dict(),
                            {n.name: tfeeds[n.name]
                             for n in ttop.data_nodes},
                            state=tsgd.model_state)
        paths = [(np.asarray(sb.data), np.asarray(sb.segment_ids))
                 for sb in (jout[0], tout[0])]
    return jcosts, tcosts, jsgd.parameters, tparams, paths


def _assert_trained_alike(jcosts, tcosts, jp, tp, paths, steps=3):
    assert len(tcosts) == steps and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=RTOL)
    jd = jp.as_dict()
    assert set(jd) == set(tp.keys())
    for k, v in jd.items():
        err = _rel(tp[k].detach().numpy(), np.asarray(v))
        assert err <= PARAM_RTOL, (k, err)
    (jpath, jseg), (tpath, tseg) = paths
    np.testing.assert_array_equal(tseg, jseg)
    np.testing.assert_array_equal(tpath, jpath)


def _chunk_batches(vocab, n_tags, steps=3, batch=6, seed=0):
    """Token sequences of 5-10 tokens, six to a batch (capacity 64,
    max_len bucket 16 throughout), tags a function of the tokens."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        rows = []
        for n in rs.randint(5, 11, batch):
            toks = rs.randint(0, vocab, n)
            rows.append((toks.tolist(), ((toks * 7 + 3) % n_tags).tolist()))
        out.append(rows)
    return out


def test_sequence_tagging_three_adam_steps_match_jax():
    vocab, n_tags = 120, 23

    def build(_srl, tagging):
        _, _, cost, dec = tagging.build(vocab_size=vocab, num_tags=n_tags,
                                        emb_dim=16, hidden=32)
        return cost, dec

    out = _train_both(build, _chunk_batches(vocab, n_tags), lr=1e-2)
    _assert_trained_alike(*out)
    assert "crf_tag.transitions" in out[3].keys()


def test_srl_depth_three_three_adam_steps_match_jax():
    """SRL at depth 3 (layer 1 reverse), widths cut (word 32, hidden
    16): the shared embedding and CRF parameters train as one each."""
    dims = dict(word_dict_len=300, label_dict_len=9, pred_dict_len=20)
    rs = np.random.RandomState(4)
    batches = [[sw.sample(rs, lo=4, hi=10, **dims) for _ in range(5)]
               for _ in range(3)]

    def build(srl, _tagging):
        _, cost, dec = srl.build(word_dim=8, mark_dim=3, hidden_dim=16,
                                 depth=3, **dims)
        return cost, dec

    out = _train_both(build, batches, lr=1e-2)
    _assert_trained_alike(*out)
    tp = out[3]
    assert "word_emb.w" in tp.keys() and "srl_crf.stop" in tp.keys()
    assert not any(k.startswith("embedding") and k.endswith(".w") and
                   tp[k].shape[0] == dims["word_dict_len"]
                   for k in tp.keys())
