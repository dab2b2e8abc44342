"""The port's nested sequences, hierarchical recurrent groups, sequence
surgery and beam cost against the JAX package, on the CPU.

- ``nested_to_padded`` / ``nested_from_padded`` and the feeder's
  sub-sequence slots (integer and dense) and dense sequence slot: tensor
  for tensor the JAX package's.
- The hierarchical groups of ``tests/test_recurrent_group.py`` (a pooled
  sentence Elman recurrence, a ``memory`` fc step, a nested sequence
  output, a sequence memory carrying the previous sentence), built in
  both packages from the JAX initializer's weights: outputs, lengths and
  the gradients of every parameter and of the input within 1e-5; a
  nested group trains 3 Adam steps through both feeders alike.
- ``seq_slice``, ``seq_concat``, ``seq_reshape``, ``kmax_seq_score``
  (with tied scores: the lower position first in both),
  ``sub_nested_seq`` and ``max_id``: equal outputs.
- ``cross_entropy_over_beam`` on the cases of
  ``tests/test_beam_cost_tagging.py`` (``tools/nested_workload.
  beam_cases``: gold in the beam, falling off at
  the first or a later expansion, mixed beam sizes, linked paths): costs
  within 1e-5 and gradients within 1e-5 relative, 1e-6 absolute (a
  gold candidate's gradient is a difference of probabilities that
  cancels to ~1e-8).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu import data_type as jdt
from paddle_tpu import event as jevent
from paddle_tpu import layer as jlayer
from paddle_tpu import optimizer as jopt
from paddle_tpu import pooling as jpooling
from paddle_tpu import topology as jtopo
from paddle_tpu import trainer as jtrainer
from paddle_tpu.attr import ParamAttr as JParamAttr
from paddle_tpu.ops import losses as jlosses
from paddle_tpu.ops import sequence_ops as jseq
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS
from paddle_tpu.sequence import SequenceBatch as JSB
from paddle_tpu.sequence import nested_from_padded as j_from
from paddle_tpu.sequence import nested_to_padded as j_to

import torch

from paddle_tpu_torch import convert
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import event as tevent
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import pooling as tpooling
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch import trainer as ttrainer
from paddle_tpu_torch.attr import ParamAttr as TParamAttr
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.ops import losses as tlosses
from paddle_tpu_torch.ops import sequence_ops as tseq
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.sequence import SequenceBatch as TSB
from paddle_tpu_torch.sequence import nested_from_padded as t_from
from paddle_tpu_torch.sequence import nested_to_padded as t_to
from paddle_tpu_torch.tools import nested_workload as nestw

TOL = 1e-5
JAX = (jlayer, jdt, jpooling, JParamAttr, jtopo)
PORT = (tlayer, tdt, tpooling, TParamAttr, ttopo)


@pytest.fixture(autouse=True)
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    yield
    JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _nested(seed, D=3):
    """Two documents: sentences [0:2], [2:5] and [5:7] (the JAX tests'
    layout), capacity 8 (one padding slot)."""
    toks = np.random.RandomState(seed).randn(8, D).astype(np.float32)
    seg = np.array([0, 0, 0, 0, 0, 1, 1, 2], np.int32)
    sub = np.array([0, 0, 1, 1, 1, 0, 0, 0], np.int32)
    lengths = np.array([5, 2], np.int32)
    j = JSB(jnp.asarray(toks), jnp.asarray(seg), jnp.asarray(lengths),
            sub_segment_ids=jnp.asarray(sub), max_len=5)
    t = TSB(torch.from_numpy(toks), torch.from_numpy(seg),
            torch.from_numpy(lengths), max_len=5,
            sub_segment_ids=torch.from_numpy(sub))
    return j, t


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _eq_sb(t, j, data_tol=None):
    if data_tol is None:
        _eq(t.data, j.data)
    else:
        np.testing.assert_allclose(t.data.detach().numpy(),
                                   np.asarray(j.data), rtol=data_tol,
                                   atol=data_tol)
    _eq(t.segment_ids, j.segment_ids)
    _eq(t.lengths, j.lengths)
    assert t.max_len == j.max_len
    assert (t.sub_segment_ids is None) == (j.sub_segment_ids is None)
    if t.sub_segment_ids is not None:
        _eq(t.sub_segment_ids, j.sub_segment_ids)


@pytest.mark.parametrize("S,W", [(3, 4), (2, 2), (1, 8)])
def test_nested_to_and_from_padded_match_jax(S, W):
    j, t = _nested(0)
    jv, tv = jax.jit(j_to, static_argnums=(1, 2))(j, S, W), t_to(t, S, W)
    for a, b in zip(tv, jv):
        _eq(a, b)
    j_from_jit = jax.jit(j_from, static_argnums=(3,))
    for cap in (8, 4, 64):
        _eq_sb(t_from(*tv, capacity=cap), j_from_jit(*jv, cap))


@pytest.mark.parametrize("kind", ["integer", "dense"])
def test_sub_sequence_slots_feed_as_jax(kind):
    rs = np.random.RandomState(1)
    if kind == "integer":
        def doc():
            return [rs.randint(0, 9, rs.randint(1, 5)).tolist()
                    for _ in range(rs.randint(1, 4))]
        jt, tt = jdt.integer_value_sub_sequence(9), \
            tdt.integer_value_sub_sequence(9)
    else:
        def doc():
            return [rs.randn(rs.randint(1, 5), 2).tolist()
                    for _ in range(rs.randint(1, 4))]
        jt, tt = jdt.dense_vector_sub_sequence(2), \
            tdt.dense_vector_sub_sequence(2)
    batch = [(doc(), int(rs.randint(2))) for _ in range(5)]
    j = jpaddle.DataFeeder([("x", jt), ("y", jdt.integer_value(2))])(batch)
    t = DataFeeder([("x", tt), ("y", tdt.integer_value(2))],
                   device="cpu")(batch)
    _eq_sb(t["x"], j["x"])
    _eq(t["y"], j["y"])


# ---------------------------------------------------------------------------
# hierarchical groups
# ---------------------------------------------------------------------------


def _pool_elman(P, D=3, H=3):
    L, dt, pooling, PA, _ = P
    x = L.data(name="x", type=dt.dense_vector_sub_sequence(D))

    def step(sentence):
        pooled = L.pooling(input=sentence, pooling_type=pooling.AvgPooling())
        m = L.memory(name="h_out", size=H)
        proj = L.fc(input=m, size=H, bias_attr=False,
                    param_attr=PA(name="nest_w"), name="h_proj")
        return L.addto(input=[pooled, proj], act="tanh", name="h_out")

    return L.recurrent_group(step=step, input=L.SubsequenceInput(
        x, max_inner=3, max_inner_len=4), name="rg_nest")


def _fc_memory(P, D=3, H=4, reverse=False):
    L, dt, _, _, _ = P
    x = L.data(name="x", type=dt.dense_vector_sub_sequence(D))

    def step(sentence):
        pooled = L.pooling(input=sentence)
        m = L.memory(name="h2", size=H)
        return L.fc(input=[pooled, m], size=H, act="tanh", name="h2")

    return L.recurrent_group(step=step, input=L.SubsequenceInput(
        x, max_inner=3, max_inner_len=4), reverse=reverse, name="rg_fc")


def _nested_output(P, D=3):
    L, dt, pooling, _, _ = P
    x = L.data(name="x", type=dt.dense_vector_sub_sequence(D))

    def step(sentence):
        m = L.memory(name="sent_pool", size=D)
        shifted = L.addto(input=[sentence, L.expand(m, sentence)],
                          name="tok_out")
        pooled = L.pooling(input=sentence,
                           pooling_type=pooling.AvgPooling(),
                           name="sent_pool")
        return [shifted, pooled]

    outs = L.recurrent_group(step=step, input=L.SubsequenceInput(
        x, max_inner=3, max_inner_len=4), name="rg_nest_seq")
    return L.fc(input=outs[0], size=2, name="tok_fc")


def _sequence_memory(P, D=3):
    L, dt, pooling, _, _ = P
    x = L.data(name="x", type=dt.dense_vector_sub_sequence(D))

    def step(sentence):
        prev = L.memory(name="raw_out", size=D, is_seq=True)
        prev_max = L.pooling(input=prev, pooling_type=pooling.MaxPooling())
        cur = L.pooling(input=sentence, pooling_type=pooling.AvgPooling())
        out = L.addto(input=[cur, prev_max], name="vec_out")
        raw = L.get_output(sentence, name="raw_out")
        return [out, raw]

    outs = L.recurrent_group(step=step, input=L.SubsequenceInput(
        x, max_inner=3, max_inner_len=4), name="rg_seqmem")
    return L.fc(input=outs[0], size=2, name="vec_fc")


GROUPS = {"pool_elman": _pool_elman, "fc_memory": _fc_memory,
          "fc_memory_reverse": lambda P: _fc_memory(P, reverse=True),
          "nested_output": _nested_output,
          "sequence_memory": _sequence_memory}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_hierarchical_group_matches_jax(name):
    """Outputs and the gradients of every parameter and of the tokens."""
    build = GROUPS[name]
    jtopo.reset_name_scope()
    jnode = build(JAX)
    ttopo.reset_name_scope()
    tnode = build(PORT)
    jt, tt = jtopo.Topology([jnode]), ttopo.Topology([tnode])
    assert set(jt.param_specs()) == set(tt.param_specs())
    arrays = {k: np.asarray(v) for k, v in
              JParameters.from_topology(jt, seed=4).as_dict().items()}
    jsb, tsb = _nested(2)
    jp = {k: jnp.asarray(v) for k, v in arrays.items()}

    def jout(p, data):
        return jt.forward(p, {}, {"x": jsb.with_data(data)})[0][0]

    jv = jax.jit(jout)(jp, jsb.data)
    wts = np.random.RandomState(9).randn(*jv.data.shape).astype(np.float32)
    wts = wts * np.asarray(jv.valid_mask, np.float32).reshape(
        (-1,) + (1,) * (wts.ndim - 1))
    jgp, jgx = jax.jit(jax.grad(lambda p, d: jnp.sum(jout(p, d).data * wts),
                                argnums=(0, 1)))(jp, jsb.data)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    x = tsb.data.clone().requires_grad_(True)
    tv = tt.forward(tp, {"x": tsb.with_data(x)})[0]
    _eq_sb(tv, jv, data_tol=TOL)
    (tv.data * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL)
    for k in arrays:
        got = tp[k].grad.numpy() if tp[k].grad is not None else 0 * arrays[k]
        np.testing.assert_allclose(got, np.asarray(jgp[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def _doc_batches(steps=3, n=6, D=4, seed=0):
    """Documents of 1-3 sentences of 2-4 tokens: every batch at capacity
    64 and max_len bucket 16."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        rows = []
        for _ in range(n):
            label = int(rs.randint(2))
            doc = [(rs.randn(rs.randint(2, 5), D) * 0.3 +
                    (0.8 if label else -0.8)).astype(np.float32).tolist()
                   for _ in range(rs.randint(1, 4))]
            rows.append((doc, label))
        out.append(rows)
    return out


def test_hierarchical_group_three_adam_steps_match_jax():
    D, H = 4, 6

    def build(P):
        L, dt, pooling, _, _ = P
        x = L.data(name="x", type=dt.dense_vector_sub_sequence(D))
        lab = L.data(name="label", type=dt.integer_value(2))

        def step(sentence):
            pooled = L.pooling(input=sentence,
                               pooling_type=pooling.AvgPooling())
            m = L.memory(name="hdoc", size=H)
            return L.fc(input=[pooled, m], size=H, act="tanh", name="hdoc")

        grp = L.recurrent_group(step=step, input=L.SubsequenceInput(
            x, max_inner=4, max_inner_len=6), name="rg_doc")
        logits = L.fc(input=L.last_seq(grp), size=2)
        return L.classification_cost(input=logits, label=lab)

    batches = _doc_batches(D=D)
    jtopo.reset_name_scope()
    jcost = build(JAX)
    jparams = JParameters.from_topology(jtopo.Topology([jcost]), seed=0)
    arrays = {k: np.array(v) for k, v in jparams.as_dict().items()}
    jsgd = jtrainer.SGD(cost=jcost, parameters=jparams,
                        update_equation=jopt.Adam(learning_rate=3e-2))
    jc = []
    jsgd.train(lambda: iter(batches), event_handler=lambda ev: jc.append(
        float(ev.cost)) if isinstance(ev, jevent.EndIteration) else None)
    ttopo.reset_name_scope()
    tcost = build(PORT)
    tparams = convert.parameters_from_numpy(arrays, device="cpu")
    tsgd = ttrainer.SGD(tcost, tparams, topt.Adam(learning_rate=3e-2),
                        device="cpu")
    tc = []
    tsgd.train(lambda: iter(batches), event_handler=lambda ev: tc.append(
        float(ev.cost)) if isinstance(ev, tevent.EndIteration) else None)
    assert len(tc) == 3 and np.isfinite(tc).all()
    np.testing.assert_allclose(tc, jc, rtol=TOL)
    for k, v in jsgd.parameters.as_dict().items():
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# sequence surgery
# ---------------------------------------------------------------------------


def _flat(seed, lens=(3, 5, 2), D=2, cap=12):
    rs = np.random.RandomState(seed)
    seqs = [rs.randn(n, D).astype(np.float32) for n in lens]
    return (JSB.from_list(seqs, capacity=cap),
            TSB.from_list(seqs, capacity=cap, device="cpu"))


def test_seq_slice_concat_reshape_match_jax():
    j, t = _flat(0)
    starts = np.array([1, 0, 3], np.int32)
    ends = np.array([3, 4, 5], np.int32)
    sj = jax.jit(jseq.seq_slice)(j, jnp.asarray(starts), jnp.asarray(ends))
    st = tseq.seq_slice(t, torch.from_numpy(starts), torch.from_numpy(ends))
    _eq_sb(st, sj)
    j2, t2 = _flat(1, lens=(1, 2, 4))
    _eq_sb(tseq.seq_concat(t, t2), jax.jit(jseq.seq_concat)(j, j2))
    _eq_sb(tseq.seq_reshape(t, 1),
           jax.jit(jseq.seq_reshape, static_argnums=(1,))(j, 1))
    # a sum pool over a sliced batch leaves the holes out, as JAX's
    np.testing.assert_allclose(tseq.seq_pool_sum(st).numpy(),
                               np.asarray(jax.jit(jseq.seq_pool_sum)(sj)),
                               rtol=1e-6)


def test_kmax_seq_score_breaks_ties_by_position_as_jax():
    scores = [np.array([0.5, 0.9, 0.5, 0.9], np.float32),
              np.array([0.1, 0.1, 0.1], np.float32),
              np.array([0.7], np.float32)]
    j = JSB.from_list(scores, capacity=10)
    t = TSB.from_list(scores, capacity=10, device="cpu")
    got = tseq.kmax_seq_score(t, 3).numpy()
    _eq(got, jseq.kmax_seq_score(j, 3))
    np.testing.assert_array_equal(got, [[1, 3, 0], [0, 1, 2], [0, -1, -1]])


def test_sub_nested_seq_and_max_id_match_jax():
    j, t = _nested(3)
    sel = np.array([[1, -1], [0, 5]], np.int32)
    _eq_sb(tseq.sub_nested_seq(t, torch.from_numpy(sel)),
           jseq.sub_nested_seq(j, jnp.asarray(sel)))
    x = np.array([[1.0, 3.0, 3.0], [2.0, 0.0, 2.0]], np.float32)
    _eq(tseq.max_id(torch.from_numpy(x)), jseq.max_id(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# cross_entropy_over_beam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["regimes", "mixed_sizes", "linked"])
def test_cross_entropy_over_beam_and_gradients_match_jax(case):
    beams = nestw.beam_cases()[case]
    w = np.arange(1.0, beams[0][0].shape[0] + 1, dtype=np.float32)

    def jcost(*scores):
        return jlosses.cross_entropy_over_beam(
            [(s,) + tuple(jnp.asarray(x) for x in b[1:])
             for s, b in zip(scores, beams)])

    jscores = [jnp.asarray(b[0]) for b in beams]
    want = np.asarray(jax.jit(jcost)(*jscores))
    jgrads = jax.jit(jax.grad(lambda *sc: jnp.sum(jcost(*sc) * w),
                              argnums=tuple(range(len(beams)))))(*jscores)
    ts = [torch.tensor(b[0], requires_grad=True) for b in beams]
    got = tlosses.cross_entropy_over_beam(
        [(s,) + tuple(torch.from_numpy(x) for x in b[1:])
         for s, b in zip(ts, beams)])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL)
    (got * torch.from_numpy(w)).sum().backward()
    for s, g in zip(ts, jgrads):
        np.testing.assert_allclose(s.grad.numpy(), np.asarray(g), rtol=TOL,
                                   atol=1e-6)


def test_beam_cost_layer_matches_jax():
    n_cand, k = 8, 3

    def build(P):
        L, dt, _, _, _ = P
        feat = L.data(name="feat", type=dt.dense_vector(16))
        sel = L.data(name="sel", type=dt.dense_vector(k))
        gold = L.data(name="gold", type=dt.integer_value(n_cand))
        scores = L.fc(input=feat, size=n_cand, name="scorer")
        return L.cross_entropy_over_beam(L.BeamInput(
            candidate_scores=scores, selected_candidates=sel, gold=gold))

    rs = np.random.RandomState(0)
    batch = [(rs.randn(16).astype(np.float32).tolist(),
              rs.choice(n_cand, size=k, replace=False).astype(
                  np.float32).tolist(), int(rs.randint(n_cand)))
             for _ in range(6)]
    jtopo.reset_name_scope()
    jc = build(JAX)
    ttopo.reset_name_scope()
    tc = build(PORT)
    jt, tt = jtopo.Topology([jc]), ttopo.Topology([tc])
    arrays = {k_: np.asarray(v) for k_, v in
              JParameters.from_topology(jt, seed=1).as_dict().items()}
    slots = [("feat", "dense_vector", 16), ("sel", "dense_vector", k),
             ("gold", "integer_value", n_cand)]
    jf = jpaddle.DataFeeder([(n, getattr(jdt, f)(d))
                             for n, f, d in slots])(batch)
    tf = DataFeeder([(n, getattr(tdt, f)(d)) for n, f, d in slots],
                    device="cpu")(batch)
    jv = jt.forward({k_: jnp.asarray(v) for k_, v in arrays.items()}, {},
                    jf)[0][0]
    tv = tt.forward(convert.parameters_from_numpy(
        arrays, device="cpu").as_dict(), tf)[0]
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=TOL)


@pytest.mark.parametrize("config", nestw.CONFIGS)
def test_nested_workload_trains_on_the_cpu(config):
    """The configurations ``chip_smoke.py`` holds card against CPU, at a
    narrow width through the sub-sequence slot: finite costs that fall."""
    from paddle_tpu_torch import event

    sgd = nestw.build_trainer(config, "cpu", width=8)
    docs = nestw.documents(width=8)
    costs = []
    sgd.train(nestw.repeat_reader(docs, 3), event_handler=lambda ev:
              costs.append(float(ev.cost))
              if isinstance(ev, event.EndIteration) else None)
    assert np.isfinite(costs).all() and costs[-1] < costs[0]


def test_seventh_slice_imports_neither_jax_nor_paddle_tpu():
    """The slice's modules pull in neither ``jax`` nor ``paddle_tpu``."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, paddle_tpu_torch.layer, paddle_tpu_torch.ops.crf,"
            " paddle_tpu_torch.models.srl,"
            " paddle_tpu_torch.models.sequence_tagging,"
            " paddle_tpu_torch.models.quick_start,"
            " paddle_tpu_torch.tools.srl_workload,"
            " paddle_tpu_torch.tools.quick_start_workload,"
            " paddle_tpu_torch.tools.nested_workload; "
            "print(sorted(m for m in sys.modules if m in ('jax', "
            "'paddle_tpu') or m.startswith(('jax.', 'paddle_tpu.'))))")
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(repo)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
