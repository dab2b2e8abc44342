"""The port's recurrent group surface against the JAX package, on the CPU.

Each test builds one graph in both packages through their own layer
functions (same layer names, so the same parameter keys), carries the
JAX ``Parameters.from_topology`` weights into the port as numpy, feeds
both the same numpy values and compares.  The JAX groups run under
``lax.scan`` (fused GRU/LSTM steps in Pallas interpret mode); the port's
as a Python loop over frames.

Tolerances: f32 (``use_bf16`` off in both) forward values at 1e-5
relative and absolute: the two sum the same products in other orders.
Gradients at 1e-4 relative (1e-6 absolute near zero): a backward through
a few frames of tanh and sigmoid compounds those rounding differences.
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import activation as jact
from paddle_tpu import data_type as jdt
from paddle_tpu import layer as jlayer
from paddle_tpu import networks as jnet
from paddle_tpu import pooling as jpool
from paddle_tpu import topology as jtopo
from paddle_tpu.attr import ParamAttr as JAttr
from paddle_tpu.ops import sequence_ops as jseq
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS
from paddle_tpu.sequence import SequenceBatch as JSB

from paddle_tpu_torch import activation as tact
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import networks as tnet
from paddle_tpu_torch import pooling as tpool
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch.attr import ParamAttr as TAttr
from paddle_tpu_torch.convert import parameters_from_numpy
from paddle_tpu_torch.inference import Inference
from paddle_tpu_torch.ops import sequence_ops as tseq
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.sequence import SequenceBatch as TSB

J = types.SimpleNamespace(layer=jlayer, dt=jdt, Attr=JAttr, net=jnet,
                          act=jact, pool=jpool, topo=jtopo, SB=JSB)
T = types.SimpleNamespace(layer=tlayer, dt=tdt, Attr=TAttr, net=tnet,
                          act=tact, pool=tpool, topo=ttopo, SB=TSB)
RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@contextlib.contextmanager
def policy(use_bf16: bool):
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = use_bf16
    try:
        yield
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old


@pytest.fixture(autouse=True)
def f32():
    with policy(False):
        yield


class Seq:
    """A numpy sequence feed: float rows [len, dim] per sequence."""

    def __init__(self, dim, lens, seed, capacity=16, max_len=None):
        rng = np.random.RandomState(seed)
        self.rows = [(rng.randn(n, dim) * 0.5).astype(np.float32)
                     for n in lens]
        self.capacity = capacity
        self.max_len = max_len or max(lens)   # a feeder's bucket, if given

    def jax(self):
        return dataclasses.replace(
            JSB.from_list(self.rows, capacity=self.capacity),
            max_len=self.max_len)

    def port(self):
        return dataclasses.replace(
            TSB.from_list(self.rows, capacity=self.capacity, device="cpu"),
            max_len=self.max_len)


def _feeds(feeds, pkg):
    out = {}
    for k, v in feeds.items():
        if isinstance(v, Seq):
            out[k] = v.jax() if pkg is J else v.port()
        else:
            out[k] = jnp.asarray(v) if pkg is J else torch.from_numpy(v)
    return out


def _np(v):
    if isinstance(v, (JSB, TSB)):
        return _np(v.data)
    if isinstance(v, torch.Tensor):
        return v.detach().numpy()
    return np.asarray(v)


def _build(build, pkg, seed=0):
    pkg.topo.reset_name_scope()
    outs = build(pkg)
    return pkg.topo.Topology(outs if isinstance(outs, list) else [outs])


def _pair(build, seed=0):
    """(JAX topology, JAX params, port topology, port params)."""
    jt = _build(build, J)
    jp = JParameters.from_topology(jt, seed=seed)
    tt = _build(build, T)
    assert set(jt.param_specs()) == set(tt.param_specs())
    tp = parameters_from_numpy(
        {k: np.asarray(v) for k, v in jp.as_dict().items()}, device="cpu")
    return jt, jp, tt, tp


def run_both(build, feeds, seed=0, train=False):
    """Both packages' output values (and new states) on the same feeds."""
    jt, jp, tt, tp = _pair(build, seed)
    jouts, jstate = jt.forward(jp.as_dict(), jt.init_state(),
                               _feeds(feeds, J), train=train,
                               rng=jax.random.PRNGKey(0))
    touts, tstate = tt.forward_with_state(
        tp.as_dict(), tt.init_state("cpu"), _feeds(feeds, T), train=train)
    return jouts, touts, jstate, tstate


def assert_close(j, t, rtol=RTOL, atol=ATOL):
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert_close(a, b, rtol, atol)
        return
    if isinstance(j, JSB):
        np.testing.assert_array_equal(np.asarray(j.lengths), _np(t.lengths))
        np.testing.assert_array_equal(np.asarray(j.segment_ids),
                                      _np(t.segment_ids))
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# sequence ops and the sequence softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [(3, 5), (1, 4, 2), (6,)])
def test_sequence_ops_match_jax(lens):
    s = Seq(4, lens, seed=len(lens))
    scores = Seq(1, lens, seed=7)
    dense = np.random.RandomState(3).randn(len(lens), 4).astype(np.float32)
    for op in ("seq_first", "seq_last"):
        assert_close(getattr(jseq, op)(s.jax()),
                     getattr(tseq, op)(s.port()))
    assert_close(jseq.sequence_softmax(scores.jax()),
                 tseq.sequence_softmax(scores.port()))
    flat = Seq(1, lens, seed=8)
    flat.rows = [r[:, 0] for r in flat.rows]       # [capacity] scores
    assert_close(jseq.sequence_softmax(flat.jax()),
                 tseq.sequence_softmax(flat.port()))
    assert_close(jseq.seq_expand(jnp.asarray(dense), s.jax()),
                 tseq.seq_expand(torch.from_numpy(dense), s.port()))
    assert_close(jseq.seq_expand(s.jax(), s.jax()),
                 tseq.seq_expand(s.port(), s.port()))


def test_sequence_softmax_sums_to_one_per_sequence_and_has_jax_grad():
    s = Seq(1, (3, 5, 2), seed=2)

    def jloss(x):
        out = jseq.sequence_softmax(s.jax().with_data(x)).data[:, 0]
        return jnp.sum(out * jnp.arange(out.shape[0], dtype=jnp.float32))

    x = np.asarray(s.jax().data)
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    sb = s.port().with_data(xt)
    out = tseq.sequence_softmax(sb)
    sums = tseq.seq_pool_sum(out)
    np.testing.assert_allclose(sums.detach().numpy()[:, 0], 1.0, rtol=1e-6)
    (out.data[:, 0] * torch.arange(out.data.shape[0])).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# recurrent_group
# ---------------------------------------------------------------------------

H = 6


def _elman(pkg, reverse=False):
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(H))
    ref = pkg.layer.recurrent(input=x, size=H, act="tanh", bias_attr=False,
                              param_attr=pkg.Attr(name="shared_w"),
                              reverse=reverse, name="ref_rnn")

    def step(frame):
        m = pkg.layer.memory(name="h_out", size=H)
        proj = pkg.layer.fc(input=m, size=H, bias_attr=False,
                            param_attr=pkg.Attr(name="shared_w"),
                            name="h_proj")
        return pkg.layer.addto(input=[frame, proj], act="tanh", name="h_out")

    grp = pkg.layer.recurrent_group(step=step, input=x, reverse=reverse,
                                    name="rg")
    return [ref, grp]


@pytest.mark.parametrize("reverse", [False, True])
def test_elman_layer_and_its_group_match_jax(reverse):
    """The Elman layer and a group of the same step: each against JAX,
    and the two against each other (weights shared by name)."""
    jouts, touts, _, _ = run_both(lambda pkg: _elman(pkg, reverse),
                                  {"x": Seq(H, [3, 5], seed=1)}, seed=11)
    assert_close(jouts, touts)
    ref, grp = touts
    np.testing.assert_allclose(_np(ref)[:8], _np(grp)[:8], rtol=RTOL,
                               atol=ATOL)


def _gru_group(pkg):
    h = 4
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(3 * h))
    ref = pkg.layer.grumemory(input=x, size=h, name="ref_gru",
                              param_attr=pkg.Attr(name="gru_w"),
                              bias_attr=False)

    def step(frame):
        m = pkg.layer.memory(name="h", size=h)
        return pkg.layer.gru_step(input=frame, output_mem=m, size=h,
                                  param_attr=pkg.Attr(name="gru_w"),
                                  bias_attr=False, name="h")

    return [ref, pkg.layer.recurrent_group(step=step, input=x,
                                           name="rg_gru")]


def test_gru_step_group_matches_grumemory_and_jax():
    jouts, touts, _, _ = run_both(_gru_group,
                                  {"x": Seq(12, [2, 4], seed=5)}, seed=3)
    assert_close(jouts, touts)
    np.testing.assert_allclose(_np(touts[0])[:6], _np(touts[1])[:6],
                               rtol=RTOL, atol=ATOL)


def _static_boot(pkg):
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(4))
    ctx_in = pkg.layer.data(name="ctx", type=pkg.dt.dense_vector(4))

    def step(frame, static_ctx):
        m = pkg.layer.memory(name="acc", size=4, boot_layer=ctx_in)
        s = pkg.layer.fc(input=[frame, m], size=4, act="tanh",
                         name="acc_pre")
        return pkg.layer.addto(input=[s, static_ctx], name="acc")

    return pkg.layer.recurrent_group(
        step=step, input=[x, pkg.layer.StaticInput(ctx_in)],
        name="rg_static")


def test_group_with_static_and_boot_inputs_matches_jax():
    ctx = np.random.RandomState(4).randn(2, 4).astype(np.float32)
    jouts, touts, _, _ = run_both(
        _static_boot, {"x": Seq(4, [2, 3], seed=2), "ctx": ctx})
    assert_close(jouts, touts)
    # the recurrence: fixed ones in, boot 10, acc = (x + m) + ctx
    ones = Seq(4, [2, 3], seed=0)
    ones.rows = [np.ones_like(r) for r in ones.rows]

    def plain(pkg):
        x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(4))
        c = pkg.layer.data(name="ctx", type=pkg.dt.dense_vector(4))

        def step(frame, static_ctx):
            m = pkg.layer.memory(name="acc", size=4, boot_layer=c)
            s = pkg.layer.addto(input=[frame, m], name="acc_pre")
            return pkg.layer.addto(input=[s, static_ctx], name="acc")

        return pkg.layer.recurrent_group(
            step=step, input=[x, pkg.layer.StaticInput(c)], name="rg_plain")

    _, touts, _, _ = run_both(plain, {"x": ones, "ctx": np.full(
        (2, 4), 10.0, np.float32)})
    got = touts[0].to_padded()[0].numpy()[..., 0]
    np.testing.assert_allclose(got[0, :2], [21.0, 32.0])
    np.testing.assert_allclose(got[1, :3], [21.0, 32.0, 43.0])


def _unequal(pkg):
    a = pkg.layer.data(name="ua", type=pkg.dt.dense_vector_sequence(3))
    b = pkg.layer.data(name="ub", type=pkg.dt.dense_vector_sequence(3))

    def step(fa, fb):
        m = pkg.layer.memory(name="u_add", size=3)
        return pkg.layer.addto(input=[fa, fb, m], act="tanh", name="u_add")

    return pkg.layer.recurrent_group(step=step, input=[a, b], name="u_grp")


def test_unequal_inlink_lengths_and_the_masks_and():
    jouts, touts, _, _ = run_both(_unequal, {"ua": Seq(3, [5, 2], seed=4),
                                             "ub": Seq(3, [3, 5], seed=5)})
    assert_close(jouts, touts)
    res = touts[0]
    assert res.lengths.tolist() == [3, 2]
    padded = res.to_padded()[0].numpy()
    assert np.all(padded[0, 3:] == 0) and np.all(padded[1, 2:] == 0)


def _reverse_boot(pkg):
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(4))
    boot = pkg.layer.data(name="b", type=pkg.dt.dense_vector(4))

    def step(frame):
        m = pkg.layer.memory(name="r_h", size=4, boot_layer=boot)
        return pkg.layer.fc(input=[frame, m], size=4, act="tanh", name="r_h")

    return pkg.layer.recurrent_group(step=step, input=x, reverse=True,
                                     name="rg_rev")


def test_reverse_group_starts_at_the_padded_end():
    """Short rows see dead frames first and keep their boot value until
    their last real token, as the JAX reverse scan does; with the feeder's
    bucket of 8 frames the scan starts 3 frames past the longest row."""
    boot = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    for max_len in (None, 8):
        jouts, touts, _, _ = run_both(
            _reverse_boot, {"x": Seq(4, [2, 5, 1], seed=6, max_len=max_len),
                            "b": boot})
        assert_close(jouts, touts)


def _multi(pkg):
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(4))

    def step(frame):
        m = pkg.layer.memory(name="mo_h", size=4)
        h = pkg.layer.fc(input=[frame, m], size=4, act="tanh", name="mo_h")
        y = pkg.layer.fc(input=h, size=2, act="softmax", name="mo_y")
        return [y, h]

    return pkg.layer.recurrent_group(step=step, input=x, name="rg_multi")


def test_multi_output_step_exposes_one_node_per_output():
    jouts, touts, _, _ = run_both(_multi, {"x": Seq(4, [3, 4], seed=8)})
    assert_close(jouts, touts)
    tt = _build(_multi, T)
    assert [o.name for o in tt.outputs] == ["rg_multi_out0",
                                            "rg_multi_out1"]


def _bn_step(pkg, x, group_name):
    def step(frame):
        h = pkg.layer.fc(input=frame, size=4, act="linear", name="gs_fc",
                         param_attr=pkg.Attr(name="gs_w"), bias_attr=False)
        return pkg.layer.batch_norm(input=h, name="gs_bn")

    return pkg.layer.recurrent_group(step=step, input=x, name=group_name)


def _bn_group(pkg):
    x = pkg.layer.data(name="gx", type=pkg.dt.dense_vector_sequence(4))
    return _bn_step(pkg, x, "train_grp")


def test_batch_norm_inside_the_step_moves_statistics_out_of_the_group():
    """The step's moving statistics live under the sub-layer's name, move
    on training frames as JAX's do, and reach a generation host built
    from the same step through ``Inference(model_state=...)``."""
    feeds = {"gx": Seq(4, [3, 5], seed=1)}
    jouts, touts, jstate, tstate = run_both(_bn_group, feeds, train=True)
    assert_close(jouts, touts)
    assert set(tstate) == {"gs_bn"}
    for slot in ("moving_mean", "moving_var"):
        np.testing.assert_allclose(_np(tstate["gs_bn"][slot]),
                                   np.asarray(jstate["gs_bn"][slot]),
                                   rtol=RTOL, atol=ATOL)
    assert np.abs(_np(tstate["gs_bn"]["moving_mean"])).sum() > 0

    _, _, _, params = _pair(_bn_group)
    T.topo.reset_name_scope()
    x2 = tlayer.data(name="gx2", type=tdt.dense_vector_sequence(4))
    inf = Inference(_bn_step(T, x2, "gen_grp"), params, model_state=tstate,
                    device="cpu")
    np.testing.assert_array_equal(
        _np(inf.model_state["gs_bn"]["moving_mean"]),
        _np(tstate["gs_bn"]["moving_mean"]))
    (out,), _ = inf.topology.forward_with_state(
        params.as_dict(), inf.model_state, {"gx2": Seq(4, [4], 3).port()})
    assert np.isfinite(_np(out)).all()


def _lstm_step_group(pkg):
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(12))

    def step(frame):
        c = pkg.layer.memory(name="ls_c", size=3)
        h = pkg.layer.memory(name="ls_h", size=3)
        s = pkg.layer.lstm_step(input=frame, state_mem=c, output_mem=h,
                                size=3, name="ls")
        return [pkg.layer.lstm_step_output(s, name="ls_h"),
                pkg.layer.lstm_step_state(s, name="ls_c")]

    return pkg.layer.recurrent_group(step=step, input=x, name="rg_lstm")


def test_lstm_step_with_its_output_and_state_halves_matches_jax():
    jouts, touts, _, _ = run_both(_lstm_step_group,
                                  {"x": Seq(12, [4, 2], seed=3)}, seed=2)
    assert_close(jouts, touts)


def _trainable(pkg):
    x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(4))
    lab = pkg.layer.data(name="label", type=pkg.dt.integer_value(2))

    def step(frame):
        m = pkg.layer.memory(name="h", size=4)
        return pkg.layer.fc(input=[frame, m], size=4, act="tanh", name="h")

    grp = pkg.layer.recurrent_group(step=step, input=x, name="rg_t")
    logits = pkg.layer.fc(input=pkg.layer.last_seq(input=grp), size=2,
                          name="out_fc")
    return pkg.layer.classification_cost(input=logits, label=lab)


def test_group_gradients_match_jax_grad():
    jt, jp, tt, tp = _pair(_trainable, seed=1)
    x = Seq(4, [3, 4], seed=9)
    labels = np.array([0, 1], np.int32)

    def jloss(p):
        outs, _ = jt.forward(p, jt.init_state(), {"x": x.jax(),
                                                  "label": jnp.asarray(labels)},
                             train=True, rng=jax.random.PRNGKey(0))
        return jnp.mean(outs[0])

    jgrads = jax.grad(jloss)(jp.as_dict())
    params = {k: v.requires_grad_(True) for k, v in tp.as_dict().items()}
    outs = tt.forward(params, {"x": x.port(),
                               "label": torch.from_numpy(labels)},
                      train=True)
    grads = torch.autograd.grad(outs[0].mean(), list(params.values()))
    for k, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    # the recurrent weight of the step gets a gradient through the loop
    assert np.abs(np.asarray(jgrads["h.w1"])).sum() > 1e-6


# ---------------------------------------------------------------------------
# the attention and bidirectional helpers
# ---------------------------------------------------------------------------

def _attention(pkg):
    enc = pkg.layer.data(name="enc", type=pkg.dt.dense_vector_sequence(6))
    state = pkg.layer.data(name="s", type=pkg.dt.dense_vector(5))
    proj = pkg.layer.fc(input=enc, size=5, bias_attr=False, name="proj")
    add = pkg.net.simple_attention(encoded_sequence=enc, encoded_proj=proj,
                                   decoder_state=state, name="att")
    tstate = pkg.layer.fc(input=state, size=6, bias_attr=False, name="ts")
    dot = pkg.net.dot_product_attention(enc, enc, tstate, name="dot")
    return [add, dot]


def test_simple_and_dot_product_attention_match_jax():
    s = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    jouts, touts, _, _ = run_both(_attention,
                                  {"enc": Seq(6, [3, 1, 4], seed=3),
                                   "s": s})
    assert_close(jouts, touts)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("return_seq", [True, False])
def test_bidirectional_helpers_match_jax(cell, return_seq):
    def build(pkg):
        x = pkg.layer.data(name="x", type=pkg.dt.dense_vector_sequence(5))
        fn = getattr(pkg.net, f"bidirectional_{cell}")
        return fn(x, size=4, name="bi", return_seq=return_seq)

    jouts, touts, _, _ = run_both(build, {"x": Seq(5, [3, 6], seed=4)})
    assert_close(jouts, touts)


def test_mixed_full_matrix_projection_matches_jax():
    def build(pkg):
        x = pkg.layer.data(name="x", type=pkg.dt.dense_vector(5))
        y = pkg.layer.data(name="y", type=pkg.dt.dense_vector(3))
        return pkg.layer.mixed(
            size=3, input=[pkg.layer.full_matrix_projection(x, 3),
                           pkg.layer.identity_projection(y)],
            act="tanh", bias_attr=True, name="mx")

    rng = np.random.RandomState(0)
    jouts, touts, _, _ = run_both(build, {
        "x": rng.randn(2, 5).astype(np.float32),
        "y": rng.randn(2, 3).astype(np.float32)})
    assert_close(jouts, touts)
