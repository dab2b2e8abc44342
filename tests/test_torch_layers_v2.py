"""The rest of the v2 layer surface, the port against the JAX package on
the CPU.

One parametrised case a layer (two where a layer has two modes worth
holding apart: ``bilinear_interp`` up and down, since JAX's resize
antialiases only when shrinking; ``img_conv3d`` and its transpose;
pools max and avg).  Each case builds the node in both packages, gives
both the JAX initializer's weights and the same seeded numpy samples
through each package's ``DataFeeder``, and compares the output and the
gradients of a weighted sum of it with respect to every parameter and
every float input, in f32: within 1e-5 (absolute and relative) unless a
case states its own bound.  Sequence outputs are compared on their valid
tokens.  ``sampling_id`` and ``nce`` draw from JAX's PRNG in the JAX
package; their cases hand JAX's draws to the port's draw functions
(monkeypatched), as the VAE's parity test hands over its ``eps``, and a
test of their own checks the port's draws on their law.

Sparse slots (binary and float, alone and as sequences) go through both
feeders; ``moe_ffn``'s dense path (the parallel slice) against JAX's.
The breadth gate:
every layer the JAX package exports is in the port's ``layer.__all__``,
and each of the slice's new layers has a case here or in
``tests/test_torch_detection.py`` (``priorbox``, ``multibox_loss``,
``detection_output``).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import data_type as jdt
from paddle_tpu import layer as jlayer
from paddle_tpu import topology as jtopo
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS
from paddle_tpu.sequence import SequenceBatch as JSeq

from paddle_tpu_torch import convert
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.sequence import SequenceBatch

TOL = 1e-5
B, D = 4, 6


@pytest.fixture(autouse=True)
def f32_policy():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    yield
    JFLAGS.use_bf16, TFLAGS.use_bf16 = old


def _rs(seed):
    return np.random.RandomState(seed)


def _x(L, dt, dim=D, name="x"):
    return L.data(name=name, type=dt.dense_vector(dim))


def _valid(v):
    """(data as numpy, valid-row mask or None)."""
    if isinstance(v, (JSeq, SequenceBatch)):
        data = v.data.detach().numpy() if isinstance(v, SequenceBatch) \
            else np.asarray(v.data)
        mask = v.valid_mask.numpy() if isinstance(v, SequenceBatch) \
            else np.asarray(v.valid_mask)
        return data, mask
    return (v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)), None


def _is_float(v) -> bool:
    d = v.data if isinstance(v, (JSeq, SequenceBatch)) else v
    return d.dtype in (jnp.float32, torch.float32)


def run_both(build, slots, batch, seed=0):
    """Forward ``build(L, dt) -> node`` in both packages on ``batch``
    (slots ``[(name, data_type fn, dim)]``).  Returns (jax out, port out,
    jax grads, port grads): outputs as numpy on valid rows, grads of
    ``sum(out * w)`` by parameter or input name."""
    jtopo.reset_name_scope()
    jnode = build(jlayer, jdt)
    ttopo.reset_name_scope()
    tnode = build(tlayer, tdt)
    jt, tt = jtopo.Topology([jnode]), ttopo.Topology([tnode])
    assert set(jt.param_specs()) == set(tt.param_specs())
    arrays = {k: np.asarray(v) for k, v in
              JParameters.from_topology(jt, seed=seed).as_dict().items()}
    jfeeds = jpaddle.DataFeeder([(n, getattr(jdt, f)(d))
                                 for n, f, d in slots])(batch)
    tfeeds = DataFeeder([(n, getattr(tdt, f)(d)) for n, f, d in slots],
                        device="cpu")(batch)
    dnames = [k for k, v in jfeeds.items() if _is_float(v)]

    def with_inputs(feeds, d):
        out = dict(feeds)
        for k in dnames:
            v = feeds[k]
            out[k] = v.with_data(d[k]) if isinstance(v, (JSeq, SequenceBatch)) \
                else d[k]
        return out

    def jout(p, d):
        return jt.forward(p, {}, with_inputs(jfeeds, d))[0][0]

    jp = {k: jnp.asarray(v) for k, v in arrays.items()}
    jd = {k: (jfeeds[k].data if isinstance(jfeeds[k], JSeq) else jfeeds[k])
          for k in dnames}
    jval = jout(jp, jd)
    want, mask = _valid(jval)
    # the weights cross as numpy, as every port parity test takes them
    params = convert.parameters_from_numpy(arrays, device="cpu")
    tp = {k: params[k].requires_grad_(True) for k in arrays}
    td = {k: (tfeeds[k].data if isinstance(tfeeds[k], SequenceBatch)
              else tfeeds[k]).clone().requires_grad_(True) for k in dnames}
    tval = tt.forward(tp, with_inputs(tfeeds, td))[0]
    got, tmask = _valid(tval)
    if mask is not None:
        np.testing.assert_array_equal(tmask, mask)
    if not np.issubdtype(want.dtype, np.floating):
        return want, got, None, None
    wts = _rs(7).randn(*want.shape).astype(np.float32)
    if mask is not None:
        wts[~mask] = 0.0

    def loss(p, d):
        v = jout(p, d)
        return jnp.sum((v.data if isinstance(v, JSeq) else v) * wts)

    jgp, jgd = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jd)
    tdata = tval.data if isinstance(tval, SequenceBatch) else tval
    tl = (tdata * torch.from_numpy(wts)).sum()
    if tl.requires_grad:
        tl.backward()
    jgrads = {**{k: np.asarray(g) for k, g in jgp.items()},
              **{f"feed:{k}": np.asarray(g) for k, g in jgd.items()}}
    tgrads = {**{k: (t.grad.numpy() if t.grad is not None
                     else np.zeros_like(arrays[k])) for k, t in tp.items()},
              **{f"feed:{k}": (t.grad.numpy() if t.grad is not None
                               else np.zeros(t.shape, np.float32))
                 for k, t in td.items()}}
    if mask is not None:
        want, got = want[mask], got[mask]
    return want, got, jgrads, tgrads


def check(want, got, jgrads, tgrads, tol=TOL):
    assert got.shape == want.shape
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert set(jgrads) == set(tgrads)
    for k in jgrads:
        np.testing.assert_allclose(tgrads[k], jgrads[k], rtol=tol, atol=tol,
                                   err_msg=k)


from paddle_tpu_torch.tools.layer_cases import CASES, dense  # noqa: E402


@pytest.mark.parametrize("case", sorted(CASES))
def test_v2_layer_matches_jax(case):
    build, slots, batch = CASES[case][:3]
    check(*run_both(build, slots, batch))


# The gradient of an impossible alignment's cost (~1e5, a sum of
# log_epsilon = -1e5 terms) is exp(a - logZ) of values near -1e5, where an
# f32 holds steps of 7.8e-3: the two packages' logaddexps round there
# apart, and the gradient carries that error (~1%) in its exponent.
# Measured: 8.7e-5 and 1.24e-3 absolute on two such sequences, 0.4% and
# 1.4% of their largest gradient; held at 2% of it.  The possible
# sequences beside it hold at 1e-5.
IMPOSSIBLE_GRAD_SHARE = 2e-2


def test_ctc_of_an_impossible_alignment_is_finite_as_jax():
    """A label longer than its input has no alignment: optax clamps at
    log_epsilon, so the cost is large and finite in both packages, not
    ``inf``."""
    build, slots, _ = CASES["ctc"]
    # the second label (4 tokens) is longer than its input (2 frames)
    batch = [(list(_rs(4).randn(n, 5).astype(np.float32)), lab) for n, lab
             in ((5, [1, 2]), (2, [1, 2, 3, 4]), (4, [3, 3]))]
    want, got, jg, tg = run_both(build, slots, batch)
    assert np.isfinite(got).all() and got[1] > 1e4
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    rows = np.arange(len(jg["feed:s"]))
    impossible = (rows >= 5) & (rows < 7)
    np.testing.assert_allclose(tg["feed:s"][~impossible],
                               jg["feed:s"][~impossible], rtol=TOL, atol=TOL)
    bad = jg["feed:s"][impossible]
    np.testing.assert_allclose(tg["feed:s"][impossible], bad, rtol=0,
                               atol=IMPOSSIBLE_GRAD_SHARE * np.abs(bad).max())


# ---------------------------------------------------------------------------
# random draws: JAX's handed to the port, the port's own on their law
# ---------------------------------------------------------------------------


def test_sampling_id_with_jax_draws(monkeypatch):
    """``sampling_id`` on softmax rows, JAX's categorical draws (the key
    JAX's forward gives the node without a step key) handed to the
    port."""
    build = lambda L, dt: L.sampling_id(L.fc(_x(L, dt), size=5,
                                             act="softmax", name="p"))
    batch = dense(("d", D, -1, 1), n=8)
    slots = [("x", "dense_vector", D)]
    jtopo.reset_name_scope()
    jt = jtopo.Topology([build(jlayer, jdt)])
    arrays = {k: np.array(v) for k, v in
              JParameters.from_topology(jt, seed=0).as_dict().items()}
    jfeeds = jpaddle.DataFeeder([("x", jdt.dense_vector(D))])(batch)
    want = np.asarray(jt.forward({k: jnp.asarray(v) for k, v in
                                  arrays.items()}, {}, jfeeds)[0][0])
    seen = []

    def draws(gen, probs):
        seen.append(probs.detach().numpy())
        return torch.from_numpy(want.astype(np.int64))

    monkeypatch.setattr(tlayer, "_draw_ids", draws)
    ttopo.reset_name_scope()
    tt = ttopo.Topology([build(tlayer, tdt)])
    got = tt.forward({k: torch.tensor(v) for k, v in arrays.items()},
                     DataFeeder([("x", tdt.dense_vector(D))],
                                device="cpu")(batch))[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    jprobs = np.asarray(jt.forward({k: jnp.asarray(v) for k, v in
                                    arrays.items()}, {}, jfeeds,
                                   outputs=[jt.outputs[0].inputs[0]])[0][0])
    np.testing.assert_allclose(seen[0], jprobs, rtol=TOL, atol=TOL)


def _jax_nce_negatives(B, k, num_classes, dist):
    key = jax.random.PRNGKey(0)          # the node's key without a step key
    if dist is None:
        return np.asarray(jax.random.randint(key, (B, k), 0, num_classes))
    logits = jnp.log(jnp.clip(jnp.asarray(dist), 1e-20, 1.0))
    return np.asarray(jax.random.categorical(key, logits[None, :],
                                             shape=(B, k)))


@pytest.mark.parametrize("dist", [None, [0.4, 0.1, 0.1, 0.1, 0.1, 0.1,
                                         0.1]], ids=["uniform", "given"])
def test_nce_with_jax_draws(monkeypatch, dist):
    k = 3
    monkeypatch.setattr(
        tlayer, "_nce_negatives",
        lambda gen, b, kk, n, d, device: torch.tensor(
            _jax_nce_negatives(b, kk, n, d)))
    build = lambda L, dt: L.nce(_x(L, dt), L.data(
        name="y", type=dt.integer_value(7)), num_classes=7,
        num_neg_samples=k, neg_distribution=dist)
    check(*run_both(build, [("x", "dense_vector", D),
                            ("y", "integer_value", 7)],
                    dense(("d", D, -1, 1), ("i", 7))))


def test_port_draws_follow_their_law():
    """The port's own draws: the same generator seed gives the same ids;
    4000 draws from a row and 4000 negatives from a distribution land on
    each class within 5 standard deviations of its expectation."""
    p = torch.tensor([[0.5, 0.3, 0.2, 0.0]]).expand(4000, -1)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    ids = tlayer._draw_ids(g1, p)
    assert torch.equal(ids, tlayer._draw_ids(g2, p))
    dist = [0.6, 0.3, 0.1]
    neg = tlayer._nce_negatives(torch.Generator().manual_seed(4), 1000, 4,
                                3, dist, "cpu").reshape(-1)
    uni = tlayer._nce_negatives(torch.Generator().manual_seed(5), 1000, 4,
                                3, None, "cpu").reshape(-1)
    for draws, law in ((ids, [0.5, 0.3, 0.2, 0.0]), (neg, dist),
                       (uni, [1 / 3] * 3)):
        counts = np.bincount(draws.numpy(), minlength=len(law))
        n = len(draws)
        for c, q in zip(counts, law):
            assert abs(c - n * q) <= 5 * np.sqrt(n * q * (1 - q)) + 1e-9


# ---------------------------------------------------------------------------
# print_layer, sparse slots, moe_ffn, the breadth gate
# ---------------------------------------------------------------------------


def test_print_layer_passes_its_input_and_prints_it(capfd):
    batch = dense(("d", 3, -1, 1), n=2)
    ttopo.reset_name_scope()
    x = _x(tlayer, tdt, 3)
    node = tlayer.print_layer(x, format="seen {x}")
    out = ttopo.Topology([node]).forward(
        {}, DataFeeder([("x", tdt.dense_vector(3))], device="cpu")(batch))[0]
    np.testing.assert_array_equal(out.numpy(), np.stack([r[0] for r in
                                                         batch]))
    text = capfd.readouterr().out
    assert text == "seen " + str(out.numpy()) + "\n"


SPARSE_SLOTS = [("b", "sparse_binary_vector", 7),
                ("f", "sparse_float_vector", 7),
                ("bs", "sparse_binary_vector_sequence", 7),
                ("fs", "sparse_float_vector_sequence", 7)]
SPARSE_BATCH = [([0, 3], [(1, 0.5), (6, -2.0)], [[2], [0, 6]],
                 [[(3, 1.5)]]),
                ([6], [(2, 1.0), (2, 3.0)], [[1, 1]],
                 [[(0, -1.0), (5, 0.25)], [(4, 2.0)], [(6, 1.0)]])]


def test_sparse_slots_feed_as_jax():
    jf = jpaddle.DataFeeder([(n, getattr(jdt, f)(d))
                             for n, f, d in SPARSE_SLOTS])(SPARSE_BATCH)
    tf = DataFeeder([(n, getattr(tdt, f)(d)) for n, f, d in SPARSE_SLOTS],
                    device="cpu")(SPARSE_BATCH)
    for name in ("b", "f"):
        assert tf[name].dtype == torch.float32
        np.testing.assert_array_equal(tf[name].numpy(), np.asarray(jf[name]))
    for name in ("bs", "fs"):
        np.testing.assert_array_equal(tf[name].data.numpy(),
                                      np.asarray(jf[name].data))
        np.testing.assert_array_equal(tf[name].lengths.numpy(),
                                      np.asarray(jf[name].lengths))
        assert tf[name].max_len == jf[name].max_len


def test_fc_over_sparse_rows_matches_jax():
    def build(L, dt):
        b = L.data(name="b", type=dt.sparse_binary_vector(7))
        f = L.data(name="f", type=dt.sparse_float_vector(7))
        return L.fc([b, f], size=3, act="tanh")

    check(*run_both(build, SPARSE_SLOTS[:2],
                    [r[:2] for r in SPARSE_BATCH]))


def test_moe_ffn_names_the_parallel_slice():
    """``moe_ffn`` came with the parallel slice: its dense path (top-2,
    a capacity that drops) against JAX's, output and gradients."""
    def build(L, dt):
        return L.moe_ffn(L.fc(_x(L, dt), size=4, name="h"), num_experts=4,
                         expert_hidden=5, top_k=2, capacity_factor=1.0,
                         name="moe")[0]

    check(*run_both(build, [("x", "dense_vector", D)],
                    dense(("d", D, -1, 1), n=8)))


DETECTION_LAYERS = {"priorbox", "multibox_loss", "detection_output"}
NEW_LAYERS = {
    "interpolation", "scaling", "power", "sum_to_one_norm", "row_l2_norm",
    "cos_sim", "clip", "resize", "spp", "maxout", "bilinear_interp", "pad",
    "crop", "rotate", "block_expand", "sampling_id", "selective_fc", "nce",
    "hsigmoid", "ctc", "warp_ctc", "cross_entropy_with_selfnorm_cost",
    "square_error_cost", "regression_cost",
    "soft_binary_class_cross_entropy_cost", "rank_cost", "lambda_cost",
    "huber_regression_cost", "huber_classification_cost", "smooth_l1_cost",
    "sum_cost", "moe_ffn", "eos", "prelu", "scale_shift", "data_norm",
    "trans", "switch_order", "tensor", "out_prod", "multiplex",
    "conv_shift", "linear_comb", "convex_comb", "cos_vm", "row_conv",
    "subseq", "featmap_expand", "print_layer", "img_conv3d", "img_pool3d",
    "mdlstmemory", "priorbox", "multibox_loss", "detection_output",
    "gated_recurrent"}


def test_every_v2_layer_is_ported_and_held():
    assert set(tlayer.__all__) == set(jlayer.__all__)
    assert len(NEW_LAYERS) == 56 and NEW_LAYERS <= set(tlayer.__all__)
    held = {c for c in CASES} | DETECTION_LAYERS | {
        "sampling_id", "nce", "print_layer", "moe_ffn"}
    covered = {n for n in NEW_LAYERS
               if n in held or any(c.startswith(n + "_") for c in held)}
    assert covered == NEW_LAYERS
