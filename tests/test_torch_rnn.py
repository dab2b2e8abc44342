"""The port's recurrent ops against the JAX package's, on the CPU.

On CPU tensors the port's fused steps run the plain versions of its four
CUDA kernels (B5 the LSTM step, B6 the one-launch GRU step, B7 + B8 the
two-launch GRU step); here they are held against the JAX Pallas kernels
run through ``_fused_call`` / ``_gru_fused_call`` with ``interpret=True``,
and the scans, the sequence helpers, the pooling ops, the integer value
feeder slot and the ``lstmemory``/``grumemory``/``pooling`` layers against
their JAX counterparts.  Inputs are made with numpy from a seed and handed
to both; ``use_bf16`` is off in both packages unless a test says so.

Tolerances: f32 values 1e-5 absolute (the two frameworks sum h W_h in
other orders), gradients through a scan 2e-5 (a few steps of such sums
chained), and the H = 1280 cases 1e-5 on values, 1e-4 on gradients (as
``tests/test_fused_lstm.py``: 1280-term sums).  A bf16 h' (bf16 xp) is
held to one bf16 step of its magnitude, 2**-7, plus 1e-5.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import data_feeder as jfeeder
from paddle_tpu import data_type as jdt
from paddle_tpu import layer as jlayer
from paddle_tpu import networks as jnetworks
from paddle_tpu import pooling as jpooling
from paddle_tpu import topology as jtopo
from paddle_tpu.ops import rnn as jrnn
from paddle_tpu.ops import sequence_ops as jseq
from paddle_tpu.parameters import Parameters as JParameters
from paddle_tpu.platform.flags import FLAGS as JFLAGS
from paddle_tpu.sequence import SequenceBatch as JSB
from paddle_tpu.sequence import position_in_sequence as jposition

from paddle_tpu_torch import activation as tact
from paddle_tpu_torch import data_feeder as tfeeder
from paddle_tpu_torch import data_type as tdt
from paddle_tpu_torch import layer as tlayer
from paddle_tpu_torch import networks as tnetworks
from paddle_tpu_torch import pooling as tpooling
from paddle_tpu_torch import topology as ttopo
from paddle_tpu_torch.ops import rnn as trnn
from paddle_tpu_torch.ops import sequence_ops as tseq
from paddle_tpu_torch.parameters import Parameters as TParameters
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS
from paddle_tpu_torch.sequence import SequenceBatch as TSB
from paddle_tpu_torch.sequence import position_in_sequence


@pytest.fixture(autouse=True)
def f32_math():
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = False
    yield
    JFLAGS.use_bf16, TFLAGS.use_bf16 = old


@contextlib.contextmanager
def pallas(on: bool):
    old = (JFLAGS.use_pallas, TFLAGS.use_pallas)
    JFLAGS.use_pallas = TFLAGS.use_pallas = on
    try:
        yield
    finally:
        JFLAGS.use_pallas, TFLAGS.use_pallas = old


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x)
                      else jnp.asarray(x, jnp.float32))


def _step_inputs(rng, B, H, gates, scale=0.3):
    return dict(xp=rng.randn(B, gates * H).astype(np.float32),
                h=np.tanh(rng.randn(B, H)).astype(np.float32),
                c=rng.randn(B, H).astype(np.float32),
                w=(rng.randn(H, gates * H) * scale).astype(np.float32),
                b=(rng.randn(gates * H) * 0.1).astype(np.float32))


# ---------------------------------------------------------------------------
# the four kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("save_acts", [True, False])
@pytest.mark.parametrize("B,H,dtype", [(4, 8, "float32"), (5, 16, "bfloat16"),
                                       (3, 1280, "float32")])
def test_lstm_step_matches_pallas(B, H, dtype, save_acts):
    """B5's plain version against ``_lstm_fused_kernel_tiled``; H = 1280
    runs JAX's hidden-tiled grid (tile 256)."""
    d = _step_inputs(np.random.RandomState(H + B), B, H, 4,
                     scale=0.02 if H > 64 else 0.3)
    jdt_, tdt_ = getattr(jnp, dtype), getattr(torch, dtype)
    jout = jrnn._fused_call(jnp.asarray(d["xp"], jdt_),
                            jnp.asarray(d["h"], jdt_), jnp.asarray(d["c"]),
                            jnp.asarray(d["w"]), jnp.asarray(d["b"]),
                            True, save_acts=save_acts)
    tout = trnn.lstm_step(_t(d["xp"]).to(tdt_), _t(d["h"]).to(tdt_),
                          _t(d["c"]), _t(d["w"]), _t(d["b"]),
                          save_acts=save_acts)
    assert tout[0].dtype == tdt_ and tout[1].dtype == torch.float32
    assert (tout[2] is not None) == save_acts
    if dtype == "bfloat16":
        want = _np(jout[0])
        np.testing.assert_array_less(np.abs(_np(tout[0]) - want),
                                     2.0 ** -7 * np.abs(want) + 1e-5)
    else:
        np.testing.assert_allclose(_np(tout[0]), _np(jout[0]), atol=1e-5)
    for got, want in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("save_acts", [True, False])
@pytest.mark.parametrize("route", ["block", "tiled"])
@pytest.mark.parametrize("B,H", [(4, 8), (3, 1280)])
def test_gru_step_matches_pallas(B, H, route, save_acts):
    """Both port routes (B6, and B7 then B8) against JAX's plan at each
    shape: the single-block ``_gru_fused_kernel`` at H = 8, the two tiled
    kernels at H = 1280."""
    d = _step_inputs(np.random.RandomState(H + 7), B, H, 3,
                     scale=0.02 if H > 64 else 0.3)
    plan = jrnn._gru_fused_plan(H, B, jnp.asarray(d["w"]))
    assert plan == ("block" if H == 8 else 640)
    jh, jacts = jrnn._gru_fused_call(
        jnp.asarray(d["xp"]), jnp.asarray(d["h"]), jnp.asarray(d["w"]),
        jnp.asarray(d["b"]), True, save_acts=save_acts)
    xp, h, w, b = (_t(d[k]) for k in ("xp", "h", "w", "b"))
    if route == "block":
        th, tacts = trnn.gru_step_reference(xp, h, w, b, save_acts=save_acts)
    else:
        zrc, rh = trnn.gru_zr_reference(xp, h, w, b)
        th = trnn.gru_cand_reference(rh, xp, w, b, zrc, h,
                                     save_c=save_acts)
        tacts = zrc if save_acts else None
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-5)
    if save_acts:
        np.testing.assert_allclose(_np(tacts), _np(jacts), atol=1e-5)
    else:
        assert tacts is None and jacts is None


def test_gru_tiled_kernels_match_pallas_phases():
    """B7's z, r and r h, and B8's c, each against the tiled Pallas
    phases' outputs (acts = (z, r, c)) at H = 1280."""
    B, H = 3, 1280
    d = _step_inputs(np.random.RandomState(3), B, H, 3, scale=0.02)
    _, jacts = jrnn._gru_fused_call(
        jnp.asarray(d["xp"]), jnp.asarray(d["h"]), jnp.asarray(d["w"]),
        jnp.asarray(d["b"]), True, save_acts=True)
    jacts = _np(jacts)
    zrc, rh = trnn.gru_zr_reference(_t(d["xp"]), _t(d["h"]), _t(d["w"]),
                                    _t(d["b"]))
    np.testing.assert_allclose(zrc[:, :2 * H].numpy(), jacts[:, :2 * H],
                               atol=1e-5)
    np.testing.assert_allclose(rh.numpy(), jacts[:, H:2 * H] * d["h"],
                               atol=1e-6)
    trnn.gru_cand_reference(rh, _t(d["xp"]), _t(d["w"]), _t(d["b"]), zrc,
                            _t(d["h"]), save_c=True)
    np.testing.assert_allclose(zrc[:, 2 * H:].numpy(), jacts[:, 2 * H:],
                               atol=1e-5)


def test_route_rules_match_jax_and_the_card_gate():
    """The fused-or-plain rule is JAX's, number for number; the port's
    own GRU gate takes B6 at the main path's B 64, H 512 and B7 + B8 at
    B 64, H 1280 (JAX's plan tiles H 1280; the grids are 128 and 320 B6
    blocks of 8 units x 32 rows, and an H100 holds 264 at every H)."""
    for H in (8, 512, 1000, 1280, 2048):
        for B in (3, 64, 256):
            w4, w3 = np.zeros((H, 4 * H), np.float32), \
                np.zeros((H, 3 * H), np.float32)
            assert trnn._lstm_tile(H, B) == jrnn._lstm_tile(H, B)
            assert trnn._gru_tile(H, B) == jrnn._gru_tile(H, B)
            assert trnn._gru_fused_plan(H, B, _t(w3)) == \
                jrnn._gru_fused_plan(H, B, jnp.asarray(w3))
            assert trnn._use_fused(B, _t(w4), torch.sigmoid, torch.tanh,
                                   torch.tanh) == jrnn._use_fused(
                B, jnp.asarray(w4), jax.nn.sigmoid, jnp.tanh, jnp.tanh)
    assert not trnn._use_fused(64, _t(np.zeros((8, 32), np.float32)),
                               torch.sigmoid, torch.relu, torch.tanh)
    assert trnn.gru_route(64, 512) == "block"
    assert trnn.gru_route(64, 1280) == "tiled"
    # B6's ring: 4 stages x (32 rows x (64 + 4) f32 + 64 k x 2 gates x 8
    # units f32) = 51,200 bytes at every H; an SM's 233,472 bytes hold 4
    # such blocks (1,024 reserved each), its 2048 threads 8, and the launch
    # bounds guarantee 2 by registers: 2 x 132 SMs = 264
    assert trnn.GRU_BLOCK_SMEM == 51200
    assert trnn.gru_block_capacity_h100() == 264
    assert trnn.gru_block_refusal(64, 512) is None
    # H 1280: 160 unit blocks x 2 row blocks
    assert "320 blocks" in trnn.gru_block_refusal(64, 1280)
    assert "264" in trnn.gru_block_refusal(64, 1280)
    assert "shared memory" in trnn.gru_block_refusal(64, 4096)


def test_kernel_wrappers_refuse_cpu_tensors():
    d = _step_inputs(np.random.RandomState(0), 2, 8, 4)
    with pytest.raises(Exception, match="CUDA tensors"):
        trnn.lstm_step_kernel(_t(d["xp"]), _t(d["h"]), _t(d["c"]),
                              _t(d["w"]), _t(d["b"]))
    g = _step_inputs(np.random.RandomState(0), 2, 8, 3)
    for call in (lambda: trnn.gru_step_kernel(_t(g["xp"]), _t(g["h"]),
                                              _t(g["w"]), _t(g["b"])),
                 lambda: trnn.gru_zr_kernel(_t(g["xp"]), _t(g["h"]),
                                            _t(g["w"]), _t(g["b"]))):
        with pytest.raises(Exception, match="CUDA tensors"):
            call()


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


def _scan_data(rng, B=4, T=7, D=6, H=8, gates=4):
    x = rng.randn(B, T, D).astype(np.float32)
    lengths = rng.randint(1, T + 1, size=B)
    mask = np.arange(T)[None, :] < lengths[:, None]
    w_x = (rng.randn(D, gates * H) * 0.3).astype(np.float32)
    w_h = (rng.randn(H, gates * H) * 0.3).astype(np.float32)
    bias = (rng.randn(gates * H) * 0.1).astype(np.float32)
    return x, mask, w_x, w_h, bias


def _scan_both(jfn, tfn, arrays, cot_seed=7):
    """Values and gradients of sum(hs * cot) + sum(final * cot2) in both
    packages, with respect to every array."""
    jhs, jfin = jfn(*[jnp.asarray(a) for a in arrays])
    cot = np.random.RandomState(cot_seed).standard_normal(
        jhs.shape).astype(np.float32)
    cot2 = np.random.RandomState(cot_seed + 1).standard_normal(
        jfin.shape).astype(np.float32)

    def jloss(*a):
        hs, fin = jfn(*a)
        return jnp.sum(hs * cot) + jnp.sum(fin * cot2)

    jg = jax.grad(jloss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [_t(a).requires_grad_(True) for a in arrays]
    ths, tfin = tfn(*ts)
    ((ths * _t(cot)).sum() + (tfin * _t(cot2)).sum()).backward()
    return ((_np(jhs), _np(jfin)), (_np(ths), _np(tfin)),
            [_np(g) for g in jg], [t.grad.numpy() for t in ts])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_values_and_grads_match_jax(fused, reverse):
    x, mask, w_x, w_h, bias = _scan_data(np.random.RandomState(1))

    def jfn(x_, wx, wh, b):
        hs, fin = jrnn.lstm_scan(x_, jnp.asarray(mask), wx, wh, b,
                                 reverse=reverse)
        return hs, fin.c

    def tfn(x_, wx, wh, b):
        hs, fin = trnn.lstm_scan(x_, _t(mask), wx, wh, b, reverse=reverse)
        return hs, fin.c

    with pallas(fused):
        assert trnn._use_fused(4, _t(w_h), torch.sigmoid, torch.tanh,
                               torch.tanh) == fused
        (jv, tv, jg, tg) = _scan_both(jfn, tfn, (x, w_x, w_h, bias))
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_values_and_grads_match_jax(fused, reverse):
    x, mask, w_x, w_h, bias = _scan_data(np.random.RandomState(2), gates=3)

    def jfn(x_, wx, wh, b):
        return jrnn.gru_scan(x_, jnp.asarray(mask), wx, wh, b,
                             reverse=reverse)

    def tfn(x_, wx, wh, b):
        return trnn.gru_scan(x_, _t(mask), wx, wh, b, reverse=reverse)

    with pallas(fused):
        (jv, tv, jg, tg) = _scan_both(jfn, tfn, (x, w_x, w_h, bias))
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_gru_scan_tiled_route_matches_jax():
    """The port's B7 + B8 route through a scan, forced, against JAX's
    tiled plan at H = 1280, T = 3."""
    B, T, D, H = 3, 3, 5, 1280
    rng = np.random.RandomState(4)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], bool)
    w_x = (rng.randn(D, 3 * H) * 0.1).astype(np.float32)
    w_h = (rng.randn(H, 3 * H) * 0.02).astype(np.float32)
    bias = (rng.randn(3 * H) * 0.1).astype(np.float32)
    old = trnn.gru_route
    trnn.gru_route = lambda *a, **k: "tiled"
    try:
        jv, tv, jg, tg = _scan_both(
            lambda a, b: jrnn.gru_scan(a, jnp.asarray(mask),
                                       jnp.asarray(w_x), b, jnp.asarray(bias)),
            lambda a, b: trnn.gru_scan(a, _t(mask), _t(w_x), b, _t(bias)),
            (x, w_h))
    finally:
        trnn.gru_route = old
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_lstm_scan_h1280_tiled_matches_jax():
    B, T, D, H = 3, 2, 5, 1280
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = np.ones((B, T), bool)
    w_x = (rng.randn(D, 4 * H) * 0.1).astype(np.float32)
    w_h = (rng.randn(H, 4 * H) * 0.02).astype(np.float32)
    bias = (rng.randn(4 * H) * 0.1).astype(np.float32)
    jv, tv, jg, tg = _scan_both(
        lambda a, b: (lambda r: (r[0], r[1].c))(jrnn.lstm_scan(
            a, jnp.asarray(mask), jnp.asarray(w_x), b, jnp.asarray(bias))),
        lambda a, b: (lambda r: (r[0], r[1].c))(trnn.lstm_scan(
            a, _t(mask), _t(w_x), b, _t(bias))),
        (x, w_h))
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_scans_bias_none_init_and_custom_activation():
    """bias None (zeros on the fused route, absent on the plain one), an
    explicit init state, a pre-projected input (w_x None), and a custom
    cell activation that takes the plain cell in both packages."""
    x, mask, _, w_h, _ = _scan_data(np.random.RandomState(6))
    xp = np.random.RandomState(7).randn(4, 7, 32).astype(np.float32)
    h0 = np.tanh(np.random.RandomState(8).randn(4, 8)).astype(np.float32)
    c0 = np.random.RandomState(9).randn(4, 8).astype(np.float32)
    for fused in (True, False):
        with pallas(fused):
            jhs, jfin = jrnn.lstm_scan(
                jnp.asarray(xp), jnp.asarray(mask), None, jnp.asarray(w_h),
                None, init=jrnn.LSTMState(jnp.asarray(h0), jnp.asarray(c0)))
            ths, tfin = trnn.lstm_scan(
                _t(xp), _t(mask), None, _t(w_h), None,
                init=trnn.LSTMState(_t(h0), _t(c0)))
        np.testing.assert_allclose(_np(ths), _np(jhs), atol=1e-5)
        np.testing.assert_allclose(_np(tfin.c), _np(jfin.c), atol=1e-5)
    jhs, _ = jrnn.lstm_scan(jnp.asarray(xp), jnp.asarray(mask), None,
                            jnp.asarray(w_h), None, cell_act=jax.nn.relu)
    ths, _ = trnn.lstm_scan(_t(xp), _t(mask), None, _t(w_h), None,
                            cell_act=torch.relu)
    assert not trnn._use_fused(4, _t(w_h), torch.sigmoid, torch.relu,
                               torch.tanh)
    np.testing.assert_allclose(_np(ths), _np(jhs), atol=1e-5)
    # ragged: a masked step holds the state, so a sequence's final state
    # is its state at its last valid step
    lengths = mask.sum(1)
    for b in range(4):
        np.testing.assert_allclose(_np(ths)[b, lengths[b]:],
                                   np.broadcast_to(
                                       _np(ths)[b, lengths[b] - 1],
                                       (7 - lengths[b], 8)), atol=0)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_fused_backward_under_bf16_policy_matches_jax(use_bf16):
    """The closed-form backward's products go through ``matmul`` (bf16
    inputs under the policy) in both packages: gradients agree to the f32
    sum order (2e-5) with the policy off and to 1e-3 with it on (dgates
    and W_h rounded to bf16 at the same places)."""
    x, mask, w_x, w_h, bias = _scan_data(np.random.RandomState(10))
    old = (JFLAGS.use_bf16, TFLAGS.use_bf16)
    JFLAGS.use_bf16 = TFLAGS.use_bf16 = use_bf16
    try:
        xp = x @ w_x
        _, _, jg, tg = _scan_both(
            lambda a, wh: (lambda r: (r[0], r[1].c))(jrnn.lstm_scan(
                a, jnp.asarray(mask), None, wh, jnp.asarray(bias))),
            lambda a, wh: (lambda r: (r[0], r[1].c))(trnn.lstm_scan(
                a, _t(mask), None, wh, _t(bias))),
            (xp, w_h))
    finally:
        JFLAGS.use_bf16, TFLAGS.use_bf16 = old
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-3 if use_bf16 else 2e-5)


# ---------------------------------------------------------------------------
# sequences, pooling, feeder, layers
# ---------------------------------------------------------------------------


def _seq_batch(rng, lengths, cap, feat=3, dtype=np.float32):
    seqs = [rng.randn(n, feat).astype(dtype) for n in lengths]
    return seqs, JSB.from_list(seqs, capacity=cap), \
        TSB.from_list(seqs, capacity=cap, device="cpu")


@pytest.mark.parametrize("max_len", [None, 4])
def test_to_padded_and_from_padded_match_jax(max_len):
    rng = np.random.RandomState(11)
    lengths = [5, 1, 7, 3]
    _, jsb, tsb = _seq_batch(rng, lengths, 32)
    jp, jm = jsb.to_padded(max_len)
    tp, tm = tsb.to_padded(max_len)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        position_in_sequence(tsb.segment_ids).numpy(),
        np.asarray(jposition(jsb.segment_ids)))
    padded = rng.randn(4, 7, 3).astype(np.float32)
    for cap in (None, 16, 40):
        j = JSB.from_padded(jnp.asarray(padded), jnp.asarray(lengths), cap)
        t = TSB.from_padded(_t(padded), _t(np.asarray(lengths, np.int32)),
                            cap)
        assert t.capacity == j.capacity and t.max_len == j.max_len == 7
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.segment_ids.numpy(),
                                      np.asarray(j.segment_ids))


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "sqrtn"])
def test_seq_pool_values_and_grads_match_jax(kind):
    rng = np.random.RandomState(12)
    lengths = [5, 1, 7, 3]
    _, jsb, tsb = _seq_batch(rng, lengths, 32)
    cot = rng.randn(4, 3).astype(np.float32)
    jfn = getattr(jseq, f"seq_pool_{kind}")
    tfn = getattr(tseq, f"seq_pool_{kind}")
    jv, jgrad = jax.value_and_grad(lambda d: jnp.sum(
        jfn(jsb.with_data(d)) * cot))(jsb.data)
    data = tsb.data.clone().requires_grad_(True)
    tv = (tfn(tsb.with_data(data)) * _t(cot)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(jgrad),
                               atol=1e-6)


def test_seq_pool_max_with_ties():
    """Two tokens of one sequence tie for the max: both packages give the
    pooled value; torch's ``scatter_reduce`` splits the gradient evenly
    between the tied tokens, which is what JAX's ``segment_max`` does."""
    seqs = [np.array([[1.0], [3.0], [3.0], [2.0]], np.float32),
            np.array([[0.5]], np.float32)]
    jsb = JSB.from_list(seqs, capacity=8)
    tsb = TSB.from_list(seqs, capacity=8, device="cpu")
    jv, jgrad = jax.value_and_grad(lambda d: jnp.sum(
        jseq.seq_pool_max(jsb.with_data(d))))(jsb.data)
    data = tsb.data.clone().requires_grad_(True)
    tv = tseq.seq_pool_max(tsb.with_data(data)).sum()
    tv.backward()
    assert float(tv.detach()) == float(jv) == 3.5
    np.testing.assert_array_equal(data.grad.numpy(), np.asarray(jgrad))
    assert data.grad.numpy()[1, 0] == data.grad.numpy()[2, 0] == 0.5


def test_integer_value_slot_matches_jax():
    batch = [([3, 4, 5], 1), ([7], 0), ([1, 2], 1)]
    jf = jfeeder.DataFeeder([("words", jdt.integer_value_sequence(10)),
                             ("label", jdt.integer_value(2))])
    tf = tfeeder.DataFeeder([("words", tdt.integer_value_sequence(10)),
                             ("label", tdt.integer_value(2))], device="cpu")
    jfeeds, tfeeds = jf.feed(batch), tf.feed(batch)
    assert tfeeds["label"].dtype == torch.int32
    np.testing.assert_array_equal(tfeeds["label"].numpy(),
                                  np.asarray(jfeeds["label"]))
    assert tfeeds["label"].shape == (3,)
    assert tfeeds["words"].max_len == jfeeds["words"].max_len == 16
    pairs = [([1], [2, 3]), ([4], [5, 6])]
    jrows = jfeeder.DataFeeder([("p", jdt.integer_value_sequence(9)),
                                ("q", jdt.integer_value(9))]).feed(
        [(a, b) for a, b in pairs])
    trows = tfeeder.DataFeeder([("p", tdt.integer_value_sequence(9)),
                                ("q", tdt.integer_value(9))],
                               device="cpu").feed([(a, b) for a, b in pairs])
    np.testing.assert_array_equal(trows["q"].numpy(), np.asarray(jrows["q"]))
    with pytest.raises(Exception, match="integer values"):
        tfeeder.DataFeeder([("x", tdt.InputType(3, tdt.SlotKind.DENSE))],
                           device="cpu")


def _layer_graph(L, N, P, dt, cell, reverse, pool):
    words = L.data(name="words", type=dt.integer_value_sequence(50))
    emb = L.embedding(input=words, size=6)
    if cell == "lstm":
        net = N.simple_lstm(input=emb, size=8, reverse=reverse, name="rnn")
    else:
        net = N.simple_gru(input=emb, size=8, reverse=reverse, name="rnn")
    return L.pooling(input=net, pooling_type=getattr(P, pool)())


@pytest.mark.parametrize("cell,reverse,pool", [
    ("lstm", False, "MaxPooling"), ("lstm", True, "AvgPooling"),
    ("gru", False, "SumPooling"), ("gru", True, "SqrtNPooling")])
def test_recurrent_layers_match_jax(cell, reverse, pool):
    """embedding -> simple_lstm / simple_gru -> pooling in both packages,
    the JAX weights crossing through the tar format: same parameter names
    and shapes, same pooled outputs."""
    jtopo.reset_name_scope()
    jout = _layer_graph(jlayer, jnetworks, jpooling, jdt, cell, reverse,
                        pool)
    jt = jtopo.Topology([jout])
    buf = io.BytesIO()
    JParameters.from_topology(jt, seed=3).to_tar(buf)
    ttopo.reset_name_scope()
    tout = _layer_graph(tlayer, tnetworks, tpooling, tdt, cell, reverse,
                        pool)
    tt = ttopo.Topology([tout])
    tparams = TParameters.from_tar(io.BytesIO(buf.getvalue()), device="cpu")
    assert {k: tuple(s.shape) for k, s in jt.param_specs().items()} == \
        {k: tuple(s.shape) for k, s in tt.param_specs().items()}
    jparams = JParameters.from_tar(io.BytesIO(buf.getvalue()))
    batch = [([1, 2, 3, 4, 5],), ([6, 7],), ([8, 9, 10, 11, 12, 13, 14],)]
    jfeeds = jfeeder.DataFeeder([("words", jdt.integer_value_sequence(50))
                                 ]).feed(batch)
    tfeeds = tfeeder.DataFeeder([("words", tdt.integer_value_sequence(50))],
                                device="cpu").feed(batch)
    jv = jt.forward(jparams.as_dict(), {}, jfeeds)[0][0]
    tv = tt.forward(tparams.as_dict(), tfeeds)[0]
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               atol=1e-5)


def test_activation_identity_and_registry():
    assert tact.get("sigmoid").fn is torch.sigmoid
    assert tact.get("tanh").fn is torch.tanh
    assert tact.get("relu").fn is torch.relu
    x = np.linspace(-4, 4, 17).astype(np.float32)
    np.testing.assert_allclose(tact.SigmoidActivation.fn(_t(x)).numpy(),
                               np.asarray(jax.nn.sigmoid(x)), atol=1e-6)
