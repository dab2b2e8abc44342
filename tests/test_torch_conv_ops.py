"""The port's image ops (``ops/conv.py``, ``ops/pool.py``, ``ops/norm.py``
and dropout) against the JAX package's, on the CPU.

Each case makes its inputs with numpy from a seed, runs the JAX function
under ``jax.vjp`` and the port's under ``torch.autograd`` with the same
cotangent, and compares the outputs and every input's gradient, in f32
(``use_bf16`` off in both packages) and under the bf16 policy
(``use_bf16`` and ``bf16_activations`` on: bf16 operands, bf16 outputs).

Tolerances, the measured worst case in brackets:
- f32: 1e-5 of the largest magnitude of the tensor compared, elementwise
  (convs and their gradients 4.1e-7, pools and norms 3.7e-7): the two
  frameworks sum the same products in other orders.
- bf16 policy: outputs and gradients within 2 ** -7 of their own
  magnitude plus 1e-2 of the tensor's largest (convs and max pools equal
  bit for bit; batch norm 2.2e-7 and cross-map norm 3.8e-3 of the largest):
  both round every conv output and every gradient to bf16, and an f32
  sum taken in another order can cross a bf16 rounding step (2 ** -8 of
  the value).
Dropout cannot match JAX bit for bit (a torch generator cannot replay a
JAX PRNG key); its tests hold the semantics: the keep rate within 4
sigma, kept values scaled by 1 / keep, the identity when off, the same
mask from the same seed.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.ops import conv as jconv
from paddle_tpu.ops import norm as jnorm
from paddle_tpu.ops import pool as jpool
from paddle_tpu.platform.flags import FLAGS as JFLAGS

from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.ops import norm as tnorm
from paddle_tpu_torch.ops import pool as tpool
from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

F32_TOL = 1e-5
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-2


@contextlib.contextmanager
def bf16_policy(on: bool):
    names = ("use_bf16", "bf16_activations")
    old = [(getattr(JFLAGS, n), getattr(TFLAGS, n)) for n in names]
    for n in names:
        setattr(JFLAGS, n, on)
        setattr(TFLAGS, n, on)
    try:
        yield
    finally:
        for n, (j, t) in zip(names, old):
            setattr(JFLAGS, n, j)
            setattr(TFLAGS, n, t)


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_close(got, want, bf16: bool, what=""):
    """Elementwise within the module's tolerance; non-finite values (a
    window wholly in -inf padding, an empty pyramid bin) must be the same
    in both."""
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=what)
    got, want = got[finite], want[finite]
    scale = float(np.abs(want).max(initial=0.0)) or 1.0
    if bf16:
        bound = BF16_REL * np.abs(want) + BF16_ABS * scale
    else:
        bound = F32_TOL * scale
    err = np.abs(got - want)
    assert np.all(err <= bound), (what, float(err.max(initial=0.0)), scale)


def _both(jfn, tfn, arrays, seed=7):
    """(JAX output, port output, JAX grads, port grads) of ``fn(*arrays)``
    under one cotangent; only float arrays get gradients."""
    jargs = [jnp.asarray(a) for a in arrays]
    jy, vjp = jax.vjp(jfn, *jargs)
    cot = np.random.RandomState(seed).randn(*jy.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot).astype(jy.dtype))
    targs = [torch.tensor(a, requires_grad=a.dtype == np.float32)
             for a in arrays]
    ty = tfn(*targs)
    assert ty.dtype == {jnp.float32: torch.float32,
                        jnp.bfloat16: torch.bfloat16}[jy.dtype.type], \
        (ty.dtype, jy.dtype)
    diff = [t for t in targs if t.requires_grad]
    tgrads = torch.autograd.grad(ty, diff, torch.from_numpy(cot).to(
        ty.dtype))
    jg = [g for g, a in zip(jgrads, arrays) if a.dtype == np.float32]
    return jy, ty, jg, tgrads


def _check(jfn, tfn, arrays, bf16, seed=7):
    jy, ty, jg, tg = _both(jfn, tfn, arrays, seed)
    assert_close(ty, jy, bf16, "output")
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert_close(a, b, bf16, f"grad {i}")


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

CONV_CASES = {
    # name: (x shape, w shape, kwargs)
    "plain": ((2, 9, 9, 4), (3, 3, 4, 6), dict()),
    "stride2_pad": ((2, 10, 11, 3), (3, 3, 3, 8), dict(stride=2,
                                                      padding=1)),
    "groups": ((2, 8, 8, 6), (3, 3, 2, 9), dict(groups=3, padding=1)),
    "dilation": ((1, 12, 12, 4), (3, 3, 4, 5), dict(dilation=2,
                                                   padding=2)),
    "asym_stride_pad": ((2, 9, 7, 2), (5, 5, 2, 4), dict(stride=(2, 1),
                                                        padding=(2, 1))),
    "same": ((2, 7, 7, 3), (3, 3, 3, 4), dict(padding="SAME")),
}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case, bf16):
    xs, ws, kw = CONV_CASES[case]
    rng = np.random.RandomState(0)
    x, w = _rand(rng, *xs), _rand(rng, *ws, scale=0.3)
    with bf16_policy(bf16):
        _check(lambda a, b: jconv.conv2d(a, b, **kw),
               lambda a, b: tconv.conv2d(a, b, **kw), [x, w], bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1), (2, 0),
                                            (3, 2)])
def test_conv2d_transpose_matches_jax(stride, padding, bf16):
    rng = np.random.RandomState(1)
    x, w = _rand(rng, 2, 5, 6, 3), _rand(rng, 3, 3, 3, 4, scale=0.3)
    kw = dict(stride=stride, padding=padding)
    with bf16_policy(bf16):
        _check(lambda a, b: jconv.conv2d_transpose(a, b, **kw),
               lambda a, b: tconv.conv2d_transpose(a, b, **kw), [x, w],
               bf16)


def test_conv2d_transpose_is_the_adjoint_of_conv2d():
    """The index map: <conv2d(x, w), r> == <x, conv2d_transpose(r, w')>
    with w' the HWIO kernel read as [kh, kw, Cout, Cin], unflipped: the
    identity that settles which way the port's kernel runs (the JAX
    package flips the kernel because it convolves the dilated input)."""
    rng = np.random.RandomState(2)
    x, w = _rand(rng, 1, 9, 9, 3), _rand(rng, 3, 3, 3, 4)
    with bf16_policy(False):
        y = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                         padding=1)
        r = torch.from_numpy(_rand(rng, *y.shape))
        wt = torch.from_numpy(w).permute(0, 1, 3, 2)
        back = tconv.conv2d_transpose(r, wt, stride=2, padding=1)
    lhs = float((y * r).sum())
    assert back.shape == x.shape
    rhs = float((torch.from_numpy(x) * back).sum())
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_depthwise_conv2d_matches_jax(bf16):
    rng = np.random.RandomState(3)
    x, w = _rand(rng, 2, 8, 8, 4), _rand(rng, 3, 3, 4, 2, scale=0.3)
    with bf16_policy(bf16):
        _check(lambda a, b: jconv.depthwise_conv2d(a, b, stride=2,
                                                   padding=1),
               lambda a, b: tconv.depthwise_conv2d(a, b, stride=2,
                                                   padding=1), [x, w], bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_conv3d_matches_jax(bf16):
    rng = np.random.RandomState(4)
    x, w = _rand(rng, 2, 5, 6, 6, 3), _rand(rng, 3, 3, 3, 3, 4, scale=0.3)
    with bf16_policy(bf16):
        _check(lambda a, b: jconv.conv3d(a, b, stride=(1, 2, 2), padding=1),
               lambda a, b: tconv.conv3d(a, b, stride=(1, 2, 2), padding=1),
               [x, w], bf16)


def test_row_conv_matches_jax():
    rng = np.random.RandomState(5)
    x, w = _rand(rng, 3, 7, 5), _rand(rng, 3, 5)
    _check(jconv.row_conv, tconv.row_conv, [x, w], False)


@pytest.mark.parametrize("block,stride,padding", [
    ((2, 3), (1, 2), (0, 1)), ((3, 3), (2, 2), (1, 1))])
def test_block_expand_matches_jax(block, stride, padding):
    """The features of a block come in (C, bh, bw) order in both:
    ``lax.conv_general_dilated_patches``'s and ``F.unfold``'s."""
    rng = np.random.RandomState(6)
    x = _rand(rng, 2, 7, 8, 3)
    _check(lambda a: jconv.block_expand(a, block, stride, padding),
           lambda a: tconv.block_expand(a, block, stride, padding), [x],
           False)


def test_conv2d_hands_the_conv_channels_last_operands(monkeypatch):
    """The NCHW view of an NHWC map is a channels-last tensor, passed on
    with no copy; the output's NHWC view is contiguous."""
    seen = []
    real = F.conv2d

    def spy(x, w, *a, **k):
        seen.append((x.is_contiguous(memory_format=torch.channels_last),
                     w.is_contiguous(memory_format=torch.channels_last)))
        return real(x, w, *a, **k)

    monkeypatch.setattr(tconv.F, "conv2d", spy)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(_rand(rng, 2, 8, 8, 16))
    with bf16_policy(False):
        y = tconv.conv2d(x, torch.from_numpy(_rand(rng, 3, 3, 16, 32)),
                         padding=1)
    assert seen == [(True, True)]
    assert y.is_contiguous()


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

POOL_CASES = {"2x2": (2, 2, 0), "3s2p1": (3, 2, 1), "3s1p1": (3, 1, 1),
              "3s2": (3, 2, 0)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_max_pool2d_matches_jax(case, bf16):
    k, s, p = POOL_CASES[case]
    x = _rand(np.random.RandomState(8), 2, 9, 10, 3)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    _check(lambda a: jpool.max_pool2d(a.astype(dt), k, s, p),
           lambda a: tpool.max_pool2d(a.to(tdt), k, s, p), [x], bf16)


def test_max_pool2d_with_padding_beyond_half_a_window():
    x = _rand(np.random.RandomState(9), 1, 5, 5, 2)
    _check(lambda a: jpool.max_pool2d(a, 2, 1, 2),
           lambda a: tpool.max_pool2d(a, 2, 1, 2), [x], False)


def test_max_pool2d_gradient_goes_to_the_first_maximum_of_tied_windows():
    """Overlapping windows over a map of few distinct values: each
    window's gradient goes to its first maximum, in XLA and in torch."""
    rng = np.random.RandomState(10)
    x = rng.randint(0, 3, size=(2, 8, 8, 3)).astype(np.float32)
    jy, ty, jg, tg = _both(lambda a: jpool.max_pool2d(a, 3, 2, 1),
                           lambda a: tpool.max_pool2d(a, 3, 2, 1), [x])
    np.testing.assert_array_equal(_np32(ty), _np32(jy))
    np.testing.assert_array_equal(_np32(tg[0]), _np32(jg[0]))


@pytest.mark.parametrize("exclude", [True, False])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_avg_pool2d_matches_jax(case, bf16, exclude):
    k, s, p = POOL_CASES[case]
    x = _rand(np.random.RandomState(11), 2, 9, 10, 3)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    _check(lambda a: jpool.avg_pool2d(a.astype(dt), k, s, p,
                                      exclude_padding=exclude),
           lambda a: tpool.avg_pool2d(a.to(tdt), k, s, p,
                                      exclude_padding=exclude), [x], bf16)


def test_max_pool2d_with_index_and_unpool2d_match_jax():
    x = _rand(np.random.RandomState(12), 2, 8, 9, 3)
    jv, ji = jpool.max_pool2d_with_index(jnp.asarray(x), 3, 2, 1)
    tv, ti = tpool.max_pool2d_with_index(torch.from_numpy(x), 3, 2, 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _check(lambda v: jpool.unpool2d(v, ji, (8, 9)),
           lambda v: tpool.unpool2d(v, ti, (8, 9)), [np.asarray(jv)], False)


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_spatial_pyramid_pool_matches_jax(pool_type):
    x = _rand(np.random.RandomState(13), 2, 7, 5, 3)
    _check(lambda a: jpool.spatial_pyramid_pool(a, 3, pool_type),
           lambda a: tpool.spatial_pyramid_pool(a, 3, pool_type), [x],
           False)


def test_maxout_matches_jax():
    x = _rand(np.random.RandomState(14), 2, 4, 5, 6)
    _check(lambda a: jpool.maxout(a, 3), lambda a: tpool.maxout(a, 3), [x],
           False)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
@pytest.mark.parametrize("shape", [(4, 4, 4, 5), (32, 6)],
                         ids=["nhwc", "rows"])
def test_batch_norm_matches_jax(shape, mode, bf16):
    """Values, gradients (x, gamma, beta) and the new moving statistics;
    every channel's statistics run over 32 values (BN amplifies rounding
    when they run over few)."""
    rng = np.random.RandomState(15)
    c = shape[-1]
    x = _rand(rng, *shape) * 2.0 + 0.5
    gamma, beta = _rand(rng, c) + 1.0, _rand(rng, c)
    mm, mv = _rand(rng, c) * 0.1, np.abs(_rand(rng, c)) + 0.5
    kw = dict(train=mode != "eval", momentum=0.9,
              use_global_stats=mode == "global_stats" or None)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32

    def jfn(a, g, b):
        return jnorm.batch_norm(a.astype(dt), g, b, jnp.asarray(mm),
                                jnp.asarray(mv), **kw)[0]

    def tfn(a, g, b):
        return tnorm.batch_norm(a.to(tdt), g, b, torch.from_numpy(mm),
                                torch.from_numpy(mv), **kw)[0]

    _check(jfn, tfn, [x, gamma, beta], bf16)
    _, jm, jv = jnorm.batch_norm(jnp.asarray(x).astype(dt), gamma, beta,
                                 jnp.asarray(mm), jnp.asarray(mv), **kw)
    _, tm, tv = tnorm.batch_norm(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(gamma),
                                 torch.from_numpy(beta),
                                 torch.from_numpy(mm), torch.from_numpy(mv),
                                 **kw)
    for t, j in ((tm, jm), (tv, jv)):
        assert t.dtype == torch.float32
        assert_close(t, j, False, "moving statistics")


def test_batch_norm_leaves_the_moving_statistics_it_was_given():
    rng = np.random.RandomState(16)
    mm, mv = torch.zeros(3), torch.ones(3)
    _, nm, nv = tnorm.batch_norm(torch.from_numpy(_rand(rng, 8, 3)),
                                 torch.ones(3), torch.zeros(3), mm, mv,
                                 train=True)
    assert torch.equal(mm, torch.zeros(3)) and torch.equal(mv, torch.ones(3))
    assert not torch.equal(nm, mm) and not torch.equal(nv, mv)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("size", [5, 4])
def test_cross_map_norm_matches_jax(size, bf16):
    x = _rand(np.random.RandomState(17), 2, 3, 4, 7) * 3.0
    dt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    _check(lambda a: jnorm.cross_map_norm(a.astype(dt), size, 1e-2, 0.75),
           lambda a: tnorm.cross_map_norm(a.to(tdt), size, 1e-2, 0.75), [x],
           bf16)


@pytest.mark.parametrize("size", [5, 4])
def test_cross_map_norm_is_local_response_norm_at_alpha_scale_times_size(
        size):
    """``F.local_response_norm`` divides its window sum by the window
    (``alpha / n``) and adds ``k``: with ``alpha = scale * size`` and
    ``k = 1`` it computes the same function, on the channels of the
    NCHW view."""
    x = torch.from_numpy(_rand(np.random.RandomState(18), 2, 3, 4, 7) * 3)
    want = F.local_response_norm(x.permute(0, 3, 1, 2), size,
                                 alpha=1e-2 * size, beta=0.75, k=1.0)
    got = tnorm.cross_map_norm(x, size, 1e-2, 0.75)
    assert_close(got, want.permute(0, 2, 3, 1), False)


def test_sum_to_one_and_row_l2_norm_match_jax():
    x = np.abs(_rand(np.random.RandomState(19), 5, 6)) + 0.1
    _check(jnorm.sum_to_one_norm, tnorm.sum_to_one_norm, [x], False)
    _check(jnorm.row_l2_norm, tnorm.row_l2_norm, [x], False)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("rate", [0.5, 0.4])
def test_dropout_keeps_at_its_rate_and_scales_the_kept(rate):
    x = torch.ones(200, 500)
    y = tmath.dropout(x, rate, _gen(0), train=True)
    keep = 1.0 - rate
    kept = y != 0
    n = x.numel()
    assert abs(kept.sum().item() - keep * n) <= 4 * np.sqrt(
        n * keep * rate)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / keep))


def test_dropout_is_the_identity_when_off():
    x = torch.randn(4, 5, generator=_gen(1))
    assert tmath.dropout(x, 0.5, _gen(0), train=False) is x
    assert tmath.dropout(x, 0.0, _gen(0), train=True) is x


def test_dropout_mask_follows_the_generator_seed():
    x = torch.randn(64, 64, generator=_gen(2)).to(torch.bfloat16)
    a = tmath.dropout(x, 0.5, _gen(3), train=True)
    b = tmath.dropout(x, 0.5, _gen(3), train=True)
    c = tmath.dropout(x, 0.5, _gen(4), train=True)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b) and not torch.equal(a != 0, c != 0)
