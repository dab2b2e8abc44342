"""The port's image path on the card against its plain CPU path.

Every image op (``ops/conv.py``, ``ops/pool.py``, ``ops/norm.py``, and
dropout on a CUDA generator) runs on ``cuda`` and on the CPU on the same
inputs, values and every input's gradient compared; a ResNet-18 step on
``cuda`` hands cuDNN channels-last maps and weights (a spy on the conv
and batch-norm calls checks the strides) and keeps the maps NHWC; and an
image entry point called with ``device=None`` runs on the card, or raises
where there is none (that test runs on the CPU too).

The card tests need a CUDA device and skip without one.  The file imports
neither ``jax`` nor ``paddle_tpu``; on a machine without JAX run it
without the repository's ``conftest.py``::

    python -m pytest tests/test_torch_image_cuda.py -q --noconftest

Tolerances: f32 (TF32 off) 1e-4 of the tensor's largest magnitude, the
card's convolution algorithms summing in other orders; bf16 within 2 ** -7
of the value plus 1e-2 of the tensor's largest (both round each output
and gradient to bf16, and an f32 sum in another order can cross a
rounding step).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import math as tmath
from paddle_tpu_torch.ops import norm as tnorm
from paddle_tpu_torch.ops import pool as tpool
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.tools import image_workload as iw

F32_TOL = 1e-4
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=[False, True], ids=["f32", "bf16"])
def bf16(request):
    old = (FLAGS.use_bf16, FLAGS.bf16_activations)
    FLAGS.use_bf16 = FLAGS.bf16_activations = request.param
    yield request.param
    FLAGS.use_bf16, FLAGS.bf16_activations = old


def assert_close(got, want, bf16: bool, what=""):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert got.shape == want.shape, what
    finite = torch.isfinite(want)
    a, b = got[~finite], want[~finite]
    assert bool(((a == b) | (a.isnan() & b.isnan())).all()), what
    got, want = got[finite], want[finite]
    scale = want.abs().max().item() if want.numel() else 1.0
    scale = scale or 1.0
    bound = (BF16_REL * want.abs() + BF16_ABS * scale) if bf16 \
        else torch.full_like(want, F32_TOL * scale)
    err = (got - want).abs()
    assert bool((err <= bound).all()), (what, err.max().item(), scale)


def _card_vs_cpu(fn, arrays, dev, bf16=False, seed=7):
    """``fn`` on the card and on the CPU: outputs and the gradients of
    every float input under one cotangent."""
    outs = []
    for d in (dev, torch.device("cpu")):
        args = [torch.tensor(a, device=d,
                             requires_grad=a.dtype == np.float32)
                for a in arrays]
        y = fn(*args)
        cot = torch.from_numpy(np.random.RandomState(seed).randn(
            *y.shape).astype(np.float32)).to(d, y.dtype)
        diff = [a for a in args if a.requires_grad]
        outs.append((y, torch.autograd.grad(y, diff, cot)))
    (yc, gc), (yh, gh) = outs
    assert yc.is_cuda and yc.dtype == yh.dtype
    assert_close(yc, yh, bf16, "output")
    for i, (a, b) in enumerate(zip(gc, gh)):
        assert_close(a, b, bf16, f"grad {i}")


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


CONV_CASES = {
    "plain": ((2, 9, 9, 8), (3, 3, 8, 16), dict()),
    "stride2_pad": ((2, 10, 11, 3), (3, 3, 3, 8), dict(stride=2,
                                                      padding=1)),
    "groups": ((2, 8, 8, 6), (3, 3, 2, 9), dict(groups=3, padding=1)),
    "dilation": ((1, 12, 12, 4), (3, 3, 4, 5), dict(dilation=2,
                                                   padding=2)),
    "stem": ((2, 32, 32, 3), (7, 7, 3, 64), dict(stride=2, padding=3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_card_matches_cpu(cuda, case, bf16):
    xs, ws, kw = CONV_CASES[case]
    rng = np.random.RandomState(0)
    _card_vs_cpu(lambda a, b: tconv.conv2d(a, b, **kw),
                 [_rand(rng, *xs), _rand(rng, *ws, scale=0.3)], cuda, bf16)


@pytest.mark.cuda
def test_other_convs_card_match_cpu(cuda, bf16):
    rng = np.random.RandomState(1)
    _card_vs_cpu(lambda a, b: tconv.conv2d_transpose(a, b, stride=2,
                                                     padding=1),
                 [_rand(rng, 2, 5, 6, 3), _rand(rng, 3, 3, 3, 4, scale=0.3)],
                 cuda, bf16)
    _card_vs_cpu(lambda a, b: tconv.depthwise_conv2d(a, b, stride=2,
                                                     padding=1),
                 [_rand(rng, 2, 8, 8, 4), _rand(rng, 3, 3, 4, 2, scale=0.3)],
                 cuda, bf16)
    _card_vs_cpu(lambda a, b: tconv.conv3d(a, b, stride=(1, 2, 2),
                                           padding=1),
                 [_rand(rng, 2, 5, 6, 6, 3),
                  _rand(rng, 3, 3, 3, 3, 4, scale=0.3)], cuda, bf16)


@pytest.mark.cuda
def test_row_conv_and_block_expand_card_match_cpu(cuda):
    rng = np.random.RandomState(2)
    _card_vs_cpu(tconv.row_conv, [_rand(rng, 3, 7, 5), _rand(rng, 3, 5)],
                 cuda)
    _card_vs_cpu(lambda a: tconv.block_expand(a, (3, 3), (2, 2), (1, 1)),
                 [_rand(rng, 2, 7, 8, 3)], cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1), (3, 1, 1)])
def test_pools_card_match_cpu(cuda, bf16, k, s, p):
    x = _rand(np.random.RandomState(3), 2, 9, 10, 16)
    dt = torch.bfloat16 if bf16 else torch.float32
    _card_vs_cpu(lambda a: tpool.max_pool2d(a.to(dt), k, s, p), [x], cuda,
                 bf16)
    for exclude in (True, False):
        _card_vs_cpu(lambda a: tpool.avg_pool2d(a.to(dt), k, s, p,
                                                exclude_padding=exclude),
                     [x], cuda, bf16)


@pytest.mark.cuda
def test_max_pool_ties_and_index_ops_card_match_cpu(cuda):
    rng = np.random.RandomState(4)
    ties = rng.randint(0, 3, size=(2, 8, 8, 3)).astype(np.float32)
    _card_vs_cpu(lambda a: tpool.max_pool2d(a, 3, 2, 1), [ties], cuda)
    x = _rand(rng, 2, 8, 9, 3)
    vc, ic = tpool.max_pool2d_with_index(torch.from_numpy(x).to(cuda), 3, 2,
                                         1)
    vh, ih = tpool.max_pool2d_with_index(torch.from_numpy(x), 3, 2, 1)
    assert torch.equal(vc.cpu(), vh) and torch.equal(ic.cpu(), ih)
    _card_vs_cpu(lambda v: tpool.unpool2d(v, ih.to(v.device), (8, 9)),
                 [vh.numpy()], cuda)
    for kind in ("max", "avg"):
        _card_vs_cpu(lambda a: tpool.spatial_pyramid_pool(a, 3, kind),
                     [_rand(rng, 2, 7, 5, 3)], cuda)
    _card_vs_cpu(lambda a: tpool.maxout(a, 3), [_rand(rng, 2, 4, 5, 6)],
                 cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "eval", "global_stats"])
def test_batch_norm_card_matches_cpu(cuda, bf16, mode):
    """cuDNN's batch norm (handed copies of the moving statistics) against
    the JAX package's formula on the CPU: values, gradients of x, gamma
    and beta, and the new moving statistics."""
    rng = np.random.RandomState(5)
    x = _rand(rng, 8, 6, 6, 16) * 2.0 + 0.5
    gamma, beta = _rand(rng, 16) + 1.0, _rand(rng, 16)
    mm, mv = _rand(rng, 16) * 0.1, np.abs(_rand(rng, 16)) + 0.5
    kw = dict(train=mode != "eval", momentum=0.9,
              use_global_stats=mode == "global_stats" or None)
    dt = torch.bfloat16 if bf16 else torch.float32

    def fn(a, g, b):
        return tnorm.batch_norm(a.to(dt), g, b, torch.from_numpy(mm).to(
            a.device), torch.from_numpy(mv).to(a.device), **kw)[0]

    _card_vs_cpu(fn, [x, gamma, beta], cuda, bf16)
    stats = []
    for d in (cuda, torch.device("cpu")):
        mm_d, mv_d = torch.from_numpy(mm).to(d), torch.from_numpy(mv).to(d)
        _, nm, nv = tnorm.batch_norm(
            torch.from_numpy(x).to(d, dt), torch.from_numpy(gamma).to(d),
            torch.from_numpy(beta).to(d), mm_d, mv_d, **kw)
        assert torch.equal(mm_d.cpu(), torch.from_numpy(mm))
        stats.append((nm, nv))
    for a, b in zip(*stats):
        assert a.dtype == torch.float32
        assert_close(a, b, False, "moving statistics")


@pytest.mark.cuda
def test_cross_map_and_row_norms_card_match_cpu(cuda, bf16):
    rng = np.random.RandomState(6)
    dt = torch.bfloat16 if bf16 else torch.float32
    _card_vs_cpu(lambda a: tnorm.cross_map_norm(a.to(dt), 5, 1e-2, 0.75),
                 [_rand(rng, 2, 3, 4, 7) * 3.0], cuda, bf16)
    x = np.abs(_rand(rng, 5, 6)) + 0.1
    _card_vs_cpu(tnorm.sum_to_one_norm, [x], cuda)
    _card_vs_cpu(tnorm.row_l2_norm, [x], cuda)


@pytest.mark.cuda
def test_dropout_on_a_cuda_generator(cuda):
    x = torch.ones(256, 1024, device=cuda)
    gen = torch.Generator(device=cuda)
    a = tmath.dropout(x, 0.4, gen.manual_seed(3), train=True)
    b = tmath.dropout(x, 0.4, gen.manual_seed(3), train=True)
    assert a.is_cuda and torch.equal(a, b)
    kept = (a != 0).sum().item()
    n = x.numel()
    assert abs(kept - 0.6 * n) <= 4 * np.sqrt(n * 0.6 * 0.4)
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.6))


@pytest.mark.cuda
def test_resnet18_step_hands_cudnn_channels_last_tensors(cuda, monkeypatch):
    """Each of the 21 convs of a ResNet-18 step gets a channels-last input and
    weight, every batch norm a channels-last input, and each returns a
    tensor whose NHWC view is contiguous: no activation is transposed."""
    seen = {"conv": [], "bn": []}
    real_conv, real_bn = F.conv2d, F.batch_norm

    def cl(t):
        return t.is_contiguous(memory_format=torch.channels_last)

    def conv(x, w, *a, **k):
        y = real_conv(x, w, *a, **k)
        seen["conv"].append((cl(x), cl(w), cl(y)))
        return y

    def bn(x, *a, **k):
        y = real_bn(x, *a, **k)
        seen["bn"].append((cl(x), cl(y)))
        return y

    monkeypatch.setattr(tconv.F, "conv2d", conv)
    monkeypatch.setattr(tnorm.F, "batch_norm", bn)
    sgd = iw.build_trainer("resnet50", cuda, depth=18, img_size=64)
    feeds = iw.device_feeds("resnet50", cuda, batch=8, img=64)
    cost = sgd.step(feeds)
    assert torch.isfinite(cost)
    assert len(seen["conv"]) == 21 and len(seen["bn"]) == 21
    assert all(all(v) for v in seen["conv"]), seen["conv"]
    assert all(all(v) for v in seen["bn"]), seen["bn"]


def test_image_entry_point_runs_on_the_card_or_raises():
    """``device=None`` means the card: the trainer lands there, or, with
    no card, the call raises instead of running on the host."""
    if torch.cuda.is_available():
        sgd = iw.build_trainer("lenet", None)
        assert sgd.device.type == "cuda"
        assert all(p.is_cuda for p in sgd.parameters.as_dict().values())
    else:
        with pytest.raises(EnforceError, match="CUDA is not available"):
            iw.build_trainer("lenet", None)
