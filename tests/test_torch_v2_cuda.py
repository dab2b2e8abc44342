"""The ninth slice on the card: the optimizer suite (every rule with every
lever on LeNet), the evaluators and ``train(prefetch=)`` on the card
against the CPU path, and the prune-mask quantile on a tensor above 2^24
elements.  Widths are cut where ``chip_smoke.py`` runs the full ones.

The card tests need a CUDA device and skip without one; the others hold
the shared workloads on the CPU.  The file imports neither ``jax`` nor
``paddle_tpu``; on a machine without JAX run it without the repository's
``conftest.py``::

    python -m pytest tests/test_torch_v2_cuda.py -q --noconftest

Tolerances: f32 with TF32 off, as ``chip_smoke.py`` holds them
(``OPT_TENSOR_RTOL``, ``EVAL_RTOL``): every optimizer tensor within 1e-5
of the CPU path's, relative in norm, after 3 steps on the same gradients
(the CPU optimizer applies the card's: the update's arithmetic alone
differs; each side's own gradients part at ReLU, max-pool and sign(p)
ties, which the Adagrad family and Adam turn into full steps, so that
run is reported by ``chip_smoke.py`` and not held); every evaluator value
within 1e-6 relative; prefetch's costs bit for bit.
"""

import random

import numpy as np
import pytest
import torch

from paddle_tpu_torch import event, reader
from paddle_tpu_torch.attr import HookAttr
from paddle_tpu_torch.optimizer import quantile_f32
from paddle_tpu_torch.tools import nmt_workload as nw
from paddle_tpu_torch.tools import v2_loop_workload as vw

OPT_TENSOR_RTOL = 1e-5
EVAL_RTOL, EVAL_ATOL = 1e-6, 1e-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rule", sorted(vw.RULES))
def test_every_rule_with_every_lever_card_matches_cpu(cuda, rule):
    with nw.f32_policy():
        same = vw.state_errors(*vw.on_both(rule, cuda))
    assert max(same.values()) <= OPT_TENSOR_RTOL, same


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(vw.EVALUATOR_CASES))
def test_evaluator_card_matches_cpu(cuda, name):
    got, metric, text = vw.evaluate(name, cuda)
    want, want_metric, want_text = vw.evaluate(name, "cpu")
    np.testing.assert_allclose(got, want, rtol=EVAL_RTOL, atol=EVAL_ATOL)
    np.testing.assert_allclose(metric, want_metric, rtol=EVAL_RTOL,
                               atol=EVAL_ATOL)
    assert text == want_text


@pytest.mark.cuda
def test_prune_quantile_above_two_to_the_24_card_matches_cpu(cuda):
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(
        vw.BIG_PRUNE_SHAPE, dtype=np.float32)).abs()
    want = quantile_f32(t, 0.6)
    got = quantile_f32(t.to(cuda), 0.6).cpu()
    assert got.numpy().tobytes() == want.numpy().tobytes()


def _sentiment_costs(device, prefetch):
    with vw.offline():
        from paddle_tpu_torch.dataset import imdb

        word_dict = imdb.word_dict()
        train, _ = vw.sentiment_readers(word_dict)
        sgd = vw.sentiment_trainer(device, len(word_dict), hidden=64,
                                   embed_size=32)
    evs = []
    random.seed(1)
    sgd.train(reader.firstn(train, 4), num_passes=1, prefetch=prefetch,
              feeding=vw.SENTIMENT_FEEDING,
              event_handler=lambda ev: evs.append(ev) if isinstance(
                  ev, event.EndIteration) else None)
    return [ev.cost for ev in evs], [dict(ev.metrics) for ev in evs]


@pytest.mark.cuda
def test_prefetch_gives_the_same_cost_bits_on_the_card(cuda):
    c0, m0 = _sentiment_costs(cuda, 0)
    c2, m2 = _sentiment_costs(cuda, 2)
    assert c2 == c0 and m2 == m0 and len(c0) == 4


def test_lever_trainer_puts_the_levers_on_lenet():
    """The shared workload on the CPU: each lever lands on its tensor."""
    sgd, feeds = vw.lever_trainer("Momentum", "cpu")
    specs = sgd.topology.param_specs()
    assert specs["fc_0.w0"].attr.gradient_clipping_threshold == 1e-3
    assert isinstance(specs["fc_0.w0"].attr.update_hooks, HookAttr)
    assert specs["conv_0.w"].attr.l2_decay == 1e-2
    assert specs["conv_1.b"].attr.is_static
    assert specs["fc_1.w0"].attr.learning_rate == 2.0
    assert set(sgd.opt_state["prune_masks"]) == {"fc_0.w0"}
    b = sgd.parameters["conv_1.b"].clone()
    sgd.step(feeds)
    assert torch.equal(sgd.parameters["conv_1.b"], b)
    assert vw.grad_norm(sgd, feeds) > vw.LEVERS["gradient_clipping_threshold"]


def test_frame_log_records_the_feeders_buckets():
    log = vw.FrameLog()
    batches = [[([1] * 5, 0), ([2] * 17, 1)], [([3] * 100, 0)]]
    assert list(log.wrap(lambda: iter(batches))()) == batches
    assert log.frames == [32, 128]


def test_offline_refuses_downloads_and_restores():
    from paddle_tpu_torch.dataset import common

    saved = common.download
    with vw.offline():
        with pytest.raises(IOError, match="offline"):
            common.download("http://example.invalid/x", "x", "")
    assert common.download is saved
