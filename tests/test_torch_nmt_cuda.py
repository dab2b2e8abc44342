"""The attention seq2seq NMT on the card against the port's CPU path.

A training step on ``cuda`` (the encoder's GRUs through the one-launch
GRU step, B6) against the same step on the CPU from the same weights, and
a beam search on ``cuda`` against the CPU's on the same trained weights,
at a reduced width (dictionaries of 2000, word vectors and GRUs of 128;
``chip_smoke.py`` runs both at demo/seqToseq's width).  The entry points'
device default is checked on any machine.

The card tests need a CUDA device and skip without one.  The file imports
neither ``jax`` nor ``paddle_tpu``; on a machine without JAX run it
without the repository's ``conftest.py``::

    python -m pytest tests/test_torch_nmt_cuda.py -q --noconftest

Tolerances, f32 with TF32 off: the step's cost within 1e-4 relative and
each parameter's update (momentum SGD's first, -lr g) within 1e-3 in
norm, the two summing the same products in other orders; every step of
the card's beam search followed on the CPU path (``nmt_workload.Replay``):
the same choices, or others only within ``TIE_ATOL`` (1e-4) plus the f32
spacing of the totals, and the final scores within ``SCORE_RTOL``.

Without a card, the replay itself is held to a CPU run of the same
generator: it follows the run at every step with no choice apart, and it
flags a run whose recorded choice the model would not make.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import parameters_from_numpy
from paddle_tpu_torch.inference import Inference, infer
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.platform.flags import FLAGS
from paddle_tpu_torch.tools import nmt_workload as nw

SMALL = dict(src_dict_size=2000, trg_dict_size=2000, embed_size=128,
             hidden=128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B6 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_training_step_on_the_card_matches_the_cpu_path(cuda):
    batch = nw.samples(5, bs=8, min_len=10, max_len=20, dict_size=2000)
    res = nw.step_parity(cuda, batch, **SMALL)
    assert res["cost_rel_diff"] <= 1e-4, res
    assert res["update_max_rel_diff"] <= 1e-3, res
    assert res["b6_launches"] == 2 * res["source_frames"] == 64


@pytest.mark.cuda
def test_beam_search_on_the_card_matches_the_cpu_path(cuda):
    old = FLAGS.use_bf16
    FLAGS.use_bf16 = False
    try:
        sgd = nw.build_trainer(cuda, **SMALL)
        batch = nw.samples(6, bs=16, dict_size=2000)
        for _ in range(2):
            sgd.step(nw.feeds(sgd, batch))
        srcs = nw.sources(7, n=5, dict_size=2000)
        until = nw.eos_until("target_lengths", 7, n=5, dict_size=2000)
        before = nw.rw.launches()["gru_step"]
        ban = nw.EosBan(until)
        _, inf = nw.generator(sgd.parameters, sgd.model_state, cuda,
                              hooks={"candidate_adjust": ban},
                              max_length=100, **SMALL)
        run = ban.run(nw.generate(inf, srcs))
        assert nw.rw.launches()["gru_step"] - before == \
            2 * nw.source_frames(srcs)
        params = parameters_from_numpy(
            {k: v.detach().cpu().numpy() for k, v in sgd.parameters.items()},
            device="cpu")
        res = nw.replay(params, {}, srcs, until, run, max_length=100,
                        **SMALL)
    finally:
        FLAGS.use_bf16 = old
    tokens, lengths, scores = run[0]
    assert tokens.shape == (5, nw.BEAM, 100) and np.isfinite(scores).all()
    assert res["ok"] and res["steps_checked"] == len(run[1]) > 10, res
    assert res["max_gap"] < nw.TIE_ATOL, res


def test_nmt_entry_points_run_on_cuda_unless_asked(monkeypatch):
    """``Inference``, ``infer`` and the workload's trainer take ``cuda``
    when no device is given, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    beam = nw.build_generator(max_length=4, **dict(SMALL, hidden=8,
                                                   embed_size=8))
    with pytest.raises(EnforceError, match="device='cpu'"):
        Inference(beam, None)
    with pytest.raises(EnforceError, match="device='cpu'"):
        infer(beam, None, [([3, 4],)])
    with pytest.raises(EnforceError, match="device='cpu'"):
        nw.build_trainer(None, src_dict_size=20, trg_dict_size=20,
                         embed_size=8, hidden=8)


def _cpu_run(variant="target_lengths", max_length=24):
    """A small trained generator's recorded run on the CPU: (run, until,
    params, sources, the generator's config)."""
    cfg = dict(src_dict_size=50, trg_dict_size=50, embed_size=16, hidden=16)
    sgd = nw.build_trainer(torch.device("cpu"), update_equation=nw.optimizer
                           .Adam(learning_rate=0.05), **cfg)
    feeds = nw.feeds(sgd, nw.samples(2, bs=8, min_len=3, max_len=8,
                                     dict_size=50))
    for _ in range(8):          # <e> becomes the likeliest word
        sgd.step(feeds)
    kw = dict(n=4, min_len=3, max_len=8, dict_size=50)
    srcs = nw.sources(3, **kw)
    until = nw.eos_until(variant, 3, max_length=max_length, **kw)
    ban = nw.EosBan(until)
    _, inf = nw.generator(sgd.parameters, sgd.model_state, "cpu",
                          hooks={"candidate_adjust": ban},
                          max_length=max_length, **cfg)
    run = ban.run(nw.generate(inf, srcs))
    return run, until, sgd.parameters, srcs, dict(cfg, max_length=max_length)


@pytest.mark.parametrize("variant", nw.GENERATIONS)
def test_replay_follows_a_run_of_the_same_generator(variant):
    run, until, params, srcs, cfg = _cpu_run(variant)
    (tokens, lengths, scores), states, parents = run
    assert (lengths >= np.minimum(until + 1, cfg["max_length"])[:, None]
            ).all()
    assert parents.shape == (len(states),) + scores.shape
    res = nw.replay(params, {}, srcs, until, run, **cfg)
    assert res["ok"] and res["lost"] is None, res
    assert res["steps_checked"] == len(states)
    assert res["rows_apart"] == 0 and res["max_gap"] == 0.0
    assert res["paths_equal"] and res["score_rel_diff"] == 0.0


def test_replay_flags_a_choice_the_model_would_not_make():
    run, until, params, srcs, cfg = _cpu_run()
    outputs, states, parents = run
    # step 2's choice as the run recorded it: row 0's best beam now holds
    # another word at the same score, a word the model scores apart
    toks, sc, fin, ln = (x.copy() for x in states[3])
    toks[0, 0] = 3 if toks[0, 0] != 3 else 4
    states = states[:3] + [(toks, sc, fin, ln)] + states[4:]
    res = nw.replay(params, {}, srcs, until, (outputs, states, parents),
                    **cfg)
    assert not res["ok"] and res["max_over_limit"] > 1.0, res


def test_replay_at_the_bf16_limit_flags_weights_changed_by_a_thousandth():
    """``BF16_ATOL`` is loose enough for the bf16 policy's rounding and
    still tells apart weights 0.1% away from the run's."""
    run, until, params, srcs, cfg = _cpu_run("eos_banned")
    rng = np.random.RandomState(0)
    moved = parameters_from_numpy(
        {k: (v.detach().numpy() *
             (1 + 1e-3 * rng.standard_normal(v.shape))).astype(np.float32)
         for k, v in params.items()}, device="cpu")
    res = nw.replay(moved, {}, srcs, until, run, atol=nw.BF16_ATOL, **cfg)
    assert not res["ok"] and res["max_over_limit"] > 1.0, res


class _Halves(nw.EosBan):
    """Log-probabilities rounded to halves: beams of one token and one
    total from different parents, as a collapsed model makes them."""

    def ban(self, logp, t):
        return torch.round(super().ban(logp, t) * 2) / 2


class _HalvesReplay(_Halves, nw.Replay):
    pass


def test_replay_follows_a_run_full_of_exact_ties():
    run, until, params, srcs, cfg = _cpu_run()
    ban = _Halves(until)
    _, inf = nw.generator(params, {}, "cpu", hooks={"candidate_adjust": ban},
                          **cfg)
    run = ban.run(nw.generate(inf, srcs))
    (tokens, lengths, scores), states, parents = run
    ties = sum(int(len({(int(a), float(b)) for a, b in zip(tk[r], sc[r])}) <
                   tk.shape[1])
               for tk, sc, _, _ in states[1:] for r in range(tk.shape[0]))
    assert ties > 0
    follow = _HalvesReplay(until, run)
    _, inf = nw.generator(params, {}, "cpu",
                          hooks={"candidate_adjust": follow}, **cfg)
    res = follow.report(nw.generate(inf, srcs))
    assert res["ok"] and res["paths_equal"], res
