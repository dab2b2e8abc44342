"""The resilience slice on the card: the headline transformer's width at
2 blocks (d 2048, 16 heads, vocab 32768, 8 x 1024 tokens, the flash
kernels B1-B3 on every step) killed mid-pass and resumed from an async
checkpoint, bit-identical to its uninterrupted control
(``tools/resilience_workload.resume_run``): every parameter and Momentum
slot ``torch.equal``, the costs per (pass, batch) equal, the NaN step
skipped with every tensor left as it was, one restart from the step-3
checkpoint, each flash kernel launched 2 x the steps run.  Then the
guarded step reads its verdict once a step on the card, and the seeded
chaos replay and the elastic run hold on the card.

Every test needs a CUDA device and skips without one (the flash kernels
have no CPU mode).  The file imports neither ``jax`` nor
``paddle_tpu``::

    python -m pytest tests/test_torch_resilience_cuda.py -q --noconftest
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest
import torch

from paddle_tpu_torch.tools import resilience_workload as resw

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA device: the flash kernels have no CPU mode")]


def test_resume_is_bit_identical_at_two_blocks_of_the_headline_width():
    dev = torch.device("cuda")
    r = resw.resume_run(dev, n_layers=2)
    init = r.pop("init")
    assert r["problems"] == []
    assert r["restarts"] == 1 and r["steps_run"] == 11
    assert r["left_in_save_dir"] == ["pass-00000", "pass-00001"]
    timing = resw.step_ms(dev, init, n_layers=2)
    assert timing["verdict_reads"] == {
        "unguarded": 0, "guarded": resw.TIMED_STEPS * resw.TIMED_WINDOWS}


def test_chaos_replay_and_elastic_run_hold_on_the_card():
    dev = torch.device("cuda")
    assert resw.chaos_run(dev)["problems"] == []
    assert resw.elastic_run(dev)["problems"] == []
