"""The parallel slice on the card, in a one-rank NCCL process group
(NCCL refuses two ranks on one device; several ranks are the CPU gloo
tests' ``tests/test_torch_parallel_*.py``).

- the headline transformer's width at 2 blocks from one set of weights:
  ``SGD(mesh=data_parallel_mesh(), zero=1)`` equal to the bit to the
  no-mesh run (every collective on one rank is an identity), and
  ``SGD(pipeline=PipelineConfig(microbatches=4))`` within 1e-3 of its
  costs and 2e-2 of its update in norm (the schedule's padded
  microbatches: the products and bf16 attention inputs are tiled
  otherwise), the flash kernels B1-B3 launched a block a step (a block a
  microbatch a step in the pipeline);
- the expert-parallel MoE layer on an ``expert`` axis of one rank (its
  all-to-alls on NCCL) against the dense path, f32, 1e-5;
- ring and Ulysses attention on a ``seq`` axis of one rank against the
  flash kernels on the whole sequence (Ulysses runs them), bf16 inputs:
  one bf16 step;
- the 2-layer, d 128, 4-expert MoE LM's step on the card against the CPU
  path (cost 1e-4 relative, each weight's update 1e-3).

Every test needs a CUDA device and skips without one.  The file imports
neither ``jax`` nor ``paddle_tpu``::

    python -m pytest tests/test_torch_parallel_cuda.py -q --noconftest
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest
import torch

from paddle_tpu_torch.tools import parallel_workload as pw

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA device: the flash kernels have no CPU mode")]


@pytest.fixture(scope="module")
def world1():
    with pw.nccl_world1():
        yield


def test_headline_under_dp_zero_and_the_pipeline(world1):
    runs = pw.headline_runs(torch.device("cuda"), n_layers=2)
    assert runs["dp_zero1"]["costs"] == runs["no_mesh"]["costs"]
    assert runs["dp_zero1"]["param_rel_diff_max"] == 0.0
    assert runs["pipeline"]["cost_rel_diff"] <= 1e-3
    assert runs["pipeline"]["param_rel_diff_max"] <= 2e-2
    n = 2 * pw.WORLD1_STEPS
    for name, want in (("no_mesh", n), ("dp_zero1", n),
                       ("pipeline", n * pw.WORLD1_MICROBATCHES)):
        assert set(runs[name]["launches"].values()) == {want}, name


def test_moe_layer_on_an_expert_axis_of_one(world1):
    res = pw.moe_layer_world1(torch.device("cuda"), tokens=1024, d=256)
    assert res["max_rel_err"] <= 1e-5, res


def test_ring_and_ulysses_on_a_seq_axis_of_one(world1):
    from paddle_tpu_torch.ops.attention import flash_attention
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel.ring import (ring_attention,
                                                ulysses_attention)

    mesh = make_mesh((1,), ("seq",))
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 256, 4, 64, device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    seg = torch.zeros(2, 256, dtype=torch.int32, device="cuda")
    seg[:, 100:] = 1
    want = flash_attention(q, k, v, segment_ids=seg, causal=True).float()
    for fn in (ring_attention, ulysses_attention):
        got = fn(q, k, v, mesh, axis="seq", segment_ids=seg,
                 causal=True).float()
        err = float((got - want).abs().max())
        assert err <= 2 ** -7 * float(want.abs().max()) + 2e-3, \
            (fn.__name__, err)


def test_moe_lm_step_card_against_cpu():
    res = pw.moe_parity_step(torch.device("cuda"))
    assert res["cost_rel_diff"] <= 1e-4, res
    assert res["update_rel_diff_max"] <= 1e-3, res
