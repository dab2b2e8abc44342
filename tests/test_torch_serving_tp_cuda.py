"""Tensor-parallel serving on the card.

- the ragged kernel (B4) on one rank's head shard of the headline pool
  (8 of 16 query heads against 8 of 16 KV heads, page 128, 8 pages a
  sequence, the mixed prefill + decode step) through
  ``ragged_paged_attention_tp``, f32, bf16 and int8 pages, against its
  plain version at ``tools/ragged_cases.py``'s tolerances; a stack that
  is not whole blocks of rows raises;
- two ranks on this card joined by gloo (``start_ranks(device="cuda")``:
  NCCL takes one rank a card) serving the serve
  workload's requests at a narrow width (d 256, 2 layers) at tp 2: the
  ranks' tokens equal, equal to the CPU engine's without a mesh on the
  same weights (a difference only at a near tie of the CPU reference),
  B4 launched 2 layers x steps on each rank, 2 x 2 all-reduces a step
  with their bytes equal to ``tp_step_comm_bytes``.

Every test needs a CUDA device and skips without one.  The file imports
neither ``jax`` nor ``paddle_tpu``::

    python -m pytest tests/test_torch_serving_tp_cuda.py -q --noconftest
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import ragged_cases as rc

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA device: the ragged kernel has no CPU mode")]

NARROW = dict(vocab_size=32768, num_layers=2, num_heads=2, head_dim=128,
              ffn_mult=4, max_positions=1024)
TIE_RTOL = 1e-3


def _shard(case, tp=2, rank=0):
    h = case["q"].shape[1] // tp
    kvh = case["k_pages"].shape[2] // tp
    out = dict(case)
    out["q"] = case["q"][:, rank * h:(rank + 1) * h].contiguous()
    for k in ("k_pages", "v_pages"):
        out[k] = case[k][:, :, rank * kvh:(rank + 1) * kvh].contiguous()
    for k in ("k_scale", "v_scale"):
        if k in case:
            out[k] = case[k][:, :, rank * kvh:(rank + 1) * kvh].contiguous()
    return out


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("rank", [0, 1])
def test_b4_on_a_head_shard_of_the_headline_pool(pages, rank):
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.serving.decode_attention import \
        ragged_paged_attention_tp

    dev = torch.device("cuda")
    base = rc.build_case(np.random.default_rng(rc.SEED), rc.MIXED_SEQS,
                         rc.H, dev)
    case = _shard(rc.with_types(base, pages), rank=rank)
    mesh = make_mesh((1,), ("model",))
    got = ragged_paged_attention_tp(mesh, "model", *rc.args(case),
                                    **rc.scales(case))
    res = rc.check(case, got)
    assert res["within_tolerance"], res
    with pytest.raises(Exception, match="whole blocks"):
        ragged_paged_attention_tp(mesh, "model", case["q"][:-1],
                                  *rc.args(case)[1:5],
                                  case["row_seq"][:-1], case["qpos"][:-1],
                                  **rc.scales(case))


def test_two_ranks_on_the_card_serve_as_the_cpu():
    from paddle_tpu_torch.convert import decoder_lm_from_numpy, \
        init_numpy_params
    from paddle_tpu_torch.platform.virtual import start_ranks
    from paddle_tpu_torch.serving import DecoderLM
    from paddle_tpu_torch.tools import serve_workload as sw
    from paddle_tpu_torch.tools import tp_workload as tpw

    run = start_ranks("paddle_tpu_torch.tools.tp_workload:serve_tp_rank", 2,
                      {"model_cfg": NARROW}, device="cuda",
                      timeout=600)
    model = DecoderLM(**NARROW, device="cpu")
    decoder_lm_from_numpy(init_numpy_params(model, sw.SEED), model)
    eng = sw.make_engine(model, "cpu")
    wl = sw.Workload(eng)
    while not wl.done:
        wl.step()
    want = [eng.result(r) for r in wl.rids]
    ranks = run.wait()
    assert ranks[0]["outputs"] == ranks[1]["outputs"]
    for i, got in enumerate(ranks[0]["outputs"]):
        if got != want[i]:
            rep = tpw.replay_parting(model, wl.prompts[i], got, want[i])
            assert rep["picks_are_top2"] and \
                rep["top2_gap"] < TIE_RTOL * abs(rep["top_logit"]), rep
    for r in ranks:
        assert r["kernel_launches"] == r["launches_expected"] > 0
        assert set(r["allreduce_calls"]) == {2 * NARROW["num_layers"]}
        assert r["comm_matches_closed_form"]
        assert r["conservation"] and r["drained"]
        assert r["kernel_check"]["within_tolerance"], r["kernel_check"]
