"""The port's measurement tooling on the CPU: the shared serve workload of
``chip_smoke.py`` and ``profile_serve`` (at a narrow width, same prompts,
same engine settings), and ``chip_smoke``'s roofline bounds (the ragged
kernel's, and the flash kernels' over the live pairs of the training
workload's cases).  Nothing
here is compared with the JAX package: these are the scripts' own
contracts (the workload drains with a prefix-cache hit; the bound counts
real rows only and prices each product at its operand type's rate)."""

import sys
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import decoder_lm_from_numpy, init_numpy_params
from paddle_tpu_torch.serving import DecoderLM
from paddle_tpu_torch.tools import serve_workload as sw
from paddle_tpu_torch.tools import train_workload as tw

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_serve_workload_drains_with_prefix_hit():
    # the workload's prompts at the published vocab and positions, on a
    # one-layer model 32 wide so the CPU run stays short
    model = DecoderLM(vocab_size=sw.MODEL["vocab_size"], num_layers=1,
                      num_heads=2, head_dim=16,
                      max_positions=sw.MODEL["max_positions"], device="cpu")
    decoder_lm_from_numpy(init_numpy_params(model, sw.SEED), model)
    eng = sw.make_engine(model, "cpu")
    wl = sw.Workload(eng)
    saw_prefill_done = False
    while not wl.done:
        wl.step()
        saw_prefill_done |= wl.prefill_done
    assert saw_prefill_done and wl.sharer_in
    assert len(wl.rids) == len(wl.prompts) == 8
    assert all(len(eng.result(r)) == sw.NEW_TOKENS for r in wl.rids)
    assert eng.cache.hits >= 1
    assert eng.metrics.prefill_tokens_saved >= sw.PREFIX_LEN
    eng.check_page_conservation()


def _tiny_case(page_dtype):
    # one 8-row block: 3 real prefill-chunk rows over a 5-token
    # sequence, 5 padded rows
    h, d, page = 2, 8, 4
    qpos = torch.tensor([2, 3, 4, -1, -1, -1, -1, -1], dtype=torch.int32)
    return dict(q=torch.zeros(8, h, d), page_table=torch.tensor([[1, 2]],
                dtype=torch.int32),
                k_pages=torch.zeros(3, page, h, d, dtype=page_dtype),
                v_pages=torch.zeros(3, page, h, d, dtype=page_dtype),
                kv_lens=torch.tensor([5], dtype=torch.int32),
                row_seq=torch.zeros(8, dtype=torch.int32), qpos=qpos)


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16])
def test_chip_smoke_roofline_counts_real_rows_and_operand_rates(page_dtype):
    case = _tiny_case(page_dtype)
    got = chip_smoke.roofline(case)
    h, d = 2, 8
    live = 3 + 4 + 5                            # tokens <= qpos per row
    kv_bytes = 2 * 5 * h * d * case["k_pages"].element_size()
    qo_bytes = 2 * 3 * h * d * 4                 # real rows only
    idx_bytes = 4 * (2 + 1 + 8 + 8)
    assert got["bytes"] == kv_bytes + qo_bytes + idx_bytes
    half = 2.0 * live * h * d
    pv_rate = chip_smoke.BF16_FLOPS_PER_S if page_dtype == torch.bfloat16 \
        else chip_smoke.F32_FLOPS_PER_S
    np.testing.assert_allclose(
        got["ops_ms"], 1e3 * (half / chip_smoke.F32_FLOPS_PER_S +
                              half / pv_rate), rtol=1e-12)
    assert got["bound_ms"] == max(got["ops_ms"], got["bytes_ms"])
    assert got["bound_by"] == ("bytes" if got["bytes_ms"] >= got["ops_ms"]
                               else "operations")


def test_flash_bound_counts_live_pairs_at_operand_rate():
    """The training case's bound: 8 causal segments of 1024 keep
    8 x 1024 x 1025 / 2 pairs a head; the forward reads q, k, v and writes
    O (bf16) and lse, and is bound by bytes, the backward kernels by
    bf16 operations."""
    case = tw.flash_case("a_bf16_8x1024_causal", "cpu")
    pairs = 8 * 1024 * 1025 // 2 * 16
    elems = 8192 * 16 * 128
    fwd = chip_smoke.flash_bound(case, "flash_fwd")
    assert fwd["live_pairs"] == pairs
    assert fwd["flops"] == 4 * pairs * 128
    assert fwd["bytes"] == 4 * elems * 2 + 4 * 16 * 8192 + 4 * 2 * 8192
    assert fwd["bound_by"] == "bytes"
    for name, mults in (("flash_bwd_kv", 8), ("flash_bwd_dq", 6)):
        got = chip_smoke.flash_bound(case, name)
        assert got["flops"] == mults * pairs * 128
        assert got["bound_by"] == "operations"
        np.testing.assert_allclose(
            got["bound_ms"], 1e3 * got["flops"] / chip_smoke.BF16_FLOPS_PER_S,
            rtol=1e-12)


def test_live_pairs_of_cross_and_padded_segments():
    seg = tw.packed_segments((3, 2), 8)            # ids 0 0 0 1 1 2 2 2
    assert seg.tolist() == [[0, 0, 0, 1, 1, 2, 2, 2]]
    assert tw.live_pairs(seg, seg, causal=True) == 6 + 3 + 6
    assert tw.live_pairs(seg, seg, causal=False) == 9 + 4 + 9
    q, k = np.zeros((1, 4), np.int32), np.zeros((1, 6), np.int32)
    assert tw.live_pairs(q, k, causal=True) == 1 + 2 + 3 + 4
    assert tw.live_pairs(q, k, causal=False) == 24
