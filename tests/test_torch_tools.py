"""The port's measurement tooling on the CPU: the shared serve workload of
``chip_smoke.py`` and ``profile_serve`` (at a narrow width, same prompts,
same engine settings), ``chip_smoke``'s roofline bounds (the ragged
kernel's, and the flash kernels' over the live pairs of the training
workload's cases) and its choice of each kernel's ptxas entry, and the
comparison tools' choice of an earlier tree's entries and of B5's
ablation variants.  Nothing here is compared with the JAX package: these
are the scripts' own contracts (the workload drains with a prefix-cache
hit; the bound counts real rows only and prices each product at its
operand type's rate)."""

import sys
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import decoder_lm_from_numpy, init_numpy_params
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.serving import DecoderLM
from paddle_tpu_torch.tools import compare_flash, compare_ragged, compare_rnn
from paddle_tpu_torch.tools import ragged_cases as rc
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


def _tiny_case(page_dtype, q_dtype=torch.float32):
    # one 8-row block: 3 real prefill-chunk rows over a 5-token
    # sequence, 5 padded rows
    h, d, page = 2, 8, 4
    qpos = torch.tensor([2, 3, 4, -1, -1, -1, -1, -1], dtype=torch.int32)
    return dict(q=torch.zeros(8, h, d, dtype=q_dtype),
                page_table=torch.tensor([[1, 2]],
                dtype=torch.int32),
                k_pages=torch.zeros(3, page, h, d, dtype=page_dtype),
                v_pages=torch.zeros(3, page, h, d, dtype=page_dtype),
                kv_lens=torch.tensor([5], dtype=torch.int32),
                row_seq=torch.zeros(8, dtype=torch.int32), qpos=qpos)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
def test_chip_smoke_roofline_counts_real_rows_and_operand_rates(page_dtype,
                                                                q_dtype):
    """``ragged_cases.roofline``, which chip_smoke's kernel phase prints:
    q and out of real rows in q's type; products at the rate they run:
    bf16 queries on bf16 pages at the bf16 rate, otherwise a narrow run's
    (at most 16 score rows: here 3 rows of one head per KV head) on the
    CUDA cores in f32."""
    case = _tiny_case(page_dtype, q_dtype)
    got = rc.roofline(case)
    h, d = 2, 8
    live = 3 + 4 + 5                            # tokens <= qpos per row
    kv_bytes = 2 * 5 * h * d * case["k_pages"].element_size()
    qo_bytes = 2 * 3 * h * d * case["q"].element_size()   # real rows only
    idx_bytes = 4 * (2 + 1 + 8 + 8)
    assert got["bytes"] == kv_bytes + qo_bytes + idx_bytes
    half = 2.0 * live * h * d
    rate = rc.BF16_FLOPS_PER_S if page_dtype == q_dtype == torch.bfloat16 \
        else rc.F32_FLOPS_PER_S
    np.testing.assert_allclose(got["ops_ms"], 1e3 * 2 * half / rate,
                               rtol=1e-12)
    assert got["bound_ms"] == max(got["ops_ms"], got["bytes_ms"])
    assert got["bound_by"] == ("bytes" if got["bytes_ms"] >= got["ops_ms"]
                               else "operations")


@pytest.mark.parametrize("page_dtype,qk_terms,pv_terms",
                         [(torch.float32, 3, 3), (torch.bfloat16, 2, 1),
                          (torch.int8, 2, 2)])
def test_roofline_prices_wide_runs_as_3xtf32(page_dtype, qk_terms,
                                             pv_terms):
    """A run of 9 real rows over 2 KV heads of 4 query heads (36 score
    rows) is a wide item: its f32 products run as 3xTF32, one TF32 product
    a term the kernel issues; the single decode row after it is narrow."""
    h, kvh, d, page = 8, 2, 8, 4
    rows = 24
    qpos = [-1] * rows
    qpos[:9] = range(3, 12)                     # a chunk over 12 tokens
    qpos[16] = 4                                # a decode row, 5 tokens
    case = dict(q=torch.zeros(rows, h, d),
                page_table=torch.tensor([[1, 2, 3], [4, 5, 0]],
                                        dtype=torch.int32),
                k_pages=torch.zeros(6, page, kvh, d, dtype=page_dtype),
                v_pages=torch.zeros(6, page, kvh, d, dtype=page_dtype),
                kv_lens=torch.tensor([12, 5], dtype=torch.int32),
                row_seq=torch.tensor([0] * 16 + [1] * 8, dtype=torch.int32),
                qpos=torch.tensor(qpos, dtype=torch.int32))
    assert rc.wide_rows(case).tolist() == [True] * 9 + [False] * 15
    got = rc.roofline(case)
    half_w = 2.0 * sum(range(4, 13)) * h * d
    half_n = 2.0 * 5 * h * d
    want = (half_w * qk_terms / rc.TF32_FLOPS_PER_S +
            half_w * pv_terms / rc.TF32_FLOPS_PER_S +
            2 * half_n / rc.F32_FLOPS_PER_S)
    np.testing.assert_allclose(got["ops_ms"], 1e3 * want, rtol=1e-12)


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


def test_compare_flash_takes_each_entry_from_the_first_source_with_it(
        monkeypatch, tmp_path):
    """An earlier tree's bf16 route: the wgmma source's entries where it
    exports them (this tree's parent: forward and dK/dV), else
    ``flash_attention.cu``'s; a tree without the wgmma source takes all
    three from ``flash_attention.cu``."""

    class Lib:
        def __init__(self, name, syms):
            for sym in syms:
                setattr(self, sym, type("Fn", (), {"lib": name})())

    parent = {"flash_attention_sm90": Lib("sm90", compare_flash.ENTRIES[:2]),
              "flash_attention": Lib("cu", compare_flash.ENTRIES)}
    older = {"flash_attention": Lib("cu", compare_flash.ENTRIES)}
    for libs, want in ((parent, ["sm90", "sm90", "cu"]),
                       (older, ["cu", "cu", "cu"])):
        monkeypatch.setattr(compare_flash, "build_earlier",
                            lambda tree, names, libs=libs: libs)
        entries = compare_flash.earlier_entries(tmp_path)
        assert [entries[e].lib for e in compare_flash.ENTRIES] == want
        assert entries["flash_bwd_dq"].restype is not None


@pytest.mark.parametrize("kernels,want", [
    ([(20, 200.0)], (10.0, 0)),                  # every record caught
    ([(17, 170.0)], (10.0, 3)),                  # 3 of 20 lost
    ([(20, 200.0), (58, 116.0)], (16.0, 2)),     # 3 launches a call, 2 lost
    ([(14, 140.0)], None),                       # 6 of 20 lost: too many
    ([(3, 30.0)], None),                         # under one launch a call
    ([], None),                                  # nothing caught
])
def test_card_time_counts_a_call_from_the_records_caught(kernels, want):
    """Card time of one call out of a trace of 20 calls: each kernel's
    mean record times its launches a call, so records the trace lost
    (the card's profiler drops a few a window in a long run, and a
    reading below the kernel's bound once came of dividing what was left
    by every call) are not read as time the card did not spend."""
    assert compare_flash.per_call_us(kernels, 20) == want


def test_comparison_summary_keeps_each_time_and_its_timer():
    """The tools' summary line: the median, every time, and every timer
    that took them, so a time from CUDA events is never passed off as a
    profiler's."""
    got = compare_flash.summary({"k": {"this": [
        (1.0, "profiler"), (3.0, "events"), (2.0, "profiler")]}})
    assert got == {"k": {"this": {"median_ms": 2.0,
                                  "all_ms": [1.0, 3.0, 2.0],
                                  "timers": ["events", "profiler"]}}}


@pytest.mark.parametrize("name", sorted(compare_rnn.VARIANTS))
def test_compare_rnn_variants_apply_to_the_lstm_source(name, monkeypatch,
                                                       tmp_path):
    """Each variant (an ablation of B5's loop, the GRU loop or both, or
    B8's unit tile and launch bounds) finds its anchors in the current
    ``csrc/rnn_cells.cu`` the given number of times and writes a tree
    whose source differs only there."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    tree = compare_rnn.variant_tree(name)
    out = (tree / "paddle_tpu_torch" / "csrc" / "rnn_cells.cu").read_text()
    source = (build.CSRC_DIR / "rnn_cells.cu").read_text()
    assert out != source
    for anchor, replacement, times in compare_rnn.VARIANTS[name]:
        assert source.count(anchor) == times
        assert out.count(replacement) == source.count(replacement) + times


@pytest.mark.parametrize("name,anchor,times", [
    (name, anchor, times) for name, subs in sorted(compare_rnn.VARIANTS.items())
    for anchor, _, times in subs if anchor in compare_rnn.GRU_ANCHORS])
def test_compare_rnn_variants_reach_the_gru_loop(name, anchor, times):
    """The GRU variants (the ablations ``no_copies``, ``no_products``,
    ``no_sync``, and B8's ``cand_one_block``, ``cand_8_units``,
    ``cand_2_blocks``) find each
    of their anchors the stated number of times, every one inside the
    GRU's main loop and B6 (between the loop's header and B7's), which B8
    runs too, so they leave B5 alone; each GRU variant has such an
    anchor."""
    source = (build.CSRC_DIR / "rnn_cells.cu").read_text()
    start = source.index("// B6, B7 and B8: the GRU's main loop")
    end = source.index("// B7 + B8: the GRU step in two ordinary launches")
    assert source.count(anchor) == times
    assert source[start:end].count(anchor) == times
    gru = {n for n, subs in compare_rnn.VARIANTS.items()
           if any(a in compare_rnn.GRU_ANCHORS for a, _, _ in subs)}
    exact = {"cand_one_block", "cand_8_units", "cand_2_blocks"}
    assert gru == {"no_copies", "no_products", "no_sync"} | exact
    assert compare_rnn.EXACT_VARIANTS == exact


def test_chip_smoke_picks_each_kernels_ptxas_entry(monkeypatch):
    """The kernels line's ptxas fields: the entry of the instantiation the
    main path runs (f32 B5-B8 on their cp.async paths, the D 128 flash
    kernels), one per name, from a report of every instantiation."""
    def entry(name, regs):
        return [f"ptxas info    : Compiling entry function '{name}' for "
                "'sm_90a'",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads", f"ptxas info    : Used {regs} registers"]

    ns = "_ZN45_GLOBAL__N__0_12_rnn_cells_cu_0"
    rnn = [f"{ns}16lstm_step_kernelI{t}Lb{v}EEEvPKT_S4_ii"
           for t in ("f", "13__nv_bfloat16") for v in (0, 1)]
    rnn += [f"{ns}{len(k)}{k}I{t}Lb{v}EEvPKT_ii" for k in
            ("gru_step_kernel", "gru_zr_kernel")
            for t in ("f", "13__nv_bfloat16") for v in (0, 1)]
    rnn += [f"{ns}15gru_cand_kernelI{t}Lb{v}EEvPKfPKT_ii"
            for t in ("f", "13__nv_bfloat16") for v in (0, 1)]
    flash = [f"_ZN0_{k}ILi{d}EEEv14CUtensorMap_st" for k in
             ("flash_fwd_wgmma_kernel", "flash_bwd_kv_wgmma_kernel",
              "flash_bwd_dq_wgmma_kernel") for d in (64, 128)]
    for src, names in (("rnn_cells", rnn), ("flash_attention_sm90", flash)):
        log = [line for i, n in enumerate(names) for line in entry(n, 40 + i)]
        monkeypatch.setitem(build.BUILD_LOG, src, (1.0, "\n".join(log)))
    want = {"lstm_step": 41, "gru_step": 45, "gru_zr": 49, "gru_cand": 53}
    for kname, regs in want.items():
        got = chip_smoke.ptxas_of("rnn_cells", chip_smoke.RNN_PTXAS[kname])
        assert got["registers"] == regs, kname
    for i, kname in enumerate(chip_smoke.FLASH_KERNELS):
        got = chip_smoke.ptxas_of("flash_attention_sm90",
                                  chip_smoke.FLASH_PTXAS[kname])
        assert got["registers"] == 41 + 2 * i, kname


def test_ragged_cases_cover_every_kernel_shape():
    """chip_smoke's ragged cases hold every compiled head dim (with the
    head-dim cases, ``C4_CASES``: 12 and 100 on pools padded to 16 and
    104, 320 on the wide kernel), groups 1, 3, 4 and 16, f32 and bf16
    queries and f32, bf16 and int8 pages, and the main path's decode and
    mixed steps at 16 heads of head_dim 128."""
    from paddle_tpu_torch.serving import decode_attention as da

    shapes = rc.CASES.values()
    assert {d for _, _, _, d, _, _ in shapes} == \
        set(da.KERNEL_WIDTHS[:-1]) | {80, 96}
    c4 = rc.C4_CASES.values()
    assert {d for _, _, _, d, _, _ in c4} == {12, 100, 320}
    assert {da.kernel_width(d) for _, _, _, d, _, _ in
            list(shapes) + list(c4)} == set(da.KERNEL_WIDTHS)
    assert {(s, q, p) for s, _, _, _, q, p in c4} >= {
        (s, "float32", p) for s in ("decode", "mixed")
        for p in ("float32", "bfloat16", "int8")}
    assert rc.CASES["mixed_f32_d96"][3:] == (96, "float32", "float32")
    assert rc.CASES["mixed_int8_d80"][3:] == (80, "float32", "int8")
    assert {h // kvh for _, kvh, h, _, _, _ in shapes} == {1, 3, 4, 16}
    assert {(q, p) for *_, q, p in shapes} >= {
        ("float32", "float32"), ("float32", "int8"),
        ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
        ("bfloat16", "float32")}
    for name in compare_ragged.CASES:
        assert rc.CASES[name][1:] == (16, 16, 128, "float32", "float32")
    # the plain version on the CPU passes its own check
    small = rc.build_case(np.random.default_rng(0), [(40, 9, 31), (5, 1, 0)],
                          2, "cpu", h=6, d=16)
    got = da.ragged_paged_attention(*rc.args(small))
    assert rc.check(small, got)["within_tolerance"]
