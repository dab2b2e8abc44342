"""The flash kernels' tile metadata on the CPU: which (query tile, key
tile) pairs the kernels visit, and which of those the wgmma forward and
dK/dV kernels compute without a mask (``attention.tile_pair_kinds``, the
rule the kernels apply to the per-tile segment-id ranges), held against
a brute-force count of live (query, key) pairs; the wrappers' choice of
library; which cases bring a held stage of the K/V ring round again;
the reading of ptxas's register and spill report; and the ablation
tool's variants of the kernel source.  No JAX here: these are
the port's own contracts."""

import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.tools import flash_ablate
from paddle_tpu_torch.tools import train_workload as tw

T = tattn.KERNEL_TILE


def _live_mask(q_seg, kv_seg, causal):
    """[Sq, Sk] pairs the mask keeps (batch 1)."""
    mask = q_seg[0][:, None] == kv_seg[0][None, :]
    if causal:
        mask &= np.arange(q_seg.shape[1])[:, None] >= \
            np.arange(kv_seg.shape[1])[None, :]
    return mask


def _check_kinds(q_seg, kv_seg, causal):
    kinds = tattn.tile_pair_kinds(torch.from_numpy(q_seg),
                                  torch.from_numpy(kv_seg), causal)[0]
    kinds = kinds.numpy()
    mask = _live_mask(q_seg, kv_seg, causal)
    nqt, nkt = q_seg.shape[1] // T, kv_seg.shape[1] // T
    live = mask.reshape(nqt, T, nkt, T).sum(axis=(1, 3))
    assert kinds.shape == (nqt, nkt)
    # a skipped pair holds no live pair; an interior pair holds only live
    # pairs; together the visited pairs hold every live pair
    assert (live[kinds == tattn.PAIR_SKIPPED] == 0).all()
    assert (live[kinds == tattn.PAIR_INTERIOR] == T * T).all()
    visited = kinds != tattn.PAIR_SKIPPED
    assert int(live[visited].sum()) == tw.live_pairs(q_seg, kv_seg, causal)
    return kinds


@pytest.mark.parametrize("name", ["a_bf16_8x1024_causal",
                                  "b_bf16_ragged_padded",
                                  "f_bf16_segments_causal_d64",
                                  "g_bf16_causal_cross_sq576",
                                  "h_bf16_segments_noncausal",
                                  "e_f32_causal_sk_gt_sq"])
def test_tile_pair_kinds_cover_every_live_pair(name):
    q_seg, kv_seg = tw.case_segments(name)
    kinds = _check_kinds(q_seg, kv_seg, tw.FLASH_CASES[name][5])
    assert (kinds == tattn.PAIR_INTERIOR).any()


def test_tile_pair_kinds_of_the_training_case():
    """8 causal segments of 1024 at 64-row tiles: each segment's 16 query
    tiles visit 136 key tiles, the 16 on the diagonal with a mask, the
    120 below it without; every other pair is skipped."""
    q_seg, kv_seg = tw.case_segments("a_bf16_8x1024_causal")
    kinds = _check_kinds(q_seg, kv_seg, True)
    assert int((kinds == tattn.PAIR_INTERIOR).sum()) == 8 * 120
    assert int((kinds == tattn.PAIR_BOUNDARY).sum()) == 8 * 16
    assert (np.diag(kinds) == tattn.PAIR_BOUNDARY).all()


def _ring_stages(constant):
    source = (build.CSRC_DIR / "flash_attention_sm90.cu").read_text()
    return int(re.search(rf"constexpr int {constant} = (\d+);",
                         source).group(1))


def _longest_foreign_run(name):
    """Over the blocks of two query tiles of a case: the most key tiles
    in a row that only the other warpgroup visits, after a tile this
    warpgroup computed (the tile whose stage it holds)."""
    q_seg, kv_seg = tw.case_segments(name)
    kinds = tattn.tile_pair_kinds(torch.from_numpy(q_seg),
                                  torch.from_numpy(kv_seg),
                                  tw.FLASH_CASES[name][5])[0].numpy()
    visits = kinds != tattn.PAIR_SKIPPED
    best = 0
    for qt0 in range(0, visits.shape[0], 2):
        rows = visits[qt0:qt0 + 2]
        for own in rows:
            run = None
            for kt in np.flatnonzero(rows.any(axis=0)):
                if own[kt]:
                    run = 0
                elif run is not None:
                    run += 1
                    best = max(best, run)
    return best


def test_non_causal_segments_bring_a_held_stage_round_again():
    """Case h drives the forward's and dQ's `finish_held` before a refill:
    after a warpgroup's last own key tile come more tiles that only the
    other warpgroup visits than either ring has stages, so the ring
    refills the stage the first warpgroup still holds.  The causal
    training case never does (one foreign tile, the other warpgroup's
    diagonal)."""
    stages = (_ring_stages("FWD_STAGES"), _ring_stages("DQ_STAGES"))
    assert _longest_foreign_run("h_bf16_segments_noncausal") >= max(stages)
    assert _longest_foreign_run("a_bf16_8x1024_causal") == 1
    assert min(stages) > 2


def test_tile_pair_kinds_non_causal_and_interleaved_ids():
    """Non-causal pairs of one segment are interior on both sides of the
    diagonal; ids that interleave within a tile make every visited pair a
    boundary pair, and a query tile whose id no key carries but which
    lies inside every key tile's id range is visited everywhere."""
    q_seg, kv_seg = tw.case_segments("d_bf16_cross")
    kinds = _check_kinds(q_seg, kv_seg, False)
    assert (kinds == tattn.PAIR_INTERIOR).all()
    kv = np.tile(np.array([0, 2], np.int32), 288)[None]
    q = kv.copy()
    q[:, -T:] = 1
    kinds = _check_kinds(q, kv, True)
    assert not (kinds == tattn.PAIR_INTERIOR).any()
    assert (kinds[-1] == tattn.PAIR_BOUNDARY).all()


def test_bf16_forward_and_dkdv_go_to_the_wgmma_source(monkeypatch):
    """bf16 with P rounded sends the forward, dK/dV and dQ to
    ``flash_attention_sm90``; f32 and ``attn_pv_f32`` send all three to
    ``flash_attention`` (the wrappers driven on CPU tensors against a
    library that records its calls)."""
    calls = []

    class Library:
        def __init__(self, name, sigs):
            self.name, self.sigs = name, set(sigs)

        def __getattr__(self, sym):
            assert sym in self.sigs, (self.name, sym)
            return lambda *args: calls.append((self.name, sym)) or 0

    monkeypatch.setattr(tattn.build, "load", Library)
    monkeypatch.setattr(tattn, "_check", lambda *args: None)
    monkeypatch.setattr(tattn, "_stream", lambda dev: 0)
    seg = torch.zeros((1, T), dtype=torch.int32)
    rows = torch.zeros((1, 2, T), dtype=torch.float32)
    for dtype, pv_f32 in ((torch.bfloat16, False), (torch.bfloat16, True),
                          (torch.float32, False)):
        x = torch.zeros((1, T, 2, 64), dtype=dtype)
        cfg = dict(causal=True, sm_scale=0.125, pv_f32=pv_f32)
        tattn.flash_fwd_kernel(x, x, x, seg, seg, **cfg)
        bwd = (x, x, x, seg, seg, x, rows, rows)
        tattn.flash_bwd_kv_kernel(*bwd, **cfg)
        tattn.flash_bwd_dq_kernel(*bwd, **cfg)
    wgmma, other = "flash_attention_sm90", "flash_attention"
    assert calls == [(wgmma, "flash_fwd"), (wgmma, "flash_bwd_kv"),
                     (wgmma, "flash_bwd_dq")] + [
        (other, "flash_fwd"), (other, "flash_bwd_kv"),
        (other, "flash_bwd_dq")] * 2
    assert "flash_attention_sm90" in build.sources()


def test_ptxas_report_reads_registers_and_spills(monkeypatch, tmp_path):
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fooILi128EEvv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z3fooILi128EEvv",
        "    0 bytes stack frame, 16 bytes spill stores, 12 bytes spill "
        "loads",
        "ptxas info    : Used 224 registers, used 1 barriers, 400 bytes "
        "cmem[0]",
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3barv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 380 bytes cmem[0]"])
    want = {"_Z3fooILi128EEvv": {"registers": 224, "spill_stores": 16,
                                 "spill_loads": 12},
            "_Z3barv": {"registers": 40, "spill_stores": 0,
                        "spill_loads": 0}}
    # the build this process ran, else the report kept beside the library
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setitem(build.BUILD_LOG, "flash_attention", (1.0, log))
    assert build.ptxas_report("flash_attention") == want
    assert build.ptxas_report("flash_attention_sm90") == {}
    build._target("flash_attention_sm90")[1].with_suffix(".log").write_text(
        log)
    assert build.ptxas_report("flash_attention_sm90") == want


@pytest.mark.parametrize("name", sorted(flash_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_kernel_source(name):
    """Each variant of ``tools/flash_ablate.py`` finds its anchors in the
    current ``csrc/flash_attention_sm90.cu`` exactly once."""
    source = (build.CSRC_DIR / "flash_attention_sm90.cu").read_text()
    out = flash_ablate.variant_source(name, source)
    assert (out == source) == (name == "as_built")


def test_variant_source_raises_where_an_anchor_count_differs():
    """The substitution shared by ``flash_ablate`` and ``compare_rnn``:
    every occurrence replaced, and an anchor found another number of
    times than given is an error, not a silent no-op."""
    variants = {"twice": [("x", "y", 2)]}
    assert flash_ablate.variant_source("twice", "x + x", variants) == "y + y"
    with pytest.raises(ValueError, match="found 1 times, not 2"):
        flash_ablate.variant_source("twice", "x", variants)


@pytest.mark.parametrize("name", ["no_products", "no_tile_loop"])
def test_ablation_variants_reach_the_dq_kernel(name):
    """B3's variants: leaving out the products or the tile loop changes
    the dQ kernel's own code, not only the forward's and dK/dV's."""
    source = (build.CSRC_DIR / "flash_attention_sm90.cu").read_text()
    out = flash_ablate.variant_source(name, source)

    def dq_code(text):
        start = text.index("__device__ __forceinline__ void bwd_dq_consumer(")
        return text[start:text.index("// launchers", start)]

    assert dq_code(out) != dq_code(source)
