"""The port's CUDA kernels on the card: the ragged paged-attention kernel
against its plain PyTorch version at every compiled width and at head
dims between them (8, 40, 48, 80, 96, 112, 160, 192), every group, query
and page type it takes, the decode-only view, and small ServingEngines on
CUDA (GQA; the default ``DecoderLM`` at head_dim 16 and one at head_dim
96, f32 and bf16) against the port's greedy oracle; the three
flash-attention kernels against their plain versions on
``chip_smoke.py``'s cases and at head dims 8-256 and lengths that end in
a partial tile, through the autograd function, and small transformers
(head dims 128, 32, 96, 256) trained through the kernels against the same
steps through the plain versions; the four RNN kernels (the fused LSTM
step, the one-launch GRU step and the two-launch GRU step) against their
plain versions on ``chip_smoke.py``'s cases and, for the LSTM step and
the GRU main loop (B6, B7, B8), on shapes that are not whole tiles (B8
also on a misaligned r h), the one-launch GRU
step on a grid at the edge of co-residency and its refusal of a grid the
card cannot hold at once, and small recurrent classifiers trained through
the kernels against the plain versions.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode).  The file imports neither ``jax`` nor ``paddle_tpu``, so it
runs on a machine without JAX; there the repository's ``conftest.py``
(which imports JAX) is skipped::

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerances: 1e-4 abs + rel for f32 and int8 pages (the two versions sum
in different orders).  bf16 pages: 1e-3 against the plain version with
``round_p_tile`` and ``round_p_span``, which round the softmax
probabilities to bf16 before the PV product at the kernel's tiles and
spans (scores summed in another order can still move a probability
across a bf16 rounding step), and 2e-2 against the plain version that
does not round; bf16 outputs within one bf16 step of the value plus
1e-3, on the tensor-core path (bf16 on bf16) for all but 0.1% of the
elements (``tools/ragged_cases.check`` states why).  Flash kernels: f32 outputs and
every lse at 1e-4 abs + rel; bf16 outputs within one bf16 step of their
own magnitude plus 2e-3 of the tensor's largest (``train_workload.
flash_error``: the plain version rounds P and dS at the kernels' tiles,
an f32 sum in another order can still cross a bf16 rounding step).  RNN
kernels: f32 outputs at 1e-5 abs + rel, a bf16 h' within one bf16 step
of its magnitude (``rnn_workload.rnn_error``); recurrent training costs
within 1e-4 relative.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from paddle_tpu_torch import event
from paddle_tpu_torch.convert import decoder_lm_from_numpy, init_numpy_params
from paddle_tpu_torch.kernels import build
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import (DecoderLM, ServingEngine,
                                      greedy_decode_reference,
                                      reference_logits)
from paddle_tpu_torch.serving import decode_attention as tda
from paddle_tpu_torch.serving.kv_cache import quantize_kv
from paddle_tpu_torch.tools import ragged_cases as rc
from paddle_tpu_torch.tools import rnn_workload as rw
from paddle_tpu_torch.tools import train_workload as tw

pytestmark = pytest.mark.cuda

PAGE, D = 128, 128
_ARGS = ("q", "k_pages", "v_pages", "page_table", "kv_lens", "row_seq",
         "qpos")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, seqs, kvh, h, pm=4, num_pages=24, seed=0, d=D):
    """A batch in the kernel packing on ``dev``: (kv_len, q_rows, q_start)
    per sequence, each sequence's rows padded to whole 8-row blocks."""
    rng = np.random.default_rng(seed)
    table = np.zeros((len(seqs), pm), np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    row_seq, qpos = [], []
    for i, (n, qr, qs) in enumerate(seqs):
        for j in range(-(-n // PAGE)):
            table[i, j] = free.pop()
        blocks = -(-qr // tda.BLOCK_ROWS)
        pos = list(range(qs, qs + qr)) if qr > 1 else [n - 1]
        qpos += pos + [-1] * (blocks * tda.BLOCK_ROWS - qr)
        row_seq += [i] * blocks * tda.BLOCK_ROWS
    arrays = dict(
        q=rng.standard_normal((len(qpos), h, d), np.float32),
        k_pages=rng.standard_normal((num_pages, PAGE, kvh, d), np.float32),
        v_pages=rng.standard_normal((num_pages, PAGE, kvh, d), np.float32),
        page_table=table, kv_lens=np.asarray([s[0] for s in seqs], np.int32),
        row_seq=np.asarray(row_seq, np.int32),
        qpos=np.asarray(qpos, np.int32))
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


SEQS = [(300, 40, 260), (0, 1, 0), (129, 1, 0), (77, 1, 0), (512, 8, 504)]


@pytest.mark.parametrize("kvh", [16, 4, 2], ids=["mha", "gqa4", "gqa8"])
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_kernel_matches_plain(cuda, dtype, kvh):
    c = _case(cuda, SEQS, kvh, 16)
    kw = {}
    if dtype == "int8":
        c["k_pages"], kw["k_scale"] = quantize_kv(c["k_pages"])
        c["v_pages"], kw["v_scale"] = quantize_kv(c["v_pages"])
    elif dtype == "bfloat16":
        c["k_pages"] = c["k_pages"].bfloat16()
        c["v_pages"] = c["v_pages"].bfloat16()
    args = [c[k] for k in _ARGS]
    before = tda.ragged_paged_attention_kernel.launches
    got = tda.ragged_paged_attention(*args, **kw)     # dispatches by device
    want = tda.ragged_paged_attention_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tda.ragged_paged_attention_kernel.launches == before + 1
    real = c["qpos"] >= 0
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    torch.testing.assert_close(got[real], want[real], rtol=tol, atol=tol)
    if dtype == "bfloat16":
        rounded = tda.ragged_paged_attention_reference(
            *args, **rc.kernel_rounding(c))
        torch.testing.assert_close(got[real], rounded[real], rtol=1e-3,
                                   atol=1e-3)
    # a block whose sequence holds nothing yields zeros, not NaN
    empty = c["row_seq"] == 1
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


# (num_kv_heads, num_heads): G 1, 3 and 16, at every head dim
GROUPS = [(2, 2), (2, 6), (1, 16)]
# the compiled widths, and head dims between them that the kernels at the
# next width run with their columns past the head dim zero (8 and 40: int8
# rows that are not whole 16-byte pieces, copied in 8-byte ones)
RAGGED_HEAD_DIMS = tda.KERNEL_WIDTHS + (8, 40, 48, 80, 96, 112, 160, 192)


@pytest.mark.parametrize("pages", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh,h", GROUPS, ids=["g1", "g3", "g16"])
@pytest.mark.parametrize("d", RAGGED_HEAD_DIMS)
def test_kernel_matches_plain_at_every_shape(cuda, d, kvh, h, q_dtype,
                                             pages):
    """Every compiled width and head dims between them (the pool holds
    d columns; no padded copy is made), G 1, 3 and 16, f32 and bf16
    queries over f32, int8 and bf16 pages (bf16 on bf16 runs on the
    tensor cores), against the plain version at ``ragged_cases``' tolerances
    (``ragged_cases.check``).  Rows of a 200-token chunk and of a 40-row
    chunk take several spans and go through the merge."""
    seqs = [(300, 40, 260), (0, 1, 0), (129, 1, 0), (77, 1, 0),
            (512, 8, 504), (200, 200, 0)]
    c = _case(cuda, seqs, kvh, h, pm=4, num_pages=32, seed=d + h, d=d)
    kw = {}
    if pages == "int8":
        c["k_pages"], kw["k_scale"] = quantize_kv(c["k_pages"])
        c["v_pages"], kw["v_scale"] = quantize_kv(c["v_pages"])
    elif pages == "bfloat16":
        c["k_pages"] = c["k_pages"].bfloat16()
        c["v_pages"] = c["v_pages"].bfloat16()
    if q_dtype == "bfloat16":
        c["q"] = c["q"].bfloat16()
    c.update(kw)
    before = tda.ragged_paged_attention_kernel.launches
    got = tda.ragged_paged_attention_kernel(*rc.args(c), **kw)
    torch.cuda.synchronize()
    assert tda.ragged_paged_attention_kernel.launches == before + 1
    assert got.dtype == c["q"].dtype
    res = rc.check(c, got)
    assert res["within_tolerance"], res
    real = c["qpos"] >= 0
    # padded rows and the empty sequence's rows are zeros
    assert torch.equal(got[~real], torch.zeros_like(got[~real]))


def test_kernel_refuses_what_it_does_not_take(cuda):
    c = _case(cuda, SEQS, 16, 16)
    args = [c[k] for k in _ARGS]
    with pytest.raises(EnforceError, match="BLOCK_ROWS"):
        tda.ragged_paged_attention_kernel(args[0][:-1], *args[1:5],
                                          args[5][:-1], args[6][:-1])
    for bad in (args[0].double(), args[0].half()):
        with pytest.raises(EnforceError, match="f32 or bf16 queries"):
            tda.ragged_paged_attention_kernel(bad, *args[1:])
    # C4's contract: every head dim of at least 1 runs, on pages at its
    # padded width; pages at the unpadded width of 100 and a head dim of
    # 0 are refused
    c100 = _case(cuda, SEQS, 16, 16, d=100)
    with pytest.raises(EnforceError,
                       match="head_dim 100 padded to a multiple of 8"):
        tda.ragged_paged_attention_kernel(*[c100[k] for k in _ARGS])
    c0 = _case(cuda, SEQS, 16, 16, d=0)
    with pytest.raises(EnforceError, match="head_dim of at least 1, got 0"):
        tda.ragged_paged_attention_kernel(*[c0[k] for k in _ARGS])
    with pytest.raises(EnforceError, match="use_kernel=False"):
        tda.attention_path(D, PAGE, num_heads=16, num_kv_heads=16,
                           device=cuda, use_kernel=False)


def test_paged_decode_attention_matches_plain(cuda):
    rng = np.random.default_rng(3)
    kp = torch.from_numpy(rng.standard_normal((16, PAGE, 4, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((16, PAGE, 4, D), np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 8, D), np.float32))
    table = torch.from_numpy(rng.integers(1, 16, (3, 4)).astype(np.int32))
    lengths = torch.tensor([5, 300, 512], dtype=torch.int32)
    want = tda.paged_decode_attention(q, kp, vp, table, lengths)  # CPU plain
    got = tda.paged_decode_attention(*(t.to(cuda) for t in
                                       (q, kp, vp, table, lengths)))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_engine_on_cuda_matches_greedy_reference(cuda):
    """Chunked prefill, decode and a cached prefix through the kernel;
    every request agrees with the non-paged oracle (a mismatch is allowed
    only at a near tie: top-two gap under 1e-3 of the top logit)."""
    model = DecoderLM(vocab_size=256, num_layers=2, num_heads=4,
                      head_dim=D, num_kv_heads=2, max_positions=512,
                      device=cuda)
    decoder_lm_from_numpy(init_numpy_params(model, 5), model)
    eng = ServingEngine(model, eos_id=-1, page_size=16, num_pages=64,
                        max_pages_per_seq=16, max_slots=4, prefill_chunk=32,
                        buckets=(32, 64), device=cuda)
    rng = np.random.default_rng(9)
    prefix = rng.integers(2, 256, 48).tolist()
    prompts = [prefix + [3, 4], rng.integers(2, 256, 70).tolist(),
               rng.integers(2, 256, 5).tolist()]
    rids = [eng.submit(p, max_tokens=8) for p in prompts]
    for _ in range(6):
        eng.step()
    prompts.append(prefix + [9])
    rids.append(eng.submit(prompts[-1], max_tokens=8))
    tda.ragged_paged_attention_kernel.launches = 0
    eng.run()
    assert tda.ragged_paged_attention_kernel.launches > 0
    assert eng.metrics.prefill_tokens_saved >= 48
    for prompt, rid in zip(prompts, rids):
        got = eng.result(rid)
        want = greedy_decode_reference(model, prompt, 8, -1)
        if got != want:
            j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            top2 = np.sort(reference_logits(model, prompt + want[:j]))[-2:]
            assert top2[1] - top2[0] < 1e-3 * abs(top2[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_serves_the_default_decoder_lm_on_cuda(cuda, dtype):
    """``DecoderLM`` at its defaults (2 layers, 2 heads of head_dim 16)
    and its bf16 version, served on the card through the ragged kernel:
    tokens equal to the greedy oracle, the kernel launched once a layer a
    step."""
    model = DecoderLM(vocab_size=512, device=cuda,
                      dtype=getattr(torch, dtype))
    assert model.head_dim == 16
    decoder_lm_from_numpy(init_numpy_params(model, 5), model)
    eng = ServingEngine(model, eos_id=-1, page_size=16, num_pages=64,
                        max_pages_per_seq=16, max_slots=4, prefill_chunk=32,
                        buckets=(32, 64), device=cuda)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, 512, n).tolist() for n in (50, 70, 5)]
    tda.ragged_paged_attention_kernel.launches = 0
    rids = [eng.submit(p, max_tokens=8) for p in prompts]
    eng.run()
    assert tda.ragged_paged_attention_kernel.launches == \
        model.num_layers * eng.metrics.step_dispatches > 0
    for prompt, rid in zip(prompts, rids):
        assert eng.result(rid) == greedy_decode_reference(model, prompt, 8,
                                                          -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_serves_a_decoder_lm_at_head_dim_96(cuda, dtype):
    """A ``DecoderLM`` of 4 heads of head_dim 96 (between the kernel's
    compiled widths 64 and 128), f32 and bf16, served on the card through
    the ragged kernel over a pool of 96-column pages: chunked prefill,
    decode and a cached prefix, tokens equal to the greedy oracle (a
    mismatch only at a near tie: top-two gap under 1e-3 of the top
    logit), the kernel launched once a layer a step."""
    model = DecoderLM(vocab_size=512, num_layers=2, num_heads=4,
                      head_dim=96, max_positions=512, device=cuda,
                      dtype=getattr(torch, dtype))
    decoder_lm_from_numpy(init_numpy_params(model, 7), model)
    eng = ServingEngine(model, eos_id=-1, page_size=16, num_pages=64,
                        max_pages_per_seq=16, max_slots=4, prefill_chunk=32,
                        buckets=(32, 64), device=cuda)
    rng = np.random.default_rng(10)
    prefix = rng.integers(2, 512, 40).tolist()
    prompts = [prefix + [3, 4], rng.integers(2, 512, 70).tolist(),
               rng.integers(2, 512, 5).tolist()]
    tda.ragged_paged_attention_kernel.launches = 0
    rids = [eng.submit(p, max_tokens=8) for p in prompts]
    for _ in range(5):
        eng.step()
    prompts.append(prefix + [9])
    rids.append(eng.submit(prompts[-1], max_tokens=8))
    eng.run()
    assert tda.ragged_paged_attention_kernel.launches == \
        model.num_layers * eng.metrics.step_dispatches > 0
    for prompt, rid in zip(prompts, rids):
        got = eng.result(rid)
        want = greedy_decode_reference(model, prompt, 8, -1)
        if got != want:
            j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            top2 = np.sort(reference_logits(model, prompt + want[:j]))[-2:]
            assert top2[1] - top2[0] < 1e-3 * abs(top2[1])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _check_flash_case(case, pv_f32=False):
    cfg = dict(causal=case.causal, sm_scale=case.sm_scale, pv_f32=pv_f32)
    fwd = (case.q, case.k, case.v, case.q_seg, case.kv_seg)
    o_ref, lse_ref = tattn.flash_fwd_reference(*fwd, **cfg)
    bwd = fwd + (case.dout, lse_ref, tattn.attention_delta(o_ref, case.dout))
    got = list(tattn.flash_fwd_kernel(*fwd, **cfg)) + \
        list(tattn.flash_bwd_kv_kernel(*bwd, **cfg)) + \
        [tattn.flash_bwd_dq_kernel(*bwd, **cfg)]
    want = [o_ref, lse_ref, *tattn.flash_bwd_kv_reference(*bwd, **cfg),
            tattn.flash_bwd_dq_reference(*bwd, **cfg)]
    torch.cuda.synchronize()
    for label, g, w in zip(("o", "lse", "dk", "dv", "dq"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        res = tw.flash_error(g, w)
        assert res["within_tolerance"], (label, res)


@pytest.mark.parametrize("name", sorted(tw.FLASH_CASES))
def test_flash_kernels_match_plain(cuda, name):
    """bf16 cases run the wgmma kernels, f32 the CUDA-core ones.  Case h
    (non-causal segments) makes the forward and dQ consumers finish a
    held product before the ring refills its stage."""
    _check_flash_case(tw.flash_case(name, cuda))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_padding_tile_that_matches_nothing(cuda, d):
    """A query tile of padding whose segment id no key carries, though it
    lies inside every key tile's id range (keys alternate ids 0 and 2,
    the tile is id 1): the kernels visit every key tile for it and mask
    every pair, so each of its rows averages V over all keys, as the plain
    version does: finite O and lse equal to the plain version's, and no
    gradient from it.  Sq = Sk = 576, 9 tiles: the last forward and dK/dV
    blocks hold one tile each."""
    s, h = 576, 4
    rng = np.random.default_rng(11)
    kv_seg = np.tile(np.array([0, 2], np.int32), s // 2)[None]
    q_seg = kv_seg.copy()
    q_seg[:, -tattn.KERNEL_TILE:] = 1

    def normal():
        return torch.from_numpy(rng.standard_normal((1, s, h, d),
                                                    np.float32)).to(
            cuda, torch.bfloat16)

    case = tw.FlashCase(name="padding_tile", q=normal(), k=normal(),
                        v=normal(), dout=normal(),
                        q_seg=torch.from_numpy(q_seg).to(cuda),
                        kv_seg=torch.from_numpy(kv_seg).to(cuda),
                        causal=True)
    _check_flash_case(case)
    o, lse = tattn.flash_fwd_kernel(case.q, case.k, case.v, case.q_seg,
                                    case.kv_seg, causal=True,
                                    sm_scale=case.sm_scale)
    pad = slice(s - tattn.KERNEL_TILE, s)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    # the mean of 576 unit normals is below 0.2, where one bf16 step is
    # under 1e-3
    want = case.v.float().mean(1, keepdim=True).expand(-1, 64, -1, -1)
    torch.testing.assert_close(o[:, pad].float(), want, rtol=0, atol=1e-3)
    # dQ of bf16 is the wgmma kernel's, and the padding rows get none
    assert tattn._library(case.q, case.k, False) is build.load(
        "flash_attention_sm90", tattn._SIGNATURES)
    before = tattn.flash_bwd_dq_kernel.launches
    dq = tattn.flash_bwd_dq_kernel(
        case.q, case.k, case.v, case.q_seg, case.kv_seg, case.dout, lse,
        tattn.attention_delta(o, case.dout), causal=True,
        sm_scale=case.sm_scale)
    torch.cuda.synchronize()
    assert tattn.flash_bwd_dq_kernel.launches == before + 1
    assert bool((dq[:, pad] == 0).all())
    assert bool(torch.isfinite(dq.float()).all())


@pytest.mark.parametrize("name", ["b_bf16_ragged_padded", "d_bf16_cross"])
def test_flash_kernels_with_pv_f32_match_plain(cuda, name):
    """bf16 with ``attn_pv_f32`` (P and dS kept in f32) runs the CUDA-core
    kernels."""
    _check_flash_case(tw.flash_case(name, cuda), pv_f32=True)


def test_flash_attention_launches_each_kernel_once(cuda):
    case = tw.flash_case("c_f32_segments_causal", cuda)
    q, k, v = (x.clone().requires_grad_(True)
               for x in (case.q, case.k, case.v))
    before = [kern.launches for kern in (tattn.flash_fwd_kernel,
                                         tattn.flash_bwd_kv_kernel,
                                         tattn.flash_bwd_dq_kernel)]
    out = tattn.flash_attention(q, k, v, segment_ids=case.q_seg,
                                causal=True)
    torch.autograd.grad(out, (q, k, v), case.dout)
    after = [kern.launches for kern in (tattn.flash_fwd_kernel,
                                        tattn.flash_bwd_kv_kernel,
                                        tattn.flash_bwd_dq_kernel)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    want = tattn.flash_attention_reference(case.q, case.k, case.v,
                                           segment_ids=case.q_seg,
                                           causal=True)
    torch.testing.assert_close(out.detach(), want, rtol=1e-4, atol=1e-4)


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    seg = torch.zeros((1, 128), dtype=torch.int32, device=cuda)
    # C4's contract: every head dim of at least 1 runs (widened to a
    # multiple of 8; the wide kernels above 512), so only a head dim of 0
    # and an fp16 input are refused
    for shape, dtype, match in (((1, 128, 2, 0), torch.float32,
                                 "head_dim of at least 1, got 0"),
                                ((1, 128, 2, 128), torch.float16,
                                 "float32 or bfloat16")):
        x = torch.zeros(shape, dtype=dtype, device=cuda)
        s = seg[:, :shape[1]].contiguous()
        with pytest.raises(EnforceError, match=match):
            tattn.flash_attention(x, x, x, segment_ids=s, causal=True,
                                  sm_scale=1.0)
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    kv = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(EnforceError, match="no GQA"):
        tattn.flash_fwd_kernel(q, kv, kv, seg[:, :64].contiguous(),
                               seg[:, :64].contiguous(), causal=True,
                               sm_scale=0.125)


# (B, Sq, Sk, H, D, causal, packed lengths or None): the CUDA-core route
# at head dims 16, 32 and 256, at head dims between its compiled widths
# (8, 48, 80, 96, 112, 160, 192) and at lengths that are not whole 64-row
# tiles (32, 96; 96 against 160 keys)
SMALL_FLASH = {
    "d8_s128_causal": (2, 128, 128, 4, 8, True, None),
    "d48_s256_segments": (1, 256, 256, 4, 48, True, (100, 120)),
    "d80_sq96_sk160_causal": (1, 96, 160, 4, 80, True, None),
    "d96_s512_segments": (1, 512, 512, 4, 96, True, (200, 250)),
    "d112_sq256_sk192_cross": (1, 256, 192, 2, 112, False, None),
    "d160_s256_segments": (1, 256, 256, 2, 160, True, (100, 120)),
    "d192_sq96_cross": (1, 96, 160, 2, 192, False, None),
    "d16_sq96_segments": (2, 96, 96, 4, 16, True, (30, 50)),
    "d32_s512_segments": (1, 512, 512, 4, 32, True, (200, 250)),
    "d256_s256_segments": (1, 256, 256, 2, 256, True, (100, 120)),
    "d256_sq96_cross": (1, 96, 160, 2, 256, False, None),
    "d128_sq32_causal": (1, 32, 32, 4, 128, True, None),
    "d64_sq96_sk160_causal": (1, 96, 160, 4, 64, True, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SMALL_FLASH))
def test_flash_kernels_at_other_head_dims_and_lengths(cuda, name, dtype):
    """The three kernels against their plain versions (P and dS rounded
    at the kernels' tiles) where the CUDA-core kernels take what the
    wgmma kernels do not: head dims 8-256 other than 64 and 128 (the
    q/k/v rows hold d columns; no padded copy is made) and lengths that
    end in a partial tile; then the autograd function on the same inputs,
    one launch of each kernel."""
    b, sq, sk, h, d, causal, lengths = SMALL_FLASH[name]
    rng = np.random.default_rng([b, sq, sk, d])
    dt = getattr(torch, dtype)

    def normal(s):
        return torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                    np.float32)).to(cuda, dt)

    q_seg = np.zeros((b, sq), np.int32) if lengths is None else \
        np.repeat(tw.packed_segments(lengths, sq), b, axis=0)
    kv_seg = q_seg if sq == sk else np.zeros((b, sk), np.int32)
    case = tw.FlashCase(name=name, q=normal(sq), k=normal(sk), v=normal(sk),
                        dout=normal(sq),
                        q_seg=torch.from_numpy(q_seg).to(cuda),
                        kv_seg=torch.from_numpy(kv_seg).to(cuda),
                        causal=causal)
    assert tattn.kernel_route(tuple(case.q.shape), tuple(case.k.shape), dt,
                              False) == "flash_attention"
    _check_flash_case(case)
    q, k, v = (x.clone().requires_grad_(True)
               for x in (case.q, case.k, case.v))
    before = [kern.launches for kern in (tattn.flash_fwd_kernel,
                                         tattn.flash_bwd_kv_kernel,
                                         tattn.flash_bwd_dq_kernel)]
    out = tattn.flash_attention(q, k, v, segment_ids=case.q_seg,
                                kv_segment_ids=case.kv_seg, causal=causal)
    torch.autograd.grad(out, (q, k, v), case.dout)
    after = [kern.launches for kern in (tattn.flash_fwd_kernel,
                                        tattn.flash_bwd_kv_kernel,
                                        tattn.flash_bwd_dq_kernel)]
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1]


def test_training_kernel_path_matches_plain_path(cuda):
    """Two steps of a small transformer (head dim 128) through the
    kernels, and the same steps with the layers' flash attention routed
    through the plain versions: costs within 1e-3 relative (bf16 flash
    inputs; the kernels sum in another order)."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters

    samples = tw.lm_samples(3, bs=2, seq=96, vocab=500)

    def run():
        topology.reset_name_scope()
        *_, cost = transformer.build(vocab_size=500, d_model=256,
                                     n_layers=2, n_heads=2, max_len=128)
        params = Parameters.from_topology(topology.Topology([cost]),
                                          seed=1, device=cuda)
        sgd = trainer.SGD(cost, params, optimizer.Momentum(
            momentum=0.9, learning_rate=0.01), device=cuda)
        costs = []
        sgd.train(tw.repeat_reader(samples, 2), event_handler=lambda ev:
                  costs.append(ev.cost)
                  if isinstance(ev, event.EndIteration) else None,
                  feeding=tw.FEEDING)
        return costs

    before = tattn.flash_fwd_kernel.launches
    kernel_costs = run()
    assert tattn.flash_fwd_kernel.launches == before + 4
    with tw.plain_flash_path():
        plain_costs = run()
    np.testing.assert_allclose(kernel_costs, plain_costs, rtol=1e-3)


@pytest.mark.parametrize("d_model,n_heads", [(256, 8), (512, 2), (384, 4)],
                         ids=["head_dim32", "head_dim256", "head_dim96"])
def test_training_at_other_head_dims(cuda, d_model, n_heads):
    """``layer.multi_head_attention`` at head_dim = size // heads of 32,
    256 and 96 trains on the card through the CUDA-core flash kernels: two
    steps, each kernel launched once a layer a step, costs finite, falling
    and within 1e-3 relative of the same steps through the plain
    versions."""
    from paddle_tpu_torch import optimizer, topology, trainer
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parameters import Parameters

    samples = tw.lm_samples(4, bs=2, seq=96, vocab=500)

    def run():
        topology.reset_name_scope()
        *_, cost = transformer.build(vocab_size=500, d_model=d_model,
                                     n_layers=2, n_heads=n_heads,
                                     max_len=128)
        params = Parameters.from_topology(topology.Topology([cost]),
                                          seed=1, device=cuda)
        sgd = trainer.SGD(cost, params, optimizer.Momentum(
            momentum=0.9, learning_rate=1e-3), device=cuda)
        costs = []
        sgd.train(tw.repeat_reader(samples, 2), event_handler=lambda ev:
                  costs.append(ev.cost)
                  if isinstance(ev, event.EndIteration) else None,
                  feeding=tw.FEEDING)
        return costs

    kernels = (tattn.flash_fwd_kernel, tattn.flash_bwd_kv_kernel,
               tattn.flash_bwd_dq_kernel)
    before = [kern.launches for kern in kernels]
    kernel_costs = run()
    assert [kern.launches - b for kern, b in zip(kernels, before)] == \
        [4, 4, 4]
    assert np.isfinite(kernel_costs).all()
    assert kernel_costs[-1] < kernel_costs[0]
    with tw.plain_flash_path():
        plain_costs = run()
    np.testing.assert_allclose(kernel_costs, plain_costs, rtol=1e-3)


def test_bf16_matmul_with_f32_result_on_the_card(cuda):
    """``ops/math.matmul`` under the bf16 policy on the card (cuBLAS on
    bf16 inputs with an f32 result, and the backward the port gives it)
    against the exact widening of the same bf16 values multiplied in f32
    on the card.  Forward: the products are exact, only the order of the
    f32 sums differs (1e-3 abs on values ~20).  Gradients: the cotangent
    is rounded to bf16 and each gradient once more on the way out, as
    JAX's transpose rule rounds to the input's dtype, so they agree to
    one bf16 step (2**-7 relative) plus the sum-order term."""
    from paddle_tpu_torch.ops import math as tmath
    from paddle_tpu_torch.platform.flags import FLAGS

    gen = torch.Generator(device="cpu").manual_seed(0)
    a, b, g = (torch.randn(shape, generator=gen).to(cuda)
               for shape in ((256, 512), (512, 384), (256, 384)))
    a.requires_grad_(True)
    b.requires_grad_(True)
    old = FLAGS.use_bf16
    FLAGS.use_bf16 = True
    try:
        y = tmath.matmul(a, b)
        ga, gb = torch.autograd.grad(y, (a, b), g)
    finally:
        FLAGS.use_bf16 = old
    assert y.dtype == ga.dtype == gb.dtype == torch.float32
    a16, b16, g16 = (x.detach().bfloat16().float() for x in (a, b, g))
    torch.testing.assert_close(y, a16 @ b16, rtol=0, atol=1e-3)
    for got, want in ((ga, g16 @ b16.T), (gb, a16.T @ g16)):
        torch.testing.assert_close(got, want.bfloat16().float(),
                                   rtol=2 ** -7, atol=1e-3)


# ---------------------------------------------------------------------------
# recurrent kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(rw.RNN_CASES))
def test_rnn_kernels_match_plain(cuda, name):
    import chip_smoke

    case = rw.rnn_case(name, cuda)
    before = rw.launches()
    calls = chip_smoke._rnn_case_calls(case)
    torch.cuda.synchronize()
    for kname, (_, _, outs) in calls.items():
        assert rw.launches()[kname] == before[kname] + 1
        for label, (got, want) in outs.items():
            assert got.dtype == want.dtype and got.shape == want.shape
            res = rw.rnn_error(got, want)
            assert res["within_tolerance"], (kname, label, res)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(37, 200), (5, 77), (50, 1104),
                                 (50, 1100)],
                         ids=["b37_h200", "b5_h77", "b50_h1104",
                              "b50_h1100"])
def test_lstm_step_on_shapes_that_are_not_whole_tiles(cuda, B, H, dtype):
    """B5 where neither the batch nor K fills its tiles, against the plain
    version, acts saved: B 37 x H 200 (5 of 32 rows of the second row
    block live, the last K chunk 8 of 64, the cp.async path), B 5 x H 77
    (units and K ragged, rows of h and W not 16-byte aligned: the path
    that stages through registers), and B 50 (18 of 32 rows live) at H
    1104 (the last K chunk 16 of 64, cp.async) and H 1100 (through
    registers)."""
    from paddle_tpu_torch.ops import rnn as R

    rng = np.random.default_rng([B, H])
    dt = getattr(torch, dtype)

    def t(a, to=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            cuda, to)

    bound = np.sqrt(6.0 / (5 * H))
    args = (t(rng.standard_normal((B, 4 * H)), dt),
            t(np.tanh(rng.standard_normal((B, H))), dt),
            t(rng.standard_normal((B, H))),
            t(rng.uniform(-bound, bound, (H, 4 * H))),
            t(0.1 * rng.standard_normal(4 * H)))
    before = R.lstm_step_kernel.launches
    got = R.lstm_step_kernel(*args, save_acts=True)
    want = R.lstm_step_reference(*args, save_acts=True)
    torch.cuda.synchronize()
    assert R.lstm_step_kernel.launches == before + 1
    for label, g, w in zip(("h", "c", "acts"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        res = rw.rnn_error(g, w)
        assert res["within_tolerance"], (label, res)


def _gru_args(dev, B, H, dtype, seed):
    """xp [B, 3H] and h [B, H] in ``dtype``, W_h XavierUniform and the
    bias f32, drawn from ``seed`` at the scales of ``rw.rnn_case``."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def t(a, to=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            dev, to)

    bound = np.sqrt(6.0 / (4 * H))
    return (t(rng.standard_normal((B, 3 * H)), dt),
            t(np.tanh(rng.standard_normal((B, H))), dt),
            t(rng.uniform(-bound, bound, (H, 3 * H))),
            t(0.1 * rng.standard_normal(3 * H)))


def _check_gru_kernels(args, save_acts):
    """B6 and B7 on ``args`` against their plain versions, each one
    launch."""
    from paddle_tpu_torch.ops import rnn as R

    H = args[1].shape[1]
    before = (R.gru_step_kernel.launches, R.gru_zr_kernel.launches)
    got_h, got_acts = R.gru_step_kernel(*args, save_acts=save_acts)
    got_zrc, got_rh = R.gru_zr_kernel(*args)
    want_h, want_acts = R.gru_step_reference(*args, save_acts=save_acts)
    want_zrc, want_rh = R.gru_zr_reference(*args)
    torch.cuda.synchronize()
    assert (R.gru_step_kernel.launches, R.gru_zr_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    assert (got_acts is None) == (not save_acts)
    pairs = {"h": (got_h, want_h), "zr": (got_zrc[:, :2 * H],
                                          want_zrc[:, :2 * H]),
             "rh": (got_rh, want_rh)}
    if save_acts:
        pairs["acts"] = (got_acts, want_acts)
    for label, (g, w) in pairs.items():
        assert g.dtype == w.dtype and g.shape == w.shape, label
        res = rw.rnn_error(g, w)
        assert res["within_tolerance"], (label, res)


@pytest.mark.parametrize("save_acts", [True, False], ids=["acts", "noacts"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [100, 520])
@pytest.mark.parametrize("B", [1, 17, 50])
def test_gru_steps_on_shapes_that_are_not_whole_tiles(cuda, B, H, dtype,
                                                      save_acts):
    """B6 and B7 where the batch and K do not fill their tiles, against
    the plain versions: B 1, 17 and 50 (1, 17 and 18 of a block's 32 rows
    live); H 100 (the last unit block 4 of 8 units, the last K chunk 36 of
    64, and H % 8 != 0, so rows stage through registers; bf16 rows of h
    are not 16-byte aligned) and H 520 (the last K chunk 8 of 64, on the
    cp.async path)."""
    _check_gru_kernels(_gru_args(cuda, B, H, dtype, [B, H]), save_acts)


def _check_gru_cand(args, save_c, rh=None):
    """B8 on ``args`` and the plain B7's z and r h (or ``rh``, the same
    values in another tensor) against its plain version, one launch."""
    from paddle_tpu_torch.ops import rnn as R

    H = args[1].shape[1]
    zrc, rh_p = R.gru_zr_reference(*args)
    if rh is None:
        rh = rh_p
    zk, zp = zrc.clone(), zrc.clone()
    before = R.gru_cand_kernel.launches
    xp, h, w, b = args
    got = R.gru_cand_kernel(rh, xp, w, b, zk, h, save_c=save_c)
    want = R.gru_cand_reference(rh_p, xp, w, b, zp, h, save_c=save_c)
    torch.cuda.synchronize()
    assert R.gru_cand_kernel.launches == before + 1
    pairs = {"h": (got, want), "zr": (zk[:, :2 * H], zp[:, :2 * H])}
    if save_c:
        pairs["c"] = (zk[:, 2 * H:], zp[:, 2 * H:])
    else:   # c is left as it was
        assert torch.equal(zk[:, 2 * H:], zrc[:, 2 * H:])
    for label, (g, w) in pairs.items():
        assert g.dtype == w.dtype and g.shape == w.shape, label
        res = rw.rnn_error(g, w)
        assert res["within_tolerance"], (label, res)


@pytest.mark.parametrize("save_c", [True, False], ids=["c", "noc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [100, 520, 1280, 1288])
@pytest.mark.parametrize("B", [1, 17, 64, 65, 128])
def test_gru_cand_kernel_on_every_tile_edge(cuda, B, H, dtype, save_c):
    """B8 (16 units by 32 rows a block) against its plain version: B 1,
    17, 64, 65 and 128 (a block's 32 rows partly or wholly live, one row
    in a third row block); H 100 (H % 8 != 0: rows stage through
    registers), 520 and 1288 (the last unit block 8 of 16 units live, the
    last K chunk 8 of 64) and 1280 (whole tiles, the main path's); c
    saved into the acts' last H columns or not."""
    _check_gru_cand(_gru_args(cuda, B, H, dtype, [B, H, 8]), save_c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_cand_kernel_on_a_misaligned_rh(cuda, dtype):
    """B8 on an r h whose rows start 4 bytes past a 16-byte boundary (a
    contiguous view one element into a buffer), at H 1280: the register
    path, the same answer."""
    B, H = 64, 1280
    args = _gru_args(cuda, B, H, dtype, [B, H, 9])
    from paddle_tpu_torch.ops import rnn as R

    _, rh_p = R.gru_zr_reference(*args)
    buf = torch.empty(B * H + 1, dtype=torch.float32, device=cuda)
    rh = buf[1:].view(B, H)
    rh.copy_(rh_p)
    assert rh.is_contiguous() and rh.data_ptr() % 16 == 4
    _check_gru_cand(args, True, rh=rh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_block_kernel_at_the_edge_of_co_residency(cuda, dtype):
    """B6 on a grid of exactly as many blocks as the card holds at once
    (one unit block an SM, H = 8 x SMs, and as many 32-row blocks as an SM
    holds B6 blocks) against the plain version; one batch row more adds a
    row block, and the launch is refused with the limit."""
    from paddle_tpu_torch.ops import rnn as R

    dt = getattr(torch, dtype)
    cap = R.gru_block_capacity(dt, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cap % sms == 0 and cap >= R.gru_block_capacity_h100()
    H, B = R.BLOCK_UNITS * sms, R.BLOCK_ROWS * (cap // sms)
    assert R._grid_blocks(B, H) == cap
    _check_gru_kernels(_gru_args(cuda, B, H, dtype, [B, H]), True)
    args = _gru_args(cuda, B + 1, H, dtype, 0)
    with pytest.raises(EnforceError, match=f"cooperative launch of "
                       f"{cap + sms} blocks.*holds {cap}"):
        R.gru_step_kernel(*args)


def test_gru_block_kernel_refuses_a_grid_the_card_cannot_hold(cuda):
    from paddle_tpu_torch.ops import rnn as R

    case = rw.rnn_case("gru_tiled_f32_h1280", cuda)
    args = (case["xp"], case["h"], case["w_h"], case["bias"])
    assert R.gru_route(64, 1280, torch.float32, cuda) == "tiled"
    assert R.gru_route(64, 512, torch.float32, cuda) == "block"
    # B 256 at H 1280: 160 unit blocks x 8 row blocks, more than a card
    # of 132 SMs holds at any number of blocks an SM that shared memory
    # allows (4)
    wide = (case["xp"].repeat(4, 1), case["h"].repeat(4, 1), case["w_h"],
            case["bias"])
    with pytest.raises(EnforceError, match="cooperative launch of 1280"):
        R.gru_step_kernel(*wide)
    with pytest.raises(EnforceError, match="float32 or bfloat16"):
        R.gru_zr_kernel(case["xp"].double(), case["h"].double(),
                        case["w_h"], case["bias"])
    # the route the gate picks (B7 then B8) gives the plain answer
    got, _ = R.gru_fused_step(*args)
    zrc, rh = R.gru_zr_reference(*args)
    want = R.gru_cand_reference(rh, case["xp"], case["w_h"], case["bias"],
                                zrc, case["h"])
    assert rw.rnn_error(got, want)["within_tolerance"]


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_training_kernel_path_matches_plain_path(cuda, cell):
    """Three steps of a small classifier (dict 500, hidden 128, batch 8
    of 40 tokens) through the kernels, and the same steps through the
    plain versions on the card: costs within 1e-4 relative."""
    batch = rw.samples(5, bs=8, seq=40, dict_size=500)
    cfg = dict(dict_size=500, embed_size=32, hidden=128)

    def run():
        sgd = rw.build_trainer(cuda, cell, **cfg)
        costs = []
        sgd.train(rw.repeat_reader(batch, 3), event_handler=lambda ev:
                  costs.append(ev.cost)
                  if isinstance(ev, event.EndIteration) else None,
                  feeding=rw.FEEDING)
        return costs

    rw.reset_launches()
    kernel_costs = run()
    used = rw.launches()
    # 2 layers x 64 steps (40 buckets to 64) x 3 steps
    kern = "lstm_step" if cell == "lstm" else "gru_step"
    assert used == {k: (2 * 64 * 3 if k == kern else 0) for k in used}
    with rw.plain_rnn_path():
        plain_costs = run()
    assert rw.launches() == used
    np.testing.assert_allclose(kernel_costs, plain_costs, rtol=1e-4)
