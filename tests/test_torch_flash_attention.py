"""The port's flash attention against the JAX package's, on the CPU.

On a CPU tensor ``paddle_tpu_torch.ops.attention.flash_attention`` runs
the plain versions of its three kernels (a loop over key blocks); here
they are held against ``paddle_tpu.ops.attention.flash_attention``, which
runs its Pallas kernels in interpret mode, and against ``mha_reference``.
Inputs are made with numpy from a seed and handed to both.  The cases are
those of ``tests/test_attention.py``: causal and not, packed segments
with a padding segment, cross-attention with Sq != Sk (causal with Sk >
Sq included), and bf16 inputs (non-causal attention without segment ids
runs in the cross-attention case); and the shapes the CUDA-core kernels
add: head dims 16 and 256, head dims between their compiled widths (48,
96), and lengths 32 and 96, which JAX runs at one block clamped to the
length.  The kernels' route, width and tile rules are checked here too.

Tolerances: f32 2e-5 absolute on the output and the q/k/v gradients (the
frameworks sum in other orders).  bf16: 1e-2 absolute and relative, about
two bf16 steps: both versions round P and dS to bf16 at the same places
and sum in f32, so they differ only where an f32 sum taken in another
order lands on the other side of a bf16 rounding step (of the rounded P,
or of the bf16 output).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn

from paddle_tpu_torch.ops import attention as tattn


def _segments(rng, b, s, n_seq, pad=0):
    """Packed segments at random cuts; the last ``pad`` slots take the id
    ``n_seq`` (padding, one more segment, as the feeder packs it)."""
    out = np.full((b, s), n_seq, np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s - pad), n_seq - 1,
                                  replace=False))
        prev = 0
        for seg, c in enumerate(list(cuts) + [s - pad]):
            out[i, prev:c] = seg
            prev = c
    return out


def _both(q, k, v, dtype, **kw):
    """Forward and q/k/v gradients of sum(O * cot) in both packages."""
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    cot = np.random.RandomState(5).standard_normal(q.shape).astype(
        np.float32)
    jkw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    tkw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}

    def jloss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, **jkw)
        return jnp.sum(o.astype(jnp.float32) * cot)

    jin = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    jout = jattn.flash_attention(*jin, **jkw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*jin)
    tin = [torch.from_numpy(x).to(tdt).requires_grad_(True)
           for x in (q, k, v)]
    tout = tattn.flash_attention(*tin, **tkw)
    (tout.float() * torch.from_numpy(cot)).sum().backward()
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return ([f32(jout)] + [f32(g) for g in jgrads],
            [tout.detach().float().numpy()] +
            [t.grad.float().numpy() for t in tin])


def _assert_close(want, got, dtype):
    tol = dict(atol=2e-5, rtol=0) if dtype == "f32" else \
        dict(atol=1e-2, rtol=1e-2)
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def _qkv(rng, b, sq, sk, h, d):
    return [rng.randn(b, s, h, d).astype(np.float32)
            for s in (sq, sk, sk)]


CASES = {
    # name: (b, sq, sk, h, d, block_q, block_k, segments, causal)
    "full_causal": (1, 128, 128, 2, 32, 64, 64, None, True),
    "segments_padding": (2, 128, 128, 2, 32, 64, 64, (4, 9), False),
    "segments_padding_causal": (1, 128, 128, 2, 32, 64, 64, (3, 7), True),
    "cross": (1, 64, 128, 2, 16, 32, 64, None, False),
    "cross_causal_sk_gt_sq": (1, 32, 128, 2, 16, 32, 32, None, True),
    # the CUDA kernels' other head dims and lengths that are not whole
    # 64-row tiles (JAX clamps its 128 block to the length)
    "d16_segments_causal": (1, 128, 128, 2, 16, 64, 64, (3, 7), True),
    "d256_segments_causal": (1, 128, 128, 2, 256, 64, 64, (3, 7), True),
    "sq32_causal": (1, 32, 32, 2, 32, 128, 128, None, True),
    "sq96_segments_padding_causal": (2, 96, 96, 2, 16, 128, 128, (3, 5),
                                     True),
    "sq96_d256_segments": (1, 96, 96, 2, 256, 128, 128, (2, 4), False),
    # head dims between the compiled widths (the kernels at widths 64 and
    # 128 with their columns past the head dim zero)
    "d48_segments_causal": (1, 128, 128, 2, 48, 64, 64, (3, 7), True),
    "d96_segments_padding": (2, 128, 128, 2, 96, 64, 64, (4, 9), False),
    "d96_cross_causal_sk_gt_sq": (1, 64, 128, 2, 96, 32, 64, None, True),
}


# every case in f32; bf16 on the training path's causal self-attention,
# on cross-attention, at head dims 16 and 256 and at lengths 32 and 96
RUNS = [(c, "f32") for c in sorted(CASES)] + [
    ("full_causal", "bf16"), ("segments_padding_causal", "bf16"),
    ("cross", "bf16"), ("d16_segments_causal", "bf16"),
    ("d256_segments_causal", "bf16"), ("sq32_causal", "bf16"),
    ("sq96_segments_padding_causal", "bf16"),
    ("d48_segments_causal", "bf16"), ("d96_segments_padding", "bf16")]


@pytest.mark.parametrize("case,dtype", RUNS)
def test_plain_flash_matches_jax_pallas(case, dtype):
    b, sq, sk, h, d, bq, bk, segs, causal = CASES[case]
    rng = np.random.RandomState(42)
    q, k, v = _qkv(rng, b, sq, sk, h, d)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    if segs is not None:
        kw["segment_ids"] = _segments(rng, b, sq, *segs)
    want, got = _both(q, k, v, dtype, **kw)
    _assert_close(want, got, dtype)
    if dtype == "f32":
        ref = jattn.mha_reference(
            *map(jnp.asarray, (q, k, v)), causal=causal,
            segment_ids=(None if segs is None
                         else jnp.asarray(kw["segment_ids"])))
        np.testing.assert_allclose(got[0], np.asarray(ref), atol=2e-5)


def test_pv_f32_flag_keeps_bf16_p_unrounded():
    """``FLAGS.attn_pv_f32``: with bf16 inputs the port keeps P and dS in
    f32, as JAX does under its flag of the same name."""
    from paddle_tpu.platform.flags import FLAGS as JFLAGS
    from paddle_tpu_torch.platform.flags import FLAGS as TFLAGS

    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 1, 128, 128, 2, 32)
    seg = _segments(rng, 1, 128, 3, 5)
    JFLAGS.attn_pv_f32 = TFLAGS.attn_pv_f32 = True
    try:
        want, got = _both(q, k, v, "bf16", segment_ids=seg, causal=True,
                          block_q=64, block_k=64)
    finally:
        JFLAGS.attn_pv_f32 = TFLAGS.attn_pv_f32 = False
    _assert_close(want, got, "bf16")


def test_row_with_no_matching_key_matches_plain_jax():
    """A query whose segment has no key at all (never on the LM path,
    where every token sees itself): the plain version averages V over
    every key, as JAX's ``mha_reference`` does, and its gradients are
    zero."""
    rng = np.random.RandomState(4)
    q, k, v = _qkv(rng, 1, 64, 64, 2, 16)
    q_seg = np.zeros((1, 64), np.int32)
    q_seg[0, 40:] = 7                       # no key carries segment 7
    kv_seg = np.zeros((1, 64), np.int32)
    ref = jattn.mha_reference(*map(jnp.asarray, (q, k, v)),
                              segment_ids=jnp.asarray(q_seg),
                              kv_segment_ids=jnp.asarray(kv_seg))
    tq = torch.from_numpy(q).requires_grad_(True)
    out = tattn.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                segment_ids=torch.from_numpy(q_seg),
                                kv_segment_ids=torch.from_numpy(kv_seg),
                                block_k=32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=2e-5)
    out.sum().backward()
    assert torch.all(tq.grad[0, 40:] == 0)


def test_cpu_path_launches_no_kernel_and_kernel_limits():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 64, 64, 2, 16))
    before = (tattn.flash_fwd_kernel.launches,
              tattn.flash_bwd_kv_kernel.launches,
              tattn.flash_bwd_dq_kernel.launches)
    tattn.flash_attention(q.requires_grad_(True), k, v,
                          causal=True).sum().backward()
    assert (tattn.flash_fwd_kernel.launches,
            tattn.flash_bwd_kv_kernel.launches,
            tattn.flash_bwd_dq_kernel.launches) == before
    err = tattn.kernel_shape_error
    assert err((1, 8192, 16, 128), (1, 8192, 16, 128), torch.bfloat16) \
        is None
    assert err((1, 128, 2, 64), (1, 256, 2, 64), torch.float32) is None
    # every head dim from 1 up and lengths that end in a partial tile
    # are taken; a head dim below 1 raises with the limit in the message
    for d in tattn.KERNEL_WIDTHS + (1, 8, 12, 48, 80, 96, 100, 112, 160,
                                    192, 264, 320, 513, 640):
        assert err((1, 96, 2, d), (1, 32, 2, d), torch.bfloat16) is None
    assert err((1, 100, 2, 128), (1, 100, 2, 128), torch.float32) is None
    for d in (0, -8):
        assert f"head_dim of at least 1, got {d}" in err(
            (1, 128, 2, d), (1, 128, 2, d), torch.float32)
    assert "float32 or bfloat16" in err((1, 64, 2, 128), (1, 64, 2, 128),
                                        torch.float16)
    assert "GQA" in err((1, 64, 4, 128), (1, 64, 2, 128), torch.float32)
    with pytest.raises(Exception, match="CUDA tensors"):
        tattn.flash_fwd_kernel(q, k, v, torch.zeros(1, 64, dtype=torch.int32),
                               torch.zeros(1, 64, dtype=torch.int32),
                               causal=True, sm_scale=0.25)


def test_train_slice_imports_no_jax():
    """The training slice's entry modules pull in neither ``jax`` nor
    ``paddle_tpu`` (note the prefix trap: ``paddle_tpu_torch`` starts
    with ``paddle_tpu``)."""
    code = ("import sys\n"
            "import paddle_tpu_torch.trainer\n"
            "import paddle_tpu_torch.models.transformer\n"
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu') or "
            "m.startswith(('jax.', 'paddle_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_each_shape_has_one_kernel_route():
    """bf16 with P rounded at head dim 64 or 128 on whole 64-row tiles
    goes to the wgmma kernels; every other shape the kernels take (f32,
    ``pv_f32``, the other head dims, a partial last tile) to the
    CUDA-core ones, the one compiled at the least width not below the
    head dim, which tile at 32 rows above head dim 128 (width 256) and at
    16 above 256 (width 512)."""
    route = tattn.kernel_route
    bf, f32 = torch.bfloat16, torch.float32
    wgmma, cores = "flash_attention_sm90", "flash_attention"
    assert route((1, 8192, 16, 128), (1, 8192, 16, 128), bf, False) == wgmma
    assert route((1, 576, 16, 64), (1, 2048, 16, 64), bf, False) == wgmma
    assert route((1, 8192, 16, 128), (1, 8192, 16, 128), bf, True) == cores
    assert route((1, 1024, 16, 128), (1, 1024, 16, 128), f32, False) == cores
    for d in (8, 16, 32, 48, 80, 96, 112, 160, 192, 256):
        assert route((1, 1024, 4, d), (1, 1024, 4, d), bf, False) == cores
    assert route((1, 96, 4, 128), (1, 96, 4, 128), bf, False) == cores
    assert route((1, 128, 4, 64), (1, 32, 4, 64), bf, False) == cores
    assert [tattn.kernel_tile(d) for d in tattn.KERNEL_WIDTHS] == \
        [64, 64, 64, 64, 32, 16]
    assert [tattn.kernel_width(d) for d in (8, 16, 24, 40, 48, 72, 96, 120,
                                            136, 192, 256)] == \
        [16, 16, 32, 64, 64, 128, 128, 128, 256, 256, 256]
    assert [tattn.kernel_width(d) for d in (1, 4, 12, 100, 264, 320, 512)] \
        == [16, 16, 16, 128, 512, 512, 512]
    assert [tattn.kernel_width(d) for d in (0, 513)] == [None] * 2
    assert [tattn.kernel_tile(d) for d in (96, 128, 136, 160, 192, 264,
                                           512)] == \
        [64, 64, 32, 32, 32, 16, 16]


def test_tile_ranges_of_a_partial_last_tile():
    """The per-tile segment-id ranges over a length that ends in a
    partial tile cover only the ids the tile holds."""
    seg = torch.tensor([[0] * 40 + [1] * 30 + [2] * 30], dtype=torch.int32)
    got = tattn._tile_ranges(seg, 32)
    assert got.tolist() == [[[0, 0], [0, 1], [1, 2], [2, 2]]]
    assert tattn._tile_ranges(seg).tolist() == [[[0, 1], [1, 2]]]


@pytest.mark.parametrize("d", [16, 96, 160, 256])
def test_plain_key_blocks_follow_the_kernel_tile(d):
    """The plain versions' default key block is the kernels' tile, with a
    shorter last block where it does not divide the length: forward and
    gradients equal the ones at an explicit block of that size, and stay
    within the bf16 rounding of P of a single block."""
    rng = np.random.RandomState(8)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in
                   _qkv(rng, 1, 96, 96, 2, d) + [rng.randn(1, 96, 2, d)
                                                 .astype(np.float32)])
    seg = torch.from_numpy(_segments(rng, 1, 96, 3, 5))
    cfg = dict(causal=True, sm_scale=d ** -0.5)
    tile = tattn.kernel_tile(d)
    o, lse = tattn.flash_fwd_reference(q, k, v, seg, seg, **cfg)
    o2, lse2 = tattn.flash_fwd_reference(q, k, v, seg, seg, block_k=tile,
                                         **cfg)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    one, _ = tattn.flash_fwd_reference(q, k, v, seg, seg, block_k=96, **cfg)
    np.testing.assert_allclose(o.float().numpy(), one.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    args = (q, k, v, seg, seg, do, lse, tattn.attention_delta(o, do))
    dk, dv = tattn.flash_bwd_kv_reference(*args, **cfg)
    dk2, dv2 = tattn.flash_bwd_kv_reference(*args, block_k=tile, **cfg)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(tattn.flash_bwd_dq_reference(*args, **cfg),
                       tattn.flash_bwd_dq_reference(*args, block_k=tile,
                                                    **cfg))
