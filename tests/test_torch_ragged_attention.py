"""Parity of the port's ragged paged attention (``paddle_tpu_torch``)
against the JAX package: the plain PyTorch version against the Pallas
kernel in interpret mode and against the JAX plain version, on the mixed
prefill+decode cases of the JAX suite, MHA and GQA, f32/int8/bf16 pages,
with a length-0 sequence; at the CUDA kernel's other head dims (16, 32,
48, 64, 80, 96, 256) and groups (1, 3, 16), and with bf16 queries (a bf16
output, held to one bf16 step of the value plus 2e-5); the P rounding over
the kernel's spans (``round_p_span``) and its span rule.  The same numpy
inputs, made from a seed, go to both packages; only real rows (qpos >=
0) are compared — padded rows are arbitrary by contract.

Tolerances: 2e-5 abs+rel for f32 math on both sides (the two libraries
sum in different orders); bf16 pages against the Pallas kernel at 2e-2
for the plain version, which does not round the softmax probabilities to
bf16 before the PV product as the kernel does, and at 2e-5 for the plain
version with ``round_p_tile`` set to the page, which rounds them as the
kernel does.

The CUDA kernel itself runs only on the card: its tests are in
``tests/test_torch_kernels_cuda.py``.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.serving import decode_attention as jda
from paddle_tpu.serving.kv_cache import quantize_kv as jquantize
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import decode_attention as tda

F32_TOL = dict(rtol=2e-5, atol=2e-5)

# (kv_len, q_rows, q_start) per sequence; page 8, 4 pages a sequence —
# the MIXED_CASES of tests/test_serving_ragged.py, plus a case with a
# length-0 sequence
MIXED_CASES = [
    [(13, 1, 0), (9, 5, 4), (20, 1, 0)],          # decode + offset chunk
    [(8, 8, 0), (1, 1, 0), (32, 1, 0)],           # page-exact chunk, len-1
    [(27, 11, 16), (5, 1, 0), (17, 17, 0)],       # multi-block chunks
    [(0, 1, 0), (14, 6, 8), (3, 1, 0)],           # a length-0 sequence
]
PAGE, PM, NUM_PAGES, D = 8, 4, 32, 16


def _build_mixed(rng, seqs, kvh, h, page=PAGE, pm=PM, d=D,
                 num_pages=NUM_PAGES):
    """A sequence-packed batch in the kernel packing (each sequence's
    rows padded to whole BLOCK_ROWS blocks), as numpy arrays."""
    kp = rng.randn(num_pages, page, kvh, d).astype(np.float32)
    vp = rng.randn(num_pages, page, kvh, d).astype(np.float32)
    table = np.zeros((len(seqs), pm), np.int32)
    free = list(range(1, num_pages))
    rng.shuffle(free)
    row_seq, qpos = [], []
    for i, (n, qr, qs) in enumerate(seqs):
        for j in range(-(-n // page)):
            table[i, j] = free.pop()
        blocks = -(-qr // tda.BLOCK_ROWS)
        pos = [qs + r for r in range(qr)] if qr > 1 else [n - 1]
        qpos += pos + [-1] * (blocks * tda.BLOCK_ROWS - qr)
        row_seq += [i] * blocks * tda.BLOCK_ROWS
    q = rng.randn(len(qpos), h, d).astype(np.float32)
    return dict(q=q, k_pages=kp, v_pages=vp, page_table=table,
                kv_lens=np.asarray([s[0] for s in seqs], np.int32),
                row_seq=np.asarray(row_seq, np.int32),
                qpos=np.asarray(qpos, np.int32))


_ARGS = ("q", "k_pages", "v_pages", "page_table", "kv_lens", "row_seq",
         "qpos")


def _jax(case):
    return [jnp.asarray(case[k]) for k in _ARGS]


def _t(a):
    """numpy -> torch; numpy has no bf16, so bf16 goes through f32 (exact)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _torch(case):
    return [_t(case[k]) for k in _ARGS]


def _pages_as(case, dtype):
    """numpy pages in the storage dtype for both packages: int8 through
    the JAX quantizer (the port's is pinned equal in test_torch_kv_cache),
    bf16 by a cast the two libraries round identically."""
    out = dict(case)
    if dtype == "int8":
        for key, sc in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            qv, s = jquantize(jnp.asarray(case[key]))
            out[key], out[sc] = np.asarray(qv), np.asarray(s)
    elif dtype == "bfloat16":
        for key in ("k_pages", "v_pages"):
            out[key] = np.asarray(jnp.asarray(case[key], jnp.bfloat16))
    return out


def _torch_pages(case):
    """The port's view of a case, int8 scales as keyword tensors."""
    kw = {k: _t(case[k]) for k in ("k_scale", "v_scale") if k in case}
    return _torch(case), kw


@pytest.mark.parametrize("kvh,h", [(2, 2), (2, 4)], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", range(len(MIXED_CASES)))
def test_plain_matches_pallas_kernel_and_jax_reference(case, kvh, h):
    rng = np.random.RandomState(case)
    c = _build_mixed(rng, MIXED_CASES[case], kvh, h)
    real = c["qpos"] >= 0
    got = tda.ragged_paged_attention_reference(*_torch(c)).numpy()
    ker = np.asarray(jda._ragged_pallas(
        *_jax(c)[:3], None, None, *_jax(c)[3:], float(D) ** -0.5, True))
    ref = np.asarray(jda.ragged_paged_attention_reference(*_jax(c)))
    np.testing.assert_allclose(got[real], ker[real], **F32_TOL)
    np.testing.assert_allclose(got[real], ref[real], **F32_TOL)
    # the public entry on CPU tensors is the (row-blocked) plain version
    pub = tda.ragged_paged_attention(*_torch(c)).numpy()
    np.testing.assert_allclose(pub[real], got[real], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("case", [0, 2, 3])
def test_quantized_and_bf16_pages_match_jax(case, dtype):
    rng = np.random.RandomState(10 + case)
    c = _pages_as(_build_mixed(rng, MIXED_CASES[case], 2, 4), dtype)
    real = c["qpos"] >= 0
    args, kw = _torch_pages(c)
    got = tda.ragged_paged_attention_reference(*args, **kw).numpy()
    jkw = {k: jnp.asarray(c[k]) for k in ("k_scale", "v_scale") if k in c}
    ref = np.asarray(jda.ragged_paged_attention_reference(*_jax(c), **jkw))
    np.testing.assert_allclose(got[real], ref[real], **F32_TOL)
    ker = np.asarray(jda._ragged_pallas(
        *_jax(c)[:3], jkw.get("k_scale"), jkw.get("v_scale"), *_jax(c)[3:],
        float(D) ** -0.5, True))
    tol = F32_TOL if dtype == "int8" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[real], ker[real], **tol)


def test_length_zero_sequence_stays_finite():
    """A block whose sequence has nothing cached attends over nothing:
    the port's plain version stays finite there (padded rows are
    arbitrary but finite), matching the JAX reference."""
    c = _build_mixed(np.random.RandomState(3), MIXED_CASES[3], 2, 2)
    got = tda.ragged_paged_attention_reference(*_torch(c)).numpy()
    assert np.isfinite(got).all()
    ref = np.asarray(jda.ragged_paged_attention_reference(*_jax(c)))
    np.testing.assert_allclose(got, ref, **F32_TOL)


def test_blocked_plain_equals_unblocked():
    c = _build_mixed(np.random.RandomState(5), MIXED_CASES[2], 2, 4)
    want = tda.ragged_paged_attention_reference(*_torch(c))
    got = tda._ragged_reference_blocked(*_torch(c), block=16)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_expand_decode_rows_matches_jax():
    rng = np.random.RandomState(0)
    for rps in (1, 3, 8, 9):
        q = rng.randn(4 * rps, 2, D).astype(np.float32)
        qpos = rng.randint(0, 30, size=4 * rps).astype(np.int32)
        want = jda.expand_decode_rows(jnp.asarray(q), jnp.asarray(qpos), rps)
        got = tda.expand_decode_rows(torch.from_numpy(q),
                                     torch.from_numpy(qpos), rps)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_paged_decode_attention_matches_jax():
    rng = np.random.RandomState(7)
    kp = rng.randn(NUM_PAGES, PAGE, 2, D).astype(np.float32)
    vp = rng.randn(NUM_PAGES, PAGE, 2, D).astype(np.float32)
    q = rng.randn(3, 4, D).astype(np.float32)
    table = rng.randint(1, NUM_PAGES, size=(3, PM)).astype(np.int32)
    lengths = np.asarray([5, 17, 32], np.int32)
    want = np.asarray(jda.paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths)))
    got = tda.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_quant_drift_harness_matches_jax_and_fires():
    c = _build_mixed(np.random.RandomState(2), MIXED_CASES[2], 2, 4)
    want = jda.quant_parity_error(*_jax(c))
    got = tda.check_quant_drift(*_torch(c))
    assert 0.0 <= got <= tda.QUANT_DRIFT_BOUND
    assert got == pytest.approx(want, rel=1e-4, abs=1e-6)
    with pytest.raises(AssertionError, match="QUANT-DRIFT"):
        tda.check_quant_drift(*_torch(c), bound=0.0)


def test_attention_path_chooser(monkeypatch):
    kw = dict(num_heads=4, num_kv_heads=2)
    # CPU: the plain version either way; use_kernel=True picks the
    # kernel's packing so CPU runs cover it
    assert tda.attention_path(16, 8, device="cpu", **kw) == "reference"
    assert tda.attention_path(16, 8, device="cpu", use_kernel=True,
                              **kw) == "kernel"
    # CUDA: the kernel or an error — never a silent plain path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tda.attention_path(128, 128, num_heads=16, num_kv_heads=4,
                              device="cuda") == "kernel"
    with pytest.raises(EnforceError, match="use_kernel=False"):
        tda.attention_path(128, 128, num_heads=16, num_kv_heads=16,
                           device="cuda", use_kernel=False)
    # every head dim from 1 up, and any group that divides the heads; a
    # head dim below 1 raises with the limit
    for d in (1, 8, 12, 40, 64, 80, 96, 100, 192, 256, 264, 320, 512, 513,
              640, 1024):
        assert tda.attention_path(d, 128, num_heads=16, num_kv_heads=16,
                                  device="cuda") == "kernel"
    assert tda.attention_path(128, 128, num_heads=12, num_kv_heads=4,
                              device="cuda") == "kernel"
    for d in (0, -8):
        with pytest.raises(EnforceError,
                           match=f"head_dim of at least 1, got {d}"):
            tda.attention_path(d, 128, num_heads=16, num_kv_heads=16,
                               device="cuda")
    with pytest.raises(EnforceError, match="dividing num_heads"):
        tda.attention_path(128, 128, num_heads=12, num_kv_heads=5,
                           device="cuda")


def test_kernel_wrapper_refuses_cpu_tensors():
    c = _build_mixed(np.random.RandomState(1), MIXED_CASES[0], 2, 2)
    before = tda.ragged_paged_attention_kernel.launches
    with pytest.raises(EnforceError, match="CUDA tensors"):
        tda.ragged_paged_attention_kernel(*_torch(c))
    assert tda.ragged_paged_attention_kernel.launches == before



@pytest.mark.parametrize("case", range(len(MIXED_CASES)))
def test_round_p_plain_pins_pallas_bf16_rounding(case):
    rng = np.random.RandomState(20 + case)
    c = _pages_as(_build_mixed(rng, MIXED_CASES[case], 2, 4), "bfloat16")
    real = c["qpos"] >= 0
    got = tda.ragged_paged_attention_reference(
        *_torch(c), round_p_tile=PAGE).numpy()
    ker = np.asarray(jda._ragged_pallas(
        *_jax(c)[:3], None, None, *_jax(c)[3:], float(D) ** -0.5, True))
    np.testing.assert_allclose(got[real], ker[real], **F32_TOL)
    # f32 pages: the option changes nothing
    f = _build_mixed(rng, MIXED_CASES[case], 2, 4)
    np.testing.assert_array_equal(
        tda.ragged_paged_attention_reference(*_torch(f), round_p_tile=PAGE),
        tda.ragged_paged_attention_reference(*_torch(f)))


# head dims and groups of the CUDA kernel: (head_dim, num_kv_heads,
# num_heads); G 1, 3 and 16 (MQA); head dims between the compiled widths
# (48, 80, 96) too
SHAPES = [(16, 2, 2), (32, 2, 6), (64, 1, 16), (256, 1, 3), (16, 1, 16),
          (32, 4, 4), (256, 2, 32), (48, 1, 3), (80, 1, 16), (96, 2, 4)]


@pytest.mark.parametrize("d,kvh,h", SHAPES,
                         ids=[f"d{d}_g{h // kvh}" for d, kvh, h in SHAPES])
@pytest.mark.parametrize("case", [0, 2, 3])
def test_plain_matches_pallas_at_every_kernel_head_dim_and_group(case, d,
                                                                 kvh, h):
    """The plain version against the Pallas kernel (interpret mode) and
    the JAX plain version at the CUDA kernel's other head dims and at
    groups of 1, 3 and 16 query heads per KV head, f32 at 2e-5."""
    rng = np.random.RandomState(30 + case)
    c = _build_mixed(rng, MIXED_CASES[case], kvh, h, d=d)
    real = c["qpos"] >= 0
    got = tda.ragged_paged_attention_reference(*_torch(c)).numpy()
    ker = np.asarray(jda._ragged_pallas(
        *_jax(c)[:3], None, None, *_jax(c)[3:], float(d) ** -0.5, True))
    ref = np.asarray(jda.ragged_paged_attention_reference(*_jax(c)))
    np.testing.assert_allclose(got[real], ker[real], **F32_TOL)
    np.testing.assert_allclose(got[real], ref[real], **F32_TOL)


# bf16 queries: the output is bf16 in both packages; each side rounds one
# f32 result to bf16, so they agree to one bf16 step of the value
# (2**-7 relative) plus 2e-5 for the order of the f32 sums
BF16_OUT_TOL = dict(rtol=2.0 ** -7, atol=2e-5)


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d,kvh,h", [(16, 2, 6), (128, 1, 16)],
                         ids=["d16_g3", "d128_g16"])
def test_bf16_queries_match_jax(d, kvh, h, pages):
    """bf16 queries over f32, bf16 and int8 pages: the port's plain
    version returns bf16 and agrees with the JAX plain version; the Pallas
    kernel rounds P on bf16 pages at its page tiles, which the plain
    version does with ``round_p_tile`` set to the page."""
    rng = np.random.RandomState(40 + d)
    c = _pages_as(_build_mixed(rng, MIXED_CASES[2], kvh, h, d=d), pages)
    c["q"] = np.asarray(jnp.asarray(c["q"], jnp.bfloat16))
    real = c["qpos"] >= 0
    args, kw = _torch_pages(c)
    assert args[0].dtype == torch.bfloat16
    got = tda.ragged_paged_attention_reference(*args, **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jkw = {k: jnp.asarray(c[k]) for k in ("k_scale", "v_scale") if k in c}
    ref = jda.ragged_paged_attention_reference(*_jax(c), **jkw)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(got[real], np.asarray(ref, np.float32)[real],
                               **BF16_OUT_TOL)
    ker = jda._ragged_pallas(*_jax(c)[:3], jkw.get("k_scale"),
                             jkw.get("v_scale"), *_jax(c)[3:],
                             float(d) ** -0.5, True)
    assert ker.dtype == jnp.bfloat16
    rounded = tda.ragged_paged_attention_reference(
        *args, round_p_tile=PAGE, **kw).float().numpy()
    np.testing.assert_allclose(rounded[real],
                               np.asarray(ker, np.float32)[real],
                               **BF16_OUT_TOL)


@pytest.mark.parametrize("span", [8, 16])
def test_round_p_span_restarts_the_running_maximum(span):
    """``round_p_span``: the running maximum that P is rounded against
    restarts every ``span`` tokens, as in the CUDA kernel's split token
    axis.  A span covering the whole table changes nothing; shorter spans
    change the rounding only, so every result stays within the bf16
    rounding of P of the unrounded one."""
    rng = np.random.RandomState(50)
    c = _pages_as(_build_mixed(rng, MIXED_CASES[2], 2, 4), "bfloat16")
    real = c["qpos"] >= 0
    args = _torch(c)
    tile = 4
    whole = tda.ragged_paged_attention_reference(*args, round_p_tile=tile)
    np.testing.assert_array_equal(
        tda.ragged_paged_attention_reference(
            *args, round_p_tile=tile, round_p_span=PAGE * PM).numpy(),
        whole.numpy())
    split = tda.ragged_paged_attention_reference(
        *args, round_p_tile=tile, round_p_span=span).numpy()
    plain = tda.ragged_paged_attention_reference(*args).numpy()
    np.testing.assert_allclose(split[real], plain[real], rtol=2e-2,
                               atol=2e-2)
    # a span of one tile rounds each tile against its own maximum
    own = tda.ragged_paged_attention_reference(
        *args, round_p_tile=tile, round_p_span=tile).numpy()
    assert not np.array_equal(own[real], whole.numpy()[real])


def test_kernel_split_tokens():
    """At least 128 tokens a span, whole 32-token tiles, at most 16
    spans over the page table."""
    assert tda.kernel_split_tokens(1024) == 128
    assert tda.kernel_split_tokens(100) == 128
    assert tda.kernel_split_tokens(4096) == 256
    assert tda.kernel_split_tokens(5000) == 320
    for n in (1, 127, 2049, 32768, 100000):
        span = tda.kernel_split_tokens(n)
        assert span % tda.KERNEL_TILE_TOKENS == 0
        assert span >= tda.KERNEL_SPLIT_TOKENS
        assert -(-n // span) <= tda.KERNEL_MAX_SPLITS
