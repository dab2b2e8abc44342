"""Head dims the CUDA kernels once refused (12, 100: not a multiple of 8;
320: above 256; 640 and 1024: above 512), on the CPU: the plain versions
of the flash kernels (B1-B3) and of the ragged kernel (B4) against the
JAX package's at those head dims, the kernels' width and tile rules, the
head dims above 512 taken (only a head dim below 1 raises), the KV pool's
padded rows, and a ``DecoderLM`` served at head_dim 12 and 100 token for
token against the JAX engine.

On the card a head dim that is not a multiple of 8 runs at the next
multiple of 8 on zero columns (q, k, v widened by the flash wrappers; the
pool allocated at that width by ``kv_cache``), 320 at the flash kernels'
compiled width 512 and in the ragged kernel's wide kernel, and 640 and
1024 on the wide flash kernels and the ragged wide kernel in chunks of
512 columns: that is held against these plain versions by
``tests/test_torch_ctr_cuda.py`` and ``tests/test_torch_seq_cuda.py``.

Tolerances as in ``tests/test_torch_flash_attention.py`` and
``tests/test_torch_ragged_attention.py``: f32 2e-5 absolute; bf16 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import attention as jattn
from paddle_tpu.serving import DecoderLM as JaxLM
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import decode_attention as jda
from paddle_tpu.serving.kv_cache import quantize_kv as jquantize

from paddle_tpu_torch.convert import decoder_lm_from_numpy
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import (DecoderLM, PagedKVConfig,
                                      ServingEngine, init_kv_pages)
from paddle_tpu_torch.serving import decode_attention as tda
from paddle_tpu_torch.serving import kv_cache as tkv

HEAD_DIMS = (12, 100, 320)
F32_ATOL = 2e-5


def _segments(b, s, cuts):
    out = np.full((b, s), len(cuts) + 1, np.int32)
    prev = 0
    for i, c in enumerate(list(cuts) + [s - 8]):
        out[:, prev:c] = i
        prev = c
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_flash_matches_jax_at_head_dim(d, dtype):
    """Output and q/k/v gradients of causal attention over packed
    segments with a padding segment."""
    rs = np.random.RandomState(d)
    b, s, h = 1, 96, 2
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    cot = rs.randn(b, s, h, d).astype(np.float32)
    seg = _segments(b, s, (30, 61))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))

    def jloss(*x):
        o = jattn.flash_attention(*x, segment_ids=jnp.asarray(seg),
                                  causal=True)
        return jnp.sum(o.astype(jnp.float32) * cot)

    jin = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    want = [jattn.flash_attention(*jin, segment_ids=jnp.asarray(seg),
                                  causal=True)]
    want += list(jax.grad(jloss, argnums=(0, 1, 2))(*jin))
    tin = [torch.from_numpy(x).to(tdt).requires_grad_(True)
           for x in (q, k, v)]
    out = tattn.flash_attention(*tin, segment_ids=torch.from_numpy(seg),
                                causal=True)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    got = [out] + [t.grad for t in tin]
    tol = dict(atol=F32_ATOL, rtol=0) if dtype == "f32" else \
        dict(atol=1e-2, rtol=1e-2)
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(
            g.detach().float().numpy(),
            np.asarray(jnp.asarray(w).astype(jnp.float32)), err_msg=name,
            **tol)


def test_kernel_width_and_tile_at_the_repaired_head_dims():
    assert [tattn.kernel_width(d) for d in HEAD_DIMS] == [16, 128, 512]
    assert [tattn.padded_head_dim(d) for d in HEAD_DIMS] == [16, 104, 320]
    assert [tattn.kernel_tile(d) for d in HEAD_DIMS] == [64, 64, 16]
    # the plain versions take their key blocks at the kernels' tile
    assert tattn._key_blocks(40, None, 320)[:2] == [(0, 16), (16, 32)]


@pytest.mark.parametrize("d", [513, 640, 0])
def test_head_dims_above_512_raise_with_the_limit(d, monkeypatch):
    """Head dims above 512 are taken (the wide kernels); only a head dim
    below 1 still raises, with the limit in the message."""
    err = tattn.kernel_shape_error((1, 64, 2, d), (1, 64, 2, d),
                                   torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    if d > 512:
        assert err is None and tda.kernel_shape_error(d, 4, 4) is None
        assert tda.attention_path(d, 8, num_heads=4, num_kv_heads=4,
                                  device="cuda") == "kernel"
        assert tattn.kernel_route((1, 64, 2, d), (1, 64, 2, d),
                                  torch.bfloat16, False) == "flash_attention"
        return
    assert err == f"flash kernels take head_dim of at least 1, got {d}"
    assert tda.kernel_shape_error(d, 4, 4) == \
        f"ragged kernel takes head_dim of at least 1, got {d}"
    # the serving chooser on a CUDA device raises with it
    with pytest.raises(EnforceError, match=f"at least 1, got {d}"):
        tda.attention_path(d, 8, num_heads=4, num_kv_heads=4,
                           device="cuda")


@pytest.mark.parametrize("d", [640, 1024])
def test_plain_flash_matches_jax_above_512(d):
    """B 1, S 64, 2 heads, f32: output and q/k/v gradients of causal
    attention over packed segments, at the wide kernels' head dims."""
    rs = np.random.RandomState(d)
    b, s, h = 1, 64, 2
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    cot = rs.randn(b, s, h, d).astype(np.float32)
    seg = _segments(b, s, (20, 41))

    def jloss(*x):
        return jnp.sum(jattn.flash_attention(
            *x, segment_ids=jnp.asarray(seg), causal=True) * cot)

    jin = [jnp.asarray(x) for x in (q, k, v)]
    want = [jattn.flash_attention(*jin, segment_ids=jnp.asarray(seg),
                                  causal=True)]
    want += list(jax.grad(jloss, argnums=(0, 1, 2))(*jin))
    tin = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tattn.flash_attention(*tin, segment_ids=torch.from_numpy(seg),
                                causal=True)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, w, g in zip(("out", "dq", "dk", "dv"), want,
                          [out] + [t.grad for t in tin]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=F32_ATOL, rtol=0, err_msg=name)
    assert tattn.kernel_width(d) is None and tattn.kernel_tile(d) == 16


@pytest.mark.parametrize("d", [640, 1024])
def test_plain_ragged_matches_jax_above_512(d):
    """f32 pages, GQA 2, decode rows and an offset prefill chunk."""
    rs = np.random.RandomState(d)
    q, kp, vp, kpp, vpp, rest = _case(rs, d, 2, 4)
    want = np.asarray(jda.ragged_paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        *map(jnp.asarray, rest)))
    got = tda.ragged_paged_attention_reference(
        torch.from_numpy(q), torch.from_numpy(kpp), torch.from_numpy(vpp),
        *map(torch.from_numpy, rest)).numpy()
    real = rest[3] >= 0
    np.testing.assert_allclose(got[real], want[real], atol=F32_ATOL,
                               rtol=F32_ATOL)


# (kv_len, q_rows, q_start): decode rows and an offset prefill chunk
SEQS = [(13, 1, 0), (9, 5, 4), (20, 1, 0), (0, 1, 0)]
PAGE, PM, NUM_PAGES = 8, 4, 24


def _case(rs, d, kvh, h):
    """A packed batch in the kernel packing; pages at the pool's padded
    width (columns past d zero) for the port and at d for JAX."""
    dp = tattn.padded_head_dim(d)
    kp = rs.randn(NUM_PAGES, PAGE, kvh, d).astype(np.float32)
    vp = rs.randn(NUM_PAGES, PAGE, kvh, d).astype(np.float32)
    table = np.zeros((len(SEQS), PM), np.int32)
    free = list(range(1, NUM_PAGES))
    rs.shuffle(free)
    row_seq, qpos = [], []
    for i, (n, qr, qs) in enumerate(SEQS):
        for j in range(-(-n // PAGE)):
            table[i, j] = free.pop()
        blocks = -(-qr // tda.BLOCK_ROWS)
        pos = [qs + r for r in range(qr)] if qr > 1 else [n - 1]
        qpos += pos + [-1] * (blocks * tda.BLOCK_ROWS - qr)
        row_seq += [i] * blocks * tda.BLOCK_ROWS
    q = rs.randn(len(qpos), h, d).astype(np.float32)
    rest = (table, np.asarray([s[0] for s in SEQS], np.int32),
            np.asarray(row_seq, np.int32), np.asarray(qpos, np.int32))
    pad = ((0, 0),) * 3 + ((0, dp - d),)
    return q, kp, vp, np.pad(kp, pad), np.pad(vp, pad), rest


@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_ragged_on_a_padded_pool_matches_jax(d, pages):
    """The port's plain version over pages at the padded width against
    the JAX plain version over pages at the head dim (int8 through the
    JAX quantizer, whose scales zero columns do not change; bf16 pages by
    a cast), GQA 2."""
    rs = np.random.RandomState(d)
    q, kp, vp, kpp, vpp, rest = _case(rs, d, 2, 4)
    jkw, tkw = {}, {}
    if pages == "int8":
        (kq, ks), (vq, vs) = jquantize(jnp.asarray(kp)), \
            jquantize(jnp.asarray(vp))
        jpages = (kq, vq)
        dp = kpp.shape[-1]
        tpages = tuple(torch.from_numpy(np.pad(np.asarray(x),
                                               ((0, 0),) * 3 +
                                               ((0, dp - d),)))
                       for x in (kq, vq))
        # the port's quantizer on the padded rows: the same int8 columns
        # and the same scales
        pk, pks = tkv.quantize_kv(torch.from_numpy(kpp))
        np.testing.assert_array_equal(pks.numpy(), np.asarray(ks))
        np.testing.assert_array_equal(pk.numpy()[..., :d], np.asarray(kq))
        jkw = dict(k_scale=ks, v_scale=vs)
        tkw = dict(k_scale=torch.tensor(np.asarray(ks)),
                   v_scale=torch.tensor(np.asarray(vs)))
    elif pages == "bfloat16":
        jpages = tuple(jnp.asarray(x, jnp.bfloat16) for x in (kp, vp))
        tpages = tuple(torch.from_numpy(x).to(torch.bfloat16)
                       for x in (kpp, vpp))
    else:
        jpages = (jnp.asarray(kp), jnp.asarray(vp))
        tpages = (torch.from_numpy(kpp), torch.from_numpy(vpp))
    want = np.asarray(jda.ragged_paged_attention_reference(
        jnp.asarray(q), *jpages, *map(jnp.asarray, rest), **jkw))
    got = tda.ragged_paged_attention_reference(
        torch.from_numpy(q), *tpages, *map(torch.from_numpy, rest),
        **tkw).numpy()
    real = rest[3] >= 0
    assert got.shape == q.shape
    np.testing.assert_allclose(got[real], want[real], atol=F32_ATOL,
                               rtol=F32_ATOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_pool_rows_are_padded_with_zero_columns(d):
    cfg = PagedKVConfig(num_layers=1, num_heads=2, head_dim=d, page_size=4,
                        num_pages=3, max_pages_per_seq=2)
    kv = init_kv_pages(cfg, device="cpu")
    assert kv.k.shape[-1] == cfg.pool_head_dim == tattn.padded_head_dim(d)
    k_new = torch.randn(2, 2, d)
    tkv.append_token(kv, 0, k_new, -k_new, torch.tensor([1, 2]),
                     torch.tensor([0, 3]))
    np.testing.assert_array_equal(kv.k[0, 1, 0, :, :d].numpy(),
                                  k_new[0].numpy())
    assert not kv.k[..., d:].any() and not kv.v[..., d:].any()
    assert cfg.bytes_per_page() == 2 * 4 * 2 * cfg.pool_head_dim * 4


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("d", [12, 100])
def test_decoder_lm_at_head_dim_serves_token_identical_to_jax(d, kv_dtype):
    """A ``DecoderLM`` at head_dim 12 and 100 (4 heads, 2 KV heads) behind
    the engine's kernel packing: the same tokens as the JAX engine."""
    cfg = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=d,
               max_positions=64, num_kv_heads=2)
    eng = dict(eos_id=1, page_size=8, num_pages=24, max_pages_per_seq=6,
               max_slots=4, buckets=(8, 16, 32), prefill_chunk=16)
    jm = JaxLM(**cfg)
    params = {k: np.asarray(v) for k, v in
              jm.init_params(jax.random.PRNGKey(1)).items()}
    tm = decoder_lm_from_numpy(params, DecoderLM(**cfg, device="cpu"))
    rs = np.random.RandomState(d)
    prompts = [rs.randint(2, 64, size=n).tolist() for n in (3, 21, 5, 12)]

    def serve(e):
        rids = [e.submit(p, max_tokens=6) for p in prompts]
        e.run(max_ticks=200)
        return [e.result(r) for r in rids]

    want = serve(JaxEngine(jm, {k: jnp.asarray(v) for k, v in
                                params.items()}, kv_dtype=kv_dtype,
                           use_kernel=False, **eng))
    teng = ServingEngine(tm, kv_dtype=kv_dtype, use_kernel=True,
                         device="cpu", **eng)
    got = serve(teng)
    assert all(got) and got == want
    assert teng._kv.k.shape[-1] == tattn.padded_head_dim(d)
