"""The port's CUDA kernel on the card: the ragged paged-attention kernel
against its plain PyTorch version, the decode-only view, and a small
ServingEngine on CUDA against the port's greedy oracle.

Every test here needs a CUDA device and skips without one (the kernel has
no CPU mode).  The file imports neither ``jax`` nor ``paddle_tpu``, so it
runs on a machine without JAX; there the repository's ``conftest.py``
(which imports JAX) is skipped::

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerances: 1e-4 abs + rel for f32 and int8 pages (the two versions sum
in different orders).  bf16 pages: 1e-3 against the plain version with
``round_p_tile``, which rounds the softmax probabilities to bf16 before
the PV product at the kernel's tiles (scores summed in another order can
still move a probability across a bf16 rounding step), and 2e-2 against
the plain version that does not round.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import decoder_lm_from_numpy, init_numpy_params
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import (DecoderLM, ServingEngine,
                                      greedy_decode_reference,
                                      reference_logits)
from paddle_tpu_torch.serving import decode_attention as tda
from paddle_tpu_torch.serving.kv_cache import quantize_kv

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


def _case(dev, seqs, kvh, h, pm=4, num_pages=24, seed=0):
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
        q=rng.standard_normal((len(qpos), h, D), np.float32),
        k_pages=rng.standard_normal((num_pages, PAGE, kvh, D), np.float32),
        v_pages=rng.standard_normal((num_pages, PAGE, kvh, D), np.float32),
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
            *args, round_p_tile=tda.KERNEL_TILE_TOKENS)
        torch.testing.assert_close(got[real], rounded[real], rtol=1e-3,
                                   atol=1e-3)
    # a block whose sequence holds nothing yields zeros, not NaN
    empty = c["row_seq"] == 1
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


def test_kernel_refuses_what_it_does_not_take(cuda):
    c = _case(cuda, SEQS, 16, 16)
    args = [c[k] for k in _ARGS]
    with pytest.raises(EnforceError, match="BLOCK_ROWS"):
        tda.ragged_paged_attention_kernel(args[0][:-1], *args[1:5],
                                          args[5][:-1], args[6][:-1])
    with pytest.raises(EnforceError, match="f32 queries"):
        tda.ragged_paged_attention_kernel(args[0].double(), *args[1:])
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
