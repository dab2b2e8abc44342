"""The serving engine's upper tier on the card: the ragged kernel (B4) on
the widened verify step of speculative decoding against its plain
version, and small engines on CUDA — greedy n-gram and draft speculation
token-identical to the same engine without speculation, a sampled
speculative replay bit-identical, the host tier's spill and swap-in
round trip identical to a cold re-prefill.

The verify blocks (``tools/ragged_cases.VERIFY_CASES``): 8 slots of
``1 + spec_k`` rows at consecutive positions, spec_k 1, 4 and 7, rows
straddling page boundaries, qpos -1 padding after the live rows, f32,
bf16 and int8 pages, bf16 queries on bf16 pages, head dims 128 and 16;
plus every head dim the engine's tests use (16, 32, 64) at spec_k 3 with
GQA.  Tolerances are ``ragged_cases.check``'s: 1e-4 abs + rel on f32 and
int8 pages, 1e-3 on bf16 pages against the plain version that rounds P as
the kernel does, bf16 outputs within one bf16 step plus 1e-3.

Every test needs a CUDA device and skips without one (the kernel has no
CPU mode).  The file imports neither ``jax`` nor ``paddle_tpu``::

    python -m pytest tests/test_torch_serving_spec_cuda.py -q --noconftest
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import decoder_lm_from_numpy, init_numpy_params
from paddle_tpu_torch.serving import (DecoderLM, SamplingParams,
                                      ServingEngine)
from paddle_tpu_torch.serving import decode_attention as tda
from paddle_tpu_torch.tools import ragged_cases as rc
from paddle_tpu_torch.tools import spec_workload as spw

pytestmark = pytest.mark.cuda

VOCAB = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(rc.VERIFY_CASES))
def test_verify_blocks_match_the_plain_version(cuda, name):
    (case,) = [c for n, c in rc.kernel_cases(
        cuda, {name: rc.VERIFY_CASES[name]})]
    tda.ragged_paged_attention_kernel.launches = 0
    got = tda.ragged_paged_attention_kernel(*rc.args(case),
                                            **rc.scales(case))
    torch.cuda.synchronize()
    assert tda.ragged_paged_attention_kernel.launches == 1
    res = rc.check(case, got)
    assert res["within_tolerance"], res


@pytest.mark.parametrize("d", [16, 32, 64])
def test_verify_blocks_with_gqa_at_the_test_widths(cuda, d):
    seqs = {"v": rc.verify_seqs(4)}
    old = dict(rc.SEQS)
    rc.SEQS.update(seqs)
    try:
        (case,) = [c for _, c in rc.kernel_cases(
            cuda, {"v": ("v", 4, 16, d, "float32", "float32")})]
    finally:
        rc.SEQS.clear()
        rc.SEQS.update(old)
    got = tda.ragged_paged_attention_kernel(*rc.args(case))
    assert rc.check(case, got)["within_tolerance"]


def _model(dev, seed=0, **cfg):
    m = DecoderLM(**dict(dict(vocab_size=VOCAB, num_layers=2, num_heads=2,
                              head_dim=16, max_positions=512), **cfg),
                  device=dev)
    return decoder_lm_from_numpy(init_numpy_params(m, seed), m)


def _engine(model, dev, **kw):
    return ServingEngine(model, eos_id=-1, page_size=16, num_pages=96,
                         max_pages_per_seq=16, max_slots=4,
                         buckets=(16, 32, 64), device=dev, **kw)


def _prompts():
    rng = np.random.default_rng(3)
    out = [rng.integers(2, VOCAB, n).tolist() for n in (5, 40, 90)]
    out += [np.tile(rng.integers(2, VOCAB, 4), 10).tolist()]
    return out


def test_greedy_speculation_is_token_identical_to_spec_off(cuda):
    model = _model(cuda)
    off = spw.drive(_engine(model, cuda), _prompts(), 24)
    draft = _model(cuda, seed=5, num_layers=1)
    for kw in (dict(spec_mode="ngram", spec_k=4),
               dict(spec_mode="draft", spec_k=3, draft_model=draft,
                    draft_params=draft),
               dict(spec_mode="draft", spec_k=7, draft_model=model,
                    draft_params=model)):
        eng = _engine(model, cuda, **kw)
        r = spw.drive(eng, _prompts(), 24)
        assert r["outputs"] == off["outputs"], kw
        assert r["snapshot"]["spec_tokens_proposed"] > 0
        eng.check_page_conservation()
    assert r["snapshot"]["spec_acceptance_rate"] > 0.9   # its own draft


def test_sampled_speculation_replays_bit_identical(cuda):
    model = _model(cuda)

    def sampling(i):
        return SamplingParams(temperature=0.8, top_p=0.95, seed=i)

    runs = [spw.drive(_engine(model, cuda, spec_mode="ngram", spec_k=4),
                      _prompts(), 16, sampling) for _ in range(2)]
    assert runs[0]["outputs"] == runs[1]["outputs"]


@pytest.mark.parametrize("fmt", ["stored", "int8"])
def test_host_tier_round_trip_on_the_card(cuda, fmt):
    model = _model(cuda)
    first, fillers, sharer = spw.host_prompts(VOCAB, prefix=64,
                                              tails=(8, 12),
                                              fillers=(80, 80))

    def engine(**kw):
        return ServingEngine(model, eos_id=-1, page_size=16, num_pages=13,
                             max_pages_per_seq=8, max_slots=2, device=cuda,
                             **kw)

    cold = engine(prefix_cache=False)
    rid = cold.submit(sharer, max_tokens=8)
    cold.run()
    eng = engine(host_tier_bytes=1 << 24, host_kv_dtype=fmt)
    r = spw.host_tier_drive(eng, first, fillers, sharer)
    assert r["snapshot"]["host_swap_ins"] > 0 and r["swapped_pages"] > 0
    if fmt == "stored":
        assert r["sharer"] == cold.result(rid)
        assert all(torch.equal(a, b) for a, b in
                   zip(r["before"][:2], r["after"][:2]))
    else:
        assert spw.int8_page_error(r["before"], r["after"])[
            "max_err_in_steps"] <= spw.INT8_STEP_BOUND
    eng.host_tier.check()
