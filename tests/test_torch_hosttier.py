"""The host page tier and the page copies of the port against the JAX
package, on the CPU.

- an evicted prefix spilled to the host tier and swapped back in serves
  token-identical to a cold re-prefill and to JAX's engine, under the
  ``'stored'`` and ``'int8'`` host formats, with equal tier counters;
- ``page_checksum`` equals JAX's on the same bytes; a payload corrupted
  after commit (one flipped byte, written by the test) is a miss that
  still serves the cold tokens; the fault hooks' torn write is caught;
- ``'int8'`` transcoding equals JAX's: the int8 codes exactly, the
  scales within 1e-6 (relative);
- LRU drop at the byte budget, and ``check()``'s conservation;
- ``read_pages``, ``write_pages`` and ``gather_kv`` against JAX's, on
  f32 and int8 pools (exact: they only move stored values).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import assert_serving_drained
from paddle_tpu.serving import DecoderLM as JaxLM
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch.convert import decoder_lm_from_numpy
from paddle_tpu_torch.serving import (DecoderLM, HostPageTier, KVPages,
                                      PageLeakError, ServingEngine,
                                      gather_kv, page_checksum, read_pages,
                                      write_pages)
from paddle_tpu_torch.serving.kv_cache import _CHAIN_SEED

PAGE = 4
CFG = dict(vocab_size=50, num_layers=1, num_heads=2, head_dim=8,
           max_positions=128)
ENGINE = dict(eos_id=1, page_size=PAGE, num_pages=16, max_pages_per_seq=8,
              max_slots=2, buckets=(8, 16), host_tier_bytes=1 << 20,
              swap_in_budget=4)
TIER_KEYS = ("pages_host", "host_swap_ins", "host_swap_outs",
             "host_corrupt", "host_dropped", "host_resident_bytes")


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(**CFG)
    params = {k: np.asarray(v) for k, v in
              jm.init_params(jax.random.PRNGKey(0)).items()}
    tm = decoder_lm_from_numpy(params, DecoderLM(**CFG, device="cpu"))
    return jm, params, tm


def _prompt(n=16, seed=0):
    return np.random.RandomState(seed).randint(2, 50, size=n).tolist()


def _roundtrip(eng, prompt, max_tokens=6, between=None):
    """Cold serve, evict everything (each page spills), warm serve on the
    same engine: (cold, warm) tokens."""
    r1 = eng.submit(list(prompt), max_tokens=max_tokens)
    eng.run()
    cold = eng.result(r1)
    eng.cache.flush()
    if between is not None:
        between(eng)
    r2 = eng.submit(list(prompt), max_tokens=max_tokens)
    eng.run()
    return cold, eng.result(r2)


@pytest.mark.parametrize("host_kv_dtype", ["stored", "int8"])
def test_swap_in_round_trip_matches_cold_prefill_and_jax(models,
                                                         host_kv_dtype):
    jm, params, tm = models
    jeng = JaxEngine(jm, params, use_kernel=False,
                     host_kv_dtype=host_kv_dtype, **ENGINE)
    want = _roundtrip(jeng, _prompt())
    for use_kernel in (False, True):
        eng = ServingEngine(tm, device="cpu", use_kernel=use_kernel,
                            host_kv_dtype=host_kv_dtype, **ENGINE)
        got = _roundtrip(eng, _prompt())
        assert got == want
        if host_kv_dtype == "stored":
            assert got[1] == got[0]       # bit-identical swap-in
        snap = eng.host_tier.snapshot()
        assert snap["host_swap_ins"] >= 4 and snap["host_corrupt"] == 0
        jsnap = jeng.host_tier.snapshot()
        assert {k: snap[k] for k in TIER_KEYS} == \
            {k: jsnap[k] for k in TIER_KEYS}
        assert eng.healthz()["host_swap_ins"] == snap["host_swap_ins"]
        assert eng._host_hits == jeng._host_hits >= 1
        assert_serving_drained(eng)


def test_corrupted_host_payload_is_a_miss(models):
    _, _, tm = models
    eng = ServingEngine(tm, device="cpu", **ENGINE)

    def flip(e):
        e.host_tier.flush()
        rec = next(iter(e.host_tier._index.values()))
        rec.k.reshape(-1).view(torch.uint8)[5] ^= 0x40   # one byte

    cold, warm = _roundtrip(eng, _prompt(), between=flip)
    assert warm == cold
    assert eng.host_tier.corrupt == 1
    assert_serving_drained(eng)


class _TornFirstSpill:
    """The tier's fault hooks, as the resilience slice's plan drives
    them: the first spill commits torn, host I/O stalls on tick 0."""

    def spill_is_torn(self, seq):
        return seq == 0

    def spill_bitflip_offset(self, seq, nbytes):
        return None

    def host_io_stalled(self, tick):
        return tick == 0


def test_fault_hooks_torn_spill_is_caught():
    tier = HostPageTier(1 << 20, faults=_TornFirstSpill())
    k = torch.randn(1, 1, PAGE, 2, 8)
    tier.spill(7, _CHAIN_SEED, (9,) * PAGE, (k, k + 1, None, None))
    assert tier.pump(0) == 0 and tier.spill_stall_ticks == 1
    assert tier.pump(1) == 1
    assert tier.take_verified(7, _CHAIN_SEED, (9,) * PAGE) is None
    assert tier.corrupt == 1
    tier.check()


@pytest.mark.parametrize("scaled", [False, True])
def test_page_checksum_matches_jax(scaled):
    rng = np.random.RandomState(0)
    k = rng.randn(2, 1, PAGE, 2, 8).astype(np.float32)
    v = rng.randn(2, 1, PAGE, 2, 8).astype(np.float32)
    ks = vs = None
    if scaled:
        k, v = (rng.randint(-127, 128, size=k.shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.rand(2, 1, PAGE, 2).astype(np.float32)
                  for _ in range(2))
    want = jkv.page_checksum(k, v, ks, vs)
    assert page_checksum(k, v, ks, vs) == want
    t = [None if x is None else torch.from_numpy(x) for x in (k, v, ks, vs)]
    assert page_checksum(*t) == want


def test_int8_transcoding_matches_jax():
    rng = np.random.RandomState(1)
    k = rng.randn(2, 1, PAGE, 2, 8).astype(np.float32) * 3
    v = rng.randn(2, 1, PAGE, 2, 8).astype(np.float32)
    mine, theirs = HostPageTier(1 << 20, dtype="int8"), \
        jkv.HostPageTier(1 << 20, dtype="int8")
    mine.spill(3, _CHAIN_SEED, (1,) * PAGE,
               (torch.from_numpy(k), torch.from_numpy(v), None, None))
    theirs.spill(3, _CHAIN_SEED, (1,) * PAGE, (k, v, None, None))
    mine.flush()
    theirs.flush()
    a = mine.take_verified(3, _CHAIN_SEED, (1,) * PAGE)
    b = theirs.take_verified(3, _CHAIN_SEED, (1,) * PAGE)
    np.testing.assert_array_equal(a.k.numpy(), b.k)
    np.testing.assert_array_equal(a.v.numpy(), b.v)
    np.testing.assert_allclose(a.k_scale.numpy(), b.k_scale, rtol=1e-6)
    np.testing.assert_allclose(a.v_scale.numpy(), b.v_scale, rtol=1e-6)
    assert a.nbytes == b.nbytes


def test_lru_drop_at_the_byte_budget_and_conservation():
    one = 2 * PAGE * 2 * 8 * 4               # k + v of one f32 page
    tier = HostPageTier(2 * one)
    for i in range(4):
        x = torch.full((1, 1, PAGE, 2, 8), float(i))
        tier.spill(10 + i, _CHAIN_SEED, (i,) * PAGE, (x, x, None, None))
    tier.flush()
    assert len(tier) == 2 and tier.dropped == 2
    assert tier.peek(10, _CHAIN_SEED, (0,) * PAGE) is None
    assert tier.peek(13, _CHAIN_SEED, (3,) * PAGE) is not None
    assert tier.peek(13, 123, (3,) * PAGE) is None          # wrong parent
    tier.check()
    tier.spills += 1                         # cook the books
    with pytest.raises(PageLeakError, match="HOSTTIER-LEAK"):
        tier.check()


@pytest.mark.parametrize("quantized", [False, True])
def test_read_write_gather_pages_match_jax(quantized):
    rng = np.random.RandomState(2)
    shape = (2, 6, PAGE, 2, 8)
    if quantized:
        arrs = [rng.randint(-127, 128, size=shape).astype(np.int8)
                for _ in range(2)] + \
            [rng.rand(*shape[:-1]).astype(np.float32) for _ in range(2)]
    else:
        arrs = [rng.randn(*shape).astype(np.float32) for _ in range(2)] + \
            [None, None]
    jpool = jkv.KVPages(*[None if a is None else jnp.asarray(a)
                          for a in arrs])
    tpool = KVPages(*[None if a is None else torch.from_numpy(a.copy())
                      for a in arrs])
    ids = [4, 1, 3]
    got, want = read_pages(tpool, ids), jkv.read_pages(jpool, ids)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    # write those pages back elsewhere
    dst = [2, 5, 0]
    write_pages(tpool, dst, *got)
    jpool = jkv.write_pages(jpool, jnp.asarray(dst, jnp.int32),
                            *[None if w is None else jnp.asarray(w)
                              for w in want])
    for g, w in zip(tpool, jpool):
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    table = np.array([[1, 2, 0], [5, 3, 4]], np.int32)
    for layer in range(2):
        for g, w in zip(gather_kv(tpool, layer, torch.from_numpy(table)),
                        jkv.gather_kv(jpool, layer, jnp.asarray(table))):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
