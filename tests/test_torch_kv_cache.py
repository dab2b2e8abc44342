"""Parity of the port's paged KV cache (``paddle_tpu_torch``) against the
JAX package: the device ops (``quantize_kv``, ``append_token``,
``zero_pages``, ``fork_page``) on the same numpy inputs, and the
pure-Python host side (``PagePool``, ``PrefixCache``, the scheduler's
packing helpers) driven through the same operation sequences.

The device ops move or round values without arithmetic that could sum in
another order, so their results must be EQUAL (int8 values, scales and
f32 pages bit for bit).  The port updates the pool in place where the
JAX functions return a new pool.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu_torch.platform.enforce import EnforceError
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import scheduler as tsched

L, P, PAGE, KVH, D = 2, 6, 4, 2, 8


def _pool(dtype):
    jcfg = jkv.PagedKVConfig(num_layers=L, num_heads=4, head_dim=D,
                             page_size=PAGE, num_pages=P,
                             max_pages_per_seq=3,
                             dtype=jkv.resolve_kv_dtype(dtype),
                             num_kv_heads=KVH)
    tcfg = tkv.PagedKVConfig(num_layers=L, num_heads=4, head_dim=D,
                             page_size=PAGE, num_pages=P,
                             max_pages_per_seq=3,
                             dtype=tkv.resolve_kv_dtype(dtype),
                             num_kv_heads=KVH)
    assert tcfg.bytes_per_page() == jcfg.bytes_per_page()
    return jkv.init_kv_pages(jcfg), tkv.init_kv_pages(tcfg, device="cpu")


def _assert_pool_equal(jpool, tpool):
    for a, b in zip(jpool, tpool):
        if a is None:
            assert b is None
            continue
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                       else a)
        np.testing.assert_array_equal(b.float().numpy() if
                                      b.dtype == torch.bfloat16
                                      else b.numpy(), a)


def test_quantize_kv_bit_identical_to_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 3, D).astype(np.float32) * 3.0
    x[1, 2] = 0.0                                  # an all-zero row
    x[2, 0, :4] = [0.5, -0.5, 1.5, 127.0 / 254.0]  # exact .5 ties
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq, ts).numpy(),
        np.asarray(jkv.dequantize_kv(jq, js)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_append_token_matches_jax(dtype):
    """Rows scatter into (page, offset) slots; masked rows write ZEROS to
    the null page, duplicates included."""
    rng = np.random.RandomState(1)
    jp, tp = _pool(dtype)
    pages = np.asarray([3, 1, 0, 0, 5], np.int32)
    offs = np.asarray([0, 3, 0, 0, 2], np.int32)
    k = rng.randn(5, KVH, D).astype(np.float32)
    v = rng.randn(5, KVH, D).astype(np.float32)
    k[2:4] = 0.0
    v[2:4] = 0.0
    for layer in range(L):
        jp = jkv.append_token(jp, layer, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pages), jnp.asarray(offs))
        out = tkv.append_token(tp, layer, torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pages),
                               torch.from_numpy(offs))
        assert out is tp                       # in place, same pool
    _assert_pool_equal(jp, tp)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_zero_pages_and_fork_page_match_jax(dtype):
    rng = np.random.RandomState(2)
    jp, tp = _pool(dtype)
    n = P * PAGE
    k = rng.randn(n, KVH, D).astype(np.float32)
    v = rng.randn(n, KVH, D).astype(np.float32)
    pages = np.repeat(np.arange(P, dtype=np.int32), PAGE)
    offs = np.tile(np.arange(PAGE, dtype=np.int32), P)
    for layer in range(L):
        jp = jkv.append_token(jp, layer, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pages), jnp.asarray(offs))
        tkv.append_token(tp, layer, torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(pages),
                         torch.from_numpy(offs))
    jp = jkv.fork_page(jp, jnp.asarray(2, jnp.int32),
                       jnp.asarray(4, jnp.int32))
    tkv.fork_page(tp, 2, 4)
    _assert_pool_equal(jp, tp)
    jp = jkv.zero_pages(jp, jnp.asarray([1, 4], jnp.int32))
    tkv.zero_pages(tp, [1, 4])
    _assert_pool_equal(jp, tp)


def test_pages_for_budget_and_spans_match_jax():
    for dtype in ("float32", "bfloat16", "int8"):
        assert tkv.pages_for_budget(1 << 20, 2, 4, 16, 8, dtype,
                                    num_kv_heads=2) == \
            jkv.pages_for_budget(1 << 20, 2, 4, 16, 8, dtype,
                                 num_kv_heads=2)
    for start, count in ((0, 1), (7, 2), (8, 8), (5, 0), (3, 17)):
        assert list(tkv.pages_spanned(start, count, 8)) == \
            list(jkv.pages_spanned(start, count, 8))
    with pytest.raises(EnforceError, match="serving_kv_dtype"):
        tkv.resolve_kv_dtype("float16")


def _pool_state(pool):
    return (list(pool._free), dict(pool._refs), set(pool._cached),
            pool.num_free, pool.num_live, pool.num_reclaimable,
            pool.total_refs)


def test_page_pool_refcount_and_cow_sequence_matches_jax():
    """One sequence of pool/cache operations — share, COW pin, park,
    revive, evict, forget — on both packages leaves identical state."""
    states = []
    for kv in (jkv, tkv):
        pool = kv.PagePool(10)
        cache = kv.PrefixCache(pool, page_size=4)
        toks = list(range(100, 112))               # 3 full blocks
        a = pool.alloc(3)
        cache.insert(toks, a, upto=12)
        hit, n = cache.lookup(toks, touch=True)
        assert hit == a and n == 12
        # a sharer refs two pages and pins the third for a COW fork
        pool.ref(hit[:2])
        pool.ref([hit[2]])
        (dst,) = pool.alloc(1)
        pool.free([hit[2]])                        # fork consumed the pin
        pool.free(a)                               # the writer finishes
        assert pool.refcount(a[0]) == 1 and pool.refcount(a[2]) == 0
        assert cache.evict(5) == 1                 # only a[2] is parked
        cache.forget([a[1]])                       # still held: not freed
        pool.free(hit[:2] + [dst])
        states.append(_pool_state(pool) + (len(cache), cache.hits,
                                           cache.evictions))
        with pytest.raises(Exception, match="double free"):
            pool.free([dst])
    assert states[0] == states[1]


def test_prefix_cache_lookup_verifies_collisions_like_jax():
    for kv in (jkv, tkv):
        pool = kv.PagePool(10)
        cache = kv.PrefixCache(pool, page_size=2,
                               hash_fn=lambda prev, blk: 7)
        a = pool.alloc(1)
        cache.insert([5, 6], a, upto=2)
        assert cache.lookup([8, 9]) == ([], 0)     # verified away
        b = pool.alloc(1)
        cache.insert([8, 9], b, upto=2)
        assert len(cache) == 1                     # existing entry wins
        assert cache.lookup([5, 6]) == (a, 2)
    toks = list(range(37))
    assert tkv.prefix_chain_hashes(toks, 8) == jkv.prefix_chain_hashes(toks, 8)


def test_scheduler_packing_helpers_match_jax():
    for length in (1, 8, 31, 33, 200, 513, 700):
        assert tsched.bucket_for(length, (8, 16, 32, 256), 512) == \
            jsched.bucket_for(length, (8, 16, 32, 256), 512)

    def reqs(mod):
        out = []
        for plen, done in ((30, 0), (9, 4), (40, 32), (5, 5)):
            r = mod.Request(prompt=list(range(2, 2 + plen)), max_tokens=3)
            r.cache_len = done
            out.append(r)
        return out

    for chunk, align, budget in ((8, 1, 16), (8, 8, 16), (0, 8, 64),
                                 (16, 8, 8)):
        got = tsched.pack_prefill_chunks(reqs(tsched), chunk, align, budget)
        want = jsched.pack_prefill_chunks(reqs(jsched), chunk, align, budget)
        assert [(s, n, r) for _, s, n, r in got[0]] == \
            [(s, n, r) for _, s, n, r in want[0]]
        assert got[1] == want[1]
