"""Block-paged KV cache for the serving engine (the port of
``paddle_tpu/serving/kv_cache.py`` minus the host-RAM tier and the page
migration plane).

K/V live in a preallocated pool of fixed-size pages ``[L, num_pages,
page_size, H_kv, D]``; each sequence owns an ordered list of page ids —
its page table — and grows one page at a time.

Device side: ``append_token`` / ``write_prompt`` scatter new K/V into
pages, ``zero_pages`` scrubs, ``fork_page`` copies.  Where the JAX
package's functions are pure and rely on buffer donation (the jitted step
donates the pool and gets it back), these update the pool tensors IN
PLACE and return the same :class:`KVPages` — eager PyTorch has no
donation, and an out-of-place update would copy the whole pool per tick.

Host side: :class:`PagePool` is the refcounted free list and
:class:`PrefixCache` the chained-hash index over full pages, both pure
Python and copied close to verbatim.

Page 0 is reserved as the null page: masked writes are steered to it
(always with zero payloads), and no live sequence is ever granted it.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Set, Tuple)

import torch

from paddle_tpu_torch.ops.attention import padded_head_dim, widen_head_dim
from paddle_tpu_torch.platform.device import DeviceLike, resolve_device
from paddle_tpu_torch.platform.enforce import enforce_that

NULL_PAGE = 0

_QMAX = 127.0        # symmetric int8 range; -128 is never produced
_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}


def resolve_kv_dtype(name) -> torch.dtype:
    """Map a ``FLAGS.serving_kv_dtype`` string (or a torch dtype) to the
    pool's storage dtype."""
    if isinstance(name, str):
        enforce_that(name in _KV_DTYPES,
                     f"serving_kv_dtype must be one of {sorted(_KV_DTYPES)},"
                     f" got {name!r}", context="serving")
        return _KV_DTYPES[name]
    enforce_that(name in _KV_DTYPES.values(),
                 f"unsupported KV dtype {name!r}", context="serving")
    return name


@dataclass(frozen=True)
class PagedKVConfig:
    """Static geometry of the paged pool (one pool shared by all layers).

    ``num_kv_heads`` (None = ``num_heads``) is the GQA knob;
    ``dtype=torch.int8`` turns on quantized pages with per-token,
    per-kv-head f32 scales."""

    num_layers: int
    num_heads: int
    head_dim: int
    page_size: int
    num_pages: int           # includes the reserved null page 0
    max_pages_per_seq: int   # page-table width
    dtype: torch.dtype = torch.float32
    num_kv_heads: Optional[int] = None   # None = MHA (== num_heads)

    def __post_init__(self):
        enforce_that(self.num_pages >= 2,
                     "need at least one usable page beyond the null page",
                     context="serving")
        enforce_that(self.page_size >= 1 and self.max_pages_per_seq >= 1,
                     "page_size and max_pages_per_seq must be positive",
                     context="serving")
        enforce_that(self.num_heads % self.kv_heads == 0,
                     f"num_kv_heads ({self.kv_heads}) must divide "
                     f"num_heads ({self.num_heads})", context="serving")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads if self.num_kv_heads else self.num_heads

    @property
    def quantized(self) -> bool:
        return self.dtype == torch.int8

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq

    @property
    def pool_head_dim(self) -> int:
        """Columns of a pool row: the head dim padded to a multiple of 8
        (the ragged kernel's row width), the columns past it zero."""
        return padded_head_dim(self.head_dim)

    def bytes_per_page(self) -> int:
        """K + V bytes one page costs across all layers, scales included."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        per = (self.num_layers * self.page_size * self.kv_heads *
               self.pool_head_dim * itemsize)
        if self.quantized:
            per += self.num_layers * self.page_size * self.kv_heads * 4
        return 2 * per

    def kv_bytes(self) -> int:
        return self.num_pages * self.bytes_per_page()


def pages_for_budget(pool_bytes: int, num_layers: int, num_heads: int,
                     head_dim: int, page_size: int, dtype,
                     num_kv_heads: Optional[int] = None) -> int:
    """Total ``num_pages`` (null page included) that fit in a pool byte
    budget: int8 pages admit ~4x the f32 pages for the same bytes."""
    probe = PagedKVConfig(num_layers=num_layers, num_heads=num_heads,
                          head_dim=head_dim, page_size=page_size,
                          num_pages=2, max_pages_per_seq=1,
                          dtype=resolve_kv_dtype(dtype),
                          num_kv_heads=num_kv_heads)
    return max(2, int(pool_bytes) // probe.bytes_per_page())


class KVPages(NamedTuple):
    """The device-resident pool: ``k``/``v`` are [num_layers, num_pages,
    page_size, num_kv_heads, pool_head_dim] (the columns past head_dim
    zero); int8 pools add ``k_scale``/
    ``v_scale`` [num_layers, num_pages, page_size, num_kv_heads] f32."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_pages(cfg: PagedKVConfig, device: DeviceLike = None) -> KVPages:
    """Allocate a zeroed pool on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_pages, cfg.page_size, cfg.kv_heads,
             cfg.pool_head_dim)
    if cfg.quantized:
        return KVPages(torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape, dtype=torch.int8, device=dev),
                       torch.zeros(shape[:-1], device=dev),
                       torch.zeros(shape[:-1], device=dev))
    return KVPages(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))


def quantize_kv(x: torch.Tensor):
    """Symmetric per-token, per-head int8 quantization of K/V rows.

    x: [..., D] float.  Returns ``(q, scale)`` with ``q`` int8 [..., D]
    and ``scale`` f32 [...].  ``torch.round`` rounds half to even, as
    ``jnp.round`` does; all-zero rows quantize to (0, 1e-20/127)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-20) / _QMAX
    q = torch.clamp(torch.round(xf / scale[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The one dequant rule the kernel, the gather reference and the
    parity harness share: ``q * scale`` in f32."""
    return q.float() * scale[..., None]


def append_token(kv: KVPages, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor, page_ids: torch.Tensor,
                 offsets: torch.Tensor) -> KVPages:
    """Scatter one K/V row per ragged batch row into its page, IN PLACE.

    k_new/v_new: [B, H_kv, D]; page_ids/offsets: [B] integer.  Masked
    rows pass ``page_ids == NULL_PAGE`` with ZERO payloads: a scatter
    with duplicate indices keeps an arbitrary one of the duplicates,
    which is harmless only while every duplicate is the same zero row.
    Quantized pools quantize on write (the zero columns of a padded row
    leave its absmax scale as it is)."""
    idx = (page_ids, offsets)
    width = kv.k.shape[-1]
    k_new, v_new = widen_head_dim(k_new, width), widen_head_dim(v_new, width)
    if kv.quantized:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        kv.k[layer].index_put_(idx, kq)
        kv.v[layer].index_put_(idx, vq)
        kv.k_scale[layer].index_put_(idx, ks)
        kv.v_scale[layer].index_put_(idx, vs)
    else:
        kv.k[layer].index_put_(idx, k_new.to(kv.k.dtype))
        kv.v[layer].index_put_(idx, v_new.to(kv.v.dtype))
    return kv


def write_prompt(kv: KVPages, layer: int, k_seq: torch.Tensor,
                 v_seq: torch.Tensor, dest_pages: torch.Tensor,
                 offsets: torch.Tensor) -> KVPages:
    """Scatter a whole (padded) prompt into pages — the same one-row-per-
    position scatter as :func:`append_token`."""
    return append_token(kv, layer, k_seq, v_seq, dest_pages, offsets)


def pages_spanned(start: int, count: int, page_size: int) -> range:
    """Page-table indices a write of ``count`` consecutive positions
    starting at ``start`` touches (empty for ``count <= 0``)."""
    if count <= 0:
        return range(0)
    return range(start // page_size, (start + count - 1) // page_size + 1)


def zero_pages(kv: KVPages, page_ids) -> KVPages:
    """Zero whole pages across every layer, IN PLACE (failed-request
    scrub: stale inf/NaN K/V must not reach the next owner)."""
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=kv.k.device)
    kv.k[:, ids] = 0
    kv.v[:, ids] = 0
    if kv.quantized:
        kv.k_scale[:, ids] = 0.0
        kv.v_scale[:, ids] = 0.0
    return kv


def fork_page(kv: KVPages, src: int, dst: int) -> KVPages:
    """Copy one page's K/V (and scales) across every layer, IN PLACE —
    the copy-on-write fork of a shared cached page."""
    src, dst = int(src), int(dst)
    kv.k[:, dst] = kv.k[:, src]
    kv.v[:, dst] = kv.v[:, src]
    if kv.quantized:
        kv.k_scale[:, dst] = kv.k_scale[:, src]
        kv.v_scale[:, dst] = kv.v_scale[:, src]
    return kv


@dataclass
class PagePool:
    """Host-side refcounted allocator over page ids 1..num_pages-1 (0 is
    the null page).  Allocation is all-or-nothing.

    ``alloc`` grants pages at refcount 1, ``ref`` adds a holder, ``free``
    drops one — a page returns to the free list only at refcount 0, and
    not even then if a :class:`PrefixCache` registered it: cached pages
    at refcount 0 are reclaimable, parked until ``release_cached``.  The
    free list is LIFO over ascending ids, mirrored by a set."""

    num_pages: int
    _free: List[int] = field(default_factory=list)
    _free_set: Set[int] = field(default_factory=set)
    _refs: Dict[int, int] = field(default_factory=dict)
    _cached: Set[int] = field(default_factory=set)

    def __post_init__(self):
        enforce_that(self.num_pages >= 2, "pool needs >= 2 pages",
                     context="serving")
        self._free = list(range(self.num_pages - 1, NULL_PAGE, -1))
        self._free_set = set(self._free)
        self._refs = {}
        self._cached = set()

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_usable(self) -> int:
        return self.num_pages - 1

    @property
    def num_in_use(self) -> int:
        """Pages not on the free list: live plus cached at refcount 0."""
        return len(self._refs)

    @property
    def num_live(self) -> int:
        return sum(1 for c in self._refs.values() if c > 0)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    @property
    def num_reclaimable(self) -> int:
        return sum(1 for p in self._cached if self._refs[p] == 0)

    @property
    def total_refs(self) -> int:
        """Sum of all refcounts (the REF-LEAK invariant's right side)."""
        return sum(self._refs.values())

    def refcount(self, p: int) -> int:
        return self._refs.get(p, 0)

    def is_cached(self, p: int) -> bool:
        return p in self._cached

    def alloc(self, n: int) -> Optional[List[int]]:
        """Grant ``n`` pages at refcount 1 each, or None (no change)."""
        if n < 0 or n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._free_set.discard(p)
            self._refs[p] = 1
        return got

    def ref(self, pages: Sequence[int]) -> None:
        for p in pages:
            enforce_that(p in self._refs, f"ref of free page {p}",
                         context="serving")
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one holder per page."""
        for p in pages:
            enforce_that(p != NULL_PAGE, "cannot free the null page",
                         context="serving")
            enforce_that(p not in self._free_set,
                         f"double free of page {p}", context="serving")
            enforce_that(self._refs.get(p, 0) > 0,
                         f"free of unreferenced page {p}", context="serving")
            self._refs[p] -= 1
            if self._refs[p] == 0 and p not in self._cached:
                del self._refs[p]
                self._free.append(p)
                self._free_set.add(p)

    def mark_cached(self, p: int) -> None:
        enforce_that(p in self._refs, f"cannot cache free page {p}",
                     context="serving")
        self._cached.add(p)

    def unmark_cached(self, p: int) -> None:
        """Withdraw a cache registration; a page parked at refcount 0 is
        freed on the spot."""
        if p not in self._cached:
            return
        self._cached.discard(p)
        if self._refs.get(p, 0) == 0:
            del self._refs[p]
            self._free.append(p)
            self._free_set.add(p)

    def release_cached(self, p: int) -> None:
        """Eviction: return a refcount-0 cached page to the free list."""
        enforce_that(p in self._cached, f"page {p} is not cached",
                     context="serving")
        enforce_that(self._refs.get(p, 0) == 0,
                     f"evicting page {p} with live holders",
                     context="serving")
        self._cached.discard(p)
        del self._refs[p]
        self._free.append(p)
        self._free_set.add(p)


_CHAIN_SEED = 0x9E3779B9   # any fixed non-zero start for the hash chain


def _chain_hash(prev: int, block: Tuple[int, ...]) -> int:
    """Chained block hash (Python's int-tuple hash is not seed-randomized,
    so it is stable across processes); collisions are verified away."""
    return hash((prev, block))


def prefix_chain_hashes(tokens: Sequence[int], page_size: int,
                        hash_fn: Optional[Callable[[int, Tuple[int, ...]],
                                                   int]] = None) -> List[int]:
    """One chained hash per FULL page block of ``tokens``, from
    :data:`_CHAIN_SEED` — exactly the keys ``lookup``/``insert`` walk."""
    hf = hash_fn or _chain_hash
    page = int(page_size)
    h = _CHAIN_SEED
    out: List[int] = []
    for j in range(len(tokens) // page):
        h = hf(h, tuple(tokens[j * page:(j + 1) * page]))
        out.append(h)
    return out


@dataclass
class _CacheEntry:
    page: int                 # the page holding this block's K/V
    tokens: Tuple[int, ...]   # the block itself (collision verification)
    prev: int                 # parent link hash (chain verification)


class PrefixCache:
    """Hash-chained index over FULL KV pages for automatic prefix caching.

    Only full pages are indexed; keys are chained so a hit on page j
    implies the whole prefix matched; every hit is verified against the
    stored tokens and parent link; entries are LRU-ordered and
    :meth:`evict` frees refcount-0 pages oldest-first.  The cache holds
    no refcounts of its own."""

    def __init__(self, pool: PagePool, page_size: int,
                 hash_fn: Optional[Callable[[int, Tuple[int, ...]], int]]
                 = None):
        enforce_that(page_size >= 1, "page_size must be positive",
                     context="serving")
        self.pool = pool
        self.page_size = int(page_size)
        self._hash = hash_fn or _chain_hash
        self._index: "OrderedDict[int, _CacheEntry]" = OrderedDict()
        self.hits = 0          # lookups that matched >= 1 page
        self.misses = 0        # lookups that matched none
        self.evictions = 0     # pages evicted

    def __len__(self) -> int:
        return len(self._index)

    def lookup(self, tokens: Sequence[int],
               touch: bool = False) -> Tuple[List[int], int]:
        """Longest verified cached prefix of ``tokens`` in full pages:
        ``(pages, hit_len)``.  Takes no references.  ``touch=False`` is a
        pure read; the scheduler re-calls with ``touch=True`` once, when
        an admission commits (LRU order and hit/miss counters)."""
        page = self.page_size
        pages: List[int] = []
        h = _CHAIN_SEED
        for j in range(len(tokens) // page):
            block = tuple(tokens[j * page:(j + 1) * page])
            key = self._hash(h, block)
            e = self._index.get(key)
            if e is None or e.tokens != block or e.prev != h:
                break
            if touch:
                self._index.move_to_end(key)
            pages.append(e.page)
            h = key
        if touch:
            if pages:
                self.hits += 1
            else:
                self.misses += 1
        return pages, len(pages) * page

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               upto: int, from_block: int = 0,
               prev_hash: Optional[int] = None) -> Tuple[int, int]:
        """Index the full pages covering ``tokens[:upto]`` (idempotent; an
        existing entry wins).  ``from_block``/``prev_hash`` resume the
        chain so chunked prefill indexes each chunk in O(chunk).  Returns
        ``(chain_hash, blocks_done)``."""
        page = self.page_size
        h = _CHAIN_SEED if prev_hash is None else prev_hash
        nblocks = min(upto, len(tokens)) // page
        for j in range(from_block, nblocks):
            block = tuple(tokens[j * page:(j + 1) * page])
            key = self._hash(h, block)
            if key not in self._index:
                self._index[key] = _CacheEntry(page=int(pages[j]),
                                               tokens=block, prev=h)
                self.pool.mark_cached(int(pages[j]))
            h = key
        return h, max(from_block, nblocks)

    def forget(self, pages: Sequence[int]) -> int:
        """Drop every index entry whose page is in ``pages`` (a prefill
        that failed the finite-logits guard must never be stitched)."""
        ps = {int(p) for p in pages}
        dropped = 0
        for key in [k for k, e in self._index.items() if e.page in ps]:
            e = self._index.pop(key)
            self.pool.unmark_cached(e.page)
            dropped += 1
        return dropped

    def evict(self, n: int) -> int:
        """Evict up to ``n`` refcount-0 cached pages, LRU first."""
        if n <= 0:
            return 0
        freed = 0
        for key in list(self._index):
            if freed >= n:
                break
            e = self._index[key]
            if self.pool.refcount(e.page) == 0:
                del self._index[key]
                self.pool.release_cached(e.page)
                self.evictions += 1
                freed += 1
        return freed

    def flush(self) -> int:
        """Evict every reclaimable page."""
        return self.evict(len(self._index))
