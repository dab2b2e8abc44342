"""Block-paged KV cache for the serving engine (the port of
``paddle_tpu/serving/kv_cache.py``, with its standalone ``check`` gate:
``python -c "from paddle_tpu_torch.serving.kv_cache import main;
main(['check'])"``).

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
Python and copied close to verbatim.  :class:`HostPageTier` is the
host-RAM spill tier under the pool: evicted reclaimable pages demote to
pinned CPU memory (``read_pages``, checksummed) and come back through
``write_pages`` when a prefix lookup continues past the device index.
A warm restart's successor engine ``adopt``s a dead engine's tier, and a
migrated chain's host copies are ``forget``-ed on the source.

Page 0 is reserved as the null page: masked writes are steered to it
(always with zero payloads), and no live sequence is ever granted it.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Set, Tuple)

import numpy as np
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
    per-kv-head f32 scales.

    ``tp`` (default 1) is the tensor-parallel degree: the pool's KV-head
    dim is split over the ``model`` mesh axis, each rank holding
    ``kv_heads / tp`` heads of every page, so every byte count here
    (:meth:`bytes_per_page`, :meth:`kv_bytes`, hence
    :func:`pages_for_budget`) is per rank; int8 scales are split with
    their heads."""

    num_layers: int
    num_heads: int
    head_dim: int
    page_size: int
    num_pages: int           # includes the reserved null page 0
    max_pages_per_seq: int   # page-table width
    dtype: torch.dtype = torch.float32
    num_kv_heads: Optional[int] = None   # None = MHA (== num_heads)
    tp: int = 1              # model-axis shards of the KV-head dim

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
        enforce_that(self.tp >= 1, "tp must be >= 1", context="serving")
        enforce_that(self.kv_heads % self.tp == 0,
                     f"tensor parallelism tp={self.tp} must divide "
                     f"num_kv_heads ({self.kv_heads}): the paged pool "
                     "shards whole KV heads over the model axis, so each "
                     "chip must own an integer number of them — pick a "
                     f"tp that divides {self.kv_heads}, or a model with "
                     "more KV heads", context="serving")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads if self.num_kv_heads else self.num_heads

    @property
    def local_kv_heads(self) -> int:
        """KV heads of every page that one rank holds."""
        return self.kv_heads // self.tp

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
        """K + V bytes one page costs one rank across all layers, scales
        included: under tensor parallelism each rank holds
        ``kv_heads / tp`` heads of every page."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        heads = self.local_kv_heads
        per = (self.num_layers * self.page_size * heads *
               self.pool_head_dim * itemsize)
        if self.quantized:
            per += self.num_layers * self.page_size * heads * 4
        return 2 * per

    def kv_bytes(self) -> int:
        """Whole-pool bytes per rank (times ``tp`` for the global pool)."""
        return self.num_pages * self.bytes_per_page()


def pages_for_budget(pool_bytes: int, num_layers: int, num_heads: int,
                     head_dim: int, page_size: int, dtype,
                     num_kv_heads: Optional[int] = None,
                     tp: int = 1) -> int:
    """Total ``num_pages`` (null page included) that fit in a per-rank
    pool byte budget: int8 pages admit ~4x the f32 pages for the same
    bytes, and ``tp``-way tensor parallelism ``tp`` x the pages again
    (each rank stores 1/tp of every page's KV heads)."""
    probe = PagedKVConfig(num_layers=num_layers, num_heads=num_heads,
                          head_dim=head_dim, page_size=page_size,
                          num_pages=2, max_pages_per_seq=1,
                          dtype=resolve_kv_dtype(dtype),
                          num_kv_heads=num_kv_heads, tp=int(tp))
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


def kv_pool_specs(axis: str = "model") -> Tuple[Optional[str], ...]:
    """The pool's layout as a leading-dims spec covering every
    :class:`KVPages` leaf: the KV-head dim (position 3 of ``k``/``v`` and
    of the scales) split over ``axis``, every other dim whole."""
    return (None, None, None, axis)


def kv_pool_sharding(mesh, axis: str, kv_heads: int) -> Tuple[slice, ...]:
    """This rank's part of a whole pool leaf in :func:`kv_pool_specs`'
    layout, as an index (``leaf[idx]`` is the shard): the rank at
    coordinate ``i`` of ``axis`` (``n`` ranks) holds the KV heads
    ``i * kv_heads / n`` up to ``(i + 1) * kv_heads / n``, the heads whose
    K and V columns :meth:`DecoderLM.shard_plan
    <paddle_tpu_torch.serving.engine.DecoderLM.shard_plan>` gives it."""
    n, i = mesh.axis_size(axis), mesh.coord(axis)
    enforce_that(kv_heads % n == 0, f"{kv_heads} KV heads do not split "
                 f"over {axis}={n}", context="serving")
    per = kv_heads // n
    return tuple(slice(i * per, (i + 1) * per) if a == axis
                 else slice(None) for a in kv_pool_specs(axis))


def init_kv_pages(cfg: PagedKVConfig, device: DeviceLike = None,
                  mesh=None, axis: str = "model") -> KVPages:
    """Allocate a zeroed pool on ``device`` (default ``cuda``).  With a
    ``mesh`` this rank's shard (:func:`kv_pool_sharding`): ``[L, P, page,
    H_kv / tp, D]`` (scales ``[L, P, page, H_kv / tp]``), ``tp`` the size
    of ``axis``."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_pages, cfg.page_size, cfg.kv_heads,
             cfg.pool_head_dim)
    if mesh is not None:
        enforce_that(mesh.axis_size(axis) == cfg.tp,
                     f"the pool is configured for tp={cfg.tp}, the mesh's "
                     f"{axis!r} axis has {mesh.axis_size(axis)} ranks",
                     context="serving")
        shape = tuple(torch.empty(shape, device="meta")[
            kv_pool_sharding(mesh, axis, cfg.kv_heads)].shape)
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


def read_pages(kv: KVPages, page_ids: Sequence[int]):
    """Pull whole pages to the host as STORED values — the spill half of
    the host tier.

    page_ids: n page ids.  Returns ``(k, v, k_scale, v_scale)`` CPU
    tensors, k/v shaped [L, n, page, H_kv, pool_head_dim] in the pool
    dtype and the scales [L, n, page, H_kv] f32 (None for float pools).
    int8 pages are NOT dequantized.  From a CUDA pool the tensors are
    pinned and filled by ``non_blocking`` copies on the current stream,
    which this call waits for before it returns."""
    ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                          device=kv.k.device)
    src = [kv.k[:, ids], kv.v[:, ids]]
    if kv.quantized:
        src += [kv.k_scale[:, ids], kv.v_scale[:, ids]]
    if kv.k.device.type != "cuda":
        out = [t.clone() for t in src]
    else:
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               .copy_(t, non_blocking=True) for t in src]
        torch.cuda.current_stream(kv.k.device).synchronize()
    if not kv.quantized:
        out += [None, None]
    return tuple(out)


def write_pages(kv: KVPages, page_ids, k, v, k_scale=None,
                v_scale=None) -> KVPages:
    """Splice whole pages into the pool, IN PLACE — the swap-in half of
    the host tier, shape-compatible with :func:`read_pages` output
    (numpy arrays or CPU tensors, pinned for an asynchronous upload).
    Stored values go in verbatim, so an int8 page arrives bit-identical,
    scales included.  Host sources reach a CUDA pool through
    ``non_blocking`` copies ordered on the current stream."""
    dev = kv.k.device
    ids = torch.as_tensor(list(page_ids) if not torch.is_tensor(page_ids)
                          else page_ids, dtype=torch.long, device=dev)

    def up(x, dtype):
        x = torch.as_tensor(x)
        return x.to(device=dev, dtype=dtype, non_blocking=True)

    kv.k.index_copy_(1, ids, up(k, kv.k.dtype))
    kv.v.index_copy_(1, ids, up(v, kv.v.dtype))
    if kv.quantized:
        kv.k_scale.index_copy_(1, ids, up(k_scale, torch.float32))
        kv.v_scale.index_copy_(1, ids, up(v_scale, torch.float32))
    return kv


def gather_kv(kv: KVPages, layer: int, page_table: torch.Tensor):
    """Linearize page tables into contiguous K/V.

    page_table: [B, max_pages_per_seq].  Returns (k, v) each [B,
    max_pages_per_seq * page_size, H_kv, pool_head_dim] — positions past
    a sequence's length hold whatever the pages contain (callers mask by
    length).  Quantized pools are dequantized with :func:`dequantize_kv`,
    the rule the kernel uses."""
    kl, vl = kv.k[layer], kv.v[layer]
    b, pm = page_table.shape
    _, page, h, d = kl.shape
    pt = page_table.long()
    k, v = kl[pt], vl[pt]
    if kv.quantized:
        k = dequantize_kv(k, kv.k_scale[layer][pt])
        v = dequantize_kv(v, kv.v_scale[layer][pt])
    return k.reshape(b, pm * page, h, d), v.reshape(b, pm * page, h, d)


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
    # obs hook: the engine binds its (enabled) tracer here; None (tracing
    # off) costs one is-None check per alloc/ref/free
    tracer: Optional[object] = field(default=None, repr=False,
                                     compare=False)

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
        if self.tracer is not None and got:
            self.tracer.instant("page_alloc", cat="pages", n=len(got),
                                pages=tuple(got))
        return got

    def ref(self, pages: Sequence[int]) -> None:
        for p in pages:
            enforce_that(p in self._refs, f"ref of free page {p}",
                         context="serving")
            self._refs[p] += 1
        if self.tracer is not None and pages:
            self.tracer.instant("page_ref", cat="pages", n=len(pages),
                                pages=tuple(pages))

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
        if self.tracer is not None and pages:
            self.tracer.instant("page_free", cat="pages", n=len(pages),
                                pages=tuple(pages))

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
        if self.tracer is not None:
            self.tracer.instant("page_evict", cat="pages", page=p)


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
    tenant: Optional[str] = None   # who prefilled it (host-tier billing)


class PrefixCache:
    """Hash-chained index over FULL KV pages for automatic prefix caching.

    Only full pages are indexed; keys are chained so a hit on page j
    implies the whole prefix matched; every hit is verified against the
    stored tokens and parent link; entries are LRU-ordered and
    :meth:`evict` frees refcount-0 pages oldest-first — or, with a
    :class:`HostPageTier` and a page reader bound, demotes them to host
    memory first.  The cache holds no refcounts of its own."""

    def __init__(self, pool: PagePool, page_size: int,
                 hash_fn: Optional[Callable[[int, Tuple[int, ...]], int]]
                 = None):
        enforce_that(page_size >= 1, "page_size must be positive",
                     context="serving")
        self.pool = pool
        self.page_size = int(page_size)
        self._hash = hash_fn or _chain_hash
        self.tracer = None     # obs hook, bound by the engine (see pool)
        self._index: "OrderedDict[int, _CacheEntry]" = OrderedDict()
        self.hits = 0          # lookups that matched >= 1 page
        self.misses = 0        # lookups that matched none
        self.evictions = 0     # pages evicted
        # the host tier: with a HostPageTier and a page reader (device
        # pages -> stored host bytes) bound by the engine, eviction
        # DEMOTES the victim into the tier instead of destroying it
        self.host_tier: Optional["HostPageTier"] = None
        self.page_reader: Optional[Callable[[Sequence[int]], tuple]] = None

    def __len__(self) -> int:
        return len(self._index)

    def chain_keys(self, tokens: Sequence[int]) -> List[int]:
        """Every full block's chained key under this cache's hash — what
        the host-tier swap-in walks to continue a lookup past the device
        index."""
        return prefix_chain_hashes(tokens, self.page_size, self._hash)

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
               prev_hash: Optional[int] = None,
               tenant: Optional[str] = None) -> Tuple[int, int]:
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
                                               tokens=block, prev=h,
                                               tenant=tenant)
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
        """Evict up to ``n`` refcount-0 cached pages, LRU first; with a
        host tier bound each victim's stored bytes are staged into it
        before the device page is reclaimed."""
        if n <= 0:
            return 0
        freed = 0
        spill = (self.host_tier is not None and
                 self.page_reader is not None)
        for key in list(self._index):
            if freed >= n:
                break
            e = self._index[key]
            if self.pool.refcount(e.page) == 0:
                if spill:
                    self.host_tier.spill(key, e.prev, e.tokens,
                                         self.page_reader([e.page]),
                                         tenant=e.tenant)
                del self._index[key]
                self.pool.release_cached(e.page)
                self.evictions += 1
                freed += 1
        if self.tracer is not None and freed:
            self.tracer.instant("cache_evict", cat="pages", n=freed)
        return freed

    def flush(self) -> int:
        """Evict every reclaimable page."""
        return self.evict(len(self._index))


# ---------------------------------------------------------------------------
# The host tier: spilled pages live in host RAM, checksummed, until a
# prefix hit swaps them back in
# ---------------------------------------------------------------------------


def _host_bytes(x) -> np.ndarray:
    """The stored bytes of a host array (numpy or CPU tensor) as a flat
    uint8 view — no copy for contiguous inputs."""
    if torch.is_tensor(x):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def page_checksum(k, v, k_scale=None, v_scale=None) -> int:
    """CRC32 chained over a page's STORED bytes plus its scale arrays —
    the one integrity rule the spill writer and the swap-in verifier
    share.  Computed over the bytes the writer INTENDED to store, so a
    torn commit or a flipped bit can never verify."""
    c = zlib.crc32(_host_bytes(k))
    c = zlib.crc32(_host_bytes(v), c)
    if k_scale is not None:
        c = zlib.crc32(_host_bytes(k_scale), c)
        c = zlib.crc32(_host_bytes(v_scale), c)
    return c


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) \
        else int(x.nbytes)


@dataclass
class _HostPage:
    """One spilled page: the prefix-cache chain identity (key / prev /
    tokens, so the host index continues the device index's chain) plus
    the stored payload (CPU tensors) and its checksum."""

    key: int
    prev: int
    tokens: Tuple[int, ...]
    k: torch.Tensor                    # [L, 1, page, H_kv, D] stored dtype
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]    # [L, 1, page, H_kv] f32, or None
    v_scale: Optional[torch.Tensor]
    checksum: int
    nbytes: int
    seq: int                           # spill sequence (fault addressing)
    tenant: Optional[str] = None


class HostPageTier:
    """The host-RAM spill tier under the device :class:`PagePool`.

    Evicted RECLAIMABLE pages demote here instead of being destroyed
    (``PrefixCache.evict`` stages them), keyed by the SAME chained block
    hash the device index uses — so a later lookup that runs off the
    end of its device hits can continue the walk in host memory and swap
    the continuation back in, verified, instead of re-prefilling it.

    Write path — a depth-one writer, tick-deterministic (no threads, no
    wall clock): ``spill`` first commits the previously staged page,
    then stages the new one; the engine's per-tick ``pump`` commits the
    staged page unless the fault hooks declare host I/O stalled for that
    tick (counted as ``spill_stall_ticks``); ``flush`` commits
    unconditionally (drain, handoff).  The fault hooks (``faults``, a
    :class:`~paddle_tpu_torch.serving.faults.FaultPlan`:
    ``spill_is_torn(seq)``, ``spill_bitflip_offset(seq, nbytes)`` and
    ``host_io_stalled(tick)``) mutate the payload AT COMMIT — after the
    checksum was taken over the intended bytes — so a torn write or a
    flipped bit is exactly what the verifier later catches.

    Capacity is a byte budget.  With ``dtype='int8'`` float payloads are
    transcoded to int8 + per-token scales on spill (~4x the f32 pages
    for the same bytes, at quantization fidelity); with the default
    ``'stored'`` the pool's bytes are kept verbatim, so swap-in is
    bit-identical.  Past the budget the tier LRU-drops.

    Conservation (``HOSTTIER-LEAK``): every page that ever entered the
    tier ends in exactly one state —

        spills + adopted == resident + swap_ins + dropped + corrupt
                            + handed_off + pending

    checked by :meth:`check`, which the engine folds into
    ``check_page_conservation``."""

    def __init__(self, capacity_bytes: int, dtype: str = "stored",
                 faults=None, tracer=None):
        enforce_that(dtype in ("stored", "int8"),
                     "serving_host_kv_dtype must be 'stored' or 'int8', "
                     f"got {dtype!r}", context="serving")
        self.capacity_bytes = int(capacity_bytes)
        self.dtype = dtype
        self.faults = faults
        self.tracer = tracer
        # single-threaded by design: the engine's tick loop is the only
        # writer (spill/pump/flush/swap-in), and a warm restart's adopt()
        # runs before the successor engine starts ticking
        self._index: "OrderedDict[int, _HostPage]" = OrderedDict()
        self._pending: Optional[_HostPage] = None
        self._seq = 0
        self.resident_bytes = 0
        self.resident_by_tenant: Dict[str, int] = {}
        # ledger counters (see the class docstring for the invariant)
        self.spills = 0            # pages ever staged (swap_outs gauge)
        self.swap_ins = 0          # verified pages promoted back to device
        self.dropped = 0           # LRU-dropped / forgotten / displaced
        self.corrupt = 0           # checksum failures (NEVER served)
        self.handed_off = 0        # adopted away by a successor tier
        self.adopted = 0           # records taken FROM predecessors
        self.restored = 0          # of those, verified + resident here
        self.spill_stall_ticks = 0  # pump ticks lost to slow host I/O

    def __len__(self) -> int:
        return len(self._index)

    # ---- write path (depth one) ------------------------------------------

    def spill(self, key: int, prev: int, tokens: Sequence[int], payload,
              tenant: Optional[str] = None) -> None:
        """Stage one evicted page (``payload`` is :func:`read_pages`
        output for a single page, which the tier then owns).  Commits
        any previously staged page first — at most one spill is ever in
        flight."""
        if self._pending is not None:
            self._commit(self._pending)
            self._pending = None
        k, v, ks, vs = (None if x is None else torch.as_tensor(x)
                        for x in payload)
        if self.dtype == "int8" and ks is None:
            # transcode-on-spill: int8 + f32 scales; swap-in dequantizes
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
        nbytes = _nbytes(k) + _nbytes(v)
        if ks is not None:
            ks, vs = ks.float(), vs.float()
            nbytes += _nbytes(ks) + _nbytes(vs)
        seq = self._seq       # 0-based: the fault hooks' Nth spill is N
        self._seq += 1
        self.spills += 1
        self._pending = _HostPage(
            key=int(key), prev=int(prev), tokens=tuple(tokens),
            k=k, v=v, k_scale=ks, v_scale=vs,
            checksum=page_checksum(k, v, ks, vs),
            nbytes=int(nbytes), seq=seq, tenant=tenant)
        if self.tracer is not None:
            self.tracer.instant("host_spill", cat="pages", seq=seq)

    def pump(self, tick: int) -> int:
        """Per-tick writer advance: commit the staged page, unless host
        I/O is stalled this tick (the spill then waits for the window to
        end — decode never waits on it)."""
        if self._pending is None:
            return 0
        if self.faults is not None and self.faults.host_io_stalled(tick):
            self.spill_stall_ticks += 1
            return 0
        self._commit(self._pending)
        self._pending = None
        return 1

    def flush(self) -> None:
        """Commit unconditionally (the drain barrier)."""
        if self._pending is not None:
            self._commit(self._pending)
            self._pending = None

    def _commit(self, rec: _HostPage) -> None:
        f = self.faults
        if f is not None:
            if f.spill_is_torn(rec.seq):
                # torn commit: the tail half of V never lands
                flat = _host_bytes(rec.v)
                flat[flat.size // 2:] = 0
            off = f.spill_bitflip_offset(rec.seq, _nbytes(rec.k))
            if off is not None:
                flat = _host_bytes(rec.k)
                flat[off % flat.size] ^= 0x40
        self._insert(rec)

    def _insert(self, rec: _HostPage) -> bool:
        if rec.key in self._index:
            # an existing entry wins (the device index's idempotence
            # rule); the duplicate is accounted as dropped
            self.dropped += 1
            return False
        if rec.nbytes > self.capacity_bytes:
            self.dropped += 1
            return False
        while self.resident_bytes + rec.nbytes > self.capacity_bytes:
            self._pop_lru()
        self._index[rec.key] = rec
        self.resident_bytes += rec.nbytes
        if rec.tenant is not None:
            self.resident_by_tenant[rec.tenant] = \
                self.resident_by_tenant.get(rec.tenant, 0) + 1
        return True

    def _pop(self, key: int) -> _HostPage:
        rec = self._index.pop(key)
        self.resident_bytes -= rec.nbytes
        if rec.tenant is not None:
            n = self.resident_by_tenant.get(rec.tenant, 0) - 1
            if n > 0:
                self.resident_by_tenant[rec.tenant] = n
            else:
                self.resident_by_tenant.pop(rec.tenant, None)
        return rec

    def _pop_lru(self) -> None:
        key = next(iter(self._index))
        self._pop(key)
        self.dropped += 1
        if self.tracer is not None:
            self.tracer.instant("host_drop", cat="pages", key=key)

    # ---- read path (verified swap-in) ------------------------------------

    def peek(self, key: int, prev: int,
             block: Sequence[int]) -> Optional[_HostPage]:
        """Pure probe: the record for ``key`` if present AND its chain
        identity matches (a collision is a miss).  No checksum work, no
        removal."""
        rec = self._index.get(key)
        if rec is None or rec.prev != int(prev) or \
                rec.tokens != tuple(block):
            return None
        return rec

    def take_verified(self, key: int, prev: int,
                      block: Sequence[int]) -> Optional[_HostPage]:
        """Remove-and-return the record for ``key`` iff its chain
        identity matches AND its checksum verifies.  A mismatch pops the
        record, counts ``corrupt`` (HOSTTIER-CORRUPT) and returns None:
        corruption degrades to a miss, never to a wrong-KV hit."""
        if self.peek(key, prev, block) is None:
            return None
        rec = self._pop(int(key))
        if page_checksum(rec.k, rec.v, rec.k_scale,
                         rec.v_scale) != rec.checksum:
            self.corrupt += 1
            if self.tracer is not None:
                self.tracer.instant("HOSTTIER-CORRUPT", cat="pages",
                                    key=int(key))
            return None
        self.swap_ins += 1
        return rec

    def forget(self, keys: Sequence[int]) -> int:
        """Drop records (and a matching staged spill) by chain key — the
        no-double-adopt rule: when a chain migrates to another replica,
        the source's host copies are forgotten so the pages can never be
        re-adopted from two places."""
        n = 0
        for key in list(keys):
            key = int(key)
            if self._pending is not None and self._pending.key == key:
                self._pending = None
                self.dropped += 1
                n += 1
            if key in self._index:
                self._pop(key)
                self.dropped += 1
                n += 1
        return n

    # ---- crash-warm restart ----------------------------------------------

    def adopt(self, other: "HostPageTier") -> int:
        """Take every record from a predecessor tier (warm restart: the
        host tier outlives the engine).  Each record is re-verified
        against its checksum before it becomes hittable here — a record
        corrupted while orphaned counts ``corrupt`` on THIS tier and is
        never served.  The source ledger stays balanced through
        ``handed_off``.  Returns how many records were restored."""
        other.flush()
        restored = 0
        # the predecessor's engine is stopped at handoff: its tier has no
        # other owner left
        for key in list(other._index):
            rec = other._pop(key)
            other.handed_off += 1
            self.adopted += 1
            if page_checksum(rec.k, rec.v, rec.k_scale,
                             rec.v_scale) != rec.checksum:
                self.corrupt += 1
                if self.tracer is not None:
                    self.tracer.instant("HOSTTIER-CORRUPT", cat="pages",
                                        key=int(key))
                continue
            if self._insert(rec):
                self.restored += 1
                restored += 1
        return restored

    # ---- conservation + scrape -------------------------------------------

    def check(self) -> None:
        """The HOSTTIER-LEAK invariant (valid at any tick): every page
        that entered the tier is in exactly one of resident / swapped-in
        / dropped / corrupt / handed-off / pending, and the resident bytes
        match the index under the budget."""
        from paddle_tpu_torch.serving.faults import PageLeakError

        pend = 1 if self._pending is not None else 0
        lhs = self.spills + self.adopted
        rhs = (len(self._index) + self.swap_ins + self.dropped +
               self.corrupt + self.handed_off + pend)
        if lhs != rhs:
            raise PageLeakError(
                f"HOSTTIER-LEAK: spills({self.spills}) + "
                f"adopted({self.adopted}) != resident({len(self._index)})"
                f" + swap_ins({self.swap_ins}) + dropped({self.dropped})"
                f" + corrupt({self.corrupt}) + "
                f"handed_off({self.handed_off}) + pending({pend})")
        nb = sum(r.nbytes for r in self._index.values())
        if nb != self.resident_bytes or nb > self.capacity_bytes:
            raise PageLeakError(
                f"HOSTTIER-LEAK: resident bytes ledger {self.resident_bytes}"
                f" vs actual {nb} (capacity {self.capacity_bytes})")

    def snapshot(self) -> Dict[str, int]:
        """Host-tier gauges, merged into the engine's scrape surface."""
        return {
            "pages_host": len(self._index),
            "host_swap_ins": self.swap_ins,
            "host_swap_outs": self.spills,
            "host_corrupt": self.corrupt,
            "host_dropped": self.dropped,
            "host_restored": self.restored,
            "host_resident_bytes": self.resident_bytes,
            "spill_stall_ticks": self.spill_stall_ticks,
        }


# ---------------------------------------------------------------------------
# standalone gate: main(["check"])
# ---------------------------------------------------------------------------


def _selfcheck(device: DeviceLike = None) -> int:
    """Replay the seeded hierarchical-tier trace of the JAX package's
    gate, on ``device`` (default ``cuda``).  Two phases:

    1. single engine: a clean spill/swap-in round trip must be
       token-identical to a cold re-prefill, and an injected torn spill
       and a seeded bit flip must BOTH be caught by the checksum at
       swap-in (degrading to a miss) — a corrupt page served would show
       up as a parity break;
    2. small fleet: kill a replica whose host tier holds spilled pages,
       ``restart_replica`` it, and the warm successor must re-adopt
       >= 1 verified page and serve the same prompt token-identically
       with zero duplicate completions.

    Returns 0 (clean) or 1 (findings); a crash propagates as 2."""
    from paddle_tpu_torch.serving._gate import gate_model
    from paddle_tpu_torch.serving.engine import ServingEngine
    from paddle_tpu_torch.serving.faults import (FaultPlan, FleetFaultPlan,
                                                 ManualClock)
    from paddle_tpu_torch.serving.fleet import FleetRouter

    model = gate_model(device)
    rng = np.random.RandomState(0)
    prompt = rng.randint(2, 64, size=16).tolist()   # 4 full pages
    problems = []

    def mk_engine(**faults_kw):
        plan = FaultPlan(seed=0, clock=ManualClock(tick_s=0.01),
                         **faults_kw)
        return ServingEngine(model, eos_id=1, page_size=4, num_pages=16,
                             max_pages_per_seq=8, max_slots=2,
                             buckets=(8, 16), faults=plan,
                             host_tier_bytes=1 << 20, swap_in_budget=4,
                             device=device)

    def roundtrip(eng):
        """cold serve -> flush (spill) -> warm serve; returns (cold,
        warm) token lists from the SAME engine."""
        r1 = eng.submit(list(prompt), max_tokens=6)
        eng.run()
        cold = eng.result(r1)
        eng.cache.flush()
        r2 = eng.submit(list(prompt), max_tokens=6)
        eng.run()
        return cold, eng.result(r2)

    # phase 1a: clean round trip — the tier must actually serve
    eng = mk_engine()
    cold, warm = roundtrip(eng)
    snap = eng.host_tier.snapshot()
    if warm != cold:
        problems.append(f"clean swap-in parity break: {warm} != {cold}")
    if snap["host_swap_ins"] < 1 or eng._host_hits < 1:
        problems.append(f"clean round trip never hit the host tier: {snap}")
    clean_swapins = snap["host_swap_ins"]
    eng.check_page_conservation()

    # phase 1b/1c: torn spill, then a seeded bit flip — each must be
    # caught at swap-in (miss + HOSTTIER-CORRUPT), never served
    for kw, name in (({"torn_spill_at": {0}}, "torn"),
                     ({"bitflip_spill_at": {0}}, "bitflip")):
        eng = mk_engine(**kw)
        cold, warm = roundtrip(eng)
        snap = eng.host_tier.snapshot()
        if warm != cold:
            problems.append(f"{name}: corrupt page SERVED "
                            f"(parity break {warm} != {cold})")
        if snap["host_corrupt"] < 1:
            problems.append(f"{name}: checksum missed the corruption "
                            f"({snap})")
        eng.check_page_conservation()

    # phase 2: crash-warm restart in a fleet
    plan = FleetFaultPlan(seed=0, clock=ManualClock(tick_s=0.01))

    def mk(i, time_fn):
        return ServingEngine(model, eos_id=1, page_size=4, num_pages=32,
                             max_pages_per_seq=8, max_slots=4,
                             buckets=(8, 16), time_fn=time_fn,
                             host_tier_bytes=1 << 20, swap_in_budget=4,
                             device=device)

    fleet = FleetRouter(mk, 2, heartbeat_s=0.05, resubmit_budget=2,
                        faults=plan)
    f1 = fleet.submit(list(prompt), max_tokens=6)
    fleet.run(max_ticks=200)
    cold = fleet.result(f1)
    victim = next(r.idx for r in fleet.replicas
                  if r.engine.cache is not None and len(r.engine.cache))
    fleet.replicas[victim].engine.cache.flush()
    fleet.kill_replica(victim)
    fleet.restart_replica(victim)
    fleet.drain_replica(1 - victim)
    for _ in range(5):
        fleet.step()
    f2 = fleet.submit(list(prompt), max_tokens=6)
    fleet.run(max_ticks=200)
    warm = fleet.result(f2)
    restored = fleet.metrics.pages_restored
    if warm != cold:
        problems.append(f"warm-restart parity break: {warm} != {cold}")
    if restored < 1:
        problems.append("warm restart adopted 0 pages")
    if fleet.metrics.duplicate_completions:
        problems.append(f"{fleet.metrics.duplicate_completions} duplicate "
                        "completions after warm restart")
    fleet.check_fleet_conservation()

    if problems:
        print("HOSTTIER: " + "; ".join(problems))
        return 1
    print(f"kv-cache check ok: clean swap-in x{clean_swapins} "
          "token-identical to cold prefill, torn + bit-flip spills both "
          f"caught at swap-in (0 corrupt pages served), warm restart "
          f"re-adopted {restored} page(s) with 0 duplicate completions, "
          "0 leaks")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``check [--device D]``: the HOSTTIER gate (exit 0 clean, 1
    findings, 2 a crash).  Importable, so callers run it through
    ``python -c "...kv_cache.main(['check'])"`` rather than
    ``python -m``, which would execute a second copy of this module
    beside the one ``paddle_tpu_torch.serving`` imported."""
    from paddle_tpu_torch.serving._gate import run_gate

    return run_gate(argv, "kv-cache",
                    "python -m paddle_tpu_torch.serving.kv_cache check "
                    "[--device cpu|cuda]", _selfcheck)


if __name__ == "__main__":
    import sys

    sys.exit(main())
