// Ragged paged attention for Hopper (sm_90a): mixed prefill + decode rows
// over a paged KV pool, one call per layer (a plan launch, an attention
// launch, a merge launch).
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (paddle_tpu/serving/decode_attention.py:173, launched by `_ragged_pallas`
// at :317) and computes what it computes:
//   - q [T, H, D] (f32 or bf16) is a sequence-packed row stack; rows come in
//     blocks of BLOCK_ROWS = 8, one sequence per block, read as
//     row_seq[blk * 8]; the output is [T, H, D] in q's type;
//   - pages [P, page, H_kv, D] in f32, bf16 or int8 (int8 with f32 scales
//     [P, page, H_kv], dequantized in registers as q * scale);
//   - GQA: query head h reads KV head h / G for any G = H / H_kv;
//   - the whole mask is `token <= qpos` (qpos -1 = padded row), and tokens
//     at or past the sequence's kv_len are never read;
//   - online softmax with (m, l, acc) in f32; bf16 pages round P to bf16
//     before the PV product, as the TPU kernel's p.astype(vb.dtype) does;
//   - a row with nothing live (kv_len 0, or a padded row) yields 0.
// Every head dim d that is a multiple of 8 from 8 up; any page size (a
// head dim that is not a multiple of 8 is served from a pool the port's
// kv_cache allocates at the next one, its columns past d zero, with q
// widened to match by the wrapper).  Head dims above 256 take the wide
// kernel at the end of this file (ragged_attention_wide_kernel), above
// 512 in chunks of 512 output columns.
// The other kernels are compiled at the widths DP = 16, 32, 64, 128 and 256
// and the one at DP runs every d with DP / 2 < d <= DP (DP = 16 also d = 8):
// rows of q, of the pages, of the output and of the partials are d
// elements apart, columns d .. DP of the Q and K/V tiles are zero-filled as
// they are loaded (zero columns add nothing to q.k, and the PV product's
// columns past d are never stored), which also pads the last k-step of the
// tensor-core products (k = 8 in 3xTF32, 16 in bf16).  Rows of f32 and bf16
// stay 16-byte aligned; int8 rows at d % 16 == 8 move in 8-byte pieces.
// Each kernel is instantiated twice a width: FULL (d == DP, the head dim a
// compile-time constant) and not (d read from the parameters).
//
// What bounds it on the H100: a decode row reads every live K/V byte of its
// sequence once for 2 * G * D multiply-adds per token and KV head, far
// below the card's operations-per-byte balance, so decode is bound by
// bytes; a prefill chunk of n rows does n times the work on the same bytes
// and is bound by operations.
//
// Design (the TPU kernel streams pages through a sequential grid axis and
// carries (m, l, acc) in VMEM; Hopper's blocks run in parallel and in no
// order):
//   1. The token axis is split into spans of `span` tokens (a multiple of
//      the 32-token tile).  A row whose live tokens lie in one span is
//      written by the block that takes that span; a row with more writes
//      an f32 partial (m, l, acc) per span to a workspace, and the merge
//      kernel (ragged_attention_merge_kernel) combines them.  The number
//      of spans a row needs follows from its own qpos and kv_len, so the
//      plan, the attention blocks and the merge agree without a host sync.
//   2. K/V tiles are shared by the rows of a sequence.  A run is up to 8
//      consecutive row blocks (64 rows) of one sequence inside a 64-row
//      aligned group.  The run's real rows (qpos >= 0) are compacted and
//      expanded by the G query heads of a KV head into score rows, 64 to a
//      chunk.  A work item is (run, chunk, span, KV head).  A decode row is
//      a run of its own and is split over tokens.
//   3. No block for empty work.  The plan kernel (one warp per row block)
//      lists the call's items, the wide ones (runs of more than 16 score
//      rows) from the front of the list and the narrow ones from its back,
//      so long work starts first; persistent attention blocks, as many as
//      the card holds at once, take items from a shared counter until none
//      is left.
//   4. Products on the tensor cores (mma.sync), a warp owning 16 score
//      rows (and, in the f32 kernel's 8 warps, half of each tile's
//      tokens), P going from the score registers (bf16) or through shared
//      memory (f32) to the PV product: bf16 queries on bf16 pages as bf16
//      products (m16n8k16) with f32 sums in 4-warp blocks; every other
//      pairing in f32 as 3xTF32 (m16n8k8): each f32 operand a = hi + lo
//      with hi and lo TF32, and a b = hi_a hi_b + hi_a lo_b + lo_a hi_b,
//      about 22 bits of each product, within 1e-6 of f32 where the f32
//      contract asks for 1e-4 (plain TF32 keeps 11 bits and would break
//      it).  Operands exact in TF32 (bf16 and int8 pages, P rounded to
//      bf16) skip their lo terms.  Narrow items of the f32 kernel (decode
//      rows) take a CUDA-core path instead (narrow_item), each K and V
//      element read once a tile.
//   5. K/V tiles of 32 tokens (a tile may cross a page boundary; each
//      token row is fetched through the page table) stream through a
//      2-stage cp.async ring; rows past the span are zero-filled.
// A block's running maximum starts afresh at its span: the plain version
// rounds P over the same spans (`round_p_span`).
//
// Plain C interface (built by paddle_tpu_torch/kernels/build.py with nvcc,
// loaded with ctypes): rpa_launch returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_ROWS = 8;      // query rows per row block (one sequence)
constexpr int RUN_BLOCKS = 8;      // row blocks a run may take (64 rows)
constexpr int RUN_ROWS = BLOCK_ROWS * RUN_BLOCKS;
constexpr int MT = 64;             // score rows of a chunk (and of a block)
constexpr int KT = 32;             // tokens per tile
constexpr int NSTAGE = 2;          // cp.async ring depth: one tile ahead
constexpr int F32_THREADS = 256;   // f32 kernel: 8 warps
constexpr int BF16_THREADS = 128;  // bf16 kernel: 4 warps of 16 score rows
constexpr int NARROW_ROWS = 16;    // runs of at most this many score rows
                                   // are narrow items, the rest wide ones
constexpr int MAX_SPLITS = 16;     // spans a row may take
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // DEFAULT_MASK_VALUE

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* kv_lens;
  const int* row_seq;
  const int* qpos;
  void* out;
  float* ws_acc;     // [splits, T, H, D] partial acc
  float2* ws_ml;     // [splits, T, H] partial (m, l)
  int4* items;       // [max_items] (run's first row block, chunk, span,
                     // row blocks of the run):
                     // wide items from the front, the rest from the back
  int* counts;       // wide items, other items, next work item
  int T, H, KVH, D, page, Pm, span, max_items, q_bf16;   // D: the head dim
  float sm_scale;
};

// per-block bookkeeping at the head of shared memory
struct Meta {
  int row[MT];     // global query row of each score row (-1: none)
  int head[MT];    // its query head
  int qpos[MT];    // its position (-1: none)
  int ns[MT];      // spans its live tokens take
  int list_row[RUN_ROWS];
  int list_qpos[RUN_ROWS];
  float row_m[NARROW_ROWS];      // narrow path: each row's running max,
  float row_l[NARROW_ROWS];      // sum and rescaling of this tile
  float row_alpha[NARROW_ROWS];
  unsigned ballot[2];
  int n_tok;
  int item;        // the work item the block takes next
};
static_assert(sizeof(Meta) % 16 == 0, "Meta keeps the tiles aligned");

// padding of a K/V tile row in shared memory, in elements: rows stay
// 16-byte aligned for cp.async, and the operand loads of a warp fall on
// distinct banks (an f32 K row of D + 4 and V row of D + 8 elements)
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int k = 4, v = 8; };
template <> struct Pad<bf16> { static constexpr int k = 8, v = 8; };
template <> struct Pad<int8_t> { static constexpr int k = 16, v = 16; };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld1(const int8_t* p) {
  return static_cast<float>(*p);
}

// two neighbouring floats to global memory as f32 or bf16
__device__ __forceinline__ void store2(void* base, size_t off, float x0,
                                       float x1, int as_bf16) {
  if (as_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + off) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(x0, x1);
  }
}

// P as the PV product sees it: bf16 pages round it to bf16 first
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  if constexpr (std::is_same<T, bf16>::value) {
    return __bfloat162float(__float2bfloat16(p));
  } else {
    return p;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_maxf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// 16 bytes global -> shared; `full` false zero-fills the destination
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// live tokens of a row (0 for a padded row or an empty sequence); the plan,
// the attention blocks and the merge all count spans with this
__device__ __forceinline__ int row_tokens(int qpos, int kv_len, int cap) {
  return qpos < 0 ? 0 : max(0, min(min(kv_len, qpos + 1), cap));
}

// the head dim: DP itself in a FULL instantiation, else the call's
template <int DP, bool FULL>
__device__ __forceinline__ int head_dim(const Params& p) {
  return FULL ? DP : p.D;
}

// ---------------------------------------------------------------------------
// runs, items and the block's share of an item
// ---------------------------------------------------------------------------

// The block's share of one work item, written to `meta`: the real rows of
// the run of `run` row blocks starting at blk expanded by the G query heads
// of KV head kh into score rows, chunk c of them, and span `split`'s token
// range [t_begin, t_end).  Returns false (for every thread) when the span
// holds no live token.  Every thread of the block must call it.
__device__ bool setup_item(const Params& p, Meta& meta, int blk, int run,
                           int c, int split, int kh, int& n_rows,
                           int& t_begin, int& t_end) {
  const int tid = threadIdx.x;
  const int G = p.H / p.KVH;
  const int row0 = blk * BLOCK_ROWS;
  const int seq = p.row_seq[row0];
  // compact the run's real rows (warps 0 and 1 cover its <= 64 rows)
  int qp = -1;
  if (tid < run * BLOCK_ROWS) qp = p.qpos[row0 + tid];
  const unsigned bal = __ballot_sync(0xffffffffu, qp >= 0);
  if (tid < RUN_ROWS && (tid & 31) == 0) meta.ballot[tid >> 5] = bal;
  if (tid == 0) meta.n_tok = 0;
  __syncthreads();
  const unsigned b0 = meta.ballot[0];
  const int n_real = __popc(b0) + __popc(meta.ballot[1]);
  if (qp >= 0) {
    const int lane = tid & 31;
    const int at = __popc(bal & ((1u << lane) - 1u)) +
                   (tid >= 32 ? __popc(b0) : 0);
    meta.list_row[at] = row0 + tid;
    meta.list_qpos[at] = qp;
  }
  __syncthreads();
  n_rows = max(0, min(MT, n_real * G - c * MT));
  const int kv_len = p.kv_lens[seq];
  const int cap = p.Pm * p.page;
  if (tid < MT) {
    int row = -1, head = 0, pos = -1, ns = 0;
    if (tid < n_rows) {
      const int r = c * MT + tid;
      const int i = r / G;
      row = meta.list_row[i];
      head = kh * G + r % G;
      pos = meta.list_qpos[i];
      const int n = row_tokens(pos, kv_len, cap);
      ns = (n + p.span - 1) / p.span;
      atomicMax(&meta.n_tok, n);
    }
    meta.row[tid] = row;
    meta.head[tid] = head;
    meta.qpos[tid] = pos;
    meta.ns[tid] = ns;
  }
  __syncthreads();
  t_begin = split * p.span;
  t_end = min(t_begin + p.span, meta.n_tok);
  return t_begin < t_end;
}

// Persistent blocks: each takes work items (a plan item for one KV head)
// from the shared counter until none is left, and runs `body(wide, blk,
// run, chunk, split, kv_head)` on each; `wide` marks the items of runs
// with more than NARROW_ROWS score rows.
template <typename Body>
__device__ __forceinline__ void for_each_item(const Params& p, Meta& meta,
                                              Body body) {
  const int wide = p.counts[0];
  const int total = (wide + p.counts[1]) * p.KVH;
  for (;;) {
    __syncthreads();   // every thread is done with the last item's meta
    if (threadIdx.x == 0) meta.item = atomicAdd(&p.counts[2], 1);
    __syncthreads();
    const int idx = meta.item;
    if (idx >= total) return;
    const int base = idx / p.KVH;
    const int4 it = p.items[base < wide ? base
                                         : p.max_items - 1 - (base - wide)];
    body(base < wide, it.x, it.w, it.y, it.z, idx % p.KVH);
  }
}

// The K and V rows of one tile in BYTES-byte pieces: the row's d elements,
// then zeros up to D; rows at or past t_end are zero-filled.  A warp's
// lanes take neighbouring pieces of a row.
template <typename T, int D, bool FULL, int KS, int VS, int NT, int BYTES>
__device__ __forceinline__ void fetch_rows(const Params& p, const int* pt,
                                           int kh, int t0, int t_end,
                                           T* k_dst, T* v_dst) {
  constexpr int PIECES = D * static_cast<int>(sizeof(T)) / BYTES;
  const int row_bytes =
      head_dim<D, FULL>(p) * static_cast<int>(sizeof(T));
  const unsigned char* kp = static_cast<const unsigned char*>(p.k_pages);
  const unsigned char* vp = static_cast<const unsigned char*>(p.v_pages);
  for (int idx = threadIdx.x; idx < KT * PIECES; idx += NT) {
    const int r = idx / PIECES;
    const int at = (idx % PIECES) * BYTES;
    const int tok = t0 + r;
    const bool live = tok < t_end && (FULL || at < row_bytes);
    size_t off = 0;
    if (live) {
      off = ((static_cast<size_t>(pt[tok / p.page]) * p.page +
              tok % p.page) * p.KVH + kh) * row_bytes + at;
    }
    unsigned char* kd = reinterpret_cast<unsigned char*>(k_dst + r * KS) + at;
    unsigned char* vd = reinterpret_cast<unsigned char*>(v_dst + r * VS) + at;
    if constexpr (BYTES == 16) {
      cp_async16(kd, kp + off, live);
      cp_async16(vd, vp + off, live);
    } else {
      cp_async8(kd, kp + off, live);
      cp_async8(vd, vp + off, live);
    }
  }
}

// One K/V tile of tokens [t0, t0 + KT) of KV head kh into shared memory
// (K rows of KS, V rows of VS elements), each token row fetched through
// the page table; rows at or past t_end, and columns d .. D, are
// zero-filled.  16-byte pieces, but 8-byte ones for int8 rows whose d
// bytes are not whole 16-byte pieces (nor 16-byte aligned).
template <typename T, int D, bool FULL, int KS, int VS, int NT>
__device__ __forceinline__ void fetch_tile(const Params& p, const int* pt,
                                           int kh, int t0, int t_end,
                                           T* k_dst, T* v_dst, float* ks_dst,
                                           float* vs_dst) {
  if constexpr (std::is_same<T, int8_t>::value && !FULL) {
    if (p.D % 16 != 0) {
      fetch_rows<T, D, FULL, KS, VS, NT, 8>(p, pt, kh, t0, t_end, k_dst,
                                            v_dst);
    } else {
      fetch_rows<T, D, FULL, KS, VS, NT, 16>(p, pt, kh, t0, t_end, k_dst,
                                             v_dst);
    }
  } else {
    fetch_rows<T, D, FULL, KS, VS, NT, 16>(p, pt, kh, t0, t_end, k_dst,
                                           v_dst);
  }
  if constexpr (std::is_same<T, int8_t>::value) {
    for (int r = threadIdx.x; r < KT; r += NT) {
      const int tok = t0 + r;
      const bool live = tok < t_end;
      size_t row = 0;
      if (live) {
        row = (static_cast<size_t>(pt[tok / p.page]) * p.page +
               tok % p.page) * p.KVH + kh;
      }
      cp_async4(ks_dst + r, p.k_scale + row, live);
      cp_async4(vs_dst + r, p.v_scale + row, live);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core pieces shared by both kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16 x 8] += a[16 x 8] b[8 x 8], TF32 operands, f32 accumulation
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; with `exact` x is TF32 already and lo is 0
template <bool exact>
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  if constexpr (exact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
}

// c += a b in 3xTF32: hi hi into c, the small terms into `corr` (c where
// a caller keeps no second chain); terms whose lo is known to be 0 are
// left out
template <bool a_exact, bool b_exact>
__device__ __forceinline__ void mma_3xtf32(float c[4], float corr[4],
                                           const unsigned ah[4],
                                           const unsigned al[4], unsigned bh0,
                                           unsigned bh1, unsigned bl0,
                                           unsigned bl1) {
  if constexpr (!a_exact) mma_tf32(corr, al, bh0, bh1);
  if constexpr (!b_exact) mma_tf32(corr, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// The maxima of a row group's tile, shared by the two warps that split its
// tokens: each writes its own, waits for its partner (named barrier
// 1 + rg of 64 threads) and takes the larger.
struct PairMax {
  float* mx;     // [2 halves][64 rows] in shared memory
  int rg, half;
  __device__ __forceinline__ float2 exchange(float a0, float a1, int g,
                                             int t) const {
    float* mine = mx + half * MT + 16 * rg;
    const float* theirs = mx + (1 - half) * MT + 16 * rg;
    if (t == 0) {
      mine[g] = a0;
      mine[g + 8] = a1;
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg));
    const float2 r = make_float2(fmaxf(a0, theirs[g]),
                                 fmaxf(a1, theirs[g + 8]));
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rg));   // both have read
    return r;
  }
};

// One tile's online softmax on a warp's 16 x 8 NS score fragment s (rows
// r0 = g and r1 = g + 8 of the warp, tokens t0 + 8 n + 2 t + e): mask,
// running maxima and sums over the quad holding a row (and over the
// partner warp's tokens, through `pair`, when two warps split the tile),
// the output rescaled; s becomes the unrounded P.  `kscale` (int8 pages)
// scales each token's scores.  A row whose tokens here all lie past the
// span keeps its state (its maximum stays -inf until a live tile comes).
template <int NN, int NS>
__device__ __forceinline__ void online_softmax(
    float s[NS][4], float o[NN][4], float& m0, float& m1, float& l0,
    float& l1, int pos0, int pos1, int t0, int t_end, int g, int t,
    float scale, const float* kscale, const PairMax* pair) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * n + 2 * t + e;
      const int tok = t0 + c;
      const float f = kscale != nullptr ? scale * kscale[c] : scale;
      const float a0 = s[n][e] * f, a1 = s[n][2 + e] * f;
      s[n][e] = tok >= t_end ? -INFINITY : (tok <= pos0 ? a0 : MASK_VALUE);
      s[n][2 + e] =
          tok >= t_end ? -INFINITY : (tok <= pos1 ? a1 : MASK_VALUE);
      mx0 = fmaxf(mx0, s[n][e]);
      mx1 = fmaxf(mx1, s[n][2 + e]);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (pair != nullptr) {
    const float2 both = pair->exchange(mx0, mx1, g, t);
    mx0 = both.x;
    mx1 = both.y;
  }
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  // the reference point of exp: the new maximum, 0 while it is -inf
  const float b0 = mn0 == -INFINITY ? 0.f : mn0;
  const float b1 = mn1 == -INFINITY ? 0.f : mn1;
  const float al0 = expf(m0 - b0), al1 = expf(m1 - b1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = expf(s[n][e] - b0);
      s[n][2 + e] = expf(s[n][2 + e] - b1);
      sum0 += s[n][e];
      sum1 += s[n][2 + e];
    }
  }
  l0 = al0 * l0 + quad_sum(sum0);
  l1 = al1 * l1 + quad_sum(sum1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    o[n][0] *= al0;
    o[n][1] *= al0;
    o[n][2] *= al1;
    o[n][3] *= al1;
  }
}

// A warp's rows r0 and r1 of the item, columns below d: a row taking one
// span is finished here (in q's type); one taking more leaves its partial
// for the merge.
template <int NN, bool FULL>
__device__ __forceinline__ void write_rows(const Params& p, const Meta& meta,
                                           float o[NN][4], float m0,
                                           float m1, float l0, float l1,
                                           int r0, int r1, int n_rows,
                                           int split, int t) {
  const int D = head_dim<NN * 8, FULL>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (r >= n_rows || split >= meta.ns[r]) continue;
    const float l = h ? l1 : l0;
    const size_t rh = static_cast<size_t>(meta.row[r]) * p.H + meta.head[r];
    const bool done = meta.ns[r] == 1;
    const float inv = done ? 1.f / (l == 0.f ? 1.f : l) : 1.f;
    const size_t part = static_cast<size_t>(split) * p.T * p.H + rh;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      if (8 * n >= D) break;   // d % 8 == 0: columns 8 n .. 8 n + 7 all past d
      const size_t col = 8 * n + 2 * t;
      const float x0 = o[n][2 * h] * inv, x1 = o[n][2 * h + 1] * inv;
      if (done) {
        store2(p.out, rh * D + col, x0, x1, p.q_bf16);
      } else {
        store2(p.ws_acc, part * D + col, x0, x1, 0);
      }
    }
    if (!done && t == 0) p.ws_ml[part] = make_float2(h ? m1 : m0, l);
  }
}

// ---------------------------------------------------------------------------
// f32 kernel: f32 queries, or any pages but bf16 under bf16 ones
// ---------------------------------------------------------------------------

// Wide items (3xTF32 MMA): Q [64][D + 4] f32, P [64][KT + 4] f32 and a
// 2-stage K/V ring.  Eight warps: warp w takes score rows 16 (w % 4) ..
// + 15 and the tokens 16 (w / 4) .. + 15 of every tile; the two warps of
// a row group share each tile's maxima (so P is rounded against the
// 32-token tile's running maximum, as the plain version rounds it) and add
// up their sums once, at the end of the item.
template <typename T, int D>
struct F32Layout {
  static constexpr int QS = D + 4;          // f32 Q tile stride
  static constexpr int KS = D + Pad<T>::k;  // K / V tile strides
  static constexpr int VS = D + Pad<T>::v;
  static constexpr int PS = KT + 4;         // f32 P tile stride
  static constexpr size_t K_BYTES = static_cast<size_t>(KT) * KS * sizeof(T);
  static constexpr size_t V_BYTES = static_cast<size_t>(KT) * VS * sizeof(T);
  static constexpr size_t STAGE = K_BYTES + V_BYTES + 2 * KT * sizeof(float);
  static constexpr size_t Q_OFF = sizeof(Meta);
  static constexpr size_t P_OFF = Q_OFF + static_cast<size_t>(MT) * QS * 4;
  static constexpr size_t X_OFF = P_OFF + static_cast<size_t>(MT) * PS * 4;
  static constexpr size_t S_OFF = X_OFF + 2 * MT * sizeof(float);
  static constexpr size_t BYTES = S_OFF + NSTAGE * STAGE;
};

template <typename T, int D, bool FULL>
__device__ __forceinline__ void f32_item(const Params& p,
                                         unsigned char* smem, int blk,
                                         int run, int chunk, int split,
                                         int kh) {
  using L = F32Layout<T, D>;
  constexpr int NT = F32_THREADS;
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr bool KV_EXACT = !std::is_same<T, float>::value;  // bf16, int8
  constexpr bool P_EXACT = std::is_same<T, bf16>::value;     // rounded P
  constexpr int NN = D / 8;

  Meta& meta = *reinterpret_cast<Meta*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* p_s = reinterpret_cast<float*>(smem + L::P_OFF);
  unsigned char* stages = smem + L::S_OFF;
  const int seq = p.row_seq[blk * BLOCK_ROWS];
  const int* pt = p.page_table + static_cast<size_t>(seq) * p.Pm;

  auto k_tile = [&](int s) {
    return reinterpret_cast<T*>(stages + s * L::STAGE);
  };
  auto v_tile = [&](int s) {
    return reinterpret_cast<T*>(stages + s * L::STAGE + L::K_BYTES);
  };
  auto k_sc = [&](int s) {
    return reinterpret_cast<float*>(stages + s * L::STAGE + L::K_BYTES +
                                    L::V_BYTES);
  };
  auto v_sc = [&](int s) { return k_sc(s) + KT; };
  auto fetch = [&](int t0, int t1, int tile) {
    const int s = tile % NSTAGE;
    fetch_tile<T, D, FULL, L::KS, L::VS, NT>(p, pt, kh, t0, t1, k_tile(s),
                                       v_tile(s), k_sc(s), v_sc(s));
  };

  int n_rows, t_begin, t_end;
  if (!setup_item(p, meta, blk, run, chunk, split, kh, n_rows, t_begin,
                  t_end)) {
    return;
  }
  static_assert(NSTAGE == 2, "one tile is fetched ahead");
  fetch(t_begin, t_end, 0);
  cp_async_commit();

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % 4, half = warp / 4;    // row group, token half
  const int n_tiles = (t_end - t_begin + KT - 1) / KT;
  const bool active = rg * 16 < n_rows;        // warp-uniform

  // Q tile in f32: score rows past n_rows and columns past d are zero
  for (int idx = tid; idx < MT * (D / 4); idx += NT) {
    const int r = idx / (D / 4);
    const int c4 = (idx % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && c4 < head_dim<D, FULL>(p)) {
      const size_t off =
          (static_cast<size_t>(meta.row[r]) * p.H + meta.head[r]) *
              head_dim<D, FULL>(p) +
          c4;
      v = p.q_bf16 ? load4(static_cast<const bf16*>(p.q) + off)
                   : load4(static_cast<const float*>(p.q) + off);
    }
    *reinterpret_cast<float4*>(q_s + r * L::QS + c4) = v;
  }

  const int r0 = rg * 16 + g, r1 = r0 + 8;
  const int pos0 = meta.qpos[r0], pos1 = meta.qpos[r1];
  const int tk = 16 * half;                    // the warp's first token
  const PairMax pair{reinterpret_cast<float*>(smem + L::X_OFF), rg, half};
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) fetch(t_begin + (tile + 1) * KT, t_end, tile + 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();   // this tile (and, the first time, Q) landed

    const int st = tile % NSTAGE;
    const int t0 = t_begin + tile * KT;
    const T* kt = k_tile(st);
    const T* vt = v_tile(st);
    if (active) {
      // S = Q K^T: 16 rows by the warp's 2 n-tiles of 8 tokens, 8 columns
      // a step; hi hi and the small terms in separate chains
      float s[2][4], sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = sc[n][e] = 0.f;
      }
#pragma unroll 4
      for (int kk = 0; kk < D / 8; ++kk) {
        unsigned ah[4], al[4];
        const int c = 8 * kk + t;
        split_tf32<false>(q_s[r0 * L::QS + c], ah[0], al[0]);
        split_tf32<false>(q_s[r1 * L::QS + c], ah[1], al[1]);
        split_tf32<false>(q_s[r0 * L::QS + c + 4], ah[2], al[2]);
        split_tf32<false>(q_s[r1 * L::QS + c + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const T* krow = kt + (tk + 8 * n + g) * L::KS + c;
          unsigned bh0, bl0, bh1, bl1;
          split_tf32<KV_EXACT>(ld1(krow), bh0, bl0);
          split_tf32<KV_EXACT>(ld1(krow + 4), bh1, bl1);
          mma_3xtf32<false, KV_EXACT>(s[n], sc[n], ah, al, bh0, bh1, bl0,
                                      bl1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += sc[n][e];
      }
      online_softmax<NN, 2>(s, o, m0, m1, l0, l1, pos0, pos1, t0 + tk,
                            t_end, g, t, p.sm_scale,
                            QUANT ? k_sc(st) + tk : nullptr, &pair);
      // P to shared memory (rounded on bf16 pages; int8 folds in V's
      // scale), as the PV product's A operand
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = tk + 8 * n + 2 * t + e;
          const float vs = QUANT ? v_sc(st)[c] : 1.f;
          p_s[r0 * L::PS + c] = round_p<T>(s[n][e]) * vs;
          p_s[r1 * L::PS + c] = round_p<T>(s[n][2 + e]) * vs;
        }
      }
      __syncwarp();
      // O += P V over the warp's 16 tokens, 8 a step
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        unsigned ah[4], al[4];
        const int c = tk + 8 * k2 + t;
        split_tf32<P_EXACT>(p_s[r0 * L::PS + c], ah[0], al[0]);
        split_tf32<P_EXACT>(p_s[r1 * L::PS + c], ah[1], al[1]);
        split_tf32<P_EXACT>(p_s[r0 * L::PS + c + 4], ah[2], al[2]);
        split_tf32<P_EXACT>(p_s[r1 * L::PS + c + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const T* vcol = vt + c * L::VS + 8 * n + g;
          unsigned bh0, bl0, bh1, bl1;
          split_tf32<KV_EXACT>(ld1(vcol), bh0, bl0);
          split_tf32<KV_EXACT>(ld1(vcol + 4 * L::VS), bh1, bl1);
          mma_3xtf32<P_EXACT, KV_EXACT>(o[n], o[n], ah, al, bh0, bh1, bl0,
                                        bl1);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  // the second half's (l, acc) through the free Q and P tiles
  if (active && half == 1) {
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = 8 * n + 2 * t;
      *reinterpret_cast<float2*>(q_s + r0 * L::QS + col) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(q_s + r1 * L::QS + col) =
          make_float2(o[n][2], o[n][3]);
    }
    if (t == 0) {
      p_s[r0 * L::PS + 1] = l0;
      p_s[r1 * L::PS + 1] = l1;
    }
  }
  __syncthreads();
  if (active && half == 0) {   // the same running maxima: sums add up
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 b0 =
          *reinterpret_cast<const float2*>(q_s + r0 * L::QS + col);
      const float2 b1 =
          *reinterpret_cast<const float2*>(q_s + r1 * L::QS + col);
      o[n][0] += b0.x;
      o[n][1] += b0.y;
      o[n][2] += b1.x;
      o[n][3] += b1.y;
    }
    write_rows<NN, FULL>(p, meta, o, m0, m1, l0 + p_s[r0 * L::PS + 1],
                   l1 + p_s[r1 * L::PS + 1], r0, r1, n_rows, split, t);
  }
}

// Narrow items: a run of at most NARROW_ROWS score rows (a decode row times
// its group) in f32 on the CUDA cores, each K and V element read from
// shared memory once a tile (the MMA path would spend a 16-row tile on
// one row).  It carves the same shared memory otherwise: Q and P of
// NARROW_ROWS rows and the 2-stage K/V ring.
template <typename T, int D>
struct NarrowLayout {
  static constexpr int QS = D + 4;          // f32 Q tile stride
  static constexpr int PS = KT + 4;         // f32 P tile stride
  static constexpr int KS = D + Pad<T>::k;  // K and V rows
  static constexpr size_t TILE = static_cast<size_t>(KT) * KS * sizeof(T);
  static constexpr size_t STAGE = 2 * TILE + 2 * KT * sizeof(float);
  static constexpr size_t Q_OFF = sizeof(Meta);
  static constexpr size_t P_OFF =
      Q_OFF + static_cast<size_t>(NARROW_ROWS) * QS * 4;
  static constexpr size_t S_OFF =
      P_OFF + static_cast<size_t>(NARROW_ROWS) * PS * 4;
  static_assert(S_OFF + NSTAGE * STAGE <= F32Layout<T, D>::BYTES,
                "the narrow carve-up fits the wide one");
};

// Scores: warp w takes tokens 4 w .. 4 w + 3, eight lanes a token, each
// lane every eighth float4 of the row; the online softmax of a row is one
// warp's (lane = token).  PV: eight lanes share 4 columns of RK rows,
// lane i taking tokens i, i + 8, ..; they add up their sums once, at the
// end of the item.
template <typename T, int D, bool FULL>
__device__ __forceinline__ void narrow_item(const Params& p,
                                            unsigned char* smem, int blk,
                                            int run, int chunk, int split,
                                            int kh) {
  using L = NarrowLayout<T, D>;
  constexpr int NT = F32_THREADS;
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int C4 = D / 4;                    // column chunks of 4
  constexpr int KC = (C4 + 7) / 8;             // a lane's chunks of a row
  constexpr int CG = C4 < 32 ? C4 : 32;        // chunk groups of the PV
  constexpr int RS = 32 / CG;                  // row sets of the PV
  constexpr int RK = (NARROW_ROWS + RS - 1) / RS;
  constexpr int CK = C4 / CG;                  // chunks a lane adds to
  Meta& meta = *reinterpret_cast<Meta*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* p_s = reinterpret_cast<float*>(smem + L::P_OFF);
  const int seq = p.row_seq[blk * BLOCK_ROWS];
  const int* pt = p.page_table + static_cast<size_t>(seq) * p.Pm;
  auto stage = [&](int tile) {
    return smem + L::S_OFF + (tile % NSTAGE) * L::STAGE;
  };
  auto fetch = [&](int t0, int t1, int tile) {
    unsigned char* b = stage(tile);
    float* sc = reinterpret_cast<float*>(b + 2 * L::TILE);
    fetch_tile<T, D, FULL, L::KS, L::KS, NT>(p, pt, kh, t0, t1,
                                       reinterpret_cast<T*>(b),
                                       reinterpret_cast<T*>(b + L::TILE), sc,
                                       sc + KT);
  };

  int n_rows, t_begin, t_end;
  if (!setup_item(p, meta, blk, run, chunk, split, kh, n_rows, t_begin,
                  t_end)) {
    return;
  }
  fetch(t_begin, t_end, 0);
  cp_async_commit();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ts = tid % 8, grp = tid / 8;       // PV: token slot, group
  const int cg = grp % CG, rs = grp / CG;
  const int n_tiles = (t_end - t_begin + KT - 1) / KT;

  for (int idx = tid; idx < n_rows * C4; idx += NT) {
    const int r = idx / C4;
    const int c = (idx % C4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);   // columns past d
    if (c < head_dim<D, FULL>(p)) {
      const size_t off =
          (static_cast<size_t>(meta.row[r]) * p.H + meta.head[r]) *
              head_dim<D, FULL>(p) +
          c;
      v = p.q_bf16 ? load4(static_cast<const bf16*>(p.q) + off)
                   : load4(static_cast<const float*>(p.q) + off);
    }
    *reinterpret_cast<float4*>(q_s + r * L::QS + c) = v;
  }
  if (tid < NARROW_ROWS) {
    meta.row_m[tid] = -INFINITY;
    meta.row_l[tid] = 0.f;
  }
  float acc[RK][CK][4];
#pragma unroll
  for (int k = 0; k < RK; ++k) {
#pragma unroll
    for (int u = 0; u < CK; ++u) {
      acc[k][u][0] = acc[k][u][1] = acc[k][u][2] = acc[k][u][3] = 0.f;
    }
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) fetch(t_begin + (tile + 1) * KT, t_end, tile + 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();   // this tile (and, the first time, Q) landed

    unsigned char* b = stage(tile);
    const T* kt = reinterpret_cast<const T*>(b);
    const T* vt = reinterpret_cast<const T*>(b + L::TILE);
    const float* ksc = reinterpret_cast<const float*>(b + 2 * L::TILE);
    const float* vsc = ksc + KT;
    const int t0 = t_begin + tile * KT;

    // scores into the P tile: token j, the lane's eighth of its columns
    {
      const int j = 4 * warp + lane / 8, q = lane % 8;
      float4 kr[KC];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        kr[i] = q + 8 * i < C4 ? load4(kt + j * L::KS + 4 * (q + 8 * i))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float f = QUANT ? p.sm_scale * ksc[j] : p.sm_scale;
      for (int r = 0; r < n_rows; ++r) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          if (q + 8 * i < C4) {
            d += dot4(kr[i], *reinterpret_cast<const float4*>(
                                 q_s + r * L::QS + 4 * (q + 8 * i)));
          }
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        if (q == 0) p_s[r * L::PS + j] = d * f;
      }
    }
    __syncthreads();

    // online softmax of row r by warp r % 8, lane = token
    for (int r = warp; r < n_rows; r += NT / 32) {
      const int tok = t0 + lane;
      const float sc = p_s[r * L::PS + lane];
      const float v = tok >= t_end ? -INFINITY
                    : (tok <= meta.qpos[r] ? sc : MASK_VALUE);
      const float m_old = meta.row_m[r];
      const float m_new = fmaxf(m_old, warp_maxf(v));
      const float pr = expf(v - m_new);
      const float l_new =
          expf(m_old - m_new) * meta.row_l[r] + warp_sum(pr);
      __syncwarp();
      p_s[r * L::PS + lane] = round_p<T>(pr) * (QUANT ? vsc[lane] : 1.f);
      if (lane == 0) {
        meta.row_alpha[r] = expf(m_old - m_new);
        meta.row_m[r] = m_new;
        meta.row_l[r] = l_new;
      }
    }
    __syncthreads();

    // acc += P V: the lane's tokens, its rows' P, its chunks of V
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const int r = rs + RS * k;
      if (r < n_rows) {
        const float al = meta.row_alpha[r];
#pragma unroll
        for (int u = 0; u < CK; ++u) {
          acc[k][u][0] *= al;
          acc[k][u][1] *= al;
          acc[k][u][2] *= al;
          acc[k][u][3] *= al;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KT / 8; ++i) {
      const int j = ts + 8 * i;
#pragma unroll
      for (int u = 0; u < CK; ++u) {
        const float4 v4 = load4(vt + j * L::KS + 4 * (cg + CG * u));
#pragma unroll
        for (int k = 0; k < RK; ++k) {
          const int r = rs + RS * k;
          if (r < n_rows) {
            const float pr = p_s[r * L::PS + j];
            acc[k][u][0] = fmaf(pr, v4.x, acc[k][u][0]);
            acc[k][u][1] = fmaf(pr, v4.y, acc[k][u][1]);
            acc[k][u][2] = fmaf(pr, v4.z, acc[k][u][2]);
            acc[k][u][3] = fmaf(pr, v4.w, acc[k][u][3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with this stage and P tile
  }

#pragma unroll
  for (int k = 0; k < RK; ++k) {
    const int r = rs + RS * k;
    if (r >= n_rows) continue;
#pragma unroll
    for (int u = 0; u < CK; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc[k][u][e];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        acc[k][u][e] = x;
      }
    }
    if (ts != 0 || split >= meta.ns[r]) continue;
    const size_t rh = static_cast<size_t>(meta.row[r]) * p.H + meta.head[r];
    const float l = meta.row_l[r];
    const bool done = meta.ns[r] == 1;
    const float inv = done ? 1.f / (l == 0.f ? 1.f : l) : 1.f;
    const size_t part = static_cast<size_t>(split) * p.T * p.H + rh;
#pragma unroll
    for (int u = 0; u < CK; ++u) {
      const int c = 4 * (cg + CG * u);
      const int dh = head_dim<D, FULL>(p);
      if (c >= dh) continue;   // columns past d
      const float* x = acc[k][u];
      if (done) {
        store2(p.out, rh * dh + c, x[0] * inv, x[1] * inv, p.q_bf16);
        store2(p.out, rh * dh + c + 2, x[2] * inv, x[3] * inv, p.q_bf16);
      } else {
        *reinterpret_cast<float4*>(p.ws_acc + part * dh + c) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    }
    if (!done && cg == 0) p.ws_ml[part] = make_float2(meta.row_m[r], l);
  }
}

// two blocks an SM where their shared memory fits (head dims up to 128):
// at most 128 registers a thread
template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(F32_THREADS, D > 128 ? 1 : 2)
ragged_attention_f32_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  for_each_item(p, *reinterpret_cast<Meta*>(smem),
                [&](bool wide, int blk, int run, int chunk, int split,
                    int kh) {
                  if (wide) {
                    f32_item<T, D, FULL>(p, smem, blk, run, chunk, split,
                                         kh);
                  } else {
                    narrow_item<T, D, FULL>(p, smem, blk, run, chunk,
                                            split, kh);
                  }
                });
}

// ---------------------------------------------------------------------------
// bf16 kernel: bf16 queries on bf16 pages
// ---------------------------------------------------------------------------

template <int D>
struct Bf16Layout {
  static constexpr int QS = D + 8;   // bf16 Q / K / V tile stride
  static constexpr size_t TILE = static_cast<size_t>(KT) * QS * 2;
  static constexpr size_t STAGE = 2 * TILE;
  static constexpr size_t Q_OFF = sizeof(Meta);
  static constexpr size_t S_OFF = Q_OFF + static_cast<size_t>(MT) * QS * 2;
  static constexpr size_t BYTES = S_OFF + NSTAGE * STAGE;
};

template <int D, bool FULL>
__device__ __forceinline__ void bf16_item(const Params& p,
                                          unsigned char* smem, int blk,
                                          int run, int chunk, int split,
                                          int kh) {
  using L = Bf16Layout<D>;
  constexpr int NN = D / 8;

  Meta& meta = *reinterpret_cast<Meta*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  unsigned char* stages = smem + L::S_OFF;
  const int seq = p.row_seq[blk * BLOCK_ROWS];
  const int* pt = p.page_table + static_cast<size_t>(seq) * p.Pm;

  int n_rows, t_begin, t_end;
  if (!setup_item(p, meta, blk, run, chunk, split, kh, n_rows, t_begin,
                  t_end)) {
    return;
  }

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_tiles = (t_end - t_begin + KT - 1) / KT;
  const bool active = warp * 16 < n_rows;   // warp-uniform

  auto k_tile = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * L::STAGE);
  };
  auto v_tile = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * L::STAGE + L::TILE);
  };
  auto fetch = [&](int tile) {
    const int s = tile % NSTAGE;
    fetch_tile<bf16, D, FULL, L::QS, L::QS, BF16_THREADS>(
        p, pt, kh, t_begin + tile * KT, t_end, k_tile(s), v_tile(s),
        nullptr, nullptr);
  };
  fetch(0);
  cp_async_commit();

  for (int idx = tid; idx < MT * (D / 8); idx += BF16_THREADS) {
    const int r = idx / (D / 8);
    const int c8 = (idx % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows && c8 < head_dim<D, FULL>(p)) {
      v = *reinterpret_cast<const uint4*>(
          static_cast<const bf16*>(p.q) +
          (static_cast<size_t>(meta.row[r]) * p.H + meta.head[r]) *
              head_dim<D, FULL>(p) +
          c8);
    }
    *reinterpret_cast<uint4*>(q_s + r * L::QS + c8) = v;
  }

  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int pos0 = meta.qpos[r0], pos1 = meta.qpos[r1];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + NSTAGE - 1 < n_tiles) fetch(tile + NSTAGE - 1);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();

    const int st = tile % NSTAGE;
    const int t0 = t_begin + tile * KT;
    const bf16* kt = k_tile(st);
    const bf16* vt = v_tile(st);
    if (active) {
      // S = Q K^T: 16 rows by 4 n-tiles of 8 tokens
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, q_s + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) *
                                 L::QS + 16 * kk + 8 * (lane / 16));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned b[4];
          ldmatrix_x4(b, kt + (16 * np + (lane % 8) + 8 * (lane / 16)) *
                                  L::QS + 16 * kk + 8 * ((lane / 8) % 2));
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      online_softmax<NN, 4>(s, o, m0, m1, l0, l1, pos0, pos1, t0, t_end, g,
                            t, p.sm_scale, nullptr, nullptr);
      // O += round(P) V: P's accumulators are the A operand, 16 tokens a step
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        unsigned a[4];
        a[0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
        a[1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
        a[2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
        a[3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
#pragma unroll
        for (int nd = 0; nd < D / 16; ++nd) {
          unsigned b[4];
          ldmatrix_x4_trans(b, vt + (16 * k2 + (lane % 8) +
                                     8 * ((lane / 8) % 2)) * L::QS +
                                   16 * nd + 8 * (lane / 16));
          mma_bf16(o[2 * nd], a, b[0], b[1]);
          mma_bf16(o[2 * nd + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  if (active) {
    write_rows<NN, FULL>(p, meta, o, m0, m1, l0, l1, r0, r1, n_rows, split,
                         t);
  }
}

template <int D, bool FULL>
__global__ void __launch_bounds__(BF16_THREADS)
ragged_attention_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  for_each_item(p, *reinterpret_cast<Meta*>(smem),
                [&](bool, int blk, int run, int chunk, int split, int kh) {
                  bf16_item<D, FULL>(p, smem, blk, run, chunk, split, kh);
                });
}

// ---------------------------------------------------------------------------
// plan: one warp per row block
// ---------------------------------------------------------------------------

constexpr int PLAN_WARPS = 8;

// The warp of a run's first row block lists the run's items: for each
// chunk of its score rows, one item per span its rows' live tokens take;
// a run with more than NARROW_ROWS score rows writes from the front of the
// list, the others from its back.
__global__ void __launch_bounds__(PLAN_WARPS * 32)
ragged_attention_plan_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x * PLAN_WARPS + threadIdx.x / 32;
  const int n_blocks = p.T / BLOCK_ROWS;
  if (blk >= n_blocks) return;
  const int row0 = blk * BLOCK_ROWS;
  const int seq = p.row_seq[row0];
  if (blk % RUN_BLOCKS != 0 && p.row_seq[row0 - BLOCK_ROWS] == seq) return;
  // the run: lane b < 8 looks at the b-th row block from here
  const int room = min(RUN_BLOCKS - blk % RUN_BLOCKS, n_blocks - blk);
  const bool same =
      lane < room && p.row_seq[row0 + lane * BLOCK_ROWS] == seq;
  const int run = __ffs(~__ballot_sync(0xffffffffu, same)) - 1;
  // the run's real rows: lane covers rows lane and lane + 32
  const int kv_len = p.kv_lens[seq];
  const int cap = p.Pm * p.page;
  int n_lo = -1, n_hi = -1;
  if (lane < run * BLOCK_ROWS) {
    const int qp = p.qpos[row0 + lane];
    if (qp >= 0) n_lo = row_tokens(qp, kv_len, cap);
  }
  if (lane + 32 < run * BLOCK_ROWS) {
    const int qp = p.qpos[row0 + lane + 32];
    if (qp >= 0) n_hi = row_tokens(qp, kv_len, cap);
  }
  const unsigned b_lo = __ballot_sync(0xffffffffu, n_lo >= 0);
  const unsigned b_hi = __ballot_sync(0xffffffffu, n_hi >= 0);
  const unsigned below = (1u << lane) - 1u;
  const int i_lo = __popc(b_lo & below);               // compacted ranks
  const int i_hi = __popc(b_lo) + __popc(b_hi & below);
  const int n_real = __popc(b_lo) + __popc(b_hi);
  const int G = p.H / p.KVH;
  const int chunks = (n_real * G + MT - 1) / MT;
  // row i holds score rows [i G, i G + G): in chunk c where they meet
  // [64 c, 64 c + 64)
  auto chunk_splits = [&](int c) {
    int n = 0;
    if (n_lo >= 0 && i_lo * G < (c + 1) * MT && (i_lo + 1) * G > c * MT) {
      n = n_lo;
    }
    if (n_hi >= 0 && i_hi * G < (c + 1) * MT && (i_hi + 1) * G > c * MT) {
      n = max(n, n_hi);
    }
    return (warp_max(n) + p.span - 1) / p.span;
  };
  int total = 0;
  for (int c = 0; c < chunks; ++c) total += chunk_splits(c);
  const bool wide = n_real * G > NARROW_ROWS;
  int at = 0;
  if (lane == 0 && total > 0) at = atomicAdd(&p.counts[wide ? 0 : 1], total);
  at = __shfl_sync(0xffffffffu, at, 0);
  for (int c = 0; c < chunks; ++c) {
    const int splits = chunk_splits(c);
    for (int s = lane; s < splits; s += 32) {
      const int slot = at + s;
      p.items[wide ? slot : p.max_items - 1 - slot] =
          make_int4(blk, c, s, run);
    }
    at += splits;
  }
}

// ---------------------------------------------------------------------------
// merge: one block per (row block, query head)
// ---------------------------------------------------------------------------

constexpr int MERGE_THREADS = 128;

// Every row that the attention blocks did not finish: the spans' partials
// of a row with more than one combined by their maxima (each row's weights
// worked out once, by one thread), and zeros for a padded row or an empty
// sequence's.
__global__ void __launch_bounds__(MERGE_THREADS)
ragged_attention_merge_kernel(const Params p) {
  __shared__ float w_s[BLOCK_ROWS][MAX_SPLITS];
  __shared__ int ns_s[BLOCK_ROWS];
  const int blk = blockIdx.x, head = blockIdx.y;
  const int D = p.D, D4 = p.D / 4;
  const size_t plane = static_cast<size_t>(p.T) * p.H;
  if (threadIdx.x < BLOCK_ROWS) {
    const int i = threadIdx.x;
    const int row = blk * BLOCK_ROWS + i;
    const int kv_len = p.kv_lens[p.row_seq[blk * BLOCK_ROWS]];
    const int ns = (row_tokens(p.qpos[row], kv_len, p.Pm * p.page) +
                    p.span - 1) / p.span;
    ns_s[i] = ns;
    if (ns > 1) {
      const size_t rh = static_cast<size_t>(row) * p.H + head;
      float mx = -INFINITY;
      for (int s = 0; s < ns; ++s) mx = fmaxf(mx, p.ws_ml[s * plane + rh].x);
      float den = 0.f;
      for (int s = 0; s < ns; ++s) {
        const float2 ml = p.ws_ml[s * plane + rh];
        w_s[i][s] = expf(ml.x - mx);
        den += w_s[i][s] * ml.y;
      }
      const float inv = 1.f / (den == 0.f ? 1.f : den);
      for (int s = 0; s < ns; ++s) w_s[i][s] *= inv;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BLOCK_ROWS * D4; idx += MERGE_THREADS) {
    const int i = idx / D4;
    const int ns = ns_s[i];
    if (ns == 1) continue;   // finished by its attention block
    const size_t rh = static_cast<size_t>(blk * BLOCK_ROWS + i) * p.H + head;
    const int c4 = (idx % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < ns; ++s) {
      const float w = w_s[i][s];
      const float4 a = *reinterpret_cast<const float4*>(
          p.ws_acc + (s * plane + rh) * D + c4);
      x.x += w * a.x;
      x.y += w * a.y;
      x.z += w * a.z;
      x.w += w * a.w;
    }
    store2(p.out, rh * D + c4, x.x, x.y, p.q_bf16);
    store2(p.out, rh * D + c4 + 2, x.z, x.w, p.q_bf16);
  }
}

// ---------------------------------------------------------------------------
// head dims above 256: the wide kernel
// ---------------------------------------------------------------------------

// Above head dim 256 the persistent kernels' Q tile and K/V ring no longer
// fit a block's shared memory (at 512: 132 KB of Q and 264 KB of ring in
// f32).  The wide kernel is the simple form of the same function: one block
// per (query row, query head, span, chunk of WIDE_MAX_D output columns),
// 4 warps on the CUDA cores, no shared K/V tiles.  It walks its span's live
// tokens in tiles of KT: warp w scores tokens w, w + 4, ... of a tile
// (lanes across the row's columns, K read through the page table once per
// query head and chunk), every thread takes the tile's running maximum and
// the P of its 32 tokens (rounded to bf16 on bf16 pages against that
// maximum, as the plain version's round_p_tile and round_p_span do), and
// thread t accumulates the chunk's columns t, t + 128, ... of the PV
// product.  Up to WIDE_MAX_D the row of Q waits in shared memory and one
// chunk covers every column; above it (any head dim, C4) each block scores
// over the whole head dim with Q read from global memory, the same sums in
// the same order, and writes its own chunk: the scores are computed once
// per chunk.  A row taking one span writes its output; a row taking more
// writes its partial for the merge (m and l from the first chunk's
// blocks), as the other kernels do.  What bounds it: every K and V row is
// read once per query head (G times under GQA, and K once per chunk) with
// one multiply-add per element, so bytes; it makes no use of the tensor
// cores and is not tuned: it serves head dims no model of the repository
// uses.
constexpr int WIDE_THREADS = 128;
constexpr int WIDE_MAX_D = 512;

__device__ __forceinline__ float q_at(const Params& p, size_t at) {
  return p.q_bf16 ? ld1(static_cast<const bf16*>(p.q) + at)
                  : static_cast<const float*>(p.q)[at];
}

template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
ragged_attention_wide_kernel(const Params p) {
  __shared__ float q_s[WIDE_MAX_D];
  __shared__ float s_s[KT];
  const int D = p.D;
  const int nch = (D + WIDE_MAX_D - 1) / WIDE_MAX_D;
  const int row = blockIdx.x, head = blockIdx.y;
  const int split = blockIdx.z / nch, ch = blockIdx.z % nch;
  const int c0 = ch * WIDE_MAX_D, cw = min(WIDE_MAX_D, D - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int seq = p.row_seq[(row / BLOCK_ROWS) * BLOCK_ROWS];
  const int n = row_tokens(p.qpos[row], p.kv_lens[seq], p.Pm * p.page);
  const int ns = (n + p.span - 1) / p.span;
  if (split >= ns) return;   // the merge writes rows without live tokens
  const int t_begin = split * p.span, t_end = min(t_begin + p.span, n);
  const int kh = head / (p.H / p.KVH);
  const int* pt = p.page_table + static_cast<size_t>(seq) * p.Pm;
  const size_t rh = static_cast<size_t>(row) * p.H + head;
  const bool staged = nch == 1;
  if (staged) {
    for (int c = tid; c < D; c += WIDE_THREADS) q_s[c] = q_at(p, rh * D + c);
  }
  const T* kp = static_cast<const T*>(p.k_pages);
  const T* vp = static_cast<const T*>(p.v_pages);
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  float acc[WIDE_MAX_D / WIDE_THREADS];
#pragma unroll
  for (int i = 0; i < WIDE_MAX_D / WIDE_THREADS; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  __syncthreads();
  for (int t0 = t_begin; t0 < t_end; t0 += KT) {
    for (int j = warp; j < KT; j += WIDE_THREADS / 32) {
      const int tok = t0 + j;
      float s = -INFINITY;
      if (tok < t_end) {
        const size_t at = (static_cast<size_t>(pt[tok / p.page]) * p.page +
                           tok % p.page) * p.KVH + kh;
        const T* krow = kp + at * D;
        float dot = 0.f;
        if (staged) {
          for (int c = lane; c < D; c += 32) dot += q_s[c] * ld1(krow + c);
        } else {
          for (int c = lane; c < D; c += 32) {
            dot += q_at(p, rh * D + c) * ld1(krow + c);
          }
        }
        dot = warp_sum(dot);
        if (QUANT) dot *= p.k_scale[at];
        s = dot * p.sm_scale;
      }
      if (lane == 0) s_s[j] = s;
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int j = 0; j < KT; ++j) mx = fmaxf(mx, s_s[j]);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < WIDE_MAX_D / WIDE_THREADS; ++i) acc[i] *= alpha;
    for (int j = 0; j < KT && t0 + j < t_end; ++j) {
      const int tok = t0 + j;
      const float e = expf(s_s[j] - m_new);
      l += e;
      const size_t at = (static_cast<size_t>(pt[tok / p.page]) * p.page +
                         tok % p.page) * p.KVH + kh;
      const T* vrow = vp + at * D + c0;
      const float w = round_p<T>(e) * (QUANT ? p.v_scale[at] : 1.f);
#pragma unroll
      for (int i = 0; i < WIDE_MAX_D / WIDE_THREADS; ++i) {
        const int c = tid + WIDE_THREADS * i;
        if (c < cw) acc[i] = fmaf(w, ld1(vrow + c), acc[i]);
      }
    }
    m = m_new;
    __syncthreads();   // every thread has read this tile's scores
  }
  const bool done = ns == 1;
  const float inv = done ? 1.f / (l == 0.f ? 1.f : l) : 1.f;
  const size_t part = static_cast<size_t>(split) * p.T * p.H + rh;
#pragma unroll
  for (int i = 0; i < WIDE_MAX_D / WIDE_THREADS; ++i) {
    const int c = tid + WIDE_THREADS * i;
    if (c >= cw) continue;
    const size_t at = rh * D + c0 + c;
    if (!done) {
      p.ws_acc[part * D + c0 + c] = acc[i];
    } else if (p.q_bf16) {
      static_cast<bf16*>(p.out)[at] = __float2bfloat16(acc[i] * inv);
    } else {
      static_cast<float*>(p.out)[at] = acc[i] * inv;
    }
  }
  if (!done && ch == 0 && tid == 0) p.ws_ml[part] = make_float2(m, l);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The persistent attention launch of one kernel instantiation: dynamic
// shared memory above 48 KB enabled and the number of blocks the card
// holds at once counted, both once.
template <typename K>
cudaError_t launch_persistent(K kernel, int threads, size_t bytes,
                              int& blocks, const Params& p,
                              cudaStream_t stream) {
  if (blocks == 0) {
    cudaError_t e = cudaSuccess;
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    }
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
    }
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return e;
    blocks = max(1, per_sm) * max(1, sms);
  }
  kernel<<<blocks, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool FULL>
cudaError_t run_f32(const Params& p, cudaStream_t stream) {
  static int blocks = 0;   // once per instantiation
  return launch_persistent(ragged_attention_f32_kernel<T, D, FULL>,
                           F32_THREADS, F32Layout<T, D>::BYTES, blocks, p,
                           stream);
}

template <int D, bool FULL>
cudaError_t run_bf16(const Params& p, cudaStream_t stream) {
  static int blocks = 0;
  return launch_persistent(ragged_attention_bf16_kernel<D, FULL>,
                           BF16_THREADS, Bf16Layout<D>::BYTES, blocks, p,
                           stream);
}

template <int D, bool FULL>
cudaError_t run_pages(const Params& p, int page_dtype, cudaStream_t stream) {
  if (page_dtype == 1 && p.q_bf16) return run_bf16<D, FULL>(p, stream);
  switch (page_dtype) {
    case 0: return run_f32<float, D, FULL>(p, stream);
    case 1: return run_f32<bf16, D, FULL>(p, stream);
    case 2: return run_f32<int8_t, D, FULL>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t run_head_dim(const Params& p, int page_dtype,
                         cudaStream_t stream) {
  return p.D == D ? run_pages<D, true>(p, page_dtype, stream)
                  : run_pages<D, false>(p, page_dtype, stream);
}

cudaError_t run_wide(const Params& p, int page_dtype, cudaStream_t stream) {
  const int n_splits = (p.Pm * p.page + p.span - 1) / p.span;
  const int nch = (p.D + WIDE_MAX_D - 1) / WIDE_MAX_D;
  if (static_cast<long long>(n_splits) * nch > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(p.T, p.H, n_splits * nch);
  switch (page_dtype) {
    case 0:
      ragged_attention_wide_kernel<float><<<grid, WIDE_THREADS, 0, stream>>>(
          p);
      break;
    case 1:
      ragged_attention_wide_kernel<bf16><<<grid, WIDE_THREADS, 0, stream>>>(p);
      break;
    case 2:
      ragged_attention_wide_kernel<int8_t><<<grid, WIDE_THREADS, 0, stream>>>(
          p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the kernels compiled at the least width DP >= the head dim
cudaError_t run_attention(const Params& p, int page_dtype,
                          cudaStream_t stream) {
  if (p.D <= 16) return run_head_dim<16>(p, page_dtype, stream);
  if (p.D <= 32) return run_head_dim<32>(p, page_dtype, stream);
  if (p.D <= 64) return run_head_dim<64>(p, page_dtype, stream);
  if (p.D <= 128) return run_head_dim<128>(p, page_dtype, stream);
  return run_head_dim<256>(p, page_dtype, stream);
}

}  // namespace

extern "C" {

// page_dtype: 0 = f32 pages, 1 = bf16 pages, 2 = int8 pages (+ f32
// scales); q_dtype: 0 = f32, 1 = bf16 (the output's type too).  Scratch:
// ws_acc [n_splits, T, H, D] f32 and ws_ml [n_splits, T, H, 2] f32 (the
// partials), plan [4 * max_items + 4] int32 (the items, then three
// counters); n_splits * span must cover Pm * page, and max_items bound the
// plan's items.  Zeroes the counters, then launches plan, attention and
// merge.
int rpa_launch(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scale, const void* v_scale,
               const void* page_table, const void* kv_lens,
               const void* row_seq, const void* qpos, void* out,
               void* ws_acc, void* ws_ml, void* plan, int T_rows, int H,
               int KVH, int D, int page, int Pm, int span, int n_splits,
               int max_items, int page_dtype, int q_dtype, float sm_scale,
               void* stream) {
  if (KVH <= 0 || H % KVH != 0 || T_rows <= 0 || T_rows % BLOCK_ROWS != 0 ||
      D < 8 || D % 8 != 0 ||
      page <= 0 || Pm <= 0 || span <= 0 || span % KT != 0 ||
      n_splits <= 0 || n_splits > MAX_SPLITS || H > 65535 ||
      max_items <= 0 ||
      static_cast<long long>(n_splits) * span <
          static_cast<long long>(Pm) * page ||
      (q_dtype != 0 && q_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.page_table = static_cast<const int*>(page_table);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.row_seq = static_cast<const int*>(row_seq);
  p.qpos = static_cast<const int*>(qpos);
  p.out = out;
  p.ws_acc = static_cast<float*>(ws_acc);
  p.ws_ml = static_cast<float2*>(ws_ml);
  p.items = static_cast<int4*>(plan);
  p.counts = static_cast<int*>(plan) + 4 * static_cast<size_t>(max_items);
  p.T = T_rows;
  p.H = H;
  p.KVH = KVH;
  p.D = D;
  p.page = page;
  p.Pm = Pm;
  p.span = span;
  p.max_items = max_items;
  p.q_bf16 = q_dtype;
  p.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(p.counts, 0, 4 * sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_blocks = T_rows / BLOCK_ROWS;
  if (D > 256) {
    e = run_wide(p, page_dtype, st);
  } else {
    ragged_attention_plan_kernel<<<(n_blocks + PLAN_WARPS - 1) / PLAN_WARPS,
                                   PLAN_WARPS * 32, 0, st>>>(p);
    e = cudaGetLastError();
    if (e == cudaSuccess) e = run_attention(p, page_dtype, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  ragged_attention_merge_kernel<<<dim3(n_blocks, H), MERGE_THREADS, 0,
                                  st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
