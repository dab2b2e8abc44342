// Flash attention for Hopper (sm_90a) on the bf16 tensor-core route: the
// forward, dK/dV and dQ kernels as warp-specialised kernels, wgmma products
// fed by a TMA + mbarrier ring in shared memory.
//
// Replaces three Pallas TPU kernels of paddle_tpu/ops/attention.py:
//   flash_fwd    <- _flash_fwd_kernel    (:142, pallas_call :249)   B1
//   flash_bwd_kv <- _flash_bwd_kv_kernel (:289, pallas_call :448)   B2
//   flash_bwd_dq <- _flash_bwd_dq_kernel (:353, pallas_call :488)   B3
// for bf16 q/k/v/dO with P and dS rounded to bf16 (attn_pv_f32 off), head
// dims 64 and 128.  flash_attention.cu keeps the CUDA-core kernels of the
// f32 and pv_f32 routes.  What the kernels compute is that file's
// contract, unchanged:
//   - q [B, Sq, H, D], k/v [B, Sk, H, D] bf16; segment ids [B, S] int32;
//     lse and delta [B, H, Sq] f32;
//   - mask q_seg == k_seg and, under causal, q_index >= k_index on absolute
//     positions in the packed buffer; a masked score is DEFAULT_MASK_VALUE
//     (finite), so a row that matches nothing in the visited tiles averages
//     their V; tile pairs are visited or skipped at 64-row tiles by the
//     `_seg_live` ranges and the causal clamp, the same pairs in all three
//     kernels, so lse is never read for a pair the forward skipped;
//   - forward: online softmax in f32, P rounded to bf16 before PV, l == 0
//     -> 1, O in bf16, lse = m + log l in natural-log units;
//   - dK/dV: p = exp(s - lse) on the mask (else 0), dV += round(p)^T dO,
//     dS = p (dP - delta) scale with p unrounded, dK += round(dS)^T Q;
//   - dQ: the same p and dS, dQ += round(dS) K; results in bf16, and a
//     row that matches nothing gets zero gradients.
//
// What bounds them on the H100, at the training case (q/k/v [1, 8192, 16,
// 128], 8 causal segments of 1024): the forward moves 134 MB of q/k/v/O
// for 34 GFLOP of live products, so bytes bound it (0.0402 ms at 3.35
// TB/s); dK/dV does 69 GFLOP against 201 MB and dQ 52 GFLOP against 168
// MB, so operations bound them (0.0696 and 0.0522 ms at 989 TFLOP/s).
// The first versions (mma.sync, one 4-warp block a 64-row tile, tiles
// loaded through registers with no overlap) took 10x, 9x and 11x their
// bounds.  What this design does about it:
//   - products are wgmma (the only instruction that reaches the tensor
//     cores' full rate).  Forward: Q is read once from shared memory into
//     registers as the A operand of every S = Q K^T; P stays in registers
//     as the A operand of the PV product, V its B operand read MN-major
//     through the descriptor's transpose bit; the PV product of one key
//     tile is issued behind the next tile's S product and runs under its
//     softmax.  dK/dV: S^T = K Q^T and dP^T = V dO^T from shared memory,
//     P^T read while dP^T runs, dV += round(P^T) dO while dS is formed.
//     dQ: the forward's shape, S = Q K^T with Q in registers and dP = dO
//     V^T with dO read from shared memory (its registers would not fit
//     beside dQ's 64), dS rounded straight into A-operand registers, and
//     dQ += round(dS) K with K read MN-major, issued behind the next
//     tile's S and dP products;
//   - one producer thread keeps the next tiles in flight with TMA (no
//     registers or address arithmetic spent on copies), completion
//     signalled on mbarriers; two consumer warpgroups own 64 rows each
//     (128 query rows a block in the forward and dQ, 128 keys in dK/dV)
//     and share each tile the ring brings;
//   - the tiles a block visits are found 32 at a time by a warp ballot
//     over the per-tile ranges (`walk_masks`), not tile by tile;
//   - tiles arrive 128-byte swizzled (a D = 128 row is two 64-column
//     boxes), which the wgmma descriptors read without bank conflicts;
//   - the softmax works in log2 units (exp2f with scale * log2 e folded
//     into one multiply); lse goes back to natural log at the end;
//   - interior tile pairs (one segment on both sides and, under causal,
//     the key tile wholly below the diagonal) skip per-element masking;
//     only boundary and diagonal pairs read segment ids;
//   - dK/dV and dQ accumulate in f32 registers for the whole loop and are
//     written once; dQ goes out through shared memory by a TMA store.
// Key tiles stay 64 wide, so the running maxima, and P rounded from them,
// are the plain version's at KERNEL_TILE.
// A block is 384 threads, two consumer warpgroups and a producer
// warpgroup whose one working thread issues the copies; the producer
// gives up its registers (setmaxnreg) so each consumer thread may hold
// 240, and one block fills an SM's registers.
//
// Plain C interface (built by paddle_tpu_torch/kernels/build.py with nvcc,
// loaded with ctypes): each entry returns a cudaError_t.  The TMA tensor
// maps are built on the host for every launch through the driver's
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint (no link
// against libcuda), and passed as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // rows of a query tile and of a key tile
constexpr int BOX = 64;         // columns of a TMA box: 128 bytes of bf16
constexpr int BOX_BYTES = TILE * BOX * 2;   // one 64 x 64 box, 8 KB
constexpr int WG = 128;         // threads of a warpgroup
constexpr int CONSUMERS = 2;    // consumer warpgroups, one 64-row tile each
constexpr int THREADS = (CONSUMERS + 1) * WG;   // + the producer warpgroup
// registers a thread after the producer warpgroup hands its own to the
// consumers (setmaxnreg): 384 threads launch at 168 each
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int FWD_STAGES = 3;   // K/V tile pairs in flight
constexpr int BWD_STAGES = 2;   // Q/dO tile pairs in flight
constexpr int DQ_STAGES = 4;    // K/V tile pairs in flight in dQ
constexpr float MASK_VALUE = -0.7f * FLT_MAX;   // DEFAULT_MASK_VALUE
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// bytes of one 64-row tile of D columns: D / 64 boxes, one after another
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return D / BOX * BOX_BYTES;
}

// ---------------------------------------------------------------------------
// barriers, copies and products (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more of copies before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one 64-row x 64-column box of a [rows, H, D] map into shared memory
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int col, int head, int row,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned) from global memory
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one 64-row x 64-column box from shared memory to a [rows, H, D] map; the
// writers of the box must have made their stores visible to the copy
// (fence.proxy.async) first
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map,
                                              uint32_t src, int col,
                                              int head, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(head), "r"(row), "r"(src)
      : "memory");
}

// wait until the issued TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products' issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptors for the 128-byte swizzled boxes TMA
// writes: 128-byte rows, 8-row groups 1024 bytes apart (SBO), swizzle mode
// 1.  K-major (the K axis runs along a row, as Q and K in Q K^T): a k-step
// of 16 columns is the start address plus 32 bytes, the next box past 64
// columns.  MN-major (the K axis runs down the rows, as V in P V): a
// k-step of 16 rows is the start plus 2048 bytes, and the second
// 64-column box of a D = 128 tile lies BOX_BYTES on (LBO).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(BOX_BYTES >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

// address of k-step kk (16 columns) of a K-major 64-row tile at `tile`
__device__ __forceinline__ uint32_t kstep(uint32_t tile, int kk) {
  return tile + (kk / 4) * BOX_BYTES + (kk % 4) * 32;
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory
// (descriptors), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (bf16 pairs),
// B from shared memory: K-major (TRANS_B 0) or MN-major (TRANS_B 1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (bf16 pairs),
// B from shared memory: K-major (TRANS_B 0) or MN-major (TRANS_B 1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TRANS_B));
}


template <int N, int TRANS_B = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 128) {
    wgmma_rs_n128<TRANS_B>(d, a, db);
  } else {
    wgmma_rs_n64<TRANS_B>(d, a, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// fragments
//
// A warpgroup's f32 accumulator of a 64 x N product: warp w holds rows
// 16 w .. 16 w + 15; lane (g = lane / 4, t = lane % 4) holds, for each
// 8-column chunk j, d[4 j + e] at row 16 w + g + 8 (e / 2), column
// 8 j + 2 t + e % 2.  The A operand of a 64 x 16 register product has the
// same shape per 16 columns, so columns 16 ks .. 16 ks + 15 of an
// accumulator, rounded to bf16 pairs, are the A operand of k-step ks:
// P and dS go from one product to the next without leaving registers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void a_operand(uint32_t (&a)[4],
                                          const float (&d)[N], int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = pack_bf16(d[8 * ks + 2 * i], d[8 * ks + 2 * i + 1]);
  }
}

// byte offset of element (x, c) of a 64-row tile of 128-byte swizzled
// 64-column boxes: the layout TMA writes and reads
__device__ __forceinline__ int swizzled(int x, int c) {
  return (c / BOX) * BOX_BYTES + x * 128 +
         ((((c % BOX) / 8) ^ (x % 8)) * 16) + (c % 8) * 2;
}

// rows r and r + 8 of a warpgroup's 64-row tile of D columns as the A
// operands of its D / 16 k-steps, read from the 128-byte swizzled boxes
// TMA wrote (16-byte chunk c of row x lies at chunk c ^ (x % 8))
template <int D>
__device__ __forceinline__ void load_a_tile(uint32_t (&a)[D / 16][4],
                                            const unsigned char* tile, int r,
                                            int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[kk][i] = *reinterpret_cast<const uint32_t*>(
          tile + swizzled(r + 8 * (i & 1), 16 * kk + 8 * (i >> 1) + 2 * t));
    }
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

// rows g and g + 8 of a warp's 16 x D accumulator, divided by den0 and
// den1, to bf16 rows of stride rs
template <int D>
__device__ __forceinline__ void store_rows(bf16* row0, size_t rs,
                                           const float (&d)[D / 2],
                                           float den0, float den1) {
  bf16* row1 = row0 + 8 * rs;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(row0 + 8 * n) =
        pack_bf16(d[4 * n] / den0, d[4 * n + 1] / den0);
    *reinterpret_cast<uint32_t*>(row1 + 8 * n) =
        pack_bf16(d[4 * n + 2] / den1, d[4 * n + 3] / den1);
  }
}

// ---------------------------------------------------------------------------
// which tile pairs are visited, and which of those need a mask
// ---------------------------------------------------------------------------

// segment-id ranges (min, max) of a query and a key tile overlap (the
// `_seg_live` predicate); under causal the key tile must not lie wholly
// above the diagonal
__device__ __forceinline__ bool pair_live(int2 qr, int2 kr, int qt, int kt,
                                          int causal) {
  return qr.y >= kr.x && qr.x <= kr.y && (!causal || kt <= qt);
}

// every pair of the tiles is live: one segment on both sides and, under
// causal, the key tile wholly below the diagonal
__device__ __forceinline__ bool pair_interior(int2 qr, int2 kr, int qt,
                                              int kt, int causal) {
  return qr.x == qr.y && kr.x == kr.y && qr.x == kr.x &&
         (!causal || kt < qt);
}

// A block walks the tiles of the other axis 32 at a time: lane l of a
// warp classifies tile base + l from one coalesced load of the ranges,
// and ballots give every warp the same three masks; the walk then visits
// the set bits only.  (Walking tile by tile, a dependent load a tile, cost
// ~16 us a block skipping the dead tiles before a late segment.)  Bit j:
// some warpgroup of the block visits tile base + j (`needed`), this
// warpgroup does (`mine`), and this warpgroup's pair is interior.
struct TileMasks {
  unsigned needed, mine, interior;
};

// `own` (w0, w1): this block's two tiles on the walking side's other axis,
// the second absent when nact == 1; `pos0` the first one's index; `other`
// the walked tiles' ranges.  Query tiles own, key tiles walked (forward)
// or the reverse (dK/dV, with `keys_own`).
__device__ __forceinline__ TileMasks walk_masks(int2 own0, int2 own1,
                                                int pos0, int nact, int wg,
                                                const int2* other, int base,
                                                int end, int keys_own,
                                                int causal) {
  const int j = base + static_cast<int>(threadIdx.x % 32);
  bool needed = false, mine = false, interior = false;
  if (j < end) {
    const int2 x = __ldg(other + j);
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) {
      if (w < nact) {
        const int2 own = w == 0 ? own0 : own1;
        const int qt = keys_own ? j : pos0 + w, kt = keys_own ? pos0 + w : j;
        const int2 qr = keys_own ? x : own, kr = keys_own ? own : x;
        const bool live = pair_live(qr, kr, qt, kt, causal);
        needed |= live;
        if (w == wg) {
          mine = live;
          interior = live && pair_interior(qr, kr, qt, kt, causal);
        }
      }
    }
  }
  return {__ballot_sync(0xffffffffu, needed), __ballot_sync(0xffffffffu, mine),
          __ballot_sync(0xffffffffu, interior)};
}

// The producer warp of the forward and dQ: walks the key tiles either of
// the block's query tiles visits, 32 at a time, and keeps STAGES K/V tile
// pairs in flight; stage s holds K at kv0 + 2 TB s and V TB after it.
// Every lane walks (the ballot needs the warp), one `leader` copies.
template <int D, int STAGES>
__device__ __forceinline__ void kv_ring_producer(
    bool leader, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    uint32_t kv0, uint32_t full0, uint32_t empty0, int2 qr0, int2 qr1,
    const int2* kr, int qt0, int nact, int kt_end, int h, int k_row,
    int causal) {
  constexpr int TB = tile_bytes<D>();
  int stage = 0;
  uint32_t phase = 0;
  for (int base = 0; base < kt_end; base += 32) {
    const unsigned needed = walk_masks(qr0, qr1, qt0, nact, 0, kr, base,
                                       kt_end, 0, causal).needed;
    for (unsigned bits = leader ? needed : 0; bits != 0; bits &= bits - 1) {
      const int kt = base + __ffs(bits) - 1;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t full = full0 + 8 * stage, k_tile = kv0 + 2 * TB * stage;
      mbar_expect_tx(full, 2 * TB);
      for (int c = 0; c < D / BOX; ++c) {
        tma_box(k_tile + c * BOX_BYTES, tm_k, c * BOX, h, k_row + kt * TILE,
                full);
        tma_box(k_tile + TB + c * BOX_BYTES, tm_v, c * BOX, h,
                k_row + kt * TILE, full);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The forward and dQ consumers hold their last tile's stage: its product,
// acc += round(A) B with the tile's B (V, or K in dQ) read MN-major at
// b_tile, is issued behind the next own tile's products.  This issues it
// alone, waits for it and releases the stage.  Besides the end of the
// walk, it is needed where the ring is about to refill the held stage
// (the tiles since were the other warpgroup's): the producer waits for
// the stage to be released and the consumer for it to be refilled.
template <int D>
__device__ __forceinline__ void finish_held(float (&acc)[D / 2],
                                            uint32_t (&a)[4][4],
                                            uint32_t b_tile, uint32_t empty) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_rs<D>(acc, a[ks], desc_mn(b_tile + ks * 16 * 128));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(empty);
}

// ---------------------------------------------------------------------------
// forward: one block per (two query tiles, head, batch)
//
// Warps 0-7 are two consumer warpgroups, warpgroup w owning query tile
// 2 blockIdx.x + w; warp 8 is the producer.  Its first thread loads both
// Q tiles, then walks the key tiles either query tile visits and keeps
// FWD_STAGES K/V tile pairs in flight.  Every consumer walks the same key
// tiles: it waits for each, computes it when its own query tile visits it,
// and releases the stage.  A query tile past Sq (Sq an odd number of
// tiles) has no warpgroup: the stages then wait for one consumer only.
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t fwd_smem() {
  // alignment slack, Q tiles, K/V stages, barriers
  return 1024 + static_cast<size_t>(CONSUMERS + 2 * FWD_STAGES) *
                    tile_bytes<D>() +
         8 * (1 + 2 * FWD_STAGES);
}

template <int D>
__device__ __forceinline__ void fwd_consumer(
    int wg, const unsigned char* q_tile, uint32_t kv0, uint32_t q_full,
    uint32_t full0, uint32_t empty0, int2 qr0, int2 qr1, const int2* kr,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    bf16* __restrict__ o, float* __restrict__ lse, int qt0, int nact,
    int kt_end, int b, int h, int Sq, int Sk, int H, int causal,
    float scale) {
  constexpr int TB = tile_bytes<D>();
  const int tid = threadIdx.x % WG, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = 16 * (tid / 32) + g;     // this thread's rows r and r + 8
  const int qt = qt0 + wg;
  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TILE;
  const int qsg0 = qseg[q0 + r], qsg1 = qseg[q0 + r + 8];
  const float sl2 = scale * LOG2E;       // scores in log2 units

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // Q stays in registers as the A operand of every S product, so those
  // read only K from shared memory
  mbar_wait(q_full, 0);
  uint32_t qa[D / 16][4];
  load_a_tile<D>(qa, q_tile, r, t);

  // round(P) of the last tile computed, and its stage: its PV product is
  // issued behind the next tile's S product and runs under that tile's
  // softmax; the stage is released once the product has completed
  uint32_t p[4][4];
  int held = -1;
  int stage = 0;
  uint32_t phase = 0;
  for (int base = 0; base < kt_end; base += 32) {
    const TileMasks masks = walk_masks(qr0, qr1, qt0, nact, wg, kr, base,
                                       kt_end, 0, causal);
    for (unsigned bits = masks.needed; bits != 0; bits &= bits - 1) {
      const int j = __ffs(bits) - 1, kt = base + j;
      if (held == stage) {
        finish_held<D>(acc, p, kv0 + 2 * TB * held + TB, empty0 + 8 * held);
        held = -1;
      }
      mbar_wait(full0 + 8 * stage, phase);
      if (!((masks.mine >> j) & 1)) {
        mbar_arrive(empty0 + 8 * stage);   // the other warpgroup's tile
      } else {
        // S = Q K^T over D, 16 columns a product, then the held PV
        const uint32_t k_tile = kv0 + 2 * TB * stage;
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_rs<64, 0>(s, qa[kk], desc_k(kstep(k_tile, kk)));
        }
        wgmma_commit();
        if (held >= 0) {
          const uint32_t v_tile = kv0 + 2 * TB * held + TB;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_rs<D>(acc, p[ks], desc_mn(v_tile + ks * 16 * 128));
          }
          wgmma_commit();
          wgmma_wait<1>();   // S is done; the PV product may still run
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s);

        if ((masks.interior >> j) & 1) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] *= sl2;
        } else {
          const int* ks = kseg + static_cast<size_t>(b) * Sk + kt * TILE;
          const int dq = (qt - kt) * TILE;   // query index - key index
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = 8 * n + 2 * t;
            const int2 kg = make_int2(ks[c], ks[c + 1]);
            const bool c0 = !causal || dq + r >= c;
            const bool c1 = !causal || dq + r >= c + 1;
            const bool c2 = !causal || dq + r + 8 >= c;
            const bool c3 = !causal || dq + r + 8 >= c + 1;
            s[4 * n] = (qsg0 == kg.x && c0) ? s[4 * n] * sl2 : MASK_VALUE;
            s[4 * n + 1] =
                (qsg0 == kg.y && c1) ? s[4 * n + 1] * sl2 : MASK_VALUE;
            s[4 * n + 2] =
                (qsg1 == kg.x && c2) ? s[4 * n + 2] * sl2 : MASK_VALUE;
            s[4 * n + 3] =
                (qsg1 == kg.y && c3) ? s[4 * n + 3] * sl2 : MASK_VALUE;
          }
        }

        // online softmax over the tile's 64 keys, rows r and r + 8
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          s[4 * n] = exp2f(s[4 * n] - m0);
          s[4 * n + 1] = exp2f(s[4 * n + 1] - m0);
          s[4 * n + 2] = exp2f(s[4 * n + 2] - m1);
          s[4 * n + 3] = exp2f(s[4 * n + 3] - m1);
          sum0 += s[4 * n] + s[4 * n + 1];
          sum1 += s[4 * n + 2] + s[4 * n + 3];
        }
        l0 = a0 * l0 + quad_sum(sum0);
        l1 = a1 * l1 + quad_sum(sum1);

        // the held product has finished: release its stage, rescale O to
        // this tile's maxima, and hold this tile's round(P)
        wgmma_wait<0>();
        fence_regs(acc);
        if (held >= 0) mbar_arrive(empty0 + 8 * held);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= a0;
          acc[4 * n + 1] *= a0;
          acc[4 * n + 2] *= a1;
          acc[4 * n + 3] *= a1;
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) a_operand(p[ks], s, ks);
        held = stage;
      }
      if (++stage == FWD_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  // O += round(P) V for the last tile
  if (held >= 0) finish_held<D>(acc, p, kv0 + 2 * TB * held + TB,
                                empty0 + 8 * held);

  const float den0 = (l0 == 0.f) ? 1.f : l0, den1 = (l1 == 0.f) ? 1.f : l1;
  const size_t rs = static_cast<size_t>(H) * D;
  store_rows<D>(o + (q0 + r) * rs + h * D + 2 * t, rs, acc, den0, den1);
  if (t == 0) {
    // back to natural-log units; a row that matched nothing keeps the
    // mask value itself as its maximum, as the plain version does
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * Sq + qt * TILE;
    lrow[r] = (m0 == MASK_VALUE ? MASK_VALUE : m0 * LN2) + logf(den0);
    lrow[r + 8] = (m1 == MASK_VALUE ? MASK_VALUE : m1 * LN2) + logf(den1);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const int* __restrict__ qrange,
                       const int* __restrict__ krange,
                       const int* __restrict__ qseg,
                       const int* __restrict__ kseg, bf16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Sk, int H,
                       int causal, float scale) {
  constexpr int TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on one
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;                           // CONSUMERS tiles
  const uint32_t kv0 = q_s + CONSUMERS * TB;           // stage s: K, V
  const uint32_t q_full = kv0 + 2 * FWD_STAGES * TB;   // barriers
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * FWD_STAGES;

  const int qt0 = CONSUMERS * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nqt = Sq / TILE, nkt = Sk / TILE;
  const int nact = min(CONSUMERS, nqt - qt0);
  const int2* qr =
      reinterpret_cast<const int2*>(qrange) + static_cast<size_t>(b) * nqt;
  const int2* kr =
      reinterpret_cast<const int2*>(krange) + static_cast<size_t>(b) * nkt;
  const int2 qr0 = __ldg(qr + qt0), qr1 = __ldg(qr + qt0 + nact - 1);
  // causal: no key tile past the last query tile's diagonal is visited
  const int kt_end = causal ? min(nkt, qt0 + nact) : nkt;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, nact * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x >= CONSUMERS * WG + 32) return;   // one producer warp
    const bool leader = threadIdx.x == CONSUMERS * WG;   // issues the copies
    const int q_row = b * Sq + qt0 * TILE, k_row = b * Sk;
    if (leader) {
      mbar_expect_tx(q_full, nact * TB);
      for (int w = 0; w < nact; ++w) {
        for (int c = 0; c < D / BOX; ++c) {
          tma_box(q_s + w * TB + c * BOX_BYTES, &tm_q, c * BOX, h,
                  q_row + w * TILE, q_full);
        }
      }
    }
    kv_ring_producer<D, FWD_STAGES>(leader, &tm_k, &tm_v, kv0, full0, empty0,
                                    qr0, qr1, kr, qt0, nact, kt_end, h,
                                    k_row, causal);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg >= nact) return;
    fwd_consumer<D>(wg, smem_raw + (q_s - raw) + wg * TB, kv0, q_full,
                    full0, empty0, qr0, qr1, kr, qseg, kseg, o, lse, qt0,
                    nact, kt_end, b, h, Sq, Sk, H, causal, scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (two key tiles, head, batch)
//
// Warpgroup w owns key tile 2 blockIdx.x + w, its K and V tiles resident
// in shared memory and its dK and dV in f32 registers; the producer's
// first thread loads K and V once, then walks the query tiles either key
// tile visits and keeps BWD_STAGES (Q, dO, lse, delta) tiles in flight.
// Per query tile: S^T = K Q^T and dP^T = V dO^T (both operands in shared
// memory, K-major), P^T and dS^T in registers, then dV += round(P^T) dO
// and dK += round(dS^T) Q with dO and Q read MN-major.
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t bwd_kv_smem() {
  // alignment slack, K and V tiles, Q/dO stages, lse/delta rows, barriers
  return 1024 +
         static_cast<size_t>(2 * CONSUMERS + 2 * BWD_STAGES) *
             tile_bytes<D>() +
         BWD_STAGES * 2 * TILE * sizeof(float) + 8 * (1 + 2 * BWD_STAGES);
}

template <int D>
__device__ __forceinline__ void bwd_kv_consumer(
    int wg, uint32_t k_tile, uint32_t v_tile, uint32_t qd0,
    const float* rows0, uint32_t kv_full, uint32_t full0, uint32_t empty0,
    const int2* qr, int2 kr0, int2 kr1, const int* __restrict__ qseg,
    const int* __restrict__ kseg, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int kt0, int nact, int qt_begin, int nqt, int b,
    int h, int Sq, int Sk, int H, int causal, float scale) {
  constexpr int TB = tile_bytes<D>();
  const int tid = threadIdx.x % WG, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = 16 * (tid / 32) + g;     // this thread's keys r and r + 8
  const int kt = kt0 + wg;
  const size_t k0 = static_cast<size_t>(b) * Sk + kt * TILE;
  const int ksg0 = kseg[k0 + r], ksg1 = kseg[k0 + r + 8];
  const float sl2 = scale * LOG2E;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int base = qt_begin; base < nqt; base += 32) {
    const TileMasks masks = walk_masks(kr0, kr1, kt0, nact, wg, qr, base,
                                       nqt, 1, causal);
    for (unsigned bits = masks.needed; bits != 0; bits &= bits - 1) {
      const int j = __ffs(bits) - 1, qt = base + j;
      mbar_wait(full0 + 8 * stage, phase);
      if ((masks.mine >> j) & 1) {
        const uint32_t q_tile = qd0 + 2 * TB * stage, do_tile = q_tile + TB;
        const float* lse_s = rows0 + 2 * TILE * stage;
        const float* delta_s = lse_s + TILE;
        const bool interior = (masks.interior >> j) & 1;
        const int* qs = qseg + static_cast<size_t>(b) * Sq + qt * TILE;
        const int dq = (qt - kt) * TILE;   // query index - key index

        // S^T = K Q^T, then dP^T = V dO^T: the first is read while the
        // second runs
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(st, desc_k(kstep(k_tile, kk)), desc_k(kstep(q_tile, kk)),
                   kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(dpt, desc_k(kstep(v_tile, kk)),
                   desc_k(kstep(do_tile, kk)), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P^T = exp(s - lse) on the mask, else 0 (row = key r (+ 8),
        // column = query c of the tile)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = 8 * n + 2 * t;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
          bool live[4] = {true, true, true, true};
          if (!interior) {
            const int2 qg = make_int2(qs[c], qs[c + 1]);
            live[0] = qg.x == ksg0 && (!causal || dq + c >= r);
            live[1] = qg.y == ksg0 && (!causal || dq + c + 1 >= r);
            live[2] = qg.x == ksg1 && (!causal || dq + c >= r + 8);
            live[3] = qg.y == ksg1 && (!causal || dq + c + 1 >= r + 8);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l = (e & 1) ? ls.y : ls.x;
            st[4 * n + e] =
                live[e] ? exp2f(fmaf(st[4 * n + e], sl2, -l * LOG2E)) : 0.f;
          }
        }

        // dV += round(P^T) dO, 16 queries a product, under the dS work
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) a_operand(pa[ks], st, ks);
        fence_regs(dva);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_rs<D>(dva, pa[ks], desc_mn(do_tile + ks * 16 * 128));
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dpt);

        // dS^T = p (dP - delta) scale with p unrounded (0 off the mask)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 dl =
              *reinterpret_cast<const float2*>(delta_s + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dlt = (e & 1) ? dl.y : dl.x;
            dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - dlt) * scale;
          }
        }

        // dK += round(dS^T) Q
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) a_operand(da[ks], dpt, ks);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          wgmma_rs<D>(dka, da[ks], desc_mn(q_tile + ks * 16 * 128));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
      }
      mbar_arrive(empty0 + 8 * stage);
      if (++stage == BWD_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  const size_t rs = static_cast<size_t>(H) * D;
  const size_t at = (k0 + r) * rs + h * D + 2 * t;
  store_rows<D>(dk + at, rs, dka, 1.f, 1.f);
  store_rows<D>(dv + at, rs, dva, 1.f, 1.f);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ qrange,
                          const int* __restrict__ krange,
                          const int* __restrict__ qseg,
                          const int* __restrict__ kseg, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Sq, int Sk, int H,
                          int causal, float scale) {
  constexpr int TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base;                         // CONSUMERS tiles
  const uint32_t v_s = k_s + CONSUMERS * TB;         // CONSUMERS tiles
  const uint32_t qd0 = v_s + CONSUMERS * TB;         // stage s: Q, dO
  const uint32_t rows_s = qd0 + 2 * BWD_STAGES * TB; // stage s: lse, delta
  const float* rows0 =
      reinterpret_cast<const float*>(smem_raw + (rows_s - raw));
  const uint32_t kv_full = rows_s + BWD_STAGES * 2 * TILE * sizeof(float);
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * BWD_STAGES;

  const int kt0 = CONSUMERS * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nqt = Sq / TILE, nkt = Sk / TILE;
  const int nact = min(CONSUMERS, nkt - kt0);
  const int2* qr =
      reinterpret_cast<const int2*>(qrange) + static_cast<size_t>(b) * nqt;
  const int2* kr =
      reinterpret_cast<const int2*>(krange) + static_cast<size_t>(b) * nkt;
  const int2 kr0 = __ldg(kr + kt0), kr1 = __ldg(kr + kt0 + nact - 1);
  // causal: query tiles before the first key tile's diagonal are masked
  // (for Sk > Sq the loop may be empty: those keys get zero gradients)
  const int qt_begin = causal ? kt0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, nact * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x >= CONSUMERS * WG + 32) return;   // one producer warp
    const bool leader = threadIdx.x == CONSUMERS * WG;   // issues the copies
    const int k_row = b * Sk + kt0 * TILE, q_row = b * Sq;
    if (leader) {
      mbar_expect_tx(kv_full, 2 * nact * TB);
      for (int w = 0; w < nact; ++w) {
        for (int c = 0; c < D / BOX; ++c) {
          tma_box(k_s + w * TB + c * BOX_BYTES, &tm_k, c * BOX, h,
                  k_row + w * TILE, kv_full);
          tma_box(v_s + w * TB + c * BOX_BYTES, &tm_v, c * BOX, h,
                  k_row + w * TILE, kv_full);
        }
      }
    }
    const size_t bh = (static_cast<size_t>(b) * H + h) * Sq;
    int stage = 0;
    uint32_t phase = 0;
    for (int base = qt_begin; base < nqt; base += 32) {
      const unsigned needed = walk_masks(kr0, kr1, kt0, nact, 0, qr, base, nqt,
                                         1, causal).needed;
      for (unsigned bits = leader ? needed : 0; bits != 0; bits &= bits - 1) {
        const int qt = base + __ffs(bits) - 1;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        const uint32_t full = full0 + 8 * stage, q_tile = qd0 + 2 * TB * stage;
        const uint32_t rows = rows_s + 2 * TILE * sizeof(float) * stage;
        mbar_expect_tx(full, 2 * TB + 2 * TILE * sizeof(float));
        for (int c = 0; c < D / BOX; ++c) {
          tma_box(q_tile + c * BOX_BYTES, &tm_q, c * BOX, h,
                  q_row + qt * TILE, full);
          tma_box(q_tile + TB + c * BOX_BYTES, &tm_do, c * BOX, h,
                  q_row + qt * TILE, full);
        }
        bulk_copy(rows, lse + bh + qt * TILE, TILE * sizeof(float), full);
        bulk_copy(rows + TILE * sizeof(float), delta + bh + qt * TILE,
                  TILE * sizeof(float), full);
        if (++stage == BWD_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg >= nact) return;
    bwd_kv_consumer<D>(wg, k_s + wg * TB, v_s + wg * TB, qd0, rows0, kv_full,
                       full0, empty0, qr, kr0, kr1, qseg, kseg, dk, dv, kt0,
                       nact, qt_begin, nqt, b, h, Sq, Sk, H, causal, scale);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (two query tiles, head, batch)
//
// The forward's block: warpgroup w owns query tile 2 blockIdx.x + w; the
// producer's first thread loads both Q and dO tiles and their lse and
// delta rows once, then keeps DQ_STAGES K/V tile pairs in flight over the
// key tiles either query tile visits.  Per key tile: S = Q K^T (Q in
// registers) and dP = dO V^T (dO in shared memory), p = exp2(s scale log2 e
// - lse log2 e) on the mask, dS = p (dP - delta) scale rounded into
// A-operand registers, and dQ += round(dS) K, issued behind the next key
// tile's S and dP products; the stage is released once that product has
// completed.  dQ is written once, in bf16, through this warpgroup's Q tile
// (free once Q is in registers) and a TMA store.
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t bwd_dq_smem() {
  // alignment slack, Q and dO tiles, K/V stages, lse/delta rows, barriers
  return 1024 +
         static_cast<size_t>(2 * CONSUMERS + 2 * DQ_STAGES) * tile_bytes<D>() +
         CONSUMERS * 2 * TILE * sizeof(float) + 8 * (1 + 2 * DQ_STAGES);
}

template <int D>
__device__ __forceinline__ void bwd_dq_consumer(
    int wg, unsigned char* q_tile, uint32_t do_tile, const float* rows,
    uint32_t kv0, uint32_t q_full, uint32_t full0, uint32_t empty0,
    int2 qr0, int2 qr1, const int2* kr, const int* __restrict__ qseg,
    const int* __restrict__ kseg, const CUtensorMap* tm_dq, int qt0,
    int nact, int kt_end, int b, int h, int Sq, int Sk, int causal,
    float scale) {
  constexpr int TB = tile_bytes<D>();
  const int tid = threadIdx.x % WG, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r = 16 * (tid / 32) + g;     // this thread's rows r and r + 8
  const int qt = qt0 + wg;
  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TILE;
  const int qsg0 = qseg[q0 + r], qsg1 = qseg[q0 + r + 8];
  const float sl2 = scale * LOG2E;

  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

  mbar_wait(q_full, 0);
  uint32_t qa[D / 16][4];
  load_a_tile<D>(qa, q_tile, r, t);
  // lse and delta of this thread's two rows, fixed for the whole loop
  const float nl0 = -rows[r] * LOG2E, nl1 = -rows[r + 8] * LOG2E;
  const float dl0 = rows[TILE + r], dl1 = rows[TILE + r + 8];

  // round(dS) of the last tile computed, and its stage: its dQ product is
  // issued behind the next tile's S and dP products
  uint32_t ds[4][4];
  int held = -1;
  int stage = 0;
  uint32_t phase = 0;
  for (int base = 0; base < kt_end; base += 32) {
    const TileMasks masks = walk_masks(qr0, qr1, qt0, nact, wg, kr, base,
                                       kt_end, 0, causal);
    for (unsigned bits = masks.needed; bits != 0; bits &= bits - 1) {
      const int j = __ffs(bits) - 1, kt = base + j;
      if (held == stage) {
        finish_held<D>(dqa, ds, kv0 + 2 * TB * held, empty0 + 8 * held);
        held = -1;
      }
      mbar_wait(full0 + 8 * stage, phase);
      if (!((masks.mine >> j) & 1)) {
        mbar_arrive(empty0 + 8 * stage);   // the other warpgroup's tile
      } else {
        const uint32_t k_tile = kv0 + 2 * TB * stage, v_tile = k_tile + TB;
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_rs<64, 0>(s, qa[kk], desc_k(kstep(k_tile, kk)));
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(dp, desc_k(kstep(do_tile, kk)), desc_k(kstep(v_tile, kk)),
                   kk > 0);
        }
        wgmma_commit();
        if (held >= 0) {
          const uint32_t kh = kv0 + 2 * TB * held;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            wgmma_rs<D>(dqa, ds[ks], desc_mn(kh + ks * 16 * 128));
          }
          wgmma_commit();
          wgmma_wait<1>();   // S and dP are done; dQ may still run
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s);
        fence_regs(dp);

        // p = exp(s - lse) on the mask, else 0, in log2 units
        if ((masks.interior >> j) & 1) {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            s[4 * n] = exp2f(fmaf(s[4 * n], sl2, nl0));
            s[4 * n + 1] = exp2f(fmaf(s[4 * n + 1], sl2, nl0));
            s[4 * n + 2] = exp2f(fmaf(s[4 * n + 2], sl2, nl1));
            s[4 * n + 3] = exp2f(fmaf(s[4 * n + 3], sl2, nl1));
          }
        } else {
          const int* ks = kseg + static_cast<size_t>(b) * Sk + kt * TILE;
          const int dqi = (qt - kt) * TILE;   // query index - key index
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = 8 * n + 2 * t;
            const int2 kg = make_int2(ks[c], ks[c + 1]);
            const bool c0 = qsg0 == kg.x && (!causal || dqi + r >= c);
            const bool c1 = qsg0 == kg.y && (!causal || dqi + r >= c + 1);
            const bool c2 = qsg1 == kg.x && (!causal || dqi + r + 8 >= c);
            const bool c3 = qsg1 == kg.y && (!causal || dqi + r + 8 >= c + 1);
            s[4 * n] = c0 ? exp2f(fmaf(s[4 * n], sl2, nl0)) : 0.f;
            s[4 * n + 1] = c1 ? exp2f(fmaf(s[4 * n + 1], sl2, nl0)) : 0.f;
            s[4 * n + 2] = c2 ? exp2f(fmaf(s[4 * n + 2], sl2, nl1)) : 0.f;
            s[4 * n + 3] = c3 ? exp2f(fmaf(s[4 * n + 3], sl2, nl1)) : 0.f;
          }
        }
        // dS = p (dP - delta) scale with p unrounded (0 off the mask)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          dp[4 * n] = s[4 * n] * (dp[4 * n] - dl0) * scale;
          dp[4 * n + 1] = s[4 * n + 1] * (dp[4 * n + 1] - dl0) * scale;
          dp[4 * n + 2] = s[4 * n + 2] * (dp[4 * n + 2] - dl1) * scale;
          dp[4 * n + 3] = s[4 * n + 3] * (dp[4 * n + 3] - dl1) * scale;
        }

        // the held product has finished: release its stage and hold this
        // tile's round(dS)
        wgmma_wait<0>();
        fence_regs(dqa);
        if (held >= 0) mbar_arrive(empty0 + 8 * held);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) a_operand(ds[ks], dp, ks);
        held = stage;
      }
      if (++stage == DQ_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  // dQ += round(dS) K for the last tile
  if (held >= 0) finish_held<D>(dqa, ds, kv0 + 2 * TB * held,
                                empty0 + 8 * held);

  // dQ in bf16 into the Q tile, swizzled as TMA reads it, then one thread
  // of the warpgroup stores the tile
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(q_tile + swizzled(r, c)) =
        pack_bf16(dqa[4 * n], dqa[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(q_tile + swizzled(r + 8, c)) =
        pack_bf16(dqa[4 * n + 2], dqa[4 * n + 3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
  if (tid == 0) {
    const uint32_t src = smem_u32(q_tile);
    for (int c = 0; c < D / BOX; ++c) {
      tma_store_box(tm_dq, src + c * BOX_BYTES, c * BOX, h,
                    static_cast<int>(q0));
    }
    tma_store_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ qrange,
                          const int* __restrict__ krange,
                          const int* __restrict__ qseg,
                          const int* __restrict__ kseg, int Sq, int Sk,
                          int H, int causal, float scale) {
  constexpr int TB = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;                           // CONSUMERS tiles
  const uint32_t do_s = q_s + CONSUMERS * TB;          // CONSUMERS tiles
  const uint32_t kv0 = do_s + CONSUMERS * TB;          // stage s: K, V
  const uint32_t rows_s = kv0 + 2 * DQ_STAGES * TB;    // tile w: lse, delta
  const uint32_t q_full = rows_s + CONSUMERS * 2 * TILE * sizeof(float);
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * DQ_STAGES;

  const int qt0 = CONSUMERS * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nqt = Sq / TILE, nkt = Sk / TILE;
  const int nact = min(CONSUMERS, nqt - qt0);
  const int2* qr =
      reinterpret_cast<const int2*>(qrange) + static_cast<size_t>(b) * nqt;
  const int2* kr =
      reinterpret_cast<const int2*>(krange) + static_cast<size_t>(b) * nkt;
  const int2 qr0 = __ldg(qr + qt0), qr1 = __ldg(qr + qt0 + nact - 1);
  // causal: no key tile past the last query tile's diagonal is visited
  const int kt_end = causal ? min(nkt, qt0 + nact) : nkt;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, nact * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x >= CONSUMERS * WG + 32) return;   // one producer warp
    const bool leader = threadIdx.x == CONSUMERS * WG;   // issues the copies
    const int q_row = b * Sq + qt0 * TILE, k_row = b * Sk;
    if (leader) {
      const size_t bh = (static_cast<size_t>(b) * H + h) * Sq + qt0 * TILE;
      mbar_expect_tx(q_full, nact * (2 * TB + 2 * TILE * sizeof(float)));
      for (int w = 0; w < nact; ++w) {
        for (int c = 0; c < D / BOX; ++c) {
          tma_box(q_s + w * TB + c * BOX_BYTES, &tm_q, c * BOX, h,
                  q_row + w * TILE, q_full);
          tma_box(do_s + w * TB + c * BOX_BYTES, &tm_do, c * BOX, h,
                  q_row + w * TILE, q_full);
        }
        const uint32_t rows = rows_s + w * 2 * TILE * sizeof(float);
        bulk_copy(rows, lse + bh + w * TILE, TILE * sizeof(float), q_full);
        bulk_copy(rows + TILE * sizeof(float), delta + bh + w * TILE,
                  TILE * sizeof(float), q_full);
      }
    }
    kv_ring_producer<D, DQ_STAGES>(leader, &tm_k, &tm_v, kv0, full0, empty0,
                                   qr0, qr1, kr, qt0, nact, kt_end, h, k_row,
                                   causal);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg >= nact) return;
    const float* rows = reinterpret_cast<const float*>(
        smem_raw + (rows_s - raw) + wg * 2 * TILE * sizeof(float));
    bwd_dq_consumer<D>(wg, smem_raw + (q_s - raw) + wg * TB, do_s + wg * TB,
                       rows, kv0, q_full, full0, empty0, qr0, qr1, kr, qseg,
                       kseg, &tm_dq, qt0, nact, kt_end, b, h, Sq, Sk, causal,
                       scale);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t tensor_map_encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// a [B, S, H, D] bf16 tensor as a 3-D map (D, H, B S): a box is 64 rows of
// one head by 64 columns (128 bytes, swizzled); one head's rows lie H D 2
// bytes apart
cudaError_t row_map(CUtensorMap* map, const void* base, int rows, int H,
                    int D) {
  EncodeTiled encode;
  const cudaError_t e = tensor_map_encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2};
  const cuuint32_t box[3] = {BOX, 1, TILE};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta, *qrange, *krange, *qseg,
      *kseg;
  void *o, *lse, *dq, *dk, *dv;
  int B, Sq, Sk, H, causal;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t run_fwd(const Args& a) {
  CUtensorMap tq, tk, tv;
  cudaError_t e = row_map(&tq, a.q, a.B * a.Sq, a.H, D);
  if (e == cudaSuccess) e = row_map(&tk, a.k, a.B * a.Sk, a.H, D);
  if (e == cudaSuccess) e = row_map(&tv, a.v, a.B * a.Sk, a.H, D);
  if (e != cudaSuccess) return e;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  static bool attr_set = false;   // once per instantiation
  if (!attr_set) {
    e = allow_smem(kernel, fwd_smem<D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.Sq / TILE + CONSUMERS - 1) / CONSUMERS, a.H, a.B);
  kernel<<<grid, THREADS, fwd_smem<D>(), a.stream>>>(
      tq, tk, tv, static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<bf16*>(a.o),
      static_cast<float*>(a.lse), a.Sq, a.Sk, a.H, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bwd_kv(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e = row_map(&tq, a.q, a.B * a.Sq, a.H, D);
  if (e == cudaSuccess) e = row_map(&tk, a.k, a.B * a.Sk, a.H, D);
  if (e == cudaSuccess) e = row_map(&tv, a.v, a.B * a.Sk, a.H, D);
  if (e == cudaSuccess) e = row_map(&tdo, a.dout, a.B * a.Sq, a.H, D);
  if (e != cudaSuccess) return e;
  auto kernel = flash_bwd_kv_wgmma_kernel<D>;
  static bool attr_set = false;
  if (!attr_set) {
    e = allow_smem(kernel, bwd_kv_smem<D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.Sk / TILE + CONSUMERS - 1) / CONSUMERS, a.H, a.B);
  kernel<<<grid, THREADS, bwd_kv_smem<D>(), a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_bwd_dq(const Args& a) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t e = row_map(&tq, a.q, a.B * a.Sq, a.H, D);
  if (e == cudaSuccess) e = row_map(&tk, a.k, a.B * a.Sk, a.H, D);
  if (e == cudaSuccess) e = row_map(&tv, a.v, a.B * a.Sk, a.H, D);
  if (e == cudaSuccess) e = row_map(&tdo, a.dout, a.B * a.Sq, a.H, D);
  if (e == cudaSuccess) e = row_map(&tdq, a.dq, a.B * a.Sq, a.H, D);
  if (e != cudaSuccess) return e;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  static bool attr_set = false;
  if (!attr_set) {
    e = allow_smem(kernel, bwd_dq_smem<D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.Sq / TILE + CONSUMERS - 1) / CONSUMERS, a.H, a.B);
  kernel<<<grid, THREADS, bwd_dq_smem<D>(), a.stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), a.Sq, a.Sk, a.H, a.causal, a.scale);
  return cudaGetLastError();
}

// bf16 (dtype 1) with P rounded (pv_f32 off), head_dim 64 or 128, sequence
// lengths whole 64-row tiles; anything else is flash_attention.cu's
cudaError_t check(int D, int dtype, int pv_f32, const Args& a) {
  if (dtype != 1 || pv_f32 || (D != 64 && D != 128) || a.B <= 0 ||
      a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Sq % TILE != 0 ||
      a.Sk % TILE != 0 || a.H > 65535 || a.B > 65535) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// the signatures of flash_attention.cu's entries of the same names
int flash_fwd(const void* q, const void* k, const void* v,
              const void* qrange, const void* krange, const void* qseg,
              const void* kseg, void* o, void* lse, int B, int Sq, int Sk,
              int H, int D, int dtype, int causal, int pv_f32, float scale,
              void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.qrange = qrange; a.krange = krange;
  a.qseg = qseg; a.kseg = kseg; a.o = o; a.lse = lse;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t e = check(D, dtype, pv_f32, a);
  if (e == cudaSuccess) e = D == 128 ? run_fwd<128>(a) : run_fwd<64>(a);
  return static_cast<int>(e);
}

int flash_bwd_kv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* qrange, const void* krange, const void* qseg,
                 const void* kseg, void* dk, void* dv, int B, int Sq, int Sk,
                 int H, int D, int dtype, int causal, int pv_f32,
                 float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse;
  a.delta = delta; a.qrange = qrange; a.krange = krange; a.qseg = qseg;
  a.kseg = kseg; a.dk = dk; a.dv = dv;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t e = check(D, dtype, pv_f32, a);
  if (e == cudaSuccess) {
    e = D == 128 ? run_bwd_kv<128>(a) : run_bwd_kv<64>(a);
  }
  return static_cast<int>(e);
}

int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* qrange, const void* krange, const void* qseg,
                 const void* kseg, void* dq, int B, int Sq, int Sk, int H,
                 int D, int dtype, int causal, int pv_f32, float scale,
                 void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse;
  a.delta = delta; a.qrange = qrange; a.krange = krange; a.qseg = qseg;
  a.kseg = kseg; a.dq = dq;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t e = check(D, dtype, pv_f32, a);
  if (e == cudaSuccess) {
    e = D == 128 ? run_bwd_dq<128>(a) : run_bwd_dq<64>(a);
  }
  return static_cast<int>(e);
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
