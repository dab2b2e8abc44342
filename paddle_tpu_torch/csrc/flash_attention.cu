// Flash attention for Hopper (sm_90a) on the CUDA cores: forward, dK/dV and
// dQ over packed sequences with segment ids and causal masking, for f32
// inputs and for bf16 with attn_pv_f32.  bf16 with P and dS rounded (the
// training path) is flash_attention_sm90.cu's: wgmma kernels fed by TMA.
//
// Replaces the three Pallas TPU kernels of paddle_tpu/ops/attention.py:
//   flash_fwd    <- _flash_fwd_kernel    (:142, pallas_call :249)
//   flash_bwd_kv <- _flash_bwd_kv_kernel (:289, pallas_call :448)
//   flash_bwd_dq <- _flash_bwd_dq_kernel (:353, pallas_call :488)
// and computes what they compute, read from the Pallas bodies:
//   - q [B, Sq, H, D], k/v [B, Sk, H, D] in f32 or bf16 (one type for all);
//     segment ids [B, S] int32; lse and delta [B, H, Sq] f32;
//   - mask: q_seg == k_seg, and under causal q_index >= k_index on absolute
//     positions in the packed buffer; inside a visited tile a masked score
//     is DEFAULT_MASK_VALUE (finite), so a row that matches nothing in the
//     tiles visited averages their V, as the TPU kernel does;
//   - a tile pair is skipped when its segment-id ranges are disjoint (the
//     `_seg_live` predicate, from per-tile min/max the wrapper computes) or
//     when it lies wholly above the causal diagonal; every kernel, here
//     and in flash_attention_sm90.cu, uses the same predicate at 64-row
//     tiles, so lse is never read for a pair the forward skipped;
//   - forward: online softmax with (m, l, acc) in f32 registers, the scale
//     applied to the f32 product, P rounded to the input type before the PV
//     product unless pv_f32 (`_pv_operands`), l == 0 -> 1, O cast to q's
//     type, lse = m + log l;
//   - dK/dV: p = exp(s - lse) on the mask (else 0), dV += round(p)^T dO,
//     dP = dO V^T, dS = p (dP - delta) scale with p unrounded,
//     dK += round(dS)^T Q; dQ: dQ += round(dS) K. Results cast to the
//     input type.
//
// What bounds it on the H100: f32 inputs run in f32 FMA (TF32 would break
// the f32 contract), so the cores' 67 TFLOP/s bound all three kernels at
// the training shapes; bf16 with pv_f32 keeps P and dS in f32, so its
// products are f32 FMA too.
//
// Design: the TPU streams the key (or query) axis through a sequential
// grid dimension and carries state in VMEM scratch; Hopper's blocks run in
// parallel and in no order, so one block owns one 64-row tile (queries for
// forward and dQ, keys for dK/dV) and loops over the other axis itself,
// carrying its sums in registers; every kernel skips the same tile pairs.
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns score rows
// ty + 16 i and columns tx + 16 j (i, j < 4), and output rows ty + 16 i by
// columns 4 tx + 64 g .. + 3, so the rows of the softmax state never leave
// their half-warp; P and dS go through shared memory; rows are padded by 4
// elements.  Above 48 KB, dynamic shared memory is enabled with
// cudaFuncSetAttribute.  No pipelining of the tile loads in this file
// (flash_attention_sm90.cu has the TMA ring).
//
// Plain C interface (built by paddle_tpu_torch/kernels/build.py with nvcc,
// loaded with ctypes): each entry returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;          // rows of a query tile and of a key tile
constexpr int NTHREADS = 256;     // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int PAD = 4;            // shared-memory row padding, in elements
constexpr int PS = TILE + 4;      // row stride of the f32 P / dS tiles
constexpr float MASK_VALUE = -0.7f * FLT_MAX;   // DEFAULT_MASK_VALUE

using bf16 = __nv_bfloat16;

template <typename T> struct Raw4;   // 4 elements moved as one word
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<bf16> { using type = uint2; };

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(bf16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// P or dS as the products that take it see it: rounded to the input type
// (bf16) unless pv_f32; f32 inputs leave it as it is
template <typename T>
__device__ __forceinline__ float round_to(float x, int pv_f32) {
  if constexpr (std::is_same<T, bf16>::value) {
    return pv_f32 ? x : __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// one 64-row tile (row stride `rs` elements in global memory) into shared
// memory rows of D + PAD elements
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t rs,
                                          int tid) {
  using R = typename Raw4<T>::type;
  constexpr int CH = D / 4;
  for (int idx = tid; idx < TILE * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    *reinterpret_cast<R*>(dst + r * (D + PAD) + c) =
        *reinterpret_cast<const R*>(src + r * rs + c);
  }
}

// c[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over shared tiles
template <typename T, int D>
__device__ __forceinline__ void tile_dot_nt(const T* A, const T* B, int ty,
                                            int tx, float c[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ty + 16 * i) * (D + PAD) + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(B + (tx + 16 * j) * (D + PAD) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
    }
  }
}

// acc[i][4 g + e] += sum_k P[ty + 16 i][k] * X[k][64 g + 4 tx + e]:
// P a f32 tile (row stride PS), X a shared tile of the input type
template <typename T, int D>
__device__ __forceinline__ void tile_acc_nn(const float* P, const T* X,
                                            int ty, int tx,
                                            float acc[4][D / 16]) {
  constexpr int NG = D / 64;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * PS + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 x = ld4(X + (k + kk) * (D + PAD) + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = comp(p[i], kk);
          acc[i][4 * g + 0] = fmaf(pk, x.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pk, x.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pk, x.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pk, x.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// write rows ty + 16 i of a 64 x D accumulator tile, divided by den[i]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, size_t rs, int ty, int tx,
                                           float acc[4][D / 16],
                                           const float den[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dst + (ty + 16 * i) * rs;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      st4(row + 64 * g + 4 * tx,
          make_float4(acc[i][4 * g] / den[i], acc[i][4 * g + 1] / den[i],
                      acc[i][4 * g + 2] / den[i],
                      acc[i][4 * g + 3] / den[i]));
    }
  }
}

__device__ __forceinline__ bool tiles_live(const int* qr, const int* kr) {
  // segment-id ranges [min, max] overlap (the `_seg_live` predicate)
  return qr[1] >= kr[0] && qr[0] <= kr[1];
}

template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return static_cast<size_t>(TILE) * (D + PAD) * sizeof(T);
}

__host__ __device__ constexpr size_t ptile_bytes() {
  return static_cast<size_t>(TILE) * PS * sizeof(float);
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, head, batch)
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem() {
  return 3 * tile_bytes<T, D>() + ptile_bytes() + 2 * TILE * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qrange,
                 const int* __restrict__ krange,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int H, int causal, int pv_f32, float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = Sq / TILE, nkt = Sk / TILE;
  const size_t rs = static_cast<size_t>(H) * D;

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + tile_bytes<T, D>());
  T* v_s = reinterpret_cast<T*>(smem + 2 * tile_bytes<T, D>());
  float* p_s = reinterpret_cast<float*>(smem + 3 * tile_bytes<T, D>());
  int* qseg_s = reinterpret_cast<int*>(smem + 3 * tile_bytes<T, D>() +
                                       ptile_bytes());
  int* kseg_s = qseg_s + TILE;

  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TILE;
  load_tile<T, D>(q_s, q + q0 * rs + h * D, rs, tid);
  if (tid < TILE) qseg_s[tid] = qseg[q0 + tid];
  const int* qr = qrange + (static_cast<size_t>(b) * nqt + qt) * 2;

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles past this query tile's last row are wholly masked
  const int kt_end = causal ? min(nkt, qt + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (!tiles_live(qr, krange + (static_cast<size_t>(b) * nkt + kt) * 2)) {
      continue;   // the same for every thread of the block
    }
    __syncthreads();   // the previous tile's readers are done
    const size_t k0 = static_cast<size_t>(b) * Sk + kt * TILE;
    load_tile<T, D>(k_s, k + k0 * rs + h * D, rs, tid);
    load_tile<T, D>(v_s, v + k0 * rs + h * D, rs, tid);
    if (tid < TILE) kseg_s[tid] = kseg[k0 + tid];
    __syncthreads();

    float s[4][4];
    tile_dot_nt<T, D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = qt * TILE + r;
      const int qsg = qseg_s[r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool live =
            qsg == kseg_s[c] && (!causal || qi >= kt * TILE + c);
        s[i][j] = live ? s[i][j] * scale : MASK_VALUE;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[r * PS + tx + 16 * j] = round_to<T>(p, pv_f32);
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // the P tile is complete
    tile_acc_nn<T, D>(p_s, v_s, ty, tx, acc);
  }

  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) den[i] = (l[i] == 0.f) ? 1.f : l[i];
  store_rows<T, D>(o + q0 * rs + h * D, rs, ty, tx, acc, den);
  if (tx == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * Sq + qt * TILE;
#pragma unroll
    for (int i = 0; i < 4; ++i) lrow[ty + 16 * i] = m[i] + logf(den[i]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (key tile, head, batch), looping over query tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t bwd_kv_smem() {
  return 4 * tile_bytes<T, D>() + 2 * ptile_bytes() +
         2 * TILE * sizeof(int) + 2 * TILE * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qrange,
                    const int* __restrict__ krange,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Sk, int H, int causal,
                    int pv_f32, float scale) {
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = Sq / TILE, nkt = Sk / TILE;
  const size_t rs = static_cast<size_t>(H) * D;
  constexpr size_t TB = tile_bytes<T, D>();

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + TB);
  T* q_s = reinterpret_cast<T*>(smem + 2 * TB);
  T* do_s = reinterpret_cast<T*>(smem + 3 * TB);
  float* p_s = reinterpret_cast<float*>(smem + 4 * TB);
  float* ds_s = p_s + TILE * PS;
  int* qseg_s = reinterpret_cast<int*>(ds_s + TILE * PS);
  int* kseg_s = qseg_s + TILE;
  float* lse_s = reinterpret_cast<float*>(kseg_s + TILE);
  float* delta_s = lse_s + TILE;

  const size_t k0 = static_cast<size_t>(b) * Sk + kt * TILE;
  load_tile<T, D>(k_s, k + k0 * rs + h * D, rs, tid);
  load_tile<T, D>(v_s, v + k0 * rs + h * D, rs, tid);
  if (tid < TILE) kseg_s[tid] = kseg[k0 + tid];
  const int* kr = krange + (static_cast<size_t>(b) * nkt + kt) * 2;
  const float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * Sq;
  const float* delta_bh = delta + (static_cast<size_t>(b) * H + h) * Sq;

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dka[i][c] = 0.f;
      dva[i][c] = 0.f;
    }
  }

  // causal: query tiles before this key tile's first row are wholly masked
  // (for Sk > Sq the loop may be empty: those keys get zero gradients)
  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    if (!tiles_live(qrange + (static_cast<size_t>(b) * nqt + qt) * 2, kr)) {
      continue;
    }
    __syncthreads();
    const size_t q0 = static_cast<size_t>(b) * Sq + qt * TILE;
    load_tile<T, D>(q_s, q + q0 * rs + h * D, rs, tid);
    load_tile<T, D>(do_s, dout + q0 * rs + h * D, rs, tid);
    if (tid < TILE) {
      qseg_s[tid] = qseg[q0 + tid];
      lse_s[tid] = lse_bh[qt * TILE + tid];
      delta_s[tid] = delta_bh[qt * TILE + tid];
    }
    __syncthreads();

    // transposed scores: row = key ty + 16 i, column = query tx + 16 j
    float s[4][4], dp[4][4];
    tile_dot_nt<T, D>(k_s, q_s, ty, tx, s);
    tile_dot_nt<T, D>(v_s, do_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int kj = kt * TILE + r;
      const int ksg = kseg_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool live =
            qseg_s[c] == ksg && (!causal || qt * TILE + c >= kj);
        const float p = live ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[c]) * scale;
        p_s[r * PS + c] = round_to<T>(p, pv_f32);
        ds_s[r * PS + c] = round_to<T>(ds, pv_f32);
      }
    }
    __syncthreads();
    tile_acc_nn<T, D>(p_s, do_s, ty, tx, dva);
    tile_acc_nn<T, D>(ds_s, q_s, ty, tx, dka);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dk + k0 * rs + h * D, rs, ty, tx, dka, one);
  store_rows<T, D>(dv + k0 * rs + h * D, rs, ty, tx, dva, one);
}

// ---------------------------------------------------------------------------
// dQ: one block per (query tile, head, batch), looping over key tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t bwd_dq_smem() {
  return 4 * tile_bytes<T, D>() + ptile_bytes() + 2 * TILE * sizeof(int) +
         2 * TILE * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qrange,
                    const int* __restrict__ krange,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dq, int Sq,
                    int Sk, int H, int causal, int pv_f32, float scale) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = Sq / TILE, nkt = Sk / TILE;
  const size_t rs = static_cast<size_t>(H) * D;
  constexpr size_t TB = tile_bytes<T, D>();

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + TB);
  T* k_s = reinterpret_cast<T*>(smem + 2 * TB);
  T* v_s = reinterpret_cast<T*>(smem + 3 * TB);
  float* ds_s = reinterpret_cast<float*>(smem + 4 * TB);
  int* qseg_s = reinterpret_cast<int*>(ds_s + TILE * PS);
  int* kseg_s = qseg_s + TILE;
  float* lse_s = reinterpret_cast<float*>(kseg_s + TILE);
  float* delta_s = lse_s + TILE;

  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TILE;
  load_tile<T, D>(q_s, q + q0 * rs + h * D, rs, tid);
  load_tile<T, D>(do_s, dout + q0 * rs + h * D, rs, tid);
  if (tid < TILE) {
    const size_t bh = (static_cast<size_t>(b) * H + h) * Sq + qt * TILE;
    qseg_s[tid] = qseg[q0 + tid];
    lse_s[tid] = lse[bh + tid];
    delta_s[tid] = delta[bh + tid];
  }
  const int* qr = qrange + (static_cast<size_t>(b) * nqt + qt) * 2;

  float dqa[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[i][c] = 0.f;
  }

  const int kt_end = causal ? min(nkt, qt + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (!tiles_live(qr, krange + (static_cast<size_t>(b) * nkt + kt) * 2)) {
      continue;
    }
    __syncthreads();
    const size_t k0 = static_cast<size_t>(b) * Sk + kt * TILE;
    load_tile<T, D>(k_s, k + k0 * rs + h * D, rs, tid);
    load_tile<T, D>(v_s, v + k0 * rs + h * D, rs, tid);
    if (tid < TILE) kseg_s[tid] = kseg[k0 + tid];
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot_nt<T, D>(q_s, k_s, ty, tx, s);
    tile_dot_nt<T, D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = qt * TILE + r;
      const int qsg = qseg_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool live =
            qsg == kseg_s[c] && (!causal || qi >= kt * TILE + c);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]) * scale;
        ds_s[r * PS + c] = round_to<T>(ds, pv_f32);
      }
    }
    __syncthreads();
    tile_acc_nn<T, D>(ds_s, k_s, ty, tx, dqa);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<T, D>(dq + q0 * rs + h * D, rs, ty, tx, dqa, one);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta, *qrange, *krange, *qseg,
      *kseg;
  void *o, *lse, *dq, *dk, *dv;
  int B, Sq, Sk, H, causal, pv_f32;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t run_fwd(const Args& a) {
  auto kernel = flash_fwd_kernel<T, D>;
  static bool attr_set = false;   // once per instantiation
  if (!attr_set) {
    const cudaError_t e = allow_smem(kernel, fwd_smem<T, D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(a.Sq / TILE, a.H, a.B);
  kernel<<<grid, NTHREADS, fwd_smem<T, D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.Sq, a.Sk, a.H, a.causal, a.pv_f32,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_bwd_kv(const Args& a) {
  auto kernel = flash_bwd_kv_kernel<T, D>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = allow_smem(kernel, bwd_kv_smem<T, D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(a.Sk / TILE, a.H, a.B);
  kernel<<<grid, NTHREADS, bwd_kv_smem<T, D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.causal, a.pv_f32, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_bwd_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = allow_smem(kernel, bwd_dq_smem<T, D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(a.Sq / TILE, a.H, a.B);
  kernel<<<grid, NTHREADS, bwd_dq_smem<T, D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(a.dq), a.Sq, a.Sk,
      a.H, a.causal, a.pv_f32, a.scale);
  return cudaGetLastError();
}

enum Which { FWD = 0, BWD_KV = 1, BWD_DQ = 2 };

template <typename T, int D>
cudaError_t run(Which w, const Args& a) {
  switch (w) {
    case FWD: return run_fwd<T, D>(a);
    case BWD_KV: return run_bwd_kv<T, D>(a);
    case BWD_DQ: return run_bwd_dq<T, D>(a);
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 = f32, 1 = bf16; head_dim 64 or 128; sequence lengths whole
// tiles.  f32, and bf16 with pv_f32, run here on the CUDA cores; bf16 with
// P rounded (pv_f32 off, the default) is flash_attention_sm90.cu's (the
// Python wrappers send it there; here it is refused).
cudaError_t dispatch(Which w, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.Sq % TILE != 0 ||
      a.Sk % TILE != 0 || a.H > 65535 || a.B > 65535 ||
      (dtype == 1 && !a.pv_f32)) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0 && D == 128) return run<float, 128>(w, a);
  if (dtype == 0 && D == 64) return run<float, 64>(w, a);
  if (dtype == 1 && D == 128) return run<bf16, 128>(w, a);
  if (dtype == 1 && D == 64) return run<bf16, 64>(w, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v,
              const void* qrange, const void* krange, const void* qseg,
              const void* kseg, void* o, void* lse, int B, int Sq, int Sk,
              int H, int D, int dtype, int causal, int pv_f32, float scale,
              void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.qrange = qrange; a.krange = krange;
  a.qseg = qseg; a.kseg = kseg; a.o = o; a.lse = lse;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.causal = causal;
  a.pv_f32 = pv_f32; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(FWD, D, dtype, a));
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
  a.pv_f32 = pv_f32; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(BWD_KV, D, dtype, a));
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
  a.pv_f32 = pv_f32; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(BWD_DQ, D, dtype, a));
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
