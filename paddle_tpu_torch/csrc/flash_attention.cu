// Flash attention for Hopper (sm_90a) on the CUDA cores: forward, dK/dV and
// dQ over packed sequences with segment ids and causal masking, for f32
// inputs and for bf16 (P and dS rounded to bf16 before their products, or
// kept in f32 under attn_pv_f32), at every head dim that is a multiple of
// 8 (above 512 on the wide kernels, in chunks of 512 columns) and any
// sequence lengths (the wrapper runs a head dim
// that is not a multiple of 8 on copies of q, k, v widened with zero
// columns to the next one).  bf16 with P and dS rounded at
// head dim 64 or 128 on whole 64-row tiles (the training path) is
// flash_attention_sm90.cu's: wgmma kernels fed by TMA; every other shape
// and type is this file's.
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
//     `_seg_live` predicate, from per-tile min/max the wrapper computes at
//     this file's tile) or when it lies wholly above the causal diagonal.
//     A skipped pair holds no live (query, key) pair at any tile size, so
//     the three kernels of one call (all of this file, at one tile) never
//     need lse where the forward wrote none;
//   - forward: online softmax with (m, l, acc) in f32 registers, the scale
//     applied to the f32 product, P rounded to the input type before the PV
//     product unless pv_f32 (`_pv_operands`), l == 0 -> 1, O cast to q's
//     type, lse = m + log l;
//   - dK/dV: p = exp(s - lse) on the mask (else 0), dV += round(p)^T dO,
//     dP = dO V^T, dS = p (dP - delta) scale with p unrounded,
//     dK += round(dS)^T Q; dQ: dQ += round(dS) K. Results cast to the
//     input type.
//
// What bounds it on the H100: every product is f32 FMA on the CUDA cores
// (TF32 would break the f32 contract; bf16 operands are widened), so the
// cores' 67 TFLOP/s bound all three kernels.
//
// Design: the TPU streams the key (or query) axis through a sequential grid
// dimension and carries state in VMEM scratch; Hopper's blocks run in parallel
// and in no order, so one block owns one tile of TILE rows (queries for
// forward and dQ, keys for dK/dV) and loops over the other axis itself,
// carrying its sums in registers.  Kernels are compiled at the widths DP = 16,
// 32, 64, 128, 256 and 512; the head dim d is an argument, and the kernel at
// DP runs every d with DP / 2 < d <= DP (DP = 16 also d = 8): rows are d
// elements apart in device memory, columns d .. DP of a tile are zero in
// shared memory (d % 8 == 0, so a 4-element word is wholly inside or wholly
// past d, and rows stay 16-byte (f32) or 8-byte (bf16) aligned), zero columns add nothing to
// q.k, and stores stop at column d.  Each kernel is instantiated twice a
// width: FULL (d == DP, the head dim a compile-time constant) and not (d read
// from the arguments).  TILE is 64, 32 at DP 256 and 16 at DP 512, where
// four f32 tiles of 64 (or 32) rows would not fit shared memory: at DP 512
// the dK/dV kernel's four f32 tiles of 16 rows take 132 KB of the 227 KB a
// block may use.
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns score rows
// ty + 16 i and columns tx + 16 j (i, j < TILE / 16), and output rows
// ty + 16 i by D / 16 columns (groups of CW = min(4, D / 16) neighbours,
// column 16 CW g + CW tx + e), so the rows of the softmax state never
// leave their half-warp; P and dS go through shared memory; rows are
// padded by 4 elements.  A last tile shorter than TILE (lengths that are
// not whole tiles) loads zeros past the end; keys past Sk are masked to
// p = 0, queries past Sq are masked in dK/dV and never stored.  Above
// 48 KB, dynamic shared memory is enabled with cudaFuncSetAttribute.  No
// pipelining of the tile loads in this file (flash_attention_sm90.cu has
// the TMA ring).
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

constexpr int NTHREADS = 256;     // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int PAD = 4;            // shared-memory row padding, in elements
constexpr float MASK_VALUE = -0.7f * FLT_MAX;   // DEFAULT_MASK_VALUE

using bf16 = __nv_bfloat16;

// rows of a query tile and of a key tile at head dim D
template <int D>
struct Tile {
  static constexpr int ROWS = D == 512 ? 16 : (D == 256 ? 32 : 64);
  static constexpr int RI = ROWS / 16;          // rows (and columns) a thread
  static constexpr int PS = ROWS + 4;           // f32 P / dS tile stride
  static constexpr int CW = D >= 64 ? 4 : D / 16;   // neighbouring columns
  static constexpr int NG = D / (16 * CW);          // column groups
  static constexpr int NC = NG * CW;                // output columns a thread
};

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// CW neighbouring elements of a shared tile as floats
template <int CW, typename T>
__device__ __forceinline__ void ld_cols(const T* p, float* x) {
  if constexpr (CW == 4) {
    const float4 v = ld4(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < CW; ++e) x[e] = to_f(p[e]);
  }
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

// one tile (row stride `rs` elements in global memory, dh columns) into
// shared memory rows of D + PAD elements; rows at or past n_rows and
// columns at or past dh are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t rs,
                                          int n_rows, int dh, int tid) {
  using R = typename Raw4<T>::type;
  constexpr int CH = D / 4;
  for (int idx = tid; idx < Tile<D>::ROWS * CH; idx += NTHREADS) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    R v{};
    if (r < n_rows && c < dh) {
      v = *reinterpret_cast<const R*>(src + r * rs + c);
    }
    *reinterpret_cast<R*>(dst + r * (D + PAD) + c) = v;
  }
}

// c[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over shared tiles,
// d in order
template <typename T, int D>
__device__ __forceinline__ void tile_dot_nt_add(
    const T* A, const T* B, int ty, int tx,
    float c[Tile<D>::RI][Tile<D>::RI]) {
  constexpr int RI = Tile<D>::RI;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RI], b[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = ld4(A + (ty + 16 * i) * (D + PAD) + d);
#pragma unroll
    for (int j = 0; j < RI; ++j) b[j] = ld4(B + (tx + 16 * j) * (D + PAD) + d);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
    }
  }
}

// c[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over shared tiles
template <typename T, int D>
__device__ __forceinline__ void tile_dot_nt(
    const T* A, const T* B, int ty, int tx,
    float c[Tile<D>::RI][Tile<D>::RI]) {
  constexpr int RI = Tile<D>::RI;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < RI; ++j) c[i][j] = 0.f;
  }
  tile_dot_nt_add<T, D>(A, B, ty, tx, c);
}

// acc[i][CW g + e] += sum_k P[ty + 16 i][k] * X[k][16 CW g + CW tx + e]:
// P a f32 tile (row stride PS), X a shared tile of the input type
template <typename T, int D>
__device__ __forceinline__ void tile_acc_nn(
    const float* P, const T* X, int ty, int tx,
    float acc[Tile<D>::RI][Tile<D>::NC]) {
  using TL = Tile<D>;
#pragma unroll 2
  for (int k = 0; k < TL::ROWS; k += 4) {
    float4 p[TL::RI];
#pragma unroll
    for (int i = 0; i < TL::RI; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * TL::PS + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < TL::NG; ++g) {
        float x[TL::CW];
        ld_cols<TL::CW>(X + (k + kk) * (D + PAD) + 16 * TL::CW * g +
                            TL::CW * tx, x);
#pragma unroll
        for (int i = 0; i < TL::RI; ++i) {
          const float pk = comp(p[i], kk);
#pragma unroll
          for (int e = 0; e < TL::CW; ++e) {
            acc[i][TL::CW * g + e] = fmaf(pk, x[e], acc[i][TL::CW * g + e]);
          }
        }
      }
    }
  }
}

// write rows ty + 16 i (those below n_rows) and columns below dh of a
// tile's accumulator, divided by den[i]
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, size_t rs, int ty, int tx,
                                           int n_rows, int dh,
                                           float acc[Tile<D>::RI][Tile<D>::NC],
                                           const float den[Tile<D>::RI]) {
  using TL = Tile<D>;
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    if (ty + 16 * i >= n_rows) continue;
    T* row = dst + (ty + 16 * i) * rs;
#pragma unroll
    for (int g = 0; g < TL::NG; ++g) {
#pragma unroll
      for (int e = 0; e < TL::CW; ++e) {
        const int col = 16 * TL::CW * g + TL::CW * tx + e;
        if (col < dh) from_f(row + col, acc[i][TL::CW * g + e] / den[i]);
      }
    }
  }
}

__device__ __forceinline__ bool tiles_live(const int* qr, const int* kr) {
  // segment-id ranges [min, max] overlap (the `_seg_live` predicate)
  return qr[1] >= kr[0] && qr[0] <= kr[1];
}

template <typename T, int D>
__host__ __device__ constexpr size_t tile_bytes() {
  return static_cast<size_t>(Tile<D>::ROWS) * (D + PAD) * sizeof(T);
}

template <int D>
__host__ __device__ constexpr size_t ptile_bytes() {
  return static_cast<size_t>(Tile<D>::ROWS) * Tile<D>::PS * sizeof(float);
}

__host__ __device__ constexpr int n_tiles(int s, int rows) {
  return (s + rows - 1) / rows;
}

// ---------------------------------------------------------------------------
// forward: one block per (query tile, head, batch)
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem() {
  return 3 * tile_bytes<T, D>() + ptile_bytes<D>() +
         2 * Tile<D>::ROWS * sizeof(int);
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qrange,
                 const int* __restrict__ krange,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int H, int dh, int causal, int pv_f32, float scale) {
  using TL = Tile<D>;
  constexpr int TR = TL::ROWS, RI = TL::RI;
  if (FULL) dh = D;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = n_tiles(Sq, TR), nkt = n_tiles(Sk, TR);
  const size_t rs = static_cast<size_t>(H) * dh;
  const int q_rows = min(TR, Sq - qt * TR);

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + tile_bytes<T, D>());
  T* v_s = reinterpret_cast<T*>(smem + 2 * tile_bytes<T, D>());
  float* p_s = reinterpret_cast<float*>(smem + 3 * tile_bytes<T, D>());
  int* qseg_s = reinterpret_cast<int*>(smem + 3 * tile_bytes<T, D>() +
                                       ptile_bytes<D>());
  int* kseg_s = qseg_s + TR;

  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TR;
  load_tile<T, D>(q_s, q + q0 * rs + h * dh, rs, q_rows, dh, tid);
  if (tid < TR) qseg_s[tid] = tid < q_rows ? qseg[q0 + tid] : -1;
  const int* qr = qrange + (static_cast<size_t>(b) * nqt + qt) * 2;

  float m[RI], l[RI], acc[RI][TL::NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TL::NC; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles past this query tile's last row are wholly masked
  const int kt_end = causal ? min(nkt, qt + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (!tiles_live(qr, krange + (static_cast<size_t>(b) * nkt + kt) * 2)) {
      continue;   // the same for every thread of the block
    }
    __syncthreads();   // the previous tile's readers are done
    const size_t k0 = static_cast<size_t>(b) * Sk + kt * TR;
    const int k_rows = min(TR, Sk - kt * TR);
    load_tile<T, D>(k_s, k + k0 * rs + h * dh, rs, k_rows, dh, tid);
    load_tile<T, D>(v_s, v + k0 * rs + h * dh, rs, k_rows, dh, tid);
    if (tid < TR) kseg_s[tid] = tid < k_rows ? kseg[k0 + tid] : -1;
    __syncthreads();

    float s[RI][RI];
    tile_dot_nt<T, D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qi = qt * TR + r;
      const int qsg = qseg_s[r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool live =
            qsg == kseg_s[c] && (!causal || qi >= kt * TR + c);
        // keys past Sk take no weight; masked keys the finite mask value
        s[i][j] = c >= k_rows ? -INFINITY
                              : (live ? s[i][j] * scale : MASK_VALUE);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[r * TL::PS + tx + 16 * j] = round_to<T>(p, pv_f32);
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TL::NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // the P tile is complete
    tile_acc_nn<T, D>(p_s, v_s, ty, tx, acc);
  }

  float den[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) den[i] = (l[i] == 0.f) ? 1.f : l[i];
  store_rows<T, D>(o + q0 * rs + h * dh, rs, ty, tx, q_rows, dh, acc, den);
  if (tx == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * Sq + qt * TR;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      if (ty + 16 * i < q_rows) lrow[ty + 16 * i] = m[i] + logf(den[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (key tile, head, batch), looping over query tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t bwd_kv_smem() {
  return 4 * tile_bytes<T, D>() + 2 * ptile_bytes<D>() +
         2 * Tile<D>::ROWS * sizeof(int) + 2 * Tile<D>::ROWS * sizeof(float);
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qrange,
                    const int* __restrict__ krange,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Sk, int H, int dh,
                    int causal, int pv_f32, float scale) {
  using TL = Tile<D>;
  constexpr int TR = TL::ROWS, RI = TL::RI;
  if (FULL) dh = D;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = n_tiles(Sq, TR), nkt = n_tiles(Sk, TR);
  const size_t rs = static_cast<size_t>(H) * dh;
  constexpr size_t TB = tile_bytes<T, D>();
  const int k_rows = min(TR, Sk - kt * TR);

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + TB);
  T* q_s = reinterpret_cast<T*>(smem + 2 * TB);
  T* do_s = reinterpret_cast<T*>(smem + 3 * TB);
  float* p_s = reinterpret_cast<float*>(smem + 4 * TB);
  float* ds_s = p_s + TR * TL::PS;
  int* qseg_s = reinterpret_cast<int*>(ds_s + TR * TL::PS);
  int* kseg_s = qseg_s + TR;
  float* lse_s = reinterpret_cast<float*>(kseg_s + TR);
  float* delta_s = lse_s + TR;

  const size_t k0 = static_cast<size_t>(b) * Sk + kt * TR;
  load_tile<T, D>(k_s, k + k0 * rs + h * dh, rs, k_rows, dh, tid);
  load_tile<T, D>(v_s, v + k0 * rs + h * dh, rs, k_rows, dh, tid);
  if (tid < TR) kseg_s[tid] = tid < k_rows ? kseg[k0 + tid] : -1;
  const int* kr = krange + (static_cast<size_t>(b) * nkt + kt) * 2;
  const float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * Sq;
  const float* delta_bh = delta + (static_cast<size_t>(b) * H + h) * Sq;

  float dka[RI][TL::NC], dva[RI][TL::NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int c = 0; c < TL::NC; ++c) {
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
    const size_t q0 = static_cast<size_t>(b) * Sq + qt * TR;
    const int q_rows = min(TR, Sq - qt * TR);
    load_tile<T, D>(q_s, q + q0 * rs + h * dh, rs, q_rows, dh, tid);
    load_tile<T, D>(do_s, dout + q0 * rs + h * dh, rs, q_rows, dh, tid);
    if (tid < TR) {
      const bool in = tid < q_rows;
      qseg_s[tid] = in ? qseg[q0 + tid] : -1;
      lse_s[tid] = in ? lse_bh[qt * TR + tid] : 0.f;
      delta_s[tid] = in ? delta_bh[qt * TR + tid] : 0.f;
    }
    __syncthreads();

    // transposed scores: row = key ty + 16 i, column = query tx + 16 j
    float s[RI][RI], dp[RI][RI];
    tile_dot_nt<T, D>(k_s, q_s, ty, tx, s);
    tile_dot_nt<T, D>(v_s, do_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int kj = kt * TR + r;
      const int ksg = kseg_s[r];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool live = c < q_rows && r < k_rows && qseg_s[c] == ksg &&
                          (!causal || qt * TR + c >= kj);
        const float p = live ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[c]) * scale;
        p_s[r * TL::PS + c] = round_to<T>(p, pv_f32);
        ds_s[r * TL::PS + c] = round_to<T>(ds, pv_f32);
      }
    }
    __syncthreads();
    tile_acc_nn<T, D>(p_s, do_s, ty, tx, dva);
    tile_acc_nn<T, D>(ds_s, q_s, ty, tx, dka);
  }

  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  store_rows<T, D>(dk + k0 * rs + h * dh, rs, ty, tx, k_rows, dh, dka, one);
  store_rows<T, D>(dv + k0 * rs + h * dh, rs, ty, tx, k_rows, dh, dva, one);
}

// ---------------------------------------------------------------------------
// dQ: one block per (query tile, head, batch), looping over key tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t bwd_dq_smem() {
  return 4 * tile_bytes<T, D>() + ptile_bytes<D>() +
         2 * Tile<D>::ROWS * sizeof(int) + 2 * Tile<D>::ROWS * sizeof(float);
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ qrange,
                    const int* __restrict__ krange,
                    const int* __restrict__ qseg,
                    const int* __restrict__ kseg, T* __restrict__ dq, int Sq,
                    int Sk, int H, int dh, int causal, int pv_f32,
                    float scale) {
  using TL = Tile<D>;
  constexpr int TR = TL::ROWS, RI = TL::RI;
  if (FULL) dh = D;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = n_tiles(Sq, TR), nkt = n_tiles(Sk, TR);
  const size_t rs = static_cast<size_t>(H) * dh;
  constexpr size_t TB = tile_bytes<T, D>();
  const int q_rows = min(TR, Sq - qt * TR);

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + TB);
  T* k_s = reinterpret_cast<T*>(smem + 2 * TB);
  T* v_s = reinterpret_cast<T*>(smem + 3 * TB);
  float* ds_s = reinterpret_cast<float*>(smem + 4 * TB);
  int* qseg_s = reinterpret_cast<int*>(ds_s + TR * TL::PS);
  int* kseg_s = qseg_s + TR;
  float* lse_s = reinterpret_cast<float*>(kseg_s + TR);
  float* delta_s = lse_s + TR;

  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TR;
  load_tile<T, D>(q_s, q + q0 * rs + h * dh, rs, q_rows, dh, tid);
  load_tile<T, D>(do_s, dout + q0 * rs + h * dh, rs, q_rows, dh, tid);
  if (tid < TR) {
    const size_t bh = (static_cast<size_t>(b) * H + h) * Sq + qt * TR;
    const bool in = tid < q_rows;
    qseg_s[tid] = in ? qseg[q0 + tid] : -1;
    lse_s[tid] = in ? lse[bh + tid] : 0.f;
    delta_s[tid] = in ? delta[bh + tid] : 0.f;
  }
  const int* qr = qrange + (static_cast<size_t>(b) * nqt + qt) * 2;

  float dqa[RI][TL::NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int c = 0; c < TL::NC; ++c) dqa[i][c] = 0.f;
  }

  const int kt_end = causal ? min(nkt, qt + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (!tiles_live(qr, krange + (static_cast<size_t>(b) * nkt + kt) * 2)) {
      continue;
    }
    __syncthreads();
    const size_t k0 = static_cast<size_t>(b) * Sk + kt * TR;
    const int k_rows = min(TR, Sk - kt * TR);
    load_tile<T, D>(k_s, k + k0 * rs + h * dh, rs, k_rows, dh, tid);
    load_tile<T, D>(v_s, v + k0 * rs + h * dh, rs, k_rows, dh, tid);
    if (tid < TR) kseg_s[tid] = tid < k_rows ? kseg[k0 + tid] : -1;
    __syncthreads();

    float s[RI][RI], dp[RI][RI];
    tile_dot_nt<T, D>(q_s, k_s, ty, tx, s);
    tile_dot_nt<T, D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qi = qt * TR + r;
      const int qsg = qseg_s[r];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool live = r < q_rows && c < k_rows && qsg == kseg_s[c] &&
                          (!causal || qi >= kt * TR + c);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]) * scale;
        ds_s[r * TL::PS + c] = round_to<T>(ds, pv_f32);
      }
    }
    __syncthreads();
    tile_acc_nn<T, D>(ds_s, k_s, ty, tx, dqa);
  }

  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  store_rows<T, D>(dq + q0 * rs + h * dh, rs, ty, tx, q_rows, dh, dqa, one);
}

// ---------------------------------------------------------------------------
// head dims above 512: the wide kernels
// ---------------------------------------------------------------------------
//
// Above 512 columns a tile no longer fits the layout of the kernels above
// (four f32 tiles of 16 rows x 1024 columns would take 264 KB).  The wide
// kernels are their simple form: the head dim is cut into chunks of
// WD = 512 columns and each block owns one (tile, head, batch, chunk c).
// Its products over the whole head dim (Q K^T, and dO V^T in the
// backward) stream chunk after chunk through the 16-row tiles of Tile<512>,
// adding into the same registers in column order, so every block of a
// (tile, head, batch) computes the same scores, softmax and P; each then
// takes its own chunk of V (forward), of dO and Q (dK/dV) or of K (dQ) for
// the product it accumulates and writes chunk c of its output (the
// forward's chunk-0 block writes lse).  The scores are recomputed once per
// chunk: the price of keeping the tiles and registers of width 512.  Rows
// are d elements apart; a chunk past d is zero-filled as it loads.

constexpr int WD = 512;

__host__ __device__ constexpr int n_chunks(int dh) { return (dh + WD - 1) / WD; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ qrange,
                      const int* __restrict__ krange,
                      const int* __restrict__ qseg,
                      const int* __restrict__ kseg, T* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int H, int dh,
                      int causal, int pv_f32, float scale) {
  using TL = Tile<WD>;
  constexpr int TR = TL::ROWS, RI = TL::RI;
  const int nch = n_chunks(dh);
  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nch, ch = blockIdx.z % nch;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = n_tiles(Sq, TR), nkt = n_tiles(Sk, TR);
  const size_t rs = static_cast<size_t>(H) * dh;
  const int q_rows = min(TR, Sq - qt * TR);
  const int cw = min(WD, dh - ch * WD);

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + tile_bytes<T, WD>());
  T* v_s = reinterpret_cast<T*>(smem + 2 * tile_bytes<T, WD>());
  float* p_s = reinterpret_cast<float*>(smem + 3 * tile_bytes<T, WD>());
  int* qseg_s = reinterpret_cast<int*>(smem + 3 * tile_bytes<T, WD>() +
                                       ptile_bytes<WD>());
  int* kseg_s = qseg_s + TR;

  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TR;
  const T* q_base = q + q0 * rs + h * dh;
  if (tid < TR) qseg_s[tid] = tid < q_rows ? qseg[q0 + tid] : -1;
  const int* qr = qrange + (static_cast<size_t>(b) * nqt + qt) * 2;

  float m[RI], l[RI], acc[RI][TL::NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TL::NC; ++c) acc[i][c] = 0.f;
  }

  const int kt_end = causal ? min(nkt, qt + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (!tiles_live(qr, krange + (static_cast<size_t>(b) * nkt + kt) * 2)) {
      continue;
    }
    const size_t k0 = static_cast<size_t>(b) * Sk + kt * TR;
    const T* k_base = k + k0 * rs + h * dh;
    const int k_rows = min(TR, Sk - kt * TR);
    float s[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < nch; ++c) {
      const int w = min(WD, dh - c * WD);
      __syncthreads();   // the previous readers of the tiles are done
      load_tile<T, WD>(q_s, q_base + c * WD, rs, q_rows, w, tid);
      load_tile<T, WD>(k_s, k_base + c * WD, rs, k_rows, w, tid);
      __syncthreads();
      tile_dot_nt_add<T, WD>(q_s, k_s, ty, tx, s);
    }
    load_tile<T, WD>(v_s, v + k0 * rs + h * dh + ch * WD, rs, k_rows, cw,
                     tid);
    if (tid < TR) kseg_s[tid] = tid < k_rows ? kseg[k0 + tid] : -1;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qi = qt * TR + r;
      const int qsg = qseg_s[r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool live =
            qsg == kseg_s[c] && (!causal || qi >= kt * TR + c);
        s[i][j] = c >= k_rows ? -INFINITY
                              : (live ? s[i][j] * scale : MASK_VALUE);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[r * TL::PS + tx + 16 * j] = round_to<T>(p, pv_f32);
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TL::NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // the P tile is complete
    tile_acc_nn<T, WD>(p_s, v_s, ty, tx, acc);
  }

  float den[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) den[i] = (l[i] == 0.f) ? 1.f : l[i];
  store_rows<T, WD>(o + q0 * rs + h * dh + ch * WD, rs, ty, tx, q_rows, cw,
                    acc, den);
  if (ch == 0 && tx == 0) {
    float* lrow = lse + (static_cast<size_t>(b) * H + h) * Sq + qt * TR;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      if (ty + 16 * i < q_rows) lrow[ty + 16 * i] = m[i] + logf(den[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ qrange,
                         const int* __restrict__ krange,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Sk, int H, int dh,
                         int causal, int pv_f32, float scale) {
  using TL = Tile<WD>;
  constexpr int TR = TL::ROWS, RI = TL::RI;
  const int nch = n_chunks(dh);
  const int kt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nch, ch = blockIdx.z % nch;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = n_tiles(Sq, TR), nkt = n_tiles(Sk, TR);
  const size_t rs = static_cast<size_t>(H) * dh;
  constexpr size_t TB = tile_bytes<T, WD>();
  const int k_rows = min(TR, Sk - kt * TR);
  const int cw = min(WD, dh - ch * WD);

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + TB);
  T* q_s = reinterpret_cast<T*>(smem + 2 * TB);
  T* do_s = reinterpret_cast<T*>(smem + 3 * TB);
  float* p_s = reinterpret_cast<float*>(smem + 4 * TB);
  float* ds_s = p_s + TR * TL::PS;
  int* qseg_s = reinterpret_cast<int*>(ds_s + TR * TL::PS);
  int* kseg_s = qseg_s + TR;
  float* lse_s = reinterpret_cast<float*>(kseg_s + TR);
  float* delta_s = lse_s + TR;

  const size_t k0 = static_cast<size_t>(b) * Sk + kt * TR;
  const T* k_base = k + k0 * rs + h * dh;
  const T* v_base = v + k0 * rs + h * dh;
  if (tid < TR) kseg_s[tid] = tid < k_rows ? kseg[k0 + tid] : -1;
  const int* kr = krange + (static_cast<size_t>(b) * nkt + kt) * 2;
  const float* lse_bh = lse + (static_cast<size_t>(b) * H + h) * Sq;
  const float* delta_bh = delta + (static_cast<size_t>(b) * H + h) * Sq;

  float dka[RI][TL::NC], dva[RI][TL::NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int c = 0; c < TL::NC; ++c) {
      dka[i][c] = 0.f;
      dva[i][c] = 0.f;
    }
  }

  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    if (!tiles_live(qrange + (static_cast<size_t>(b) * nqt + qt) * 2, kr)) {
      continue;
    }
    const size_t q0 = static_cast<size_t>(b) * Sq + qt * TR;
    const T* q_base = q + q0 * rs + h * dh;
    const T* do_base = dout + q0 * rs + h * dh;
    const int q_rows = min(TR, Sq - qt * TR);
    // transposed scores: row = key ty + 16 i, column = query tx + 16 j
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    for (int c = 0; c < nch; ++c) {
      const int w = min(WD, dh - c * WD);
      __syncthreads();
      load_tile<T, WD>(k_s, k_base + c * WD, rs, k_rows, w, tid);
      load_tile<T, WD>(v_s, v_base + c * WD, rs, k_rows, w, tid);
      load_tile<T, WD>(q_s, q_base + c * WD, rs, q_rows, w, tid);
      load_tile<T, WD>(do_s, do_base + c * WD, rs, q_rows, w, tid);
      __syncthreads();
      tile_dot_nt_add<T, WD>(k_s, q_s, ty, tx, s);
      tile_dot_nt_add<T, WD>(v_s, do_s, ty, tx, dp);
    }
    __syncthreads();
    if (ch != nch - 1) {   // the last chunk's are loaded
      load_tile<T, WD>(q_s, q_base + ch * WD, rs, q_rows, cw, tid);
      load_tile<T, WD>(do_s, do_base + ch * WD, rs, q_rows, cw, tid);
    }
    if (tid < TR) {
      const bool in = tid < q_rows;
      qseg_s[tid] = in ? qseg[q0 + tid] : -1;
      lse_s[tid] = in ? lse_bh[qt * TR + tid] : 0.f;
      delta_s[tid] = in ? delta_bh[qt * TR + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int kj = kt * TR + r;
      const int ksg = kseg_s[r];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool live = c < q_rows && r < k_rows && qseg_s[c] == ksg &&
                          (!causal || qt * TR + c >= kj);
        const float p = live ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[c]) * scale;
        p_s[r * TL::PS + c] = round_to<T>(p, pv_f32);
        ds_s[r * TL::PS + c] = round_to<T>(ds, pv_f32);
      }
    }
    __syncthreads();
    tile_acc_nn<T, WD>(p_s, do_s, ty, tx, dva);
    tile_acc_nn<T, WD>(ds_s, q_s, ty, tx, dka);
  }

  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  store_rows<T, WD>(dk + k0 * rs + h * dh + ch * WD, rs, ty, tx, k_rows, cw,
                    dka, one);
  store_rows<T, WD>(dv + k0 * rs + h * dh + ch * WD, rs, ty, tx, k_rows, cw,
                    dva, one);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ qrange,
                         const int* __restrict__ krange,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, T* __restrict__ dq,
                         int Sq, int Sk, int H, int dh, int causal,
                         int pv_f32, float scale) {
  using TL = Tile<WD>;
  constexpr int TR = TL::ROWS, RI = TL::RI;
  const int nch = n_chunks(dh);
  const int qt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nch, ch = blockIdx.z % nch;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nqt = n_tiles(Sq, TR), nkt = n_tiles(Sk, TR);
  const size_t rs = static_cast<size_t>(H) * dh;
  constexpr size_t TB = tile_bytes<T, WD>();
  const int q_rows = min(TR, Sq - qt * TR);
  const int cw = min(WD, dh - ch * WD);

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + TB);
  T* k_s = reinterpret_cast<T*>(smem + 2 * TB);
  T* v_s = reinterpret_cast<T*>(smem + 3 * TB);
  float* ds_s = reinterpret_cast<float*>(smem + 4 * TB);
  int* qseg_s = reinterpret_cast<int*>(ds_s + TR * TL::PS);
  int* kseg_s = qseg_s + TR;
  float* lse_s = reinterpret_cast<float*>(kseg_s + TR);
  float* delta_s = lse_s + TR;

  const size_t q0 = static_cast<size_t>(b) * Sq + qt * TR;
  const T* q_base = q + q0 * rs + h * dh;
  const T* do_base = dout + q0 * rs + h * dh;
  if (tid < TR) {
    const size_t bh = (static_cast<size_t>(b) * H + h) * Sq + qt * TR;
    const bool in = tid < q_rows;
    qseg_s[tid] = in ? qseg[q0 + tid] : -1;
    lse_s[tid] = in ? lse[bh + tid] : 0.f;
    delta_s[tid] = in ? delta[bh + tid] : 0.f;
  }
  const int* qr = qrange + (static_cast<size_t>(b) * nqt + qt) * 2;

  float dqa[RI][TL::NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int c = 0; c < TL::NC; ++c) dqa[i][c] = 0.f;
  }

  const int kt_end = causal ? min(nkt, qt + 1) : nkt;
  for (int kt = 0; kt < kt_end; ++kt) {
    if (!tiles_live(qr, krange + (static_cast<size_t>(b) * nkt + kt) * 2)) {
      continue;
    }
    const size_t k0 = static_cast<size_t>(b) * Sk + kt * TR;
    const T* k_base = k + k0 * rs + h * dh;
    const T* v_base = v + k0 * rs + h * dh;
    const int k_rows = min(TR, Sk - kt * TR);
    float s[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    for (int c = 0; c < nch; ++c) {
      const int w = min(WD, dh - c * WD);
      __syncthreads();
      load_tile<T, WD>(q_s, q_base + c * WD, rs, q_rows, w, tid);
      load_tile<T, WD>(do_s, do_base + c * WD, rs, q_rows, w, tid);
      load_tile<T, WD>(k_s, k_base + c * WD, rs, k_rows, w, tid);
      load_tile<T, WD>(v_s, v_base + c * WD, rs, k_rows, w, tid);
      __syncthreads();
      tile_dot_nt_add<T, WD>(q_s, k_s, ty, tx, s);
      tile_dot_nt_add<T, WD>(do_s, v_s, ty, tx, dp);
    }
    __syncthreads();
    if (ch != nch - 1) {   // the last chunk's is loaded
      load_tile<T, WD>(k_s, k_base + ch * WD, rs, k_rows, cw, tid);
    }
    if (tid < TR) kseg_s[tid] = tid < k_rows ? kseg[k0 + tid] : -1;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      const int qi = qt * TR + r;
      const int qsg = qseg_s[r];
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int c = tx + 16 * j;
        const bool live = r < q_rows && c < k_rows && qsg == kseg_s[c] &&
                          (!causal || qi >= kt * TR + c);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]) * scale;
        ds_s[r * TL::PS + c] = round_to<T>(ds, pv_f32);
      }
    }
    __syncthreads();
    tile_acc_nn<T, WD>(ds_s, k_s, ty, tx, dqa);
  }

  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  store_rows<T, WD>(dq + q0 * rs + h * dh + ch * WD, rs, ty, tx, q_rows, cw,
                    dqa, one);
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
  int B, Sq, Sk, H, D, causal, pv_f32;   // D: the head dim
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, bool FULL>
cudaError_t run_fwd(const Args& a) {
  auto kernel = flash_fwd_kernel<T, D, FULL>;
  static bool attr_set = false;   // once per instantiation
  if (!attr_set) {
    const cudaError_t e = allow_smem(kernel, fwd_smem<T, D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(n_tiles(a.Sq, Tile<D>::ROWS), a.H, a.B);
  kernel<<<grid, NTHREADS, fwd_smem<T, D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.Sq, a.Sk, a.H, a.D, a.causal, a.pv_f32,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool FULL>
cudaError_t run_bwd_kv(const Args& a) {
  auto kernel = flash_bwd_kv_kernel<T, D, FULL>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = allow_smem(kernel, bwd_kv_smem<T, D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(n_tiles(a.Sk, Tile<D>::ROWS), a.H, a.B);
  kernel<<<grid, NTHREADS, bwd_kv_smem<T, D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.D, a.causal, a.pv_f32,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D, bool FULL>
cudaError_t run_bwd_dq(const Args& a) {
  auto kernel = flash_bwd_dq_kernel<T, D, FULL>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = allow_smem(kernel, bwd_dq_smem<T, D>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(n_tiles(a.Sq, Tile<D>::ROWS), a.H, a.B);
  kernel<<<grid, NTHREADS, bwd_dq_smem<T, D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.qrange),
      static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
      static_cast<const int*>(a.kseg), static_cast<T*>(a.dq), a.Sq, a.Sk,
      a.H, a.D, a.causal, a.pv_f32, a.scale);
  return cudaGetLastError();
}

enum Which { FWD = 0, BWD_KV = 1, BWD_DQ = 2 };

template <typename T, int D, bool FULL>
cudaError_t run_as(Which w, const Args& a) {
  switch (w) {
    case FWD: return run_fwd<T, D, FULL>(a);
    case BWD_KV: return run_bwd_kv<T, D, FULL>(a);
    case BWD_DQ: return run_bwd_dq<T, D, FULL>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int D>
cudaError_t run(Which w, const Args& a) {
  return a.D == D ? run_as<T, D, true>(w, a) : run_as<T, D, false>(w, a);
}

// the wide kernels: one block per (tile, head, batch x chunk)
template <typename T>
cudaError_t run_wide(Which w, const Args& a) {
  const int nch = n_chunks(a.D);
  if (static_cast<long long>(a.B) * nch > 65535) return cudaErrorInvalidValue;
  constexpr int TR = Tile<WD>::ROWS;
  if (w == FWD) {
    auto kernel = flash_fwd_wide_kernel<T>;
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = allow_smem(kernel, fwd_smem<T, WD>());
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    kernel<<<dim3(n_tiles(a.Sq, TR), a.H, a.B * nch), NTHREADS,
             fwd_smem<T, WD>(), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const int*>(a.qrange),
        static_cast<const int*>(a.krange), static_cast<const int*>(a.qseg),
        static_cast<const int*>(a.kseg), static_cast<T*>(a.o),
        static_cast<float*>(a.lse), a.Sq, a.Sk, a.H, a.D, a.causal,
        a.pv_f32, a.scale);
  } else if (w == BWD_KV) {
    auto kernel = flash_bwd_kv_wide_kernel<T>;
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = allow_smem(kernel, bwd_kv_smem<T, WD>());
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    kernel<<<dim3(n_tiles(a.Sk, TR), a.H, a.B * nch), NTHREADS,
             bwd_kv_smem<T, WD>(), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta),
        static_cast<const int*>(a.qrange), static_cast<const int*>(a.krange),
        static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.D,
        a.causal, a.pv_f32, a.scale);
  } else {
    auto kernel = flash_bwd_dq_wide_kernel<T>;
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = allow_smem(kernel, bwd_dq_smem<T, WD>());
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
    kernel<<<dim3(n_tiles(a.Sq, TR), a.H, a.B * nch), NTHREADS,
             bwd_dq_smem<T, WD>(), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta),
        static_cast<const int*>(a.qrange), static_cast<const int*>(a.krange),
        static_cast<const int*>(a.qseg), static_cast<const int*>(a.kseg),
        static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.D, a.causal, a.pv_f32,
        a.scale);
  }
  return cudaGetLastError();
}

// the kernel compiled at the least width DP >= the head dim
template <typename T>
cudaError_t run_head_dim(Which w, const Args& a) {
  if (a.D <= 16) return run<T, 16>(w, a);
  if (a.D <= 32) return run<T, 32>(w, a);
  if (a.D <= 64) return run<T, 64>(w, a);
  if (a.D <= 128) return run<T, 128>(w, a);
  if (a.D <= 256) return run<T, 256>(w, a);
  if (a.D <= 512) return run<T, 512>(w, a);
  return run_wide<T>(w, a);
}

// dtype: 0 = f32, 1 = bf16; head dim a multiple of 8 from 8 up; any
// positive lengths.  The range arrays hold one [min, max] per tile of
// Tile<DP>::ROWS rows (the Python wrappers compute them at that tile).
cudaError_t dispatch(Which w, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.H > 65535 ||
      a.B > 65535 || a.D < 8 || a.D % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return run_head_dim<float>(w, a);
  if (dtype == 1) return run_head_dim<bf16>(w, a);
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
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.D = D; a.causal = causal;
  a.pv_f32 = pv_f32; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(FWD, dtype, a));
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
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.D = D; a.causal = causal;
  a.pv_f32 = pv_f32; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(BWD_KV, dtype, a));
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
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.D = D; a.causal = causal;
  a.pv_f32 = pv_f32; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(BWD_DQ, dtype, a));
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
