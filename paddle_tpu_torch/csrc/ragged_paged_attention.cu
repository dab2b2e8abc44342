// Ragged paged attention for Hopper (sm_90a): mixed prefill + decode rows
// over a paged KV pool, one launch per layer.
//
// Replaces the Pallas TPU kernel `_ragged_kernel`
// (paddle_tpu/serving/decode_attention.py:173, launched by `_ragged_pallas`
// at :317) and computes what it computes:
//   - q [T, H, D] f32 is a sequence-packed row stack; rows come in blocks of
//     BLOCK_ROWS = 8, one sequence per block, read as row_seq[blk * 8];
//   - pages [P, page, H_kv, D] in f32, bf16 or int8 (int8 with f32 scales
//     [P, page, H_kv], dequantized in registers as q * scale);
//   - GQA: query head h reads KV head h / G (G = H / H_kv); the G query
//     heads of a KV head share one page load;
//   - the whole mask is `token <= qpos` (qpos -1 = padded row), and tokens
//     at or past the sequence's kv_len are never read;
//   - online softmax with (m, l, acc) in f32; bf16 pages round P to bf16
//     before the PV product, as the TPU kernel's p.astype(vb.dtype) does;
//   - a row with nothing live yields 0, not NaN.
//
// What bounds it on the H100: a decode row reads every live K/V byte of its
// sequence once and does 2 * G * D FMAs per token and KV head against
// 2 * D * sizeof(page) bytes, far below the card's FLOP/byte balance, so
// decode is memory-bound. A prefill chunk of n rows re-reads the same pages
// for n / 8 row blocks (from L2) and adds n-proportional FLOPs.
//
// Design: one CUDA block handles one (row block, KV head) pair, and a loop
// over the sequence's tokens inside the block replaces the TPU's
// sequential page grid axis and its VMEM scratch carry (Hopper's blocks run
// in parallel and in no order, so nothing can carry between blocks). Each
// block reads its own sequence id, page-table row and length, which
// replaces scalar prefetch. Tokens stream in tiles of 32 (a tile may cross
// a page boundary; each token row is fetched through the page table) with
// cp.async double buffering, so the next tile's 16-byte loads are in flight
// while this tile computes. A tile of f32 K and V at D = 128 is 2 x 16 KB;
// dynamic shared memory above 48 KB is enabled with cudaFuncSetAttribute.
// The loop stops at min(kv_len, max qpos of the block + 1): later tokens
// are masked for every row of the block. The arithmetic is f32 on the CUDA
// cores (the TPU kernel's f32 semantics; TF32 tensor cores would drop
// precision): lane = token for the scores, lane = 4 columns of D for the
// PV product, each warp owning 2 * G of the block's 8 * G score rows.
// Split-K over pages, wgmma and TMA are later work.
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

constexpr int BLOCK_ROWS = 8;   // query rows per block (one sequence)
constexpr int KT = 32;          // tokens per tile: lane <-> token
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NSTAGE = 2;       // cp.async pipeline depth
constexpr int HEAD_DIM = 128;   // lane <-> 4 columns in the PV product
constexpr float MASK_VALUE = -0.7f * FLT_MAX;  // DEFAULT_MASK_VALUE

// padding of a K/V tile row in shared memory, in elements (keeps each row
// 16-byte aligned for cp.async and spreads lanes over the banks)
template <typename T> struct RowPad;
template <> struct RowPad<float> { static constexpr int value = 4; };
template <> struct RowPad<__nv_bfloat16> { static constexpr int value = 8; };
template <> struct RowPad<int8_t> { static constexpr int value = 16; };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// P as the PV product sees it: bf16 pages round it to bf16 first
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(p));
  } else {
    return p;
  }
}

__device__ __forceinline__ float warp_max(float v) {
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared memory of one block: Q tile [8G][D+4] f32, P tile [8G][KT] f32,
// then NSTAGE stages of {K tile, V tile [KT][D+pad] T, K/V scales [KT]}
template <typename T>
struct Layout {
  static constexpr int QS = HEAD_DIM + 4;
  static constexpr int KS = HEAD_DIM + RowPad<T>::value;
  static constexpr int ROW_BYTES = KS * static_cast<int>(sizeof(T));
  static constexpr int STAGE_BYTES = 2 * KT * ROW_BYTES + 2 * KT * 4;
  static constexpr size_t bytes(int rows) {
    return static_cast<size_t>(rows) * QS * 4 +
           static_cast<size_t>(rows) * KT * 4 +
           static_cast<size_t>(NSTAGE) * STAGE_BYTES;
  }
};

// R = score rows per warp = 2 * G (8 * G rows over NWARPS warps)
template <typename T, int R>
__global__ void __launch_bounds__(NTHREADS)
ragged_paged_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ kv_lens, const int* __restrict__ row_seq,
    const int* __restrict__ qpos, float* __restrict__ out, int H, int KVH,
    int page, int Pm, float sm_scale) {
  using L = Layout<T>;
  constexpr int D = HEAD_DIM;
  constexpr int G = R * NWARPS / BLOCK_ROWS;   // query heads per KV head
  constexpr int ROWS = BLOCK_ROWS * G;         // score rows of the block
  constexpr int CHUNKS = D * static_cast<int>(sizeof(T)) / 16;
  constexpr bool QUANT = std::is_same<T, int8_t>::value;

  const int blk = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + ROWS * L::QS;
  unsigned char* stages = reinterpret_cast<unsigned char*>(p_s + ROWS * KT);

  const int row0 = blk * BLOCK_ROWS;
  const int seq = row_seq[row0];
  int max_pos = -1;
#pragma unroll
  for (int i = 0; i < BLOCK_ROWS; ++i) max_pos = max(max_pos, qpos[row0 + i]);
  // tokens past max_pos are masked for every row; past kv_len never live
  const int n_tok = max(0, min(min(kv_lens[seq], max_pos + 1), Pm * page));
  const int n_tiles = (n_tok + KT - 1) / KT;
  const int* pt = page_table + static_cast<size_t>(seq) * Pm;

  // Q tile: score row rr = i * G + g is query row row0 + i, head kh*G + g
  for (int idx = tid; idx < ROWS * (D / 4); idx += NTHREADS) {
    const int rr = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    const int i = rr / G;
    const int g = rr % G;
    const float* src =
        q + (static_cast<size_t>(row0 + i) * H + kh * G + g) * D + c;
    *reinterpret_cast<float4*>(q_s + rr * L::QS + c) =
        *reinterpret_cast<const float4*>(src);
  }

  auto k_tile = [&](int s) {
    return reinterpret_cast<T*>(stages + s * L::STAGE_BYTES);
  };
  auto v_tile = [&](int s) {
    return reinterpret_cast<T*>(stages + s * L::STAGE_BYTES +
                                KT * L::ROW_BYTES);
  };
  auto k_sc = [&](int s) {
    return reinterpret_cast<float*>(stages + s * L::STAGE_BYTES +
                                    2 * KT * L::ROW_BYTES);
  };
  auto v_sc = [&](int s) { return k_sc(s) + KT; };

  // fetch tile `tile` (tokens tile*KT ..) into stage s through the table
  auto fetch = [&](int tile, int s) {
    const int t0 = tile * KT;
    unsigned char* kd = reinterpret_cast<unsigned char*>(k_tile(s));
    unsigned char* vd = reinterpret_cast<unsigned char*>(v_tile(s));
    for (int idx = tid; idx < KT * CHUNKS; idx += NTHREADS) {
      const int r = idx / CHUNKS;
      const int c = idx % CHUNKS;
      const int tok = t0 + r;
      if (tok < n_tok) {
        const size_t row =
            (static_cast<size_t>(pt[tok / page]) * page + tok % page) * KVH +
            kh;
        cp_async16(kd + r * L::ROW_BYTES + c * 16,
                   reinterpret_cast<const unsigned char*>(k_pages + row * D) +
                       c * 16);
        cp_async16(vd + r * L::ROW_BYTES + c * 16,
                   reinterpret_cast<const unsigned char*>(v_pages + row * D) +
                       c * 16);
      }
    }
    if constexpr (QUANT) {
      for (int r = tid; r < KT; r += NTHREADS) {
        const int tok = t0 + r;
        if (tok < n_tok) {
          const size_t row =
              (static_cast<size_t>(pt[tok / page]) * page + tok % page) *
                  KVH + kh;
          cp_async4(k_sc(s) + r, k_scale + row);
          cp_async4(v_sc(s) + r, v_scale + row);
        }
      }
    }
  };

  // per-row online-softmax state; warp w owns score rows w + NWARPS * j
  int pos[R];
  float m[R], l[R];
  float4 acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    pos[j] = qpos[row0 + (warp + NWARPS * j) / G];
    m[j] = -INFINITY;
    l[j] = 0.f;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_tiles) fetch(s, s);
    cp_async_commit();
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int next = tile + NSTAGE - 1;
    if (next < n_tiles) fetch(next, next % NSTAGE);
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();   // this tile (and, first time, the Q tile) landed

    const int s = tile % NSTAGE;
    const int t0 = tile * KT;
    const int tile_n = min(KT, n_tok - t0);
    const T* kt = k_tile(s);
    const T* vt = v_tile(s);

    // scores: lane = token of the tile
    float dot[R];
#pragma unroll
    for (int j = 0; j < R; ++j) dot[j] = 0.f;
    if (lane < tile_n) {
      const float ks = QUANT ? k_sc(s)[lane] : 1.f;
      const T* krow = kt + lane * L::KS;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        float4 k4 = load4(krow + c);
        if constexpr (QUANT) k4 = scale4(k4, ks);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float4 q4 = *reinterpret_cast<const float4*>(
              q_s + (warp + NWARPS * j) * L::QS + c);
          dot[j] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
        }
      }
    }

    // online softmax; the warp's shuffles reduce over the tile's tokens
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float sc = -INFINITY;               // lanes past the tile: p = 0
      if (lane < tile_n) {
        sc = (t0 + lane <= pos[j]) ? dot[j] * sm_scale : MASK_VALUE;
      }
      const float m_new = fmaxf(m[j], warp_max(sc));
      const float alpha = expf(m[j] - m_new);
      const float p = expf(sc - m_new);
      l[j] = alpha * l[j] + warp_sum(p);
      m[j] = m_new;
      acc[j] = scale4(acc[j], alpha);
      p_s[(warp + NWARPS * j) * KT + lane] = round_p<T>(p);
    }
    __syncwarp();

    // acc += P V: lane = 4 columns of D
    for (int t = 0; t < tile_n; ++t) {
      float4 v4 = load4(vt + t * L::KS + lane * 4);
      if constexpr (QUANT) v4 = scale4(v4, v_sc(s)[t]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = p_s[(warp + NWARPS * j) * KT + t];
        acc[j].x += p * v4.x;
        acc[j].y += p * v4.y;
        acc[j].z += p * v4.z;
        acc[j].w += p * v4.w;
      }
    }
    __syncthreads();   // every warp is done with stage s before it refills
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int rr = warp + NWARPS * j;
    const float den = (l[j] == 0.f) ? 1.f : l[j];   // length 0 -> zeros
    float* dst = out +
                 (static_cast<size_t>(row0 + rr / G) * H + kh * G + rr % G) *
                     D + lane * 4;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[j].x / den, acc[j].y / den, acc[j].z / den,
                    acc[j].w / den);
  }
}

template <typename T, int R>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* pt,
                   const void* lens, const void* rs, const void* qp,
                   void* out, int T_rows, int H, int KVH, int page, int Pm,
                   float sm_scale, cudaStream_t stream) {
  constexpr int ROWS = R * NWARPS;
  const size_t smem = Layout<T>::bytes(ROWS);
  auto kernel = ragged_paged_attention_kernel<T, R>;
  static bool smem_attr_set = false;   // once per instantiation
  if (!smem_attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_attr_set = true;
  }
  const dim3 grid(T_rows / BLOCK_ROWS, KVH);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pt),
      static_cast<const int*>(lens), static_cast<const int*>(rs),
      static_cast<const int*>(qp), static_cast<float*>(out), H, KVH, page,
      Pm, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_group(int G, const void* q, const void* kp,
                           const void* vp, const void* ks, const void* vs,
                           const void* pt, const void* lens, const void* rs,
                           const void* qp, void* out, int T_rows, int H,
                           int KVH, int page, int Pm, float sm_scale,
                           cudaStream_t stream) {
  switch (G) {
    case 1:
      return launch<T, 2>(q, kp, vp, ks, vs, pt, lens, rs, qp, out, T_rows,
                          H, KVH, page, Pm, sm_scale, stream);
    case 2:
      return launch<T, 4>(q, kp, vp, ks, vs, pt, lens, rs, qp, out, T_rows,
                          H, KVH, page, Pm, sm_scale, stream);
    case 4:
      return launch<T, 8>(q, kp, vp, ks, vs, pt, lens, rs, qp, out, T_rows,
                          H, KVH, page, Pm, sm_scale, stream);
    case 8:
      return launch<T, 16>(q, kp, vp, ks, vs, pt, lens, rs, qp, out, T_rows,
                           H, KVH, page, Pm, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = f32 pages, 1 = bf16 pages, 2 = int8 pages (+ f32 scales)
int rpa_launch(const void* q, const void* k_pages, const void* v_pages,
               const void* k_scale, const void* v_scale,
               const void* page_table, const void* kv_lens,
               const void* row_seq, const void* qpos, void* out, int T_rows,
               int H, int KVH, int D, int page, int Pm, int dtype,
               float sm_scale, void* stream) {
  if (D != HEAD_DIM || KVH <= 0 || H % KVH != 0 || T_rows % BLOCK_ROWS != 0 ||
      page <= 0 || Pm <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int G = H / KVH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      e = dispatch_group<float>(G, q, k_pages, v_pages, k_scale, v_scale,
                                page_table, kv_lens, row_seq, qpos, out,
                                T_rows, H, KVH, page, Pm, sm_scale, st);
      break;
    case 1:
      e = dispatch_group<__nv_bfloat16>(G, q, k_pages, v_pages, k_scale,
                                        v_scale, page_table, kv_lens, row_seq,
                                        qpos, out, T_rows, H, KVH, page, Pm,
                                        sm_scale, st);
      break;
    case 2:
      e = dispatch_group<int8_t>(G, q, k_pages, v_pages, k_scale, v_scale,
                                 page_table, kv_lens, row_seq, qpos, out,
                                 T_rows, H, KVH, page, Pm, sm_scale, st);
      break;
    default:
      break;
  }
  return static_cast<int>(e);
}

const char* rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
