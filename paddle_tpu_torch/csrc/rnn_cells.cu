// Fused LSTM and GRU steps for Hopper (sm_90a): one time step of a
// recurrent layer, the recurrent product and all the gate math in one
// launch, so the gates never round-trip through device memory.
//
// Replaces the four Pallas TPU kernels of paddle_tpu/ops/rnn.py:
//   rnn_lstm_step <- _lstm_fused_kernel_tiled (:80, pallas_call :145)   B5
//   rnn_gru_step  <- _gru_fused_kernel        (:212, pallas_call :283)  B6
//   rnn_gru_zr    <- _gru_zr_kernel_tiled     (:234, pallas_call :295)  B7
//   rnn_gru_cand  <- _gru_cand_kernel_tiled   (:244, pallas_call :317)  B8
// and computes what they compute, read from the Pallas bodies:
//   - LSTM: gates = (xp + h W_h) + b in f32, gate order i, f, g, o; i, f, o
//     sigmoid, g tanh; c' = f c + i g; h' = o tanh(c') in xp's type, c' in
//     f32; acts [B, 5H] = (i, f, g, o, tanh c') in f32 when asked;
//   - GRU: z, r = sigmoid((xp_zr + h W_zr) + b_zr); c = tanh((xp_c +
//     (r h) W_c) + b_c); h' = (1 - z) h + z c in xp's type; acts [B, 3H] =
//     (z, r, c) in f32 when asked.  B6 does the whole step in one launch;
//     B7 writes z and r (into the first 2H columns of a [B, 3H] f32 buffer,
//     the acts layout) and r h [B, H] f32 (rnn.py:311 forms it between the
//     two launches; here it is B7's second output); B8 reads the complete
//     r h and writes h' and, when asked, c into the buffer's last H columns.
//   xp and h are f32 or bf16 (one type), c, W_h and b f32; every product is
//   f32 FMA on the CUDA cores (no TF32: it would change the numbers).
//
// What bounds it on the H100: one step at the training shapes (B 64, H 512)
// is a [64, 512] x [512, 2048] f32 product, 134 MFLOP, 2.0 us at the 67
// TFLOP/s f32 peak, against ~5.9 MB of operands (1.8 us at 3.35 TB/s): so
// operations, at the scale of a launch.  W_h (4.2 MB at H 512, 26 MB at
// H 1280) stays in the 50 MB L2 from one step to the next.
//
// Design: the TPU runs 1-5 large hidden tiles in a sequential grid; on the
// card that would fill 1-5 of 132 SMs.  So blocks tile the hidden units,
// each owning all gates of its units so the gate math stays in registers.
// B5 has its own main loop (below, at its kernel): 256-thread blocks of
// 32 rows by 8 units, a cp.async ring over K, K split across the warps,
// 32 sums a thread.  B6-B8 share the first design: a block owns 16 hidden
// units by 16 batch rows, 8 x 16 = 128 threads, thread (ty, tx) owns unit
// tx and rows 2 ty, 2 ty + 1, and keeps NG x 2 f32 sums (NG = 2 gates for
// z/r, 1 for the candidate); the K axis is taken in chunks of 32, the
// block staging the chunk of its h rows ([16][33], padded against bank
// conflicts) and of its W_h columns ([32][NG * 16]) in shared memory,
// coalesced, then every thread sums.
//
// B6 has the GRU's coupling: the candidate of every unit needs r h of all
// H units.  The TPU holds one whole block; here B6 is one cooperative
// launch (cudaLaunchCooperativeKernel) with a grid-wide sync between the
// two phases: each block keeps the full h rows of its 16 batch rows
// resident in shared memory for phase 1 (z, r of its units), writes its
// r h tile to a scratch buffer, syncs the grid, loads the complete r h
// rows into the same shared memory and computes c and h' for the same
// units, with z and h still in registers.  A cooperative grid must be
// co-resident: 16 (H + pad) x 4 bytes of rows a block and at most 128
// registers a thread (__launch_bounds__(128, 4)) decide how many blocks
// an SM holds, and rnn_gru_block_capacity reports the card's answer.  The
// Python gate (ops/rnn.py) takes B6 when the grid fits and B7 + B8
// otherwise; B7 and B8 are ordinary launches that take any shape.  Later
// work for B6-B8: B5's main loop.
//
// Plain C interface (built by paddle_tpu_torch/kernels/build.py with nvcc,
// loaded with ctypes): each entry returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int UNITS = 16;                  // hidden units of a block (tx)
constexpr int RGROUPS = 8;                 // row groups of a block (ty)
constexpr int RPT = 2;                     // batch rows of a thread
constexpr int ROWS = RGROUPS * RPT;        // batch rows of a block
constexpr int THREADS = UNITS * RGROUPS;   // 128
constexpr int KT = 32;                     // K chunk
constexpr int AS_LD = KT + 1;              // staged h-chunk row stride
constexpr int GRU_BLOCK_MIN_BLOCKS = 4;    // B6: <= 128 registers a thread

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Row stride of the resident rows of B6: H rounded up to whole K chunks
// (zeros beyond H) plus one, so two row groups of a warp hit other banks.
__host__ __device__ __forceinline__ int resident_ld(int H) {
  return (H + KT - 1) / KT * KT + 1;
}

__host__ __device__ __forceinline__ size_t gru_block_smem(int H) {
  return sizeof(float) * ((size_t)ROWS * resident_ld(H) + KT * 2 * UNITS);
}

// Stage rows [k0, k0 + KT) of gate columns (goff + g) H + j0 .. + UNITS of
// W ([K, ldw] f32) into Ws[KT][NG * UNITS]; zeros outside.
template <int NG>
__device__ __forceinline__ void stage_w(float* Ws, const float* W, int ldw,
                                        int goff, int j0, int H, int k0,
                                        int K) {
  for (int e = threadIdx.x; e < KT * NG * UNITS; e += THREADS) {
    const int kk = e / (NG * UNITS), col = e % (NG * UNITS);
    const int g = col / UNITS, j = j0 + col % UNITS, k = k0 + kk;
    Ws[e] = (k < K && j < H) ? W[(size_t)k * ldw + (size_t)(goff + g) * H + j]
                             : 0.f;
  }
}

// Stage columns [k0, k0 + KT) of rows b0 .. b0 + ROWS of A ([B, K]) into
// As[ROWS][AS_LD] as f32; zeros outside.
template <typename TA>
__device__ __forceinline__ void stage_a(float* As, const TA* A, int B, int b0,
                                        int k0, int K) {
  for (int e = threadIdx.x; e < ROWS * KT; e += THREADS) {
    const int r = e / KT, kk = e % KT, b = b0 + r, k = k0 + kk;
    As[r * AS_LD + kk] = (b < B && k < K) ? to_f(A[(size_t)b * K + k]) : 0.f;
  }
}

// acc[g][i] += sum over one chunk of A[row ty RPT + i][kk] Ws[kk][g][tx].
template <int NG>
__device__ __forceinline__ void mac_chunk(float (&acc)[NG][RPT],
                                          const float* As, int as_ld,
                                          const float* Ws, int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < KT; ++kk) {
    float a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = As[(ty * RPT + i) * as_ld + kk];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float w = Ws[kk * NG * UNITS + g * UNITS + tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[g][i] = fmaf(a[i], w, acc[g][i]);
    }
  }
}

// acc += A[b0 .., :] W[:, gate columns], A streamed from device memory.
template <int NG, typename TA>
__device__ __forceinline__ void gemm_staged(float (&acc)[NG][RPT],
                                            const TA* A, int B, int b0,
                                            int K, const float* W, int ldw,
                                            int goff, int j0, int H,
                                            float* As, float* Ws) {
  const int tx = threadIdx.x % UNITS, ty = threadIdx.x / UNITS;
  for (int k0 = 0; k0 < K; k0 += KT) {
    stage_a(As, A, B, b0, k0, K);
    stage_w<NG>(Ws, W, ldw, goff, j0, H, k0, K);
    __syncthreads();
    mac_chunk<NG>(acc, As, AS_LD, Ws, ty, tx);
    __syncthreads();
  }
}

// acc += Hs W[:, gate columns], Hs the block's resident rows.
template <int NG>
__device__ __forceinline__ void gemm_resident(float (&acc)[NG][RPT],
                                              const float* Hs, int hs_ld,
                                              int K, const float* W, int ldw,
                                              int goff, int j0, int H,
                                              float* Ws) {
  const int tx = threadIdx.x % UNITS, ty = threadIdx.x / UNITS;
  for (int k0 = 0; k0 < K; k0 += KT) {
    stage_w<NG>(Ws, W, ldw, goff, j0, H, k0, K);
    __syncthreads();
    mac_chunk<NG>(acc, Hs + k0, hs_ld, Ws, ty, tx);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B5: LSTM step, with its own main loop
//
// A block of 256 threads owns LSTM_ROWS = 32 batch rows by LSTM_UNITS = 8
// hidden units (their 32 gate columns of W_h): 128 blocks at B 64, H 512,
// 320 at H 1280.  K (= H) streams through a ring of LSTM_STAGES chunks of
// LSTM_KC = 64 in shared memory, filled by 16-byte cp.async for h and
// 8-byte cp.async for W (zero-filled past B and K), one barrier a chunk.
// Each of the 8 warps takes 8 k of every chunk (a split of K inside the
// block): lane (ry, ux) keeps rows ry + 8 i (i < 4) by the 4 gates of
// units 2 ux, 2 ux + 1, 32 f32 sums, reading its h rows as 16-byte words
// (row stride padded so the 8 rows of a read sit in 8 bank groups) and
// its 8 W values of a k as two float4 (the chunk stores W as [k][unit
// pair][gate][2]): 24 shared loads per 256 FMAs.  After the loop the
// warps' sums meet in shared memory; thread (row, unit) adds the 8 slices
// of its 4 gates and does the gate math in registers.  H not a multiple
// of 8 (rows of h or W no longer 16- and 8-byte aligned) stages through
// registers instead of cp.async, with the same loop (so do h or W not
// 16-byte aligned).
// ---------------------------------------------------------------------------

constexpr int LSTM_ROWS = 32;
constexpr int LSTM_UNITS = 8;
constexpr int LSTM_COLS = 4 * LSTM_UNITS;          // W columns of a block
constexpr int LSTM_WARPS = 8;
constexpr int LSTM_THREADS = 32 * LSTM_WARPS;      // 256
constexpr int LSTM_KC = 64;                        // K chunk
constexpr int LSTM_KW = LSTM_KC / LSTM_WARPS;      // k of a chunk a warp takes
constexpr int LSTM_STAGES = 4;

// h row stride in shared memory, in elements: the chunk plus 16 bytes
template <typename T>
__host__ __device__ constexpr int lstm_hld() {
  return LSTM_KC + 16 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr size_t lstm_stage_bytes() {
  return sizeof(T) * LSTM_ROWS * lstm_hld<T>() +
         sizeof(float) * LSTM_KC * LSTM_COLS;
}

template <typename T>
__host__ __device__ constexpr size_t lstm_smem() {
  // the ring, reused after the loop for the warps' partial sums
  return LSTM_STAGES * lstm_stage_bytes<T>() >
                 sizeof(float) * LSTM_WARPS * LSTM_ROWS * LSTM_COLS
             ? LSTM_STAGES * lstm_stage_bytes<T>()
             : sizeof(float) * LSTM_WARPS * LSTM_ROWS * LSTM_COLS;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16 or 8) from src, or zeros when !valid (src is not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk k0 .. k0 + LSTM_KC of the block's h rows into hs[row][k] and of its
// W columns into ws[k][unit pair][gate][2].  VEC: cp.async (H % 8 == 0);
// else element by element through registers.
template <typename T, bool VEC>
__device__ __forceinline__ void lstm_stage(T* hs, float* ws, const T* h,
                                           const float* W, int B, int H,
                                           int b0, int j0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int VE = 16 / sizeof(T);              // elements a copy
    constexpr int PER_ROW = LSTM_KC / VE;
    for (int e = tid; e < LSTM_ROWS * PER_ROW; e += LSTM_THREADS) {
      const int row = e / PER_ROW, k = k0 + (e % PER_ROW) * VE;
      const bool ok = b0 + row < B && k < H;
      cp_async<16>(hs + row * lstm_hld<T>() + (e % PER_ROW) * VE,
                   ok ? h + (size_t)(b0 + row) * H + k : h, ok);
    }
    // 16 copies a k: gate g, unit pair p (the 4 pairs of a gate lie
    // side by side in device memory)
    for (int e = tid; e < LSTM_KC * 16; e += LSTM_THREADS) {
      const int kk = e / 16, g = (e % 16) / 4, p = e % 4;
      const bool ok = k0 + kk < H;
      cp_async<8>(ws + kk * LSTM_COLS + p * 8 + g * 2,
                  ok ? W + (size_t)(k0 + kk) * 4 * H + (size_t)g * H + j0 +
                           2 * p
                     : W,
                  ok);
    }
  } else {
    for (int e = tid; e < LSTM_ROWS * LSTM_KC; e += LSTM_THREADS) {
      const int row = e / LSTM_KC, kk = e % LSTM_KC, k = k0 + kk;
      const int b = b0 + row;
      hs[row * lstm_hld<T>() + kk] =
          (b < B && k < H) ? h[(size_t)b * H + k] : from_f<T>(0.f);
    }
    for (int e = tid; e < LSTM_KC * LSTM_COLS; e += LSTM_THREADS) {
      const int kk = e / LSTM_COLS, g = (e % LSTM_COLS) / LSTM_UNITS;
      const int u = e % LSTM_UNITS, k = k0 + kk, j = j0 + u;
      ws[kk * LSTM_COLS + (u / 2) * 8 + g * 2 + u % 2] =
          (k < H && j < H) ? W[(size_t)k * 4 * H + (size_t)g * H + j] : 0.f;
    }
  }
}

// 8 consecutive h values of one row, as f32
__device__ __forceinline__ void load_h8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_h8(float (&v)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// acc[i][g][e] += sum over this warp's LSTM_KW k of the chunk of
// h[row ry + 8 i][k] W[k][gate g, unit 2 ux + e]
template <typename T>
__device__ __forceinline__ void lstm_mac(float (&acc)[4][4][2], const T* hs,
                                         const float* ws, int ry, int ux,
                                         int kw) {
  float hv[4][LSTM_KW];
#pragma unroll
  for (int i = 0; i < 4; ++i) load_h8(hv[i], hs + (ry + 8 * i) * lstm_hld<T>() + kw);
#pragma unroll
  for (int kk = 0; kk < LSTM_KW; ++kk) {
    const float* wk = ws + (kw + kk) * LSTM_COLS + ux * 8;
    const float4 w0 = *reinterpret_cast<const float4*>(wk);
    const float4 w1 = *reinterpret_cast<const float4*>(wk + 4);
    const float w[4][2] = {{w0.x, w0.y}, {w0.z, w0.w}, {w1.x, w1.y},
                           {w1.z, w1.w}};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        acc[i][g][0] = fmaf(hv[i][kk], w[g][0], acc[i][g][0]);
        acc[i][g][1] = fmaf(hv[i][kk], w[g][1], acc[i][g][1]);
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(LSTM_THREADS, 2)
    lstm_step_kernel(const T* __restrict__ xp, const T* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ W,
                     const float* __restrict__ bias, T* __restrict__ new_h,
                     float* __restrict__ new_c, float* __restrict__ acts,
                     int B, int H) {
  extern __shared__ __align__(16) unsigned char lstm_smem_raw[];
  const int j0 = blockIdx.x * LSTM_UNITS, b0 = blockIdx.y * LSTM_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = lane / 4, ux = lane % 4;
  auto hs = [&](int st) {
    return reinterpret_cast<T*>(lstm_smem_raw + st * lstm_stage_bytes<T>());
  };
  auto ws = [&](int st) {
    return reinterpret_cast<float*>(lstm_smem_raw +
                                    st * lstm_stage_bytes<T>() +
                                    sizeof(T) * LSTM_ROWS * lstm_hld<T>());
  };

  float acc[4][4][2] = {};
  const int nchunks = (H + LSTM_KC - 1) / LSTM_KC;
#pragma unroll
  for (int st = 0; st < LSTM_STAGES - 1; ++st) {
    if (st < nchunks) {
      lstm_stage<T, VEC>(hs(st), ws(st), h, W, B, H, b0, j0, st * LSTM_KC);
    }
    cp_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_wait<LSTM_STAGES - 2>();   // chunk ch has landed (this thread's part)
    __syncthreads();              // everyone's, and chunk ch - 1 is done
    const int next = ch + LSTM_STAGES - 1;
    if (next < nchunks) {
      lstm_stage<T, VEC>(hs(next % LSTM_STAGES), ws(next % LSTM_STAGES), h, W,
                         B, H, b0, j0, next * LSTM_KC);
    }
    cp_commit();
    lstm_mac<T>(acc, hs(ch % LSTM_STAGES), ws(ch % LSTM_STAGES), ry, ux,
                warp * LSTM_KW);
  }
  cp_wait<0>();
  __syncthreads();

  // the 8 warps' sums of each (gate, row, unit) meet in shared memory
  float* red = reinterpret_cast<float*>(lstm_smem_raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      *reinterpret_cast<float2*>(
          red + ((warp * 4 + g) * LSTM_ROWS + ry + 8 * i) * LSTM_UNITS +
          2 * ux) = make_float2(acc[i][g][0], acc[i][g][1]);
    }
  }
  __syncthreads();
  const int row = threadIdx.x / LSTM_UNITS, u = threadIdx.x % LSTM_UNITS;
  const int b = b0 + row, j = j0 + u;
  if (b >= B || j >= H) return;
  float gate[4] = {};
#pragma unroll
  for (int w = 0; w < LSTM_WARPS; ++w) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      gate[g] += red[((w * 4 + g) * LSTM_ROWS + row) * LSTM_UNITS + u];
    }
  }
  const T* x = xp + (size_t)b * 4 * H;
  const float gi = sigmoid(to_f(x[j]) + gate[0] + bias[j]);
  const float gf = sigmoid(to_f(x[H + j]) + gate[1] + bias[H + j]);
  const float gg = tanhf(to_f(x[2 * H + j]) + gate[2] + bias[2 * H + j]);
  const float go = sigmoid(to_f(x[3 * H + j]) + gate[3] + bias[3 * H + j]);
  const float cn = gf * c[(size_t)b * H + j] + gi * gg;
  const float tn = tanhf(cn);
  new_h[(size_t)b * H + j] = from_f<T>(go * tn);
  new_c[(size_t)b * H + j] = cn;
  if (acts != nullptr) {
    float* a = acts + (size_t)b * 5 * H;
    a[j] = gi;
    a[H + j] = gf;
    a[2 * H + j] = gg;
    a[3 * H + j] = go;
    a[4 * H + j] = tn;
  }
}

// ---------------------------------------------------------------------------
// B6: GRU step in one cooperative launch
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, GRU_BLOCK_MIN_BLOCKS)
    gru_step_kernel(const T* __restrict__ xp, const T* __restrict__ h,
                    const float* __restrict__ W,
                    const float* __restrict__ bias, float* rh,
                    T* __restrict__ new_h, float* __restrict__ acts, int B,
                    int H) {
  extern __shared__ float smem[];
  const int hs_ld = resident_ld(H);
  float* Hs = smem;                       // [ROWS][hs_ld]
  float* Ws = smem + ROWS * hs_ld;        // [KT][2 * UNITS]
  const int tx = threadIdx.x % UNITS, ty = threadIdx.x / UNITS;
  const int j0 = blockIdx.x * UNITS, b0 = blockIdx.y * ROWS;
  const int j = j0 + tx;

  for (int e = threadIdx.x; e < ROWS * hs_ld; e += THREADS) {
    const int r = e / hs_ld, k = e % hs_ld, b = b0 + r;
    Hs[e] = (b < B && k < H) ? to_f(h[(size_t)b * H + k]) : 0.f;
  }
  __syncthreads();
  float acc[2][RPT] = {};
  gemm_resident<2>(acc, Hs, hs_ld, H, W, 3 * H, 0, j0, H, Ws);

  float z[RPT], hv[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty * RPT + i;
    z[i] = hv[i] = 0.f;
    if (b >= B || j >= H) continue;
    const T* x = xp + (size_t)b * 3 * H;
    z[i] = sigmoid(to_f(x[j]) + acc[0][i] + bias[j]);
    const float r = sigmoid(to_f(x[H + j]) + acc[1][i] + bias[H + j]);
    hv[i] = Hs[(ty * RPT + i) * hs_ld + j];
    rh[(size_t)b * H + j] = r * hv[i];
    if (acts != nullptr) {
      acts[(size_t)b * 3 * H + j] = z[i];
      acts[(size_t)b * 3 * H + H + j] = r;
    }
  }

  cg::this_grid().sync();   // every block's r h tile is written

  // the complete r h rows, read past L1 (other SMs wrote them)
  for (int e = threadIdx.x; e < ROWS * hs_ld; e += THREADS) {
    const int r = e / hs_ld, k = e % hs_ld, b = b0 + r;
    Hs[e] = (b < B && k < H) ? __ldcg(rh + (size_t)b * H + k) : 0.f;
  }
  __syncthreads();
  float accc[1][RPT] = {};
  gemm_resident<1>(accc, Hs, hs_ld, H, W, 3 * H, 2, j0, H, Ws);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty * RPT + i;
    if (b >= B || j >= H) continue;
    const float cc = tanhf(to_f(xp[(size_t)b * 3 * H + 2 * H + j]) +
                           accc[0][i] + bias[2 * H + j]);
    new_h[(size_t)b * H + j] = from_f<T>((1.f - z[i]) * hv[i] + z[i] * cc);
    if (acts != nullptr) acts[(size_t)b * 3 * H + 2 * H + j] = cc;
  }
}

// ---------------------------------------------------------------------------
// B7 + B8: the GRU step in two ordinary launches
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gru_zr_kernel(const T* __restrict__ xp, const T* __restrict__ h,
                  const float* __restrict__ W, const float* __restrict__ bias,
                  float* __restrict__ zrc, float* __restrict__ rh, int B,
                  int H) {
  __shared__ float As[ROWS * AS_LD];
  __shared__ float Ws[KT * 2 * UNITS];
  const int tx = threadIdx.x % UNITS, ty = threadIdx.x / UNITS;
  const int j0 = blockIdx.x * UNITS, b0 = blockIdx.y * ROWS;
  float acc[2][RPT] = {};
  gemm_staged<2>(acc, h, B, b0, H, W, 3 * H, 0, j0, H, As, Ws);
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty * RPT + i;
    if (b >= B) continue;
    const T* x = xp + (size_t)b * 3 * H;
    const float z = sigmoid(to_f(x[j]) + acc[0][i] + bias[j]);
    const float r = sigmoid(to_f(x[H + j]) + acc[1][i] + bias[H + j]);
    zrc[(size_t)b * 3 * H + j] = z;
    zrc[(size_t)b * 3 * H + H + j] = r;
    rh[(size_t)b * H + j] = r * to_f(h[(size_t)b * H + j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    gru_cand_kernel(const float* __restrict__ rh, const T* __restrict__ xp,
                    const float* __restrict__ W,
                    const float* __restrict__ bias, float* __restrict__ zrc,
                    const T* __restrict__ h, T* __restrict__ new_h,
                    int save_c, int B, int H) {
  __shared__ float As[ROWS * AS_LD];
  __shared__ float Ws[KT * UNITS];
  const int tx = threadIdx.x % UNITS, ty = threadIdx.x / UNITS;
  const int j0 = blockIdx.x * UNITS, b0 = blockIdx.y * ROWS;
  float acc[1][RPT] = {};
  gemm_staged<1>(acc, rh, B, b0, H, W, 3 * H, 2, j0, H, As, Ws);
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty * RPT + i;
    if (b >= B) continue;
    const float cc = tanhf(to_f(xp[(size_t)b * 3 * H + 2 * H + j]) +
                           acc[0][i] + bias[2 * H + j]);
    const float z = zrc[(size_t)b * 3 * H + j];
    const float hv = to_f(h[(size_t)b * H + j]);
    new_h[(size_t)b * H + j] = from_f<T>((1.f - z) * hv + z * cc);
    if (save_c) zrc[(size_t)b * 3 * H + 2 * H + j] = cc;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

dim3 grid_of(int B, int H) {
  return dim3((H + UNITS - 1) / UNITS, (B + ROWS - 1) / ROWS);
}

template <typename T, bool VEC>
cudaError_t launch_lstm_as(const void* xp, const void* h, const void* c,
                           const void* w, const void* b, void* nh, void* nc,
                           void* acts, int B, int H, cudaStream_t s) {
  auto kernel = lstm_step_kernel<T, VEC>;
  static bool attr_set = false;   // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)lstm_smem<T>());
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((H + LSTM_UNITS - 1) / LSTM_UNITS,
                  (B + LSTM_ROWS - 1) / LSTM_ROWS);
  kernel<<<grid, LSTM_THREADS, lstm_smem<T>(), s>>>(
      static_cast<const T*>(xp), static_cast<const T*>(h),
      static_cast<const float*>(c), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(nh),
      static_cast<float*>(nc), static_cast<float*>(acts), B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lstm(const void* xp, const void* h, const void* c,
                        const void* w, const void* b, void* nh, void* nc,
                        void* acts, int B, int H, cudaStream_t s) {
  if (B <= 0 || H <= 0 || B > 65535 * LSTM_ROWS) return cudaErrorInvalidValue;
  // rows of h (bf16) and W and their unit pairs 16- and 8-byte aligned
  const bool aligned = ((reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  if (H % 8 == 0 && aligned) {
    return launch_lstm_as<T, true>(xp, h, c, w, b, nh, nc, acts, B, H, s);
  }
  return launch_lstm_as<T, false>(xp, h, c, w, b, nh, nc, acts, B, H, s);
}

template <typename T>
cudaError_t gru_block_capacity(int H, int* capacity) {
  const size_t smem = gru_block_smem(H);
  cudaError_t e = cudaFuncSetAttribute(
      gru_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    gru_step_kernel<T>,
                                                    THREADS, smem);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *capacity = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_gru_step(const void* xp, const void* h, const void* w,
                            const void* b, void* rh, void* nh, void* acts,
                            int B, int H, cudaStream_t s) {
  size_t smem = gru_block_smem(H);
  cudaError_t e = cudaFuncSetAttribute(
      gru_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const T* xp_ = static_cast<const T*>(xp);
  const T* h_ = static_cast<const T*>(h);
  const float* w_ = static_cast<const float*>(w);
  const float* b_ = static_cast<const float*>(b);
  float* rh_ = static_cast<float*>(rh);
  T* nh_ = static_cast<T*>(nh);
  float* acts_ = static_cast<float*>(acts);
  void* args[] = {&xp_, &h_, &w_, &b_, &rh_, &nh_, &acts_, &B, &H};
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that is not
  // co-resident rather than launching it
  e = cudaLaunchCooperativeKernel((const void*)gru_step_kernel<T>,
                                  grid_of(B, H), dim3(THREADS), args, smem,
                                  s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gru_zr(const void* xp, const void* h, const void* w,
                          const void* b, void* zrc, void* rh, int B, int H,
                          cudaStream_t s) {
  gru_zr_kernel<T><<<grid_of(B, H), THREADS, 0, s>>>(
      static_cast<const T*>(xp), static_cast<const T*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(zrc), static_cast<float*>(rh), B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gru_cand(const void* rh, const void* xp, const void* w,
                            const void* b, void* zrc, const void* h,
                            void* nh, int save_c, int B, int H,
                            cudaStream_t s) {
  gru_cand_kernel<T><<<grid_of(B, H), THREADS, 0, s>>>(
      static_cast<const float*>(rh), static_cast<const T*>(xp),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(zrc), static_cast<const T*>(h),
      static_cast<T*>(nh), save_c, B, H);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of xp, h and h').  Pointers to device
// memory, contiguous; acts may be null.  stream: a cudaStream_t.
extern "C" {

int rnn_lstm_step(const void* xp, const void* h, const void* c,
                  const void* w, const void* b, void* new_h, void* new_c,
                  void* acts, int B, int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_lstm<float>(xp, h, c, w, b, new_h, new_c, acts, B, H, s);
  if (dtype == 1)
    return launch_lstm<bf16>(xp, h, c, w, b, new_h, new_c, acts, B, H, s);
  return cudaErrorInvalidValue;
}

// How many B6 blocks the card holds at once at this H (the cooperative
// grid's limit): blocks an SM holds by registers, threads and shared
// memory, times the SMs.
int rnn_gru_block_capacity(int H, int dtype, int* capacity) {
  if (dtype == 0) return gru_block_capacity<float>(H, capacity);
  if (dtype == 1) return gru_block_capacity<bf16>(H, capacity);
  return cudaErrorInvalidValue;
}

int rnn_gru_step(const void* xp, const void* h, const void* w, const void* b,
                 void* rh_scratch, void* new_h, void* acts, int B, int H,
                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gru_step<float>(xp, h, w, b, rh_scratch, new_h, acts, B,
                                  H, s);
  if (dtype == 1)
    return launch_gru_step<bf16>(xp, h, w, b, rh_scratch, new_h, acts, B, H,
                                 s);
  return cudaErrorInvalidValue;
}

int rnn_gru_zr(const void* xp, const void* h, const void* w, const void* b,
               void* zrc, void* rh, int B, int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_gru_zr<float>(xp, h, w, b, zrc, rh, B, H, s);
  if (dtype == 1) return launch_gru_zr<bf16>(xp, h, w, b, zrc, rh, B, H, s);
  return cudaErrorInvalidValue;
}

int rnn_gru_cand(const void* rh, const void* xp, const void* w, const void* b,
                 void* zrc, const void* h, void* new_h, int save_c, int B,
                 int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gru_cand<float>(rh, xp, w, b, zrc, h, new_h, save_c, B, H,
                                  s);
  if (dtype == 1)
    return launch_gru_cand<bf16>(rh, xp, w, b, zrc, h, new_h, save_c, B, H,
                                 s);
  return cudaErrorInvalidValue;
}

const char* rnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
