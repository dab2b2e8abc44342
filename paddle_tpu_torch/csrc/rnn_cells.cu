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
//   f32 FMA on the CUDA cores (no TF32: it would change the numbers; 3xTF32
//   on mma.sync keeps them, but for B6 and B7 at the training shapes it ran
//   slower than these FMAs on an H100).
//
// What bounds it on the H100: one step at the training shapes (B 64, H 512)
// is a [64, 512] x [512, 2048] f32 product, 134 MFLOP, 2.0 us at the 67
// TFLOP/s f32 peak, against ~5.9 MB of operands (1.8 us at 3.35 TB/s): so
// operations, at the scale of a launch.  W_h (4.2 MB at H 512, 26 MB at
// H 1280) stays in the 50 MB L2 from one step to the next.  The GRU's two
// products are 67 + 34 MFLOP at H 512 (B6), and 419 MFLOP for B7's z and r
// and 210 for B8's candidate at H 1280 (3.1 us at the f32 peak); past the
// bound, what a launch pays is the traffic from L2
// (every block streams all H of its rows: B H (H / U) x 4 bytes of rows a
// product, and W_h once per 32 batch rows) and the latency of a short
// chain of dependent steps.
//
// Design: the TPU runs 1-5 large hidden tiles in a sequential grid; on the
// card that would fill 1-5 of 132 SMs.  So blocks tile the hidden units,
// each owning all gates of its units so the gate math stays in registers.
// B5 and B6-B8 have one design of main loop, written out twice (B5's at its
// kernel, the GRU's at B6): 256-thread blocks of 32 batch rows, K streamed
// in chunks of 64 through a 4-stage cp.async ring (the block's rows of h,
// or of r h, and its W_h columns), K split across the 8 warps inside the
// block, register micro-tiles fed by 16-byte shared loads, and the warps'
// sums reduced through shared memory before the gate math in registers.
// The GRU's loop is written once for NG gates of U units, NG x U <= 16 W
// columns a block: NG = 2, U = 8 (z and r: phase 1 of B6, and B7) and
// NG = 1, U = 8 (the candidate: phase 2 of B6) or U = 16 (the candidate:
// B8).  B8's 16-unit tile keeps the 16 sums a thread of B7's and the same
// ring, and streams each block's r h rows once per 16 units, not 8: at
// B 64, H 1280 ~26 MB of rows and ~13 MB of W_c from L2 a launch.  Its
// (80, 2) tiles would leave most SMs one block and some two, so each
// tile's K is split between a cluster of GRU_CAND_SPLITS = 2 blocks (an
// (80, 2, 2) grid, 3 blocks an SM: one wave, the same bytes): the second
// block hands its sums to the first through distributed shared memory,
// and the first does the epilogue.
//
// B6 has the GRU's coupling: the candidate of every unit needs r h of all
// H units.  The TPU holds one whole block; here B6 is one cooperative
// launch (cudaLaunchCooperativeKernel) with a grid-wide sync between the
// two phases.  Phase 1 streams h and W_zr through the ring, sums z and r of
// the block's 32 x 8 tile and writes its r h tile to a scratch buffer; the
// block then puts W_c's first chunks in flight (they do not depend on
// r h), syncs the grid, streams the complete r h rows through the same
// ring with cp.async.cg (read through L2: other SMs wrote them) and
// computes c and h' of the same units, with z and h still in registers.
// The epilogues' xp, bias and h values are fetched before phase 1.  A
// cooperative grid must be co-resident: the ring's 51,200 bytes (the same
// at every H) and at most 128 registers a thread (__launch_bounds__(256,
// 2)) let an SM hold 2 blocks or more, and rnn_gru_block_capacity reports
// the card's answer.  The Python gate (ops/rnn.py) takes B6 where JAX's
// plan is its one block and the grid fits, and B7 + B8 otherwise; B7 (B6's
// phase 1 alone, h streamed the same way) and B8 (clusters of 2 blocks)
// need no co-resident grid and take any shape.
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
// B6, B7 and B8: the GRU's main loop
//
// A block of GRU_THREADS = 256 threads owns GRU_ROWS = 32 batch rows by U
// hidden units, NG gate columns of each unit, NG x U <= GRU_COLS = 16 W
// columns (NG = 2, U = 8: z and r, in B6 and B7; NG = 1: the candidate, U = 8
// in B6 and 16 in B8): B7 has 320 blocks at B 64, H 1280, B8 160.  K streams
// through a ring of GRU_STAGES chunks of GRU_KC = 64 in shared memory.  A
// stage holds the chunk of the block's 32 A rows ([row][k], h or r h, the row
// stride padded by 16 bytes so the 8 rows of a read sit in 8 bank groups) and
// of its 16 W columns ([k][gate][unit]), both filled by 16-byte cp.async.cg
// (zero-filled past B and H), one barrier a chunk.  Each of the 8 warps takes
// 8 k of every chunk: lane (ry, ux) keeps rows ry + 8 i (i < 4) by units U / 4
// ux .. + U / 4 of each gate, NG U f32 sums (16 in B7 and B8), reading its
// rows as 16-byte words and W as one U-byte word a gate and k: 8 + 8 NG shared
// loads per 64 NG U / 4 FMAs (the lanes that share a row or a unit group read
// one address).  After the loop the warps' sums meet in shared memory (the
// ring, reused) and thread tid adds the 8 slices of its NG gates at (row,
// unit) = ((tid + 256 p) / U, tid % U), p < U / 8.  H not a multiple of 8, or
// h, W_h or r h not 16-byte aligned, stages through registers instead of
// cp.async, with the same loop.
// ---------------------------------------------------------------------------

constexpr int GRU_ROWS = 32;
constexpr int GRU_UNITS = 8;                     // B6 and B7
constexpr int GRU_CAND_UNITS = 16;               // B8
constexpr int GRU_COLS = 16;                     // NG x U, W columns a block
constexpr int GRU_WARPS = 8;
constexpr int GRU_THREADS = 32 * GRU_WARPS;      // 256
constexpr int GRU_KC = 64;                       // K chunk
constexpr int GRU_KW = GRU_KC / GRU_WARPS;       // k of a chunk a warp takes
constexpr int GRU_STAGES = 4;
// launch bounds: B7 at most 80 registers a thread, so an SM holds 3 of its
// blocks and its 320 blocks at H 1280 run in one wave; B6 (128 blocks at
// the training shape, one an SM) at most 128, 2 blocks an SM: the
// registers buy more products in flight (and no spills) and the card still
// holds 264 blocks at once, twice the grid; B8 (320 blocks at H 1280) at
// 3 blocks an SM, as B7, holds its grid in one wave
constexpr int GRU_ZR_MIN_BLOCKS = 3;
constexpr int GRU_STEP_MIN_BLOCKS = 2;
constexpr int GRU_CAND_MIN_BLOCKS = 3;
// blocks (a cluster) that share the K axis of a B8 tile
constexpr int GRU_CAND_SPLITS = 2;

// row stride of a staged A chunk, in elements: the chunk plus 16 bytes
template <typename T>
__host__ __device__ constexpr int gru_ald() {
  return GRU_KC + 16 / static_cast<int>(sizeof(T));
}

// a stage: the A chunk, sized for f32 rows (B6's phase 2 and B8 stream f32
// r h under a bf16 h), then the chunk of the block's 16 W columns
constexpr size_t GRU_A_BYTES = sizeof(float) * GRU_ROWS * gru_ald<float>();
constexpr size_t GRU_STAGE_BYTES =
    GRU_A_BYTES + sizeof(float) * GRU_KC * GRU_COLS;
constexpr size_t GRU_SMEM = GRU_STAGES * GRU_STAGE_BYTES;   // 51,200 bytes
static_assert(GRU_SMEM >= sizeof(float) * GRU_WARPS * GRU_ROWS * GRU_COLS,
              "the ring holds the warps' sums");
// B8: past the ring, the sums the cluster's other blocks hand the first
constexpr size_t GRU_CAND_SMEM =
    GRU_SMEM + sizeof(float) * (GRU_CAND_SPLITS - 1) * GRU_ROWS *
                   GRU_CAND_UNITS;

__host__ __device__ constexpr int gru_chunks(int H) {
  return (H + GRU_KC - 1) / GRU_KC;
}

template <typename TA>
__device__ __forceinline__ TA* gru_a(unsigned char* ring, int st) {
  return reinterpret_cast<TA*>(ring + st * GRU_STAGE_BYTES);
}

__device__ __forceinline__ float* gru_w(unsigned char* ring, int st) {
  return reinterpret_cast<float*>(ring + st * GRU_STAGE_BYTES + GRU_A_BYTES);
}

// A element by element: f32 through L2 (B6's phase 2 reads r h that other
// SMs wrote in this launch)
__device__ __forceinline__ float gru_ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 gru_ld(const bf16* p) { return *p; }

// Chunk k0 .. k0 + GRU_KC of rows b0 .. b0 + GRU_ROWS of A ([B, H]) into
// as[row][k]; zeros outside.
template <typename TA, bool VEC>
__device__ __forceinline__ void gru_copy_a(TA* as, const TA* A, int B, int H,
                                           int b0, int k0) {
  if constexpr (VEC) {
    constexpr int VE = 16 / sizeof(TA);              // elements a copy
    constexpr int PER_ROW = GRU_KC / VE;
    for (int e = threadIdx.x; e < GRU_ROWS * PER_ROW; e += GRU_THREADS) {
      const int row = e / PER_ROW, kk = (e % PER_ROW) * VE;
      const bool ok = b0 + row < B && k0 + kk < H;
      cp_async<16>(as + row * gru_ald<TA>() + kk,
                   ok ? A + (size_t)(b0 + row) * H + k0 + kk : A, ok);
    }
  } else {
    for (int e = threadIdx.x; e < GRU_ROWS * GRU_KC; e += GRU_THREADS) {
      const int row = e / GRU_KC, kk = e % GRU_KC, b = b0 + row, k = k0 + kk;
      as[row * gru_ald<TA>() + kk] =
          (b < B && k < H) ? gru_ld(A + (size_t)b * H + k) : from_f<TA>(0.f);
    }
  }
}

// Rows k0 .. k0 + GRU_KC of W_h ([H, 3H]), gate columns (goff + g) H + j0
// .. + U for g < NG, into ws[k][g][unit]; zeros outside.
template <int NG, int U, bool VEC>
__device__ __forceinline__ void gru_copy_w(float* ws, const float* W, int H,
                                           int goff, int j0, int k0) {
  static_assert(NG * U <= GRU_COLS, "a stage holds 16 W columns");
  if constexpr (VEC) {
    // U / 4 16-byte pieces a (k, gate); H % 8 == 0, so a piece's 4 units
    // are all < H or all past it
    for (int e = threadIdx.x; e < GRU_KC * NG * U / 4; e += GRU_THREADS) {
      const int kk = e / (NG * U / 4), g = (e / (U / 4)) % NG;
      const int u = 4 * (e % (U / 4));
      const bool ok = k0 + kk < H && j0 + u < H;
      cp_async<16>(ws + (kk * NG + g) * U + u,
                   ok ? W + (size_t)(k0 + kk) * 3 * H + (size_t)(goff + g) * H +
                            j0 + u
                      : W,
                   ok);
    }
  } else {
    for (int e = threadIdx.x; e < GRU_KC * NG * U; e += GRU_THREADS) {
      const int kk = e / (NG * U), g = (e / U) % NG;
      const int k = k0 + kk, j = j0 + e % U;
      ws[e] = (k < H && j < H)
                  ? W[(size_t)k * 3 * H + (size_t)(goff + g) * H + j]
                  : 0.f;
    }
  }
}

// U / 4 consecutive W values of one (k, gate)
template <int N>
__device__ __forceinline__ void load_w(float (&w)[N], const float* p) {
  static_assert(N == 2 || N == 4, "8- or 16-byte words");
  if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
}

// acc[i][g][e] += sum over this warp's GRU_KW k of the chunk of
// A[row ry + 8 i][k] W[k][gate g, unit U / 4 ux + e]
template <int NG, int U, typename TA>
__device__ __forceinline__ void gru_mac(float (&acc)[4][NG][U / 4],
                                        const TA* as, const float* ws, int ry,
                                        int ux, int kw) {
  float av[4][GRU_KW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    load_h8(av[i], as + (ry + 8 * i) * gru_ald<TA>() + kw);
  }
#pragma unroll
  for (int kk = 0; kk < GRU_KW; ++kk) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float w[U / 4];
      load_w(w, ws + ((kw + kk) * NG + g) * U + (U / 4) * ux);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < U / 4; ++e) {
          acc[i][g][e] = fmaf(av[i][kk], w[e], acc[i][g][e]);
        }
      }
    }
  }
}

// W_h's chunks of gate columns goff .. goff + NG into the first
// GRU_STAGES - 1 stages, not committed: they join the loop's first group
template <int NG, int U, bool VEC>
__device__ __forceinline__ void gru_prefetch_w(unsigned char* ring,
                                               const float* W, int H,
                                               int goff, int j0) {
  const int nchunks = gru_chunks(H);
#pragma unroll
  for (int st = 0; st < GRU_STAGES - 1; ++st) {
    if (st < nchunks) {
      gru_copy_w<NG, U, VEC>(gru_w(ring, st), W, H, goff, j0, st * GRU_KC);
    }
  }
}

// acc += A[b0 .. b0 + 32, k] W_h[k, gate columns goff .. goff + NG of
// units j0 .. j0 + U] over the K chunks c0 .. c1 (k from GRU_KC c0), this
// warp's k of each chunk; with w_ready the first stages' W chunks are
// already in flight (gru_prefetch_w, c0 = 0).
template <int NG, int U, typename TA, bool VEC>
__device__ __forceinline__ void gru_k_loop(float (&acc)[4][NG][U / 4],
                                           unsigned char* ring, const TA* A,
                                           const float* W, int B, int H,
                                           int b0, int j0, int goff,
                                           bool w_ready, int c0, int c1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = lane / 4, ux = lane % 4;
  const int nchunks = c1 - c0;
#pragma unroll
  for (int st = 0; st < GRU_STAGES - 1; ++st) {
    if (st < nchunks) {
      const int k0 = (c0 + st) * GRU_KC;
      gru_copy_a<TA, VEC>(gru_a<TA>(ring, st), A, B, H, b0, k0);
      if (!w_ready) {
        gru_copy_w<NG, U, VEC>(gru_w(ring, st), W, H, goff, j0, k0);
      }
    }
    cp_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_wait<GRU_STAGES - 2>();   // chunk ch has landed (this thread's part)
    __syncthreads();             // everyone's, and chunk ch - 1 is done
    const int next = ch + GRU_STAGES - 1;
    if (next < nchunks) {
      const int st = next % GRU_STAGES, k0 = (c0 + next) * GRU_KC;
      gru_copy_a<TA, VEC>(gru_a<TA>(ring, st), A, B, H, b0, k0);
      gru_copy_w<NG, U, VEC>(gru_w(ring, st), W, H, goff, j0, k0);
    }
    cp_commit();
    gru_mac<NG, U, TA>(acc, gru_a<TA>(ring, ch % GRU_STAGES),
                       gru_w(ring, ch % GRU_STAGES), ry, ux, warp * GRU_KW);
  }
  cp_wait<0>();
  __syncthreads();
}

// The warps' sums of each (gate, row, unit) meet in the ring; thread tid
// gets the total of each of its NG gates at (row, unit) = ((tid + 256 p) /
// U, tid % U), p < U / 8.
template <int NG, int U>
__device__ __forceinline__ void gru_reduce(float (&sum)[NG][U / 8],
                                           const float (&acc)[4][NG][U / 4],
                                           unsigned char* ring) {
  float* red = reinterpret_cast<float*>(ring);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = lane / 4, ux = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float* dst = red + ((warp * NG + g) * GRU_ROWS + ry + 8 * i) * U +
                   (U / 4) * ux;
      if constexpr (U == 8) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[i][g][0],
                                                      acc[i][g][1]);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int p = 0; p < U / 8; ++p) {
      sum[g][p] = 0.f;
#pragma unroll
      for (int w = 0; w < GRU_WARPS; ++w) {
        sum[g][p] += red[(w * NG + g) * GRU_ROWS * U + threadIdx.x +
                         GRU_THREADS * p];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B6: GRU step in one cooperative launch
// ---------------------------------------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(GRU_THREADS, GRU_STEP_MIN_BLOCKS)
    gru_step_kernel(const T* __restrict__ xp, const T* __restrict__ h,
                    const float* __restrict__ W,
                    const float* __restrict__ bias, float* rh,
                    T* __restrict__ new_h, float* __restrict__ acts, int B,
                    int H) {
  extern __shared__ __align__(16) unsigned char gru_ring[];
  const int j0 = blockIdx.x * GRU_UNITS, b0 = blockIdx.y * GRU_ROWS;
  const int b = b0 + threadIdx.x / GRU_UNITS;
  const int j = j0 + threadIdx.x % GRU_UNITS;
  const bool live = b < B && j < H;
  // the epilogues' inputs, in flight during phase 1
  float xz = 0.f, xr = 0.f, xc = 0.f, bz = 0.f, br = 0.f, bc = 0.f;
  float hv = 0.f;
  if (live) {
    const T* x = xp + (size_t)b * 3 * H;
    xz = to_f(x[j]);
    xr = to_f(x[H + j]);
    xc = to_f(x[2 * H + j]);
    bz = bias[j];
    br = bias[H + j];
    bc = bias[2 * H + j];
    hv = to_f(h[(size_t)b * H + j]);
  }

  float acc[4][2][2] = {};
  gru_k_loop<2, GRU_UNITS, T, VEC>(acc, gru_ring, h, W, B, H, b0, j0, 0,
                                   false, 0, gru_chunks(H));
  float zr[2][1];
  gru_reduce<2, GRU_UNITS>(zr, acc, gru_ring);
  float z = 0.f;
  if (live) {
    z = sigmoid(xz + zr[0][0] + bz);
    const float r = sigmoid(xr + zr[1][0] + br);
    rh[(size_t)b * H + j] = r * hv;
    if (acts != nullptr) {
      acts[(size_t)b * 3 * H + j] = z;
      acts[(size_t)b * 3 * H + H + j] = r;
    }
  }
  __syncthreads();   // the sums are read: the ring takes W_c's first chunks
  gru_prefetch_w<1, GRU_UNITS, VEC>(gru_ring, W, H, 2, j0);

  cg::this_grid().sync();   // every block's r h tile is written

  float accc[4][1][2] = {};
  gru_k_loop<1, GRU_UNITS, float, VEC>(accc, gru_ring, rh, W, B, H, b0, j0,
                                       2, true, 0, gru_chunks(H));
  float c[1][1];
  gru_reduce<1, GRU_UNITS>(c, accc, gru_ring);
  if (!live) return;
  const float cc = tanhf(xc + c[0][0] + bc);
  new_h[(size_t)b * H + j] = from_f<T>((1.f - z) * hv + z * cc);
  if (acts != nullptr) acts[(size_t)b * 3 * H + 2 * H + j] = cc;
}

// ---------------------------------------------------------------------------
// B7 + B8: the GRU step in two ordinary launches
// ---------------------------------------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(GRU_THREADS, GRU_ZR_MIN_BLOCKS)
    gru_zr_kernel(const T* __restrict__ xp, const T* __restrict__ h,
                  const float* __restrict__ W, const float* __restrict__ bias,
                  float* __restrict__ zrc, float* __restrict__ rh, int B,
                  int H) {
  extern __shared__ __align__(16) unsigned char gru_ring[];
  const int j0 = blockIdx.x * GRU_UNITS, b0 = blockIdx.y * GRU_ROWS;
  const int b = b0 + threadIdx.x / GRU_UNITS;
  const int j = j0 + threadIdx.x % GRU_UNITS;
  const bool live = b < B && j < H;
  // the epilogue's inputs, in flight during the loop
  float xz = 0.f, xr = 0.f, bz = 0.f, br = 0.f, hv = 0.f;
  if (live) {
    const T* x = xp + (size_t)b * 3 * H;
    xz = to_f(x[j]);
    xr = to_f(x[H + j]);
    bz = bias[j];
    br = bias[H + j];
    hv = to_f(h[(size_t)b * H + j]);
  }
  float acc[4][2][2] = {};
  gru_k_loop<2, GRU_UNITS, T, VEC>(acc, gru_ring, h, W, B, H, b0, j0, 0,
                                   false, 0, gru_chunks(H));
  float zr[2][1];
  gru_reduce<2, GRU_UNITS>(zr, acc, gru_ring);
  if (!live) return;
  const float z = sigmoid(xz + zr[0][0] + bz);
  const float r = sigmoid(xr + zr[1][0] + br);
  zrc[(size_t)b * 3 * H + j] = z;
  zrc[(size_t)b * 3 * H + H + j] = r;
  rh[(size_t)b * H + j] = r * hv;
}

// cluster barriers of every thread of the cluster's blocks: arrive
// (relaxed: no memory to publish), and arrive then wait, publishing what
// was written before
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// B8: block z of a cluster of GRU_CAND_SPLITS takes K chunks
// [z n / S, (z + 1) n / S) of the tile's (80, 2) place in the grid; thread
// tid owns unit j0 + tid % 16 of rows b0 + tid / 16 and b0 + tid / 16 + 16,
// the (row, unit) pairs gru_reduce<1, 16> hands it.  Blocks z > 0 write
// their sums into block 0's shared memory past its ring; block 0 adds them
// and does the epilogue.
template <typename T, bool VEC>
__global__ void __cluster_dims__(1, 1, GRU_CAND_SPLITS)
    __launch_bounds__(GRU_THREADS, GRU_CAND_MIN_BLOCKS)
    gru_cand_kernel(const float* __restrict__ rh, const T* __restrict__ xp,
                    const float* __restrict__ W,
                    const float* __restrict__ bias, float* zrc,
                    const T* __restrict__ h, T* __restrict__ new_h,
                    int save_c, int B, int H) {
  constexpr int U = GRU_CAND_UNITS, P = U / 8;   // (row, unit) pairs a thread
  extern __shared__ __align__(16) unsigned char gru_ring[];
  cluster_arrive_relaxed();   // this block runs: its shared memory exists
  const int j0 = blockIdx.x * U, b0 = blockIdx.y * GRU_ROWS;
  const int z = blockIdx.z;   // the block's rank in its cluster
  const int j = j0 + threadIdx.x % U;
  // the epilogue's inputs (block 0's), in flight during the loop
  float xc[P] = {}, zv[P] = {}, hv[P] = {}, bc = 0.f;
  if (z == 0 && j < H) {
    bc = bias[2 * H + j];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int b = b0 + (threadIdx.x + GRU_THREADS * p) / U;
      if (b < B) {
        xc[p] = to_f(xp[(size_t)b * 3 * H + 2 * H + j]);
        zv[p] = zrc[(size_t)b * 3 * H + j];
        hv[p] = to_f(h[(size_t)b * H + j]);
      }
    }
  }
  const int n = gru_chunks(H);
  float acc[4][1][U / 4] = {};
  gru_k_loop<1, U, float, VEC>(acc, gru_ring, rh, W, B, H, b0, j0, 2, false,
                               z * n / GRU_CAND_SPLITS,
                               (z + 1) * n / GRU_CAND_SPLITS);
  float c[1][P];
  gru_reduce<1, U>(c, acc, gru_ring);
  float* part = reinterpret_cast<float*>(gru_ring + GRU_SMEM);
  cluster_wait();   // every block of the cluster runs
  if (z > 0) {
    float* dst = cg::this_cluster().map_shared_rank(part, 0) +
                 (z - 1) * GRU_THREADS * P;
#pragma unroll
    for (int p = 0; p < P; ++p) dst[threadIdx.x + GRU_THREADS * p] = c[0][p];
  }
  cluster_sync();   // the sums are in block 0's shared memory
  if (z > 0 || j >= H) return;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    for (int s = 1; s < GRU_CAND_SPLITS; ++s) {
      c[0][p] += part[(s - 1) * GRU_THREADS * P + threadIdx.x +
                      GRU_THREADS * p];
    }
    const int b = b0 + (threadIdx.x + GRU_THREADS * p) / U;
    if (b >= B) continue;
    const float cc = tanhf(xc[p] + c[0][p] + bc);
    new_h[(size_t)b * H + j] =
        from_f<T>((1.f - zv[p]) * hv[p] + zv[p] * cc);
    if (save_c) zrc[(size_t)b * 3 * H + 2 * H + j] = cc;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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

dim3 gru_grid(int B, int H, int units) {
  return dim3((H + units - 1) / units, (B + GRU_ROWS - 1) / GRU_ROWS);
}

// rows of h (bf16: 8 to a 16-byte piece), of W_h and of r h in whole
// 16-byte pieces: the cp.async path
bool gru_vec(int H, const void* h, const void* w, const void* rh) {
  return H % 8 == 0 && ((reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(rh)) % 16) == 0;
}

// The ring's size (and B8's past it) as the dynamic shared memory limit of
// B6, B7 and B8, once per instantiation.
template <typename T, bool VEC>
cudaError_t gru_set_smem() {
  static bool set = false;
  if (set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      gru_step_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)GRU_SMEM);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gru_zr_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GRU_SMEM);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(gru_cand_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GRU_CAND_SMEM);
  }
  set = e == cudaSuccess;
  return e;
}

template <typename T, bool VEC>
cudaError_t gru_step_per_sm(int* per_sm) {
  const cudaError_t e = gru_set_smem<T, VEC>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gru_step_kernel<T, VEC>, GRU_THREADS, GRU_SMEM);
}

// B6 blocks the card holds at once: the lesser of its two paths' blocks
// an SM, times the SMs
template <typename T>
cudaError_t gru_block_capacity(int* capacity) {
  int vec = 0, reg = 0, dev = 0, sms = 0;
  cudaError_t e = gru_step_per_sm<T, true>(&vec);
  if (e == cudaSuccess) e = gru_step_per_sm<T, false>(&reg);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return e;
  *capacity = (vec < reg ? vec : reg) * sms;
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t launch_gru_step_as(const void* xp, const void* h, const void* w,
                               const void* b, void* rh, void* nh, void* acts,
                               int B, int H, cudaStream_t s) {
  const cudaError_t e = gru_set_smem<T, VEC>();
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
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      (const void*)gru_step_kernel<T, VEC>, gru_grid(B, H, GRU_UNITS),
      dim3(GRU_THREADS),
      args, GRU_SMEM, s);
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gru_step(const void* xp, const void* h, const void* w,
                            const void* b, void* rh, void* nh, void* acts,
                            int B, int H, cudaStream_t s) {
  if (B <= 0 || H <= 0 || B > 65535 * GRU_ROWS) return cudaErrorInvalidValue;
  if (gru_vec(H, h, w, rh)) {
    return launch_gru_step_as<T, true>(xp, h, w, b, rh, nh, acts, B, H, s);
  }
  return launch_gru_step_as<T, false>(xp, h, w, b, rh, nh, acts, B, H, s);
}

template <typename T, bool VEC>
cudaError_t launch_gru_zr_as(const void* xp, const void* h, const void* w,
                             const void* b, void* zrc, void* rh, int B,
                             int H, cudaStream_t s) {
  const cudaError_t e = gru_set_smem<T, VEC>();
  if (e != cudaSuccess) return e;
  gru_zr_kernel<T, VEC><<<gru_grid(B, H, GRU_UNITS), GRU_THREADS, GRU_SMEM,
                          s>>>(
      static_cast<const T*>(xp), static_cast<const T*>(h),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(zrc), static_cast<float*>(rh), B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gru_zr(const void* xp, const void* h, const void* w,
                          const void* b, void* zrc, void* rh, int B, int H,
                          cudaStream_t s) {
  if (B <= 0 || H <= 0 || B > 65535 * GRU_ROWS) return cudaErrorInvalidValue;
  if (gru_vec(H, h, w, nullptr)) {
    return launch_gru_zr_as<T, true>(xp, h, w, b, zrc, rh, B, H, s);
  }
  return launch_gru_zr_as<T, false>(xp, h, w, b, zrc, rh, B, H, s);
}

template <typename T, bool VEC>
cudaError_t launch_gru_cand_as(const void* rh, const void* xp, const void* w,
                               const void* b, void* zrc, const void* h,
                               void* nh, int save_c, int B, int H,
                               cudaStream_t s) {
  const cudaError_t e = gru_set_smem<T, VEC>();
  if (e != cudaSuccess) return e;
  dim3 grid = gru_grid(B, H, GRU_CAND_UNITS);
  grid.z = GRU_CAND_SPLITS;   // a cluster a tile (__cluster_dims__)
  gru_cand_kernel<T, VEC><<<grid, GRU_THREADS, GRU_CAND_SMEM, s>>>(
      static_cast<const float*>(rh), static_cast<const T*>(xp),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(zrc), static_cast<const T*>(h),
      static_cast<T*>(nh), save_c, B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gru_cand(const void* rh, const void* xp, const void* w,
                            const void* b, void* zrc, const void* h,
                            void* nh, int save_c, int B, int H,
                            cudaStream_t s) {
  if (B <= 0 || H <= 0 || B > 65535 * GRU_ROWS) return cudaErrorInvalidValue;
  if (gru_vec(H, h, w, rh)) {
    return launch_gru_cand_as<T, true>(rh, xp, w, b, zrc, h, nh, save_c, B, H,
                                       s);
  }
  return launch_gru_cand_as<T, false>(rh, xp, w, b, zrc, h, nh, save_c, B, H,
                                      s);
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

// How many B6 blocks the card holds at once (the cooperative grid's limit,
// the same at every H): blocks an SM holds by registers, threads and
// shared memory, times the SMs.
int rnn_gru_block_capacity(int dtype, int* capacity) {
  if (dtype == 0) return gru_block_capacity<float>(capacity);
  if (dtype == 1) return gru_block_capacity<bf16>(capacity);
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
