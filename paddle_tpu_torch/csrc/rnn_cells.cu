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
// card that would fill 1-5 of 132 SMs.  So a block owns 16 hidden units
// (all gates of them, so the gate math stays in registers) by 16 batch
// rows: 8 x 16 = 128 threads, thread (ty, tx) owns unit tx and rows
// 2 ty, 2 ty + 1, and keeps NG x 2 f32 sums (NG = 4 gates for the LSTM,
// 2 for z/r, 1 for the candidate).  At B 64, H 512 that is 128 blocks.
// The K axis is taken in chunks of 32: the block stages the chunk of its
// h rows ([16][33], padded against bank conflicts) and of its W_h columns
// ([32][NG * 16]) in shared memory, coalesced, then every thread sums.
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
// work: wider thread tiles and cp.async pipelining of the chunks.
//
// Plain C interface (built by paddle_tpu_torch/kernels/build.py with nvcc,
// loaded with ctypes): each entry returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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
// B5: LSTM step
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lstm_step_kernel(const T* __restrict__ xp, const T* __restrict__ h,
                     const float* __restrict__ c, const float* __restrict__ W,
                     const float* __restrict__ bias, T* __restrict__ new_h,
                     float* __restrict__ new_c, float* __restrict__ acts,
                     int B, int H) {
  __shared__ float As[ROWS * AS_LD];
  __shared__ float Ws[KT * 4 * UNITS];
  const int tx = threadIdx.x % UNITS, ty = threadIdx.x / UNITS;
  const int j0 = blockIdx.x * UNITS, b0 = blockIdx.y * ROWS;
  float acc[4][RPT] = {};
  gemm_staged<4>(acc, h, B, b0, H, W, 4 * H, 0, j0, H, As, Ws);
  const int j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty * RPT + i;
    if (b >= B) continue;
    const T* x = xp + (size_t)b * 4 * H;
    const float gi = sigmoid(to_f(x[j]) + acc[0][i] + bias[j]);
    const float gf = sigmoid(to_f(x[H + j]) + acc[1][i] + bias[H + j]);
    const float gg = tanhf(to_f(x[2 * H + j]) + acc[2][i] + bias[2 * H + j]);
    const float go = sigmoid(to_f(x[3 * H + j]) + acc[3][i] + bias[3 * H + j]);
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

template <typename T>
cudaError_t launch_lstm(const void* xp, const void* h, const void* c,
                        const void* w, const void* b, void* nh, void* nc,
                        void* acts, int B, int H, cudaStream_t s) {
  lstm_step_kernel<T><<<grid_of(B, H), THREADS, 0, s>>>(
      static_cast<const T*>(xp), static_cast<const T*>(h),
      static_cast<const float*>(c), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(nh),
      static_cast<float*>(nc), static_cast<float*>(acts), B, H);
  return cudaGetLastError();
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
