// The Mamba2 SSD chunked scan (ssd_fwd) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// Replaces src/repro/kernels/ssd/kernel.py:73 ssd_fwd (body _ssd_kernel at
// :24).  For a batch row b and head h, with A = -exp(a_log) and chunks of l
// tokens, per chunk:
//
//   a_cum[t] = sum_{s<=t} dt[s]*A                  (inclusive, in the chunk)
//   y[t][p]  = sum_{s<=t} (C[t].B[s]) exp(a_cum[t]-a_cum[s]) dt[s] x[s][p]
//            + exp(a_cum[t]) sum_n C[t][n] state[p][n]
//   state    <- exp(a_cum[l-1]) state
//            + sum_s B[s] exp(a_cum[l-1]-a_cum[s]) dt[s] x[s][p]
//
// with the (P, N) f32 state carried across the chunks in order, from zero.
// B and C have G groups; head h reads group h / (H/G).
//
// What bounds it on an H100 SXM.  Per (chunk, head) the three chunk products
// take 2*l*l*N + 2*l*l*P + 4*l*N*P FLOPs (the scores C.B^T, the scores times
// x*dt, and the state read and update); the inputs are read once and y (f32)
// written once.  At mamba2-130m's shapes (l = 128, N = 128, P = 64) that is
// about 168 FLOPs per byte moved, so the kernel is bound by operations.  It
// runs them on the CUDA cores in f32 (bf16 inputs are widened when they are
// loaded), so its bound is the f32 peak, 67 TFLOP/s, not a tensor-core rate.
//
// Design.  The TPU kernel walks the chunks of a batch row on the sequential
// grid and keeps the state in VMEM between grid steps.  Blocks on Hopper run
// in no order, so here one block owns one (batch row, head, 16-column slice of
// P) and walks all the chunks itself, carrying its (16, N) slice of the state
// in registers (and a copy in shared memory for the read).  Nothing is carried
// between blocks.  Per chunk the block stages B and C (as f32, rows padded to
// N+1 floats so that column reads hit distinct banks), x*dt for its 16
// columns and the chunk's a_cum (a warp-shuffle scan) in shared memory, then
//   1. forms the l x l scores with an 8x8 register tile per thread and masks
//      the upper triangle BEFORE exp: a_cum[t]-a_cum[s] is positive there and
//      exp would overflow, so those scores are selected to 0, never
//      multiplied by a mask;
//   2. multiplies the scores by x*dt and adds C.state*exp(a_cum), one output
//      column and 8 rows per thread, and writes y;
//   3. updates its state slice in registers, and after a barrier publishes it.
// The three products are plain FMA loops over shared memory.  About 212 KB of
// dynamic shared memory (N = 128) leaves one block per SM.
//
// What this simple design leaves on the table (later work): C.B^T is formed
// again by every 16-column block and every head of a group (P/16 * H/G = 96
// times per chunk at mamba2-130m, where G = 1) instead of once per group; the
// scores include the masked upper triangle; and the products run on CUDA
// cores, not wgmma.  A block per (row, head, P-slice) gives P/16 * H * B
// blocks: 96 at batch 1, which leaves 36 of the 132 SMs idle.
//
// The launch goes on the stream the caller passes (PyTorch's current stream);
// the kernel allocates nothing and does not synchronise.  ssd_fwd returns the
// error of cudaFuncSetAttribute if the shared-memory size is refused, else the
// value of cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 128;       // largest chunk
constexpr int kPT = 16;       // columns of P per block
constexpr int kNMax = 128;    // largest state size
constexpr int kLdS = kL + 1;  // padded row of the score tile
// state entries per thread: kPT * N / kThreads, at most this many
constexpr int kStateRegs = kPT * kNMax / kThreads;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int n) {
  const size_t ld = static_cast<size_t>(n) + 1;
  const size_t floats = 2 * kL * ld      // B, C
                        + kL * kLdS      // scores
                        + kL * kPT       // x * dt
                        + kPT * ld       // state
                        + 4 * kL;        // dt, a_cum, w, exp(a_cum)
  return floats * sizeof(float);
}

// x: [rows, S, H, P]; dt: [rows, S, H] f32; a_log: [H] (row stride 0) or
// [rows, H] (row stride H) f32; B, C: [rows, S, G, N]; y: [rows, S, H, P] f32.
// Requires P % kPT == 0, N a power of two <= kNMax, chunk <= kL and
// S % chunk == 0 (the wrapper checks).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_fwd_kernel(float* __restrict__ y, const T* __restrict__ x,
                   const float* __restrict__ dt,
                   const float* __restrict__ a_log, int64_t alog_stride,
                   const T* __restrict__ bmat, const T* __restrict__ cmat,
                   int S, int H, int P, int G, int N, int chunk) {
  extern __shared__ float smem[];
  const int ld = N + 1;
  float* sB = smem;                  // [kL][ld]
  float* sC = sB + kL * ld;          // [kL][ld]
  float* sScore = sC + kL * ld;      // [kL][kLdS]
  float* sX = sScore + kL * kLdS;    // [kL][kPT]  x * dt
  float* sState = sX + kL * kPT;     // [kPT][ld]
  float* sDt = sState + kPT * ld;    // [kL]
  float* sAcum = sDt + kL;           // [kL]
  float* sW = sAcum + kL;            // [kL]  exp(a_cum[l-1] - a_cum[s])
  float* sDecay = sW + kL;           // [kL]  exp(a_cum[t])

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int g = h / (H / G);
  const float A = -expf(a_log[b * alog_stride + h]);

  // the state entries this thread updates: column n, rows pbase + r*pstep
  const int n_own = tid % N;
  const int pbase = tid / N;
  const int pstep = kThreads / N;
  float st[kStateRegs];
#pragma unroll
  for (int r = 0; r < kStateRegs; ++r) st[r] = 0.0f;
  for (int i = tid; i < kPT * ld; i += kThreads) sState[i] = 0.0f;

  const int nchunks = S / chunk;
  for (int c = 0; c < nchunks; ++c) {
    const int64_t tok0 = b * S + static_cast<int64_t>(c) * chunk;
    __syncthreads();  // the previous chunk's readers are done

    // stage B and C of group g as f32
    for (int i = tid; i < chunk * N; i += kThreads) {
      const int s = i / N, n = i - s * N;
      const int64_t src = ((tok0 + s) * G + g) * N + n;
      sB[s * ld + n] = to_f32(bmat[src]);
      sC[s * ld + n] = to_f32(cmat[src]);
    }
    // dt and the inclusive scan of a = dt*A: warp 0, four tokens a lane
    if (tid < 32) {
      constexpr int kPer = kL / 32;
      float v[kPer];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int s = tid * kPer + k;
        const float d = s < chunk ? dt[(tok0 + s) * H + h] : 0.0f;
        sDt[s] = d;
        run += d * A;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < kPer; ++k) sAcum[tid * kPer + k] = excl + v[k];
    }
    __syncthreads();
    const float acum_end = sAcum[chunk - 1];
    for (int i = tid; i < chunk * kPT; i += kThreads) {
      const int s = i / kPT, p = i - s * kPT;
      sX[i] = to_f32(x[((tok0 + s) * H + h) * P + p0 + p]) * sDt[s];
    }
    for (int s = tid; s < kL; s += kThreads) {
      sW[s] = expf(acum_end - sAcum[s]);
      sDecay[s] = expf(sAcum[s]);
    }
    __syncthreads();

    // 1. scores[t][s] = (C[t].B[s]) exp(a_cum[t]-a_cum[s]) for s <= t < l
    {
      const int ti = tid >> 4, si = tid & 15;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = sC[(ti + 16 * i) * ld + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sB[(si + 16 * j) * ld + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ti + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = si + 16 * j;
          // a select, not a product with a mask: exp may be inf above the
          // diagonal, and inf * 0 is NaN
          sScore[t * kLdS + s] =
              (s <= t && t < chunk) ? acc[i][j] * expf(sAcum[t] - sAcum[s])
                                    : 0.0f;
        }
      }
    }
    __syncthreads();

    // 2. y = scores . (x*dt) + exp(a_cum) * (C . state), one column p and
    //    rows tg + 16 i per thread
    {
      const int p = tid & 15, tg = tid >> 4;
      float acc[8], acc2[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = acc2[i] = 0.0f;
      for (int s = 0; s < chunk; ++s) {
        const float xv = sX[s * kPT + p];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = fmaf(sScore[(tg + 16 * i) * kLdS + s], xv, acc[i]);
      }
      for (int n = 0; n < N; ++n) {
        const float sv = sState[p * ld + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc2[i] = fmaf(sC[(tg + 16 * i) * ld + n], sv, acc2[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = tg + 16 * i;
        if (t < chunk) {
          y[((tok0 + t) * H + h) * P + p0 + p] = acc[i] + sDecay[t] * acc2[i];
        }
      }
    }

    // 3. the state slice: decay it by the whole chunk and add the chunk's
    //    B-weighted x*dt, in registers while other threads still read sState
    {
      float add[kStateRegs];
#pragma unroll
      for (int r = 0; r < kStateRegs; ++r) add[r] = 0.0f;
      for (int s = 0; s < chunk; ++s) {
        const float bw = sB[s * ld + n_own] * sW[s];
#pragma unroll
        for (int r = 0; r < kStateRegs; ++r) {
          const int p = pbase + r * pstep;
          if (p < kPT) add[r] = fmaf(bw, sX[s * kPT + p], add[r]);
        }
      }
      const float total = expf(acum_end);
#pragma unroll
      for (int r = 0; r < kStateRegs; ++r) st[r] = fmaf(st[r], total, add[r]);
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int r = 0; r < kStateRegs; ++r) {
      const int p = pbase + r * pstep;
      if (p < kPT) sState[p * ld + n_own] = st[r];
    }
  }
}

template <typename T>
int launch(float* y, const void* x, const float* dt, const float* a_log,
           int64_t alog_stride, const void* bmat, const void* cmat, int rows,
           int S, int H, int P, int G, int N, int chunk, cudaStream_t stream) {
  const size_t bytes = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(P / kPT, H, rows);
  ssd_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      y, static_cast<const T*>(x), dt, a_log, alog_stride,
      static_cast<const T*>(bmat), static_cast<const T*>(cmat), S, H, P, G,
      N, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 for f32 x/B/C, 1 for bf16.  Returns cudaErrorInvalidValue for a
// dtype code or a shape the kernel does not take.
int ssd_fwd(void* y, const void* x, const void* dt, const void* a_log,
            int64_t alog_stride, const void* bmat, const void* cmat,
            int rows, int S, int H, int P, int G, int N, int chunk, int dtype,
            void* stream) {
  if (rows <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      P % kPT != 0 || N <= 0 || N > kNMax || (kThreads % N) != 0 ||
      chunk <= 0 || chunk > kL || S % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* yy = static_cast<float*>(y);
  const float* d = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return launch<float>(yy, x, d, al, alog_stride, bmat, cmat, rows, S, H,
                         P, G, N, chunk, st);
  }
  if (dtype == kBF16) {
    return launch<__nv_bfloat16>(yy, x, d, al, alog_stride, bmat, cmat, rows,
                                 S, H, P, G, N, chunk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
