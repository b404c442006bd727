// Forward flash attention (flash_attention_fwd) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:69
// flash_attention_fwd (body _flash_kernel at :24).  For batch row b and
// query head h, with kv head h / (Hq / Hkv):
//
//   s[i][j] = cap * tanh((q[i].k[j] * hd^-0.5) / cap)    (cap > 0 only)
//   live    = j <= i and i - window < j (window > 0) and j < S
//   out[i]  = sum_{live j} exp(s[i][j]) v[j] / sum_{live j} exp(s[i][j])
//
// in f32, whatever the storage dtype (f32 or bf16) of q, k, v and out.  The
// mask is always causal: the port runs every other mask in plain PyTorch
// (repro_torch/models/attention.py), so the kernel has no non-causal walk.
//
// What bounds it on an H100 SXM.  Per head it does 4 * hd FLOPs for each
// live (query, key) pair (q.k and p.v); it must read q, k and v once and
// write out once.  At S = 4096 with a window of 1024 that is about a
// thousand FLOPs per byte, so it is bound by operations.  It runs them on
// the CUDA cores in f32, so its bound is the f32 peak, 67 TFLOP/s; the bf16
// tensor cores (989 TFLOP/s, through wgmma) are the later target.
//
// Design.  The TPU kernel walks the key blocks of one query block in a
// fori_loop and keeps the online softmax's (m, l, acc) in VMEM; here one
// block of 256 threads owns one (batch row, query head, 64-row query tile)
// and walks the key tiles itself, with (m, l, acc) in registers.  Nothing is
// carried between blocks.  The block stages its query tile once, transposed
// in shared memory as f32 (bf16 is widened at load); per key tile of 64 rows
// it stages K (transposed) and V, then
//   1. forms the 64 x 64 scores with a 4 x 4 register tile per thread
//      (rows 4ty+i, keys 4tx+j; float4 reads of the transposed tiles);
//   2. scales, caps and masks them -- a masked score is SELECTED to -inf and
//      its weight to exactly 0, never multiplied by a mask -- and updates the
//      online softmax of its 4 rows, reducing over the 16 lanes that share a
//      row with warp shuffles; the weights go to shared memory, read back
//      only by the same warp;
//   3. adds P.V for its 4 rows and hd/16 columns.
// It streams only the key tiles that meet the block's causal cone and
// window: from the tile that holds q0 - window + 1 to the diagonal tile.
// (The TPU kernel streams every tile up to the diagonal.)  A row whose
// first tiles are wholly masked keeps m = -inf and l = 0 until its first
// live key: the rescale factor is then taken as 1, not exp(-inf + inf).
// Shared memory is 3 * 64 * hd + 64 * 64 floats: 64 KB at hd = 64, 112 KB at
// 128, 208 KB at 256 (one block per SM there).  Rows past S are computed
// but not written; keys past S are masked.
//
// What this simple design leaves on the table (later work): the products
// run as f32 FMA loops on the CUDA cores, not wgmma on the tensor cores;
// tiles are staged by every thread with plain loads, not TMA, and not
// double-buffered; the diagonal and window-edge tiles compute their masked
// halves.
//
// The launch goes on the stream the caller passes (PyTorch's current
// stream); the kernel allocates nothing and does not synchronise.
// flash_attention_fwd returns the error of cudaFuncSetAttribute if the
// shared-memory size is refused, else the value of cudaGetLastError() after
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query rows per block, key rows per tile
constexpr int kRows = 4;   // query rows per thread
constexpr int kKeys = 4;   // keys per thread in the score tile

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return (3 * static_cast<size_t>(D) * kTile + kTile * kTile) * sizeof(float);
}

// Rows [row0, row0 + 64) of head `head` of a (rows, S, H, D) tensor, as f32
// transposed: dst[d * 64 + r].  Rows past S are zeros.  A thread reads 4
// consecutive columns of one row; consecutive threads take consecutive rows,
// so the shared-memory writes hit consecutive banks.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(float* dst,
                                                 const T* __restrict__ src,
                                                 int64_t b, int row0, int S,
                                                 int H, int head) {
  const int r = threadIdx.x % kTile;
  const int s = row0 + r;
  for (int g = threadIdx.x / kTile; g < D / 4; g += kThreads / kTile) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < S) load4(src + ((b * S + s) * H + head) * D + 4 * g, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(4 * g + e) * kTile + r] = v[e];
  }
}

// The same rows as f32, row-major: dst[r * D + d].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const T* __restrict__ src,
                                           int64_t b, int row0, int S, int H,
                                           int head) {
  constexpr int kG = D / 4;
  for (int i = threadIdx.x; i < kTile * kG; i += kThreads) {
    const int r = i / kG, g = i - r * kG;
    const int s = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < S) load4(src + ((b * S + s) * H + head) * D + 4 * g, v);
    *reinterpret_cast<float4*>(dst + r * D + 4 * g) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// q, out: [rows, S, Hq, D]; k, v: [rows, S, Hkv, D]; Hq % Hkv == 0 (the
// wrapper checks).  Grid (ceil(S / 64), Hq, rows).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(T* __restrict__ out, const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, int S, int Hq,
                               int Hkv, int window, float softcap,
                               float scale) {
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQt = reinterpret_cast<float*>(smem4);  // [D][64]
  float* sKt = sQt + D * kTile;                  // [D][64]
  float* sV = sKt + D * kTile;                   // [64][D]
  float* sP = sV + D * kTile;                    // [64][64]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys 4tx+j; output columns 64c + 4tx + e
  const int ty = tid / 16;  // rows 4ty+i; the 16 lanes of a row share a warp
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  stage_transposed<T, D>(sQt, q, b, q0, S, Hq, h);

  // the key tiles any row of this block can see
  const int q_last = min(q0 + kTile, S) - 1;
  const int kt_end = q_last / kTile + 1;
  const int kt_begin = window > 0 ? max(q0 - window + 1, 0) / kTile : 0;

  float m[kRows], l[kRows], o[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // Q is staged; the previous tile's readers are done
    stage_transposed<T, D>(sKt, k, b, k0, S, Hkv, hk);
    stage_rows<T, D>(sV, v, b, k0, S, Hkv, hk);
    __syncthreads();

    // 1. raw scores q.k of rows 4ty+i against keys 4tx+j
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(sQt + d * kTile +
                                                         4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(sKt + d * kTile +
                                                         4 * tx);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // 2. scale, cap, mask; the online softmax of rows 4ty+i
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = k0 + 4 * tx + j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool live =
            kj < S && kj <= qi && (window <= 0 || kj > qi - window);
        s[i][j] = live ? x : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      // no live key yet: nothing to rescale (exp(-inf + inf) would be NaN)
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        // a select: a masked key weighs exactly 0
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
      *reinterpret_cast<float4*>(sP + (4 * ty + i) * kTile + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncwarp();  // a row's weights are written and read by one warp

    // 3. o += P.V over the tile's keys, 4 at a time
#pragma unroll 2
    for (int c4 = 0; c4 < kTile; c4 += 4) {
      float p[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(
            sP + (4 * ty + i) * kTile + c4);
        p[i][0] = pv.x;
        p[i][1] = pv.y;
        p[i][2] = pv.z;
        p[i][3] = pv.w;
      }
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) {
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              sV + (c4 + e2) * D + 64 * cc + 4 * tx);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            o[i][4 * cc + 0] = fmaf(p[i][e2], vv.x, o[i][4 * cc + 0]);
            o[i][4 * cc + 1] = fmaf(p[i][e2], vv.y, o[i][4 * cc + 1]);
            o[i][4 * cc + 2] = fmaf(p[i][e2], vv.z, o[i][4 * cc + 2]);
            o[i][4 * cc + 3] = fmaf(p[i][e2], vv.w, o[i][4 * cc + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = out + ((b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(dst + 64 * cc + 4 * tx + e, o[i][4 * cc + e] / den);
  }
}

template <typename T, int D>
int launch(void* out, const void* q, const void* k, const void* v, int rows,
           int S, int Hq, int Hkv, int window, float softcap,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((S + kTile - 1) / kTile, Hq, rows);
  flash_attention_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), S, Hq, Hkv, window,
      softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, void* out, const void* q, const void* k, const void* v,
             int rows, int S, int Hq, int Hkv, int window, float softcap,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(out, q, k, v, rows, S, Hq, Hkv, window, softcap,
                           stream);
    case 128:
      return launch<T, 128>(out, q, k, v, rows, S, Hq, Hkv, window, softcap,
                            stream);
    case 256:
      return launch<T, 256>(out, q, k, v, rows, S, Hq, Hkv, window, softcap,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 for f32 q/k/v/out, 1 for bf16.  Returns cudaErrorInvalidValue for
// a dtype code, head_dim or shape the kernel does not take.
int flash_attention_fwd(void* out, const void* q, const void* k,
                        const void* v, int rows, int S, int Hq, int Hkv,
                        int head_dim, int window, float softcap, int dtype,
                        void* stream) {
  if (rows <= 0 || rows > 65535 || S <= 0 || Hq <= 0 || Hq > 65535 ||
      Hkv <= 0 || Hq % Hkv != 0 || window < 0 || !(softcap >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return dispatch<float>(head_dim, out, q, k, v, rows, S, Hq, Hkv, window,
                           softcap, st);
  }
  if (dtype == kBF16) {
    return dispatch<__nv_bfloat16>(head_dim, out, q, k, v, rows, S, Hq, Hkv,
                                   window, softcap, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
