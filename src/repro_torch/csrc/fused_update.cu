// Server-apply kernels of PersA-FL for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
//   fu_apply_scaled: out = w - s * d              (every immediate apply)
//   fu_apply_rows:   out = w - sum_i s_i * d_i    (every buffered / sync flush,
//                                                 every fp32-banked window)
//   fu_apply_rows_q: out = w - sum_i (s_i * scale_i) * q_i   (every int8-banked
//                                                 serving window; q int8)
//
// All three read their inputs once and write the output once, do the arithmetic
// in f32 and keep the storage type of w (f32 or bf16; d may be either).  They are
// memory-bound elementwise passes: the bound on an H100 SXM is the bytes moved
// over 3.35 TB/s, and there is nothing to tile for -- the TPU kernels' 64K-row
// padding, 8192-column blocks and SMEM scalar are artefacts of that machine and
// are not carried over.  Neither kernel allocates, synchronises or pads: the
// ragged tail is masked by the loop bound, and the launch goes on the stream the
// caller passes (PyTorch's current stream).  Each entry point returns the value
// of cudaGetLastError() after the launch, which the Python wrapper turns into an
// exception.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// apply_rows stages the row weights in shared memory this many at a time
constexpr int kWeightChunk = 1024;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i,
                                          float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Replaces src/repro/kernels/fused_update/kernel.py:229 apply_scaled (body
// _apply_scaled_kernel at :95).  Bound: 2n elements read and n written, over
// 3.35 TB/s; at the main path's 52K-element CNN leaves the launch itself
// dominates.  Design: a grid-stride loop, one element per thread per step,
// neighbouring threads on neighbouring addresses so every warp load coalesces.
// The multiply and the subtraction are rounded separately (__fmul_rn,
// __fsub_rn) so that the result is bit-equal to the plain version, which
// computes s*d and then w - (s*d) as two f32 operations.
template <typename TW, typename TD>
__global__ void __launch_bounds__(kThreads)
    apply_scaled_kernel(TW* __restrict__ out, const TW* __restrict__ w,
                        const TD* __restrict__ d, float s, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    store_f32(out, i, __fsub_rn(load_f32(w, i), __fmul_rn(s, load_f32(d, i))));
  }
}

// Replaces src/repro/kernels/fused_update/kernel.py:129 apply_rows (body
// _apply_rows_kernel at :114).  Bound: (M+1)·n elements read and n written,
// over 3.35 TB/s.  Design: each thread owns one column and walks all M rows
// with ONE f32 accumulator, so the whole reduction is one pass with no
// cross-block step; the [M] weights are staged in shared memory in chunks of
// kWeightChunk.  Row loads are coalesced across the warp (consecutive columns
// of one row).  This follows the plain version rather than the TPU kernel for
// M > 128: the TPU kernel rounds its partial sum to the storage type between
// 128-row chunks (kernel.py:120-126), the plain version keeps all of it in f32,
// and so does this kernel.  A zero-weight row with finite contents adds
// exactly 0.
template <typename TW, typename TD>
__global__ void __launch_bounds__(kThreads)
    apply_rows_kernel(TW* __restrict__ out, const TW* __restrict__ w,
                      const TD* __restrict__ d, const float* __restrict__ s,
                      int64_t m, int64_t n) {
  __shared__ float s_chunk[kWeightChunk];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  // the chunk loop is uniform across the block, so every thread reaches both
  // barriers even when its own column lies past n
  for (int64_t r0 = 0; r0 < m; r0 += kWeightChunk) {
    const int rows = static_cast<int>(m - r0 < kWeightChunk ? m - r0 : kWeightChunk);
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += blockDim.x) s_chunk[j] = s[r0 + j];
    __syncthreads();
    if (col < n) {
      const TD* row = d + r0 * n + col;
#pragma unroll 8
      for (int j = 0; j < rows; ++j) {
        acc = fmaf(s_chunk[j], load_f32(row, static_cast<int64_t>(j) * n), acc);
      }
    }
  }
  if (col < n) store_f32(out, col, load_f32(w, col) - acc);
}

// Replaces src/repro/kernels/fused_update/kernel.py:186 apply_rows_q (body
// _apply_rows_q_kernel at :168).  Bound: M·n int8 bytes, w read and out written
// (8n bytes for f32 w, 4n for bf16) and 8M bytes of weights and scales, over
// 3.35 TB/s; the int8 rows are most of it at every real M.  Design: apply_rows'
// shape -- one thread per column, ONE f32 accumulator across all M rows, so the
// reduction is one pass with no cross-block step.  The per-row coefficient
// weights[i]*scales[i] is formed once per block per row, rounded as the plain
// version rounds it (__fmul_rn, never contracted into anything else), and
// staged in shared memory kWeightChunk rows at a time; the f32 delta row never
// exists.  A warp reads 32 consecutive int8 codes of one row per step (one
// 32-byte sector).  Like apply_rows this follows the plain version, not the TPU
// kernel, which rounds its partial sum to the storage type between 128-row
// chunks (kernel.py:168-184).  A padding row (weight 0, scale 0) adds exactly 0.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
    apply_rows_q_kernel(TW* __restrict__ out, const TW* __restrict__ w,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ s,
                        const float* __restrict__ scale, int64_t m,
                        int64_t n) {
  __shared__ float c_chunk[kWeightChunk];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  // uniform across the block: every thread reaches both barriers
  for (int64_t r0 = 0; r0 < m; r0 += kWeightChunk) {
    const int rows = static_cast<int>(m - r0 < kWeightChunk ? m - r0 : kWeightChunk);
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      c_chunk[j] = __fmul_rn(__ldg(s + r0 + j), __ldg(scale + r0 + j));
    }
    __syncthreads();
    if (col < n) {
      const int8_t* row = q + r0 * n + col;
#pragma unroll 8
      for (int j = 0; j < rows; ++j) {
        acc = fmaf(c_chunk[j],
                   static_cast<float>(__ldg(row + static_cast<int64_t>(j) * n)),
                   acc);
      }
    }
  }
  if (col < n) store_f32(out, col, load_f32(w, col) - acc);
}

int grid_for(int64_t n) {
  // enough blocks to fill the card several times over; the grid-stride loop
  // covers the rest
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 64 ? blocks : 132 * 64);
}

template <typename TW, typename TD>
void launch_scaled(void* out, const void* w, const void* d, float s, int64_t n,
                   cudaStream_t stream) {
  apply_scaled_kernel<TW, TD><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<TW*>(out), static_cast<const TW*>(w),
      static_cast<const TD*>(d), s, n);
}

template <typename TW, typename TD>
void launch_rows(void* out, const void* w, const void* d, const float* s,
                 int64_t m, int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  apply_rows_kernel<TW, TD><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<TW*>(out), static_cast<const TW*>(w),
      static_cast<const TD*>(d), s, m, n);
}

template <typename TW>
void launch_rows_q(void* out, const void* w, const int8_t* q, const float* s,
                   const float* scale, int64_t m, int64_t n,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  apply_rows_q_kernel<TW><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<TW*>(out), static_cast<const TW*>(w), q, s, scale, m, n);
}

}  // namespace

extern "C" {

// Returns cudaErrorInvalidValue for a dtype code it does not know, else the
// value of cudaGetLastError() after the launch.  n must be > 0.
int fu_apply_scaled(void* out, const void* w, const void* d, float s,
                    int64_t n, int w_dtype, int d_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == kF32 && d_dtype == kF32) {
    launch_scaled<float, float>(out, w, d, s, n, st);
  } else if (w_dtype == kF32 && d_dtype == kBF16) {
    launch_scaled<float, __nv_bfloat16>(out, w, d, s, n, st);
  } else if (w_dtype == kBF16 && d_dtype == kF32) {
    launch_scaled<__nv_bfloat16, float>(out, w, d, s, n, st);
  } else if (w_dtype == kBF16 && d_dtype == kBF16) {
    launch_scaled<__nv_bfloat16, __nv_bfloat16>(out, w, d, s, n, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// weights: [m] f32 on the device; d: [m, n] row-major.  n must be > 0.
int fu_apply_rows(void* out, const void* w, const void* d, const void* weights,
                  int64_t m, int64_t n, int w_dtype, int d_dtype,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(weights);
  if (w_dtype == kF32 && d_dtype == kF32) {
    launch_rows<float, float>(out, w, d, s, m, n, st);
  } else if (w_dtype == kF32 && d_dtype == kBF16) {
    launch_rows<float, __nv_bfloat16>(out, w, d, s, m, n, st);
  } else if (w_dtype == kBF16 && d_dtype == kF32) {
    launch_rows<__nv_bfloat16, float>(out, w, d, s, m, n, st);
  } else if (w_dtype == kBF16 && d_dtype == kBF16) {
    launch_rows<__nv_bfloat16, __nv_bfloat16>(out, w, d, s, m, n, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [m, n] int8 row-major; weights, scales: [m] f32 on the device.  n must be
// > 0.
int fu_apply_rows_q(void* out, const void* w, const void* q,
                    const void* weights, const void* scales, int64_t m,
                    int64_t n, int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* s = static_cast<const float*>(weights);
  const float* sc = static_cast<const float*>(scales);
  if (w_dtype == kF32) {
    launch_rows_q<float>(out, w, qq, s, sc, m, n, st);
  } else if (w_dtype == kBF16) {
    launch_rows_q<__nv_bfloat16>(out, w, qq, s, sc, m, n, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
