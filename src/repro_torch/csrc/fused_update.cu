// Fused-update kernels of PersA-FL for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
//   fu_sgd_step:     out = w - eta * g                  (Option A step)
//   fu_prox_inner:   out = t - eta_in * (g + lam * (t - w))
//                                                     (Option C inner step)
//   fu_prox_outer:   out = w - (eta*lam) * (w - t)      (Option C outer step)
//   fu_apply_scaled: out = w - s * d              (every immediate apply)
//   fu_apply_rows:   out = w - sum_i s_i * d_i    (every buffered / sync flush,
//                                                 every fp32-banked window)
//   fu_apply_rows_q: out = w - sum_i (s_i * scale_i) * q_i   (every int8-banked
//                                                 serving window; q int8)
//
// All of them read their inputs once and write the output once, do the
// arithmetic in f32 and keep the storage type of their first operand (f32 or
// bf16; every other float operand may be either).  They are memory-bound
// elementwise passes: the bound on an H100 SXM is the bytes moved over
// 3.35 TB/s, and there is nothing to tile for -- the TPU kernels' 64K-element
// padding, 8192-column blocks and SMEM scalar are artefacts of that machine
// and are not carried over.  No kernel allocates, synchronises or pads: the
// ragged tail is masked by the loop bound, and the launch goes on the stream
// the caller passes (PyTorch's current stream).  Each entry point returns the
// value of cudaGetLastError() after the launch, which the Python wrapper turns
// into an exception.

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

// The three local-step kernels replace src/repro/kernels/fused_update/
// kernel.py:78 sgd_step, :83 prox_inner and :90 prox_outer (bodies
// _sgd_kernel at :39, _prox_inner_kernel at :45 and _prox_outer_kernel at :52,
// all run by _run_flat at :58).  Bound: sgd_step and prox_outer move 3n
// elements (2 read, 1 written), prox_inner 4n (3 read, 1 written), over
// 3.35 TB/s: at n = 2^26+3 in f32 0.2404 ms and 0.3205 ms.  Design:
// apply_scaled's -- a grid-stride loop, one element per thread per step,
// neighbouring threads on neighbouring addresses.  The TPU's 64K-element BLOCK
// padding (kernel.py:36, :58-75) is a VMEM tiling and is not carried over; the
// loop bound masks the ragged tail.  Every operation is rounded on its own
// (__fmul_rn, __fsub_rn, __fadd_rn; nvcc would otherwise contract a multiply
// and an add into one FMA, rounded once), in the plain version's order, so
// each kernel is bit-equal to its plain version.  The host rounds each scalar
// to f32 as the plain version does; prox_outer takes eta*lam as one scalar,
// formed in double and rounded once.
template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
    sgd_step_kernel(TW* __restrict__ out, const TW* __restrict__ w,
                    const TG* __restrict__ g, float eta, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    store_f32(out, i,
              __fsub_rn(load_f32(w, i), __fmul_rn(eta, load_f32(g, i))));
  }
}

template <typename TT, typename TG, typename TW>
__global__ void __launch_bounds__(kThreads)
    prox_inner_kernel(TT* __restrict__ out, const TT* __restrict__ theta,
                      const TG* __restrict__ g, const TW* __restrict__ w,
                      float eta_in, float lam, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float t = load_f32(theta, i);
    const float pull = __fmul_rn(lam, __fsub_rn(t, load_f32(w, i)));
    store_f32(out, i,
              __fsub_rn(t, __fmul_rn(eta_in, __fadd_rn(load_f32(g, i), pull))));
  }
}

template <typename TW, typename TT>
__global__ void __launch_bounds__(kThreads)
    prox_outer_kernel(TW* __restrict__ out, const TW* __restrict__ w,
                      const TT* __restrict__ theta, float eta_lam, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float wi = load_f32(w, i);
    const float gap = __fsub_rn(wi, load_f32(theta, i));
    store_f32(out, i, __fsub_rn(wi, __fmul_rn(eta_lam, gap)));
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

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) with T the storage type of dtype code `code`; false for a code
// it does not know.  f returns whether it launched.
template <typename F>
bool with_dtype(int code, F&& f) {
  if (code == kF32) return f(Tag<float>{});
  if (code == kBF16) return f(Tag<__nv_bfloat16>{});
  return false;
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

// The local steps' launchers: false for a dtype code they do not know.  The
// dispatch's generic lambdas live here, at namespace scope, and not inside
// the extern "C" entry points.
bool launch_sgd_step(void* out, const void* w, const void* g, float eta,
                     int64_t n, int w_dtype, int g_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(w_dtype, [&](auto tw) {
    return with_dtype(g_dtype, [&](auto tg) {
      using TW = typename decltype(tw)::type;
      using TG = typename decltype(tg)::type;
      sgd_step_kernel<TW, TG><<<grid_for(n), kThreads, 0, st>>>(
          static_cast<TW*>(out), static_cast<const TW*>(w),
          static_cast<const TG*>(g), eta, n);
      return true;
    });
  });
}

bool launch_prox_inner(void* out, const void* theta, const void* g,
                       const void* w, float eta_in, float lam, int64_t n,
                       int t_dtype, int g_dtype, int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(t_dtype, [&](auto tt) {
    return with_dtype(g_dtype, [&](auto tg) {
      return with_dtype(w_dtype, [&](auto tw) {
        using TT = typename decltype(tt)::type;
        using TG = typename decltype(tg)::type;
        using TW = typename decltype(tw)::type;
        prox_inner_kernel<TT, TG, TW><<<grid_for(n), kThreads, 0, st>>>(
            static_cast<TT*>(out), static_cast<const TT*>(theta),
            static_cast<const TG*>(g), static_cast<const TW*>(w), eta_in, lam,
            n);
        return true;
      });
    });
  });
}

bool launch_prox_outer(void* out, const void* w, const void* theta,
                       float eta_lam, int64_t n, int w_dtype, int t_dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(w_dtype, [&](auto tw) {
    return with_dtype(t_dtype, [&](auto tt) {
      using TW = typename decltype(tw)::type;
      using TT = typename decltype(tt)::type;
      prox_outer_kernel<TW, TT><<<grid_for(n), kThreads, 0, st>>>(
          static_cast<TW*>(out), static_cast<const TW*>(w),
          static_cast<const TT*>(theta), eta_lam, n);
      return true;
    });
  });
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

// The local steps.  Each returns cudaErrorInvalidValue for a dtype code it
// does not know, else the value of cudaGetLastError() after the launch.  n
// must be > 0.
int fu_sgd_step(void* out, const void* w, const void* g, float eta, int64_t n,
                int w_dtype, int g_dtype, void* stream) {
  if (!launch_sgd_step(out, w, g, eta, n, w_dtype, g_dtype, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int fu_prox_inner(void* out, const void* theta, const void* g, const void* w,
                  float eta_in, float lam, int64_t n, int t_dtype, int g_dtype,
                  int w_dtype, void* stream) {
  if (!launch_prox_inner(out, theta, g, w, eta_in, lam, n, t_dtype, g_dtype,
                         w_dtype, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// eta_lam is eta*lam, formed by the caller in double and rounded to f32 once.
int fu_prox_outer(void* out, const void* w, const void* theta, float eta_lam,
                  int64_t n, int w_dtype, int t_dtype, void* stream) {
  if (!launch_prox_outer(out, w, theta, eta_lam, n, w_dtype, t_dtype,
                         stream)) {
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
