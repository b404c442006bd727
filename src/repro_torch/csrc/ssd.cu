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
// Design: chunk-parallel, in three launches (one when the sequence is one
// chunk), the decomposition GPU Mamba2 kernels use.  Let nc = S / l.
//
//   1. ssd_fwd_chunk_state: one block per (row, chunk < nc-1, tile of heads
//      of one group).  Per head it scans a_cum and forms the chunk's own end
//      state sum_s (x[s] w[s] dt[s]) (x) B[s], w = exp(a_cum[l-1]-a_cum[s]),
//      as a (P x l).(l x N) product, into an f32 scratch (rows, nc-1, H, P,
//      N), and writes exp(a_cum[l-1]) to a (rows, nc-1, H) one.  B is staged
//      once per block for all its heads, each head's x with cp.async two
//      heads ahead of its products (three stages).  The last chunk's end
//      state is never read, so it is not formed.
//   2. ssd_fwd_state_pass: one thread per 8 state entries of a (row, head)
//      (two 16-byte loads).  It walks the chunks in order, running =
//      exp(a_cum_end[c]) running + chunk_state[c], and writes the running
//      state back in place: slot c then holds the state entering chunk c+1
//      (for bf16 inputs as its hi and lo bf16 halves, the same 4 bytes an
//      entry, in the layout the chunk scan stages as it is).  It loads 4
//      chunks ahead of the FMAs that need them; only the FMA depends on the
//      previous chunk.
//   3. ssd_fwd_chunk_scan: one block per (row, chunk, tile of heads of one
//      group).  It forms C.B^T once for all the heads it walks, skipping the
//      16-token tiles above the diagonal, and per head computes
//      y = (C.B^T o exp(a_cum[t]-a_cum[s]) o dt[s]) . x
//        + exp(a_cum[t]) C . state_in^T; inside a diagonal tile the upper
//      triangle is masked by a select BEFORE exp is used: a_cum[t]-a_cum[s]
//      is positive there and exp may overflow, so those entries are selected
//      to 0, never multiplied by a mask.  Chunk 0 takes the zero state and
//      skips that product.  y is written in f32.
//
// The host picks the heads per block (kMaxHeads at most) so that the grid
// has about two blocks per SM where the shape allows it
// (repro_torch/kernels/ssd/kernel.py plan()); C.B^T is formed once per
// (row, chunk, group, tile of heads).
//
// Products on the tensor cores (bf16 x, B, C).  x, B and C are exact bf16
// values, so every f32 factor is put on the other side of each product:
//   * C.B^T: bf16 mma with f32 accumulation; the products are exact;
//   * the intra-chunk product: S' = C.B^T o L o dt is split into S'_hi =
//     bf16(S') and S'_lo = bf16(S' - S'_hi), and y += S'_hi.x + S'_lo.x;
//   * the state update: the same split of x o w o dt (the x side, not B:
//     B stays one staged copy for all heads, and l x P is the smaller
//     operand), times B;
//   * the inter-chunk term: the same split of the f32 state, times C.
// hi + lo keeps about 16 bits of the f32 mantissa against the full bf16
// input, for twice the FLOPs of those three products.  Rounding S' or the
// state to one bf16 value (2^-9 relative) is what bf16 SSD kernels
// elsewhere do; in the plain model of these kernels (ref.py
// ssd_phases_ref) it moves y by 9e-3 to 2.3e-2 at |y| ~ 0.3, far past the
// 5e-4 the scan is held to against the sequential reference, where the
// split stays within 1e-4 (tests/test_torch_ssd.py).  The products are
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 fed by ldmatrix from
// shared memory (rows padded by 16 bytes, so the eight rows of an 8x8
// matrix fall in distinct banks).  In the chunk scan one warp owns 16
// tokens t: it keeps its strip of C.B^T in registers (accumulator layout),
// builds the A fragments of S'_hi and S'_lo from them directly, and stages
// each head's x and hi/lo state with cp.async, double-buffered across the
// heads of the block; the state pass has already split the state, once per
// entry.  The products of a hi and a lo half go to different accumulators
// in turn, so that no mma waits on the one before it.  f32 inputs take the
// same three kernels with the products as f32 FMAs on the CUDA cores
// (register tiles over shared memory), C.B^T still once per block and the
// upper triangle still skipped.  No TF32 anywhere.
//
// What bounds it on an H100 SXM.  The work (inputs read once, y written
// once; 2l^2N + 2l^2P + 4lNP FLOPs per chunk and head) is bound by bytes
// for bf16: the f32 y is most of them.  This design moves more: the
// states, P*N f32 per (row, chunk, head), are written by kernel 1, read and
// written by kernel 2 and read by kernel 3, and kernel 1 reads x, B and dt
// a second time; at mamba2-130m's (8, 4096) that is 3.9x the bound's bytes
// (kernel.py plan().design_bytes, which chip_smoke.py reports).  Each
// kernel is bound by its own bytes: kernel 1 by the states it writes
// (about 60% of what it moves), kernel 2 by the states it streams through
// (it reaches about 88% of that floor), kernel 3 by the states and x it
// reads and the y it writes; the tensor-core work (hi/lo doubled) is far
// below each.  Kernels 1 and 3 reach about 40% of their floors; what holds
// them there is not measured (no ncu on the card's machine).  For f32 the
// CUDA-core FMAs of kernels 1 and 3 are the bound.
//
// What a later PR could take: wgmma (warpgroup products from shared memory)
// if the products set the pace, and a chained single-pass state carry (each
// chunk block waits on its predecessor's state through a flag in global
// memory) that would remove the states' round trips through device memory,
// kernel 2, and kernel 1's second read of the inputs.
//
// Every launch goes on the stream the caller passes (PyTorch's current
// stream); the kernels allocate nothing and do not synchronise: the wrapper
// allocates y and the scratch with torch.empty.  ssd_fwd checks
// cudaGetLastError() after each launch and returns the first error (a
// refused shared-memory size included).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 128;       // largest chunk
constexpr int kPMax = 64;     // largest head dim
constexpr int kNMax = 128;    // largest state size
constexpr int kMaxHeads = 8;  // heads one block walks
constexpr int kAhead = 4;     // chunks the state pass loads ahead

enum DType : int { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !valid (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a.b, one 16x8x16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  __nv_bfloat162 v;
  v.x = __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu));
  v.y = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  return __bfloat1622float2(v);
}

// (a, b) -> hi = bf16(a, b) and lo = bf16((a, b) - hi), a in the low half
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

struct Shape {
  int S, H, P, G, N, chunk, hb;
};

// the heads block (blockIdx.x, ., .) walks: h0 .. h0+nh-1, all of group g
struct HeadTile {
  int g, h0, nh;
};
__device__ __forceinline__ HeadTile head_tile(const Shape& sh) {
  const int rep = sh.H / sh.G;
  const int tiles = (rep + sh.hb - 1) / sh.hb;
  const int g = blockIdx.x / tiles;
  const int first = (blockIdx.x - g * tiles) * sh.hb;
  return {g, g * rep + first, min(sh.hb, rep - first)};
}

// dt and the inclusive a_cum of the block's heads into sDt / sAc
// ([kMaxHeads][kL]; zero dt past the chunk, so a_cum stays flat there): one
// warp per head, four tokens a lane, a shuffle scan
__device__ void scan_heads(float* sDt, float* sAc, const float* dt,
                           const float* a_log, int64_t alog_stride,
                           int64_t row, int64_t tok0, const Shape& sh,
                           const HeadTile& ht) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < ht.nh; i += kWarps) {
    const int hh = ht.h0 + i;
    const float A = -expf(a_log[row * alog_stride + hh]);
    constexpr int kPer = kL / 32;
    float v[kPer];
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = lane * kPer + k;
      const float d = s < sh.chunk ? dt[(tok0 + s) * sh.H + hh] : 0.0f;
      sDt[i * kL + s] = d;
      run += d * A;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < kPer; ++k) sAc[i * kL + lane * kPer + k] = excl + v[k];
  }
}

// ------------------------------------------------- 1. the chunks' end states

constexpr int kStateStages = 3;  // heads of x the end-state kernel stages

size_t chunk_state_smem(int dtype, int lp, int P, int N) {
  if (dtype == kBF16) {
    return static_cast<size_t>(lp) * (N + 8) * 2                   // B
           + kStateStages * static_cast<size_t>(lp) * (P + 8) * 2  // x
           + 3 * kMaxHeads * kL * 4;  // dt, a_cum, w dt
  }
  return static_cast<size_t>(lp) * (N + P) * 4 + 2 * kMaxHeads * kL * 4;
}

// the end-state weights w dt of chunk token s: exp(a_cum[l-1]-a_cum[s]) dt
__device__ __forceinline__ float end_weight(const float* ac, const float* dtv,
                                            int s) {
  return expf(ac[kL - 1] - ac[s]) * dtv[s];
}

// states: [rows, nc-1, H, P, N] f32; decay: [rows, nc-1, H] f32.  The A
// operand (x w dt)^T is built in registers: a transposed ldmatrix of the
// staged bf16 x gives the fragment, each pair is widened, weighted by its
// token's w dt and split into the hi and lo fragments.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_fwd_chunk_state_bf16(float* __restrict__ states,
                             float* __restrict__ decay,
                             const bf16* __restrict__ x,
                             const float* __restrict__ dt,
                             const float* __restrict__ a_log,
                             int64_t alog_stride,
                             const bf16* __restrict__ bmat, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sh.P, N = sh.N, chunk = sh.chunk;
  const int lp = pad16(chunk);
  const int ldk = N + 8, ldx = P + 8;
  bf16* sB = reinterpret_cast<bf16*>(smem);  // [lp][ldk]  B[s][n]
  bf16* sX = sB + lp * ldk;  // [kStateStages][lp][ldx]  x of head i % 3
  float* sDt = reinterpret_cast<float*>(sX + kStateStages * lp * ldx);
  float* sAc = sDt + kMaxHeads * kL;
  float* sW = sAc + kMaxHeads * kL;  // w dt, per head and token

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const HeadTile ht = head_tile(sh);
  const int c = blockIdx.y, nslots = gridDim.y;
  const int64_t row = blockIdx.z;
  const int64_t tok0 = row * sh.S + static_cast<int64_t>(c) * chunk;
  const int64_t slot = row * nslots + c;

  for (int q = tid; q < lp * (N / 8); q += kThreads) {
    const int s = q / (N / 8), k8 = q - s * (N / 8);
    const bool ok = s < chunk;
    cp_async16(sB + s * ldk + 8 * k8,
               bmat + (ok ? ((tok0 + s) * sh.G + ht.g) * N + 8 * k8 : 0),
               ok);
  }
  cp_async_commit();
  // x of head i into stage i % kStateStages, two heads ahead of its products
  auto issue = [&](int i) {
    bf16* dst = sX + (i % kStateStages) * lp * ldx;
    const int hh = ht.h0 + i;
    for (int q = tid; q < lp * (P / 8); q += kThreads) {
      const int s = q / (P / 8), p8 = q - s * (P / 8);
      const bool ok = s < chunk;
      cp_async16(dst + s * ldx + 8 * p8,
                 x + (ok ? ((tok0 + s) * sh.H + hh) * P + 8 * p8 : 0), ok);
    }
  };
  for (int i = 0; i < kStateStages - 1; ++i) {
    if (i < ht.nh) issue(i);
    cp_async_commit();
  }
  scan_heads(sDt, sAc, dt, a_log, alog_stride, row, tok0, sh, ht);
  __syncthreads();
  for (int q = tid; q < ht.nh * kL; q += kThreads) {
    const int i = q / kL, s = q - i * kL;
    sW[q] = s < chunk ? end_weight(sAc + i * kL, sDt + i * kL, s) : 0.0f;
  }
  if (tid < ht.nh) {
    decay[slot * sh.H + ht.h0 + tid] = expf(sAc[tid * kL + kL - 1]);
  }

  // warp -> its strip of 16 p and its 16-column tiles of n
  const int sp = P / 16, units = sp * (N / 16);
  const int strip = warp % sp;
  for (int i = 0; i < ht.nh; ++i) {
    const int hh = ht.h0 + i;
    if (i + kStateStages - 1 < ht.nh) issue(i + kStateStages - 1);
    cp_async_commit();
    cp_async_wait<kStateStages - 1>();  // B and head i's x have landed
    __syncthreads();
    const bf16* xi = sX + (i % kStateStages) * lp * ldx;
    const float* wi = sW + i * kL;

    float acc[4][2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[u][h2][r] = 0.0f;
    for (int kk = 0; kk < lp / 16; ++kk) {
      // A = (x w dt)^T [p][s] from x [s][p]: a transposed 8x8 load, then
      // each pair (tokens s, s + 1) weighted and split
      uint32_t a[4], ahi[4], alo[4];
      ldsm_x4_t(a, xi + (16 * kk + (lane & 7) + (lane >> 4) * 8) * ldx +
                       16 * strip + ((lane >> 3) & 1) * 8);
      const int s0 = 16 * kk + 2 * (lane & 3);
      const float2 w0 = *reinterpret_cast<const float2*>(wi + s0);
      const float2 w8 = *reinterpret_cast<const float2*>(wi + s0 + 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = unpack(a[r]);
        const float2 w = r < 2 ? w0 : w8;
        split2(f.x * w.x, f.y * w.y, ahi[r], alo[r]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cu = warp + u * kWarps;
        if (cu < units) {
          const int col = cu / sp;
          // B operand [s][n], k = s: transposed 8x8 loads
          uint32_t b[4];
          ldsm_x4_t(b, sB + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               ldk +
                           16 * col + (lane >> 4) * 8);
          mma(acc[u][0], ahi, b[0], b[1]);
          mma(acc[u][1], ahi, b[2], b[3]);
          mma(acc[u][0], alo, b[0], b[1]);
          mma(acc[u][1], alo, b[2], b[3]);
        }
      }
    }
    float* out = states + (slot * sh.H + hh) * P * N;
    const int p0 = 16 * strip + (lane >> 2);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cu = warp + u * kWarps;
      if (cu < units) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int n = 16 * (cu / sp) + 8 * h2 + 2 * (lane & 3);
          *reinterpret_cast<float2*>(out + p0 * N + n) =
              make_float2(acc[u][h2][0], acc[u][h2][1]);
          *reinterpret_cast<float2*>(out + (p0 + 8) * N + n) =
              make_float2(acc[u][h2][2], acc[u][h2][3]);
        }
      }
    }
    __syncthreads();  // stage i % kStateStages is refilled for head i + 3
  }
}

// f32 inputs: the same work as f32 FMAs.  Thread (pg, ng) owns p = pg + 16a
// and n = ng + 16b; lanes run along n, so each half-warp writes 64 bytes of
// one state row.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_fwd_chunk_state_f32(float* __restrict__ states,
                            float* __restrict__ decay,
                            const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ a_log,
                            int64_t alog_stride,
                            const float* __restrict__ bmat, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sh.P, N = sh.N, chunk = sh.chunk;
  const int lp = pad16(chunk);
  float* sB = reinterpret_cast<float*>(smem);  // [lp][N]
  float* sX = sB + lp * N;                     // [lp][P]  x w dt
  float* sDt = sX + lp * P;
  float* sAc = sDt + kMaxHeads * kL;

  const int tid = threadIdx.x;
  const HeadTile ht = head_tile(sh);
  const int c = blockIdx.y, nslots = gridDim.y;
  const int64_t row = blockIdx.z;
  const int64_t tok0 = row * sh.S + static_cast<int64_t>(c) * chunk;
  const int64_t slot = row * nslots + c;

  for (int q = tid; q < lp * (N / 4); q += kThreads) {
    const int s = q / (N / 4), k4 = q - s * (N / 4);
    *reinterpret_cast<float4*>(sB + s * N + 4 * k4) =
        s < chunk ? *reinterpret_cast<const float4*>(
                        bmat + ((tok0 + s) * sh.G + ht.g) * N + 4 * k4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  scan_heads(sDt, sAc, dt, a_log, alog_stride, row, tok0, sh, ht);
  __syncthreads();

  const int ng = tid & 15, pg = tid >> 4;
  for (int i = 0; i < ht.nh; ++i) {
    const int hh = ht.h0 + i;
    const float* ac = sAc + i * kL;
    const float* dtv = sDt + i * kL;
    for (int q = tid; q < lp * (P / 4); q += kThreads) {
      const int s = q / (P / 4), p4 = q - s * (P / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < chunk) {
        v = *reinterpret_cast<const float4*>(
            x + ((tok0 + s) * sh.H + hh) * P + 4 * p4);
        const float wgt = end_weight(ac, dtv, s);
        v.x *= wgt;
        v.y *= wgt;
        v.z *= wgt;
        v.w *= wgt;
      }
      *reinterpret_cast<float4*>(sX + s * P + 4 * p4) = v;
    }
    if (tid == 0) decay[slot * sh.H + hh] = expf(ac[kL - 1]);
    __syncthreads();

    float acc[kPMax / 16][kNMax / 16];
#pragma unroll
    for (int a = 0; a < kPMax / 16; ++a)
#pragma unroll
      for (int b = 0; b < kNMax / 16; ++b) acc[a][b] = 0.0f;
    for (int s = 0; s < lp; ++s) {
      float xv[kPMax / 16], bv[kNMax / 16];
#pragma unroll
      for (int a = 0; a < kPMax / 16; ++a)
        xv[a] = 16 * a < P ? sX[s * P + pg + 16 * a] : 0.0f;
#pragma unroll
      for (int b = 0; b < kNMax / 16; ++b)
        bv[b] = 16 * b < N ? sB[s * N + ng + 16 * b] : 0.0f;
#pragma unroll
      for (int a = 0; a < kPMax / 16; ++a)
#pragma unroll
        for (int b = 0; b < kNMax / 16; ++b)
          acc[a][b] = fmaf(xv[a], bv[b], acc[a][b]);
    }
    float* out = states + (slot * sh.H + hh) * P * N;
#pragma unroll
    for (int a = 0; a < kPMax / 16; ++a)
#pragma unroll
      for (int b = 0; b < kNMax / 16; ++b)
        if (16 * a < P && 16 * b < N)
          out[(pg + 16 * a) * N + ng + 16 * b] = acc[a][b];
    __syncthreads();  // sX is rewritten for the next head
  }
}

// --------------------------------------------------- 2. the state pass

// states: [rows, ns, H, P*N] f32; decay: [rows, ns, H].  Thread e owns
// entries 8e .. 8e+7 of a (row, head), 32 bytes it reads and rewrites in
// place in every slot.  kSplit (bf16 inputs): the running state goes back as
// hi, lo bf16 halves, 8 of each in those 32 bytes, the layout the chunk
// scan's ldmatrix reads; else as f32.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_state_pass(float4* __restrict__ states,
                       const float* __restrict__ decay, int rows, int ns,
                       int H, int pn8) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * H * pn8) return;
  const int64_t rh = idx / pn8;
  const int e = static_cast<int>(idx - rh * pn8);
  const int64_t row = rh / H;
  const int h = static_cast<int>(rh - row * H);
  float4* st = states + ((row * ns * H + h) * pn8 + e) * 2;
  const float* dc = decay + row * ns * H + h;
  const int64_t sstride = static_cast<int64_t>(H) * pn8 * 2;  // float4s

  float4 cur[kAhead][2], nxt[kAhead][2];
  float dcur[kAhead], dnxt[kAhead];
  auto load = [&](float4 (&v)[kAhead][2], float (&d)[kAhead], int c0) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < ns) {
        v[k][0] = st[(c0 + k) * sstride];
        v[k][1] = st[(c0 + k) * sstride + 1];
        d[k] = dc[(c0 + k) * H];
      }
    }
  };
  load(cur, dcur, 0);
  float run[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) run[j] = 0.0f;
  for (int c0 = 0; c0 < ns; c0 += kAhead) {
    // the next kAhead chunks' loads go out before this batch's FMAs
    load(nxt, dnxt, c0 + kAhead);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c < ns) {
        const float d = dcur[k];
        const float in[8] = {cur[k][0].x, cur[k][0].y, cur[k][0].z,
                             cur[k][0].w, cur[k][1].x, cur[k][1].y,
                             cur[k][1].z, cur[k][1].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) run[j] = fmaf(d, run[j], in[j]);
        if (kSplit) {
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split2(run[2 * j], run[2 * j + 1], hi[j], lo[j]);
          uint4* out = reinterpret_cast<uint4*>(st + c * sstride);
          out[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          out[1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        } else {
          st[c * sstride] = make_float4(run[0], run[1], run[2], run[3]);
          st[c * sstride + 1] = make_float4(run[4], run[5], run[6], run[7]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cur[k][0] = nxt[k][0];
      cur[k][1] = nxt[k][1];
      dcur[k] = dnxt[k];
    }
  }
}

// ----------------------------------------------------- 3. the chunk scan

size_t chunk_scan_smem(int dtype, int lp, int P, int N) {
  const size_t tables = 2 * kMaxHeads * kL * 4;  // dt, a_cum
  if (dtype == kBF16) {
    const size_t stage = static_cast<size_t>(lp) * (P + 8) * 2    // x
                         + static_cast<size_t>(P) * (4 * N + 16);  // state
    return 2 * static_cast<size_t>(lp) * (N + 8) * 2 + 2 * stage + tables;
  }
  const size_t cb = static_cast<size_t>(lp) * (N + 1) > lp * (lp + 1)
                        ? static_cast<size_t>(lp) * (N + 1)
                        : static_cast<size_t>(lp) * (lp + 1);
  return (static_cast<size_t>(lp) * (N + 1) + cb + static_cast<size_t>(lp) * P +
          static_cast<size_t>(P) * (N + 1)) *
             4 +
         tables;
}

// states (the state entering each chunk, slot c-1 for chunk c):
// [rows, nc-1, H, P, N / 8] units of 8 hi then 8 lo bf16 halves (32 bytes,
// as the state pass writes them)
__global__ void __launch_bounds__(kThreads, 1)
    ssd_fwd_chunk_scan_bf16(float* __restrict__ y,
                            const bf16* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ a_log,
                            int64_t alog_stride,
                            const bf16* __restrict__ bmat,
                            const bf16* __restrict__ cmat,
                            const float* __restrict__ states, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sh.P, N = sh.N, chunk = sh.chunk;
  const int lp = pad16(chunk);
  const int ldk = N + 8, ldx = P + 8;
  bf16* sC = reinterpret_cast<bf16*>(smem);  // [lp][ldk]
  bf16* sB = sC + lp * ldk;                  // [lp][ldk]
  unsigned char* stage0 = reinterpret_cast<unsigned char*>(sB + lp * ldk);
  const size_t xbytes = static_cast<size_t>(lp) * ldx * 2;
  const int lds = 2 * N + 8;  // bf16 row of the staged hi/lo state
  const size_t stage_bytes = xbytes + static_cast<size_t>(P) * lds * 2;
  float* sDt = reinterpret_cast<float*>(stage0 + 2 * stage_bytes);
  float* sAc = sDt + kMaxHeads * kL;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const HeadTile ht = head_tile(sh);
  const int c = blockIdx.y, nc = gridDim.y;
  const int64_t row = blockIdx.z;
  const int64_t tok0 = row * sh.S + static_cast<int64_t>(c) * chunk;
  const bool has_state = c > 0;
  const float* st_in =
      has_state ? states + ((row * (nc - 1) + c - 1) * sh.H) * P * N
                : nullptr;

  for (int q = tid; q < lp * (N / 8); q += kThreads) {
    const int s = q / (N / 8), k8 = q - s * (N / 8);
    const bool ok = s < chunk;
    const int64_t src = ok ? ((tok0 + s) * sh.G + ht.g) * N + 8 * k8 : 0;
    cp_async16(sC + s * ldk + 8 * k8, cmat + src, ok);
    cp_async16(sB + s * ldk + 8 * k8, bmat + src, ok);
  }
  cp_async_commit();
  // head i's x (bf16 [lp][ldx]) and hi/lo state ([P][lds]) into stage i & 1
  auto issue = [&](int i) {
    unsigned char* st = stage0 + (i & 1) * stage_bytes;
    bf16* sX = reinterpret_cast<bf16*>(st);
    const int hh = ht.h0 + i;
    for (int q = tid; q < lp * (P / 8); q += kThreads) {
      const int s = q / (P / 8), p8 = q - s * (P / 8);
      const bool ok = s < chunk;
      cp_async16(sX + s * ldx + 8 * p8,
                 x + (ok ? ((tok0 + s) * sh.H + hh) * P + 8 * p8 : 0), ok);
    }
    if (has_state) {
      bf16* sS = reinterpret_cast<bf16*>(st + xbytes);
      const bf16* src = reinterpret_cast<const bf16*>(
          st_in + static_cast<int64_t>(hh) * P * N);
      for (int q = tid; q < P * (N / 4); q += kThreads) {
        const int p = q / (N / 4), k8 = q - p * (N / 4);
        cp_async16(sS + p * lds + 8 * k8, src + p * 2 * N + 8 * k8, true);
      }
    }
  };
  issue(0);
  cp_async_commit();
  scan_heads(sDt, sAc, dt, a_log, alog_stride, row, tok0, sh, ht);
  cp_async_wait<1>();
  __syncthreads();

  // this warp's strip of C.B^T: t in [16 strip, 16 strip + 16), s <= t,
  // in the mma accumulator layout (n-tile j covers s in [8j, 8j + 8)).
  // Strip k has k + 1 tiles of s; warps w and w + 4 share a scheduler, so
  // they take strips that sum to 7 (the same work on every scheduler)
  const int strip = warp < 4 ? warp : 11 - warp;
  const bool active = 16 * strip < lp;
  const int t0 = 16 * strip + (lane >> 2), t1 = t0 + 8;
  float cb[kL / 8][4];
#pragma unroll
  for (int j = 0; j < kL / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) cb[j][r] = 0.0f;
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kNMax / 16; ++kk) {
      if (16 * kk < N) {
        uint32_t a[4];
        ldsm_x4(a, sC + (16 * strip + (lane & 15)) * ldk + 16 * kk +
                       (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < kL / 16; ++jp) {
          if (jp <= strip) {  // the tiles above the diagonal are skipped
            uint32_t b[4];
            ldsm_x4(b, sB + (16 * jp + (lane & 7) + (lane >> 4) * 8) * ldk +
                           16 * kk + ((lane >> 3) & 1) * 8);
            mma(cb[2 * jp], a, b[0], b[1]);
            mma(cb[2 * jp + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }

  for (int i = 0; i < ht.nh; ++i) {
    if (i + 1 < ht.nh) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    unsigned char* st = stage0 + (i & 1) * stage_bytes;
    const bf16* sX = reinterpret_cast<const bf16*>(st);
    const bf16* sS = reinterpret_cast<const bf16*>(st + xbytes);
    if (active) {
      const int hh = ht.h0 + i;
      const float* ac = sAc + i * kL;
      const float* dtv = sDt + i * kL;
      float acc[kPMax / 8][4];
#pragma unroll
      for (int j = 0; j < kPMax / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
      const float ac0 = ac[t0], ac1 = ac[t1];
      if (has_state) {
        // exp(a_cum[t]) C . state^T, the state split into hi and lo
#pragma unroll
        for (int kk = 0; kk < kNMax / 16; ++kk) {
          if (16 * kk < N) {
            uint32_t a[4];
            ldsm_x4(a, sC + (16 * strip + (lane & 15)) * ldk + 16 * kk +
                           (lane >> 4) * 8);
#pragma unroll
            for (int jp = 0; jp < kPMax / 16; ++jp) {
              if (16 * jp < P) {
                // 8 n of one kind: unit 2 kk (+1) of row p, hi then lo
                const bf16* q = sS +
                                (16 * jp + (lane & 7) + (lane >> 4) * 8) * lds +
                                16 * (2 * kk + ((lane >> 3) & 1));
                uint32_t bh[4], bl[4];
                ldsm_x4(bh, q);
                ldsm_x4(bl, q + 8);
                mma(acc[2 * jp], a, bh[0], bh[1]);
                mma(acc[2 * jp + 1], a, bh[2], bh[3]);
                mma(acc[2 * jp], a, bl[0], bl[1]);
                mma(acc[2 * jp + 1], a, bl[2], bl[3]);
              }
            }
          }
        }
        const float e0 = expf(ac0), e1 = expf(ac1);
#pragma unroll
        for (int j = 0; j < kPMax / 8; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }
      // (C.B^T o exp(a_cum[t]-a_cum[s]) o dt[s]) . x over the tiles s <= t
#pragma unroll
      for (int kk = 0; kk < kL / 16; ++kk) {
        if (kk <= strip) {
          uint32_t shi[4], slo[4];
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int s = 16 * kk + 8 * h2 + 2 * (lane & 3);
            const float2 as = *reinterpret_cast<const float2*>(ac + s);
            const float2 ds = *reinterpret_cast<const float2*>(dtv + s);
            const int j = 2 * kk + h2;
            // a select, not a product with a mask: exp may be inf above
            // the diagonal, and inf * 0 is NaN
            const float v00 =
                s <= t0 ? cb[j][0] * expf(ac0 - as.x) * ds.x : 0.f;
            const float v01 =
                s + 1 <= t0 ? cb[j][1] * expf(ac0 - as.y) * ds.y : 0.f;
            const float v10 =
                s <= t1 ? cb[j][2] * expf(ac1 - as.x) * ds.x : 0.f;
            const float v11 =
                s + 1 <= t1 ? cb[j][3] * expf(ac1 - as.y) * ds.y : 0.f;
            split2(v00, v01, shi[2 * h2], slo[2 * h2]);
            split2(v10, v11, shi[2 * h2 + 1], slo[2 * h2 + 1]);
          }
#pragma unroll
          for (int jp = 0; jp < kPMax / 16; ++jp) {
            if (16 * jp < P) {
              uint32_t b[4];
              ldsm_x4_t(b, sX + (16 * kk + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * ldx +
                               16 * jp + (lane >> 4) * 8);
              mma(acc[2 * jp], shi, b[0], b[1]);
              mma(acc[2 * jp + 1], shi, b[2], b[3]);
              mma(acc[2 * jp], slo, b[0], b[1]);
              mma(acc[2 * jp + 1], slo, b[2], b[3]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPMax / 8; ++j) {
        if (8 * j < P) {
          const int p = 8 * j + 2 * (lane & 3);
          if (t0 < chunk)
            *reinterpret_cast<float2*>(y + ((tok0 + t0) * sh.H + hh) * P +
                                       p) = make_float2(acc[j][0], acc[j][1]);
          if (t1 < chunk)
            *reinterpret_cast<float2*>(y + ((tok0 + t1) * sh.H + hh) * P +
                                       p) = make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
    __syncthreads();  // stage i & 1 is refilled for head i + 2
  }
}

// f32 inputs: C.B^T once per block into registers (an 8x8 tile per thread,
// rows ti + 16i, columns si + 16j, only j <= i), then per head S' into
// shared memory and y from a tile of 8 consecutive tokens by 4 columns of P
// per thread, which reads S' only up to its own last token.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_fwd_chunk_scan_f32(float* __restrict__ y,
                           const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a_log,
                           int64_t alog_stride,
                           const float* __restrict__ bmat,
                           const float* __restrict__ cmat,
                           const float* __restrict__ states, Shape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sh.P, N = sh.N, chunk = sh.chunk;
  const int lp = pad16(chunk);
  const int ldc = N + 1, ldq = lp + 1;
  const int cbsize = lp * ldc > lp * ldq ? lp * ldc : lp * ldq;
  float* sC = reinterpret_cast<float*>(smem);  // [lp][ldc]
  float* sB = sC + lp * ldc;                   // [lp][ldc], then S' [lp][ldq]
  float* sQ = sB;
  float* sX = sB + cbsize;                     // [lp][P]
  float* sS = sX + lp * P;                     // [P][ldc]
  float* sDt = sS + P * ldc;
  float* sAc = sDt + kMaxHeads * kL;

  const int tid = threadIdx.x;
  const HeadTile ht = head_tile(sh);
  const int c = blockIdx.y, nc = gridDim.y;
  const int64_t row = blockIdx.z;
  const int64_t tok0 = row * sh.S + static_cast<int64_t>(c) * chunk;
  const bool has_state = c > 0;
  const float* st_in =
      has_state ? states + ((row * (nc - 1) + c - 1) * sh.H) * P * N
                : nullptr;

  for (int q = tid; q < lp * N; q += kThreads) {
    const int s = q / N, n = q - s * N;
    const bool ok = s < chunk;
    const int64_t src = ((tok0 + s) * sh.G + ht.g) * N + n;
    sC[s * ldc + n] = ok ? cmat[src] : 0.0f;
    sB[s * ldc + n] = ok ? bmat[src] : 0.0f;
  }
  scan_heads(sDt, sAc, dt, a_log, alog_stride, row, tok0, sh, ht);
  __syncthreads();

  const int ti = tid >> 4, si = tid & 15;
  float cb[kL / 16][kL / 16];
#pragma unroll
  for (int i = 0; i < kL / 16; ++i)
#pragma unroll
    for (int j = 0; j < kL / 16; ++j) cb[i][j] = 0.0f;
  for (int n = 0; n < N; ++n) {
    float cv[kL / 16], bv[kL / 16];
#pragma unroll
    for (int i = 0; i < kL / 16; ++i) {
      cv[i] = 16 * i < lp ? sC[(ti + 16 * i) * ldc + n] : 0.0f;
      bv[i] = 16 * i < lp ? sB[(si + 16 * i) * ldc + n] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kL / 16; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)  // the tiles above the diagonal skipped
        cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
  }
  __syncthreads();  // sB becomes S'

  const int rg = tid >> 4, cg = tid & 15;
  const int r0 = 8 * rg;
  for (int i = 0; i < ht.nh; ++i) {
    const int hh = ht.h0 + i;
    const float* ac = sAc + i * kL;
    const float* dtv = sDt + i * kL;
    for (int q = tid; q < lp * (P / 4); q += kThreads) {
      const int s = q / (P / 4), p4 = q - s * (P / 4);
      *reinterpret_cast<float4*>(sX + s * P + 4 * p4) =
          s < chunk ? *reinterpret_cast<const float4*>(
                          x + ((tok0 + s) * sh.H + hh) * P + 4 * p4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (has_state) {
      const float* src = st_in + static_cast<int64_t>(hh) * P * N;
      for (int q = tid; q < P * (N / 4); q += kThreads) {
        const int p = q / (N / 4), k4 = q - p * (N / 4);
        const float4 v = *reinterpret_cast<const float4*>(src + p * N + 4 * k4);
        float* d = sS + p * ldc + 4 * k4;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
    }
#pragma unroll
    for (int a = 0; a < kL / 16; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const int t = ti + 16 * a, s = si + 16 * b;
        if (16 * a < lp) {
          // a select, not a product with a mask (see the bf16 kernel)
          sQ[t * ldq + s] =
              s <= t ? cb[a][b] * expf(ac[t] - ac[s]) * dtv[s] : 0.0f;
        }
      }
    }
    __syncthreads();

    if (r0 < lp) {
      float acc[8][kPMax / 16];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < kPMax / 16; ++q) acc[r][q] = 0.0f;
      if (has_state) {
        for (int n = 0; n < N; ++n) {
          float cv[8], sv[kPMax / 16];
#pragma unroll
          for (int r = 0; r < 8; ++r) cv[r] = sC[(r0 + r) * ldc + n];
#pragma unroll
          for (int q = 0; q < kPMax / 16; ++q)
            sv[q] = 16 * q < P ? sS[(cg + 16 * q) * ldc + n] : 0.0f;
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int q = 0; q < kPMax / 16; ++q)
              acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float e = expf(ac[r0 + r]);
#pragma unroll
          for (int q = 0; q < kPMax / 16; ++q) acc[r][q] *= e;
        }
      }
      // S' is zero above the diagonal inside the 16 x 16 tiles this thread
      // reads (s <= r0 + 7 lies in a tile j <= i of the writer's layout)
      for (int s = 0; s < r0 + 8; ++s) {
        float qv[8], xv[kPMax / 16];
#pragma unroll
        for (int r = 0; r < 8; ++r) qv[r] = sQ[(r0 + r) * ldq + s];
#pragma unroll
        for (int q = 0; q < kPMax / 16; ++q)
          xv[q] = 16 * q < P ? sX[s * P + cg + 16 * q] : 0.0f;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < kPMax / 16; ++q)
            acc[r][q] = fmaf(qv[r], xv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r0 + r < chunk) {
          float* out = y + ((tok0 + r0 + r) * sh.H + hh) * P;
#pragma unroll
          for (int q = 0; q < kPMax / 16; ++q)
            if (16 * q < P) out[cg + 16 * q] = acc[r][q];
        }
      }
    }
    __syncthreads();  // sX, sS and S' are rewritten for the next head
  }
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// dtype: 0 for f32 x/B/C, 1 for bf16.  states / decay: f32 scratch of
// rows*(nc-1)*H*P*N and rows*(nc-1)*H floats (unused, may be null, when
// nc = 1); hb: heads per block.  *launched receives the number of kernels
// launched.  Returns cudaErrorInvalidValue for a dtype code or a shape the
// kernels do not take, else the first CUDA error of the three launches.
int ssd_fwd(void* y, const void* x, const void* dt, const void* a_log,
            int64_t alog_stride, const void* bmat, const void* cmat,
            void* states, void* decay, int rows, int S, int H, int P, int G,
            int N, int chunk, int hb, int dtype, void* stream,
            int* launched) {
  *launched = 0;
  if (rows <= 0 || rows > 65535 || S <= 0 || H <= 0 || G <= 0 ||
      H % G != 0 || !(P == 16 || P == 32 || P == 64) || N < 16 ||
      N > kNMax || N % 16 != 0 || chunk <= 0 || chunk > kL ||
      S % chunk != 0 || S / chunk > 65535 || hb < 1 || hb > kMaxHeads ||
      (dtype != kF32 && dtype != kBF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = S / chunk, lp = pad16(chunk), rep = H / G;
  const int tiles = (rep + hb - 1) / hb;
  const Shape sh{S, H, P, G, N, chunk, hb};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = dtype == kBF16;
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  const float* d = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  cudaError_t err;

  if (nc > 1) {
    const dim3 grid(G * tiles, nc - 1, rows);
    const size_t bytes = chunk_state_smem(dtype, lp, P, N);
    if (bf) {
      err = set_smem(ssd_fwd_chunk_state_bf16, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      ssd_fwd_chunk_state_bf16<<<grid, kThreads, bytes, st>>>(
          sts, dec, static_cast<const bf16*>(x), d, al, alog_stride,
          static_cast<const bf16*>(bmat), sh);
    } else {
      err = set_smem(ssd_fwd_chunk_state_f32, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      ssd_fwd_chunk_state_f32<<<grid, kThreads, bytes, st>>>(
          sts, dec, static_cast<const float*>(x), d, al, alog_stride,
          static_cast<const float*>(bmat), sh);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;

    const int pn8 = P * N / 8;
    const int64_t threads = static_cast<int64_t>(rows) * H * pn8;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    float4* sts4 = reinterpret_cast<float4*>(sts);
    if (bf) {
      ssd_fwd_state_pass<true>
          <<<blocks, kThreads, 0, st>>>(sts4, dec, rows, nc - 1, H, pn8);
    } else {
      ssd_fwd_state_pass<false>
          <<<blocks, kThreads, 0, st>>>(sts4, dec, rows, nc - 1, H, pn8);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }

  const dim3 grid(G * tiles, nc, rows);
  const size_t bytes = chunk_scan_smem(dtype, lp, P, N);
  if (bf) {
    err = set_smem(ssd_fwd_chunk_scan_bf16, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_fwd_chunk_scan_bf16<<<grid, kThreads, bytes, st>>>(
        static_cast<float*>(y), static_cast<const bf16*>(x), d, al,
        alog_stride, static_cast<const bf16*>(bmat),
        static_cast<const bf16*>(cmat), sts, sh);
  } else {
    err = set_smem(ssd_fwd_chunk_scan_f32, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_fwd_chunk_scan_f32<<<grid, kThreads, bytes, st>>>(
        static_cast<float*>(y), static_cast<const float*>(x), d, al,
        alog_stride, static_cast<const float*>(bmat),
        static_cast<const float*>(cmat), sts, sh);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
