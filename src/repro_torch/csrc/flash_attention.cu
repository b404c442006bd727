// Forward flash attention (flash_attention_fwd) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (repro_torch/kernels/_build.py).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:69
// flash_attention_fwd (body _flash_kernel at :24).  For batch row b and
// query head h, with kv head h / (Hq / Hkv), queries q (rows, S, Hq, hd)
// and keys and values k, v (rows, T, Hkv, hd):
//
//   s[i][j] = cap * tanh((q[i].k[j] * hd^-0.5) / cap)    (cap > 0 only)
//   live    = j < T and (j <= i where causal) and i - window < j (window > 0)
//   out[i]  = sum_{live j} exp(s[i][j]) v[j] / sum_{live j} exp(s[i][j])
//
// with the softmax in f32, whatever the storage dtype (f32 or bf16) of q, k,
// v and out.  Query row i sits at position i whatever T is: causal with
// T != S is offset 0, as in _flash_kernel, and the mask of a row past T
// holds every key up to T.  Both kernels below stream only the key tiles
// that a block's rows can see: from the tile that holds q0 - window + 1
// (the first tile without a window) to the last tile of T, or, when causal,
// to the smaller of that and the diagonal tile (the TPU kernel streams
// every tile up to the diagonal, or all of them).  A masked score is
// SELECTED to -inf and its weight to exactly 0, never multiplied by a mask;
// a row whose first tiles are wholly masked keeps m = -inf and l = 0 until
// its first live key, and its rescale factor is then taken as 1, not
// exp(-inf + inf).  A row that sees no key at all (possible only with a
// window narrower than its distance past T) gets zeros, as the plain model
// attention_tiles_ref gives it; attention_ref and the TPU kernel, whose
// masked logits are a finite -1e30, give it the mean of v over the keys.
// No model path makes such a row.
//
// Non-causal and cross-length attention (whisper's encoder: 1500 x 1500;
// its cross-attention: 448 x 1500) meet one hazard the causal walk did not:
// the wgmma kernel's last key tile reads rows past T, which TMA fills with
// zeros, and a zero key scores exactly 0.  The causal mask hid them (j <= i
// < S = T); without it the past-T keys are selected to -inf like any masked
// key: the tile holding T is an edge tile and takes the mask code.  The f32
// kernel bounds its loads by T.
//
// What bounds it on an H100 SXM.  Per head it does 4 * hd FLOPs for each
// live (query, key) pair (q.k and p.v); it must read q, k and v once and
// write out once.  At S = 4096 that is about a thousand FLOPs per byte, so
// it is bound by operations: in bf16 by the tensor cores' 989 TFLOP/s.
//
// Two kernels, picked by dtype (never by a try, nor by shape):
//
// flash_attention_fwd_wgmma<D, kCap>, bf16 at hd 64, 128 and 256.  One block of
// three warpgroups owns 128 query rows of one (batch row, query head):
// warpgroup 2 is the producer, 0 and 1 the consumers of 64 rows each.  Its
// tiles follow the head dim (WgmmaCfg<D>):
//
//     hd   key tile  stages  S = Q.K^T          O += P.V          shared
//     64     128       3     m64n128k16 x 4     m64n64k16 x 8     112 KB
//     128    128       3     m64n128k16 x 8     m64n128k16 x 8    225 KB
//     256     64       2     m64n64k16 x 16     m64n256k16 x 4    193 KB
//
// At hd 256 a 128-key K or V tile would be 64 KB, and three stages of both
// beside the 64 KB Q tile would not fit the 227 KB a block may have: the
// key tile is 64 keys (K and V 32 KB each) in two stages.  64 and not
// FlashAttention-3's 80 keys, so that tiles start at multiples of 64, as
// chip_smoke.py's long-case check asks of the tail it compares.
//   * Loads.  One thread of the producer issues TMA loads through 3-D
//     (B, S, H * hd) tensor maps with 128-byte swizzle (one hd-64 bf16 row is
//     128 bytes; a wider head is hd / 64 such column slices): Q once, then K
//     and V tiles into the ring.  At hd 256 (kSplitKV) K and V have a full
//     and an empty mbarrier each a stage: a consumer frees a K stage as
//     soon as its S product is done and a V stage after P.V, so K is
//     refilled while P.V still reads V, and with two stages a tile's loads
//     have a whole tile's products to land in (with one pair a stage the
//     kernel was 23-37% slower).  At hd 64 and 128 one pair a stage serves
//     both (their three stages leave the slack; the split slowed them
//     7-17%).  A tile never reads into the next batch row: rows past S
//     (of Q) and past T (of K and V) arrive as zeros.  The maps are
//     encoded on the host at every call (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint, so nothing links libcuda; the whole
//     C call, encoding included, took 6.4 us of host time on an NVIDIA H100
//     80GB HBM3 at 700 W).  The producer gives its registers to the consumers
//     (setmaxnreg 24 / 240).
//   * S = Q.K^T: wgmma with bf16 operands from shared memory (both K-major),
//     f32 accumulators, hd / 16 instructions over the column slices.
//   * Online softmax in registers: raw scores (capped first, cap * tanh,
//     where cap > 0) masked by select only on the diagonal (when causal),
//     window-edge and past-T tiles of each consumer (interior tiles skip the
//     mask code), row
//     max and sum reduced over the 4 lanes that share an accumulator row,
//     weights exp2(s * mul - m) with log2 e (and the cap) folded into mul
//     (ex2.approx.ftz, one FMA before it).  l sums the f32 weights; P goes to
//     bf16 pairs in the register fragment of wgmma's A, which is the
//     accumulator's layout.
//   * O += P.V: wgmma m64n{hd}k16 with A = P from registers and B = V from
//     shared memory, MN-major (the transposed descriptor 16-bit types
//     allow), 16 keys an instruction.
//   * Overlap.  At tile i a consumer issues S of tile i + 1 and P.V of tile
//     i together, waits for S only, runs tile i + 1's softmax while P.V is
//     on the tensor cores, then waits for P.V, frees the stage's V (one
//     arrival a consumer warp) and rescales O.  ptxas would hoist the wait
//     for P.V above the softmax; a barrier of the consumer's warps on a
//     predicate of the row sums keeps it below (softmax_done).  The last
//     tile is peeled off the loop, so that no wgmma is issued under a
//     branch (ptxas serialises wgmma whose accumulators a branch merge
//     touches).  The other consumer fills what gaps remain.  At hd 256
//     this keeps O (64 x 256 f32: 128 registers a thread), the next tile's
//     S (32), P (16 bf16 pairs), m, l and the rescale live at once, within
//     the 240 registers setmaxnreg gives a consumer, without spills (nvcc's
//     -Xptxas -v report, which chip_smoke.py prints).
//   * Softcap.  A kernel instance of its own (kCap), so that the uncapped
//     one carries none of its code; its tanh is one tanh.approx.f32
//     (cap_tanh).
//   * Out: O / l as bf16 into the consumer's own 64 rows of the Q tile, in
//     the swizzled layout, then one TMA store a column slice (rows past S
//     are clipped by the map).
//   * Block order: within each (b, h), causal query tiles are issued from the
//     last (the heaviest causal cone) to the first, so the grid's tail is
//     light; without the causal mask every tile walks the same keys and they
//     go in order.  The blocks of one (b, h) run together and share its K/V
//     in L2.
// What it still leaves: the exp2 of every score competes with the tensor
// cores (at hd 64, 128 x 128 weights take the multi-function unit as long
// as the tile's products take the tensor cores), and the softcap's tanh
// takes the same unit (8-16% of the hd-256 kernel's time at gemma2's
// prefill shapes on an NVIDIA H100 80GB HBM3 at 700 W); the diagonal and
// window-edge tiles compute their masked parts; a consumer whose rows see
// none of a tile still multiplies it; at hd 256 the S product of a 64-key
// tile reads its operands from shared memory at about the rate shared
// memory gives; the tensor maps cost host time at every call.
//
// flash_attention_fwd_kernel<D>, f32 at every head dim.  The f32 checks
// need 2e-5, which bf16 products cannot give, so f32 stays on the CUDA
// cores, bound by their 67 TFLOP/s.  One block of 256 threads owns one
// (batch row, query head, 64-row query tile) and walks the key tiles
// itself, with (m, l, acc) in registers.  It stages its query tile once,
// transposed in shared memory; per key tile of 64 rows it stages K
// (transposed) and V with plain loads, then
//   1. forms the 64 x 64 scores with a 4 x 4 register tile per thread
//      (rows 4ty+i, keys 4tx+j; float4 reads of the transposed tiles);
//   2. scales, caps (with the exact tanhf) and masks them and updates the
//      online softmax of its 4 rows, reducing over the 16 lanes that share
//      a row with warp shuffles; the weights go to shared memory, read back
//      only by the same warp;
//   3. adds P.V for its 4 rows and hd/16 columns.
// Shared memory is 3 * 64 * hd + 64 * 64 floats: 64 KB at hd = 64, 112 KB at
// 128, 208 KB at 256 (one block per SM there).  Rows past S are computed but
// not written; keys past T are not read (zeros) and are masked.
//
// The launch goes on the stream the caller passes (PyTorch's current
// stream); the kernels allocate nothing and do not synchronise.
// flash_attention_fwd returns cudaErrorInvalidValue for an argument it does
// not take (a bf16 pointer off 16 bytes, a tensor map the driver refuses),
// the error of cudaFuncSetAttribute if the shared-memory size is refused,
// else the value of cudaGetLastError() after the launch.

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// f32: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

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

template <int D>
constexpr size_t smem_bytes() {
  return (3 * static_cast<size_t>(D) * kTile + kTile * kTile) * sizeof(float);
}

// Rows [row0, row0 + 64) of head `head` of a (rows, L, H, D) tensor,
// transposed: dst[d * 64 + r].  Rows past L are zeros.  A thread reads 4
// consecutive columns of one row; consecutive threads take consecutive rows,
// so the shared-memory writes hit consecutive banks.
template <int D>
__device__ __forceinline__ void stage_transposed(float* dst,
                                                 const float* __restrict__ src,
                                                 int64_t b, int row0, int L,
                                                 int H, int head) {
  const int r = threadIdx.x % kTile;
  const int s = row0 + r;
  for (int g = threadIdx.x / kTile; g < D / 4; g += kThreads / kTile) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < L) load4(src + ((b * L + s) * H + head) * D + 4 * g, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(4 * g + e) * kTile + r] = v[e];
  }
}

// The same rows, row-major: dst[r * D + d].
template <int D>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int64_t b, int row0, int L, int H,
                                           int head) {
  constexpr int kG = D / 4;
  for (int i = threadIdx.x; i < kTile * kG; i += kThreads) {
    const int r = i / kG, g = i - r * kG;
    const int s = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < L) load4(src + ((b * L + s) * H + head) * D + 4 * g, v);
    *reinterpret_cast<float4*>(dst + r * D + 4 * g) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// q, out: [rows, S, Hq, D]; k, v: [rows, T, Hkv, D]; Hq % Hkv == 0 (the
// wrapper checks).  Grid (ceil(S / 64), Hq, rows).
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(float* __restrict__ out,
                               const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v, int S, int T,
                               int Hq, int Hkv, int window, int causal,
                               float softcap, float scale) {
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

  stage_transposed<D>(sQt, q, b, q0, S, Hq, h);

  // the key tiles any row of this block can see
  const int q_last = min(q0 + kTile, S) - 1;
  const int t_tiles = (T + kTile - 1) / kTile;
  const int kt_end = causal ? min(q_last / kTile + 1, t_tiles) : t_tiles;
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
    stage_transposed<D>(sKt, k, b, k0, T, Hkv, hk);
    stage_rows<D>(sV, v, b, k0, T, Hkv, hk);
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
        const bool live = kj < T && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
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
    float* dst = out + ((b * S + qi) * Hq + h) * D;
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[64 * cc + 4 * tx + e] = o[i][4 * cc + e] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd 64 / 128 / 256: wgmma products fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kWgmmaThreads = 3 * kWg;  // consumers 0 and 1, producer 2
constexpr int kBlockQ = 128;           // query rows per block, 64 a consumer
constexpr int kSliceCols = 64;         // bf16 columns of a 128-byte row
constexpr int kSliceRowBytes = 128;
constexpr int kConsumerWarps = 8;      // arrivals that free a stage
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WgmmaCfg {
  static constexpr int kSlices = D / kSliceCols;
  // key rows a tile and stages of the ring: a 64-key tile in two stages at
  // hd 256, whose 128-key K and V tiles would be 64 KB each
  static constexpr int kBlockK = D == 256 ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : 3;
  // K and V on barriers of their own (K freed once S is done), where two
  // stages leave the loads no other slack; else one pair a stage for both
  static constexpr bool kSplitKV = kStages == 2;
  // slice c of the Q tile at c * kQSlice, of a K or V tile at c * kKSlice
  static constexpr int kQSlice = kBlockQ * kSliceRowBytes;
  static constexpr int kKSlice = kBlockK * kSliceRowBytes;
  static constexpr int kQBytes = kSlices * kQSlice;
  static constexpr int kTileBytes = kSlices * kKSlice;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // Q's barrier and a full and an empty one a stage (for K and for V where
  // kSplitKV); + 1024 so that the base can be rounded up to the swizzle's
  // 1024 bytes
  static constexpr size_t kSmemBytes =
      kBarOffset + (1 + (kSplitKV ? 4 : 2) * kStages) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "a block has at most 227 KB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The 64-column box at (col, row, batch) of a (B, S, H * hd) tensor map into
// shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(batch)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int col, int row,
                                          int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(batch)
      : "memory");
}

// wgmma's descriptor of an operand in shared memory at byte address addr,
// 128-byte swizzle (layout 1, bits 62-63): leading and stride byte offsets
// in 16-byte units.  K-major (Q, K): rows of 128 bytes, 8-row groups 1024
// bytes apart (the stride offset; the leading one is unused), and a step of
// 16 columns along K adds 32 bytes to the address.  MN-major (V): 8-key
// groups 1024 bytes apart, 64-column slices lbo bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the fence, commit and wait (their asm names none of them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x; -inf gives 0 (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A.B, A and B in shared memory,
// both K-major (trans-a = trans-b = 0).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) = (scale_d ? d : 0) + A.B, A and B in shared memory,
// both K-major (trans-a = trans-b = 0).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A.B, A (64 x 16 bf16) from registers in the
// accumulator-matching fragment, B in shared memory MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A.B, A (64 x 16 bf16) from registers in the
// accumulator-matching fragment, B in shared memory MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A.B, A (64 x 16 bf16) from registers in the
// accumulator-matching fragment, B in shared memory MN-major (trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N) = (scale_d ? d : 0) + A.B from shared memory, N = 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

// d (64 x N) += A.B, A from registers, N = 64, 128 or 256
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// S = Q.K^T of one consumer's 64 rows (its Q slice rows at sQw) against the
// key tile at kst: hd / 16 instructions of m64n{kBlockK}k16, committed as one
// group.
template <int D>
__device__ __forceinline__ void issue_scores(
    float (&s)[WgmmaCfg<D>::kBlockK / 2], uint32_t sQw, uint32_t kst) {
  using Cfg = WgmmaCfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;  // 16 columns are 32 bytes
    wgmma_ss<Cfg::kBlockK>(
        s, smem_desc(sQw + (kk / 4) * Cfg::kQSlice + col, 16, 1024),
        smem_desc(kst + (kk / 4) * Cfg::kKSlice + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// o += P.V of the V tile at vst, 16 keys an instruction of m64n{hd}k16,
// committed as one group.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&p)[WgmmaCfg<D>::kBlockK / 4],
    uint32_t vst) {
  using Cfg = WgmmaCfg<D>;
#pragma unroll
  for (int kk = 0; kk < Cfg::kBlockK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                           p[4 * kk + 3]};
    wgmma_rs<D>(o, a, smem_desc(vst + kk * 16 * kSliceRowBytes,
                                Cfg::kKSlice, 1024));
  }
  wgmma_commit();
}

// What a consumer thread's softmax needs to know of its rows: the
// consumer's first row, this thread's row (and row + 8), its column quad,
// the keys' length T, the window, whether the mask is causal, the factor
// cap_in that takes a raw score into the cap's tanh (kernels with a
// softcap), and mul, the factor into log2 units of a raw (or capped) score.
struct TileRows {
  int first, row, cq, T, window, causal;
  float cap_in, mul;
};

// The softcap's tanh on every score: cap * tanh(x / cap) is taken as
// tanh(x * cap_in), cap folded into mul.  tanh.approx.f32 is one
// instruction of the multi-function unit (relative error below 2^-10.9, a
// quarter of the bf16 rounding P takes after it); the exact tanhf cost
// about as much as the rest of the softmax and set the pace of the hd-256
// kernel: 1.381 against 0.9718 ms without the cap at (8, 4096) on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py's ms_no_softcap).
__device__ __forceinline__ float cap_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile of N keys (keys k0 ..), in place: the
// raw scores s become the f32 weights exp2(s * mul - m_new), m the new
// running max (in log2 units) of rows `row` (r = 0) and row + 8 (r = 1),
// alpha the factor that rescales the rows' earlier o and l, rs the rows'
// partial sums of the weights (over this thread's columns).  Scores are
// capped first (kCap) and masked by select to -inf only where the tile
// meets a masked pair of the consumer's 64 rows.
template <int N, bool kCap>
__device__ __forceinline__ void tile_weights(float (&s)[N / 2], float (&m)[2],
                                             float (&alpha)[2],
                                             float (&rs)[2], int k0,
                                             const TileRows& q) {
  if constexpr (kCap) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) s[e] = cap_tanh(s[e] * q.cap_in);
  }
  // the diagonal tile (causal), the tile that holds T (its rows past T are
  // TMA's zeros, which would score 0) and the window's first tile
  const bool edge = (q.causal && k0 + N - 1 > q.first) || k0 + N > q.T ||
                    (q.window > 0 && k0 <= q.first + 63 - q.window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q.row + (e >> 1) * 8;
        const int kj = k0 + 8 * j + 2 * q.cq + (e & 1);
        const bool live = kj < q.T && (!q.causal || kj <= qi) &&
                          (q.window <= 0 || kj > qi - q.window);
        s[4 * j + e] = live ? s[4 * j + e] : -INFINITY;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[r], mt * q.mul);  // mul > 0
    // no live key yet: nothing to rescale (exp(-inf + inf) would be NaN),
    // and every weight is exp2(-inf) = 0
    alpha[r] = m_new == -INFINITY ? 1.f : ex2(m[r] - m_new);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w = ex2(fmaf(s[4 * j + 2 * r + e], q.mul, -m_use));
        s[4 * j + 2 * r + e] = w;
        sum += w;
      }
    }
    rs[r] = sum;
    m[r] = m_new;
  }
}

// Applies a tile's weights: o and l rescaled by alpha, l += rs, and the
// weights s packed into P, bf16 pairs in wgmma's A fragment (which is the
// accumulator's layout: p[i] holds s[2i], s[2i + 1]).
template <int D, int N>
__device__ __forceinline__ void next_weights(float (&o)[D / 2], float (&l)[2],
                                             uint32_t (&p)[N / 4],
                                             const float (&s)[N / 2],
                                             const float (&alpha)[2],
                                             const float (&rs)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * r] *= alpha[r];
      o[4 * j + 2 * r + 1] *= alpha[r];
    }
  }
#pragma unroll
  for (int e = 0; e < N / 4; ++e) {
    p[e] = pack_bf16(s[2 * e], s[2 * e + 1]);
  }
}

// Ends a consumer's softmax of a tile before it waits for P.V.  ptxas
// places the wait for an in-flight wgmma group as early as its block
// allows: above the softmax, which then ran after P.V instead of under it
// (the kernels' SASS shows it).  The wait is not moved above a barrier, and
// this barrier of the consumer's 4 warps (named barrier 3 + wg) takes a
// predicate of the row sums (true unless a sum is NaN; its result is not
// read), so it cannot come before them: the whole softmax stays above the
// wait.
__device__ __forceinline__ void softmax_done(int wg, const float (&rs)[2]) {
  asm volatile(
      "{\n.reg .pred q, r;\nsetp.ge.f32 q, %2, 0f00000000;\n"
      "bar.red.and.pred r, %0, %1, q;\n}\n" ::"r"(3 + wg),
      "r"(kWg), "f"(rs[0] + rs[1])
      : "memory");
}

// Frees a stage: one arrival a consumer warp on its empty barrier.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// q, out: (rows, S, Hq * D); k, v: (rows, T, Hkv * D), as tensor maps with
// 64-column boxes of kBlockQ (q), WgmmaCfg<D>::kBlockK (k, v) and 64 (out)
// rows.  Grid (ceil(S / kBlockQ), Hq, rows), kWgmmaThreads threads.  kCap:
// softcap > 0 (an instance of its own, so that the kernel without a cap
// carries no code of it).
template <int D, bool kCap>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    flash_attention_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap to, int S,
                              int T, int Hq, int Hkv, int window, int causal,
                              float softcap, float scale) {
  using Cfg = WgmmaCfg<D>;
  constexpr int kBlockK = Cfg::kBlockK;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + Cfg::kQBytes;              // stage st: + st * tile
  const uint32_t sV = sK + kStages * Cfg::kTileBytes;
  // barriers of stage st at + 8 * st; without kSplitKV, V's are K's
  constexpr bool kSplit = Cfg::kSplitKV;
  const uint32_t qbar = base + Cfg::kBarOffset;
  const uint32_t full_k = qbar + 8;
  const uint32_t empty_v = full_k + 8 * kStages;
  const uint32_t full_v = kSplit ? empty_v + 8 * kStages : full_k;
  const uint32_t empty_k = kSplit ? full_v + 8 * kStages : empty_v;

  // causal: the heaviest cones first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * kBlockQ;
  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int t_tiles = (T + kBlockK - 1) / kBlockK;
  const int kt_end =
      causal ? min(q_last / kBlockK + 1, t_tiles) : t_tiles;
  // at least one tile, so that the consumers' first product has a stage to
  // wait for: a block whose window starts past T walks T's last tile, every
  // key of it masked for its rows (their out is 0)
  const int kt_begin =
      min(window > 0 ? max(q0 - window + 1, 0) / kBlockK : 0, kt_end - 1);
  const int n_tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(empty_v + 8 * st, kConsumerWarps);
      if constexpr (kSplit) {
        mbar_init(full_v + 8 * st, 1);
        mbar_init(empty_k + 8 * st, kConsumerWarps);
      }
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == 2) {
    // the producer: one thread keeps the ring's loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 2 * kWg) {
      mbar_expect_tx(qbar, Cfg::kQBytes);
#pragma unroll
      for (int c = 0; c < Cfg::kSlices; ++c) {
        tma_load(sQ + c * Cfg::kQSlice, &tq, qbar, h * D + c * kSliceCols,
                 q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        // the first pass over the ring finds every stage free
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (kt_begin + i) * kBlockK;
        mbar_wait(empty_k + 8 * st, parity);
        mbar_expect_tx(full_k + 8 * st, (kSplit ? 1 : 2) * Cfg::kTileBytes);
#pragma unroll
        for (int c = 0; c < Cfg::kSlices; ++c) {
          tma_load(sK + st * Cfg::kTileBytes + c * Cfg::kKSlice, &tk,
                   full_k + 8 * st, hk * D + c * kSliceCols, k0, b);
        }
        if constexpr (kSplit) {
          mbar_wait(empty_v + 8 * st, parity);
          mbar_expect_tx(full_v + 8 * st, Cfg::kTileBytes);
        }
#pragma unroll
        for (int c = 0; c < Cfg::kSlices; ++c) {
          tma_load(sV + st * Cfg::kTileBytes + c * Cfg::kKSlice, &tv,
                   full_v + 8 * st, hk * D + c * kSliceCols, k0, b);
        }
      }
    }
    return;
  }

  // a consumer: rows r_first .. r_first + 63; this thread holds rows `row`
  // and row + 8 of the accumulators, columns 8j + 2cq + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = threadIdx.x % kWg;
  const int lane = t % 32;
  const int r_first = q0 + 64 * wg;
  const TileRows rows{r_first, r_first + 16 * (t / 32) + lane / 4, lane % 4,
                      T, window, causal, kCap ? scale / softcap : 0.f,
                      kCap ? softcap * kLog2e : scale * kLog2e};
  const uint32_t sQw = sQ + wg * 64 * kSliceRowBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[kBlockK / 2];     // the scores, then the f32 weights, of a tile
  uint32_t p[kBlockK / 4];  // the bf16 weights P.V takes
  float alpha[2], rs[2];

  // tile 0's scores and weights; then, at tile i, the scores of tile i + 1
  // and P.V of tile i go to the tensor cores together, and tile i + 1's
  // softmax runs while P.V does
  mbar_wait(qbar, 0);
  mbar_wait(full_k, 0);
  wgmma_fence();
  issue_scores<D>(s, sQw, sK);
  wgmma_wait<0>();
  fence_regs(s);
  if constexpr (kSplit) release(empty_k, lane);
  tile_weights<kBlockK, kCap>(s, m, alpha, rs, kt_begin * kBlockK, rows);
  next_weights<D, kBlockK>(o, l, p, s, alpha, rs);
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int st = i % kStages;
    const int st1 = (i + 1) % kStages;
    mbar_wait(full_k + 8 * st1, ((i + 1) / kStages) & 1);
    if constexpr (kSplit) mbar_wait(full_v + 8 * st, (i / kStages) & 1);
    fence_regs(o);
    fence_regs(p);
    fence_regs(s);
    wgmma_fence();
    issue_scores<D>(s, sQw, sK + st1 * Cfg::kTileBytes);
    issue_pv<D>(o, p, sV + st * Cfg::kTileBytes);
    wgmma_wait<1>();  // the scores of tile i + 1
    fence_regs(s);
    if constexpr (kSplit) release(empty_k + 8 * st1, lane);
    tile_weights<kBlockK, kCap>(s, m, alpha, rs,
                                (kt_begin + i + 1) * kBlockK, rows);
    softmax_done(wg, rs);
    wgmma_wait<0>();  // o += P.V of tile i
    fence_regs(o);
    fence_regs(p);  // read by P.V until here: keep its registers
    release(empty_v + 8 * st, lane);
    next_weights<D, kBlockK>(o, l, p, s, alpha, rs);
  }
  // P.V of the last tile (no stage need be freed: nothing more is loaded)
  const int last = n_tiles - 1;
  if constexpr (kSplit) {
    mbar_wait(full_v + 8 * (last % kStages), (last / kStages) & 1);
  }
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  issue_pv<D>(o, p, sV + (last % kStages) * Cfg::kTileBytes);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);

  // out = o / l, through this consumer's 64 rows of the Q tile (its own
  // products from them are done) in the swizzled layout of the out map
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  const int g = lane / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = 16 * (t / 32) + g + 8 * r;  // row in the 64; rr % 8 == g
      const uint32_t addr = sQw + (j / 8) * Cfg::kQSlice +
                            rr * kSliceRowBytes + (((j % 8) ^ g) << 4) +
                            4 * rows.cq;
      const uint32_t val = pack_bf16(o[4 * j + 2 * r] * inv[r],
                                     o[4 * j + 2 * r + 1] * inv[r]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWg) : "memory");
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < Cfg::kSlices; ++c) {
      tma_store(&to, sQw + c * Cfg::kQSlice, h * D + c * kSliceCols, r_first,
                b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once; null if the driver does
// not have it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, L, cols) bf16 tensor as a 3-D tensor map whose box is 64
// columns (128 bytes, swizzled) by box_rows rows of one batch row; rows past
// L read as zeros and are not written.
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int L, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * 2 * L};
  const cuuint32_t box[3] = {kSliceCols, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(void* out, const void* q, const void* k, const void* v,
                 int rows, int S, int T, int Hq, int Hkv, int window,
                 int causal, float softcap, cudaStream_t stream) {
  const uintptr_t addrs =
      reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(q) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  if (addrs % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  constexpr int kBlockK = WgmmaCfg<D>::kBlockK;
  if (!encode_map(&tq, q, rows, S, Hq * D, kBlockQ) ||
      !encode_map(&tk, k, rows, T, Hkv * D, kBlockK) ||
      !encode_map(&tv, v, rows, T, Hkv * D, kBlockK) ||
      !encode_map(&to, out, rows, S, Hq * D, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = softcap > 0.f ? flash_attention_fwd_wgmma<D, true>
                                    : flash_attention_fwd_wgmma<D, false>;
  const size_t bytes = WgmmaCfg<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, rows);
  kernel<<<grid, kWgmmaThreads, bytes, stream>>>(
      tq, tk, tv, to, S, T, Hq, Hkv, window, causal, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(void* out, const void* q, const void* k, const void* v, int rows,
           int S, int T, int Hq, int Hkv, int window, int causal,
           float softcap, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((S + kTile - 1) / kTile, Hq, rows);
  flash_attention_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), S, T, Hq,
      Hkv, window, causal, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(int D, void* out, const void* q, const void* k,
                 const void* v, int rows, int S, int T, int Hq, int Hkv,
                 int window, int causal, float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64>(out, q, k, v, rows, S, T, Hq, Hkv, window, causal,
                        softcap, stream);
    case 128:
      return launch<128>(out, q, k, v, rows, S, T, Hq, Hkv, window, causal,
                         softcap, stream);
    case 256:
      return launch<256>(out, q, k, v, rows, S, T, Hq, Hkv, window, causal,
                         softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, out: (rows, S, Hq, head_dim); k, v: (rows, T, Hkv, head_dim).  causal:
// 0 or 1.  dtype: 0 for f32 q/k/v/out, 1 for bf16.  bf16 runs
// flash_attention_fwd_wgmma, f32 flash_attention_fwd_kernel.  Returns
// cudaErrorInvalidValue for a dtype code, head_dim or shape the kernels do
// not take.
int flash_attention_fwd(void* out, const void* q, const void* k,
                        const void* v, int rows, int S, int T, int Hq,
                        int Hkv, int head_dim, int window, int causal,
                        float softcap, int dtype, void* stream) {
  if (rows <= 0 || rows > 65535 || S <= 0 || T <= 0 || Hq <= 0 ||
      Hq > 65535 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      (causal != 0 && causal != 1) || !(softcap >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return dispatch_f32(head_dim, out, q, k, v, rows, S, T, Hq, Hkv, window,
                        causal, softcap, st);
  }
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64:
      return launch_wgmma<64>(out, q, k, v, rows, S, T, Hq, Hkv, window,
                              causal, softcap, st);
    case 128:
      return launch_wgmma<128>(out, q, k, v, rows, S, T, Hq, Hkv, window,
                               causal, softcap, st);
    case 256:
      return launch_wgmma<256>(out, q, k, v, rows, S, T, Hq, Hkv, window,
                               causal, softcap, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
