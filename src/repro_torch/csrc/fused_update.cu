// Fused-update kernels of PersA-FL for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
//   fu_sub_scaled_leaves: out = w - c * b over a table of up to kMaxLeaves
//       leaves in ONE launch: sgd_step (w - eta * g, the Option A step) and
//       apply_scaled (w - s * d, every immediate apply)
//   fu_prox_outer_leaves: out = w - (eta*lam) * (w - t) over such a table
//                                                     (Option C outer step)
//   fu_apply_rows_leaves: out = w - sum_i s_i * d_i over a table of leaves and
//       their [M, n] stacks, in ONE launch (every buffered / sync flush, every
//       fp32-banked window)
//   fu_prox_inner:   out = t - eta_in * (g + lam * (t - w))
//                                                     (Option C inner step)
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
#include <utility>

namespace {

constexpr int kThreads = 256;
// the leaf-table kernels: each thread moves kPerThread elements of a tile of
// kTile, and one launch takes at most kMaxLeaves leaves
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxLeaves = 48;
// the stacked applies stage the row weights in shared memory this many at a
// time
constexpr int kWeightChunk = 1024;
// apply_rows: a thread issues the loads of this many rows before their FMAs;
// a block's threads form at most 2^kMaxGroupsLog2 row groups, each of at
// least kMinGroupRows rows; the host takes the fewest groups that give the
// grid kFillBlocksPerSM blocks per SM
constexpr int kUnroll = 8;
constexpr int kMaxGroupsLog2 = 3;
constexpr int kMinGroupRows = kUnroll;
constexpr int kFillBlocksPerSM = 32;
constexpr int kThreadsLog2 = 8;
static_assert(kThreads == 1 << kThreadsLog2, "kThreadsLog2 is log2(kThreads)");

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

// ---------------------------------------------------------------------------
// One launch over a table of leaves: sgd_step, apply_scaled and prox_outer
// ---------------------------------------------------------------------------
//
// Replace src/repro/kernels/fused_update/kernel.py:78 sgd_step (body
// _sgd_kernel at :39, run by _run_flat at :58), :229 apply_scaled (body
// _apply_scaled_kernel at :95) and :90 prox_outer (body _prox_outer_kernel at
// :52, run by _run_flat).  The first two compute out = a - c * b, a the
// params w and b the gradient g or the delta d; prox_outer computes
// out = a - c * (a - b), a = w, b = theta and c = eta*lam.  Bound: 2n
// elements read and n written over 3.35 TB/s -- at n = 2^26+3 0.2404 ms in
// f32 and 0.1202 ms in bf16 -- and nothing else; at a param tree of small
// leaves (the MNIST CNN's 8, 52K elements) the bound is 0.2 us and the time
// is the host's.  The reference
// jits each tree front into one program; a launch per leaf costs a ctypes call
// and a launch each.  Design:
//   * one launch per param tree: the leaves travel by value, as a __grid_
//     constant__ LeafTable of at most kMaxLeaves entries (out and input
//     pointers, length, first tile, whether the leaf may be moved in
//     vectors), under the 4 KB parameter limit.  __grid_constant__ lets a
//     thread index the table with a run-time leaf number without copying the
//     struct into local memory.  A longer tree, or one whose leaves mix dtype
//     pairs, takes one launch per chunk and pair (the wrapper plans them);
//   * the leaves are cut into tiles of kTile elements, none straddling two
//     leaves, one block per tile; a block finds its tile's leaf by a scan of
//     the table's tile prefix, the same for every thread of the block.  (A
//     grid capped at a few waves, its blocks looping over tiles, ran slower
//     on an H100 at the LM param trees, one persistent wave slower still);
//   * where the wrapper found all of a leaf's pointers 16-byte aligned, a
//     tile moves in chunks of 16 bytes of the widest operand (4 elements if
//     any operand is f32, else 8 bf16), a narrower operand in proportionally
//     narrower vectors.  Chunk k of thread t is chunk k * kThreads + t of the
//     tile, so every warp instruction reads or writes one contiguous span, and
//     a thread issues the loads of all its kPerThread elements before its
//     first store.  In a leaf's last tile a chunk past the end goes element by
//     element.  A leaf that is not aligned (a view at an odd offset) takes a
//     scalar loop over its tiles, neighbouring threads on neighbouring
//     addresses;
//   * every operation is rounded on its own (__fmul_rn, __fsub_rn; nvcc would
//     otherwise contract them into one FMA, rounded once), in the plain
//     version's order, so the result is bit-equal to the plain version.  The
//     host rounds the scalar to f32 as the plain version does.
// The table and the tile take any number of inputs (a parameter pack); each
// step is an operator of its own.

template <int kIn>
struct LeafTable {
  struct Leaf {
    void* out;
    const void* in[kIn];
    int64_t n;      // elements, > 0
    int32_t tile0;  // the leaf's first tile in the launch
    int32_t vec;    // every pointer 16-byte aligned: vector loads and stores
  } leaf[kMaxLeaves];
  int32_t count;  // leaves in the table
  int32_t tiles;  // tiles over all of them
};
static_assert(sizeof(LeafTable<2>) == 40 * kMaxLeaves + 8,
              "a two-input leaf is 40 bytes");
static_assert(sizeof(LeafTable<3>) + 16 <= 4096,
              "the table and the scalars fit the 4 KB parameter limit");

// out = a - c * b, the multiply and the subtraction rounded separately
struct SubScaled {
  float c;
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __fsub_rn(a, __fmul_rn(c, b));
  }
};

// out = a - c * (a - b), each operation rounded on its own, in
// prox_outer_ref's order
struct ProxOuter {
  float c;
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __fsub_rn(a, __fmul_rn(c, __fsub_rn(a, b)));
  }
};

// kC elements of T that move as one vector load or store
template <typename T, int kC>
struct alignas(sizeof(T) * kC) Chunk {
  T v[kC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float& x, float v) { x = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16& x, float v) {
  x = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T, int kC>
__device__ __forceinline__ void load_chunk(const void* p, int64_t i,
                                           float (&v)[kC]) {
  const Chunk<T, kC> c =
      *reinterpret_cast<const Chunk<T, kC>*>(static_cast<const T*>(p) + i);
#pragma unroll
  for (int k = 0; k < kC; ++k) v[k] = to_f32(c.v[k]);
}

template <typename T, int kC>
__device__ __forceinline__ void store_chunk(void* p, int64_t i,
                                            const float (&v)[kC]) {
  Chunk<T, kC> c;
#pragma unroll
  for (int k = 0; k < kC; ++k) from_f32(c.v[k], v[k]);
  *reinterpret_cast<Chunk<T, kC>*>(static_cast<T*>(p) + i) = c;
}

// the size of the widest of the types
template <typename T, typename... R>
__host__ __device__ constexpr int widest() {
  if constexpr (sizeof...(R) == 0) {
    return sizeof(T);
  } else {
    return sizeof(T) > widest<R...>() ? sizeof(T) : widest<R...>();
  }
}

// element i of the leaf
template <typename Op, typename TO, typename... TI, size_t... I>
__device__ __forceinline__ void leaf_one(
    const typename LeafTable<sizeof...(TI)>::Leaf& leaf, int64_t i,
    const Op& op, std::index_sequence<I...>) {
  store_f32(static_cast<TO*>(leaf.out), i,
            op(load_f32(static_cast<const TI*>(leaf.in[I]), i)...));
}

// the tile at element `base` of an aligned leaf, in chunks; `full` if the
// whole tile lies inside the leaf
template <typename Op, typename TO, typename... TI, size_t... I>
__device__ __forceinline__ void tile_vec(
    const typename LeafTable<sizeof...(TI)>::Leaf& leaf, int64_t base,
    bool full, const Op& op, std::index_sequence<I...> idx) {
  constexpr int kC = 16 / widest<TO, TI...>();
  constexpr int kChunks = kPerThread / kC;
  if (full) {
    float v[sizeof...(TI)][kChunks][kC];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t e = base + (c * kThreads + threadIdx.x) * kC;
      (load_chunk<TI, kC>(leaf.in[I], e, v[I][c]), ...);
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float r[kC];
#pragma unroll
      for (int k = 0; k < kC; ++k) r[k] = op(v[I][c][k]...);
      store_chunk<TO, kC>(leaf.out, base + (c * kThreads + threadIdx.x) * kC,
                          r);
    }
    return;
  }
  for (int c = 0; c < kChunks; ++c) {
    const int64_t e = base + (c * kThreads + threadIdx.x) * kC;
    if (e + kC <= leaf.n) {
      float v[sizeof...(TI)][kC];
      (load_chunk<TI, kC>(leaf.in[I], e, v[I]), ...);
      float r[kC];
#pragma unroll
      for (int k = 0; k < kC; ++k) r[k] = op(v[I][k]...);
      store_chunk<TO, kC>(leaf.out, e, r);
    } else {
      for (int64_t i = e; i < leaf.n; ++i) {
        leaf_one<Op, TO, TI...>(leaf, i, op, idx);
      }
    }
  }
}

template <typename Op, typename TO, typename... TI>
__global__ void __launch_bounds__(kThreads)
    leaves_kernel(const __grid_constant__ LeafTable<sizeof...(TI)> table,
                  const Op op) {
  constexpr auto kIdx = std::index_sequence_for<TI...>{};
  const int t = blockIdx.x;
  int j = 0;
  while (j + 1 < table.count && table.leaf[j + 1].tile0 <= t) ++j;
  const auto& leaf = table.leaf[j];
  const int64_t base = static_cast<int64_t>(t - leaf.tile0) * kTile;
  if (leaf.vec) {
    tile_vec<Op, TO, TI...>(leaf, base, base + kTile <= leaf.n, op, kIdx);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t e = base + k * kThreads + threadIdx.x;
      if (e < leaf.n) leaf_one<Op, TO, TI...>(leaf, e, op, kIdx);
    }
  }
}

// The Option C inner step replaces src/repro/kernels/fused_update/kernel.py:83
// prox_inner (body _prox_inner_kernel at :45, run by _run_flat at :58).
// Bound: 4n elements (3 read, 1 written) over 3.35 TB/s: at n = 2^26+3 in f32
// 0.3205 ms.  Design: one launch per leaf, a grid-stride loop, one element
// per thread per step, neighbouring threads on neighbouring addresses.  The
// TPU's 64K-element BLOCK padding (kernel.py:36, :58-75) is a VMEM tiling and
// is not carried over; the loop bound masks the ragged tail.  Every operation
// is rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn), in the plain
// version's order, so the kernel is bit-equal to its plain version.  The host
// rounds each scalar to f32 as the plain version does.
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

// ---------------------------------------------------------------------------
// One launch over a stacked table of leaves: apply_rows
// ---------------------------------------------------------------------------
//
// Replaces src/repro/kernels/fused_update/kernel.py:129 apply_rows (body
// _apply_rows_kernel at :114): out = w - sum_i s_i * d_i for every leaf of a
// param tree, d the leaf's [M, n] bank stack and s the [M] f32 row weights
// shared by all leaves.  Bound: (M+1)·n elements read and n written over
// 3.35 TB/s (at M = 4 over mamba2-130m's leaves 1.201 ms); at the MNIST
// CNN's 8 leaves it is under a microsecond and the time is the host's.
// Design:
//   * one launch per param tree, as leaves_kernel: a __grid_constant__
//     LeafTable<2> with in[0] = w and in[1] = the stack, one block per tile
//     of columns; M and the device pointer of the weights pass beside it;
//   * the block's threads form `groups` row groups (1, 2, 4 or 8, kThreads /
//     groups threads each), every group over all the tile's columns.  Group
//     g sums the rows g, g + groups, g + 2·groups, ... in order into f32
//     accumulators, issuing kUnroll rows' loads before their FMAs so that
//     many loads are in flight per thread; then the groups' sums are added
//     in shared memory in group order.  The order of the sum is fixed by M
//     and the number of groups: no atomics, no second pass, and two calls on
//     the same inputs are bit-equal.  It differs from the plain version's,
//     so the f32 result agrees within a few ulps;
//   * the host takes the fewest groups, each of at least kMinGroupRows rows,
//     whose grid has kFillBlocksPerSM blocks per SM: one group at M = 4 or
//     8, where a group needs its kUnroll rows in flight and the columns of
//     a large leaf fill the card anyway, and eight at M = 300 over 2^20
//     columns, where eight short row loops per tile beat one long one.  On
//     an H100, one group per tile left M = 300 over 2^20+5 columns behind
//     torch.addmv, eight groups at M = 8 ran a 2^20-column bf16 stack
//     slower than one or two, and more blocks per SM forced through launch
//     bounds spilled registers and ran slower;
//   * a thread owns kC columns of the tile in every row, kC = 16 bytes of the
//     widest type.  Where the wrapper found the pointers of w, out and the
//     stack 16-byte aligned AND the row stride n·sizeof(d) a multiple of 16
//     bytes (so that every row is aligned, not only the first), the kC
//     columns are neighbours, moved as one 16-byte chunk per row (a narrower
//     stack as a narrower vector); otherwise, and in a leaf's last partial
//     tile, they lie kThreads / groups apart, neighbouring threads on
//     neighbouring columns, and move element by element.  Both layouts sum
//     each column in the same order;
//   * the weights are staged in shared memory kWeightChunk rows at a time; a
//     zero-weight row with finite contents adds exactly 0, and M = 0 gives w.
// This follows the plain version rather than the TPU kernel for M > 128: the
// TPU kernel rounds its partial sum to the storage type between 128-row
// chunks (kernel.py:120-126), the plain version keeps all of it in f32, and
// so does this kernel.

// the kC columns of the thread in one row at element offset `row` of the
// stack: one chunk at column c0, or columns c0 + k * step below n
template <typename T, int kC, bool kVec>
__device__ __forceinline__ void load_cols(const T* p, int64_t row, int64_t c0,
                                          int step, int64_t n,
                                          Chunk<T, kC>& v) {
  if constexpr (kVec) {
    v = *reinterpret_cast<const Chunk<T, kC>*>(p + row + c0);
  } else {
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int64_t c = c0 + k * step;
      if (c < n) v.v[k] = p[row + c];
    }
  }
}

// one tile of a stacked leaf, in the chunk layout (kVec) or the strided one;
// the same for every thread of the block
template <typename TO, typename TD, bool kVec>
__device__ __forceinline__ void rows_tile(
    const LeafTable<2>::Leaf& leaf, int64_t base, int lg,
    const float* __restrict__ weights, int64_t m, float* s_w, float* s_part) {
  constexpr int kC = 16 / widest<TO, TD>();
  const int groups = 1 << lg;
  const int width = kThreads >> lg;  // threads in a row group
  const int g = threadIdx.x >> (kThreadsLog2 - lg);
  const int lane = threadIdx.x & (width - 1);
  const int64_t n = leaf.n;
  const int64_t c0 = kVec ? base + lane * kC : base + lane;
  const int step = kVec ? 1 : width;
  const TD* d = static_cast<const TD*>(leaf.in[1]);
  float acc[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) acc[k] = 0.0f;
  // group 0 writes the output: its w is loaded ahead of the rows
  Chunk<TO, kC> w;
  if (g == 0) {
    load_cols<TO, kC, kVec>(static_cast<const TO*>(leaf.in[0]), 0, c0, step,
                            n, w);
  }
  // the chunk loop is uniform across the block, so every thread reaches the
  // barriers
  for (int64_t r0 = 0; r0 < m; r0 += kWeightChunk) {
    const int rows =
        static_cast<int>(m - r0 < kWeightChunk ? m - r0 : kWeightChunk);
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += kThreads) {
      s_w[j] = __ldg(weights + r0 + j);
    }
    __syncthreads();
    for (int j = g; j < rows; j += kUnroll * groups) {
      Chunk<TD, kC> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = j + u * groups;
        if (r < rows) {
          load_cols<TD, kC, kVec>(d, (r0 + r) * n, c0, step, n, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = j + u * groups;
        if (r < rows) {
          const float s = s_w[r];
#pragma unroll
          for (int k = 0; k < kC; ++k) {
            acc[k] = fmaf(s, to_f32(v[u].v[k]), acc[k]);
          }
        }
      }
    }
  }
  if (groups > 1) {
    // groups 1.. hand their sums to group 0, which adds them in group order;
    // neighbouring lanes on neighbouring words
    if (g > 0) {
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        s_part[((g - 1) * kC + k) * width + lane] = acc[k];
      }
    }
    __syncthreads();
    if (g == 0) {
      for (int h = 1; h < groups; ++h) {
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          acc[k] += s_part[((h - 1) * kC + k) * width + lane];
        }
      }
    }
  }
  if (g != 0) return;
  TO* out = static_cast<TO*>(leaf.out);
  if constexpr (kVec) {
    float r[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) r[k] = to_f32(w.v[k]) - acc[k];
    store_chunk<TO, kC>(out, c0, r);
  } else {
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int64_t c = c0 + k * step;
      if (c < n) store_f32(out, c, to_f32(w.v[k]) - acc[k]);
    }
  }
}

template <typename TO, typename TD>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const __grid_constant__ LeafTable<2> table,
                const float* __restrict__ weights, int64_t m, int lg) {
  constexpr int kC = 16 / widest<TO, TD>();
  __shared__ float s_w[kWeightChunk];
  // the sums of groups 1..groups-1: (groups - 1) * kC * (kThreads / groups)
  // floats, fewer than kThreads * kC
  __shared__ float s_part[kThreads * kC];
  const int t = blockIdx.x;
  int j = 0;
  while (j + 1 < table.count && table.leaf[j + 1].tile0 <= t) ++j;
  const auto& leaf = table.leaf[j];
  const int64_t cols = static_cast<int64_t>(kThreads >> lg) * kC;
  const int64_t base = static_cast<int64_t>(t - leaf.tile0) * cols;
  if (leaf.vec && base + cols <= leaf.n) {
    rows_tile<TO, TD, true>(leaf, base, lg, weights, m, s_w, s_part);
  } else {
    rows_tile<TO, TD, false>(leaf, base, lg, weights, m, s_w, s_part);
  }
}

// Replaces src/repro/kernels/fused_update/kernel.py:186 apply_rows_q (body
// _apply_rows_q_kernel at :168).  Bound: M·n int8 bytes, w read and out written
// (8n bytes for f32 w, 4n for bf16) and 8M bytes of weights and scales, over
// 3.35 TB/s; the int8 rows are most of it at every real M.  Design: one launch
// per leaf, one thread per column, ONE f32 accumulator across all M rows, so
// the reduction is one pass with no cross-block step.  The per-row coefficient
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

template <typename TW>
void launch_rows_q(void* out, const void* w, const int8_t* q, const float* s,
                   const float* scale, int64_t m, int64_t n,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  apply_rows_q_kernel<TW><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<TW*>(out), static_cast<const TW*>(w), q, s, scale, m, n);
}

// The table of `count` leaves from `words`: kIn + 3 int64 per leaf, the
// output pointer, the kIn input pointers, the length and the vector flag; a
// leaf takes ceil(n / tile) tiles.  False if count or a length is out of
// range, or the tiles overflow int32.
template <int kIn>
bool fill_table(const int64_t* words, int count, int64_t tile,
                LeafTable<kIn>* table) {
  if (count < 1 || count > kMaxLeaves) return false;
  int64_t tiles = 0;
  for (int j = 0; j < count; ++j) {
    const int64_t* w = words + j * (kIn + 3);
    auto& leaf = table->leaf[j];
    leaf.out = reinterpret_cast<void*>(w[0]);
    for (int k = 0; k < kIn; ++k) {
      leaf.in[k] = reinterpret_cast<const void*>(w[1 + k]);
    }
    leaf.n = w[kIn + 1];
    leaf.vec = w[kIn + 2] != 0;
    if (leaf.n <= 0) return false;
    leaf.tile0 = static_cast<int32_t>(tiles);
    tiles += (leaf.n + tile - 1) / tile;
    if (tiles > INT32_MAX) return false;
  }
  table->count = count;
  table->tiles = static_cast<int32_t>(tiles);
  return true;
}

// out = op(a, b) over a table of leaves, a of dtype code a_dtype (also the
// output's), b of b_dtype; false for a dtype code or a table it does not take
template <typename Op>
bool launch_leaves(const int64_t* words, int count, Op op, int a_dtype,
                   int b_dtype, void* stream) {
  LeafTable<2> table;
  if (!fill_table(words, count, kTile, &table)) return false;
  const int grid = table.tiles;  // one block per tile
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(a_dtype, [&](auto ta) {
    return with_dtype(b_dtype, [&](auto tb) {
      using TA = typename decltype(ta)::type;
      using TB = typename decltype(tb)::type;
      leaves_kernel<Op, TA, TA, TB><<<grid, kThreads, 0, st>>>(table, op);
      return true;
    });
  });
}

// out = w - sum_i s_i * d_i over a stacked table, w (and out) of dtype code
// w_dtype and the stacks of d_dtype; false for a dtype code, a table or an m
// it does not take
bool launch_rows_leaves(const int64_t* words, int count, const float* weights,
                        int64_t m, int w_dtype, int d_dtype, void* stream) {
  if (m < 0) return false;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(w_dtype, [&](auto tw) {
    return with_dtype(d_dtype, [&](auto td) {
      using TO = typename decltype(tw)::type;
      using TD = typename decltype(td)::type;
      constexpr int kC = 16 / widest<TO, TD>();
      // the fewest row groups, at most m, whose grid fills the card
      LeafTable<2> table;
      int lg = 0;
      if (!fill_table(words, count, kThreads * kC, &table)) return false;
      while (lg < kMaxGroupsLog2 &&
             (int64_t{kMinGroupRows} << (lg + 1)) <= m &&
             table.tiles < kFillBlocksPerSM * sms) {
        ++lg;
        fill_table(words, count, (kThreads >> lg) * kC, &table);
      }
      rows_kernel<TO, TD><<<table.tiles, kThreads, 0, st>>>(table, weights, m,
                                                           lg);
      return true;
    });
  });
}

// The Option C inner step's launcher: false for a dtype code it does not know.
// The dispatch's generic lambdas live here, at namespace scope, and not inside
// the extern "C" entry points.
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

}  // namespace

extern "C" {

int fu_max_leaves() { return kMaxLeaves; }

// out = w - c * b over a table of leaves: sgd_step (b = g, c = eta) and
// apply_scaled (b = d, c = s).  leaves: count * 5 int64 on the host, per leaf
// the output pointer, w, b, the length (> 0) and the 16-byte vector flag;
// 1 <= count <= fu_max_leaves(), every leaf of the same dtype pair.  Returns
// cudaErrorInvalidValue for a dtype code or a table it does not take, else
// the value of cudaGetLastError() after its one launch.
int fu_sub_scaled_leaves(const int64_t* leaves, int count, float c,
                         int w_dtype, int b_dtype, void* stream) {
  if (!launch_leaves(leaves, count, SubScaled{c}, w_dtype, b_dtype, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = w - eta_lam * (w - t) over a table of leaves (the Option C outer
// step): leaves, count and the return as fu_sub_scaled_leaves', b = t.
// eta_lam is eta*lam, formed by the caller in double and rounded to f32 once.
int fu_prox_outer_leaves(const int64_t* leaves, int count, float eta_lam,
                         int w_dtype, int t_dtype, void* stream) {
  if (!launch_leaves(leaves, count, ProxOuter{eta_lam}, w_dtype, t_dtype,
                     stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out = w - sum_i weights[i] * d[i] over a table of leaves and their stacks:
// leaves as fu_sub_scaled_leaves', b the leaf's [m, n] row-major stack, and
// the vector flag set only if every row of the stack is 16-byte aligned;
// weights: [m] f32 on the device, m >= 0.  Returns as fu_sub_scaled_leaves.
int fu_apply_rows_leaves(const int64_t* leaves, int count,
                         const void* weights, int64_t m, int w_dtype,
                         int d_dtype, void* stream) {
  if (!launch_rows_leaves(leaves, count, static_cast<const float*>(weights),
                          m, w_dtype, d_dtype, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The Option C inner step.  Returns cudaErrorInvalidValue for a dtype code it
// does not know, else the value of cudaGetLastError() after the launch.  n
// must be > 0.
int fu_prox_inner(void* out, const void* theta, const void* g, const void* w,
                  float eta_in, float lam, int64_t n, int t_dtype, int g_dtype,
                  int w_dtype, void* stream) {
  if (!launch_prox_inner(out, theta, g, w, eta_in, lam, n, t_dtype, g_dtype,
                         w_dtype, stream)) {
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
