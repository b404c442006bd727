// Fused-update kernels of PersA-FL for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (repro_torch/kernels/_build.py).
//
//   fu_sub_scaled_leaves: out = w - c * b over a table of up to kMaxLeaves
//       leaves in ONE launch: sgd_step (w - eta * g, the Option A step) and
//       apply_scaled (w - s * d, every immediate apply)
//   fu_prox_outer_leaves: out = w - (eta*lam) * (w - t) over such a table
//                                                     (Option C outer step)
//   fu_prox_inner_leaves: out = t - eta_in * (g + lam * (t - w)) over such a
//       table of three inputs                         (Option C inner step)
//   fu_apply_rows_leaves: out = w - sum_i s_i * d_i over a table of leaves and
//       their [M, n] stacks, in ONE launch (every buffered / sync flush, every
//       fp32-banked window)
//   fu_apply_rows_q_leaves: out = w - sum_i (s_i * scale_i) * q_i over a table
//       of leaves, their int8 [M, n] stacks and their [M] row scales, in ONE
//       launch (every int8-banked serving window)
//
// All of them read their inputs once and write the output once, do the
// arithmetic in f32 and keep the storage type of their first operand (f32 or
// bf16; every other float operand may be either, a stack of apply_rows_q is
// int8).  They are memory-bound passes: the bound on an H100 SXM is the bytes
// moved over 3.35 TB/s, and there is nothing to tile for -- the TPU kernels'
// 64K-element padding, 8192-column blocks and SMEM scalar are artefacts of
// that machine and are not carried over.  No kernel allocates, synchronises
// or pads: the ragged tail is masked, and the launch goes on the stream the
// caller passes (PyTorch's current stream).  Each entry point returns the
// value of cudaGetLastError() after its launch, which the Python wrapper
// turns into an exception.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 256;
// the leaf-table kernels: each thread moves kPerThread elements of a tile of
// kTile, and one launch takes at most kMaxLeaves leaves
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxLeaves = 48;
// the stacked applies: a thread issues the loads of kUnroll rows (in
// apply_rows_q's 16-column layout kUnrollQ) before their FMAs; a block's
// threads form at most 2^kMaxGroupsLog2 row groups, each of at least
// kMinGroupRows rows; the host takes the fewest groups that give the grid
// kFillBlocksPerSM blocks per SM; apply_rows_q's kernel is held to
// kRowsQBlocksPerSM resident blocks per SM (80 registers a thread)
constexpr int kUnroll = 8;
constexpr int kUnrollQ = 4;
constexpr int kRowsQBlocksPerSM = 3;
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
// One launch over a table of leaves: sgd_step, apply_scaled, prox_outer and
// prox_inner
// ---------------------------------------------------------------------------
//
// Replace src/repro/kernels/fused_update/kernel.py:78 sgd_step (body
// _sgd_kernel at :39, run by _run_flat at :58), :229 apply_scaled (body
// _apply_scaled_kernel at :95), :90 prox_outer (body _prox_outer_kernel at
// :52, run by _run_flat) and :83 prox_inner (body _prox_inner_kernel at :45,
// run by _run_flat).  The first two compute out = a - c * b, a the params w
// and b the gradient g or the delta d; prox_outer computes
// out = a - c * (a - b), a = w, b = theta and c = eta*lam; prox_inner
// out = t - eta_in * (g + lam * (t - w)) of three inputs.  Bound: the inputs
// read once and the output written once over 3.35 TB/s -- at n = 2^26+3
// 0.2404 ms in f32 and 0.1202 ms in bf16 for two inputs, 0.3205 ms in f32
// for three -- and nothing else; at a param tree of small leaves (the MNIST
// CNN's 8, 52K elements) the bound is 0.2 us and the time is the host's.  The
// TPU's 64K-element BLOCK padding (kernel.py:36, :58-75) is a VMEM tiling and
// is not carried over.  The reference
// jits each tree front into one program; a launch per leaf costs a ctypes call
// and a launch each.  Design:
//   * one launch per param tree: the leaves travel by value, as a __grid_
//     constant__ LeafTable of at most kMaxLeaves entries (out and input
//     pointers, length, first tile, whether the leaf may be moved in
//     vectors), under the 4 KB parameter limit.  __grid_constant__ lets a
//     thread index the table with a run-time leaf number without copying the
//     struct into local memory.  A longer tree, or one whose leaves mix dtype
//     combinations, takes one launch per chunk and combination (the wrapper
//     plans them);
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
//   * every operation is rounded on its own (__fmul_rn, __fsub_rn,
//     __fadd_rn; nvcc would otherwise contract them into one FMA, rounded
//     once), in the plain version's order, so the result is bit-equal to the
//     plain version.  The host rounds each scalar to f32 as the plain version
//     does.
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
static_assert(sizeof(LeafTable<3>) + 24 <= 4096,
              "the table and the arguments beside it fit the 4 KB parameter "
              "limit");

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

// out = t - eta_in * (g + lam * (t - w)), each operation rounded on its own,
// in prox_inner_ref's order
struct ProxInner {
  float eta_in, lam;
  __device__ __forceinline__ float operator()(float t, float g,
                                              float w) const {
    return __fsub_rn(
        t, __fmul_rn(eta_in, __fadd_rn(g, __fmul_rn(lam, __fsub_rn(t, w)))));
  }
};

// kC elements of T that move as one vector load or store, or as several of
// 16 bytes where they are wider
template <typename T, int kC>
struct alignas(sizeof(T) * kC < 16 ? sizeof(T) * kC : 16) Chunk {
  T v[kC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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
    return static_cast<int>(sizeof(T));
  } else {
    constexpr int kT = static_cast<int>(sizeof(T));
    return kT > widest<R...>() ? kT : widest<R...>();
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

// ---------------------------------------------------------------------------
// One launch over a stacked table of leaves: apply_rows and apply_rows_q
// ---------------------------------------------------------------------------
//
// Replaces src/repro/kernels/fused_update/kernel.py:129 apply_rows (body
// _apply_rows_kernel at :114): out = w - sum_i s_i * d_i for every leaf of a
// param tree, d the leaf's [M, n] bank stack and s the [M] f32 row weights
// shared by all leaves; and kernel.py:186 apply_rows_q (body
// _apply_rows_q_kernel at :168), the same sum over an int8 stack q with the
// row coefficient s_i * scale_i, scale the leaf's own [M] f32 row scales.
// Bound: the stacks read once (M·n elements; for apply_rows_q M·n bytes),
// w read and out written, over 3.35 TB/s (at M = 4 over mamba2-130m's leaves
// 1.201 ms for an f32 stack, 0.6004 ms for an int8 one); at the MNIST CNN's
// 8 leaves it is under a microsecond and the time is the host's.  Design:
//   * one launch per param tree, as leaves_kernel: a __grid_constant__
//     LeafTable with in[0] = w, in[1] = the stack and, for apply_rows_q,
//     in[2] = the leaf's scales; one block per tile of columns, no tile
//     straddling two leaves; M and the device pointer of the weights pass
//     beside it;
//   * the block's threads form `groups` row groups (1, 2, 4 or 8, kThreads /
//     groups threads each), every group over all the tile's columns.  Group
//     g sums the rows g, g + groups, g + 2·groups, ... in order into f32
//     accumulators, issuing a few rows' loads, and their row weights' (and
//     scales'), before their FMAs so that many loads are in flight per
//     thread; then the groups' sums are added in shared memory in group
//     order.  The order of the sum is fixed by M and the number of groups:
//     no atomics, no second pass, and two calls on the same inputs are
//     bit-equal.  It differs from the plain version's, so the f32 result
//     agrees within a few ulps.  A row's coefficient is loaded with the row
//     (every thread of a warp reads the same word): staging the weights in
//     shared memory behind a barrier ran no faster on an H100, for
//     apply_rows too;
//   * the host takes the fewest groups, each of at least kMinGroupRows rows,
//     whose grid has kFillBlocksPerSM blocks per SM: one group at M = 4 or
//     8, where a group needs its rows in flight and the columns of a large
//     leaf fill the card anyway, and eight at M = 300 over 2^20 columns,
//     where eight short row loops per tile beat one long one.  On an H100,
//     one group per tile left M = 300 over 2^20+5 columns behind
//     torch.addmv, and eight groups at M = 8 ran a 2^20-column bf16 stack
//     slower than one or two;
//   * a thread owns kChunks chunks of kV columns, kV = 16 bytes of the
//     widest of w and the stack (4 f32 columns); chunk j of a thread lies
//     at column (j · width + lane) · kV of the tile, so that every warp
//     instruction moves one contiguous span.  apply_rows takes one chunk
//     and 8 rows in flight.  apply_rows_q, whose int8 rows are a third of
//     the bytes at M = 4 and nearly all of them from M = 32 on, takes 16
//     columns (four chunks for an f32 w, a 4-byte int8 load each a row) and
//     4 rows in flight, and loads w after the rows; its kernel is held to
//     kRowsQBlocksPerSM blocks per SM, 80 registers, and spills a few
//     words.  On an H100 that ran faster, at M = 4 and at M = 300, than one
//     chunk a thread as apply_rows, than one 16-byte int8 vector a thread
//     (w and out then move in 16-byte vectors 64 bytes apart, and the
//     kernel took every register), and than 16 columns with w held through
//     the row loop (two blocks an SM);
//   * int8 codes are read as the aligned 32-bit words around them and
//     shifted into place (__funnelshift_r by the row's offset within a
//     word), so a row of any length and a stack at any byte take the vector
//     layout; each code becomes f32 exactly by a byte permute and one
//     subtraction rather than an int-to-float conversion, a quarter-rate
//     instruction on Hopper that set the pace at large M;
//   * where the wrapper found the pointers of w and out 16-byte aligned (and
//     for an f32 or bf16 stack also the stack's and its row stride
//     n·sizeof(d), so that every row is aligned and not only the first), a
//     full tile takes the vector layout; otherwise, and in a leaf's last
//     partial tile, a thread's kChunks · kV columns lie kThreads / groups
//     apart, neighbouring threads on neighbouring columns, and move element
//     by element, with fewer rows in flight.  Both layouts sum each column
//     in the same order.  The scales are read by scalar loads and need no
//     alignment;
//   * a zero-weight row with finite contents adds exactly 0 (a padding row
//     of apply_rows_q has weight 0 and scale 0), and M = 0 gives w.  A
//     block's tile belongs to one leaf, so its scales are the block's own.
// This follows the plain versions rather than the TPU kernels for M > 128:
// the TPU kernels round their partial sum to the storage type between
// 128-row chunks (kernel.py:120-126, :168-184), the plain versions keep all
// of it in f32, and so does this kernel.

// kV int8 codes of a stack row in the vector layout: the kV/4 words that
// hold them and the word after, the codes starting `shift` bytes into the
// first (a row of n codes starts on a word only where 4 divides its offset)
template <int kV>
struct Codes {
  uint32_t x[kV / 4 + 1];
};

// the kV values at p of a stack row, as one chunk (p kV-aligned)
template <typename T, int kV>
__device__ __forceinline__ void load_vals(const T* p, int, Chunk<T, kV>& v) {
  v = *reinterpret_cast<const Chunk<T, kV>*>(p);
}
// kV int8 codes at any byte p, `shift` bytes past a word: the aligned words
// around them.  The word after holds codes only if shift > 0; otherwise it
// may lie past the end of the stack and is not read
template <int kV>
__device__ __forceinline__ void load_vals(const int8_t* p, int shift,
                                          Codes<kV>& v) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(p - shift);
#pragma unroll
  for (int i = 0; i < kV / 4; ++i) v.x[i] = a[i];
  v.x[kV / 4] = shift ? a[kV / 4] : 0u;
}

// value k of a loaded chunk as f32
template <typename T, int kV>
__device__ __forceinline__ float val(const Chunk<T, kV>& v, int k, int) {
  return to_f32(v.v[k]);
}
// code k, exactly, without an int-to-float conversion (a quarter-rate
// instruction on Hopper, which would set the pace at large M): its byte b,
// shifted into place, becomes the f32 whose bits are 0x4B0000 | (b ^ 0x80),
// that is 2^23 + 128 + b, and 2^23 + 128 is taken off
template <int kV>
__device__ __forceinline__ float val(const Codes<kV>& v, int k, int shift) {
  const uint32_t word =
      __funnelshift_r(v.x[k >> 2], v.x[(k >> 2) + 1], 8 * shift);
  return __int_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u,
                                    0x7440 | (k & 3))) -
         8388736.0f;
}

// How a thread of the stacked kernels covers its tile, for w of TO and stacks of TD
// over kIn inputs: kChunks chunks of kV columns, kRows rows in flight, w
// loaded after the rows or before them.  apply_rows (kIn = 2): one chunk,
// kUnroll rows, w first; apply_rows_q (kIn = 3, in[2] the leaf's row
// scales): 16 columns, kUnrollQ rows, w last
template <typename TO, typename TD, int kIn>
struct RowsLayout {
  static constexpr int kV = 16 / widest<TO, TD>();
  static constexpr bool kQ = kIn == 3;
  static constexpr int kChunks = kQ ? 16 / kV : 1;
  static constexpr int kRows = kQ ? kUnrollQ : kUnroll;
  static constexpr bool kWLast = kQ;
  static constexpr int kC = kV * kChunks;  // columns of the thread
};

// one tile of a stacked leaf, in the chunk layout (kVec) or the strided one;
// the same for every thread of the block
template <typename TO, typename TD, int kIn, bool kVec>
__device__ __forceinline__ void rows_tile(
    const typename LeafTable<kIn>::Leaf& leaf, int64_t base, int lg,
    const float* __restrict__ weights, int m, float* s_part) {
  using L = RowsLayout<TO, TD, kIn>;
  constexpr int kV = L::kV, kChunks = L::kChunks, kRows = L::kRows;
  constexpr bool kWLast = L::kWLast;
  constexpr int kC = L::kC;
  // int8 rows in the vector layout: realigned words
  constexpr bool kCodes = kVec && std::is_same<TD, int8_t>::value;
  using Vals = std::conditional_t<kCodes, Codes<kV>, Chunk<TD, kV>>;
  // the strided layout loads element by element: fewer rows in flight keep
  // its registers as many as the vector layout's
  constexpr int kLoad = kVec ? kRows : (kRows / kChunks > 0 ? kRows / kChunks
                                                            : 1);
  const int groups = 1 << lg;
  const int width = kThreads >> lg;  // threads in a row group
  const int g = threadIdx.x >> (kThreadsLog2 - lg);
  const int lane = threadIdx.x & (width - 1);
  const int64_t n = leaf.n;
  const TD* d = static_cast<const TD*>(leaf.in[1]);
  // the column of value e of the thread's chunk j: kV neighbours at
  // base + (j * width + lane) * kV, so that every warp instruction moves one
  // contiguous span; strided, base + lane + (j * kV + e) * width
  auto col = [&](int j, int e) -> int64_t {
    return kVec ? base + static_cast<int64_t>(j * width + lane) * kV + e
                : base + lane + static_cast<int64_t>(j * kV + e) * width;
  };
  float acc[kChunks][kV];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
#pragma unroll
    for (int e = 0; e < kV; ++e) acc[j][e] = 0.0f;
  }
  // group 0 writes the output: its w, loaded ahead of the rows, or after
  // them (kWLast) where the registers it would hold through the row loop
  // are better spent on rows in flight
  Chunk<TO, kV> w[kChunks];
  auto load_w = [&]() {
    const TO* pw = static_cast<const TO*>(leaf.in[0]);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if constexpr (kVec) {
        load_vals(pw + col(j, 0), 0, w[j]);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          if (col(j, e) < n) w[j].v[e] = pw[col(j, e)];
        }
      }
    }
  };
  if (!kWLast && g == 0) load_w();
  // apply_rows_q's row scales (read only where kIn == 3)
  const float* scales = static_cast<const float*>(leaf.in[kIn - 1]);
  // group g sums rows g, g + groups, ...: kLoad rows' loads (and their
  // coefficients') are issued before their FMAs
  for (int i = g; i < m; i += kLoad * groups) {
    Vals v[kLoad][kChunks];
    int shift[kLoad];
    float cw[kLoad], cs[kLoad];
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      const int r = i + u * groups;
      if (r < m) {
        cw[u] = __ldg(weights + r);
        if constexpr (kIn == 3) cs[u] = __ldg(scales + r);
        const TD* row = d + r * n;
        shift[u] = kCodes
                       ? static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3)
                       : 0;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          if constexpr (kVec) {
            load_vals(row + col(j, 0), shift[u], v[u][j]);
          } else {
#pragma unroll
            for (int e = 0; e < kV; ++e) {
              if (col(j, e) < n) v[u][j].v[e] = row[col(j, e)];
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoad; ++u) {
      if (i + u * groups < m) {
        // apply_rows_q: the coefficient weights[r] * scales[r], rounded as
        // the plain version rounds it, never contracted into the FMA
        const float s = kIn == 3 ? __fmul_rn(cw[u], cs[u]) : cw[u];
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
#pragma unroll
          for (int e = 0; e < kV; ++e) {
            acc[j][e] = fmaf(s, val(v[u][j], e, shift[u]), acc[j][e]);
          }
        }
      }
    }
  }
  if (kWLast && g == 0) load_w();
  if (groups > 1) {
    // groups 1.. hand their sums to group 0, which adds them in group order;
    // neighbouring lanes on neighbouring words
    if (g > 0) {
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        s_part[((g - 1) * kC + k) * width + lane] = acc[k / kV][k % kV];
      }
    }
    __syncthreads();
    if (g == 0) {
      for (int h = 1; h < groups; ++h) {
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          acc[k / kV][k % kV] += s_part[((h - 1) * kC + k) * width + lane];
        }
      }
    }
  }
  if (g != 0) return;
  TO* out = static_cast<TO*>(leaf.out);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if constexpr (kVec) {
      float r[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) r[e] = to_f32(w[j].v[e]) - acc[j][e];
      store_chunk<TO, kV>(out, col(j, 0), r);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        if (col(j, e) < n) {
          store_f32(out, col(j, e), to_f32(w[j].v[e]) - acc[j][e]);
        }
      }
    }
  }
}

// the block's tile of the table: its leaf and first column, in the vector
// layout where the leaf allows and the tile is full
template <typename TO, typename TD, int kIn>
__device__ __forceinline__ void rows_block(const LeafTable<kIn>& table,
                                           const float* __restrict__ weights,
                                           int m, int lg) {
  constexpr int kC = RowsLayout<TO, TD, kIn>::kC;
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
    rows_tile<TO, TD, kIn, true>(leaf, base, lg, weights, m, s_part);
  } else {
    rows_tile<TO, TD, kIn, false>(leaf, base, lg, weights, m, s_part);
  }
}

template <typename TO, typename TD>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const __grid_constant__ LeafTable<2> table,
                const float* __restrict__ weights, int m, int lg) {
  rows_block<TO, TD, 2>(table, weights, m, lg);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads, kRowsQBlocksPerSM)
    rows_q_kernel(const __grid_constant__ LeafTable<3> table,
                  const float* __restrict__ weights, int m, int lg) {
  rows_block<TO, int8_t, 3>(table, weights, m, lg);
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

// f(Tag<T0>{}, ..., Tag<T(kN-1)>{}) with Ti the storage type of dtype code
// codes[i]; false for a code it does not know.  f returns whether it
// launched.
template <int kN, typename F, typename... Tags>
bool with_dtypes(const int* codes, F&& f, Tags... tags) {
  if constexpr (sizeof...(Tags) == kN) {
    return f(tags...);
  } else {
    return with_dtype(codes[sizeof...(Tags)], [&](auto t) {
      return with_dtypes<kN>(codes, f, tags..., t);
    });
  }
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

// out = op(in[0], ..., in[kIn-1]) over a table of leaves, input k of dtype
// code codes[k] and the output of codes[0]'s; false for a dtype code or a
// table it does not take.  The dispatch's generic lambdas live here, at
// namespace scope, and not inside the extern "C" entry points.
template <int kIn, typename Op>
bool launch_leaves(const int64_t* words, int count, Op op,
                   const int (&codes)[kIn], void* stream) {
  LeafTable<kIn> table;
  if (!fill_table(words, count, kTile, &table)) return false;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtypes<kIn>(codes, [&](auto t0, auto... ts) {
    using TO = typename decltype(t0)::type;
    // one block per tile
    leaves_kernel<Op, TO, TO, typename decltype(ts)::type...>
        <<<table.tiles, kThreads, 0, st>>>(table, op);
    return true;
  });
}

// rows_kernel (kIn = 2) or rows_q_kernel (kIn = 3) over a stacked table, w
// (and out) of TO and the stacks of TD; false for a table or an m it does
// not take
template <int kIn, typename TO, typename TD>
bool launch_rows(const int64_t* words, int count, const float* weights,
                 int64_t m, void* stream) {
  constexpr int kC = RowsLayout<TO, TD, kIn>::kC;
  if (m < 0 || m > INT32_MAX) return false;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the fewest row groups, at most m, whose grid fills the card
  LeafTable<kIn> table;
  int lg = 0;
  if (!fill_table(words, count, kThreads * kC, &table)) return false;
  while (lg < kMaxGroupsLog2 && (int64_t{kMinGroupRows} << (lg + 1)) <= m &&
         table.tiles < kFillBlocksPerSM * sms) {
    ++lg;
    fill_table(words, count, (kThreads >> lg) * kC, &table);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kIn == 3) {
    rows_q_kernel<TO><<<table.tiles, kThreads, 0, st>>>(
        table, weights, static_cast<int>(m), lg);
  } else {
    rows_kernel<TO, TD><<<table.tiles, kThreads, 0, st>>>(
        table, weights, static_cast<int>(m), lg);
  }
  return true;
}

// out = w - sum_i s_i * d_i over a stacked table, w (and out) of dtype code
// w_dtype and the stacks of d_dtype
bool launch_rows_leaves(const int64_t* words, int count, const float* weights,
                        int64_t m, int w_dtype, int d_dtype, void* stream) {
  const int codes[2] = {w_dtype, d_dtype};
  return with_dtypes<2>(codes, [&](auto tw, auto td) {
    using TO = typename decltype(tw)::type;
    using TD = typename decltype(td)::type;
    return launch_rows<2, TO, TD>(words, count, weights, m, stream);
  });
}

// out = w - sum_i (s_i * scale_i) * q_i over a table of leaves, their int8
// stacks and their row scales, w (and out) of dtype code w_dtype
bool launch_rows_q_leaves(const int64_t* words, int count,
                          const float* weights, int64_t m, int w_dtype,
                          void* stream) {
  return with_dtype(w_dtype, [&](auto tw) {
    using TO = typename decltype(tw)::type;
    return launch_rows<3, TO, int8_t>(words, count, weights, m, stream);
  });
}

int status(bool launched) {
  return launched ? static_cast<int>(cudaGetLastError())
                  : static_cast<int>(cudaErrorInvalidValue);
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
  return status(launch_leaves(leaves, count, SubScaled{c},
                              {w_dtype, b_dtype}, stream));
}

// out = w - eta_lam * (w - t) over a table of leaves (the Option C outer
// step): leaves, count and the return as fu_sub_scaled_leaves', b = t.
// eta_lam is eta*lam, formed by the caller in double and rounded to f32 once.
int fu_prox_outer_leaves(const int64_t* leaves, int count, float eta_lam,
                         int w_dtype, int t_dtype, void* stream) {
  return status(launch_leaves(leaves, count, ProxOuter{eta_lam},
                              {w_dtype, t_dtype}, stream));
}

// out = t - eta_in * (g + lam * (t - w)) over a table of leaves (the Option
// C inner step): leaves as fu_sub_scaled_leaves' with three inputs, count *
// 6 int64 per table (output, t, g, w, length, vector flag), every leaf of
// the same dtype triple; the return as fu_sub_scaled_leaves'.
int fu_prox_inner_leaves(const int64_t* leaves, int count, float eta_in,
                         float lam, int t_dtype, int g_dtype, int w_dtype,
                         void* stream) {
  return status(launch_leaves(leaves, count, ProxInner{eta_in, lam},
                              {t_dtype, g_dtype, w_dtype}, stream));
}

// out = w - sum_i weights[i] * d[i] over a table of leaves and their stacks:
// leaves as fu_sub_scaled_leaves', b the leaf's [m, n] row-major stack, and
// the vector flag set only if every row of the stack is 16-byte aligned;
// weights: [m] f32 on the device, m >= 0.  Returns as fu_sub_scaled_leaves.
int fu_apply_rows_leaves(const int64_t* leaves, int count,
                         const void* weights, int64_t m, int w_dtype,
                         int d_dtype, void* stream) {
  return status(launch_rows_leaves(leaves, count,
                                   static_cast<const float*>(weights), m,
                                   w_dtype, d_dtype, stream));
}

// out = w - sum_i (weights[i] * scales[i]) * q[i] over a table of leaves:
// count * 6 int64, per leaf the output pointer, w, the leaf's [m, n] int8
// row-major stack q, its [m] f32 row scales on the device, the length (> 0)
// and the vector flag (set only if out and w are 16-byte aligned: the rows of
// q are read at any byte); weights: [m] f32 on the device shared by every
// leaf, m >= 0.  Returns as fu_sub_scaled_leaves.
int fu_apply_rows_q_leaves(const int64_t* leaves, int count,
                           const void* weights, int64_t m, int w_dtype,
                           void* stream) {
  return status(launch_rows_q_leaves(leaves, count,
                                     static_cast<const float*>(weights), m,
                                     w_dtype, stream));
}

const char* fu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
