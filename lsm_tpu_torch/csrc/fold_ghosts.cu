// K4: fold of the ghost-shell cotangents of a padded buffer into its
// interior (the transpose of K2), out of place; and K5: zeroing of the ghost
// shells in place.
//
// K4 replaces the TPU kernel lsm_tpu/ops/weno_v2_bwd.py
// `fold_ghost_cotangent_fast`; K5 replaces `_zero_pad_shells` there.
//
// K4. K2 writes the ghosts of axis 0, then axis 1 (over axis 0's padded
// extent), then axis 2 (over the padded extents of axes 0 and 1), each ghost
// a weighted sum of interior nodes of its line. Its transpose, the plain
// version (ops/weno_v2_bwd.py `fold_ghost_cotangent_plain`), scatters in the
// reverse order: axis 2's pass, then axis 1's, then axis 0's, each adding
// w * ghost onto the ghost's source nodes (left side, then right side, ghost
// distance k = 1..3; periodic, shared endpoint: left k <- node n-1-k, right
// k <- node k; symmetry: left k <- node k, right k <- node n-1-k;
// extrapolation of degree P <= 7: K2's Lagrange weights, nodes j = 0..P from
// the boundary inward), then zeroing that axis's ghosts. A ghost that an
// earlier pass has added to (an edge or corner of the shell) passes on its
// partial sum.
//
// Design: one launch that reads g and writes every node of a new buffer gf
// exactly once, so the caller needs no copy of g (the stage backward used to
// clone the whole cotangent and fold the clone in place: 2 x 556 MB at
// 512^3 f32 besides the fold). A ghost of gf is 0. An interior node gathers
// what the scatter would add to it, in the scatter's order: g at the node,
// then axis 2's contributions, then axis 1's, then axis 0's, each side 0 k =
// 1..3 then side 1 k = 1..3, each product and sum rounded on its own
// (__fmul_rn/__fadd_rn), so gf equals the plain version bit for bit. A
// contribution from a ghost of axis 1 or 0 takes that ghost's partial sum
// from the earlier passes, which the thread recomputes from g in registers
// (V2, then V1 below); at a vertex of the shell's strips that is at most 7^3
// reads, and only the nodes within max(4, P+1) of a face (8 (P+1)^3 of them
// at a vertex) take that path. g is only read and gf only written: no race.
//
// The bulk (nodes farther than max(4, P+1) from every face, 92% of the
// buffer at 512^3) is a straight copy: a flat pass reads and writes the
// buffer as 16-byte vectors (the buffer is 16-byte aligned as a whole though
// its rows of 518 floats are not), each thread eight vectors a block's width
// apart, every load issued before the stores. Its other vectors go node by
// node: a ghost is written 0, a node of a bulk row (i and j in the bulk's
// ranges) gathers axis 2's contributions only. The interior nodes of the
// strip rows (8,128 rows at 512^3) take one thread a node and the whole
// gather; their blocks are interleaved in proportion with the flat pass's,
// so that their chains of loads run beside its stream (on an H100 at 512^3
// f32, 0.395 ms of device time against 0.435 with them after it,
// tools/shell_variants.py). g off 16-byte alignment
// (a view handed over by autograd) is read an element at a time. Index math
// is 32-bit within a block (a fast division by the plane and row lengths),
// from a 64-bit base per block.
//
// K5. One launch, 3D or 2D, over the gaps between the interior rows of the
// buffer read as flat memory (zero_shells_kernel, below): the long gaps
// (head, tail, between planes) as 16-byte stores, the six-element seams
// between two rows of a plane a few lanes each; no interior node is read or
// written. On an H100 at 512^3 f32 it takes 0.028 ms of device time, its
// first design (one thread a ghost node of the six slabs, each decoding its
// node with 64-bit divisions) 0.042; the seams bind (below).
//
// Bound: K4 reads g and writes gf whole, 2 x 518^3 x 4 B at 512^3 f32: 0.332
// ms at 3.35 TB/s (the copy it replaces moved the same bytes, and the
// in-place fold after it some 40 MB more). K5 writes the shells only, 19 MB
// at 512^3 f32: 0.0057 ms; its 261,632 seams of 24 B fall across 32-byte
// sectors, so with every sector they touch counted whole about 0.008 ms.
//
// The 2D entries (lsm_fold_ghosts_2d_*, lsm_zero_shells_2d_*) take a 2D
// field's (n0+6, n1+6) buffer, the dense 2D stepper's. K4's is the transpose
// of K2's 2D entry (axis 0's ghosts over the interior columns, then axis 1's
// over every padded row): its plain version scatters axis 1's pass over every
// padded row, then axis 0's over the interior columns. One launch, one thread
// a node of the buffer, rows fastest: a ghost is written 0, a node of the
// bulk (farther than max(4, P+1) from both faces of each axis) copies g, a
// node of the strips gathers what the scatter adds to it, in its order: g at
// the node, axis 1's contributions (V1), then axis 0's, w * V1(ghost), where
// V1 of an axis-0 ghost row (its corner contributions) is recomputed from g.
// An axis of 1-3 nodes (Extrapolation of degree <= n-1) has no bulk: each of
// its nodes gathers from both faces, side 0 first. K5's is the 3D design
// on one plane of n0 rows (head and tail 3 rows and 3 nodes, seams of 6).
// Bound at 4096^2 f32: g read and gf written once, 2 x 4102^2 x 4 B =
// 134.6 MB, 0.040 ms at 3.35 TB/s; K5's 0.39 MB of shells, launch latency.
//
// K4's table route (lsm_fold_table_*): a buffer with an Extrapolation of
// degree above LSM_MAX_DEGREE runs the same kernels, one launch (3D
// fold_kernel, 2D fold_2d_kernel, instantiated on WeightSource kTable), the
// gather's weights read from a table of the buffer's type (refresh_ghosts.cu
// WeightTable) in place of FoldArgs' own; its strips are max(4, P + 1) nodes
// deep. Its first design (a copy of g, a gather launch an axis, three
// zeroing launches) took 1.07 ms of device time at 512^3 f32 under
// Extrapolation(8) on an H100, this one 0.63; the bound is the by-value
// route's, 0.332 ms (tools/ab_degree.sh).

#include <cuda_runtime.h>

#include "fast_div.cuh"
#include "lsm_kernels.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_add_rn(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}
__device__ __forceinline__ double mul_add_rn(double acc, double w, double x) {
  return __dadd_rn(acc, __dmul_rn(w, x));
}

// 16 bytes at an aligned address, as an array of 4 floats or 2 doubles
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load16(const double* p, double (&x)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x, x[1] = v.y;
}
__device__ __forceinline__ void store16(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&x)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}

template <typename T>
struct FoldArgs {
  int n[3];                          // interior extents
  uint32_t S1, S2, plane;            // padded extents of axes 1 and 2; S1 * S2
  FastDiv div_plane, div_row;
  int lo[3], hi[3];                  // the bulk: padded index in [lo, hi) on each axis
  uint32_t flat_blocks;              // blocks of the flat pass
  FastDiv div_n2;
  uint32_t cnt_planes, cnt_rows;     // threads of the strip rows' two ranges
  int kind[3][2], degree[3][2];      // per axis and side
  T w[3][2][LSM_GHOST][LSM_MAX_DEGREE + 1];  // [axis][side][k-1][j], in T
  // the table route's weights (kTable): node j for the ghost at distance k of
  // side s of axis a at table[((2 a + s) * 3 + k - 1) * stride + j]; the
  // address in two halves, so that the struct keeps the 4-byte alignment (and
  // the by-value kernels their parameters' offsets) in float
  uint32_t table_lo, table_hi;
  int stride;
};

// Where the gather reads its weights (a template parameter of the kernels):
// FoldArgs' w (kArgs, the by-value route) or its table (kTable).
enum WeightSource { kArgs, kTable };

// The weight of the ghost at distance k on `side` of `axis` in interior node
// m of its line, when m is one of that ghost's sources.
template <int kW, typename T>
__device__ __forceinline__ bool weight_of(const FoldArgs<T>& a, int axis, int side, int k, int m,
                                          T& w) {
  const int n = a.n[axis];
  switch (a.kind[axis][side]) {
    case LSM_BC_PERIODIC:
      w = T(1);
      return m == (side == 0 ? n - 1 - k : k);
    case LSM_BC_SYMMETRY:
      w = T(1);
      return m == (side == 0 ? k : n - 1 - k);
    default: {  // LSM_BC_EXTRAPOLATION: node j from the boundary inward
      const int j = side == 0 ? m : n - 1 - m;
      if (j > a.degree[axis][side]) return false;
      if constexpr (kW == kArgs) {
        w = a.w[axis][side][k - 1][j];
      } else {
        const T* table = reinterpret_cast<const T*>(uint64_t{a.table_hi} << 32 | a.table_lo);
        w = table[((2 * axis + side) * LSM_GHOST + k - 1) * a.stride + j];
      }
      return true;
    }
  }
}

// padded index of the ghost at distance k on `side` of an axis of n nodes
__device__ __forceinline__ int ghost_pos(int side, int k, int n) {
  return side == 0 ? LSM_GHOST - k : LSM_GHOST + n - 1 + k;
}

// The products w * x onto interior node m of an axis from the ghosts of its
// line whose sources include m, in the scatter's order (side 0, k = 1..3,
// then side 1); ghost(p) is the line's value at padded index p.
template <int kW, typename T, typename Ghost>
__device__ __forceinline__ T gather_axis(const FoldArgs<T>& a, int axis, int m, T x, Ghost ghost) {
  for (int side = 0; side < 2; ++side)
    for (int d = 1; d <= LSM_GHOST; ++d) {
      T w;
      if (weight_of<kW>(a, axis, side, d, m, w))
        x = mul_add_rn(x, w, ghost(ghost_pos(side, d, a.n[axis])));
    }
  return x;
}

// gf at padded node (i, j, k): 0 on a ghost; on an interior node V0, where
// V2(y) = g(y) + axis 2's contributions to y (y's row), V1(y) = V2(y) +
// w * V2(ghost) over axis 1's ghosts of y's column, V0(y) = V1(y) + w *
// V1(ghost) over axis 0's: the scatter's partial sums, in its order. An
// axis adds nothing to a node outside its strips (the bulk's range).
template <int kW, typename T>
__device__ __forceinline__ T fold_node(const T* __restrict__ g, const FoldArgs<T>& a, int i,
                                       int j, int k) {
  const int mi = i - LSM_GHOST, mj = j - LSM_GHOST, mk = k - LSM_GHOST;
  if (static_cast<unsigned>(mi) >= static_cast<unsigned>(a.n[0]) ||
      static_cast<unsigned>(mj) >= static_cast<unsigned>(a.n[1]) ||
      static_cast<unsigned>(mk) >= static_cast<unsigned>(a.n[2]))
    return T(0);
  const bool strip0 = i < a.lo[0] || i >= a.hi[0], strip1 = j < a.lo[1] || j >= a.hi[1],
             strip2 = k < a.lo[2] || k >= a.hi[2];
  const auto v2 = [&](const T* row) {
    return strip2 ? gather_axis<kW>(a, 2, mk, row[k], [&](int p) { return row[p]; }) : row[k];
  };
  const auto v1 = [&](const T* plane) {
    const T x = v2(plane + static_cast<uint32_t>(j) * a.S2);
    return strip1 ? gather_axis<kW>(a, 1, mj, x, [&](int p) {
      return v2(plane + static_cast<uint32_t>(p) * a.S2);
    }) : x;
  };
  const T x = v1(g + static_cast<int64_t>(i) * a.plane);
  return strip0 ? gather_axis<kW>(a, 0, mi, x, [&](int p) {
    return v1(g + static_cast<int64_t>(p) * a.plane);
  }) : x;
}

constexpr int kVectors = 8;  // 16-byte vectors a thread, kThreads apart

// A node of a bulk row (i and j in the bulk's ranges, k interior): g plus
// axis 2's contributions.
template <int kW, typename T>
__device__ __forceinline__ T row_node(const T* __restrict__ g, const FoldArgs<T>& a, int i, int j,
                                      int k) {
  const T* row = g + (static_cast<int64_t>(i) * a.plane + static_cast<uint32_t>(j) * a.S2);
  if (k >= a.lo[2] && k < a.hi[2]) return row[k];
  return gather_axis<kW>(a, 2, k - LSM_GHOST, row[k], [&](int p) { return row[p]; });
}

// flat_blocks of the blocks (interleaved in proportion with the others, so
// that the strip rows' chains of loads run beside the flat pass's stream)
// pass over the buffer as 16-byte vectors: a vector of the bulk is copied
// (every load issued before the stores); of the others, a ghost is written
// 0 and a node of a bulk row its row_node, node by node; the interior nodes
// of the strip rows (i and j interior, not both in the bulk's ranges) are
// left to the other blocks, one thread a node (fold_node). Every node of gf
// is written once. The weights from kW.
template <typename T, int kW>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const T* __restrict__ g, T* __restrict__ gf, int64_t numel, int vec,
                FoldArgs<T> a) {
  constexpr int W = 16 / sizeof(T);  // elements a vector
  // flat blocks before this one, and up to it
  const uint64_t b = blockIdx.x;
  const uint32_t before = static_cast<uint32_t>(b * a.flat_blocks / gridDim.x);
  const uint32_t upto = static_cast<uint32_t>((b + 1) * a.flat_blocks / gridDim.x);
  const auto in_bulk = [&](int p, int axis) { return p >= a.lo[axis] && p < a.hi[axis]; };
  if (upto > before) {
    const int64_t base = static_cast<int64_t>(before) * (kThreads * kVectors * W);
    // the block's first element: plane i0, offset r0 within it
    uint32_t i0, r0;
    if (base < (int64_t{1} << 31)) {
      i0 = quo(a.div_plane, static_cast<uint32_t>(base));
      r0 = static_cast<uint32_t>(base) - i0 * a.plane;
    } else {
      i0 = static_cast<uint32_t>(base / a.plane);
      r0 = static_cast<uint32_t>(base - static_cast<int64_t>(i0) * a.plane);
    }
    const T* gb = g + base;
    T* fb = gf + base;
    const int64_t left = numel - base;  // elements from the block's first on
    const auto node_of = [&](uint32_t o, int& i, int& j, int& k) {
      uint32_t r = r0 + o;
      const uint32_t di = quo(a.div_plane, r);
      r -= di * a.plane;
      i = static_cast<int>(i0 + di);
      j = static_cast<int>(quo(a.div_row, r));
      k = static_cast<int>(r - static_cast<uint32_t>(j) * a.S2);
    };
    T x[kVectors][W];
    unsigned bulk = 0, rest = 0;  // bit u: vector u is the bulk's, or not
#pragma unroll
    for (int u = 0; u < kVectors; ++u) {
      const uint32_t o = (u * kThreads + threadIdx.x) * W;
      if (o >= left) continue;
      int i, j, k;
      node_of(o, i, j, k);
      if (o + W > left || !in_bulk(i, 0) || !in_bulk(j, 1) || k < a.lo[2] || k + W > a.hi[2]) {
        rest |= 1u << u;
        continue;
      }
      bulk |= 1u << u;
      if (vec) {
        load16(gb + o, x[u]);
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) x[u][q] = gb[o + q];
      }
    }
#pragma unroll
    for (int u = 0; u < kVectors; ++u) {
      if (!(bulk >> u & 1)) continue;
      const uint32_t o = (u * kThreads + threadIdx.x) * W;
      if (vec) {
        store16(fb + o, x[u]);
      } else {
#pragma unroll
        for (int q = 0; q < W; ++q) fb[o + q] = x[u][q];
      }
    }
#pragma unroll 1
    for (; rest != 0; rest &= rest - 1) {
      const uint32_t o = ((__ffs(rest) - 1) * kThreads + threadIdx.x) * W;
      int i, j, k;
      node_of(o, i, j, k);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        if (o + q < left) {
          if (static_cast<unsigned>(i - LSM_GHOST) >= static_cast<unsigned>(a.n[0]) ||
              static_cast<unsigned>(j - LSM_GHOST) >= static_cast<unsigned>(a.n[1]) ||
              static_cast<unsigned>(k - LSM_GHOST) >= static_cast<unsigned>(a.n[2]))
            fb[o + q] = T(0);
          else if (in_bulk(i, 0) && in_bulk(j, 1))
            fb[o + q] = row_node<kW>(g, a, i, j, k);
        }
        if (++k == static_cast<int>(a.S2)) {
          k = 0;
          if (++j == static_cast<int>(a.S1)) {
            j = 0;
            ++i;
          }
        }
      }
    }
    return;
  }
  // the interior nodes of the strip rows: planes i outside the bulk's axis-0
  // range (its rows j all interior), then rows j outside its axis-1 range in
  // the planes within it
  uint32_t t = (blockIdx.x - before) * kThreads + threadIdx.x;
  const int n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
  const int B0 = a.hi[0] - a.lo[0], B1 = a.hi[1] - a.lo[1];
  const int lo0 = a.lo[0] - LSM_GHOST, lo1 = a.lo[1] - LSM_GHOST;  // as interior indices
  int mi, mj;
  const uint32_t row = quo(a.div_n2, t);
  const int mk = static_cast<int>(t - row * static_cast<uint32_t>(n2));
  if (t < a.cnt_planes) {
    const uint32_t p = row / static_cast<uint32_t>(n1);
    mj = static_cast<int>(row - p * static_cast<uint32_t>(n1));
    mi = static_cast<int>(p) < lo0 ? static_cast<int>(p) : static_cast<int>(p) + B0;
  } else if (t - a.cnt_planes < a.cnt_rows) {
    const uint32_t q = row - a.cnt_planes / static_cast<uint32_t>(n2),
                   other = static_cast<uint32_t>(n1 - B1), ii = q / other;
    const int jj = static_cast<int>(q - ii * other);
    mi = lo0 + static_cast<int>(ii);
    mj = jj < lo1 ? jj : jj + B1;
  } else {
    return;
  }
  const int i = LSM_GHOST + mi, j = LSM_GHOST + mj, k = LSM_GHOST + mk;
  gf[static_cast<int64_t>(i) * a.plane + (static_cast<uint32_t>(j) * a.S2 + k)] =
      fold_node<kW>(g, a, i, j, k);
}

// The table (dmax + 1 values a row, refresh_ghosts.cu WeightTable) into a.
template <typename T>
void table_args(FoldArgs<T>& a, const void* table, int dmax) {
  const uint64_t addr = reinterpret_cast<uintptr_t>(table);
  a.table_lo = static_cast<uint32_t>(addr);
  a.table_hi = static_cast<uint32_t>(addr >> 32);
  a.stride = dmax + 1;
}

// K4's 3D entry; with a table, the table route's instantiation.
template <typename T>
int launch_fold(const void* g_, void* gf_, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                const int* degrees, const double* weights, void* stream,
                const void* table = nullptr, int dmax = 0) {
  const T* g = static_cast<const T*>(g_);
  T* gf = static_cast<T*>(gf_);
  const int64_t n[3] = {n0, n1, n2};
  const int64_t S0 = n0 + 2 * LSM_GHOST, S1 = n1 + 2 * LSM_GHOST, S2 = n2 + 2 * LSM_GHOST;
  constexpr int64_t kBlock = kThreads * kVectors * (16 / sizeof(T));
  // a block's offsets within a plane stay below 2^31
  if (S1 * S2 + kBlock >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs<T> a;
  table_args(a, table, dmax);
  a.S1 = static_cast<uint32_t>(S1);
  a.S2 = static_cast<uint32_t>(S2);
  a.plane = static_cast<uint32_t>(S1 * S2);
  a.div_plane = fast_div(a.plane);
  a.div_row = fast_div(a.S2);
  for (int axis = 0; axis < 3; ++axis) {
    a.n[axis] = static_cast<int>(n[axis]);
    int reach = LSM_GHOST + 1;  // periodic and symmetry feed nodes 1..3 from each face
    for (int side = 0; side < 2; ++side) {
      const int s = 2 * axis + side;
      a.kind[axis][side] = kinds[s];
      a.degree[axis][side] = degrees[s];
      if (kinds[s] == LSM_BC_EXTRAPOLATION && degrees[s] + 1 > reach) reach = degrees[s] + 1;
      for (int k = 0; k < LSM_GHOST; ++k)
        for (int j = 0; j <= LSM_MAX_DEGREE; ++j)
          a.w[axis][side][k][j] =
              static_cast<T>(weights[(s * LSM_GHOST + k) * (LSM_MAX_DEGREE + 1) + j]);
    }
    a.lo[axis] = LSM_GHOST + reach;
    a.hi[axis] = static_cast<int>(LSM_GHOST + n[axis] - reach);
    if (a.hi[axis] < a.lo[axis]) a.hi[axis] = a.lo[axis];
  }
  const int64_t numel = S0 * S1 * S2;
  const int64_t B0 = a.hi[0] - a.lo[0], B1 = a.hi[1] - a.lo[1];
  const int64_t planes = (n0 - B0) * n1 * n2, rows = B0 * (n1 - B1) * n2;
  if (planes + rows + kThreads >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.cnt_planes = static_cast<uint32_t>(planes);
  a.cnt_rows = static_cast<uint32_t>(rows);
  a.div_n2 = fast_div(static_cast<uint32_t>(n2));
  a.flat_blocks = static_cast<uint32_t>((numel + kBlock - 1) / kBlock);
  const int vec = (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(gf)) % 16 == 0;
  const unsigned blocks =
      a.flat_blocks + static_cast<unsigned>((planes + rows + kThreads - 1) / kThreads);
  const auto kernel = table != nullptr ? fold_kernel<T, kTable> : fold_kernel<T, kArgs>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(g, gf, numel, vec, a);
  return static_cast<int>(cudaGetLastError());
}

// K5, both entries: the shells of a padded buffer read as flat memory are
// the gaps between its interior rows (runs of n elements, `rows` of them a
// plane, `planes` planes): the head (head_planes planes, 3 rows, 3 nodes),
// a seam of 6 between two rows of a plane (one row's right ghosts, the
// next row's left ones), 6 + 6 S2 between two planes (the row ends and both
// planes' axis-1 slabs), and the tail, the head's mirror. 3D: rows of n2,
// n1 a plane, n0 planes, 3 head planes; 2D: rows of n1, n0 in one plane,
// none. The long gaps (head, tail, between planes) go in chunks of
// kThreads * kZeroVectors 16-byte vectors, a block each, scalars at a
// chunk's unaligned ends (a buffer off 16-byte alignment takes its vectors
// at the elements that are aligned); the seams kSeamLanes lanes each,
// 6 / kSeamLanes elements a lane, kSeams work items a thread kThreads
// apart; block b takes seam block b and chunk b. Index math is 32-bit (a
// fast division of the seam index by the seams a plane) below a plane's
// 64-bit base. On an H100 at 512^3 f32 (device time, tools/shell_variants.py)
// six lanes a seam took 0.027-0.028 ms, three 0.033, two 0.043, one 0.058
// (a warp's stores then span 5 seams, not 32); the seams alone 0.013-0.015,
// the long gaps alone 0.005-0.008; the long gaps' blocks apart from the
// seams' (first, interleaved, after them, or after them in a grid of eight
// blocks an SM) and chunks of 1-8 vectors a thread, all 0.028-0.029. What
// binds is the seams' 24-byte stores into sectors whose other bytes are the
// interior's.
constexpr int kZeroVectors = 1;  // 16-byte vectors a thread of a long gap's chunk
constexpr int kSeamLanes = 6;    // lanes a seam
constexpr int kSeams = 1;        // seam work items a thread

struct ZeroArgs {
  uint32_t n, S2, rows, head_planes;  // row length, padded row length, rows a plane, head planes
  uint32_t planes;                    // interior planes (the 2D buffer one)
  int64_t plane;                      // padded elements a plane
  int64_t head, mid;                  // elements of the head (and tail), of a gap between planes
  uint32_t head_blocks, mid_blocks;   // their chunks
  uint32_t long_blocks;               // chunks of every long gap
  FastDiv div_mid;                    // by mid_blocks
  uint32_t items, seam_blocks;        // seam work items (planes (rows - 1) kSeamLanes), blocks
  FastDiv div_seams;                  // by rows - 1, the seams a plane
  uint32_t phase;                     // the first element at a 16-byte boundary, in [0, W)
};

// Long gap chunk b: chunk c of gap g, 0 the head, planes the tail, else the
// gap between planes g - 1 and g; scalars at its unaligned ends, 16-byte
// vectors between.
template <typename T>
__device__ __forceinline__ void zero_chunk(T* __restrict__ buf, const ZeroArgs& a, uint32_t b) {
  constexpr uint32_t W = 16 / sizeof(T);                    // elements a vector
  constexpr uint32_t kChunk = kThreads * kZeroVectors * W;  // elements a chunk
  uint32_t g, c;
  const uint32_t between = (a.planes - 1) * a.mid_blocks;
  if (b < a.head_blocks) {
    g = 0, c = b;
  } else if (b - a.head_blocks < between) {
    const uint32_t r = b - a.head_blocks;
    g = 1 + quo(a.div_mid, r);
    c = r - (g - 1) * a.mid_blocks;
  } else {
    g = a.planes, c = b - a.head_blocks - between;
  }
  // a gap after the head starts where the last row of plane g - 1 ends
  const int64_t start =
      (g == 0 ? 0
              : static_cast<int64_t>(a.head_planes + g - 1) * a.plane +
                    (static_cast<int64_t>(a.rows + 2) * a.S2 + LSM_GHOST + a.n)) +
      static_cast<int64_t>(c) * kChunk;
  const int64_t left =
      (g == 0 || g == a.planes ? a.head : a.mid) - static_cast<int64_t>(c) * kChunk;
  const uint32_t cnt = left < kChunk ? static_cast<uint32_t>(left) : kChunk;
  T* p = buf + start;
  const uint32_t lead = min((a.phase - static_cast<uint32_t>(start)) & (W - 1), cnt);
  const uint32_t vecs = (cnt - lead) / W, tail = lead + vecs * W;
  if (threadIdx.x < lead) p[threadIdx.x] = T(0);
  if (threadIdx.x < cnt - tail) p[tail + threadIdx.x] = T(0);
  const T zero[W] = {};
#pragma unroll
  for (int u = 0; u < kZeroVectors; ++u) {
    const uint32_t v = u * kThreads + threadIdx.x;
    if (v < vecs) store16(p + lead + v * W, zero);
  }
}

// Seam block b: its threads' work items, kThreads apart, each kRun elements
// of seam q = item / kSeamLanes (row r of plane pl: the fast division).
template <typename T>
__device__ __forceinline__ void zero_seams(T* __restrict__ buf, const ZeroArgs& a, uint32_t b) {
  constexpr int kRun = 2 * LSM_GHOST / kSeamLanes;  // elements a lane
  const uint32_t w0 = b * (kThreads * kSeams) + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kSeams; ++s) {
    const uint32_t w = w0 + s * kThreads;
    if (w >= a.items) return;
    const uint32_t q = w / kSeamLanes, part = w - q * kSeamLanes;
    const uint32_t pl = quo(a.div_seams, q), r = q - pl * (a.rows - 1);
    T* p = buf + static_cast<int64_t>(a.head_planes + pl) * a.plane +
           ((r + LSM_GHOST) * a.S2 + LSM_GHOST + a.n + part * kRun);
#pragma unroll
    for (int e = 0; e < kRun; ++e) p[e] = T(0);
  }
}

// Block b zeroes seam block b and long gap chunk b, those that exist.
template <typename T>
__global__ void __launch_bounds__(kThreads) zero_shells_kernel(T* __restrict__ buf, ZeroArgs a) {
  if (blockIdx.x < a.seam_blocks) zero_seams(buf, a, blockIdx.x);
  if (blockIdx.x < a.long_blocks) zero_chunk(buf, a, blockIdx.x);
}

// K5's launch over `planes` planes of `rows` rows of n nodes (3D: n0, n1,
// n2 with head_planes 3; 2D: 1, n0, n1 with none).
template <typename T>
int launch_zero_shells(void* buf, int64_t planes, int64_t rows, int64_t n, int head_planes,
                       void* stream) {
  constexpr int64_t W = 16 / sizeof(T), kChunk = kThreads * kZeroVectors * W;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(buf);
  const int64_t S2 = n + 2 * LSM_GHOST, plane = (rows + 2 * LSM_GHOST) * S2;
  const int64_t seams = planes * (rows - 1);
  ZeroArgs a;
  a.head = head_planes * plane + LSM_GHOST * S2 + LSM_GHOST;
  a.mid = 2 * LSM_GHOST * S2 + 2 * LSM_GHOST;
  const int64_t head_blocks = (a.head + kChunk - 1) / kChunk,
                mid_blocks = (a.mid + kChunk - 1) / kChunk,
                long_blocks = 2 * head_blocks + (planes - 1) * mid_blocks,
                seam_blocks = (seams * kSeamLanes + kThreads * kSeams - 1) / (kThreads * kSeams);
  // 32-bit seam items and offsets within a plane, a grid below 2^31 blocks
  if (planes < 1 || rows < 1 || n < 1 || addr % sizeof(T) != 0 || plane >= (int64_t{1} << 32) ||
      seams * kSeamLanes + kThreads * kSeams >= (int64_t{1} << 31) ||
      long_blocks + seam_blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.n = static_cast<uint32_t>(n);
  a.S2 = static_cast<uint32_t>(S2);
  a.rows = static_cast<uint32_t>(rows);
  a.head_planes = static_cast<uint32_t>(head_planes);
  a.planes = static_cast<uint32_t>(planes);
  a.plane = plane;
  a.head_blocks = static_cast<uint32_t>(head_blocks);
  a.mid_blocks = static_cast<uint32_t>(mid_blocks);
  a.long_blocks = static_cast<uint32_t>(long_blocks);
  a.div_mid = fast_div(a.mid_blocks);
  a.items = static_cast<uint32_t>(seams * kSeamLanes);
  a.seam_blocks = static_cast<uint32_t>(seam_blocks);
  a.div_seams = fast_div(rows > 1 ? static_cast<uint32_t>(rows - 1) : 1);
  a.phase = static_cast<uint32_t>((16 - addr % 16) % 16 / sizeof(T));
  const int64_t blocks = long_blocks > seam_blocks ? long_blocks : seam_blocks;
  zero_shells_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(buf), a);
  return static_cast<int>(cudaGetLastError());
}

// K4's 2D entry: a (the FoldArgs of the 2D axes 0 and 1) gives plane = the
// buffer's nodes and S2 = its row length; one thread a node.
template <typename T, int kW>
__global__ void __launch_bounds__(kThreads)
    fold_2d_kernel(const T* __restrict__ g, T* __restrict__ gf, FoldArgs<T> a) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.plane) return;
  const uint32_t i = quo(a.div_row, t);
  const int j = static_cast<int>(t - i * a.S2);
  const int mi = static_cast<int>(i) - LSM_GHOST, mj = j - LSM_GHOST;
  T x = T(0);
  if (static_cast<unsigned>(mi) < static_cast<unsigned>(a.n[0]) &&
      static_cast<unsigned>(mj) < static_cast<unsigned>(a.n[1])) {
    const bool strip0 = static_cast<int>(i) < a.lo[0] || static_cast<int>(i) >= a.hi[0];
    const bool strip1 = j < a.lo[1] || j >= a.hi[1];
    // V1 of row `row` at column j: g plus axis 1's contributions
    const auto v1 = [&](const T* row) {
      return strip1 ? gather_axis<kW>(a, 1, mj, row[j], [&](int p) { return row[p]; }) : row[j];
    };
    x = v1(g + i * a.S2);
    if (strip0)
      x = gather_axis<kW>(a, 0, mi, x, [&](int p) { return v1(g + static_cast<uint32_t>(p) * a.S2); });
  }
  gf[t] = x;
}

template <typename T>
int launch_fold_2d(const void* g, void* gf, int64_t n0, int64_t n1, const int* kinds,
                   const int* degrees, const double* weights, void* stream,
                   const void* table = nullptr, int dmax = 0) {
  const int64_t n[2] = {n0, n1};
  const int64_t S0 = n0 + 2 * LSM_GHOST, S1 = n1 + 2 * LSM_GHOST;
  if (S0 * S1 + kThreads >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  FoldArgs<T> a{};
  table_args(a, table, dmax);
  a.S1 = static_cast<uint32_t>(S0);
  a.S2 = static_cast<uint32_t>(S1);
  a.plane = static_cast<uint32_t>(S0 * S1);
  a.div_row = fast_div(a.S2);
  for (int axis = 0; axis < 2; ++axis) {
    a.n[axis] = static_cast<int>(n[axis]);
    int reach = LSM_GHOST + 1;
    for (int side = 0; side < 2; ++side) {
      const int s = 2 * axis + side;
      a.kind[axis][side] = kinds[s];
      a.degree[axis][side] = degrees[s];
      if (kinds[s] == LSM_BC_EXTRAPOLATION && degrees[s] + 1 > reach) reach = degrees[s] + 1;
      for (int k = 0; k < LSM_GHOST; ++k)
        for (int j = 0; j <= LSM_MAX_DEGREE; ++j)
          a.w[axis][side][k][j] =
              static_cast<T>(weights[(s * LSM_GHOST + k) * (LSM_MAX_DEGREE + 1) + j]);
    }
    a.lo[axis] = LSM_GHOST + reach;
    a.hi[axis] = static_cast<int>(LSM_GHOST + n[axis] - reach);
    if (a.hi[axis] < a.lo[axis]) a.hi[axis] = a.lo[axis];
  }
  const unsigned blocks = static_cast<unsigned>((S0 * S1 + kThreads - 1) / kThreads);
  const auto kernel = table != nullptr ? fold_2d_kernel<T, kTable> : fold_2d_kernel<T, kArgs>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<T*>(gf), a);
  return static_cast<int>(cudaGetLastError());
}

// K4 on the table route (lsm_fold_table_*), 3D or 2D.
template <typename T>
int launch_fold_table(const void* g, void* gf, int ndim, int64_t n0, int64_t n1, int64_t n2,
                      const int* kinds, const int* degrees, const double* weights,
                      const void* table, int dmax, void* stream) {
  if (table == nullptr || dmax < 0 || g == gf) return static_cast<int>(cudaErrorInvalidValue);
  if (ndim == 3)
    return launch_fold<T>(g, gf, n0, n1, n2, kinds, degrees, weights, stream, table, dmax);
  if (ndim == 2)
    return launch_fold_2d<T>(g, gf, n0, n1, kinds, degrees, weights, stream, table, dmax);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int lsm_fold_ghosts_2d_f32(const void* g, void* gf, int64_t n0, int64_t n1,
                                      const int* kinds, const int* degrees,
                                      const double* weights, void* stream) {
  return launch_fold_2d<float>(g, gf, n0, n1, kinds, degrees, weights, stream);
}

extern "C" int lsm_fold_ghosts_2d_f64(const void* g, void* gf, int64_t n0, int64_t n1,
                                      const int* kinds, const int* degrees,
                                      const double* weights, void* stream) {
  return launch_fold_2d<double>(g, gf, n0, n1, kinds, degrees, weights, stream);
}

extern "C" int lsm_zero_shells_2d_f32(void* buf, int64_t n0, int64_t n1, void* stream) {
  return launch_zero_shells<float>(buf, 1, n0, n1, 0, stream);
}

extern "C" int lsm_zero_shells_2d_f64(void* buf, int64_t n0, int64_t n1, void* stream) {
  return launch_zero_shells<double>(buf, 1, n0, n1, 0, stream);
}

extern "C" int lsm_fold_ghosts_f32(const void* g, void* gf, int64_t n0, int64_t n1,
                                   int64_t n2, const int* kinds, const int* degrees,
                                   const double* weights, void* stream) {
  return launch_fold<float>(g, gf, n0, n1, n2, kinds, degrees, weights, stream);
}

extern "C" int lsm_fold_ghosts_f64(const void* g, void* gf, int64_t n0, int64_t n1,
                                   int64_t n2, const int* kinds, const int* degrees,
                                   const double* weights, void* stream) {
  return launch_fold<double>(g, gf, n0, n1, n2, kinds, degrees, weights, stream);
}

extern "C" int lsm_zero_shells_f32(void* buf, int64_t n0, int64_t n1, int64_t n2,
                                   void* stream) {
  return launch_zero_shells<float>(buf, n0, n1, n2, LSM_GHOST, stream);
}

extern "C" int lsm_zero_shells_f64(void* buf, int64_t n0, int64_t n1, int64_t n2,
                                   void* stream) {
  return launch_zero_shells<double>(buf, n0, n1, n2, LSM_GHOST, stream);
}

extern "C" int lsm_fold_table_f32(const void* g, void* gf, int ndim, int64_t n0, int64_t n1,
                                  int64_t n2, const int* kinds, const int* degrees,
                                  const double* weights, const void* table, int dmax,
                                  void* stream) {
  return launch_fold_table<float>(g, gf, ndim, n0, n1, n2, kinds, degrees, weights, table, dmax,
                                  stream);
}

extern "C" int lsm_fold_table_f64(const void* g, void* gf, int ndim, int64_t n0, int64_t n1,
                                  int64_t n2, const int* kinds, const int* degrees,
                                  const double* weights, const void* table, int dmax,
                                  void* stream) {
  return launch_fold_table<double>(g, gf, ndim, n0, n1, n2, kinds, degrees, weights, table, dmax,
                                   stream);
}
