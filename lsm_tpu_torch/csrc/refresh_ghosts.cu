// K2: in-place refresh of the ghost shells of a padded 3D or 2D buffer.
//
// Replaces the TPU kernel lsm_tpu/ops/weno_v2.py `refresh_ghosts_fast`
// (helpers `_dim0_shell`, `_dim1_ghost_cols`). Semantics are those of
// lsm_tpu/core/bc.py `_ghost_block`, per side of each axis:
//   periodic (shared endpoint): ghost -k <- node n-1-k, ghost n-1+k <- node k;
//   symmetry (mirror without the boundary node): ghost -k <- node k,
//     ghost n-1+k <- node n-1-k;
//   extrapolation of degree P <= 7: sum_j w[k][j] * node j from the boundary
//     inward (left: nodes 0..P; right: nodes n-1..n-1-P).
//
// pad_ghost composes the axes: axis 0's ghosts over the interior, then axis
// 1's over axis 0's padded extent (its corner ghosts read axis 0's), then
// axis 2's over both padded extents.
//
// Design of the 3D entry (lsm_refresh_ghosts_*, refresh_3d_kernel): one
// launch (the three below took 0.053 ms of device time at 512^3 f32 on an
// H100, waves of threads with one dependent load and store each). An edge
// or vertex ghost's thread recomputes the earlier axes' ghosts it reads from
// the interior with their arithmetic, so no thread reads what another writes
// and the composition needs no launch order. Index math is 32-bit (a 64-bit
// base per plane); a buffer that would need 2^31 threads (some 10 GB in
// f32) takes the three launches below.
//
// The three launches (launch_refresh, refresh_axis_kernel): axis 0, then axis
// 1, then axis 2, on one stream, the launch order giving the composition
// order, a thread a line and its six ghosts. The single-axis entry
// (lsm_refresh_axis_*) runs one of the three phases alone: the sharded
// refresh takes it for the axes a mesh leaves unsharded (always axis 2); K7
// runs the three gated on a buffer beyond 32-bit indices.
//
// Bound: it touches only the shells, O(N^2): 4,774,104 ghosts at 512^3, each
// written once and one source read (Periodic), 38 MB: 0.0114 ms at 3.35
// TB/s. The ends of the 262,144 interior rows move whole 32-byte sectors, a
// few times the ghosts' own 24 bytes a row end.
//
// K2's 2D entry (lsm_refresh_ghosts_2d_*) refreshes a 2D field's (n0+6, n1+6)
// buffer, the dense 2D stepper's, in one launch (refresh_2d_kernel): the two
// phases' ghosts are written by disjoint threads that read the interior
// only, a corner's thread recomputing the axis-0 values it reads, so the
// composition order needs no second launch. At 4096^2 that is 49 k ghosts
// against the (1, n0, n1) embedding's three phases over six 4102^2 planes.
//
// K7 (lsm_refresh_band_ghosts_*) replaces the TPU kernel
// lsm_tpu/ops/band_pallas.py `refresh_band_ghosts_fast` (kernel01, kernel2)
// on the band path, whose buffers share this uniform 3-ghost layout: K2's
// one-launch threads (shell_ghost, ghost_2d) gated on the device by int32
// flags, with no host read (band_refresh_3d_kernel, band_refresh_2d_kernel). A shell
// changes only when an active tile touches its face, so a band that stays
// inside the grid skips the whole refresh, and the launch then costs one
// small grid of blocks that read the flags and exit (its first design, three
// full-shell launches whose blocks each read a flag, took 0.1209 ms gated off
// at 512^3 f32 on an H100 by CUDA events). The 2D entry refreshes a 2D band
// on its own (n0+6, n1+6) layout; the TPU kernel ran the 3D refresh on the
// (1, n0, n1) embedding, whose dummy axis keeps flags[0] on and rewrites the
// full axis-0 ghost planes at every stage; this layout has none.
//
// The table route (lsm_refresh_table_*): a buffer with an Extrapolation of
// degree above LSM_MAX_DEGREE runs the same threads, one launch an entry
// (refresh_3d_table_kernel, refresh_2d_table_kernel, band_refresh_3d/2d_
// table_kernel, refresh_axis_table_kernel), with the BCs of TableBC: the
// weights read in place from a table of the buffer's type (WeightTable;
// ops/weno_v2.py `_ghost_table`, built once per BCs, shape, device and dtype:
// each weight the by-value route's double rounded to T once);
// a line thread loads an extrapolating side's P + 1 nodes in chunks of
// kTableChunk, every chunk's loads issued together (table_ghosts), an edge
// or vertex ghost recomputes the composition from the interior as K2's E
// threads do (at most (P + 1)^3 reads, at 8 x 27 vertex ghosts). The sums
// keep ghost_of's order, so the bits are the plain version's. Its first
// design (one launch a phase, one thread a ghost, each ghost's P + 1 loads
// in turn, two 64-bit divisions a thread, double weights converted at each
// use) took 0.36 ms of device time at 512^3 f32 under Extrapolation(8) on an
// H100, this one 0.098, against 0.107 for the by-value route under
// Extrapolation(7) (tools/ab_degree.sh). Bound: each ghost written once and
// its line's P + 1 nodes read once (0.0228 ms at 512^3 f32, P = 8, at 3.35
// TB/s).
// A copy of the table in shared memory, made by each block first, gained 4%
// on K2 and nothing on K4 and cost K7 a quarter (device ms, staged against
// in place: K2 0.097 / 0.101, K4 0.619 / 0.617, K7 flags on 0.166 / 0.131;
// tools/shell_variants.py on a staging version of these kernels), and it
// would cap the degree at shared memory.

#include <cuda_runtime.h>

#include "fast_div.cuh"
#include "lsm_kernels.h"

namespace {

struct AxisBC {
  int kind[2];
  int degree[2];
  double w[2][LSM_GHOST][LSM_MAX_DEGREE + 1];  // [side][k-1][j]
};

// One launch's share of the table: the weight of node j (from the boundary
// inward) for the ghost at distance k of side s of local axis a at w[((2 a +
// s) * LSM_GHOST + k - 1) * stride + j]; the kinds and degrees of those
// sides at kind[2 a + s], degree[2 a + s].
template <typename T>
struct WeightTable {
  const T* w;
  int stride;  // dmax + 1
  int kind[6], degree[6];
};

// The table (dmax + 1 values a row, six rows an axis) of axes [first, first
// + naxes) of a buffer whose sides have the host arrays' kinds and degrees.
template <typename T>
WeightTable<T> weight_table(const void* table, int dmax, const int* kinds, const int* degrees,
                            int first, int naxes) {
  WeightTable<T> t;
  t.stride = dmax + 1;
  t.w = static_cast<const T*>(table) + static_cast<int64_t>(first) * 2 * LSM_GHOST * t.stride;
  for (int s = 0; s < 6; ++s) {
    t.kind[s] = s < 2 * naxes ? kinds[2 * first + s] : 0;
    t.degree[s] = s < 2 * naxes ? degrees[2 * first + s] : 0;
  }
  return t;
}

// Whether an axis's sides (kinds and degrees at 2 axis, 2 axis + 1) need
// the table: an extrapolation of degree above LSM_MAX_DEGREE.
inline bool needs_table(const int* kinds, const int* degrees, int axis) {
  for (int s = 2 * axis; s < 2 * axis + 2; ++s)
    if (kinds[s] == LSM_BC_EXTRAPOLATION && degrees[s] > LSM_MAX_DEGREE) return true;
  return false;
}

// The boundary conditions of one axis on the table route (WeightTable):
// kinds and degrees as AxisBC's, the weights of any degree at w[(side * 3 +
// k - 1) * stride + j] (the axis's rows of the device table).
template <typename T>
struct TableBC {
  int kind[2];
  int degree[2];
  const T* w;
  int stride;
};

template <typename BC>
struct IsTable {
  static constexpr bool value = false;
};
template <typename T>
struct IsTable<TableBC<T>> {
  static constexpr bool value = true;
};

// The weights of the ghost at distance k on `side`: [j] is node j's.
template <typename BC>
__device__ __forceinline__ auto weight_row(const BC& bc, int side, int k)
    -> decltype((bc.w[side][k - 1])) {
  return bc.w[side][k - 1];
}
template <typename T>
__device__ __forceinline__ const T* weight_row(const TableBC<T>& bc, int side, int k) {
  return bc.w + (side * LSM_GHOST + k - 1) * bc.stride;
}

constexpr int kThreads = 256;

// acc + w * x with both operations rounded separately (no FMA contraction),
// as the plain torch version computes it: the kernel then matches it bit for bit
__device__ __forceinline__ float mul_add_rn(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}
__device__ __forceinline__ double mul_add_rn(double acc, double w, double x) {
  return __dadd_rn(acc, __dmul_rn(w, x));
}

// The boundary conditions of one axis from the host arrays (kinds[2*axis +
// side], degrees likewise, weights[((2*axis + side)*3 + k-1)*8 + j]).
AxisBC axis_bc(const int* kinds, const int* degrees, const double* weights, int axis) {
  AxisBC bc;
  for (int side = 0; side < 2; ++side) {
    const int a = 2 * axis + side;
    bc.kind[side] = kinds[a];
    bc.degree[side] = degrees[a];
    for (int k = 0; k < LSM_GHOST; ++k)
      for (int j = 0; j <= LSM_MAX_DEGREE; ++j)
        bc.w[side][k][j] = weights[(a * LSM_GHOST + k) * (LSM_MAX_DEGREE + 1) + j];
  }
  return bc;
}

// One ghost of a line of n nodes: the node at index m of the line is node(m);
// side 0 or 1 and distance k = 1..3 from the face, with the plain version's
// arithmetic (0 + w0 x0 + w1 x1 + ..., each product and sum rounded).
// The 2D entry takes it with K2's double weights and 64-bit indices, the 3D
// entries with weights in T and 32-bit indices; the table route with its
// table's weights (one node loaded at a time, as here: the edge and corner
// ghosts, whose nodes are themselves such sums).
template <typename T, typename BC, typename I, typename Node>
__device__ __forceinline__ T ghost_of(const BC& bc, int side, int k, I n, Node node) {
  switch (bc.kind[side]) {
    case LSM_BC_PERIODIC:
      return node(side == 0 ? n - 1 - k : k);
    case LSM_BC_SYMMETRY:
      return node(side == 0 ? k : n - 1 - k);
    default: {  // LSM_BC_EXTRAPOLATION
      const auto& w = weight_row(bc, side, k);
      const I m0 = side == 0 ? 0 : n - 1, step = side == 0 ? 1 : -1;
      T val = mul_add_rn(T(0), T(w[0]), node(m0));
      for (int j = 1; j <= bc.degree[side]; ++j) val = mul_add_rn(val, T(w[j]), node(m0 + j * step));
      return val;
    }
  }
}

// Thread t (t < 6 (n1 + n0 + 6)) of the 2D refresh, K2's and K7's: threads
// [0, 6 n1) write the axis-0 ghosts of the interior columns (a row of n1
// fastest, coalesced), the next 6 (n0+6) the axis-1 ghosts of every padded
// row (a row's six slots fastest). An axis-1 ghost of an axis-0 ghost row (a
// corner) reads that row's values: its thread recomputes each from the
// interior with the axis-0 arithmetic, or with kStored (K7's flags (0, 1),
// where no thread writes those rows) reads the stored ones, as the plain
// version does. Indices in I: int64_t for K2's and K7's by-value entries,
// int for the table route's below 2^31 elements (one long a buffer beyond).
template <typename T, bool kStored, typename BC, typename I>
__device__ __forceinline__ void ghost_2d(T* __restrict__ P, I n0, I n1, const BC& bc0,
                                         const BC& bc1, I t) {
  const I S1 = n1 + 2 * LSM_GHOST;
  const I cols = 2 * LSM_GHOST * n1;
  // a slot g6 in [0, 6): side g6 / 3, layer g6 % 3 (distance 3 - layer on the
  // left, layer + 1 on the right), at padded index layer or n + 3 + layer
  const auto slot = [](int g6, I n, int& side, int& k, I& pos) {
    side = g6 / LSM_GHOST;
    const int layer = g6 % LSM_GHOST;
    k = side == 0 ? LSM_GHOST - layer : layer + 1;
    pos = side == 0 ? layer : LSM_GHOST + n + layer;
  };
  int side, k;
  I pos;
  if (t < cols) {  // an axis-0 ghost of interior column b
    const I b = t % n1;
    slot(static_cast<int>(t / n1), n0, side, k, pos);
    const T* col = P + LSM_GHOST * S1 + LSM_GHOST + b;  // node (0, b)
    P[pos * S1 + LSM_GHOST + b] = ghost_of<T>(bc0, side, k, n0, [&](I m) {
      return col[m * S1];
    });
    return;
  }
  const I r = t - cols, row = r / (2 * LSM_GHOST);
  slot(static_cast<int>(r % (2 * LSM_GHOST)), n1, side, k, pos);
  T val;
  if (kStored || (row >= LSM_GHOST && row < LSM_GHOST + n0)) {
    const T* line = P + row * S1 + LSM_GHOST;  // node (row - 3, 0)
    val = ghost_of<T>(bc1, side, k, n1, [&](I m) { return line[m]; });
  } else {  // a corner: the axis-0 ghost row's values, recomputed from the interior
    int side0, k0;
    I pos0;
    slot(static_cast<int>(row < LSM_GHOST ? row : row - n0), n0, side0, k0, pos0);
    const T* first = P + LSM_GHOST * S1 + LSM_GHOST;  // node (0, 0)
    val = ghost_of<T>(bc1, side, k, n1, [&](I m) {
      return ghost_of<T>(bc0, side0, k0, n0, [&](I i) { return first[i * S1 + m]; });
    });
  }
  P[row * S1 + pos] = val;
}

// K2's 2D entry: every ghost of a (n0+6, n1+6) buffer in one launch
// (ghost_2d's threads): a corner's thread recomputes the axis-0 values it
// reads from the interior, so the launch equals pad_ghost's composition (axis
// 0, then axis 1 over the padded rows) bit for bit, and no thread reads what
// another writes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    refresh_2d_kernel(T* __restrict__ P, int64_t n0, int64_t n1, AxisBC bc0, AxisBC bc1) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= 2 * LSM_GHOST * (n1 + n0 + 2 * LSM_GHOST)) return;
  ghost_2d<T, false>(P, n0, n1, bc0, bc1, t);
}

template <typename T>
int launch_refresh_ghosts_2d(void* P, int64_t n0, int64_t n1, const int* kinds,
                             const int* degrees, const double* weights, void* stream) {
  const int64_t total = 2 * LSM_GHOST * (n1 + n0 + 2 * LSM_GHOST);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  refresh_2d_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(P), n0, n1, axis_bc(kinds, degrees, weights, 0),
      axis_bc(kinds, degrees, weights, 1));
  return static_cast<int>(cudaGetLastError());
}

// K2's 3D entry: every ghost of a (n0+6, n1+6, n2+6) buffer in one launch,
// none reading what another writes. Its threads, in order:
//   E: one a ghost of two or three axes (an edge or vertex of the shell;
//      55,512 at 512^3), first so that their longer chains start early. Such
//      a ghost reads pad_ghost's values of the earlier axes' ghosts, which
//      its thread recomputes from the interior with their arithmetic: f0
//      (axis 0 over an interior column), f1 (axis 1 over f0's values), f2
//      (axis 2 over f1's);
//   A: one the six axis-0 ghosts of an interior column (j, k), warps along k;
//   B: one the six axis-1 ghosts of an interior (i, k);
//   C: one an axis-2 ghost slot of kRowsC interior rows (rows_c apart; for
//      each, a warp's lanes take neighbouring rows' slots in the order of
//      their addresses: a row's right ghosts beside the next row's left).
// A line of A, B or C reads its own interior nodes, an extrapolation's all
// at once. So every ghost equals pad_ghost's composition bit for bit, with no
// second launch. A buffer with no extrapolating side takes an instantiation
// without extrapolation's code (kExtrap false), whose registers are fewer.

constexpr int kRowsC = 1;  // rows a thread of C takes

template <typename T>
struct ShellBC {
  int kind[2];
  int degree[2];
  T w[2][LSM_GHOST][LSM_MAX_DEGREE + 1];  // [side][k-1][j]
};

template <typename T>
struct Shell3 {
  int n[3];
  uint32_t S1, S2, plane;  // padded extents of axes 1 and 2; S1 * S2
  uint32_t cnt_e1, cnt_e2, cnt_e3, cnt_a, cnt_b, cnt_c;
  uint32_t rows_c;  // C's rows over kRowsC
  ShellBC<T> bc[3];
};

// padded index of ghost slot g in [0, 6) of an axis of n nodes, and its side
// and distance k
__device__ __forceinline__ int slot_pos(int g, int n) { return g < LSM_GHOST ? g : n + g; }
__device__ __forceinline__ int slot_side(int g) { return g < LSM_GHOST ? 0 : 1; }
__device__ __forceinline__ int slot_dist(int g) { return g < LSM_GHOST ? LSM_GHOST - g : g - 2; }

// The P + 1 nodes node(m) an extrapolation on `side` of a line of n nodes
// reads, loaded at once (ghost_of's loop waits for each load in turn), and a
// ghost's sum over them in ghost_of's order.
template <typename T, typename Node>
__device__ __forceinline__ void extrap_nodes(int P, int side, int n, Node node,
                                             T (&x)[LSM_MAX_DEGREE + 1]) {
  const int m0 = side == 0 ? 0 : n - 1, step = side == 0 ? 1 : -1;
#pragma unroll
  for (int j = 0; j <= LSM_MAX_DEGREE; ++j) x[j] = j <= P ? node(m0 + j * step) : T(0);
}
template <typename T>
__device__ __forceinline__ T extrap_sum(int P, const T* w, const T (&x)[LSM_MAX_DEGREE + 1]) {
  T val = mul_add_rn(T(0), w[0], x[0]);
#pragma unroll
  for (int j = 1; j <= LSM_MAX_DEGREE; ++j)
    if (j <= P) val = mul_add_rn(val, w[j], x[j]);
  return val;
}

// ghost_of's value; without extrapolation (kExtrap false) a copy of the node
// a periodic or symmetry ghost takes.
template <typename T, bool kExtrap, typename BC, typename Node>
__device__ __forceinline__ T ghost3(const BC& bc, int side, int k, int n, Node node) {
  if constexpr (kExtrap) {
    return ghost_of<T>(bc, side, k, n, node);
  } else {  // periodic: ghost -k <- node n-1-k, n-1+k <- k; symmetry the mirror
    return node((bc.kind[side] == LSM_BC_SYMMETRY) == (side == 0) ? k : n - 1 - k);
  }
}

constexpr int kTableChunk = 8;  // the table route: an extrapolating side's nodes loaded at once

// The table route's extrapolation of any degree P: the ghosts of slots
// [g_lo, g_hi) on `side` of a line of n nodes node(m) into val, the P + 1
// nodes in chunks of kTableChunk, each chunk's loads issued together, and
// each ghost's sum in ghost_of's order (0 + w0 x0 + w1 x1 + ...: chunking
// keeps it), so the bits are the plain version's.
template <typename T, typename Node>
__device__ __forceinline__ void table_ghosts(const TableBC<T>& bc, int side, int n, int g_lo,
                                             int g_hi, Node node, T (&val)[2 * LSM_GHOST]) {
  const int P = bc.degree[side];
  const int m0 = side == 0 ? 0 : n - 1, step = side == 0 ? 1 : -1;
#pragma unroll
  for (int g = side * LSM_GHOST; g < (side + 1) * LSM_GHOST; ++g)
    if (g >= g_lo && g < g_hi) val[g] = T(0);
#pragma unroll 1
  for (int c = 0; c <= P; c += kTableChunk) {
    T x[kTableChunk];
#pragma unroll
    for (int j = 0; j < kTableChunk; ++j) x[j] = c + j <= P ? node(m0 + (c + j) * step) : T(0);
#pragma unroll
    for (int g = side * LSM_GHOST; g < (side + 1) * LSM_GHOST; ++g) {
      if (g < g_lo || g >= g_hi) continue;
      const T* w = weight_row(bc, side, slot_dist(g)) + c;
#pragma unroll
      for (int j = 0; j < kTableChunk; ++j)
        if (c + j <= P) val[g] = mul_add_rn(val[g], w[j], x[j]);
    }
  }
}

// The ghosts of slots [g_lo, g_hi) of a line of n nodes node(m) into val,
// ghost_of's values; an extrapolating side's nodes loaded once for its ghosts
// (by value all at once, from a table in chunks).
template <typename T, bool kExtrap, typename BC, typename Node>
__device__ __forceinline__ void line_ghosts(const BC& bc, int n, int g_lo, int g_hi, Node node,
                                            T (&val)[2 * LSM_GHOST]) {
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    if (g_hi <= side * LSM_GHOST || g_lo >= (side + 1) * LSM_GHOST) continue;
    if (kExtrap && bc.kind[side] == LSM_BC_EXTRAPOLATION) {
      if constexpr (IsTable<BC>::value) {
        table_ghosts(bc, side, n, g_lo, g_hi, node, val);
      } else {
        T x[LSM_MAX_DEGREE + 1];
        extrap_nodes<T>(bc.degree[side], side, n, node, x);
#pragma unroll
        for (int g = side * LSM_GHOST; g < (side + 1) * LSM_GHOST; ++g)
          if (g >= g_lo && g < g_hi)
            val[g] = extrap_sum(bc.degree[side], bc.w[side][slot_dist(g) - 1], x);
      }
    } else {
#pragma unroll
      for (int g = side * LSM_GHOST; g < (side + 1) * LSM_GHOST; ++g)
        if (g >= g_lo && g < g_hi) val[g] = ghost3<T, false>(bc, side, slot_dist(g), n, node);
    }
  }
}

// The ghost at padded (i, j, k), a ghost of two or three axes: the
// composition f2(f1(f0)) from the interior, with the BCs bc[3].
template <typename T, bool kExtrap, typename BC>
__device__ __forceinline__ T edge_ghost(const T* __restrict__ P, const Shell3<T>& s,
                                        const BC* bc, int i, int j, int k) {
  const int n0 = s.n[0], n1 = s.n[1], n2 = s.n[2];
  const auto inside = [](int p, int n) {
    return static_cast<unsigned>(p - LSM_GHOST) < static_cast<unsigned>(n);
  };
  const auto f0 = [&](int i, int j, int k) -> T {  // j and k interior
    const T* col = P + (static_cast<int64_t>(LSM_GHOST) * s.plane +
                        (static_cast<uint32_t>(j) * s.S2 + k));
    if (inside(i, n0)) return col[static_cast<int64_t>(i - LSM_GHOST) * s.plane];
    const int g = i < LSM_GHOST ? i : i - n0;
    return ghost3<T, kExtrap>(bc[0], slot_side(g), slot_dist(g), n0,
                              [&](int m) { return col[static_cast<int64_t>(m) * s.plane]; });
  };
  const auto f1 = [&](int i, int j, int k) -> T {  // k interior
    if (inside(j, n1)) return f0(i, j, k);
    const int g = j < LSM_GHOST ? j : j - n1;
    return ghost3<T, kExtrap>(bc[1], slot_side(g), slot_dist(g), n1,
                              [&](int m) { return f0(i, LSM_GHOST + m, k); });
  };
  if (inside(k, n2)) return f1(i, j, k);
  const int g = k < LSM_GHOST ? k : k - n2;
  return ghost3<T, kExtrap>(bc[2], slot_side(g), slot_dist(g), n2,
                            [&](int m) { return f1(i, j, LSM_GHOST + m); });
}

// The BCs of s into shared memory: a warp's lanes read other ghosts' weights
// without the constant cache serialising them.
template <typename T>
__device__ __forceinline__ void shell_bcs(ShellBC<T> (&bc)[3], const Shell3<T>& s) {
  constexpr int kW = 2 * LSM_GHOST * (LSM_MAX_DEGREE + 1);  // weights of an axis
  for (int e = threadIdx.x; e < 3 * kW; e += kThreads) {
    const int axis = e / kW, r = e % kW, side = r / (kW / 2);
    const int k = r / (LSM_MAX_DEGREE + 1) % LSM_GHOST, j = r % (LSM_MAX_DEGREE + 1);
    bc[axis].w[side][k][j] = s.bc[axis].w[side][k][j];
  }
  if (threadIdx.x < 6) {
    bc[threadIdx.x / 2].kind[threadIdx.x % 2] = s.bc[threadIdx.x / 2].kind[threadIdx.x % 2];
    bc[threadIdx.x / 2].degree[threadIdx.x % 2] = s.bc[threadIdx.x / 2].degree[threadIdx.x % 2];
  }
}

// The table route's BCs of a launch's naxes axes into bc (shared memory,
// as shell_bcs), from t. Every thread of the block calls it; a barrier ends
// it.
template <typename T>
__device__ __forceinline__ void table_bcs(TableBC<T>* bc, int naxes, const WeightTable<T>& t) {
  if (threadIdx.x < naxes) {
    TableBC<T>& b = bc[threadIdx.x];
    for (int side = 0; side < 2; ++side) {
      b.kind[side] = t.kind[2 * threadIdx.x + side];
      b.degree[side] = t.degree[2 * threadIdx.x + side];
    }
    b.w = t.w + threadIdx.x * 2 * LSM_GHOST * t.stride;
    b.stride = t.stride;
  }
  __syncthreads();
}

// Thread t of K2's 3D launch, K7's under flags (1, 1): the ghost(s) of
// class E (first, so that their longer chains start early), then A, B and C.
template <typename T, bool kExtrap, typename BC>
__device__ __forceinline__ void shell_ghost(T* __restrict__ P, const Shell3<T>& s, const BC* bc,
                                            uint32_t t) {
  const int n0 = s.n[0], n1 = s.n[1], n2 = s.n[2];
  constexpr int G2 = 2 * LSM_GHOST;
  const auto at = [&](int i, int j, int k) {
    return P + (static_cast<int64_t>(i) * s.plane + (static_cast<uint32_t>(j) * s.S2 + k));
  };
  if (t < s.cnt_e1 + s.cnt_e2 + s.cnt_e3) {  // E: an edge or vertex ghost
    int i, j, k;
    if (t < s.cnt_e1) {  // i and j ghosts, any k
      const uint32_t r = t / s.S2, g0 = r / G2;
      k = static_cast<int>(t - r * s.S2);
      i = slot_pos(static_cast<int>(g0), n0);
      j = slot_pos(static_cast<int>(r - g0 * G2), n1);
    } else if ((t -= s.cnt_e1) < s.cnt_e2) {  // i and k ghosts, j interior
      const uint32_t r = t / G2, g0 = r / static_cast<uint32_t>(n1);
      k = slot_pos(static_cast<int>(t - r * G2), n2);
      i = slot_pos(static_cast<int>(g0), n0);
      j = LSM_GHOST + static_cast<int>(r - g0 * static_cast<uint32_t>(n1));
    } else {  // j and k ghosts, i interior
      t -= s.cnt_e2;
      const uint32_t r = t / G2, mi = r / G2;
      k = slot_pos(static_cast<int>(t - r * G2), n2);
      j = slot_pos(static_cast<int>(r - mi * G2), n1);
      i = LSM_GHOST + static_cast<int>(mi);
    }
    *at(i, j, k) = edge_ghost<T, kExtrap>(P, s, bc, i, j, k);
    return;
  }
  t -= s.cnt_e1 + s.cnt_e2 + s.cnt_e3;
  // A, B, C: ghosts of a line whose other coordinates are interior
  int axis;
  T* line;  // padded index 0 of the line
  int64_t step;
  if (t < s.cnt_a) {  // A: axis 0 at the interior column (j, k)
    axis = 0;
    const uint32_t mj = t / static_cast<uint32_t>(n2);
    line = at(0, LSM_GHOST + mj, LSM_GHOST + (t - mj * static_cast<uint32_t>(n2)));
    step = s.plane;
  } else if ((t -= s.cnt_a) < s.cnt_b) {  // B: axis 1 at the interior (i, k)
    axis = 1;
    const uint32_t mi = t / static_cast<uint32_t>(n2);
    line = at(LSM_GHOST + mi, 0, LSM_GHOST + (t - mi * static_cast<uint32_t>(n2)));
    step = s.S2;
  } else if ((t -= s.cnt_b) < s.cnt_c) {  // C: slot g of kRowsC interior rows, rows_c apart
    const uint32_t rg = t / G2, rows = static_cast<uint32_t>(n0) * static_cast<uint32_t>(n1);
    const int g = static_cast<int>(t - rg * G2);
    T v[kRowsC];
    T* dst[kRowsC];
#pragma unroll
    for (int u = 0; u < kRowsC; ++u) {
      const uint32_t r = rg + u * s.rows_c, mi = r / static_cast<uint32_t>(n1);
      dst[u] = nullptr;
      if (r >= rows) continue;
      T* row = at(LSM_GHOST + mi, LSM_GHOST + (r - mi * static_cast<uint32_t>(n1)), 0);
      const T* node = row + LSM_GHOST;
      T val[G2];
      line_ghosts<T, kExtrap>(bc[2], n2, g, g + 1, [&](int m) { return node[m]; }, val);
#pragma unroll
      for (int q = 0; q < G2; ++q)
        if (q == g) v[u] = val[q];
      dst[u] = row + slot_pos(g, n2);
    }
#pragma unroll
    for (int u = 0; u < kRowsC; ++u)
      if (dst[u] != nullptr) *dst[u] = v[u];
    return;
  } else {
    return;
  }
  const int n = s.n[axis];
  const T* node = line + LSM_GHOST * step;
  T val[G2];
  line_ghosts<T, kExtrap>(bc[axis], n, 0, G2, [&](int m) { return node[m * step]; }, val);
#pragma unroll
  for (int g = 0; g < G2; ++g) line[slot_pos(g, n) * step] = val[g];
}

template <typename T, bool kExtrap>
__global__ void __launch_bounds__(kThreads, 6) refresh_3d_kernel(T* __restrict__ P, Shell3<T> s) {
  __shared__ ShellBC<T> bc[3];
  shell_bcs(bc, s);
  __syncthreads();
  shell_ghost<T, kExtrap>(P, s, bc, blockIdx.x * kThreads + threadIdx.x);
}

// K2's 3D entry on the table route: refresh_3d_kernel's threads with the
// table's weights (s.bc is not read). At 64 registers (four blocks an SM):
// 0.098-0.101 ms of device time at 512^3 f32 under Extrapolation(8) on an
// H100, against 0.125-0.138 at K2's 40 (spilling) and 0.140-0.146 at 128
// (two blocks an SM), and 0.113-0.121 with chunks of 16 nodes
// (tools/shell_variants.py).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    refresh_3d_table_kernel(T* __restrict__ P, Shell3<T> s, WeightTable<T> tab) {
  __shared__ TableBC<T> bc[3];
  table_bcs(bc, 3, tab);
  shell_ghost<T, true>(P, s, bc, blockIdx.x * kThreads + threadIdx.x);
}

// K7's entries: K2's one-launch kernels gated on the device by flags
// (int32[2], read once a block): 3D, flags[0] gates axes 0 and 1, flags[1]
// axis 2; 2D, flags[0] axis 0 and flags[1] axis 1. Each of the four gates
// gives the plain version's bits (its phases in order, a phase run only
// where its flag is set):
//   (0, 0): nothing is written;
//   (1, 1): K2's composition, every ghost recomputed from the interior;
//   (1, 0): the ghosts of axes 0 and 1 at interior axis-2 indices (2D: axis
//     0's at interior columns): an edge ghost of axes 0 and 1 recomputes
//     axis 0's values from the interior (f1(f0), as K2's E threads);
//   (0, 1): the axis-2 ghosts (2D: axis 1's) of every padded row of the
//     earlier axes, from the row's stored values: the plain version reads
//     the axis-0/1 ghosts as they stand, and no thread writes them under
//     this gate.
// The grid is a fixed number of blocks for the card (kBandBlocksPerSM times
// its SM count, at most the gated-on work's blocks), each walking its share
// of the gate's work in a grid-stride loop: gated off, a launch costs one
// block per slot of the card that reads the flags and exits, not a grid
// over the whole shell. The 3D kernel takes 64 registers (four blocks an
// SM): its three gates' paths in one loop spilled 1.5 KB a thread (f32,
// extrapolation) under K2's 40, and took 0.0707 ms gated on at 512^3 f32 on
// an H100 against 0.0546-0.0562 (one, two, 8, 16 or 24 blocks an SM and the
// full grid measured: tools/shell_variants.py, PERF.md).
constexpr int kBandBlocksPerSM = 4;  // the 3D kernel's resident blocks an SM

// The card's SM count, read once per device.
cudaError_t sm_count(int& sms) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool slot = dev >= 0 && dev < 64;
  if (slot && cached[dev] > 0) {
    sms = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && slot) cached[dev] = sms;
  return err;
}

// Blocks of kThreads for work of `total` threads: kBandBlocksPerSM blocks an
// SM, or fewer when the work needs fewer.
cudaError_t band_blocks(int64_t total, unsigned& blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  const int64_t need = (total + kThreads - 1) / kThreads, most = int64_t{kBandBlocksPerSM} * sms;
  blocks = static_cast<unsigned>(need < most ? need : most);
  if (blocks == 0) blocks = 1;
  return err;
}

// The gate as a block reads it: bit 0 flags[0], bit 1 flags[1].
__device__ __forceinline__ int read_gate(const int* __restrict__ flags) {
  __shared__ int gate;
  if (threadIdx.x == 0) gate = (flags[0] != 0) | (flags[1] != 0) << 1;
  __syncthreads();
  return gate;
}

// The gate's work (1, 2 or 3) of K7's 3D launch, each block its share in a
// grid-stride loop.
template <typename T, bool kExtrap, typename BC>
__device__ __forceinline__ void band_walk(T* __restrict__ P, const Shell3<T>& s, const BC* bc,
                                          int gate) {
  constexpr uint32_t G2 = 2 * LSM_GHOST;
  const int n0 = s.n[0], n2 = s.n[2];
  const uint32_t cnt_e = s.cnt_e1 + s.cnt_e2 + s.cnt_e3;
  const uint32_t e01 = G2 * G2 * static_cast<uint32_t>(n2);  // (1, 0)'s edge ghosts
  const uint32_t total = gate == 3   ? cnt_e + s.cnt_a + s.cnt_b + s.cnt_c
                         : gate == 1 ? e01 + s.cnt_a + s.cnt_b
                                     : G2 * (static_cast<uint32_t>(n0) + G2) * s.S1;
  for (uint32_t t = blockIdx.x * kThreads + threadIdx.x; t < total; t += gridDim.x * kThreads) {
    if (gate != 2) {  // K2's thread t; under (1, 0) the E thread of an i and j ghost at
      // interior k (f1(f0) from the interior), then A's and B's
      uint32_t u = t;
      if (gate == 1) {
        const uint32_t r = t / static_cast<uint32_t>(n2);
        u = t < e01 ? r * s.S2 + LSM_GHOST + (t - r * static_cast<uint32_t>(n2))
                    : cnt_e + (t - e01);
      }
      shell_ghost<T, kExtrap>(P, s, bc, u);
    } else {  // slot q of padded row (i, j), from its stored nodes
      const uint32_t r = t / G2, i = r / s.S1;
      const int q = static_cast<int>(t - r * G2);
      T* row = P + (static_cast<int64_t>(i) * s.plane + (r - i * s.S1) * s.S2);
      const T* node = row + LSM_GHOST;
      T val[G2];
      line_ghosts<T, kExtrap>(bc[2], n2, q, q + 1, [&](int m) { return node[m]; }, val);
      T v = T(0);
#pragma unroll
      for (int g = 0; g < static_cast<int>(G2); ++g)
        if (g == q) v = val[g];
      row[slot_pos(q, n2)] = v;
    }
  }
}

template <typename T, bool kExtrap>
__global__ void __launch_bounds__(kThreads, 4)
    band_refresh_3d_kernel(T* __restrict__ P, Shell3<T> s, const int* __restrict__ flags) {
  const int gate = read_gate(flags);
  if (gate == 0) return;
  __shared__ ShellBC<T> bc[3];
  shell_bcs(bc, s);
  __syncthreads();
  band_walk<T, kExtrap>(P, s, bc, gate);
}

// K7's 3D entry on the table route: band_refresh_3d_kernel with the table's
// weights.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    band_refresh_3d_table_kernel(T* __restrict__ P, Shell3<T> s, WeightTable<T> tab,
                                 const int* __restrict__ flags) {
  const int gate = read_gate(flags);
  if (gate == 0) return;
  __shared__ TableBC<T> bc[3];
  table_bcs(bc, 3, tab);
  band_walk<T, true>(P, s, bc, gate);
}

// The gate's work of K7's 2D launch (ghost_2d's threads), each block its
// share in a grid-stride loop.
template <typename T, typename BC, typename I>
__device__ __forceinline__ void band_walk_2d(T* __restrict__ P, I n0, I n1, const BC& bc0,
                                             const BC& bc1, int gate) {
  const I cols = 2 * LSM_GHOST * n1, rows = 2 * LSM_GHOST * (n0 + 2 * LSM_GHOST);
  const I lo = gate == 2 ? cols : 0, hi = gate == 1 ? cols : cols + rows;
  for (I t = lo + static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; t < hi;
       t += static_cast<I>(gridDim.x) * kThreads) {
    if (gate == 2)
      ghost_2d<T, true>(P, n0, n1, bc0, bc1, t);
    else
      ghost_2d<T, false>(P, n0, n1, bc0, bc1, t);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    band_refresh_2d_kernel(T* __restrict__ P, int64_t n0, int64_t n1, AxisBC bc0, AxisBC bc1,
                           const int* __restrict__ flags) {
  const int gate = read_gate(flags);
  if (gate == 0) return;
  band_walk_2d(P, n0, n1, bc0, bc1, gate);
}

// K2's and K7's 2D entries on the table route: refresh_2d_kernel's and
// band_refresh_2d_kernel's threads with the table's weights, indices in I
// (int below 2^31 elements: 32-bit divisions).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    refresh_2d_table_kernel(T* __restrict__ P, I n0, I n1, WeightTable<T> tab) {
  __shared__ TableBC<T> bc[2];
  table_bcs(bc, 2, tab);
  const I t = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= 2 * LSM_GHOST * (n1 + n0 + 2 * LSM_GHOST)) return;
  ghost_2d<T, false>(P, n0, n1, bc[0], bc[1], t);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    band_refresh_2d_table_kernel(T* __restrict__ P, I n0, I n1, WeightTable<T> tab,
                                 const int* __restrict__ flags) {
  const int gate = read_gate(flags);
  if (gate == 0) return;
  __shared__ TableBC<T> bc[2];
  table_bcs(bc, 2, tab);
  band_walk_2d(P, n0, n1, bc[0], bc[1], gate);
}

// K2's single-axis entry (lsm_refresh_axis_*, refresh_axis_kernel): one phase
// of pad_ghost's composition alone, the two shells of one axis from the
// lines through them, reading the earlier axes' ghosts as the buffer holds
// them. The sharded refresh runs it for the axes a mesh leaves unsharded
// (always axis 2); K2's 3D entry and K7 run the three phases in order, K7's
// gated by its flags, where their one launch would need more than 32-bit
// indices. Axes 0 and 1: a thread a line along the axis at (j, k) or (i,
// k), axis 2's interior k fastest across the warp (coalesced), its six
// ghosts from loads of both ends issued before the stores (an
// extrapolation's nodes at once). Axis 2: a lane a ghost, six lanes the six
// contiguous elements between two padded rows (a row's right ghosts, the
// next one's left). The weights are in T, converted on the host; the sums
// round as the plain version's (mul_add_rn). Index math is 32-bit (a fast
// division by n2; axis 2 a block's 42 seams) below the block's first line,
// a 64-bit index; each line's address a 64-bit product. On an H100, out of
// L2, f32, at the shards of 512^3 on (2, 2) (256 x 256 x 512) and (4, 1)
// (128 x 512 x 512) meshes: axis 1's phase 0.0023 ms of device time, its
// first design (one thread a ghost, a 64-bit division and remainder per
// index, double weights converted per term) 0.0045; axis 2's 0.0089 either
// way, and 0.014 with a thread a row (its loads and stores touch a line a
// lane), against a bound of 0.0010 ms (each ghost written once from one
// source, Periodic) and 0.0028 with the rows' ends' whole 32-byte sectors:
// the scattered row ends bind.
template <typename T>
struct AxisPhase {
  int n;               // the axis's interior nodes
  int64_t lines;       // axes 0, 1: lines (a, b), b < n2 fastest; axis 2: padded rows
  int64_t first;       // axes 0, 1: padded index 0 of line (0, 0)
  int64_t a_stride;    // elements from line (a, b) to (a + 1, b); axis 2 from row to row
  int64_t step;        // axes 0, 1: elements between neighbours along the axis
  uint32_t n2;         // axis 2's interior nodes
  FastDiv div_n2;
  ShellBC<T> bc;
};

// The six ghosts of one line (padded index 0 at `line`, `step` apart) from
// its interior nodes: every load before the stores.
template <typename T, bool kExtrap, typename BC, typename I>
__device__ __forceinline__ void refresh_line(T* line, I step, const BC& bc, int n) {
  const T* node = line + LSM_GHOST * step;
  T val[2 * LSM_GHOST];
  line_ghosts<T, kExtrap>(bc, n, 0, 2 * LSM_GHOST, [&](int m) { return node[m * step]; }, val);
#pragma unroll
  for (int g = 0; g < 2 * LSM_GHOST; ++g) line[slot_pos(g, n) * step] = val[g];
}

// Whether `gate` (an int32 flag on the device, read once a block) is set.
__device__ __forceinline__ bool gate_on(const int* __restrict__ gate) {
  __shared__ int on;
  if (threadIdx.x == 0) on = *gate != 0;
  __syncthreads();
  return on != 0;
}

constexpr int kRowSeams = kThreads / (2 * LSM_GHOST);  // axis 2: seams a block (42)

// A thread of the single-axis phase a, with the BCs bc (a.bc's kinds and
// degrees).
template <typename T, bool kExtrap, bool kRows, typename BC>
__device__ __forceinline__ void axis_thread(T* __restrict__ P, const AxisPhase<T>& a,
                                            const BC& bc) {
  if constexpr (kRows) {
    // seam q between padded rows q - 1 and q (q in [0, rows]): six
    // contiguous elements, a lane each, row q - 1's right ghosts then row q's
    // left ones
    const uint32_t dq = threadIdx.x / (2 * LSM_GHOST), e = threadIdx.x - dq * (2 * LSM_GHOST);
    const int64_t q = static_cast<int64_t>(blockIdx.x) * kRowSeams + dq;
    const int64_t row = e < LSM_GHOST ? q - 1 : q;
    if (dq >= kRowSeams || row < 0 || row >= a.lines) return;
    const int g = e < LSM_GHOST ? static_cast<int>(e) + LSM_GHOST : static_cast<int>(e) - LSM_GHOST;
    T* line = P + row * a.a_stride;
    const T* node = line + LSM_GHOST;
    T val[2 * LSM_GHOST];
    line_ghosts<T, kExtrap>(bc, a.n, g, g + 1, [&](int m) { return node[m]; }, val);
    T v = T(0);
#pragma unroll
    for (int h = 0; h < 2 * LSM_GHOST; ++h)
      if (h == g) v = val[h];
    line[slot_pos(g, a.n)] = v;
  } else {  // line t0 + threadIdx.x = (i0 + di) n2 + k, from t0 = i0 n2 + k0
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads;  // the block's first line
    if (t0 + threadIdx.x >= a.lines) return;
    const uint32_t i0 = t0 < (int64_t{1} << 31) ? quo(a.div_n2, static_cast<uint32_t>(t0))
                                                 : static_cast<uint32_t>(t0 / a.n2);
    const uint32_t r = static_cast<uint32_t>(t0 - static_cast<int64_t>(i0) * a.n2) + threadIdx.x;
    const uint32_t di = quo(a.div_n2, r);
    refresh_line<T, kExtrap>(
        P + a.first + static_cast<int64_t>(i0 + di) * a.a_stride + (r - di * a.n2), a.step, bc,
        a.n);
  }
}

template <typename T, bool kExtrap, bool kRows>
__global__ void __launch_bounds__(kThreads)
    refresh_axis_kernel(T* __restrict__ P, AxisPhase<T> a, const int* __restrict__ gate) {
  if (gate != nullptr && !gate_on(gate)) return;
  axis_thread<T, kExtrap, kRows>(P, a, a.bc);
}

// The single-axis phase on the table route (an axis with a side of degree
// above LSM_MAX_DEGREE): refresh_axis_kernel's threads with the axis's
// weights from the table (a.bc is not read).
template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads)
    refresh_axis_table_kernel(T* __restrict__ P, AxisPhase<T> a, WeightTable<T> tab,
                              const int* __restrict__ gate) {
  if (gate != nullptr && !gate_on(gate)) return;
  __shared__ TableBC<T> bc;
  table_bcs(&bc, 1, tab);
  axis_thread<T, true, kRows>(P, a, bc);
}

// The boundary conditions of one axis from the host arrays (kinds[2*axis +
// side], degrees likewise, weights[((2*axis + side)*3 + k-1)*8 + j]), the
// weights in T.
template <typename T>
ShellBC<T> shell_bc(const int* kinds, const int* degrees, const double* weights, int axis) {
  ShellBC<T> bc;
  for (int side = 0; side < 2; ++side) {
    const int a = 2 * axis + side;
    bc.kind[side] = kinds[a];
    bc.degree[side] = degrees[a];
    for (int k = 0; k < LSM_GHOST; ++k)
      for (int j = 0; j <= LSM_MAX_DEGREE; ++j)
        bc.w[side][k][j] = static_cast<T>(weights[(a * LSM_GHOST + k) * (LSM_MAX_DEGREE + 1) + j]);
  }
  return bc;
}

// Axes [axis_lo, axis_hi) in order, one launch each on one stream (the launch
// order gives the composition's): the whole refresh is [0, 3), one phase of
// it [axis, axis + 1). With flags (K7's), a phase runs where its flag is set:
// flags[0] for axes 0 and 1, flags[1] for axis 2. With a table (dmax + 1
// values a row), an axis with a side of degree above LSM_MAX_DEGREE takes
// refresh_axis_table_kernel.
template <typename T>
int launch_refresh(void* P, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                   const int* degrees, const double* weights, const int* flags, void* stream,
                   int axis_lo = 0, int axis_hi = 3, const void* table = nullptr, int dmax = 0) {
  const int64_t n[3] = {n0, n1, n2};
  const int64_t S0 = n0 + 2 * LSM_GHOST, S1 = n1 + 2 * LSM_GHOST, S2 = n2 + 2 * LSM_GHOST;
  const int64_t plane = S1 * S2;
  if (n2 >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  for (int axis = axis_lo; axis < axis_hi; ++axis) {
    AxisPhase<T> a;
    a.n = static_cast<int>(n[axis]);
    a.bc = shell_bc<T>(kinds, degrees, weights, axis);
    a.n2 = static_cast<uint32_t>(n2);
    a.div_n2 = fast_div(a.n2);
    // axis 0: lines over interior (j, k); axis 1: over padded i, interior k;
    // axis 2: every padded row
    a.lines = axis == 0 ? n1 * n2 : axis == 1 ? S0 * n2 : S0 * S1;
    a.first = axis == 0 ? LSM_GHOST * S2 + LSM_GHOST : LSM_GHOST;
    a.a_stride = axis == 1 ? plane : S2;
    a.step = axis == 0 ? plane : S2;
    const int64_t blocks = axis == 2 ? a.lines / kRowSeams + 1  // the rows' lines + 1 seams
                                     : (a.lines + kThreads - 1) / kThreads;
    if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const int* gate = flags == nullptr ? nullptr : flags + (axis == 2 ? 1 : 0);
    if (table != nullptr && needs_table(kinds, degrees, axis)) {
      const WeightTable<T> tab = weight_table<T>(table, dmax, kinds, degrees, axis, 1);
      const auto kernel =
          axis == 2 ? refresh_axis_table_kernel<T, true> : refresh_axis_table_kernel<T, false>;
      kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<T*>(P), a, tab, gate);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      continue;
    }
    const bool extrap = kinds[2 * axis] == LSM_BC_EXTRAPOLATION ||
                        kinds[2 * axis + 1] == LSM_BC_EXTRAPOLATION;
    const auto kernel = axis == 2 ? (extrap ? refresh_axis_kernel<T, true, true>
                                            : refresh_axis_kernel<T, false, true>)
                                  : (extrap ? refresh_axis_kernel<T, true, false>
                                            : refresh_axis_kernel<T, false, false>);
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(P), a, gate);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K2's threads at this shape into s, their count and whether a side
// extrapolates; false where they would need more than 32-bit indices.
template <typename T>
bool shell3_args(Shell3<T>& s, int64_t& total, bool& extrap, int64_t n0, int64_t n1, int64_t n2,
                 const int* kinds, const int* degrees, const double* weights) {
  const int64_t S1 = n1 + 2 * LSM_GHOST, S2 = n2 + 2 * LSM_GHOST;
  constexpr int64_t G2 = 2 * LSM_GHOST;
  const int64_t cnt_e1 = G2 * G2 * S2, cnt_e2 = G2 * G2 * n1, cnt_e3 = G2 * G2 * n0,
                cnt_a = n1 * n2, cnt_b = n0 * n2, rows_c = (n0 * n1 + kRowsC - 1) / kRowsC,
                cnt_c = rows_c * G2;
  total = cnt_e1 + cnt_e2 + cnt_e3 + cnt_a + cnt_b + cnt_c;
  if (total + kThreads >= (int64_t{1} << 31) || S1 * S2 >= (int64_t{1} << 31)) return false;
  const int64_t n[3] = {n0, n1, n2};
  for (int axis = 0; axis < 3; ++axis) {
    s.n[axis] = static_cast<int>(n[axis]);
    s.bc[axis] = shell_bc<T>(kinds, degrees, weights, axis);
  }
  s.S1 = static_cast<uint32_t>(S1);
  s.S2 = static_cast<uint32_t>(S2);
  s.plane = static_cast<uint32_t>(S1 * S2);
  s.cnt_e1 = static_cast<uint32_t>(cnt_e1);
  s.cnt_e2 = static_cast<uint32_t>(cnt_e2);
  s.cnt_e3 = static_cast<uint32_t>(cnt_e3);
  s.cnt_a = static_cast<uint32_t>(cnt_a);
  s.cnt_b = static_cast<uint32_t>(cnt_b);
  s.cnt_c = static_cast<uint32_t>(cnt_c);
  s.rows_c = static_cast<uint32_t>(rows_c);
  extrap = false;  // the kernel without extrapolation's code when no side takes it
  for (int a = 0; a < 6; ++a) extrap |= kinds[a] == LSM_BC_EXTRAPOLATION;
  return true;
}

// K2's 3D entry: one launch when its threads allow 32-bit indices; beyond
// them the three launches of launch_refresh. With a table, the table route's
// kernels.
template <typename T>
int launch_refresh_3d(void* P, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                      const int* degrees, const double* weights, void* stream,
                      const void* table = nullptr, int dmax = 0) {
  Shell3<T> s;
  int64_t total;
  bool extrap;
  if (!shell3_args(s, total, extrap, n0, n1, n2, kinds, degrees, weights))
    return launch_refresh<T>(P, n0, n1, n2, kinds, degrees, weights, nullptr, stream, 0, 3,
                             table, dmax);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (table != nullptr) {
    const WeightTable<T> tab = weight_table<T>(table, dmax, kinds, degrees, 0, 3);
    refresh_3d_table_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(P), s, tab);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = extrap ? refresh_3d_kernel<T, true> : refresh_3d_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(P), s);
  return static_cast<int>(cudaGetLastError());
}

// K7's 3D entry: one gated launch; beyond 32-bit indices the three gated
// launches of launch_refresh (a size route, as K2's).
template <typename T>
int launch_band_refresh_3d(void* P, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                           const int* degrees, const double* weights, const int* flags,
                           void* stream, const void* table = nullptr, int dmax = 0) {
  Shell3<T> s;
  int64_t total;
  bool extrap;
  if (!shell3_args(s, total, extrap, n0, n1, n2, kinds, degrees, weights))
    return launch_refresh<T>(P, n0, n1, n2, kinds, degrees, weights, flags, stream, 0, 3, table,
                             dmax);
  unsigned blocks;
  const cudaError_t err = band_blocks(total, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (table != nullptr) {
    const WeightTable<T> tab = weight_table<T>(table, dmax, kinds, degrees, 0, 3);
    band_refresh_3d_table_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<T*>(P), s, tab, flags);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = extrap ? band_refresh_3d_kernel<T, true> : band_refresh_3d_kernel<T, false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<T*>(P), s,
                                                                     flags);
  return static_cast<int>(cudaGetLastError());
}

// K7's 2D entry: one gated launch.
template <typename T>
int launch_band_refresh_2d(void* P, int64_t n0, int64_t n1, const int* kinds, const int* degrees,
                           const double* weights, const int* flags, void* stream) {
  unsigned blocks;
  const cudaError_t err = band_blocks(2 * LSM_GHOST * (n1 + n0 + 2 * LSM_GHOST), blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  band_refresh_2d_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(P), n0, n1, axis_bc(kinds, degrees, weights, 0),
      axis_bc(kinds, degrees, weights, 1), flags);
  return static_cast<int>(cudaGetLastError());
}

// K2's 2D entry (flags null) or K7's on the table route: one launch, int
// indices below 2^31 elements.
template <typename T>
int launch_table_2d(void* P_, int64_t n0, int64_t n1, const WeightTable<T>& tab,
                    const int* flags, void* stream_) {
  const int64_t total = 2 * LSM_GHOST * (n1 + n0 + 2 * LSM_GHOST);
  unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (flags != nullptr) {
    const cudaError_t err = band_blocks(total, blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool small = (n0 + 2 * LSM_GHOST) * (n1 + 2 * LSM_GHOST) < (int64_t{1} << 31);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  T* P = static_cast<T*>(P_);
  const int m0 = static_cast<int>(n0), m1 = static_cast<int>(n1);
  if (flags == nullptr && small)
    refresh_2d_table_kernel<T, int><<<blocks, kThreads, 0, stream>>>(P, m0, m1, tab);
  else if (flags == nullptr)
    refresh_2d_table_kernel<T, int64_t><<<blocks, kThreads, 0, stream>>>(P, n0, n1, tab);
  else if (small)
    band_refresh_2d_table_kernel<T, int><<<blocks, kThreads, 0, stream>>>(P, m0, m1, tab, flags);
  else
    band_refresh_2d_table_kernel<T, int64_t><<<blocks, kThreads, 0, stream>>>(P, n0, n1, tab,
                                                                             flags);
  return static_cast<int>(cudaGetLastError());
}

// The table route's refresh (lsm_refresh_table_*): K2's 3D or 2D entry
// (axes [0, ndim)), K2's single-axis entry ([axis, axis + 1), 3D), or with
// flags K7's entry (axes [0, ndim)); one launch each but past 32-bit
// threads in 3D.
template <typename T>
int launch_table_refresh(void* P, int ndim, int64_t n0, int64_t n1, int64_t n2, int axis_lo,
                         int axis_hi, const int* kinds, const int* degrees,
                         const double* weights, const void* table, int dmax, const int* flags,
                         void* stream) {
  const bool whole = axis_lo == 0 && axis_hi == ndim;
  if (table == nullptr || dmax < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ndim == 2 && whole)
    return launch_table_2d<T>(P, n0, n1, weight_table<T>(table, dmax, kinds, degrees, 0, 2),
                              flags, stream);
  if (ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (whole && flags != nullptr)
    return launch_band_refresh_3d<T>(P, n0, n1, n2, kinds, degrees, weights, flags, stream, table,
                                     dmax);
  if (whole)
    return launch_refresh_3d<T>(P, n0, n1, n2, kinds, degrees, weights, stream, table, dmax);
  if (axis_lo < 0 || axis_hi != axis_lo + 1 || axis_hi > 3 || flags != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_refresh<T>(P, n0, n1, n2, kinds, degrees, weights, nullptr, stream, axis_lo,
                           axis_hi, table, dmax);
}

}  // namespace

extern "C" int lsm_refresh_ghosts_2d_f32(void* P, int64_t n0, int64_t n1, const int* kinds,
                                         const int* degrees, const double* weights,
                                         void* stream) {
  return launch_refresh_ghosts_2d<float>(P, n0, n1, kinds, degrees, weights, stream);
}

extern "C" int lsm_refresh_ghosts_2d_f64(void* P, int64_t n0, int64_t n1, const int* kinds,
                                         const int* degrees, const double* weights,
                                         void* stream) {
  return launch_refresh_ghosts_2d<double>(P, n0, n1, kinds, degrees, weights, stream);
}

extern "C" int lsm_refresh_ghosts_f32(void* P, int64_t n0, int64_t n1, int64_t n2,
                                      const int* kinds, const int* degrees,
                                      const double* weights, void* stream) {
  return launch_refresh_3d<float>(P, n0, n1, n2, kinds, degrees, weights, stream);
}

extern "C" int lsm_refresh_ghosts_f64(void* P, int64_t n0, int64_t n1, int64_t n2,
                                      const int* kinds, const int* degrees,
                                      const double* weights, void* stream) {
  return launch_refresh_3d<double>(P, n0, n1, n2, kinds, degrees, weights, stream);
}

extern "C" int lsm_refresh_axis_f32(void* P, int64_t n0, int64_t n1, int64_t n2, int axis,
                                    const int* kinds, const int* degrees,
                                    const double* weights, void* stream) {
  if (axis < 0 || axis > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_refresh<float>(P, n0, n1, n2, kinds, degrees, weights, nullptr, stream, axis,
                               axis + 1);
}

extern "C" int lsm_refresh_axis_f64(void* P, int64_t n0, int64_t n1, int64_t n2, int axis,
                                    const int* kinds, const int* degrees,
                                    const double* weights, void* stream) {
  if (axis < 0 || axis > 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_refresh<double>(P, n0, n1, n2, kinds, degrees, weights, nullptr, stream, axis,
                                axis + 1);
}

extern "C" int lsm_refresh_band_ghosts_f32(void* P, int64_t n0, int64_t n1, int64_t n2,
                                           const int* kinds, const int* degrees,
                                           const double* weights, const void* flags,
                                           void* stream) {
  return launch_band_refresh_3d<float>(P, n0, n1, n2, kinds, degrees, weights,
                                       static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_band_ghosts_f64(void* P, int64_t n0, int64_t n1, int64_t n2,
                                           const int* kinds, const int* degrees,
                                           const double* weights, const void* flags,
                                           void* stream) {
  return launch_band_refresh_3d<double>(P, n0, n1, n2, kinds, degrees, weights,
                                        static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_band_ghosts_2d_f32(void* P, int64_t n0, int64_t n1, const int* kinds,
                                              const int* degrees, const double* weights,
                                              const void* flags, void* stream) {
  return launch_band_refresh_2d<float>(P, n0, n1, kinds, degrees, weights,
                                       static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_band_ghosts_2d_f64(void* P, int64_t n0, int64_t n1, const int* kinds,
                                              const int* degrees, const double* weights,
                                              const void* flags, void* stream) {
  return launch_band_refresh_2d<double>(P, n0, n1, kinds, degrees, weights,
                                        static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_table_f32(void* P, int ndim, int64_t n0, int64_t n1, int64_t n2,
                                     int axis_lo, int axis_hi, const int* kinds,
                                     const int* degrees, const double* weights,
                                     const void* table, int dmax, const void* flags,
                                     void* stream) {
  return launch_table_refresh<float>(P, ndim, n0, n1, n2, axis_lo, axis_hi, kinds, degrees,
                                     weights, table, dmax, static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_table_f64(void* P, int ndim, int64_t n0, int64_t n1, int64_t n2,
                                     int axis_lo, int axis_hi, const int* kinds,
                                     const int* degrees, const double* weights,
                                     const void* table, int dmax, const void* flags,
                                     void* stream) {
  return launch_table_refresh<double>(P, ndim, n0, n1, n2, axis_lo, axis_hi, kinds, degrees,
                                      weights, table, dmax, static_cast<const int*>(flags),
                                      stream);
}
