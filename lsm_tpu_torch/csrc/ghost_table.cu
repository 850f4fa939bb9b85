// K2, K4 and K7 for Extrapolation of any degree: the weight-table route.
//
// The kernels of refresh_ghosts.cu (K2, its single-axis entry, K7) and
// fold_ghosts.cu (K4) take each side's Lagrange weights by value, eight a
// ghost (LSM_MAX_DEGREE 7). A buffer with a side of higher degree takes
// this route instead, so the by-value kernels keep their code. Its weights
// w[a][k-1][j] (a = 2*axis + side, ghost distance k = 1..3, node j = 0..P
// from the boundary inward) lie in a device table of 6 * 3 * (dmax + 1)
// doubles that the wrapper builds once per BCs, shape and device
// (ops/weno_v2.py `_ghost_table`), each converted to the buffer's type where
// it is used, as K2's 2D entry converts its own.
//
// Design: pad_ghost's composition, one launch a phase on one stream, the
// launch order giving the composition's (axis 0, 1, 2; a 2D buffer is the
// (1, n0, n1) case of the same rule, its dummy axis of one padded node). A
// phase covers the lines of its axis: the earlier axes over their full padded
// extent, the later ones over their interior.
//   refresh (K2, K2's single axis, K7): one thread a ghost of a line, lines
//     fastest (on axes 0 and 1 neighbouring lines are neighbouring elements);
//     a ghost reads only interior nodes of its line, so no thread reads what
//     another of its launch writes. Its sum is the plain version's: 0 + w0 x0
//     + w1 x1 + ..., each product and sum rounded (mul_add_rn), bit for bit.
//     K7's flags gate a launch on the card (3D: flags[0] axes 0 and 1,
//     flags[1] axis 2; 2D: flags[axis]).
//   fold (K4): gf = g (one copy), then the axes last to first, one thread a
//     node within reach of a face of a line (max(4, P + 1) nodes from each
//     face: every node a ghost is built from), adding w * ghost onto the node
//     in the plain version's order (side 0, k = 1..3, then side 1), in place:
//     a launch reads ghosts and writes interior nodes of its axis only. Then
//     every shell is zeroed (one launch an axis). The plain version zeroes an
//     axis's shells before the next axis's pass, which neither reads nor
//     writes them, so the end result is the same bit for bit.
//
// Bound: a refresh moves what K2 does (each ghost written once, P + 1 reads
// a ghost, mostly cached); a fold moves the copy (g read, gf written: 2 x
// 518^3 x 4 B at 512^3 f32, 0.332 ms at 3.35 TB/s) plus the strips.

#include <cuda_runtime.h>

#include "lsm_kernels.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_add_rn(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}
__device__ __forceinline__ double mul_add_rn(double acc, double w, double x) {
  return __dadd_rn(acc, __dmul_rn(w, x));
}

// One phase: the lines along `axis` of a padded buffer. Line l = a * cnt_b + b
// starts (padded index 0 along the axis) at base + a * st_a + b * st_b.
struct Phase {
  int64_t lines, cnt_b, base, st_a, st_b, step;
  int n;                  // interior nodes along the axis
  int kind[2], degree[2];
  const double* w;        // the axis's rows: w[(side * 3 + k - 1) * stride + j]
  int stride;             // dmax + 1
  int reach;              // fold: nodes from each face a ghost is built from
  int64_t nodes;          // fold: nodes a line takes, min(n, 2 reach)
};

__device__ __forceinline__ int64_t line_start(const Phase& f, int64_t l) {
  const int64_t a = l / f.cnt_b;
  return f.base + a * f.st_a + (l - a * f.cnt_b) * f.st_b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    table_refresh_kernel(T* __restrict__ P, Phase f, const int* __restrict__ gate) {
  if (gate != nullptr && *gate == 0) return;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= 2 * LSM_GHOST * f.lines) return;
  const int g = static_cast<int>(t / f.lines);
  T* line = P + line_start(f, t - g * f.lines);
  const int side = g / LSM_GHOST, layer = g % LSM_GHOST;
  const int k = side == 0 ? LSM_GHOST - layer : layer + 1;
  const int pos = side == 0 ? layer : LSM_GHOST + f.n + layer;
  const auto node = [&](int m) { return line[(LSM_GHOST + m) * f.step]; };
  T val;
  switch (f.kind[side]) {
    case LSM_BC_PERIODIC:
      val = node(side == 0 ? f.n - 1 - k : k);
      break;
    case LSM_BC_SYMMETRY:
      val = node(side == 0 ? k : f.n - 1 - k);
      break;
    default: {  // LSM_BC_EXTRAPOLATION
      const double* w = f.w + (side * LSM_GHOST + k - 1) * f.stride;
      const int m0 = side == 0 ? 0 : f.n - 1, dir = side == 0 ? 1 : -1;
      val = mul_add_rn(T(0), T(w[0]), node(m0));
      for (int j = 1; j <= f.degree[side]; ++j) val = mul_add_rn(val, T(w[j]), node(m0 + j * dir));
    }
  }
  line[pos * f.step] = val;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) table_fold_kernel(T* __restrict__ P, Phase f) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= f.nodes * f.lines) return;
  const int q = static_cast<int>(t / f.lines);
  T* line = P + line_start(f, t - q * f.lines);
  const int m = f.nodes == f.n || q < f.reach ? q : f.n - static_cast<int>(f.nodes) + q;
  T x = line[(LSM_GHOST + m) * f.step];
  for (int side = 0; side < 2; ++side)
    for (int k = 1; k <= LSM_GHOST; ++k) {
      T w;
      switch (f.kind[side]) {
        case LSM_BC_PERIODIC:
          if (m != (side == 0 ? f.n - 1 - k : k)) continue;
          w = T(1);
          break;
        case LSM_BC_SYMMETRY:
          if (m != (side == 0 ? k : f.n - 1 - k)) continue;
          w = T(1);
          break;
        default: {  // LSM_BC_EXTRAPOLATION: node j from the boundary inward
          const int j = side == 0 ? m : f.n - 1 - m;
          if (j > f.degree[side]) continue;
          w = T(f.w[(side * LSM_GHOST + k - 1) * f.stride + j]);
        }
      }
      const int pos = side == 0 ? LSM_GHOST - k : LSM_GHOST + f.n - 1 + k;
      x = mul_add_rn(x, w, line[pos * f.step]);
    }
  line[(LSM_GHOST + m) * f.step] = x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) table_zero_kernel(T* __restrict__ P, Phase f) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= 2 * LSM_GHOST * f.lines) return;
  const int g = static_cast<int>(t / f.lines);
  const int pos = g < LSM_GHOST ? g : f.n + g;
  P[line_start(f, t - g * f.lines) + pos * f.step] = T(0);
}

// The phase of `axis` (3D numbering; a 2D buffer is (1, n0, n1) with a dummy
// axis 0 of one padded node, `bc` its 2D axis) of a buffer of interior
// extents n and padded extents E.
Phase phase_of(const int64_t (&n)[3], const int64_t (&E)[3], int axis, int bc,
               const int* kinds, const int* degrees, const double* table, int dmax) {
  const int64_t st[3] = {E[1] * E[2], E[2], 1};
  int other[2], o = 0;
  for (int d = 0; d < 3; ++d)
    if (d != axis) other[o++] = d;
  Phase f;
  int64_t start[2], cnt[2];
  for (int i = 0; i < 2; ++i) {  // the earlier axes whole, the later ones' interior
    const int d = other[i];
    start[i] = d < axis ? 0 : LSM_GHOST;
    cnt[i] = d < axis ? E[d] : n[d];
  }
  f.lines = cnt[0] * cnt[1];
  f.cnt_b = cnt[1];
  f.st_a = st[other[0]];
  f.st_b = st[other[1]];
  f.base = start[0] * f.st_a + start[1] * f.st_b;
  f.step = st[axis];
  f.n = static_cast<int>(n[axis]);
  f.reach = LSM_GHOST + 1;  // periodic and symmetry: nodes 1..3 from each face
  for (int side = 0; side < 2; ++side) {
    const int a = 2 * bc + side;
    f.kind[side] = kinds[a];
    f.degree[side] = degrees[a];
    if (kinds[a] == LSM_BC_EXTRAPOLATION && degrees[a] + 1 > f.reach) f.reach = degrees[a] + 1;
  }
  f.nodes = f.n < 2 * f.reach ? f.n : 2 * f.reach;
  f.w = table + static_cast<int64_t>(2 * bc) * LSM_GHOST * (dmax + 1);
  f.stride = dmax + 1;
  return f;
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T>
int launch_table(int op, const void* g, void* P_, int ndim, int64_t n0, int64_t n1, int64_t n2,
                 int axis_lo, int axis_hi, const int* kinds, const int* degrees,
                 const double* table, int dmax, const void* flags, void* stream_) {
  if ((ndim != 2 && ndim != 3) || axis_lo < 0 || axis_hi > ndim || axis_lo >= axis_hi ||
      dmax < 0 || (op != LSM_TABLE_REFRESH && op != LSM_TABLE_FOLD))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  T* P = static_cast<T*>(P_);
  const int lift = 3 - ndim;  // a 2D axis is the 3D axis + 1
  const int64_t n[3] = {ndim == 3 ? n0 : 1, ndim == 3 ? n1 : n0, ndim == 3 ? n2 : n1};
  const int64_t E[3] = {ndim == 3 ? n[0] + 2 * LSM_GHOST : 1, n[1] + 2 * LSM_GHOST,
                        n[2] + 2 * LSM_GHOST};
  const int* gates = static_cast<const int*>(flags);
  if (op == LSM_TABLE_REFRESH) {
    for (int ax = axis_lo; ax < axis_hi; ++ax) {
      const Phase f = phase_of(n, E, ax + lift, ax, kinds, degrees, table, dmax);
      const int* gate = gates == nullptr ? nullptr
                        : ndim == 2      ? gates + ax
                                         : gates + (ax == 2 ? 1 : 0);
      table_refresh_kernel<T><<<blocks_for(2 * LSM_GHOST * f.lines), kThreads, 0, stream>>>(
          P, f, gate);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  if (g != P_) {
    const cudaError_t err = cudaMemcpyAsync(P_, g, sizeof(T) * E[0] * E[1] * E[2],
                                            cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int ax = ndim - 1; ax >= 0; --ax) {
    const Phase f = phase_of(n, E, ax + lift, ax, kinds, degrees, table, dmax);
    table_fold_kernel<T><<<blocks_for(f.nodes * f.lines), kThreads, 0, stream>>>(P, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int ax = 0; ax < ndim; ++ax) {
    const Phase f = phase_of(n, E, ax + lift, ax, kinds, degrees, table, dmax);
    table_zero_kernel<T><<<blocks_for(2 * LSM_GHOST * f.lines), kThreads, 0, stream>>>(P, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" int lsm_ghosts_table_f32(int op, const void* g, void* P, int ndim, int64_t n0,
                                    int64_t n1, int64_t n2, int axis_lo, int axis_hi,
                                    const int* kinds, const int* degrees, const double* table,
                                    int dmax, const void* flags, void* stream) {
  return launch_table<float>(op, g, P, ndim, n0, n1, n2, axis_lo, axis_hi, kinds, degrees, table,
                             dmax, flags, stream);
}

extern "C" int lsm_ghosts_table_f64(int op, const void* g, void* P, int ndim, int64_t n0,
                                    int64_t n1, int64_t n2, int axis_lo, int axis_hi,
                                    const int* kinds, const int* degrees, const double* table,
                                    int dmax, const void* flags, void* stream) {
  return launch_table<double>(op, g, P, ndim, n0, n1, n2, axis_lo, axis_hi, kinds, degrees, table,
                              dmax, flags, stream);
}
