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
// Design: three launches, axis 0, then axis 1, then axis 2, on one stream. A
// launch's blocks run in no order on Hopper, so the composition order that
// makes corner ghosts equal pad_ghost's (axis 1 reads the fresh axis-0
// ghosts, axis 2 reads both) comes from the launch order. Each thread writes
// one ghost node from at most 8 source nodes along its axis. For axes 0 and 1
// the contiguous axis 2 is the thread's fastest index (coalesced rows); for
// axis 2 the six ghost slots of one row are. The single-axis entry
// (lsm_refresh_axis_*) runs one of the three phases alone: the sharded
// refresh takes it for the axes a mesh leaves unsharded (always axis 2).
//
// Bound: it touches only the shells, O(N^2): about 6 * 518^2 nodes per axis at
// 512^3, a few MB of traffic, so launch latency dominates.
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
// on the band path, whose buffers share this uniform 3-ghost layout. It is
// the same three launches, each gated on the device by an int32 flag: the
// axis-0 and axis-1 launches return at once when flags[0] == 0, the axis-2
// launch when flags[1] == 0 (no host read, and a skipped phase leaves the
// buffer bit-identical). A shell changes only when an active tile touches
// its face, so a band that stays inside the grid skips the whole refresh.
//
// K7's 2D entry (lsm_refresh_band_ghosts_2d_*) refreshes a 2D band on its own
// (n0+6, n1+6) layout: K2's two 2D phases, axis 0 over the interior columns
// gated by flags[0], then axis 1 over every padded row gated by flags[1]
// (which the caller sets whenever flags[0] is: the axis-1 ghosts of the
// axis-0 ghost rows read those rows). The TPU kernel ran the 3D refresh on the
// (1, n0, n1) embedding, whose dummy axis keeps flags[0] on and rewrites the
// full axis-0 ghost planes at every stage; this layout has none.

#include <cuda_runtime.h>

#include "lsm_kernels.h"

namespace {

struct AxisBC {
  int kind[2];
  int degree[2];
  double w[2][LSM_GHOST][LSM_MAX_DEGREE + 1];  // [side][k-1][j]
};

constexpr int kThreads = 256;

// acc + w * x with both operations rounded separately (no FMA contraction),
// as the plain torch version computes it: the kernel then matches it bit for bit
__device__ __forceinline__ float mul_add_rn(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}
__device__ __forceinline__ double mul_add_rn(double acc, double w, double x) {
  return __dadd_rn(acc, __dmul_rn(w, x));
}

// Ghost slots of one axis: g6 in [0, 6): side = g6 / 3, layer = g6 % 3.
// Left layer l sits at padded index l (distance k = 3 - l); right layer l at
// padded index 3 + n + l (distance k = l + 1). Node m sits at 3 + m.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    refresh_axis_kernel(T* __restrict__ P, int64_t n, int64_t stride,
                        int64_t a_lo, int64_t a_cnt, int64_t a_stride, int64_t b_lo,
                        int64_t b_cnt, int64_t b_stride, int ghost_fastest, AxisBC bc,
                        const int* __restrict__ gate) {
  if (gate != nullptr && *gate == 0) return;
  const int64_t total = 2 * LSM_GHOST * a_cnt * b_cnt;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  int g6;
  int64_t a, b;
  if (ghost_fastest) {
    g6 = static_cast<int>(t % (2 * LSM_GHOST));
    const int64_t r = t / (2 * LSM_GHOST);
    b = r % b_cnt;
    a = r / b_cnt;
  } else {
    b = t % b_cnt;
    const int64_t r = t / b_cnt;
    a = r % a_cnt;
    g6 = static_cast<int>(r / a_cnt);
  }
  const int side = g6 / LSM_GHOST;
  const int layer = g6 % LSM_GHOST;
  const int64_t base = (a_lo + a) * a_stride + (b_lo + b) * b_stride;
  const int64_t pos = side == 0 ? layer : LSM_GHOST + n + layer;
  const int k = side == 0 ? LSM_GHOST - layer : layer + 1;
  const T* line = P + base + LSM_GHOST * stride;  // node 0 of this line
  T val;
  switch (bc.kind[side]) {
    case LSM_BC_PERIODIC:
      val = line[(side == 0 ? n - 1 - k : k) * stride];
      break;
    case LSM_BC_SYMMETRY:
      val = line[(side == 0 ? k : n - 1 - k) * stride];
      break;
    default: {  // LSM_BC_EXTRAPOLATION
      const double* w = bc.w[side][k - 1];
      const int P_deg = bc.degree[side];
      const int64_t step = side == 0 ? stride : -stride;
      const T* node = line + (side == 0 ? 0 : (n - 1) * stride);
      val = mul_add_rn(T(0), T(w[0]), node[0]);
      for (int j = 1; j <= P_deg; ++j) val = mul_add_rn(val, T(w[j]), node[j * step]);
      break;
    }
  }
  P[base + pos * stride] = val;
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

// Axes [axis_lo, axis_hi) in order: the whole refresh is [0, 3), one phase
// of it [axis, axis + 1).
template <typename T>
int launch_refresh(void* P_, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                   const int* degrees, const double* weights, const int* flags,
                   void* stream_, int axis_lo = 0, int axis_hi = 3) {
  T* P = static_cast<T*>(P_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int64_t n[3] = {n0, n1, n2};
  const int64_t S[3] = {n0 + 2 * LSM_GHOST, n1 + 2 * LSM_GHOST, n2 + 2 * LSM_GHOST};
  const int64_t stride[3] = {S[1] * S[2], S[2], 1};
  for (int axis = axis_lo; axis < axis_hi; ++axis) {
    const AxisBC bc = axis_bc(kinds, degrees, weights, axis);
    // the two other axes, in order; earlier axes span their padded extent
    // (ghosts already fresh), later ones their interior
    const int oa = axis == 0 ? 1 : 0;
    const int ob = axis == 2 ? 1 : 2;
    const int64_t a_lo = oa < axis ? 0 : LSM_GHOST;
    const int64_t a_cnt = oa < axis ? S[oa] : n[oa];
    const int64_t b_lo = ob < axis ? 0 : LSM_GHOST;
    const int64_t b_cnt = ob < axis ? S[ob] : n[ob];
    const int64_t total = 2 * LSM_GHOST * a_cnt * b_cnt;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    refresh_axis_kernel<T><<<blocks, kThreads, 0, stream>>>(
        P, n[axis], stride[axis], a_lo, a_cnt, stride[oa], b_lo, b_cnt, stride[ob],
        axis == 2 ? 1 : 0, bc,
        flags == nullptr ? nullptr : flags + (axis == 2 ? 1 : 0));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The two phases of a 2D buffer (n0+6, n1+6), each gated by its flag: axis 0
// over the interior columns (rows of n1 nodes, coalesced), then axis 1 over
// all n0+6 padded rows (the six ghost slots of a row fastest). The kernel's
// second line axis is unused (one line, stride 0).
template <typename T>
int launch_refresh_2d(void* P_, int64_t n0, int64_t n1, const int* kinds, const int* degrees,
                      const double* weights, const int* flags, void* stream_) {
  T* P = static_cast<T*>(P_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int64_t S1 = n1 + 2 * LSM_GHOST;
  for (int axis = 0; axis < 2; ++axis) {
    const AxisBC bc = axis_bc(kinds, degrees, weights, axis);
    const int64_t b_lo = axis == 0 ? LSM_GHOST : 0;
    const int64_t b_cnt = axis == 0 ? n1 : n0 + 2 * LSM_GHOST;
    const int64_t total = 2 * LSM_GHOST * b_cnt;
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    refresh_axis_kernel<T><<<blocks, kThreads, 0, stream>>>(
        P, axis == 0 ? n0 : n1, axis == 0 ? S1 : 1, 0, 1, 0, b_lo, b_cnt, axis == 0 ? 1 : S1,
        axis, bc, flags + axis);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One ghost of a line of n nodes: the node at index m of the line is node(m);
// side and distance k as refresh_axis_kernel takes them, with its arithmetic
// (which keeps its own copy of it, so that the 3D entries and K7 keep their
// machine code).
template <typename T, typename Node>
__device__ __forceinline__ T ghost_of(const AxisBC& bc, int side, int k, int64_t n, Node node) {
  switch (bc.kind[side]) {
    case LSM_BC_PERIODIC:
      return node(side == 0 ? n - 1 - k : k);
    case LSM_BC_SYMMETRY:
      return node(side == 0 ? k : n - 1 - k);
    default: {  // LSM_BC_EXTRAPOLATION
      const double* w = bc.w[side][k - 1];
      const int64_t m0 = side == 0 ? 0 : n - 1, step = side == 0 ? 1 : -1;
      T val = mul_add_rn(T(0), T(w[0]), node(m0));
      for (int j = 1; j <= bc.degree[side]; ++j) val = mul_add_rn(val, T(w[j]), node(m0 + j * step));
      return val;
    }
  }
}

// K2's 2D entry: every ghost of a (n0+6, n1+6) buffer in one launch. Threads
// [0, 6 n1) write the axis-0 ghosts of the interior columns (a row of n1
// fastest, coalesced), the next 6 (n0+6) the axis-1 ghosts of every padded
// row (a row's six slots fastest). An axis-1 ghost of an axis-0 ghost row (a
// corner) reads that row's values, which other threads of the launch write:
// its thread recomputes each value it reads from the interior with the
// axis-0 arithmetic, so it equals pad_ghost's composition (axis 0, then axis 1
// over the padded rows) bit for bit, and no thread reads what another writes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    refresh_2d_kernel(T* __restrict__ P, int64_t n0, int64_t n1, AxisBC bc0, AxisBC bc1) {
  const int64_t S1 = n1 + 2 * LSM_GHOST;
  const int64_t cols = 2 * LSM_GHOST * n1;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= cols + 2 * LSM_GHOST * (n0 + 2 * LSM_GHOST)) return;
  // a slot g6 in [0, 6): side g6 / 3, layer g6 % 3 (distance 3 - layer on the
  // left, layer + 1 on the right), at padded index layer or n + 3 + layer
  const auto slot = [](int g6, int64_t n, int& side, int& k, int64_t& pos) {
    side = g6 / LSM_GHOST;
    const int layer = g6 % LSM_GHOST;
    k = side == 0 ? LSM_GHOST - layer : layer + 1;
    pos = side == 0 ? layer : LSM_GHOST + n + layer;
  };
  int side, k;
  int64_t pos;
  if (t < cols) {  // an axis-0 ghost of interior column b
    const int64_t b = t % n1;
    slot(static_cast<int>(t / n1), n0, side, k, pos);
    const T* col = P + LSM_GHOST * S1 + LSM_GHOST + b;  // node (0, b)
    P[pos * S1 + LSM_GHOST + b] = ghost_of<T>(bc0, side, k, n0, [&](int64_t m) {
      return col[m * S1];
    });
    return;
  }
  const int64_t r = t - cols, row = r / (2 * LSM_GHOST);
  slot(static_cast<int>(r % (2 * LSM_GHOST)), n1, side, k, pos);
  T val;
  if (row >= LSM_GHOST && row < LSM_GHOST + n0) {
    const T* line = P + row * S1 + LSM_GHOST;  // node (row - 3, 0)
    val = ghost_of<T>(bc1, side, k, n1, [&](int64_t m) { return line[m]; });
  } else {  // a corner: the axis-0 ghost row's values, recomputed from the interior
    int side0, k0;
    int64_t pos0;
    slot(static_cast<int>(row < LSM_GHOST ? row : row - n0), n0, side0, k0, pos0);
    const T* first = P + LSM_GHOST * S1 + LSM_GHOST;  // node (0, 0)
    val = ghost_of<T>(bc1, side, k, n1, [&](int64_t m) {
      return ghost_of<T>(bc0, side0, k0, n0, [&](int64_t i) { return first[i * S1 + m]; });
    });
  }
  P[row * S1 + pos] = val;
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
  return launch_refresh<float>(P, n0, n1, n2, kinds, degrees, weights, nullptr, stream);
}

extern "C" int lsm_refresh_ghosts_f64(void* P, int64_t n0, int64_t n1, int64_t n2,
                                      const int* kinds, const int* degrees,
                                      const double* weights, void* stream) {
  return launch_refresh<double>(P, n0, n1, n2, kinds, degrees, weights, nullptr, stream);
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
  return launch_refresh<float>(P, n0, n1, n2, kinds, degrees, weights,
                               static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_band_ghosts_f64(void* P, int64_t n0, int64_t n1, int64_t n2,
                                           const int* kinds, const int* degrees,
                                           const double* weights, const void* flags,
                                           void* stream) {
  return launch_refresh<double>(P, n0, n1, n2, kinds, degrees, weights,
                                static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_band_ghosts_2d_f32(void* P, int64_t n0, int64_t n1, const int* kinds,
                                              const int* degrees, const double* weights,
                                              const void* flags, void* stream) {
  return launch_refresh_2d<float>(P, n0, n1, kinds, degrees, weights,
                                  static_cast<const int*>(flags), stream);
}

extern "C" int lsm_refresh_band_ghosts_2d_f64(void* P, int64_t n0, int64_t n1, const int* kinds,
                                              const int* degrees, const double* weights,
                                              const void* flags, void* stream) {
  return launch_refresh_2d<double>(P, n0, n1, kinds, degrees, weights,
                                   static_cast<const int*>(flags), stream);
}
