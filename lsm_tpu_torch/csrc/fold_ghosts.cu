// K4: fold of the ghost-shell cotangents of a padded buffer into its
// interior (the transpose of K2), and K5: zeroing of the ghost shells.
//
// K4 replaces the TPU kernel lsm_tpu/ops/weno_v2_bwd.py
// `fold_ghost_cotangent_fast`; K5 replaces `_zero_pad_shells` there.
//
// K4. K2 writes the ghosts of axis 0, then axis 1 (over axis 0's padded
// extent), then axis 2 (over the padded extents of axes 0 and 1), each ghost
// a weighted sum of interior nodes of its line. The transpose runs the three
// launches in reverse order, axis 2, then 1, then 0, each over the same lines
// K2's launch for that axis covers. A thread owns one line: for the left,
// then the right side, for the ghost at distance k = 1..3, it adds
// w * g[ghost] onto each source node of the line (periodic, shared
// endpoint: left k <- node n-1-k, right k <- node k; symmetry: left k <-
// node k, right k <- node n-1-k; extrapolation of degree P <= 7: the
// Lagrange weights of K2, nodes j = 0..P from the boundary inward), then
// zeroes the line's six ghosts. A line owns its ghosts and its sources, so
// there is no race and no atomic. Each product and sum is rounded on its
// own (__fmul_rn/__fadd_rn), in the order of the plain torch version
// (ops/weno_v2_bwd.py `fold_ghost_cotangent_plain`), so the two agree bit for
// bit.
//
// K5. One launch, one thread per ghost node of the six slabs (axis-0 slabs
// over the padded extents of axes 1 and 2, axis-1 slabs over interior axis
// 0, axis-2 slabs over interior axes 0 and 1), writing 0.
//
// Bound: both touch only the O(N^2) shells and the interior strips next to
// them: at 512^3 about 4.8 M ghost nodes, so some 40 MB of traffic for K4
// (~0.012 ms at 3.35 TB/s) and 19 MB for K5; launch latency dominates.

#include <cuda_runtime.h>

#include "lsm_kernels.h"

namespace {

struct AxisFold {
  int kind[2];
  int degree[2];
  double w[2][LSM_GHOST][LSM_MAX_DEGREE + 1];  // [side][k-1][j]
};

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_add_rn(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}
__device__ __forceinline__ double mul_add_rn(double acc, double w, double x) {
  return __dadd_rn(acc, __dmul_rn(w, x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fold_axis_kernel(T* __restrict__ g, int64_t n, int64_t stride, int64_t a_lo,
                     int64_t a_cnt, int64_t a_stride, int64_t b_lo, int64_t b_cnt,
                     int64_t b_stride, AxisFold bc) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a_cnt * b_cnt) return;
  const int64_t b = t % b_cnt, a = t / b_cnt;
  T* line = g + (a_lo + a) * a_stride + (b_lo + b) * b_stride;  // padded index 0
  T* node = line + LSM_GHOST * stride;                            // interior node 0
  for (int side = 0; side < 2; ++side) {
    for (int k = 1; k <= LSM_GHOST; ++k) {
      const int64_t pos = side == 0 ? LSM_GHOST - k : LSM_GHOST + n - 1 + k;
      const T gv = line[pos * stride];
      switch (bc.kind[side]) {
        case LSM_BC_PERIODIC: {
          T* src = node + (side == 0 ? n - 1 - k : k) * stride;
          *src = mul_add_rn(*src, T(1), gv);
          break;
        }
        case LSM_BC_SYMMETRY: {
          T* src = node + (side == 0 ? k : n - 1 - k) * stride;
          *src = mul_add_rn(*src, T(1), gv);
          break;
        }
        default: {  // LSM_BC_EXTRAPOLATION
          const double* w = bc.w[side][k - 1];
          for (int j = 0; j <= bc.degree[side]; ++j) {
            T* src = node + (side == 0 ? j : n - 1 - j) * stride;
            *src = mul_add_rn(*src, T(w[j]), gv);
          }
          break;
        }
      }
    }
  }
  for (int l = 0; l < LSM_GHOST; ++l) {
    line[l * stride] = T(0);
    line[(LSM_GHOST + n + l) * stride] = T(0);
  }
}

template <typename T>
int launch_fold(void* g_, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                const int* degrees, const double* weights, void* stream_) {
  T* g = static_cast<T*>(g_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int64_t n[3] = {n0, n1, n2};
  const int64_t S[3] = {n0 + 2 * LSM_GHOST, n1 + 2 * LSM_GHOST, n2 + 2 * LSM_GHOST};
  const int64_t stride[3] = {S[1] * S[2], S[2], 1};
  for (int axis = 2; axis >= 0; --axis) {
    AxisFold bc;
    for (int side = 0; side < 2; ++side) {
      const int a = 2 * axis + side;
      bc.kind[side] = kinds[a];
      bc.degree[side] = degrees[a];
      for (int k = 0; k < LSM_GHOST; ++k)
        for (int j = 0; j <= LSM_MAX_DEGREE; ++j)
          bc.w[side][k][j] = weights[(a * LSM_GHOST + k) * (LSM_MAX_DEGREE + 1) + j];
    }
    // the lines K2 refreshes for this axis: earlier axes over their padded
    // extent, later ones over their interior; the later of the two other axes
    // is the thread's fastest index
    const int oa = axis == 0 ? 1 : 0;
    const int ob = axis == 2 ? 1 : 2;
    const int64_t a_lo = oa < axis ? 0 : LSM_GHOST;
    const int64_t a_cnt = oa < axis ? S[oa] : n[oa];
    const int64_t b_lo = ob < axis ? 0 : LSM_GHOST;
    const int64_t b_cnt = ob < axis ? S[ob] : n[ob];
    const unsigned blocks = static_cast<unsigned>((a_cnt * b_cnt + kThreads - 1) / kThreads);
    fold_axis_kernel<T><<<blocks, kThreads, 0, stream>>>(g, n[axis], stride[axis], a_lo, a_cnt,
                                                         stride[oa], b_lo, b_cnt, stride[ob], bc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    zero_shells_kernel(T* __restrict__ buf, int64_t n0, int64_t n1, int64_t n2) {
  const int64_t S1 = n1 + 2 * LSM_GHOST, S2 = n2 + 2 * LSM_GHOST;
  const int64_t cnt0 = 2 * LSM_GHOST * S1 * S2;  // axis-0 slabs
  const int64_t cnt1 = n0 * 2 * LSM_GHOST * S2;  // axis-1 slabs, interior axis 0
  const int64_t cnt2 = n0 * n1 * 2 * LSM_GHOST;  // axis-2 slabs, interior axes 0, 1
  int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t i, j, k;
  auto ghost = [](int64_t s6, int64_t n) { return s6 < LSM_GHOST ? s6 : n + s6; };
  if (t < cnt0) {
    k = t % S2;
    j = (t / S2) % S1;
    i = ghost(t / (S1 * S2), n0);
  } else if ((t -= cnt0) < cnt1) {
    k = t % S2;
    j = ghost((t / S2) % (2 * LSM_GHOST), n1);
    i = LSM_GHOST + t / (S2 * 2 * LSM_GHOST);
  } else if ((t -= cnt1) < cnt2) {
    k = ghost(t % (2 * LSM_GHOST), n2);
    j = LSM_GHOST + (t / (2 * LSM_GHOST)) % n1;
    i = LSM_GHOST + t / (2 * LSM_GHOST * n1);
  } else {
    return;
  }
  buf[(i * S1 + j) * S2 + k] = T(0);
}

template <typename T>
int launch_zero_shells(void* buf, int64_t n0, int64_t n1, int64_t n2, void* stream) {
  const int64_t S0 = n0 + 2 * LSM_GHOST, S1 = n1 + 2 * LSM_GHOST, S2 = n2 + 2 * LSM_GHOST;
  const int64_t total = S0 * S1 * S2 - n0 * n1 * n2;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  zero_shells_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(buf), n0, n1, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_fold_ghosts_f32(void* g, int64_t n0, int64_t n1, int64_t n2,
                                   const int* kinds, const int* degrees,
                                   const double* weights, void* stream) {
  return launch_fold<float>(g, n0, n1, n2, kinds, degrees, weights, stream);
}

extern "C" int lsm_fold_ghosts_f64(void* g, int64_t n0, int64_t n1, int64_t n2,
                                   const int* kinds, const int* degrees,
                                   const double* weights, void* stream) {
  return launch_fold<double>(g, n0, n1, n2, kinds, degrees, weights, stream);
}

extern "C" int lsm_zero_shells_f32(void* buf, int64_t n0, int64_t n1, int64_t n2,
                                   void* stream) {
  return launch_zero_shells<float>(buf, n0, n1, n2, stream);
}

extern "C" int lsm_zero_shells_f64(void* buf, int64_t n0, int64_t n1, int64_t n2,
                                   void* stream) {
  return launch_zero_shells<double>(buf, n0, n1, n2, stream);
}
