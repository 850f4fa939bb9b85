// K1: one fused RK stage of WENO5 advection on the padded layout.
//
// Replaces the TPU kernel lsm_tpu/ops/weno_v2.py `fused_stage` (body
// `_make_kernel`) for the "advection" term kind with three streamed velocity
// components. Arithmetic follows lsm_tpu/ops/stencils.py `weno5_upwind` /
// `_weno_combine` term by term: the five stencil inputs are selected by the
// sign of u (u == 0 takes the plus branch), one Jiang-Shu core runs, and the
// weights use the one-division form.
//
// Design: one thread per interior node, threadIdx.x along the contiguous last
// axis so a warp reads and writes 32 neighbouring floats. Each thread loads
// its 19-point stencil (7 per axis, the centre shared) straight from device
// memory and relies on L1/L2 for the reuse between neighbours.
//
// Bound at 512^3 f32: per cell it reads phi once from DRAM when the caches
// hold the neighbour planes, 3 velocity components and aux (stages 2-3), and
// writes phi: 20-24 B/cell, ~1 ms at 3.35 TB/s. It also does a few hundred
// flops per cell including 6 IEEE divisions (no fast math), comparable time
// on the FP32 pipes. Shared-memory tiles, marching along an axis in registers
// and in-kernel analytic coefficients are later work.

#include <cuda_runtime.h>

#include "lsm_kernels.h"

namespace {

template <typename T>
struct WenoFloor;
template <>
struct WenoFloor<float> {
  static __device__ __forceinline__ float value() { return 1.0e-12f; }
};
template <>
struct WenoFloor<double> {
  static __device__ __forceinline__ double value() { return 1.0e-36; }
};

template <typename T>
__device__ __forceinline__ T max2(T a, T b) {
  return a > b ? a : b;
}

// u * WENO5 upwind derivative from the six backward differences dm[0..5]
// (D- at I-2 .. I+3), as stencils.weno5_upwind.
template <typename T>
__device__ __forceinline__ T weno5_upwind(const T* dm, T u) {
  const bool cond = u > T(0);
  const T v1 = cond ? dm[0] : dm[5];
  const T v2 = cond ? dm[1] : dm[4];
  const T v3 = cond ? dm[2] : dm[3];
  const T v4 = cond ? dm[3] : dm[2];
  const T v5 = cond ? dm[4] : dm[1];
  const T e2 = v3 - v2;
  const T e3 = v4 - v3;
  const T c1 = e2 - (v2 - v1);
  const T c2 = e3 - e2;
  const T c3 = (v5 - v4) - e3;
  const T d1 = v3 + T(0.5) * e2 + T(1.0 / 3.0) * c1;
  const T d2 = v3 + T(0.5) * e3 - T(1.0 / 6.0) * c2;
  const T d3 = v3 + T(0.5) * e3 - T(1.0 / 6.0) * c3;
  const T c13 = T(13.0 / 12.0);
  const T t1 = c1 + T(2.0) * e2;
  const T t2 = e2 + e3;
  const T t3 = c3 - T(2.0) * e3;
  const T s1 = c13 * (c1 * c1) + T(0.25) * (t1 * t1);
  const T s2 = c13 * (c2 * c2) + T(0.25) * (t2 * t2);
  const T s3 = c13 * (c3 * c3) + T(0.25) * (t3 * t3);
  const T vmax = max2(max2(max2(v1 * v1, v2 * v2), max2(v3 * v3, v4 * v4)), v5 * v5);
  const T eps = T(1.0e-6) * vmax + WenoFloor<T>::value();
  const T r = T(1.0) / eps;
  const T b1 = s1 * r + T(1.0);
  const T b2 = s2 * r + T(1.0);
  const T b3 = s3 * r + T(1.0);
  const T p1 = b2 * b3;
  const T p2 = b1 * b3;
  const T p3 = b1 * b2;
  const T q1 = T(0.1) * (p1 * p1);
  const T q2 = T(0.6) * (p2 * p2);
  const T q3 = T(0.3) * (p3 * p3);
  const T w = T(1.0) / (q1 + q2 + q3);
  return u * ((q1 * d1 + q2 * d2 + q3 * d3) * w);
}

// u * WENO5 along the axis with element stride `stride`, centred at `c`.
template <typename T>
__device__ __forceinline__ T axis_term(const T* __restrict__ P, int64_t c, int64_t stride,
                                       T inv_h, T u) {
  T s[7];
#pragma unroll
  for (int m = 0; m < 7; ++m) s[m] = P[c + (m - 3) * stride];
  T dm[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) dm[m] = (s[m + 1] - s[m]) * inv_h;
  return weno5_upwind(dm, u);
}

constexpr int kBlockX = 64;
constexpr int kBlockY = 4;

template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    weno_stage_kernel(const T* __restrict__ P, const T* __restrict__ u0,
                      const T* __restrict__ u1, const T* __restrict__ u2,
                      const T* __restrict__ aux, T* __restrict__ out, int64_t n0,
                      int64_t n1, int64_t n2, T inv_h0, T inv_h1, T inv_h2, T alpha,
                      T beta, T gamma) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (k >= n2 || j >= n1 || i >= n0) return;
  const int64_t s1 = n2 + 2 * LSM_GHOST;        // stride of axis 1
  const int64_t s0 = (n1 + 2 * LSM_GHOST) * s1;  // stride of axis 0
  const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
  const int64_t q = (i * n1 + j) * n2 + k;  // interior (stream) index
  T ham = axis_term(P, c, s0, inv_h0, u0[q]);
  ham = ham + axis_term(P, c, s1, inv_h1, u1[q]);
  ham = ham + axis_term(P, c, int64_t(1), inv_h2, u2[q]);
  T res = beta * P[c] - gamma * ham;
  if (aux != nullptr) res = alpha * aux[c] + res;
  out[c] = res;
}

template <typename T>
int launch_stage(const void* P, const void* u0, const void* u1, const void* u2,
                 const void* aux, void* out, int64_t n0, int64_t n1, int64_t n2,
                 double inv_h0, double inv_h1, double inv_h2, double alpha, double beta,
                 double gamma, void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid(static_cast<unsigned>((n2 + kBlockX - 1) / kBlockX),
                  static_cast<unsigned>((n1 + kBlockY - 1) / kBlockY),
                  static_cast<unsigned>(n0));
  weno_stage_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const T*>(u2), static_cast<const T*>(aux), static_cast<T*>(out), n0, n1,
      n2, T(inv_h0), T(inv_h1), T(inv_h2), T(alpha), T(beta), T(gamma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_weno_stage_f32(const void* P, const void* u0, const void* u1,
                                  const void* u2, const void* aux, void* out, int64_t n0,
                                  int64_t n1, int64_t n2, double inv_h0, double inv_h1,
                                  double inv_h2, double alpha, double beta, double gamma,
                                  void* stream) {
  return launch_stage<float>(P, u0, u1, u2, aux, out, n0, n1, n2, inv_h0, inv_h1, inv_h2,
                             alpha, beta, gamma, stream);
}

extern "C" int lsm_weno_stage_f64(const void* P, const void* u0, const void* u1,
                                  const void* u2, const void* aux, void* out, int64_t n0,
                                  int64_t n1, int64_t n2, double inv_h0, double inv_h1,
                                  double inv_h2, double alpha, double beta, double gamma,
                                  void* stream) {
  return launch_stage<double>(P, u0, u1, u2, aux, out, n0, n1, n2, inv_h0, inv_h1, inv_h2,
                              alpha, beta, gamma, stream);
}

extern "C" const char* lsm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
