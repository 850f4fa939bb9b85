// K10 and K11: the WENO5 advection stage of the general path, 3D and 2D.
//
// Replace the TPU kernel lsm_tpu/ops/weno_pallas.py `weno_stage_pallas`
// (bodies `_make_kernel_3d` and `_make_kernel_2d`):
//   out = alpha*aux + beta*phi - gamma * sum_d u_d * WENO5_d(phi)
// on a field padded by 3 ghost layers on every side (`MeshField.pad(3)`,
// strides ((n1+6)(n2+6), n2+6, 1), or (n1+6, 1) in 2D), with u, aux and out
// interior-shaped and contiguous. The host passes (0, 0, -1) and no aux for
// the bare Hamiltonian.
//
// The per-node arithmetic is K1's and K6's (lsm::stage_value_at, weno5.cuh):
// the same WENO5 core, epsilon floors and upwind choice at u == 0, so the
// three stage kernels cannot drift apart. Unlike K1, aux is read and out
// written at the interior index q.
//
// Design: K1's layout, one thread per interior node, threadIdx.x along the
// contiguous last axis (64 per block) so a warp reads and writes neighbouring
// elements; each thread loads its 13-point (2D) or 19-point (3D) stencil
// from device memory and relies on L1/L2 for the reuse between neighbours.
// The outer axis is walked by a grid-stride loop, so any extent launches.
// Indices are int64_t: the 512^3 padded buffer holds 1.39e8 elements.
//
// Bound at 512^3 f32: the padded phi read once (518^3 * 4 B), three velocity
// components read and the output written: 20 B per cell (24 with aux),
// 0.81 ms (0.97 ms) at 3.35 TB/s; its ~269 FP32 operations per cell take
// 0.54 ms at 67 TFLOP/s, so bytes bind. At 4096^2 f32 K11 moves 16 B per
// cell (20 with aux): 0.08 ms, where launch overhead is of the same order.
// Shared-memory tiles and TMA are later work.

#include <cuda_runtime.h>

#include "lsm_kernels.h"
#include "weno5.cuh"

namespace {

constexpr int kBlockX = 64;
constexpr int kBlockY = 4;
constexpr int64_t kMaxGridYZ = 65535;

template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    weno_general_3d_kernel(const T* __restrict__ P, const T* __restrict__ u0,
                           const T* __restrict__ u1, const T* __restrict__ u2,
                           const T* __restrict__ aux, T* __restrict__ out, int64_t n0,
                           int64_t n1, int64_t n2, T inv_h0, T inv_h1, T inv_h2, T alpha,
                           T beta, T gamma) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  if (k >= n2 || j >= n1) return;
  const int64_t s1 = n2 + 2 * LSM_GHOST;
  const int64_t s0 = (n1 + 2 * LSM_GHOST) * s1;
  const int64_t stride[3] = {s0, s1, 1};
  const T inv_h[3] = {inv_h0, inv_h1, inv_h2};
  for (int64_t i = blockIdx.z; i < n0; i += gridDim.z) {
    const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
    const int64_t q = (i * n1 + j) * n2 + k;
    const T u[3] = {u0[q], u1[q], u2[q]};
    out[q] = lsm::stage_value_at<T, 3>(P, aux, c, q, stride, u, inv_h, alpha, beta, gamma);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    weno_general_2d_kernel(const T* __restrict__ P, const T* __restrict__ u0,
                           const T* __restrict__ u1, const T* __restrict__ aux,
                           T* __restrict__ out, int64_t n0, int64_t n1, T inv_h0, T inv_h1,
                           T alpha, T beta, T gamma) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  if (k >= n1) return;
  const int64_t s0 = n1 + 2 * LSM_GHOST;
  const int64_t stride[2] = {s0, 1};
  const T inv_h[2] = {inv_h0, inv_h1};
  const int64_t rows = static_cast<int64_t>(gridDim.y) * kBlockY;
  for (int64_t i = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y; i < n0; i += rows) {
    const int64_t c = (i + LSM_GHOST) * s0 + (k + LSM_GHOST);
    const int64_t q = i * n1 + k;
    const T u[2] = {u0[q], u1[q]};
    out[q] = lsm::stage_value_at<T, 2>(P, aux, c, q, stride, u, inv_h, alpha, beta, gamma);
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

int64_t capped(int64_t blocks) { return blocks < kMaxGridYZ ? blocks : kMaxGridYZ; }

template <typename T>
int launch_3d(const void* P, const void* u0, const void* u1, const void* u2, const void* aux,
              void* out, int64_t n0, int64_t n1, int64_t n2, double inv_h0, double inv_h1,
              double inv_h2, double alpha, double beta, double gamma, void* stream) {
  if (n0 < 1 || n1 < 1 || n2 < 1 || cdiv(n1, kBlockY) > kMaxGridYZ)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid(static_cast<unsigned>(cdiv(n2, kBlockX)),
                  static_cast<unsigned>(cdiv(n1, kBlockY)), static_cast<unsigned>(capped(n0)));
  weno_general_3d_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const T*>(u2), static_cast<const T*>(aux), static_cast<T*>(out), n0, n1, n2,
      T(inv_h0), T(inv_h1), T(inv_h2), T(alpha), T(beta), T(gamma));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_2d(const void* P, const void* u0, const void* u1, const void* aux, void* out,
              int64_t n0, int64_t n1, double inv_h0, double inv_h1, double alpha, double beta,
              double gamma, void* stream) {
  if (n0 < 1 || n1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid(static_cast<unsigned>(cdiv(n1, kBlockX)),
                  static_cast<unsigned>(capped(cdiv(n0, kBlockY))), 1);
  weno_general_2d_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const T*>(aux), static_cast<T*>(out), n0, n1, T(inv_h0), T(inv_h1), T(alpha),
      T(beta), T(gamma));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_weno_general_3d_f32(const void* P, const void* u0, const void* u1,
                                       const void* u2, const void* aux, void* out, int64_t n0,
                                       int64_t n1, int64_t n2, double inv_h0, double inv_h1,
                                       double inv_h2, double alpha, double beta, double gamma,
                                       void* stream) {
  return launch_3d<float>(P, u0, u1, u2, aux, out, n0, n1, n2, inv_h0, inv_h1, inv_h2, alpha,
                          beta, gamma, stream);
}

extern "C" int lsm_weno_general_3d_f64(const void* P, const void* u0, const void* u1,
                                       const void* u2, const void* aux, void* out, int64_t n0,
                                       int64_t n1, int64_t n2, double inv_h0, double inv_h1,
                                       double inv_h2, double alpha, double beta, double gamma,
                                       void* stream) {
  return launch_3d<double>(P, u0, u1, u2, aux, out, n0, n1, n2, inv_h0, inv_h1, inv_h2, alpha,
                           beta, gamma, stream);
}

extern "C" int lsm_weno_general_2d_f32(const void* P, const void* u0, const void* u1,
                                       const void* aux, void* out, int64_t n0, int64_t n1,
                                       double inv_h0, double inv_h1, double alpha, double beta,
                                       double gamma, void* stream) {
  return launch_2d<float>(P, u0, u1, aux, out, n0, n1, inv_h0, inv_h1, alpha, beta, gamma,
                          stream);
}

extern "C" int lsm_weno_general_2d_f64(const void* P, const void* u0, const void* u1,
                                       const void* aux, void* out, int64_t n0, int64_t n1,
                                       double inv_h0, double inv_h1, double alpha, double beta,
                                       double gamma, void* stream) {
  return launch_2d<double>(P, u0, u1, aux, out, n0, n1, inv_h0, inv_h1, alpha, beta, gamma,
                           stream);
}
