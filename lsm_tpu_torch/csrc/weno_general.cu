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
// The per-node arithmetic is K1's and K6's (weno5.cuh): the same WENO5
// core, epsilon floors and upwind choice at u == 0, so the three stage
// kernels cannot drift apart.
//
// K10's design is K1's march (march.cuh; weno_stage.cu's top comment): a
// block of 16 x 32 columns marches a chunk of <= 64 planes of axis 0, each
// plane of phi with its halo and the output plane's velocity and aux staged
// in shared memory by cp.async, the differences along axis 0 kept in
// registers. K1 keeps aux and the output on the padded layout; here both are
// interior-shaped (kInterior): aux is copied as the velocity is (16 bytes
// at a time where n2 % 4 == 0 (f32) and the pointer is aligned), and the
// output plane is stored at the interior index (o*n1 + j)*n2 + k. On the
// same P, u and aux, K10's output equals the interior of K1's bit for bit.
// Axis 0 is always marched: MeshField.pad(3) makes no promise about the
// ghosts of a one-node axis, so K1's n0 == 1 shortcut is not taken.
//
// K11's design is K1's 2D march (march2d.cuh; weno_stage_2d.cu's top
// comment): a block of 128 threads owns 128 columns of axis 1 and marches
// down a chunk of <= 64 rows of axis 0, eight padded rows of phi a step and
// the output rows' velocity and aux staged in shared memory by cp.async,
// the axis-0 differences of a column formed once for its eight rows. As in
// K10, aux and the output are interior-shaped (kInterior): aux is copied as
// the velocity is (16 bytes at a time where n1 % 4 == 0 (f32) and the
// pointer is aligned, else element by element), and the output row stored
// at o*n1 + k; axis 0 is always marched. The per-node arithmetic is
// stage_value_at<T, 2>'s from the same differences, so on the same P, u and
// aux K11's output equals the interior of K1 2D's streamed entry bit for
// bit. (Its first design, one thread per node with its 13-point stencil
// from device memory, took 0.2212 ms at 4096^2 f32 on an H100: PERF.md.)
//
// Bound at 512^3 f32: the padded phi read once (518^3 * 4 B), three velocity
// components read and the output written: 20 B per cell (24 with aux),
// 0.81 ms (0.97 ms) at 3.35 TB/s; its ~269 FP32 operations per cell take
// 0.54 ms at 67 TFLOP/s, so bytes bind. At 4096^2 f32 K11 moves 16 B per
// cell (20 with aux): 0.08 ms, where launch overhead is of the same order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "lsm_kernels.h"
#include "march.cuh"
#include "march2d.cuh"
#include "weno5.cuh"

namespace {

constexpr int64_t kMaxGridYZ = 65535;

// K10: K1's march (march.cuh) with an interior-shaped aux and output; axis
// 0 always on (MeshField.pad(3) makes no promise about a one-node axis).
template <typename T>
__global__ void __launch_bounds__(March<T>::NT, March<T>::MIN_BLOCKS)
    general_march_kernel(const __grid_constant__ MarchArgs<T> a) {
  march<T, false, true, true>(a, nullptr);
}

// K11: K1's 2D march (march2d.cuh) with an interior-shaped aux and output.
template <typename T>
__global__ void __launch_bounds__(March2<T>::NT)
    general_march_2d_kernel(const __grid_constant__ March2Args<T> a, int vec_aux) {
  march2d<T, kStream, true>(a, nullptr, vec_aux);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
int launch_3d(const void* P, const void* u0, const void* u1, const void* u2, const void* aux,
              void* out, int64_t n0, int64_t n1, int64_t n2, double inv_h0, double inv_h1,
              double inv_h2, double alpha, double beta, double gamma, void* stream) {
  using M = March<T>;
  const int64_t chunks = cdiv(n0, kChunk);
  if (n0 < 1 || n1 < 1 || n2 < 1 || n0 > INT_MAX || chunks > kMaxGridYZ ||
      cdiv(n1, M::CY) > kMaxGridYZ || n1 + 2 * LSM_GHOST > INT_MAX / (n2 + 2 * LSM_GHOST))
    return static_cast<int>(cudaErrorInvalidValue);  // offsets inside a plane are 32-bit
  MarchArgs<T> a{};
  a.P = static_cast<const T*>(P);
  a.u[0] = static_cast<const T*>(u0);
  a.u[1] = static_cast<const T*>(u1);
  a.u[2] = static_cast<const T*>(u2);
  a.aux = static_cast<const T*>(aux);
  a.out = static_cast<T*>(out);
  a.n0 = static_cast<int>(n0);
  a.n1 = static_cast<int>(n1);
  a.n2 = static_cast<int>(n2);
  a.s1 = a.n2 + 2 * LSM_GHOST;
  a.s0 = int64_t(a.n1 + 2 * LSM_GHOST) * a.s1;
  a.m12 = n1 * n2;
  a.chunk = static_cast<int>(cdiv(n0, chunks));  // as even as n0 allows
  a.inv_h[0] = T(inv_h0);
  a.inv_h[1] = T(inv_h1);
  a.inv_h[2] = T(inv_h2);
  a.alpha = T(alpha);
  a.beta = T(beta);
  a.gamma = T(gamma);
  a.pairs = a.s1 % 2 == 0 && aligned(P, 2 * sizeof(T));
  a.vec_u = a.n2 % M::VU == 0 && aligned(u0, 16) && aligned(u1, 16) && aligned(u2, 16);
  a.vec_aux = a.n2 % M::VU == 0 && aligned(aux, 16);
  const dim3 grid(static_cast<unsigned>(cdiv(n2, M::CX)), static_cast<unsigned>(cdiv(n1, M::CY)),
                  static_cast<unsigned>(chunks));
  const auto kernel = general_march_kernel<T>;
  const size_t smem = MarchRing<T, false>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    kernel<<<grid, M::NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_2d(const void* P, const void* u0, const void* u1, const void* aux, void* out,
              int64_t n0, int64_t n1, double inv_h0, double inv_h1, double alpha, double beta,
              double gamma, void* stream) {
  using M = March2<T>;
  March2Args<T> a;
  dim3 grid;
  if (!march2_args<T>(a, P, aux, out, n0, n1, 2, grid, true))
    return static_cast<int>(cudaErrorInvalidValue);
  a.sptr[0] = static_cast<const T*>(u0);
  a.sptr[1] = static_cast<const T*>(u1);
  a.vec_s = a.n1 % M::VU == 0 && aligned(u0, 16) && aligned(u1, 16);
  const int vec_aux = a.n1 % M::VU == 0 && aligned(aux, 16);
  a.inv_h[0] = T(inv_h0);
  a.inv_h[1] = T(inv_h1);
  a.alpha = T(alpha);
  a.beta = T(beta);
  a.gamma = T(gamma);
  const size_t smem = size_t(a.elems) * sizeof(T) * M::S;
  const auto kernel = general_march_2d_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    kernel<<<grid, M::NT, smem, static_cast<cudaStream_t>(stream)>>>(a, vec_aux);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
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
