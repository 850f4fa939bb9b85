// K1: one fused RK stage on the padded layout.
//
// Replaces the TPU kernel lsm_tpu/ops/weno_v2.py `fused_stage` (body
// `_make_kernel`). Three entries:
// - the advection-only stage (one WENO5 advection term, three streamed
//   velocity components): lsm::stage_value (weno5.cuh);
// - K1'': the same stage with the velocity a coefficient program, evaluated
//   per node by csrc/coef_program.cuh at lo + (origin + i)*h and the stage
//   time (the TPU kernel's "analytic" branch, `_coords_block`): nothing is
//   streamed, 12 B/cell less in f32;
// - any term list (advection, normal motion, curvature, eikonal
//   reinitialization; streamed, constant, program or no coefficient), summed
//   in list order: lsm::stage_value_terms (hamiltonians.cuh). The table
//   travels by value in the kernel's parameters (__grid_constant__, so a loop
//   over it reads the constant bank without a local copy); its branches are
//   uniform.
// The per-node functions are shared with the band stage K6.
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
// on the FP32 pipes. The term-list entry reads phi (and per term at most one
// scalar stream) and writes phi: 8-12 B/cell for the normal, curvature and
// eikonal kinds, ~0.3-0.5 ms at 512^3 f32; a normal or eikonal term does
// ~140 operations per cell, a curvature term ~70, so it sits on the FP32
// pipes as much as on DRAM. Divisions by spacing constants are products by
// host-computed reciprocals, and a table without advection takes an
// instantiation without WENO5's registers (more threads resident per SM).
// K1'' reads phi (and aux) and writes phi, 8-12 B/cell: at 512^3 f32 its 269
// WENO5 operations per cell bind (0.54 ms at 67 TFLOP/s) before DRAM does,
// plus the program's own (the rotation: one table load per component).
// Shared-memory tiles and marching along an axis in registers are later work.

#include <cuda_runtime.h>

#include "coef_program.cuh"
#include "hamiltonians.cuh"
#include "lsm_kernels.h"
#include "weno5.cuh"

namespace {

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
  out[c] = lsm::stage_value(P, aux, c, s0, s1, u0[q], u1[q], u2[q], inv_h0, inv_h1, inv_h2,
                            alpha, beta, gamma);
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

template <typename T, bool kAdvection, bool kProgram>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    weno_stage_terms_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                            T* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                            const __grid_constant__ LsmStageTerms terms) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (k >= n2 || j >= n1 || i >= n0) return;
  const int64_t s1 = n2 + 2 * LSM_GHOST;
  const int64_t s0 = (n1 + 2 * LSM_GHOST) * s1;
  const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
  const int64_t q = (i * n1 + j) * n2 + k;
  out[c] = lsm::stage_value_terms<T, kAdvection, kProgram>(P, aux, c, s0, s1, q, i, j, k,
                                                           terms);
}

template <typename T>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    weno_stage_prog_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                           T* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                           lsm::StageConsts<T> sc,
                           const __grid_constant__ LsmStageTerms terms) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (k >= n2 || j >= n1 || i >= n0) return;
  const int64_t s1 = n2 + 2 * LSM_GHOST;
  const int64_t s0 = (n1 + 2 * LSM_GHOST) * s1;
  const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
  const T u0 = lsm::prog_value<T>(terms.prog, 0, 0, i, j, k);
  const T u1 = lsm::prog_value<T>(terms.prog, 0, 1, i, j, k);
  const T u2 = lsm::prog_value<T>(terms.prog, 0, 2, i, j, k);
  out[c] = lsm::stage_value(P, aux, c, s0, s1, u0, u1, u2, sc.inv_h0, sc.inv_h1, sc.inv_h2,
                            sc.alpha, sc.beta, sc.gamma);
}

template <typename T>
int launch_stage_prog(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                      int64_t n2, const LsmStageTerms* terms, void* stream) {
  if (terms->n != 1 || terms->coef[0] != LSM_COEF_PROGRAM)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid(static_cast<unsigned>((n2 + kBlockX - 1) / kBlockX),
                  static_cast<unsigned>((n1 + kBlockY - 1) / kBlockY),
                  static_cast<unsigned>(n0));
  weno_stage_prog_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(aux), static_cast<T*>(out), n0, n1, n2,
      lsm::StageConsts<T>::of(*terms), *terms);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stage_terms(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                       int64_t n2, const LsmStageTerms* terms, void* stream) {
  if (terms->n < 1 || terms->n > LSM_MAX_TERMS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid(static_cast<unsigned>((n2 + kBlockX - 1) / kBlockX),
                  static_cast<unsigned>((n1 + kBlockY - 1) / kBlockY),
                  static_cast<unsigned>(n0));
  const bool adv = lsm::has_advection(*terms), prog = lsm::has_program(*terms);
  const auto kernel = adv ? (prog ? weno_stage_terms_kernel<T, true, true>
                                  : weno_stage_terms_kernel<T, true, false>)
                          : (prog ? weno_stage_terms_kernel<T, false, true>
                                  : weno_stage_terms_kernel<T, false, false>);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(aux), static_cast<T*>(out), n0, n1, n2,
      *terms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_weno_stage_terms_f32(const void* P, const void* aux, void* out, int64_t n0,
                                        int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                        void* stream) {
  return launch_stage_terms<float>(P, aux, out, n0, n1, n2, terms, stream);
}

extern "C" int lsm_weno_stage_terms_f64(const void* P, const void* aux, void* out, int64_t n0,
                                        int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                        void* stream) {
  return launch_stage_terms<double>(P, aux, out, n0, n1, n2, terms, stream);
}

extern "C" int lsm_weno_stage_prog_f32(const void* P, const void* aux, void* out, int64_t n0,
                                       int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                       void* stream) {
  return launch_stage_prog<float>(P, aux, out, n0, n1, n2, terms, stream);
}

extern "C" int lsm_weno_stage_prog_f64(const void* P, const void* aux, void* out, int64_t n0,
                                       int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                       void* stream) {
  return launch_stage_prog<double>(P, aux, out, n0, n1, n2, terms, stream);
}

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
