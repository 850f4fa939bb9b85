// K6: one fused RK stage over an active-tile dispatch list.
//
// Replaces the TPU kernel lsm_tpu/ops/band_pallas.py `band_stage` (body
// `_make_band_kernel`). For every node of each dispatched tile it writes,
// into the ping-pong target `out`,
//   alpha*aux + beta*phi - gamma*u.grad(phi)   where the combined band mask
//                                              is nonzero (compute band),
//   phi (the source's own value)               elsewhere in the tile.
// Tiles not on the list are left as they are: off-band cells are frozen in
// every buffer, which is what makes that correct. The per-node stage is
// K1's own, so the two cannot drift: lsm::stage_value (weno5.cuh) for the
// advection-only stage, lsm::stage_value_terms (hamiltonians.cuh) for any
// term list, whose streamed coefficients are tile-packed like the velocity.
// K6'' (the TPU kernel's "analytic" branch, band_pallas.py:537-545): a
// coefficient program is evaluated at each node's own coordinates
// (csrc/coef_program.cuh), computed from the tile id and the node's place in
// the tile, so nothing is tile-packed or kept per slot for it.
//
// Layout: P, aux and out are padded (n0+6, n1+6, n2+6) buffers; `band` is
// the interior-shaped uint8 combined mask (0 outside, 1 compute band only, 2
// active band); the velocity is tile-packed, (capacity, B0, B1, B2), indexed
// by dispatch slot. `ids` holds flat tile ids (row-major over the tile grid
// G0 x G1 x G2) or -1 for an empty slot. Ragged edge tiles are masked.
//
// The 2D entries (lsm_band_stage*_2d_*) take a 2D band on its own padded
// (n0+6, n1+6) layout with (B0, B1) tiles and compute the function of the
// (1, n0, n1) embedding that the TPU kernel ran (lsm_tpu/integrators/
// band_fused.py): the same kernels with kFirst = 1, launched as n0 = 1,
// B0 = 1 over the 2D axes, so the tile ids, the slot packing and the
// embedding's term table and programs carry over unchanged, and the per-node
// stage has axis 0 compiled out (weno5.cuh `stage_value_2d`, hamiltonians.cuh
// kFirst), where every difference of the embedding is exactly zero. There
// are no axis-0 ghost planes to keep, so the gated refresh (K7) and the
// re-tube (K8) see only the band's two real axes.
//
// Design: one block per dispatch slot (grid = capacity); an empty slot
// exits at once. Threads walk the tile's nodes with the contiguous axis
// fastest, so a warp reads and writes neighbouring elements; stencils come
// from device memory through L1/L2, as in K1. Bound: per dispatched node,
// phi's centre and the mask byte read and the output written; on the
// compute band only, the 3 velocity components (and aux on later RK stages)
// read. Shared-memory tiles and fewer launches per stage are later work.

#include <cuda_runtime.h>

#include "coef_program.cuh"
#include "hamiltonians.cuh"
#include "lsm_kernels.h"
#include "weno5.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int kFirst>
__global__ void __launch_bounds__(kThreads)
    band_stage_kernel(const T* __restrict__ P, const T* __restrict__ u0,
                      const T* __restrict__ u1, const T* __restrict__ u2,
                      const T* __restrict__ aux, T* __restrict__ out,
                      const uint8_t* __restrict__ band, const int32_t* __restrict__ ids,
                      int64_t n0, int64_t n1, int64_t n2, int B0, int B1, int B2, int G1,
                      int G2, T inv_h0, T inv_h1, T inv_h2, T alpha, T beta, T gamma) {
  const int32_t tid = ids[blockIdx.x];
  if (tid < 0) return;
  const int64_t ti = tid / (G1 * G2);
  const int64_t tj = (tid / G2) % G1;
  const int64_t tk = tid % G2;
  const int64_t s1 = n2 + 2 * LSM_GHOST;
  const int64_t s0 = kFirst == 0 ? (n1 + 2 * LSM_GHOST) * s1 : 0;  // 2D: no axis 0
  const int tile = B0 * B1 * B2;
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * tile;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int c2 = e % B2;
    const int r = e / B2;
    const int c1 = r % B1;
    const int c0 = r / B1;
    const int64_t i = ti * B0 + c0;
    const int64_t j = tj * B1 + c1;
    const int64_t k = tk * B2 + c2;
    if (i >= n0 || j >= n1 || k >= n2) continue;
    const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
    const int64_t q = (i * n1 + j) * n2 + k;
    T v;
    if (band[q] != 0) {
      const int64_t p = slot + e;
      if constexpr (kFirst == 0) {
        v = lsm::stage_value(P, aux, c, s0, s1, u0[p], u1[p], u2[p], inv_h0, inv_h1, inv_h2,
                             alpha, beta, gamma);
      } else {
        v = lsm::stage_value_2d(P, aux, c, s1, u1[p], u2[p], inv_h1, inv_h2, alpha, beta,
                                gamma);
      }
    } else {
      v = P[c];
    }
    out[c] = v;
  }
}

// kFirst = 1: a 2D band as n0 = 1, B0 = 1 (u0 and inv_h0 not read).
template <typename T, int kFirst = 0>
int launch_band_stage(const void* P, const void* u0, const void* u1, const void* u2,
                      const void* aux, void* out, const void* band, const void* ids,
                      int64_t capacity, int64_t n0, int64_t n1, int64_t n2, int64_t B0,
                      int64_t B1, int64_t B2, double inv_h0, double inv_h1, double inv_h2,
                      double alpha, double beta, double gamma, void* stream) {
  if (capacity <= 0) return 0;
  const int G1 = static_cast<int>((n1 + B1 - 1) / B1);
  const int G2 = static_cast<int>((n2 + B2 - 1) / B2);
  band_stage_kernel<T, kFirst><<<static_cast<unsigned>(capacity), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(u0), static_cast<const T*>(u1),
      static_cast<const T*>(u2), static_cast<const T*>(aux), static_cast<T*>(out),
      static_cast<const uint8_t*>(band), static_cast<const int32_t*>(ids), n0, n1, n2,
      static_cast<int>(B0), static_cast<int>(B1), static_cast<int>(B2), G1, G2, T(inv_h0),
      T(inv_h1), T(inv_h2), T(alpha), T(beta), T(gamma));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kAdvection, bool kProgram, int kFirst>
__global__ void __launch_bounds__(kThreads)
    band_stage_terms_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                            T* __restrict__ out, const uint8_t* __restrict__ band,
                            const int32_t* __restrict__ ids, int64_t n0, int64_t n1, int64_t n2,
                            int B0, int B1, int B2, int G1, int G2,
                            const __grid_constant__ LsmStageTerms terms) {
  const int32_t tid = ids[blockIdx.x];
  if (tid < 0) return;
  const int64_t ti = tid / (G1 * G2);
  const int64_t tj = (tid / G2) % G1;
  const int64_t tk = tid % G2;
  const int64_t s1 = n2 + 2 * LSM_GHOST;
  const int64_t s0 = kFirst == 0 ? (n1 + 2 * LSM_GHOST) * s1 : 0;  // 2D: no axis 0
  const int tile = B0 * B1 * B2;
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * tile;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int c2 = e % B2;
    const int r = e / B2;
    const int c1 = r % B1;
    const int c0 = r / B1;
    const int64_t i = ti * B0 + c0;
    const int64_t j = tj * B1 + c1;
    const int64_t k = tk * B2 + c2;
    if (i >= n0 || j >= n1 || k >= n2) continue;
    const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
    const int64_t q = (i * n1 + j) * n2 + k;
    out[c] = band[q] != 0 ? lsm::stage_value_terms<T, kAdvection, kProgram, kFirst>(
                                lsm::DeviceNbr<T>{P, c, s0, s1}, aux, c, slot + e, i, j, k,
                                terms)
                          : P[c];
  }
}

template <typename T, int kFirst = 0>
int launch_band_stage_terms(const void* P, const void* aux, void* out, const void* band,
                            const void* ids, int64_t capacity, int64_t n0, int64_t n1, int64_t n2,
                            int64_t B0, int64_t B1, int64_t B2, const LsmStageTerms* terms,
                            void* stream) {
  if (terms->n < 1 || terms->n > LSM_MAX_TERMS) return static_cast<int>(cudaErrorInvalidValue);
  if (capacity <= 0) return 0;
  const int G1 = static_cast<int>((n1 + B1 - 1) / B1);
  const int G2 = static_cast<int>((n2 + B2 - 1) / B2);
  const bool adv = lsm::has_advection(*terms), prog = lsm::has_program(*terms);
  const auto kernel = adv ? (prog ? band_stage_terms_kernel<T, true, true, kFirst>
                                  : band_stage_terms_kernel<T, true, false, kFirst>)
                          : (prog ? band_stage_terms_kernel<T, false, true, kFirst>
                                  : band_stage_terms_kernel<T, false, false, kFirst>);
  kernel<<<static_cast<unsigned>(capacity), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(aux), static_cast<T*>(out),
      static_cast<const uint8_t*>(band), static_cast<const int32_t*>(ids), n0, n1, n2,
      static_cast<int>(B0), static_cast<int>(B1), static_cast<int>(B2), G1, G2, *terms);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kFirst>
__global__ void __launch_bounds__(kThreads)
    band_stage_prog_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                           T* __restrict__ out, const uint8_t* __restrict__ band,
                           const int32_t* __restrict__ ids, int64_t n0, int64_t n1, int64_t n2,
                           int B0, int B1, int B2, int G1, int G2, lsm::StageConsts<T> sc,
                           const __grid_constant__ LsmStageTerms terms) {
  const int32_t tid = ids[blockIdx.x];
  if (tid < 0) return;
  const int64_t ti = tid / (G1 * G2);
  const int64_t tj = (tid / G2) % G1;
  const int64_t tk = tid % G2;
  const int64_t s1 = n2 + 2 * LSM_GHOST;
  const int64_t s0 = kFirst == 0 ? (n1 + 2 * LSM_GHOST) * s1 : 0;  // 2D: no axis 0
  const int tile = B0 * B1 * B2;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int c2 = e % B2;
    const int r = e / B2;
    const int c1 = r % B1;
    const int c0 = r / B1;
    const int64_t i = ti * B0 + c0;
    const int64_t j = tj * B1 + c1;
    const int64_t k = tk * B2 + c2;
    if (i >= n0 || j >= n1 || k >= n2) continue;
    const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
    const int64_t q = (i * n1 + j) * n2 + k;
    T v;
    if (band[q] != 0) {
      if constexpr (kFirst == 0) {
        const T u0 = lsm::prog_value<T>(terms.prog, 0, 0, i, j, k);
        const T u1 = lsm::prog_value<T>(terms.prog, 0, 1, i, j, k);
        const T u2 = lsm::prog_value<T>(terms.prog, 0, 2, i, j, k);
        v = lsm::stage_value(P, aux, c, s0, s1, u0, u1, u2, sc.inv_h0, sc.inv_h1, sc.inv_h2,
                             sc.alpha, sc.beta, sc.gamma);
      } else {  // the embedding's node (0, j, k); its velocity component 0 is zero
        const T u1 = lsm::prog_value<T>(terms.prog, 0, 1, i, j, k);
        const T u2 = lsm::prog_value<T>(terms.prog, 0, 2, i, j, k);
        v = lsm::stage_value_2d(P, aux, c, s1, u1, u2, sc.inv_h1, sc.inv_h2, sc.alpha, sc.beta,
                                sc.gamma);
      }
    } else {
      v = P[c];
    }
    out[c] = v;
  }
}

template <typename T, int kFirst = 0>
int launch_band_stage_prog(const void* P, const void* aux, void* out, const void* band,
                           const void* ids, int64_t capacity, int64_t n0, int64_t n1, int64_t n2,
                           int64_t B0, int64_t B1, int64_t B2, const LsmStageTerms* terms,
                           void* stream) {
  if (terms->n != 1 || terms->coef[0] != LSM_COEF_PROGRAM)
    return static_cast<int>(cudaErrorInvalidValue);
  if (capacity <= 0) return 0;
  const int G1 = static_cast<int>((n1 + B1 - 1) / B1);
  const int G2 = static_cast<int>((n2 + B2 - 1) / B2);
  band_stage_prog_kernel<T, kFirst><<<static_cast<unsigned>(capacity), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(aux), static_cast<T*>(out),
      static_cast<const uint8_t*>(band), static_cast<const int32_t*>(ids), n0, n1, n2,
      static_cast<int>(B0), static_cast<int>(B1), static_cast<int>(B2), G1, G2,
      lsm::StageConsts<T>::of(*terms), *terms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_band_stage_prog_f32(const void* P, const void* aux, void* out,
                                       const void* band, const void* ids, int64_t capacity,
                                       int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                                       int64_t B2, const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_prog<float>(P, aux, out, band, ids, capacity, n0, n1, n2, B0, B1, B2,
                                       terms, stream);
}

extern "C" int lsm_band_stage_prog_f64(const void* P, const void* aux, void* out,
                                       const void* band, const void* ids, int64_t capacity,
                                       int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                                       int64_t B2, const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_prog<double>(P, aux, out, band, ids, capacity, n0, n1, n2, B0, B1,
                                        B2, terms, stream);
}

extern "C" int lsm_band_stage_terms_f32(const void* P, const void* aux, void* out,
                                        const void* band, const void* ids, int64_t capacity,
                                        int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                                        int64_t B2, const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_terms<float>(P, aux, out, band, ids, capacity, n0, n1, n2, B0, B1, B2,
                                        terms, stream);
}

extern "C" int lsm_band_stage_terms_f64(const void* P, const void* aux, void* out,
                                        const void* band, const void* ids, int64_t capacity,
                                        int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                                        int64_t B2, const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_terms<double>(P, aux, out, band, ids, capacity, n0, n1, n2, B0, B1,
                                         B2, terms, stream);
}

extern "C" int lsm_band_stage_f32(const void* P, const void* u0, const void* u1,
                                  const void* u2, const void* aux, void* out, const void* band,
                                  const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                                  int64_t n2, int64_t B0, int64_t B1, int64_t B2, double inv_h0,
                                  double inv_h1, double inv_h2, double alpha, double beta,
                                  double gamma, void* stream) {
  return launch_band_stage<float>(P, u0, u1, u2, aux, out, band, ids, capacity, n0, n1, n2, B0,
                                  B1, B2, inv_h0, inv_h1, inv_h2, alpha, beta, gamma, stream);
}

extern "C" int lsm_band_stage_f64(const void* P, const void* u0, const void* u1,
                                  const void* u2, const void* aux, void* out, const void* band,
                                  const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                                  int64_t n2, int64_t B0, int64_t B1, int64_t B2, double inv_h0,
                                  double inv_h1, double inv_h2, double alpha, double beta,
                                  double gamma, void* stream) {
  return launch_band_stage<double>(P, u0, u1, u2, aux, out, band, ids, capacity, n0, n1, n2, B0,
                                   B1, B2, inv_h0, inv_h1, inv_h2, alpha, beta, gamma, stream);
}

// The 2D entries: a 2D band (n0, n1) with tiles (B0, B1) runs the kernels
// above with kFirst = 1 as the (1, n0, n1) band of (1, B0, B1) tiles.

extern "C" int lsm_band_stage_2d_f32(const void* P, const void* u0, const void* u1,
                                     const void* aux, void* out, const void* band,
                                     const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                                     int64_t B0, int64_t B1, double inv_h0, double inv_h1,
                                     double alpha, double beta, double gamma, void* stream) {
  return launch_band_stage<float, 1>(P, nullptr, u0, u1, aux, out, band, ids, capacity, 1, n0,
                                     n1, 1, B0, B1, 1.0, inv_h0, inv_h1, alpha, beta, gamma,
                                     stream);
}

extern "C" int lsm_band_stage_2d_f64(const void* P, const void* u0, const void* u1,
                                     const void* aux, void* out, const void* band,
                                     const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                                     int64_t B0, int64_t B1, double inv_h0, double inv_h1,
                                     double alpha, double beta, double gamma, void* stream) {
  return launch_band_stage<double, 1>(P, nullptr, u0, u1, aux, out, band, ids, capacity, 1, n0,
                                      n1, 1, B0, B1, 1.0, inv_h0, inv_h1, alpha, beta, gamma,
                                      stream);
}

extern "C" int lsm_band_stage_terms_2d_f32(const void* P, const void* aux, void* out,
                                           const void* band, const void* ids, int64_t capacity,
                                           int64_t n0, int64_t n1, int64_t B0, int64_t B1,
                                           const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_terms<float, 1>(P, aux, out, band, ids, capacity, 1, n0, n1, 1, B0,
                                           B1, terms, stream);
}

extern "C" int lsm_band_stage_terms_2d_f64(const void* P, const void* aux, void* out,
                                           const void* band, const void* ids, int64_t capacity,
                                           int64_t n0, int64_t n1, int64_t B0, int64_t B1,
                                           const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_terms<double, 1>(P, aux, out, band, ids, capacity, 1, n0, n1, 1, B0,
                                            B1, terms, stream);
}

extern "C" int lsm_band_stage_prog_2d_f32(const void* P, const void* aux, void* out,
                                          const void* band, const void* ids, int64_t capacity,
                                          int64_t n0, int64_t n1, int64_t B0, int64_t B1,
                                          const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_prog<float, 1>(P, aux, out, band, ids, capacity, 1, n0, n1, 1, B0,
                                          B1, terms, stream);
}

extern "C" int lsm_band_stage_prog_2d_f64(const void* P, const void* aux, void* out,
                                          const void* band, const void* ids, int64_t capacity,
                                          int64_t n0, int64_t n1, int64_t B0, int64_t B1,
                                          const LsmStageTerms* terms, void* stream) {
  return launch_band_stage_prog<double, 1>(P, aux, out, band, ids, capacity, 1, n0, n1, 1, B0,
                                           B1, terms, stream);
}
