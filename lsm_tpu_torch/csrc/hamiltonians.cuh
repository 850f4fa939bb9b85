// Per-node Hamiltonians of the four term kinds and their sum over a term
// table, shared by K1 (weno_stage.cu) and K6 (band_stage.cu) so that the
// dense and the band stage cannot drift apart.
//
// Arithmetic follows the plain versions term by term (lsm_tpu/ops/stencils.py
// `eno2_onesided` / `godunov_norms`, lsm_tpu/geometry/queries.py
// `curvature_from_padded`, lsm_tpu/ops/weno_v2.py `_ham_contribution`), with
// the same association order. Where the plain version divides by a spacing
// constant (h, 2h, h*h, 4*h_i*h_j) the kernel multiplies by its reciprocal,
// formed in double on the host, and |grad|^3 is |grad|^2 * sqrt(|grad|^2)
// rather than a pow: those, and FMA contraction, round differently by an
// ulp or so.
// Tie rules that decide a branch match exactly:
// - minmod is zero unless the product x*y > 0 (a product that underflows to 0
//   is a sign change) and picks x when |x| <= |y|;
// - normal motion is max(v,0)*|grad+| + min(v,0)*|grad-|;
// - the eikonal sign picks |grad+| where sign > 0 (phi == 0 takes |grad-|),
//   and the recomputed sign is 0 where its denominator is 0;
// - the curvature is 0 where |grad|^2 < the dtype's epsilon;
// - safe_sqrt(0) = 0.
//
// Each function takes the padded buffer P, the centre index c and the
// strides (s0, s1, 1); every stencil value is loaded from device memory and
// the reuse between neighbouring nodes is left to L1/L2.
//
// kFirst is the first axis of the stencil: 0 for the 3D kernels, 1 for K6's
// 2D entry, which runs the 3D function of the (1, n0, n1) embedding on a
// (n0+6, n1+6) buffer with axis 0 compiled out (s0 is not read). Along that
// axis every difference of the embedding is exactly zero (its ghosts are
// copies of its one node), so each skipped term is an exact zero and the sums
// keep the 3D order of the other terms.
#ifndef LSM_HAMILTONIANS_CUH
#define LSM_HAMILTONIANS_CUH

#include <stdint.h>

#include "coef_program.cuh"
#include "lsm_kernels.h"
#include "weno5.cuh"

namespace lsm {

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static __device__ __forceinline__ float value() { return 1.1920928955078125e-07f; }
};
template <>
struct Eps<double> {
  static __device__ __forceinline__ double value() { return 2.220446049250313e-16; }
};

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T min2(T a, T b) {
  return a < b ? a : b;
}

template <typename T>
__device__ __forceinline__ T safe_sqrt(T x) {
  return x > T(0) ? sqrt_(x) : T(0);
}

template <typename T>
__device__ __forceinline__ T minmod(T x, T y) {
  const T pick = abs_(x) <= abs_(y) ? x : y;
  return x * y > T(0) ? pick : T(0);
}

// Second-order ENO one-sided derivatives (A, B) along the axis of stride s:
// A = D- + h/2 minmod(D2--, D2_0), B = D+ - h/2 minmod(D2++, D2_0).
template <typename T>
__device__ __forceinline__ void eno2(const T* __restrict__ P, int64_t c, int64_t s, T inv_h,
                                     T half_h, T inv_hh, T& A, T& B) {
  const T m2 = P[c - 2 * s];
  const T m1 = P[c - s];
  const T c0 = P[c];
  const T p1 = P[c + s];
  const T p2 = P[c + 2 * s];
  const T d2c = (p1 - T(2) * c0 + m1) * inv_hh;
  const T d2mm = (m2 - T(2) * m1 + c0) * inv_hh;
  const T d2pp = (c0 - T(2) * p1 + p2) * inv_hh;
  A = (c0 - m1) * inv_h + half_h * minmod(d2mm, d2c);
  B = (p1 - c0) * inv_h - half_h * minmod(d2pp, d2c);
}

// Godunov upwind gradient magnitudes (|grad+|, |grad-|) from ENO2.
template <typename T, int kFirst = 0>
__device__ __forceinline__ void godunov(const T* __restrict__ P, int64_t c, int64_t s0,
                                        int64_t s1, const LsmStageTerms& p, T& gp, T& gm) {
  const int64_t stride[3] = {s0, s1, 1};
  T gp2 = T(0);
  T gm2 = T(0);
#pragma unroll
  for (int d = kFirst; d < 3; ++d) {
    T A, B;
    eno2(P, c, stride[d], T(p.inv_h[d]), T(p.half_h[d]), T(p.inv_hh[d]), A, B);
    const T ap = max2(A, T(0));
    const T an = min2(A, T(0));
    const T bp = max2(B, T(0));
    const T bn = min2(B, T(0));
    gp2 = gp2 + ap * ap + bn * bn;
    gm2 = gm2 + an * an + bp * bp;
  }
  gp = safe_sqrt(gp2);
  gm = safe_sqrt(gm2);
}

// b * kappa * |grad phi| with central differences: 3 first, 3 second and 3
// mixed (the 4 edge neighbours of each axis pair) differences.
template <typename T, int kFirst = 0>
__device__ __forceinline__ T curvature_term(const T* __restrict__ P, int64_t c, int64_t s0,
                                            int64_t s1, const LsmStageTerms& p, T b) {
  const int64_t st[3] = {s0, s1, 1};
  const T c0 = P[c];
  T g[3], hd[3];
#pragma unroll
  for (int d = kFirst; d < 3; ++d) {
    const T plus = P[c + st[d]];
    const T minus = P[c - st[d]];
    g[d] = (plus - minus) * T(p.inv_two_h[d]);
    hd[d] = (plus - T(2) * c0 + minus) * T(p.inv_hh[d]);
  }
  T nrmsq, lap, quad;
  if constexpr (kFirst == 1) {  // the 3D sums without their axis-0 terms
    const T hm12 = (P[c + s1 + 1] - P[c + s1 - 1] - P[c - s1 + 1] + P[c - s1 - 1]) *
                   T(p.inv_hmix[2]);
    nrmsq = g[1] * g[1] + g[2] * g[2];
    lap = hd[1] + hd[2];
    quad = g[1] * g[1] * hd[1];
    quad = quad + T(2) * g[1] * g[2] * hm12;
    quad = quad + g[2] * g[2] * hd[2];
  } else {
    T hm[3];  // (0,1), (0,2), (1,2)
    const int pair[3][2] = {{0, 1}, {0, 2}, {1, 2}};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int64_t a = st[pair[k][0]];
      const int64_t b2 = st[pair[k][1]];
      hm[k] = (P[c + a + b2] - P[c + a - b2] - P[c - a + b2] + P[c - a - b2]) * T(p.inv_hmix[k]);
    }
    nrmsq = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
    lap = hd[0] + hd[1] + hd[2];
    quad = g[0] * g[0] * hd[0];
    quad = quad + T(2) * g[0] * g[1] * hm[0];
    quad = quad + T(2) * g[0] * g[2] * hm[1];
    quad = quad + g[1] * g[1] * hd[1];
    quad = quad + T(2) * g[1] * g[2] * hm[2];
    quad = quad + g[2] * g[2] * hd[2];
  }
  const bool safe = nrmsq >= Eps<T>::value();
  const T ns = safe ? nrmsq : T(1);
  const T kappa = safe ? (lap * ns - quad) / (ns * sqrt_(ns)) : T(0);
  return b * kappa * safe_sqrt(nrmsq);
}

// s * (|grad| - 1) with the sign s frozen (s = s0: streamed or a program)
// or recomputed from phi with gradient-aware smoothing (LSM_COEF_NONE).
template <typename T, int kFirst = 0>
__device__ __forceinline__ T eikonal_term(const T* __restrict__ P, int64_t c, int64_t s0,
                                          int64_t s1, const LsmStageTerms& p, int coef,
                                          T s_frozen) {
  T gp, gm;
  godunov<T, kFirst>(P, c, s0, s1, p, gp, gm);
  T s, norm;
  if (coef == LSM_COEF_NONE) {
    const T center = P[c];
    const T dx = T(p.dx_min);
    norm = center > T(0) ? gp : gm;
    const T denom = sqrt_(center * center + norm * norm * dx * dx);
    s = denom == T(0) ? T(0) : center / denom;
  } else {
    s = s_frozen;
    norm = s > T(0) ? gp : gm;
  }
  return s * (norm - T(1));
}

// Whether the table holds an advection term (host side: picks the kernel).
inline bool has_advection(const LsmStageTerms& p) {
  for (int e = 0; e < p.n; ++e) {
    if (p.kind[e] == LSM_TERM_ADVECTION) return true;
  }
  return false;
}

// Whether the table holds a program coefficient (host side: picks the kernel).
inline bool has_program(const LsmStageTerms& p) {
  for (int e = 0; e < p.n; ++e) {
    if (p.coef[e] == LSM_COEF_PROGRAM) return true;
  }
  return false;
}

// One RK stage at the padded index c over the term table p:
// alpha*aux[c] + beta*P[c] - gamma*sum_e H_e, the alpha term dropped when
// aux is null. q indexes the streams (the interior index for K1, the slot
// position for K6); a program coefficient is evaluated at the node's
// interior index (i0, i1, i2) (K1'', K6''). The loop and its branches are
// uniform across a block.
// kAdvection compiles the WENO5 advection branch in; a table without an
// advection term takes the instantiation without it, whose registers are not
// sized for WENO5 (more threads resident per SM). kProgram likewise compiles
// the program interpreter in only for tables that hold a program. kFirst = 1
// is the 2D entry (see the top of this file): i0 is then 0, the embedding's
// node, and an advection term's component 0, the embedding's zero velocity,
// is not read.
template <typename T, bool kAdvection, bool kProgram, int kFirst = 0>
__device__ __forceinline__ T stage_value_terms(const T* __restrict__ P,
                                               const T* __restrict__ aux, int64_t c, int64_t s0,
                                               int64_t s1, int64_t q, int64_t i0, int64_t i1,
                                               int64_t i2, const LsmStageTerms& p) {
  T ham = T(0);
  for (int e = 0; e < p.n; ++e) {
    const int kind = p.kind[e];
    const int coef = p.coef[e];
    const bool dummy = kFirst == 1 && kind == LSM_TERM_ADVECTION;  // u0 of the embedding
    T v = T(0);  // the scalar coefficient of a normal, curvature or eikonal term
    if (coef == LSM_COEF_STREAM) {
      if (!dummy) v = static_cast<const T*>(p.stream[e][0])[q];
    } else if (coef == LSM_COEF_CONST) {
      v = T(p.value[e]);
    } else if (kProgram && coef == LSM_COEF_PROGRAM && !dummy) {
      v = prog_value<T>(p.prog, e, 0, i0, i1, i2);
    }
    T h;
    if (kAdvection && kind == LSM_TERM_ADVECTION) {
      const bool prog = kProgram && coef == LSM_COEF_PROGRAM;
      const T u1 = prog ? prog_value<T>(p.prog, e, 1, i0, i1, i2)
                        : static_cast<const T*>(p.stream[e][1])[q];
      const T u2 = prog ? prog_value<T>(p.prog, e, 2, i0, i1, i2)
                        : static_cast<const T*>(p.stream[e][2])[q];
      if constexpr (kFirst == 0) {
        h = axis_term(P, c, s0, T(p.inv_h[0]), v);
        h = h + axis_term(P, c, s1, T(p.inv_h[1]), u1);
      } else {
        h = axis_term(P, c, s1, T(p.inv_h[1]), u1);
      }
      h = h + axis_term(P, c, int64_t(1), T(p.inv_h[2]), u2);
    } else if (kind == LSM_TERM_NORMAL) {
      T gp, gm;
      godunov<T, kFirst>(P, c, s0, s1, p, gp, gm);
      h = max2(v, T(0)) * gp + min2(v, T(0)) * gm;
    } else if (kind == LSM_TERM_CURVATURE) {
      h = curvature_term<T, kFirst>(P, c, s0, s1, p, v);
    } else {
      h = eikonal_term<T, kFirst>(P, c, s0, s1, p, coef, v);
    }
    ham = ham + h;
  }
  T res = T(p.beta) * P[c] - T(p.gamma) * ham;
  if (aux != nullptr) res = T(p.alpha) * aux[c] + res;
  return res;
}

}  // namespace lsm

#endif  // LSM_HAMILTONIANS_CUH
