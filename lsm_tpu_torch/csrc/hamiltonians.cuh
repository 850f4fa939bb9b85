// Per-node Hamiltonians of the four term kinds and their sum over a term
// table, shared by K1' (weno_stage.cu) and K6' (band_stage.cu) so that the
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
// Each function reads phi through a neighbourhood accessor n:
// n.at(d, m) is the sample m nodes along axis d from the centre (m = 0 the
// centre), n.corner(k, sa, sb) the sample sa nodes along the first axis of
// the pair k ((0,1), (0,2), (1,2)) and sb along its second (sa, sb = +-1).
// DeviceNbr reads them from a padded buffer in device memory (K6', and K1''s
// kernel of one thread per node); K1''s march keeps a node's samples in
// registers, loaded once from its shared-memory tile (weno_stage.cu), so the
// two run the same formulas in the same order, with the same IEEE square
// root and division. The second differences along the axes are the ENO2 and
// the curvature stencils' common piece (eno2's D2_0 is the curvature's
// h_dd): every caller forms them, the Godunov norms and the curvature once
// per node for all terms (term_pieces), and each term adds its share
// (term_share).
//
// kFirst is the first axis of the stencil: 0 for the 3D kernels, 1 for the 2D
// entries, which run the 3D function of the (1, n0, n1) embedding with axis
// 0 compiled out (no axis-0 sample is read). Along that axis every
// difference of the embedding is exactly zero (its ghosts are copies of its
// one node), so each skipped term is an exact zero and the sums keep the 3D
// order of the other terms.
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

// sqrt(x) for x > 0, else 0; the square root the constants c take.
template <typename T, typename C>
__device__ __forceinline__ T safe_sqrt(const C& c, T x) {
  return x > T(0) ? c.sqrt(x) : T(0);
}

template <typename T>
__device__ __forceinline__ T minmod(T x, T y) {
  const T pick = abs_(x) <= abs_(y) ? x : y;
  return x * y > T(0) ? pick : T(0);
}

// phi from a padded buffer in device memory, centred at c (strides s0,
// s1, 1; s0 is not read where kFirst = 1).
template <typename T>
struct DeviceNbr {
  const T* __restrict__ P;
  int64_t c, s0, s1;
  __device__ __forceinline__ T at(int d, int m) const {
    return P[c + m * (d == 0 ? s0 : (d == 1 ? s1 : int64_t(1)))];
  }
  __device__ __forceinline__ T corner(int k, int sa, int sb) const {
    return P[c + sa * (k == 2 ? s1 : s0) + sb * (k == 0 ? s1 : int64_t(1))];
  }
};

// The table's spacing constants and coefficients in T, and the square root
// and division the Hamiltonians take (IEEE, as the plain versions').
// TableConsts converts the table's doubles where they are read (K6', K1''s
// kernel of one thread per node); TermConsts holds them converted once on
// the host (the same values) and sits in K1''s march's kernel parameters,
// where a per-node conversion from double would cost more than the node's
// arithmetic.
template <typename T>
struct TableConsts {
  const LsmStageTerms& p;
  __device__ __forceinline__ T inv_h(int d) const { return T(p.inv_h[d]); }
  __device__ __forceinline__ T half_h(int d) const { return T(p.half_h[d]); }
  __device__ __forceinline__ T inv_two_h(int d) const { return T(p.inv_two_h[d]); }
  __device__ __forceinline__ T inv_hh(int d) const { return T(p.inv_hh[d]); }
  __device__ __forceinline__ T inv_hmix(int k) const { return T(p.inv_hmix[k]); }
  __device__ __forceinline__ T dx_min() const { return T(p.dx_min); }
  __device__ __forceinline__ T alpha() const { return T(p.alpha); }
  __device__ __forceinline__ T beta() const { return T(p.beta); }
  __device__ __forceinline__ T gamma() const { return T(p.gamma); }
  __device__ __forceinline__ T value(int e) const { return T(p.value[e]); }
  __device__ __forceinline__ T sqrt(T x) const { return sqrt_(x); }
  __device__ __forceinline__ T div(T a, T b) const { return a / b; }
};

template <typename T>
struct TermConsts {
  T inv_h_[3], half_h_[3], inv_two_h_[3], inv_hh_[3], inv_hmix_[3];
  T dx_min_, alpha_, beta_, gamma_;
  T value_[LSM_MAX_TERMS];
  static TermConsts of(const LsmStageTerms& p) {  // host side
    TermConsts c{};
    for (int d = 0; d < 3; ++d) {
      c.inv_h_[d] = T(p.inv_h[d]);
      c.half_h_[d] = T(p.half_h[d]);
      c.inv_two_h_[d] = T(p.inv_two_h[d]);
      c.inv_hh_[d] = T(p.inv_hh[d]);
      c.inv_hmix_[d] = T(p.inv_hmix[d]);
    }
    c.dx_min_ = T(p.dx_min);
    c.alpha_ = T(p.alpha);
    c.beta_ = T(p.beta);
    c.gamma_ = T(p.gamma);
    for (int e = 0; e < LSM_MAX_TERMS; ++e) c.value_[e] = T(p.value[e]);
    return c;
  }
  __device__ __forceinline__ T inv_h(int d) const { return inv_h_[d]; }
  __device__ __forceinline__ T half_h(int d) const { return half_h_[d]; }
  __device__ __forceinline__ T inv_two_h(int d) const { return inv_two_h_[d]; }
  __device__ __forceinline__ T inv_hh(int d) const { return inv_hh_[d]; }
  __device__ __forceinline__ T inv_hmix(int k) const { return inv_hmix_[k]; }
  __device__ __forceinline__ T dx_min() const { return dx_min_; }
  __device__ __forceinline__ T alpha() const { return alpha_; }
  __device__ __forceinline__ T beta() const { return beta_; }
  __device__ __forceinline__ T gamma() const { return gamma_; }
  __device__ __forceinline__ T value(int e) const { return value_[e]; }
  __device__ __forceinline__ T sqrt(T x) const { return sqrt_(x); }
  __device__ __forceinline__ T div(T a, T b) const { return a / b; }
};

// A node's streamed coefficients in device memory: component d of term e
// at the stream index q (K6': the slot position; K1': the interior index).
template <typename T>
struct DeviceStreams {
  const LsmStageTerms& p;
  int64_t q;
  __device__ __forceinline__ T operator()(int e, int d) const {
    return static_cast<const T*>(p.stream[e][d])[q];
  }
};

// The centred second differences along the axes: (phi+ - 2 phi + phi-) / h^2.
template <typename T, int kFirst, typename N, typename C>
__device__ __forceinline__ void second_diffs(const N& n, const C& c, T (&hd)[3]) {
#pragma unroll
  for (int d = kFirst; d < 3; ++d)
    hd[d] = (n.at(d, 1) - T(2) * n.at(d, 0) + n.at(d, -1)) * c.inv_hh(d);
}

// Second-order ENO one-sided derivatives (A, B) along axis d, d2c its
// second difference: A = D- + h/2 minmod(D2--, D2_0), B = D+ - h/2
// minmod(D2++, D2_0).
template <typename T, typename N>
__device__ __forceinline__ void eno2(const N& n, int d, T inv_h, T half_h, T inv_hh, T d2c,
                                     T& A, T& B) {
  const T m2 = n.at(d, -2);
  const T m1 = n.at(d, -1);
  const T c0 = n.at(d, 0);
  const T p1 = n.at(d, 1);
  const T p2 = n.at(d, 2);
  const T d2mm = (m2 - T(2) * m1 + c0) * inv_hh;
  const T d2pp = (c0 - T(2) * p1 + p2) * inv_hh;
  A = (c0 - m1) * inv_h + half_h * minmod(d2mm, d2c);
  B = (p1 - c0) * inv_h - half_h * minmod(d2pp, d2c);
}

// Godunov upwind gradient magnitudes (|grad+|, |grad-|) from ENO2; hd the
// second differences (second_diffs).
template <typename T, int kFirst, typename N, typename C>
__device__ __forceinline__ void godunov(const N& n, const C& c, const T (&hd)[3], T& gp, T& gm) {
  T gp2 = T(0);
  T gm2 = T(0);
#pragma unroll
  for (int d = kFirst; d < 3; ++d) {
    T A, B;
    eno2(n, d, c.inv_h(d), c.half_h(d), c.inv_hh(d), hd[d], A, B);
    const T ap = max2(A, T(0));
    const T an = min2(A, T(0));
    const T bp = max2(B, T(0));
    const T bn = min2(B, T(0));
    gp2 = gp2 + ap * ap + bn * bn;
    gm2 = gm2 + an * an + bp * bp;
  }
  gp = safe_sqrt(c, gp2);
  gm = safe_sqrt(c, gm2);
}

// The mean curvature kappa and |grad phi| (norm) with central differences:
// 3 first, 3 second (hd) and 3 mixed (the 4 edge neighbours of each axis
// pair) differences. A curvature term is b * kappa * norm.
template <typename T, int kFirst, typename N, typename C>
__device__ __forceinline__ void curvature(const N& n, const C& c, const T (&hd)[3], T& kappa,
                                          T& norm) {
  T g[3];
#pragma unroll
  for (int d = kFirst; d < 3; ++d) g[d] = (n.at(d, 1) - n.at(d, -1)) * c.inv_two_h(d);
  T hm[3];  // (0,1), (0,2), (1,2)
#pragma unroll
  for (int k = kFirst == 1 ? 2 : 0; k < 3; ++k)
    hm[k] = (n.corner(k, 1, 1) - n.corner(k, 1, -1) - n.corner(k, -1, 1) + n.corner(k, -1, -1)) *
            c.inv_hmix(k);
  T nrmsq, lap, quad;
  if constexpr (kFirst == 1) {  // the 3D sums without their axis-0 terms
    nrmsq = g[1] * g[1] + g[2] * g[2];
    lap = hd[1] + hd[2];
    quad = g[1] * g[1] * hd[1];
    quad = quad + T(2) * g[1] * g[2] * hm[2];
    quad = quad + g[2] * g[2] * hd[2];
  } else {
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
  kappa = safe ? c.div(lap * ns - quad, ns * c.sqrt(ns)) : T(0);
  norm = safe_sqrt(c, nrmsq);
}

// Normal motion at speed v: max(v,0)*|grad+| + min(v,0)*|grad-|.
template <typename T>
__device__ __forceinline__ T normal_value(T v, T gp, T gm) {
  return max2(v, T(0)) * gp + min2(v, T(0)) * gm;
}

// s * (|grad| - 1) with the sign s frozen (s = s0: streamed or a program)
// or recomputed from phi (the centre's value) with gradient-aware smoothing
// (LSM_COEF_NONE); dx the smallest spacing.
template <typename T, typename C>
__device__ __forceinline__ T eikonal_value(const C& c, T center, T gp, T gm, int coef,
                                           T s_frozen) {
  T s, norm;
  if (coef == LSM_COEF_NONE) {
    const T dx = c.dx_min();
    norm = center > T(0) ? gp : gm;
    const T denom = c.sqrt(center * center + norm * norm * dx * dx);
    s = denom == T(0) ? T(0) : c.div(center, denom);
  } else {
    s = s_frozen;
    norm = s > T(0) ? gp : gm;
  }
  return s * (norm - T(1));
}

// u * WENO5 along axis d (weno5.cuh axis_term's differences and core).
template <typename T, typename N>
__device__ __forceinline__ T advection_axis(const N& n, int d, T inv_h, T u) {
  T s[7];
#pragma unroll
  for (int m = 0; m < 7; ++m) s[m] = n.at(d, m - 3);
  T dm[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) dm[m] = (s[m + 1] - s[m]) * inv_h;
  return weno5_upwind(dm, u);
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

// The pieces a table's terms share, as bits: the Godunov norms (a normal or
// eikonal term), the curvature, the eikonal term with its sign recomputed.
enum { kGodunov = 1, kCurvature = 2, kEikonalNone = 4 };

// Which pieces the table p needs (uniform across a launch).
__device__ __forceinline__ int pieces_of(const LsmStageTerms& p) {
  int f = 0;
  for (int e = 0; e < p.n; ++e) {
    const int kind = p.kind[e];
    if (kind == LSM_TERM_NORMAL || kind == LSM_TERM_EIKONAL) f |= kGodunov;
    if (kind == LSM_TERM_CURVATURE) f |= kCurvature;
    if (kind == LSM_TERM_EIKONAL && p.coef[e] == LSM_COEF_NONE) f |= kEikonalNone;
  }
  return f;
}

// The pieces of a node formed once for all its terms (pieces_of says
// which): the centre, the Godunov norms, the curvature and
// |grad phi|, the eikonal term with its sign recomputed (it takes no
// coefficient).
template <typename T>
struct Pieces {
  T center, gp, gm, kappa, knorm, eik_none;
};

template <typename T, int kFirst, typename N, typename C>
__device__ __forceinline__ Pieces<T> term_pieces(const N& n, const C& c, int pieces) {
  Pieces<T> q{n.at(0, 0), T(0), T(0), T(0), T(0), T(0)};
  T hd[3] = {};
  if (pieces & (kGodunov | kCurvature)) second_diffs<T, kFirst>(n, c, hd);
  if (pieces & kGodunov) godunov<T, kFirst>(n, c, hd, q.gp, q.gm);
  if (pieces & kCurvature) curvature<T, kFirst>(n, c, hd, q.kappa, q.knorm);
  if (pieces & kEikonalNone)
    q.eik_none = eikonal_value(c, q.center, q.gp, q.gm, LSM_COEF_NONE, T(0));
  return q;
}

// A normal, curvature or eikonal term's Hamiltonian from the node's pieces,
// v its coefficient: selects, no branch.
template <typename T, typename C>
__device__ __forceinline__ T term_share(const C& c, const Pieces<T>& q, int kind, int coef, T v) {
  const T frozen = eikonal_value(c, q.center, q.gp, q.gm, LSM_COEF_STREAM, v);
  return kind == LSM_TERM_NORMAL      ? normal_value(v, q.gp, q.gm)
         : kind == LSM_TERM_CURVATURE ? v * q.kappa * q.knorm
         : coef == LSM_COEF_NONE      ? q.eik_none
                                      : frozen;
}

// Term e's Hamiltonian at the node of n (term_sum's loop body), q the
// node's pieces (term_pieces).
template <typename T, bool kAdvection, bool kProgram, int kFirst, typename N, typename C,
          typename S>
__device__ __forceinline__ T term_value(const N& n, const C& c, const S& s, int64_t i0,
                                        int64_t i1, int64_t i2, const LsmStageTerms& p, int e,
                                        const Pieces<T>& q) {
  const int kind = p.kind[e];
  const int coef = p.coef[e];
  const bool dummy = kFirst == 1 && kind == LSM_TERM_ADVECTION;  // u0 of the embedding
  T v = T(0);  // the scalar coefficient of a normal, curvature or eikonal term
  if (coef == LSM_COEF_STREAM) {
    if (!dummy) v = s(e, 0);
  } else if (coef == LSM_COEF_CONST) {
    v = c.value(e);
  } else if (kProgram && coef == LSM_COEF_PROGRAM && !dummy) {
    v = prog_value<T>(p.prog, e, 0, i0, i1, i2);
  }
  if (kAdvection && kind == LSM_TERM_ADVECTION) {
    const bool prog = kProgram && coef == LSM_COEF_PROGRAM;
    const T u1 = prog ? prog_value<T>(p.prog, e, 1, i0, i1, i2) : s(e, 1);
    const T u2 = prog ? prog_value<T>(p.prog, e, 2, i0, i1, i2) : s(e, 2);
    T h;
    if constexpr (kFirst == 0) {
      h = advection_axis(n, 0, c.inv_h(0), v);
      h = h + advection_axis(n, 1, c.inv_h(1), u1);
    } else {
      h = advection_axis(n, 1, c.inv_h(1), u1);
    }
    return h + advection_axis(n, 2, c.inv_h(2), u2);
  }
  return term_share(c, q, kind, coef, v);
}

// sum_e H_e at the node of the accessor n over the term table p, the
// constants from c (TableConsts, TermConsts), the streamed coefficients from
// s (s(e, d): component d of term e); a program coefficient is evaluated at
// the node's interior index (i0, i1, i2) (K1'', K6''). pieces (pieces_of(p))
// says which pieces the terms share, formed once before the loop. The loop
// and its branches are uniform across a block.
// kAdvection compiles the WENO5 advection branch in; a table without an
// advection term takes the instantiation without it, whose registers are not
// sized for WENO5 (more threads resident per SM). kProgram likewise compiles
// the program interpreter in only for tables that hold a program. kFirst = 1
// is the 2D entry (see the top of this file): i0 is then 0, the embedding's
// node, and an advection term's component 0, the embedding's zero velocity,
// is not read.
template <typename T, bool kAdvection, bool kProgram, int kFirst, typename N, typename C,
          typename S>
__device__ __forceinline__ T term_sum(const N& n, const C& c, const S& s, int64_t i0, int64_t i1,
                                      int64_t i2, const LsmStageTerms& p, int pieces) {
  const Pieces<T> q = term_pieces<T, kFirst>(n, c, pieces);
  T ham = T(0);
  for (int e = 0; e < p.n; ++e)
    ham = ham + term_value<T, kAdvection, kProgram, kFirst>(n, c, s, i0, i1, i2, p, e, q);
  return ham;
}

// One RK stage at the node of n: beta*phi - gamma*ham, then alpha*aux + the
// rest where aux is given (stage_value_terms; K1''s march with its staged aux).
template <typename T, typename C>
__device__ __forceinline__ T stage_combine(const C& c, T center, T ham) {
  return c.beta() * center - c.gamma() * ham;
}
template <typename T, typename C>
__device__ __forceinline__ T stage_with_aux(const C& c, T aux, T res) {
  return c.alpha() * aux + res;
}

// One RK stage at the padded index of the device-memory accessor n over the
// term table p: alpha*aux[a] + beta*P[c] - gamma*sum_e H_e, the alpha term
// dropped when aux is null; q indexes the streams (K6', and K1''s kernel of
// one thread per node).
template <typename T, bool kAdvection, bool kProgram, int kFirst, typename N>
__device__ __forceinline__ T stage_value_terms(const N& n, const T* __restrict__ aux, int64_t a,
                                               int64_t q, int64_t i0, int64_t i1, int64_t i2,
                                               const LsmStageTerms& p) {
  const TableConsts<T> c{p};
  const T ham = term_sum<T, kAdvection, kProgram, kFirst>(n, c, DeviceStreams<T>{p, q}, i0, i1,
                                                          i2, p, pieces_of(p));
  T res = stage_combine(c, n.at(0, 0), ham);
  if (aux != nullptr) res = stage_with_aux(c, aux[a], res);
  return res;
}

}  // namespace lsm

#endif  // LSM_HAMILTONIANS_CUH
