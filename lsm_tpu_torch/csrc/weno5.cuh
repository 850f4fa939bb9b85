// Per-node WENO5 advection stage, shared by K1 (weno_stage.cu), K6
// (band_stage.cu) and the general path's K10/K11 (weno_general.cu) so that
// the stages cannot drift apart. K1's march reads its samples from shared
// memory and registers and forms the same differences itself, then calls
// weno5_upwind.
//
// Arithmetic follows lsm_tpu/ops/stencils.py `weno5_upwind` /
// `_weno_combine` term by term: the five stencil inputs are selected by the
// sign of u (u == 0 takes the plus branch), one Jiang-Shu core runs, and the
// weights use the one-division form, its two reciprocals `weno_recip`.
#ifndef LSM_WENO5_CUH
#define LSM_WENO5_CUH

#include <stdint.h>

namespace lsm {

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

// 1 / x for the weights: in float the hardware's approximate reciprocal and
// one Newton step, as the reference's `_fast_recip` (lsm_tpu/ops/weno_v2.py);
// within about an ulp of the division, without its branches to a slow path.
// In double the IEEE division.
template <typename T>
__device__ __forceinline__ T weno_recip(T x) {
  if constexpr (sizeof(T) == 4) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r * (2.0f - x * r);
  } else {
    return T(1.0) / x;
  }
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
  const T r = weno_recip(eps);
  const T b1 = s1 * r + T(1.0);
  const T b2 = s2 * r + T(1.0);
  const T b3 = s3 * r + T(1.0);
  const T p1 = b2 * b3;
  const T p2 = b1 * b3;
  const T p3 = b1 * b2;
  const T q1 = T(0.1) * (p1 * p1);
  const T q2 = T(0.6) * (p2 * p2);
  const T q3 = T(0.3) * (p3 * p3);
  const T w = weno_recip(q1 + q2 + q3);
  return u * ((q1 * d1 + q2 * d2 + q3 * d3) * w);
}

// u * WENO5 along the axis with element stride `stride`, centred at `c`
// (I: the index type; K6 indexes its tile in shared memory with int).
template <typename T, typename I = int64_t>
__device__ __forceinline__ T axis_term(const T* __restrict__ P, I c, I stride, T inv_h, T u) {
  T s[7];
#pragma unroll
  for (int m = 0; m < 7; ++m) s[m] = P[c + (m - 3) * stride];
  T dm[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) dm[m] = (s[m + 1] - s[m]) * inv_h;
  return weno5_upwind(dm, u);
}

// One RK stage over N axes at the padded index c of P (element strides
// stride[0..N-1]): alpha*aux[a] + beta*P[c] - gamma*(u[0]*W0 + ... ), the
// axes summed in order and the alpha term dropped when aux is null. The
// caller names aux's index a: K1's per-node kernel keeps aux on P's padded
// layout (a = c), K11 on the interior, K6 P's tile in shared memory (c and
// the strides the tile's, a aux's offset from the tile's first node).
template <typename T, int N, typename I = int64_t>
__device__ __forceinline__ T stage_value_at(const T* __restrict__ P, const T* __restrict__ aux,
                                            I c, I a, const I (&stride)[N], const T (&u)[N],
                                            const T (&inv_h)[N], T alpha, T beta, T gamma) {
  T ham = axis_term<T, I>(P, c, stride[0], inv_h[0], u[0]);
#pragma unroll
  for (int d = 1; d < N; ++d) ham = ham + axis_term<T, I>(P, c, stride[d], inv_h[d], u[d]);
  T res = beta * P[c] - gamma * ham;
  if (aux != nullptr) res = alpha * aux[a] + res;
  return res;
}

// The 3D stage of K1's per-node kernel at the padded index c of P (strides
// s0, s1, 1), aux on the same layout.
template <typename T>
__device__ __forceinline__ T stage_value(const T* __restrict__ P, const T* __restrict__ aux,
                                         int64_t c, int64_t s0, int64_t s1, T u0, T u1, T u2,
                                         T inv_h0, T inv_h1, T inv_h2, T alpha, T beta,
                                         T gamma) {
  const int64_t stride[3] = {s0, s1, 1};
  const T u[3] = {u0, u1, u2};
  const T inv_h[3] = {inv_h0, inv_h1, inv_h2};
  return stage_value_at<T, 3>(P, aux, c, c, stride, u, inv_h, alpha, beta, gamma);
}

// The 2D stage at the padded index c of a (n0+6, n1+6) buffer P (strides
// s1, 1), aux on the same layout: the 3D stage of the (1, n0, n1) embedding
// with axis 0 compiled out (its differences, and so its term, are exactly
// zero there); K1's per-node kernel on the embedding, and K6's 2D entries
// (stage_value_at on their tile) run it.
template <typename T>
__device__ __forceinline__ T stage_value_2d(const T* __restrict__ P, const T* __restrict__ aux,
                                            int64_t c, int64_t s1, T u1, T u2, T inv_h1,
                                            T inv_h2, T alpha, T beta, T gamma) {
  const int64_t stride[2] = {s1, 1};
  const T u[2] = {u1, u2};
  const T inv_h[2] = {inv_h1, inv_h2};
  return stage_value_at<T, 2>(P, aux, c, c, stride, u, inv_h, alpha, beta, gamma);
}

}  // namespace lsm

#endif  // LSM_WENO5_CUH
