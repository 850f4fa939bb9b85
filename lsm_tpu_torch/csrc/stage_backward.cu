// K3: cotangents of one fused RK stage (K1) of WENO5 advection; K3', further
// down, those of a term-list stage (K1') of the other kinds.
//
// Replaces the TPU kernel lsm_tpu/ops/weno_v2_bwd.py `stage_backward` (body
// `_make_bwd_kernel`). Given the folded cotangent g of the stage output (only
// its interior is read; K4 has already folded the ghost-shell cotangents
// into it), P, the three streamed velocity components u_a and the optional
// aux buffer, it writes
//   dP  (padded, every element): beta*g on the interior plus, per axis a,
//       (c_a[x] - c_a[x+e_a]) * inv_h_a, where the edge cotangent
//       c_a[z] = sum_k ddm_k(y = z - (k-2) e_a) gathers the six difference
//       cotangents of the <= 6 interior outputs y whose stencil uses the
//       difference D-(z). dP is nonzero on the face ghosts within reach 3 of
//       the interior (the stage reads stored ghosts) and 0 on edge and corner
//       ghosts;
//   du_a = core_a * (-gamma*g) on the interior (optional);
//   daux = alpha*g on the interior (optional; K5 zeroes its shells);
//   dcoef = (dalpha, dbeta, dgamma) = (sum g*aux, sum g*phi, -sum g*H).
// ddm and core come from the hand-derived WENO5 adjoint, the arithmetic of
// lsm_tpu_torch/ops/stencils.py `weno5_upwind_fwd_bwd` term by term. Every
// product, sum and quotient is rounded on its own (the __fmul_rn family, which
// the compiler never contracts into an FMA; IEEE division), because at
// WENO-symmetric cells the cotangent of eps multiplies a cancelled sum dr by
// r^2 ~ 1e21: the plain association is what keeps float32 right there.
//
// Design: one launch for the three axes (and the reduction), in the gather
// form (every dP element written by one thread, once). A block owns a column
// of CY x CX nodes in axes (1, 2) (16 x 32 in f32, 8 x 32 in f64; one thread
// per node) and marches down axis 0 over a chunk of <= 64 planes. Per output
// plane p:
//  - axis 0: each thread evaluates the adjoint of its own output (p, j, k)
//    from a register ring of the seven P values along axis 0 and adds the six
//    ddm into a register ring of the edge cotangents c_0. The march runs
//    downwards, so c_0[z] sums its outputs from y = z+2 down to z-3, the
//    order of the per-axis form, and dP of plane p+3 is complete (lag 3).
//  - axes 1 and 2 (the chunk's own planes only): plane p of P (the column and
//    a reach of 6, 28 x 44 in f32) and of g (reach 3) sit in shared memory,
//    filled by cp.async one plane ahead (two buffers); the adjoint of each
//    output of the column and a halo of 3 along its axis (22 x 32 for axis 1,
//    16 x 38 for axis 2) is evaluated once into shared memory (two sets, by
//    the plane's parity, so two barriers a plane suffice), and every thread
//    gathers c_1 and c_2 of its node, kept in registers until axis 0's lag
//    is through. A table built once per block holds each output's
//    plane-invariant offsets (int32 inside the column; across planes int64).
// dP, du and daux are written once; nothing is read back. Adjoint
// evaluations per output and axis: (chunk + 6)/chunk on axis 0 (1.10 at
// 512^3: 9 chunks of 58), 22/16 = 1.375 on axis 1, 38/32 = 1.19 on axis 2
// (the per-axis launches before: 24/18, 24/18 and 128/122). Dynamic shared
// memory 98.2 KB (f32: tiles 16.5, ddm 61.5, table 20.5), 104.3 KB (f64);
// one block of 16 warps per SM (125 registers in f32). Scalar sums: each block
// writes its partials (in double) to four scratch slots; the reduction sums
// them in a fixed order. No atomics: every run gives the same bits.
//
// Bound at 512^3 f32: it must read P, g (interior) and the 3 streams and
// write dP and the 3 du: 36 B/cell, 44 with aux and daux, 4.9-6.0 GB,
// 1.45-1.78 ms at 3.35 TB/s. Its arithmetic is 607 FP32 operations per cell
// (202 per axis, counting each of the 2 IEEE divisions per axis as one),
// 8.1e10 at 512^3, 1.2 ms at 67 TFLOP/s: bytes bind, barely. Measured on an
// H100 80GB HBM3 at 700 W (PERF.md): 9.7 ms, against 10.8 for the per-axis
// launches. With the adjoints replaced by a product per difference the
// kernel still takes 5.8 ms (tools/stage_bwd_variants.py): the per-plane
// skeleton (the tiles' halos, the barriers at 16 warps per SM, the halo
// outputs' velocity reads) binds more than the adjoint's unfused
// arithmetic.
//
// Accumulate mode (an advection term inside a term list, after K3' below has
// written dP): dP is added to, with no beta*g, no daux and no phi/aux
// partial sums, so dcoef is (0, 0, dgamma of this advection term).
//
// K3'' (the program entry, lsm_stage_bwd_prog_*): the velocity is a
// coefficient program (csrc/coef_program.cuh), each output evaluating the
// component of its axis at its node in place of the stream (the TPU
// kernel's "analytic" branch, weno_v2_bwd.py:604-660). There is no du. When
// the stage time needs a cotangent the component is evaluated in forward-mode
// dual numbers, and dt = sum over outputs of du_a * du_a/dt (du_a = core_a *
// (-gamma*g), the cotangent of u_a) joins the fixed-order partial sums.
//
// The 2D entries of K3 and K3'' (lsm_stage_bwd_2d_*, lsm_stage_bwd_prog_2d_*)
// take a 2D field's (n0+6, n1+6) layout, the dense 2D stepper's, whose K1 2D
// entries compute the function of the (1, n0, n1) embedding with its dummy
// axis compiled out (a program is evaluated at the embedding's node (0, i,
// j), from the embedding's table, as K1'' 2D reads it). Their kernel is a 2D
// march of its own (stage_bwd_2d_kernel, below): the 3D kernel's axis 0 down
// the 2D axis 0, the gather of its in-plane axes along the rows. Its sums
// are those of one plane a block (the design before it), so dP, du and daux
// keep their bits. Bound at 4096^2 f32: the streamed entry reads P, g and
// two velocity components and writes dP and two du, 28 B a cell (36 with aux
// and daux), 0.140 ms (0.180) at 3.35 TB/s, against 405 FP32 operations a
// cell (202 an axis and one), 0.101 ms at 67 TFLOP/s; with the rotation
// in-kernel 12 B a cell (0.060 ms) against the same operations (0.101 ms)
// and the program's: the operations bind.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "coef_program.cuh"
#include "lsm_kernels.h"

namespace {

template <typename T>
struct Rn;
template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float floor_eps() { return 1.0e-12f; }
};
template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double floor_eps() { return 1.0e-36; }
};

// cotangents (ga, gb) of ans = max(a, b) for the cotangent gm of ans; an
// exact tie splits 0.5 / 0.5
template <typename T>
__device__ __forceinline__ void max_bwd(T a, T b, T ans, T gm, T& ga, T& gb) {
  using R = Rn<T>;
  const bool ta = a == ans, tb = b == ans;
  ga = R::mul(gm, ta ? (tb ? T(0.5) : T(1)) : T(0));
  gb = R::mul(gm, tb ? (ta ? T(0.5) : T(1)) : T(0));
}

// Hand-derived WENO5 upwind adjoint for one output along one axis: from the
// six backward differences dm (D- at y-2 .. y+3), the velocity u and the
// cotangent g of H = u * core, the six cotangents ddm and core.
template <typename T>
__device__ __forceinline__ void weno5_fwd_bwd(const T* dm, T u, T g, T* ddm, T& core) {
  using R = Rn<T>;
  const bool cond = u > T(0);
  const T v1 = cond ? dm[0] : dm[5];
  const T v2 = cond ? dm[1] : dm[4];
  const T v3 = cond ? dm[2] : dm[3];
  const T v4 = cond ? dm[3] : dm[2];
  const T v5 = cond ? dm[4] : dm[1];
  // forward
  const T e2 = R::sub(v3, v2);
  const T e3 = R::sub(v4, v3);
  const T c1 = R::sub(e2, R::sub(v2, v1));
  const T c2 = R::sub(e3, e2);
  const T c3 = R::sub(R::sub(v5, v4), e3);
  const T d1 = R::add(R::add(v3, R::mul(T(0.5), e2)), R::mul(T(1.0 / 3.0), c1));
  const T d2 = R::sub(R::add(v3, R::mul(T(0.5), e3)), R::mul(T(1.0 / 6.0), c2));
  const T d3 = R::sub(R::add(v3, R::mul(T(0.5), e3)), R::mul(T(1.0 / 6.0), c3));
  const T c13 = T(13.0 / 12.0);
  const T t1 = R::add(c1, R::mul(T(2), e2));
  const T t2 = R::add(e2, e3);
  const T t3 = R::sub(c3, R::mul(T(2), e3));
  const T s1 = R::add(R::mul(c13, R::mul(c1, c1)), R::mul(T(0.25), R::mul(t1, t1)));
  const T s2 = R::add(R::mul(c13, R::mul(c2, c2)), R::mul(T(0.25), R::mul(t2, t2)));
  const T s3 = R::add(R::mul(c13, R::mul(c3, c3)), R::mul(T(0.25), R::mul(t3, t3)));
  const T sq1 = R::mul(v1, v1), sq2 = R::mul(v2, v2), sq3 = R::mul(v3, v3);
  const T sq4 = R::mul(v4, v4), sq5 = R::mul(v5, v5);
  const T m12 = sq1 > sq2 ? sq1 : sq2;  // torch.maximum (no NaN here)
  const T m34 = sq3 > sq4 ? sq3 : sq4;
  const T m14 = m12 > m34 ? m12 : m34;
  const T vmax = m14 > sq5 ? m14 : sq5;
  const T eps = R::add(R::mul(T(1.0e-6), vmax), R::floor_eps());
  const T r = R::div(T(1), eps);
  const T b1 = R::add(R::mul(s1, r), T(1));
  const T b2 = R::add(R::mul(s2, r), T(1));
  const T b3 = R::add(R::mul(s3, r), T(1));
  const T p1 = R::mul(b2, b3);
  const T p2 = R::mul(b1, b3);
  const T p3 = R::mul(b1, b2);
  const T q1 = R::mul(T(0.1), R::mul(p1, p1));
  const T q2 = R::mul(T(0.6), R::mul(p2, p2));
  const T q3 = R::mul(T(0.3), R::mul(p3, p3));
  const T qsum = R::add(R::add(q1, q2), q3);
  const T w = R::div(T(1), qsum);
  core = R::mul(R::add(R::add(R::mul(q1, d1), R::mul(q2, d2)), R::mul(q3, d3)), w);
  // backward
  const T gc = R::mul(u, g);
  const T wgc = R::mul(w, gc);
  const T dd1 = R::mul(q1, wgc);
  const T dd2 = R::mul(q2, wgc);
  const T dd3 = R::mul(q3, wgc);
  const T dq1 = R::mul(R::sub(d1, core), wgc);
  const T dq2 = R::mul(R::sub(d2, core), wgc);
  const T dq3 = R::mul(R::sub(d3, core), wgc);
  const T dp1 = R::mul(R::mul(T(0.2), p1), dq1);
  const T dp2 = R::mul(R::mul(T(1.2), p2), dq2);
  const T dp3 = R::mul(R::mul(T(0.6), p3), dq3);
  const T db1 = R::add(R::mul(b3, dp2), R::mul(b2, dp3));
  const T db2 = R::add(R::mul(b3, dp1), R::mul(b1, dp3));
  const T db3 = R::add(R::mul(b2, dp1), R::mul(b1, dp2));
  const T ds1 = R::mul(r, db1);
  const T ds2 = R::mul(r, db2);
  const T ds3 = R::mul(r, db3);
  const T dr = R::add(R::add(R::mul(s1, db1), R::mul(s2, db2)), R::mul(s3, db3));
  const T dvmax = R::mul(R::mul(T(-1.0e-6), R::mul(r, r)), dr);
  T dm14, dsq5, dm12, dm34, dsq1, dsq2, dsq3, dsq4;
  max_bwd(m14, sq5, vmax, dvmax, dm14, dsq5);
  max_bwd(m12, m34, m14, dm14, dm12, dm34);
  max_bwd(sq1, sq2, m12, dm12, dsq1, dsq2);
  max_bwd(sq3, sq4, m34, dm34, dsq3, dsq4);
  T dv1 = R::mul(R::mul(T(2), v1), dsq1);
  T dv2 = R::mul(R::mul(T(2), v2), dsq2);
  T dv3 = R::mul(R::mul(T(2), v3), dsq3);
  T dv4 = R::mul(R::mul(T(2), v4), dsq4);
  T dv5 = R::mul(R::mul(T(2), v5), dsq5);
  const T c13x2 = T(2.0 * (13.0 / 12.0));
  T dc1 = R::mul(R::mul(c13x2, c1), ds1);
  T dc2 = R::mul(R::mul(c13x2, c2), ds2);
  T dc3 = R::mul(R::mul(c13x2, c3), ds3);
  const T dt1 = R::mul(R::mul(T(0.5), t1), ds1);
  const T dt2 = R::mul(R::mul(T(0.5), t2), ds2);
  const T dt3 = R::mul(R::mul(T(0.5), t3), ds3);
  dc1 = R::add(dc1, dt1);
  T de2 = R::add(R::mul(T(2), dt1), dt2);
  T de3 = R::sub(dt2, R::mul(T(2), dt3));
  dc3 = R::add(dc3, dt3);
  dv3 = R::add(R::add(R::add(dv3, dd1), dd2), dd3);
  de2 = R::add(de2, R::mul(T(0.5), dd1));
  de3 = R::add(de3, R::mul(T(0.5), R::add(dd2, dd3)));
  dc1 = R::add(dc1, R::mul(T(1.0 / 3.0), dd1));
  dc2 = R::sub(dc2, R::mul(T(1.0 / 6.0), dd2));
  dc3 = R::sub(dc3, R::mul(T(1.0 / 6.0), dd3));
  de2 = R::sub(R::add(de2, dc1), dc2);
  de3 = R::sub(R::add(de3, dc2), dc3);
  dv1 = R::add(dv1, dc1);
  dv2 = R::sub(dv2, dc1);
  dv4 = R::sub(dv4, dc3);
  dv5 = R::add(dv5, dc3);
  dv3 = R::sub(R::add(dv3, de2), de3);
  dv2 = R::sub(dv2, de2);
  dv4 = R::add(dv4, de3);
  // undo the input selection
  ddm[0] = cond ? dv1 : T(0);
  ddm[1] = cond ? dv2 : dv5;
  ddm[2] = cond ? dv3 : dv4;
  ddm[3] = cond ? dv4 : dv3;
  ddm[4] = cond ? dv5 : dv2;
  ddm[5] = cond ? T(0) : dv1;
}

// The padded geometry in int32: sizes, and the strides of axes 0 and 1 (axis
// 2 is contiguous). A plane (S1 * S2 nodes) fits in int32; an offset across
// planes is int64.
struct Geom {
  int n[3], S[3];
  int s0, s1;
  int m12;  // n1 * n2: an interior plane
};

inline Geom make_geom(int64_t n0, int64_t n1, int64_t n2) {
  Geom g;
  const int64_t n[3] = {n0, n1, n2};
  for (int d = 0; d < 3; ++d) {
    g.n[d] = static_cast<int>(n[d]);
    g.S[d] = static_cast<int>(n[d] + 2 * LSM_GHOST);
  }
  g.s1 = g.S[2];
  g.s0 = g.S[1] * g.S[2];
  g.m12 = g.n[1] * g.n[2];
  return g;
}

// A 2D field's (n0+6, n1+6) layout as one plane of the geometry above with
// no axis-0 ghosts (S[0] = 1): its axes 0 and 1 take the places of axes 1
// and 2.
inline Geom make_geom_2d(int64_t n0, int64_t n1) {
  Geom g = make_geom(1, n0, n1);
  g.S[0] = 1;
  return g;
}

__device__ __forceinline__ int64_t pidx(const Geom& G, int i, int j, int k) {
  return int64_t(i) * G.s0 + (j * G.s1 + k);
}

__device__ __forceinline__ bool inside(int c, int n) { return c >= LSM_GHOST && c < n + LSM_GHOST; }

__device__ __forceinline__ bool interior(const Geom& G, int i, int j, int k) {
  return inside(i, G.n[0]) && inside(j, G.n[1]) && inside(k, G.n[2]);
}

inline int64_t nblocks(dim3 d) { return int64_t(d.x) * d.y * d.z; }

// The march along axis 0: chunks of at most kChunk planes, as even as the
// padded axis allows.
constexpr int kChunk = 64;

inline int chunks_of(int S0) { return (S0 + kChunk - 1) / kChunk; }
inline int chunk_len(int S0) { return (S0 + chunks_of(S0) - 1) / chunks_of(S0); }

// deterministic sum over the block of NT threads (result in thread 0)
template <int NT>
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0;
  if (tid == 0)
    for (int k = 0; k < NT / 32; ++k) v += red[k];
  return v;
}

constexpr int kReduceThreads = 1024;

// sum of part[stride*b + field] over b < count, in a fixed order
__device__ double strided_sum(const double* part, int64_t count, int stride, int field,
                              double* red) {
  double v = 0.0;
  for (int64_t b = threadIdx.x; b < count; b += kReduceThreads) v += part[b * stride + field];
  return block_sum<kReduceThreads>(v, red);
}

// out = (dalpha, dbeta, dgamma[, dt]) from the per-block partials (g*H, g*phi,
// g*aux, dt) of K3 or K3'; kDt writes out[3]
template <typename T, bool kDt>
__global__ void __launch_bounds__(kReduceThreads)
    stage_bwd_reduce_kernel(const double* part, int64_t nb, T* out) {
  __shared__ double red[4][kReduceThreads / 32];
  const double sg = strided_sum(part, nb, 4, 0, red[0]);
  const double sb = strided_sum(part, nb, 4, 1, red[1]);
  const double sa = strided_sum(part, nb, 4, 2, red[2]);
  double st = 0.0;
  if constexpr (kDt) st = strided_sum(part, nb, 4, 3, red[3]);
  if (threadIdx.x == 0) {
    out[0] = T(sa);
    out[1] = T(sb);
    out[2] = T(-sg);
    if (kDt) out[3] = T(st);
  }
}

template <typename T>
cudaError_t launch_reduce(const double* part, int64_t nb, bool dt, void* dcoef,
                          cudaStream_t stream) {
  const auto reduce = dt ? stage_bwd_reduce_kernel<T, true> : stage_bwd_reduce_kernel<T, false>;
  reduce<<<1, kReduceThreads, 0, stream>>>(part, nb, static_cast<T*>(dcoef));
  return cudaGetLastError();
}

// One element from global to shared memory asynchronously (cp.async); 0
// when !valid (src is then not read). async_wait() waits for this thread's
// copies; a barrier after it publishes them to the block.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  __pipeline_memcpy_async(dst, src, sizeof(T), valid ? 0 : sizeof(T));
}
__device__ __forceinline__ void async_commit() { __pipeline_commit(); }
__device__ __forceinline__ void async_wait() { __pipeline_wait_prior(0); }

// The column of one K3 block: CY x CX nodes in axes (1, 2), one thread each;
// the P tile (reach 6 around the column: the outputs within reach 3 and
// their stencils), the g tile (reach 3: the outputs), the outputs of axis 1
// (R1 rows of CX) and of axis 2 (CY rows of W2), UPT of them per thread.
template <typename T>
struct AdvTile {
  static constexpr int CY = sizeof(T) == 4 ? 16 : 8, CX = 32, NT = CY * CX;
  static constexpr int R1 = CY + 2 * LSM_GHOST, W2 = CX + 2 * LSM_GHOST;
  static constexpr int PY = CY + 4 * LSM_GHOST, PX = CX + 4 * LSM_GHOST;
  static constexpr int GY = R1, GX = W2;
  static constexpr int U1 = R1 * CX, U2 = CY * W2, UPT = (U1 + U2 + NT - 1) / NT;
  // dynamic shared memory: two P and two g tiles (one being filled), two
  // sets of ddm (by the plane's parity), then the units' table (int4 each,
  // 16-byte aligned)
  static constexpr size_t tab_off =
      ((2 * (PY * PX + GY * GX) + 2 * 6 * (U1 + U2)) * sizeof(T) + 15) / 16 * 16;
  static constexpr size_t smem = tab_off + (U1 + U2) * 16;
};

template <typename T>
inline dim3 adv_grid(const Geom& g) {
  using TL = AdvTile<T>;
  return dim3(static_cast<unsigned>((g.S[2] + TL::CX - 1) / TL::CX),
              static_cast<unsigned>((g.S[1] + TL::CY - 1) / TL::CY),
              static_cast<unsigned>(chunks_of(g.S[0])));
}

template <typename T>
struct BwdArgs {
  const T* P;
  const T* g;
  const T* u[3];  // the velocity components (interior-shaped); K3'' none
  const T* aux;   // may be null
  T* dP;
  T* du[3];  // each may be null
  T* daux;   // may be null
  double* part;
  Geom geo;
  int chunk;
  T inv_h[3], alpha, beta, gamma;
  int accumulate;  // add to dP (see above)
  // K3'' only: the velocity program (entry 0 of tab) and whether dt is wanted
  int needs_dt;
  LsmStageTerms tab;
};

// The plane-invariant part of axis-1/2 unit e of a K3 block (e < U1: axis 1,
// row r of R1; else axis 2, row r of CY, column c of W2), built once per
// block: x = its output's offset in the P tile | axis 2 << 16 | an output of
// the column << 17; y = its offset in the g tile | (yk - k0 + 3) << 16 |
// (yj - j0 + 3) << 24; z = (yj - 3) * n2 + (yk - 3), or -1 off the interior
// in the plane.
template <typename TL>
__device__ __forceinline__ int4 adv_unit(int e, int j0, int k0, const Geom& G) {
  constexpr int H = LSM_GHOST;
  int r, c, yj, yk, pc, gc, mine;
  const bool ax1 = e < TL::U1;
  if (ax1) {
    r = e / TL::CX, c = e % TL::CX;
    yj = j0 - H + r, yk = k0 + c;
    pc = (r + H) * TL::PX + c + 2 * H, gc = r * TL::GX + c + H;
    mine = r >= H && r < H + TL::CY;
  } else {
    r = (e - TL::U1) / TL::W2, c = (e - TL::U1) % TL::W2;
    yj = j0 + r, yk = k0 - H + c;
    pc = (r + 2 * H) * TL::PX + c + H, gc = (r + H) * TL::GX + c;
    mine = c >= H && c < H + TL::CX;
  }
  const bool in = inside(yj, G.n[1]) && inside(yk, G.n[2]);
  return make_int4(pc | (ax1 ? 0 : 1 << 16) | (mine << 17),
                   gc | ((yk - k0 + H) << 16) | ((yj - j0 + H) << 24),
                   in ? (yj - H) * G.n[2] + (yk - H) : -1, 0);
}

// The program velocity of K3'' along `axis` at an output (its t-derivative
// in *udt when dt is wanted)
template <typename T>
__device__ __forceinline__ T program_velocity(const BwdArgs<T>& a, int axis, int i, int j, int k,
                                              T* udt) {
  const int64_t n0 = i - LSM_GHOST, n1 = j - LSM_GHOST, n2 = k - LSM_GHOST;
  return a.needs_dt ? lsm::prog_eval<T, true>(a.tab.prog, 0, axis, n0, n1, n2, udt)
                    : lsm::prog_eval<T, false>(a.tab.prog, 0, axis, n0, n1, n2, nullptr);
}

// (c_a[x] - c_a[x + e_a]) * inv_h from the six ddm rows D[q] of the outputs
// along a: x at row r, rows `step` apart, `lane` the offset across them
template <typename T, int N>
__device__ __forceinline__ T edge_term(const T (*D)[N], int r, int step, int lane, T inv_h) {
  using R = Rn<T>;
  T cx = D[0][(r + 2) * step + lane];
  T cx1 = D[0][(r + 3) * step + lane];
#pragma unroll
  for (int q = 1; q < 6; ++q) {
    cx = R::add(cx, D[q][(r + 2 - q) * step + lane]);
    cx1 = R::add(cx1, D[q][(r + 3 - q) * step + lane]);
  }
  return R::mul(R::sub(cx, cx1), inv_h);
}

template <typename T, bool kProgram>
__global__ void __launch_bounds__(AdvTile<T>::NT)
    stage_bwd_kernel(const __grid_constant__ BwdArgs<T> a) {
  using R = Rn<T>;
  using TL = AdvTile<T>;
  constexpr int CY = TL::CY, CX = TL::CX, NT = TL::NT, H = LSM_GHOST, UPT = TL::UPT;
  constexpr int LAG = H;  // dP of plane p + LAG is written at plane p
  constexpr int PT = TL::PY * TL::PX, GT = TL::GY * TL::GX;
  extern __shared__ __align__(16) unsigned char lsm_dyn_smem[];
  T* const Pt = reinterpret_cast<T*>(lsm_dyn_smem);  // [2][PT], plane p in buffer p & 1
  T* const Gt = Pt + 2 * PT;                          // [2][GT]
  T(*const D1s)[TL::U1] = reinterpret_cast<T(*)[TL::U1]>(Gt + 2 * GT);  // [2 * 6]
  T(*const D2s)[TL::U2] = reinterpret_cast<T(*)[TL::U2]>(&D1s[12][0]);   // [2 * 6]
  int4* const units = reinterpret_cast<int4*>(lsm_dyn_smem + TL::tab_off);
  __shared__ double red[4][NT / 32];
  const Geom& G = a.geo;
  const int t = threadIdx.x, jl = t / CX, kl = t % CX;
  const int j0 = blockIdx.y * CY, k0 = blockIdx.x * CX;
  const int j = j0 + jl, k = k0 + kl;
  const int i0 = blockIdx.z * a.chunk, i1 = min(i0 + a.chunk, G.S[0]);
  const bool col = j < G.S[1] && k < G.S[2];
  // this thread's node in its plane: padded offset, interior offset (-1 off
  // the interior in the plane)
  const int pin = j * G.s1 + k;
  const int qin = inside(j, G.n[1]) && inside(k, G.n[2]) ? (j - H) * G.n[2] + (k - H) : -1;
  const T neg_gamma = -a.gamma;
  double sg = 0.0, sb = 0.0, sa = 0.0, st = 0.0;
  for (int e = t; e < TL::U1 + TL::U2; e += NT) units[e] = adv_unit<TL>(e, j0, k0, G);
  T pr[7] = {};                // P[p - 3 + q] along axis 0 at (j, k)
  T cz[7] = {};                // c_0[p - 2 + q]
  T c1q[4] = {}, c2q[4] = {};  // the axis-1 and axis-2 dP terms of planes p .. p + 3
  auto P_at = [&](int i) -> T {
    return col && i >= 0 && i < G.S[0] ? a.P[int64_t(i) * G.s0 + pin] : T(0);
  };
  // plane `plane` of P and g into the tiles, asynchronously
  auto issue_tiles = [&](int plane) {
    T* const pd = Pt + (plane & 1) * PT;
    T* const gd = Gt + (plane & 1) * GT;
    for (int e = t; e < PT; e += NT) {
      const int jj = j0 - 2 * H + e / TL::PX, kk = k0 - 2 * H + e % TL::PX;
      const bool in = jj >= 0 && jj < G.S[1] && kk >= 0 && kk < G.S[2];
      copy_async(pd + e, a.P + (in ? pidx(G, plane, jj, kk) : 0), in);
    }
    for (int e = t; e < GT; e += NT) {
      const int jj = j0 - H + e / TL::GX, kk = k0 - H + e % TL::GX;
      const bool in = interior(G, plane, jj, kk);
      copy_async(gd + e, a.g + (in ? pidx(G, plane, jj, kk) : 0), in);
    }
    async_commit();
  };
  // what step p reads from global memory besides the tiles, loaded a step
  // ahead: the axis-0 output's new P, its g and u_0, each unit's velocity
  T nx_p = T(0), nx_g = T(0), nx_u0 = T(0), nx_u[UPT] = {};
  auto fetch = [&](int p) {
    nx_p = P_at(p - H);
    const bool in_p = inside(p, G.n[0]);
    const bool in0 = in_p && qin >= 0;
    nx_g = in0 ? a.g[int64_t(p) * G.s0 + pin] : T(0);
    if constexpr (!kProgram) {
      const int64_t qp = int64_t(p - H) * G.m12;
      nx_u0 = in0 ? a.u[0][qp + qin] : T(0);
      const bool own = p >= i0 && p < i1 && in_p;
#pragma unroll
      for (int m = 0; m < UPT; ++m) {
        const int e = t + m * NT;
        const int4 u = e < TL::U1 + TL::U2 ? units[e] : make_int4(0, 0, -1, 0);
        const bool in = own && u.z >= 0;
        nx_u[m] = in ? a.u[(u.x >> 16 & 1) + 1][qp + u.z] : T(0);
      }
    }
  };
  const int ptop = i1 - 1 + LAG;
#pragma unroll
  for (int q = 0; q < 6; ++q) pr[q] = P_at(ptop - 2 + q);  // shifted up on entry
  __syncthreads();  // the units' table is in
  fetch(ptop);
  issue_tiles(i1 - 1);  // the first plane of the chunk
  for (int p = ptop; p >= i0 - LAG; --p) {
    const bool own = p >= i0 && p < i1;  // uniform over the block
    const T p_new = nx_p, g0 = nx_g, u0 = nx_u0;
    T um[UPT];
#pragma unroll
    for (int m = 0; m < UPT; ++m) um[m] = nx_u[m];
    if (p > i0 - LAG) fetch(p - 1);
#pragma unroll
    for (int q = 3; q > 0; --q) {
      c1q[q] = c1q[q - 1];
      c2q[q] = c2q[q - 1];
    }
    c1q[0] = c2q[0] = T(0);
    if (own) {
      async_wait();
      __syncthreads();  // the tiles of plane p are in
      // the next plane's into the other buffers: their last readers passed
      // the previous plane's barriers
      if (p > i0) issue_tiles(p - 1);
    }
    {  // axis 0: this thread's output (p, j, k)
#pragma unroll
      for (int q = 6; q > 0; --q) {
        pr[q] = pr[q - 1];
        cz[q] = cz[q - 1];
      }
      pr[0] = p_new;
      cz[0] = T(0);
      if (qin >= 0 && inside(p, G.n[0])) {
        T dm[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) dm[q] = R::mul(R::sub(pr[q + 1], pr[q]), a.inv_h[0]);
        T udt = T(0);
        T uv = u0;
        if constexpr (kProgram) uv = program_velocity(a, 0, p, j, k, &udt);
        const T gup = R::mul(neg_gamma, g0);
        T ddm[6], core;
        weno5_fwd_bwd(dm, uv, gup, ddm, core);
#pragma unroll
        for (int q = 0; q < 6; ++q) cz[q] = R::add(cz[q], ddm[q]);
        if (own) {
          if (!kProgram && a.du[0] != nullptr)
            a.du[0][int64_t(p - H) * G.m12 + qin] = R::mul(core, gup);
          sg += double(g0) * double(R::mul(uv, core));
          if (kProgram) st += double(R::mul(core, gup)) * double(udt);
        }
      }
    }
    if (own) {
      // axes 1 and 2: the outputs of the column and a halo of 3 along each;
      // their ddm in the set of this plane's parity, whose last readers
      // passed this plane's first barrier
      T(*const D1)[TL::U1] = D1s + 6 * (p & 1);
      T(*const D2)[TL::U2] = D2s + 6 * (p & 1);
      const T* const pt = Pt + (p & 1) * PT;
      const T* const gt = Gt + (p & 1) * GT;
      const bool in_p = inside(p, G.n[0]);
      const int64_t qp = int64_t(p - H) * G.m12;
#pragma unroll
      for (int m = 0; m < UPT; ++m) {
        const int e = t + m * NT;
        if (e >= TL::U1 + TL::U2) break;
        const int4 un = units[e];
        const bool ax1 = (un.x >> 16 & 1) == 0;
        const int axis = ax1 ? 1 : 2;
        T* const Dq = ax1 ? &D1[0][e] : &D2[0][e - TL::U1];
        const int dstride = ax1 ? TL::U1 : TL::U2;
        if (!(in_p && un.z >= 0)) {
#pragma unroll
          for (int q = 0; q < 6; ++q) Dq[q * dstride] = T(0);
          continue;
        }
        // the output in the tiles: P's rows from j0 - 6, g's from j0 - 3
        const int pc = un.x & 0xffff, gc = un.y & 0xffff;
        const int step = ax1 ? TL::PX : 1;
        T dm[6];
#pragma unroll
        for (int q = 0; q < 6; ++q)
          dm[q] = R::mul(R::sub(pt[pc + (q - H + 1) * step], pt[pc + (q - H) * step]),
                         a.inv_h[axis]);
        T udt = T(0);
        T uv = um[m];
        if constexpr (kProgram)
          uv = program_velocity(a, axis, p, j0 - H + (un.y >> 24),
                                k0 - H + (un.y >> 16 & 0xff), &udt);
        const T gv = gt[gc];
        const T gup = R::mul(neg_gamma, gv);
        T ddm[6], core;
        weno5_fwd_bwd(dm, uv, gup, ddm, core);
#pragma unroll
        for (int q = 0; q < 6; ++q) Dq[q * dstride] = ddm[q];
        if (un.x >> 17 & 1) {  // an output of this block's column
          if (!kProgram && a.du[axis] != nullptr) a.du[axis][qp + un.z] = R::mul(core, gup);
          sg += double(gv) * double(R::mul(uv, core));
          if (kProgram) st += double(R::mul(core, gup)) * double(udt);
        }
      }
      __syncthreads();  // the ddm are in
      c1q[0] = edge_term<T, TL::U1>(D1, jl + H, CX, kl, a.inv_h[1]);
      c2q[0] = edge_term<T, TL::U2>(D2, kl + H, 1, jl * TL::W2, a.inv_h[2]);
    }
    // dP of plane i = p + LAG: c_0 of planes i and i + 1 are complete
    const int i = p + LAG;
    if (col && i >= i0 && i < i1) {
      const T contrib0 = R::mul(R::sub(cz[5], cz[6]), a.inv_h[0]);
      const int64_t x = int64_t(i) * G.s0 + pin;
      T v;
      if (a.accumulate) {
        v = R::add(a.dP[x], contrib0);
      } else if (qin >= 0 && inside(i, G.n[0])) {
        const T gv = a.g[x];
        v = R::add(R::mul(a.beta, gv), contrib0);
        if (a.daux != nullptr) a.daux[x] = R::mul(a.alpha, gv);
        sb += double(gv) * double(a.P[x]);
        if (a.aux != nullptr) sa += double(gv) * double(a.aux[x]);
      } else {
        v = contrib0;
      }
      v = R::add(v, c1q[LAG]);
      a.dP[x] = R::add(v, c2q[LAG]);
    }
  }
  const int64_t bid = int64_t(blockIdx.x) + int64_t(gridDim.x) *
                      (int64_t(blockIdx.y) + int64_t(gridDim.y) * blockIdx.z);
  sg = block_sum<NT>(sg, red[0]);
  sb = block_sum<NT>(sb, red[1]);
  sa = block_sum<NT>(sa, red[2]);
  st = block_sum<NT>(st, red[3]);
  if (t == 0) {
    a.part[4 * bid] = sg;
    a.part[4 * bid + 1] = sb;
    a.part[4 * bid + 2] = sa;
    a.part[4 * bid + 3] = st;
  }
}

// K3 (kProgram false: the velocity streamed in u) and K3'' (the velocity the
// program of tab's entry 0): the fused launch, then the reduction
template <typename T, bool kProgram>
int launch_stage_bwd(const void* P, const void* g, const void* const* u, const void* aux,
                     void* dP, void* const* du, void* daux, void* part, void* dcoef, int64_t n0,
                     int64_t n1, int64_t n2, const double* inv_h, double alpha, double beta,
                     double gamma, int accumulate, const LsmStageTerms* tab, int needs_dt,
                     void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  BwdArgs<T> a{};
  a.P = static_cast<const T*>(P);
  a.g = static_cast<const T*>(g);
  a.aux = accumulate ? nullptr : static_cast<const T*>(aux);
  a.dP = static_cast<T*>(dP);
  a.daux = accumulate ? nullptr : static_cast<T*>(daux);
  for (int d = 0; d < 3; ++d) {
    a.u[d] = kProgram ? nullptr : static_cast<const T*>(u[d]);
    a.du[d] = kProgram ? nullptr : static_cast<T*>(du[d]);
    a.inv_h[d] = T(inv_h[d]);
  }
  a.part = static_cast<double*>(part);
  a.geo = make_geom(n0, n1, n2);
  a.chunk = chunk_len(a.geo.S[0]);
  a.alpha = T(alpha);
  a.beta = T(beta);
  a.gamma = T(gamma);
  a.accumulate = accumulate;
  if constexpr (kProgram) {
    a.needs_dt = needs_dt;
    a.tab = *tab;
  }
  const dim3 grid = adv_grid<T>(a.geo);
  const auto kernel = stage_bwd_kernel<T, kProgram>;
  const size_t smem = AdvTile<T>::smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, AdvTile<T>::NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // without dt, dcoef[3] is left as the caller zeroed it
  return static_cast<int>(
      launch_reduce<T>(a.part, nblocks(grid), kProgram && needs_dt, dcoef, stream));
}


// ---------------------------------------------------------------------------
// K3 and K3'' 2D (lsm_stage_bwd_2d_*, lsm_stage_bwd_prog_2d_*): the march.
//
// A block of NT threads owns NT columns of the padded axis 1, one thread a
// column, and marches down a chunk of <= 64 padded rows of axis 0 (as even as
// the axis allows), NR rows a step (6 in f32, 4 in f64). Step s stages the
// rows b .. b + NR - 1 (b = i1 - (s + 1) NR) by cp.async one step ahead: P
// over the columns and a reach of 6, g and u1 over the columns and a halo of
// 3; at the columns, u0 of the rows three below and aux of the rows six
// below (the axis-0 outputs' and the written rows'). Then:
//  - axis 1 (across the row): the adjoint of every output of the step's rows
//    in the chunk, over the columns and a halo of 3 (NT + 6 a row), once into
//    shared memory; a barrier;
//  - axis 0 (along the march): each thread evaluates the outputs y = b + 3
//    .. b + NR + 2 of its column from a register ring of seven P values and
//    adds their six ddm into a register ring of the edge cotangents c_0 (the
//    3D kernel's axis 0), so c_0[z] sums its outputs y = z + 2 down to z - 3,
//    edge_term's order; after output y the row y + 3 is complete and its dP
//    written once: c_1 from a ring of held values (each thread's own, in
//    shared memory; a step's rows are at least 6 below the rows it writes,
//    so each step fills it by edge_term after its writes), g from a register ring of the outputs' g, P from the ring's pr[6], aux
//    staged: the write reads no device memory.
// dP = ((beta*g + 0) + c_0 term) + c_1 term, every sum and product rounded as
// in the design of one plane a block, so dP, du and daux keep its bits.
// Adjoints per output: (chunk + 6)/chunk along axis 0 (the last step's
// extra rows skipped), (NT + 6)/NT across. K3'': a component that reads one
// 2D coordinate or none is evaluated once per column or once per row of the
// block into shared memory (ops/coef_program.py `Program.axes`, K1'' 2D's
// rule), one that reads both per output. Shared memory in f32 50.7 KB (56.8
// with aux; K3'' 38.1, 44.2). Against six rows a step, 128 columns and
// three blocks an SM (the fastest of six rounds, two runs; PERF.md section
// 6, the 2D marches' entry): four rows 2-3% slower, four blocks an SM within
// the spread, 64 columns 3% and 256 columns 24-29% slower; eight and sixteen
// rows measured slower before and are not built (a step would stage a row
// it writes). Scalar sums in per-block slots, reduced in a fixed order, as K3.

enum { kByColumn = 0, kByRow = 1, kByNode = 2 };  // K3'': how a component is evaluated

template <typename T>
struct Adv2D {
  static constexpr int NT = 128;                    // threads, one column each
  static constexpr int NR = sizeof(T) == 4 ? 6 : 4;  // rows a step
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 3 : 2;
  static constexpr int WP = NT + 4 * LSM_GHOST;  // a staged row of P: reach 6
  static constexpr int WG = NT + 2 * LSM_GHOST;  // of g and u1: the outputs of axis 1
  static constexpr int C1 = 8;                   // the ring of held c_1 rows (6 live)
  // a step stages the rows b .. b + NR - 1 and writes b + 6 .. b + NR + 5,
  // whose c_1 earlier steps held; the rows b .. b + 5 take distinct slots
  static_assert(NR <= 6 && C1 >= 6 && (C1 & (C1 - 1)) == 0, "c_1 of a written row is held");
  // a stage: NR rows of P and of g, then (streamed) of u1 and of u0, then
  // (with aux) of aux
  static constexpr int stage(bool prog, bool aux) {
    return NR * (WP + WG + (prog ? 0 : WG + NT) + (aux ? NT : 0));
  }
  // the two stages, the ddm of a step, the held c_1 and g
  static constexpr size_t smem(bool prog, bool aux) {
    return size_t(2 * stage(prog, aux) + 6 * NR * WG + (C1 + LSM_GHOST) * NT) * sizeof(T);
  }
};

template <typename T>
struct Bwd2DArgs {
  const T* P;
  const T* g;
  const T* u[2];  // the velocity components (interior-shaped); K3'' none
  const T* aux;   // may be null
  T* dP;
  T* du[2];  // each may be null
  T* daux;   // may be null
  double* part;
  int n0, n1, S0, S1, chunk;
  int stage, aux_at;  // a stage's elements (Adv2D::stage), where its aux starts
  T inv_h[2], alpha, beta, gamma;
  int accumulate;
  int needs_dt, vclass[2];  // K3'': dt wanted; how each component is evaluated
  LsmStageTerms tab;        // K3'': the velocity program (entry 0, the embedding's)
};

// K3'': component 1 + d of the embedding's program at the 2D output (y, x)
// (padded), its t-derivative in *udt when dt is wanted
template <typename T>
__device__ __forceinline__ T prog_2d(const Bwd2DArgs<T>& a, int d, int y, int x, T* udt) {
  const int64_t i1 = y - LSM_GHOST, i2 = x - LSM_GHOST;
  return a.needs_dt ? lsm::prog_eval<T, true>(a.tab.prog, 0, d + 1, 0, i1, i2, udt)
                    : lsm::prog_eval<T, false>(a.tab.prog, 0, d + 1, 0, i1, i2, nullptr);
}

template <typename T, bool kProgram>
__global__ void __launch_bounds__(Adv2D<T>::NT, Adv2D<T>::MIN_BLOCKS)
    stage_bwd_2d_kernel(const __grid_constant__ Bwd2DArgs<T> a) {
  using R = Rn<T>;
  using M = Adv2D<T>;
  constexpr int NT = M::NT, NR = M::NR, WP = M::WP, WG = M::WG, C1 = M::C1, H = LSM_GHOST;
  constexpr int VR = kChunk + 2 * H;
  const int ST = a.stage;
  extern __shared__ __align__(16) unsigned char lsm_dyn_smem[];
  T* const ring = reinterpret_cast<T*>(lsm_dyn_smem);  // [2][ST], step s in stage s & 1
  T(*const D)[NR * WG] = reinterpret_cast<T(*)[NR * WG]>(ring + 2 * ST);  // [6]
  T* const c1s = ring + 2 * ST + 6 * NR * WG;  // [C1][NT]: c_1 of row i in slot i % C1
  T* const hold = c1s + C1 * NT;               // [H][NT]: g of the rows b .. b + 2
  __shared__ double red[4][NT / 32];
  // K3'': the components by column (the block's columns and halo) and by row
  // (the chunk's and a reach of 3), values then t-derivatives
  __shared__ T vcol[kProgram ? 4 : 1][kProgram ? WG : 1];
  __shared__ T vrow[kProgram ? 4 : 1][kProgram ? VR : 1];
  const int t = threadIdx.x, k0 = blockIdx.x * NT, k = k0 + t;
  const int i0 = blockIdx.y * a.chunk, i1 = min(i0 + a.chunk, a.S0);
  const int nsteps = (i1 - i0 + 2 * H + NR - 1) / NR;
  const bool col = k < a.S1, kin = inside(k, a.n1);
  const T neg_gamma = -a.gamma;
  double sg = 0.0, sb = 0.0, sa = 0.0, st = 0.0;
  // step s's rows into stage s & 1, asynchronously (one commit group a step)
  auto issue = [&](int s) {
    if (s < nsteps) {
      T* const sp = ring + (s & 1) * ST;
      const int b = i1 - (s + 1) * NR;
      for (int e = t; e < NR * WP; e += NT) {
        const int r = e / WP, c = k0 - 2 * H + (e - r * WP), row = b + r;
        const bool in = row >= 0 && c >= 0 && c < a.S1;
        copy_async(sp + e, a.P + (in ? int64_t(row) * a.S1 + c : 0), in);
      }
      T* const gd = sp + NR * WP;
      for (int e = t; e < NR * WG; e += NT) {
        const int r = e / WG, c = k0 - H + (e - r * WG), row = b + r;
        const bool in = inside(row, a.n0) && inside(c, a.n1);
        copy_async(gd + e, a.g + (in ? int64_t(row) * a.S1 + c : 0), in);
        if constexpr (!kProgram)
          copy_async(gd + NR * WG + e, a.u[1] + (in ? int64_t(row - H) * a.n1 + (c - H) : 0), in);
      }
      // at the columns: u0 of the axis-0 outputs b + 3 .. b + NR + 2, aux of
      // the rows written after them, b + 6 .. b + NR + 5
      if constexpr (!kProgram) {
        T* const ud = gd + 2 * NR * WG;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const bool in = inside(b + H + r, a.n0) && kin;
          copy_async(ud + r * NT + t, a.u[0] + (in ? int64_t(b + r) * a.n1 + (k - H) : 0), in);
        }
      }
      if (a.aux != nullptr) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const bool in = inside(b + 2 * H + r, a.n0) && kin;
          copy_async(sp + a.aux_at + r * NT + t,
                     a.aux + (in ? int64_t(b + 2 * H + r) * a.S1 + k : 0), in);
        }
      }
    }
    async_commit();
  };
  issue(0);
  auto velocity = [&](int d, int y, int x, T* udt) -> T {
    if (a.vclass[d] == kByColumn) {
      *udt = vcol[2 + d][x - k0 + H];
      return vcol[d][x - k0 + H];
    }
    if (a.vclass[d] == kByRow) {
      *udt = vrow[2 + d][y - i0 + H];
      return vrow[d][y - i0 + H];
    }
    return prog_2d(a, d, y, x, udt);
  };
  if constexpr (kProgram) {  // at the interior's columns and rows (a table has no more)
    for (int e = t; e < 2 * WG; e += NT) {
      const int d = e / WG, c = e - d * WG;
      T dt = T(0);
      if (a.vclass[d] == kByColumn && inside(k0 - H + c, a.n1)) {
        vcol[d][c] = prog_2d(a, d, H, k0 - H + c, &dt);
        vcol[2 + d][c] = dt;
      }
    }
    for (int e = t; e < 2 * VR; e += NT) {
      const int d = e / VR, r = e - d * VR;
      T dt = T(0);
      if (a.vclass[d] == kByRow && inside(i0 - H + r, a.n0) && i0 - H + r < i1 + H) {
        vrow[d][r] = prog_2d(a, d, i0 - H + r, H, &dt);
        vrow[2 + d][r] = dt;
      }
    }
  }
  // the ring along axis 0 enters at the output y = i1 + 2: P of the rows i1
  // .. i1 + 5 (shifted up on entry), g of the rows i1 .. i1 + 2 held; g of
  // the outputs y .. y + 3 rides a ring of its own, so the row y + 3 written
  // after output y reads no device memory (its P is pr[6], its aux staged)
  T pr[7] = {}, cz[7] = {}, gq[4] = {};
#pragma unroll
  for (int q = 0; q < 6; ++q)
    pr[q] = col && i1 + q < a.S0 ? a.P[int64_t(i1 + q) * a.S1 + k] : T(0);
#pragma unroll
  for (int j = 0; j < H; ++j)
    hold[j * NT + t] = inside(i1 + j, a.n0) && kin ? a.g[int64_t(i1 + j) * a.S1 + k] : T(0);
  for (int s = 0; s < nsteps; ++s) {
    async_wait();
    __syncthreads();  // step s's rows are in; every thread is done with step s - 1
    issue(s + 1);     // into the stage step s - 1 read
    const int b = i1 - (s + 1) * NR;
    const T* const Ps = ring + (s & 1) * ST;
    const T* const Gs = Ps + NR * WP;
    const T* const U1s = Gs + NR * WG;
    const T* const U0s = U1s + NR * WG;
    const T* const As = Ps + a.aux_at;
    // axis 1: the outputs of the step's rows in the chunk over the columns
    // and a halo of 3: this thread's column's NR, then one of the 6 NR of the halo
    for (int m = 0; m <= NR; ++m) {
      int r = m, c = t + H;
      if (m == NR) {
        if (t >= 6 * NR) break;
        r = t / 6;
        c = t % 6 < 3 ? t % 6 : NT + t % 6;
      }
      const int row = b + r, x = k0 - H + c;
      if (row < i0) continue;  // no dP of this chunk reads it
      T ddm[6] = {};
      if (inside(row, a.n0) && inside(x, a.n1)) {
        const T* const pc = Ps + r * WP + c + H;  // P at (row, x)
        T dm[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) dm[q] = R::mul(R::sub(pc[q - 2], pc[q - 3]), a.inv_h[1]);
        T udt = T(0);
        T uv;
        if constexpr (kProgram) uv = velocity(1, row, x, &udt);
        else uv = U1s[r * WG + c];
        const T gv = Gs[r * WG + c];
        const T gup = R::mul(neg_gamma, gv);
        T core;
        weno5_fwd_bwd(dm, uv, gup, ddm, core);
        if (m < NR) {  // an output of this thread's column
          if (!kProgram && a.du[1] != nullptr)
            a.du[1][int64_t(row - H) * a.n1 + (x - H)] = R::mul(core, gup);
          sg += double(gv) * double(R::mul(uv, core));
          if (kProgram) st += double(R::mul(core, gup)) * double(udt);
        }
      }
#pragma unroll
      for (int q = 0; q < 6; ++q) D[q][r * WG + c] = ddm[q];
    }
    __syncthreads();  // the ddm are in
    // axis 0: the outputs y = b + 3 + m of this thread's column, downwards
#pragma unroll 1
    for (int m = NR - 1; m >= 0; --m) {
      const int y = b + H + m;
#pragma unroll
      for (int q = 6; q > 0; --q) {
        pr[q] = pr[q - 1];
        cz[q] = cz[q - 1];
      }
      pr[0] = Ps[m * WP + t + 2 * H];  // P[y - 3]: the step's row m
      // g at (y, k): the step's row m + 3, or held from the step above
      const T gv = m >= NR - H ? hold[(m - NR + H) * NT + t] : Gs[(m + H) * WG + t + H];
#pragma unroll
      for (int q = 3; q > 0; --q) gq[q] = gq[q - 1];
      gq[0] = gv;
      T ddm[6] = {};
      if (kin && inside(y, a.n0) && y >= i0 - H) {
        T dm[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) dm[q] = R::mul(R::sub(pr[q + 1], pr[q]), a.inv_h[0]);
        T udt = T(0);
        T uv;
        if constexpr (kProgram) uv = velocity(0, y, k, &udt);
        else uv = U0s[m * NT + t];
        const T gup = R::mul(neg_gamma, gv);
        T core;
        weno5_fwd_bwd(dm, uv, gup, ddm, core);
        if (y >= i0 && y < i1) {
          if (!kProgram && a.du[0] != nullptr)
            a.du[0][int64_t(y - H) * a.n1 + (k - H)] = R::mul(core, gup);
          sg += double(gv) * double(R::mul(uv, core));
          if (kProgram) st += double(R::mul(core, gup)) * double(udt);
        }
      }
      cz[0] = ddm[0];  // c_0[y - 2]'s first output, as edge_term starts its sum
#pragma unroll
      for (int q = 1; q < 6; ++q) cz[q] = R::add(cz[q], ddm[q]);
      // dP of row i = y + 3: c_0 of rows i and i + 1 are complete
      const int i = y + H;
      if (col && i >= i0 && i < i1) {
        const T c0 = R::mul(R::sub(cz[5], cz[6]), a.inv_h[0]);
        const T c1 = c1s[(i & (C1 - 1)) * NT + t];
        const int64_t x = int64_t(i) * a.S1 + k;
        T v;
        if (a.accumulate) {
          v = R::add(a.dP[x], T(0));
        } else if (kin && inside(i, a.n0)) {  // g, P and aux of row i: gq[3], pr[6], staged
          v = R::add(R::mul(a.beta, gq[3]), T(0));
          if (a.daux != nullptr) a.daux[x] = R::mul(a.alpha, gq[3]);
          sb += double(gq[3]) * double(pr[6]);
          if (a.aux != nullptr) sa += double(gq[3]) * double(As[m * NT + t]);
        } else {
          v = T(0);
        }
        v = R::add(v, c0);
        a.dP[x] = R::add(v, c1);
      }
    }
    // c_1 of the step's rows, which the next steps write (after this step's
    // reads of the ring)
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (b + r >= i0)
        c1s[((b + r) & (C1 - 1)) * NT + t] =
            edge_term<T, NR * WG>(D, t + H, 1, r * WG, a.inv_h[1]);
    // g of the step's rows b .. b + 2, which the next step's axis 0 reads
#pragma unroll
    for (int j = 0; j < H; ++j) hold[j * NT + t] = Gs[j * WG + t + H];
  }
  const int64_t bid = int64_t(blockIdx.x) + int64_t(gridDim.x) * blockIdx.y;
  sg = block_sum<NT>(sg, red[0]);
  sb = block_sum<NT>(sb, red[1]);
  sa = block_sum<NT>(sa, red[2]);
  st = block_sum<NT>(st, red[3]);
  if (t == 0) {
    a.part[4 * bid] = sg;
    a.part[4 * bid + 1] = sb;
    a.part[4 * bid + 2] = sa;
    a.part[4 * bid + 3] = st;
  }
}

inline dim3 adv_grid_2d(int64_t n0, int64_t n1) {
  return dim3(static_cast<unsigned>((n1 + 2 * LSM_GHOST + Adv2D<float>::NT - 1) /
                                    Adv2D<float>::NT),
              static_cast<unsigned>(chunks_of(static_cast<int>(n0 + 2 * LSM_GHOST))));
}

// K3 2D (kProgram false: u0, u1 streamed) and K3'' 2D (tab's entry 0 the
// velocity program, axes[d] the embedding's axes its component 1 + d reads):
// the march, then the reduction
template <typename T, bool kProgram>
int launch_stage_bwd_2d(const void* P, const void* g, const void* u0, const void* u1,
                        const void* aux, void* dP, void* du0, void* du1, void* daux, void* part,
                        void* dcoef, int64_t n0, int64_t n1, double inv_h0, double inv_h1,
                        double alpha, double beta, double gamma, int accumulate,
                        const LsmStageTerms* tab, int needs_dt, const int* axes,
                        void* stream_) {
  using M = Adv2D<T>;
  if (n0 < 1 || n1 < 1 || n0 > (1 << 29) || n1 > (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  Bwd2DArgs<T> a{};
  a.P = static_cast<const T*>(P);
  a.g = static_cast<const T*>(g);
  a.u[0] = static_cast<const T*>(u0);
  a.u[1] = static_cast<const T*>(u1);
  a.aux = accumulate ? nullptr : static_cast<const T*>(aux);
  a.dP = static_cast<T*>(dP);
  a.du[0] = static_cast<T*>(du0);
  a.du[1] = static_cast<T*>(du1);
  a.daux = accumulate ? nullptr : static_cast<T*>(daux);
  a.part = static_cast<double*>(part);
  a.n0 = static_cast<int>(n0);
  a.n1 = static_cast<int>(n1);
  a.S0 = a.n0 + 2 * LSM_GHOST;
  a.S1 = a.n1 + 2 * LSM_GHOST;
  a.chunk = chunk_len(a.S0);
  a.stage = M::stage(kProgram, a.aux != nullptr);
  a.aux_at = M::stage(kProgram, false);
  a.inv_h[0] = T(inv_h0);
  a.inv_h[1] = T(inv_h1);
  a.alpha = T(alpha);
  a.beta = T(beta);
  a.gamma = T(gamma);
  a.accumulate = accumulate;
  if constexpr (kProgram) {
    a.needs_dt = needs_dt;
    a.tab = *tab;
    for (int d = 0; d < 2; ++d)
      a.vclass[d] = (axes[d] & 6) == 6 ? kByNode : (axes[d] & 2 ? kByRow : kByColumn);
  }
  const dim3 grid = adv_grid_2d(n0, n1);
  const auto kernel = stage_bwd_2d_kernel<T, kProgram>;
  const size_t smem = M::smem(kProgram, a.aux != nullptr);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(M::smem(kProgram, true)));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, M::NT, smem, static_cast<cudaStream_t>(stream_)>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // without dt, dcoef[3] is left as the caller zeroed it
  return static_cast<int>(launch_reduce<T>(a.part, nblocks(grid), kProgram && needs_dt, dcoef,
                                           static_cast<cudaStream_t>(stream_)));
}


// ---------------------------------------------------------------------------
// K3': cotangents of one K1' stage over a term table.
//
// Replaces the non-advection parts of the same TPU kernel: inside
// `_make_bwd_kernel` every normal-motion, curvature and eikonal term ran its
// own jax.vjp of lsm_tpu/ops/weno_v2.py `_ham_contribution`. Given the folded
// cotangent g (interior read), P, the optional aux and the table (the
// LsmStageTerms K1' reads, so forward and backward cannot disagree on a
// term), it writes
//   dP  (padded, every element): beta*g on the interior plus, for every
//       output y within reach of x, the cotangent -gamma*g[y]*dH(y)/dP[x] of
//       the normal, curvature and eikonal entries (advection entries are
//       skipped: K3 adds their share afterwards in accumulate mode);
//   dstream[e] for each streamed coefficient of those entries (optional);
//   daux = alpha*g on the interior (optional; K5 zeroes its shells);
//   dcoef = (sum g*aux, sum g*phi, -sum g*H, dt) over those entries, dt (K3'')
//   the sum over nodes of a program coefficient's cotangent times its
//   t-derivative (dual numbers at the centre output), when asked for.
// A program coefficient (K3'') is evaluated at each output's node in place
// of its stream.
// The tie rules are those of autodiff of the plain stage (torch.maximum /
// minimum split a tie 0.5/0.5, torch.where sends everything to the branch it
// took, safe_sqrt has derivative 0 at 0, minmod's goes to the argument it
// picked), so the kernel is held to autograd of the plain version.
//
// Design: each output's adjoint evaluated once into shared memory, then
// gathered. A block owns a column of CY x CX nodes in axes (1, 2) (16 x 32 in
// f32, 8 x 16 in f64; one thread each) and marches up axis 0 over a chunk of
// <= 64 planes (and 2 planes either side). At plane s, phase 1 evaluates the
// adjoint of every output of plane s over the column and a halo of 2 (20 x
// 36 positions in f32, less the 16 corners no gather reads) and keeps only
// the pieces the gather needs: for the Godunov kinds (normal motion,
// eikonal) the cotangents dA, dB of the ENO2 one-sided derivatives and
// their six minmod branches in one 16-bit word (26 B in f32); for curvature,
// over a halo of 1, the cotangents of its 3 central first, second and mixed
// differences (36 B). A thread's own output also sends at once, in registers,
// what it owes its own node on planes s-2 .. s+2 (axis 0, and the centre's
// direct part): dP of a thread's node accumulates over five planes. After a
// barrier, phase 2: every thread gathers from the plane's pieces what its
// node owes to the outputs around it in the plane, and (curvature's mixed
// differences across axes (0, 1) and (0, 2)) what its nodes on planes s-1
// and s+1 owe to them; dP of plane s-2 is then complete and written once. P
// comes through a ring of planes (s-2 .. s+3, slots mirrored so that five
// planes lie at one stride) and g through a ring of two, filled by cp.async
// one plane ahead; a table built once per block holds each unit's
// plane-invariant offsets. Adjoint evaluations per output: 704/512 x
// (chunk+4)/chunk = 1.47 for the Godunov kinds, 612/512 x (chunk+4)/chunk =
// 1.28 for curvature at 512^3 in f32 (1.87 and 1.50 in f64), against 13
// and 19 in the recompute form this replaces. Dynamic shared memory 94.2 KB
// in f32 (the P ring 37.5, the pieces 38.8, the table 11.3, g 5.6; less the
// pieces of a kind the table lacks), 61.9 KB in f64: two blocks of 16 warps
// per SM in f32 (64 registers). The pieces never leave the chip. No atomics;
// the partials go to per-block slots in double and one fixed-order
// reduction follows, so every run gives the same bits. Products and sums may
// contract into FMAs here, and in float the square roots and quotients are
// the hardware's approximations (tsqrt, qdiv): the f32 kernel is held to the
// f64 oracle at 1e-3, as before.
//
// Bound at 512^3 f32 (constant coefficients): read the padded P and the
// interior g, write the padded dP, 1.65 GB, 0.49 ms at 3.35 TB/s; a streamed
// speed adds its read and its cotangent's write. One adjoint per output and
// its gather weights are ~400 operations per node on config A (curvature +
// normal motion), 0.8 ms at 67 TFLOP/s: the operations bind, barely.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 8.7 ms on config A
// (88.95 in the recompute form), 7.3 on config C (45.50).

template <typename T>
struct TermsTile {
  static constexpr int CY = sizeof(T) == 4 ? 16 : 8, CX = sizeof(T) == 4 ? 32 : 16;
  static constexpr int NT = CY * CX;
  static constexpr int W = CX + 4, RP = (CY + 4) * W;   // a plane's outputs: halo 2
  static constexpr int WC = CX + 2, RC = (CY + 2) * WC;  // curvature's: halo 1
  static constexpr int TW = CX + 8, TP = (CY + 8) * TW;  // a plane of P: reach 4
  // P's planes s - 2 .. s + 3 in 6 slots, slots 0 .. 3 mirrored after them,
  // so that any 5 consecutive planes lie in consecutive slots; g's s, s + 1
  static constexpr int P_SLOTS = 6, P_RING = P_SLOTS + 4, G_SLOTS = 2;
  static constexpr int GOD_F = 6, CURV_F = 9;  // dA[3], dB[3]; dg[3], dhd[3], dhm[3]
  static constexpr int MIN_BLOCKS = 2;
};

template <typename T>
inline size_t terms_smem(bool god, bool curv) {
  using TL = TermsTile<T>;
  return TL::RP * 16 + (TL::P_RING * TL::TP + TL::G_SLOTS * TL::RP) * sizeof(T) +
         (god ? TL::RP * (TL::GOD_F * sizeof(T) + sizeof(uint16_t)) : 0) +
         (curv ? TL::RC * TL::CURV_F * sizeof(T) : 0);
}

// P around one output, from the ring of planes in shared memory: planes y - 2
// .. y + 2 lie `plane` apart from y0 (plane y - 2 at y's position), `row` the
// stride of axis 1
template <typename T>
struct Stencil {
  const T* y0;
  int plane, row;
  __device__ __forceinline__ T at(int o0, int o1, int o2) const {
    return y0[(o0 + 2) * plane + o1 * row + o2];
  }
  // offset o along axis d
  __device__ __forceinline__ T along(int d, int o) const {
    return d == 0 ? at(o, 0, 0) : (d == 1 ? at(0, o, 0) : at(0, 0, o));
  }
};

template <typename T>
inline dim3 terms_grid(const Geom& g) {
  using TL = TermsTile<T>;
  return dim3(static_cast<unsigned>((g.S[2] + TL::CX - 1) / TL::CX),
              static_cast<unsigned>((g.S[1] + TL::CY - 1) / TL::CY),
              static_cast<unsigned>(chunks_of(g.S[0])));
}

// The table's spacing constants, stage coefficients and constant
// coefficients rounded to T once, on the host
template <typename T>
struct TermConsts {
  T inv_h[3], half_h[3], inv_hh[3], inv_two_h[3], inv_hmix[3];
  T dx, alpha, beta, gamma;
  T value[LSM_MAX_TERMS];
  // the entries of the Godunov kinds (normal motion, eikonal) and of curvature
  int n_god, n_curv;
  int god[LSM_MAX_TERMS], curv[LSM_MAX_TERMS];
  static TermConsts of(const LsmStageTerms& p) {
    TermConsts c;
    c.n_god = c.n_curv = 0;
    for (int e = 0; e < p.n; ++e) {
      if (p.kind[e] == LSM_TERM_NORMAL || p.kind[e] == LSM_TERM_EIKONAL) c.god[c.n_god++] = e;
      if (p.kind[e] == LSM_TERM_CURVATURE) c.curv[c.n_curv++] = e;
    }
    for (int d = 0; d < 3; ++d) {
      c.inv_h[d] = T(p.inv_h[d]);
      c.half_h[d] = T(p.half_h[d]);
      c.inv_hh[d] = T(p.inv_hh[d]);
      c.inv_two_h[d] = T(p.inv_two_h[d]);
      c.inv_hmix[d] = T(p.inv_hmix[d]);
    }
    c.dx = T(p.dx_min);
    c.alpha = T(p.alpha);
    c.beta = T(p.beta);
    c.gamma = T(p.gamma);
    for (int e = 0; e < LSM_MAX_TERMS; ++e) c.value[e] = T(p.value[e]);
    return c;
  }
};

template <typename T>
struct TermsBwdArgs {
  const T* P;
  const T* g;
  const T* aux;  // may be null
  T* dP;
  T* daux;  // may be null
  double* part;
  T* dstream[LSM_MAX_TERMS];  // per table entry, its stream's cotangent or null
  Geom geo;
  int chunk;
  LsmStageTerms tab;
  TermConsts<T> k;
  int has_godunov, has_curvature;
  int needs_dt;  // K3'': the stage time's cotangent through program entries
};

// A program coefficient (K3''): entry e at the output whose padded
// coordinates are Y, with its t-derivative in *vdt when `dual`. Not inlined,
// so that the interpreter's registers and stack stay out of the adjoints of
// the streamed and constant coefficients.
template <typename T>
__device__ __noinline__ T program_coef(const LsmProgram& p, int e, const int* Y, bool dual,
                                       T* vdt) {
  const int64_t i0 = Y[0] - LSM_GHOST, i1 = Y[1] - LSM_GHOST, i2 = Y[2] - LSM_GHOST;
  return dual ? lsm::prog_eval<T, true>(p, e, 0, i0, i1, i2, vdt)
              : lsm::prog_eval<T, false>(p, e, 0, i0, i1, i2, nullptr);
}

// A scalar coefficient of entry e at the output whose padded coordinates are
// Y (q its interior index): streamed, constant or (kProgram: the table holds
// a program entry) a program. A table without programs takes the
// instantiation without the call, so K3' of streamed and constant
// coefficients keeps its registers.
template <typename T, bool kProgram>
__device__ __forceinline__ T coef_at(const TermsBwdArgs<T>& a, int e, int64_t q, const int* Y,
                                     bool dual, T* vdt) {
  const LsmStageTerms& p = a.tab;
  if (p.coef[e] == LSM_COEF_STREAM) return static_cast<const T*>(p.stream[e][0])[q];
  if (p.coef[e] == LSM_COEF_CONST) return a.k.value[e];
  if constexpr (kProgram) {
    if (p.coef[e] == LSM_COEF_PROGRAM) return program_coef<T>(p.prog, e, Y, dual, vdt);
  }
  return T(0);
}

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return a < b ? a : b;
}
// The square roots and quotients of K3': in float the hardware's
// approximations (MUFU, a few ulp, against the 1e-3 the f32 checks allow),
// in double IEEE
__device__ __forceinline__ float tsqrt(float x) { return x > 0.0f ? x * rsqrtf(x) : 0.0f; }
__device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float qdiv(float a, float b) { return __fdividef(a, b); }
__device__ __forceinline__ double qdiv(double a, double b) { return a / b; }
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

template <typename T>
struct EpsOf;
template <>
struct EpsOf<float> {
  static __device__ __forceinline__ float value() { return 1.1920928955078125e-07f; }
};
template <>
struct EpsOf<double> {
  static __device__ __forceinline__ double value() { return 2.220446049250313e-16; }
};

// minmod(x, y) and which argument it returned: 0 none (x*y <= 0), 1 x, 2 y
template <typename T>
__device__ __forceinline__ T minmod_sel(T x, T y, int& sel) {
  const bool same = x * y > T(0);
  const bool first = tabs(x) <= tabs(y);
  sel = same ? (first ? 1 : 2) : 0;
  return same ? (first ? x : y) : T(0);
}

// coefficient of offset k in the second difference centred at `centre`
template <typename T>
__device__ __forceinline__ T d2_coef(int centre, int k) {
  const int r = k - centre;
  return r == 0 ? T(-2) : ((r == 1 || r == -1) ? T(1) : T(0));
}

// The Godunov kinds (normal motion, eikonal) at one output: the cotangents
// of the ENO2 one-sided derivatives A_d, B_d and the minmod branches they
// took, the direct cotangent of the centre (the recomputed eikonal sign),
// and at the centre node H and the stream cotangents.
template <typename T>
struct GodAdj {
  T dA[3], dB[3];
  int sA[3], sB[3];
  T dc, ham, dt;  // dt: sum of the centre's coefficient cotangent times its d/dt
};

// S the P around y; Y the padded coordinates of y, q its interior index.
// kFirst the first axis (hamiltonians.cuh): 1 for the 2D entry, whose axis-0
// pieces are 0 and never read.
template <typename T, bool kProgram, int kFirst = 0>
__device__ void godunov_adjoint(const TermsBwdArgs<T>& a, const Stencil<T>& S, int64_t q,
                                const int* Y, T gbar, bool centre, GodAdj<T>& o) {
  const LsmStageTerms& p = a.tab;
  T A[3], B[3];
  T gp2 = T(0), gm2 = T(0);
  if constexpr (kFirst == 1) {
    A[0] = B[0] = T(0);
    o.sA[0] = o.sB[0] = 0;
  }
#pragma unroll
  for (int d = kFirst; d < 3; ++d) {
    const T inv_h = a.k.inv_h[d], half_h = a.k.half_h[d], inv_hh = a.k.inv_hh[d];
    const T m2 = S.along(d, -2), m1 = S.along(d, -1), c0 = S.at(0, 0, 0);
    const T p1 = S.along(d, 1), p2 = S.along(d, 2);
    const T d2c = (p1 - T(2) * c0 + m1) * inv_hh;
    const T d2mm = (m2 - T(2) * m1 + c0) * inv_hh;
    const T d2pp = (c0 - T(2) * p1 + p2) * inv_hh;
    A[d] = (c0 - m1) * inv_h + half_h * minmod_sel(d2mm, d2c, o.sA[d]);
    B[d] = (p1 - c0) * inv_h - half_h * minmod_sel(d2pp, d2c, o.sB[d]);
    const T ap = tmax(A[d], T(0)), an = tmin(A[d], T(0));
    const T bp = tmax(B[d], T(0)), bn = tmin(B[d], T(0));
    gp2 = gp2 + ap * ap + bn * bn;
    gm2 = gm2 + an * an + bp * bp;
  }
  const T gp = gp2 > T(0) ? tsqrt(gp2) : T(0);
  const T gm = gm2 > T(0) ? tsqrt(gm2) : T(0);
  T dgp = T(0), dgm = T(0), dc = T(0), ham = T(0), tsum = T(0);
  for (int i = 0; i < a.k.n_god; ++i) {
    const int e = a.k.god[i], kind = p.kind[e], coef = p.coef[e];
    const bool dual = kProgram && centre && a.needs_dt && coef == LSM_COEF_PROGRAM;
    T vdt = T(0);
    const T v = coef_at<T, kProgram>(a, e, q, Y, dual, &vdt);
    T dv = T(0);
    if (kind == LSM_TERM_NORMAL) {
      // H = max(v, 0) gp + min(v, 0) gm; a tie at v == 0 splits 0.5 / 0.5
      dgp = dgp + gbar * tmax(v, T(0));
      dgm = dgm + gbar * tmin(v, T(0));
      if (centre) {
        ham = ham + (tmax(v, T(0)) * gp + tmin(v, T(0)) * gm);
        dv = v > T(0) ? gbar * gp
                      : (v < T(0) ? gbar * gm : gbar * gp * T(0.5) + gbar * gm * T(0.5));
      }
    } else if (coef == LSM_COEF_NONE) {
      // s = phi / sqrt(phi^2 + norm^2 dx^2) (0 where that is 0), H = s (norm - 1)
      const T c0 = S.at(0, 0, 0), dx = a.k.dx;
      const bool up = c0 > T(0);
      const T norm = up ? gp : gm;
      const T denom = tsqrt(c0 * c0 + norm * norm * dx * dx);
      const T s = denom == T(0) ? T(0) : qdiv(c0, denom);
      const T ds = gbar * (norm - T(1));
      T dnorm = gbar * s;
      const T ddenom = denom == T(0) ? T(0) : qdiv(-ds * c0, denom * denom);
      if (denom != T(0)) dc = dc + qdiv(ds, denom);
      const T dX = qdiv(ddenom, T(2) * denom);  // 0/0 where denom == 0, as autodiff's
      dc = dc + dX * (T(2) * c0);
      dnorm = dnorm + dX * dx * dx * (T(2) * norm);
      if (up) dgp = dgp + dnorm;
      else dgm = dgm + dnorm;
      if (centre) ham = ham + s * (norm - T(1));
    } else {
      // frozen sign s = v: H = s (norm - 1), norm = |grad+| where s > 0
      const bool up = v > T(0);
      const T norm = up ? gp : gm;
      if (up) dgp = dgp + gbar * v;
      else dgm = dgm + gbar * v;
      if (centre) {
        ham = ham + v * (norm - T(1));
        dv = gbar * (norm - T(1));
      }
    }
    if (centre && coef == LSM_COEF_STREAM && a.dstream[e] != nullptr) a.dstream[e][q] = dv;
    if (dual) tsum = tsum + dv * vdt;
  }
  const T dgp2 = gp2 > T(0) ? qdiv(dgp, T(2) * gp) : T(0);
  const T dgm2 = gm2 > T(0) ? qdiv(dgm, T(2) * gm) : T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {  // (kFirst = 1: A[0] = B[0] = 0, so dA[0] = dB[0] = 0)
    o.dA[d] = A[d] > T(0) ? dgp2 * (T(2) * A[d]) : (A[d] < T(0) ? dgm2 * (T(2) * A[d]) : T(0));
    o.dB[d] = B[d] < T(0) ? dgp2 * (T(2) * B[d]) : (B[d] > T(0) ? dgm2 * (T(2) * B[d]) : T(0));
  }
  o.dc = dc;
  o.ham = ham;
  o.dt = tsum;
}

// what the Godunov kinds at y send to P[y + k e_d], k in -2..2 (the centre's
// direct part excluded), from y's pieces along d: dA, dB and their minmod
// branches sA, sB
template <typename T>
__device__ __forceinline__ T godunov_weight(T dA, T dB, int sA, int sB, const TermConsts<T>& c,
                                            int d, int k) {
  const T inv_h = c.inv_h[d], half_h = c.half_h[d], inv_hh = c.inv_hh[d];
  T w = T(0);
  // A = (c0 - m1)/h + h/2 minmod(D2--, D2_0); B = (p1 - c0)/h - h/2 minmod(D2++, D2_0)
  if (k == 0) w = w + dA * inv_h - dB * inv_h;
  if (k == -1) w = w - dA * inv_h;
  if (k == 1) w = w + dB * inv_h;
  if (sA != 0) w = w + dA * half_h * inv_hh * d2_coef<T>(sA == 1 ? -1 : 0, k);
  if (sB != 0) w = w - dB * half_h * inv_hh * d2_coef<T>(sB == 1 ? 1 : 0, k);
  return w;
}

// Curvature b kappa |grad phi| at one output: the cotangents of its 3
// central first, 3 second and 3 mixed differences, and at the centre node H
// and the stream cotangents.
template <typename T>
struct CurvAdj {
  T dg[3], dhd[3], dhm[3];
  T ham, dt;
};

// kFirst = 1 (the 2D entry): the 3D sums without their axis-0 terms, as
// hamiltonians.cuh's curvature; the axis-0 pieces are 0.
template <typename T, bool kProgram, int kFirst = 0>
__device__ void curvature_adjoint(const TermsBwdArgs<T>& a, const Stencil<T>& S, int64_t q,
                                  const int* Y, T gbar, bool centre, CurvAdj<T>& o) {
  const LsmStageTerms& p = a.tab;
  const int pair[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  const T c0 = S.at(0, 0, 0);
  T g[3], hd[3], hm[3];
  if constexpr (kFirst == 1) g[0] = hd[0] = hm[0] = hm[1] = T(0);
#pragma unroll
  for (int d = kFirst; d < 3; ++d) {
    const T plus = S.along(d, 1), minus = S.along(d, -1);
    g[d] = (plus - minus) * a.k.inv_two_h[d];
    hd[d] = (plus - T(2) * c0 + minus) * a.k.inv_hh[d];
  }
#pragma unroll
  for (int k = kFirst == 1 ? 2 : 0; k < 3; ++k) {
    // the edge neighbour (sa, sb) along the axis pair
    auto edge = [&](int sa, int sb) {
      int off[3] = {0, 0, 0};
      off[pair[k][0]] += sa;
      off[pair[k][1]] += sb;
      return S.at(off[0], off[1], off[2]);
    };
    hm[k] = (edge(1, 1) - edge(1, -1) - edge(-1, 1) + edge(-1, -1)) * a.k.inv_hmix[k];
  }
  T nrmsq, lap, quad;
  if constexpr (kFirst == 1) {
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
  const bool safe = nrmsq >= EpsOf<T>::value();
  const T ns = safe ? nrmsq : T(1);
  const T root = tsqrt(ns);
  const T D = ns * root;
  const T inv_D = qdiv(T(1), D);  // one reciprocal for the quotients by D
  const T N = lap * ns - quad;
  const T kr = N * inv_D;
  const T kap = safe ? kr : T(0);
  const T nrm = safe ? root : (nrmsq > T(0) ? tsqrt(nrmsq) : T(0));
  T dkap = T(0), dnrm = T(0), ham = T(0), tsum = T(0);
  for (int i = 0; i < a.k.n_curv; ++i) {
    const int e = a.k.curv[i];
    const bool stream = p.coef[e] == LSM_COEF_STREAM;
    const bool dual = kProgram && centre && a.needs_dt && p.coef[e] == LSM_COEF_PROGRAM;
    T bdt = T(0);
    const T b = coef_at<T, kProgram>(a, e, q, Y, dual, &bdt);
    // H = (b kappa) |grad|
    dkap = dkap + gbar * nrm * b;
    dnrm = dnrm + gbar * (b * kap);
    if (centre) {
      ham = ham + b * kap * nrm;
      if (stream && a.dstream[e] != nullptr) a.dstream[e][q] = gbar * nrm * kap;
      if (dual) tsum = tsum + (gbar * nrm * kap) * bdt;
    }
  }
  const T dK = safe ? dkap : T(0);
  const T dN = dK * inv_D;
  const T dD = -dN * kr;  // -dK N / D^2
  const T dns = dN * lap + dD * (T(1.5) * root);
  const T dlap = dN * ns;
  const T dquad = -dN;
  const T dnrmsq = (safe ? dns : T(0)) + (nrmsq > T(0) ? qdiv(dnrm, T(2) * nrm) : T(0));
  if constexpr (kFirst == 1) o.dhd[0] = o.dg[0] = o.dhm[0] = o.dhm[1] = T(0);
#pragma unroll
  for (int d = kFirst; d < 3; ++d) {
    o.dhd[d] = dquad * (g[d] * g[d]) + dlap;
    T dgd = dquad * (T(2) * g[d] * hd[d]);
#pragma unroll
    for (int k = kFirst == 1 ? 2 : 0; k < 3; ++k) {
      const int i = pair[k][0], j = pair[k][1];
      if (i == d) dgd = dgd + dquad * (T(2) * g[j] * hm[k]);
      if (j == d) dgd = dgd + dquad * (T(2) * g[i] * hm[k]);
    }
    o.dg[d] = dgd + (T(2) * g[d]) * dnrmsq;
  }
#pragma unroll
  for (int k = kFirst == 1 ? 2 : 0; k < 3; ++k)
    o.dhm[k] = dquad * (T(2) * g[pair[k][0]] * g[pair[k][1]]);
  o.ham = ham;
  o.dt = tsum;
}

// Phase 1's unit e of a K3' block, plane-invariant, built once per block:
// its position (jj, kk) in a plane of outputs (RP = (CY + 4) x W, the column
// at jj, kk in [2, CY + 2) x [2, CX + 2)), the column's positions first (unit
// e = thread e: its own node), then the halo. x = jj * W + kk | (its
// position in curvature's plane + 1, or 0 off it) << 16; y = its offset in
// a plane of the P ring | jj << 16 | kk << 24; z = (Yj - 3) * n2 + (Yk - 3),
// or -1 off the interior in the plane; w = whether the Godunov gather reads
// its pieces.
template <typename TL>
__device__ __forceinline__ int4 terms_unit(int e, int j0, int k0, const Geom& G) {
  constexpr int W = TL::W;
  int jj, kk;
  if (e < TL::NT) {
    jj = e / TL::CX + 2;
    kk = e % TL::CX + 2;
  } else if (e - TL::NT < 4 * W) {  // two rows above the column, two below
    const int h = e - TL::NT;
    jj = h < 2 * W ? h / W : TL::CY + h / W;
    kk = h % W;
  } else {  // two lanes on each side
    const int h = e - TL::NT - 4 * W;
    jj = 2 + h / 4;
    const int c = h % 4;
    kk = c < 2 ? c : TL::CX + c;
  }
  const int Yj = j0 + jj - 2, Yk = k0 + kk - 2;
  const bool c1 = jj >= 1 && jj <= TL::CY + 2 && kk >= 1 && kk <= TL::CX + 2;
  // the Godunov gather reads along one axis: a corner's pieces are never read
  const bool god = (jj >= 2 && jj < TL::CY + 2) || (kk >= 2 && kk < TL::CX + 2);
  const bool in = inside(Yj, G.n[1]) && inside(Yk, G.n[2]);
  return make_int4((jj * W + kk) | ((c1 ? (jj - 1) * TL::WC + kk : 0) << 16),
                   ((jj + 2) * TL::TW + kk + 2) | (jj << 16) | (kk << 24),
                   in ? (Yj - LSM_GHOST) * G.n[2] + (Yk - LSM_GHOST) : -1, god);
}

// Phase 1 of a K3' block at one output y (unit `un`, whose Godunov and
// curvature positions it holds; S the P around y, Y its padded coordinates,
// q its interior index, g its cotangent): the pieces of the gather into the
// buffers gb, cb and sb_ of the plane (the row: TL's field strides RP, RC)
// (0 off the interior). `own` (the unit of this thread's node): what y sends
// its own node, into acc[0], and along the march's axis kFirst (axis 0 in
// 3D; the 2D entry, whose axis 0 is compiled out, marches along axis 1) into
// acc[-2 .. 2], the node on the planes (rows) y - 2 .. y + 2; `centre`: its
// g*H and dt into the partial sums.
template <typename T, bool kProgram, int kFirst, typename TL = TermsTile<T>>
__device__ __forceinline__ void terms_pieces(const TermsBwdArgs<T>& a, const Stencil<T>& S,
                                             int64_t q, const int* Y, T g, int4 un, bool in,
                                             bool own, bool centre, T* gb, T* cb, uint16_t* sb_,
                                             T* acc, double& sg, double& st_) {
  constexpr int RP = TL::RP, RC = TL::RC;
  const TermConsts<T>& kc = a.k;
  const int pos = un.x & 0xffff, cpos1 = un.x >> 16;
  const T gbar = -kc.gamma * g;
  if (a.has_godunov && un.w) {
    if (in) {
      GodAdj<T> o;
      godunov_adjoint<T, kProgram, kFirst>(a, S, q, Y, gbar, centre, o);
      int bits = 0;
#pragma unroll
      for (int d = kFirst; d < 3; ++d) {
        gb[d * RP + pos] = o.dA[d];
        gb[(3 + d) * RP + pos] = o.dB[d];
        bits |= (o.sA[d] | (o.sB[d] << 2)) << (4 * d);
      }
      sb_[pos] = static_cast<uint16_t>(bits);
      if (own) {
        T w = godunov_weight<T>(o.dA[kFirst], o.dB[kFirst], o.sA[kFirst], o.sB[kFirst], kc,
                                kFirst, 0);
#pragma unroll
        for (int d = kFirst + 1; d < 3; ++d)
          w = w + godunov_weight<T>(o.dA[d], o.dB[d], o.sA[d], o.sB[d], kc, d, 0);
        acc[0] = acc[0] + (w + o.dc);
#pragma unroll
        for (int kq = -2; kq <= 2; ++kq)
          if (kq != 0)
            acc[kq] = acc[kq] + godunov_weight<T>(o.dA[kFirst], o.dB[kFirst], o.sA[kFirst],
                                                  o.sB[kFirst], kc, kFirst, kq);
      }
      if (centre) {
        sg += double(g) * double(o.ham);
        st_ += double(o.dt);
      }
    } else {
#pragma unroll
      for (int f6 = 0; f6 < TL::GOD_F; ++f6) gb[f6 * RP + pos] = T(0);
      sb_[pos] = 0;
    }
  }
  // curvature reaches 1: its pieces over the column and a halo of 1
  if (a.has_curvature && cpos1 > 0) {
    const int cpos = cpos1 - 1;
    if (in) {
      CurvAdj<T> o;
      curvature_adjoint<T, kProgram, kFirst>(a, S, q, Y, gbar, centre, o);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        cb[d * RC + cpos] = o.dg[d];
        cb[(3 + d) * RC + cpos] = o.dhd[d];
        cb[(6 + d) * RC + cpos] = o.dhm[d];
      }
      if (own) {
        T h = o.dhd[kFirst] * kc.inv_hh[kFirst];
#pragma unroll
        for (int d = kFirst + 1; d < 3; ++d) h = h + o.dhd[d] * kc.inv_hh[d];
        acc[0] = acc[0] - T(2) * h;
        const T dg = o.dg[kFirst] * kc.inv_two_h[kFirst], dh = o.dhd[kFirst] * kc.inv_hh[kFirst];
        acc[1] = acc[1] + (dg + dh);    // the node at y + 1 reads y as its -1
        acc[-1] = acc[-1] + (-dg + dh);  // the node at y - 1 as its +1
      }
      if (centre) {
        sg += double(g) * double(o.ham);
        st_ += double(o.dt);
      }
    } else {
#pragma unroll
      for (int f9 = 0; f9 < TL::CURV_F; ++f9) cb[f9 * RC + cpos] = T(0);
    }
  }
}

// Phase 2 of a K3' block: what the outputs around this thread's node in the
// plane (the row) send to it along the axes after the march's axis kFirst
// (their pieces in gb, sb_, cb), into acc[0]; and, across the edges of the
// axis pairs with the march's axis ((0, 1) and (0, 2) in 3D, (1, 2) in the
// 2D entry), what they send its nodes on the planes (rows) either side, into
// acc[-1] and acc[1].
template <typename T, int kFirst, typename TL = TermsTile<T>>
__device__ __forceinline__ void terms_gather(const TermConsts<T>& kc, bool god, bool curv,
                                             const T* gb, const uint16_t* sb_, const T* cb,
                                             int own_pos, int own_c, T* acc) {
  constexpr int RP = TL::RP, RC = TL::RC;
  const int dpos[3] = {0, TL::W, 1}, dcpos[3] = {0, TL::WC, 1};
#pragma unroll
  for (int d = kFirst + 1; d < 3; ++d) {
#pragma unroll
    for (int kk = -2; kk <= 2; ++kk) {
      if (kk == 0) continue;
      const bool near = kk == 1 || kk == -1;
      if (!god && !near) continue;
      // (the pieces of an output off the interior are 0)
      if (god) {
        const int pos = own_pos - kk * dpos[d], bits = sb_[pos] >> (4 * d);
        acc[0] = acc[0] + godunov_weight<T>(gb[d * RP + pos], gb[(3 + d) * RP + pos], bits & 3,
                                            (bits >> 2) & 3, kc, d, kk);
      }
      if (curv && near) {
        const int cpos = own_c - kk * dcpos[d];
        const T dg = cb[d * RC + cpos] * kc.inv_two_h[d];
        acc[0] = acc[0] + ((kk == 1 ? dg : -dg) + cb[(3 + d) * RC + cpos] * kc.inv_hh[d]);
      }
    }
  }
  if (curv) {
    // the mixed differences: y = x - sa e_da - sb e_db with y in the plane, x
    // on the plane sa away when da is the march's axis
    const int pair[3][2] = {{0, 1}, {0, 2}, {1, 2}};
#pragma unroll
    for (int m = kFirst == 0 ? 0 : 2; m < 3; ++m) {
      const int da = pair[m][0], db = pair[m][1];
#pragma unroll
      for (int sa_ = -1; sa_ <= 1; sa_ += 2) {
#pragma unroll
        for (int sb2 = -1; sb2 <= 1; sb2 += 2) {
          const int cpos = own_c - (da != kFirst ? sa_ * dcpos[da] : 0) - sb2 * dcpos[db];
          const T w = cb[(6 + m) * RC + cpos] * kc.inv_hmix[m];
          const int at = da == kFirst ? sa_ : 0;
          acc[at] = acc[at] + (sa_ * sb2 > 0 ? w : -w);
        }
      }
    }
  }
}

template <typename T, bool kProgram>
__global__ void __launch_bounds__(TermsTile<T>::NT, TermsTile<T>::MIN_BLOCKS)
    stage_bwd_terms_kernel(const __grid_constant__ TermsBwdArgs<T> a) {
  using TL = TermsTile<T>;
  constexpr int CX = TL::CX, NT = TL::NT, W = TL::W, RP = TL::RP, WC = TL::WC, RC = TL::RC;
  constexpr int TW = TL::TW, TP = TL::TP;
  extern __shared__ __align__(16) unsigned char lsm_dyn_smem[];
  __shared__ double red[4][NT / 32];
  const Geom& G = a.geo;
  const LsmStageTerms& p = a.tab;
  const bool god = a.has_godunov, curv = a.has_curvature;
  // shared memory: the units' table, the ring of P's planes, the ring of g's
  // (at the outputs' positions), the Godunov and curvature pieces of a plane
  // (field-major), the Godunov minmod branches
  int4* const units = reinterpret_cast<int4*>(lsm_dyn_smem);
  T* const ring = reinterpret_cast<T*>(units + RP);
  T* const gring = ring + TL::P_RING * TP;
  T* const gp_ = gring + TL::G_SLOTS * RP;
  T* const cp_ = gp_ + (god ? TL::GOD_F * RP : 0);
  uint16_t* const sel = reinterpret_cast<uint16_t*>(cp_ + (curv ? TL::CURV_F * RC : 0));
  auto pslot = [](int plane) { return (plane + 2 * TL::P_SLOTS) % TL::P_SLOTS * TP; };
  auto gslot = [](int plane) { return (plane + 2 * TL::G_SLOTS) % TL::G_SLOTS * RP; };
  const int t = threadIdx.x;
  const int j0 = blockIdx.y * TL::CY, k0 = blockIdx.x * CX;
  const int j = j0 + t / CX, k = k0 + t % CX;  // this thread's node in the column
  const int own_pos = (t / CX + 2) * W + t % CX + 2, own_c = (t / CX + 1) * WC + t % CX + 1;
  const int own_p = (t / CX + 4) * TW + t % CX + 4;
  const int i0 = blockIdx.z * a.chunk, i1 = min(i0 + a.chunk, G.S[0]);
  const TermConsts<T>& kc = a.k;
  for (int e = t; e < RP; e += NT) units[e] = terms_unit<TL>(e, j0, k0, G);
  // plane `plane` of P over the column and a reach of 4, asynchronously
  auto load_plane = [&](int plane) {
    T* const dst = ring + pslot(plane);
    const bool mirror = pslot(plane) < (TL::P_RING - TL::P_SLOTS) * TP;
    for (int e = t; e < TP; e += NT) {
      const int jj = j0 - 4 + e / TW, kk = k0 - 4 + e % TW;
      const bool in = plane >= 0 && plane < G.S[0] && jj >= 0 && jj < G.S[1] && kk >= 0 &&
                      kk < G.S[2];
      const T* const src = a.P + (in ? pidx(G, plane, jj, kk) : 0);
      copy_async(dst + e, src, in);
      if (mirror) copy_async(dst + TL::P_SLOTS * TP + e, src, in);
    }
  };
  // plane `plane` of g at the outputs' positions (0 off the interior)
  auto load_g = [&](int plane) {
    T* const dst = gring + gslot(plane);
    for (int e = t; e < RP; e += NT) {
      const int Yj = j0 + e / W - 2, Yk = k0 + e % W - 2;
      const bool in = interior(G, plane, Yj, Yk);
      copy_async(dst + e, a.g + (in ? pidx(G, plane, Yj, Yk) : 0), in);
    }
  };
  double sg = 0.0, sb = 0.0, sa = 0.0, st_ = 0.0;
  // dP of this thread's node on planes s - 2 .. s + 2, gathered as the pieces
  // of plane s come: on planes s -+ 1, s -+ 2 from its own output (axis 0),
  // on s from the outputs around it in the plane, on s -+ 1 from the edges
  // across the axis pairs (0, 1), (0, 2)
  T acc[5] = {};
  const int s0 = i0 - 2, s1 = i1 + 2;  // the planes whose pieces this chunk needs
  for (int plane = s0 - 2; plane <= s0 + 2; ++plane) load_plane(plane);
  load_g(s0);
  async_commit();
  for (int s = s0; s < s1; ++s) {
    async_wait();
    __syncthreads();  // P's planes s - 2 .. s + 2 and g's plane s are in
    load_plane(s + 3);
    load_g(s + 1);
    async_commit();
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = acc[q + 1];
    acc[4] = T(0);
    const T* const gs = gring + gslot(s);
    // phase 1: the pieces of plane s's outputs over the column and a halo
    // of 2 (Godunov) or 1 (curvature); a thread's own output first (the
    // previous plane's readers passed the barrier above)
    const bool in_s = inside(s, G.n[0]);
    const int64_t qs = int64_t(s - LSM_GHOST) * G.m12;
    const T* const planes = ring + pslot(s - 2);  // planes s - 2 .. s + 2, TP apart
    for (int e = t; e < RP; e += NT) {
      const int4 un = units[e];
      const int Y[3] = {s, j0 + (un.y >> 16 & 0xff) - 2, k0 + (un.y >> 24) - 2};
      const bool own = e < NT, in = in_s && un.z >= 0;
      const Stencil<T> S{planes + (un.y & 0xffff), TP, TW};
      terms_pieces<T, kProgram, 0>(a, S, qs + un.z, Y, gs[un.x & 0xffff], un, in, own,
                                   own && in && s >= i0 && s < i1, gp_, cp_, sel, acc + 2, sg,
                                   st_);
    }
    __syncthreads();  // plane s's pieces are in
    // phase 2: what the outputs around this thread's node in plane s send to
    // it (on plane s) and, across the edges, to its nodes on planes s -+ 1
    if (j < G.S[1] && k < G.S[2]) {
      terms_gather<T, 0>(kc, god, curv, gp_, sel, cp_, own_pos, own_c, acc + 2);
      // dP of plane s - 2 is complete
      const int i = s - 2;
      if (i >= i0 && i < i1) {
        const int64_t x = pidx(G, i, j, k);
        T v = acc[0];
        if (interior(G, i, j, k)) {
          const T gv = a.g[x];
          v = kc.beta * gv + v;
          if (a.daux != nullptr) a.daux[x] = kc.alpha * gv;
          sb += double(gv) * double(ring[pslot(i) + own_p]);
          if (a.aux != nullptr) sa += double(gv) * double(a.aux[x]);
        }
        a.dP[x] = v;
      }
    }
  }
  async_wait();
  __syncthreads();
  sg = block_sum<NT>(sg, red[0]);
  sb = block_sum<NT>(sb, red[1]);
  sa = block_sum<NT>(sa, red[2]);
  st_ = block_sum<NT>(st_, red[3]);
  if (t == 0) {
    const int64_t bid = int64_t(blockIdx.x) + int64_t(gridDim.x) *
                        (int64_t(blockIdx.y) + int64_t(gridDim.y) * blockIdx.z);
    a.part[4 * bid] = sg;
    a.part[4 * bid + 1] = sb;
    a.part[4 * bid + 2] = sa;
    a.part[4 * bid + 3] = st_;
  }
}

// K3''s 2D entry (lsm_stage_bwd_terms_2d_*): the adjoint of K1''s 2D stage
// (the embedding's function with axis 0 compiled out, hamiltonians.cuh with
// kFirst = 1) on a 2D field's (n0+6, n1+6) layout, whose axes 0 and 1 take
// the places of axes 1 and 2 above (make_geom_2d). The 3D kernel's march
// with its axis 1 compiled out: a block of NT threads marches up a chunk of
// <= 64 padded rows (and 2 rows either side), thread t at the padded column
// k0 - 2 + t; the block owns the NT - 4 columns of threads 2 .. NT - 3, the
// others are their halo of 2 (1 for curvature). At row s, phase 1 evaluates
// the pieces of the output of each thread's column, one pass of the block
// (terms_pieces, kFirst = 1: the 2D axis 0 is the march's), and a thread's
// own output sends what it owes its own node on rows s - 2 .. s + 2 in
// registers; after a barrier, phase 2 gathers along the row from row s's
// pieces and curvature's mixed differences into rows s -+ 1 (terms_gather);
// dP of row s - 2 is then complete and written once, its g, P and aux from
// shared memory. P comes through a ring of rows (s - 2 .. s + 3, mirrored so
// that five rows lie at one stride), g (s - 2 .. s + 1) and aux (s - 2, s -
// 1) through rings of their own, by cp.async one row ahead. Adjoints per
// output NT/(NT - 4) x (chunk + 4)/chunk, 1.10 at 4096^2 (a halo of 4 units
// a row as a second pass of warp 0 measured 13% slower: PERF.md section 6,
// the 2D marches' entry). Shared memory 16.2 KB in f32 with both kinds'
// pieces. Four blocks an SM (128 registers) measured 4-5% faster than eight
// (64) in f32; with a program coefficient eight, though it spills, 11-13%
// faster than four (PERF.md section 6, the 2D marches' entry). An advection
// term's share is K3's 2D entry in accumulate mode, as in 3D.
template <typename T>
struct TermsMarch2D {
  static constexpr int NT = 128, OWN = NT - 4, MIN_BLOCKS = 4;
  static constexpr int MIN_BLOCKS_PROG = sizeof(T) == 4 ? 8 : 4;  // with a program coefficient
  static constexpr int W = NT, RP = W;        // a row's outputs: the threads' columns
  static constexpr int WC = NT - 2, RC = WC;  // curvature's: the owned and a halo of 1
  static constexpr int TW = NT + 4;           // a row of P: reach 2 past the threads'
  // P's rows s - 2 .. s + 3 (mirrored as in 3D); g's s - 2 .. s + 1 at the
  // threads' columns; aux's s - 2, s - 1
  static constexpr int P_SLOTS = 6, P_RING = P_SLOTS + 4, G_SLOTS = 4, A_SLOTS = 2;
  static constexpr int GOD_F = TermsTile<T>::GOD_F, CURV_F = TermsTile<T>::CURV_F;
};

template <typename T, bool kProgram>
__global__ void __launch_bounds__(TermsMarch2D<T>::NT, kProgram
                                                             ? TermsMarch2D<T>::MIN_BLOCKS_PROG
                                                             : TermsMarch2D<T>::MIN_BLOCKS)
    stage_bwd_terms_2d_kernel(const __grid_constant__ TermsBwdArgs<T> a) {
  using TL = TermsMarch2D<T>;
  constexpr int NT = TL::NT, RP = TL::RP, TW = TL::TW, H = LSM_GHOST;
  extern __shared__ __align__(16) unsigned char lsm_dyn_smem[];
  __shared__ double red[4][NT / 32];
  const Geom& G = a.geo;  // axis 1: the 2D rows (S[1], n[1]); axis 2: the columns
  const bool god = a.has_godunov, curv = a.has_curvature;
  // shared memory: the ring of P's rows, the ring of g's, the ring of aux's,
  // the Godunov and curvature pieces of a row (field-major), the Godunov
  // minmod branches
  T* const ring = reinterpret_cast<T*>(lsm_dyn_smem);
  T* const gring = ring + TL::P_RING * TW;
  T* const aring = gring + TL::G_SLOTS * RP;
  T* const gp_ = aring + TL::A_SLOTS * NT;
  T* const cp_ = gp_ + (god ? TL::GOD_F * RP : 0);
  uint16_t* const sel = reinterpret_cast<uint16_t*>(cp_ + (curv ? TL::CURV_F * TL::RC : 0));
  auto pslot = [](int row) { return (row + 2 * TL::P_SLOTS) % TL::P_SLOTS * TW; };
  auto gslot = [](int row) { return (row + 2 * TL::G_SLOTS) % TL::G_SLOTS * RP; };
  auto aslot = [](int row) { return (row + 2 * TL::A_SLOTS) % TL::A_SLOTS * NT; };
  const int t = threadIdx.x, k0 = blockIdx.x * TL::OWN, k = k0 - 2 + t;  // this thread's column
  const bool own = t >= 2 && t < NT - 2 && k < G.S[2];  // a column this block owns
  const bool kin = inside(k, G.n[2]);
  const int i0 = blockIdx.y * a.chunk, i1 = min(i0 + a.chunk, G.S[1]);
  const TermConsts<T>& kc = a.k;
  // row `row` of P over the threads' columns and a reach of 2, asynchronously
  auto load_row = [&](int row) {
    T* const dst = ring + pslot(row);
    const bool mirror = pslot(row) < (TL::P_RING - TL::P_SLOTS) * TW;
    for (int e = t; e < TW; e += NT) {
      const int kk = k0 - 4 + e;
      const bool in = row >= 0 && row < G.S[1] && kk >= 0 && kk < G.S[2];
      const T* const src = a.P + (in ? pidx(G, 0, row, kk) : 0);
      copy_async(dst + e, src, in);
      if (mirror) copy_async(dst + TL::P_SLOTS * TW + e, src, in);
    }
  };
  // row `row` of g (0 off the interior) and of aux at the threads' columns
  auto load_g = [&](int row) {
    const bool in = inside(row, G.n[1]) && kin;
    copy_async(gring + gslot(row) + t, a.g + (in ? pidx(G, 0, row, k) : 0), in);
  };
  auto load_aux = [&](int row) {
    const bool in = inside(row, G.n[1]) && kin;
    copy_async(aring + aslot(row) + t, a.aux + (in ? pidx(G, 0, row, k) : 0), in);
  };
  double sg = 0.0, sb = 0.0, sa = 0.0, st_ = 0.0;
  // dP of this thread's node on rows s - 2 .. s + 2, gathered as the pieces
  // of row s come
  T acc[5] = {};
  const int s0 = i0 - 2, s1 = i1 + 2;  // the rows whose pieces this chunk needs
  for (int row = s0 - 2; row <= s0 + 2; ++row) load_row(row);
  load_g(s0);
  async_commit();
  // this thread's unit: its position in the row's pieces (curvature's + 1,
  // or 0 off its halo of 1); the gather reads every position's Godunov pieces
  const int4 un = make_int4(t | ((t >= 1 && t < NT - 1 ? t : 0) << 16), 0, 0, 1);
  for (int s = s0; s < s1; ++s) {
    async_wait();
    __syncthreads();  // P's rows s - 2 .. s + 2, g's row s (and aux's s - 2) are in
    load_row(s + 3);
    load_g(s + 1);
    if (a.aux != nullptr) load_aux(s - 1);
    async_commit();
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = acc[q + 1];
    acc[4] = T(0);
    const bool in = inside(s, G.n[1]) && kin;
    const T* const rows = ring + pslot(s - 2);  // rows s - 2 .. s + 2, TW apart
    // phase 1: the pieces of the output (s, k)
    const int Y[3] = {H, s, k};  // the embedding's node: axis-0 index 0
    const Stencil<T> S{rows + 2 * TW + t + 2, 0, TW};
    terms_pieces<T, kProgram, 1, TL>(a, S, int64_t(s - H) * G.n[2] + (k - H), Y,
                                     gring[gslot(s) + t], un, in, own,
                                     own && in && s >= i0 && s < i1, gp_, cp_, sel, acc + 2, sg,
                                     st_);
    __syncthreads();  // row s's pieces are in
    // phase 2: what the outputs around this thread's node in row s send to
    // it (on row s) and, across the edges, to its nodes on rows s -+ 1
    if (own) {
      terms_gather<T, 1, TL>(kc, god, curv, gp_, sel, cp_, t, t - 1, acc + 2);
      // dP of row s - 2 is complete
      const int i = s - 2;
      if (i >= i0 && i < i1) {
        const int64_t x = pidx(G, 0, i, k);
        T v = acc[0];
        if (inside(i, G.n[1]) && kin) {  // g, P and aux from the rings
          const T gv = gring[gslot(i) + t];
          v = kc.beta * gv + v;
          if (a.daux != nullptr) a.daux[x] = kc.alpha * gv;
          sb += double(gv) * double(ring[pslot(i) + t + 2]);
          if (a.aux != nullptr) sa += double(gv) * double(aring[aslot(i) + t]);
        }
        a.dP[x] = v;
      }
    }
  }
  async_wait();
  __syncthreads();
  sg = block_sum<NT>(sg, red[0]);
  sb = block_sum<NT>(sb, red[1]);
  sa = block_sum<NT>(sa, red[2]);
  st_ = block_sum<NT>(st_, red[3]);
  if (t == 0) {
    const int64_t bid = int64_t(blockIdx.x) + int64_t(gridDim.x) * int64_t(blockIdx.y);
    a.part[4 * bid] = sg;
    a.part[4 * bid + 1] = sb;
    a.part[4 * bid + 2] = sa;
    a.part[4 * bid + 3] = st_;
  }
}

template <typename T>
inline size_t terms_smem_2d(bool god, bool curv) {
  using TL = TermsMarch2D<T>;
  return (TL::P_RING * TL::TW + TL::G_SLOTS * TL::RP + TL::A_SLOTS * TL::NT) * sizeof(T) +
         (god ? TL::RP * (TL::GOD_F * sizeof(T) + sizeof(uint16_t)) : 0) +
         (curv ? TL::RC * TL::CURV_F * sizeof(T) : 0);
}

inline dim3 terms_grid_2d(const Geom& g) {
  return dim3(static_cast<unsigned>((g.S[2] + TermsMarch2D<float>::OWN - 1) /
                                    TermsMarch2D<float>::OWN),
              static_cast<unsigned>(chunks_of(g.S[1])));
}

// k2D: the 2D entry, (n0, n1, n2) = (1, the 2D field's n0, n1)
template <typename T, bool k2D = false>
int launch_stage_bwd_terms(
const void* P, const void* g, const void* aux, void* dP, void* daux,
                           void* part, void* dcoef, int64_t n0, int64_t n1, int64_t n2,
                           const LsmStageTerms* terms, const void* const* dstreams,
                           int needs_dt, void* stream_) {
  if (terms->n < 1 || terms->n > LSM_MAX_TERMS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  TermsBwdArgs<T> a;
  a.P = static_cast<const T*>(P);
  a.g = static_cast<const T*>(g);
  a.aux = static_cast<const T*>(aux);
  a.dP = static_cast<T*>(dP);
  a.daux = static_cast<T*>(daux);
  a.part = static_cast<double*>(part);
  a.geo = k2D ? make_geom_2d(n1, n2) : make_geom(n0, n1, n2);
  a.chunk = chunk_len(a.geo.S[k2D ? 1 : 0]);  // the march's axis
  a.tab = *terms;
  a.k = TermConsts<T>::of(*terms);
  a.has_godunov = 0;
  a.has_curvature = 0;
  a.needs_dt = needs_dt;
  bool program = false;
  for (int e = 0; e < LSM_MAX_TERMS; ++e) {
    a.dstream[e] = e < terms->n ? static_cast<T*>(const_cast<void*>(dstreams[e])) : nullptr;
    if (e < terms->n && terms->coef[e] == LSM_COEF_PROGRAM &&
        terms->kind[e] != LSM_TERM_ADVECTION)
      program = true;
  }
  a.has_godunov = a.k.n_god > 0;
  a.has_curvature = a.k.n_curv > 0;
  const dim3 grid = k2D ? terms_grid_2d(a.geo) : terms_grid<T>(a.geo);
  const auto kernel =
      k2D ? (program ? stage_bwd_terms_2d_kernel<T, true> : stage_bwd_terms_2d_kernel<T, false>)
          : (program ? stage_bwd_terms_kernel<T, true> : stage_bwd_terms_kernel<T, false>);
  const size_t smem = k2D ? terms_smem_2d<T>(a.has_godunov, a.has_curvature)
                          : terms_smem<T>(a.has_godunov, a.has_curvature);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, k2D ? TermsMarch2D<T>::NT : TermsTile<T>::NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce<T>(a.part, nblocks(grid), true, dcoef, stream));
}

}  // namespace

// scratch doubles: four per block of the larger grid (f64's)
extern "C" int64_t lsm_stage_bwd_scratch(int64_t n0, int64_t n1, int64_t n2) {
  return 4 * nblocks(adv_grid<double>(make_geom(n0, n1, n2)));
}

extern "C" int lsm_stage_bwd_f32(const void* P, const void* g, const void* u0, const void* u1,
                                 const void* u2, const void* aux, void* dP, void* du0,
                                 void* du1, void* du2, void* daux, void* part, void* dcoef,
                                 int64_t n0, int64_t n1, int64_t n2, double inv_h0,
                                 double inv_h1, double inv_h2, double alpha, double beta,
                                 double gamma, int accumulate, void* stream) {
  const void* u[3] = {u0, u1, u2};
  void* du[3] = {du0, du1, du2};
  const double inv_h[3] = {inv_h0, inv_h1, inv_h2};
  return launch_stage_bwd<float, false>(P, g, u, aux, dP, du, daux, part, dcoef, n0, n1, n2,
                                        inv_h, alpha, beta, gamma, accumulate, nullptr, 0,
                                        stream);
}

extern "C" int lsm_stage_bwd_f64(const void* P, const void* g, const void* u0, const void* u1,
                                 const void* u2, const void* aux, void* dP, void* du0,
                                 void* du1, void* du2, void* daux, void* part, void* dcoef,
                                 int64_t n0, int64_t n1, int64_t n2, double inv_h0,
                                 double inv_h1, double inv_h2, double alpha, double beta,
                                 double gamma, int accumulate, void* stream) {
  const void* u[3] = {u0, u1, u2};
  void* du[3] = {du0, du1, du2};
  const double inv_h[3] = {inv_h0, inv_h1, inv_h2};
  return launch_stage_bwd<double, false>(P, g, u, aux, dP, du, daux, part, dcoef, n0, n1, n2,
                                         inv_h, alpha, beta, gamma, accumulate, nullptr, 0,
                                         stream);
}

template <typename T>
int launch_stage_bwd_prog(const void* P, const void* g, const void* aux, void* dP, void* daux,
                          void* part, void* dcoef, int64_t n0, int64_t n1, int64_t n2,
                          const LsmStageTerms* terms, int accumulate, int needs_dt,
                          void* stream) {
  if (terms->n != 1 || terms->coef[0] != LSM_COEF_PROGRAM)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* u[3] = {nullptr, nullptr, nullptr};
  void* du[3] = {nullptr, nullptr, nullptr};
  return launch_stage_bwd<T, true>(P, g, u, aux, dP, du, daux, part, dcoef, n0, n1, n2,
                                   terms->inv_h, terms->alpha, terms->beta, terms->gamma,
                                   accumulate, terms, needs_dt, stream);
}

extern "C" int lsm_stage_bwd_prog_f32(const void* P, const void* g, const void* aux, void* dP,
                                      void* daux, void* part, void* dcoef, int64_t n0,
                                      int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                      int accumulate, int needs_dt, void* stream) {
  return launch_stage_bwd_prog<float>(P, g, aux, dP, daux, part, dcoef, n0, n1, n2, terms,
                                      accumulate, needs_dt, stream);
}

extern "C" int lsm_stage_bwd_prog_f64(const void* P, const void* g, const void* aux, void* dP,
                                      void* daux, void* part, void* dcoef, int64_t n0,
                                      int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                      int accumulate, int needs_dt, void* stream) {
  return launch_stage_bwd_prog<double>(P, g, aux, dP, daux, part, dcoef, n0, n1, n2, terms,
                                       accumulate, needs_dt, stream);
}

// scratch doubles: four per block of the larger grid (f64's)
extern "C" int64_t lsm_stage_bwd_terms_scratch(int64_t n0, int64_t n1, int64_t n2) {
  return 4 * nblocks(terms_grid<double>(make_geom(n0, n1, n2)));
}

extern "C" int lsm_stage_bwd_terms_f32(const void* P, const void* g, const void* aux, void* dP,
                                       void* daux, void* part, void* dcoef, int64_t n0,
                                       int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                       const void* const* dstreams, int needs_dt,
                                       void* stream) {
  return launch_stage_bwd_terms<float>(P, g, aux, dP, daux, part, dcoef, n0, n1, n2, terms,
                                       dstreams, needs_dt, stream);
}

extern "C" int lsm_stage_bwd_terms_f64(const void* P, const void* g, const void* aux, void* dP,
                                       void* daux, void* part, void* dcoef, int64_t n0,
                                       int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                       const void* const* dstreams, int needs_dt,
                                       void* stream) {
  return launch_stage_bwd_terms<double>(P, g, aux, dP, daux, part, dcoef, n0, n1, n2, terms,
                                        dstreams, needs_dt, stream);
}

// -- the 2D entries: a 2D field's (n0+6, n1+6) layout -----------------------------------

extern "C" int64_t lsm_stage_bwd_scratch_2d(int64_t n0, int64_t n1) {
  return 4 * nblocks(adv_grid_2d(n0, n1));
}

extern "C" int64_t lsm_stage_bwd_terms_scratch_2d(int64_t n0, int64_t n1) {
  return 4 * nblocks(terms_grid_2d(make_geom_2d(n0, n1)));
}

extern "C" int lsm_stage_bwd_2d_f32(const void* P, const void* g, const void* u0, const void* u1,
                                    const void* aux, void* dP, void* du0, void* du1, void* daux,
                                    void* part, void* dcoef, int64_t n0, int64_t n1,
                                    double inv_h0, double inv_h1, double alpha, double beta,
                                    double gamma, int accumulate, void* stream) {
  return launch_stage_bwd_2d<float, false>(P, g, u0, u1, aux, dP, du0, du1, daux, part, dcoef,
                                           n0, n1, inv_h0, inv_h1, alpha, beta, gamma,
                                           accumulate, nullptr, 0, nullptr, stream);
}

extern "C" int lsm_stage_bwd_2d_f64(const void* P, const void* g, const void* u0, const void* u1,
                                    const void* aux, void* dP, void* du0, void* du1, void* daux,
                                    void* part, void* dcoef, int64_t n0, int64_t n1,
                                    double inv_h0, double inv_h1, double alpha, double beta,
                                    double gamma, int accumulate, void* stream) {
  return launch_stage_bwd_2d<double, false>(P, g, u0, u1, aux, dP, du0, du1, daux, part, dcoef,
                                            n0, n1, inv_h0, inv_h1, alpha, beta, gamma,
                                            accumulate, nullptr, 0, nullptr, stream);
}

namespace {

// K3'' 2D: the embedding's table (its spacing and coordinates, the program
// over (1, n0, n1)), entry 0 the velocity program; axes1, axes2 the
// embedding's axes its components 1 and 2 read (Program.axes)
template <typename T>
int launch_stage_bwd_prog_2d(const void* P, const void* g, const void* aux, void* dP, void* daux,
                             void* part, void* dcoef, int64_t n0, int64_t n1,
                             const LsmStageTerms* terms, int accumulate, int needs_dt, int axes1,
                             int axes2, void* stream) {
  if (terms->n != 1 || terms->coef[0] != LSM_COEF_PROGRAM || ((axes1 | axes2) & ~7))
    return static_cast<int>(cudaErrorInvalidValue);
  const int axes[2] = {axes1, axes2};
  return launch_stage_bwd_2d<T, true>(P, g, nullptr, nullptr, aux, dP, nullptr, nullptr, daux,
                                      part, dcoef, n0, n1, terms->inv_h[1], terms->inv_h[2],
                                      terms->alpha, terms->beta, terms->gamma, accumulate, terms,
                                      needs_dt, axes, stream);
}

}  // namespace

extern "C" int lsm_stage_bwd_prog_2d_f32(const void* P, const void* g, const void* aux, void* dP,
                                         void* daux, void* part, void* dcoef, int64_t n0,
                                         int64_t n1, const LsmStageTerms* terms, int accumulate,
                                         int needs_dt, int axes1, int axes2, void* stream) {
  return launch_stage_bwd_prog_2d<float>(P, g, aux, dP, daux, part, dcoef, n0, n1, terms,
                                         accumulate, needs_dt, axes1, axes2, stream);
}

extern "C" int lsm_stage_bwd_prog_2d_f64(const void* P, const void* g, const void* aux, void* dP,
                                         void* daux, void* part, void* dcoef, int64_t n0,
                                         int64_t n1, const LsmStageTerms* terms, int accumulate,
                                         int needs_dt, int axes1, int axes2, void* stream) {
  return launch_stage_bwd_prog_2d<double>(P, g, aux, dP, daux, part, dcoef, n0, n1, terms,
                                          accumulate, needs_dt, axes1, axes2, stream);
}

extern "C" int lsm_stage_bwd_terms_2d_f32(const void* P, const void* g, const void* aux, void* dP,
                                          void* daux, void* part, void* dcoef, int64_t n0,
                                          int64_t n1, const LsmStageTerms* terms,
                                          const void* const* dstreams, int needs_dt,
                                          void* stream) {
  return launch_stage_bwd_terms<float, true>(P, g, aux, dP, daux, part, dcoef, 1, n0, n1, terms,
                                             dstreams, needs_dt, stream);
}

extern "C" int lsm_stage_bwd_terms_2d_f64(const void* P, const void* g, const void* aux, void* dP,
                                          void* daux, void* part, void* dcoef, int64_t n0,
                                          int64_t n1, const LsmStageTerms* terms,
                                          const void* const* dstreams, int needs_dt,
                                          void* stream) {
  return launch_stage_bwd_terms<double, true>(P, g, aux, dP, daux, part, dcoef, 1, n0, n1,
                                              terms, dstreams, needs_dt, stream);
}
