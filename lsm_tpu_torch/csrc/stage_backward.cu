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
// product, sum and quotient is rounded on its own (__fmul_rn etc., no FMA
// contraction, IEEE division), because at WENO-symmetric cells the
// cotangent of eps multiplies a cancelled sum dr by r^2 ~ 1e21: the plain
// association is what keeps float32 right there.
//
// Design. The TPU kernel accumulated each tile's +-3 overhang into dP by
// read-modify-write and carried the scalar partials across grid steps, both
// relying on an in-order grid. Blocks run in no order on Hopper, so this is
// the gather form: every dP element is written by one thread. One launch per
// axis a (0, 1, 2, in order on the stream). A block owns a tile of LA
// consecutive positions along a (and, for a = 0 or 1, 32 lanes along the
// contiguous axis 2); it first evaluates the per-axis adjoint of the LA + 6
// outputs within reach of the tile into shared memory, once each, then every
// thread gathers c_a for its positions from there. The axis-0 launch writes
// dP, daux and the phi/aux partial sums; the axis-1 and axis-2 launches add
// their term to dP. Redundancy factor: (LA + 6) / LA evaluations of the
// adjoint per output and axis, 24/18 = 1.33 for axes 0 and 1 and 128/122 =
// 1.05 for axis 2. Scalar sums: each block writes its partial (in double) to
// a scratch slot; a fourth launch of one block sums the slots in a fixed
// order. No atomics: every run gives the same bits.
//
// Bound at 512^3 f32: it must read P, g (interior) and the 3 streams and
// write dP and the 3 du: 36 B/cell, 44 with aux and daux, 4.9-6.0 GB,
// 1.45-1.78 ms at 3.35 TB/s. Its arithmetic is 607 FP32 operations per cell
// (202 per axis, counting each of the 2 IEEE divisions per axis as one),
// 8.1e10 at 512^3, 1.2 ms at 67 TFLOP/s: bytes bind, barely. Measured on an
// H100 80GB HBM3 at 700 W (PERF.md): 10.6 ms, each axis launch 3.4 ms
// whether its axis is contiguous or strided, so instruction issue binds,
// not DRAM: the halo recomputation, no FMA, int64 index arithmetic and the
// division sequences. Fusing the three axes into one pass, contracting FMAs
// outside the s/b/dr chain and int32 indexing are later work.
//
// Accumulate mode (an advection term inside a term list, after K3' below has
// written dP): the axis-0 launch adds its term to dP as the others do, and
// writes no beta*g, no daux and no phi/aux partial sums, so dcoef is
// (0, 0, dgamma of this advection term).
//
// K3'' (the program entry, lsm_stage_bwd_prog_*): the velocity is a
// coefficient program (csrc/coef_program.cuh), each axis launch evaluating
// its own component at the output's node in place of the stream (the TPU
// kernel's "analytic" branch, weno_v2_bwd.py:604-660). There is no du. When
// the stage time needs a cotangent the component is evaluated in forward-mode
// dual numbers, and dt = sum over outputs of du_a * du_a/dt (du_a = core_a *
// (-gamma*g), the cotangent of u_a) joins the fixed-order partial sums:
// one more double per block, summed by the reduction launch.

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

// Tile of one axis launch: LA positions along the axis (rows) times LX lanes
// along axis 2 (axes 0 and 1 only), NT threads. (LA + 6) * LX is a multiple
// of NT, so every thread evaluates the same number of outputs.
template <int AXIS>
struct Tile {
  static constexpr int LX = 32, LA = 18, NT = 256;
};
template <>
struct Tile<2> {
  static constexpr int LX = 1, LA = 122, NT = 128;
};

struct Geom {
  int64_t n[3], S[3], s[3];
};

__host__ __device__ inline Geom make_geom(int64_t n0, int64_t n1, int64_t n2) {
  Geom g;
  g.n[0] = n0;
  g.n[1] = n1;
  g.n[2] = n2;
  for (int d = 0; d < 3; ++d) g.S[d] = g.n[d] + 2 * LSM_GHOST;
  g.s[2] = 1;
  g.s[1] = g.S[2];
  g.s[0] = g.S[1] * g.S[2];
  return g;
}

template <int AXIS>
__host__ __device__ inline dim3 bwd_grid(const Geom& g) {
  using TL = Tile<AXIS>;
  const unsigned rows = static_cast<unsigned>((g.S[AXIS] + TL::LA - 1) / TL::LA);
  if constexpr (AXIS == 2) {
    return dim3(rows, static_cast<unsigned>(g.S[1]), static_cast<unsigned>(g.S[0]));
  } else {
    return dim3(rows, static_cast<unsigned>((g.S[2] + TL::LX - 1) / TL::LX),
                static_cast<unsigned>(g.S[1 - AXIS]));
  }
}

inline int64_t nblocks(dim3 d) { return int64_t(d.x) * d.y * d.z; }

__device__ __forceinline__ bool inside(int64_t c, int64_t n) {
  return c >= LSM_GHOST && c < n + LSM_GHOST;
}

template <typename T>
struct BwdArgs {
  const T* P;
  const T* g;
  const T* u;    // this axis's velocity component (interior-shaped)
  const T* aux;  // axis-0 launch only, may be null
  T* dP;
  T* du;    // this axis's, may be null
  T* daux;  // axis-0 launch only, may be null
  double* part;
  Geom geo;
  T inv_h, alpha, beta, gamma;
  int accumulate;  // add to dP on the axis-0 launch too (see above)
  // K3'' only: the velocity program (entry 0 of tab), whether dt is wanted,
  // and this axis's slots of the dt partials
  int needs_dt;
  double* tpart;
  LsmStageTerms tab;
};

// deterministic sum over the block of NT threads, 1D or 2D (result in
// thread 0)
template <int NT>
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.0;
  if (tid == 0)
    for (int k = 0; k < NT / 32; ++k) v += red[k];
  return v;
}

template <typename T, int AXIS, bool kProgram>
__global__ void __launch_bounds__(Tile<AXIS>::NT)
    stage_bwd_axis_kernel(const __grid_constant__ BwdArgs<T> a) {
  using R = Rn<T>;
  using TL = Tile<AXIS>;
  constexpr int LX = TL::LX, LA = TL::LA, NT = TL::NT, ROWS = LA + 2 * LSM_GHOST;
  __shared__ T D[6][ROWS * LX];
  __shared__ double red[kProgram ? 4 : 3][NT / 32];
  const Geom& G = a.geo;
  const int64_t m0 = int64_t(blockIdx.x) * LA;
  // the two coordinates this block holds fixed (or its lane base)
  int64_t fix_i = 0, fix_j = 0, l0 = 0;
  if constexpr (AXIS == 2) {
    fix_j = blockIdx.y;
    fix_i = blockIdx.z;
  } else {
    l0 = int64_t(blockIdx.y) * LX;
    if constexpr (AXIS == 0) fix_j = blockIdx.z;
    else fix_i = blockIdx.z;
  }
  const int64_t sa = G.s[AXIS];
  auto coords = [&](int64_t m, int64_t l, int64_t& i, int64_t& j, int64_t& k) {
    if constexpr (AXIS == 0) {
      i = m, j = fix_j, k = l;
    } else if constexpr (AXIS == 1) {
      i = fix_i, j = m, k = l;
    } else {
      i = fix_i, j = fix_j, k = m;
    }
  };
  const T neg_gamma = -a.gamma;
  double sg = 0.0, sb = 0.0, sa_ = 0.0, st_ = 0.0;

  // phase 1: the adjoint of every output within reach of the tile, once each
  for (int idx = threadIdx.x; idx < ROWS * LX; idx += NT) {
    const int lane = idx % LX, r = idx / LX;
    const int64_t m = m0 - LSM_GHOST + r, l = l0 + lane;
    int64_t i, j, k;
    coords(m, l, i, j, k);
    const bool valid = inside(i, G.n[0]) && inside(j, G.n[1]) && inside(k, G.n[2]);
    if (!valid) {
#pragma unroll
      for (int q = 0; q < 6; ++q) D[q][idx] = T(0);
      continue;
    }
    const int64_t c = i * G.s[0] + j * G.s[1] + k;
    T sv[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) sv[q] = a.P[c + (q - 3) * sa];
    T dm[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) dm[q] = R::mul(R::sub(sv[q + 1], sv[q]), a.inv_h);
    const int64_t qi = ((i - LSM_GHOST) * G.n[1] + (j - LSM_GHOST)) * G.n[2] + (k - LSM_GHOST);
    const T gv = a.g[c];
    T uv, udt = T(0);
    if constexpr (kProgram) {
      const int64_t n0 = i - LSM_GHOST, n1 = j - LSM_GHOST, n2 = k - LSM_GHOST;
      uv = a.needs_dt ? lsm::prog_eval<T, true>(a.tab.prog, 0, AXIS, n0, n1, n2, &udt)
                      : lsm::prog_eval<T, false>(a.tab.prog, 0, AXIS, n0, n1, n2, nullptr);
    } else {
      uv = a.u[qi];
    }
    const T gup = R::mul(neg_gamma, gv);
    T ddm[6], core;
    weno5_fwd_bwd(dm, uv, gup, ddm, core);
#pragma unroll
    for (int q = 0; q < 6; ++q) D[q][idx] = ddm[q];
    if (r >= LSM_GHOST && r < LSM_GHOST + LA) {  // an output this block owns
      if (a.du != nullptr) a.du[qi] = R::mul(core, gup);
      sg += double(gv) * double(R::mul(uv, core));
      if (kProgram) st_ += double(R::mul(core, gup)) * double(udt);
    }
  }
  __syncthreads();

  // phase 2: gather the edge cotangents for the tile's positions
  for (int idx = threadIdx.x; idx < LA * LX; idx += NT) {
    const int lane = idx % LX, rr = idx / LX, r = rr + LSM_GHOST;
    const int64_t m = m0 + rr, l = l0 + lane;
    if (m >= G.S[AXIS] || (AXIS != 2 && l >= G.S[2])) continue;
    int64_t i, j, k;
    coords(m, l, i, j, k);
    T cx = D[0][(r + 2) * LX + lane];
    T cx1 = D[0][(r + 3) * LX + lane];
#pragma unroll
    for (int q = 1; q < 6; ++q) {
      cx = R::add(cx, D[q][(r + 2 - q) * LX + lane]);
      cx1 = R::add(cx1, D[q][(r + 3 - q) * LX + lane]);
    }
    const T contrib = R::mul(R::sub(cx, cx1), a.inv_h);
    const int64_t x = i * G.s[0] + j * G.s[1] + k;
    if (AXIS == 0 && !a.accumulate) {
      const bool in_x = inside(i, G.n[0]) && inside(j, G.n[1]) && inside(k, G.n[2]);
      if (in_x) {
        const T gv = a.g[x];
        a.dP[x] = R::add(R::mul(a.beta, gv), contrib);
        if (a.daux != nullptr) a.daux[x] = R::mul(a.alpha, gv);
        sb += double(gv) * double(a.P[x]);
        if (a.aux != nullptr) sa_ += double(gv) * double(a.aux[x]);
      } else {
        a.dP[x] = contrib;
      }
    } else {
      a.dP[x] = R::add(a.dP[x], contrib);
    }
  }

  const int64_t bid = int64_t(blockIdx.x) + int64_t(gridDim.x) *
                      (int64_t(blockIdx.y) + int64_t(gridDim.y) * blockIdx.z);
  sg = block_sum<NT>(sg, red[0]);
  if constexpr (kProgram) {
    st_ = block_sum<NT>(st_, red[3]);
    if (threadIdx.x == 0) a.tpart[bid] = st_;
  }
  if (AXIS == 0) {
    sb = block_sum<NT>(sb, red[1]);
    sa_ = block_sum<NT>(sa_, red[2]);
    if (threadIdx.x == 0) {
      a.part[3 * bid] = sg;
      a.part[3 * bid + 1] = sb;
      a.part[3 * bid + 2] = sa_;
    }
  } else if (threadIdx.x == 0) {
    a.part[bid] = sg;
  }
}

constexpr int kReduceThreads = 1024;

// sum of part[off + stride*b + field] over b < count, in a fixed order
__device__ double strided_sum(const double* part, int64_t count, int stride, int field,
                              double* red) {
  double v = 0.0;
  for (int64_t b = threadIdx.x; b < count; b += kReduceThreads) v += part[b * stride + field];
  return block_sum<kReduceThreads>(v, red);
}

// out = (dalpha, dbeta, dgamma) from the three launches' partials; K3''
// adds out[3] = dt from the dt partials (tpart, nb0 + nb1 + nb2 of them)
template <typename T, bool kProgram>
__global__ void __launch_bounds__(kReduceThreads)
    stage_bwd_reduce_kernel(const double* part, int64_t nb0, int64_t nb1, int64_t nb2,
                            const double* tpart, T* out) {
  __shared__ double red[kProgram ? 6 : 5][kReduceThreads / 32];
  const double g0 = strided_sum(part, nb0, 3, 0, red[0]);
  const double sb = strided_sum(part, nb0, 3, 1, red[1]);
  const double sa = strided_sum(part, nb0, 3, 2, red[2]);
  const double g1 = strided_sum(part + 3 * nb0, nb1, 1, 0, red[3]);
  const double g2 = strided_sum(part + 3 * nb0 + nb1, nb2, 1, 0, red[4]);
  double dt = 0.0;
  if constexpr (kProgram) dt = strided_sum(tpart, nb0 + nb1 + nb2, 1, 0, red[5]);
  if (threadIdx.x == 0) {
    out[0] = T(sa);
    out[1] = T(sb);
    out[2] = T(-((g0 + g1) + g2));
    if (kProgram) out[3] = T(dt);
  }
}

template <typename T, int AXIS, bool kProgram>
cudaError_t launch_axis(const BwdArgs<T>& args, cudaStream_t stream) {
  stage_bwd_axis_kernel<T, AXIS, kProgram>
      <<<bwd_grid<AXIS>(args.geo), Tile<AXIS>::NT, 0, stream>>>(args);
  return cudaGetLastError();
}

// K3 (kProgram false: the velocity streamed in u) and K3'' (the velocity the
// program of tab's entry 0; part holds 2 * lsm_stage_bwd_scratch doubles, the
// second half the dt partials)
template <typename T, bool kProgram>
int launch_stage_bwd(const void* P, const void* g, const void* const* u, const void* aux,
                     void* dP, void* const* du, void* daux, void* part, void* dcoef, int64_t n0,
                     int64_t n1, int64_t n2, const double* inv_h, double alpha, double beta,
                     double gamma, int accumulate, const LsmStageTerms* tab, int needs_dt,
                     void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Geom geo = make_geom(n0, n1, n2);
  const int64_t nb[3] = {nblocks(bwd_grid<0>(geo)), nblocks(bwd_grid<1>(geo)),
                         nblocks(bwd_grid<2>(geo))};
  double* parts = static_cast<double*>(part);
  double* part_at[3] = {parts, parts + 3 * nb[0], parts + 3 * nb[0] + nb[1]};
  double* tparts = parts + 3 * nb[0] + nb[1] + nb[2];
  double* tpart_at[3] = {tparts, tparts + nb[0], tparts + nb[0] + nb[1]};
  cudaError_t err = cudaSuccess;
  for (int axis = 0; axis < 3 && err == cudaSuccess; ++axis) {
    BwdArgs<T> a{};
    a.P = static_cast<const T*>(P);
    a.g = static_cast<const T*>(g);
    a.u = kProgram ? nullptr : static_cast<const T*>(u[axis]);
    a.aux = axis == 0 ? static_cast<const T*>(aux) : nullptr;
    a.dP = static_cast<T*>(dP);
    a.du = kProgram ? nullptr : static_cast<T*>(du[axis]);
    a.daux = axis == 0 ? static_cast<T*>(daux) : nullptr;
    a.part = part_at[axis];
    a.geo = geo;
    a.inv_h = T(inv_h[axis]);
    a.alpha = T(alpha);
    a.beta = T(beta);
    a.gamma = T(gamma);
    a.accumulate = accumulate;
    if constexpr (kProgram) {
      a.needs_dt = needs_dt;
      a.tpart = tpart_at[axis];
      a.tab = *tab;
    }
    if (axis == 0) err = launch_axis<T, 0, kProgram>(a, stream);
    else if (axis == 1) err = launch_axis<T, 1, kProgram>(a, stream);
    else err = launch_axis<T, 2, kProgram>(a, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // without dt the dt partials are all 0: the plain reduction, dcoef[3] left
  // as the caller zeroed it
  const auto reduce = kProgram && needs_dt ? stage_bwd_reduce_kernel<T, true>
                                           : stage_bwd_reduce_kernel<T, false>;
  reduce<<<1, kReduceThreads, 0, stream>>>(parts, nb[0], nb[1], nb[2], tparts,
                                           static_cast<T*>(dcoef));
  return static_cast<int>(cudaGetLastError());
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
// Design: recompute, in the gather form. One thread per padded node x
// writes dP[x] once: it re-evaluates, in registers, the adjoint of every
// output y whose stencil holds x (13 nodes for the Godunov kinds: the centre
// and +-1, +-2 along each axis; 19 for curvature: the centre, +-1 along each
// axis and the 12 edge neighbours) and takes the weight of x. Stream
// cotangents and the scalar partials come from y == x. No shared memory, no
// atomics; the partials go to per-block slots in double and one fixed-order
// reduction follows, so every run gives the same bits. This file is built
// without FMA contraction (ops/_build.py), so each product and sum rounds on
// its own, as in the plain version.
//
// Bound at 512^3 f32 (constant coefficients): read the padded P and the
// interior g, write the padded dP, 1.65 GB, 0.49 ms at 3.35 TB/s; a streamed
// speed adds its read and its cotangent's write. The recomputation does 13
// (Godunov) or 19 (curvature) adjoints per node, ~3.7e3 (normal motion) to
// ~6e3 (curvature + normal motion) operations per node, 0.5e12-0.8e12 at
// 512^3, 7-12 ms at 67 TFLOP/s: the operations bind, by ~15-25x. Staging
// each output's adjoint pieces in shared memory over a tile and its halo
// (once per output instead of 13-19 times) is the later work.

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
  LsmStageTerms tab;
  int has_godunov, has_curvature;
  int needs_dt;  // K3'': the stage time's cotangent through program entries
};

// A program coefficient (K3''): entry e at the output whose padded
// coordinates are Y, with its t-derivative in *vdt when `dual`. Not inlined,
// so that the interpreter's registers and stack stay out of the adjoints of
// the streamed and constant coefficients.
template <typename T>
__device__ __noinline__ T program_coef(const LsmProgram& p, int e, const int64_t* Y, bool dual,
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
__device__ __forceinline__ T coef_at(const TermsBwdArgs<T>& a, int e, int64_t q,
                                     const int64_t* Y, bool dual, T* vdt) {
  const LsmStageTerms& p = a.tab;
  if (p.coef[e] == LSM_COEF_STREAM) return static_cast<const T*>(p.stream[e][0])[q];
  if (p.coef[e] == LSM_COEF_CONST) return T(p.value[e]);
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
__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
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

template <typename T, bool kProgram>
__device__ void godunov_adjoint(const TermsBwdArgs<T>& a, int64_t c, int64_t q,
                                const int64_t* Y, T gbar, bool centre, GodAdj<T>& o) {
  const LsmStageTerms& p = a.tab;
  const T* P = a.P;
  const int64_t st[3] = {a.geo.s[0], a.geo.s[1], 1};
  T A[3], B[3];
  T gp2 = T(0), gm2 = T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int64_t s = st[d];
    const T inv_h = T(p.inv_h[d]), half_h = T(p.half_h[d]), inv_hh = T(p.inv_hh[d]);
    const T m2 = P[c - 2 * s], m1 = P[c - s], c0 = P[c], p1 = P[c + s], p2 = P[c + 2 * s];
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
  for (int e = 0; e < p.n; ++e) {
    const int kind = p.kind[e], coef = p.coef[e];
    if (kind != LSM_TERM_NORMAL && kind != LSM_TERM_EIKONAL) continue;
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
      const T c0 = P[c], dx = T(p.dx_min);
      const bool up = c0 > T(0);
      const T norm = up ? gp : gm;
      const T denom = tsqrt(c0 * c0 + norm * norm * dx * dx);
      const T s = denom == T(0) ? T(0) : c0 / denom;
      const T ds = gbar * (norm - T(1));
      T dnorm = gbar * s;
      const T ddenom = denom == T(0) ? T(0) : -ds * c0 / (denom * denom);
      if (denom != T(0)) dc = dc + ds / denom;
      const T dX = ddenom / (T(2) * denom);  // 0/0 where denom == 0, as autodiff's
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
  const T dgp2 = gp2 > T(0) ? dgp / (T(2) * gp) : T(0);
  const T dgm2 = gm2 > T(0) ? dgm / (T(2) * gm) : T(0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    o.dA[d] = A[d] > T(0) ? dgp2 * (T(2) * A[d]) : (A[d] < T(0) ? dgm2 * (T(2) * A[d]) : T(0));
    o.dB[d] = B[d] < T(0) ? dgp2 * (T(2) * B[d]) : (B[d] > T(0) ? dgm2 * (T(2) * B[d]) : T(0));
  }
  o.dc = dc;
  o.ham = ham;
  o.dt = tsum;
}

// what the Godunov kinds at y send to P[y + k e_d], k in -2..2 (the centre's
// direct part excluded)
template <typename T>
__device__ __forceinline__ T godunov_weight(const GodAdj<T>& o, const LsmStageTerms& p, int d,
                                            int k) {
  const T inv_h = T(p.inv_h[d]), half_h = T(p.half_h[d]), inv_hh = T(p.inv_hh[d]);
  const T dA = o.dA[d], dB = o.dB[d];
  T w = T(0);
  // A = (c0 - m1)/h + h/2 minmod(D2--, D2_0); B = (p1 - c0)/h - h/2 minmod(D2++, D2_0)
  if (k == 0) w = w + dA * inv_h - dB * inv_h;
  if (k == -1) w = w - dA * inv_h;
  if (k == 1) w = w + dB * inv_h;
  if (o.sA[d] != 0) w = w + dA * half_h * inv_hh * d2_coef<T>(o.sA[d] == 1 ? -1 : 0, k);
  if (o.sB[d] != 0) w = w - dB * half_h * inv_hh * d2_coef<T>(o.sB[d] == 1 ? 1 : 0, k);
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

template <typename T, bool kProgram>
__device__ void curvature_adjoint(const TermsBwdArgs<T>& a, int64_t c, int64_t q,
                                  const int64_t* Y, T gbar, bool centre, CurvAdj<T>& o) {
  const LsmStageTerms& p = a.tab;
  const T* P = a.P;
  const int64_t st[3] = {a.geo.s[0], a.geo.s[1], 1};
  const int pair[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  const T c0 = P[c];
  T g[3], hd[3], hm[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const T plus = P[c + st[d]], minus = P[c - st[d]];
    g[d] = (plus - minus) * T(p.inv_two_h[d]);
    hd[d] = (plus - T(2) * c0 + minus) * T(p.inv_hh[d]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t sa = st[pair[k][0]], sb = st[pair[k][1]];
    hm[k] = (P[c + sa + sb] - P[c + sa - sb] - P[c - sa + sb] + P[c - sa - sb]) *
            T(p.inv_hmix[k]);
  }
  const T nrmsq = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
  const T lap = hd[0] + hd[1] + hd[2];
  T quad = g[0] * g[0] * hd[0];
  quad = quad + T(2) * g[0] * g[1] * hm[0];
  quad = quad + T(2) * g[0] * g[2] * hm[1];
  quad = quad + g[1] * g[1] * hd[1];
  quad = quad + T(2) * g[1] * g[2] * hm[2];
  quad = quad + g[2] * g[2] * hd[2];
  const bool safe = nrmsq >= EpsOf<T>::value();
  const T ns = safe ? nrmsq : T(1);
  const T root = tsqrt(ns);
  const T D = ns * root;
  const T N = lap * ns - quad;
  const T kap = safe ? N / D : T(0);
  const T nrm = nrmsq > T(0) ? tsqrt(nrmsq) : T(0);
  T dkap = T(0), dnrm = T(0), ham = T(0), tsum = T(0);
  for (int e = 0; e < p.n; ++e) {
    if (p.kind[e] != LSM_TERM_CURVATURE) continue;
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
  const T dN = dK / D;
  const T dD = -dK * N / (D * D);
  const T dns = dN * lap + dD * (T(1.5) * root);
  const T dlap = dN * ns;
  const T dquad = -dN;
  const T dnrmsq = (safe ? dns : T(0)) + (nrmsq > T(0) ? dnrm / (T(2) * nrm) : T(0));
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    o.dhd[d] = dquad * (g[d] * g[d]) + dlap;
    T dgd = dquad * (T(2) * g[d] * hd[d]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int i = pair[k][0], j = pair[k][1];
      if (i == d) dgd = dgd + dquad * (T(2) * g[j] * hm[k]);
      if (j == d) dgd = dgd + dquad * (T(2) * g[i] * hm[k]);
    }
    o.dg[d] = dgd + (T(2) * g[d]) * dnrmsq;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) o.dhm[k] = dquad * (T(2) * g[pair[k][0]] * g[pair[k][1]]);
  o.ham = ham;
  o.dt = tsum;
}

constexpr int kTermsX = 64;
constexpr int kTermsY = 4;

__host__ __device__ inline dim3 terms_grid(const Geom& g) {
  return dim3(static_cast<unsigned>((g.S[2] + kTermsX - 1) / kTermsX),
              static_cast<unsigned>((g.S[1] + kTermsY - 1) / kTermsY),
              static_cast<unsigned>(g.S[0]));
}

__device__ __forceinline__ bool inside3(const int64_t* X, const Geom& G) {
  return inside(X[0], G.n[0]) && inside(X[1], G.n[1]) && inside(X[2], G.n[2]);
}

template <typename T, bool kProgram>
__global__ void __launch_bounds__(kTermsX* kTermsY)
    stage_bwd_terms_kernel(const __grid_constant__ TermsBwdArgs<T> a) {
  const Geom& G = a.geo;
  const LsmStageTerms& p = a.tab;
  const int64_t k = int64_t(blockIdx.x) * kTermsX + threadIdx.x;
  const int64_t j = int64_t(blockIdx.y) * kTermsY + threadIdx.y;
  const int64_t i = blockIdx.z;
  const int64_t st[3] = {G.s[0], G.s[1], 1};
  const int pair[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  const T neg_gamma = -T(p.gamma);
  auto qidx = [&](const int64_t* Y) {
    return ((Y[0] - LSM_GHOST) * G.n[1] + (Y[1] - LSM_GHOST)) * G.n[2] + (Y[2] - LSM_GHOST);
  };
  double sg = 0.0, sb = 0.0, sa = 0.0, st_ = 0.0;
  if (k < G.S[2] && j < G.S[1]) {
    const int64_t X[3] = {i, j, k};
    const int64_t x = i * st[0] + j * st[1] + k;
    T acc = T(0);
    if (inside3(X, G)) {
      const int64_t q = qidx(X);
      const T gv = a.g[x];
      const T gbar = neg_gamma * gv;
      acc = T(p.beta) * gv;
      T ham = T(0);
      if (a.has_godunov) {
        GodAdj<T> o;
        godunov_adjoint<T, kProgram>(a, x, q, X, gbar, true, o);
        acc = acc + (godunov_weight(o, p, 0, 0) + godunov_weight(o, p, 1, 0) +
                     godunov_weight(o, p, 2, 0) + o.dc);
        ham = ham + o.ham;
        st_ += double(o.dt);
      }
      if (a.has_curvature) {
        CurvAdj<T> o;
        curvature_adjoint<T, kProgram>(a, x, q, X, gbar, true, o);
        acc = acc - T(2) * (o.dhd[0] * T(p.inv_hh[0]) + o.dhd[1] * T(p.inv_hh[1]) +
                            o.dhd[2] * T(p.inv_hh[2]));
        ham = ham + o.ham;
        st_ += double(o.dt);
      }
      if (a.daux != nullptr) a.daux[x] = T(p.alpha) * gv;
      sg = double(gv) * double(ham);
      sb = double(gv) * double(a.P[x]);
      if (a.aux != nullptr) sa = double(gv) * double(a.aux[x]);
    }
    // outputs along each axis: +-1 (both kinds) and +-2 (Godunov kinds)
    for (int d = 0; d < 3; ++d) {
      for (int kk = -2; kk <= 2; ++kk) {
        if (kk == 0) continue;
        const bool near = kk == 1 || kk == -1;
        if (!a.has_godunov && !near) continue;
        int64_t Y[3] = {X[0], X[1], X[2]};
        Y[d] -= kk;
        if (!inside3(Y, G)) continue;
        const int64_t y = x - kk * st[d], q = qidx(Y);
        const T gbar = neg_gamma * a.g[y];
        if (a.has_godunov) {
          GodAdj<T> o;
          godunov_adjoint<T, kProgram>(a, y, q, Y, gbar, false, o);
          acc = acc + godunov_weight(o, p, d, kk);
        }
        if (a.has_curvature && near) {
          CurvAdj<T> o;
          curvature_adjoint<T, kProgram>(a, y, q, Y, gbar, false, o);
          const T dg = o.dg[d] * T(p.inv_two_h[d]);
          acc = acc + ((kk == 1 ? dg : -dg) + o.dhd[d] * T(p.inv_hh[d]));
        }
      }
    }
    // curvature's mixed differences: the 12 edge neighbours
    if (a.has_curvature) {
      for (int m = 0; m < 3; ++m) {
        const int da = pair[m][0], db = pair[m][1];
        for (int sa_ = -1; sa_ <= 1; sa_ += 2) {
          for (int sb_ = -1; sb_ <= 1; sb_ += 2) {
            int64_t Y[3] = {X[0], X[1], X[2]};
            Y[da] -= sa_;
            Y[db] -= sb_;
            if (!inside3(Y, G)) continue;
            const int64_t y = x - sa_ * st[da] - sb_ * st[db];
            CurvAdj<T> o;
            curvature_adjoint<T, kProgram>(a, y, qidx(Y), Y, neg_gamma * a.g[y], false, o);
            const T w = o.dhm[m] * T(p.inv_hmix[m]);
            acc = acc + (sa_ * sb_ > 0 ? w : -w);
          }
        }
      }
    }
    a.dP[x] = acc;
  }
  __shared__ double red[4][kTermsX * kTermsY / 32];
  sg = block_sum<kTermsX * kTermsY>(sg, red[0]);
  sb = block_sum<kTermsX * kTermsY>(sb, red[1]);
  sa = block_sum<kTermsX * kTermsY>(sa, red[2]);
  st_ = block_sum<kTermsX * kTermsY>(st_, red[3]);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const int64_t bid = int64_t(blockIdx.x) + int64_t(gridDim.x) *
                        (int64_t(blockIdx.y) + int64_t(gridDim.y) * blockIdx.z);
    a.part[4 * bid] = sg;
    a.part[4 * bid + 1] = sb;
    a.part[4 * bid + 2] = sa;
    a.part[4 * bid + 3] = st_;
  }
}

// out = (dalpha, dbeta, dgamma, dt) from K3''s per-block partials
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    stage_bwd_terms_reduce_kernel(const double* part, int64_t nb, T* out) {
  __shared__ double red[4][kReduceThreads / 32];
  const double sg = strided_sum(part, nb, 4, 0, red[0]);
  const double sb = strided_sum(part, nb, 4, 1, red[1]);
  const double sa = strided_sum(part, nb, 4, 2, red[2]);
  const double st = strided_sum(part, nb, 4, 3, red[3]);
  if (threadIdx.x == 0) {
    out[0] = T(sa);
    out[1] = T(sb);
    out[2] = T(-sg);
    out[3] = T(st);
  }
}

template <typename T>
int launch_stage_bwd_terms(const void* P, const void* g, const void* aux, void* dP, void* daux,
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
  a.geo = make_geom(n0, n1, n2);
  a.tab = *terms;
  a.has_godunov = 0;
  a.has_curvature = 0;
  a.needs_dt = needs_dt;
  bool program = false;
  for (int e = 0; e < LSM_MAX_TERMS; ++e) {
    a.dstream[e] = e < terms->n ? static_cast<T*>(const_cast<void*>(dstreams[e])) : nullptr;
    if (e >= terms->n) continue;
    if (terms->kind[e] == LSM_TERM_NORMAL || terms->kind[e] == LSM_TERM_EIKONAL)
      a.has_godunov = 1;
    if (terms->kind[e] == LSM_TERM_CURVATURE) a.has_curvature = 1;
    if (terms->coef[e] == LSM_COEF_PROGRAM && terms->kind[e] != LSM_TERM_ADVECTION) program = true;
  }
  const dim3 grid = terms_grid(a.geo);
  const auto kernel = program ? stage_bwd_terms_kernel<T, true> : stage_bwd_terms_kernel<T, false>;
  kernel<<<grid, dim3(kTermsX, kTermsY, 1), 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stage_bwd_terms_reduce_kernel<T><<<1, kReduceThreads, 0, stream>>>(
      a.part, nblocks(grid), static_cast<T*>(dcoef));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int64_t lsm_stage_bwd_scratch(int64_t n0, int64_t n1, int64_t n2) {
  const Geom geo = make_geom(n0, n1, n2);
  return 3 * nblocks(bwd_grid<0>(geo)) + nblocks(bwd_grid<1>(geo)) +
         nblocks(bwd_grid<2>(geo));
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

extern "C" int64_t lsm_stage_bwd_terms_scratch(int64_t n0, int64_t n1, int64_t n2) {
  return 4 * nblocks(terms_grid(make_geom(n0, n1, n2)));
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
