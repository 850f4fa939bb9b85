// The march of K1, K1'' (csrc/weno_stage.cu) and K10 (csrc/weno_general.cu):
// a block of columns in axes (1, 2) marching down a chunk of axis 0, each
// plane of phi with its halo and an output plane's streams staged in shared
// memory by cp.async. The design is described at the top of weno_stage.cu.
#ifndef LSM_MARCH_CUH
#define LSM_MARCH_CUH

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "coef_program.cuh"
#include "lsm_kernels.h"
#include "weno5.cuh"

namespace {

// The march of K1 and K1'' (and of K10, kInterior): a block of NT threads,
// CX along axis 2 by TY along axis 1, each computing NR neighbouring rows of
// axis 1, so a block owns CY x CX columns. A step stages one plane of phi
// with its halo (RY x RX) and the streams of one output plane: aux on a
// window of AX elements a row (from the even column k0 + 2, so that pairs of
// elements are aligned; K10's interior-shaped aux on CY x CX, as the
// velocity) and, for K1 and K10, the three velocity components. DEPTH steps' copies are in
// flight; the ring holds those and the four planes a step reads (its own,
// and the plane three back that centres its output).
template <typename T>
struct March {
  static constexpr int CX = 32, TY = 8, NT = CX * TY, NR = 2, CY = TY * NR;
  static constexpr int RX = CX + 2 * LSM_GHOST, RY = CY + 2 * LSM_GHOST, PT = RX * RY;
  static constexpr int AX = CX + 2;
  static constexpr int VU = 16 / sizeof(T);  // the elements of a 16-byte copy
  static constexpr int DEPTH = sizeof(T) == 4 ? 2 : 1;
  static constexpr int STAGES = DEPTH + 4;
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 2 : 1;
};
constexpr int kChunk = 64;  // planes a block marches over, at most

// A stage of the ring in dynamic shared memory: the plane's tile (PT
// elements), aux (CY x AX), the velocity (K1: 3 x CY x CX); each part starts
// on 16 bytes.
template <typename T, bool kProgram>
struct MarchRing {
  using M = March<T>;
  static constexpr int AUX = M::PT;
  static constexpr int U = AUX + M::CY * M::AX;
  static constexpr int ELEMS = U + (kProgram ? 0 : 3 * M::CY * M::CX);
  static constexpr size_t BYTES = size_t(M::STAGES) * ELEMS * sizeof(T);
  static_assert(M::PT % 4 == 0 && M::CY * M::AX % 4 == 0 && ELEMS % 4 == 0, "16-byte parts");
};

// How K1'' evaluates a velocity component: once per column, once per plane,
// or per node.
enum { kPerColumn = 0, kPerPlane = 1, kPerNode = 2 };

template <typename T>
struct MarchArgs {
  const T* P;
  const T* u[3];  // K1: the velocity components (interior-shaped)
  const T* aux;   // may be null
  T* out;
  int64_t s0;   // padded plane stride
  int64_t m12;  // interior plane size n1 * n2
  int n0, n1, n2, s1, chunk;
  // copies of two elements for the tile and aux (rows of even length,
  // buffers aligned to two elements), of 16 bytes for the velocity
  int pairs, vec_u;
  int vclass[3];  // K1'': kPerColumn, kPerPlane or kPerNode, per component
  T inv_h[3], alpha, beta, gamma;
  int vec_aux;  // K10: interior-shaped aux copied 16 bytes at a time
};

// COUNT chunks of N elements into shared memory by cp.async: chunk f (this
// thread's: t, t + NT, ...) lands at dst + f * N and comes from src(m, f),
// m the thread's m-th chunk.
template <int N, int COUNT, int NT, typename T, typename Src>
__device__ __forceinline__ void copy_chunks(T* dst, int t, Src src) {
#pragma unroll
  for (int m = 0; m < (COUNT + NT - 1) / NT; ++m) {
    const int f = t + m * NT;
    if ((m + 1) * NT <= COUNT || f < COUNT)
      __pipeline_memcpy_async(dst + f * N, src(m, f), N * sizeof(T));
  }
}

// In-plane offsets of chunk f of W elements of what a step copies for the
// block at (j0, k0): the tile of phi (RY x RX), aux's window (CY x AX, from
// column k0 + 2 of the padded row) and a velocity component (CY x CX). A
// chunk off the buffer takes element 0: it fills a slot that no node reads.
template <typename T, int W>
__device__ __forceinline__ int tile_chunk(const MarchArgs<T>& a, int j0, int k0, int f) {
  constexpr int RX = March<T>::RX;
  const int r = f / (RX / W), c = k0 + f % (RX / W) * W;
  return j0 + r < a.n1 + 2 * LSM_GHOST && c < a.s1 ? (j0 + r) * a.s1 + c : 0;
}
template <typename T, int W>
__device__ __forceinline__ int aux_chunk(const MarchArgs<T>& a, int j0, int k0, int f) {
  constexpr int AX = March<T>::AX;
  const int r = f / (AX / W), c = k0 + 2 + f % (AX / W) * W;
  return j0 + r < a.n1 && c < a.s1 ? (j0 + LSM_GHOST + r) * a.s1 + c : 0;
}
template <typename T, int W>
__device__ __forceinline__ int vel_chunk(const MarchArgs<T>& a, int j0, int k0, int f) {
  constexpr int CX = March<T>::CX;
  const int r = f / (CX / W), c = k0 + f % (CX / W) * W;
  return j0 + r < a.n1 && c < a.n2 ? (j0 + r) * a.n2 + c : 0;
}

// The N backward differences of N + 1 samples, as weno5.cuh's axis_term
// forms them.
template <typename T, int N>
__device__ __forceinline__ void diffs(const T (&s)[N + 1], T inv_h, T (&d)[N]) {
#pragma unroll
  for (int m = 0; m < N; ++m) d[m] = (s[m + 1] - s[m]) * inv_h;
}

// One block's march (see the top of weno_stage.cu); prog is K1'''s velocity
// program (entry 0 of the term table), null for K1; none of its components
// is evaluated per node. kInterior (K10): aux and out are interior-shaped
// (n0, n1, n2); aux is staged as the velocity is, and the output plane
// stored at the interior index.
// Step q copies padded plane i0 + q (i0 + q + 3 without axis 0) and, from
// step L on, the streams of output plane i0 + q - L, whose centre plane is
// the one step q - L / 2 copied.
template <typename T, bool kProgram, bool kAxis0, bool kInterior = false>
__device__ __forceinline__ void march(const MarchArgs<T>& a, const LsmProgram* prog) {
  using M = March<T>;
  using Ring = MarchRing<T, kProgram>;
  constexpr int CX = M::CX, CY = M::CY, NR = M::NR, NT = M::NT, RX = M::RX, PT = M::PT;
  constexpr int AX = M::AX, VU = M::VU, S = M::STAGES, D = M::DEPTH, H = LSM_GHOST;
  constexpr int L = kAxis0 ? 2 * H : 0;
  extern __shared__ __align__(16) unsigned char march_smem[];
  T* const ring = reinterpret_cast<T*>(march_smem);
  __shared__ T vplane[kProgram ? 3 : 1][kProgram ? kChunk : 1];  // K1'': per-plane components
  const int t = threadIdx.x, jl = t / CX, kl = t % CX;
  const int j0 = blockIdx.y * CY, k0 = blockIdx.x * CX;
  const int jf = j0 + jl * NR, k = k0 + kl;  // this thread's first row, and its column
  const int i0 = blockIdx.z * a.chunk, i1 = min(i0 + a.chunk, a.n0), nq = i1 - i0 + L;
  bool rin[NR];  // its rows on the grid (those past n1 come last)
#pragma unroll
  for (int r = 0; r < NR; ++r) rin[r] = k < a.n2 && jf + r < a.n1;
  // this thread's chunks' offsets on the common path (pairs, 16-byte
  // velocity copies); the other computes them at each copy
  constexpr int CU = CY * CX / VU;  // a component's 16-byte chunks
  constexpr int TP = (PT / 2 + NT - 1) / NT, AP = (CY * AX / 2 + NT - 1) / NT;
  constexpr int UP = (3 * CU + NT - 1) / NT;
  int toff[TP], aoff[AP], uoff[UP];
#pragma unroll
  for (int m = 0; m < TP; ++m) toff[m] = tile_chunk<T, 2>(a, j0, k0, t + m * NT);
#pragma unroll
  for (int m = 0; m < AP; ++m) aoff[m] = aux_chunk<T, 2>(a, j0, k0, t + m * NT);
#pragma unroll
  for (int m = 0; m < UP; ++m) uoff[m] = vel_chunk<T, VU>(a, j0, k0, (t + m * NT) % CU);
  // step q's copies (one commit group a step, empty past the last)
  auto issue = [&](int q) {
    if (q < nq) {
      T* const st = ring + unsigned(q) % S * Ring::ELEMS;
      const T* const pp = a.P + int64_t(i0 + q + (kAxis0 ? 0 : H)) * a.s0;
      if (a.pairs)
        copy_chunks<2, PT / 2, NT>(st, t, [&](int m, int) { return pp + toff[m]; });
      else
        copy_chunks<1, PT, NT>(st, t, [&](int, int f) {
          return pp + tile_chunk<T, 1>(a, j0, k0, f);
        });
      const int o = i0 + q - L;
      if (q >= L && a.aux != nullptr) {
        if constexpr (kInterior) {  // chunk f < CU: this thread's first, uoff[0]
          const T* const pa = a.aux + int64_t(o) * a.m12;
          if (a.vec_aux)
            copy_chunks<VU, CU, NT>(st + Ring::AUX, t, [&](int m, int) {
              return pa + uoff[m];
            });
          else
            copy_chunks<1, CY * CX, NT>(st + Ring::AUX, t, [&](int, int f) {
              return pa + vel_chunk<T, 1>(a, j0, k0, f);
            });
        } else {
          const T* const pa = a.aux + int64_t(o + H) * a.s0;
          if (a.pairs)
            copy_chunks<2, CY * AX / 2, NT>(st + Ring::AUX, t, [&](int m, int) {
              return pa + aoff[m];
            });
          else
            copy_chunks<1, CY * AX, NT>(st + Ring::AUX, t, [&](int, int f) {
              return pa + aux_chunk<T, 1>(a, j0, k0, f);
            });
        }
      }
      if constexpr (!kProgram) {
        if (q >= L) {
          // chunk f: component f / (chunks a component), its chunk f % (...)
          const int64_t plane = int64_t(o) * a.m12;
          const auto comp = [&](int f, int per) {
            const int d = f / per;
            return (d == 0 ? a.u[0] : (d == 1 ? a.u[1] : a.u[2])) + plane;
          };
          if (a.vec_u)
            copy_chunks<VU, 3 * CU, NT>(st + Ring::U, t, [&](int m, int f) {
              return comp(f, CU) + uoff[m];
            });
          else
            copy_chunks<1, 3 * CY * CX, NT>(st + Ring::U, t, [&](int, int f) {
              return comp(f, CY * CX) + vel_chunk<T, 1>(a, j0, k0, f % (CY * CX));
            });
        }
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int p = 0; p < D; ++p) issue(p);
  T uc[3][NR] = {};  // K1'': the per-column components
  if constexpr (kProgram) {
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (a.vclass[d] == kPerColumn && rin[r])
          uc[d][r] = lsm::prog_value<T>(*prog, 0, d, i0, jf + r, k);
    for (int e = t; e < 3 * kChunk; e += NT) {
      const int d = e / kChunk, p = e % kChunk;
      if (a.vclass[d] == kPerPlane && i0 + p < i1)
        vplane[d][p] = lsm::prog_value<T>(*prog, 0, d, i0 + p, 0, 0);
    }
  }
  // axis 0: per row, the six differences D- at planes i - 2 .. i + 3 of the
  // next output i, and phi on plane i + 3
  T dq[NR][6] = {}, last[NR] = {};
  // row 0, plane i0; K10's rows and planes at its interior strides
  T* out = kInterior ? a.out + int64_t(i0) * a.m12 + jf * a.n2 + k
                     : a.out + int64_t(i0 + H) * a.s0 + (jf + H) * a.s1 + k + H;
  const int orow = kInterior ? a.n2 : a.s1;
  const int64_t oplane = kInterior ? a.m12 : a.s0;
  for (int q = 0; q < nq; ++q) {
    __pipeline_wait_prior(D - 1);
    __syncthreads();  // step q's copies are in; every thread is done with step q - 1
    issue(q + D);
    const T* const st = ring + unsigned(q) % S * Ring::ELEMS;
    if constexpr (kAxis0) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const T v = st[(jl * NR + r + H) * RX + kl + H];
#pragma unroll
        for (int m = 0; m < 5; ++m) dq[r][m] = dq[r][m + 1];
        dq[r][5] = (v - last[r]) * a.inv_h[0];
        last[r] = v;
      }
    }
    if (q < L || !rin[0]) continue;
    const int o = i0 + q - L;
    // axis 1: the column's samples over the rows and their reach, and their
    // differences, shared by the rows
    const T* const c =
        ring + unsigned(q - L / 2) % S * Ring::ELEMS + (jl * NR + H) * RX + kl + H;
    T c1[NR + 6], d1[NR + 5];
#pragma unroll
    for (int m = 0; m < NR + 6; ++m) c1[m] = c[(m - H) * RX];
    diffs<T, NR + 5>(c1, a.inv_h[1], d1);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (!rin[r]) break;
      T u[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if constexpr (kProgram) {
          u[d] = a.vclass[d] == kPerColumn ? uc[d][r] : vplane[d][o - i0];
        } else {
          u[d] = st[Ring::U + (d * CY + jl * NR + r) * CX + kl];
        }
      }
      T s2[7], d2[6];
#pragma unroll
      for (int m = 0; m < 7; ++m) s2[m] = c[r * RX + m - H];
      diffs<T, 6>(s2, a.inv_h[2], d2);
      T ham;
      if constexpr (kAxis0) {
        ham = lsm::weno5_upwind(dq[r], u[0]);
        ham = ham + lsm::weno5_upwind(d1 + r, u[1]);
      } else {
        ham = lsm::weno5_upwind(d1 + r, u[1]);
      }
      ham = ham + lsm::weno5_upwind(d2, u[2]);
      T res = a.beta * c1[r + H] - a.gamma * ham;
      if (a.aux != nullptr)
        res = a.alpha * st[Ring::AUX + (jl * NR + r) * (kInterior ? CX : AX) + kl +
                           (kInterior ? 0 : 1)] + res;
      out[r * orow] = res;
    }
    out += oplane;
  }
}

}  // namespace

#endif  // LSM_MARCH_CUH
