// K1: one fused RK stage on the padded layout.
//
// Replaces the TPU kernel lsm_tpu/ops/weno_v2.py `fused_stage` (body
// `_make_kernel`). Three entries:
// - the advection-only stage (one WENO5 advection term, three streamed
//   velocity components);
// - K1'': the same stage with the velocity a coefficient program
//   (csrc/coef_program.cuh), evaluated at lo + (origin + i)*h and the stage
//   time (the TPU kernel's "analytic" branch, `_coords_block`): nothing is
//   streamed, 12 B/cell less in f32;
// - K1': any term list (advection, normal motion, curvature, eikonal
//   reinitialization; streamed, constant, program or no coefficient), summed
//   in list order: lsm::stage_value_terms (hamiltonians.cuh). The table
//   travels by value in the kernel's parameters (__grid_constant__, so a loop
//   over it reads the constant bank without a local copy); its branches are
//   uniform.
// The per-node functions are shared with the band stage K6.
//
// Design of the advection-only entries (K1, K1''), as the TPU kernel stages a
// slab of phi in VMEM: a block of 256 threads owns a tile of 16 x 32 output
// columns in axes (1, 2), each thread two neighbouring rows of one column,
// and marches down a chunk of <= 64 planes of axis 0. Each step copies one
// plane of phi with its 3-node halo in axes 1 and 2 (22 x 38) into shared
// memory by cp.async, with the streams of the output plane three planes
// back (aux, and K1's u0, u1, u2); the ring holds six steps (five in f64):
// the four planes a step reads and two steps' copies in flight (one in
// f64). A padded row of 2072 B in f32 is not 16-byte aligned, so TMA cannot
// take the layout; the copies take two elements at a time where rows have
// an even length (aux from the even column before the interior's), the
// interior-shaped velocity 16 bytes at a time, else an element at a time.
// Axes 1 and 2 take their samples from the tile; the two rows share the
// differences along axis 1, and axis 0 keeps each row's six differences in
// registers, one new one a step from the plane just copied. Offsets inside a
// plane are 32-bit. The differences are formed as weno5.cuh's axis_term
// forms them, and each axis's value is lsm::weno5_upwind, summed in the same
// order as K6's, so a node's bits do not depend on where it sits in a tile,
// and a shard's equal the single device's.
// K1'': the velocity program's components are sorted on the host by the axes
// they read, as the tracer found them (ops/coef_program.py `Program.axes`).
// One that does not read axis 0 is evaluated once per column (the rotation's
// u0 and u2), one that reads axis 0 only once per plane of the chunk, into
// shared memory (the rotation's u1). A program with a component that reads
// axis 0 and another axis (the vortex) takes a kernel of one thread per node
// that evaluates each component by the interpreter: the march with the
// interpreter in its plane loop measured slower.
// n0 == 1 (the 2D embedding (1, n0, n1), integrators/fused.py) takes an
// instantiation with axis 0 compiled out: the axis-0 ghosts of a one-node
// axis copy its plane under every boundary condition K2 refreshes
// (Extrapolation(0) in the embedding; the others need more nodes), so every
// axis-0 difference, and the term, is exactly zero (weno5.cuh
// `stage_value_2d` does the same for K6); a step there copies the one plane
// its output needs. The entries require such ghosts there (a buffer as
// pack_padded or K2 leaves it): on other axis-0 ghosts they drop a term that
// the plain stage keeps.
//
// Bound at 512^3 f32: per cell it reads phi once, 3 velocity components and
// aux (stages 2-3), and writes phi: 20-24 B/cell, 0.81-0.97 ms at 3.35 TB/s.
// Its WENO5 is 269 operations per cell (a reciprocal counted as one),
// 0.54 ms at 67 TFLOP/s; few of them pair into FMAs, and with the
// addressing, selects and loads the march issues over 400 instructions a
// node, so the issue rate binds before the bytes (tools/stage_fwd_variants.py
// counts the plane loop's instructions). K1'' reads phi (and aux) and
// writes phi, 8-12 B/cell: its WENO5 arithmetic binds, plus the program's
// own (none per node for the rotation, the interpreter per node for the
// vortex).
//
// The term-list entry (K1') keeps one thread per interior node, threadIdx.x
// along the contiguous last axis so a warp reads and writes 32 neighbouring
// floats; each thread loads its stencils straight from device memory and
// relies on L1/L2 for the reuse between neighbours. It reads phi (and per
// term at most one scalar stream) and writes phi: 8-12 B/cell for the normal,
// curvature and eikonal kinds, ~0.3-0.5 ms at 512^3 f32; a normal or eikonal
// term does ~140 operations per cell, a curvature term ~70, so it sits on the
// FP32 pipes as much as on DRAM. Divisions by spacing constants are products
// by host-computed reciprocals, and a table without advection takes an
// instantiation without WENO5's registers (more threads resident per SM).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "coef_program.cuh"
#include "hamiltonians.cuh"
#include "lsm_kernels.h"
#include "weno5.cuh"

namespace {

// The march of K1 and K1'': a block of NT threads, CX along axis 2 by TY
// along axis 1, each computing NR neighbouring rows of axis 1, so a block
// owns CY x CX columns. A step stages one plane of phi with its halo (RY x
// RX) and the streams of one output plane: aux on a window of AX elements a
// row (from the even column k0 + 2, so that pairs of elements are aligned)
// and, for K1, the three velocity components. DEPTH steps' copies are in
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

// One block's march (see the top of this file); prog is K1'''s velocity
// program (entry 0 of the term table), null for K1; none of its components
// is evaluated per node.
// Step q copies padded plane i0 + q (i0 + q + 3 without axis 0) and, from
// step L on, the streams of output plane i0 + q - L, whose centre plane is
// the one step q - L / 2 copied.
template <typename T, bool kProgram, bool kAxis0>
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
  T* out = a.out + int64_t(i0 + H) * a.s0 + (jf + H) * a.s1 + k + H;  // row 0, plane i0
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
      if (a.aux != nullptr) res = a.alpha * st[Ring::AUX + (jl * NR + r) * AX + kl + 1] + res;
      out[r * a.s1] = res;
    }
    out += a.s0;
  }
}

template <typename T, bool kAxis0>
__global__ void __launch_bounds__(March<T>::NT, March<T>::MIN_BLOCKS)
    stage_march_kernel(const __grid_constant__ MarchArgs<T> a) {
  march<T, false, kAxis0>(a, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(March<T>::NT, March<T>::MIN_BLOCKS)
    stage_march_prog_kernel(const __grid_constant__ MarchArgs<T> a,
                            const __grid_constant__ LsmStageTerms terms) {
  march<T, true, true>(a, &terms.prog);
}

// K1'' for a program with a component evaluated per node (the vortex), and
// on the 2D embedding (one plane: nothing to march, and every component is
// evaluated once per node there): one thread per interior node,
// threadIdx.x along the contiguous last axis, the stencils from device
// memory, each component by the interpreter. The march holding the
// interpreter in its plane loop, and on the embedding, measured slower
// (PERF.md section 6). The per-node arithmetic is the march's.
constexpr int kBlockX = 64;
constexpr int kBlockY = 4;

template <typename T, bool kAxis0>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    stage_node_prog_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                           T* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                           lsm::StageConsts<T> sc, const __grid_constant__ LsmStageTerms terms) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlockX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;
  const int64_t i = blockIdx.z;
  if (k >= n2 || j >= n1 || i >= n0) return;
  const int64_t s1 = n2 + 2 * LSM_GHOST;
  const int64_t s0 = (n1 + 2 * LSM_GHOST) * s1;
  const int64_t c = (i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST);
  const T u1 = lsm::prog_value<T>(terms.prog, 0, 1, i, j, k);
  const T u2 = lsm::prog_value<T>(terms.prog, 0, 2, i, j, k);
  if constexpr (kAxis0) {
    const T u0 = lsm::prog_value<T>(terms.prog, 0, 0, i, j, k);
    out[c] = lsm::stage_value(P, aux, c, s0, s1, u0, u1, u2, sc.inv_h0, sc.inv_h1, sc.inv_h2,
                              sc.alpha, sc.beta, sc.gamma);
  } else {
    out[c] = lsm::stage_value_2d(P, aux, c, s1, u1, u2, sc.inv_h1, sc.inv_h2, sc.alpha,
                                 sc.beta, sc.gamma);
  }
}

// K1 (terms null: the velocity streamed in u) and K1'' (the velocity the
// program of the table's entry 0, whose component d reads the axes of bit
// mask axes[d]): the march over the grid.
template <typename T>
int launch_march(const void* P, const void* const* u, const void* aux, void* out, int64_t n0,
                 int64_t n1, int64_t n2, const double* inv_h, double alpha, double beta,
                 double gamma, const LsmStageTerms* terms, const int* axes, void* stream) {
  using M = March<T>;
  if (n0 > INT_MAX || n1 + 2 * LSM_GHOST > INT_MAX / (n2 + 2 * LSM_GHOST))
    return static_cast<int>(cudaErrorInvalidValue);  // offsets inside a plane are 32-bit
  MarchArgs<T> a{};
  a.P = static_cast<const T*>(P);
  a.aux = static_cast<const T*>(aux);
  a.out = static_cast<T*>(out);
  a.n0 = static_cast<int>(n0);
  a.n1 = static_cast<int>(n1);
  a.n2 = static_cast<int>(n2);
  a.s1 = a.n2 + 2 * LSM_GHOST;
  a.s0 = int64_t(a.n1 + 2 * LSM_GHOST) * a.s1;
  a.m12 = n1 * n2;
  const int chunks = static_cast<int>((n0 + kChunk - 1) / kChunk);  // as even as n0 allows
  a.chunk = static_cast<int>((n0 + chunks - 1) / chunks);
  for (int d = 0; d < 3; ++d) {
    a.u[d] = terms == nullptr ? static_cast<const T*>(u[d]) : nullptr;
    a.inv_h[d] = T(inv_h[d]);
    if (terms != nullptr)
      a.vclass[d] = !(axes[d] & 1) ? kPerColumn : (axes[d] == 1 ? kPerPlane : kPerNode);
  }
  a.alpha = T(alpha);
  a.beta = T(beta);
  a.gamma = T(gamma);
  const auto aligned = [](const void* ptr, size_t bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  a.pairs = a.s1 % 2 == 0 && aligned(P, 2 * sizeof(T)) &&
            (aux == nullptr || aligned(aux, 2 * sizeof(T)));
  a.vec_u = terms == nullptr && a.n2 % M::VU == 0 && aligned(u[0], 16) && aligned(u[1], 16) &&
            aligned(u[2], 16);
  const dim3 grid(static_cast<unsigned>((n2 + M::CX - 1) / M::CX),
                  static_cast<unsigned>((n1 + M::CY - 1) / M::CY), static_cast<unsigned>(chunks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // n0 == 1: the 2D embedding, axis 0 compiled out (its ghosts copy the plane)
  const bool axis0 = n0 > 1;
  cudaError_t err;
  if (terms == nullptr) {
    const auto kernel = axis0 ? stage_march_kernel<T, true> : stage_march_kernel<T, false>;
    const size_t smem = MarchRing<T, false>::BYTES;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) kernel<<<grid, M::NT, smem, s>>>(a);
  } else if (!axis0 || a.vclass[0] == kPerNode || a.vclass[1] == kPerNode ||
             a.vclass[2] == kPerNode) {
    const dim3 block(kBlockX, kBlockY, 1);
    const dim3 nodes(static_cast<unsigned>((n2 + kBlockX - 1) / kBlockX),
                     static_cast<unsigned>((n1 + kBlockY - 1) / kBlockY),
                     static_cast<unsigned>(n0));
    const auto kernel = axis0 ? stage_node_prog_kernel<T, true> : stage_node_prog_kernel<T, false>;
    kernel<<<nodes, block, 0, s>>>(a.P, a.aux, a.out, n0, n1, n2, lsm::StageConsts<T>::of(*terms),
                                   *terms);
    err = cudaSuccess;
  } else {
    const auto kernel = stage_march_prog_kernel<T>;
    const size_t smem = MarchRing<T, true>::BYTES;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) kernel<<<grid, M::NT, smem, s>>>(a, *terms);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_stage(const void* P, const void* u0, const void* u1, const void* u2,
                 const void* aux, void* out, int64_t n0, int64_t n1, int64_t n2,
                 double inv_h0, double inv_h1, double inv_h2, double alpha, double beta,
                 double gamma, void* stream) {
  const void* const u[3] = {u0, u1, u2};
  const double inv_h[3] = {inv_h0, inv_h1, inv_h2};
  return launch_march<T>(P, u, aux, out, n0, n1, n2, inv_h, alpha, beta, gamma, nullptr,
                         nullptr, stream);
}

template <typename T>
int launch_stage_prog(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                      int64_t n2, const LsmStageTerms* terms, const int* axes, void* stream) {
  if (terms->n != 1 || terms->coef[0] != LSM_COEF_PROGRAM ||
      ((axes[0] | axes[1] | axes[2]) & ~7))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_march<T>(P, nullptr, aux, out, n0, n1, n2, terms->inv_h, terms->alpha,
                         terms->beta, terms->gamma, terms, axes, stream);
}

// The term-list entry K1': one thread per interior node (kBlockX x kBlockY
// blocks, as K1'''s per-node kernel).

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
                                       int axes0, int axes1, int axes2, void* stream) {
  const int axes[3] = {axes0, axes1, axes2};
  return launch_stage_prog<float>(P, aux, out, n0, n1, n2, terms, axes, stream);
}

extern "C" int lsm_weno_stage_prog_f64(const void* P, const void* aux, void* out, int64_t n0,
                                       int64_t n1, int64_t n2, const LsmStageTerms* terms,
                                       int axes0, int axes1, int axes2, void* stream) {
  const int axes[3] = {axes0, axes1, axes2};
  return launch_stage_prog<double>(P, aux, out, n0, n1, n2, terms, axes, stream);
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
