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
//   in list order (hamiltonians.cuh). The table travels by value in the
//   kernel's parameters (__grid_constant__, so a loop over it reads the
//   constant bank without a local copy); its branches are uniform.
// The per-node functions are shared with the band stage K6, the march
// (march.cuh) with the general path's K10.
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
// n0 == 1 (a 3D field of one plane, as JAX's (1, n0, n1) embedding of a 2D
// field; a 2D field itself takes the 2D entries of csrc/weno_stage_2d.cu on
// its own (n0+6, n1+6) layout) takes an instantiation with axis 0 compiled
// out: the axis-0 ghosts of a one-node axis copy its plane under every
// boundary condition K2 refreshes (Extrapolation(0); the others need more
// nodes), so every axis-0 difference, and the term, is exactly zero
// (weno5.cuh `stage_value_2d` does the same for K6); a step there copies the
// one plane its output needs. The entries require such ghosts there (a
// buffer as pack_padded or K2 leaves it): on other axis-0 ghosts they drop a
// term that the plain stage keeps.
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
// The term-list entry (K1') marches a block of columns down axis 0 too. A
// step copies a plane of phi with a halo of R = 2 nodes (3 with an advection
// term, a compile-time choice) and the output plane's aux and streamed
// coefficients (as many as
// the ring's budget holds; the rest are read in place). A node loads its
// samples from the tile once into registers (RingNbr, hamiltonians.cuh's
// accessor), forms the pieces its terms share once (second differences,
// Godunov norms, curvature, the recomputed eikonal sign: lsm::term_pieces),
// and without an advection term a thread walks the table once for its four
// rows (lsm::term_share, selects); the constants come in T from the kernel
// parameters, converted on the host. Square roots and divisions are IEEE,
// as K6''s. A table with a program coefficient takes a kernel of one thread
// per node (its interpreter per node; launch_stage_terms chooses from the
// table, ops/weno_v2.py stage_route reports it). Bound at 512^3 f32 on
// config A: phi read once and written, 8 B/cell (0.32 ms), ~200 operations
// a node (0.40 ms at 67 TFLOP/s); the march issues ~480 instructions a node
// with its copies, loads, table walk and the IEEE forms' range checks and
// branches, so the issue rate binds (tools/stage_fwd_variants.py takes it
// apart).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "coef_program.cuh"
#include "hamiltonians.cuh"
#include "lsm_kernels.h"
#include "march.cuh"
#include "weno5.cuh"

namespace {

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
// on a field of one plane (nothing to march, and every component is
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
  // n0 == 1: one plane, axis 0 compiled out (its ghosts copy the plane)
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

// The term-list entry K1'. A table without a program coefficient takes the
// march (see the top of this file): a block of NT threads, CX along axis 2
// by TY along axis 1, each NR rows of axis 1, owns CY x CX columns and
// marches a chunk of axis 0; four rows a thread share the table's walk and
// a plane's fixed costs (tools/stage_fwd_variants.py measured one, two and
// four). R is the stencil's reach: 2 without an advection term (ENO2
// reaches 2; the curvature's mixed differences read the corners at reach
// 1), 3 with one (WENO5). A step copies one plane of phi: rows j0 + 3 - R ..
// j0 + CY + 2 + R of the padded layout (RY rows) and the padded columns k0
// .. k0 + CX + 5 (RX, so that pairs of elements start on an even column),
// and the output plane's aux (CY x AX from the even column k0 + 2, as K1's)
// and streamed coefficients (CY x CX each, as K1's velocity; as many as the
// ring's budget holds, the rest read in place). The ring holds the 2R + 1
// planes a node reads and DEPTH steps' copies in flight; axis 0 is compiled
// out on a field of one plane (kFirst = 1: R0 = 0).
template <typename T, int R, int kFirst>
struct TermsMarch {
  static constexpr int CX = 32, TY = 8, NT = CX * TY, NR = 4, CY = TY * NR;
  static constexpr int RX = CX + 2 * LSM_GHOST, RY = CY + 2 * R, PT = RX * RY, AX = CX + 2;
  static constexpr int VU = 16 / sizeof(T);  // the elements of a 16-byte copy
  static constexpr int R0 = kFirst == 0 ? R : 0;  // the reach along axis 0
  // f32 without advection: three steps in flight (a ring of 8 stages)
  static constexpr int DEPTH = sizeof(T) == 4 ? (R == 2 ? 3 : 2) : 1;
  static constexpr int STAGES = 2 * R0 + 1 + DEPTH;
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 2 : 1;
  // the ring's bytes, at most, so that MIN_BLOCKS blocks fit an SM's 228 KB
  static constexpr size_t BUDGET = 224 * 1024 / MIN_BLOCKS;
  static_assert(PT % 4 == 0 && CY * AX % 4 == 0, "the parts of a stage start on 16 bytes");
};
constexpr int kMaxStaged = 6;  // the streamed components a stage holds, at most

template <typename T>
struct TermsArgs {
  const T* P;
  const T* aux;  // may be null
  T* out;
  int64_t s0;   // padded plane stride
  int64_t m12;  // interior plane size n1 * n2
  int n0, n1, n2, s1, chunk;
  int pairs;  // phi's tile and aux copied two elements at a time (even rows, aligned)
  int vec_s;  // the staged streams copied 16 bytes at a time
  int elems, aux_at, str_at;  // a stage's elements and where aux and the streams start
  int nstaged;                // the streamed components staged
  int slot[LSM_MAX_TERMS];    // term e's first staged component, or -1: read in place
  const T* sptr[kMaxStaged];  // the staged components, in slot order
  lsm::TermConsts<T> k;       // the table's constants in T
};

// In-plane offsets of chunk f of W elements of what a step of the block at
// (j0, k0) copies: the tile of phi, aux's window (from column k0 + 2 of the
// padded row) and a streamed component (interior-shaped). A chunk off the
// buffer takes element 0: it fills a slot that no node reads.
template <typename T, int R, int W>
__device__ __forceinline__ int terms_tile_chunk(const TermsArgs<T>& a, int j0, int k0, int f) {
  constexpr int RX = TermsMarch<T, R, 0>::RX;
  const int r = j0 + LSM_GHOST - R + f / (RX / W), c = k0 + f % (RX / W) * W;
  return r < a.n1 + 2 * LSM_GHOST && c < a.s1 ? r * a.s1 + c : 0;
}
template <typename T, int W>
__device__ __forceinline__ int terms_aux_chunk(const TermsArgs<T>& a, int j0, int k0, int f) {
  constexpr int AX = TermsMarch<T, 2, 0>::AX;
  const int r = f / (AX / W), c = k0 + 2 + f % (AX / W) * W;
  return j0 + r < a.n1 && c < a.s1 ? (j0 + LSM_GHOST + r) * a.s1 + c : 0;
}
template <typename T, int W>
__device__ __forceinline__ int terms_stream_chunk(const TermsArgs<T>& a, int j0, int k0, int f) {
  constexpr int CX = TermsMarch<T, 2, 0>::CX;
  const int r = f / (CX / W), c = k0 + f % (CX / W) * W;
  return j0 + r < a.n1 && c < a.n2 ? (j0 + r) * a.n2 + c : 0;
}

// A node's samples in registers (hamiltonians.cuh's accessor): the centre,
// R on each side along each axis and, for a curvature term, the 12 corners.
template <typename T, int R>
struct RingNbr {
  T c, s[3][2 * R], cr[3][4];
  __device__ __forceinline__ T at(int d, int m) const {
    return m == 0 ? c : s[d][m < 0 ? m + R : m + R - 1];
  }
  __device__ __forceinline__ T corner(int k, int sa, int sb) const {
    return cr[k][(sa < 0 ? 2 : 0) + (sb < 0 ? 1 : 0)];
  }
};

// Load the node at x of its plane's tile from the planes pl[0 .. 2 R0]
// (pl[R0] its own): once, for every term.
template <typename T, int R, int kFirst>
__device__ __forceinline__ void load_nbr(RingNbr<T, R>& n,
                                         const T* const (&pl)[2 * TermsMarch<T, R, kFirst>::R0 + 1],
                                         int x, bool curv) {
  constexpr int R0 = TermsMarch<T, R, kFirst>::R0, RX = TermsMarch<T, R, kFirst>::RX;
  const T* const own = pl[R0];
  n.c = own[x];
#pragma unroll
  for (int m = 1; m <= R; ++m) {
    if constexpr (kFirst == 0) {
      n.s[0][R - m] = pl[R0 - m][x];
      n.s[0][R + m - 1] = pl[R0 + m][x];
    }
    n.s[1][R - m] = own[x - m * RX];
    n.s[1][R + m - 1] = own[x + m * RX];
    n.s[2][R - m] = own[x - m];
    n.s[2][R + m - 1] = own[x + m];
  }
  if (curv) {
#pragma unroll
    for (int sa = 1; sa >= -1; sa -= 2)
#pragma unroll
      for (int sb = 1; sb >= -1; sb -= 2) {
        const int z = (sa < 0 ? 2 : 0) + (sb < 0 ? 1 : 0);
        if constexpr (kFirst == 0) {
          n.cr[0][z] = pl[R0 + sa][x + sb * RX];
          n.cr[1][z] = pl[R0 + sa][x + sb];
        }
        n.cr[2][z] = own[x + sa * RX + sb];
      }
  }
}

// A node's streamed coefficients: a staged component from its stage, at the
// node's place y in the block's columns; the others in place, at the
// interior index q.
template <typename T>
struct StagedStreams {
  const TermsArgs<T>& a;
  const LsmStageTerms& p;
  const T* st;  // the stage of the node's output plane
  int y;
  int64_t q;
  __device__ __forceinline__ T operator()(int e, int d) const {
    constexpr int CC = TermsMarch<T, 2, 0>::CY * TermsMarch<T, 2, 0>::CX;
    const int sl = a.slot[e];
    return sl >= 0 ? st[a.str_at + (sl + d) * CC + y] : static_cast<const T*>(p.stream[e][d])[q];
  }
};

// The march of K1'. Step q copies padded plane i0 + q + 3 - R0 and, from
// step 2 R0 on, the aux and streams of output plane o = i0 + q - 2 R0,
// which it computes from the planes of steps q - 2 R0 .. q. A node loads its
// samples from the tile once (load_nbr), forms the pieces its terms share
// once (lsm::term_pieces), and stores its value.
template <typename T, int R, int kFirst>
__global__ void __launch_bounds__(TermsMarch<T, R, kFirst>::NT,
                                  TermsMarch<T, R, kFirst>::MIN_BLOCKS)
    stage_terms_march_kernel(const __grid_constant__ TermsArgs<T> a,
                             const __grid_constant__ LsmStageTerms p) {
  using M = TermsMarch<T, R, kFirst>;
  constexpr int CX = M::CX, CY = M::CY, NR = M::NR, NT = M::NT, RX = M::RX, PT = M::PT;
  constexpr int AX = M::AX, VU = M::VU, R0 = M::R0, S = M::STAGES, D = M::DEPTH;
  constexpr int H = LSM_GHOST, L = 2 * R0;
  extern __shared__ __align__(16) unsigned char terms_smem[];
  T* const ring = reinterpret_cast<T*>(terms_smem);
  const int t = threadIdx.x, jl = t / CX, kl = t % CX;
  const int j0 = blockIdx.y * CY, k0 = blockIdx.x * CX;
  const int jf = j0 + jl * NR, k = k0 + kl;  // this thread's first row, and its column
  const int i0 = blockIdx.z * a.chunk, i1 = min(i0 + a.chunk, a.n0), nq = i1 - i0 + L;
  // this thread's chunks' offsets on the common path (pairs, 16-byte stream
  // copies); the other computes them at each copy
  constexpr int TP = (PT / 2 + NT - 1) / NT, AP = (CY * AX / 2 + NT - 1) / NT;
  constexpr int SP = (CY * CX / VU + NT - 1) / NT;
  int toff[TP], aoff[AP], soff[SP];
#pragma unroll
  for (int m = 0; m < TP; ++m) toff[m] = terms_tile_chunk<T, R, 2>(a, j0, k0, t + m * NT);
#pragma unroll
  for (int m = 0; m < AP; ++m) aoff[m] = terms_aux_chunk<T, 2>(a, j0, k0, t + m * NT);
#pragma unroll
  for (int m = 0; m < SP; ++m) soff[m] = terms_stream_chunk<T, VU>(a, j0, k0, t + m * NT);
  // step q's copies (one commit group a step, empty past the last)
  auto issue = [&](int q) {
    if (q < nq) {
      T* const st = ring + unsigned(q) % S * a.elems;
      const T* const pp = a.P + int64_t(i0 + q + H - R0) * a.s0;
      if (a.pairs)
        copy_chunks<2, PT / 2, NT>(st, t, [&](int m, int) { return pp + toff[m]; });
      else
        copy_chunks<1, PT, NT>(st, t, [&](int, int f) {
          return pp + terms_tile_chunk<T, R, 1>(a, j0, k0, f);
        });
      if (q >= L) {
        const int o = i0 + q - L;
        if (a.aux != nullptr) {
          const T* const pa = a.aux + int64_t(o + H) * a.s0;
          if (a.pairs)
            copy_chunks<2, CY * AX / 2, NT>(st + a.aux_at, t, [&](int m, int) {
              return pa + aoff[m];
            });
          else
            copy_chunks<1, CY * AX, NT>(st + a.aux_at, t, [&](int, int f) {
              return pa + terms_aux_chunk<T, 1>(a, j0, k0, f);
            });
        }
        for (int sl = 0; sl < a.nstaged; ++sl) {
          const T* const ps = a.sptr[sl] + int64_t(o) * a.m12;
          T* const dst = st + a.str_at + sl * CY * CX;
          if (a.vec_s)
            copy_chunks<VU, CY * CX / VU, NT>(dst, t, [&](int m, int) { return ps + soff[m]; });
          else
            copy_chunks<1, CY * CX, NT>(dst, t, [&](int, int f) {
              return ps + terms_stream_chunk<T, 1>(a, j0, k0, f);
            });
        }
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int q = 0; q < D; ++q) issue(q);
  const int pieces = lsm::pieces_of(p);  // what the table's terms share (uniform)
  const bool curv = pieces & lsm::kCurvature;
  const int x0 = (jl * NR + R) * RX + kl + H;  // row 0's node in its plane's tile
  for (int q = 0; q < nq; ++q) {
    __pipeline_wait_prior(D - 1);
    __syncthreads();  // step q's copies are in; every thread is done with step q - 1
    issue(q + D);
    if (q < L || k >= a.n2) continue;
    const int o = i0 + q - L;
    const T* pl[2 * R0 + 1];
#pragma unroll
    for (int m = 0; m <= 2 * R0; ++m) pl[m] = ring + unsigned(q - L + m) % S * a.elems;
    const int64_t cp = int64_t(o + H) * a.s0, qp = int64_t(o) * a.m12;
    const T* const st = pl[2 * R0];  // the stage that holds the output plane's aux and streams
    if constexpr (R == 3) {  // an advection term: each row's samples stay for WENO5
#pragma unroll 1
      for (int r = 0; r < NR; ++r) {
        const int j = jf + r;
        if (j >= a.n1) break;
        RingNbr<T, R> n;
        load_nbr<T, R, kFirst>(n, pl, x0 + r * RX, curv);
        const StagedStreams<T> s{a, p, st, (jl * NR + r) * CX + kl, qp + j * a.n2 + k};
        const T ham = lsm::term_sum<T, true, false, kFirst>(n, a.k, s, o, j, k, p, pieces);
        T res = lsm::stage_combine(a.k, n.c, ham);
        if (a.aux != nullptr)
          res = lsm::stage_with_aux(a.k, st[a.aux_at + (jl * NR + r) * AX + kl + 1], res);
        a.out[cp + (j + H) * a.s1 + k + H] = res;
      }
    } else {  // the rows' pieces first, then one walk of the table for both rows
      lsm::Pieces<T> pc[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        RingNbr<T, R> n;
        load_nbr<T, R, kFirst>(n, pl, x0 + r * RX, curv);
        pc[r] = lsm::term_pieces<T, kFirst>(n, a.k, pieces);
      }
      T ham[NR] = {};
      for (int e = 0; e < p.n; ++e) {
        const int kind = p.kind[e], coef = p.coef[e];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          // a row past n1 reads no stream (its node is not stored)
          const StagedStreams<T> s{a, p, st, (jl * NR + r) * CX + kl, qp + (jf + r) * a.n2 + k};
          const T v = coef == LSM_COEF_STREAM ? (jf + r < a.n1 ? s(e, 0) : T(0))
                                              : (coef == LSM_COEF_CONST ? a.k.value(e) : T(0));
          ham[r] = ham[r] + lsm::term_share(a.k, pc[r], kind, coef, v);
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int j = jf + r;
        if (j >= a.n1) break;
        T res = lsm::stage_combine(a.k, pc[r].center, ham[r]);
        if (a.aux != nullptr)
          res = lsm::stage_with_aux(a.k, st[a.aux_at + (jl * NR + r) * AX + kl + 1], res);
        a.out[cp + (j + H) * a.s1 + k + H] = res;
      }
    }
  }
}

// Stage the table's streamed components while the ring stays within its
// budget (a term's components all or none), lay a stage out and launch.
template <typename T, int R, int kFirst>
cudaError_t launch_terms_march(TermsArgs<T> a, dim3 grid, const LsmStageTerms& terms,
                               cudaStream_t s) {
  using M = TermsMarch<T, R, kFirst>;
  const auto aligned = [](const void* ptr, size_t bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  a.aux_at = M::PT;
  a.str_at = M::PT + (a.aux != nullptr ? M::CY * M::AX : 0);
  const size_t per = size_t(M::CY) * M::CX * sizeof(T) * M::STAGES;  // a staged component
  const size_t base = size_t(a.str_at) * sizeof(T) * M::STAGES;
  const int room = base >= M::BUDGET ? 0 : static_cast<int>((M::BUDGET - base) / per);
  const int cap = room < kMaxStaged ? room : kMaxStaged;
  a.nstaged = 0;
  a.vec_s = a.n2 % M::VU == 0;
  for (int e = 0; e < terms.n; ++e) {
    const int comps = terms.kind[e] == LSM_TERM_ADVECTION ? 3 : 1;
    a.slot[e] = -1;
    if (terms.coef[e] != LSM_COEF_STREAM || a.nstaged + comps > cap) continue;
    a.slot[e] = a.nstaged;
    for (int d = 0; d < comps; ++d) {
      a.sptr[a.nstaged] = static_cast<const T*>(terms.stream[e][d]);
      a.vec_s = a.vec_s && aligned(terms.stream[e][d], 16);
      ++a.nstaged;
    }
  }
  a.elems = a.str_at + a.nstaged * M::CY * M::CX;
  const size_t smem = size_t(a.elems) * sizeof(T) * M::STAGES;
  const auto kernel = stage_terms_march_kernel<T, R, kFirst>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) kernel<<<grid, M::NT, smem, s>>>(a, terms);
  return err;
}

// K1' for a table with a program coefficient: one thread per interior node
// (kBlockX x kBlockY blocks, as the per-node kernel of K1''), the stencils
// from device memory, the programs by the interpreter per node.
template <typename T, bool kAdvection>
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
  out[c] = lsm::stage_value_terms<T, kAdvection, true, 0>(lsm::DeviceNbr<T>{P, c, s0, s1}, aux,
                                                          c, q, i, j, k, terms);
}

// K1': a table with a program coefficient takes the kernel of one thread
// per node (the march evaluates no program), any other the march.
template <typename T>
int launch_stage_terms(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                       int64_t n2, const LsmStageTerms* terms, void* stream) {
  if (terms->n < 1 || terms->n > LSM_MAX_TERMS) return static_cast<int>(cudaErrorInvalidValue);
  const bool adv = lsm::has_advection(*terms);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lsm::has_program(*terms)) {
    const dim3 block(kBlockX, kBlockY, 1);
    const dim3 grid(static_cast<unsigned>((n2 + kBlockX - 1) / kBlockX),
                    static_cast<unsigned>((n1 + kBlockY - 1) / kBlockY),
                    static_cast<unsigned>(n0));
    const auto kernel = adv ? weno_stage_terms_kernel<T, true> : weno_stage_terms_kernel<T, false>;
    kernel<<<grid, block, 0, s>>>(static_cast<const T*>(P), static_cast<const T*>(aux),
                                  static_cast<T*>(out), n0, n1, n2, *terms);
    return static_cast<int>(cudaGetLastError());
  }
  using M = TermsMarch<T, 2, 0>;  // the block's columns are every instantiation's
  const int64_t chunks = (n0 + kChunk - 1) / kChunk, gy = (n1 + M::CY - 1) / M::CY;
  if (n0 > INT_MAX || chunks > 65535 || gy > 65535 ||
      n1 + 2 * LSM_GHOST > INT_MAX / (n2 + 2 * LSM_GHOST))
    return static_cast<int>(cudaErrorInvalidValue);  // offsets inside a plane are 32-bit
  const auto aligned = [](const void* ptr, size_t bytes) {
    return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
  };
  TermsArgs<T> a{};
  a.P = static_cast<const T*>(P);
  a.aux = static_cast<const T*>(aux);
  a.out = static_cast<T*>(out);
  a.n0 = static_cast<int>(n0);
  a.n1 = static_cast<int>(n1);
  a.n2 = static_cast<int>(n2);
  a.s1 = a.n2 + 2 * LSM_GHOST;
  a.s0 = int64_t(a.n1 + 2 * LSM_GHOST) * a.s1;
  a.m12 = n1 * n2;
  a.chunk = static_cast<int>((n0 + chunks - 1) / chunks);  // as even as n0 allows
  a.pairs = a.s1 % 2 == 0 && aligned(P, 2 * sizeof(T)) &&
            (aux == nullptr || aligned(aux, 2 * sizeof(T)));
  a.k = lsm::TermConsts<T>::of(*terms);
  const dim3 grid(static_cast<unsigned>((n2 + M::CX - 1) / M::CX), static_cast<unsigned>(gy),
                  static_cast<unsigned>(chunks));
  // n0 == 1: one plane, axis 0 compiled out (its ghosts copy the plane)
  const bool axis0 = n0 > 1;
  const cudaError_t err =
      adv ? (axis0 ? launch_terms_march<T, 3, 0>(a, grid, *terms, s)
                   : launch_terms_march<T, 3, 1>(a, grid, *terms, s))
          : (axis0 ? launch_terms_march<T, 2, 0>(a, grid, *terms, s)
                   : launch_terms_march<T, 2, 1>(a, grid, *terms, s));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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
