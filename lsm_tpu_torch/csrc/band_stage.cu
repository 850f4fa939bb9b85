// K6: one fused RK stage over an active-tile dispatch list.
//
// Replaces the TPU kernel lsm_tpu/ops/band_pallas.py `band_stage` (body
// `_make_band_kernel`). For every node of each dispatched tile it writes,
// into the ping-pong target `out`,
//   alpha*aux + beta*phi - gamma*sum of the terms   where the combined band
//                                                   mask is nonzero (the
//                                                   compute band),
//   phi (the source's own value)                    elsewhere in the tile.
// Tiles not on the list are left as they are: off-band cells are frozen in
// every buffer, which is what makes that correct. Three kernels, the TPU
// kernel's branches:
// - K6, one WENO5 advection term with a tile-packed velocity: lsm::stage_
//   value_at (weno5.cuh), K1's per-node stage;
// - K6', any term list (hamiltonians.cuh stage_value_terms, K1''s
//   Hamiltonians, their streamed coefficients tile-packed like the
//   velocity);
// - K6'' (the TPU kernel's "analytic" branch, band_pallas.py:537-545): one
//   advection term whose velocity is a coefficient program
//   (csrc/coef_program.cuh), evaluated at the nodes' own coordinates, so
//   nothing is tile-packed or kept per slot for it. As K1'''s march, each
//   component is evaluated once per column of the tile where it does not
//   read axis 0, once per plane where it reads axis 0 only, else per node
//   (the axes the tracer found, ops/coef_program.py `Program.axes`).
// The formulas are the dense stages', so a node's bits do not depend on the
// path that computed it.
//
// Layout: P, aux and out are padded (n0+6, n1+6, n2+6) buffers; `band` is
// the interior-shaped uint8 combined mask (0 outside, 1 compute band only, 2
// active band); streams are tile-packed, (capacity, B0, B1, B2), indexed by
// dispatch slot. `ids` holds flat tile ids (row-major over the tile grid
// G0 x G1 x G2) or -1 for an empty slot. Ragged edge tiles are masked.
//
// Design: one block of 256 threads per dispatch slot (an empty slot exits
// at once). The block first copies the tile's neighbourhood of phi, the
// (B0+6) x (B1+6) x (B2+6) box of the padded buffer, into shared memory by
// cp.async (pairs of elements where the rows allow), and waits for it once;
// then each thread takes columns of the tile (t1, t2), the contiguous axis
// fastest across a warp, and walks down axis 0: each node reads its stencil
// from the box (32-bit offsets), its mask byte, streams and aux from device
// memory (coalesced across the warp), and stores its value; a node off the
// compute band copies phi from the box's centre. A column's (t1, t2) comes
// from one division, no per-node % or /. The box is 42.6 KB at 16^3 in f32
// (85 KB in f64): five (two) blocks an SM; a tile whose box exceeds a
// block's 227 KB is refused (ops/band.py says so before the launch). A ring
// of planes marching down axis 0 would bound shared memory too, at the cost
// of a barrier a plane; every tile the stepper and the sweep take fits the
// box.
//
// The 2D entries (lsm_band_stage*_2d_*) take a 2D band on its own padded
// (n0+6, n1+6) layout with (B0, B1) tiles and compute the function of the
// (1, n0, n1) embedding that the TPU kernel ran (lsm_tpu/integrators/
// band_fused.py): the same kernels with kFirst = 1, launched as n0 = 1,
// B0 = 1 over the 2D axes, so the tile ids, the slot packing and the
// embedding's term table and programs carry over unchanged, and the per-node
// stage has axis 0 compiled out (weno5.cuh stage_value_at over two axes,
// hamiltonians.cuh kFirst), where every difference of the embedding is
// exactly zero. The box is then one plane, (B0+6) x (B1+6).
//
// Bound: per dispatched node, phi's centre and the mask byte read and the
// output written; on the compute band only, the streams (and aux on later
// RK stages) read. The box re-reads each tile's halo from L2 (2.6 times the
// tile's own nodes at 16^3).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "coef_program.cuh"
#include "hamiltonians.cuh"
#include "lsm_kernels.h"
#include "weno5.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kH = LSM_GHOST;

// How K6'' evaluates a velocity component (K1'''s classes, march.cuh).
enum { kPerColumn = 0, kPerPlane = 1, kPerNode = 2 };

// The launch's geometry: the grid, the tiles and the box's strides.
struct TileArgs {
  int64_t n0, n1, n2;
  int64_t s0, s1;      // the padded buffer's plane and row strides (s0 = 0 in 2D)
  int B0, B1, B2, G1, G2;
  int BP0, BR1, RX;    // the box: planes (1 in 2D), rows, elements a row
  int pairs;           // the box copied two elements at a time
  int vclass[3];       // K6'': kPerColumn, kPerPlane or kPerNode, per component
};

// phi from the box in shared memory, centred at c (strides s0, s1, 1): the
// accessor hamiltonians.cuh's formulas read (as its DeviceNbr does from
// device memory).
template <typename T>
struct BoxNbr {
  const T* box;
  int c, s0, s1;
  __device__ __forceinline__ T at(int d, int m) const {
    return box[c + m * (d == 0 ? s0 : (d == 1 ? s1 : 1))];
  }
  __device__ __forceinline__ T corner(int k, int sa, int sb) const {
    return box[c + sa * (k == 2 ? s1 : s0) + sb * (k == 0 ? s1 : 1)];
  }
};

__device__ __forceinline__ int clip(int64_t x, int hi) {
  return x < hi ? static_cast<int>(x) : hi;
}

// This block's tile: its origin, and its box of P copied into `box` (one
// wait, one barrier). Elements past the buffer's end (a ragged last tile's
// box) are not copied: only nodes off the grid would read them.
template <typename T, int kFirst>
__device__ __forceinline__ void stage_box(const T* __restrict__ P, T* box, const TileArgs& a,
                                          int32_t tid, int64_t& i0, int64_t& j0, int64_t& k0) {
  const int32_t tz = tid / (a.G1 * a.G2), rest = tid - tz * (a.G1 * a.G2);
  const int32_t ty = rest / a.G2;
  i0 = static_cast<int64_t>(tz) * a.B0;
  j0 = static_cast<int64_t>(ty) * a.B1;
  k0 = static_cast<int64_t>(rest - ty * a.G2) * a.B2;
  // the box's first element: padded (i0, j0, k0), node (i0 - 3, j0 - 3, k0 - 3)
  const T* const src = P + i0 * a.s0 + j0 * a.s1 + k0;
  const int lim0 = kFirst ? 1 : clip(a.n0 + 2 * kH - i0, a.BP0);
  const int lim1 = clip(a.n1 + 2 * kH - j0, a.BR1), limx = clip(a.n2 + 2 * kH - k0, a.RX);
  const int unit = a.pairs ? 2 : 1, per_row = a.RX / unit;
  // chunk f = t, t + NT, ...: (plane, row, x), stepped without a division
  const int t = threadIdx.x;
  int row = t / per_row, x = t - row * per_row;
  int b0 = row / a.BR1, b1 = row - b0 * a.BR1;
  const int drow = kThreads / per_row, dx = kThreads - drow * per_row;
  const int db0 = drow / a.BR1, db1 = drow - db0 * a.BR1;
  const int s0 = static_cast<int>(a.s0), s1 = static_cast<int>(a.s1);
  while (b0 < a.BP0) {
    if (b0 < lim0 && b1 < lim1 && x * unit < limx) {
      const int off = b0 * s0 + b1 * s1 + x * unit;
      T* const dst = box + (b0 * a.BR1 + b1) * a.RX + x * unit;
      if (a.pairs)
        __pipeline_memcpy_async(dst, src + off, 2 * sizeof(T));
      else
        __pipeline_memcpy_async(dst, src + off, sizeof(T));
    }
    x += dx;
    b1 += db1;
    b0 += db0;
    if (x >= per_row) {
      x -= per_row;
      ++b1;
    }
    if (b1 >= a.BR1) {
      b1 -= a.BR1;
      ++b0;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// The walk over the tile's nodes, shared by the three kernels: per column
// (t1, t2) of this thread, first(t1, t2, j, k) once, then node(t0, ...) for
// each plane of the column on the grid, with the node's offset in the box
// (L), in the padded buffer from the tile's first node (o) and in the slot's
// packed streams (e), and whether its mask byte is nonzero: the column's
// bytes (m_t: the mask from the tile's first node) are loaded first, 32
// planes at a time, so that their loads are in flight together.
template <int kFirst, typename First, typename Node>
__device__ __forceinline__ void walk(const TileArgs& a, int64_t i0, int64_t j0, int64_t k0,
                                     const uint8_t* __restrict__ m_t, First first, Node node) {
  const int cols = a.B1 * a.B2;
  const int SB1 = a.RX, SB0 = a.BR1 * a.RX;
  const int s0 = static_cast<int>(a.s0), s1 = static_cast<int>(a.s1);
  const int m12 = static_cast<int>(a.n1 * a.n2);
  const int n0 = clip(a.n0 - i0, a.B0);  // planes on the grid
  for (int col = threadIdx.x; col < cols; col += kThreads) {
    const int t1 = col / a.B2, t2 = col - t1 * a.B2;
    const int64_t j = j0 + t1, k = k0 + t2;
    if (j >= a.n1 || k >= a.n2) continue;
    first(t1, t2, j, k);
    int L = (kFirst ? 0 : kH * SB0) + (t1 + kH) * SB1 + t2 + kH;
    int o = t1 * s1 + t2, q = static_cast<int>(t1 * a.n2) + t2, e = col;
    for (int c0 = 0; c0 < n0; c0 += 32) {
      const int cn = n0 - c0 < 32 ? n0 - c0 : 32;
      uint32_t on = 0;  // bit t: plane c0 + t is on the compute band
#pragma unroll 8
      for (int t = 0; t < cn; ++t) on |= (m_t[q + t * m12] != 0 ? 1u : 0u) << t;
      for (int t = 0; t < cn; ++t) {
        node(c0 + t, i0 + c0 + t, j, k, L, o, e, (on >> t) & 1u);
        L += SB0;
        o += s0;
        e += cols;
      }
      q += 32 * m12;
    }
  }
}

// Offsets of the tile's first node: in the padded buffer and in the mask.
__device__ __forceinline__ int64_t padded_first(const TileArgs& a, int64_t i0, int64_t j0,
                                                int64_t k0) {
  return (i0 + kH) * a.s0 + (j0 + kH) * a.s1 + k0 + kH;
}
__device__ __forceinline__ int64_t mask_first(const TileArgs& a, int64_t i0, int64_t j0,
                                              int64_t k0) {
  return (i0 * a.n1 + j0) * a.n2 + k0;
}

template <typename T, int kFirst>
__global__ void __launch_bounds__(kThreads)
    band_stage_kernel(const T* __restrict__ P, const T* __restrict__ u0,
                      const T* __restrict__ u1, const T* __restrict__ u2,
                      const T* __restrict__ aux, T* __restrict__ out,
                      const uint8_t* __restrict__ band, const int32_t* __restrict__ ids,
                      TileArgs a, T inv_h0, T inv_h1, T inv_h2, T alpha, T beta, T gamma) {
  extern __shared__ __align__(16) unsigned char box_smem[];
  T* const box = reinterpret_cast<T*>(box_smem);
  const int32_t tid = ids[blockIdx.x];
  if (tid < 0) return;
  int64_t i0, j0, k0;
  stage_box<T, kFirst>(P, box, a, tid, i0, j0, k0);
  const int64_t pf = padded_first(a, i0, j0, k0);
  T* const o_t = out + pf;
  const T* const a_t = aux == nullptr ? nullptr : aux + pf;
  const uint8_t* const m_t = band + mask_first(a, i0, j0, k0);
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * a.B0 * a.B1 * a.B2;
  const T *const v0 = u0 + slot, *const v1 = u1 + slot, *const v2 = u2 + slot;
  const int SB1 = a.RX, SB0 = a.BR1 * a.RX;
  walk<kFirst>(a, i0, j0, k0, m_t, [](int, int, int64_t, int64_t) {},
               [&](int, int64_t, int64_t, int64_t, int L, int o, int e, bool band_on) {
                 T v;
                 if (band_on) {
                   if constexpr (kFirst == 0) {
                     const int st[3] = {SB0, SB1, 1};
                     const T u[3] = {v0[e], v1[e], v2[e]};
                     const T ih[3] = {inv_h0, inv_h1, inv_h2};
                     v = lsm::stage_value_at<T, 3, int>(box, a_t, L, o, st, u, ih, alpha,
                                                        beta, gamma);
                   } else {
                     const int st[2] = {SB1, 1};
                     const T u[2] = {v1[e], v2[e]};
                     const T ih[2] = {inv_h1, inv_h2};
                     v = lsm::stage_value_at<T, 2, int>(box, a_t, L, o, st, u, ih, alpha,
                                                        beta, gamma);
                   }
                 } else {
                   v = box[L];
                 }
                 o_t[o] = v;
               });
}

template <typename T, bool kAdvection, bool kProgram, int kFirst>
__global__ void __launch_bounds__(kThreads)
    band_stage_terms_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                            T* __restrict__ out, const uint8_t* __restrict__ band,
                            const int32_t* __restrict__ ids, TileArgs a,
                            const __grid_constant__ LsmStageTerms terms) {
  extern __shared__ __align__(16) unsigned char box_smem[];
  T* const box = reinterpret_cast<T*>(box_smem);
  const int32_t tid = ids[blockIdx.x];
  if (tid < 0) return;
  int64_t i0, j0, k0;
  stage_box<T, kFirst>(P, box, a, tid, i0, j0, k0);
  const int64_t pf = padded_first(a, i0, j0, k0);
  T* const o_t = out + pf;
  const T* const a_t = aux == nullptr ? nullptr : aux + pf;
  const uint8_t* const m_t = band + mask_first(a, i0, j0, k0);
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * a.B0 * a.B1 * a.B2;
  const int SB1 = a.RX, SB0 = kFirst ? 0 : a.BR1 * a.RX;
  walk<kFirst>(a, i0, j0, k0, m_t, [](int, int, int64_t, int64_t) {},
               [&](int, int64_t i, int64_t j, int64_t k, int L, int o, int e, bool band_on) {
                 o_t[o] = band_on
                              ? lsm::stage_value_terms<T, kAdvection, kProgram, kFirst>(
                                    BoxNbr<T>{box, L, SB0, SB1}, a_t, o, slot + e, i, j, k,
                                    terms)
                              : box[L];
               });
}

template <typename T, int kFirst>
__global__ void __launch_bounds__(kThreads)
    band_stage_prog_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                           T* __restrict__ out, const uint8_t* __restrict__ band,
                           const int32_t* __restrict__ ids, TileArgs a, lsm::StageConsts<T> sc,
                           const __grid_constant__ LsmStageTerms terms) {
  extern __shared__ __align__(16) unsigned char box_smem[];
  T* const box = reinterpret_cast<T*>(box_smem);
  const int32_t tid = ids[blockIdx.x];
  if (tid < 0) return;
  int64_t i0, j0, k0;
  const int boxn = a.BP0 * a.BR1 * a.RX;
  T* const vplane = box + boxn;  // 3 x B0: the components evaluated once per plane
  {  // before stage_box's barrier
    const int32_t tz = tid / (a.G1 * a.G2);
    for (int f = threadIdx.x; f < 3 * a.B0; f += kThreads) {
      const int d = f / a.B0, t0 = f - d * a.B0;
      const int64_t i = static_cast<int64_t>(tz) * a.B0 + t0;
      if (!kFirst && a.vclass[d] == kPerPlane && i < a.n0)
        vplane[f] = lsm::prog_value<T>(terms.prog, 0, d, i, 0, 0);
    }
  }
  stage_box<T, kFirst>(P, box, a, tid, i0, j0, k0);
  const int64_t pf = padded_first(a, i0, j0, k0);
  T* const o_t = out + pf;
  const T* const a_t = aux == nullptr ? nullptr : aux + pf;
  const uint8_t* const m_t = band + mask_first(a, i0, j0, k0);
  const int SB1 = a.RX, SB0 = a.BR1 * a.RX;
  T uc[3] = {};  // the column's components (kPerColumn)
  walk<kFirst>(
      a, i0, j0, k0, m_t,
      [&](int, int, int64_t j, int64_t k) {
#pragma unroll
        for (int d = kFirst; d < 3; ++d)
          if (kFirst || a.vclass[d] == kPerColumn)
            uc[d] = lsm::prog_value<T>(terms.prog, 0, d, i0, j, k);
      },
      [&](int t0, int64_t i, int64_t j, int64_t k, int L, int o, int, bool band_on) {
        T v;
        if (band_on) {
          if constexpr (kFirst == 0) {
            T u[3];
#pragma unroll
            for (int d = 0; d < 3; ++d)
              u[d] = a.vclass[d] == kPerColumn  ? uc[d]
                     : a.vclass[d] == kPerPlane ? vplane[d * a.B0 + t0]
                                                : lsm::prog_value<T>(terms.prog, 0, d, i, j, k);
            const int st[3] = {SB0, SB1, 1};
            const T ih[3] = {sc.inv_h0, sc.inv_h1, sc.inv_h2};
            v = lsm::stage_value_at<T, 3, int>(box, a_t, L, o, st, u, ih, sc.alpha, sc.beta,
                                               sc.gamma);
          } else {  // the embedding's node (0, j, k); its velocity component 0 is zero
            const int st[2] = {SB1, 1};
            const T u[2] = {uc[1], uc[2]};
            const T ih[2] = {sc.inv_h1, sc.inv_h2};
            v = lsm::stage_value_at<T, 2, int>(box, a_t, L, o, st, u, ih, sc.alpha, sc.beta,
                                               sc.gamma);
          }
        } else {
          v = box[L];
        }
        o_t[o] = v;
      });
}

// The launch's geometry; false for a shape the kernels do not take (a box
// over a block's shared memory, offsets inside a tile past int).
template <typename T>
bool tile_args(TileArgs& a, bool two_d, int64_t n0, int64_t n1, int64_t n2, int64_t B0,
               int64_t B1, int64_t B2, const void* P, size_t& smem, int extra) {
  a = TileArgs{};
  a.n0 = n0;
  a.n1 = n1;
  a.n2 = n2;
  a.s1 = n2 + 2 * kH;
  a.s0 = two_d ? 0 : (n1 + 2 * kH) * a.s1;
  a.B0 = static_cast<int>(B0);
  a.B1 = static_cast<int>(B1);
  a.B2 = static_cast<int>(B2);
  a.G1 = static_cast<int>((n1 + B1 - 1) / B1);
  a.G2 = static_cast<int>((n2 + B2 - 1) / B2);
  a.BP0 = two_d ? 1 : a.B0 + 2 * kH;
  a.BR1 = a.B1 + 2 * kH;
  a.RX = a.B2 + 2 * kH;
  a.pairs = a.RX % 2 == 0 && a.s1 % 2 == 0 && a.B2 % 2 == 0 &&
            reinterpret_cast<uintptr_t>(P) % (2 * sizeof(T)) == 0;
  smem = (static_cast<size_t>(a.BP0) * a.BR1 * a.RX + extra) * sizeof(T);
  const int64_t tiles = ((n0 + B0 - 1) / B0) * a.G1 * a.G2;
  return smem <= 227 * 1024 && tiles <= INT32_MAX &&
         (B0 + 2 * kH) * a.s0 + (B1 + 2 * kH) * a.s1 < INT32_MAX &&
         B0 * n1 * n2 + B1 * n2 < INT32_MAX;
}

template <typename K, typename... Args>
int launch_tiles(K kernel, int64_t capacity, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(capacity), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// kFirst = 1: a 2D band as n0 = 1, B0 = 1 (u0 and inv_h0 not read).
template <typename T, int kFirst = 0>
int launch_band_stage(const void* P, const void* u0, const void* u1, const void* u2,
                      const void* aux, void* out, const void* band, const void* ids,
                      int64_t capacity, int64_t n0, int64_t n1, int64_t n2, int64_t B0,
                      int64_t B1, int64_t B2, double inv_h0, double inv_h1, double inv_h2,
                      double alpha, double beta, double gamma, void* stream) {
  if (capacity <= 0) return 0;
  TileArgs a;
  size_t smem;
  if (!tile_args<T>(a, kFirst, n0, n1, n2, B0, B1, B2, P, smem, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tiles(band_stage_kernel<T, kFirst>, capacity, smem, stream,
                      static_cast<const T*>(P), static_cast<const T*>(u0),
                      static_cast<const T*>(u1), static_cast<const T*>(u2),
                      static_cast<const T*>(aux), static_cast<T*>(out),
                      static_cast<const uint8_t*>(band), static_cast<const int32_t*>(ids), a,
                      T(inv_h0), T(inv_h1), T(inv_h2), T(alpha), T(beta), T(gamma));
}

template <typename T, int kFirst = 0>
int launch_band_stage_terms(const void* P, const void* aux, void* out, const void* band,
                            const void* ids, int64_t capacity, int64_t n0, int64_t n1, int64_t n2,
                            int64_t B0, int64_t B1, int64_t B2, const LsmStageTerms* terms,
                            void* stream) {
  if (terms->n < 1 || terms->n > LSM_MAX_TERMS) return static_cast<int>(cudaErrorInvalidValue);
  if (capacity <= 0) return 0;
  TileArgs a;
  size_t smem;
  if (!tile_args<T>(a, kFirst, n0, n1, n2, B0, B1, B2, P, smem, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool adv = lsm::has_advection(*terms), prog = lsm::has_program(*terms);
  const auto kernel = adv ? (prog ? band_stage_terms_kernel<T, true, true, kFirst>
                                  : band_stage_terms_kernel<T, true, false, kFirst>)
                          : (prog ? band_stage_terms_kernel<T, false, true, kFirst>
                                  : band_stage_terms_kernel<T, false, false, kFirst>);
  return launch_tiles(kernel, capacity, smem, stream, static_cast<const T*>(P),
                      static_cast<const T*>(aux), static_cast<T*>(out),
                      static_cast<const uint8_t*>(band), static_cast<const int32_t*>(ids), a,
                      *terms);
}

// axes[d]: the coordinate axes component d reads (bit a for axis a).
template <typename T, int kFirst = 0>
int launch_band_stage_prog(const void* P, const void* aux, void* out, const void* band,
                           const void* ids, int64_t capacity, int64_t n0, int64_t n1, int64_t n2,
                           int64_t B0, int64_t B1, int64_t B2, const LsmStageTerms* terms,
                           const int* axes, void* stream) {
  if (terms->n != 1 || terms->coef[0] != LSM_COEF_PROGRAM ||
      ((axes[0] | axes[1] | axes[2]) & ~7))
    return static_cast<int>(cudaErrorInvalidValue);
  if (capacity <= 0) return 0;
  TileArgs a;
  size_t smem;
  if (!tile_args<T>(a, kFirst, n0, n1, n2, B0, B1, B2, P, smem, 3 * static_cast<int>(B0)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < 3; ++d)
    a.vclass[d] = !(axes[d] & 1) ? kPerColumn : (axes[d] == 1 ? kPerPlane : kPerNode);
  return launch_tiles(band_stage_prog_kernel<T, kFirst>, capacity, smem, stream,
                      static_cast<const T*>(P), static_cast<const T*>(aux), static_cast<T*>(out),
                      static_cast<const uint8_t*>(band), static_cast<const int32_t*>(ids), a,
                      lsm::StageConsts<T>::of(*terms), *terms);
}

}  // namespace

extern "C" int lsm_band_stage_prog_f32(const void* P, const void* aux, void* out,
                                       const void* band, const void* ids, int64_t capacity,
                                       int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                                       int64_t B2, const LsmStageTerms* terms, int axes0,
                                       int axes1, int axes2, void* stream) {
  const int axes[3] = {axes0, axes1, axes2};
  return launch_band_stage_prog<float>(P, aux, out, band, ids, capacity, n0, n1, n2, B0, B1, B2,
                                       terms, axes, stream);
}

extern "C" int lsm_band_stage_prog_f64(const void* P, const void* aux, void* out,
                                       const void* band, const void* ids, int64_t capacity,
                                       int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                                       int64_t B2, const LsmStageTerms* terms, int axes0,
                                       int axes1, int axes2, void* stream) {
  const int axes[3] = {axes0, axes1, axes2};
  return launch_band_stage_prog<double>(P, aux, out, band, ids, capacity, n0, n1, n2, B0, B1,
                                        B2, terms, axes, stream);
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
  return launch_band_stage<float, 1>(P, u0, u0, u1, aux, out, band, ids, capacity, 1, n0, n1, 1,
                                     B0, B1, 1.0, inv_h0, inv_h1, alpha, beta, gamma, stream);
}

extern "C" int lsm_band_stage_2d_f64(const void* P, const void* u0, const void* u1,
                                     const void* aux, void* out, const void* band,
                                     const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                                     int64_t B0, int64_t B1, double inv_h0, double inv_h1,
                                     double alpha, double beta, double gamma, void* stream) {
  return launch_band_stage<double, 1>(P, u0, u0, u1, aux, out, band, ids, capacity, 1, n0, n1, 1,
                                      B0, B1, 1.0, inv_h0, inv_h1, alpha, beta, gamma, stream);
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

// The 2D program entries evaluate both components per node (a column of a
// 2D tile is one node).
extern "C" int lsm_band_stage_prog_2d_f32(const void* P, const void* aux, void* out,
                                          const void* band, const void* ids, int64_t capacity,
                                          int64_t n0, int64_t n1, int64_t B0, int64_t B1,
                                          const LsmStageTerms* terms, void* stream) {
  const int axes[3] = {7, 7, 7};
  return launch_band_stage_prog<float, 1>(P, aux, out, band, ids, capacity, 1, n0, n1, 1, B0,
                                          B1, terms, axes, stream);
}

extern "C" int lsm_band_stage_prog_2d_f64(const void* P, const void* aux, void* out,
                                          const void* band, const void* ids, int64_t capacity,
                                          int64_t n0, int64_t n1, int64_t B0, int64_t B1,
                                          const LsmStageTerms* terms, void* stream) {
  const int axes[3] = {7, 7, 7};
  return launch_band_stage_prog<double, 1>(P, aux, out, band, ids, capacity, 1, n0, n1, 1, B0,
                                           B1, terms, axes, stream);
}
