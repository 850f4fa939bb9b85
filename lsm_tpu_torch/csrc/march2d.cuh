// The 2D march of K1 and K1'' (csrc/weno_stage_2d.cu) and of K11
// (csrc/weno_general.cu): a block of columns of the contiguous axis 1
// marching down a chunk of axis 0, eight padded rows of phi a step and the
// output rows' aux and streams staged in shared memory by cp.async. The
// design is described at the top of weno_stage_2d.cu.
#ifndef LSM_MARCH2D_CUH
#define LSM_MARCH2D_CUH

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "coef_program.cuh"
#include "lsm_kernels.h"
#include "march.cuh"
#include "weno5.cuh"

namespace {

constexpr int kH = LSM_GHOST;
constexpr int kRows = 64;            // rows a block marches over, at most (K1'')
constexpr int kPerRow = kPerPlane;   // K1'': a component that reads the row's coordinate alone

enum { kStream = 0, kProgram = 1 };  // the march's entries: K1 (and K11), K1''

// The 2D march: NT threads, one column each, NR rows of the column a step;
// a row's output LAG steps after its copy (LAG * NR >= 6, the WENO5 reach
// below and above it); DEPTH steps' copies in flight. A stage of the ring
// holds NR rows of phi (RXP elements each), the outputs' aux (AXP each; K11's
// interior-shaped aux CX) and streams (a component NR rows of CX), in that
// order.
template <typename T>
struct March2 {
  static constexpr int NT = 128, CX = NT, NR = 8;
  static constexpr int LAG = (2 * kH + NR - 1) / NR;
  static constexpr int RX = CX + 2 * kH;  // a row of phi: the padded columns k0 .. k0 + CX + 5
  static constexpr int AX = CX + 2;       // aux's window, from the even column k0 + 2
  static constexpr int VU = 16 / sizeof(T);
  static constexpr int DEPTH = 2;
  static constexpr int S = LAG + 1 + DEPTH;  // the ring's stages
  // the parts of a stage start on 16 bytes
  static constexpr int RXP = (RX + 3) / 4 * 4, AXP = (AX + 3) / 4 * 4;
};

template <typename T>
struct March2Args {
  const T* P;
  const T* aux;  // may be null
  T* out;
  int n0, n1, s1, chunk;
  int pairs;   // phi's rows and aux copied two elements at a time
  int vec_s;   // the streams copied 16 bytes at a time
  int elems, aux_at, str_at;  // a stage's elements and where aux and the streams start
  int nstaged;                // the streamed components staged (K1: 2, K1'': 0)
  const T* sptr[2];           // K1: u0, u1
  int vclass[2];              // K1'': kPerColumn or kPerRow of the components 1, 2
  T inv_h[2], alpha, beta, gamma;
};

// One block's march. Step q copies the padded rows i0 + q NR .. i0 + q NR +
// NR - 1 and, from step LAG on, the aux and streams of the output rows o0 ..
// o0 + NR - 1, o0 = i0 + (q - LAG) NR, which it computes from the rows of
// steps q - LAG .. q. prog is K1'''s velocity program (entry 0 of the term
// table), null for K1. kInterior (K11): aux and out are interior-shaped (n0,
// n1); aux is staged as the streams are (16 bytes at a time where vec_aux),
// and the output row stored at the interior index o * n1 + k.
template <typename T, int kKind, bool kInterior = false>
__device__ __forceinline__ void march2d(const March2Args<T>& a, const LsmProgram* prog,
                                        int vec_aux = 0) {
  using M = March2<T>;
  constexpr int NT = M::NT, CX = M::CX, NR = M::NR, RX = M::RX, AX = M::AX, VU = M::VU;
  constexpr int D = M::DEPTH, LAG = M::LAG, S = M::S, RXP = M::RXP, AXP = M::AXP;
  extern __shared__ __align__(16) unsigned char march2d_smem[];
  T* const ring = reinterpret_cast<T*>(march2d_smem);
  __shared__ T vrow[kKind == kProgram ? 2 : 1][kKind == kProgram ? kRows : 1];
  const int t = threadIdx.x, k0 = blockIdx.x * CX, k = k0 + t;
  const int i0 = blockIdx.y * a.chunk, i1 = min(i0 + a.chunk, a.n0);
  const int nq = (i1 - i0 + NR - 1) / NR + LAG;
  const bool kin = k < a.n1;
  // step q's copies (one commit group a step, empty past the last); a chunk
  // off the buffers takes element 0: it fills a slot no node reads
  auto issue = [&](int q) {
    if (q < nq) {
      T* const st = ring + unsigned(q) % S * a.elems;
      const int p0 = i0 + q * NR;  // the step's first padded row of phi
      const int prows = a.n0 + 2 * kH;
      if (a.pairs) {
        for (int f = t; f < NR * (RX / 2); f += NT) {
          const int m = f / (RX / 2), x = 2 * (f - m * (RX / 2)), c = k0 + x;
          const bool in = p0 + m < prows && c < a.s1;
          __pipeline_memcpy_async(st + m * RXP + x, in ? a.P + int64_t(p0 + m) * a.s1 + c : a.P,
                                  2 * sizeof(T));
        }
      } else {
        for (int f = t; f < NR * RX; f += NT) {
          const int m = f / RX, x = f - m * RX, c = k0 + x;
          const bool in = p0 + m < prows && c < a.s1;
          __pipeline_memcpy_async(st + m * RXP + x, in ? a.P + int64_t(p0 + m) * a.s1 + c : a.P,
                                  sizeof(T));
        }
      }
      if (q >= LAG) {
        const int o0 = i0 + (q - LAG) * NR;  // the step's first output row
        if (a.aux != nullptr) {
          T* const dst = st + a.aux_at;
          if constexpr (kInterior) {  // row m: CX elements, as a stream's
            if (vec_aux) {
              for (int f = t; f < NR * (CX / VU); f += NT) {
                const int m = f / (CX / VU), x = (f - m * (CX / VU)) * VU, c = k0 + x;
                __pipeline_memcpy_async(dst + m * CX + x,
                                        o0 + m < a.n0 && c < a.n1
                                            ? a.aux + int64_t(o0 + m) * a.n1 + c : a.aux, 16);
              }
            } else {
              for (int f = t; f < NR * CX; f += NT) {
                const int m = f / CX, x = f - m * CX, c = k0 + x;
                __pipeline_memcpy_async(dst + f,
                                        o0 + m < a.n0 && c < a.n1
                                            ? a.aux + int64_t(o0 + m) * a.n1 + c : a.aux,
                                        sizeof(T));
              }
            }
          } else if (a.pairs) {
            for (int f = t; f < NR * (AX / 2); f += NT) {
              const int m = f / (AX / 2), x = 2 * (f - m * (AX / 2)), c = k0 + 2 + x;
              const bool in = o0 + m < a.n0 && c < a.s1;
              __pipeline_memcpy_async(dst + m * AXP + x,
                                      in ? a.aux + int64_t(o0 + m + kH) * a.s1 + c : a.aux,
                                      2 * sizeof(T));
            }
          } else {
            for (int f = t; f < NR * AX; f += NT) {
              const int m = f / AX, x = f - m * AX, c = k0 + 2 + x;
              const bool in = o0 + m < a.n0 && c < a.s1;
              __pipeline_memcpy_async(dst + m * AXP + x,
                                      in ? a.aux + int64_t(o0 + m + kH) * a.s1 + c : a.aux,
                                      sizeof(T));
            }
          }
        }
        // component sl's row m: NR * CX elements a component
        if (a.vec_s) {
          for (int f = t; f < a.nstaged * NR * (CX / VU); f += NT) {
            const int sl = f / (NR * (CX / VU)), g = f - sl * (NR * (CX / VU));
            const int m = g / (CX / VU), x = (g - m * (CX / VU)) * VU, c = k0 + x;
            const T* const src = a.sptr[sl];
            __pipeline_memcpy_async(st + a.str_at + (sl * NR + m) * CX + x,
                                    o0 + m < a.n0 && c < a.n1 ? src + int64_t(o0 + m) * a.n1 + c
                                                              : src, 16);
          }
        } else {
          for (int f = t; f < a.nstaged * NR * CX; f += NT) {
            const int sl = f / (NR * CX), g = f - sl * (NR * CX);
            const int m = g / CX, x = g - m * CX, c = k0 + x;
            const T* const src = a.sptr[sl];
            __pipeline_memcpy_async(st + a.str_at + f,
                                    o0 + m < a.n0 && c < a.n1 ? src + int64_t(o0 + m) * a.n1 + c
                                                              : src, sizeof(T));
          }
        }
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int q = 0; q < D; ++q) issue(q);
  T uc[2] = {};  // K1'': the column's components
  if constexpr (kKind == kProgram) {
#pragma unroll
    for (int d = 0; d < 2; ++d)
      if (a.vclass[d] == kPerColumn && kin) uc[d] = lsm::prog_value<T>(*prog, 0, d + 1, 0, i0, k);
    for (int e = t; e < 2 * kRows; e += NT) {
      const int d = e / kRows, r = e % kRows;
      if (a.vclass[d] == kPerRow && i0 + r < i1)
        vrow[d][r] = lsm::prog_value<T>(*prog, 0, d + 1, 0, i0 + r, 0);
    }
  }
  for (int q = 0; q < nq; ++q) {
    __pipeline_wait_prior(D - 1);
    __syncthreads();  // step q's copies are in; every thread is done with step q - 1
    issue(q + D);
    if (q < LAG || !kin) continue;
    // the stages of steps q - LAG .. q: padded row o0 + m (m = 0 .. NR + 5) of
    // phi is row m % NR of stage sp[m / NR], at this thread's column
    const T* sp[LAG + 1];
#pragma unroll
    for (int j = 0; j <= LAG; ++j) sp[j] = ring + unsigned(q - LAG + j) % S * a.elems + t + kH;
    const auto row = [&](int m) { return sp[m / NR] + m % NR * RXP; };
    const T* const st = ring + unsigned(q) % S * a.elems;  // the outputs' aux and streams
    const int o0 = i0 + (q - LAG) * NR;
    T* out;
    if constexpr (kInterior)
      out = a.out + int64_t(o0) * a.n1 + k;
    else
      out = a.out + int64_t(o0 + kH) * a.s1 + k + kH;
    // the column's axis-0 differences over the NR rows and their reach
    T col[NR + 2 * kH], dq[NR + 2 * kH - 1];
#pragma unroll
    for (int m = 0; m < NR + 2 * kH; ++m) col[m] = row(m)[0];
    diffs<T, NR + 2 * kH - 1>(col, a.inv_h[0], dq);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int o = o0 + r;
      if (o >= i1) break;
      const T* const c = row(r + kH);  // the output row's own
      T s1[7], d1[6];
#pragma unroll
      for (int m = 0; m < 7; ++m) s1[m] = c[m - kH];
      diffs<T, 6>(s1, a.inv_h[1], d1);
      T u[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        if constexpr (kKind == kStream)
          u[d] = st[a.str_at + (d * NR + r) * CX + t];
        else
          u[d] = a.vclass[d] == kPerColumn ? uc[d] : vrow[d][o - i0];
      }
      // weno5.cuh stage_value_at over two axes, from the same differences
      T ham = lsm::weno5_upwind(dq + r, u[0]);
      ham = ham + lsm::weno5_upwind(d1, u[1]);
      T res = a.beta * c[0] - a.gamma * ham;
      if constexpr (kInterior) {
        if (a.aux != nullptr) res = a.alpha * st[a.aux_at + r * CX + t] + res;
        out[r * a.n1] = res;
      } else {
        if (a.aux != nullptr) res = a.alpha * st[a.aux_at + r * AXP + t + 1] + res;
        out[r * a.s1] = res;
      }
    }
  }
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The march's arguments and grid; false for a shape it does not take.
// interior (K11): aux is interior-shaped (a stage holds NR x CX of it, and
// phi's pairs do not depend on its alignment), and a chunk may exceed kRows
// rows where axis 0 needs more than 65535 chunks (K11 reads no per-row
// table).
template <typename T>
bool march2_args(March2Args<T>& a, const void* P, const void* aux, void* out, int64_t n0,
                 int64_t n1, int nstaged, dim3& grid, bool interior = false) {
  using M = March2<T>;
  int64_t chunks = (n0 + kRows - 1) / kRows;
  if (interior && chunks > 65535) chunks = 65535;
  if (n0 < 1 || n1 < 1 || n0 > INT_MAX / 2 || n1 + 2 * kH > INT_MAX / 2 || chunks > 65535)
    return false;
  a = March2Args<T>{};
  a.P = static_cast<const T*>(P);
  a.aux = static_cast<const T*>(aux);
  a.out = static_cast<T*>(out);
  a.n0 = static_cast<int>(n0);
  a.n1 = static_cast<int>(n1);
  a.s1 = a.n1 + 2 * kH;
  a.chunk = static_cast<int>((n0 + chunks - 1) / chunks);  // as even as n0 allows
  a.pairs = a.s1 % 2 == 0 && aligned(P, 2 * sizeof(T)) &&
            (interior || aux == nullptr || aligned(aux, 2 * sizeof(T)));
  a.nstaged = nstaged;
  a.aux_at = M::NR * M::RXP;
  a.str_at = a.aux_at + (aux != nullptr ? M::NR * (interior ? M::CX : M::AXP) : 0);
  a.elems = a.str_at + nstaged * M::NR * M::CX;
  grid = dim3(static_cast<unsigned>((n1 + M::CX - 1) / M::CX), static_cast<unsigned>(chunks));
  return true;
}

}  // namespace

#endif  // LSM_MARCH2D_CUH
