// K1's 2D entries: one fused RK stage of a 2D field on its own padded
// (n0+6, n1+6) layout, the layout of the 2D band.
//
// Replaces the TPU kernel lsm_tpu/ops/weno_v2.py `fused_stage` on a 2D field.
// JAX runs a 2D field through its 3D kernels as the (1, n0, n1) embedding
// (lsm_tpu/integrators/fused.py `_embed_specs_2d`); here the function is the
// embedding's, computed on the 2D layout as K6's 2D entries compute it: the
// same per-node functions with axis 0 of the embedding compiled out
// (weno5.cuh stage_value_at over two axes for one advection term,
// hamiltonians.cuh with kFirst = 1 for a term list), so a node's bits do not
// depend on where it sits, nor on whether the dense or the band stage took it.
// The term table is the embedding's (its spacing and coordinates carry the
// dummy axis, ops/weno_v2.py `embedding_2d`); an advection term's streamed
// velocity is the field's two components (the table's component 0, the
// embedding's zero, is never read). Three entries:
// - K1, one WENO5 advection term, its two velocity components streamed: the
//   2D march;
// - K1'', the same with the velocity a coefficient program
//   (csrc/coef_program.cuh): the 2D march when each component reads one
//   axis or none (ops/coef_program.py `Program.axes`; the rotation's u0
//   reads y alone, once per column, its u1 x alone, once per row of the
//   chunk, into shared memory), a kernel of one thread per node when one
//   reads both (the vortex: its interpreter per node);
// - K1', any term list (advection, normal motion, curvature, eikonal;
//   streamed, constant, program or no coefficient), summed in list order:
//   the per-node form.
//
// The 2D march (march2d.cuh, which K11 also runs with an interior-shaped
// aux and output): a block of 128 threads owns 128 columns of the contiguous
// axis 1, one thread a column, and marches down a chunk of at most 64 rows
// of axis 0, eight rows a step (one, two and four measured slower, as did
// 64 or 256 threads, deeper copies and register caps for more blocks). A
// step copies eight padded rows of phi (the block's columns and their
// 3-node halo) into shared memory by cp.async, with the aux and the streamed
// velocity of the eight output rows one step back (aux from the even column
// before the interior's, so that pairs of elements are aligned; the velocity
// 16 bytes at a time where rows allow); the ring holds the two steps a step
// reads and two steps' copies in flight. Every phi sample is read from HBM
// once, plus the chunk's six halo rows. A thread forms its column's axis-0
// differences over the eight rows and their reach once (thirteen for eight
// nodes), and each node's axis-1 differences from its row. The per-node form (stage_node_2d_kernel): one
// thread a node, its stencils from device memory (L1). The march with a
// term list, one or four rows a step, and with the interpreter per node
// measured slower than one thread a node (tools/stage2d_variants.py).
//
// Bound at 4096^2 f32: K1 reads phi, two velocity components and aux (stages
// 2-3) and writes phi, 16-20 B/cell (0.080-0.100 ms at 3.35 TB/s); its WENO5
// is 181 operations a cell (0.045 ms at 67 TFLOP/s). K1'' reads phi (and aux)
// and writes phi, 8-12 B/cell: 0.040-0.060 ms. The WENO5 arithmetic issues
// about 75 instructions an axis and does not hide behind the copies: the
// issue rate binds.

#include <cuda_runtime.h>

#include <cstdint>

#include "coef_program.cuh"
#include "hamiltonians.cuh"
#include "lsm_kernels.h"
#include "march2d.cuh"
#include "weno5.cuh"

namespace {

// K1 and K1'' 2D: the march of march2d.cuh on the padded layout.
template <typename T, int kKind>
__global__ void __launch_bounds__(March2<T>::NT)
    stage_march_2d_kernel(const __grid_constant__ March2Args<T> a,
                          const __grid_constant__ LsmStageTerms p) {
  march2d<T, kKind>(a, kKind == kProgram ? &p.prog : nullptr);
}

// The per-node form: one thread per interior node, the stencils from device
// memory, K6's 2D function (hamiltonians.cuh stage_value_terms, kFirst = 1)
// over the table. K1' takes it (the march measured slower: PERF.md section
// 6, PR 14); for K1 and K1'' it is the comparison.
constexpr int kNodeX = 64, kNodeY = 4;

// K1'' with a component per node (the vortex): one thread per node, both
// components by the interpreter, K6''s 2D stage (weno5.cuh stage_value_2d);
// the march with the interpreter per node measured slower.
template <typename T>
__global__ void __launch_bounds__(kNodeX* kNodeY)
    stage_node_prog_2d_kernel(const T* __restrict__ P, const T* __restrict__ aux,
                              T* __restrict__ out, int64_t n0, int64_t n1, lsm::StageConsts<T> sc,
                              const __grid_constant__ LsmStageTerms terms) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kNodeX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kNodeY + threadIdx.y;
  if (k >= n1 || j >= n0) return;
  const int64_t s1 = n1 + 2 * kH;
  const int64_t c = (j + kH) * s1 + k + kH;
  const T u1 = lsm::prog_value<T>(terms.prog, 0, 1, 0, j, k);
  const T u2 = lsm::prog_value<T>(terms.prog, 0, 2, 0, j, k);
  out[c] = lsm::stage_value_2d(P, aux, c, s1, u1, u2, sc.inv_h1, sc.inv_h2, sc.alpha, sc.beta,
                               sc.gamma);
}

template <typename T, bool kAdvection, bool kProg>
__global__ void __launch_bounds__(kNodeX* kNodeY)
    stage_node_2d_kernel(const T* __restrict__ P, const T* __restrict__ aux, T* __restrict__ out,
                         int64_t n0, int64_t n1, const __grid_constant__ LsmStageTerms terms) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kNodeX + threadIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kNodeY + threadIdx.y;
  if (k >= n1 || j >= n0) return;
  const int64_t s1 = n1 + 2 * kH;
  const int64_t c = (j + kH) * s1 + k + kH;
  out[c] = lsm::stage_value_terms<T, kAdvection, kProg, 1>(lsm::DeviceNbr<T>{P, c, 0, s1}, aux, c,
                                                          j * n1 + k, 0, j, k, terms);
}

template <typename T, int kKind>
int launch_march_2d(const March2Args<T>& a, dim3 grid, const LsmStageTerms& terms,
                    cudaStream_t s) {
  using M = March2<T>;
  const size_t smem = size_t(a.elems) * sizeof(T) * M::S;
  const auto kernel = stage_march_2d_kernel<T, kKind>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) {
    kernel<<<grid, M::NT, smem, s>>>(a, terms);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T>
int launch_stage_node_2d(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                         const LsmStageTerms* terms, void* stream) {
  if (terms->n < 1 || terms->n > LSM_MAX_TERMS || (n0 + kNodeY - 1) / kNodeY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool adv = lsm::has_advection(*terms), prog = lsm::has_program(*terms);
  const auto kernel = adv ? (prog ? stage_node_2d_kernel<T, true, true>
                                  : stage_node_2d_kernel<T, true, false>)
                          : (prog ? stage_node_2d_kernel<T, false, true>
                                  : stage_node_2d_kernel<T, false, false>);
  const dim3 block(kNodeX, kNodeY, 1);
  const dim3 grid(static_cast<unsigned>((n1 + kNodeX - 1) / kNodeX),
                  static_cast<unsigned>((n0 + kNodeY - 1) / kNodeY));
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(aux), static_cast<T*>(out), n0, n1, *terms);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stage_2d(const void* P, const void* u0, const void* u1, const void* aux, void* out,
                    int64_t n0, int64_t n1, double inv_h0, double inv_h1, double alpha,
                    double beta, double gamma, void* stream) {
  March2Args<T> a;
  dim3 grid;
  if (!march2_args<T>(a, P, aux, out, n0, n1, 2, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  a.sptr[0] = static_cast<const T*>(u0);
  a.sptr[1] = static_cast<const T*>(u1);
  a.vec_s = a.n1 % March2<T>::VU == 0 && aligned(u0, 16) && aligned(u1, 16);
  a.inv_h[0] = T(inv_h0);
  a.inv_h[1] = T(inv_h1);
  a.alpha = T(alpha);
  a.beta = T(beta);
  a.gamma = T(gamma);
  const LsmStageTerms none{};  // the streamed entry reads no table
  return launch_march_2d<T, kStream>(a, grid, none, static_cast<cudaStream_t>(stream));
}

// axes1, axes2: the embedding's axes its components 1 and 2 read (bit a for
// axis a): bit 1 the row's coordinate, bit 2 the column's. A component that
// reads both takes the kernel of one thread per node.
template <typename T>
int launch_stage_prog_2d(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                         const LsmStageTerms* terms, int axes1, int axes2, void* stream) {
  if (terms->n != 1 || terms->coef[0] != LSM_COEF_PROGRAM || ((axes1 | axes2) & ~7))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((axes1 & 6) == 6 || (axes2 & 6) == 6) {
    if ((n0 + kNodeY - 1) / kNodeY > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(kNodeX, kNodeY, 1);
    const dim3 grid(static_cast<unsigned>((n1 + kNodeX - 1) / kNodeX),
                    static_cast<unsigned>((n0 + kNodeY - 1) / kNodeY));
    stage_node_prog_2d_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(P), static_cast<const T*>(aux), static_cast<T*>(out), n0, n1,
        lsm::StageConsts<T>::of(*terms), *terms);
    return static_cast<int>(cudaGetLastError());
  }
  March2Args<T> a;
  dim3 grid;
  if (!march2_args<T>(a, P, aux, out, n0, n1, 0, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const int axes[2] = {axes1, axes2};
  for (int d = 0; d < 2; ++d) a.vclass[d] = axes[d] & 2 ? kPerRow : kPerColumn;
  const lsm::StageConsts<T> sc = lsm::StageConsts<T>::of(*terms);
  a.inv_h[0] = sc.inv_h1;
  a.inv_h[1] = sc.inv_h2;
  a.alpha = sc.alpha;
  a.beta = sc.beta;
  a.gamma = sc.gamma;
  return launch_march_2d<T, kProgram>(a, grid, *terms, static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int lsm_weno_stage_2d_f32(const void* P, const void* u0, const void* u1,
                                     const void* aux, void* out, int64_t n0, int64_t n1,
                                     double inv_h0, double inv_h1, double alpha, double beta,
                                     double gamma, void* stream) {
  return launch_stage_2d<float>(P, u0, u1, aux, out, n0, n1, inv_h0, inv_h1, alpha, beta, gamma,
                                stream);
}

extern "C" int lsm_weno_stage_2d_f64(const void* P, const void* u0, const void* u1,
                                     const void* aux, void* out, int64_t n0, int64_t n1,
                                     double inv_h0, double inv_h1, double alpha, double beta,
                                     double gamma, void* stream) {
  return launch_stage_2d<double>(P, u0, u1, aux, out, n0, n1, inv_h0, inv_h1, alpha, beta, gamma,
                                 stream);
}

extern "C" int lsm_weno_stage_prog_2d_f32(const void* P, const void* aux, void* out, int64_t n0,
                                          int64_t n1, const LsmStageTerms* terms, int axes1,
                                          int axes2, void* stream) {
  return launch_stage_prog_2d<float>(P, aux, out, n0, n1, terms, axes1, axes2, stream);
}

extern "C" int lsm_weno_stage_prog_2d_f64(const void* P, const void* aux, void* out, int64_t n0,
                                          int64_t n1, const LsmStageTerms* terms, int axes1,
                                          int axes2, void* stream) {
  return launch_stage_prog_2d<double>(P, aux, out, n0, n1, terms, axes1, axes2, stream);
}

// K1' (any term table, an advection term's too) takes the per-node form.
extern "C" int lsm_weno_stage_terms_2d_f32(const void* P, const void* aux, void* out, int64_t n0,
                                           int64_t n1, const LsmStageTerms* terms, void* stream) {
  return launch_stage_node_2d<float>(P, aux, out, n0, n1, terms, stream);
}

extern "C" int lsm_weno_stage_terms_2d_f64(const void* P, const void* aux, void* out, int64_t n0,
                                           int64_t n1, const LsmStageTerms* terms, void* stream) {
  return launch_stage_node_2d<double>(P, aux, out, n0, n1, terms, stream);
}

