// K9: write the ghost-shell blocks of a shard's padded buffer in place.
//
// Replaces the TPU kernel lsm_tpu/parallel/fused_evolve.py `write_shell_blocks`
// (pallas_call at :178). On a mesh of shards each shard keeps its block of the
// grid in the uniform padded layout (n0+6, n1+6, n2+6); after a stage the
// sharded refresh (lsm_tpu_torch/parallel/fused_evolve.py) builds the ghost
// shells of the sharded axes 0 and 1 outside the kernel, from the neighbours'
// edge rows (interior faces) or the boundary condition (physical faces), and
// this kernel writes them:
//   block 0, axis 0 left:  rows [0, 3),         columns [3, 3+n1), lanes [3, 3+n2);
//   block 1, axis 0 right: rows [3+n0, n0+6),    the same columns and lanes;
//   block 2, axis 1 left:  rows [0, n0+6),       columns [0, 3),    the same lanes;
//   block 3, axis 1 right: rows [0, n0+6),       columns [3+n1, n1+6).
// The axis-1 blocks span the full axis-0 extent (their caller composed them
// from edge columns that include the fresh axis-0 ghosts), the axis-0 blocks
// the interior columns only, so the four blocks cover disjoint nodes and one
// launch writes them all; corner ghosts then compose as in K2 (axis 0, then
// axis 1). The lane ghosts (axis 2) are left to K2's axis-2 phase, which runs
// after this kernel over the full extent of axes 0 and 1.
//
// Any block may be absent (NULL): an unsharded axis has its shells refreshed
// by K2's single-axis entry instead.
//
// Design: a copy. A CTA covers a few lines of the contiguous axis 2, its
// threads the lanes, so both the read of the contiguous source block and the
// write into the buffer's rows coalesce, and no thread divides by n2 (a first
// version derived each thread's one value from a flat index by 64-bit
// divisions). A block of more than 65535 * kLines lines (rows x columns) is
// refused (cudaErrorInvalidValue): gridDim.y.
//
// Bound: bytes. At 512^3 on 4 shards along axis 0 a shard's two axis-0 blocks
// are 2 x 3 x 512 x 512 values, read once and written once (12.6 MB in f32,
// 3.8 us at 3.35 TB/s): launch latency dominates.

#include <cuda_runtime.h>

#include "lsm_kernels.h"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Blocks {
  const T* src[4];
  unsigned lines[4];  // rows x cols: the block's lines along axis 2
  unsigned cols[4];   // extent along axis 1
  int64_t row0[4];    // first padded row (axis 0) and column (axis 1) written
  int64_t col0[4];
};

// A field of the by-value parameter struct for block k. Indexing the arrays
// with the run-time k would copy the struct to local memory in every thread;
// constant indices read it in place.
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[4], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

// kLines consecutive lines along axis 2 per CTA (blockIdx.y; line = row *
// cols + col), the lanes over the threads, the block over blockIdx.z. A line
// of 512 lanes is two values a thread, so a CTA moves 8 independent values
// per thread.
constexpr int kLines = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shell_blocks_kernel(T* __restrict__ P, int64_t S1, int64_t S2, unsigned n2, Blocks<T> b) {
  const int k = blockIdx.z;
  const T* __restrict__ src = pick(b.src, k);
  if (src == nullptr) return;
  const unsigned lines = pick(b.lines, k), cols = pick(b.cols, k);
  const int64_t row0 = pick(b.row0, k), col0 = pick(b.col0, k);
#pragma unroll
  for (int l = 0; l < kLines; ++l) {
    const unsigned line = blockIdx.y * kLines + l;
    if (line >= lines) return;
    const unsigned row = line / cols;
    const unsigned col = line - row * cols;
    T* __restrict__ dst = P + ((row0 + row) * S1 + col0 + col) * S2 + LSM_GHOST;
    const T* __restrict__ from = src + static_cast<int64_t>(line) * n2;
    for (unsigned lane = threadIdx.x; lane < n2; lane += kThreads) dst[lane] = from[lane];
  }
}

template <typename T>
int launch_shell_blocks(void* P_, int64_t n0, int64_t n1, int64_t n2, const void* l0,
                        const void* r0, const void* l1, const void* r1, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int64_t S0 = n0 + 2 * LSM_GHOST, S1 = n1 + 2 * LSM_GHOST, S2 = n2 + 2 * LSM_GHOST;
  Blocks<T> b;
  const void* src[4] = {l0, r0, l1, r1};
  int64_t most = 0;
  for (int k = 0; k < 4; ++k) {
    const bool axis0 = k < 2;
    const int64_t rows = axis0 ? LSM_GHOST : S0, cols = axis0 ? n1 : LSM_GHOST;
    const int64_t lines = src[k] == nullptr ? 0 : rows * cols;
    if (lines > 65535 * kLines) return static_cast<int>(cudaErrorInvalidValue);  // gridDim.y
    b.src[k] = static_cast<const T*>(src[k]);
    b.lines[k] = static_cast<unsigned>(lines);
    b.cols[k] = static_cast<unsigned>(cols);
    b.row0[k] = axis0 ? (k == 0 ? 0 : LSM_GHOST + n0) : 0;
    b.col0[k] = axis0 ? LSM_GHOST : (k == 2 ? 0 : LSM_GHOST + n1);
    if (lines > most) most = lines;
  }
  if (most == 0 || n2 == 0) return 0;
  const dim3 grid(1, static_cast<unsigned>((most + kLines - 1) / kLines), 4);
  shell_blocks_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<T*>(P_), S1, S2,
                                                        static_cast<unsigned>(n2), b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_shell_blocks_f32(void* P, int64_t n0, int64_t n1, int64_t n2,
                                    const void* l0, const void* r0, const void* l1,
                                    const void* r1, void* stream) {
  return launch_shell_blocks<float>(P, n0, n1, n2, l0, r0, l1, r1, stream);
}

extern "C" int lsm_shell_blocks_f64(void* P, int64_t n0, int64_t n1, int64_t n2,
                                    const void* l0, const void* r0, const void* l1,
                                    const void* r1, void* stream) {
  return launch_shell_blocks<double>(P, n0, n1, n2, l0, r0, l1, r1, stream);
}
