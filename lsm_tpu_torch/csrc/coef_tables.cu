// The per-axis tables of coefficient programs (the prologue of K1'', K3''
// and K6''): every subexpression of a traced callable that reads at most one
// coordinate axis (lsm_tpu_torch/ops/coef_program.py) evaluated along that
// axis by the programs' own interpreter (csrc/coef_program.cuh), so that a
// stage kernel reads it per node as one load.
//
// Replaces, with the stage kernels' per-node programs, the "analytic" branch
// of the TPU kernels: lsm_tpu/ops/weno_v2.py `_coords_block` and
// `coef_static(coords, t)` in `_make_kernel`, which Pallas evaluates on the
// block's sparse per-axis coordinate arrays (lsm_tpu/ops/weno_v2_bwd.py and
// lsm_tpu/ops/band_pallas.py the same, with `jax.jvp` for dH/dt).
//
// Design: one thread per table entry over all slots (a few thousand at
// 512^3: n per axis table, 1 per constant one), the slot found by a scan of
// the ascending offsets; the programs are uniform per slot. With tab_dt > 0
// each entry also writes its t-derivative (dual numbers), which K3'' reads
// for the stage time's cotangent. Bound: the tables' bytes, a few KiB: one
// launch's latency.

#include <cuda_runtime.h>

#include "coef_program.cuh"
#include "lsm_kernels.h"

namespace {

constexpr int kBlock = 128;

template <typename T, bool kDual>
__global__ void __launch_bounds__(kBlock)
    prog_tables_kernel(const __grid_constant__ LsmTableFill f) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (q >= f.total) return;
  int s = 0;
  while (s + 1 < f.n && q >= f.prog.tab_off[s + 1]) ++s;
  const int64_t i = q - f.prog.tab_off[s];
  T d = T(0);
  const T v = lsm::prog_run<T, kDual>(f.prog, f.start[s], f.nops[s], i, i, i, &d);
  T* out = static_cast<T*>(const_cast<void*>(f.prog.table));
  out[q] = v;
  if (kDual) out[f.prog.tab_dt + q] = d;
}

template <typename T>
int launch_tables(const LsmTableFill* fill, void* stream) {
  if (fill->total <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((fill->total + kBlock - 1) / kBlock));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fill->prog.tab_dt > 0)
    prog_tables_kernel<T, true><<<grid, kBlock, 0, s>>>(*fill);
  else
    prog_tables_kernel<T, false><<<grid, kBlock, 0, s>>>(*fill);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lsm_prog_tables_f32(const LsmTableFill* fill, void* stream) {
  return launch_tables<float>(fill, stream);
}

extern "C" int lsm_prog_tables_f64(const LsmTableFill* fill, void* stream) {
  return launch_tables<double>(fill, stream);
}
