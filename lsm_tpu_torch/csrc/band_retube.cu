// K8: incremental re-tube of the narrow band over a candidate tile list.
//
// Replaces the TPU kernel lsm_tpu/ops/band_pallas.py `band_retube_incremental`
// (body `_retube_kernels.kernel_mask`). Per candidate tile it recomputes the
// combined band mask (0 outside, 1 compute band only, 2 active band) from
// phi and the old active mask, as the full re-tube does on the whole grid:
//   cut cells   = cells with a corner <= 0 and a corner >= 0 whose 8 corners
//                 are all active (old mask == 2);
//   stamp       = the corner nodes of the cut cells;
//   active      = stamp dilated by a box of radius nlayers;
//   compute     = stamp dilated by a box of radius nlayers + chalo;
//   combined    = compute + active.
// Nodes outside the grid count as not active, so no cell that touches one
// is cut, and the dilations see nothing beyond the faces (the full
// re-tube's zero-flux borders).
//
// The Pallas kernel ran both phases in one call and relied on its grid
// running in order (every read of the old mask done before any write).
// Hopper gives no order between blocks, so here they are two launches on
// one stream:
//   A: one block per candidate slot. The block reads phi and the old mask
//      over its tile and a halo of E = nlayers + chalo + 2 nodes into shared
//      memory (one byte per node: phi <= 0, phi >= 0, active), computes the
//      cut cells, the stamp and the two separable box dilations in shared
//      memory, and writes the new combined tile to `stash[slot]` and whether
//      it holds any band node to `flags[slot]`.
//   B: one block per candidate slot copies `stash[slot]` into the mask.
// An empty slot (-1) writes flags[slot] = 0 in A and nothing else.
//
// The 2D entry (lsm_band_retube_2d_*) re-tubes a 2D band on its own
// (n0+6, n1+6) layout with (B0, B1) tiles: launch A in 2D (4-corner cells,
// two dilations), launch B as in 3D with n0 = 1, B0 = 1. The TPU code could
// not re-tube a 2D band incrementally (its (1, n0, n1) embedding has one-node
// tiles on the dummy axis, below the reach) and re-tubes it in full in XLA
// (lsm_tpu/integrators/band_fused.py `_retube_full`); this entry computes the
// same masks on the candidate tiles.
//
// Bound: per candidate tile the reads of phi (4/8 B) and the mask (1 B)
// over the halo slab, the stash written and read once and the tile written
// once (1 B each per node). Bit-packing the shared-memory masks is later work.

#include <cuda_runtime.h>

#include "lsm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kNonPos = 1;  // phi <= 0
constexpr uint8_t kNonNeg = 2;  // phi >= 0
constexpr uint8_t kActive = 4;  // old combined mask == 2

struct TileGeom {
  int64_t n0, n1, n2;
  int B0, B1, B2, G1, G2;
  int na, nc;  // nlayers, nlayers + chalo
  int E;       // node halo, nc + 2
};

__device__ __forceinline__ void tile_origin(const TileGeom& g, int32_t tid, int64_t& i0,
                                            int64_t& j0, int64_t& k0) {
  i0 = static_cast<int64_t>(tid / (g.G1 * g.G2)) * g.B0;
  j0 = static_cast<int64_t>((tid / g.G2) % g.G1) * g.B1;
  k0 = static_cast<int64_t>(tid % g.G2) * g.B2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    retube_tiles_kernel(const T* __restrict__ P, const uint8_t* __restrict__ band,
                        const int32_t* __restrict__ cand, uint8_t* __restrict__ stash,
                        int32_t* __restrict__ flags, TileGeom g) {
  extern __shared__ uint8_t smem[];
  const int32_t tid = cand[blockIdx.x];
  if (tid < 0) {
    if (threadIdx.x == 0) flags[blockIdx.x] = 0;
    return;
  }
  int64_t i0, j0, k0;
  tile_origin(g, tid, i0, j0, k0);
  const int E = g.E;
  // region sizes: nodes N (tile + 2E), cells N-2, stamp N-4
  const int N0 = g.B0 + 2 * E, N1 = g.B1 + 2 * E, N2 = g.B2 + 2 * E;
  uint8_t* A = smem;                 // N0*N1*N2: node bits, later stamp, later axis-1 pass
  uint8_t* C = smem + N0 * N1 * N2;  // (N0-2)(N1-2)(N2-2): cut cells, later axis-2 pass
  const int64_t s1 = g.n2 + 2 * LSM_GHOST;
  const int64_t s0 = (g.n1 + 2 * LSM_GHOST) * s1;

  // 1. node bits over the tile and its halo; nodes off the grid stay 0
  for (int e = threadIdx.x; e < N0 * N1 * N2; e += kThreads) {
    const int a2 = e % N2, r = e / N2, a1 = r % N1, a0 = r / N1;
    const int64_t i = i0 + a0 - E, j = j0 + a1 - E, k = k0 + a2 - E;
    uint8_t bits = 0;
    if (i >= 0 && i < g.n0 && j >= 0 && j < g.n1 && k >= 0 && k < g.n2) {
      const T v = P[(i + LSM_GHOST) * s0 + (j + LSM_GHOST) * s1 + (k + LSM_GHOST)];
      bits = (v <= T(0) ? kNonPos : 0) | (v >= T(0) ? kNonNeg : 0) |
             (band[(i * g.n1 + j) * g.n2 + k] == 2 ? kActive : 0);
    }
    A[e] = bits;
  }
  __syncthreads();

  // 2. cut cells: cell c (local index cc = c + E - 1) has corners A[cc+1+d]
  const int M0 = N0 - 2, M1 = N1 - 2, M2 = N2 - 2;
  for (int e = threadIdx.x; e < M0 * M1 * M2; e += kThreads) {
    const int c2 = e % M2, r = e / M2, c1 = r % M1, c0 = r / M1;
    uint8_t any_np = 0, any_nn = 0, all_act = kActive;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const uint8_t b = A[((c0 + 1 + (d >> 2)) * N1 + (c1 + 1 + ((d >> 1) & 1))) * N2 +
                          (c2 + 1 + (d & 1))];
      any_np |= b & kNonPos;
      any_nn |= b & kNonNeg;
      all_act &= b;
    }
    C[e] = (any_np && any_nn && (all_act & kActive)) ? 1 : 0;
  }
  __syncthreads();

  // 3. stamp: node n (local s = n + E - 2) is a corner of cells n-1 and n,
  //    C indices s and s+1 per axis
  const int S0 = N0 - 4, S1 = N1 - 4, S2 = N2 - 4;
  uint8_t* S = A;
  for (int e = threadIdx.x; e < S0 * S1 * S2; e += kThreads) {
    const int t2 = e % S2, r = e / S2, t1 = r % S1, t0 = r / S1;
    uint8_t st = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      st |= C[((t0 + (d >> 2)) * M1 + (t1 + ((d >> 1) & 1))) * M2 + (t2 + (d & 1))];
    S[e] = st;
  }
  __syncthreads();

  // 4. box dilation along axis 2 onto the tile's extent: bit 0 radius na,
  //    bit 1 radius nc (stamp index of tile node k is k + E - 2)
  uint8_t* D2 = C;  // S0 x S1 x B2
  for (int e = threadIdx.x; e < S0 * S1 * g.B2; e += kThreads) {
    const int k = e % g.B2, row = e / g.B2;
    const uint8_t* line = S + static_cast<int64_t>(row) * S2 + (k + E - 2);
    uint8_t r3 = 0, r6 = 0;
    for (int d = -g.nc; d <= g.nc; ++d) {
      const uint8_t v = line[d];
      r6 |= v;
      if (d >= -g.na && d <= g.na) r3 |= v;
    }
    D2[e] = r3 | (r6 << 1);
  }
  __syncthreads();

  // 5. along axis 1
  uint8_t* D1 = A;  // S0 x B1 x B2
  for (int e = threadIdx.x; e < S0 * g.B1 * g.B2; e += kThreads) {
    const int k = e % g.B2, r = e / g.B2, j = r % g.B1, t0 = r / g.B1;
    uint8_t acc = 0;
    for (int d = -g.nc; d <= g.nc; ++d) {
      const uint8_t v = D2[(t0 * S1 + (j + E - 2 + d)) * g.B2 + k];
      acc |= v & 2;
      if (d >= -g.na && d <= g.na) acc |= v & 1;
    }
    D1[e] = acc;
  }
  __syncthreads();

  // 6. along axis 0, onto the tile: combined = compute + active
  const int tile = g.B0 * g.B1 * g.B2;
  int any = 0;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int k = e % g.B2, r = e / g.B2, j = r % g.B1, i = r / g.B1;
    uint8_t acc = 0;
    for (int d = -g.nc; d <= g.nc; ++d) {
      const uint8_t v = D1[((i + E - 2 + d) * g.B1 + j) * g.B2 + k];
      acc |= v & 2;
      if (d >= -g.na && d <= g.na) acc |= v & 1;
    }
    const uint8_t comb = static_cast<uint8_t>(((acc >> 1) & 1) + (acc & 1));
    stash[static_cast<int64_t>(blockIdx.x) * tile + e] = comb;
    if (comb != 0 && i0 + i < g.n0 && j0 + j < g.n1 && k0 + k < g.n2) any = 1;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[blockIdx.x] = any;
}

// Launch A of the 2D entry: as retube_tiles_kernel over the geometry's axes 1
// and 2 (n0 == 1, B0 == 1): the node bits of the tile and its halo, the cut
// cells (4 corners), the stamp and the two box dilations.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    retube_tiles_2d_kernel(const T* __restrict__ P, const uint8_t* __restrict__ band,
                           const int32_t* __restrict__ cand, uint8_t* __restrict__ stash,
                           int32_t* __restrict__ flags, TileGeom g) {
  extern __shared__ uint8_t smem[];
  const int32_t tid = cand[blockIdx.x];
  if (tid < 0) {
    if (threadIdx.x == 0) flags[blockIdx.x] = 0;
    return;
  }
  int64_t i0, j0, k0;
  tile_origin(g, tid, i0, j0, k0);
  const int E = g.E;
  const int N1 = g.B1 + 2 * E, N2 = g.B2 + 2 * E;
  uint8_t* A = smem;            // N1*N2: node bits, later stamp
  uint8_t* C = smem + N1 * N2;  // (N1-2)(N2-2): cut cells, later axis-2 pass
  const int64_t s1 = g.n2 + 2 * LSM_GHOST;

  // 1. node bits over the tile and its halo; nodes off the grid stay 0
  for (int e = threadIdx.x; e < N1 * N2; e += kThreads) {
    const int a2 = e % N2, a1 = e / N2;
    const int64_t j = j0 + a1 - E, k = k0 + a2 - E;
    uint8_t bits = 0;
    if (j >= 0 && j < g.n1 && k >= 0 && k < g.n2) {
      const T v = P[(j + LSM_GHOST) * s1 + (k + LSM_GHOST)];
      bits = (v <= T(0) ? kNonPos : 0) | (v >= T(0) ? kNonNeg : 0) |
             (band[j * g.n2 + k] == 2 ? kActive : 0);
    }
    A[e] = bits;
  }
  __syncthreads();

  // 2. cut cells: cell c (local index cc = c + E - 1) has corners A[cc+1+d]
  const int M1 = N1 - 2, M2 = N2 - 2;
  for (int e = threadIdx.x; e < M1 * M2; e += kThreads) {
    const int c2 = e % M2, c1 = e / M2;
    uint8_t any_np = 0, any_nn = 0, all_act = kActive;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint8_t b = A[(c1 + 1 + (d >> 1)) * N2 + (c2 + 1 + (d & 1))];
      any_np |= b & kNonPos;
      any_nn |= b & kNonNeg;
      all_act &= b;
    }
    C[e] = (any_np && any_nn && (all_act & kActive)) ? 1 : 0;
  }
  __syncthreads();

  // 3. stamp: node n (local s = n + E - 2) is a corner of cells n-1 and n
  const int S1 = N1 - 4, S2 = N2 - 4;
  uint8_t* S = A;
  for (int e = threadIdx.x; e < S1 * S2; e += kThreads) {
    const int t2 = e % S2, t1 = e / S2;
    uint8_t st = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) st |= C[(t1 + (d >> 1)) * M2 + (t2 + (d & 1))];
    S[e] = st;
  }
  __syncthreads();

  // 4. box dilation along axis 2 onto the tile's extent: bit 0 radius na,
  //    bit 1 radius nc
  uint8_t* D2 = C;  // S1 x B2
  for (int e = threadIdx.x; e < S1 * g.B2; e += kThreads) {
    const int k = e % g.B2, row = e / g.B2;
    const uint8_t* line = S + static_cast<int64_t>(row) * S2 + (k + E - 2);
    uint8_t r3 = 0, r6 = 0;
    for (int d = -g.nc; d <= g.nc; ++d) {
      const uint8_t v = line[d];
      r6 |= v;
      if (d >= -g.na && d <= g.na) r3 |= v;
    }
    D2[e] = r3 | (r6 << 1);
  }
  __syncthreads();

  // 5. along axis 1, onto the tile: combined = compute + active
  const int tile = g.B1 * g.B2;
  int any = 0;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int k = e % g.B2, j = e / g.B2;
    uint8_t acc = 0;
    for (int d = -g.nc; d <= g.nc; ++d) {
      const uint8_t v = D2[(j + E - 2 + d) * g.B2 + k];
      acc |= v & 2;
      if (d >= -g.na && d <= g.na) acc |= v & 1;
    }
    const uint8_t comb = static_cast<uint8_t>(((acc >> 1) & 1) + (acc & 1));
    stash[static_cast<int64_t>(blockIdx.x) * tile + e] = comb;
    if (comb != 0 && j0 + j < g.n1 && k0 + k < g.n2) any = 1;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[blockIdx.x] = any;
}

__global__ void __launch_bounds__(kThreads)
    retube_writeback_kernel(const int32_t* __restrict__ cand, const uint8_t* __restrict__ stash,
                            uint8_t* __restrict__ band, TileGeom g) {
  const int32_t tid = cand[blockIdx.x];
  if (tid < 0) return;
  int64_t i0, j0, k0;
  tile_origin(g, tid, i0, j0, k0);
  const int tile = g.B0 * g.B1 * g.B2;
  for (int e = threadIdx.x; e < tile; e += kThreads) {
    const int k = e % g.B2, r = e / g.B2, j = r % g.B1, i = r / g.B1;
    if (i0 + i >= g.n0 || j0 + j >= g.n1 || k0 + k >= g.n2) continue;
    band[((i0 + i) * g.n1 + (j0 + j)) * g.n2 + (k0 + k)] =
        stash[static_cast<int64_t>(blockIdx.x) * tile + e];
  }
}

// kTwoD: a 2D band passed as n0 = 1, B0 = 1 (launch A in 2D).
template <typename T, bool kTwoD = false>
int launch_retube(const void* P, void* band, const void* cand, void* stash, void* flags,
                  int64_t ncand, int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                  int64_t B2, int64_t nlayers, int64_t chalo, void* stream_) {
  if (ncand <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  TileGeom g;
  g.n0 = n0;
  g.n1 = n1;
  g.n2 = n2;
  g.B0 = static_cast<int>(B0);
  g.B1 = static_cast<int>(B1);
  g.B2 = static_cast<int>(B2);
  g.G1 = static_cast<int>((n1 + B1 - 1) / B1);
  g.G2 = static_cast<int>((n2 + B2 - 1) / B2);
  g.na = static_cast<int>(nlayers);
  g.nc = static_cast<int>(nlayers + chalo);
  g.E = g.nc + 2;
  const int N0 = g.B0 + 2 * g.E, N1 = g.B1 + 2 * g.E, N2 = g.B2 + 2 * g.E;
  const size_t smem = kTwoD ? static_cast<size_t>(N1) * N2 + static_cast<size_t>(N1 - 2) * (N2 - 2)
                            : static_cast<size_t>(N0) * N1 * N2 +
                                  static_cast<size_t>(N0 - 2) * (N1 - 2) * (N2 - 2);
  const auto kernel = kTwoD ? retube_tiles_2d_kernel<T> : retube_tiles_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ncand), kThreads, smem, stream>>>(
      static_cast<const T*>(P), static_cast<const uint8_t*>(band),
      static_cast<const int32_t*>(cand), static_cast<uint8_t*>(stash),
      static_cast<int32_t*>(flags), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  retube_writeback_kernel<<<static_cast<unsigned>(ncand), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(cand), static_cast<const uint8_t*>(stash),
      static_cast<uint8_t*>(band), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int64_t lsm_band_retube_smem(int64_t B0, int64_t B1, int64_t B2, int64_t nlayers,
                                        int64_t chalo) {
  const int64_t E = nlayers + chalo + 2;
  const int64_t N0 = B0 + 2 * E, N1 = B1 + 2 * E, N2 = B2 + 2 * E;
  return N0 * N1 * N2 + (N0 - 2) * (N1 - 2) * (N2 - 2);
}

extern "C" int lsm_band_retube_f32(const void* P, void* band, const void* cand, void* stash,
                                   void* flags, int64_t ncand, int64_t n0, int64_t n1,
                                   int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                                   int64_t nlayers, int64_t chalo, void* stream) {
  return launch_retube<float>(P, band, cand, stash, flags, ncand, n0, n1, n2, B0, B1, B2,
                              nlayers, chalo, stream);
}

extern "C" int lsm_band_retube_f64(const void* P, void* band, const void* cand, void* stash,
                                   void* flags, int64_t ncand, int64_t n0, int64_t n1,
                                   int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                                   int64_t nlayers, int64_t chalo, void* stream) {
  return launch_retube<double>(P, band, cand, stash, flags, ncand, n0, n1, n2, B0, B1, B2,
                               nlayers, chalo, stream);
}

extern "C" int64_t lsm_band_retube_smem_2d(int64_t B0, int64_t B1, int64_t nlayers,
                                           int64_t chalo) {
  const int64_t E = nlayers + chalo + 2;
  const int64_t N0 = B0 + 2 * E, N1 = B1 + 2 * E;
  return N0 * N1 + (N0 - 2) * (N1 - 2);
}

extern "C" int lsm_band_retube_2d_f32(const void* P, void* band, const void* cand, void* stash,
                                      void* flags, int64_t ncand, int64_t n0, int64_t n1,
                                      int64_t B0, int64_t B1, int64_t nlayers, int64_t chalo,
                                      void* stream) {
  return launch_retube<float, true>(P, band, cand, stash, flags, ncand, 1, n0, n1, 1, B0, B1,
                                    nlayers, chalo, stream);
}

extern "C" int lsm_band_retube_2d_f64(const void* P, void* band, const void* cand, void* stash,
                                      void* flags, int64_t ncand, int64_t n0, int64_t n1,
                                      int64_t B0, int64_t B1, int64_t nlayers, int64_t chalo,
                                      void* stream) {
  return launch_retube<double, true>(P, band, cand, stash, flags, ncand, 1, n0, n1, 1, B0, B1,
                                     nlayers, chalo, stream);
}
