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
// Design: bit planes. A tile's new mask depends on the nodes within
// H = nlayers + chalo + 1 of it (a stamp within nlayers + chalo, a cut cell
// one node further). The block holds that region, R0 x R1 rows along axis 2
// of N2 = B2 + 2H nodes, as rows of W = ceil(N2 / 32) 32-bit words, one bit
// a node (at the default 16^3 tiles and 3 layers: 30 x 30 rows of one word).
// Along axis 2 the cut cells, the stamp and the dilations are shifts and
// ANDs/ORs of words, bits carried across word boundaries; along axes 1 and
// 0 they are ORs (ANDs) of neighbouring rows' words. Only the tile's own
// rows are unpacked to bytes. No per-node % or /; offsets inside a region
// are 32-bit.
//
// One byte a node. A first launch (T) writes each active candidate node's
// signs into its mask byte's bits 4 (phi <= 0) and 5 (phi >= 0), reading
// phi there only. The re-tube (A) then reads only mask bytes: the block
// builds a word of each plane (phi <= 0, phi >= 0, active) from 32 of them,
// loaded as four aligned 16-byte words and taken apart four bytes at a time
// (SWAR). A cell is cut only if its corners are all active, so T tags the
// active nodes only; an active node without tags (in a tile that is no
// candidate, or NaN) takes its signs from phi, so the result is the full
// re-tube's on any candidate list. Shared memory: five planes of R0 * R1 * W
// words (18 KB at the default); at most 48 registers, five blocks an SM.
//
// Only the candidates. `count` (int32 in device memory, compact_ids's
// count) says how many leading slots of `cand` hold tiles; grids of about
// as many blocks as the card holds at once stride over them, so no block
// is launched for the empty slots and nothing is read back to the host.
//
// No stash. The Pallas kernel ran its two phases in one ordered grid; Hopper
// gives no order between blocks. Here a node's new value goes into its mask
// byte's bits 2-3: the byte is written only by its own tile's block, every
// reader takes the low two bits as the old mask (and bits 4-5 as the
// signs), so a read sees the same whether it comes before or after the
// write. A last launch (B) over the candidates shifts each tile's bytes
// down ((v >> 2) & 3: the new value, the tags cleared), after every block of
// A has read what it needs. A node whose new value is 0 is not written in A.
//
// The 2D entry (lsm_band_retube_2d_*) re-tubes a 2D band on its own
// (n0+6, n1+6) layout with (B0, B1) tiles: the same kernels with axis 0
// compiled out (launched as n0 = 1, B0 = 1: one row of the region along
// axis 0, 4-corner cells, two dilations). The TPU code could not re-tube a
// 2D band incrementally (its (1, n0, n1) embedding has one-node tiles on the
// dummy axis, below the reach) and re-tubes it in full in XLA
// (lsm_tpu/integrators/band_fused.py `_retube_full`); this entry computes
// the same masks on the candidate tiles.
//
// Bound: phi (4/8 B) and the mask (1 B) read once over the candidates'
// reach, the new mask written once on the candidate tiles. T reads the
// candidates' mask and the active nodes' phi and writes their tags, A reads
// each region's bytes (a 30^3 region for a 16^3 tile, mostly from L2), B
// reads and writes the candidates' bytes once more. The measured split
// (PERF.md section 6): A's integer work on the planes and its loads
// bind, not the bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "lsm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // tile rows a lane of T or B loads before it stores

struct RetubeGeom {
  int64_t n0, n1, n2;  // the grid (a 2D band: n0 = 1)
  int B0, B1, B2, G1, G2;
  int na, nc;          // nlayers, nlayers + chalo
  int H0, H;           // the region's halo along axis 0 (0 in 2D) and along axes 1, 2
  int R0, R1, N2, W;   // region rows along axes 0 and 1, nodes and words a row
  int ps0, ps1, m12, m2;  // row offsets: P's (s0, s1), the mask's (n1 n2, n2)
  int ncand;
  int lw_shift, lw4_shift;  // log2 of the lanes a tile row takes: a node a lane, four
};

// Bit 0 of bytes 0-3 of x (the others 0) to bits 0-3: the product puts each
// at bits 21-24, where no other term lands.
__device__ __forceinline__ uint32_t gather4(uint32_t x) { return (x * 0x00204081u) >> 21 & 15u; }

// The same for bits 0 and 4 of bytes 0-3 at once: bits 0-3 and 4-7 (the
// two sets of products land at bits 21-24 and 25-28, apart from all others).
__device__ __forceinline__ uint32_t gather8(uint32_t x) { return (x * 0x00204081u) >> 21 & 255u; }

// The 16 bytes of the mask at addr (aligned to 16) into m[0..3], those
// outside [base, end) 0.
__device__ __forceinline__ void load16(uint32_t* m, uintptr_t addr, uintptr_t base,
                                       uintptr_t end) {
  if (addr >= base && addr + 16 <= end) {
    const uint4 v = *reinterpret_cast<const uint4*>(addr);
    m[0] = v.x;
    m[1] = v.y;
    m[2] = v.z;
    m[3] = v.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) m[e] = 0;
#pragma unroll
  for (int e = 0; e < 16; ++e)  // a block the mask holds in part, or not at all
    if (addr + e >= base && addr + e < end)
      m[e / 4] |= uint32_t(*reinterpret_cast<const uint8_t*>(addr + e)) << (8 * (e % 4));
}

// Four mask bytes' planes as nibbles: bits 0-3 active (the low bits == 2),
// 4-7 tagged phi <= 0, 8-11 tagged phi >= 0.
__device__ __forceinline__ uint32_t swar12(uint32_t v) {
  const uint32_t y = (v & 0x03030303u) ^ 0x02020202u;  // a byte 0 where active
  const uint32_t act = ((y | (y >> 1)) & 0x01010101u) ^ 0x01010101u;
  return gather8(act | (v & 0x10101010u)) | gather4((v >> 5) & 0x01010101u) << 8;
}

// Nine words' nibbles of the three planes; bits(p, ph): the 32 bits of plane
// p from byte ph of the first word.
struct Nibbles {
  uint32_t lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};  // words 0-7, word 8
  __device__ __forceinline__ void put(int t, uint32_t p12) {
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t nib = (p12 >> (4 * p)) & 15u;
      if (t < 8)
        lo[p] |= nib << (4 * t);
      else
        hi[p] = nib;
    }
  }
  __device__ __forceinline__ uint32_t bits(int p, int ph) const {
    return ph == 0 ? lo[p] : (lo[p] >> ph) | (hi[p] << (32 - ph));
  }
};

// A node's sign tags: bit 4 phi <= 0, bit 5 phi >= 0 (neither for NaN).
template <typename T>
__device__ __forceinline__ uint32_t sign_bits(T v) {
  return (v <= T(0) ? 16u : 0u) | (v >= T(0) ? 32u : 0u);
}

// Bits 0-3 of x to bit 0 of bytes 0-3.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

__device__ __forceinline__ void tile_origin(const RetubeGeom& g, int32_t tid, int64_t& i0,
                                            int64_t& j0, int64_t& k0) {
  const int32_t tz = tid / (g.G1 * g.G2), rest = tid - tz * (g.G1 * g.G2);
  const int32_t ty = rest / g.G2;
  i0 = static_cast<int64_t>(tz) * g.B0;
  j0 = static_cast<int64_t>(ty) * g.B1;
  k0 = static_cast<int64_t>(rest - ty * g.G2) * g.B2;
}

// Launch T: each candidate tile's active nodes tagged with their signs in
// their mask bytes' bits 4 (phi <= 0) and 5 (phi >= 0), a word of four
// bytes at a time where the rows allow (`words`); an inactive node's signs
// are never read.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    retube_tag_kernel(const T* __restrict__ P, uint8_t* __restrict__ band,
                      const int32_t* __restrict__ cand, const int32_t* __restrict__ count,
                      RetubeGeom g, int words) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = words ? g.lw4_shift : g.lw_shift, lw = 1 << shift;
  const int sub = lane >> shift, x0 = lane & (lw - 1), per_warp = 32 >> shift;
  const int rows0 = g.B0 * g.B1;
  const int nslots = min(*count, g.ncand);
  for (int slot = blockIdx.x; slot < nslots; slot += gridDim.x) {
    const int32_t tid = cand[slot];
    if (tid < 0) continue;
    int64_t i0, j0, k0;
    tile_origin(g, tid, i0, j0, k0);
    const int kn = g.n2 - k0 < g.B2 ? static_cast<int>(g.n2 - k0) : g.B2;
    const int xn = words ? kn / 4 : kn;  // a row's words (bytes)
    for (int qb = warp * per_warp + sub; qb < rows0; qb += kBatch * kWarps * per_warp) {
      for (int x = x0; x < xn; x += lw) {
        // kBatch rows' loads first, then their stores (a byte store may
        // alias phi: the compiler would not move a load above it)
        uint8_t* dst[kBatch];
        uint32_t val[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = qb + u * kWarps * per_warp;
          const int t0 = q / g.B1, t1 = q - t0 * g.B1;
          const int64_t i = i0 + t0, j = j0 + t1;
          dst[u] = nullptr;
          if (q >= rows0 || i >= g.n0 || j >= g.n1) continue;
          uint8_t* const row = band + (i * g.n1 + j) * g.n2 + k0;
          const T* const prow =
              P + (i + LSM_GHOST) * g.ps0 + (j + LSM_GHOST) * g.ps1 + k0 + LSM_GHOST;
          if (words) {  // phi read for the active nodes only: no other's signs are read
            const uint32_t m = reinterpret_cast<const uint32_t*>(row)[x];
            uint32_t tag = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (((m >> (8 * e)) & 3u) == 2u) tag |= sign_bits(prow[4 * x + e]) << (8 * e);
            val[u] = m | tag;
            dst[u] = tag != 0 ? row + 4 * x : nullptr;
          } else {
            const uint32_t m = row[x];
            val[u] = (m & 3u) == 2u ? m | sign_bits(prow[x]) : m;
            dst[u] = val[u] != m ? row + x : nullptr;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (dst[u] == nullptr) continue;
          if (words)
            *reinterpret_cast<uint32_t*>(dst[u]) = val[u];
          else
            *dst[u] = static_cast<uint8_t>(val[u]);
        }
      }
    }
  }
}

// Launch A: each candidate tile's new mask into its bytes' bits 2-3, and its
// activity flag.
template <typename T, bool k2D>
__global__ void __launch_bounds__(kThreads, 5)
    retube_bits_kernel(const T* __restrict__ P, uint8_t* __restrict__ band,
                       const int32_t* __restrict__ cand, const int32_t* __restrict__ count,
                       int32_t* __restrict__ flags, RetubeGeom g, int words) {
  extern __shared__ uint32_t planes[];
  const int W = g.W, R1 = g.R1, rows = g.R0 * R1, PW = rows * W;
  uint32_t* const p0 = planes;           // phi <= 0, then the stamp, then the tile's words
  uint32_t* const p1 = planes + PW;      // phi >= 0, then the stamp dilated by na along axis 2
  uint32_t* const p2 = planes + 2 * PW;  // active, then the stamp dilated by nc along axis 2
  uint32_t* const p3 = planes + 3 * PW;  // cut cells, then axis 1's na dilation
  uint32_t* const p4 = planes + 4 * PW;  // axis 1's nc dilation
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nslots = min(*count, g.ncand);
  const uintptr_t base = reinterpret_cast<uintptr_t>(band);
  const uintptr_t end = base + static_cast<uintptr_t>(g.n0 * g.n1 * g.n2);
  // cell rows along axes 0 and 1 (a 2D band: its one row along axis 0)
  const int crows0 = k2D ? 1 : g.R0 - 1, crows1 = R1 - 1;
  const int rows1 = g.R0 * g.B1, rows0 = g.B0 * g.B1;  // after axis 1's and axis 0's dilation
  for (int slot = blockIdx.x; slot < nslots; slot += gridDim.x) {
    const int32_t tid = cand[slot];
    if (tid < 0) {  // uniform across the block
      if (threadIdx.x == 0) flags[slot] = 0;
      continue;
    }
    int64_t i0, j0, k0;
    tile_origin(g, tid, i0, j0, k0);
    const int64_t ib = i0 - g.H0, jb = j0 - g.H, kb = k0 - g.H;  // the region's first node
    const int64_t ob = (ib * g.n1 + jb) * g.n2 + kb;              // its offset in the mask

    // 1. the node planes: a thread builds word w of row r from the 32 mask
    //    bytes from the node of its bit 0, loaded as four aligned 16-byte
    //    words (L1 serves a row's neighbours) and taken apart four bytes at a
    //    time (SWAR: a byte's bit per plane gathered into a nibble). A node
    //    takes its signs from its byte's tags, or, if it is active and
    //    untagged (outside the candidates, or NaN), from phi; nodes off the
    //    grid or past the region's row are 0 in every plane, and the signs
    //    of an inactive node are not needed (no cell with it is cut).
    for (int it = threadIdx.x; it < rows * W; it += kThreads) {
      const int r = it / W, w = it - r * W;  // per 32 nodes, not per node
      const int a0 = r / R1, a1 = r - a0 * R1;
      const int64_t i = ib + a0, j = jb + a1;
      if (i < 0 || i >= g.n0 || j < 0 || j >= g.n1) {
        p0[it] = p1[it] = p2[it] = 0u;
        continue;
      }
      const int64_t k_w = kb + 32 * w;  // the node of bit 0
      const uintptr_t first = base + ob + a0 * g.m12 + a1 * g.m2 + 32 * w;
      const int ph = static_cast<int>(first & 3), q4 = static_cast<int>((first >> 2) & 3);
      uint32_t m[16];  // the 64 bytes from first's 16-byte word: words q4 .. q4 + 8 are used
#pragma unroll
      for (int u = 0; u < 4; ++u) load16(m + 4 * u, (first & ~uintptr_t(15)) + 16 * u, base, end);
      Nibbles n;
#pragma unroll
      for (int t = 0; t < 9; ++t)  // word q4 + t, q4 in 0..3: no dynamic register index
        n.put(t, swar12(q4 == 0 ? m[t] : q4 == 1 ? m[t + 1] : q4 == 2 ? m[t + 2] : m[t + 3]));
      // the row's nodes on the grid: bits [lo, hi) of word w
      const int lo = k_w < 0 ? static_cast<int>(-k_w) : 0;
      int hi = g.N2 - 32 * w < 32 ? g.N2 - 32 * w : 32;
      if (g.n2 - k_w < hi) hi = static_cast<int>(g.n2 - k_w);
      const uint32_t keep =
          hi <= lo ? 0u : (hi >= 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
      const uint32_t ac = n.bits(0, ph) & keep;
      uint32_t np = n.bits(1, ph) & ac, nn = n.bits(2, ph) & ac;
      for (uint32_t un = ac & ~(np | nn); un != 0; un &= un - 1) {  // active, untagged
        const int b = __ffs(un) - 1;
        const T v = P[(i + LSM_GHOST) * g.ps0 + (j + LSM_GHOST) * g.ps1 + k_w + b + LSM_GHOST];
        np |= (v <= T(0) ? 1u : 0u) << b;
        nn |= (v >= T(0) ? 1u : 0u) << b;
      }
      p0[it] = np;
      p1[it] = nn;
      p2[it] = ac;
    }
    __syncthreads();

    // 2. cut cells, stored at their lower corner's row: cell bit c of row
    //    (c0, c1) has corners at bits c, c + 1 of rows c0..c0+1, c1..c1+1
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int c0 = r / R1, c1 = r - c0 * R1;
      uint32_t* const out = p3 + r * W;
      if (c0 >= crows0 || c1 >= crows1) {
        for (int w = 0; w < W; ++w) out[w] = 0;
        continue;
      }
      const auto any = [&](const uint32_t* p, int w) {
        uint32_t x = p[r * W + w] | p[(r + 1) * W + w];
        if constexpr (!k2D) x |= p[(r + R1) * W + w] | p[(r + R1 + 1) * W + w];
        return x;
      };
      const auto all = [&](const uint32_t* p, int w) {
        uint32_t x = p[r * W + w] & p[(r + 1) * W + w];
        if constexpr (!k2D) x &= p[(r + R1) * W + w] & p[(r + R1 + 1) * W + w];
        return x;
      };
      uint32_t np = any(p0, 0), nn = any(p1, 0), ac = all(p2, 0);
      for (int w = 0; w < W; ++w) {
        const bool more = w + 1 < W;
        const uint32_t np1 = more ? any(p0, w + 1) : 0u, nn1 = more ? any(p1, w + 1) : 0u;
        const uint32_t ac1 = more ? all(p2, w + 1) : 0u;
        // bit c of x | x >> 1, carried: node c or node c + 1
        const uint32_t cnp = np | (np >> 1) | (np1 << 31);
        const uint32_t cnn = nn | (nn >> 1) | (nn1 << 31);
        const uint32_t cac = ac & ((ac >> 1) | (ac1 << 31));
        out[w] = cnp & cnn & cac;
        np = np1;
        nn = nn1;
        ac = ac1;
      }
    }
    __syncthreads();

    // 3. the stamp: node s is a corner of cells s - 1 and s along each axis
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int s0_ = r / R1, s1_ = r - s0_ * R1;
      uint32_t prev = 0;
      for (int w = 0; w < W; ++w) {
        uint32_t x = 0;
#pragma unroll
        for (int d0 = k2D ? 0 : -1; d0 <= 0; ++d0) {
          const int c0 = s0_ + d0;
          if (c0 < 0 || c0 >= crows0) continue;
#pragma unroll
          for (int d1 = -1; d1 <= 0; ++d1) {
            const int c1 = s1_ + d1;
            if (c1 >= 0 && c1 < crows1) x |= p3[(c0 * R1 + c1) * W + w];
          }
        }
        p0[r * W + w] = x | (x << 1) | (prev >> 31);  // bit s: cell s or cell s - 1
        prev = x;
      }
    }
    __syncthreads();

    // 4. the box dilations along axis 2 (radii na and nc <= 31: a shift
    //    crosses at most one word boundary)
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const uint32_t* const x = p0 + r * W;
      if (W == 1) {  // one word: radius 1 at a time (D_a then D_b is D_(a+b))
        uint32_t a = x[0];
        for (int d = 0; d < g.na; ++d) a |= (a << 1) | (a >> 1);
        uint32_t c = a;
        for (int d = g.na; d < g.nc; ++d) c |= (c << 1) | (c >> 1);
        p1[r] = a;
        p2[r] = c;
        continue;
      }
      for (int w = 0; w < W; ++w) {
        const uint32_t xm = w > 0 ? x[w - 1] : 0u, x0 = x[w], xp = w + 1 < W ? x[w + 1] : 0u;
        uint32_t a = x0, c = x0;
        for (int d = 1; d <= g.nc; ++d) {
          const uint32_t s = (x0 << d) | (xm >> (32 - d)) | (x0 >> d) | (xp << (32 - d));
          c |= s;
          if (d <= g.na) a |= s;
        }
        p1[r * W + w] = a;
        p2[r * W + w] = c;
      }
    }
    __syncthreads();

    // 5. along axis 1, onto the tile's rows (region rows t1 + H +- radius)
    for (int q = threadIdx.x; q < rows1; q += kThreads) {
      const int a0 = q / g.B1, t1 = q - a0 * g.B1;
      const int base = a0 * R1 + t1 + g.H;
      for (int w = 0; w < W; ++w) {
        uint32_t a = 0, c = 0;
        for (int d = -g.na; d <= g.na; ++d) a |= p1[(base + d) * W + w];
        for (int d = -g.nc; d <= g.nc; ++d) c |= p2[(base + d) * W + w];
        p3[q * W + w] = a;
        p4[q * W + w] = c;
      }
    }
    __syncthreads();

    // 6. along axis 0, onto the tile's rows: the tile's active and compute
    //    words into p0 (a 2D band: the rows as they are)
    uint32_t* const fa = p0;
    uint32_t* const fc = p0 + rows0 * W;
    for (int q = threadIdx.x; q < rows0; q += kThreads) {
      const int t0 = q / g.B1, t1 = q - t0 * g.B1;
      for (int w = 0; w < W; ++w) {
        uint32_t a = 0, c = 0;
        if constexpr (k2D) {
          a = p3[q * W + w];
          c = p4[q * W + w];
        } else {
          const int rr = ((t0 + g.H0) * g.B1 + t1) * W + w, step = g.B1 * W;
          for (int d = -g.na; d <= g.na; ++d) a |= p3[rr + d * step];
          for (int d = -g.nc; d <= g.nc; ++d) c |= p4[rr + d * step];
        }
        fa[q * W + w] = a;
        fc[q * W + w] = c;
      }
    }
    __syncthreads();

    // 7. unpack the tile's rows: a group of lanes a row, four nodes a lane
    //    (`words`: a word of the mask) or one; a node whose new value is
    //    nonzero gets it in its byte's high bits
    const int kn = g.n2 - k0 < g.B2 ? static_cast<int>(g.n2 - k0) : g.B2;
    const int shift = words ? g.lw4_shift : g.lw_shift, lw = 1 << shift;
    const int sub = lane >> shift, x0 = lane & (lw - 1), per_warp = 32 >> shift;
    int anyset = 0;
    for (int q = warp * per_warp + sub; q < rows0; q += kWarps * per_warp) {
      const int t0 = q / g.B1, t1 = q - t0 * g.B1;
      const int64_t i = i0 + t0, j = j0 + t1;
      if (i >= g.n0 || j >= g.n1) continue;
      uint8_t* const row = band + (i * g.n1 + j) * g.n2 + k0;
      if (words) {
        uint32_t* const row4 = reinterpret_cast<uint32_t*>(row);
        for (int x = x0; x < kn / 4; x += lw) {
          const int b = 4 * x + g.H, wi = b >> 5;
          const bool two = wi + 1 < W;
          const uint64_t a = fa[q * W + wi] | (two ? uint64_t(fa[q * W + wi + 1]) << 32 : 0u);
          const uint64_t c = fc[q * W + wi] | (two ? uint64_t(fc[q * W + wi + 1]) << 32 : 0u);
          const uint32_t nv = spread4(static_cast<uint32_t>(a >> (b & 31)) & 15u) +
                              spread4(static_cast<uint32_t>(c >> (b & 31)) & 15u);
          if (nv != 0) {
            row4[x] |= nv << 2;
            anyset = 1;
          }
        }
      } else {
        for (int t2 = x0; t2 < kn; t2 += lw) {
          const int b = t2 + g.H;
          const uint32_t nv = ((fa[q * W + (b >> 5)] >> (b & 31)) & 1u) +
                              ((fc[q * W + (b >> 5)] >> (b & 31)) & 1u);
          if (nv != 0) {
            row[t2] = static_cast<uint8_t>(row[t2] | (nv << 2));
            anyset = 1;
          }
        }
      }
    }
    anyset = __syncthreads_or(anyset);  // also: every thread is done with the planes
    if (threadIdx.x == 0) flags[slot] = anyset;
  }
}

// Launch B: each candidate tile's bytes shifted down to their new value, a
// word of four bytes at a time where the rows allow (`words`).
__global__ void __launch_bounds__(kThreads)
    retube_decode_kernel(const int32_t* __restrict__ cand, const int32_t* __restrict__ count,
                         uint8_t* __restrict__ band, RetubeGeom g, int words) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = words ? g.lw4_shift : g.lw_shift, lw = 1 << shift;
  const int sub = lane >> shift, x0 = lane & (lw - 1), per_warp = 32 >> shift;
  const int rows0 = g.B0 * g.B1;
  const int nslots = min(*count, g.ncand);
  for (int slot = blockIdx.x; slot < nslots; slot += gridDim.x) {
    const int32_t tid = cand[slot];
    if (tid < 0) continue;
    int64_t i0, j0, k0;
    tile_origin(g, tid, i0, j0, k0);
    const int kn = g.n2 - k0 < g.B2 ? static_cast<int>(g.n2 - k0) : g.B2;
    const int xn = words ? kn / 4 : kn;  // a row's words (bytes)
    for (int qb = warp * per_warp + sub; qb < rows0; qb += kBatch * kWarps * per_warp) {
      for (int x = x0; x < xn; x += lw) {
        uint8_t* dst[kBatch];  // kBatch rows' loads first, then their stores
        uint32_t val[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = qb + u * kWarps * per_warp;
          const int t0 = q / g.B1, t1 = q - t0 * g.B1;
          const int64_t i = i0 + t0, j = j0 + t1;
          dst[u] = nullptr;
          if (q >= rows0 || i >= g.n0 || j >= g.n1) continue;
          uint8_t* const row = band + (i * g.n1 + j) * g.n2 + k0;
          dst[u] = words ? row + 4 * x : row + x;
          val[u] = words ? *reinterpret_cast<const uint32_t*>(dst[u]) : *dst[u];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (dst[u] == nullptr || val[u] == 0) continue;
          if (words)  // the new value; tags cleared
            *reinterpret_cast<uint32_t*>(dst[u]) = (val[u] >> 2) & 0x03030303u;
          else
            *dst[u] = static_cast<uint8_t>((val[u] >> 2) & 3u);
        }
      }
    }
  }
}

RetubeGeom make_geom(bool two_d, int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                     int64_t B2, int64_t nlayers, int64_t chalo, int64_t ncand) {
  RetubeGeom g;
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
  g.H = g.nc + 1;
  g.H0 = two_d ? 0 : g.H;
  g.R0 = g.B0 + 2 * g.H0;
  g.R1 = g.B1 + 2 * g.H;
  g.N2 = g.B2 + 2 * g.H;
  g.W = (g.N2 + 31) / 32;
  g.ps1 = static_cast<int>(n2 + 2 * LSM_GHOST);
  g.ps0 = two_d ? 0 : static_cast<int>((n1 + 2 * LSM_GHOST) * (n2 + 2 * LSM_GHOST));
  g.m2 = static_cast<int>(n2);
  g.m12 = two_d ? 0 : static_cast<int>(n1 * n2);
  g.ncand = static_cast<int>(ncand);
  g.lw_shift = 0;
  while ((1 << g.lw_shift) < g.B2 && g.lw_shift < 5) ++g.lw_shift;
  g.lw4_shift = 0;
  while ((1 << g.lw4_shift) < (g.B2 + 3) / 4 && g.lw4_shift < 5) ++g.lw4_shift;
  return g;
}

// Launch A's shared memory: five bit planes.
int64_t planes_bytes(const RetubeGeom& g) {
  return 5 * static_cast<int64_t>(g.R0) * g.R1 * g.W * static_cast<int64_t>(sizeof(uint32_t));
}

// The shapes the kernels take: radii of at most 31 (a shift crosses one
// word boundary), tiles at least the reach deep, ids and offsets in int.
bool geom_ok(const RetubeGeom& g, int64_t nlayers, int64_t chalo, int64_t ncand) {
  const int64_t tiles = static_cast<int64_t>((g.n0 + g.B0 - 1) / g.B0) * g.G1 * g.G2;
  const int64_t s1 = g.n2 + 2 * LSM_GHOST, s0 = (g.n1 + 2 * LSM_GHOST) * s1;
  return nlayers >= 0 && chalo >= 0 && nlayers + chalo <= 31 && ncand <= INT32_MAX &&
         tiles <= INT32_MAX && planes_bytes(g) <= 227 * 1024 &&
         g.R0 * s0 + g.R1 * s1 + g.N2 < INT32_MAX && g.R0 * g.n1 * g.n2 < INT32_MAX;
}

// Grid: as many blocks as the card holds at once, at most one a slot.
template <typename K>
int resident_grid(K kernel, size_t smem, int64_t ncand) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(ncand < full ? ncand : full);
}

// kTwoD: a 2D band passed as n0 = 1, B0 = 1.
template <typename T, bool kTwoD = false>
int launch_retube(const void* P, void* band, const void* cand, const void* count, void* flags,
                  int64_t ncand, int64_t n0, int64_t n1, int64_t n2, int64_t B0, int64_t B1,
                  int64_t B2, int64_t nlayers, int64_t chalo, void* stream_) {
  if (ncand <= 0) return 0;
  const RetubeGeom g = make_geom(kTwoD, n0, n1, n2, B0, B1, B2, nlayers, chalo, ncand);
  if (!geom_ok(g, nlayers, chalo, ncand)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const size_t smem = static_cast<size_t>(planes_bytes(g));
  const auto bits = retube_bits_kernel<T, kTwoD>;
  cudaError_t err = cudaFuncSetAttribute(bits, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid_a = resident_grid(bits, smem, ncand);
  const int grid_b = resident_grid(retube_decode_kernel, 0, ncand);
  const int grid_t = resident_grid(retube_tag_kernel<T>, 0, ncand);
  if (grid_a <= 0 || grid_b <= 0 || grid_t <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // four bytes at a time: rows and tiles a multiple of 4 long, the mask aligned
  const int words = n2 % 4 == 0 && B2 % 4 == 0 && reinterpret_cast<uintptr_t>(band) % 4 == 0;
  retube_tag_kernel<T><<<grid_t, kThreads, 0, stream>>>(
      static_cast<const T*>(P), static_cast<uint8_t*>(band), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(count), g, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bits<<<grid_a, kThreads, smem, stream>>>(
      static_cast<const T*>(P), static_cast<uint8_t*>(band), static_cast<const int32_t*>(cand),
      static_cast<const int32_t*>(count), static_cast<int32_t*>(flags), g, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  retube_decode_kernel<<<grid_b, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(cand), static_cast<const int32_t*>(count),
      static_cast<uint8_t*>(band), g, words);
  return static_cast<int>(cudaGetLastError());
}

int64_t smem_or_refusal(bool two_d, int64_t B0, int64_t B1, int64_t B2, int64_t nlayers,
                        int64_t chalo) {
  if (nlayers < 0 || chalo < 0 || nlayers + chalo > 31) return -1;
  // the grid does not enter the planes' size
  return planes_bytes(make_geom(two_d, 1, 1, 1, B0, B1, B2, nlayers, chalo, 1));
}

}  // namespace

extern "C" int64_t lsm_band_retube_smem(int64_t B0, int64_t B1, int64_t B2, int64_t nlayers,
                                        int64_t chalo) {
  return smem_or_refusal(false, B0, B1, B2, nlayers, chalo);
}

extern "C" int lsm_band_retube_f32(const void* P, void* band, const void* cand, const void* count,
                                   void* flags, int64_t ncand, int64_t n0, int64_t n1,
                                   int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                                   int64_t nlayers, int64_t chalo, void* stream) {
  return launch_retube<float>(P, band, cand, count, flags, ncand, n0, n1, n2, B0, B1, B2,
                              nlayers, chalo, stream);
}

extern "C" int lsm_band_retube_f64(const void* P, void* band, const void* cand, const void* count,
                                   void* flags, int64_t ncand, int64_t n0, int64_t n1,
                                   int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                                   int64_t nlayers, int64_t chalo, void* stream) {
  return launch_retube<double>(P, band, cand, count, flags, ncand, n0, n1, n2, B0, B1, B2,
                               nlayers, chalo, stream);
}

extern "C" int64_t lsm_band_retube_smem_2d(int64_t B0, int64_t B1, int64_t nlayers,
                                           int64_t chalo) {
  return smem_or_refusal(true, 1, B0, B1, nlayers, chalo);
}

extern "C" int lsm_band_retube_2d_f32(const void* P, void* band, const void* cand,
                                      const void* count, void* flags, int64_t ncand, int64_t n0,
                                      int64_t n1, int64_t B0, int64_t B1, int64_t nlayers,
                                      int64_t chalo, void* stream) {
  return launch_retube<float, true>(P, band, cand, count, flags, ncand, 1, n0, n1, 1, B0, B1,
                                    nlayers, chalo, stream);
}

extern "C" int lsm_band_retube_2d_f64(const void* P, void* band, const void* cand,
                                      const void* count, void* flags, int64_t ncand, int64_t n0,
                                      int64_t n1, int64_t B0, int64_t B1, int64_t nlayers,
                                      int64_t chalo, void* stream) {
  return launch_retube<double, true>(P, band, cand, count, flags, ncand, 1, n0, n1, 1, B0, B1,
                                     nlayers, chalo, stream);
}
