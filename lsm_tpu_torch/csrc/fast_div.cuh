// A 32-bit division by a divisor fixed at launch: a multiply-high and a
// shift in place of the division's dozens of instructions. K4, K5 and K2's
// single-axis entry decode their threads' indices with it.
#ifndef LSM_FAST_DIV_CUH
#define LSM_FAST_DIV_CUH

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// n / d for n in [0, 2^31) and d in [1, 2^31): a multiply-high and a shift
// (the round-up method; mul = ceil(2^(31 + ceil(log2 d)) / d))
struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    int l = 0;
    while ((uint64_t{1} << l) < d) ++l;
    f.mul = static_cast<uint32_t>(((uint64_t{1} << (31 + l)) + d - 1) / d);
    f.shr = static_cast<uint32_t>(l - 1);
  }
  return f;
}

__device__ __forceinline__ uint32_t quo(const FastDiv& f, uint32_t n) {
  return f.d == 1 ? n : __umulhi(n, f.mul) >> f.shr;
}

}  // namespace

#endif  // LSM_FAST_DIV_CUH
