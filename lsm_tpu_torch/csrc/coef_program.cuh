// The per-node interpreter of coefficient programs (K1'', K3'', K6''): a
// coordinate callable traced once into postfix ops
// (lsm_tpu_torch/ops/coef_program.py), evaluated here at a node's coordinates
// x_d = lo_d + (origin_d + i_d) * h_d and the stage time t.
//
// Replaces the "analytic" branch of the TPU kernels: lsm_tpu/ops/weno_v2.py
// `_coords_block` and `coef_static(coords, t)` inside `_make_kernel`, the
// same in lsm_tpu/ops/weno_v2_bwd.py `_make_bwd_kernel` (with `jax.jvp` for
// dH/dt) and lsm_tpu/ops/band_pallas.py `_make_band_kernel`. Pallas inlines the
// callable's trace into each kernel; here one interpreter serves every
// callable, so the library stays one build of csrc/ with no generated source.
//
// Cost: a program is uniform across the grid, so every thread of a warp takes
// the same branch of the op switch; the stack lives in local memory (L1).
// Each op costs tens of instructions of dispatch, so the programs are cut
// down before they reach the kernel (coef_program.py): the zero idioms fold
// away, and every subexpression that reads at most one coordinate axis is a
// table along that axis, which this interpreter fills once per launch
// (csrc/coef_tables.cu, one thread per table entry), as JAX's kernel
// evaluates such a subexpression on its sparse coordinate arrays. The rigid rotation
// is then one table load per component, the vortex 11 ops for three, and a
// node reads no streamed velocity (12 B/cell in f32).
//
// Rounding: every operation rounds on its own (the _rn intrinsics: no FMA
// contraction, IEEE division and square root), a constant is rounded to T,
// and a constant exponent takes torch's special cases (2, 3, 0.5, -0.5, -1,
// -2, 0, 1), so + - * / sqrt agree with the plain evaluation bit for bit and
// the transcendental functions to an ulp or two.
#ifndef LSM_COEF_PROGRAM_CUH
#define LSM_COEF_PROGRAM_CUH

#include <stdint.h>

#include "lsm_kernels.h"

namespace lsm {

template <typename T>
struct Pm;
template <>
struct Pm<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float sin(float a) { return sinf(a); }
  static __device__ __forceinline__ float cos(float a) { return cosf(a); }
  static __device__ __forceinline__ float tan(float a) { return tanf(a); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
  static __device__ __forceinline__ float tanh(float a) { return tanhf(a); }
  static __device__ __forceinline__ float pow(float a, float b) { return powf(a, b); }
};
template <>
struct Pm<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double sin(double a) { return ::sin(a); }
  static __device__ __forceinline__ double cos(double a) { return ::cos(a); }
  static __device__ __forceinline__ double tan(double a) { return ::tan(a); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
  static __device__ __forceinline__ double tanh(double a) { return ::tanh(a); }
  static __device__ __forceinline__ double pow(double a, double b) { return ::pow(a, b); }
};

// The coordinate of node index i along axis d.
template <typename T>
__device__ __forceinline__ T prog_coord(const LsmProgram& p, int d, int64_t i) {
  using M = Pm<T>;
  return M::add(T(p.lo[d]), M::mul(M::add(T(p.origin[d]), T(i)), T(p.h[d])));
}

__device__ __forceinline__ int64_t pick(unsigned a, int64_t i0, int64_t i1, int64_t i2) {
  return a == 0 ? i0 : (a == 1 ? i1 : i2);
}

// a ** c for a constant exponent c, with torch's special cases
template <typename T>
__device__ __forceinline__ T powc(T a, double c) {
  using M = Pm<T>;
  if (c == 2.0) return M::mul(a, a);
  if (c == 3.0) return M::mul(M::mul(a, a), a);
  if (c == 0.5) return M::sqrt(a);
  if (c == -0.5) return M::div(T(1), M::sqrt(a));
  if (c == -1.0) return M::div(T(1), a);
  if (c == -2.0) return M::div(T(1), M::mul(a, a));
  if (c == 0.0) return T(1);
  if (c == 1.0) return a;
  return M::pow(a, T(c));
}

// torch.minimum / torch.maximum: NaN wins (a != a only for NaN)
template <typename T>
__device__ __forceinline__ T pmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// A leaf's value at node (i0, i1, i2), and its t-derivative in *d: a
// coordinate (LSM_OP_X, axis a), the time (LSM_OP_T), a constant (index a) or
// a table (LSM_OP_TAB, slot a).
template <typename T, bool kDual>
__device__ __forceinline__ T prog_leaf(const LsmProgram& p, unsigned op, unsigned a, int64_t i0,
                                       int64_t i1, int64_t i2, T* d) {
  if (op == LSM_OP_TAB) {
    const int ax = p.tab_axis[a];
    const int64_t at = p.tab_off[a] + (ax < 0 ? 0 : pick(ax, i0, i1, i2));
    const T* table = static_cast<const T*>(p.table);
    if (kDual) *d = __ldg(table + p.tab_dt + at);
    return __ldg(table + at);
  }
  if (kDual) *d = op == LSM_OP_T ? T(1) : T(0);
  if (op == LSM_OP_X) return prog_coord<T>(p, a, pick(a, i0, i1, i2));
  return op == LSM_OP_T ? T(p.t) : T(p.konst[a]);
}

// The n ops of p.op from start at the node of interior index (i0, i1, i2)
// and time T(p.t). An accumulator machine: the top of the stack lives in
// a register (acc), the stack below it in local memory, and a binary op
// whose right operand is a leaf takes it as an immediate (the op word's mode
// bits, coef_program.py), so a left-deep chain such as the vortex's
// table * table * table touches no stack at all. kDual also carries the
// derivative in t (forward mode, the rules of torch's autograd: a tie of
// minimum/maximum splits 0.5/0.5, where/sign/comparisons pass nothing from
// their condition; a table's derivative is its second half) into *dt.
template <typename T, bool kDual>
__device__ T prog_run(const LsmProgram& p, int start, int n, int64_t i0, int64_t i1, int64_t i2,
                      T* dt) {
  using M = Pm<T>;
  if (n == 1) {  // one leaf (a table, a constant): no loop, no stack
    const unsigned code = p.op[start];
    T d1 = T(0);
    const T r = prog_leaf<T, kDual>(p, code & 31u, code >> 8, i0, i1, i2, &d1);
    if (kDual) *dt = d1;
    return r;
  }
  T v[LSM_PROG_STACK];
  T g[kDual ? LSM_PROG_STACK : 1];
  T acc = T(0), dacc = T(0);
  int sp = 0;
  for (int k = 0; k < n; ++k) {
    const unsigned code = p.op[start + k];
    const unsigned arg = code >> 8;
    const unsigned mode = (code >> 5) & 3u;
    const unsigned opc = code & 31u;
    if (opc <= LSM_OP_CONST || opc == LSM_OP_TAB) {  // a leaf: load, or push then load
      if (mode != 0) {
        v[sp] = acc;
        if (kDual) g[sp] = dacc;
        ++sp;
      }
      acc = prog_leaf<T, kDual>(p, opc, arg, i0, i1, i2, &dacc);
      continue;
    }
    if (opc < LSM_OP_ADD || opc == LSM_OP_POWC) {  // unary, on acc
      const T a = acc, da = dacc;
      T r, dr = T(0);
      switch (opc) {
        case LSM_OP_NEG: r = -a; dr = -da; break;
        case LSM_OP_ABS: r = M::abs(a); dr = a > T(0) ? da : (a < T(0) ? -da : T(0)); break;
        case LSM_OP_SIN: r = M::sin(a); if (kDual) dr = M::mul(da, M::cos(a)); break;
        case LSM_OP_COS: r = M::cos(a); if (kDual) dr = -M::mul(da, M::sin(a)); break;
        case LSM_OP_TAN: r = M::tan(a); if (kDual) dr = M::mul(da, M::add(T(1), M::mul(r, r)));
                         break;
        case LSM_OP_EXP: r = M::exp(a); if (kDual) dr = M::mul(da, r); break;
        case LSM_OP_LOG: r = M::log(a); if (kDual) dr = M::div(da, a); break;
        case LSM_OP_SQRT: r = M::sqrt(a); if (kDual) dr = M::div(da, M::mul(T(2), r)); break;
        case LSM_OP_RSQRT: r = M::div(T(1), M::sqrt(a));
                           if (kDual) dr = M::mul(M::mul(T(-0.5), da), M::mul(M::mul(r, r), r));
                           break;
        case LSM_OP_TANH: r = M::tanh(a); if (kDual) dr = M::mul(da, M::sub(T(1), M::mul(r, r)));
                          break;
        case LSM_OP_SIGN: r = T(a > T(0)) - T(a < T(0)); break;
        default: {  // LSM_OP_POWC
          const double c = p.konst[arg];
          r = powc(a, c);
          if (kDual && c != 0.0) dr = M::mul(M::mul(T(c), powc(a, c - 1.0)), da);
        }
      }
      acc = r;
      dacc = dr;
      continue;
    }
    if (opc == LSM_OP_WHERE) {  // condition and true value on the stack, false in acc
      const T c = v[sp - 2];
      if (kDual) dacc = c != T(0) ? g[sp - 1] : dacc;
      acc = c != T(0) ? v[sp - 1] : acc;
      sp -= 2;
      continue;
    }
    T a, b, da = T(0), db = T(0);  // binary: a op b
    if (mode == 0) {  // a from the stack, b in acc
      --sp;
      a = v[sp];
      if (kDual) da = g[sp];
      b = acc;
      db = dacc;
    } else {  // a in acc, b an immediate leaf: a table, a constant, a coordinate or t
      a = acc;
      da = dacc;
      const unsigned leaf = mode == 1 ? LSM_OP_TAB
                          : (mode == 2 ? LSM_OP_CONST : (arg < 3 ? LSM_OP_X : LSM_OP_T));
      b = prog_leaf<T, kDual>(p, leaf, arg, i0, i1, i2, &db);
    }
    T r, dr = T(0);
    switch (opc) {
      case LSM_OP_ADD: r = M::add(a, b); dr = M::add(da, db); break;
      case LSM_OP_SUB: r = M::sub(a, b); dr = M::sub(da, db); break;
      case LSM_OP_MUL: r = M::mul(a, b); if (kDual) dr = M::add(M::mul(da, b), M::mul(a, db));
                       break;
      case LSM_OP_DIV: r = M::div(a, b); if (kDual) dr = M::div(M::sub(da, M::mul(r, db)), b);
                       break;
      case LSM_OP_POW:
        r = M::pow(a, b);
        if (kDual) {
          dr = M::mul(M::mul(b, M::pow(a, M::sub(b, T(1)))), da);
          if (db != T(0)) dr = M::add(dr, M::mul(M::mul(r, M::log(a)), db));
        }
        break;
      case LSM_OP_MIN: r = pmin(a, b);
                       dr = a == b ? M::mul(T(0.5), M::add(da, db)) : (a < b ? da : db); break;
      case LSM_OP_MAX: r = pmax(a, b);
                       dr = a == b ? M::mul(T(0.5), M::add(da, db)) : (a > b ? da : db); break;
      case LSM_OP_LT: r = T(a < b); break;
      case LSM_OP_LE: r = T(a <= b); break;
      case LSM_OP_GT: r = T(a > b); break;
      case LSM_OP_GE: r = T(a >= b); break;
      case LSM_OP_EQ: r = T(a == b); break;
      default: r = T(a != b);  // LSM_OP_NE
    }
    acc = r;
    dacc = dr;
  }
  if (kDual) *dt = dacc;
  return acc;
}

// Component d of entry e's program at node (i0, i1, i2); kDual as for
// prog_run.
template <typename T, bool kDual>
__device__ __forceinline__ T prog_eval(const LsmProgram& p, int e, int d, int64_t i0,
                                       int64_t i1, int64_t i2, T* dt) {
  return prog_run<T, kDual>(p, p.start[e][d], p.len[e][d], i0, i1, i2, dt);
}

// The stage constants of the program entries K1'' and K6'', rounded to T once
// on the host (the term table carries them in double).
template <typename T>
struct StageConsts {
  T inv_h0, inv_h1, inv_h2, alpha, beta, gamma;
  static StageConsts of(const LsmStageTerms& p) {
    return {T(p.inv_h[0]), T(p.inv_h[1]), T(p.inv_h[2]), T(p.alpha), T(p.beta), T(p.gamma)};
  }
};

// Component d of entry e at node (i0, i1, i2), value only.
template <typename T>
__device__ __forceinline__ T prog_value(const LsmProgram& p, int e, int d, int64_t i0,
                                        int64_t i1, int64_t i2) {
  return prog_eval<T, false>(p, e, d, i0, i1, i2, nullptr);
}

}  // namespace lsm

#endif  // LSM_COEF_PROGRAM_CUH
