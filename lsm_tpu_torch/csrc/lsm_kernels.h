/* C interface of the hand-written Hopper kernels of lsm_tpu_torch.
 *
 * Built by lsm_tpu_torch/ops/_build.py into one shared library (nvcc, sm_90a)
 * and bound with ctypes. Every pointer argument is a device pointer unless
 * stated; `stream` is a cudaStream_t. Each entry point launches on `stream`,
 * does not synchronise, allocates nothing, and returns cudaGetLastError()
 * (0 on success).
 *
 * Layout: a padded buffer holds a 3D field of n0 x n1 x n2 interior nodes with
 * LSM_GHOST ghost layers on both sides of every axis, contiguous, last axis
 * fastest: shape (n0+6, n1+6, n2+6).
 */
#ifndef LSM_KERNELS_H
#define LSM_KERNELS_H

#include <stdint.h>

#define LSM_GHOST 3
#define LSM_MAX_DEGREE 7

/* Boundary-condition codes of the ghost refresh and its transpose. */
#define LSM_BC_PERIODIC 0
#define LSM_BC_SYMMETRY 1
#define LSM_BC_EXTRAPOLATION 2

/* Term kinds and coefficient kinds of the stage's term table. */
#define LSM_MAX_TERMS 16
#define LSM_TERM_ADVECTION 0
#define LSM_TERM_NORMAL 1
#define LSM_TERM_CURVATURE 2
#define LSM_TERM_EIKONAL 3
#define LSM_COEF_STREAM 0
#define LSM_COEF_CONST 1
#define LSM_COEF_NONE 2
#define LSM_COEF_PROGRAM 3

/* Coefficient programs (lsm_tpu_torch/ops/coef_program.py): postfix ops for an
 * accumulator machine, each opcode | mode << 5 | operand << 8. A leaf (X, T,
 * CONST, TAB) has mode 0 (load the accumulator) or 1 (push it first); a
 * binary op has mode 0 (left operand from the stack) or takes its right
 * operand as an immediate: mode 1 a table, 2 a constant, 3 a coordinate
 * (operand 0-2) or t (operand 3). Operands: the axis of X, the constant
 * index of CONST and POWC, the table slot of TAB. The opcodes' order is
 * coef_program.OPCODES'. */
#define LSM_PROG_MAX_OPS 160
#define LSM_PROG_MAX_CONSTS 40
#define LSM_PROG_MAX_TABS 32
#define LSM_PROG_STACK 12
enum {
  LSM_OP_X, LSM_OP_T, LSM_OP_CONST, LSM_OP_NEG, LSM_OP_ABS, LSM_OP_SIN, LSM_OP_COS,
  LSM_OP_TAN, LSM_OP_EXP, LSM_OP_LOG, LSM_OP_SQRT, LSM_OP_RSQRT, LSM_OP_TANH, LSM_OP_SIGN,
  LSM_OP_ADD, LSM_OP_SUB, LSM_OP_MUL, LSM_OP_DIV, LSM_OP_POW, LSM_OP_POWC, LSM_OP_MIN,
  LSM_OP_MAX, LSM_OP_LT, LSM_OP_LE, LSM_OP_GT, LSM_OP_GE, LSM_OP_EQ, LSM_OP_NE, LSM_OP_WHERE,
  LSM_OP_TAB
};

/* The program terms of a stage (mirrored by lsm_tpu_torch.ops.weno_v2.ProgramTable):
 * node (i0, i1, i2) sits at x_d = lo[d] + (origin[d] + i_d) * h[d], the stage
 * time is t; entry e's component d is len[e][d] ops from op[start[e][d]].
 * A subexpression that reads at most one axis is a table: slot s holds its
 * values at table[tab_off[s] + i_a] (a = tab_axis[s]; one value at
 * table[tab_off[s]] when a < 0), in the field's dtype on the device; with
 * tab_dt > 0 their t-derivatives follow at table[tab_dt + ...]. */
typedef struct {
  double lo[3], h[3], origin[3];
  double t;
  int16_t start[LSM_MAX_TERMS][3];
  int16_t len[LSM_MAX_TERMS][3];
  uint16_t op[LSM_PROG_MAX_OPS];
  double konst[LSM_PROG_MAX_CONSTS];
  const void* table;
  int64_t tab_dt;
  int32_t tab_off[LSM_PROG_MAX_TABS];
  int32_t tab_axis[LSM_PROG_MAX_TABS];
} LsmProgram;

/* The per-axis tables of a stage's programs, filled on the device by
 * lsm_prog_tables_* (mirrored by lsm_tpu_torch.ops.weno_v2.TableFill): prog
 * holds the n table programs' ops and constants (no TAB leaf: a table reads
 * at most one axis), the coordinates and time, and the layout the stage reads
 * (tab_off ascending and contiguous, tab_axis, tab_dt); table slot s is
 * nops[s] ops from prog.op[start[s]], evaluated at index i = 0..count[s]-1 of
 * its axis into table[tab_off[s] + i] (and its t-derivative into
 * table[tab_dt + tab_off[s] + i] when tab_dt > 0); total = the sum of count. */
typedef struct {
  LsmProgram prog;
  int32_t n, total;
  int16_t start[LSM_PROG_MAX_TABS];
  int16_t nops[LSM_PROG_MAX_TABS];
  int32_t count[LSM_PROG_MAX_TABS];
} LsmTableFill;

/* The term table of K1, K3, K3' and K6 (mirrored by
 * lsm_tpu_torch.ops.weno_v2.StageTerms), copied into the kernel's parameters.
 * Entry e of n: kind[e] (LSM_TERM_*), coef[e] (LSM_COEF_*), value[e] (a
 * constant coefficient), stream[e][0..2] (device pointers of the streamed
 * coefficients: 3 velocity components for advection, 1 otherwise;
 * interior-shaped for K1, tile-packed by dispatch slot for K6), prog (the
 * programs of LSM_COEF_PROGRAM entries). The spacing-derived constants are
 * formed in double on the host: per axis 1/h, h/2, 1/(2h) and 1/(h*h),
 * 1/(4*h_i*h_j) for the axis pairs (0,1), (0,2), (1,2), and min(h). */
typedef struct {
  int n;
  int kind[LSM_MAX_TERMS];
  int coef[LSM_MAX_TERMS];
  double value[LSM_MAX_TERMS];
  const void* stream[LSM_MAX_TERMS][3];
  double inv_h[3], half_h[3], inv_two_h[3], inv_hh[3], inv_hmix[3];
  double dx_min;
  double alpha, beta, gamma;
  LsmProgram prog;
} LsmStageTerms;

#ifdef __cplusplus
extern "C" {
#endif

/* K1: out_interior = alpha*aux + beta*phi - gamma * sum_d u_d * WENO5_d(phi).
 * P, aux, out: padded buffers (aux may be NULL: the alpha term is dropped).
 * u0, u1, u2: interior-shaped (n0, n1, n2) velocity components.
 * inv_h*: reciprocal node spacing per axis. out's ghost shells are not written. */
int lsm_weno_stage_f32(const void* P, const void* u0, const void* u1, const void* u2,
                       const void* aux, void* out, int64_t n0, int64_t n1, int64_t n2,
                       double inv_h0, double inv_h1, double inv_h2,
                       double alpha, double beta, double gamma, void* stream);
int lsm_weno_stage_f64(const void* P, const void* u0, const void* u1, const void* u2,
                       const void* aux, void* out, int64_t n0, int64_t n1, int64_t n2,
                       double inv_h0, double inv_h1, double inv_h2,
                       double alpha, double beta, double gamma, void* stream);

/* K1' over a term table: out_interior = alpha*aux + beta*phi - gamma*sum_e H_e
 * with the Hamiltonians of csrc/hamiltonians.cuh summed in table order (the
 * constants alpha, beta, gamma and the spacing come from *terms, a host
 * pointer). P, aux (may be NULL), out as for lsm_weno_stage_*. A table
 * without a program coefficient takes the march (n0 == 1 compiles axis 0
 * out, which needs axis-0 ghosts that copy the plane), a table with one a
 * kernel of one thread per node. */
int lsm_weno_stage_terms_f32(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                             int64_t n2, const LsmStageTerms* terms, void* stream);
int lsm_weno_stage_terms_f64(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                             int64_t n2, const LsmStageTerms* terms, void* stream);

/* K1'': the advection-only stage with the velocity of the table's entry 0, a
 * 3-component program evaluated per node. P, aux, out, n0..n2 and terms as
 * for lsm_weno_stage_terms_*; axes0..axes2: the coordinate axes component d
 * reads (bit a for axis a), as the tracer found them
 * (lsm_tpu_torch.ops.coef_program.Program.axes). */
int lsm_weno_stage_prog_f32(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                            int64_t n2, const LsmStageTerms* terms, int axes0, int axes1,
                            int axes2, void* stream);
int lsm_weno_stage_prog_f64(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                            int64_t n2, const LsmStageTerms* terms, int axes0, int axes1,
                            int axes2, void* stream);

/* K1's 2D entries (csrc/weno_stage_2d.cu): the stage of a 2D field on its
 * padded (n0+6, n1+6) layout (P, aux, out), the function of the (1, n0, n1)
 * embedding with the dummy axis compiled out. lsm_weno_stage_2d_*: one
 * advection term, u0 and u1 interior-shaped (n0, n1), inv_h* per axis;
 * lsm_weno_stage_prog_2d_*: its velocity the program of the table's entry 0,
 * axes1, axes2 the embedding's axes its components 1 and 2 read;
 * lsm_weno_stage_terms_2d_*: any term table (one thread per node, the
 * per-node form; the smoke times K1 and K1'' through it). The tables are the
 * embedding's (spacing and coordinates of (1, n0, n1); an advection term's
 * stream[e][1..2] the field's two velocity components, stream[e][0] not
 * read). out's ghost shells are not written. */
int lsm_weno_stage_2d_f32(const void* P, const void* u0, const void* u1, const void* aux,
                          void* out, int64_t n0, int64_t n1, double inv_h0, double inv_h1,
                          double alpha, double beta, double gamma, void* stream);
int lsm_weno_stage_2d_f64(const void* P, const void* u0, const void* u1, const void* aux,
                          void* out, int64_t n0, int64_t n1, double inv_h0, double inv_h1,
                          double alpha, double beta, double gamma, void* stream);
int lsm_weno_stage_prog_2d_f32(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                               const LsmStageTerms* terms, int axes1, int axes2, void* stream);
int lsm_weno_stage_prog_2d_f64(const void* P, const void* aux, void* out, int64_t n0, int64_t n1,
                               const LsmStageTerms* terms, int axes1, int axes2, void* stream);
int lsm_weno_stage_terms_2d_f32(const void* P, const void* aux, void* out, int64_t n0,
                                int64_t n1, const LsmStageTerms* terms, void* stream);
int lsm_weno_stage_terms_2d_f64(const void* P, const void* aux, void* out, int64_t n0,
                                int64_t n1, const LsmStageTerms* terms, void* stream);

/* The program tables of K1'', K3'' and K6'' (csrc/coef_tables.cu): every
 * slot of *fill (a host pointer) evaluated by the programs' interpreter
 * into fill->prog.table (a device buffer of the field's dtype, total values,
 * twice that with tab_dt > 0: then the t-derivatives in dual numbers). */
int lsm_prog_tables_f32(const LsmTableFill* fill, void* stream);
int lsm_prog_tables_f64(const LsmTableFill* fill, void* stream);

/* K2: rewrite every ghost shell of the padded buffer P from its interior, in
 * place, equal to the three phases axis 0, then axis 1 (over axis 0's full
 * padded extent), then axis 2 (over the full padded extents of axes 0 and 1).
 * One launch (an edge or vertex ghost recomputes the earlier phases' values
 * it reads); three, in order, for a buffer that would need 2^31 threads.
 * Host arrays, index a = 2*axis + side (side 0 = left, 1 = right):
 *   kinds[6]    LSM_BC_* code;
 *   degrees[6]  extrapolation degree (<= LSM_MAX_DEGREE; a higher one takes
 *     lsm_refresh_table_* / lsm_fold_table_*);
 *   weights[6 * LSM_GHOST * (LSM_MAX_DEGREE+1)]  weight of node j (from the
 *     boundary inward) for the ghost at distance k: weights[(a*3 + k-1)*8 + j]. */
int lsm_refresh_ghosts_f32(void* P, int64_t n0, int64_t n1, int64_t n2,
                           const int* kinds, const int* degrees, const double* weights,
                           void* stream);
int lsm_refresh_ghosts_f64(void* P, int64_t n0, int64_t n1, int64_t n2,
                           const int* kinds, const int* degrees, const double* weights,
                           void* stream);

/* K2's 2D entry: every ghost of a 2D buffer (n0+6, n1+6) in one launch,
 * equal to the two phases axis 0, then axis 1 over the padded rows (a corner
 * recomputes the axis-0 values it reads). Arguments as for K2, axes 0 and 1. */
int lsm_refresh_ghosts_2d_f32(void* P, int64_t n0, int64_t n1, const int* kinds,
                              const int* degrees, const double* weights, void* stream);
int lsm_refresh_ghosts_2d_f64(void* P, int64_t n0, int64_t n1, const int* kinds,
                              const int* degrees, const double* weights, void* stream);

/* K2's single-axis entry: one of its three phases (axis 0, 1 or 2), the shells
 * of that axis over the extents described above (the earlier axes' full padded
 * extent, the later axes' interior). One launch; arguments as for K2. */
int lsm_refresh_axis_f32(void* P, int64_t n0, int64_t n1, int64_t n2, int axis,
                         const int* kinds, const int* degrees, const double* weights,
                         void* stream);
int lsm_refresh_axis_f64(void* P, int64_t n0, int64_t n1, int64_t n2, int axis,
                         const int* kinds, const int* degrees, const double* weights,
                         void* stream);

/* K2, K4 and K7 for an Extrapolation of any degree (the table route): a
 * buffer with a side of degree > LSM_MAX_DEGREE. The by-value kernels'
 * thread bodies with the weights read from table (refresh_ghosts.cu
 * WeightTable): a device array of the buffer's dtype, 2 * ndim * LSM_GHOST
 * * (dmax+1) values, the
 * weight of node j for the ghost at distance k of side a = 2*axis + side at
 * table[(a*3 + k-1) * (dmax+1) + j]; kinds, degrees (any degree <= dmax) and
 * weights (the by-value rows, zero for a side of higher degree) as for K2.
 * ndim 3 (n0, n1, n2) or 2 (n0, n1; n2 unused).
 * lsm_refresh_table_*: in place, axes [axis_lo, axis_hi) = [0, ndim) K2's 3D
 * or 2D entry, or with flags (int32[2] in device memory, as K7's) K7's, one
 * launch (3D: three past 32-bit threads, as K2's); [axis, axis + 1), 3D
 * and no flags, K2's single-axis entry, one launch.
 * lsm_fold_table_*: gf gets K4's fold of g (g != gf, read only), one launch. */
int lsm_refresh_table_f32(void* P, int ndim, int64_t n0, int64_t n1, int64_t n2, int axis_lo,
                          int axis_hi, const int* kinds, const int* degrees,
                          const double* weights, const void* table, int dmax,
                          const void* flags, void* stream);
int lsm_refresh_table_f64(void* P, int ndim, int64_t n0, int64_t n1, int64_t n2, int axis_lo,
                          int axis_hi, const int* kinds, const int* degrees,
                          const double* weights, const void* table, int dmax,
                          const void* flags, void* stream);
int lsm_fold_table_f32(const void* g, void* gf, int ndim, int64_t n0, int64_t n1, int64_t n2,
                       const int* kinds, const int* degrees, const double* weights,
                       const void* table, int dmax, void* stream);
int lsm_fold_table_f64(const void* g, void* gf, int ndim, int64_t n0, int64_t n1, int64_t n2,
                       const int* kinds, const int* degrees, const double* weights,
                       const void* table, int dmax, void* stream);

/* K9: write the ghost-shell blocks of a shard's padded buffer P in place
 * (csrc/shell_blocks.cu). l0, r0: the axis-0 shells (3, n1, n2), rows [0, 3)
 * and [3+n0, n0+6) at the interior columns and lanes; l1, r1: the axis-1
 * shells (n0+6, 3, n2), columns [0, 3) and [3+n1, n1+6) over every row, at the
 * interior lanes. Each block contiguous, of P's dtype; any may be NULL (not
 * written). The lane ghosts are not touched. One launch. */
int lsm_shell_blocks_f32(void* P, int64_t n0, int64_t n1, int64_t n2, const void* l0,
                         const void* r0, const void* l1, const void* r1, void* stream);
int lsm_shell_blocks_f64(void* P, int64_t n0, int64_t n1, int64_t n2, const void* l0,
                         const void* r0, const void* l1, const void* r1, void* stream);

/* K3: cotangents of one K1 stage (csrc/stage_backward.cu). g is the padded
 * cotangent of the stage output, already folded (K4): only its interior is
 * read. Writes dP (padded, every element), du0..du2 (interior-shaped; each
 * may be NULL), daux = alpha*g on the interior of a padded buffer (NULL when
 * aux is NULL or not wanted; its shells are left for K5) and dcoef[3] =
 * (dalpha, dbeta, dgamma). aux may be NULL (dalpha is then 0). part is
 * device scratch of lsm_stage_bwd_scratch(n0, n1, n2) doubles. Two
 * launches: the three axes in one pass, then the sum of the per-block
 * partials.
 * accumulate != 0 (an advection term of a term list, after K3'): dP is added
 * to instead of written, with no beta*g, no daux and dcoef = (0, 0, dgamma). */
int64_t lsm_stage_bwd_scratch(int64_t n0, int64_t n1, int64_t n2);

/* K3'': K3 with the velocity of the table's entry 0, a 3-component program
 * evaluated per node (no du). part: lsm_stage_bwd_scratch doubles; dcoef[4]
 * = (dalpha, dbeta, dgamma, dt), dt the cotangent of the stage time when
 * needs_dt (the program in dual numbers); without needs_dt dcoef[3] is not
 * written. Other arguments as for K3. */
int lsm_stage_bwd_prog_f32(const void* P, const void* g, const void* aux, void* dP, void* daux,
                           void* part, void* dcoef, int64_t n0, int64_t n1, int64_t n2,
                           const LsmStageTerms* terms, int accumulate, int needs_dt,
                           void* stream);
int lsm_stage_bwd_prog_f64(const void* P, const void* g, const void* aux, void* dP, void* daux,
                           void* part, void* dcoef, int64_t n0, int64_t n1, int64_t n2,
                           const LsmStageTerms* terms, int accumulate, int needs_dt,
                           void* stream);
int lsm_stage_bwd_f32(const void* P, const void* g, const void* u0, const void* u1,
                      const void* u2, const void* aux, void* dP, void* du0, void* du1,
                      void* du2, void* daux, void* part, void* dcoef, int64_t n0, int64_t n1,
                      int64_t n2, double inv_h0, double inv_h1, double inv_h2, double alpha,
                      double beta, double gamma, int accumulate, void* stream);
int lsm_stage_bwd_f64(const void* P, const void* g, const void* u0, const void* u1,
                      const void* u2, const void* aux, void* dP, void* du0, void* du1,
                      void* du2, void* daux, void* part, void* dcoef, int64_t n0, int64_t n1,
                      int64_t n2, double inv_h0, double inv_h1, double inv_h2, double alpha,
                      double beta, double gamma, int accumulate, void* stream);

/* K3': cotangents of one K1' stage over a term table (csrc/stage_backward.cu):
 * the normal, curvature and eikonal entries of *terms (a host pointer; its
 * advection entries are skipped, K3 adds their share in accumulate mode).
 * g, aux, daux, part as for K3 (part: lsm_stage_bwd_terms_scratch doubles).
 * Writes dP (padded, every element: beta*g plus the entries' adjoints),
 * dstreams[e] (a host array of LSM_MAX_TERMS device pointers: the cotangent
 * of entry e's stream, interior-shaped, or NULL) and dcoef[4] = (dalpha,
 * dbeta, dgamma of those entries, dt), dt the cotangent of the stage time
 * through the program entries when needs_dt (dual numbers), else 0. Two
 * launches: the gather, then the sum of the per-block partials. */
int64_t lsm_stage_bwd_terms_scratch(int64_t n0, int64_t n1, int64_t n2);
int lsm_stage_bwd_terms_f32(const void* P, const void* g, const void* aux, void* dP, void* daux,
                            void* part, void* dcoef, int64_t n0, int64_t n1, int64_t n2,
                            const LsmStageTerms* terms, const void* const* dstreams,
                            int needs_dt, void* stream);
int lsm_stage_bwd_terms_f64(const void* P, const void* g, const void* aux, void* dP, void* daux,
                            void* part, void* dcoef, int64_t n0, int64_t n1, int64_t n2,
                            const LsmStageTerms* terms, const void* const* dstreams,
                            int needs_dt, void* stream);

/* K4: the transpose of K2 out of place: gf (a padded buffer like g, not
 * overlapping it) gets g's interior plus the ghost-shell cotangents folded
 * into it, and zero shells; g is only read. One launch. kinds, degrees,
 * weights as for K2. */
int lsm_fold_ghosts_f32(const void* g, void* gf, int64_t n0, int64_t n1, int64_t n2,
                        const int* kinds, const int* degrees, const double* weights,
                        void* stream);
int lsm_fold_ghosts_f64(const void* g, void* gf, int64_t n0, int64_t n1, int64_t n2,
                        const int* kinds, const int* degrees, const double* weights,
                        void* stream);

/* K5: zero the six ghost slabs of a padded buffer in place. */
int lsm_zero_shells_f32(void* buf, int64_t n0, int64_t n1, int64_t n2, void* stream);
int lsm_zero_shells_f64(void* buf, int64_t n0, int64_t n1, int64_t n2, void* stream);

/* The 2D entries of K3, K3'', K3', K4 and K5: a 2D field's (n0+6, n1+6)
 * layout, the stage of K1's 2D entries (the (1, n0, n1) embedding's function
 * with its dummy axis compiled out). Arguments as for the 3D entries, with
 * the 2D field's two axes (two velocity components, two spacings); K3'' and
 * K3' take the embedding's table (ops/weno_v2.py `_table_2d`), K3'' also the
 * embedding's axes its components 1 and 2 read (bit a for axis a), as K1''
 * 2D. */
int64_t lsm_stage_bwd_scratch_2d(int64_t n0, int64_t n1);
int64_t lsm_stage_bwd_terms_scratch_2d(int64_t n0, int64_t n1);
int lsm_stage_bwd_2d_f32(const void* P, const void* g, const void* u0, const void* u1,
                         const void* aux, void* dP, void* du0, void* du1, void* daux, void* part,
                         void* dcoef, int64_t n0, int64_t n1, double inv_h0, double inv_h1,
                         double alpha, double beta, double gamma, int accumulate, void* stream);
int lsm_stage_bwd_2d_f64(const void* P, const void* g, const void* u0, const void* u1,
                         const void* aux, void* dP, void* du0, void* du1, void* daux, void* part,
                         void* dcoef, int64_t n0, int64_t n1, double inv_h0, double inv_h1,
                         double alpha, double beta, double gamma, int accumulate, void* stream);
int lsm_stage_bwd_prog_2d_f32(const void* P, const void* g, const void* aux, void* dP,
                              void* daux, void* part, void* dcoef, int64_t n0, int64_t n1,
                              const LsmStageTerms* terms, int accumulate, int needs_dt,
                              int axes1, int axes2, void* stream);
int lsm_stage_bwd_prog_2d_f64(const void* P, const void* g, const void* aux, void* dP,
                              void* daux, void* part, void* dcoef, int64_t n0, int64_t n1,
                              const LsmStageTerms* terms, int accumulate, int needs_dt,
                              int axes1, int axes2, void* stream);
int lsm_stage_bwd_terms_2d_f32(const void* P, const void* g, const void* aux, void* dP,
                               void* daux, void* part, void* dcoef, int64_t n0, int64_t n1,
                               const LsmStageTerms* terms, const void* const* dstreams,
                               int needs_dt, void* stream);
int lsm_stage_bwd_terms_2d_f64(const void* P, const void* g, const void* aux, void* dP,
                               void* daux, void* part, void* dcoef, int64_t n0, int64_t n1,
                               const LsmStageTerms* terms, const void* const* dstreams,
                               int needs_dt, void* stream);
int lsm_fold_ghosts_2d_f32(const void* g, void* gf, int64_t n0, int64_t n1, const int* kinds,
                           const int* degrees, const double* weights, void* stream);
int lsm_fold_ghosts_2d_f64(const void* g, void* gf, int64_t n0, int64_t n1, const int* kinds,
                           const int* degrees, const double* weights, void* stream);
int lsm_zero_shells_2d_f32(void* buf, int64_t n0, int64_t n1, void* stream);
int lsm_zero_shells_2d_f64(void* buf, int64_t n0, int64_t n1, void* stream);

/* K6: K1's stage over an active-tile dispatch list (csrc/band_stage.cu).
 * P, aux (may be NULL), out: padded buffers; out is written only on the
 * tiles of the list: where the combined mask `band` (uint8, interior-shaped,
 * 0/1/2) is nonzero with the stage, elsewhere in the tile with P's value.
 * ids: int32[capacity] flat tile ids over the tile grid ceil(n/B) (row-major)
 * or -1. u0..u2: tile-packed velocity (capacity, B0, B1, B2), by slot. One
 * launch of `capacity` blocks, each staging its tile's (B0+6)(B1+6)(B2+6)
 * box of P in shared memory: a box over 227 KB, or offsets inside a tile
 * past int, are refused (cudaErrorInvalidValue). */
int lsm_band_stage_f32(const void* P, const void* u0, const void* u1, const void* u2,
                       const void* aux, void* out, const void* band, const void* ids,
                       int64_t capacity, int64_t n0, int64_t n1, int64_t n2, int64_t B0,
                       int64_t B1, int64_t B2, double inv_h0, double inv_h1, double inv_h2,
                       double alpha, double beta, double gamma, void* stream);
int lsm_band_stage_f64(const void* P, const void* u0, const void* u1, const void* u2,
                       const void* aux, void* out, const void* band, const void* ids,
                       int64_t capacity, int64_t n0, int64_t n1, int64_t n2, int64_t B0,
                       int64_t B1, int64_t B2, double inv_h0, double inv_h1, double inv_h2,
                       double alpha, double beta, double gamma, void* stream);

/* K6 over a term table (streams tile-packed by slot): arguments as for
 * lsm_band_stage_* and lsm_weno_stage_terms_*. */
int lsm_band_stage_terms_f32(const void* P, const void* aux, void* out, const void* band,
                             const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                             int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                             const LsmStageTerms* terms, void* stream);
int lsm_band_stage_terms_f64(const void* P, const void* aux, void* out, const void* band,
                             const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                             int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                             const LsmStageTerms* terms, void* stream);

/* K6'': the advection-only band stage with the velocity of the table's entry
 * 0, a 3-component program. Arguments as for lsm_band_stage_terms_*;
 * axes0..axes2 as for lsm_weno_stage_prog_*: a component that does not read
 * axis 0 is evaluated once per column of a tile, one that reads axis 0 only
 * once per plane, any other per node. */
int lsm_band_stage_prog_f32(const void* P, const void* aux, void* out, const void* band,
                            const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                            int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                            const LsmStageTerms* terms, int axes0, int axes1, int axes2,
                            void* stream);
int lsm_band_stage_prog_f64(const void* P, const void* aux, void* out, const void* band,
                            const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                            int64_t n2, int64_t B0, int64_t B1, int64_t B2,
                            const LsmStageTerms* terms, int axes0, int axes1, int axes2,
                            void* stream);

/* K7: K2 gated on the device (csrc/refresh_ghosts.cu). flags: int32[2] in
 * device memory; flags[0] == 0 skips the axis-0 and axis-1 launches,
 * flags[1] == 0 the axis-2 launch. Other arguments as for K2. */
int lsm_refresh_band_ghosts_f32(void* P, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                                const int* degrees, const double* weights, const void* flags,
                                void* stream);
int lsm_refresh_band_ghosts_f64(void* P, int64_t n0, int64_t n1, int64_t n2, const int* kinds,
                                const int* degrees, const double* weights, const void* flags,
                                void* stream);

/* K8: incremental re-tube over a candidate tile list (csrc/band_retube.cu).
 * P: padded phi; band: the combined uint8 mask, updated in place on the
 * candidate tiles; cand: int32[ncand] tile ids or -1; count: an int32 in
 * device memory, the number of leading slots of cand to re-tube (at most
 * ncand); flags: int32[ncand], set to 1 where the new tile holds a band
 * node, 0 for an empty slot (slots past count are not written). Two
 * launches over the candidates only, no scratch (A: the new mask into the
 * candidate tiles' bytes' high bits; B: shifted down). lsm_band_retube_smem
 * gives launch A's shared memory in bytes, -1 for radii nlayers + chalo it
 * does not take (> 31); a launch refuses those and planes over 227 KB. */
int64_t lsm_band_retube_smem(int64_t B0, int64_t B1, int64_t B2, int64_t nlayers,
                             int64_t chalo);
int lsm_band_retube_f32(const void* P, void* band, const void* cand, const void* count,
                        void* flags, int64_t ncand, int64_t n0, int64_t n1, int64_t n2,
                        int64_t B0, int64_t B1, int64_t B2, int64_t nlayers, int64_t chalo,
                        void* stream);
int lsm_band_retube_f64(const void* P, void* band, const void* cand, const void* count,
                        void* flags, int64_t ncand, int64_t n0, int64_t n1, int64_t n2,
                        int64_t B0, int64_t B1, int64_t B2, int64_t nlayers, int64_t chalo,
                        void* stream);

/* The 2D entries of K6, K7 and K8: a 2D band on its own padded layout,
 * P, aux, out (n0+6, n1+6), band (n0, n1), tiles (B0, B1), streams
 * tile-packed (capacity, B0, B1); tile ids and slots as in 3D over the 2D
 * tile grid. They compute the 3D function of the (1, n0, n1) embedding:
 * the term table is the embedding's (spacing (h_min, h0, h1); its entries 1
 * and 2 are the 2D axes), a program is evaluated at the embedding's node
 * (0, i, j), and an advection term's component 0 is not read. K6's
 * advection entry takes the two 2D velocity components u0, u1 and
 * spacings. */
int lsm_band_stage_2d_f32(const void* P, const void* u0, const void* u1, const void* aux,
                          void* out, const void* band, const void* ids, int64_t capacity,
                          int64_t n0, int64_t n1, int64_t B0, int64_t B1, double inv_h0,
                          double inv_h1, double alpha, double beta, double gamma, void* stream);
int lsm_band_stage_2d_f64(const void* P, const void* u0, const void* u1, const void* aux,
                          void* out, const void* band, const void* ids, int64_t capacity,
                          int64_t n0, int64_t n1, int64_t B0, int64_t B1, double inv_h0,
                          double inv_h1, double alpha, double beta, double gamma, void* stream);
int lsm_band_stage_terms_2d_f32(const void* P, const void* aux, void* out, const void* band,
                                const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                                int64_t B0, int64_t B1, const LsmStageTerms* terms, void* stream);
int lsm_band_stage_terms_2d_f64(const void* P, const void* aux, void* out, const void* band,
                                const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                                int64_t B0, int64_t B1, const LsmStageTerms* terms, void* stream);
int lsm_band_stage_prog_2d_f32(const void* P, const void* aux, void* out, const void* band,
                               const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                               int64_t B0, int64_t B1, const LsmStageTerms* terms, void* stream);
int lsm_band_stage_prog_2d_f64(const void* P, const void* aux, void* out, const void* band,
                               const void* ids, int64_t capacity, int64_t n0, int64_t n1,
                               int64_t B0, int64_t B1, const LsmStageTerms* terms, void* stream);
/* K7 2D: flags[0] gates the axis-0 phase, flags[1] the axis-1 phase. */
int lsm_refresh_band_ghosts_2d_f32(void* P, int64_t n0, int64_t n1, const int* kinds,
                                   const int* degrees, const double* weights, const void* flags,
                                   void* stream);
int lsm_refresh_band_ghosts_2d_f64(void* P, int64_t n0, int64_t n1, const int* kinds,
                                   const int* degrees, const double* weights, const void* flags,
                                   void* stream);
/* K8 2D: arguments as for K8. */
int64_t lsm_band_retube_smem_2d(int64_t B0, int64_t B1, int64_t nlayers, int64_t chalo);
int lsm_band_retube_2d_f32(const void* P, void* band, const void* cand, const void* count,
                           void* flags, int64_t ncand, int64_t n0, int64_t n1, int64_t B0,
                           int64_t B1, int64_t nlayers, int64_t chalo, void* stream);
int lsm_band_retube_2d_f64(const void* P, void* band, const void* cand, const void* count,
                           void* flags, int64_t ncand, int64_t n0, int64_t n1, int64_t B0,
                           int64_t B1, int64_t nlayers, int64_t chalo, void* stream);

/* K10: the general path's 3D WENO5 advection stage (csrc/weno_general.cu):
 * out = alpha*aux + beta*phi - gamma * sum_d u_d * WENO5_d(phi). P: the field
 * padded by LSM_GHOST on every side, (n0+6, n1+6, n2+6); u0..u2, aux (may be
 * NULL: the alpha term is dropped) and out: interior-shaped (n0, n1, n2).
 * inv_h*: reciprocal node spacing per axis. One launch; offsets inside a
 * padded plane are 32-bit, so a larger plane is refused. */
int lsm_weno_general_3d_f32(const void* P, const void* u0, const void* u1, const void* u2,
                            const void* aux, void* out, int64_t n0, int64_t n1, int64_t n2,
                            double inv_h0, double inv_h1, double inv_h2,
                            double alpha, double beta, double gamma, void* stream);
int lsm_weno_general_3d_f64(const void* P, const void* u0, const void* u1, const void* u2,
                            const void* aux, void* out, int64_t n0, int64_t n1, int64_t n2,
                            double inv_h0, double inv_h1, double inv_h2,
                            double alpha, double beta, double gamma, void* stream);

/* K11: the same in 2D; P (n0+6, n1+6), u0, u1, aux, out (n0, n1). */
int lsm_weno_general_2d_f32(const void* P, const void* u0, const void* u1, const void* aux,
                            void* out, int64_t n0, int64_t n1, double inv_h0, double inv_h1,
                            double alpha, double beta, double gamma, void* stream);
int lsm_weno_general_2d_f64(const void* P, const void* u0, const void* u1, const void* aux,
                            void* out, int64_t n0, int64_t n1, double inv_h0, double inv_h1,
                            double alpha, double beta, double gamma, void* stream);

/* Human-readable name of a CUDA error code returned above. */
const char* lsm_error_string(int code);

#ifdef __cplusplus
}
#endif

#endif /* LSM_KERNELS_H */
