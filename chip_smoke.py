"""On-card smoke test of the PyTorch + CUDA port (``lsm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one line of results (any failure raises and the script
exits non-zero); ``python3 chip_smoke.py PHASE ...`` runs only the named
phases (a partial run: no kernel record):

1. device  — ``nvidia-smi`` name and power limit; no CUDA device is an error;
             ``lsm.sample`` with no ``device`` lands on the card.
2. build   — nvcc builds the kernels from ``lsm_tpu_torch/csrc`` (sm_90a, one
             process per source); prints the build time and ptxas
             register/spill counts, and a summary line per stage-adjoint
             kernel (K3, K3'', K3' and their reduction: registers, spills,
             static shared memory).
3. k2      — K2's 3D entry (one launch) vs its plain version and pad_ghost,
             bit for bit, at SHELL_SHAPES (an axis of 4 nodes, odd rows, an
             8-node axis under Extrapolation(7)), five BC cases and the
             degree-7 ones, f32 and f64; a second launch equal bits.
4. k1      — stage kernel vs its plain version, f32 (and f64).
5. k4k5    — ghost-cotangent fold (K4, out of place) vs its plain version bit
             for bit and the autograd transpose of ``pack_padded``, at K2's
             shapes and BC cases, f32 and f64: its input's bits untouched, a
             second launch and a launch on a misaligned copy equal bits;
             shell zeroing (K5, 3D and 2D) vs its plain version bit for bit at
             those shapes, K2's 2D ones (4096^2 among them) and axes of 1-3
             nodes, f32 and f64, on and off 16-byte alignment, the interior
             and the elements around the buffer untouched.
6. k3      — stage backward (K3) in f32 vs the f64 autograd oracle of stage +
             refresh, in f64 vs its plain version, in f32 vs its plain version.
7. k6k7k8  — the band kernels vs their plain versions at 40x72x136, f32 and
             f64: the active-tile stage (K6), the gated shell refresh (K7) on
             five BC cases and three gate settings, the incremental re-tube
             (K8) and the dispatch rebuilt from it.
   band_tiles — K6, K6'' and K6' vs their plain versions, and K8 bit for
             bit, at every tile shape of tools/band_tile_sweep.py (3D at
             40x72x136, 2D at 200x264), f32 and f64: K6's largest boxes of
             shared memory and K8's rows of several words.
   k1kinds — K1's term-list entry (K1') vs its plain version at 40x72x136
             on a torus, five BC cases, f32 and f64: normal motion (constant,
             streamed, callable speed), curvature (constant, streamed),
             eikonal (recomputed, frozen sign), a 3-term sum with aux; then
             at K1_MARCH_SHAPES (the march's edge shapes, the embedding
             included), f32 and f64, every kind and two sums with streams
             and aux off 16-byte alignment; a program table's route named.
   k6kinds — K6's term-list entry (K6') on the same cases over a sphere's
             dispatch list; the rest of the target bit for bit.
   k3kinds — the term-list stage adjoint (K3') vs its plain version at
             40x72x136 on a noisy torus, three tie-free BC cases, normal
             motion, curvature, eikonal (both signs) and sums (one with an
             advection term), with and without aux: f64 vs plain, f32 vs
             the f64 autograd oracle.
   k1analytic — K1'' (in-kernel coefficient programs) vs its plain version
             at 40x72x136, f32 and f64: the rotation, the time-dependent
             vortex, a program normal speed beside a constant curvature
             with aux; origin 0 and a nonzero origin; the programs' tables
             (csrc/coef_tables.cu) vs their plain version.
   k3analytic — K3'' vs its plain version in f64 and vs the f64 autograd
             oracle in f32, the stage time's cotangent included.
   k6analytic — K6'' vs its plain version over the sphere's dispatch list.
   k10k11  — the general path's WENO5 stage, K10 (3D, 40x72x136) and K11
             (2D, 67x131), vs their plain versions, five BC cases, f32 and
             f64, the bare Hamiltonian and stages with and without aux; a
             flat field; K10 at K1_MARCH_SHAPES (n0 >= 2) equal bit for bit
             to the interior of K1's march on the same inputs.
   k2_small — K2's 2D entry (one launch) on (n0+6, n1+6) buffers at ragged
             shapes and at 4096^2, five BC cases, f32 and f64, bit for bit vs
             its plain version and pad_ghost; K2 on a 3D field of one plane
             (the length-1 axis's Extrapolation(0)) bit for bit.
   k2_degree — K2 (3D, 2D, each single axis), K4 (3D, 2D) and K7 (3D, 2D,
             four gates) under Extrapolation(8), Extrapolation(11) and both
             mixed with Periodic and Symmetry, and degrees 17 and 19 (three
             chunks of loads), f32 and f64, at ragged shapes and 512^3, and
             Extrapolation(520) in f64: their weight-table route (the
             by-value kernels' threads reading a table of weights) bit for
             bit against the plain versions; one kernel a call, no copy, by
             the profiler's names;
             its times beside the by-value route's (Extrapolation(7)) and
             g.clone() at 512^3 (device times from tools/ghost_shells.py, a
             process of its own); the flagship under Extrapolation(8): 10 RK3
             steps of ``integrate`` on the fused path, a 64^3 f64 rollout
             gradient and a band card vs CPU.
   k1_2d   — K1's 2D entries (K1 and K1'' the 2D march, K1' and a K1''
             component per node one thread a node) and their per-node form
             vs the plain 2D stage at ragged shapes, f32 and f64, BC cases,
             with and without aux, streams and aux off alignment.
8. k512    — K1, K1'' (the rotation in-kernel, and its tables) and K2 vs
             their plain versions at the main path's 512^3 shape, on its own
             inputs (Zalesak field, rotation velocity); K2 bit for bit there
             and on config A's torus (Extrapolation(2)).
9. k3_512  — K3 and K3'' (the rotation in-kernel) at 512^3 on the main
             path's inputs: a 64^3 sub-box vs the f64 plain backward, the
             whole buffer finite, a second launch on the same inputs equal
             bit for bit; K4 and K5 bit for bit vs their plain versions at
             512^3, on a random cotangent and on K3's dP (K4 leaves its input
             alone and gives the same bits on a misaligned copy).
10. band_512 — the band bench's 512^3 sphere band, a few FE steps through
             K6-K8 and through their plain versions, the rotation in-kernel
             (K6'') and on the stream route (K6).
    kinds_512 — K1' vs plain at 512^3 on configs A, B and the kinds
             gradient's inputs (a second launch on A's and the kinds
             gradient's: equal bits), each with its route; K6' on config C's
             and on A's terms over the off-axis sphere band.
    k3kinds_512 — K3' at 512^3 on config A's and (dense) config C's inputs:
             a 64^3 sub-box vs the f64 plain K3', a second launch equal bit
             for bit; K3' and its plain version timed (the plain at 256^3).
11. slice  — 64^3 Zalesak RK3 ``integrate``: CPU (plain) vs card (kernels).
12. main   — the 512^3 Zalesak RK3 main path through
             ``LevelSetEquation.integrate`` as the JAX bench runs it, the
             rotation a callable evaluated in-kernel (K1''), then with the
             velocity streamed; launches counted, ms per step of both; then
             2 steps with a callable that does not trace (the stream route).
13. grad   — the gradient slice: ``value_and_grad`` of one fused FE step at
             512^3 (streamed and callable velocity) with a 64^3 f64
             central-difference check, and of a 20-step RK3 ``rollout``
             under remat at 512^3, counting K1-K5 launches; remat and
             card-vs-CPU gradient checks at 64^3 (f64 max norm; f32
             relative L2 against the CPU's own 1-ulp spread).
14. band   — the band main path: ``integrate`` on the 512^3 sphere
             ``NarrowBandField``, FE and RK3, counting K6-K8 launches; a
             forced dispatch-list overflow; 64^3 card vs CPU, and a band
             rollout's gradient card (band stepper) vs CPU.
    kinds  — configs A (torus, curvature + normal motion, RK3), B (eikonal
             reinitialization of a torus whose |grad| is not 1, both sign
             forms) and C (the sphere band under a streamed normal speed, FE
             and RK3) through ``integrate`` at 512^3, counting launches; A's
             terms on the off-axis band vs the plain versions; 64^3 card vs
             CPU; a gradient through a rollout of A's terms runs K3'.
    update — ``update_func`` terms on the dense fused stepper:
             ``integrate`` at 64^3 on the card against the CPU.
    grad_kinds — the dense kinds gradient (RK3 rollout, remat, curvature +
             normal motion at a streamed speed): 64^3 card vs CPU (f64 max
             norm, f32 relative L2), then 512^3 f32: ms per value_and_grad,
             peak memory, K1'/K2/K4/K3'/K5 launches, a profile.
    config5 — configuration 5 (shape optimisation through a band rollout) at
             64^3 x 8 steps, card vs CPU in f64 and f32 vs f64, K6'/K7/K8
             launched; at 256^3 f32: ms per loss_and_grad, peak memory, a
             profile.
    general_512 — H: the 512^3 Zalesak RK3 configuration through
             ``integrate`` with a posthook (the general path: K10 = 30, K1 = 0
             over 10 steps), with ``fast="off"``, and with a posthook that
             calls ``reinitialize`` every 5 steps; K10 vs plain on H's inputs.
    twod   — D1-D4 and D2s (configurations 1-4 of ``models.benchmarks``, D2s
             D2 streamed) at 4096^2 through ``integrate`` (D2-D4 the dense 2D
             stepper on (n+6, n+6): K1's and K2's 2D entries, no (1, n, n)
             launch; D2h, D2 with a posthook: K11; D1, upwind: no kernel);
             K1, K1'', K1' 2D vs plain on each one's state (a second launch
             equal bits), K2 2D and K11 vs plain at 4096^2; 256^2 card vs
             CPU.
    grad_2d — the dense 2D gradient (this slice's path): K4 and K5 2D bit for
             bit vs their plain versions at k2_small's shapes and BC cases (and
             a 3-node axis), f32 and f64 (input untouched, again and misaligned
             equal bits); K3/K3''/K3' 2D in f64 vs plain and in f32 vs the f64
             autograd oracle, twice equal bits; K3/K3''/K3' 2D at 4096^2 on
             the 2D cells' stage inputs, f32 vs the f64 plain version of
             sub-boxes (dP, du, daux, dcoef; 0 off the boxes); K4, K3 and
             K3' on 3D fields with a short axis (axis 0, all, axis 2) and
             their rollout gradients card vs CPU;
             Extrapolation(3) on 3 nodes raising ValueError; the 2D cells'
             gradients at 256^2 card vs CPU; grad2d (the rotation in-kernel and
             streamed) and grad2d_kinds at 4096^2: launches (2D entries only,
             no plain version called), ms per value_and_grad, peak memory; the
             kernels' and the plain-autograd yardstick's times from
             tools/grad_2d.py in a child process.
    general_small — card vs CPU: H and a band with hooks at 64^3,
             ``reinitialize`` at 64^3 f64, the general path's rollout
             gradient at 32^3 f64 (K10 launches in its forward).
    semi_implicit — SI: ``SemiImplicitI2OE`` (upwind, CFL 2) on the
             flagship's sphere at 512^3 f32 (3 steps) and configuration 2 at
             4096^2 (5 steps): ms a step, BiCGStab iterations, the relative
             residual, peak memory, no non-convergence warning; card vs CPU
             at 48^3 f64 and a gradient through a step at 32^3 f64.
    interp_sdf — NSDF: ``NewtonSDF`` of a sphere at 256^3 f64 (the lazy
             interpolant), ``reinitialize_newton`` over every node (its
             error against |x| - r), ``hausdorff_distance``; card vs CPU at
             32^3.
    quadrature — Q: volume and area of a 64^3 sphere from a field on the
             card, its interpolant eager and lazy.
    io     — the host-side modules on the 512^3 flagship:
             ``utils.profiling.timed`` around 10 ``FusedStepper.step`` calls
             against CUDA events (it waits for the card), ``StepMonitor`` as
             the posthook of ``integrate`` (the general path, K10),
             ``trace``'s Chrome trace naming K1'' and K2;
             ``io.marching_tetrahedra`` of a card field equal to its CPU
             copy's, a 512^3 sphere read back, marched, welded (watertight,
             area to 1e-3), exported (``export_surface_mesh``,
             ``write_obj``; ``export_volume_mesh`` at 64^3: its text is
             about 40 GB at 512^3). No plotting (host-side, tested on the
             CPU).
15. timing — CUDA-event medians at 512^3: K1-K5 (K2, K4 and K5 also back
             to back and by device time, K4 beside g.clone(); K2's single-axis
             phases at the shard shapes by device time: tools/ghost_shells.py,
             a process of its own), the FE and RK3 steps
             through the kernels and through the plain versions, the
             end-to-end ``integrate`` time per step for FE and RK3, the two
             gradient cells, and the plain backward; peak memory of each.
16. band_timing — K6-K8 alone, the band FE and RK3 steps (kernels and plain
             versions), the band ``integrate`` per step at 512^3 and 768^3
             beside the dense one at 768^3; peak memory of each.
    kinds_timing — K1' on A's (with and without aux), B's (both signs),
             the kinds gradient's table (with and without aux) and D4's
             inputs, K6' on C's, their plain versions, ``integrate`` per step
             of A, B and C; K1''s routes; peak memory.
    general_timing — K10 at 512^3 and K11 at 4096^2 with their plain
             versions, K1's 2D entries (with aux, per-node form, plain) and
             K2's at 4096^2, ``integrate`` per step of H (posthook,
             ``fast="off"``, fused) and of D1-D4, D2s, D2h; peak memory of
             each.
    analytic_timing — K1'', K3'', K6'' and the program tables at 512^3
             beside their plain versions; the flagship RK3 ``integrate`` per step with the
             rotation in-kernel and streamed, in turns.
    k9     — the shell writer K9 vs its plain version, bit for bit (random
             blocks, every subset, f32 and f64); K2's single-axis entry (also
             at 150x160x521, many blocks an SM, and on a buffer past 2^31
             elements, where K2's 3D entry and K7 under each gate take its
             three launches); the sharded refresh on (4, 1), (2, 2) and (1, 4)
             meshes of the card vs the single-device refresh, five BC cases;
             K9 timed at the 512^3 flagship's shard shapes.
    sharded — this slice's main path: the 512^3 flagship (in-kernel
             rotation, RK3, 10 steps) through make_sharded_evolve(fused=True) on
             (4, 1) and (2, 2) meshes of the card vs the single-device
             integrate; launches counted (K1'', K9, K2's phases); ms per step
             in turns; the sharded refresh per stage; the device busy share.
    sharded_grad — the sharded fused rollout's gradient at 64^3 vs the
             single-device card rollout (f64 max norm, f32 relative L2).
    sharded_general — make_sharded_step (K10 at 64^3, K11 at 256^2) and the
             sharded band evolve on a (2, 2) mesh vs the single-device runs.
    dryrun — dryrun_multichip(4) on the card: a sharded training step, the
             sharded dense, band and fused evolves.
17. profile — ``torch.profiler`` over 3 RK3 steps of the main path, the two
             gradient cells, 3 band FE and RK3 steps, and 3 RK3 steps each of
             configs A and C, H, D2 and D2h: device busy share of the wall
             time and device time by kernel.
18. revolution — D2 at 256^2 through one full revolution on the card and on
             the CPU: the area loss of each.

The last two lines are the card (``nvidia-smi``) and a JSON verdict; the line
before them holds the per-kernel JSON record: launches on the main paths,
error against the plain version, time, the plain version's time, the bound
(the larger of the bytes over 3.35 TB/s and the FP32 operations over 67
TFLOP/s, the H100 SXM data sheet's rates) and, where one PyTorch call computes
the same function, that call's time.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

import lsm_tpu_torch as lsm
from lsm_tpu_torch.core.bc import pad_ghost
from lsm_tpu_torch.core.narrowband import box_dilate
from lsm_tpu_torch.integrators.band_fused import FusedBandStepper, default_tiles
from lsm_tpu_torch.geometry import queries as geo
from lsm_tpu_torch.integrators.fused import _STAGES, FusedStepper
from lsm_tpu_torch.models import benchmarks as bench
from lsm_tpu_torch.models import shapes
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops import band as bd
from lsm_tpu_torch.ops import coef_program
from lsm_tpu_torch.ops import stencils as st
from lsm_tpu_torch.ops import weno_general as wg
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.ops import weno_v2_bwd as bwd
from lsm_tpu_torch import io as lio
from lsm_tpu_torch import parallel as par
from lsm_tpu_torch.parallel import fused_evolve as sfe
from lsm_tpu_torch.parallel.dryrun import dryrun_multichip
from lsm_tpu_torch.utils import profiling

N_MAIN = 512
N_SMALL = 64  # the gradient checks' small grid
N_PLAIN_BWD = 256  # the plain backward's timing grid when 512^3 does not fit
ROLLOUT_STEPS = 20  # cell (b): a 20-step RK3 rollout under remat
K1_TOL = 1e-5  # relative to max(|ref|, 1): the JAX on-chip parity bound
K2_TOL = 1e-6
K3_TOL = 1e-3  # f32 kernel vs the f64 oracle, relative to max|ref|: the JAX on-chip gate
K4_TOL = 1e-6  # relative to max(|ref|, 1)
F32_L2_FACTOR = 4.0  # f32 card-vs-CPU rollout gradient, times the CPU's 1-ulp L2 spread
VOL_TOL = 1e-3  # relative volume change over the main path's 10 RK3 steps
BAND_SMALL = (40, 72, 136)  # the band kernels' parity grid (ragged last tile on axis 2)
BAND_ODD = (40, 72, 133)  # the same, rows of odd length: K6's and K8's copies an element a time
BAND_STEPS = 10  # the band main path: steps of integrate, FE and RK3
BAND_CHECK_STEPS = 3  # the 512^3 band: kernels against plain versions
BAND_TINY = 1024  # a dispatch list too small for the 512^3 band: integrate must regrow it
N_BAND_XL = 768  # the band's winning regime: band and dense integrate at 768^3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
FP32_OPS_PER_S = 67e12
# FP32 operations per interior cell, counted from the sources (a division
# or reciprocal counts as one): csrc/weno_stage.cu 88 per axis + 5,
# csrc/stage_backward.cu 202 per axis + 1 (FE form, no aux)
K1_OPS_PER_CELL = 3 * 88 + 5
K3_OPS_PER_CELL = 3 * 202 + 1
# csrc/hamiltonians.cuh per node (a division, square root or pow as one):
# Godunov norms 3 * 43 + 6 (ENO2 31 per axis), normal motion 140, curvature
# 69, frozen eikonal 139, recomputed 146; the stage adds 3 and one per term.
# A curvature beside a normal or eikonal term shares their second
# differences (12 operations; 8 in 2D). In 2D (D4, the embedding) the
# Godunov norms take 2 * 43 + 6 (normal motion 97), the curvature 38.
KINDS_OPS = {"A": 140 + 69 - 12 + 2 + 3, "B": 139 + 1 + 3, "B none": 146 + 1 + 3,
             "C": 140 + 1 + 3, "D4": 97 + 38 - 8 + 2 + 3}
KINDS_STEPS = 10  # configs A, B and C at 512^3: steps of integrate
KINDS_SMALL_STEPS = 5  # their 64^3 card-vs-CPU trajectories
GATE_ULPS = 4  # curvature: nodes this close to its eps gate are counted, not compared
N_2D = 4096  # D1-D4, the canonical 2D configurations: a 4K frame
N_2D_SMALL = 256  # their card-vs-CPU trajectories and the revolution
BAND_2D_SMALL = (200, 264)  # the 2D band kernels' parity grid (ragged 16x16 tiles)
BAND_2D_STEPS = 10  # D2b and D4b: steps of integrate at N_2D^2
BAND_2D_CHECK_STEPS = 3  # D2b, D4b: kernels against plain versions at N_2D^2
N_BAND_2D_SMALL = 128  # the 2D band's card-vs-CPU trajectory and gradient, f64
GRAD2B_STEPS = 8  # grad2b: configuration 5's RK3 steps
GENERAL_STEPS = 10  # H and D1-D4: steps of integrate
GRAD_GENERAL_N = 32  # the general path's card-vs-CPU gradient, f64
REINIT_EVERY = 5  # H's reinitializing posthook runs every this many steps
SHARDS = 4  # the sharded cells: four shards on the one card
SHARDED_MESHES = ((4, 1), (2, 2))  # their mesh shapes
SHARDED_STEPS = 10  # the sharded flagship: RK3 steps, as the main path
SHARDED_TOL = 1e-6  # sharded vs single-device 512^3 trajectory, relative to max(|ref|, 1)
K9_SETS = 8  # K9's timing: buffers and block sets in turn, ~100 MB against the 50 MB L2
# card vs CPU: the times reached, each the sum of steps from a CFL bound that
# both reduce in the field's dtype, in another order
T_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
# csrc/weno_general.cu runs K1's per-node code (weno5.cuh): 88 per axis + 5
K11_OPS_PER_CELL = 2 * 88 + 5

# K3' (csrc/stage_backward.cu), counted from the source (a division, square
# root or compare-and-select as one): per node one Godunov adjoint (152: ENO2
# 40 per axis, the norms 4, 6 per normal term, the backward 22) and its 13
# gather weights (4 each); one curvature adjoint (135) and its 19 weights (3
# each); the stage terms 4, a stream cotangent 2. The kernel re-evaluates
# each adjoint at every node whose stencil holds it (13 or 19 times): that
# is its design's cost, not the function's.
K3K_OPS = {"A": 152 + 13 * 4 + 135 + 19 * 3 + 4, "C": 152 + 13 * 4 + 4 + 2}
K3K_BCS = {"periodic": lsm.Periodic, "extrap1": lsm.LinearExtrapolation,
           "symmetry": lsm.Symmetry}  # tie-free for WENO5: the raw dP compares
# Linear-extrapolation ghosts make the one-sided second difference at a face
# exactly 0 in float64 and a rounding residue in float32, so ENO2's minmod
# takes another branch (another subgradient) in the two precisions there: in
# that case the f32 kernel is held to its f32 plain version, not the oracle
K3K_F32_VS_PLAIN = ("extrap1",)
N_K3K_PLAIN = 256  # the plain K3' is timed at this grid (its autograd does not fit 512^3)
GRAD_KINDS_STEPS = 3  # the dense kinds gradient at 512^3: RK3 steps
N_CONFIG5 = 64  # configuration 5's published size: n and steps
CONFIG5_STEPS = 8
N_CONFIG5_XL = 256  # its timed size (the plain band backward is O(grid) per stage)
# configuration 5's sphere is mirror-symmetric: its upwind and minmod
# comparisons tie exactly, and two paths that round differently take other
# subgradients there; the card-vs-CPU checks add this much seeded noise
CONFIG5_NOISE = 1e-6

# the 2D entries of K6, K7 and K8, of K1 (K1, K1', K1'') and K2, and of the
# backward's K3 (K3, K3''), K3', K4 and K5, counted apart (``launches_2d``) as
# well as in their wrapper's ``launches``
TWOD_ENTRIES = {"K6 2D": bd.band_stage, "K7 2D": bd.refresh_band_ghosts_fast,
                "K8 2D": bd.band_retube_incremental, "K1 2D": v2.fused_stage,
                "K2 2D": v2.refresh_ghosts_fast, "K3 2D": bwd.stage_backward,
                "K3' 2D": bwd.stage_backward_terms, "K4 2D": bwd.fold_ghost_cotangent_fast,
                "K5 2D": bwd.zero_pad_shells}
COUNTED = {"K1": v2.fused_stage, "K2": v2.refresh_ghosts_fast, "K3": bwd.stage_backward,
           "K3'": bwd.stage_backward_terms,
           "K4": bwd.fold_ghost_cotangent_fast, "K5": bwd.zero_pad_shells,
           "K6": bd.band_stage, "K7": bd.refresh_band_ghosts_fast,
           "K8": bd.band_retube_incremental, "K10": wg.weno_stage_3d, "K11": wg.weno_stage_2d,
           "K9": sfe.write_shell_blocks, "K2ax": v2.refresh_axis_fast}
# the term-list entries of K1 and K6, counted apart (``kinds_launches``) as
# well as in their wrapper's ``launches``
KIND_ENTRIES = {"K1'": v2.fused_stage, "K6'": bd.band_stage}
# the launches with an in-kernel coefficient program (``program_launches``):
# K1'' and K6'' of the stage wrappers, K3'' of K3's and K3''s
PROGRAM_ENTRIES = {"K1''": (v2.fused_stage,), "K3''": (bwd.stage_backward,
                                                     bwd.stage_backward_terms),
                   "K6''": (bd.band_stage,)}
NONE_LAUNCHED = {name: 0 for name in (*COUNTED, *KIND_ENTRIES, *PROGRAM_ENTRIES,
                                      *TWOD_ENTRIES)}


def reset_counts():
    v2.program_tables.launches = 0
    for fn in COUNTED.values():
        fn.launches = 0
    for fn in TWOD_ENTRIES.values():
        fn.launches_2d = 0
    for fn in KIND_ENTRIES.values():
        fn.kinds_launches = 0
    for fns in PROGRAM_ENTRIES.values():
        for fn in fns:
            fn.program_launches = 0


def read_counts():
    out = {name: fn.launches for name, fn in COUNTED.items()}
    out.update({name: fn.kinds_launches for name, fn in KIND_ENTRIES.items()})
    out.update({name: sum(fn.program_launches for fn in fns)
                for name, fns in PROGRAM_ENTRIES.items()})
    out.update({name: fn.launches_2d for name, fn in TWOD_ENTRIES.items()})
    return out


def bound(nbytes, ops):
    """The least time on the card: ``(ms, what binds)``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def f32_weno_floor():
    """Evaluate WENO5 in float64 with float32's epsilon floor (1e-12), so that
    a float64 oracle computes the function the float32 kernel computes and
    differs from it by rounding only. With its own floor (1e-36) float64
    weighs near-flat stencils (differences at float32 round-off, as in a
    stage output) as another function: on the 512^3 RK3 stage-2 input that
    alone moved dP by 1.1e-2 and du2 by 3.6e5 of their maxima. The
    stencil module's epsilon is swapped for the context's duration only."""
    saved = st._weno_eps
    st._weno_eps = lambda vmax, dtype: 1.0e-6 * vmax + 1.0e-12
    try:
        yield
    finally:
        st._weno_eps = saved


def rel_err(got, ref):
    """``max|got - ref| / max|ref|`` in float64 (0 when both are 0)."""
    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    return err / scale if scale > 0 else err


def rel_l2(got, ref):
    """``||got - ref|| / ||ref||`` (L2) in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm())


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rotation(xs, t):
    """Rigid rotation about the domain's vertical axis: (0.5 - y, x - 0.5, 0)."""
    x, y, z = xs
    zero = 0.0 * (x + y + z)
    return (0.5 - y + zero, x - 0.5 + zero, zero)


def rotation_polar(xs, t):
    """:func:`rotation` in polar form, ``r (-sin th, cos th)`` about the axis
    x = y = 0.5: the same field, kept on the stream route (``torch.hypot``
    and ``torch.atan2`` are not among a program's functions), so a stepper
    evaluates it into streams at every stage."""
    x, y, z = xs
    r, th = torch.hypot(x - 0.5, y - 0.5), torch.atan2(y - 0.5, x - 0.5)
    return (-r * torch.sin(th), r * torch.cos(th), 0.0 * (x + y + z))


def bc_cases():
    return {
        "periodic": lsm.normalize_bcs(lsm.Periodic(), 3),
        "symmetry": lsm.normalize_bcs(lsm.Symmetry(), 3),
        "extrap0": lsm.normalize_bcs(lsm.Extrapolation(0), 3),
        "extrap2": lsm.normalize_bcs(lsm.Extrapolation(2), 3),
        "mixed": lsm.normalize_bcs([(lsm.Symmetry(), lsm.Extrapolation(1)), lsm.Periodic(),
                                    (lsm.Extrapolation(3), lsm.Symmetry())], 3),
    }


def cuda_time(fn, warmup=3, reps=20) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def zalesak(n, device, dtype=torch.float32):
    grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (n, n, n))
    phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=dtype, device=device)
    vel = lsm.sample(lambda *xs: rotation(xs, 0.0), grid, dtype=dtype, device=device,
                     vector=True)
    return grid, phi, vel


#: K2's and K4's 3D shapes: the smoke's grid, an axis of 4 nodes (every node
#: fed from both faces), rows of odd length, an 8-node axis (Extrapolation(7))
SHELL_SHAPES = ((40, 72, 136), (4, 37, 75), (8, 19, 33), (67, 4, 9))


def shell_cases(shape):
    """The five BC cases, and on a shape whose axes all hold 8 nodes
    ``Extrapolation(7)`` alone and mixed per side with Symmetry and Periodic."""
    cases = bc_cases()
    if min(shape) >= 8:
        cases["extrap7"] = lsm.normalize_bcs(lsm.Extrapolation(7), 3)
        cases["mixed7"] = lsm.normalize_bcs([(lsm.Extrapolation(7), lsm.Symmetry()),
                                             lsm.Periodic(),
                                             (lsm.Symmetry(), lsm.Extrapolation(5))], 3)
    return cases


def scribbled(vals, bcs, gen):
    """``pack_padded(vals)`` with random values written over its shells."""
    P = v2.pack_padded(vals, bcs)
    shell = shell_mask(vals.shape, vals.device)
    P[shell] = torch.randn(int(shell.sum()), generator=gen, device=vals.device, dtype=vals.dtype)
    return P


def k2_compare(phase, label, vals, bcs, gen):
    """K2 (one launch) on ``vals`` packed with scribbled shells: equal to its
    plain version and to ``pack_padded(vals)``, and a second launch on the same
    input equal bit for bit."""
    shape = tuple(vals.shape)
    P = scribbled(vals, bcs, gen)
    got = v2.refresh_ghosts_fast(P.clone(), bcs, shape)
    ref = v2.refresh_ghosts_plain(P.clone(), bcs, shape)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    err_pad = float((got - v2.pack_padded(vals, bcs)).abs().max())
    again = same_bits(got, v2.refresh_ghosts_fast(P.clone(), bcs, shape))
    log(phase, f"K2 {label} {str(vals.dtype)[6:]} shape={shape} max|kernel-plain|={err:.3e} "
               f"max|kernel-pad_ghost|={err_pad:.3e} (both must be 0); a second launch "
               f"equal bits: {again}")
    if not (err == 0.0 and err_pad == 0.0 and again):
        raise AssertionError(f"K2 failed for {label} at {shape}: {err} / {err_pad}, {again}")
    return err


def phase_k2(dev, res):
    """K2's 3D entry against its plain version and ``pad_ghost``, bit for bit,
    at SHELL_SHAPES under their BC cases, f32 and f64, scribbled shells."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for shape in SHELL_SHAPES:
        for dtype in (torch.float32, torch.float64):
            for name, bcs in shell_cases(shape).items():
                vals = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                worst = max(worst, k2_compare("k2", name, vals, bcs, gen))
    res["k2_err"] = worst


#: K7's shapes: the band kernels' parity grid, a ragged one with every axis
#: of at least 8 nodes (Extrapolation(7)), and one whose work under each gate
#: exceeds the kernel's grid (4 blocks of 256 threads an SM: 528 blocks on a
#: 132-SM H100), so that its grid-stride loop takes a second pass under
#: (1, 1), (1, 0) and (0, 1); 2D likewise (its (0, 1) work is 6 (n0 + 6)
#: threads, its (1, 0) work 6 n1)
K7_SHAPES = (BAND_SMALL, (9, 13, 70), (150, 160, 521))
K7_2D_SHAPES = (BAND_2D_SMALL, (13, 131), (22531, 22537))
K7_FLAGS = ((1, 1), (1, 0), (0, 1), (0, 0))


def shell_cases_2d(shape):
    """The 2D BC cases, and on a shape whose axes both hold 8 nodes
    ``Extrapolation(7)`` alone and mixed per side."""
    cases = bc_cases_2d()
    if min(shape) >= 8:
        cases["extrap7"] = lsm.normalize_bcs(lsm.Extrapolation(7), 2)
        cases["mixed7"] = lsm.normalize_bcs([(lsm.Extrapolation(7), lsm.Symmetry()),
                                             lsm.Periodic()], 2)
    return cases


def k7_compare(phase, shape, cases, dtype, dev, gen, vals=None):
    """K7 (one launch, 3D or 2D) on ``vals`` (random values where None)
    packed with scribbled shells under each BC case and each of the four
    gates: equal to its plain version bit for bit (under (0, 1) the last
    axis's ghosts of the earlier axes' ghost rows read the scribbled values),
    and (0, 0) leaves the buffer's bits."""
    for name, bcs in cases.items():
        Q = scribbled(torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                      if vals is None else vals, bcs, gen)
        for flags in K7_FLAGS:
            f = torch.tensor(flags, dtype=torch.int32, device=dev)
            got = bd.refresh_band_ghosts_fast(Q.clone(), bcs, shape, f)
            ref = bd.refresh_band_ghosts_plain(Q.clone(), bcs, shape, f)
            torch.cuda.synchronize()
            kept = flags != (0, 0) or same_bits(got, Q)
            if not (same_bits(got, ref) and kept):
                raise AssertionError(f"K7 differs from its plain version at {shape} ({name}, "
                                     f"{str(dtype)[6:]}, flags {flags})")
    log(phase, f"K7 {len(shape)}D {str(dtype)[6:]} shape={shape} {' '.join(cases)}: flags "
               f"(1,1) (1,0) (0,1) (0,0) kernel == plain bit for bit, (0,0) leaves the buffer "
               f"as it was")


# K1's and K1''s shapes where the march treats a tile apart: the 2D embedding
# (n0 = 1, axis 0 compiled out; its axis-0 ghosts copy the plane, as
# Extrapolation(0) refreshes them), axis 0 not a multiple of the march's
# chunk (64 planes), and columns that tile neither axis 1 (16) nor axis 2
# (32): with an odd n2 (element copies) and with n2 % 4 == 0 (pairs for the
# tile and aux, 16-byte velocity copies, cut at the last tile)
K1_MARCH_SHAPES = ((1, 75, 133), (67, 37, 75), (130, 20, 33), (67, 37, 100), (1, 45, 264))
K1_MISALIGNED_SHAPE = (67, 37, 100)  # aux and u1 one element off their alignment there


def k1_inputs(shape, dtype, dev, gen):
    """A padded buffer of random values for K1 at ``shape`` (its ghosts
    random too, or on the embedding (n0 = 1) the Extrapolation(0) copies
    of the plane along axis 0 and periodic ones on the other axes), a
    random aux buffer and the grid's spacing and ``lo``."""
    grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (max(shape[0], 2), *shape[1:]))
    if shape[0] == 1:
        bcs = ((lsm.Extrapolation(0), lsm.Extrapolation(0)),
               *lsm.normalize_bcs(lsm.Periodic(), 2))
        P = v2.pack_padded(torch.randn(shape, generator=gen, device=dev, dtype=dtype), bcs)
    else:
        P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
    A = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
    return P, A, grid.spacing, grid.lo


def misaligned(x):
    """A contiguous copy of ``x`` that starts one element into its storage:
    off the alignment the march's copies of two elements and of 16 bytes
    need, so its launch copies an element at a time."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    return out.copy_(x)


def k1_compare(phase, label, P, terms, coeffs, aux, sp, shape, where=None, tol=None):
    """K1 (or K1'') against its plain version on the same inputs, within
    ``tol`` (K1_TOL in float32, 1e-12 in float64) times max(|ref|, 1);
    returns max|kernel - plain|."""
    tol = tol or (K1_TOL if P.dtype == torch.float32 else 1e-12)
    got = v2.unpack_padded(v2.fused_stage(P, terms, coeffs, aux, sp, shape, where), shape)
    ref = v2.unpack_padded(v2.stage_plain(P, terms, coeffs, aux, sp, shape, where), shape)
    err = float((got - ref).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    log(phase, f"{label} {str(P.dtype)[6:]} shape={tuple(shape)} aux={aux is not None} "
               f"max|kernel-plain|={err:.3e} scale={scale:.3e} tol={tol:g}*scale")
    if not (bool(torch.isfinite(got).all()) and err <= tol * scale):
        raise AssertionError(f"{label} parity failed at {tuple(shape)}: {err} > {tol} * {scale}")
    return err


def phase_k1(dev, res):
    """K1 against its plain version, f32 and f64: random buffers at a shape
    of each dtype and at K1_MARCH_SHAPES in both, with and without aux."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(torch.float32, (96, 128, 160)), (torch.float64, (32, 48, 64))]
    cases += [(dtype, shape) for shape in K1_MARCH_SHAPES
              for dtype in (torch.float32, torch.float64)]
    for dtype, shape in cases:
        P, A, sp, lo = k1_inputs(shape, dtype, dev, gen)
        xs = v2.node_coords(shape, sp, lo, dtype, dev)
        u = v2.eval_components(rotation(xs, 0.0), shape, dtype, dev)  # u2 == 0: ties
        if shape[0] == 1:  # the embedding: any u0 (its term is exactly zero)
            u = (torch.randn(shape, generator=gen, device=dev, dtype=dtype), *u[1:])
        for aux, coeffs in ((None, (0.0, 1.0, 1e-3)), (A, (0.75, 0.25, 2.5e-4))):
            err = k1_compare("k1", "K1", P, u, coeffs, aux, sp, shape)
            if dtype == torch.float32:
                worst = max(worst, err)
        if shape == K1_MISALIGNED_SHAPE:  # the same stage from misaligned aux and u1
            coeffs = (0.75, 0.25, 2.5e-4)
            mu = (u[0], misaligned(u[1]), u[2])
            err = k1_compare("k1", "K1 misaligned aux, u1", P, mu, coeffs, misaligned(A), sp,
                             shape)
            same = torch.equal(*(v2.unpack_padded(v2.fused_stage(P, w, coeffs, a, sp, shape),
                                                  shape) for w, a in ((u, A), (mu, misaligned(A)))))
            log("k1", f"K1 {str(dtype)[6:]} shape={shape}: aligned and misaligned inputs "
                      f"give equal bits: {same}")
            if not same:
                raise AssertionError(f"K1 at {shape}: misaligned aux and u1 change the bits")
            if dtype == torch.float32:
                worst = max(worst, err)
    res["k1_err"] = worst


def shell_mask(shape, dev):
    """True on the ghost shells of a padded buffer."""
    mask = torch.ones(v2.padded_shape(shape), dtype=torch.bool, device=dev)
    v2.unpack_padded(mask, shape).fill_(False)
    return mask


def phase_device(dev, res):
    """The entry points default to the card: ``sample`` without ``device``."""
    grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (8, 8, 8))
    phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic())
    log("device", f"lsm.sample without device -> {phi.values.device}")
    if phi.values.device.type != "cuda":
        raise AssertionError(f"sample() without device landed on {phi.values.device}")


def k4_compare(phase, label, G, bcs, shape, autograd=True):
    """K4 on ``G``: ``G``'s bits left as they were, the output equal to the
    plain version's, zero shells, a second launch and a launch on a
    misaligned copy of ``G`` equal bit for bit, and (``autograd``) within
    K4_TOL of the autograd transpose of ``pack_padded``."""
    before = G.clone()
    got = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
    plain = bwd.fold_ghost_cotangent_plain(G.clone(), bcs, shape)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    untouched = same_bits(G, before)
    shells_zero = not bool(got[shell_mask(shape, G.device)].any())
    msg = ""
    if autograd:
        ref = bwd.fold_ghost_cotangent(G, bcs, shape)
        scale = max(float(ref.abs().max()), 1.0)
        err_ref = float((v2.unpack_padded(got, shape) - ref).abs().max())
        msg = f" max|kernel-autograd|={err_ref:.3e} (tol {K4_TOL:g}*{scale:.3e})"
        if not err_ref <= K4_TOL * scale:
            raise AssertionError(f"K4 {label} at {shape} differs from autograd: {err_ref}")
    again = same_bits(got, bwd.fold_ghost_cotangent_fast(G, bcs, shape))
    off = same_bits(got, bwd.fold_ghost_cotangent_fast(misaligned(G), bcs, shape))
    log(phase, f"K4 {label} {str(G.dtype)[6:]} shape={shape} max|kernel-plain|={err:.3e} "
               f"(must be 0){msg} shells_zero={shells_zero} input untouched={untouched}; "
               f"equal bits: a second launch {again}, on a misaligned copy {off}")
    if not (err == 0.0 and shells_zero and untouched and again and off):
        raise AssertionError(f"K4 {label} at {shape}: {err}, shells_zero={shells_zero}, "
                             f"input untouched={untouched}, again={again}, misaligned={off}")
    return err


#: K5's shapes besides SHELL_SHAPES and K2_2D_SHAPES (D2b's 4096^2 among
#: them): axes of 1-3 nodes, gaps between planes and a 2D head longer than a
#: block's chunk of vectors
K5_SHAPES = ((1, 7, 5), (3, 2, 9), (2, 3, 1), (3, 2, 700), (1, 5), (3, 2), (3, 1400))


def k5_compare(shape, dtype, off, gen):
    """K5 on a padded buffer of ``shape`` (3D or 2D) of random values that
    starts ``off`` elements into its allocation (off 16-byte alignment for
    ``off`` 1): equal to its plain version bit for bit, its interior and the
    elements around it untouched. Returns ``max|kernel - plain|`` (0) or
    raises."""
    numel = math.prod(v2.padded_shape(shape))
    base = torch.randn(numel + off + 1, generator=gen, device=gen.device, dtype=dtype)
    keep = base.clone()
    buf = base[off:off + numel].view(v2.padded_shape(shape))
    ref = bwd.zero_pad_shells_plain(buf.clone(), shape)
    out = bwd.zero_pad_shells(buf, shape)
    torch.cuda.synchronize()
    inner = same_bits(v2.unpack_padded(buf, shape).contiguous(),
                      v2.unpack_padded(keep[off:off + numel].view(buf.shape), shape).contiguous())
    around = same_bits(base[:off], keep[:off]) and same_bits(base[off + numel:],
                                                              keep[off + numel:])
    if not (out is buf and same_bits(buf, ref) and inner and around):
        raise AssertionError(f"K5 at {shape} {dtype} {off} elements off: equal bits "
                             f"{same_bits(buf, ref)}, interior untouched {inner}, around "
                             f"untouched {around}")
    return float((buf - ref).abs().max())


def phase_k4k5(dev, res):
    """K4 at SHELL_SHAPES under their BC cases, f32 and f64
    (:func:`k4_compare`); K5 against its plain version bit for bit at
    SHELL_SHAPES, K2_2D_SHAPES and K5_SHAPES, f32 and f64, on buffers on and
    off 16-byte alignment, interiors untouched (:func:`k5_compare`)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0.0
    for shape in SHELL_SHAPES:
        for dtype in (torch.float32, torch.float64):
            for name, bcs in shell_cases(shape).items():
                G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
                worst = max(worst, k4_compare("k4k5", name, G, bcs, shape))
    worst5, shapes = 0.0, SHELL_SHAPES + K2_2D_SHAPES + K5_SHAPES
    for shape in shapes:
        for dtype in (torch.float32, torch.float64):
            for off in (0, 1):
                worst5 = max(worst5, k5_compare(shape, dtype, off, gen))
    log("k4k5", f"K5 == plain bit for bit, interiors and neighbours untouched, at {shapes}, "
                f"f32 and f64, on and off 16-byte alignment")
    res["k4_err"], res["k5_err"] = worst, worst5


def _k3_compare(tag, got, ref, shape, bcs, tol):
    """Worst relative error of K3's outputs against ``ref``'s: dP folded to
    the interior, du, daux (interior), and each of dalpha/dbeta/dgamma."""
    fold = lambda d: bwd.fold_ghost_cotangent(d.double(), bcs, shape)
    errs = {"dP": rel_err(fold(got[0]), fold(ref[0]))}
    for d in range(3):
        errs[f"du{d}"] = rel_err(got[1][d], ref[1][d])
    if ref[3] is not None:
        errs["daux"] = rel_err(v2.unpack_padded(got[3], shape), v2.unpack_padded(ref[3], shape))
    for k, name in enumerate(("dalpha", "dbeta", "dgamma")):
        errs[name] = rel_err(got[2][k:k + 1], ref[2][k:k + 1])
    worst = max(errs.values())
    log("k3", f"{tag}: " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
        + f" (max|err|/max|ref|, tol {tol:g})")
    if not (worst <= tol and all(bool(torch.isfinite(t).all()) for t in (got[0], *got[1]))):
        raise AssertionError(f"K3 parity failed ({tag}): {errs}")
    return worst


def phase_k3(dev, res):
    """K3 on a Zalesak field (WENO-symmetric tie cells) with the rotation
    velocity (u2 == 0 exactly): f32 against the f64 autograd oracle of stage
    + refresh (with the f32 epsilon floor, :func:`f32_weno_floor`), f64
    against its plain version, f32 against its plain version (reported)."""
    shape = (96, 128, 160)
    grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
    sp = grid.spacing
    gen = torch.Generator(device=dev).manual_seed(5)
    worst_plain = 0.0
    for dtype in (torch.float32, torch.float64):
        phi = lsm.sample(shapes.zalesak_sphere(), grid, lsm.Periodic(), dtype=dtype, device=dev)
        bcs = phi.bcs
        P = v2.pack_padded(phi.values, bcs)
        A = v2.pack_padded(torch.randn(shape, generator=gen, device=dev, dtype=dtype), bcs)
        G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
        xs = v2.node_coords(shape, sp, grid.lo, dtype, dev)
        u = v2.eval_components(rotation(xs, 0.0), shape, dtype, dev)
        for aux, coeffs in ((None, (0.0, 1.0, 1e-3)), (A, (0.75, 0.25, 2.5e-4))):
            gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
            got = bwd.stage_backward(P, u, coeffs, aux, gf, sp, shape)
            plain = bwd.stage_backward_plain(P, u, coeffs, aux, gf, sp, shape)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]} aux={aux is not None}"
            if dtype == torch.float32:
                d = lambda t: None if t is None else t.double()
                with f32_weno_floor():
                    ref = bwd.composite_backward_autograd(d(P), [c.double() for c in u], coeffs,
                                                          d(aux), G.double(), bcs, sp, shape)
                _k3_compare(f"{tag} kernel vs f64 oracle", got, ref, shape, bcs, K3_TOL)
                err = max(float((got[0] - plain[0]).abs().max()),
                          *(float((a - b).abs().max()) for a, b in zip(got[1], plain[1])))
                log("k3", f"{tag} kernel vs f32 plain: max|dP, du diff|={err:.3e} "
                          f"(reported)")
                worst_plain = max(worst_plain, err)
            else:
                _k3_compare(f"{tag} kernel vs plain", got, plain, shape, bcs, 1e-10)
    res["k3_err"] = worst_plain


def _sub_box(n, B, centre):
    """Padded start index of a B-node box around ``centre`` (a fraction of
    the axis) whose outputs within reach 3 are all interior."""
    a = 3 + int(centre * (n - 1)) - B // 2
    return min(max(a, 6), n - B)


def same_bits(first, again):
    """Whether two launches' outputs (tensors, tuples of them or None) are
    equal bit for bit."""
    if isinstance(first, (tuple, list)):
        return len(first) == len(again) and all(same_bits(a, b) for a, b in zip(first, again))
    if first is None or again is None:
        return first is again
    return bool(torch.equal(first.view(torch.int8), again.view(torch.int8)))


def repeat_check(phase, label, call, first):
    """Launch ``call`` again on the same inputs and require the bits of
    ``first``: the kernels sum in a fixed order, with no atomics."""
    again = call()
    torch.cuda.synchronize()
    equal = same_bits(first, again)
    log(phase, f"{label}: a second launch on the same inputs gives equal bits: {equal}")
    if not equal:
        raise AssertionError(f"{label}: two launches on the same inputs differ")


def phase_k3_512(dev, res):
    """K3 at 512^3 on the main path's inputs, stage 1 and an RK3 stage with
    aux: a sub-box (around the slot, where u1 == 0) against the f64 plain
    backward of that sub-box (its outputs within reach included; the f32
    epsilon floor, :func:`f32_weno_floor`), the whole buffer finite. K4 and
    K5 against their plain versions, bit for bit, on a random cotangent with
    every shell set and on each K3 ``dP`` (what K4 folds next in a rollout's
    backward)."""
    grid, phi, vel = zalesak(N_MAIN, dev)
    shape, sp, bcs, n = grid.shape, grid.spacing, phi.bcs, N_MAIN
    stepper = FusedStepper(lsm.AdvectionTerm(vel), phi, lsm.RK3())
    P = stepper.pack(phi.values)
    u = stepper.stage_terms(0.0)[0][1]
    dt = 0.5 * float(lsm.compute_cfl(stepper.terms, phi, 0.0))
    P1 = v2.fused_step_stage(P, u, (0.0, 1.0, dt), None, bcs, sp, shape)
    G = torch.randn(v2.padded_shape(shape), generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    k4k5_512(G, bcs, shape, "random cotangent, every shell", res)
    B = min(64, n // 2)
    a = [_sub_box(n, B, c) for c in (0.5, 0.75, 0.5)]
    box = tuple(slice(x - 6, x + B + 6) for x in a)
    inner_p = tuple(slice(6, 6 + B) for _ in a)
    inner_i = tuple(slice(3, 3 + B) for _ in a)
    worst = 0.0
    for label, src, aux, coeffs in (("stage 1", P, None, (0.0, 1.0, dt)),
                                    ("RK3 stage 2", P1, P, (0.75, 0.25, 0.25 * dt))):
        gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
        call = lambda: bwd.stage_backward(src, u, coeffs, aux, gf, sp, shape)
        dP, du, dcoef, daux = first = call()
        repeat_check("k3_512", f"K3 {label}", call, first)
        del first
        finite = all(bool(torch.isfinite(t).all()) for t in (dP, *du, dcoef)) and (
            daux is None or bool(torch.isfinite(daux).all()))
        sub = (B + 6,) * 3
        d = lambda t: None if t is None else t[box].double().contiguous()
        with f32_weno_floor():
            ref = bwd.stage_backward_plain(
                d(src), [c[tuple(slice(x - 6, x + B) for x in a)].double().contiguous()
                         for c in u], coeffs, d(aux), d(gf), sp, sub)
        region = tuple(slice(x, x + B) for x in a)
        region_i = tuple(slice(x - 3, x - 3 + B) for x in a)
        errs = {"dP": rel_err(dP[region], ref[0][inner_p])}
        for k in range(3):
            errs[f"du{k}"] = rel_err(du[k][region_i], ref[1][k][inner_i])
        if daux is not None:
            errs["daux"] = rel_err(daux[region], ref[3][inner_p])
        w = max(errs.values())
        log("k3_512", f"{label:11s} {n}^3 f32 sub-box {B}^3 at {a}: "
                      + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                      + f" (tol {K3_TOL:g}) finite={finite}")
        if not (finite and w <= K3_TOL):
            raise AssertionError(f"K3 at {n}^3 failed ({label}): {errs}, finite={finite}")
        worst = max(worst, w)
        # K3's dP is what K4 folds next in a rollout's backward
        k4k5_512(dP, bcs, shape, f"K3's dP of {label}", res)
        del dP, du, daux, gf
    res["k3_512_rel"] = worst
    # K3'' on the same inputs with the rotation in-kernel, as cell (b) runs
    # it: the plain sub-box evaluates the program from the box's first node
    prog = program_term("advection", rotation)[0].coef_static
    origin = tuple(x - 6 for x in a)
    worst = worst_abs = 0.0
    for label, src, aux, coeffs in (("stage 1", P, None, (0.0, 1.0, dt)),
                                    ("RK3 stage 2", P1, P, (0.75, 0.25, 0.25 * dt))):
        gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
        call = lambda: bwd.stage_backward(src, prog, coeffs, aux, gf, sp, shape,
                                          where=v2.Where(grid.lo))
        dP, du, dcoef, daux = first = call()
        repeat_check("k3_512", f"K3'' {label}", call, first)
        del first
        finite = all(bool(torch.isfinite(t).all()) for t in (dP, dcoef)) and (
            daux is None or bool(torch.isfinite(daux).all()))
        d = lambda t: None if t is None else t[box].double().contiguous()
        with f32_weno_floor():
            ref = bwd.stage_backward_plain(d(src), prog, coeffs, d(aux), d(gf), sp, (B + 6,) * 3,
                                           where=v2.Where(grid.lo, origin))
        region = tuple(slice(x, x + B) for x in a)
        errs = {"dP": rel_err(dP[region], ref[0][inner_p])}
        if daux is not None:
            errs["daux"] = rel_err(daux[region], ref[3][inner_p])
        w = max(errs.values())
        log("k3_512", f"K3'' {label:11s} {n}^3 f32 rotation in-kernel, sub-box {B}^3 at {a} "
                      f"(origin {origin}): " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                      + f" (tol {K3_TOL:g}) du={du} finite={finite}")
        if not (finite and w <= K3_TOL and du is None and dcoef.numel() == 4):
            raise AssertionError(f"K3'' at {n}^3 failed ({label}): {errs}, finite={finite}")
        worst = max(worst, w)
        worst_abs = max(worst_abs, float((dP[region].double() - ref[0][inner_p]).abs().max()))
        del dP, daux, gf
    res["k3a_512_rel"] = worst
    res["k3a_err"] = max(res["k3a_err"], worst_abs)


def k4k5_512(G, bcs, shape, label, res):
    """K4 (:func:`k4_compare`: bit for bit, input untouched, twice and on a
    misaligned copy) and K5 bit for bit against their plain versions on a
    padded buffer of the main path's shape; their max|kernel - plain| go into
    ``res``."""
    err4 = k4_compare("k3_512", label, G, bcs, shape, autograd=False)
    got = bwd.zero_pad_shells(G.clone(), shape)
    err5 = float((got - bwd.zero_pad_shells_plain(G.clone(), shape)).abs().max())
    log("k3_512", f"{N_MAIN}^3 f32 {label}: K4 max|kernel-plain|={err4:.3e}, "
                  f"K5 max|kernel-plain|={err5:.3e} (both must be 0)")
    if not (err4 == 0.0 and err5 == 0.0):
        raise AssertionError(f"K4/K5 at {N_MAIN}^3 differ from their plain versions ({label})")
    res["k4_err"], res["k5_err"] = max(res["k4_err"], err4), max(res["k5_err"], err5)


def phase_k512(dev, res):
    """K1 and K2 against their plain versions at the main path's shape, on
    the main path's inputs: stage 1 and stage 2 of an RK3 step, the bare
    operator ``-u.grad(phi)`` (gamma = 1, so an error in it is not scaled
    down by dt), and the shell refresh of a stage output with scribbled
    shells."""
    grid, phi, vel = zalesak(N_MAIN, dev)
    shape, sp, bcs = grid.shape, grid.spacing, phi.bcs
    stepper = FusedStepper(lsm.AdvectionTerm(vel), phi, lsm.RK3())
    P = stepper.pack(phi.values)
    u = stepper.stage_terms(0.0)[0][1]
    dt = 0.5 * float(lsm.compute_cfl(stepper.terms, phi, 0.0))
    P1 = v2.refresh_ghosts_plain(v2.stage_plain(P, u, (0.0, 1.0, dt), None, sp, shape),
                                 bcs, shape)
    worst = 0.0
    for label, src, aux, coeffs in (("stage 1", P, None, (0.0, 1.0, dt)),
                                    ("stage 2", P1, P, (0.75, 0.25, 0.25 * dt)),
                                    ("-u.grad(phi)", P, None, (0.0, 0.0, 1.0))):
        g = v2.unpack_padded(v2.fused_stage(src, u, coeffs, aux, sp, shape), shape)
        r = v2.unpack_padded(v2.stage_plain(src, u, coeffs, aux, sp, shape), shape)
        err = float((g - r).abs().max())
        scale = max(float(r.abs().max()), 1.0)
        ok = bool(torch.isfinite(g).all()) and err <= K1_TOL * scale
        log("k512", f"K1 {label:12s} {N_MAIN}^3 f32 max|kernel-plain|={err:.3e} "
                    f"scale={scale:.3e} tol={K1_TOL:g}*scale")
        if not ok:
            raise AssertionError(f"K1 parity at {N_MAIN}^3 failed ({label}): "
                                 f"{err} > {K1_TOL} * {scale}")
        worst = max(worst, err)
        del g, r
    # K1'' on the same inputs with the rotation in-kernel, as the main path
    # runs it (the program and its tables at the grid's lo)
    terms, where = (program_term("advection", rotation),), v2.Where(grid.lo)
    res["tables_err"] = max(res.get("tables_err", 0.0), check_tables(
        [terms[0][0].coef_static], shape, sp, where, P, "k512"))
    worst_p = 0.0
    for label, src, aux, coeffs in (("stage 1", P, None, (0.0, 1.0, dt)),
                                    ("stage 2", P1, P, (0.75, 0.25, 0.25 * dt)),
                                    ("-u.grad(phi)", P, None, (0.0, 0.0, 1.0))):
        g = v2.unpack_padded(v2.fused_stage(src, terms, coeffs, aux, sp, shape, where), shape)
        r = v2.unpack_padded(v2.stage_plain(src, terms, coeffs, aux, sp, shape, where), shape)
        err = float((g - r).abs().max())
        scale = max(float(r.abs().max()), 1.0)
        log("k512", f"K1'' {label:12s} {N_MAIN}^3 f32 rotation in-kernel max|kernel-plain|="
                    f"{err:.3e} scale={scale:.3e} tol={K1_TOL:g}*scale")
        if not (bool(torch.isfinite(g).all()) and err <= K1_TOL * scale):
            raise AssertionError(f"K1'' parity at {N_MAIN}^3 failed ({label}): "
                                 f"{err} > {K1_TOL} * {scale}")
        worst_p = max(worst_p, err)
        del g, r
    res["k1a_err"] = max(res["k1a_err"], worst_p)
    # the march's bits do not depend on the launch: K1 and K1'' twice on RK3
    # stage 2's inputs (the interior: the kernels leave the shells unset)
    for label, terms_i, where_i in (("K1", u, None), ("K1''", terms, where)):
        call = (lambda t=terms_i, w=where_i: v2.unpack_padded(v2.fused_stage(
            P1, t, (0.75, 0.25, 0.25 * dt), P, sp, shape, w), shape).contiguous())
        first = call()
        repeat_check("k512", f"{label} {N_MAIN}^3 stage 2", call, first)
        del first
    # the sharded flagship's shards (make_sharded_evolve on (4, 1) and (2, 2)
    # meshes): the padded block of the 512^3 buffer a shard holds, its
    # velocity, and its program at the shard's nonzero origin
    for mesh_shape, at in (((4, 1), (N_MAIN // 4, 0)), ((2, 2), (N_MAIN // 2, N_MAIN // 2))):
        sub = (N_MAIN // mesh_shape[0], N_MAIN // mesh_shape[1], N_MAIN)
        box = tuple(slice(a, a + m) for a, m in zip(at, sub[:2]))
        pbox = tuple(slice(a, a + m + 2 * v2.GHOST) for a, m in zip(at, sub[:2]))
        where_s = v2.Where(grid.lo, (*at, 0), 0.0)
        for dtype in (torch.float32, torch.float64):
            Ps, As = P1[pbox].to(dtype).contiguous(), P[pbox].to(dtype).contiguous()
            us = tuple(c[box].to(dtype).contiguous() for c in u)
            for label, terms_s in (("K1", us), (f"K1'' rotation origin {(*at, 0)}", terms)):
                err = k1_compare("k512", f"{label} shard of {mesh_shape}", Ps, terms_s,
                                 (0.75, 0.25, 0.25 * dt), As, sp, sub, where_s)
                if dtype == torch.float32:
                    key = "k1_err" if label == "K1" else "k1a_err"
                    res[key] = max(res[key], err)
            del Ps, As, us
    # K2 on a stage output (Periodic) and on config A's torus (Extrapolation(2))
    gen = torch.Generator(device=dev).manual_seed(3)
    err = k2_compare("k512", "periodic, RK3 stage 1's output", v2.unpack_padded(P1, shape),
                     bcs, gen)
    del P, P1
    torus = torus_field(N_MAIN, dev)
    err = max(err, k2_compare("k512", "extrap2, config A's torus", torus.values, torus.bcs, gen))
    res["k1_err"] = max(res["k1_err"], worst)
    res["k2_err"] = max(res["k2_err"], err)


def phase_slice(dev, res):
    out = {}
    tf = None
    for where in ("cpu", dev):
        grid, phi, vel = zalesak(64, where)
        eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(vel), ic=phi, integrator=lsm.RK3())
        if tf is None:  # 5 adaptive steps, the last one cut to land on tf
            tf = 4.5 * 0.5 * float(lsm.compute_cfl(eq.terms, phi, 0.0))
        eq.integrate(tf)
        out[str(where)] = (eq.state.values.cpu(), eq.last_nsteps, eq.last_fast_path)
    (a, na, pa), (b, nb, pb) = out["cpu"], out[str(dev)]
    err = float((a - b).abs().max())
    log("slice", f"64^3 RK3 f32: steps cpu={na} card={nb} paths={pa}/{pb} "
                 f"max|card-cpu|={err:.3e}")
    if not (na == nb == 5 and pa == pb == "fused" and err <= 1e-4):
        raise AssertionError(f"slice cross-check failed: steps {na}/{nb}, err {err}")


def phase_main(dev, res):
    """The flagship as the JAX bench runs it: the 512^3 Zalesak RK3
    ``integrate`` with the rotation a callable, traced and evaluated in-kernel
    (K1'' and its tables), then the same with the velocity streamed (K1),
    each counted; both ms per step (host clock, CFL read-back included).
    Then two steps with the rotation a callable that does not trace
    (:func:`rotation_polar`): the stream route, evaluated into streams at
    every stage and run by K1."""
    grid, phi, vel = zalesak(N_MAIN, dev)
    vol0 = float(lsm.volume(phi))
    for label, velocity in (("in-kernel (program)", rotation), ("streamed", vel)):
        torch.cuda.reset_peak_memory_stats()
        eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(velocity), ic=phi,
                                  integrator=lsm.RK3())
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        eq.integrate(1.0, max_steps=10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tables = read_counts(), v2.program_tables.launches
        steps = eq.last_nsteps
        vol1 = float(eq.volume())
        finite = bool(torch.isfinite(eq.state.values).all())
        rel = abs(vol1 - vol0) / vol0
        program = velocity is rotation
        routes = FusedStepper(eq.terms, phi, lsm.RK3()).routes
        log("main", f"{N_MAIN}^3 RK3 velocity {label}: steps={steps} t={eq.t:.6f} "
                    f"path={eq.last_fast_path} routes={routes} "
                    f"launches={launches} table fills={tables} finite={finite} volume "
                    f"{vol0:.6e} -> {vol1:.6e} (rel {rel:.2e}) wall={wall:.3f}s = "
                    f"{1e3 * wall / steps:.4f} ms/step "
                    f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        want = dict(NONE_LAUNCHED, K1=3 * steps, K2=3 * steps,
                    **{"K1''": 3 * steps if program else 0})
        if not (steps == 10 and eq.last_fast_path == "fused" and finite and rel <= VOL_TOL
                and tuple(eq.state.values.shape) == grid.shape and launches == want
                and tables == (3 * steps if program else 0)
                and routes == ((("program", None) if program else ("stream", None)),)):
            raise AssertionError(f"main path check failed ({label})")
        if program:
            res["launches"].update({"K1''": launches["K1''"], "tables": tables})
            res["main_program_ms"] = 1e3 * wall / steps
        else:
            res["launches"].update({"K1": launches["K1"], "K2": launches["K2"]})
        del eq
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(rotation_polar), ic=phi,
                              integrator=lsm.RK3())
    routes = FusedStepper(eq.terms, phi, lsm.RK3()).routes
    torch.cuda.synchronize()
    reset_counts()
    eq.integrate(1.0, max_steps=2)
    torch.cuda.synchronize()
    launches, steps = read_counts(), eq.last_nsteps
    finite = bool(torch.isfinite(eq.state.values).all())
    rel = abs(float(eq.volume()) - vol0) / vol0
    log("main", f"{N_MAIN}^3 RK3 velocity a callable that does not trace: steps={steps} "
                f"path={eq.last_fast_path} routes={routes} launches={launches} "
                f"finite={finite} volume rel change {rel:.2e}")
    if not (steps == 2 and eq.last_fast_path == "fused" and finite and rel <= VOL_TOL
            and routes[0][0] == "stream" and "torch.hypot" in routes[0][1]
            and launches == dict(NONE_LAUNCHED, K1=3 * steps, K2=3 * steps)):
        raise AssertionError("stream-route main path check failed")
    del eq


def fe_grad_loss(v, streams, bcs, sp, shape, dt, lo=None):
    """Cell (a)'s loss ``sum(unpack(step(pack(phi)))^2)`` of one fused FE
    step through ``fused_step_stage``; ``streams`` three velocity tensors or
    a term list (a program term at the grid's ``lo``, time 0)."""
    P = v2.pack_padded(v, bcs)
    out = v2.fused_step_stage(P, streams, (0.0, 1.0, dt), None, bcs, sp, shape,
                              where=v2.Where(lo))
    return (v2.unpack_padded(out, shape) ** 2).sum()


def rollout_grad(phi, v, dt, nsteps, **kw):
    """Cell (b): loss ``sum(phi_final^2)`` of an RK3 ``rollout`` with the
    rotation as a callable and its gradient w.r.t. the initial values."""
    out, _ = lsm.rollout(lsm.RK3(), (lsm.AdvectionTerm(rotation),), phi.with_values(v), 0.0,
                         dt, nsteps, **kw)
    loss = (out.values ** 2).sum()
    return loss, torch.autograd.grad(loss, v)[0]


def phase_grad(dev, res):
    n = N_MAIN
    grid, phi, vel = zalesak(n, dev)
    shape, sp, bcs = grid.shape, grid.spacing, phi.bcs
    dt = 0.25 * grid.min_spacing
    # cell (a): value_and_grad of one FE step, streamed and callable velocity
    v = phi.values.clone().requires_grad_()
    u = vel.values.clone().requires_grad_()
    torch.cuda.synchronize()
    reset_counts()
    loss = fe_grad_loss(v, tuple(u[d] for d in range(3)), bcs, sp, shape, dt)
    gv, gu = torch.autograd.grad(loss, (v, u))
    torch.cuda.synchronize()
    counts_a = read_counts()  # the streamed K3: one launch, no program
    ok_a = math.isfinite(loss.item()) and bool(torch.isfinite(gv).all()) and bool(
        torch.isfinite(gu).all()) and counts_a == dict(NONE_LAUNCHED, K1=1, K2=1, K3=1, K4=1)
    stream_c = FusedStepper(lsm.AdvectionTerm(rotation), phi,
                            lsm.ForwardEuler()).stage_terms(0.0)  # the program (K1'', K3'')
    loss_c = fe_grad_loss(v, stream_c, bcs, sp, shape, dt, grid.lo)
    (gv_c,) = torch.autograd.grad(loss_c, v)
    ok_a = ok_a and math.isfinite(loss_c.item()) and bool(torch.isfinite(gv_c).all())
    log("grad", f"cell (a) {n}^3 f32 FE value_and_grad: streamed loss={loss.item():.6e} "
                f"max|dphi|={float(gv.abs().max()):.3e} max|du|={float(gu.abs().max()):.3e}; "
                f"callable loss={loss_c.item():.6e} max|dphi|={float(gv_c.abs().max()):.3e} "
                f"finite={ok_a}")
    del v, u, gv, gu, gv_c, stream_c
    # the same cell in f64 at 64^3: <grad L, w> against a central difference.
    # A little noise breaks the exact WENO ties of the piecewise-linear
    # Zalesak field, where the directional derivative is not the gradient's
    # (the adjoint takes the 0.5/0.5 subgradient there); the difference's
    # O(eps^2) error is large for WENO's sharp weights, hence the tolerance.
    g64, phi64, vel64 = zalesak(N_SMALL, dev, torch.float64)
    streams = tuple(vel64.values[d] for d in range(3))
    gen = torch.Generator(device=dev).manual_seed(7)
    base = phi64.values + 1e-3 * torch.randn(g64.shape, generator=gen, device=dev,
                                             dtype=torch.float64)
    w = torch.randn(g64.shape, generator=gen, device=dev, dtype=torch.float64)
    v = base.clone().requires_grad_()
    dt64 = 0.25 * g64.min_spacing
    (g,) = torch.autograd.grad(fe_grad_loss(v, streams, phi64.bcs, g64.spacing, g64.shape,
                                            dt64), v)
    eps = 1e-7
    with torch.no_grad():
        lp = float(fe_grad_loss(base + eps * w, streams, phi64.bcs, g64.spacing, g64.shape, dt64))
        lm = float(fe_grad_loss(base - eps * w, streams, phi64.bcs, g64.spacing, g64.shape, dt64))
    fd, ad = (lp - lm) / (2 * eps), float((g * w).sum())
    fd_rel = abs(fd - ad) / abs(ad)
    log("grad", f"cell (a) {N_SMALL}^3 f64: <grad L, w>={ad:.12e} central difference "
                f"(eps {eps:g}) {fd:.12e} rel {fd_rel:.2e} (tol 1e-4)")
    # cell (b): a 20-step RK3 rollout under remat, counting launches
    v = phi.values.clone().requires_grad_()
    torch.cuda.synchronize()
    reset_counts()
    loss_b, g_b = rollout_grad(phi, v, dt, ROLLOUT_STEPS, remat=True)
    torch.cuda.synchronize()
    counts = read_counts()
    want = dict(NONE_LAUNCHED, K1=2 * 3 * ROLLOUT_STEPS, K2=2 * 3 * ROLLOUT_STEPS,
                K3=3 * ROLLOUT_STEPS, K4=3 * ROLLOUT_STEPS, K5=2 * ROLLOUT_STEPS,
                **{"K1''": 2 * 3 * ROLLOUT_STEPS, "K3''": 3 * ROLLOUT_STEPS})
    ok_b = math.isfinite(loss_b.item()) and bool(torch.isfinite(g_b).all())
    log("grad", f"cell (b) {n}^3 f32 RK3 rollout x{ROLLOUT_STEPS} remat: loss={loss_b.item():.6e} "
                f"max|dphi0|={float(g_b.abs().max()):.3e} finite={ok_b} launches={counts} "
                f"(expected {want})")
    del v, g_b
    # 64^3: remat and remat_chunk are gradient-neutral; the card agrees with the CPU
    g_s, phi_s, _ = zalesak(N_SMALL, dev)
    dt_s = 0.25 * g_s.min_spacing
    grads = {}
    for label, kw in (("none", {"remat": False}), ("remat", {"remat": True}),
                      ("chunk4", {"remat": True, "remat_chunk": 4})):
        grads[label] = rollout_grad(phi_s, phi_s.values.clone().requires_grad_(), dt_s,
                                    ROLLOUT_STEPS, **kw)[1]
    scale = float(grads["none"].abs().max())
    remat_err = max(float((grads[k] - grads["none"]).abs().max()) for k in ("remat", "chunk4"))
    # card vs CPU, 3 steps. f64: max norm, where the comparison sees the
    # kernels. f32: the max norm is reported, not gated, since the f32
    # gradient of this loss moves by several % of its max under a 1-ulp
    # change of phi0 (the Periodic wrap's jumps); the relative L2 norm is
    # gated at F32_L2_FACTOR times the CPU's own L2 spread under that change
    diffs, cpu = {}, {}
    for dtype in (torch.float32, torch.float64):
        _, phi_card, _ = zalesak(N_SMALL, dev, dtype)
        _, cpu[dtype], _ = zalesak(N_SMALL, "cpu", dtype)
        g_card = rollout_grad(phi_card, phi_card.values.clone().requires_grad_(), dt_s, 3)[1]
        g_cpu = rollout_grad(cpu[dtype], cpu[dtype].values.clone().requires_grad_(), dt_s, 3)[1]
        diffs[dtype] = (float((g_card.cpu() - g_cpu).abs().max()), float(g_cpu.abs().max()),
                        rel_l2(g_card.cpu(), g_cpu))
        cpu[dtype] = (cpu[dtype], g_cpu)
    phi32, g32 = cpu[torch.float32]
    gen = torch.Generator().manual_seed(12)
    pert = phi32.values * (1 + 2.0 ** -23 * torch.randn(g_s.shape, generator=gen))
    g_pert = rollout_grad(phi32, pert.requires_grad_(), dt_s, 3)[1]
    ulp_max, ulp_l2 = float((g_pert - g32).abs().max()), rel_l2(g_pert, g32)
    (e32, s32, l2_32), (e64, s64, _) = diffs[torch.float32], diffs[torch.float64]
    log("grad", f"{N_SMALL}^3 f32 rollout x{ROLLOUT_STEPS}: max|remat - none|={remat_err:.3e} "
                f"scale={scale:.3e} (tol 1e-6*scale)")
    log("grad", f"{N_SMALL}^3 rollout x3 card vs CPU: f64 max|diff|={e64:.3e} scale={s64:.3e} "
                f"(tol 1e-10*scale); f32 max|diff|={e32:.3e} scale={s32:.3e} (reported), "
                f"f32 relative L2 {l2_32:.3e} (tol {F32_L2_FACTOR:g}x the 1-ulp spread); "
                f"the CPU's f32 gradient under a 1-ulp change of phi0: max {ulp_max:.3e}, "
                f"relative L2 {ulp_l2:.3e}")
    if not (ok_a and fd_rel <= 1e-4 and ok_b and counts == want
            and remat_err <= 1e-6 * scale and e64 <= 1e-10 * s64
            and l2_32 <= F32_L2_FACTOR * ulp_l2):
        raise AssertionError("gradient slice check failed")
    res["launches"].update({"K3": counts_a["K3"], "K4": counts["K4"], "K5": counts["K5"],
                            "K3''": counts["K3''"]})


class PlainStepper(FusedStepper):
    """The fused stepper with each stage on the kernels' plain versions, to
    time the plain step on the card (``integrate`` never routes a CUDA
    tensor there)."""

    def stage(self, P, coeffs, t_stage, aux, coeff_values=None, t_value=None, entries=None):
        out = v2.stage_plain(P, self.stage_terms(t_stage, entries), coeffs, aux, self.spacing,
                             self.shape, v2.Where(self.lo, None, t_stage))
        return v2.refresh_ghosts_plain(out, self.bcs, self.shape)


def integrate_ms_per_step(term, phi, integrator, steps=10, path="fused", **kw) -> float:
    """End-to-end ms per accepted step of ``integrate``: the median over 20
    calls of ``steps`` steps each (CFL bound, its read-back, pack and unpack
    included), on the fast path ``path`` (``None``: the general path);
    ``kw`` go to ``integrate`` (hooks, ``fast``)."""
    eq = lsm.LevelSetEquation(terms=term, ic=phi, integrator=integrator)

    def run():
        eq.integrate(eq.t + 1.0, max_steps=steps, **kw)
        if eq.last_nsteps != steps or eq.last_fast_path != path:
            raise AssertionError(f"integrate took {eq.last_nsteps} steps on "
                                 f"{eq.last_fast_path}, not {steps} on {path}")

    eq.integrate(eq.t + 1.0, max_steps=2, **kw)  # warm-up
    return cuda_time(run, warmup=0) / steps


# -- the narrow band (K6, K7, K8) ------------------------------------------------------


def spin(xs, t):
    """The band bench's rigid rotation about the z axis: (-y, x, 0)."""
    x, y, z = xs
    zero = 0.0 * (x + y + z)
    return (-y + zero, x + zero, zero)


def spin_polar(xs, t):
    """:func:`spin` in polar form (as :func:`rotation_polar`): the stream
    route, evaluated per stage at the dispatched slots' coordinates."""
    x, y, z = xs
    r, th = torch.hypot(x, y), torch.atan2(y, x)
    return (-r * torch.sin(th), r * torch.cos(th), 0.0 * (x + y + z))


def sphere_band(n, dev, dtype=torch.float32, center=(0.0, 0.0, 0.0), radius=0.5):
    """The band bench's field: a sphere of radius 0.5 on [-1, 1]^3 with n^3
    nodes, ``Extrapolation(2)``, a band of 3 layers."""
    grid = lsm.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (n, n, n))
    phi = lsm.sample(shapes.sphere(center, radius), grid, lsm.Extrapolation(2),
                     dtype=dtype, device=dev)
    return lsm.NarrowBandField.from_field(phi)


def combined(nb):
    """The band stepper's uint8 combined mask (0 / 1 compute / 2 active)."""
    return (nb.compute_mask.to(torch.uint8) + nb.mask.to(torch.uint8)).contiguous()


def inside(shape, cells, dev):
    """A padded-shape bool that is ``cells`` on the interior, False on the
    shells."""
    out = torch.zeros(v2.padded_shape(shape), dtype=torch.bool, device=dev)
    v2.unpack_padded(out, shape).copy_(cells)
    return out


class PlainBandStepper(FusedBandStepper):
    """The band stepper on the plain versions of K6, K7 and K8, to compare
    with and to time on the card (``integrate`` never routes a CUDA tensor
    there)."""

    def stage(self, src, dst, state, coeffs, t_stage, aux, coeff_values=None, t_value=None):
        bd.band_stage_plain(src, dst, state.ids, state.band, self.stage_terms(state, t_stage),
                            coeffs, aux, self.spacing, self.shape, self.tiles,
                            v2.Where(self.lo, None, t_stage))
        return bd.refresh_band_ghosts_plain(dst, self.bcs, self.shape, state.flags)

    def retube_tiles(self, cur, band, cids, count):
        return bd.band_retube_plain(cur, band, cids, self.nlayers,
                                    lsm.NarrowBandField.COMPUTE_HALO, self.shape, self.tiles,
                                    count)


K8_WIDE_TILES = (8, 8, 64)  # K8's rows of three words (64 + 2 (nlayers + 4) nodes)
# the tile shapes tools/band_tile_sweep.py times; phase_band_tiles holds the
# band kernels against their plain versions at each
SWEEP_TILES = ((8, 8, 32), (8, 8, 64), (8, 8, 128), (8, 16, 32), (16, 16, 16), (16, 16, 32))
SWEEP_TILES_2D = ((16, 16), (32, 32), (16, 64), (8, 128))


def k8_reach(nlayers):
    """How far K8's region reaches past its tile: a stamp within nlayers +
    chalo, a cut cell one node further."""
    return nlayers + lsm.NarrowBandField.COMPUTE_HALO + 1


def k8_compare(phase, label, P, band, act, nlayers, shape, tiles, repeat=False):
    """K8 against its plain version on the candidates of the tile activity
    ``act`` (the stepper's list and count: the active tiles and their
    neighbours), bit for bit: the new mask and the flags; with ``repeat``
    also a second launch on the same inputs. Returns the nodes it changed."""
    halo = lsm.NarrowBandField.COMPUTE_HALO
    cids, count = bd.compact_ids(box_dilate(act, 1), act.numel())

    def run(fn):
        b = band.clone()
        return b, fn(P, b, cids, nlayers, halo, shape, tiles, count)

    got, ref = run(bd.band_retube_incremental), run(bd.band_retube_plain)
    torch.cuda.synchronize()
    same, changed = same_bits(got, ref), int((got[0] != band).sum())
    log(phase, f"K8 {label} tiles={tiles} candidates={int(count)} of {act.numel()} tiles, "
               f"nodes changed={changed}: kernel == plain (mask, flags) {same}")
    if not same:
        raise AssertionError(f"K8 differs from its plain version ({label})")
    if repeat:
        repeat_check(phase, f"K8 {label}", lambda: run(bd.band_retube_incremental), got)
    return changed


def k8_after_step(phase, label, stepper, state, t, dt):
    """One more step of ``stepper`` without its re-tube, then
    :func:`k8_compare` on the re-tube that step would have run (twice)."""
    moved = stepper.step(state, t, dt, retube=False)
    return k8_compare(phase, label, moved.bufs[0], moved.band, moved.act, stepper.nlayers,
                      stepper.shape, stepper.tiles, repeat=True)


def phase_k6k7k8(dev, res):
    """K6, K7 and K8 against their plain versions at BAND_SMALL, f32 and
    f64, on a band that crosses tile boundaries, the ragged last tile of
    axis 2 and the faces x = 0 and z = 1, with the default tiles and with
    K8_WIDE_TILES (K8's rows of several words); K6 and K8 also at BAND_ODD
    (rows of odd length: the element copies). K6: within K1's bound on the
    compute band, bit for bit elsewhere (the source's value on the rest of a
    dispatched tile, the target's previous value on every other tile and
    every shell), streamed and callable, FE and with aux. K7: bit for bit at
    K7_SHAPES under their BC cases with all four flags (:func:`k7_compare`).
    K8: the mask, the flags, the rebuilt activity, dispatch list and count,
    exactly; the mask also against the full re-tube."""
    gen = torch.Generator(device=dev).manual_seed(13)
    halo = lsm.NarrowBandField.COMPUTE_HALO
    worst6 = 0.0
    for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
        for shape_n in (BAND_SMALL, BAND_ODD):
            grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape_n)
            phi = lsm.sample(shapes.sphere((0.1, 0.5, 0.9), 0.35), grid, lsm.Extrapolation(2),
                             dtype=dtype, device=dev)
            nb = lsm.NarrowBandField.from_field(phi)
            shape, sp = grid.shape, grid.spacing
            band = combined(nb)
            P = v2.pack_padded(nb.values, nb.bcs)
            A = v2.pack_padded(nb.values + 0.01 * torch.randn(shape, generator=gen, device=dev,
                                                              dtype=dtype), nb.bcs)
            target = P + torch.randn(P.shape, generator=gen, device=dev, dtype=dtype)
            cm = band != 0
            stream = torch.randn((3, *shape), generator=gen, device=dev, dtype=dtype)
            stream[1, :, ::3] = 0.0  # ties
            for tiles in (default_tiles(nb.nlayers), K8_WIDE_TILES):
                act = bd.tile_activity(band, tiles)
                cap = int(act.sum()) + 5  # a few empty (-1) slots
                ids, _ = bd.compact_ids(act, cap)
                disp = bd.dispatched_cells(ids, shape, tiles)
                flat, _ = bd.tile_index(ids, shape, tiles)
                streamed = tuple(stream[d].reshape(-1)[flat].contiguous() for d in range(3))
                xs = bd.tile_coords(ids, shape, tiles, sp, grid.lo, dtype)
                called = v2.eval_components(spin(xs, 0.0), (cap, *tiles), dtype, dev)
                off_list = ~inside(shape, disp, dev)
                for vname, u in (("streamed", streamed), ("callable", called)):
                    for aux, coeffs in ((None, (0.0, 1.0, 1e-3)), (A, (0.75, 0.25, 2.5e-4))):
                        args = (ids, band, u, coeffs, aux, sp, shape, tiles)
                        got = bd.band_stage(P, target.clone(), *args)
                        ref = bd.band_stage_plain(P, target.clone(), *args)
                        torch.cuda.synchronize()
                        g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
                        on = disp & cm
                        err = float((g - r)[on].abs().max())
                        scale = max(float(r[on].abs().max()), 1.0)
                        kept = disp & ~cm
                        src_kept = torch.equal(g[kept], v2.unpack_padded(P, shape)[kept])
                        untouched = torch.equal(got[off_list], target[off_list])
                        ok = (bool(torch.isfinite(g).all()) and err <= tol * scale and src_kept
                              and untouched)
                        log("k6k7k8", f"K6 {str(dtype)[6:]} {vname:8s} aux={aux is not None!s:5s} "
                                      f"grid={shape} tiles={tiles} slots={cap} "
                                      f"max|kernel-plain|={err:.3e} "
                                      f"scale={scale:.3e} tol={tol:g}*scale source kept off the "
                                      f"band: {src_kept}, other tiles and shells untouched: "
                                      f"{untouched}")
                        if not ok:
                            raise AssertionError(f"K6 parity failed ({dtype}, {vname}, "
                                                 f"aux={aux is not None}, tiles {tiles})")
                        if dtype == torch.float32:
                            worst6 = max(worst6, err)
            if shape_n == BAND_SMALL:
                for k7_shape in K7_SHAPES:
                    k7_compare("k6k7k8", k7_shape, shell_cases(k7_shape), dtype, dev, gen)
            # K8 after the interface moved by about a cell
            moved = lsm.sample(shapes.sphere((0.1 + 1.5 * sp[0], 0.5, 0.9), 0.35), grid,
                               lsm.Extrapolation(2), dtype=dtype, device=dev)
            Pm = v2.pack_padded(moved.values, nb.bcs)
            for tiles in (default_tiles(nb.nlayers), K8_WIDE_TILES):
                act = bd.tile_activity(band, tiles)
                total = act.numel()
                cids, ccount = bd.compact_ids(box_dilate(act, 1), total)
                out = {}
                for label, fn in (("kernel", bd.band_retube_incremental),
                                  ("plain", bd.band_retube_plain)):
                    b = band.clone()
                    flags = fn(Pm, b, cids, nb.nlayers, halo, shape, tiles, ccount)
                    new_act = bd.scatter_activity(act, cids, flags)
                    ids2, count2 = bd.compact_ids(new_act | act, int(act.sum()) + 64)
                    out[label] = (b, flags, new_act, ids2, count2)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(out["kernel"], out["plain"]))
                full = bd.retube_full(moved.values, band, nb.nlayers, halo)
                exact_full = torch.equal(out["kernel"][0], full)
                changed = int((out["kernel"][0] != band).sum())
                log("k6k7k8", f"K8 {str(dtype)[6:]} grid={shape} tiles={tiles} "
                              f"candidates={int(ccount)} of "
                              f"{total} tiles, nodes changed={changed}: kernel == plain (mask, "
                              f"flags, activity, ids, count) {same}; == full re-tube {exact_full}")
                if not (same and exact_full and changed > 0):
                    raise AssertionError(f"K8 parity failed ({dtype}, tiles {tiles})")
    res["k6_err"], res["k7_err"], res["k8_err"] = worst6, 0.0, 0.0


def run_band_stepper(cls, nb, integrator, dt, steps, velocity=spin, terms=None):
    """``steps`` steps of ``cls`` (re-tubing every step) from ``nb`` under
    ``velocity`` (or the term list ``terms``); the stepper and its last
    state."""
    stepper = cls(terms or (lsm.AdvectionTerm(velocity),), nb, integrator)
    state, t = stepper.pack(nb), 0.0
    for _ in range(steps):
        state = stepper.step(state, t, dt)
        t += dt
    if stepper.overflowed(state):
        raise AssertionError("the band dispatch list overflowed")
    return stepper, state


def band_diff(a, b):
    """``(max|a - b| where both compute bands agree, scale, active-mask
    mismatches, compute-mask mismatches)`` of two band fields."""
    dev = a.values.device
    agree = a.compute_mask == b.compute_mask.to(dev)
    d = (a.values.double() - b.values.to(dev).double())[agree]
    return (float(d.abs().max()), max(float(b.values.abs().max()), 1.0),
            int((a.mask != b.mask.to(dev)).sum()), int((~agree).sum()))


def phase_band_512(dev, res):
    """The band bench's configuration at 512^3 (f32, FE, dt = 0.25 h,
    re-tube every step) through the kernels and through their plain
    versions: values within K1's bound and equal masks after BAND_CHECK_STEPS
    steps. Twice: the bench's sphere, centred on the rotation's axis (its
    band does not move), and one off the axis that touches the face x = 1,
    whose band moves (K8 changes nodes) and whose K7 gates are on. Each
    with the rotation in-kernel (:func:`spin`, K6'') and on the stream route
    (:func:`spin_polar`, K6, evaluated into tile-packed streams per stage);
    K6's error and launches are the latter's."""
    res["launches"]["K6"] = 0
    for (label, center), (route, velocity) in itertools.product(
            (("centred", (0.0, 0.0, 0.0)), ("off-axis", (0.5, 0.0, 0.0))),
            (("program", spin), ("stream", spin_polar))):
        nb = sphere_band(N_MAIN, dev, center=center)
        dt = 0.25 * nb.grid.min_spacing
        torch.cuda.synchronize()
        reset_counts()
        kst, kstate = run_band_stepper(FusedBandStepper, nb, lsm.ForwardEuler(), dt,
                                       BAND_CHECK_STEPS, velocity)
        torch.cuda.synchronize()
        counts = read_counts()
        pst, pstate = run_band_stepper(PlainBandStepper, nb, lsm.ForwardEuler(), dt,
                                       BAND_CHECK_STEPS, velocity)
        got, ref = kst.unpack(kstate), pst.unpack(pstate)
        err, scale, dmask, dcmask = band_diff(got, ref)
        finite = bool(torch.isfinite(got.values).all())
        moved = int((got.mask != nb.mask).sum())
        flags = kstate.flags.tolist()
        log("band_512", f"{N_MAIN}^3 f32 sphere band {label} {center} {route} route "
                        f"{kst.entries[0][0].route} FE x{BAND_CHECK_STEPS} "
                        f"(dt = 0.25 h): compute-band cells {int(got.compute_mask.sum())}, "
                        f"dispatched tiles {int(kstate.count)} of {kst.total} (tiles {kst.tiles}), "
                        f"max|kernels-plain|={err:.3e} scale={scale:.3e} tol={K1_TOL:g}*scale, "
                        f"mask mismatches {dmask} (compute {dcmask}), active-mask nodes changed "
                        f"{moved}, launches {counts}, flags {flags}, finite={finite}")
        want = dict(NONE_LAUNCHED, K6=BAND_CHECK_STEPS, K7=BAND_CHECK_STEPS, K8=BAND_CHECK_STEPS,
                    **{"K6''": BAND_CHECK_STEPS if route == "program" else 0})
        moving = label == "centred" or (moved > 0 and flags == [1, 1])
        if not (finite and err <= K1_TOL * scale and dmask == 0 and dcmask == 0 and counts == want
                and moving and kst.entries[0][0].route == route):
            raise AssertionError(f"band kernels and plain versions disagree at 512^3 ({label}, "
                                 f"{route})")
        if route == "stream":
            res["k6_err"] = max(res["k6_err"], err)
            res["launches"]["K6"] += counts["K6"]
        else:
            res["k6a_err"] = max(res.get("k6a_err", 0.0), err)
        # the stage twice on the same inputs; the re-tube of a step that
        # moved the band, against its plain version and twice
        t = BAND_CHECK_STEPS * dt
        terms, (Pk, outk) = kst.stage_terms(kstate, t), kstate.bufs[:2]
        stage = lambda: bd.band_stage(Pk, outk.clone(), kstate.ids, kstate.band, terms,
                                      (0.75, 0.25, 0.25 * dt), Pk, kst.spacing, kst.shape,
                                      kst.tiles, v2.Where(kst.lo, None, t))
        kernel = "K6" if route == "stream" else "K6''"
        repeat_check("band_512", f"{kernel} {label} {N_MAIN}^3 (with aux)", stage, stage())
        changed = k8_after_step("band_512", f"{N_MAIN}^3 f32 {label} {route} route, step "
                                            f"{BAND_CHECK_STEPS + 1}", kst, kstate, t, dt)
        if label == "off-axis" and changed == 0:
            raise AssertionError("the off-axis band did not move at 512^3")
        del nb, kst, kstate, pst, pstate, got, ref, terms, Pk, outk
    # K8 in f64: the off-axis sphere moved by 1.5 h, its band reaching the face x = 1
    nb = sphere_band(N_MAIN, dev, torch.float64, center=(0.5, 0.0, 0.0))
    h = nb.grid.min_spacing
    moved = lsm.sample(shapes.sphere((0.5 + 1.5 * h, 0.0, 0.0), 0.5), nb.grid,
                       lsm.Extrapolation(2), dtype=torch.float64, device=dev)
    band, tiles = combined(nb), default_tiles(nb.nlayers)
    changed = k8_compare("band_512", f"{N_MAIN}^3 f64 off-axis sphere moved by 1.5 h",
                         v2.pack_padded(moved.values, nb.bcs), band, bd.tile_activity(band, tiles),
                         nb.nlayers, nb.shape, tiles, repeat=True)
    if changed == 0:
        raise AssertionError("the f64 band did not move at 512^3")
    del nb, moved, band
    torch.cuda.empty_cache()


@contextlib.contextmanager
def first_capacity(capacity):
    """The first band stepper built inside the context gets ``capacity``
    dispatch slots (the ones ``regrow`` builds keep theirs); yields the list
    of the capacities built."""
    made, init, first = [], FusedBandStepper.__init__, capacity

    def patched(self, *a, capacity=None, **k):
        init(self, *a, capacity=capacity if made else first, **k)
        made.append(self.capacity)

    FusedBandStepper.__init__ = patched
    try:
        yield made
    finally:
        FusedBandStepper.__init__ = init


def band_integrate(nb, integrator, steps=None, tf=1.0):
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(spin), ic=nb, integrator=integrator)
    eq.integrate(tf, max_steps=steps)
    return eq


def phase_band(dev, res):
    """The band main path: ``LevelSetEquation.integrate`` on a 512^3
    ``NarrowBandField``, FE and RK3, BAND_STEPS steps each, counting
    launches (K6 = K7 = stages x steps, K8 every step, nothing else); the
    volume drift; a forced dispatch-list overflow that must regrow before
    stepping and give the run without overflow; a 64^3 card-vs-CPU run."""
    nb = sphere_band(N_MAIN, dev)
    vol0 = float(lsm.volume(nb))
    cells0 = int(nb.compute_mask.sum())
    runs = {}
    for name, integ in (("FE", lsm.ForwardEuler()), ("RK3", lsm.RK3())):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        eq = band_integrate(nb, integ, BAND_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        stages, steps = len(_STAGES[type(integ)]), eq.last_nsteps
        want = dict(NONE_LAUNCHED, K6=stages * steps, K7=stages * steps, K8=steps,
                    **{"K6''": stages * steps})
        finite = bool(torch.isfinite(eq.state.values).all())
        rel = abs(float(eq.volume()) - vol0) / vol0
        tiles = int(bd.tile_activity(eq.state.compute_mask, default_tiles()).sum())
        log("band", f"{N_MAIN}^3 f32 sphere band {name}: steps={steps} t={eq.t:.6f} "
                    f"path={eq.last_fast_path} launches={counts} compute-band cells "
                    f"{cells0} -> {int(eq.state.compute_mask.sum())}, active tiles {tiles}, "
                    f"volume rel change {rel:.2e} finite={finite} wall={wall:.3f}s")
        if not (steps == BAND_STEPS and eq.last_fast_path == "band" and counts == want
                and finite and rel <= VOL_TOL and isinstance(eq.state, lsm.NarrowBandField)):
            raise AssertionError(f"band main path check failed ({name})")
        runs[name] = eq
        if name == "RK3":
            res["launches"].update({k: counts[k] for k in ("K7", "K8", "K6''")})
    # a dispatch list far too small: regrown before the band is stepped
    with first_capacity(BAND_TINY) as made:
        eq = band_integrate(nb, lsm.ForwardEuler(), BAND_STEPS)
    ref = runs["FE"]
    same = torch.equal(eq.state.values, ref.state.values) and torch.equal(
        eq.state.mask, ref.state.mask)
    log("band", f"overflow: capacities built {made}, steps {eq.last_nsteps} vs "
                f"{ref.last_nsteps}, same state as without overflow: {same}")
    if not (made[0] == BAND_TINY and len(made) > 1 and same
            and eq.last_nsteps == ref.last_nsteps):
        raise AssertionError("the overflowing band run differs from the one without")
    del runs, eq, ref, nb
    # 64^3: the card (kernels) against the CPU (plain versions), on a sphere
    # off the rotation's axis whose band moves, re-tubes and reaches the face
    # x = 1 (so K7's gates fire)
    for dtype in (torch.float32, torch.float64):
        out = {}
        for where in ("cpu", dev):
            nb = sphere_band(N_SMALL, where, dtype, center=(0.5, 0.0, 0.0), radius=0.4)
            eq = band_integrate(nb, lsm.RK3(), tf=0.2)
            out[str(where)] = eq
        moved = int((eq.state.mask != nb.mask).sum())
        a, b = out[str(dev)], out["cpu"]
        err, scale, dmask, dcmask = band_diff(a.state, b.state)
        log("band", f"{N_SMALL}^3 {str(dtype)[6:]} RK3 card vs CPU: steps {a.last_nsteps}/"
                    f"{b.last_nsteps} paths {a.last_fast_path}/{b.last_fast_path} "
                    f"max|card-cpu|={err:.3e} (tol 1e-4) mask mismatches {dmask} "
                    f"(compute {dcmask}); the band moved: {moved} nodes changed")
        masks_ok = dtype == torch.float32 or (dmask == 0 and dcmask == 0)
        if not (a.last_nsteps == b.last_nsteps and a.last_fast_path == b.last_fast_path == "band"
                and err <= 1e-4 and masks_ok and moved > 0):
            raise AssertionError(f"band card-vs-CPU check failed ({dtype})")
        res[f"band_mask_mismatch_{str(dtype)[6:]}"] = dmask
    # rollout on a band: the band stepper on the card, the general path on
    # the CPU
    term = (lsm.AdvectionTerm(spin),)
    outs = {}
    for where in ("cpu", dev):
        nb = sphere_band(N_SMALL, where, torch.float64, center=(0.5, 0.0, 0.0), radius=0.4)
        dt = 0.25 * nb.grid.min_spacing
        outs[str(where)] = lsm.rollout(lsm.RK3(), term, nb, 0.0, dt, 3)[0]
    err, scale, dmask, dcmask = band_diff(outs[str(dev)], outs["cpu"])
    # the gradient: the card's band stepper (K6-K8 forward, autograd of the
    # plain band composite backward) against the CPU's general path, on
    # tie-free data (the sphere plus seeded noise)
    noise = 1e-6 * torch.randn((N_SMALL,) * 3, generator=torch.Generator().manual_seed(3),
                               dtype=torch.float64)
    grads = {}
    for where in ("cpu", dev):
        nb = sphere_band(N_SMALL, where, torch.float64, center=(0.5, 0.0, 0.0), radius=0.4)
        v = (nb.values + noise.to(where)).requires_grad_()
        out = lsm.rollout(lsm.RK3(), term, nb.with_values(v, mask_update=False), 0.0, dt, 3)[0]
        grads[str(where)] = torch.autograd.grad((out.values ** 2).sum(), v)[0]
    gscale = float(grads["cpu"].abs().max())
    gerr = float((grads[str(dev)].cpu() - grads["cpu"]).abs().max())
    log("band", f"{N_SMALL}^3 f64 RK3 rollout x3, card (band stepper) vs CPU (general path): "
                f"max|diff|={err:.3e} scale={scale:.3e} (tol 1e-10*scale) mask mismatches "
                f"{dmask} (compute {dcmask}); gradient max|diff|={gerr:.3e} "
                f"scale={gscale:.3e} (tol 1e-10*scale)")
    if not (err <= 1e-10 * scale and dmask == dcmask == 0 and gerr <= 1e-10 * gscale
            and gscale > 0):
        raise AssertionError("band rollout check failed")


def phase_band_timing(dev, res):
    """K7 on the band main path's field at 512^3 (its grid strides there)
    under the four flags and the BC cases, bit for bit against its plain
    version (:func:`k7_compare`). CUDA-event medians: K6, K7 (flags on and
    off) and K8 alone at 512^3 on the band main path's state, and their plain versions (and K6's and
    K8's time a call issued back to back, the host's issue hidden); the band FE
    and RK3 stepper step (per layer) through the kernels and the plain
    versions; the end-to-end ``integrate`` ms per step on the band at 512^3
    (FE, RK3) and at 768^3 (FE) beside the dense FE ``integrate`` at 768^3;
    peak memory of each."""
    t, mem, n = res["t"], {}, N_MAIN
    nb = sphere_band(n, dev)
    shape, sp, halo = nb.shape, nb.grid.spacing, lsm.NarrowBandField.COMPUTE_HALO
    dt = 0.25 * nb.grid.min_spacing
    fe = FusedBandStepper((lsm.AdvectionTerm(spin),), nb, lsm.ForwardEuler())
    state = fe.pack(nb)
    P, out = state.bufs
    # K6 streamed: the rotation tile-packed (the stepper itself runs K6'')
    spec = fe.stage_terms(state, 0.0)[0][0]
    u = tuple(c.contiguous() for c in fe._slot_values(spec, state, 0.0))
    coeffs = (0.0, 1.0, dt)
    t["K6"] = cuda_time(lambda: bd.band_stage(P, out, state.ids, state.band, u, coeffs, None, sp,
                                              shape, fe.tiles))
    t["K6_plain"] = cuda_time(lambda: bd.band_stage_plain(
        P, out, state.ids, state.band, u, coeffs, None, sp, shape, fe.tiles), warmup=1, reps=5)
    # K7 on the main path's field at its shape, where its grid strides over the
    # work under every gate: bit for bit against its plain version
    k7_compare("band_timing", shape, {"band": nb.bcs, **shell_cases(shape)}, nb.dtype, dev,
               torch.Generator(device=dev).manual_seed(18), vals=nb.values)
    on = torch.ones(2, dtype=torch.int32, device=dev)
    off = torch.zeros(2, dtype=torch.int32, device=dev)
    t["K7"] = cuda_time(lambda: bd.refresh_band_ghosts_fast(P, nb.bcs, shape, on))
    t["K7_off"] = cuda_time(lambda: bd.refresh_band_ghosts_fast(P, nb.bcs, shape, off))
    t["K7_plain"] = cuda_time(lambda: bd.refresh_band_ghosts_plain(P, nb.bcs, shape, on))
    cids, count = bd.compact_ids(box_dilate(state.act, 1), fe.total)
    band = state.band.clone()
    t["K8"] = cuda_time(lambda: bd.band_retube_incremental(P, band, cids, nb.nlayers, halo,
                                                           shape, fe.tiles, count))
    t["K8_plain"] = cuda_time(lambda: bd.band_retube_plain(P, band, cids, nb.nlayers, halo,
                                                           shape, fe.tiles, count),
                              warmup=1, reps=5)
    # back to back: the card's time a call, the host's issue hidden behind it
    t["K6_back_to_back"] = back_to_back_ms(lambda: bd.band_stage(
        P, out, state.ids, state.band, u, coeffs, None, sp, shape, fe.tiles))
    t["K8_back_to_back"] = back_to_back_ms(lambda: bd.band_retube_incremental(
        P, band, cids, nb.nlayers, halo, shape, fe.tiles, count))
    # what each call must move and compute, from this state
    flat, valid = bd.tile_index(state.ids, shape, fe.tiles)
    dispatched = int(valid.sum())
    ops_cells = int(((state.band.view(-1)[flat] != 0) & valid).sum())
    cand = bd.dispatched_cells(cids, shape, fe.tiles)
    reach = box_dilate(cand, k8_reach(nb.nlayers))
    res["band_work"] = {"dispatched": dispatched, "ops_cells": ops_cells,
                        "cand_cells": int(cand.sum()), "cand_reach_cells": int(reach.sum()),
                        "active_reach_cells": int((reach & (band == bd.ACTIVE)).sum()),
                        "ghosts": (n + 6) ** 3 - n ** 3}
    log("band_timing", f"{n}^3 band state: dispatched tiles {int(state.count)} "
                       f"({dispatched} nodes), compute-band nodes {ops_cells}, K8 candidates "
                       f"{int((cids >= 0).sum())} ({res['band_work']['cand_cells']} nodes, "
                       f"{res['band_work']['cand_reach_cells']} within its reach, "
                       f"{res['band_work']['active_reach_cells']} of them active)")
    del reach
    del cand, flat, valid, band
    for name, integ in (("FE", lsm.ForwardEuler()), ("RK3", lsm.RK3())):
        for label, cls in (("", FusedBandStepper), ("_plain", PlainBandStepper)):
            st_ = cls((lsm.AdvectionTerm(spin),), nb, integ)
            s0 = st_.pack(nb)
            key = f"band_{name}_step{label}"
            t[key] = cuda_time(lambda: st_.step(s0, 0.0, dt), **(
                {"warmup": 1, "reps": 5} if label else {}))
            mem[key] = peak_gib(lambda: st_.step(s0, 0.0, dt))
            del st_, s0
        key = f"band_{name}_integrate@{n}"
        t[key] = integrate_ms_per_step(lsm.AdvectionTerm(spin), nb, integ, path="band")
        mem[key] = peak_gib(lambda: band_integrate(nb, integ, 10))
    del nb, state, P, out, u, fe
    torch.cuda.empty_cache()
    # 768^3: the band against the dense path, FE, the same sphere and rotation
    nx = N_BAND_XL
    nb = sphere_band(nx, dev)
    t[f"band_FE_integrate@{nx}"] = integrate_ms_per_step(lsm.AdvectionTerm(spin), nb,
                                                         lsm.ForwardEuler(), path="band")
    mem[f"band_FE_integrate@{nx}"] = peak_gib(lambda: band_integrate(nb, lsm.ForwardEuler(), 10))
    dense = lsm.MeshField(nb.values, nb.grid, nb.bcs)
    del nb
    torch.cuda.empty_cache()
    t[f"dense_FE_integrate@{nx}"] = integrate_ms_per_step(lsm.AdvectionTerm(spin), dense,
                                                          lsm.ForwardEuler())
    mem[f"dense_FE_integrate@{nx}"] = peak_gib(lambda: lsm.LevelSetEquation(
        terms=lsm.AdvectionTerm(spin), ic=dense, integrator=lsm.ForwardEuler()).integrate(
            1.0, max_steps=10))
    del dense
    torch.cuda.empty_cache()
    for name in [k for k in t if k.startswith(("K6", "K7", "K8", "band", "dense"))]:
        log("band_timing", f"f32 {name:26s} median {t[name]:.4f} ms")
    for name, info in res["band_ptxas"].items():
        log("band_timing", f"{name}: {info}")
    log("band_timing", "peak memory: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in mem.items()))
    res["mem"].update(mem)


# -- the term kinds: K1' and K6' (the term-list entries of K1 and K6) -----------------


def a_terms():
    """Config A's terms: curvature plus normal motion, constant coefficients."""
    return (lsm.CurvatureTerm(-0.05), lsm.NormalMotionTerm(0.2))


def torus_field(n, dev, dtype=torch.float32, wavy=False):
    """Config A's field: the torus (major radius 0.5, minor 0.2) on [-1, 1]^3
    with n^3 nodes, ``Extrapolation(2)``. ``wavy``: config B's, the torus
    times (0.5 + |x|^2), whose zero set is the torus but whose |grad| is not 1."""
    grid = lsm.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (n, n, n))
    tor = shapes.torus((0.0, 0.0, 0.0), 0.5, 0.2)
    fn = (lambda x, y, z: tor(x, y, z) * (0.5 + x * x + y * y + z * z)) if wavy else tor
    return lsm.sample(fn, grid, lsm.Extrapolation(2), dtype=dtype, device=dev)


def c_term(phi):
    """Config C's term: normal motion at the streamed speed 0.1 + 0.05 x."""
    speed = lsm.sample(lambda x, y, z: 0.1 + 0.05 * x + 0.0 * (y + z), phi.grid, phi.bcs,
                       dtype=phi.dtype, device=phi.device)
    return lsm.NormalMotionTerm(speed)


def kinds_speed(xs, t):
    """A speed that changes sign across [-1, 1]^3 (both Godunov branches)."""
    return 0.3 * xs[0] - 0.1 * (xs[1] + xs[2]) + 0.05 + 0.2 * t


def gate_nodes(P, sp, shape):
    """Interior nodes whose plain |grad phi|^2 lies within GATE_ULPS ulps of
    the curvature's epsilon gate, where one ulp switches the curvature
    between 0 and its value."""
    nrmsq = 0.0
    for c in geo.gradient_from_padded(P, sp, v2.GHOST, shape):
        nrmsq = nrmsq + c * c
    eps = torch.finfo(P.dtype).eps
    return (nrmsq.double() - eps).abs() <= GATE_ULPS * eps * eps


def kind_cases(phi, gen, pack, xs, shape):
    """The term lists of the kinds checks, as ``(name, terms, with_aux)``:
    every kind with each coefficient kind it takes (a callable evaluated at
    ``xs`` into tensors of ``shape``) and a 3-term sum with aux. Random
    streams have exact zeros (ties). ``pack`` maps an interior-shaped
    stream to the kernel's layout."""
    dev, dtype = phi.device, phi.dtype
    a = torch.randn(phi.shape, generator=gen, device=dev, dtype=dtype)
    a[:, ::4] = 0.0
    vel = 0.5 * torch.randn((3, *phi.shape), generator=gen, device=dev, dtype=dtype)
    s0 = lsm.EikonalReinitializationTerm.from_initial(phi).s0.values
    stream = lambda kind, arrs: (v2.TermSpec(kind, "stream", None, len(arrs)),
                                 tuple(pack(x) for x in arrs))
    const = lambda kind, value: (v2.TermSpec(kind, "const", value, 0), ())
    called = (v2.TermSpec("normal", "stream", None, 1),
              v2.eval_components(kinds_speed(xs, 0.3), shape, dtype, dev, 1))
    return [
        ("normal const", (const("normal", 0.2),), False),
        ("normal stream", (stream("normal", [a]),), False),
        ("normal callable", (called,), False),
        ("curvature const", (const("curvature", -0.05),), False),
        ("curvature stream", (stream("curvature", [-a.abs()]),), False),
        ("eikonal none", ((v2.TermSpec("eikonal", "none", None, 0), ()),), False),
        ("eikonal stream", (stream("eikonal", [s0]),), False),
        ("3-term sum", (stream("advection", list(vel)), const("curvature", -0.01),
                        stream("normal", [a])), True),
    ]


def kinds_err(g, r, keep):
    """``(max|g - r|, max(|r|, 1))`` over ``keep``."""
    d = (g - r)[keep]
    return float(d.abs().max()), max(float(r[keep].abs().max()), 1.0)


def has_curvature(terms):
    return any(spec.kind == "curvature" for spec, _ in terms)


def phase_k1kinds(dev, res):
    """K1' (K1's term-list entry) against its plain version at BAND_SMALL on
    the torus (curvature of both signs), on K2's five BC cases, f32 and
    f64, for every case of :func:`kind_cases`: the bare operator (alpha,
    beta, gamma) = (0, 0, 1), so no dt scales an error down, and a stage
    (with aux for the sum). Then at K1_MARCH_SHAPES (the march's edge
    shapes, the embedding included) on random buffers, f32 and f64, every
    case of :func:`k1_march_cases` with its streams and aux off 16-byte
    alignment, with and without aux. Curvature nodes at the eps gate are
    counted and left out. A program table's route is named."""
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = 0.0
    for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
        grid = lsm.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), BAND_SMALL)
        phi = lsm.sample(shapes.torus((0.0, 0.0, 0.0), 0.5, 0.2), grid, lsm.Extrapolation(2),
                         dtype=dtype, device=dev)
        shape, sp = grid.shape, grid.spacing
        xs = v2.node_coords(shape, sp, grid.lo, dtype, dev)
        for bname, bcs in bc_cases().items():
            P = v2.pack_padded(phi.values, bcs)
            A = v2.pack_padded(phi.values + 0.01 * torch.randn(
                shape, generator=gen, device=dev, dtype=dtype), bcs)
            gate = gate_nodes(P, sp, shape)
            errs = {}
            for name, terms, with_aux in kind_cases(phi, gen, lambda x: x.contiguous(), xs, shape):
                keep = ~gate if has_curvature(terms) else torch.ones_like(gate)
                stage = (A, (0.75, 0.25, 2.5e-4)) if with_aux else (None, (0.0, 1.0, 1e-3))
                for aux, coeffs in ((None, (0.0, 0.0, 1.0)), stage):
                    got = v2.fused_stage(P, terms, coeffs, aux, sp, shape)
                    ref = v2.stage_plain(P, terms, coeffs, aux, sp, shape)
                    torch.cuda.synchronize()
                    g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
                    err, scale = kinds_err(g, r, keep)
                    if not (bool(torch.isfinite(g).all()) and err <= tol * scale):
                        raise AssertionError(f"K1' parity failed ({dtype}, {bname}, {name}, "
                                             f"coeffs {coeffs}): {err} > {tol} * {scale}")
                    errs[name] = max(errs.get(name, 0.0), err / scale)
                    if dtype == torch.float32:
                        worst = max(worst, err)
            log("k1kinds", f"K1' {str(dtype)[6:]} {bname:9s} shape={shape} max|kernel-plain|/scale "
                           f"(tol {tol:g}): " + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                           + f"; nodes at the curvature gate left out: {int(gate.sum())}")
    for shape in K1_MARCH_SHAPES:
        for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
            P, A, sp, _ = k1_inputs(shape, dtype, dev, gen)
            keep_all = torch.ones(shape, dtype=torch.bool, device=dev)
            gate = gate_nodes(P, sp, shape)
            errs, routes = {}, set()  # random buffers: errors relative to their scale
            for name, terms in k1_march_cases(shape, dtype, dev, gen):
                keep = ~gate if has_curvature(terms) else keep_all
                routes.add(v2.stage_route(terms, shape))
                for aux, coeffs in ((None, (0.0, 0.0, 1.0)), (misaligned(A), (0.75, 0.25, 2.5e-4))):
                    got = v2.unpack_padded(v2.fused_stage(P, terms, coeffs, aux, sp, shape), shape)
                    ref = v2.unpack_padded(v2.stage_plain(P, terms, coeffs, aux, sp, shape), shape)
                    err, scale = kinds_err(got, ref, keep)
                    if not (bool(torch.isfinite(got).all()) and err <= tol * scale):
                        raise AssertionError(f"K1' parity failed at {shape} ({dtype}, {name}, "
                                             f"aux {aux is not None}): {err} > {tol} * {scale}")
                    errs[name] = max(errs.get(name, 0.0), err / scale)
                    if dtype == torch.float32:
                        res["k1k_march_rel"] = max(res.get("k1k_march_rel", 0.0), err / scale)
            log("k1kinds", f"K1' {str(dtype)[6:]} march shape={shape} routes {sorted(routes)}, "
                           f"streams and aux off 16-byte alignment, with and without aux: "
                           f"max|kernel-plain|/scale (tol {tol:g}): "
                           + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                           + f"; nodes at the curvature gate left out: {int(gate.sum())}")
    phi = torus_field(24, dev)
    prog_route = FusedStepper((lsm.NormalMotionTerm(kinds_speed),), phi, lsm.RK3()).stage_route
    log("k1kinds", f"a table with a program coefficient (normal motion at kinds_speed, which "
                   f"reads every axis) takes the route {prog_route!r}")
    if prog_route != "K1' per node":
        raise AssertionError(f"a program table's route is {prog_route!r}")
    res["k1k_err"] = worst


def k1_march_cases(shape, dtype, dev, gen):
    """K1''s term lists at a march shape, as ``(name, terms)``: each kind with
    each coefficient kind the march takes (no program) and two sums, one
    with an advection term (reach 3); every stream a contiguous copy that
    starts one element into its storage (off 16-byte alignment). Random
    streams have exact zeros (ties)."""
    a = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    a[:, ::4] = 0.0
    vel = [0.5 * torch.randn(shape, generator=gen, device=dev, dtype=dtype) for _ in range(3)]
    stream = lambda kind, arrs: (v2.TermSpec(kind, "stream", None, len(arrs)),
                                 tuple(misaligned(x) for x in arrs))
    const = lambda kind, value: (v2.TermSpec(kind, "const", value, 0), ())
    return [("normal const", (const("normal", 0.2),)),
            ("normal stream", (stream("normal", [a]),)),
            ("curvature const", (const("curvature", -0.05),)),
            ("curvature stream", (stream("curvature", [-a.abs()]),)),
            ("eikonal none", ((v2.TermSpec("eikonal", "none", None, 0), ()),)),
            ("eikonal stream", (stream("eikonal", [torch.tanh(a)]),)),
            ("A", (const("curvature", -0.05), const("normal", 0.2))),
            ("3-term sum", (stream("advection", vel), const("curvature", -0.01),
                            stream("normal", [a])))]


def phase_k6kinds(dev, res):
    """K6' (K6's term-list entry) against its plain version on the cases of
    :func:`kind_cases` over the BAND_SMALL sphere's dispatch list, with the
    ghosts of K2's five BC cases, f32 and f64: within K1's bound on the
    compute band of the dispatched tiles, bit for bit elsewhere (the
    source's value on the rest of a dispatched tile, the target's previous
    value on every other tile and on the shells)."""
    gen = torch.Generator(device=dev).manual_seed(22)
    worst = 0.0
    for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
        grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), BAND_SMALL)
        phi = lsm.sample(shapes.sphere((0.1, 0.5, 0.9), 0.35), grid, lsm.Extrapolation(2),
                         dtype=dtype, device=dev)
        nb = lsm.NarrowBandField.from_field(phi)
        shape, sp, tiles = grid.shape, grid.spacing, default_tiles(nb.nlayers)
        band = combined(nb)
        act = bd.tile_activity(band, tiles)
        cap = int(act.sum()) + 5
        ids, _ = bd.compact_ids(act, cap)
        flat, _ = bd.tile_index(ids, shape, tiles)
        disp = bd.dispatched_cells(ids, shape, tiles)
        cm = band != 0
        off_list = ~inside(shape, disp, dev)
        xs = bd.tile_coords(ids, shape, tiles, sp, grid.lo, dtype)
        pack = lambda x: x.reshape(-1)[flat].contiguous()
        for bname, bcs in bc_cases().items():
            P = v2.pack_padded(nb.values, bcs)
            A = v2.pack_padded(nb.values + 0.01 * torch.randn(
                shape, generator=gen, device=dev, dtype=dtype), bcs)
            target = P + torch.randn(P.shape, generator=gen, device=dev, dtype=dtype)
            gate = gate_nodes(P, sp, shape)
            errs, exact = {}, True
            for name, terms, with_aux in kind_cases(phi, gen, pack, xs, (cap, *tiles)):
                on = disp & cm & (~gate if has_curvature(terms) else torch.ones_like(gate))
                aux, coeffs = (A, (0.75, 0.25, 2.5e-4)) if with_aux else (None, (0.0, 1.0, 1e-3))
                got = bd.band_stage(P, target.clone(), ids, band, terms, coeffs, aux, sp, shape,
                                    tiles)
                ref = bd.band_stage_plain(P, target.clone(), ids, band, terms, coeffs, aux, sp,
                                          shape, tiles)
                torch.cuda.synchronize()
                g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
                err, scale = kinds_err(g, r, on)
                kept = torch.equal(g[disp & ~cm], v2.unpack_padded(P, shape)[disp & ~cm])
                untouched = torch.equal(got[off_list], target[off_list])
                exact = exact and kept and untouched
                if not (bool(torch.isfinite(g).all()) and err <= tol * scale and kept
                        and untouched):
                    raise AssertionError(f"K6' parity failed ({dtype}, {bname}, {name}): err "
                                         f"{err} scale {scale}, kept {kept}, untouched {untouched}")
                errs[name] = err / scale
                if dtype == torch.float32:
                    worst = max(worst, err)
            log("k6kinds", f"K6' {str(dtype)[6:]} {bname:9s} tiles={tiles} slots={cap} "
                           f"max|kernel-plain|/scale (tol {tol:g}): "
                           + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                           + f"; off the band and off the list bit for bit: {exact}")
    res["k6k_err"] = worst


def _k1k_512(label, stepper, P, coeff_sets, res, repeat=False):
    """K1' against its plain version on the 512^3 stepper's term list; with
    ``repeat``, the first set launched twice (interiors equal bit for bit:
    the kernel leaves the shells unset)."""
    terms = stepper.stage_terms(0.0)
    shape, sp = stepper.shape, stepper.spacing
    keep = ~gate_nodes(P, sp, shape) if has_curvature(terms) else None
    log("kinds_512", f"K1' {label}: route {stepper.stage_route!r}")
    if repeat:
        _, src, aux, coeffs = coeff_sets[0]
        call = lambda: v2.unpack_padded(v2.fused_stage(src, terms, coeffs, aux, sp, shape),
                                        shape).contiguous()
        first = call()
        repeat_check("kinds_512", f"K1' {label} {N_MAIN}^3", call, first)
        del first
    for tag, src, aux, coeffs in coeff_sets:
        g = v2.unpack_padded(v2.fused_stage(src, terms, coeffs, aux, sp, shape), shape)
        r = v2.unpack_padded(v2.stage_plain(src, terms, coeffs, aux, sp, shape), shape)
        err, scale = kinds_err(g, r, keep if keep is not None else torch.ones_like(g, dtype=bool))
        ok = bool(torch.isfinite(g).all()) and err <= K1_TOL * scale
        log("kinds_512", f"K1' {label} {tag:8s} {N_MAIN}^3 f32 max|kernel-plain|={err:.3e} "
                         f"scale={scale:.3e} tol={K1_TOL:g}*scale, gate nodes left out "
                         f"{0 if keep is None else int((~keep).sum())}")
        if not ok:
            raise AssertionError(f"K1' parity at {N_MAIN}^3 failed ({label}, {tag})")
        res["k1k_err"] = max(res["k1k_err"], err)
        del g, r


def phase_kinds_512(dev, res):
    """K1' against its plain version at 512^3 on the inputs of config A
    (stage 1, RK3 stage 2 with aux, the bare operator), of the kinds
    gradient's table and of config B (both eikonal forms), each with its
    route; on A's and the kinds gradient's, a second launch gives equal
    bits. K6' on config C's sphere band (streamed speed) and on curvature
    plus normal motion on the off-axis sphere that reaches a face."""
    phi = torus_field(N_MAIN, dev)
    st_a = FusedStepper(a_terms(), phi, lsm.RK3())
    P = st_a.pack(phi.values)
    dt = 0.5 * float(st_a.cfl(P, 0.0))
    P1 = v2.refresh_ghosts_plain(v2.stage_plain(P, st_a.stage_terms(0.0), (0.0, 1.0, dt), None,
                                                st_a.spacing, st_a.shape), st_a.bcs, st_a.shape)
    _k1k_512("A", st_a, P, (("stage 2", P1, P, (0.75, 0.25, 0.25 * dt)),
                            ("stage 1", P, None, (0.0, 1.0, dt)),
                            ("-H", P, None, (0.0, 0.0, 1.0))), res, repeat=True)
    del P1, st_a
    # the kinds gradient's table: curvature plus normal motion at a streamed speed
    st_g = FusedStepper(grad_kinds_terms(phi, c_term(phi).speed.values), phi, lsm.RK3())
    dt = 0.5 * float(st_g.cfl(P, 0.0))
    _k1k_512("kinds gradient", st_g, P, (("stage 1", P, None, (0.0, 1.0, dt)),
                                         ("-H", P, None, (0.0, 0.0, 1.0))), res, repeat=True)
    del P, st_g, phi
    phi = torus_field(N_MAIN, dev, wavy=True)
    for label, term in (("B frozen", lsm.EikonalReinitializationTerm.from_initial(phi)),
                        ("B none", lsm.EikonalReinitializationTerm())):
        st_b = FusedStepper((term,), phi, lsm.RK3())
        P = st_b.pack(phi.values)
        dt = 0.5 * float(st_b.cfl(P, 0.0))
        _k1k_512(label, st_b, P, (("stage 1", P, None, (0.0, 1.0, dt)),
                                  ("-H", P, None, (0.0, 0.0, 1.0))), res)
        del P, st_b
    del phi
    torch.cuda.empty_cache()
    for label, center, terms_of in (("C", (0.0, 0.0, 0.0), lambda nb: (c_term(nb),)),
                                    ("A off-axis", (0.5, 0.0, 0.0), lambda nb: a_terms())):
        nb = sphere_band(N_MAIN, dev, center=center)
        stepper = FusedBandStepper(terms_of(nb), nb, lsm.ForwardEuler())
        state = stepper.pack(nb)
        P, out = state.bufs
        terms = stepper.stage_terms(state, 0.0)
        dt = 0.5 * float(stepper.cfl(state, 0.0)[0])
        shape, sp = stepper.shape, stepper.spacing
        got = bd.band_stage(P, out.clone(), state.ids, state.band, terms, (0.0, 1.0, dt), None,
                            sp, shape, stepper.tiles)
        ref = bd.band_stage_plain(P, out.clone(), state.ids, state.band, terms, (0.0, 1.0, dt),
                                  None, sp, shape, stepper.tiles)
        disp = bd.dispatched_cells(state.ids, shape, stepper.tiles)
        stage_nodes = disp & (state.band != 0)
        on = stage_nodes & ~gate_nodes(P, sp, shape) if has_curvature(terms) else stage_nodes
        g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
        err, scale = kinds_err(g, r, on)
        rest = ~inside(shape, stage_nodes, dev)
        same = torch.equal(got[rest], ref[rest])
        log("kinds_512", f"K6' {label} {N_MAIN}^3 f32 sphere band {center}: dispatched tiles "
                         f"{int(state.count)}, gates {state.flags.tolist()}, max|kernel-plain|="
                         f"{err:.3e} scale={scale:.3e} tol={K1_TOL:g}*scale, the rest bit for "
                         f"bit: {same}")
        if not (bool(torch.isfinite(g).all()) and err <= K1_TOL * scale and same):
            raise AssertionError(f"K6' parity at {N_MAIN}^3 failed ({label})")
        repeat_check("kinds_512", f"K6' {label} {N_MAIN}^3", lambda: bd.band_stage(
            P, out.clone(), state.ids, state.band, terms, (0.0, 1.0, dt), None, sp, shape,
            stepper.tiles), got)
        res["k6k_err"] = max(res["k6k_err"], err)
        del nb, stepper, state, P, out, got, ref, g, r
        torch.cuda.empty_cache()


def eikonal_error(phi):
    """``(mean, max)`` of ``| |grad phi| - 1 |`` (central differences) over
    the nodes with ``|phi| < 3h``."""
    g = geo.grad_norm_from_padded(phi.pad(1), phi.spacing, 1, phi.shape)
    near = phi.values.abs() < 3 * phi.grid.min_spacing
    d = (g[near].double() - 1.0).abs()
    return float(d.mean()), float(d.max())


def counted_integrate(phi, terms, integrator, steps):
    """``integrate`` of ``steps`` steps with the launch counts reset before
    it: ``(equation, counts, wall seconds)``."""
    eq = lsm.LevelSetEquation(terms=terms, ic=phi, integrator=integrator)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eq.integrate(1.0, max_steps=steps)
    torch.cuda.synchronize()
    return eq, read_counts(), time.perf_counter() - t0


def phase_kinds(dev, res):
    """Configs A, B and C through ``LevelSetEquation.integrate`` at 512^3,
    KINDS_STEPS steps each, counting launches (dense RK3: K1 = K2 = K1' = 3
    per step; band: K6 = K7 = K6' = stages per step, K8 one per re-tube;
    nothing else); A's volume change, B's | |grad phi| - 1 | near the
    interface before and after; C's band against the plain versions with
    curvature on the off-axis sphere; 64^3 card-vs-CPU trajectories; a
    gradient through a kinds rollout on the card runs K3'."""
    n, steps = N_MAIN, KINDS_STEPS
    phi = torus_field(n, dev)
    vol0 = float(lsm.volume(phi))
    eq, counts, wall = counted_integrate(phi, a_terms(), lsm.RK3(), steps)
    vol1 = float(eq.volume())
    finite = bool(torch.isfinite(eq.state.values).all())
    want = dict(NONE_LAUNCHED, K1=3 * steps, K2=3 * steps, **{"K1'": 3 * steps})
    log("kinds", f"A {n}^3 f32 curvature(-0.05) + normal(0.2) RK3: steps={eq.last_nsteps} "
                 f"t={eq.t:.6e} path={eq.last_fast_path} launches={counts} finite={finite} "
                 f"volume {vol0:.6e} -> {vol1:.6e} (rel {abs(vol1 - vol0) / vol0:.2e}) "
                 f"wall={wall:.3f}s")
    if not (eq.last_nsteps == steps and eq.last_fast_path == "fused" and finite
            and counts == want and tuple(eq.state.values.shape) == phi.shape):
        raise AssertionError("config A check failed")
    res["launches"]["K1'"] = counts["K1'"]
    res["kinds_A_volume"] = (vol0, vol1)
    del eq, phi
    phi = torus_field(n, dev, wavy=True)
    before = eikonal_error(phi)
    for label, term in (("frozen", lsm.EikonalReinitializationTerm.from_initial(phi)),
                        ("none", lsm.EikonalReinitializationTerm())):
        eq, counts, wall = counted_integrate(phi, (term,), lsm.RK3(), steps)
        after = eikonal_error(eq.state)
        log("kinds", f"B {n}^3 f32 eikonal ({label} sign) RK3: steps={eq.last_nsteps} "
                     f"t={eq.t:.6e} path={eq.last_fast_path} launches={counts}; | |grad phi| - 1 | "
                     f"over |phi| < 3h: mean {before[0]:.4e} -> {after[0]:.4e}, max "
                     f"{before[1]:.4e} -> {after[1]:.4e}; wall={wall:.3f}s")
        if not (eq.last_nsteps == steps and eq.last_fast_path == "fused" and counts == want
                and bool(torch.isfinite(eq.state.values).all()) and after[0] < before[0]):
            raise AssertionError(f"config B check failed ({label})")
        res[f"kinds_B_{label}"] = (before, after)
        del eq
    del phi
    torch.cuda.empty_cache()
    nb = sphere_band(n, dev)
    vol0 = float(lsm.volume(nb))
    for name, integ in (("FE", lsm.ForwardEuler()), ("RK3", lsm.RK3())):
        eq, counts, wall = counted_integrate(nb, (c_term(nb),), integ, steps)
        stages = len(_STAGES[type(integ)])
        want_c = dict(NONE_LAUNCHED, K6=stages * steps, K7=stages * steps, K8=steps,
                      **{"K6'": stages * steps})
        rel = abs(float(eq.volume()) - vol0) / vol0
        log("kinds", f"C {n}^3 f32 sphere band, normal motion at 0.1 + 0.05 x (streamed) "
                     f"{name}: steps={eq.last_nsteps} t={eq.t:.6e} path={eq.last_fast_path} "
                     f"launches={counts} volume rel change {rel:.3e} wall={wall:.3f}s")
        if not (eq.last_nsteps == steps and eq.last_fast_path == "band" and counts == want_c
                and bool(torch.isfinite(eq.state.values).all())):
            raise AssertionError(f"config C check failed ({name})")
        if name == "RK3":
            res["launches"]["K6'"] = counts["K6'"]
        del eq
    del nb
    torch.cuda.empty_cache()
    # the parity case: curvature plus normal motion on the off-axis sphere,
    # through the kernels and through their plain versions
    nb = sphere_band(n, dev, center=(0.5, 0.0, 0.0))
    kst = FusedBandStepper(a_terms(), nb, lsm.ForwardEuler())
    dt = 0.5 * float(kst.cfl(kst.pack(nb), 0.0)[0])
    outs = {}
    for cls in (FusedBandStepper, PlainBandStepper):
        st_ = cls(a_terms(), nb, lsm.ForwardEuler())
        state, t = st_.pack(nb), 0.0
        for _ in range(BAND_CHECK_STEPS):
            state = st_.step(state, t, dt)
            t += dt
        outs[cls] = (st_.unpack(state), state.flags.tolist())
    (got, flags), (ref, _) = outs[FusedBandStepper], outs[PlainBandStepper]
    err, scale, dmask, dcmask = band_diff(got, ref)
    log("kinds", f"A's terms on the off-axis {n}^3 sphere band, FE x{BAND_CHECK_STEPS}: "
                 f"max|kernels-plain|={err:.3e} scale={scale:.3e} tol={K1_TOL:g}*scale, mask "
                 f"mismatches {dmask} (compute {dcmask}), gates {flags}")
    if not (err <= K1_TOL * scale and dmask == dcmask == 0 and flags == [1, 1]):
        raise AssertionError("the band kinds disagree with their plain versions at 512^3")
    del nb, kst, outs, got, ref
    torch.cuda.empty_cache()
    kinds_card_vs_cpu(dev)
    # a gradient through a kinds rollout on the card runs K3' (grad_kinds
    # measures it): 2 RK3 steps, one K3' per stage
    phi = torus_field(N_SMALL, dev)
    v = phi.values.clone().requires_grad_()
    reset_counts()
    out, _ = lsm.rollout(lsm.RK3(), a_terms(), phi.with_values(v), 0.0, 1e-4, 2)
    (g,) = torch.autograd.grad((out.values ** 2).sum(), v)
    torch.cuda.synchronize()
    counts = read_counts()
    log("kinds", f"gradient through a rollout of A's terms on the card: launches {counts}, "
                 f"max|dphi0|={float(g.abs().max()):.3e}")
    if not (counts["K3'"] == 6 and counts["K3"] == 0 and bool(torch.isfinite(g).all())):
        raise AssertionError("a gradient through the kinds did not run K3'")


def kinds_card_vs_cpu(dev):
    """64^3 trajectories of A, B (frozen sign) and C, card (kernels) against
    CPU (plain versions): f32 within 1e-4 * scale, f64 within 1e-10 * scale,
    equal step counts and paths; the band's masks equal in f64 (reported in
    f32, where a rounding difference may flip a cut cell)."""
    cases = {
        "A": (lambda where, dt: torus_field(N_SMALL, where, dt), lambda phi: a_terms()),
        "B": (lambda where, dt: torus_field(N_SMALL, where, dt, wavy=True),
              lambda phi: (lsm.EikonalReinitializationTerm.from_initial(phi),)),
        "C": (lambda where, dt: sphere_band(N_SMALL, where, dt, center=(0.5, 0.0, 0.0),
                                            radius=0.4), lambda phi: (c_term(phi),)),
    }
    for name, (make, terms_of) in cases.items():
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            out = {}
            for where in ("cpu", dev):
                phi = make(where, dtype)
                eq = lsm.LevelSetEquation(terms=terms_of(phi), ic=phi, integrator=lsm.RK3())
                eq.integrate(1.0, max_steps=KINDS_SMALL_STEPS)
                out[str(where)] = eq
            a, b = out[str(dev)], out["cpu"]
            scale = max(float(b.state.values.abs().max()), 1.0)
            if name == "C":
                err, _, dmask, dcmask = band_diff(a.state, b.state)
            else:
                err, dmask, dcmask = float((a.state.values.cpu() - b.state.values).abs().max()), 0, 0
            log("kinds", f"{name} {N_SMALL}^3 {str(dtype)[6:]} RK3 x{KINDS_SMALL_STEPS} card vs "
                         f"CPU: paths {a.last_fast_path}/{b.last_fast_path} t {a.t:.6e}/{b.t:.6e} "
                         f"max|card-cpu|={err:.3e} scale={scale:.3e} (tol {tol:g}*scale) mask "
                         f"mismatches {dmask} (compute {dcmask})")
            masks_ok = dtype == torch.float32 or dmask == dcmask == 0
            if not (a.last_nsteps == b.last_nsteps == KINDS_SMALL_STEPS and masks_ok
                    and a.last_fast_path == b.last_fast_path and err <= tol * scale):
                raise AssertionError(f"{name} card-vs-CPU check failed ({dtype})")


def phase_kinds_timing(dev, res):
    """CUDA-event medians at 512^3: K1' on config A's, the kinds gradient's
    (both also with aux: RK3 stages 2 and 3) and config B's (frozen and
    recomputed sign) stage-1 inputs, on D4's at N_2D^2 (the embedding), K6'
    on config C's, and their plain versions; ``integrate`` ms per step for A
    (RK3), B (RK3, frozen sign) and C (FE, RK3); peak memory of each."""
    t, mem, n = res["t"], {}, N_MAIN
    phi = torus_field(n, dev)
    st_a = FusedStepper(a_terms(), phi, lsm.RK3())
    P = st_a.pack(phi.values)
    dt = 0.5 * float(st_a.cfl(P, 0.0))
    terms = st_a.stage_terms(0.0)
    t["K1k_A"] = cuda_time(lambda: v2.fused_stage(P, terms, (0.0, 1.0, dt), None, st_a.spacing,
                                                  st_a.shape))
    t["K1k_A_plain"] = cuda_time(lambda: v2.stage_plain(P, terms, (0.0, 1.0, dt), None,
                                                        st_a.spacing, st_a.shape), warmup=1, reps=5)
    t["A_integrate"] = integrate_ms_per_step(a_terms(), phi, lsm.RK3())
    mem["A_integrate"] = peak_gib(lambda: lsm.LevelSetEquation(
        terms=a_terms(), ic=phi, integrator=lsm.RK3()).integrate(1.0, max_steps=10))
    # the kinds gradient's table: curvature plus normal motion at a streamed speed
    st_g = FusedStepper(grad_kinds_terms(phi, c_term(phi).speed.values), phi, lsm.RK3())
    terms = st_g.stage_terms(0.0)
    t["K1k_grad"] = cuda_time(lambda: v2.fused_stage(P, terms, (0.0, 1.0, dt), None,
                                                     st_g.spacing, st_g.shape))
    t["K1k_grad_aux"] = cuda_time(lambda: v2.fused_stage(P, terms, (0.75, 0.25, 0.25 * dt), P,
                                                         st_g.spacing, st_g.shape))
    t["K1k_A_aux"] = cuda_time(lambda: v2.fused_stage(P, st_a.stage_terms(0.0),
                                                      (0.75, 0.25, 0.25 * dt), P, st_a.spacing,
                                                      st_a.shape))
    del phi, st_a, st_g, P, terms
    # D4: config 4 at N_2D^2 on the (1, n0, n1) embedding (axis 0 compiled out)
    d4_terms, d4_phi, d4_integ = config("D4", N_2D, dev)
    st_d = FusedStepper(d4_terms, d4_phi, d4_integ)
    P, terms = st_d.pack(d4_phi.values), st_d.stage_terms(0.0)
    t["K1k_D4"] = cuda_time(lambda: v2.fused_stage(P, terms, (0.0, 1.0, 1e-6), None,
                                                   st_d.spacing, st_d.shape))
    t["K1k_D4_plain"] = cuda_time(lambda: v2.stage_plain(P, terms, (0.0, 1.0, 1e-6), None,
                                                         st_d.spacing, st_d.shape),
                                  warmup=1, reps=5)
    res["k1k_routes"] = {"A": FusedStepper(a_terms(), torus_field(8, dev), lsm.RK3()).stage_route,
                         "D4": st_d.stage_route}
    del d4_terms, d4_phi, d4_integ, st_d, P, terms
    torch.cuda.empty_cache()
    phi = torus_field(n, dev, wavy=True)
    frozen = lsm.EikonalReinitializationTerm.from_initial(phi)
    for label, term in (("frozen", frozen), ("none", lsm.EikonalReinitializationTerm())):
        st_b = FusedStepper((term,), phi, lsm.RK3())
        P = st_b.pack(phi.values)
        terms = st_b.stage_terms(0.0)
        t[f"K1k_B_{label}"] = cuda_time(lambda: v2.fused_stage(P, terms, (0.0, 1.0, 1e-3), None,
                                                               st_b.spacing, st_b.shape))
        t[f"K1k_B_{label}_plain"] = cuda_time(lambda: v2.stage_plain(
            P, terms, (0.0, 1.0, 1e-3), None, st_b.spacing, st_b.shape), warmup=1, reps=5)
        del st_b, P, terms
    t["B_integrate"] = integrate_ms_per_step((frozen,), phi, lsm.RK3())
    mem["B_integrate"] = peak_gib(lambda: lsm.LevelSetEquation(
        terms=(frozen,), ic=phi, integrator=lsm.RK3()).integrate(1.0, max_steps=10))
    del phi, frozen
    torch.cuda.empty_cache()
    nb = sphere_band(n, dev)
    fe = FusedBandStepper((c_term(nb),), nb, lsm.ForwardEuler())
    state = fe.pack(nb)
    P, out = state.bufs
    terms = fe.stage_terms(state, 0.0)
    dt = 0.5 * float(fe.cfl(state, 0.0)[0])
    args = (state.ids, state.band, terms, (0.0, 1.0, dt), None, fe.spacing, fe.shape, fe.tiles)
    t["K6k_C"] = cuda_time(lambda: bd.band_stage(P, out, *args))
    t["K6k_C_back_to_back"] = back_to_back_ms(lambda: bd.band_stage(P, out, *args))
    t["K6k_C_plain"] = cuda_time(lambda: bd.band_stage_plain(P, out, *args), warmup=1, reps=5)
    flat, valid = bd.tile_index(state.ids, fe.shape, fe.tiles)
    res["kinds_band_work"] = {"dispatched": int(valid.sum()),
                              "ops_cells": int(((state.band.view(-1)[flat] != 0) & valid).sum())}
    del flat, valid
    for name, integ in (("FE", lsm.ForwardEuler()), ("RK3", lsm.RK3())):
        key = f"C_{name}_integrate"
        t[key] = integrate_ms_per_step((c_term(nb),), nb, integ, path="band")
        mem[key] = peak_gib(lambda: lsm.LevelSetEquation(
            terms=(c_term(nb),), ic=nb, integrator=integ).integrate(1.0, max_steps=10))
    del nb, fe, state, P, out, terms
    torch.cuda.empty_cache()
    for name in [k for k in t if k.startswith(("K1k", "K6k", "A_", "B_", "C_"))]:
        where = f"{N_2D}^2" if "D4" in name else f"{n}^3"
        log("kinds_timing", f"{where} f32 {name:24s} median {t[name]:.4f} ms")
    log("kinds_timing", f"K1' routes: {res['k1k_routes']}")
    log("kinds_timing", "peak memory: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in mem.items()))
    res["mem"].update(mem)


# -- gradients of the term kinds (K3') and configuration 5 -----------------------------


def k3k_cases(shape, dtype, dev, gen):
    """The term lists of K3''s checks: normal motion (streamed, constant),
    curvature (constant), eikonal (frozen sign, recomputed), curvature +
    normal motion, advection + normal motion. Streamed scalars have exact
    zeros (the normal motion's 0.5 / 0.5 tie)."""
    s = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    s[:, ::3] = 0.0
    vel = 0.3 * torch.randn((3, *shape), generator=gen, device=dev, dtype=dtype)
    stream = lambda kind, arrs: (v2.TermSpec(kind, "stream", None, len(arrs)),
                                 tuple(a.contiguous() for a in arrs))
    const = lambda kind, value: (v2.TermSpec(kind, "const", value, 0), ())
    return {
        "normal stream": (stream("normal", [s]),),
        "normal const": (const("normal", 0.2),),
        "curvature const": (const("curvature", -0.05),),
        "eikonal stream": (stream("eikonal", [s]),),
        "eikonal none": ((v2.TermSpec("eikonal", "none", None, 0), ()),),
        "curvature + normal": (const("curvature", -0.05), stream("normal", [s])),
        "advection + normal": (stream("advection", list(vel)), stream("normal", [s])),
    }


def cast_terms(terms, dtype):
    return tuple((spec, tuple(a.to(dtype).contiguous() for a in arrs)) for spec, arrs in terms)


def k3k_errs(got, ref, shape):
    """Worst ``max|got - ref| / max|ref|`` over K3''s outputs (the raw dP,
    each stream cotangent, dalpha, dbeta, dgamma, daux), and the worst
    absolute difference of dP and the stream cotangents."""
    pairs = [(got[0], ref[0])] + list(zip(got[1], ref[1]))
    pairs += [(got[2][k:k + 1], ref[2][k:k + 1]) for k in range(3)]
    if ref[3] is not None:
        pairs.append((v2.unpack_padded(got[3], shape), v2.unpack_padded(ref[3], shape)))
    rel = max(rel_err(a, b) for a, b in pairs)
    absolute = max(float((a.double() - b.double()).abs().max())
                   for a, b in [(got[0], ref[0])] + list(zip(got[1], ref[1])))
    return rel, absolute


def phase_k3kinds(dev, res):
    """K3' against its plain version at BAND_SMALL on the torus (with a
    little noise), three BC cases, each term list with and without aux: f64
    kernel vs f64 plain (tol 1e-10, relative to max|ref|), f32 kernel vs the
    f64 autograd oracle of stage + refresh (with float32's WENO epsilon
    floor; tol K3_TOL), or vs its f32 plain version on K3K_F32_VS_PLAIN."""
    shape = BAND_SMALL
    gen = torch.Generator(device=dev).manual_seed(13)
    grid = lsm.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), shape)
    sp = grid.spacing
    torus = lsm.sample(shapes.torus((0.0, 0.0, 0.0), 0.5, 0.2), grid, dtype=torch.float64,
                       device=dev).values
    vals = torus + 1e-3 * torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
    aux_vals = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
    G64 = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=torch.float64)
    cases = k3k_cases(shape, torch.float64, dev, gen)
    worst = {"f64": 0.0, "f32": 0.0, "f32_abs": 0.0, "f32_plain": 0.0}
    for bname, bc in K3K_BCS.items():
        bcs = lsm.normalize_bcs(bc(), 3)
        for name, terms64 in cases.items():
            line = {}
            for with_aux in (False, True):
                coeffs = (0.75, 0.25, 2.5e-3) if with_aux else (0.0, 1.0, 1e-2)
                for dtype in (torch.float64, torch.float32):
                    P = v2.pack_padded(vals.to(dtype), bcs)
                    A = v2.pack_padded(aux_vals.to(dtype), bcs) if with_aux else None
                    G = G64.to(dtype)
                    terms = cast_terms(terms64, dtype)
                    gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
                    got = bwd.stage_backward_terms(P, terms, coeffs, A, gf, sp, shape)
                    plain = bwd.stage_backward_terms_plain(P, terms, coeffs, A, gf, sp, shape)
                    torch.cuda.synchronize()
                    if dtype == torch.float64:
                        rel, _ = k3k_errs(got, plain, shape)
                        worst["f64"] = max(worst["f64"], rel)
                        line["f64"] = max(line.get("f64", 0.0), rel)
                        continue
                    d = lambda t: None if t is None else t.double()
                    with f32_weno_floor():
                        ref = bwd.composite_backward_autograd(d(P), cast_terms(terms, torch.float64),
                                                              coeffs, d(A), G.double(), bcs, sp,
                                                              shape)
                    rel, absolute = k3k_errs(got, ref, shape)
                    prel, pabs = k3k_errs(got, plain, shape)
                    if bname in K3K_F32_VS_PLAIN:
                        rel, absolute = prel, pabs
                    worst["f32"] = max(worst["f32"], rel)
                    worst["f32_abs"] = max(worst["f32_abs"], absolute)
                    worst["f32_plain"] = max(worst["f32_plain"], pabs)
                    line["f32"] = max(line.get("f32", 0.0), rel)
                    finite = all(bool(torch.isfinite(t).all()) for t in (got[0], *got[1]))
                    if not finite:
                        raise AssertionError(f"K3' non-finite ({bname}, {name}, aux={with_aux})")
            ref32 = "f32 plain" if bname in K3K_F32_VS_PLAIN else "f64 oracle"
            log("k3kinds", f"{bname:9s} {name:20s} f64 kernel vs plain {line['f64']:.2e} "
                           f"(tol 1e-10), f32 kernel vs {ref32} {line['f32']:.2e} "
                           f"(tol {K3_TOL:g}), relative to max|ref|")
    log("k3kinds", f"worst: f64 {worst['f64']:.3e}, f32 {worst['f32']:.3e} "
                   f"(max abs {worst['f32_abs']:.3e}), f32 kernel vs f32 plain max abs "
                   f"{worst['f32_plain']:.3e} (reported)")
    if not (worst["f64"] <= 1e-10 and worst["f32"] <= K3_TOL):
        raise AssertionError(f"K3' parity failed: {worst}")
    res["k3k_err"] = worst["f32_abs"]
    res["k3k_rel"] = (worst["f64"], worst["f32"])


def k3k_inputs(label, n, dev):
    """Config A's stage-1 inputs at n^3 (the torus; curvature + normal
    motion, constants) or config C's dense one (the sphere; normal motion at
    the streamed speed 0.1 + 0.05 x): ``(stepper, P, terms, dt)``."""
    if label == "A":
        phi = torus_field(n, dev)
        terms = a_terms()
    else:
        grid = lsm.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), (n, n, n))
        phi = lsm.sample(shapes.sphere((0.0, 0.0, 0.0), 0.5), grid, lsm.Extrapolation(2),
                         device=dev)
        terms = (c_term(phi),)
    stepper = FusedStepper(terms, phi, lsm.ForwardEuler())
    P = stepper.pack(phi.values)
    return stepper, P, stepper.stage_terms(0.0), 0.5 * float(stepper.cfl(P, 0.0))


def phase_k3kinds_512(dev, res):
    """K3' at 512^3 f32 on config A's and config C's (dense) stage-1 inputs:
    a 64^3 sub-box against the f64 plain K3' of that sub-box (its outputs
    within reach included; tol K3_TOL), the whole buffer finite; CUDA-event
    medians of K3' there, and of K3' and its plain version at N_K3K_PLAIN^3."""
    n, t = N_MAIN, res.setdefault("t_k3k", {})  # by config label
    B = min(64, n // 8)  # at 512^3 the box spans +-0.125 around its centre
    gen = torch.Generator(device=dev).manual_seed(14)
    for label in ("A", "C"):
        stepper, P, terms, dt = k3k_inputs(label, n, dev)
        shape, sp, bcs = stepper.shape, stepper.spacing, stepper.bcs
        G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
        gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
        coeffs = (0.0, 1.0, dt)
        call = lambda: bwd.stage_backward_terms(P, terms, coeffs, None, gf, sp, shape)
        dP, ds, dcoef, _ = first = call()
        repeat_check("k3kinds_512", f"K3' config {label}", call, first)
        del first
        finite = all(bool(torch.isfinite(x).all()) for x in (dP, *ds, dcoef))
        # on the surface: the torus's at y = -0.7, off its core circle
        # (|grad phi| -> 0 there, and curvature's adjoint with it); the sphere's
        a = [_sub_box(n, B, c) for c in ((0.5, 0.15, 0.5) if label == "A" else (0.5, 0.25, 0.5))]
        box = tuple(slice(x - 6, x + B + 6) for x in a)
        sub = (B + 6,) * 3
        sub_terms = tuple((spec, tuple(c[tuple(slice(x - 6, x + B) for x in a)].double()
                                       .contiguous() for c in arrs)) for spec, arrs in terms)
        ref = bwd.stage_backward_terms_plain(P[box].double().contiguous(), sub_terms, coeffs, None,
                                             gf[box].double().contiguous(), sp, sub)
        region = tuple(slice(x, x + B) for x in a)
        region_i = tuple(slice(x - 3, x - 3 + B) for x in a)
        inner_p, inner_i = (slice(6, 6 + B),) * 3, (slice(3, 3 + B),) * 3
        errs = {"dP": rel_err(dP[region], ref[0][inner_p])}
        for k, (d, r) in enumerate(zip(ds, ref[1])):
            errs[f"ds{k}"] = rel_err(d[region_i], r[inner_i])
        log("k3kinds_512", f"config {label} {n}^3 f32 sub-box {B}^3 at {a}: "
                           + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
                           + f" (tol {K3_TOL:g}) finite={finite}")
        if not (finite and max(errs.values()) <= K3_TOL):
            raise AssertionError(f"K3' at {n}^3 failed (config {label}): {errs}")
        t[label] = cuda_time(lambda: bwd.stage_backward_terms(P, terms, coeffs, None, gf, sp,
                                                              shape))
        del stepper, P, terms, G, gf, dP, ds, ref
        torch.cuda.empty_cache()
        m = N_K3K_PLAIN
        stepper, P, terms, dt = k3k_inputs(label, m, dev)
        G = torch.randn(v2.padded_shape(stepper.shape), generator=gen, device=dev)
        gf = bwd.fold_ghost_cotangent_fast(G, stepper.bcs, stepper.shape)
        args = (P, terms, (0.0, 1.0, dt), None, gf, stepper.spacing, stepper.shape)
        t[f"{label}@{m}"] = cuda_time(lambda: bwd.stage_backward_terms(*args))
        t[f"{label}_plain@{m}"] = cuda_time(lambda: bwd.stage_backward_terms_plain(*args),
                                            warmup=1, reps=5)
        del stepper, P, terms, G, gf, args
        torch.cuda.empty_cache()
    for name, ms in t.items():
        log("k3kinds_512", f"f32 K3' config {name:12s} median {ms:.4f} ms")


def grad_kinds_terms(phi, s):
    """Config A's curvature with config C's normal motion at the streamed
    speed ``s``."""
    return (lsm.CurvatureTerm(-0.05), lsm.NormalMotionTerm(lsm.MeshField(s, phi.grid, phi.bcs)))


def grad_kinds(phi, v, s, dt, nsteps):
    """``sum(phi_final^2)`` of an RK3 rollout (remat) through
    :func:`grad_kinds_terms`, and its gradients w.r.t. the values ``v`` and
    the speed ``s``."""
    out, _ = lsm.rollout(lsm.RK3(), grad_kinds_terms(phi, s), phi.with_values(v), 0.0, dt,
                         nsteps, remat=True)
    loss = (out.values ** 2).sum()
    return (loss,) + torch.autograd.grad(loss, (v, s))


def phase_grad_kinds(dev, res):
    """The dense kinds gradient: an RK3 rollout under remat of curvature
    (-0.05) plus normal motion at the streamed speed 0.1 + 0.05 x on the
    torus. 64^3, 3 steps, card against CPU: f64 max norm (tol 1e-10*scale),
    f32 relative L2 against F32_L2_FACTOR times the CPU's own spread under a
    1-ulp change of phi0; the torus carries 1e-3 of seeded noise, so no
    exact tie takes another subgradient. Then 512^3 f32, GRAD_KINDS_STEPS
    steps: ms per value_and_grad, peak memory, launches."""
    noise = 1e-3 * torch.randn((N_SMALL,) * 3, generator=torch.Generator().manual_seed(15),
                               dtype=torch.float64)

    def run(where, dtype, perturb=None):
        phi = torus_field(N_SMALL, where, dtype)
        v = phi.values + noise.to(where, dtype)
        if perturb is not None:
            v = v * (1 + 2.0 ** -23 * perturb)
        s = c_term(phi).speed.values
        dt = 0.5 * float(lsm.compute_cfl(grad_kinds_terms(phi, s), phi.with_values(v), 0.0))
        return grad_kinds(phi, v.clone().requires_grad_(), s.clone().requires_grad_(), dt, 3)

    out = {}
    for dtype in (torch.float64, torch.float32):
        for where in ("cpu", dev):
            out[(str(where), dtype)] = [x.detach().cpu() for x in run(where, dtype)]
    card, cpu = out[(str(dev), torch.float64)], out[("cpu", torch.float64)]
    e64 = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(card, cpu)]
    card, cpu = out[(str(dev), torch.float32)], out[("cpu", torch.float32)]
    l2_32 = [rel_l2(a, b) for a, b in zip(card[1:], cpu[1:])]
    pert = torch.randn((N_SMALL,) * 3, generator=torch.Generator().manual_seed(16))
    ulp = [rel_l2(a.detach(), b) for a, b in zip(run("cpu", torch.float32, pert)[1:], cpu[1:])]
    log("grad_kinds", f"{N_SMALL}^3 RK3 x3 card vs CPU: f64 max|diff|/max|ref| loss {e64[0]:.2e} "
                      f"dphi0 {e64[1]:.2e} dspeed {e64[2]:.2e} (tol 1e-10); f32 relative L2 "
                      f"dphi0 {l2_32[0]:.3e} dspeed {l2_32[1]:.3e} (tol {F32_L2_FACTOR:g}x the "
                      f"CPU's 1-ulp spread {ulp[0]:.3e}, {ulp[1]:.3e})")
    if not (max(e64) <= 1e-10 and all(a <= F32_L2_FACTOR * b for a, b in zip(l2_32, ulp))):
        raise AssertionError("kinds gradient card-vs-CPU check failed")
    del out, card, cpu
    # 512^3 f32: one value_and_grad, counting launches, then timed
    n = N_MAIN
    phi = torus_field(n, dev)
    s = c_term(phi).speed.values
    dt = 0.5 * float(lsm.compute_cfl(grad_kinds_terms(phi, s), phi, 0.0))
    call = lambda: grad_kinds(phi, phi.values.clone().requires_grad_(), s.clone().requires_grad_(),
                              dt, GRAD_KINDS_STEPS)
    torch.cuda.synchronize()
    reset_counts()
    loss, gv, gs = call()
    torch.cuda.synchronize()
    counts = read_counts()
    k = GRAD_KINDS_STEPS
    want = dict(NONE_LAUNCHED, K1=2 * 3 * k, K2=2 * 3 * k, K4=3 * k, K5=2 * k,
                **{"K1'": 2 * 3 * k, "K3'": 3 * k})
    finite = bool(torch.isfinite(gv).all()) and bool(torch.isfinite(gs).all())
    del gv, gs
    ms = cuda_time(call, warmup=1, reps=3)
    mem = peak_gib(call)
    log("grad_kinds", f"{n}^3 f32 RK3 rollout x{k} remat, curvature + normal motion (streamed "
                      f"speed): loss={loss.item():.6e} finite={finite} launches={counts} "
                      f"(expected {want}); value_and_grad median {ms:.1f} ms, peak {mem:.2f} GiB")
    if not (finite and counts == want):
        raise AssertionError("the kinds gradient at 512^3 failed")
    res["launches"]["K1' kinds grad"] = counts["K1'"]
    profile_window(f"kinds gradient, {k} RK3 steps at {n}^3", call)
    res["launches"]["K3'"] = counts["K3'"]
    res["t_grad"] = {"grad_kinds": ms}
    res["mem_grad"] = {"grad_kinds": mem}


def phase_config5(dev, res):
    """Configuration 5 (``models.benchmarks.config5_shape_opt_3d``): at its
    published size (64^3, 8 RK3 steps) the card (band stepper: K6', K7, K8
    forward, autograd of the plain band composite backward) against the CPU
    (the general band path) in f64, loss and both gradients (tol
    1e-10*scale), and f32 against f64 on the card (relative L2 of each
    gradient, tol F32_L2_FACTOR times the CPU's own f32-vs-f64 distance:
    8 steps of f32 move this gradient by ~4e-3, a 1-ulp change of phi0 by
    ~9e-4), on phi0 plus CONFIG5_NOISE of seeded noise; then
    N_CONFIG5_XL^3 f32 on the published phi0: ms per loss_and_grad and peak
    memory."""
    out, counts = {}, None
    shape = (N_CONFIG5,) * 3
    noise = CONFIG5_NOISE * torch.randn(shape, generator=torch.Generator().manual_seed(5),
                                        dtype=torch.float64)
    for label, where, dtype in (("cpu", "cpu", torch.float64), ("card", dev, torch.float64),
                                ("card32", dev, torch.float32), ("cpu32", "cpu", torch.float32)):
        fn, phi0, speed0 = bench.config5_shape_opt_3d(n=N_CONFIG5, nsteps=CONFIG5_STEPS,
                                                      dtype=dtype, device=where)
        torch.cuda.synchronize()
        reset_counts()
        loss, (dphi, dspeed) = fn(phi0.values + noise.to(where, dtype), speed0)
        torch.cuda.synchronize()
        if label == "card":
            counts = read_counts()
        out[label] = [x.cpu() for x in (loss, dphi, dspeed)]
    card, cpu = out["card"], out["cpu"]
    e64 = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(card, cpu)]
    l2_32 = [rel_l2(a, b) for a, b in zip(out["card32"][1:], card[1:])]
    l2_cpu = [rel_l2(a, b) for a, b in zip(out["cpu32"][1:], cpu[1:])]
    stages = CONFIG5_STEPS * 3
    log("config5", f"{N_CONFIG5}^3 x{CONFIG5_STEPS} RK3 loss_and_grad: loss card "
                   f"{float(card[0]):.12e} CPU {float(cpu[0]):.12e}; card vs CPU f64 "
                   f"max|diff|/max|ref| loss {e64[0]:.2e} dphi {e64[1]:.2e} dspeed {e64[2]:.2e} "
                   f"(tol 1e-10); f32 vs f64 relative L2 dphi {l2_32[0]:.3e} dspeed {l2_32[1]:.3e} "
                   f"(tol {F32_L2_FACTOR:g}x the CPU's {l2_cpu[0]:.3e}, {l2_cpu[1]:.3e}); "
                   f"launches {counts}")
    if not (max(e64) <= 1e-10 and all(a <= F32_L2_FACTOR * b for a, b in zip(l2_32, l2_cpu))
            and counts["K6'"] >= stages and counts["K7"] >= stages and counts["K8"] > 0
            and counts["K1"] == counts["K3"] == counts["K3'"] == 0):
        raise AssertionError("configuration 5 check failed")
    del out, card, cpu
    torch.cuda.empty_cache()
    fn, phi0, speed0 = bench.config5_shape_opt_3d(n=N_CONFIG5_XL, nsteps=CONFIG5_STEPS, device=dev)
    call = lambda: fn(phi0.values, speed0)
    loss, (dphi, dspeed) = call()
    finite = bool(torch.isfinite(dphi).all()) and bool(torch.isfinite(dspeed).all())
    del dphi, dspeed
    ms = cuda_time(call, warmup=1, reps=3)
    mem = peak_gib(call)
    log("config5", f"{N_CONFIG5_XL}^3 f32 x{CONFIG5_STEPS} RK3 loss_and_grad: loss "
                   f"{float(loss):.6e} finite={finite}, median {ms:.1f} ms, peak {mem:.2f} GiB")
    if not finite:
        raise AssertionError("configuration 5 at 256^3 is not finite")
    profile_window(f"configuration 5 loss_and_grad at {N_CONFIG5_XL}^3", call)
    res["t_grad"]["config5_xl"] = ms
    res["mem_grad"]["config5_xl"] = mem


# -- the general path (K10, K11) and 2D fields ------------------------------------------


def general_bcs(ndim):
    """:func:`bc_cases` on the first ``ndim`` axes."""
    return {name: bcs[:ndim] for name, bcs in bc_cases().items()}


def general_compare(label, got, ref, tol):
    """``(max|got - ref|, max(|ref|, 1))``; raises beyond ``tol * scale`` or
    on a non-finite value."""
    err = float((got.double() - ref.double()).abs().max())
    scale = max(float(ref.abs().max()), 1.0)
    if not (bool(torch.isfinite(got).all()) and err <= tol * scale):
        raise AssertionError(f"{label}: {err} > {tol} * {scale}")
    return err, scale


def k10_march_shapes(dev, gen, res):
    """K10 at K1_MARCH_SHAPES with n0 >= 2 (K10 always marches axis 0), f32
    and f64, random buffers: the bare Hamiltonian and stages with and
    without aux, with aligned inputs and with u1 and aux one element off
    their alignment: within the tolerance of its plain version, and equal
    bit for bit to the interior of K1's march on the same P, u and aux (aux
    on K1's padded layout)."""
    worst = 0.0
    for shape in [s for s in K1_MARCH_SHAPES if s[0] >= 2]:
        for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
            P, A, sp, _ = k1_inputs(shape, dtype, dev, gen)
            u = [torch.randn(shape, generator=gen, device=dev, dtype=dtype) for _ in range(3)]
            u[0].view(-1)[::7] = 0.0
            aux = v2.unpack_padded(A, shape).contiguous()
            rel, same = 0.0, True
            for coeffs, a in (((0.0, 0.0, -1.0), None), ((0.0, 1.0, 1e-3), None),
                              ((0.75, 0.25, 2.5e-4), aux)):
                for uu, aa in ((u, a), ((u[0], misaligned(u[1]), u[2]),
                                        None if a is None else misaligned(a))):
                    got = wg.weno_stage_3d(P, uu, sp, shape, coeffs, aa)
                    ref = wg._stage_plain(P, uu, aa, coeffs, sp, shape)
                    k1 = v2.unpack_padded(v2.fused_stage(P, uu, coeffs, None if a is None else A,
                                                         sp, shape), shape)
                    torch.cuda.synchronize()
                    err, scale = general_compare(f"K10 {shape} {dtype} {coeffs}", got, ref, tol)
                    rel = max(rel, err / scale)
                    same = same and bool(torch.equal(got, k1))
                    if dtype == torch.float32:
                        worst = max(worst, err)
            log("k10k11", f"K10 {str(dtype):13s} march shape={shape} H / stage / stage+aux, aligned "
                          f"and u1, aux off alignment: max|kernel-plain|/scale={rel:.3e} (tol "
                          f"{tol:g}); equal bits to K1's march interior: {same}")
            if not same:
                raise AssertionError(f"K10 at {shape} ({dtype}) differs from K1's march")
    res["k10_err"] = max(res.get("k10_err", 0.0), worst)


#: K11's march: axis 0 under one step of 8 rows and past one chunk of 64,
#: axis 1 a multiple of neither 4 (16-byte copies) nor 128 (a block's columns)
K11_MARCH_SHAPES = ((5, 131), (67, 37), (70, 9), (3, 258), (130, 200))


def k11_against_k1_2d(label, P, u, aux, sp, shape, tol, res):
    """K11 on ``(P, u, aux)`` under the bare Hamiltonian, a stage and a stage
    with aux, aligned and with ``u[1]`` and aux one element off their
    alignment (element copies): within ``tol`` times max(|ref|, 1) of its
    plain version, and equal bit for bit to the interior of K1 2D's streamed
    entry on the same P, u and aux (aux on K1's padded layout). Returns the
    largest relative error; f32 errors go to ``res["k11_err"]``."""
    A = torch.zeros_like(P)
    v2.unpack_padded(A, shape).copy_(aux)
    rel = 0.0
    for coeffs, a in ((None, None), ((0.0, 1.0, 1e-3), None), ((0.75, 0.25, 2.5e-4), aux)):
        bits = []
        for uu, aa in ((u, a), ((u[0], misaligned(u[1])), None if a is None else misaligned(a))):
            got = wg.weno_stage_2d(P, uu, sp, shape, coeffs, aa)
            ref = wg._stage_plain(P, uu, aa, coeffs or wg._BARE, sp, shape)
            k1 = v2.unpack_padded(v2.fused_stage(P, tuple(uu), coeffs or wg._BARE,
                                                 None if a is None else A, sp, shape), shape)
            torch.cuda.synchronize()
            err, scale = general_compare(f"K11 {label} {coeffs}", got, ref, tol)
            rel = max(rel, err / scale)
            if P.dtype == torch.float32:
                res["k11_err"] = max(res.get("k11_err", 0.0), err)
            if not same_bits(got, k1):
                raise AssertionError(f"K11 {label} {coeffs}: differs from K1 2D's interior")
            bits.append(got)
        if not same_bits(*bits):
            raise AssertionError(f"K11 {label} {coeffs}: misaligned inputs change the bits")
    return rel


def k11_march(dev, gen, res):
    """K11 (K1's 2D march, aux and output interior-shaped) at K11_MARCH_SHAPES
    on random buffers, f32 and f64, and at N_2D^2 on D2s's stage inputs
    (the stepper's packed state and streamed velocity; aux its interior),
    f32: :func:`k11_against_k1_2d`."""
    for shape in K11_MARCH_SHAPES:
        sp = tuple(1.0 / (n + 1) for n in shape)
        for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
            P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
            u = [torch.randn(shape, generator=gen, device=dev, dtype=dtype) for _ in range(2)]
            u[0].view(-1)[::7] = 0.0
            aux = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            rel = k11_against_k1_2d(f"{shape} {dtype}", P, u, aux, sp, shape, tol, res)
            log("k10k11", f"K11 {str(dtype):13s} march shape={shape} H / stage / stage+aux, "
                          f"aligned and u1, aux off alignment: max|kernel-plain|/scale="
                          f"{rel:.3e} (tol {tol:g}); equal bits to K1 2D's interior: True")
    terms, phi, integ = config("D2s", N_2D, dev)
    st = FusedStepper(terms, phi, integ)
    P = st.pack(phi.values)
    u = list(st.stage_terms(0.0)[0][1])
    rel = k11_against_k1_2d(f"D2s {N_2D}^2", P, u, v2.unpack_padded(P, st.shape).contiguous(),
                            st.spacing, st.shape, K1_TOL, res)
    log("k10k11", f"K11 f32 D2s {N_2D}^2 H / stage / stage+aux, aligned and u1, aux off "
                  f"alignment: max|kernel-plain|/scale={rel:.3e} (tol {K1_TOL:g}); equal bits "
                  f"to K1 2D's streamed entry's interior: True")


def phase_k10k11(dev, res):
    """K10 (3D) and K11 (2D) against their plain versions at 40x72x136 and
    67x131, five BC cases, f32 and f64: the bare Hamiltonian and a stage
    with and without aux, on a random field with a random velocity that is
    exactly 0 on every 7th node (the upwind tie); a flat field gives 0.
    K10 also at the march's shapes against K1's march
    (:func:`k10_march_shapes`), K11 at its march's shapes and on D2s's
    inputs against K1 2D's (:func:`k11_march`)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    worst = {"K10": 0.0, "K11": 0.0}
    for shape in ((40, 72, 136), (67, 131)):
        key = "K10" if len(shape) == 3 else "K11"
        sp = tuple(1.0 / (n - 1) for n in shape)
        for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
            rel = 0.0
            for name, bcs in general_bcs(len(shape)).items():
                vals = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                P = pad_ghost(vals, bcs, v2.GHOST).contiguous()
                u = [torch.randn(shape, generator=gen, device=dev, dtype=dtype) for _ in shape]
                u[0].view(-1)[::7] = 0.0
                aux = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                for coeffs, a in ((None, None), ((0.0, 1.0, 1e-3), None),
                                  ((0.75, 0.25, 2.5e-4), aux)):
                    got = wg.weno_stage_general(P, u, sp, shape, coeffs, a)
                    ref = wg._stage_plain(P, u, a, coeffs or wg._BARE, sp, shape)
                    torch.cuda.synchronize()
                    err, scale = general_compare(f"{key} {name} {dtype} {coeffs}", got, ref, tol)
                    rel = max(rel, err / scale)
                    if dtype == torch.float32:
                        worst[key] = max(worst[key], err)
            log("k10k11", f"{key} {str(dtype):13s} shape={shape} five BC cases, H / stage / "
                          f"stage+aux: max|kernel-plain|/scale={rel:.3e} (tol {tol:g})")
        if key == "K10":
            k10_march_shapes(dev, gen, res)
        else:
            k11_march(dev, gen, res)
        flat = torch.ones(tuple(n + 6 for n in shape), device=dev)
        uf = [torch.full(shape, v, device=dev) for v in (1.0, -1.0, 0.0)[:len(shape)]]
        hf = wg.weno_hamiltonian(flat, uf, sp, shape)
        torch.cuda.synchronize()
        mx = float(hf.abs().max())
        log("k10k11", f"{key} flat field f32: finite={bool(torch.isfinite(hf).all())} "
                      f"max|H|={mx:.3e}")
        if not (bool(torch.isfinite(hf).all()) and mx < 1e-6):
            raise AssertionError(f"{key} on a flat field: {mx}")
    res["k10_err"] = max(res.get("k10_err", 0.0), worst["K10"])
    res["k11_err"] = max(res.get("k11_err", 0.0), worst["K11"])


#: K2's 2D entry's shapes: ragged, the smallest axes Periodic takes, D2's grid
K2_2D_SHAPES = ((67, 131), (4, 9), (40, 72), (N_2D, N_2D))


def phase_k2_small(dev, res):
    """K2's 2D entry (one launch) on ``(n0+6, n1+6)`` buffers at
    K2_2D_SHAPES, f32 and f64, the five BC cases of ``general_bcs(2)`` (two
    at N_2D^2), scribbled shells: bit for bit against its plain version and
    ``pad_ghost`` of the interior. Then K2 on a 3D field of one plane (the
    length-1 axis under ``Extrapolation(0)``, which a 3D field still takes),
    bit for bit against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(12)
    for shape in K2_2D_SHAPES:
        cases = general_bcs(2)
        if shape[0] == N_2D:
            cases = {k: cases[k] for k in ("periodic", "mixed")}
        for dtype in (torch.float32, torch.float64):
            for name, bcs in cases.items():
                vals = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                P = v2.pack_padded(vals, bcs)
                shell = shell_mask(shape, dev)
                P[shell] = torch.randn(int(shell.sum()), generator=gen, device=dev, dtype=dtype)
                reset_counts()
                got = v2.refresh_ghosts_fast(P.clone(), bcs, shape)
                counts = read_counts()
                ref = v2.refresh_ghosts_plain(P.clone(), bcs, shape)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                err_pad = float((got - pad_ghost(vals, bcs, v2.GHOST)).abs().max())
                log("k2_small", f"K2 2D {str(dtype)[6:]} {name:9s} shape={shape} "
                                f"max|kernel-plain|={err:.3e} max|kernel-pad_ghost|={err_pad:.3e} "
                                f"launches K2 {counts['K2']} (2D {counts['K2 2D']})")
                if not (err == 0.0 and err_pad == 0.0 and counts["K2"] == counts["K2 2D"] == 1):
                    raise AssertionError(f"K2's 2D entry failed for {name} at {shape}: {err}")
    res["k2_2d_err"] = 0.0
    shape = (1, 67, 131)
    for name, bcs2 in general_bcs(2).items():
        bcs = ((lsm.Extrapolation(0), lsm.Extrapolation(0)), *bcs2)  # the length-1 axis 0
        vals = torch.randn(shape, generator=gen, device=dev)
        P = v2.pack_padded(vals, bcs)
        shell = shell_mask(shape, dev)
        P[shell] = torch.randn(int(shell.sum()), generator=gen, device=dev)  # scribble
        got = v2.refresh_ghosts_fast(P.clone(), bcs, shape)
        ref = v2.refresh_ghosts_plain(P.clone(), bcs, shape)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        err_pad = float((got - v2.pack_padded(vals, bcs)).abs().max())
        copies = bool((got[:3] == got[3]).all() and (got[4:] == got[3]).all())
        log("k2_small", f"{name:9s} shape={shape} max|kernel-plain|={err:.3e} "
                        f"max|kernel-pad_ghost|={err_pad:.3e} length-1 axis ghosts copies={copies}")
        if not (err == 0.0 and err_pad <= K2_TOL and copies):
            raise AssertionError(f"K2 on a length-1 axis failed for {name}: {err} / {err_pad}")
    res["k2_err"] = max(res["k2_err"], 0.0)


# -- the dense 2D stepper's stage on the (n0+6, n1+6) layout: K1's 2D entries -----------

#: K1's 2D march at its edge shapes: rows of odd length (element copies) and a
#: ragged last block of columns, n1 % 4 == 0 (pairs and 16-byte streams), more
#: rows than a chunk (three chunks)
K1_2D_SHAPES = ((67, 131), (40, 72), (130, 33))


def speed2(xs, t):
    """A 2D speed that changes sign (both Godunov branches), traced into a
    program that reads both axes and t."""
    return 0.3 * xs[0] - 0.2 * xs[1] * xs[1] + 0.05 + 0.2 * t


def stage_2d_cases(phi, gen):
    """The dense 2D stepper's term lists as ``(name, terms)``: the streamed
    velocity (K1), the rotation (K1'': a component per column and one per
    row) and the vortex (per node), and K1' on D4's terms, a 4-term sum with
    an advection term and streams (reach 3), a frozen eikonal sign, a
    program speed with curvature and an advection program with curvature.
    Random streams have exact zeros (ties)."""
    dev, dtype, g = phi.device, phi.dtype, phi.grid
    vel = 0.5 * torch.randn((2, *phi.shape), generator=gen, device=dev, dtype=dtype)
    vel[0].view(-1)[::7] = 0.0
    speed = torch.randn(phi.shape, generator=gen, device=dev, dtype=dtype)
    speed[:, ::4] = 0.0
    adv = lsm.AdvectionTerm(lsm.MeshField(vel, g))
    return [("K1 streamed", (adv,)),
            ("K1'' rotation", (lsm.AdvectionTerm(rotation2),)),
            ("K1'' vortex", (lsm.AdvectionTerm(shapes.vortex_velocity(period=4.0)),)),
            ("K1' D4", (lsm.CurvatureTerm(-0.05), lsm.NormalMotionTerm(0.2))),
            ("K1' 4-term sum", (lsm.NormalMotionTerm(lsm.MeshField(speed, g)),
                                lsm.CurvatureTerm(-0.05), lsm.EikonalReinitializationTerm(), adv)),
            ("K1' frozen sign", (lsm.EikonalReinitializationTerm.from_initial(phi),)),
            ("K1' program speed", (lsm.NormalMotionTerm(speed2), lsm.CurvatureTerm(-0.01))),
            ("K1' advection program", (lsm.AdvectionTerm(rotation2), lsm.CurvatureTerm(-0.01)))]


def k1_2d_compare(label, st, P, terms, coeffs, aux, where, repeat=False, scale=None):
    """K1's 2D entry (the stepper's route) against its plain version, and its
    per-node form beside it, on the same inputs: ``(max|kernel - plain|,
    scale, max|per node - plain|)`` over the nodes off the curvature's gate
    (GATE_ULPS), within K1_TOL (1e-12 in f64) times ``scale`` (default
    max(|ref|, 1)); the kernel's and the per-node form's bits must be equal
    on every node; ``repeat``: a second launch gives equal bits."""
    sp, shape = st.spacing, st.shape
    run = lambda fn: v2.unpack_padded(fn(P, terms, coeffs, aux, sp, shape, where), shape)
    got, node = run(v2.fused_stage), run(v2.fused_stage_2d_per_node)
    ref = run(v2.stage_plain)
    keep = (~gate_nodes(P, sp, shape) if has_curvature(terms)
            else torch.ones_like(ref, dtype=torch.bool))
    err, own = kinds_err(got, ref, keep)
    scale = own if scale is None else scale
    node_err = kinds_err(node, ref, keep)[0]
    tol = K1_TOL if P.dtype == torch.float32 else 1e-12
    same = bool(torch.equal(got, node))
    again = bool(torch.equal(got, run(v2.fused_stage))) if repeat else True
    if not (bool(torch.isfinite(got).all()) and err <= tol * scale and node_err <= tol * scale
            and same and again):
        raise AssertionError(f"{label}: march {err}, per node {node_err} > {tol} * {scale}, "
                             f"march and per node equal bits {same}, second launch equal "
                             f"{again}")
    return err, scale, node_err


def phase_k1_2d(dev, res):
    """K1's 2D entries (K1, K1', K1'', the 2D march of ``csrc/weno_stage_2d.cu``)
    and their per-node form against the plain 2D stage at K1_2D_SHAPES, f32
    and f64, on the term lists of :func:`stage_2d_cases` through the
    stepper's own entries and routes, each with and without aux; the five BC
    cases on the first shape, two on the others; streams and aux one
    element off their alignment at (40, 72), equal bits to the aligned
    launch."""
    gen = torch.Generator(device=dev).manual_seed(14)
    worst, routes = {}, {}
    for i, shape in enumerate(K1_2D_SHAPES):
        grid = lsm.Grid((0.0, -0.2), (1.0, 1.1), shape)
        bcases = bc_cases_2d() if i == 0 else {k: bc_cases_2d()[k] for k in ("periodic", "mixed")}
        for dtype in (torch.float32, torch.float64):
            rel = {}
            for bname, bcs in bcases.items():
                phi = lsm.MeshField(0.3 * torch.randn(shape, generator=gen, device=dev,
                                                      dtype=dtype), grid, bcs)
                A = v2.pack_padded(torch.randn(shape, generator=gen, device=dev, dtype=dtype), bcs)
                for name, terms in stage_2d_cases(phi, gen):
                    st = FusedStepper(terms, phi, lsm.RK3())
                    routes[name] = st.stage_route
                    P, where = st.pack(phi.values), v2.Where(st.lo, None, T_STAGE)
                    tt = st.stage_terms(T_STAGE)
                    for aux, coeffs in ((None, (0.0, 1.0, 1e-3)), (A, (0.75, 0.25, 2.5e-4))):
                        err, scale, node_err = k1_2d_compare(
                            f"{name} {bname} {shape} {dtype}", st, P, tt, coeffs, aux, where)
                        rel[name] = max(rel.get(name, 0.0), err / scale)
                        if dtype == torch.float32:
                            worst[name] = max(worst.get(name, 0.0), err)
                    if shape == (40, 72) and bname == "periodic" and any(
                            spec.coef_kind == "stream" for spec, _ in tt):
                        mt = tuple((spec, tuple(misaligned(a) for a in arrs)) for spec, arrs in tt)
                        coeffs = (0.75, 0.25, 2.5e-4)
                        out = [v2.unpack_padded(v2.fused_stage(P, w, coeffs, a, st.spacing,
                                                               st.shape, where), st.shape)
                               for w, a in ((tt, A), (mt, misaligned(A)))]
                        log("k1_2d", f"{name} {str(dtype)[6:]} {shape}: streams and aux off "
                                     f"alignment give equal bits: {torch.equal(*out)}")
                        if not torch.equal(*out):
                            raise AssertionError(f"{name}: misaligned inputs change the bits")
            for name, r in rel.items():
                log("k1_2d", f"{name:22s} {str(dtype)[6:]} shape={shape} route {routes[name]!r} "
                             f"{len(bcases)} BC cases, stage and stage+aux: "
                             f"max|kernel-plain|/scale={r:.3e}")
    log("k1_2d", "march and per-node form equal bit for bit on every case (asserted)")
    res["k1_2d_small_err"] = worst
    res["k1_2d_routes"] = routes


def general_run(term, phi, integrator, steps, **kw):
    """``integrate`` of ``steps`` steps on the general path (``kw``: a hook;
    by default one that records ``eq.t``; or ``fast="off"``), counting
    launches: ``(equation, counts, wall s, peak GiB)``."""
    seen = []
    if "posthook" not in kw and kw.get("fast") != "off":
        kw = dict(kw, posthook=lambda e: seen.append(e.t))
    eq = lsm.LevelSetEquation(terms=term, ic=phi, integrator=integrator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eq.integrate(1.0, max_steps=steps, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if seen and not (len(seen) == eq.last_nsteps and seen[-1] == eq.t):
        raise AssertionError("the posthook did not run once per accepted step")
    return eq, read_counts(), wall, torch.cuda.max_memory_allocated() / 2**30


def phase_general_512(dev, res):
    """H: the 512^3 Zalesak RK3 configuration through ``integrate`` with a
    posthook that records ``eq.t``, GENERAL_STEPS steps, counting launches
    (K10 = 3 per step, nothing else); once with ``fast="off"``; once with a
    posthook that reinitializes (band 5h) every REINIT_EVERY steps, timed,
    with | |grad phi| - 1 | near the interface before and after; K10 against
    its plain version on H's inputs (stages 1 and 2, the bare operator)."""
    grid, phi, vel = zalesak(N_MAIN, dev)
    shape, sp, h = grid.shape, grid.spacing, grid.min_spacing
    vol0 = float(lsm.volume(phi))
    term = lsm.AdvectionTerm(vel)
    want = dict(NONE_LAUNCHED, K10=3 * GENERAL_STEPS)
    for label, kw in (("posthook", {}), ('fast="off"', {"fast": "off"})):
        eq, counts, wall, peak = general_run(term, phi, lsm.RK3(), GENERAL_STEPS, **kw)
        rel = abs(float(eq.volume()) - vol0) / vol0
        finite = bool(torch.isfinite(eq.state.values).all())
        log("general_512", f"H {N_MAIN}^3 RK3 {label}: steps={eq.last_nsteps} t={eq.t:.6f} "
                           f"path={eq.last_fast_path} launches={counts} finite={finite} volume "
                           f"rel change {rel:.2e} wall={wall:.3f}s peak_mem={peak:.2f} GiB")
        if not (eq.last_nsteps == GENERAL_STEPS and eq.last_fast_path is None and finite
                and counts == want and rel <= VOL_TOL and tuple(eq.state.values.shape) == shape):
            raise AssertionError(f"H check failed ({label})")
        res.setdefault("general_mem", {})[f"H {label}"] = peak
        del eq
    res["launches"]["K10"] = counts["K10"]
    hooks = []

    def reinit_hook(e):
        if e.last_nsteps % REINIT_EVERY:
            return
        before = eikonal_error(e.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.state = lsm.reinitialize(e.state, band_width=5 * h)
        torch.cuda.synchronize()
        hooks.append((1e3 * (time.perf_counter() - t0), before, eikonal_error(e.state)))

    eq, counts, wall, peak = general_run(term, phi, lsm.RK3(), GENERAL_STEPS,
                                         posthook=reinit_hook)
    for ms, before, after in hooks:
        log("general_512", f"H + reinitialize(band 5h) every {REINIT_EVERY} steps: hook "
                           f"{ms:.1f} ms; | |grad phi| - 1 | over |phi| < 3h: mean "
                           f"{before[0]:.4e} -> {after[0]:.4e}, max {before[1]:.4e} -> "
                           f"{after[1]:.4e}")
    log("general_512", f"H + reinitialize: steps={eq.last_nsteps} launches={counts} "
                       f"wall={wall:.3f}s peak_mem={peak:.2f} GiB")
    if not (len(hooks) == GENERAL_STEPS // REINIT_EVERY and counts == want
            and bool(torch.isfinite(eq.state.values).all())
            and all(math.isfinite(b[0]) and math.isfinite(a[0]) for _, b, a in hooks)):
        raise AssertionError("H with a reinitializing posthook failed")
    res["reinit_hook"] = hooks
    res["general_mem"]["H reinit"] = peak
    del eq
    torch.cuda.empty_cache()
    P = phi.pad(v2.GHOST)
    u = tuple(vel.values[d] for d in range(3))
    dt = 0.5 * float(lsm.compute_cfl((term,), phi, 0.0))
    phi1 = phi.with_values(wg._stage_plain(P, u, None, (0.0, 1.0, dt), sp, shape))
    worst = 0.0
    for label, src, aux, coeffs in (("stage 1", P, None, (0.0, 1.0, dt)),
                                    ("stage 2", phi1.pad(v2.GHOST), phi.values,
                                     (0.75, 0.25, 0.25 * dt)),
                                    ("-u.grad(phi)", P, None, (0.0, 0.0, 1.0))):
        got = wg.weno_stage_3d(src, u, sp, shape, coeffs, aux)
        ref = wg._stage_plain(src, u, aux, coeffs, sp, shape)
        err, scale = general_compare(f"K10 {label} at {N_MAIN}^3", got, ref, K1_TOL)
        log("general_512", f"K10 {label:12s} {N_MAIN}^3 f32 max|kernel-plain|={err:.3e} "
                           f"scale={scale:.3e} tol={K1_TOL:g}*scale")
        worst = max(worst, err)
        del got, ref
    res["k10_err"] = max(res["k10_err"], worst)


def config(name, n, dev, dtype=torch.float32):
    """D1-D4 (configurations 1-4 of ``models.benchmarks``) at ``n^2``; D2h
    is D2, D2s D2 with its velocity sampled on the grid (streamed)."""
    eq = {"D1": lambda: bench.config1_circle_advection(n, dtype=dtype, device=dev)[0],
          "D2": lambda: bench.config2_zalesak(n, dtype=dtype, device=dev),
          "D2h": lambda: bench.config2_zalesak(n, dtype=dtype, device=dev),
          "D2s": lambda: bench.config2_zalesak(n, dtype=dtype, device=dev),
          "D3": lambda: bench.config3_vortex_spiral(n, dtype=dtype, device=dev),
          "D4": lambda: bench.config4_curvature_normal(n, dtype=dtype, device=dev)}[name]()
    if name == "D2s":
        vel = lsm.sample(lambda *xs: rotation2(xs, 0.0), eq.state.grid, dtype=dtype, device=dev,
                         vector=True)
        return (lsm.AdvectionTerm(vel),), eq.state, eq.integrator
    return eq.terms, eq.state, eq.integrator


# the dense 2D stepper's launches per stage: K1's and K2's 2D entries
_ON_2D = {"K1": 1, "K2": 1, "K1 2D": 1, "K2 2D": 1}
TWOD = {  # name: (path, launches per stage, integrate's keyword arguments)
    "D1": (None, {}, {}),
    "D2": ("fused", dict(_ON_2D, **{"K1''": 1}), {}),
    "D2s": ("fused", _ON_2D, {}),
    "D3": ("fused", dict(_ON_2D, **{"K1''": 1}), {}),
    "D4": ("fused", dict(_ON_2D, **{"K1'": 1}), {}),
    "D2h": (None, {"K11": 1}, {"posthook": True}),
}
#: the record key of K1's 2D entry each configuration's stage launches
K1_2D_OF = {"D2s": "K1 2D", "D2": "K1'' 2D", "D3": "K1'' 2D", "D4": "K1' 2D"}


def twod_integrate(name, n, dev, dtype=torch.float32, steps=GENERAL_STEPS):
    """``integrate`` of D1-D4 or D2h, counting launches: ``(equation,
    counts, wall s)``."""
    terms, phi, integ = config(name, n, dev, dtype)
    path, _, kw = TWOD[name]
    seen = []
    kw = {"posthook": lambda e: seen.append(e.t)} if kw else {}
    eq = lsm.LevelSetEquation(terms=terms, ic=phi, integrator=integ)
    if str(dev) != "cpu":
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eq.integrate(1.0, max_steps=steps, **kw)
    if str(dev) != "cpu":
        torch.cuda.synchronize()
    if eq.last_fast_path != path or (kw and len(seen) != eq.last_nsteps):
        raise AssertionError(f"{name} took {eq.last_fast_path}, not {path}")
    return eq, read_counts(), time.perf_counter() - t0


def phase_twod(dev, res):
    """D1-D4, D2s and D2h at N_2D^2 f32 through ``integrate``, GENERAL_STEPS
    steps each, counting launches (D2, D3: K1'' = K1 = K2 = 3 per step, all
    of them K1's and K2's 2D entries on the (n0+6, n1+6) layout, none a
    ``(1, n0, n1)`` one; D2s, D2's velocity streamed: K1's 2D entry; D4:
    K1' too; D2h, D2 with a posthook: K11 = 3 per step; D1, upwind FE:
    none); K1's 2D entries (K1 on D2s, K1'' on D2 and D3, K1' on D4) against
    their plain versions on each one's state at N_2D^2 (the bare operator H
    and H plus aux within K1_TOL * max(|H|, 1), then RK3's stages 1 and 2
    with aux; the per-node form's bits equal to the kernel's, a second
    launch's too), K2's 2D entry bit
    for bit against its plain version and ``pad_ghost`` there, K11 against
    its plain version on D2's inputs; card-vs-CPU trajectories at
    N_2D_SMALL^2 (a gradient through a dense 2D field: the grad_2d phase)."""
    n, steps = N_2D, GENERAL_STEPS
    res.setdefault("k1_2d_err", {})
    for name, (path, per_stage, _) in TWOD.items():
        stages = (1 if name == "D1" else 3) * steps
        eq, counts, wall = twod_integrate(name, n, dev)
        want = dict(NONE_LAUNCHED, **{k: v * stages for k, v in per_stage.items()})
        finite = bool(torch.isfinite(eq.state.values).all())
        log("twod", f"{name} {n}^2 f32: steps={eq.last_nsteps} t={eq.t:.6e} "
                    f"path={eq.last_fast_path} launches={counts} finite={finite} "
                    f"wall={wall:.3f}s")
        if not (eq.last_nsteps == steps and counts == want and finite
                and tuple(eq.state.values.shape) == (n, n)):
            raise AssertionError(f"{name} check failed")
        if name == "D2h":
            res["launches"]["K11"] = counts["K11"]
        if name not in K1_2D_OF:
            continue
        key = K1_2D_OF[name]
        res["launches"][key] = counts["K1 2D"]
        res["launches"]["K2 2D"] = counts["K2 2D"]
        if name == "D4":
            res["launches"]["K1' D4"] = counts["K1'"]
        # the stage on this configuration's state, against its plain version: the
        # bare operator H (alpha, beta, gamma) = (0, 0, 1), so no dt scales an error
        # down, then H plus aux (1, 0, 1), both within K1_TOL * max(|H|, 1); the RK3
        # stages 1 and 2 besides
        stepper = FusedStepper(eq.terms, eq.state, lsm.RK3())
        P = stepper.pack(eq.state.values)
        A = 0.5 * P  # aux: not phi, so reading phi for aux shows
        where = v2.Where(stepper.lo, None, eq.t)
        terms = stepper.stage_terms(eq.t)
        dt = 0.5 * float(stepper.cfl(P, eq.t))
        scale_h = None
        for label, aux, coeffs in (("H", None, (0.0, 0.0, 1.0)), ("H + aux", A, (1.0, 0.0, 1.0)),
                                   ("stage 1", None, (0.0, 1.0, dt)),
                                   ("stage 2", A, (0.75, 0.25, 0.25 * dt))):
            err, scale, node_err = k1_2d_compare(f"{key} on {name} {label}", stepper, P, terms,
                                                 coeffs, aux, where, repeat=True,
                                                 scale=scale_h if label == "H + aux" else None)
            scale_h = scale if label == "H" else scale_h
            log("twod", f"{key} {name} {label:8s} {n}^2 f32 route {stepper.stage_route!r} "
                        f"max|kernel-plain|={err:.3e} scale={scale:.3e} tol={K1_TOL:g}*scale; "
                        f"per-node form {node_err:.3e}, its bits equal to the kernel's; a "
                        f"second launch equal bits")
            res["k1_2d_err"][name] = max(res["k1_2d_err"].get(name, 0.0), err)
            if label.startswith("H"):
                res.setdefault("k1_2d_rel_h", {})[name] = max(
                    res.get("k1_2d_rel_h", {}).get(name, 0.0), err / scale)
        if name == "D2":  # K2's 2D entry on the stage's output
            Q = v2.fused_stage(P, terms, (0.0, 1.0, dt), None, stepper.spacing, stepper.shape,
                               where)
            got = v2.refresh_ghosts_fast(Q.clone(), stepper.bcs, stepper.shape)
            ref = v2.refresh_ghosts_plain(Q.clone(), stepper.bcs, stepper.shape)
            err = float((got - ref).abs().max())
            err_pad = float((got - pad_ghost(v2.unpack_padded(Q, stepper.shape), stepper.bcs,
                                             v2.GHOST)).abs().max())
            log("twod", f"K2 2D on D2's ({n}+6, {n}+6) buffer, periodic: max|kernel-plain|="
                        f"{err:.3e} max|kernel-pad_ghost|={err_pad:.3e}")
            if not err == err_pad == 0.0:
                raise AssertionError(f"K2's 2D entry at {n}^2: {err} / {err_pad}")
            del Q, got, ref
        del stepper, P, A, terms, eq
    # K11 at N_2D^2 on D2's inputs
    terms, phi, _ = config("D2", n, dev)
    sp, shape = phi.spacing, phi.shape
    u = wg._components(terms[0].velocity(phi.grid.coords(dtype=phi.dtype, device=dev), 0.0),
                       shape, phi.values)
    dt = 0.5 * float(lsm.compute_cfl(terms, phi, 0.0))
    P = phi.pad(v2.GHOST)
    phi1 = phi.with_values(wg._stage_plain(P, u, None, (0.0, 1.0, dt), sp, shape))
    worst = 0.0
    for label, src, aux, coeffs in (("stage 1", P, None, (0.0, 1.0, dt)),
                                    ("stage 2", phi1.pad(v2.GHOST), phi.values,
                                     (0.75, 0.25, 0.25 * dt)),
                                    ("-u.grad(phi)", P, None, (0.0, 0.0, 1.0))):
        got = wg.weno_stage_2d(src, u, sp, shape, coeffs, aux)
        ref = wg._stage_plain(src, u, aux, coeffs, sp, shape)
        err, scale = general_compare(f"K11 {label} at {n}^2", got, ref, K1_TOL)
        log("twod", f"K11 {label:12s} {n}^2 f32 max|kernel-plain|={err:.3e} "
                    f"scale={scale:.3e} tol={K1_TOL:g}*scale")
        worst = max(worst, err)
    res["k11_err"] = max(res["k11_err"], worst)
    del P, phi1, u
    torch.cuda.empty_cache()
    twod_card_vs_cpu(dev)


def twod_card_vs_cpu(dev):
    """N_2D_SMALL^2 trajectories of D2, D2s, D3, D4 and D2h, card (kernels)
    against CPU (plain versions), KINDS_SMALL_STEPS steps: f32 within 1e-4 *
    scale, f64 within 1e-10 * scale, equal step counts and paths."""
    for name in ("D2", "D2s", "D3", "D4", "D2h"):
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            out = {where: twod_integrate(name, N_2D_SMALL, where, dtype, KINDS_SMALL_STEPS)[0]
                   for where in ("cpu", dev)}
            a, b = out[dev], out["cpu"]
            scale = max(float(b.state.values.abs().max()), 1.0)
            err = float((a.state.values.cpu() - b.state.values).abs().max())
            log("twod", f"{name} {N_2D_SMALL}^2 {str(dtype)[6:]} x{KINDS_SMALL_STEPS} card vs "
                        f"CPU: paths {a.last_fast_path}/{b.last_fast_path} t {a.t:.6e}/{b.t:.6e} "
                        f"max|card-cpu|={err:.3e} scale={scale:.3e} (tol {tol:g}*scale)")
            if not (a.last_nsteps == b.last_nsteps == KINDS_SMALL_STEPS
                    and math.isclose(a.t, b.t, rel_tol=T_TOL[dtype]) and err <= tol * scale):
                raise AssertionError(f"{name} card-vs-CPU check failed ({dtype})")


# -- the dense 2D gradient: the 2D entries of K4, K3/K3'', K3' and K5 --------------------

GRAD2D_STEPS = 8  # grad2d: RK3 steps of rollout under remat, dt = 0.1 h
GRAD2D_KINDS_STEPS = 3  # grad2d_kinds: configuration 4's terms at a streamed speed
GRAD2D_SMALL_STEPS = 3  # their card-vs-CPU gradients at N_2D_SMALL^2
# the seeded noise on phi0 of those checks, as grad_kinds' torus carries: on
# the bare samples the f64 gradient moves by 1.8e-3 (grad2d) and 6e-4
# (grad2d_kinds, Extrapolation(2)'s minmod ties) of its max under a 1-ulp
# change of phi0 (on the CPU), and the card, which multiplies by 1/h^2 where
# the plain stencils divide, took another subgradient there (4.4e-4 of max on
# an H100); with the noise that spread is 1e-12 of max
GRAD2D_NOISE = 1e-3
#: the 2D stage adjoints' parity shapes: ragged rows, a short axis 0 (3 nodes,
#: Extrapolation), more rows than columns; padded rows past one and two
#: chunks of the 2D marches (65 + 6, 129 + 6: two and three chunks, each
#: march's last step short), padded widths one column past a block of K3 2D
#: (128 columns: 123 + 6) and of K3' 2D (124: 119 + 6), and past two of K3 2D
#: (251 + 6)
BWD_2D_SHAPES = ((67, 131), (40, 72), (3, 40), (130, 33), (65, 123), (129, 119), (129, 251))
#: tie-free BCs for the raw dP of the 2D adjoints (the WENO5 and ENO2 ties of
#: Extrapolation(2): ROADMAP.md queue 3's lessons); a 3-node axis takes Extrapolation(1)
BWD_2D_BCS = {"periodic": lsm.Periodic, "symmetry": lsm.Symmetry,
              "extrap1": lsm.LinearExtrapolation}
#: the f32 K3/K3'' 2D cases of grad2d_parity whose float32 function itself
#: misses the f64 oracle at one output: ``(label, shape, bc name): output``.
#: The f32 input is the f64 buffer rounded, ghosts included. Under
#: Extrapolation(1) a face's last interior difference and its three ghost
#: differences are equal in float64, so a WENO5 sub-stencil of three of them
#: is exactly flat: its smoothness indicator and that indicator's gradient
#: are 0. Rounded they differ by about 1e-5 of their size, and that gradient
#: times WENO5's 1/eps (eps = 1e-6 vmax) is of order one: the float64
#: function on the rounded buffer misses the oracle as far. At (129, 251)
#: the folded dP at node (8, 249), beside the axis-1 face's last node, moves
#: by 1.6 (1.14e-3 of max|dP|; tools/bwd_2d_f32.py takes the case apart).
#: That output is held to the f32 plain version (K3_TOL), its oracle error
#: to at most K3_2D_F32_FACTOR times the plain version's; every other output
#: of the case to the oracle.
K3_2D_F32_VS_PLAIN = {("K3'' rotation", (129, 251), "extrap1"): "dP"}
K3_2D_F32_FACTOR = 1.25
#: the 2D gradient cells at N_2D^2 f32: grad2d (configuration 2, the rotation
#: in-kernel), grad2d_streamed (its velocity sampled on the grid), grad2d_kinds
GRAD2D_CELLS = ("grad2d", "grad2d_streamed", "grad2d_kinds")
# K3's 2D entry: the 3D count's two axes (202 each) and one
K3_2D_OPS_PER_CELL = 2 * 202 + 1
# K3' 2D on grad2d_kinds' terms (curvature + streamed normal motion),
# estimated from the source as K3K_OPS: one Godunov adjoint over two axes (152
# less one axis's ENO2, 40) and its 9 gather weights (4 each); one curvature
# adjoint over two axes (96) and its 9 weights (3 each); the stage terms 4,
# the stream cotangent 2
K3K_OPS_2D = 112 + 9 * 4 + 96 + 9 * 3 + 4 + 2
# the plain versions the 2D cells must not call (module, attribute): the
# wrappers of K1, K2, K3, K3', K4 and K5 look them up per call
PLAIN_VERSIONS = {"K1": (v2, "stage_plain"), "K2": (v2, "refresh_ghosts_plain"),
                  "K3": (bwd, "stage_backward_plain"), "K3'": (bwd, "stage_backward_terms_plain"),
                  "K4": (bwd, "fold_ghost_cotangent_plain"), "K5": (bwd, "zero_pad_shells_plain"),
                  "autograd": (v2, "stage_refresh_plain")}


@contextlib.contextmanager
def plain_calls():
    """Count the calls of the kernels' plain versions while the block runs:
    yields a Counter by :data:`PLAIN_VERSIONS` key."""
    calls, saved = collections.Counter(), {}
    for key, (mod, name) in PLAIN_VERSIONS.items():
        fn = saved[(mod, name)] = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def grad2d_cell(name, n, dev, dtype=torch.float32):
    """A dense 2D gradient cell at ``n^2``: ``(phi, terms_of, s, dt, nsteps)``,
    ``terms_of(s)`` its terms for the speed ``s`` (``None`` but for
    grad2d_kinds). grad2d: configuration 2 (Zalesak disk, the rotation 2 pi
    about (0.5, 0.5) traced in-kernel: K1'' 2D, K3'' 2D), Periodic, dt = 0.1 h,
    GRAD2D_STEPS; grad2d_streamed: its velocity sampled on the grid (K1 2D,
    K3 2D); grad2d_kinds: configuration 4's star on [-1, 1]^2, Extrapolation(2),
    curvature -0.05 and normal motion at the streamed speed 0.2 + 0.05 x (K1'
    2D, K3' 2D), dt half its CFL bound, GRAD2D_KINDS_STEPS."""
    if name == "grad2d_kinds":
        phi = bench.config4_curvature_normal(n, dtype=dtype, device=dev).state
        s = lsm.sample(lambda x, y: 0.2 + 0.05 * x + 0.0 * y, phi.grid, dtype=dtype,
                       device=dev).values

        def terms_of(speed):
            return (lsm.CurvatureTerm(-0.05), lsm.NormalMotionTerm(lsm.MeshField(speed, phi.grid)))

        # the CFL bound in float64 (the same dt on the card and the CPU, either dtype)
        dt = 0.5 * float(lsm.compute_cfl(terms_of(s.double()), phi.with_values(
            phi.values.double()), 0.0))
        return phi, terms_of, s, dt, GRAD2D_KINDS_STEPS
    terms, phi, _ = config("D2" if name == "grad2d" else "D2s", n, dev, dtype)
    return phi, (lambda speed: terms), None, 0.1 * phi.grid.min_spacing, GRAD2D_STEPS


def grad2d_value_and_grad(phi, terms_of, s, dt, nsteps, v, remat=True):
    """``L = sum(phi_final^2)`` of an RK3 ``rollout`` from ``v`` (under
    remat) and its gradient w.r.t. ``v`` (and the speed ``s``)."""
    s = None if s is None else s.detach().clone().requires_grad_()
    out, _ = lsm.rollout(lsm.RK3(), terms_of(s), phi.with_values(v), 0.0, dt, nsteps,
                         remat=remat)
    loss = (out.values ** 2).sum()
    return loss, torch.autograd.grad(loss, (v,) if s is None else (v, s))


def grad2d_launches(name, nsteps):
    """The launches of one value_and_grad of a 2D cell under remat: each
    stage's K1 and K2 twice (the forward, then again in the backward), K4 and
    K3 (K3'') or K3' once, K5 on the later stages' daux; all 2D entries."""
    stages = 3 * nsteps
    k3 = "K3'" if name == "grad2d_kinds" else "K3"
    want = dict(NONE_LAUNCHED, **{"K1": 2 * stages, "K1 2D": 2 * stages, "K2": 2 * stages,
                                  "K2 2D": 2 * stages, k3: stages, f"{k3} 2D": stages,
                                  "K4": stages, "K4 2D": stages, "K5": 2 * nsteps,
                                  "K5 2D": 2 * nsteps})
    want.update({"grad2d": {"K1''": 2 * stages, "K3''": stages},
                 "grad2d_streamed": {}, "grad2d_kinds": {"K1'": 2 * stages}}[name])
    return want


def bwd_2d_outputs(res, bcs, shape, fold):
    """``{name: tensor}`` of a 2D stage adjoint's result ``(dP, du, dcoef,
    daux)``: dP (folded to the interior when ``fold``, else raw), each
    stream cotangent (du0, du1), each entry of dcoef (dcoef0 ..), daux's
    interior."""
    out = {"dP": bwd.fold_ghost_cotangent(res[0].double(), bcs, shape) if fold else res[0]}
    out.update({f"du{k}": d for k, d in enumerate(res[1] or ()) if d is not None})
    out.update({f"dcoef{k}": res[2][k:k + 1] for k in range(len(res[2]))})
    if res[3] is not None:
        out["daux"] = v2.unpack_padded(res[3], shape)
    return out


def bwd_2d_errs(got, ref, bcs, shape, fold):
    """``{output: max|got - ref| / max|ref|}`` over a 2D stage adjoint's
    outputs (:func:`bwd_2d_outputs`)."""
    got, ref = bwd_2d_outputs(got, bcs, shape, fold), bwd_2d_outputs(ref, bcs, shape, fold)
    return {name: rel_err(got[name], ref[name]) for name in ref}


def bwd_2d_cases(phi, gen):
    """The 2D stage adjoints' cases on the field ``phi``: ``{label: (kernel
    name, terms)}``: K3 (a streamed velocity with exact zeros: upwind ties),
    K3'' (the rotation; the vortex, whose stage time takes a cotangent), K3'
    (configuration 4's terms at a streamed speed with exact zeros, the
    eikonal kind's two sign forms, a time-dependent program speed beside a
    streamed curvature, an advection term beside normal motion)."""
    shape, dtype, dev = phi.shape, phi.dtype, phi.values.device
    vel = 0.3 * torch.randn((2, *shape), generator=gen, device=dev, dtype=dtype)
    vel[1, :, ::4] = 0.0
    s = 0.2 + 0.05 * torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    s[:, ::3] = 0.0
    mf = lambda x: lsm.MeshField(x, phi.grid)
    lists = {
        "K3 stream": ("K3 2D", (lsm.AdvectionTerm(mf(vel)),)),
        "K3'' rotation": ("K3'' 2D", (lsm.AdvectionTerm(rotation2),)),
        "K3'' vortex dt": ("K3'' 2D", (lsm.AdvectionTerm(shapes.vortex_velocity(period=4.0)),)),
        "K3' config 4": ("K3' 2D", (lsm.CurvatureTerm(-0.05), lsm.NormalMotionTerm(mf(s)))),
        "K3' eikonal none": ("K3' 2D", (lsm.EikonalReinitializationTerm(),)),
        "K3' eikonal frozen": ("K3' 2D", (lsm.EikonalReinitializationTerm(mf(s)),)),
        "K3' program + dt": ("K3' 2D", (lsm.NormalMotionTerm(
            lambda xs, t: 0.1 + 0.05 * xs[0] + 0.02 * t * xs[1]), lsm.CurvatureTerm(mf(s)))),
        "K3' advection + normal": ("K3' 2D", (lsm.AdvectionTerm(mf(vel)),
                                              lsm.NormalMotionTerm(mf(s)))),
    }
    return {k: (kernel, FusedStepper(terms, phi, lsm.RK3()).entries)
            for k, (kernel, terms) in lists.items()}


def bwd_2d_run(P, terms, coeffs, aux, gf, sp, shape, where, plain=False):
    """One 2D stage adjoint of ``terms`` (K3 or K3'' for one advection
    term, else K3'), or its plain version."""
    if v2.is_advection_only(terms):
        spec, arrs = terms[0]
        u = arrs if spec.coef_kind == "stream" else spec.coef_static
        fn = bwd.stage_backward_plain if plain else bwd.stage_backward
        return fn(P, u, coeffs, aux, gf, sp, shape, where=where, need_dt=True)
    fn = bwd.stage_backward_terms_plain if plain else bwd.stage_backward_terms
    return fn(P, terms, coeffs, aux, gf, sp, shape, where=where, need_dt=True)


def bwd_2d_inputs(dev):
    """The inputs of :func:`grad2d_parity`, drawn in its order from one
    generator seeded 17 on ``dev``: for each ``BWD_2D_SHAPES`` shape and
    ``BWD_2D_BCS`` name (a 3-node axis: extrap1 only) ``(shape, bc name,
    phi64, P64, A64, G64, cases)``: a sampled Zalesak disk with 1e-3 of
    noise, its padded buffer, a padded aux and a padded cotangent, and
    :func:`bwd_2d_cases` on it (float64)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    for shape in BWD_2D_SHAPES:
        grid = lsm.Grid((0.0, 0.0), (1.0, 1.3), shape)
        for bc_name, bc in BWD_2D_BCS.items():
            if min(shape) < 4 and bc_name != "extrap1":
                continue
            phi64 = lsm.sample(shapes.zalesak_disk(), grid, bc(), dtype=torch.float64, device=dev)
            phi64 = phi64.with_values(phi64.values + 1e-3 * torch.randn(
                shape, generator=gen, device=dev, dtype=torch.float64))
            P64 = v2.pack_padded(phi64.values, phi64.bcs)
            A64 = v2.pack_padded(torch.randn(shape, generator=gen, device=dev,
                                             dtype=torch.float64), phi64.bcs)
            G64 = torch.randn(v2.padded_shape(shape), generator=gen, device=dev,
                              dtype=torch.float64)
            yield shape, bc_name, phi64, P64, A64, G64, bwd_2d_cases(phi64, gen)


def grad2d_parity(dev, res):
    """K3/K3''/K3' 2D at BWD_2D_SHAPES under BWD_2D_BCS (a 3-node axis:
    extrap1 only), with and without aux, on a sampled Zalesak disk with a
    little noise: f64 kernel vs f64 plain within 1e-10 (raw dP), f32 kernel
    vs the f64 autograd oracle of the 2D stage and refresh (with float32's
    WENO epsilon floor) within K3_TOL, dP folded to the interior (K3, K3''),
    raw (K3'; under extrap1 against its f32 plain version, K3K_F32_VS_PLAIN;
    the output K3_2D_F32_VS_PLAIN names against its f32 plain version, its
    oracle error within K3_2D_F32_FACTOR of the plain version's); a second
    launch equal bits."""
    worst = collections.defaultdict(float)
    where = v2.Where((0.0, 0.0), None, T_STAGE)
    for shape, bc_name, phi64, P64, A64, G64, cases in bwd_2d_inputs(dev):
        bcs, sp = phi64.bcs, phi64.spacing
        gf64 = bwd.fold_ghost_cotangent_fast(G64, bcs, shape)
        for label, (kernel, terms64) in cases.items():
            terms32 = cast_terms(terms64, torch.float32)
            fold = kernel != "K3' 2D"
            for aux, coeffs in ((None, (0.0, 1.0, 0.03)), (A64, (0.75, 0.25, 0.03))):
                got = bwd_2d_run(P64, terms64, coeffs, aux, gf64, sp, shape, where)
                again = bwd_2d_run(P64, terms64, coeffs, aux, gf64, sp, shape, where)
                ref = bwd_2d_run(P64, terms64, coeffs, aux, gf64, sp, shape, where,
                                 plain=True)
                e64 = max(bwd_2d_errs(got, ref, bcs, shape, fold=False).values())
                same = same_bits(got[0], again[0]) and all(
                    same_bits(a, b) for a, b in zip(got[1] or (), again[1] or ()))
                d = lambda t: None if t is None else t.float()
                got32 = bwd_2d_run(d(P64), terms32, coeffs, d(aux),
                                   bwd.fold_ghost_cotangent_fast(d(G64), bcs, shape), sp,
                                   shape, where)
                plain32 = lambda: bwd_2d_run(
                    d(P64), terms32, coeffs, d(aux),
                    bwd.fold_ghost_cotangent_fast(d(G64), bcs, shape), sp, shape, where,
                    plain=True)
                if kernel == "K3' 2D" and bc_name in K3K_F32_VS_PLAIN:
                    ref32 = plain32()
                    against = "f32 plain"
                else:
                    with f32_weno_floor():
                        ref32 = bwd.composite_backward_autograd(P64, terms64, coeffs, aux,
                                                                G64, bcs, sp, shape, where)
                    against = "f64 oracle"
                errs = bwd_2d_errs(got32, ref32, bcs, shape, fold)
                named = K3_2D_F32_VS_PLAIN.get((label, shape, bc_name))
                if named is not None:
                    # the named output: the f32 function's own conditioning
                    p32 = plain32()
                    e_plain = bwd_2d_errs(p32, ref32, bcs, shape, fold)[named]
                    e_vs_plain = bwd_2d_errs(got32, p32, bcs, shape, fold)[named]
                    ok = e_vs_plain <= K3_TOL and errs[named] <= K3_2D_F32_FACTOR * e_plain
                    log("grad_2d", f"{label:22s} {bc_name:8s} shape={shape} aux={aux is not None}"
                                   f": {named} f32 vs f64 oracle {errs[named]:.2e}, the f32 "
                                   f"plain version's {e_plain:.2e} (at most "
                                   f"{K3_2D_F32_FACTOR:g}x), f32 vs f32 plain {e_vs_plain:.2e} "
                                   f"(tol {K3_TOL:g}): {ok}")
                    if not ok:
                        raise AssertionError(f"{label} at {shape} ({bc_name}): {named} "
                                             f"{errs[named]} / {e_plain} / {e_vs_plain}")
                    errs[named] = e_vs_plain
                    against = f"f64 oracle ({named} vs f32 plain)"
                e32 = max(errs.values())
                log("grad_2d", f"{label:22s} {bc_name:8s} shape={shape} aux={aux is not None}"
                               f": f64 vs plain {e64:.2e} (tol 1e-10), f32 vs {against} "
                               f"{e32:.2e} (tol {K3_TOL:g}), a second launch equal bits {same}")
                if not (e64 <= 1e-10 and e32 <= K3_TOL and same
                        and bool(torch.isfinite(got32[0]).all())):
                    raise AssertionError(f"{label} at {shape} ({bc_name}): {e64} / {e32}")
                worst[kernel] = max(worst[kernel], e32)
                worst[f"{kernel} f64"] = max(worst[f"{kernel} f64"], e64)
    res["k3_2d_rel"] = dict(worst)


N2D_BOX = 64  # the side of the 4096^2 check's sub-boxes of outputs


def _box_start(n, B, m):
    """Padded start of a B-node box of outputs centred on interior node
    ``m`` whose reach (the outputs within 3, and the P their stencils read)
    stays in the interior: no ghost of the grid, so no BC, enters the
    comparison."""
    return min(max(m + 3 - B // 2, 9), n - B - 3)


def grad2d_4096(dev, res):
    """K3'' 2D, K3 2D and K3' 2D at N_2D^2 f32 on the inputs of grad2d,
    grad2d_streamed and grad2d_kinds (the state, its streams and program as
    their stepper packs them): stage 1, and an RK3 stage 2 on stage 1's
    output with aux. Two N2D_BOX^2 boxes of outputs, one on the interface
    and one at the far end of the index range (both clear of the grid's
    ghosts), each against the f64 plain version of the box with its reach
    (float32's WENO epsilon floor, :func:`f32_weno_floor`), within K3_TOL
    relative to the box's max|ref|:
      - with a random folded cotangent on the whole grid: dP, du and daux of
        the box's outputs; every output finite; a second launch equal bits;
      - with that cotangent zeroed off the boxes' outputs: dP, du and daux
        over each box with its reach, and dcoef against the sum of the
        boxes'; every element off the boxes exactly 0.
    ``res["k3_2d_4096"]``: each kernel's worst relative and absolute error."""
    B, n = N2D_BOX, N_2D
    out = {}
    for name in GRAD2D_CELLS:
        kernel = {"grad2d": "K3'' 2D", "grad2d_streamed": "K3 2D",
                  "grad2d_kinds": "K3' 2D"}[name]
        phi, terms_of, s, dt, _ = grad2d_cell(name, n, dev)
        grid, shape, bcs, sp = phi.grid, phi.shape, phi.bcs, phi.spacing
        entries = FusedStepper(terms_of(s), phi, lsm.RK3()).entries
        where = v2.Where(grid.lo)
        P = v2.pack_padded(phi.values, bcs)
        with torch.no_grad():
            P1 = v2.fused_step_stage(P, entries, (0.0, 1.0, dt), None, bcs, sp, shape,
                                     where=where)
        G = torch.randn(v2.padded_shape(shape), generator=torch.Generator(
            device=dev).manual_seed(20), device=dev)
        gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
        del G
        # on the interface along the middle row, and at the far corner
        m = n // 2 + int(phi.values[n // 2, n // 2:].abs().argmin())
        starts = ((_box_start(n, B, n // 2), _box_start(n, B, m)), (n - B - 3,) * 2)
        gm = torch.zeros_like(gf)
        in_p = torch.zeros(v2.padded_shape(shape), dtype=torch.bool, device=dev)
        for a in starts:
            reach = tuple(slice(x - 3, x + B + 3) for x in a)
            gm[reach] = gf[reach]
            in_p[tuple(slice(x - 6, x + B + 6) for x in a)] = True
        in_i = v2.unpack_padded(in_p, shape)
        rel = abs_ = 0.0
        for label, src, aux, coeffs in (("stage 1", P, None, (0.0, 1.0, dt)),
                                        ("RK3 stage 2", P1, P, (0.75, 0.25, 0.25 * dt))):
            call = lambda g=gf: bwd_2d_run(src, entries, coeffs, aux, g, sp, shape, where)
            got = call()
            repeat_check("grad_2d", f"{kernel} {name} {label} {n}^2", call, got)
            outs = [got[0], *(got[1] or ()), got[2]] + ([got[3]] if aux is not None else [])
            finite = all(bool(torch.isfinite(t).all()) for t in outs)
            masked = call(gm)
            pairs, dcoef_ref = [], 0.0
            for a in starts:
                box = tuple(slice(x - 6, x + B + 6) for x in a)
                box_i = tuple(slice(x - 6, x + B) for x in a)  # the box's reach, interior index
                d = lambda t: None if t is None else t[box].double().contiguous()
                sub = tuple((spec, tuple(c[box_i].double().contiguous() for c in arrs))
                            for spec, arrs in entries)
                with f32_weno_floor():
                    ref = bwd_2d_run(d(src), sub, coeffs, d(aux), d(gm), sp, (B + 6,) * 2,
                                     v2.Where(grid.lo, tuple(float(x - 6) for x in a)),
                                     plain=True)
                region = tuple(slice(x, x + B) for x in a)
                region_i = tuple(slice(x - 3, x - 3 + B) for x in a)
                inner_p, inner_i = (slice(6, 6 + B),) * 2, (slice(3, 3 + B),) * 2
                pairs += [(f"dP {a}", got[0][region], ref[0][inner_p]),
                          (f"dP reach {a}", masked[0][box], ref[0])]
                for k, (g1, g2, r) in enumerate(zip(got[1] or (), masked[1] or (), ref[1] or ())):
                    pairs += [(f"du{k} {a}", g1[region_i], r[inner_i]),
                              (f"du{k} reach {a}", g2[box_i], r)]
                if aux is not None:
                    pairs += [(f"daux {a}", got[3][region], ref[3][inner_p]),
                              (f"daux reach {a}", masked[3][box], ref[3])]
                dcoef_ref = dcoef_ref + ref[2]
            pairs += [(f"dcoef{k}", masked[2][k:k + 1], dcoef_ref[k:k + 1])
                      for k in range(len(dcoef_ref))]
            errs = {k: rel_err(g, r) for k, g, r in pairs}
            worst_abs = max(float((g.double() - r).abs().max()) for _, g, r in pairs)
            off = [masked[0][~in_p]] + [t[~in_i] for t in masked[1] or ()] + (
                [masked[3][~in_p]] if aux is not None else [])
            zero_off = not any(bool(t.any()) for t in off)
            w = max(errs.values())
            log("grad_2d", f"{kernel} {name} {label:11s} {n}^2 f32, boxes {B}^2 at {starts}: "
                           f"worst {max(errs, key=errs.get)} {w:.2e}, max|err| {worst_abs:.3e} "
                           f"(tol {K3_TOL:g}); " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()
                                                           if k.startswith("dcoef"))
                           + f"; finite={finite}, 0 off the boxes={zero_off}")
            if not (finite and zero_off and w <= K3_TOL):
                raise AssertionError(f"{kernel} at {n}^2 ({name}, {label}): {errs}, "
                                     f"finite={finite}, zero off the boxes={zero_off}")
            rel, abs_ = max(rel, w), max(abs_, worst_abs)
            del got, masked, outs, off
        out[kernel] = {"rel": rel, "abs": abs_}
        del phi, P, P1, gf, gm, in_p, entries
        torch.cuda.empty_cache()
    res["k3_2d_4096"] = out


#: 3D shapes with an axis of fewer than 4 nodes (axis 0, all three, axis 2)
#: and the Extrapolation degree each takes for K3 and for K3'
SHORT_3D_SHAPES = (((3, 24, 40), 2, 1), ((2, 9, 12), 1, 1), ((24, 40, 3), 2, 1))


def helical(xs, t):
    """:func:`rotation` with a constant axis-2 component 0.3: every axis,
    a short one too, upwinds a nonzero velocity."""
    x, y, z = xs
    zero = 0.0 * (x + y + z)
    return (0.5 - y + zero, x - 0.5 + zero, 0.3 + zero)


def grad2d_short_3d(dev, res):
    """3D fields with an axis of fewer than 4 nodes (SHORT_3D_SHAPES: axis 0
    short, every axis short, axis 2 short): K4 bit for bit against its plain
    version under Extrapolation(1) and (2 where it fits), f32 and f64 (its
    input untouched, again and misaligned equal bits); K3 (the helical
    velocity streamed; dP folded) and K3' (config A's terms; raw dP) in f64
    against their plain versions; a rollout gradient through each field
    (the helical velocity, Extrapolation(2) where it fits) on the card
    against the CPU in f64 (``gradient_reason`` no longer refuses them)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    for shape, deg3, deg3k in SHORT_3D_SHAPES:
        for deg in sorted({deg3, deg3k}):
            bcs = lsm.normalize_bcs(lsm.Extrapolation(deg), 3)
            for dtype in (torch.float32, torch.float64):
                G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
                k4_compare("grad_2d", f"extrap{deg} (3D, short axis)", G, bcs, shape)
        grid = lsm.Grid((0.0, 0.0, 0.0), tuple(0.05 * (n - 1) for n in shape), shape)
        for deg, label in ((deg3, "K3"), (deg3k, "K3'")):
            phi = lsm.sample(shapes.zalesak_sphere(center=tuple(0.025 * (n - 1) for n in shape)),
                             grid, lsm.Extrapolation(deg), dtype=torch.float64, device=dev)
            P = v2.pack_padded(phi.values, phi.bcs)
            G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev,
                            dtype=torch.float64)
            gf = bwd.fold_ghost_cotangent_fast(G, phi.bcs, shape)
            if label == "K3":  # the helical velocity evaluated into streams
                xs = v2.node_coords(shape, grid.spacing, grid.lo, torch.float64, dev)
                entries = ((v2.ADVECTION, v2.eval_components(helical(xs, 0.0), shape,
                                                             torch.float64, dev)),)
            else:
                entries = FusedStepper(a_terms(), phi, lsm.RK3()).entries
            args = (P, entries, (0.75, 0.25, 0.01), P, gf, grid.spacing, shape, v2.Where())
            got, ref = bwd_2d_run(*args), bwd_2d_run(*args, plain=True)
            err = max(bwd_2d_errs(got, ref, phi.bcs, shape, fold=label == "K3").values())
            log("grad_2d", f"{label} 3D f64 shape={shape} Extrapolation({deg}) kernel vs plain "
                           f"{err:.2e} (tol 1e-10)")
            if not err <= 1e-10:
                raise AssertionError(f"{label} on a short 3D axis at {shape}: {err}")
        grads = {}
        for where in (dev, "cpu"):
            phi = lsm.sample(shapes.zalesak_sphere(center=tuple(0.025 * (n - 1) for n in shape)),
                             grid, lsm.Extrapolation(deg3), dtype=torch.float64, device=where)
            v = phi.values.clone().requires_grad_()
            out, _ = lsm.rollout(lsm.RK3(), (lsm.AdvectionTerm(helical),), phi.with_values(v),
                                 0.0, 0.1 * grid.min_spacing, 2, remat=True)
            grads[where] = torch.autograd.grad((out.values ** 2).sum(), v)[0].cpu()
        err, scale = float((grads[dev] - grads["cpu"]).abs().max()), float(
            grads["cpu"].abs().max())
        log("grad_2d", f"rollout gradient through a {shape} field (Extrapolation({deg3})) f64 "
                       f"card vs CPU: max|diff|={err:.3e} scale={scale:.3e} (tol 1e-10*scale)")
        if not err <= 1e-10 * scale:
            raise AssertionError(f"the short-axis 3D gradient at {shape}: {err}")


def grad2d_card_vs_cpu(dev, res):
    """The three 2D cells' gradients at N_2D_SMALL^2, GRAD2D_SMALL_STEPS
    steps, phi0 with GRAD2D_NOISE of seeded noise, card (kernels) against
    CPU (plain versions): f64 max norm within 1e-10 * scale; f32 relative L2
    within F32_L2_FACTOR times the CPU's own L2 spread under a 1-ulp change
    of phi0 (the max norm reported)."""
    out = {}
    for name in GRAD2D_CELLS:
        diffs, cpu = {}, {}
        for dtype in (torch.float32, torch.float64):
            g = {}
            for where in (dev, "cpu"):
                phi, terms_of, s, dt, _ = grad2d_cell(name, N_2D_SMALL, where, dtype)
                noise = GRAD2D_NOISE * torch.randn(phi.shape, generator=torch.Generator(
                    ).manual_seed(19), dtype=torch.float64)
                v = phi.values + noise.to(where, dtype)
                g[where] = [x.cpu() for x in grad2d_value_and_grad(
                    phi, terms_of, s, dt, GRAD2D_SMALL_STEPS, v.requires_grad_())[1]]
                if where == "cpu":
                    cpu[dtype] = (phi, terms_of, s, dt, v.detach())
            diffs[dtype] = [(float((a - b).abs().max()), float(b.abs().max()), rel_l2(a, b))
                            for a, b in zip(g[dev], g["cpu"])]
            cpu[dtype] = cpu[dtype] + (g["cpu"],)
        phi, terms_of, s, dt, v32, g32 = cpu[torch.float32]
        pert = v32 * (1 + 2.0 ** -23 * torch.randn(phi.shape, generator=torch.Generator(
            ).manual_seed(12)))
        g_pert = grad2d_value_and_grad(phi, terms_of, s, dt, GRAD2D_SMALL_STEPS,
                                       pert.requires_grad_())[1]
        spread = [rel_l2(a, b) for a, b in zip(g_pert, g32)]
        ok = all(e <= 1e-10 * sc for e, sc, _ in diffs[torch.float64]) and all(
            l2 <= F32_L2_FACTOR * sp for (_, _, l2), sp in zip(diffs[torch.float32], spread))
        log("grad_2d", f"{name} {N_2D_SMALL}^2 x{GRAD2D_SMALL_STEPS} card vs CPU (d/dphi0"
                       f"{', d/dspeed' if s is not None else ''}): f64 " + ", ".join(
                           f"max|diff|={e:.3e} scale={sc:.3e}" for e, sc, _ in
                           diffs[torch.float64]) + " (tol 1e-10*scale); f32 " + ", ".join(
                           f"max|diff|={e:.3e} relative L2 {l2:.3e} (tol {F32_L2_FACTOR:g}x "
                           f"{sp:.3e})" for (e, _, l2), sp in zip(diffs[torch.float32], spread)))
        if not ok:
            raise AssertionError(f"{name}: the 2D gradient card vs CPU failed")
        out[name] = {"f64": diffs[torch.float64], "f32": diffs[torch.float32], "spread": spread}
    res["grad2d_small"] = out


def phase_grad_2d(dev, res):
    """The dense 2D gradient on the card (this slice's main path): K4 and K5
    2D bit for bit against their plain versions at K2_2D_SHAPES (and a
    3-node axis) under the BC cases of k2_small, f32 and f64; K3/K3''/K3' 2D
    (:func:`grad2d_parity`) and at N_2D^2 (:func:`grad2d_4096`); 3D fields
    with a short axis (:func:`grad2d_short_3d`); Extrapolation(3) on an axis of 3 nodes raising
    ValueError, as in JAX; the cells' gradients card vs CPU at N_2D_SMALL^2
    (:func:`grad2d_card_vs_cpu`); then grad2d (in-kernel and streamed) and
    grad2d_kinds at N_2D^2 f32: launches of one value_and_grad (every one a
    2D entry, no plain version called), ms per value_and_grad (CUDA-event
    median), peak memory; the kernels' device times, their plain versions
    and the plain-autograd yardstick from ``tools/grad_2d.py`` in a process
    of its own."""
    gen = torch.Generator(device=dev).manual_seed(16)
    E = lsm.Extrapolation
    worst = 0.0
    for shape in K2_2D_SHAPES + ((3, 40),):
        cases = general_bcs(2)
        if shape[0] == N_2D:
            cases = {k: cases[k] for k in ("periodic", "mixed")}
        if shape[0] < 4:
            cases = {"extrap0": cases["extrap0"], "extrap2": cases["extrap2"],
                     "short": lsm.normalize_bcs([(E(1), E(2)), lsm.Periodic()], 2)}
        for dtype in (torch.float32, torch.float64):
            for name, bcs in cases.items():
                G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
                reset_counts()
                worst = max(worst, k4_compare("grad_2d", f"2D {name}", G, bcs, shape,
                                              autograd=shape[0] != N_2D))
                z = bwd.zero_pad_shells(G.clone(), shape)
                counts = read_counts()
                same = bool(torch.equal(z, bwd.zero_pad_shells_plain(G.clone(), shape)))
                if not (same and counts["K4 2D"] == counts["K4"] == 3
                        and counts["K5 2D"] == counts["K5"] == 1):
                    raise AssertionError(f"K5 2D or the 2D launch counts at {shape}: {same}, "
                                         f"{counts}")
                del G, z
    log("grad_2d", "K5 2D == plain at every shape and case; K4 2D and K5 2D counted apart")
    res["k4_2d_err"], res["k5_2d_err"] = worst, 0.0
    grad2d_parity(dev, res)
    grad2d_4096(dev, res)
    grad2d_short_3d(dev, res)
    # Extrapolation(3) on an axis of 3 nodes: JAX's ValueError, not a pending port
    grid = lsm.Grid((0.0, 0.0), (1.0, 1.0), (3, 40))
    phi = lsm.MeshField(torch.zeros(3, 40, device=dev), grid, E(3))
    try:
        lsm.LevelSetEquation(terms=lsm.AdvectionTerm(rotation2), ic=phi).integrate(
            0.1, max_steps=1)
        raised = None
    except ValueError as e:
        raised = str(e)
    log("grad_2d", f"Extrapolation(3) on an axis of 3 nodes on the card: ValueError {raised!r}")
    if raised is None or "needs 4 nodes" not in raised:
        raise AssertionError("Extrapolation(3) on 3 nodes did not raise JAX's ValueError")
    grad2d_card_vs_cpu(dev, res)
    # the cells at N_2D^2: launches, ms per value_and_grad, peak memory
    res.setdefault("grad2d", {})
    for name in GRAD2D_CELLS:
        phi, terms_of, s, dt, nsteps = grad2d_cell(name, N_2D, dev)
        call = lambda: grad2d_value_and_grad(phi, terms_of, s, dt, nsteps,
                                             phi.values.clone().requires_grad_())
        loss, grads = call()  # warm: builds, tables
        torch.cuda.synchronize()
        reset_counts()
        with plain_calls() as plain:
            loss, grads = call()
            torch.cuda.synchronize()
        counts, want = read_counts(), grad2d_launches(name, nsteps)
        finite = math.isfinite(float(loss.detach())) and all(bool(torch.isfinite(g).all()) for g in grads)
        ms = cuda_time(call, warmup=1, reps=5)
        mem = peak_gib(call)
        log("grad_2d", f"{name} {N_2D}^2 f32 RK3 x{nsteps} remat value_and_grad: loss "
                       f"{float(loss):.6e} max|dphi0|={float(grads[0].abs().max()):.3e} "
                       f"finite={finite}, median {ms:.3f} ms, peak {mem:.3f} GiB; launches "
                       f"{counts} (expected {want}); plain versions called {dict(plain)}")
        if not (finite and counts == want and sum(plain.values()) == 0):
            raise AssertionError(f"{name}: launches {counts} or plain calls {dict(plain)}")
        res["grad2d"][name] = {"ms": ms, "peak_gib": mem, "launches": counts}
        key = {"grad2d": ("K3'' 2D", "K3''"), "grad2d_streamed": ("K3 2D", "K3 2D"),
               "grad2d_kinds": ("K3' 2D", "K3' 2D")}[name]
        res["launches"][key[0]] = counts[key[1]]
        if name == "grad2d":
            res["launches"]["K4 2D"], res["launches"]["K5 2D"] = counts["K4 2D"], counts["K5 2D"]
        del phi, grads, call
        torch.cuda.empty_cache()
    grad2d_device(res)


def grad2d_device(res):
    """The 2D backward kernels' times at N_2D^2 f32 (CUDA-event medians and
    the profiler's device times), their plain versions', the library calls
    beside K4 and K5, and the plain-autograd yardstick of each cell, from
    ``tools/grad_2d.py`` in a process of its own (``res["t"]``; every
    reading in ``res["grad2d_tool"]``)."""
    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, "tools/grad_2d.py", "smoke"], capture_output=True,
                         text=True, check=True, timeout=900).stdout
    line = next(x for x in out.splitlines() if x.startswith("GRAD2D smoke"))
    vals = line.split()[2:]
    tool = {k: float(v) for k, v in zip(vals[::2], vals[1::2])}
    res["grad2d_tool"] = tool
    res["t"].update({k: v for k, v in tool.items() if k.startswith(("K3", "K4", "K5"))})
    log("grad_2d", "tools/grad_2d.py: " + " ".join(f"{k} {v:.4f}" for k, v in tool.items()))


def phase_general_small(dev, res):
    """Card (kernels) against CPU (plain versions): H at N_SMALL^3 with a
    posthook, and the off-axis sphere band with a posthook (the general path,
    re-tubed every step), f32 within 1e-4 * scale and f64 within 1e-10 *
    scale, band masks equal in f64; ``reinitialize`` (band 5h) on config B's
    torus in f64; the general path's gradient, ``rollout(RK3,
    fast="off")`` at GRAD_GENERAL_N^3 f64 w.r.t. phi and the streamed
    velocity, K10 launches counted in its forward."""
    cases = {
        "H": (lambda where, dt: zalesak(N_SMALL, where, dt)[1],
              lambda phi: lsm.AdvectionTerm(rotation)),
        "band": (lambda where, dt: sphere_band(N_SMALL, where, dt, center=(0.5, 0.0, 0.0),
                                               radius=0.4), lambda phi: lsm.AdvectionTerm(spin)),
    }
    for name, (make, term_of) in cases.items():
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            out = {}
            for where in ("cpu", dev):
                phi = make(where, dtype)
                eq = lsm.LevelSetEquation(terms=term_of(phi), ic=phi, integrator=lsm.RK3())
                eq.integrate(1.0, max_steps=KINDS_SMALL_STEPS, posthook=lambda e: None)
                out[where] = eq
            a, b = out[dev], out["cpu"]
            if name == "band":
                err, scale, dmask, dcmask = band_diff(a.state, b.state)
            else:
                err, dmask, dcmask = float((a.state.values.cpu() - b.state.values).abs().max()), 0, 0
                scale = max(float(b.state.values.abs().max()), 1.0)
            log("general_small", f"{name} {N_SMALL}^3 {str(dtype)[6:]} RK3 x{KINDS_SMALL_STEPS} "
                                 f"posthook, card vs CPU: paths {a.last_fast_path}/"
                                 f"{b.last_fast_path} max|card-cpu|={err:.3e} scale={scale:.3e} "
                                 f"(tol {tol:g}*scale) mask mismatches {dmask} (compute {dcmask})")
            masks_ok = dtype == torch.float32 or dmask == dcmask == 0
            if not (a.last_nsteps == b.last_nsteps == KINDS_SMALL_STEPS
                    and math.isclose(a.t, b.t, rel_tol=T_TOL[dtype])
                    and a.last_fast_path is None and masks_ok and err <= tol * scale):
                raise AssertionError(f"{name} card-vs-CPU check failed ({dtype})")
    outs = {}
    for where in ("cpu", dev):
        phi = torus_field(N_SMALL, where, torch.float64, wavy=True)
        outs[where] = lsm.reinitialize(phi, band_width=5 * phi.grid.min_spacing).values
    err = float((outs[dev].cpu() - outs["cpu"]).abs().max())
    scale = max(float(outs["cpu"].abs().max()), 1.0)
    log("general_small", f"reinitialize(band 5h) {N_SMALL}^3 f64 card vs CPU: "
                         f"max|diff|={err:.3e} scale={scale:.3e} (tol 1e-10*scale)")
    if not err <= 1e-10 * scale:
        raise AssertionError("reinitialize card-vs-CPU check failed")
    grads, counts = {}, None
    for where in ("cpu", dev):
        grid, phi, vel = zalesak(GRAD_GENERAL_N, where, torch.float64)
        v = phi.values.clone().requires_grad_()
        u = vel.values.clone().requires_grad_()
        dt = 0.25 * grid.min_spacing
        reset_counts()
        out, _ = lsm.rollout(lsm.RK3(), (lsm.AdvectionTerm(lsm.MeshField(u, grid)),),
                             phi.with_values(v), 0.0, dt, 3, remat=False, fast="off")
        if where != "cpu":
            torch.cuda.synchronize()
            counts = read_counts()
        grads[where] = torch.autograd.grad((out.values ** 2).sum(), (v, u))
    errs = [(float((g.cpu() - c).abs().max()), max(float(c.abs().max()), 1.0))
            for g, c in zip(grads[dev], grads["cpu"])]
    want = dict(NONE_LAUNCHED, K10=9)
    log("general_small", f"rollout(RK3, fast='off') x3 {GRAD_GENERAL_N}^3 f64 gradient card vs "
                         f"CPU: dphi {errs[0][0]:.3e} (scale {errs[0][1]:.3e}), du {errs[1][0]:.3e} "
                         f"(scale {errs[1][1]:.3e}), tol 1e-10*scale; forward launches {counts}")
    if not (counts == want and all(e <= 1e-10 * s for e, s in errs)):
        raise AssertionError("the general path's gradient check failed")
    res["general_grad"] = errs


def phase_general_timing(dev, res):
    """CUDA-event medians: K10 at 512^3 on H's stage inputs (with and
    without aux) and its plain version, K11 at N_2D^2 on D2's; ``integrate``
    ms per step of H with a light posthook, with ``fast="off"`` and on the
    fused path, and of D1-D4 and D2h; peak memory of each; then K11's and
    K7's device times from a process of its own (:func:`general_band_device`)."""
    t, mem, n = res["t"], {}, N_MAIN
    grid, phi, vel = zalesak(n, dev)
    sp, shape = grid.spacing, grid.shape
    term = lsm.AdvectionTerm(vel)
    P = phi.pad(v2.GHOST)
    u = tuple(vel.values[d] for d in range(3))
    dt = 0.5 * float(lsm.compute_cfl((term,), phi, 0.0))
    t["K10"] = cuda_time(lambda: wg.weno_stage_3d(P, u, sp, shape, (0.0, 1.0, dt)))
    t["K10_aux"] = cuda_time(lambda: wg.weno_stage_3d(P, u, sp, shape, (0.75, 0.25, dt),
                                                      phi.values))
    t["K10_plain"] = cuda_time(lambda: wg._stage_plain(P, u, None, (0.0, 1.0, dt), sp, shape),
                               warmup=1, reps=5)
    del P
    for key, kw, path in (("H_integrate", {"posthook": lambda e: None}, None),
                          ("H_off_integrate", {"fast": "off"}, None),
                          ("H_fused_integrate", {}, "fused")):
        t[key] = integrate_ms_per_step(term, phi, lsm.RK3(), path=path, **kw)
        mem[key] = peak_gib(lambda: lsm.LevelSetEquation(
            terms=term, ic=phi, integrator=lsm.RK3()).integrate(1.0, max_steps=10, **kw))
    del grid, phi, vel, term, u
    torch.cuda.empty_cache()
    terms, phi2, _ = config("D2", N_2D, dev)
    sp2, shape2 = phi2.spacing, phi2.shape
    u2 = wg._components(terms[0].velocity(phi2.grid.coords(dtype=phi2.dtype, device=dev), 0.0),
                        shape2, phi2.values)
    P2 = phi2.pad(v2.GHOST)
    dt2 = 0.5 * float(lsm.compute_cfl(terms, phi2, 0.0))
    t["K11"] = cuda_time(lambda: wg.weno_stage_2d(P2, u2, sp2, shape2, (0.0, 1.0, dt2)))
    t["K11_aux"] = cuda_time(lambda: wg.weno_stage_2d(P2, u2, sp2, shape2, (0.75, 0.25, dt2),
                                                      phi2.values))
    t["K11_plain"] = cuda_time(lambda: wg._stage_plain(P2, u2, None, (0.0, 1.0, dt2), sp2,
                                                       shape2), warmup=1, reps=5)
    del P2, u2, phi2, terms
    timing_2d(dev, res)
    for name, (path, _, kw) in TWOD.items():
        terms, phi, integ = config(name, N_2D, dev)
        kw = {"posthook": lambda e: None} if kw else {}
        t[f"{name}_integrate"] = integrate_ms_per_step(terms, phi, integ, path=path, **kw)
        mem[f"{name}_integrate"] = peak_gib(lambda: lsm.LevelSetEquation(
            terms=terms, ic=phi, integrator=integ).integrate(1.0, max_steps=10, **kw))
    for name in [k for k in t if k.startswith(("K10", "K11", "H_", "D"))]:
        where = f"{N_2D}^2" if name.startswith(("K11", "D")) else f"{n}^3"
        log("general_timing", f"{where} f32 {name:18s} median {t[name]:.4f} ms")
    log("general_timing", "peak memory: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in mem.items()))
    res["mem"].update(mem)
    general_band_device(res)


def general_band_device(res):
    """K11's and K7's device times (K11 at N_2D^2 on D2h's inputs, with and
    without aux; K7 at 512^3 on the band cells' buffer and its 2D entry on
    D2b's, flags on and off) and their times a call back to back, from
    ``tools/general_band.py`` in a process of its own (``res["t"]``: each
    ``<call>_device`` and ``<call>_b2b``)."""
    torch.cuda.empty_cache()  # the cached blocks of the phases before, for the child
    out = subprocess.run([sys.executable, "tools/general_band.py", "smoke"], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    line = next(x for x in out.splitlines() if x.startswith("GENBAND smoke"))
    vals = line.split()[2:]
    tool = {k: float(v) for k, v in zip(vals[::2], vals[1::2])}
    res["t"].update({k: v for k, v in tool.items() if k.endswith(("_device", "_b2b"))})
    log("general_timing", "tools/general_band.py: " + " ".join(
        f"{k} {v:.4f}" for k, v in tool.items()))


def timing_2d(dev, res):
    """CUDA-event medians at N_2D^2 f32 of K1's 2D entries on each
    configuration's stage-1 inputs (K1 on D2s, K1'' on D2 and D3, K1' on D4;
    without and with aux), their per-node form and their plain versions,
    and of K2's 2D entry on D2's buffer beside its plain version; each
    program's work for the bounds."""
    t, work = res["t"], {}
    for name, key in (("D2s", "K1_2d"), ("D2", "K1pp_2d_rotation"), ("D3", "K1pp_2d_vortex"),
                      ("D4", "K1k_2d_D4")):
        terms, phi, integ = config(name, N_2D, dev)
        st = FusedStepper(terms, phi, integ)
        P, where = st.pack(phi.values), v2.Where(st.lo, None, 0.0)
        tt = st.stage_terms(0.0)
        dt = 0.5 * float(st.cfl(P, 0.0))
        args = (st.spacing, st.shape, where)
        t[key] = cuda_time(lambda: v2.fused_stage(P, tt, (0.0, 1.0, dt), None, *args))
        t[f"{key}_aux"] = cuda_time(lambda: v2.fused_stage(P, tt, (0.75, 0.25, dt), P, *args))
        t[f"{key}_per_node"] = cuda_time(lambda: v2.fused_stage_2d_per_node(
            P, tt, (0.0, 1.0, dt), None, *args))
        t[f"{key}_plain"] = cuda_time(lambda: v2.stage_plain(P, tt, (0.0, 1.0, dt), None, *args),
                                      warmup=1, reps=5)
        progs = [spec.coef_static for spec, _ in tt if spec.coef_kind == "program"]
        if progs:
            work[name] = program_work(progs[0], (1, *st.shape))
        if name == "D2":
            t["K2_2d"] = cuda_time(lambda: v2.refresh_ghosts_fast(P, st.bcs, st.shape))
            t["K2_2d_plain"] = cuda_time(lambda: v2.refresh_ghosts_plain(P, st.bcs, st.shape),
                                         warmup=1, reps=5)
        del st, P, tt, phi, terms
        torch.cuda.empty_cache()
    res["k1_2d_work"] = work
    for name in [k for k in t if k.startswith(("K1_2d", "K1pp_2d", "K1k_2d", "K2_2d"))]:
        log("general_timing", f"{N_2D}^2 f32 {name:26s} median {t[name]:.4f} ms")


def phase_revolution(dev, res):
    """D2 at N_2D_SMALL^2 f32 through one full revolution (t = 1), on the
    card and on the CPU: the relative area loss of each, equal step counts,
    and the two losses within 1e-3 of each other."""
    out = {}
    threads = torch.get_num_threads()
    for where in (dev, "cpu"):
        # at 256^2 the CPU's steps are many small ops: one thread runs them fastest
        torch.set_num_threads(1 if where == "cpu" else threads)
        terms, phi, integ = config("D2", N_2D_SMALL, where)
        eq = lsm.LevelSetEquation(terms=terms, ic=phi, integrator=integ)
        a0 = float(eq.volume())
        t0 = time.perf_counter()
        eq.integrate(1.0)
        wall = time.perf_counter() - t0
        out[where] = ((a0 - float(eq.volume())) / a0, eq.last_nsteps, wall,
                      bool(torch.isfinite(eq.state.values).all()))
    torch.set_num_threads(threads)
    (lc, nc, wc, fc), (lp, np_, wp, fp) = out[dev], out["cpu"]
    log("revolution", f"D2 {N_2D_SMALL}^2 f32 one revolution: area loss card {lc:.6e} "
                      f"({nc} steps, {wc:.1f} s) CPU {lp:.6e} ({np_} steps, {wp:.1f} s)")
    if not (fc and fp and nc == np_ and abs(lc - lp) <= 1e-3):
        raise AssertionError("the revolution check failed")
    res["revolution"] = (lc, lp, nc)


def phase_timing(dev, res):
    n = N_MAIN
    grid, phi, vel = zalesak(n, dev)
    term = lsm.AdvectionTerm(vel)
    cells = n ** 3
    shape, sp, bcs = grid.shape, grid.spacing, phi.bcs
    dt = 0.5 * float(lsm.compute_cfl((term,), phi, 0.0))
    fe = FusedStepper(term, phi, lsm.ForwardEuler())
    rk3 = FusedStepper(term, phi, lsm.RK3())
    P = fe.pack(phi.values)
    u = fe.stage_terms(0.0)[0][1]
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t["K1"] = cuda_time(lambda: v2.fused_stage(P, u, (0.0, 1.0, dt), None, sp, shape))
    t["K1_aux"] = cuda_time(lambda: v2.fused_stage(P, u, (0.75, 0.25, dt), P, sp, shape))
    t["K2"] = cuda_time(lambda: v2.refresh_ghosts_fast(P, bcs, shape))
    t["K2_back_to_back"] = back_to_back_ms(lambda: v2.refresh_ghosts_fast(P, bcs, shape))
    t["FE_step"] = cuda_time(lambda: fe.step(P, 0.0, dt))
    t["RK3_step"] = cuda_time(lambda: rk3.step(P, 0.0, dt))
    t["FE_integrate"] = integrate_ms_per_step(term, phi, lsm.ForwardEuler())
    t["RK3_integrate"] = integrate_ms_per_step(term, phi, lsm.RK3())
    kernel_peak = torch.cuda.max_memory_allocated()
    src = torch.empty(2**28, device=dev)  # 1 GiB, 20x the 50 MB L2
    dst = torch.empty_like(src)
    t["copy_1GiB"] = cuda_time(lambda: dst.copy_(src))
    del src, dst
    torch.cuda.reset_peak_memory_stats()
    t["K1_plain"] = cuda_time(lambda: v2.stage_plain(P, u, (0.0, 1.0, dt), None, sp, shape),
                              warmup=1)
    t["K2_plain"] = cuda_time(lambda: v2.refresh_ghosts_plain(P, bcs, shape), warmup=1)
    plain_fe = PlainStepper(term, phi, lsm.ForwardEuler())
    plain_rk3 = PlainStepper(term, phi, lsm.RK3())
    t["FE_step_plain"] = cuda_time(lambda: plain_fe.step(P, 0.0, dt), warmup=1)
    t["RK3_step_plain"] = cuda_time(lambda: plain_rk3.step(P, 0.0, dt), warmup=1)
    plain_peak = torch.cuda.max_memory_allocated()
    for name, ms in t.items():
        steps_like = name.split("_")[0] in ("K1", "FE", "RK3")
        rate = f" {cells / (ms * 1e-3) / 1e9:.3f} G cell-updates/s" if steps_like else ""
        log("timing", f"{n}^3 f32 {name:14s} median {ms:.4f} ms{rate}")
    log("timing", f"device copy bandwidth {2 * 2**30 / (t['copy_1GiB'] * 1e-3) / 1e12:.3f} "
                  f"TB/s (read + write of 1 GiB)")
    log("timing", f"peak memory: kernels {kernel_peak / 2**30:.2f} GiB, "
                  f"plain {plain_peak / 2**30:.2f} GiB")
    del fe, rk3, plain_fe, plain_rk3
    res["t"].update(t)  # beside the times of the phases before it
    timing_backward(dev, res, grid, phi, vel, P, u, dt)


def peak_gib(fn, reps=1):
    """Peak device memory (GiB) over ``reps`` calls of ``fn``, from a reset."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def plain_backward_size(n, tensors):
    """The grid the plain backward is timed at: ``n`` when ``tensors``
    interior-sized f32 buffers fit in the free device memory, else
    ``N_PLAIN_BWD``."""
    free, _ = torch.cuda.mem_get_info()
    return n if tensors * 4 * n ** 3 < 0.8 * free else N_PLAIN_BWD


def timing_backward(dev, res, grid, phi, vel, P, u, dt):
    """K3, K4 and K5 alone, the two gradient cells end to end, and the plain
    backward, at the main path's shape; peak memory of each."""
    n, t, mem = N_MAIN, res["t"], {}
    shape, sp, bcs = grid.shape, grid.spacing, phi.bcs
    G = torch.randn(v2.padded_shape(shape), generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev)
    gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
    coeffs = (0.0, 1.0, dt)
    t["K3"] = cuda_time(lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape))
    t["K3_aux"] = cuda_time(lambda: bwd.stage_backward(P, u, (0.75, 0.25, dt), P, gf, sp,
                                                       shape))
    mem["K3"] = peak_gib(lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape))
    # K4 beside g.clone() of the same buffer, its copy floor (the port calls no clone)
    for key, fn in (("K4", lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape)),
                    ("K4_clone", lambda: G.clone())):
        t[key] = cuda_time(fn)
        t[f"{key}_back_to_back"] = back_to_back_ms(fn)
    shells_device(res)
    t["K5"] = cuda_time(lambda: bwd.zero_pad_shells(G, shape))
    mask = shell_mask(shape, dev)
    t["K5_library"] = cuda_time(lambda: G.masked_fill_(mask, 0.0))
    # the whole 32-byte sectors K5 writes (its seams of 24 B straddle them)
    res["k5_sector_bytes"] = 32 * torch.unique(mask.view(-1).nonzero().view(-1) * 4 // 32).numel()
    del mask
    t["K4_plain"] = cuda_time(lambda: bwd.fold_ghost_cotangent_plain(G, bcs, shape), warmup=1)
    t["K5_plain"] = cuda_time(lambda: bwd.zero_pad_shells_plain(G, shape), warmup=1)
    del G
    # cell (a): value_and_grad of one FE step, streamed (grads w.r.t. phi and
    # the 3 components) and callable (w.r.t. phi)
    velv = vel.values.clone().requires_grad_()
    phiv = phi.values.clone().requires_grad_()
    stream_c = FusedStepper(lsm.AdvectionTerm(rotation), phi,
                            lsm.ForwardEuler()).stage_terms(0.0)  # the program (K1'', K3'')
    dt_a = 0.25 * grid.min_spacing

    def cell_a_streamed():
        loss = fe_grad_loss(phiv, tuple(velv[d] for d in range(3)), bcs, sp, shape, dt_a)
        return torch.autograd.grad(loss, (phiv, velv))

    def cell_a_callable():
        return torch.autograd.grad(fe_grad_loss(phiv, stream_c, bcs, sp, shape, dt_a, grid.lo),
                                   phiv)

    t["cellA_streamed"] = cuda_time(cell_a_streamed, reps=10)
    mem["cellA_streamed"] = peak_gib(cell_a_streamed)
    t["cellA_callable"] = cuda_time(cell_a_callable, reps=10)
    mem["cellA_callable"] = peak_gib(cell_a_callable)
    del velv, stream_c
    # cell (b): value_and_grad of the 20-step RK3 rollout under remat, per step

    def cell_b():
        return rollout_grad(phi, phiv, dt_a, ROLLOUT_STEPS, remat=True)

    t["cellB_per_step"] = cuda_time(cell_b, warmup=1, reps=10) / ROLLOUT_STEPS
    mem["cellB"] = peak_gib(cell_b)
    del phiv
    # the plain backward (K3's plain version, then the autograd oracle of
    # stage + refresh): at n^3 when it fits, else at N_PLAIN_BWD^3
    for name, tensors, fn in (("plain", 140, "stage_backward_plain"),
                              ("oracle", 260, "composite_backward_autograd")):
        m = plain_backward_size(n, tensors)
        gm, phim, velm = zalesak(m, dev)
        Pm = v2.pack_padded(phim.values, phim.bcs)
        um = tuple(velm.values[d].contiguous() for d in range(3))
        Gm = torch.randn(v2.padded_shape(gm.shape), generator=torch.Generator(
            device=dev).manual_seed(9), device=dev)
        if fn == "stage_backward_plain":
            gfm = bwd.fold_ghost_cotangent_plain(Gm.clone(), phim.bcs, gm.shape)
            call = lambda: bwd.stage_backward_plain(Pm, um, coeffs, None, gfm, gm.spacing,
                                                    gm.shape)
            if m != n:
                t[f"K3@{m}"] = cuda_time(lambda: bwd.stage_backward(
                    Pm, um, coeffs, None, gfm, gm.spacing, gm.shape))
        else:
            call = lambda: bwd.composite_backward_autograd(Pm, um, coeffs, None, Gm, phim.bcs,
                                                           gm.spacing, gm.shape)
        t[f"K3_{name}@{m}"] = cuda_time(call, warmup=1, reps=10)
        mem[f"K3_{name}@{m}"] = peak_gib(call)
        res[f"K3_{name}_n"] = m
        del gm, phim, velm, Pm, um, Gm, call
    for name in [k for k in t if k.startswith(("K3", "K4", "K5", "cell"))]:
        log("timing", f"{n}^3 f32 {name:22s} median {t[name]:.4f} ms")
    log("timing", "peak memory: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in mem.items()))
    res["mem"] = mem


def shells_device(res):
    """The device times of K2, K4 and ``g.clone()`` at 512^3 (the flagship's
    Periodic state; config A's ``Extrapolation(2)`` and mixed BCs beside it),
    of K5 at 512^3, and of K2's single-axis phases at the sharded flagship's
    shard shapes (out of L2) from ``tools/ghost_shells.py`` in a process of its
    own: after the phases before it, this process's profiler under-reads them
    (on an H100, K4 0.14 ms of its 0.40, the clone's copy not at all). Into
    ``res["t"]`` (K2_device, K4_device, K4_clone_device, K5_device) and
    ``res["shells"]`` (every reading of the tool)."""
    torch.cuda.empty_cache()  # the cached blocks of the phases before, for the child
    out = subprocess.run([sys.executable, "tools/ghost_shells.py", "smoke"], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    line = next(x for x in out.splitlines() if x.startswith("SHELLS smoke"))
    vals = line.split()[2:]
    shells = {k: float(v) for k, v in zip(vals[::2], vals[1::2])}
    for key, name in (("K2_device", "periodic_K2"), ("K4_device", "periodic_K4"),
                      ("K4_clone_device", "periodic_clone"), ("K5_device", "K5")):
        res["t"][key] = shells[f"{name}_device"]
    res["shells"] = shells
    log("timing", "device ms (tools/ghost_shells.py): " + " ".join(
        f"{k} {v:.4f}" for k, v in shells.items() if k.endswith("_device")))


def device_ms(fn, reps=20, name=None):
    """Device time per call of ``fn`` (ms): ``torch.profiler``'s CUDA self
    time over ``reps`` calls (warmed up first), of every kernel or of those
    whose name holds ``name``. Unlike :func:`cuda_time` it leaves out the
    host's time to issue the calls, which bounds a call of a few
    microseconds of device work."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and (name is None or name in e.key)]
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def back_to_back_ms(fn, calls=50) -> float:
    """Milliseconds a call of ``fn`` over ``calls`` calls issued back to
    back between two CUDA events (warmed up first): the card's time for a
    call whenever the host issues faster than the card runs, since the
    queue never drains."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def profile_window(label, fn, kernels=None):
    """``torch.profiler`` over one call of ``fn`` (warmed up first): wall
    time, device busy share, and the device time by kernel. Returns ``(wall
    ms, device busy ms)``; a dict given as ``kernels`` gets every kernel's
    ``(device ms, launches)`` by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if kernels is not None:
        kernels.update({e.key: (e.self_device_time_total / 1e3, e.count) for e in events})
    log("profile", f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
                   f"({100 * busy_us / wall_us:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3


def phase_profile(dev, res):
    """``torch.profiler`` over 3 RK3 steps of the 512^3 main path, one
    ``value_and_grad`` of cell (a) (streamed) and one of cell (b), 3 band FE
    and RK3 steps, 3 RK3 steps of configs C and A, of H (the general path,
    K10) and of D2 (the dense 2D stepper: K1'' and K2 2D) and D2h (K11) at
    N_2D^2: the device busy share and the device time by kernel."""
    grid, phi, vel = zalesak(N_MAIN, dev)
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(vel), ic=phi, integrator=lsm.RK3())
    profile_window(f"3 RK3 steps at {N_MAIN}^3", lambda: eq.integrate(1.0, max_steps=3))
    del eq
    shape, sp, bcs, dt = grid.shape, grid.spacing, phi.bcs, 0.25 * grid.min_spacing
    velv = vel.values.clone().requires_grad_()
    phiv = phi.values.clone().requires_grad_()
    profile_window(f"cell (a) streamed at {N_MAIN}^3", lambda: torch.autograd.grad(
        fe_grad_loss(phiv, tuple(velv[d] for d in range(3)), bcs, sp, shape, dt), (phiv, velv)))
    del velv
    profile_window(f"cell (b), {ROLLOUT_STEPS} steps at {N_MAIN}^3",
                   lambda: rollout_grad(phi, phiv, dt, ROLLOUT_STEPS, remat=True))
    del phiv, phi, vel
    nb = sphere_band(N_MAIN, dev)
    for name, integ in (("FE", lsm.ForwardEuler()), ("RK3", lsm.RK3())):
        eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(spin), ic=nb, integrator=integ)
        profile_window(f"3 band {name} steps at {N_MAIN}^3",
                       lambda: eq.integrate(eq.t + 1.0, max_steps=3))
    eq = lsm.LevelSetEquation(terms=(c_term(nb),), ic=nb, integrator=lsm.RK3())
    profile_window(f"config C: 3 band RK3 steps at {N_MAIN}^3",
                   lambda: eq.integrate(eq.t + 1.0, max_steps=3))
    del eq, nb
    phi = torus_field(N_MAIN, dev)
    eq = lsm.LevelSetEquation(terms=a_terms(), ic=phi, integrator=lsm.RK3())
    profile_window(f"config A: 3 RK3 steps at {N_MAIN}^3",
                   lambda: eq.integrate(eq.t + 1.0, max_steps=3))
    del eq, phi
    _, phi, vel = zalesak(N_MAIN, dev)
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(vel), ic=phi, integrator=lsm.RK3())
    profile_window(f"H: 3 RK3 steps with a posthook at {N_MAIN}^3 (the general path)",
                   lambda: eq.integrate(eq.t + 1.0, max_steps=3, posthook=lambda e: None))
    del eq, phi, vel
    for name in ("D2", "D2h"):
        terms, phi, integ = config(name, N_2D, dev)
        eq = lsm.LevelSetEquation(terms=terms, ic=phi, integrator=integ)
        kw = {"posthook": lambda e: None} if name == "D2h" else {}
        wall, busy = profile_window(f"{name}: 3 RK3 steps at {N_2D}^2",
                                    lambda: eq.integrate(eq.t + 1.0, max_steps=3, **kw))
        res[f"{name}_busy_share"] = busy / wall


# -- in-kernel coefficient programs: K1'', K3'', K6'' ------------------------------

ORIGIN = (3.0, -5.0, 7.0)  # a shard's node offset (index units): K1'' takes a nonzero one
T_STAGE = 0.3  # the stage time the program checks evaluate at


def vortex3(xs, t):
    """Config 3's single-vortex field in 3D: its swirl in x-y (reversing with
    period 4) and a constant drift along z, a time-dependent program."""
    x, y, z = xs
    ux, uy = shapes.vortex_velocity(period=4.0)((x, y), t)
    return (ux + 0.0 * z, uy + 0.0 * z, 0.1 + 0.0 * (x + y + z))


def program_term(kind, fn):
    """``(TermSpec, ())`` of ``fn`` traced into a program (raises if it does
    not trace: the smoke's callables all must)."""
    prog = coef_program.trace(fn, 3, v2.n_components(kind))
    if isinstance(prog, str):
        raise AssertionError(f"{fn.__name__} did not trace: {prog}")
    return v2.TermSpec(kind, "program", prog), ()


def analytic_cases():
    """The program cases, ``(name, terms, with_aux)``: the rotation and the
    vortex (time-dependent) through the advection-only entry, and a
    time-dependent program normal speed beside a constant curvature, with
    aux, through the term-list entry."""
    return [("rotation", (program_term("advection", rotation),), False),
            ("vortex", (program_term("advection", vortex3),), False),
            ("normal+curvature", (program_term("normal", kinds_speed),
                                  (v2.TermSpec("curvature", "const", -0.05, 0), ())), True)]


def check_tables(progs, shape, sp, where, like, phase):
    """The program tables' kernel against its plain version on ``progs``
    (values, and values with t-derivatives), within K1's bound for
    ``like``'s float32 (1e-12 in float64); returns the worst max|kernel -
    plain|."""
    tol = K1_TOL if like.dtype == torch.float32 else 1e-12
    worst = 0.0
    for need_dt in (False, True):
        got = v2.program_tables(progs, shape, sp, where, like, need_dt)
        ref = v2.program_tables_plain(progs, shape, sp, where, like, need_dt)
        err = float((got - ref).abs().max())
        scale = max(float(ref.abs().max()), 1.0)
        log(phase, f"program tables {str(like.dtype)[6:]} {got.numel()} values (dt {need_dt}) "
                   f"max|kernel-plain|={err:.3e} scale={scale:.3e} tol={tol:g}*scale")
        if not (got.shape == ref.shape and err <= tol * scale):
            raise AssertionError(f"program tables disagree with their plain version: {err}")
        worst = max(worst, err)
    return worst


def phase_k1analytic(dev, res):
    """K1'' against its plain version at BAND_SMALL on the torus, f32 and
    f64, two BC cases, each case of :func:`analytic_cases` at origin 0 and at
    ORIGIN, as the bare operator (0, 0, 1) and as a stage (with aux for the
    term list); curvature nodes at the eps gate left out as in k1kinds."""
    gen = torch.Generator(device=dev).manual_seed(31)
    worst = 0.0
    for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
        grid = lsm.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), BAND_SMALL)
        phi = lsm.sample(shapes.torus((0.0, 0.0, 0.0), 0.5, 0.2), grid, lsm.Extrapolation(2),
                         dtype=dtype, device=dev)
        shape, sp = grid.shape, grid.spacing
        for bname in ("periodic", "mixed"):
            bcs = bc_cases()[bname]
            P = v2.pack_padded(phi.values, bcs)
            A = v2.pack_padded(phi.values + 0.01 * torch.randn(
                shape, generator=gen, device=dev, dtype=dtype), bcs)
            gate = gate_nodes(P, sp, shape)
            errs = {}
            if bname == "periodic":
                for origin in (None, ORIGIN):
                    err = check_tables([s.coef_static for _, ts, _ in analytic_cases()
                                        for s, _ in ts if s.coef_kind == "program"], shape, sp,
                                       v2.Where(grid.lo, origin, T_STAGE), P, "k1analytic")
                    if dtype == torch.float32:
                        res["tables_err"] = max(res.get("tables_err", 0.0), err)
            for name, terms, with_aux in analytic_cases():
                keep = ~gate if has_curvature(terms) else torch.ones_like(gate)
                stage = (A, (0.75, 0.25, 2.5e-4)) if with_aux else (None, (0.0, 1.0, 1e-3))
                for origin in (None, ORIGIN):
                    for aux, coeffs in ((None, (0.0, 0.0, 1.0)), stage):
                        where = v2.Where(grid.lo, origin, T_STAGE)
                        got = v2.fused_stage(P, terms, coeffs, aux, sp, shape, where)
                        ref = v2.stage_plain(P, terms, coeffs, aux, sp, shape, where)
                        torch.cuda.synchronize()
                        g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
                        err, scale = kinds_err(g, r, keep)
                        if not (bool(torch.isfinite(g).all()) and err <= tol * scale):
                            raise AssertionError(f"K1'' parity failed ({dtype}, {bname}, {name},"
                                                 f" origin {origin}): {err} > {tol} * {scale}")
                        errs[name] = max(errs.get(name, 0.0), err / scale)
                        if dtype == torch.float32:
                            worst = max(worst, err)
            log("k1analytic", f"K1'' {str(dtype)[6:]} {bname:9s} shape={shape} t={T_STAGE} "
                              f"origins 0 and {ORIGIN}: max|kernel-plain|/scale (tol {tol:g}): "
                              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
        # the march's own shapes: the rotation (a component per column, one
        # per plane) and the vortex (per node), on random buffers
        for shape in K1_MARCH_SHAPES:
            P, A, sp, lo = k1_inputs(shape, dtype, dev, gen)
            for name, terms, _ in analytic_cases()[:2]:
                for origin in (None, ORIGIN):
                    where = v2.Where(lo, origin, T_STAGE)
                    for aux, coeffs in ((None, (0.0, 0.0, 1.0)), (A, (0.75, 0.25, 2.5e-4))):
                        err = k1_compare("k1analytic", f"K1'' {name} origin {origin}", P, terms,
                                         coeffs, aux, sp, shape, where, tol)
                        if dtype == torch.float32:
                            worst = max(worst, err)
    res["k1a_err"] = worst


def k3a_errs(got, ref, shape):
    """``{output: max|got - ref| / max|ref|}`` over K3''s outputs: the raw
    dP, dalpha, dbeta, dgamma, dt, daux."""
    errs = {"dP": rel_err(got[0], ref[0])}
    for k, name in enumerate(("dalpha", "dbeta", "dgamma", "dt")):
        errs[name] = rel_err(got[2][k:k + 1], ref[2][k:k + 1])
    if ref[3] is not None:
        errs["daux"] = rel_err(v2.unpack_padded(got[3], shape), v2.unpack_padded(ref[3], shape))
    return errs


def k3a_run(P, terms, coeffs, A, gf, sp, shape, where, plain=False):
    """K3'' (or its plain version) on a program term list: the advection-only
    entry for one advection program, the term-list entry otherwise; with
    the stage time's cotangent."""
    if v2.is_advection_only(terms):
        fn = bwd.stage_backward_plain if plain else bwd.stage_backward
        return fn(P, terms[0][0].coef_static, coeffs, A, gf, sp, shape, where=where,
                  need_dt=True)
    fn = bwd.stage_backward_terms_plain if plain else bwd.stage_backward_terms
    return fn(P, terms, coeffs, A, gf, sp, shape, where=where, need_dt=True)


def phase_k3analytic(dev, res):
    """K3'' at BAND_SMALL on the noisy torus, two tie-free BC cases, the
    cases of :func:`analytic_cases` plus the vortex beside the program normal
    speed (K3 in accumulate mode after K3'), with and without aux, the stage
    time's cotangent included: f64 kernel vs f64 plain (tol 1e-10 relative
    to max|ref|), f32 kernel vs the f64 autograd oracle of stage + refresh
    (float32's WENO epsilon floor; tol K3_TOL)."""
    shape = BAND_SMALL
    gen = torch.Generator(device=dev).manual_seed(32)
    grid = lsm.Grid((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), shape)
    sp, where = grid.spacing, v2.Where(grid.lo, None, T_STAGE)
    torus = lsm.sample(shapes.torus((0.0, 0.0, 0.0), 0.5, 0.2), grid, dtype=torch.float64,
                       device=dev).values
    vals = torus + 1e-3 * torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
    aux_vals = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
    G64 = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=torch.float64)
    cases = [(n, t) for n, t, _ in analytic_cases()] + [
        ("vortex + normal", (program_term("advection", vortex3),
                             program_term("normal", kinds_speed)))]
    worst = {"f64": 0.0, "f32": 0.0, "f32_abs": 0.0}
    for bname in ("periodic", "symmetry"):
        bcs = lsm.normalize_bcs(K3K_BCS[bname](), 3)
        for name, terms in cases:
            line = {}
            for with_aux in (False, True):
                coeffs = (0.75, 0.25, 2.5e-3) if with_aux else (0.0, 1.0, 1e-2)
                for dtype in (torch.float64, torch.float32):
                    P = v2.pack_padded(vals.to(dtype), bcs)
                    A = v2.pack_padded(aux_vals.to(dtype), bcs) if with_aux else None
                    G = G64.to(dtype)
                    gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
                    got = k3a_run(P, terms, coeffs, A, gf, sp, shape, where)
                    torch.cuda.synchronize()
                    if not all(bool(torch.isfinite(x).all()) for x in (got[0], got[2])):
                        raise AssertionError(f"K3'' non-finite ({bname}, {name})")
                    if dtype == torch.float64:
                        plain = k3a_run(P, terms, coeffs, A, gf, sp, shape, where, plain=True)
                        errs = k3a_errs(got, plain, shape)
                        key = "f64"
                    else:
                        d = lambda t: None if t is None else t.double()
                        with f32_weno_floor():
                            ref = bwd.composite_backward_autograd(
                                d(P), terms, coeffs, d(A), G.double(), bcs, sp, shape, where)
                        errs = k3a_errs(got, ref, shape)
                        worst["f32_abs"] = max(worst["f32_abs"],
                                               float((got[0].double() - ref[0]).abs().max()))
                        key = "f32"
                    line[key] = max(line.get(key, 0.0), max(errs.values()))
                    line[f"{key}_dt"] = max(line.get(f"{key}_dt", 0.0), errs["dt"])
                    worst[key] = max(worst[key], max(errs.values()))
            log("k3analytic", f"{bname:9s} {name:16s} f64 kernel vs plain {line['f64']:.2e} "
                              f"(dt {line['f64_dt']:.2e}; tol 1e-10), f32 kernel vs f64 oracle "
                              f"{line['f32']:.2e} (dt {line['f32_dt']:.2e}; tol {K3_TOL:g}), "
                              f"relative to max|ref|")
    log("k3analytic", f"worst: f64 {worst['f64']:.3e}, f32 {worst['f32']:.3e} (dP max abs "
                      f"{worst['f32_abs']:.3e})")
    if not (worst["f64"] <= 1e-10 and worst["f32"] <= K3_TOL):
        raise AssertionError(f"K3'' parity failed: {worst}")
    res["k3a_err"] = worst["f32_abs"]


def phase_k6analytic(dev, res):
    """K6'' against its plain version over the BAND_SMALL sphere's dispatch
    list, f32 and f64, two BC cases: the band bench's rotation (the
    advection-only entry) and a program normal speed beside a constant
    curvature with aux (the term-list entry), at T_STAGE; within K1's bound
    on the dispatched compute band, bit for bit elsewhere."""
    gen = torch.Generator(device=dev).manual_seed(33)
    worst = 0.0
    cases = [("spin", (program_term("advection", spin),), False),
             ("normal+curvature", (program_term("normal", kinds_speed),
                                   (v2.TermSpec("curvature", "const", -0.05, 0), ())), True)]
    for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
        grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), BAND_SMALL)
        phi = lsm.sample(shapes.sphere((0.1, 0.5, 0.9), 0.35), grid, lsm.Extrapolation(2),
                         dtype=dtype, device=dev)
        nb = lsm.NarrowBandField.from_field(phi)
        shape, sp, tiles = grid.shape, grid.spacing, default_tiles(nb.nlayers)
        band = combined(nb)
        act = bd.tile_activity(band, tiles)
        cap = int(act.sum()) + 5
        ids, _ = bd.compact_ids(act, cap)
        disp = bd.dispatched_cells(ids, shape, tiles)
        cm = band != 0
        off_list = ~inside(shape, disp, dev)
        for bname in ("extrap2", "mixed"):
            bcs = bc_cases()[bname]
            P = v2.pack_padded(nb.values, bcs)
            A = v2.pack_padded(nb.values + 0.01 * torch.randn(
                shape, generator=gen, device=dev, dtype=dtype), bcs)
            target = P + torch.randn(P.shape, generator=gen, device=dev, dtype=dtype)
            gate = gate_nodes(P, sp, shape)
            errs, exact = {}, True
            for name, terms, with_aux in cases:
                on = disp & cm & (~gate if has_curvature(terms) else torch.ones_like(gate))
                aux, coeffs = (A, (0.75, 0.25, 2.5e-4)) if with_aux else (None, (0.0, 1.0, 1e-3))
                got = bd.band_stage(P, target.clone(), ids, band, terms, coeffs, aux, sp, shape,
                                    tiles, v2.Where(grid.lo, None, T_STAGE))
                ref = bd.band_stage_plain(P, target.clone(), ids, band, terms, coeffs, aux, sp,
                                          shape, tiles, v2.Where(grid.lo, None, T_STAGE))
                torch.cuda.synchronize()
                g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
                err, scale = kinds_err(g, r, on)
                kept = torch.equal(g[disp & ~cm], v2.unpack_padded(P, shape)[disp & ~cm])
                untouched = torch.equal(got[off_list], target[off_list])
                exact = exact and kept and untouched
                if not (bool(torch.isfinite(g).all()) and err <= tol * scale and kept
                        and untouched):
                    raise AssertionError(f"K6'' parity failed ({dtype}, {bname}, {name}): err "
                                         f"{err} scale {scale}, kept {kept}, untouched {untouched}")
                errs[name] = err / scale
                if dtype == torch.float32:
                    worst = max(worst, err)
            log("k6analytic", f"K6'' {str(dtype)[6:]} {bname:9s} tiles={tiles} slots={cap} "
                              f"max|kernel-plain|/scale (tol {tol:g}): "
                              + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
                              + f"; off the band and off the list bit for bit: {exact}")
    res["k6a_err"] = worst


def update_terms_of(phi):
    """``update_func`` terms: the rotation re-traced at every refresh, and a
    normal speed that follows the state (0.05 + 0.02 tanh(phi), streamed)."""
    speed = lambda s, p, t: lsm.MeshField(0.05 + 0.02 * torch.tanh(p.values), p.grid)
    return (lsm.AdvectionTerm(rotation, update_func=lambda v, p, t: rotation),
            lsm.NormalMotionTerm(0.05, update_func=speed))


def phase_update(dev, res):
    """``update_func`` on the dense fused stepper: ``integrate`` of the
    64^3 Zalesak field under :func:`update_terms_of`, RK3, on the card
    (kernels: K1'' inside K1' for the program advection beside the streamed
    speed) against the CPU (plain versions), f32 and f64; launches counted."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        out = {}
        for where in ("cpu", dev):
            _, phi, _ = zalesak(N_SMALL, where, dtype)
            eq = lsm.LevelSetEquation(terms=update_terms_of(phi), ic=phi, integrator=lsm.RK3())
            if where != "cpu":
                torch.cuda.synchronize()
            reset_counts()
            eq.integrate(1.0, max_steps=KINDS_SMALL_STEPS)
            if where != "cpu":
                torch.cuda.synchronize()
            out[str(where)] = (eq, read_counts())
        (a, counts), (b, _) = out[str(dev)], out["cpu"]
        steps = a.last_nsteps
        scale = max(float(b.state.values.abs().max()), 1.0)
        err = float((a.state.values.cpu().double() - b.state.values.double()).abs().max())
        want = dict(NONE_LAUNCHED, K1=3 * steps, K2=3 * steps,
                    **{"K1'": 3 * steps, "K1''": 3 * steps})
        speeds = isinstance(a.terms[1].speed, lsm.MeshField)
        log("update", f"{N_SMALL}^3 {str(dtype)[6:]} RK3 update_func: steps {steps}/"
                      f"{b.last_nsteps} paths {a.last_fast_path}/{b.last_fast_path} t "
                      f"{a.t:.9e}/{b.t:.9e} max|card-cpu|={err:.3e} (tol {tol:g}*scale) "
                      f"launches={counts} refreshed terms kept: {speeds}")
        if not (steps == b.last_nsteps == KINDS_SMALL_STEPS
                and a.last_fast_path == b.last_fast_path == "fused"
                and abs(a.t - b.t) <= T_TOL[dtype] * abs(b.t) and err <= tol * scale
                and counts == want and speeds):
            raise AssertionError(f"update_func card-vs-CPU check failed ({dtype})")


def phase_analytic_timing(dev, res):
    """CUDA-event medians at 512^3 f32 of K1'' (rotation, vortex), K3''
    (rotation; vortex with the time's cotangent) and K6'' (the band bench's
    state), beside their plain versions (the plain K3'' at N_PLAIN_BWD^3);
    the flagship RK3 ``integrate`` per step with the rotation in-kernel and
    streamed, in turns."""
    t, n = res["t"], N_MAIN
    grid, phi, vel = zalesak(n, dev)
    shape, sp, bcs = grid.shape, grid.spacing, phi.bcs
    P = v2.pack_padded(phi.values, bcs)
    dt = 0.5 * float(lsm.compute_cfl((lsm.AdvectionTerm(vel),), phi, 0.0))
    coeffs = (0.0, 1.0, dt)
    where = v2.Where(grid.lo, None, T_STAGE)
    G = torch.randn(v2.padded_shape(shape), generator=torch.Generator(device=dev).manual_seed(34),
                    device=dev)
    gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
    for name, fn in (("rotation", rotation), ("vortex", vortex3)):
        terms = (program_term("advection", fn),)
        prog = terms[0][0].coef_static
        t[f"K1pp_{name}"] = cuda_time(lambda: v2.fused_stage(P, terms, coeffs, None, sp, shape,
                                                             where))
        t[f"K1pp_{name}_plain"] = cuda_time(lambda: v2.stage_plain(
            P, terms, coeffs, None, sp, shape, where), warmup=1)
        t[f"K3pp_{name}"] = cuda_time(lambda: bwd.stage_backward(
            P, prog, coeffs, None, gf, sp, shape, where=where, need_dt=prog.depends_on_t))
        t[f"tables_{name}"] = cuda_time(lambda: v2.program_tables(
            [prog], shape, sp, where, P, False))
        t[f"tables_{name}_plain"] = cuda_time(lambda: v2.program_tables_plain(
            [prog], shape, sp, where, P, False))
        res[f"prog_{name}"] = program_work(prog, shape)
    m = N_PLAIN_BWD
    gm, phim, _ = zalesak(m, dev)
    Pm = v2.pack_padded(phim.values, phim.bcs)
    Gm = torch.randn(v2.padded_shape(gm.shape), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(35))
    gfm = bwd.fold_ghost_cotangent_plain(Gm, phim.bcs, gm.shape)
    prog = program_term("advection", vortex3)[0].coef_static
    t[f"K3pp_vortex@{m}"] = cuda_time(lambda: bwd.stage_backward(
        Pm, prog, coeffs, None, gfm, gm.spacing, gm.shape, where=where, need_dt=True))
    t[f"K3pp_vortex_plain@{m}"] = cuda_time(lambda: bwd.stage_backward_plain(
        Pm, prog, coeffs, None, gfm, gm.spacing, gm.shape, where=where, need_dt=True),
        warmup=1, reps=5)
    del gm, phim, Pm, Gm, gfm, G, gf
    # the CFL bound, which still evaluates a callable over the whole grid in
    # plain torch (ROADMAP queue 1 item 7b), against the streamed velocity's
    for key, term in (("cfl_program", lsm.AdvectionTerm(rotation)),
                      ("cfl_streamed", lsm.AdvectionTerm(vel))):
        t[key] = cuda_time(lambda: lsm.compute_cfl((term,), phi, 0.0), warmup=1)
    for key, term in (("RK3_integrate_program", lsm.AdvectionTerm(rotation)),
                      ("RK3_integrate_streamed", lsm.AdvectionTerm(vel)),
                      ("RK3_integrate_streamed_2", lsm.AdvectionTerm(vel)),
                      ("RK3_integrate_program_2", lsm.AdvectionTerm(rotation))):
        t[key] = integrate_ms_per_step(term, phi, lsm.RK3())
    del P, phi, vel
    torch.cuda.empty_cache()
    nb = sphere_band(n, dev)
    fe = FusedBandStepper((lsm.AdvectionTerm(spin),), nb, lsm.ForwardEuler())
    state = fe.pack(nb)
    Q, out = state.bufs
    terms = fe.stage_terms(state, 0.0)
    bcoeffs = (0.0, 1.0, 0.25 * nb.grid.min_spacing)
    t["K6pp"] = cuda_time(lambda: bd.band_stage(Q, out, state.ids, state.band, terms, bcoeffs,
                                                None, nb.grid.spacing, nb.shape, fe.tiles,
                                                v2.Where(fe.lo)))
    t["K6pp_back_to_back"] = back_to_back_ms(lambda: bd.band_stage(
        Q, out, state.ids, state.band, terms, bcoeffs, None, nb.grid.spacing, nb.shape,
        fe.tiles, v2.Where(fe.lo)))
    t["K6pp_plain"] = cuda_time(lambda: bd.band_stage_plain(
        Q, out, state.ids, state.band, terms, bcoeffs, None, nb.grid.spacing, nb.shape,
        fe.tiles, v2.Where(fe.lo)), warmup=1, reps=5)
    res["prog_spin"] = program_work(terms[0][0].coef_static, nb.shape)
    del nb, fe, state, Q, out
    torch.cuda.empty_cache()
    for name in [k for k in t if k.startswith(("K1pp", "K3pp", "K6pp", "RK3_integrate", "cfl",
                                               "tables"))]:
        log("analytic_timing", f"f32 {name:28s} median {t[name]:.4f} ms")


def program_work(prog, shape):
    """A program's work on a grid of ``shape``: its arithmetic operations
    per node (a leaf's load is none), and its tables' entries and arithmetic
    operations (each table once per launch)."""
    entries = [1 if axis < 0 else shape[axis] for _, axis in prog.tables]
    return {"per_node": prog.n_arith, "table_entries": sum(entries),
            "table_ops": sum(n * k for n, k in zip(entries, prog.table_arith))}


# -- the sharded paths: K9, the sharded fused evolve, its gradient, the general path ---


def card_mesh(dev, shape):
    """A mesh of ``shape`` whose every shard lies on the card ``dev``."""
    return par.make_mesh(devices=[dev] * math.prod(shape), mesh_shape=shape)


def k9_blocks(shape, mesh_shape, dtype, dev, gen):
    """Random K9 blocks for a shard of ``shape``: the axis-0 pair when the
    mesh splits axis 0, the axis-1 pair when it splits axis 1."""
    n0, n1, n2 = shape

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev, dtype=dtype)

    l0, r0 = (rnd(3, n1, n2), rnd(3, n1, n2)) if mesh_shape[0] > 1 else (None, None)
    l1, r1 = (rnd(n0 + 6, 3, n2), rnd(n0 + 6, 3, n2)) if mesh_shape[1] > 1 else (None, None)
    return l0, r0, l1, r1


def sharded_refresh_mismatches(grid, bcs, v, dev, label):
    """The sharded refresh of ``v``'s shards on SHARDED_MESHES and (1, 4) of
    the card (every shell stale, NaN, before it) against the single-device
    plain refresh of the whole padded buffer, bit for bit; each refresh must
    launch K9 once per shard and K2's three-phase refresh never. Returns the
    mismatches, tagged with ``label``."""
    bad = []
    ref = v2.refresh_ghosts_plain(v2.pack_padded(v, bcs), bcs, grid.shape)
    for ms in SHARDED_MESHES + ((1, 4),):
        layout = sfe.ShardLayout(card_mesh(dev, ms), grid)
        bufs = []
        for blk in par.constrain(v, layout.mesh, 3).flat:
            b = torch.full(v2.padded_shape(layout.local_shape), float("nan"), device=dev,
                           dtype=v.dtype)
            v2.unpack_padded(b, layout.local_shape).copy_(blk)
            bufs.append(b)
        reset_counts()
        sfe.refresh_ghosts_sharded(bufs, bcs, layout)
        counts = read_counts()
        m0, m1, _ = layout.local_shape
        for b, (i, j) in zip(bufs, layout.pos):
            if not torch.equal(b, ref[i * m0:i * m0 + m0 + 6, j * m1:j * m1 + m1 + 6]):
                bad.append(("refresh", *label, ms, (i, j)))
        if counts["K9"] != SHARDS or counts["K2"] != 0:
            bad.append(("refresh launches", *label, ms, counts))
        del bufs
    return bad


#: a buffer past 2^31 elements (10.1 GB in f32) on which K2's 3D entry and K7
#: take the three launches of K2's single-axis entry (their one launch would
#: need 2^31 threads); one node along axis 2, so Extrapolation(0) there
K2AX_BIG = (20000, 18000, 1)


def kernel_names(fn, ok=bool, tries=3):
    """The names of the device activities (kernels, copies) one call of
    ``fn`` launches, by the profiler. The profiler drops records now and
    then (its first trace in a process has come back empty, late in a long
    process every trace, and once one kernel of three), so a trace that
    ``ok`` refuses is taken again, calling ``fn`` again, up to ``tries``
    times: a count that is wrong in the code stays wrong in every trace.
    ``fn`` must give the same result when called twice (a ghost refresh and
    an out-of-place fold do)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if ok(names):
            break
    return names


def k2ax_past_2_31(dev):
    """K2's single-axis entry (each axis), K2's 3D entry and K7 under each of
    K7_FLAGS on a K2AX_BIG buffer of random values, f32, bit for bit against
    their plain versions; the 3D entry and K7 there launch the single-axis
    kernel three times (the profiler's kernel names)."""
    shape = K2AX_BIG
    bcs = lsm.normalize_bcs([lsm.Periodic(), (lsm.Symmetry(), lsm.Extrapolation(3)),
                             lsm.Extrapolation(0)], 3)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(31)
    orig = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
    bad = []

    def check(label, fast, plain, launches):
        ref = plain(orig.clone())
        P = orig.clone()
        count = lambda names: sum("refresh_axis_kernel" in name for name in names)
        names = kernel_names(lambda: fast(P), ok=lambda names: count(names) == launches)
        axis = count(names)
        if not (same_bits(P, ref) and axis == launches):
            bad.append((label, same_bits(P, ref), axis, names[:3]))
        del P, ref
        torch.cuda.empty_cache()

    for ax in range(3):
        check(f"axis {ax}", lambda P: v2.refresh_axis_fast(P, bcs, shape, ax),
              lambda P: v2.refresh_axis_plain(P, bcs, shape, ax), 1)
    check("K2 3D", lambda P: v2.refresh_ghosts_fast(P, bcs, shape),
          lambda P: v2.refresh_ghosts_plain(P, bcs, shape), 3)
    for flags in K7_FLAGS:
        f = torch.tensor(flags, dtype=torch.int32, device=dev)
        check(f"K7 {flags}", lambda P: bd.refresh_band_ghosts_fast(P, bcs, shape, f),
              lambda P: bd.refresh_band_ghosts_plain(P, bcs, shape, f), 3)
    log("k9", f"{shape} f32 ({orig.numel()} elements, past 2^31): K2's single-axis entry "
              f"(axes 0-2), K2 3D and K7 under {K7_FLAGS} (three single-axis launches each) "
              f"vs plain, bit for bit: mismatches {bad}")
    del orig
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"K2's single-axis route past 2^31 elements failed: {bad}")


def axis2_sector_bytes(shape):
    """The bytes of the whole 32-byte sectors that K2's axis-2 phase reads
    and writes on a padded f32 buffer of ``shape`` (Periodic, 32-byte aligned):
    each padded row's six ghosts and their six sources, a sector counted once
    for the reads and once for the writes."""
    n2, S2 = shape[2], shape[2] + 2 * v2.GHOST
    rows = (shape[0] + 2 * v2.GHOST) * (shape[1] + 2 * v2.GHOST)
    base = torch.arange(rows, dtype=torch.int64)[:, None] * S2
    ghosts = torch.tensor([0, 1, 2, n2 + 3, n2 + 4, n2 + 5])
    sources = torch.tensor([n2 - 1, n2, n2 + 1, 4, 5, 6])  # nodes n2-4..n2-2 and 1..3
    return 32 * sum(torch.unique((base + at) * 4 // 32).numel() for at in (ghosts, sources))


def phase_k9(dev, res):
    """K9 against its plain version (slice assignment), bit for bit: random
    blocks at ragged shapes, every subset of the four, f32 and f64; K2's
    single-axis entry against its plain version, every BC case and axis; the
    sharded refresh (exchange, BC blocks, K9, K2's phases) on meshes of the
    card against the single-device plain refresh, every BC case, f32 and
    f64; the single-axis entry at 150x160x521 too; the same at the 512^3
    flagship's size, with K9 and K2's single-axis entry at its shard shapes,
    f32; the single-axis route on a buffer past 2^31 elements
    (:func:`k2ax_past_2_31`, in a process of its own); then K9 timed there
    over K9_SETS buffers in turn (out of L2) beside its plain version and
    K2's axis-2 phase."""
    gen = torch.Generator(device=dev).manual_seed(19)
    worst, worst_ax, bad = 0.0, 0.0, []
    for dtype in (torch.float32, torch.float64):
        for shape in ((5, 7, 9), (16, 24, 40), (33, 8, 130)):
            P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
            blocks = k9_blocks(shape, (2, 2), dtype, dev, gen)
            for keep in itertools.product((False, True), repeat=4):
                bl = [b if k else None for b, k in zip(blocks, keep)]
                a = sfe.write_shell_blocks(P.clone(), *bl, shape)
                b = sfe.write_shell_blocks_plain(P.clone(), *bl, shape)
                worst = max(worst, float((a - b).abs().max()))
                if not torch.equal(a, b):
                    bad.append(("K9", str(dtype), shape, keep))
        grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (24, 32, 20))
        shape = grid.shape
        for name, bcs in bc_cases().items():
            P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
            for ax in range(3):
                a = v2.refresh_axis_fast(P.clone(), bcs, shape, ax)
                b = v2.refresh_axis_plain(P.clone(), bcs, shape, ax)
                worst_ax = max(worst_ax, float((a - b).abs().max()))
                if not torch.equal(a, b):
                    bad.append(("K2 axis", str(dtype), name, ax))
            v = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
            bad += sharded_refresh_mismatches(grid, bcs, v, dev, (str(dtype), name))
        shape = K7_SHAPES[2]  # a grid of many blocks an SM on every axis
        for name, bcs in bc_cases().items():
            P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
            for ax in range(3):
                a = v2.refresh_axis_fast(P.clone(), bcs, shape, ax)
                b = v2.refresh_axis_plain(P.clone(), bcs, shape, ax)
                worst_ax = max(worst_ax, float((a - b).abs().max()))
                if not same_bits(a, b):
                    bad.append(("K2 axis", str(dtype), shape, name, ax))
    log("k9", f"K9 vs plain, 3 shapes x 16 block subsets, f32 and f64: max|diff| {worst:.3e}; "
              f"K2's single-axis entry vs plain (also at {K7_SHAPES[2]}) and the sharded "
              f"refresh on meshes {SHARDED_MESHES + ((1, 4),)} of the card vs the "
              f"single-device plain refresh, {len(bc_cases())} BC cases: mismatches {bad}")
    if bad:
        raise AssertionError(f"K9 / sharded refresh check failed: {bad[:4]}")
    # the flagship's size: the sharded refresh of random 512^3 values against
    # the single-device plain refresh, and at each mesh's shard shape K9 and
    # K2's single-axis entry (every axis) against their plain versions, every
    # BC case, f32, bit for bit
    grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (N_MAIN,) * 3)
    for name, bcs in bc_cases().items():
        v = torch.randn(grid.shape, generator=gen, device=dev)
        bad += sharded_refresh_mismatches(grid, bcs, v, dev, (f"{N_MAIN}^3", name))
        del v
        for ms in SHARDED_MESHES:
            shape = (N_MAIN // ms[0], N_MAIN // ms[1], N_MAIN)
            P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
            for ax in range(3):
                a = v2.refresh_axis_fast(P.clone(), bcs, shape, ax)
                b = v2.refresh_axis_plain(P.clone(), bcs, shape, ax)
                worst_ax = max(worst_ax, float((a - b).abs().max()))
                if not torch.equal(a, b):
                    bad.append(("K2 axis", name, ms, ax))
                del a, b
            bl = k9_blocks(shape, ms, torch.float32, dev, gen)
            if not torch.equal(sfe.write_shell_blocks(P.clone(), *bl, shape),
                               sfe.write_shell_blocks_plain(P.clone(), *bl, shape)):
                bad.append(("K9", name, ms, shape))
            del P, bl
    log("k9", f"at {N_MAIN}^3: the sharded refresh on meshes {SHARDED_MESHES + ((1, 4),)} vs "
              f"the single-device plain refresh, K9 and K2's single-axis entry (axes 0-2) at "
              f"the shard shapes of {SHARDED_MESHES} vs plain, {len(bc_cases())} BC cases, "
              f"f32: mismatches {bad}")
    if bad:
        raise AssertionError(f"K9 / sharded refresh check at {N_MAIN}^3 failed: {bad[:4]}")
    # in a process of its own: late in this one the profiler that names the
    # kernels has recorded none
    torch.cuda.empty_cache()
    child = subprocess.run(
        [sys.executable, "-c", "import sys, torch; sys.path.insert(0, '.'); import chip_smoke; "
         "chip_smoke.k2ax_past_2_31(torch.device('cuda', 0))"],
        capture_output=True, text=True, timeout=900)
    print(child.stdout, end="", flush=True)
    if child.returncode != 0:
        raise AssertionError(f"K2's single-axis route past 2^31 elements failed:\n"
                             f"{child.stderr[-3000:]}")
    periodic = lsm.normalize_bcs(lsm.Periodic(), 3)
    times = {}
    for ms in SHARDED_MESHES:
        shape = (N_MAIN // ms[0], N_MAIN // ms[1], N_MAIN)
        # K9_SETS buffers and block sets in turn: a set's ~13 MB is out of
        # the card's 50 MB L2 by the time it comes round again, so each call
        # reads its blocks and writes its shells from and to HBM, as a stage
        # of the main path does (K1 streams the whole buffer in between)
        sets = [(torch.zeros(v2.padded_shape(shape), device=dev),
                 k9_blocks(shape, ms, torch.float32, dev, gen)) for _ in range(K9_SETS)]
        P, bl = sets[0]
        nbytes = 2 * 4 * sum(b.numel() for b in bl if b is not None)  # read once, written once

        def turns(fn):
            it = itertools.cycle(sets)
            return lambda: fn(*next(it))

        k9 = turns(lambda P, bl: sfe.write_shell_blocks(P, *bl, shape))
        plain = turns(lambda P, bl: sfe.write_shell_blocks_plain(P, *bl, shape))
        k2_axis2 = turns(lambda P, bl: v2.refresh_axis_fast(P, periodic, shape, 2))
        k2_axis2_plain = turns(lambda P, bl: v2.refresh_axis_plain(P, periodic, shape, 2))
        # periodic: each axis-2 ghost (over the padded extent of axes 0 and
        # 1) read once from its source and written once; axis 1's over axis
        # 0's padded extent and axis 2's interior
        k2_bytes = 2 * 4 * 2 * v2.GHOST * (shape[0] + 6) * (shape[1] + 6)
        k2_axis1_bytes = 2 * 4 * 2 * v2.GHOST * (shape[0] + 6) * shape[2]
        # device time per call (the profiler) and the time of one call
        # between CUDA events, the host's issue included; K9 on one set
        # again and again (its blocks and shells stay in L2) beside them
        times[ms] = {"shape": shape, "mb": nbytes / 1e6, "bound": bound(nbytes, 0),
                     "ms": device_ms(k9), "plain_ms": device_ms(plain),
                     "K2_axis2_ms": device_ms(k2_axis2),
                     "K2_axis2_plain_ms": device_ms(k2_axis2_plain),
                     "K2_axis2_bound": bound(k2_bytes, 0),
                     "K2_axis2_sectors": axis2_sector_bytes(shape),
                     "K2_axis1_bound": bound(k2_axis1_bytes, 0), "call_ms": cuda_time(k9),
                     "plain_call_ms": cuda_time(plain),
                     "ms_hot_l2": device_ms(lambda: sfe.write_shell_blocks(P, *bl, shape))}
        r = times[ms]
        log("k9", f"mesh {ms} shard {shape} f32, {K9_SETS} sets in turn: K9 {r['ms']:.4f} ms on "
                  f"the card ({r['call_ms']:.4f} ms a call, host included; one set again and "
                  f"again {r['ms_hot_l2']:.4f}), plain {r['plain_ms']:.4f} ms "
                  f"({r['plain_call_ms']:.4f}), bound {r['bound'][0]:.4f} ms ({r['bound'][1]}, "
                  f"{r['mb']:.2f} MB); K2's axis-2 phase {r['K2_axis2_ms']:.4f} ms, plain "
                  f"{r['K2_axis2_plain_ms']:.4f}, bound {r['K2_axis2_bound'][0]:.4f}")
        del P, bl, sets
    res["k9"] = {"err": worst, "k2ax_err": worst_ax, "times": times}


def phase_sharded(dev, res):
    """The slice's main path: the 512^3 flagship (Zalesak, Periodic, RK3, the
    rotation in-kernel) through ``make_sharded_evolve(fused=True)`` on
    SHARDED_MESHES of the card, SHARDED_STEPS steps, against the
    single-device fused ``integrate`` of the same steps: equal step counts
    and times, the shards unsharded within SHARDED_TOL * max(|ref|, 1) (bit
    for bit expected: every node's arithmetic is the single device's);
    launches counted. Then ms per step of each, in turns; the sharded
    refresh alone per stage (device time and host time); the device busy
    share of a sharded run."""
    grid, phi, _ = zalesak(N_MAIN, dev)
    term = lsm.AdvectionTerm(rotation)
    eq = lsm.LevelSetEquation(terms=term, ic=phi, integrator=lsm.RK3())
    eq.integrate(1.0, max_steps=SHARDED_STEPS)
    ref, ref_t, ref_n = eq.state.values, eq.t, eq.last_nsteps
    del eq
    scale = max(float(ref.abs().max()), 1.0)
    out, runs = {}, {}
    for ms in SHARDED_MESHES:
        mesh = card_mesh(dev, ms)
        ev = par.make_sharded_evolve(lsm.RK3(), mesh, grid, fused=True, max_steps=SHARDED_STEPS)
        sphi = par.shard_field(phi, mesh)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sout, t, n = ev((term,), sphi, 0.0, 1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, tables = read_counts(), v2.program_tables.launches
        vals = par.unshard(sout).values
        err, exact = float((vals - ref).abs().max()), bool(torch.equal(vals, ref))
        refreshes = 3 * n + 1  # one per stage and the pack's
        phases = sum(s == 1 for s in ms) + 1  # K2's phases: the whole axes and axis 2
        want = dict(NONE_LAUNCHED, K1=3 * n * SHARDS, K9=refreshes * SHARDS,
                    K2ax=refreshes * SHARDS * phases, **{"K1''": 3 * n * SHARDS})
        log("sharded", f"{N_MAIN}^3 RK3 in-kernel on mesh {ms} of {dev} (shards "
                       f"{sfe.ShardLayout(mesh, grid).local_shape}): steps {n} (single device "
                       f"{ref_n}) t {t!r} ({ref_t!r}) max|sharded - single|={err:.3e} "
                       f"(tol {SHARDED_TOL:g}*{scale:.3e}) bit for bit {exact}; launches "
                       f"{counts} table fills {tables}; first run {1e3 * wall / n:.4f} ms/step")
        if not (n == ref_n == SHARDED_STEPS and t == ref_t and err <= SHARDED_TOL * scale
                and counts == want and tables == 3 * n * SHARDS):
            raise AssertionError(f"sharded flagship check failed on mesh {ms}")
        out[ms] = {"err": err, "exact": exact, "launches": counts}
        runs[ms] = (ev, sphi)
        del sout, vals
    del ref
    per = collections.defaultdict(list)
    for key in (None, *SHARDED_MESHES, *reversed(SHARDED_MESHES), None):  # in turns
        if key is None:
            per["single"].append(integrate_ms_per_step(term, phi, lsm.RK3(),
                                                       steps=SHARDED_STEPS))
        else:
            ev, sphi = runs[key]
            per[key].append(cuda_time(lambda: ev((term,), sphi, 0.0, 1.0), warmup=1, reps=10)
                            / SHARDED_STEPS)
    refresh = {}
    for ms in SHARDED_MESHES:
        layout = sfe.ShardLayout(card_mesh(dev, ms), grid)
        sphi = runs[ms][1]
        bufs = [v2.pack_padded(sphi.blocks[c], phi.bcs) for c in layout.coords]
        dev_ms = device_ms(lambda: sfe.refresh_ghosts_sharded(bufs, phi.bcs, layout))
        call_ms = cuda_time(lambda: sfe.refresh_ghosts_sharded(bufs, phi.bcs, layout))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            sfe.refresh_ghosts_sharded(bufs, phi.bcs, layout)
        host_ms = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        refresh[ms] = {"ms": dev_ms, "call_ms": call_ms, "host_ms": host_ms}
        del bufs
    ev, sphi = runs[(2, 2)]
    by_kernel = {}
    wall_ms, busy_ms = profile_window(f"sharded flagship, {SHARDED_STEPS} RK3 steps at "
                                      f"{N_MAIN}^3 on mesh (2, 2) of the card",
                                      lambda: ev((term,), sphi, 0.0, 1.0), by_kernel)
    # K9's device time per launch inside the main path's run
    k9_prof = [v for k, v in by_kernel.items() if "shell_blocks_kernel" in k]
    k9_path_ms = sum(v[0] for v in k9_prof) / sum(v[1] for v in k9_prof) if k9_prof else None
    for key, v in per.items():
        where = "single device" if key == "single" else f"mesh {key}"
        log("sharded", f"{N_MAIN}^3 f32 RK3 in-kernel, {where}: "
                       f"{' / '.join(f'{x:.4f}' for x in v)} ms/step (in turns)")
    for ms, r in refresh.items():
        log("sharded", f"mesh {ms}: the sharded refresh (exchange, BC blocks, K9, K2's phases) "
                       f"{r['ms']:.4f} ms per stage on the card, {r['call_ms']:.4f} ms a call "
                       f"between events, {r['host_ms']:.4f} ms of host time to issue it")
    busy = 100 * busy_ms / wall_ms
    log("sharded", f"mesh (2, 2): device busy {busy_ms:.3f} of {wall_ms:.3f} ms wall "
                   f"({busy:.1f}%; host share {100 - busy:.1f}%); K9 {k9_path_ms} ms per "
                   f"launch in that run")
    res["sharded"] = {"check": out, "ms_per_step": dict(per), "refresh": refresh,
                      "busy": (wall_ms, busy_ms), "k9_path_ms": k9_path_ms}
    res["launches"]["K9"] = out[(2, 2)]["launches"]["K9"]
    res["launches"]["K2ax"] = out[(2, 2)]["launches"]["K2ax"]


def sharded_rollout_grad(mesh, phi, v, dt, nsteps):
    """``sum(phi_final^2)`` of the sharded fused RK3 rollout (the rotation
    in-kernel, remat) and its gradient w.r.t. the initial values."""
    ro = sfe.make_sharded_fused_rollout(lsm.RK3(), mesh, phi.grid, nsteps=nsteps)
    loss = (ro((lsm.AdvectionTerm(rotation),), phi.with_values(v), 0.0, dt).values ** 2).sum()
    return loss, torch.autograd.grad(loss, v)[0]


def phase_sharded_grad(dev, res):
    """The sharded rollout's gradient at N_SMALL^3 on a (2, 2) mesh of the
    card against the single-device card rollout (the Zalesak field, the
    rotation in-kernel: K1'' and K3'', RK3, 3 steps, remat): f64 max norm
    within 1e-10 * scale; f32 relative L2 within F32_L2_FACTOR times the
    card's own spread under a 1-ulp change of phi0; launches counted (the
    backward's refresh transpose is plain torch: no K4)."""
    mesh = card_mesh(dev, (2, 2))
    errs, counts = {}, None
    for dtype in (torch.float32, torch.float64):
        grid, phi, _ = zalesak(N_SMALL, dev, dtype)
        dt = 0.25 * grid.min_spacing
        torch.cuda.synchronize()
        reset_counts()
        loss, g = sharded_rollout_grad(mesh, phi, phi.values.clone().requires_grad_(), dt, 3)
        torch.cuda.synchronize()
        counts = read_counts() if dtype == torch.float64 else counts
        loss_r, g_r = rollout_grad(phi, phi.values.clone().requires_grad_(), dt, 3)
        loss, loss_r = float(loss.detach()), float(loss_r.detach())
        errs[dtype] = (float((g - g_r).abs().max()), max(float(g_r.abs().max()), 1.0),
                       rel_l2(g, g_r), abs(loss - loss_r) / abs(loss_r))
        if dtype == torch.float32:
            gen = torch.Generator(device=dev).manual_seed(12)
            pert = phi.values * (1 + 2.0 ** -23 * torch.randn(grid.shape, generator=gen,
                                                              device=dev))
            ulp_l2 = rel_l2(rollout_grad(phi, pert.requires_grad_(), dt, 3)[1], g_r)
    (e32, s32, l2_32, _), (e64, s64, _, lrel64) = errs[torch.float32], errs[torch.float64]
    log("sharded_grad", f"{N_SMALL}^3 RK3 rollout x3 (remat) on mesh (2, 2) of the card vs the "
                        f"single-device card rollout: f64 max|diff|={e64:.3e} scale={s64:.3e} "
                        f"(tol 1e-10*scale), loss rel {lrel64:.2e}; f32 max|diff|={e32:.3e} "
                        f"scale={s32:.3e} (reported), relative L2 {l2_32:.3e} (tol "
                        f"{F32_L2_FACTOR:g}x the card's 1-ulp spread {ulp_l2:.3e}); f64 launches "
                        f"{counts}")
    if not (e64 <= 1e-10 * s64 and l2_32 <= F32_L2_FACTOR * ulp_l2 and counts["K9"] > 0
            and counts["K3''"] > 0 and counts["K4"] == 0 and counts["K2"] == 0):
        raise AssertionError("sharded gradient check failed")
    res["sharded_grad"] = errs


def phase_sharded_general(dev, res):
    """The sharded general path on a (2, 2) mesh of the card against the
    single-device card runs: ``make_sharded_step`` at N_SMALL^3 (Zalesak,
    streamed rotation, RK3; K10 per shard and stage) and at N_2D_SMALL^2
    (configuration 2's disk; K11), and the sharded band evolve (the
    off-axis sphere band, streamed spin, 3 RK3 steps) against the
    single-device general band path (``fast="off"``), f32."""
    mesh = card_mesh(dev, (2, 2))
    grid, phi, vel = zalesak(N_SMALL, dev)
    dt = 0.25 * grid.min_spacing
    term = lsm.AdvectionTerm(vel)
    reset_counts()
    got = par.make_sharded_step(lsm.RK3(), mesh, grid)((term,), phi, 0.0, dt)
    torch.cuda.synchronize()
    c3 = read_counts()
    reset_counts()
    want, _ = lsm.RK3().advance((term,), phi, 0.0, dt)
    e3 = float((got.values - want.values).abs().max())
    ex3 = bool(torch.equal(got.values, want.values))
    terms2, phi2, _ = config("D2h", N_2D_SMALL, dev)
    vel2 = lsm.sample(lambda x, y: (0.5 - y + 0 * x, x - 0.5 + 0 * y), phi2.grid, vector=True,
                      device=dev)
    term2 = lsm.AdvectionTerm(vel2)
    dt2 = 0.25 * phi2.grid.min_spacing
    reset_counts()
    got2 = par.make_sharded_step(lsm.RK3(), mesh, phi2.grid)((term2,), phi2, 0.0, dt2)
    torch.cuda.synchronize()
    c2 = read_counts()
    want2, _ = lsm.RK3().advance((term2,), phi2, 0.0, dt2)
    e2 = float((got2.values - want2.values).abs().max())
    nb = sphere_band(N_SMALL, dev, center=(0.5, 0.0, 0.0), radius=0.4)
    velb = lsm.sample(lambda x, y, z: spin((x, y, z), 0.0), nb.grid, vector=True, device=dev)
    termb = lsm.AdvectionTerm(velb)
    reset_counts()
    bout, bt, bn = par.make_sharded_evolve(lsm.RK3(), mesh, nb.grid, max_steps=3,
                                           is_band=True)((termb,), nb, 0.0, 1.0)
    torch.cuda.synchronize()
    cb = read_counts()
    eq = lsm.LevelSetEquation(terms=termb, ic=nb, integrator=lsm.RK3())
    eq.integrate(1.0, max_steps=3, fast="off")
    eb, scb, dmask, dcmask = band_diff(bout, eq.state)
    log("sharded_general", f"make_sharded_step {N_SMALL}^3 RK3 on mesh (2, 2): max|sharded - "
                           f"single|={e3:.3e} bit for bit {ex3} launches {c3}; 2D "
                           f"{N_2D_SMALL}^2: {e2:.3e} launches {c2}; band evolve x{bn} t={bt:.6f} "
                           f"(single {eq.last_nsteps}, {eq.t:.6f}): {eb:.3e} (scale {scb:.3e}) "
                           f"mask mismatches {dmask} ({dcmask}) launches {cb}")
    if not (e3 <= 1e-6 and c3 == dict(NONE_LAUNCHED, K10=3 * SHARDS) and e2 <= 1e-6
            and c2 == dict(NONE_LAUNCHED, K11=3 * SHARDS) and bn == eq.last_nsteps == 3
            and dmask == dcmask == 0 and eb <= 1e-6 * scb and cb["K10"] == 3 * 3 * SHARDS):
        raise AssertionError("sharded general path check failed")


def phase_dryrun(dev, res):
    """The dryrun counterpart on SHARDS shards of the card: a sharded
    training step through the fused rollout, then the sharded dense, band
    and fused evolves for 3 steps each."""
    out = dryrun_multichip(SHARDS, devices=[dev] * SHARDS)
    log("dryrun", f"dryrun_multichip({SHARDS}) on {dev}: {out}")


# -- the 2D band (the 2D entries of K6, K7 and K8) ------------------------------------


def rotation2(xs, t):
    """Configuration 2's rigid rotation: 2 pi about (0.5, 0.5)."""
    return shapes.rigid_rotation_velocity((0.5, 0.5), 2.0 * math.pi)(xs, t)


def corner_band(shape, dev, dtype):
    """A circle band about the corner (0.1, 0.9) of [0, 1]^2 that crosses the
    faces x = 0 and y = 1, the ragged last tiles and tile boundaries."""
    grid = lsm.Grid((0.0, 0.0), (1.0, 1.0), shape)
    phi = lsm.sample(shapes.circle((0.1, 0.9), 0.35), grid, lsm.Extrapolation(2), dtype=dtype,
                     device=dev)
    return lsm.NarrowBandField.from_field(phi)


def bc_cases_2d():
    return {
        "periodic": lsm.normalize_bcs(lsm.Periodic(), 2),
        "symmetry": lsm.normalize_bcs(lsm.Symmetry(), 2),
        "extrap0": lsm.normalize_bcs(lsm.Extrapolation(0), 2),
        "extrap2": lsm.normalize_bcs(lsm.Extrapolation(2), 2),
        "mixed": lsm.normalize_bcs([(lsm.Symmetry(), lsm.Extrapolation(1)),
                                    (lsm.Extrapolation(3), lsm.Symmetry())], 2),
    }


def k6_2d_cases(nb, gen):
    """K6 2D's term lists as ``(name, terms, with_aux, route)``: a streamed
    velocity (the advection entry), the rotation and the vortex traced into
    programs (K6'', the vortex with aux), and a 3-term sum of the kinds with
    aux (K6': streamed normal speed, constant curvature, the recomputed
    eikonal sign)."""
    dev, dtype, g = nb.device, nb.dtype, nb.grid
    vel = lsm.MeshField(0.5 * torch.randn((2, *nb.shape), generator=gen, device=dev,
                                          dtype=dtype), g)
    speed = torch.randn(nb.shape, generator=gen, device=dev, dtype=dtype)
    speed[:, ::4] = 0.0  # ties
    return [("streamed", (lsm.AdvectionTerm(vel),), False, "stream"),
            ("rotation", (lsm.AdvectionTerm(rotation2),), False, "program"),
            ("vortex", (lsm.AdvectionTerm(shapes.vortex_velocity(period=4.0)),), True,
             "program"),
            ("3-term sum", (lsm.NormalMotionTerm(lsm.MeshField(speed, g)),
                            lsm.CurvatureTerm(-0.05), lsm.EikonalReinitializationTerm()), True,
             "stream")]


def phase_k6k7k8_2d(dev, res):
    """The 2D entries of K6, K7 and K8 against their plain versions at
    BAND_2D_SMALL (ragged 16x16 tiles on both axes), f32 and f64, on a band
    that crosses the faces x = 0 and y = 1. K6 (each case of
    :func:`k6_2d_cases`, its terms tile-packed by the band stepper): within
    K1's bound on the dispatched compute band (curvature: off its eps gate),
    bit for bit elsewhere. K7: bit for bit at K7_2D_SHAPES under their BC
    cases with all four flags (:func:`k7_compare`). K8: the mask, flags,
    activity, dispatch list and count
    exactly, the mask also against the full re-tube."""
    gen = torch.Generator(device=dev).manual_seed(29)
    halo = lsm.NarrowBandField.COMPUTE_HALO
    worst = {"K6 2D": 0.0, "K6' 2D": 0.0, "K6'' 2D": 0.0}
    for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
        nb = corner_band(BAND_2D_SMALL, dev, dtype)
        shape, sp, lo = nb.shape, nb.grid.spacing, nb.grid.lo
        tiles = default_tiles(nb.nlayers, 2)
        band = combined(nb)
        act = bd.tile_activity(band, tiles)
        P = v2.pack_padded(nb.values, nb.bcs)
        A = v2.pack_padded(nb.values + 0.01 * torch.randn(shape, generator=gen, device=dev,
                                                          dtype=dtype), nb.bcs)
        target = P + torch.randn(P.shape, generator=gen, device=dev, dtype=dtype)
        gate = gate_nodes(P, sp, shape)
        for name, terms, with_aux, route in k6_2d_cases(nb, gen):
            stepper = FusedBandStepper(terms, nb, lsm.RK3(), capacity=int(act.sum()) + 5)
            routes = [spec.route for spec, _ in stepper.entries]
            if routes != [route] + ["const", "none"][:len(terms) - 1]:
                raise AssertionError(f"K6 2D {name}: routes {routes}")
            state = stepper.pack(nb)
            packed = stepper.stage_terms(state, T_STAGE)
            disp = bd.dispatched_cells(state.ids, shape, tiles)
            cm = band != 0
            on = disp & cm & (~gate if has_curvature(packed) else torch.ones_like(gate))
            off_list = ~inside(shape, disp, dev)
            aux, coeffs = (A, (0.75, 0.25, 2.5e-4)) if with_aux else (None, (0.0, 1.0, 1e-3))
            where = v2.Where(lo, None, T_STAGE)
            got = bd.band_stage(P, target.clone(), state.ids, band, packed, coeffs, aux, sp,
                                shape, tiles, where)
            ref = bd.band_stage_plain(P, target.clone(), state.ids, band, packed, coeffs, aux,
                                      sp, shape, tiles, where)
            torch.cuda.synchronize()
            g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
            err, scale = kinds_err(g, r, on)
            kept = torch.equal(g[disp & ~cm], v2.unpack_padded(P, shape)[disp & ~cm])
            untouched = torch.equal(got[off_list], target[off_list])
            log("k6k7k8_2d", f"K6 2D {str(dtype)[6:]} {name:10s} route {route:7s} "
                             f"aux={with_aux!s:5s} tiles={tiles} slots={stepper.capacity} "
                             f"max|kernel-plain|={err:.3e} scale={scale:.3e} tol={tol:g}*scale; "
                             f"source kept off the band: {kept}, other tiles and shells "
                             f"untouched: {untouched}")
            if not (bool(torch.isfinite(g).all()) and err <= tol * scale and kept and untouched):
                raise AssertionError(f"K6 2D parity failed ({dtype}, {name})")
            if dtype == torch.float32:
                key = {"streamed": "K6 2D", "3-term sum": "K6' 2D"}.get(name, "K6'' 2D")
                worst[key] = max(worst[key], err)
        for k7_shape in K7_2D_SHAPES:
            k7_compare("k6k7k8_2d", k7_shape, shell_cases_2d(k7_shape), dtype, dev, gen)
        h = sp[0]
        grid = nb.grid
        moved = lsm.sample(shapes.circle((0.1 + 1.5 * h, 0.9 - 0.5 * h), 0.35), grid,
                           lsm.Extrapolation(2), dtype=dtype, device=dev)
        Pm = v2.pack_padded(moved.values, nb.bcs)
        total = act.numel()
        cids, ccount = bd.compact_ids(box_dilate(act, 1), total)
        out = {}
        for label, fn in (("kernel", bd.band_retube_incremental), ("plain", bd.band_retube_plain)):
            b = band.clone()
            flags = fn(Pm, b, cids, nb.nlayers, halo, shape, tiles, ccount)
            new_act = bd.scatter_activity(act, cids, flags)
            ids2, count2 = bd.compact_ids(new_act | act, total)
            out[label] = (b, flags, new_act, ids2, count2)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out["kernel"], out["plain"]))
        full = bd.retube_full(moved.values, band, nb.nlayers, halo)
        exact_full = torch.equal(out["kernel"][0], full)
        changed = int((out["kernel"][0] != band).sum())
        log("k6k7k8_2d", f"K8 2D {str(dtype)[6:]} candidates={int((cids >= 0).sum())} of "
                         f"{total} tiles, nodes changed={changed}: kernel == plain (mask, flags, "
                         f"activity, ids, count) {same}; == full re-tube {exact_full}")
        if not (same and exact_full and changed > 0):
            raise AssertionError(f"K8 2D parity failed ({dtype})")
    res["k6_2d_err"] = worst
    res["k7_2d_err"], res["k8_2d_err"] = 0.0, 0.0


def k6_tiles_compare(label, nb, tiles, cases, gen, tol):
    """K6 (each ``(name, terms, with_aux)`` of ``cases``, its terms packed by
    a band stepper with ``tiles``) against its plain version on the band
    ``nb``: within ``tol`` of max(|ref|, 1) on the dispatched compute band
    (curvature: off its eps gate), bit for bit elsewhere. Returns the
    largest difference over the scale."""
    dev, dtype, shape, sp = nb.device, nb.dtype, nb.shape, nb.grid.spacing
    band = combined(nb)
    P = v2.pack_padded(nb.values, nb.bcs)
    A = v2.pack_padded(nb.values + 0.01 * torch.randn(shape, generator=gen, device=dev,
                                                      dtype=dtype), nb.bcs)
    target = P + torch.randn(P.shape, generator=gen, device=dev, dtype=dtype)
    gate = gate_nodes(P, sp, shape)
    worst = 0.0
    for name, terms, with_aux in cases:
        stepper = FusedBandStepper(terms, nb, lsm.RK3(), tiles=tiles)
        state = stepper.pack(nb)
        packed = stepper.stage_terms(state, T_STAGE)
        disp = bd.dispatched_cells(state.ids, shape, tiles)
        on = disp & (band != 0) & (~gate if has_curvature(packed) else torch.ones_like(gate))
        off_list = ~inside(shape, disp, dev)
        aux, coeffs = (A, (0.75, 0.25, 2.5e-4)) if with_aux else (None, (0.0, 1.0, 1e-3))
        args = (state.ids, band, packed, coeffs, aux, sp, shape, tiles,
                v2.Where(nb.grid.lo, None, T_STAGE))
        got = bd.band_stage(P, target.clone(), *args)
        ref = bd.band_stage_plain(P, target.clone(), *args)
        torch.cuda.synchronize()
        g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
        err, scale = kinds_err(g, r, on)
        kept = torch.equal(g[disp & (band == 0)], v2.unpack_padded(P, shape)[disp & (band == 0)])
        untouched = torch.equal(got[off_list], target[off_list])
        if not (bool(torch.isfinite(g).all()) and err <= tol * scale and kept and untouched):
            raise AssertionError(f"{label} {name} tiles {tiles}: K6 parity failed, err {err} "
                                 f"scale {scale}, kept {kept}, untouched {untouched}")
        worst = max(worst, err / scale)
    return worst


def phase_band_tiles(dev, res):
    """Every tile shape of ``tools/band_tile_sweep.py`` (SWEEP_TILES,
    SWEEP_TILES_2D), f32 and f64: K6 (a streamed velocity), K6'' (the
    rotation in-kernel) and K6' (a streamed normal speed beside a constant
    curvature, with aux) against their plain versions, within K1's bound,
    and K8 on the candidates after the interface moved by about a cell,
    bit for bit. 3D at BAND_SMALL, 2D at BAND_2D_SMALL, on bands that reach
    faces; the largest tiles give K6 its largest box of shared memory and
    K8 rows of several words."""
    gen = torch.Generator(device=dev).manual_seed(41)
    for dtype, tol in ((torch.float32, K1_TOL), (torch.float64, 1e-12)):
        grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), BAND_SMALL)
        nb = lsm.NarrowBandField.from_field(lsm.sample(
            shapes.sphere((0.1, 0.5, 0.9), 0.35), grid, lsm.Extrapolation(2), dtype=dtype,
            device=dev))
        vel = lsm.MeshField(0.5 * torch.randn((3, *nb.shape), generator=gen, device=dev,
                                              dtype=dtype), grid)
        speed = torch.randn(nb.shape, generator=gen, device=dev, dtype=dtype)
        cases = [("streamed", (lsm.AdvectionTerm(vel),), False),
                 ("rotation", (lsm.AdvectionTerm(spin),), False),
                 ("normal+curvature", (lsm.NormalMotionTerm(lsm.MeshField(speed, grid)),
                                       lsm.CurvatureTerm(-0.05)), True)]
        moved = lsm.sample(shapes.sphere((0.1 + 1.5 * grid.spacing[0], 0.5, 0.9), 0.35), grid,
                           lsm.Extrapolation(2), dtype=dtype, device=dev)
        Pm = v2.pack_padded(moved.values, nb.bcs)
        for tiles in SWEEP_TILES:
            err = k6_tiles_compare("3D", nb, tiles, cases, gen, tol)
            band = combined(nb)
            k8_compare("band_tiles", f"{str(dtype)[6:]} 3D", Pm, band,
                       bd.tile_activity(band, tiles), nb.nlayers, nb.shape, tiles)
            log("band_tiles", f"K6/K6''/K6' {str(dtype)[6:]} grid={nb.shape} tiles={tiles}: "
                              f"max|kernel-plain|/scale {err:.1e} (tol {tol:g})")
        nb2 = corner_band(BAND_2D_SMALL, dev, dtype)
        moved2 = lsm.sample(shapes.circle((0.1 + 1.5 * nb2.grid.spacing[0], 0.9), 0.35),
                            nb2.grid, lsm.Extrapolation(2), dtype=dtype, device=dev)
        Pm2 = v2.pack_padded(moved2.values, nb2.bcs)
        cases2 = [case[:3] for case in k6_2d_cases(nb2, gen)]
        for tiles in SWEEP_TILES_2D:
            err = k6_tiles_compare("2D", nb2, tiles, cases2, gen, tol)
            band = combined(nb2)
            k8_compare("band_tiles", f"{str(dtype)[6:]} 2D", Pm2, band,
                       bd.tile_activity(band, tiles), nb2.nlayers, nb2.shape, tiles)
            log("band_tiles", f"K6 2D {str(dtype)[6:]} grid={nb2.shape} tiles={tiles}: "
                              f"max|kernel-plain|/scale {err:.1e} (tol {tol:g})")


def d2b(n, dev, dtype=torch.float32):
    """D2b: configuration 2 (the Zalesak disk under the rigid rotation, RK3)
    at n^2 as a 3-layer band. A NarrowBandField refuses Periodic BCs (as
    JAX's and the reference's), so the band takes Extrapolation(2): the disk
    stays 0.1 from every face, so no ghost is read and the values are
    configuration 2's."""
    eq = bench.config2_zalesak(n, dtype=dtype, device=dev)
    phi = eq.state.with_bcs(lsm.Extrapolation(2), replace=True)
    return eq.terms, lsm.NarrowBandField.from_field(phi, nlayers=3), eq.integrator


def d4b(n, dev, dtype=torch.float32):
    """D4b: configuration 4 (the star, curvature -0.05 and normal motion 0.2,
    Extrapolation(2), RK3) at n^2 as a 3-layer band."""
    eq = bench.config4_curvature_normal(n, dtype=dtype, device=dev)
    return eq.terms, lsm.NarrowBandField.from_field(eq.state, nlayers=3), eq.integrator


def grad2b(n, nsteps, dtype, device):
    """grad2b: configuration 5's loss in 2D. ``(loss_and_grad, phi0,
    speed0)``: the circle of radius 0.45 on [-1, 1]^2, Extrapolation(1), a
    3-layer band, normal motion at a streamed speed (0.1), ``nsteps`` RK3
    steps of ``rollout`` at dt = 0.4 h, loss ``(area - 0.3)^2``, gradients
    with respect to phi0 and the speed."""
    grid = lsm.Grid((-1.0, -1.0), (1.0, 1.0), (n, n))
    phi0 = lsm.sample(shapes.circle((0.0, 0.0), 0.45), grid, lsm.Extrapolation(1), dtype=dtype,
                      device=device)
    speed0 = torch.full(grid.shape, 0.1, dtype=dtype, device=phi0.device)
    dt = float(torch.tensor(0.4, dtype=dtype) * grid.min_spacing)

    def loss_and_grad(phi_values, speed_values):
        with torch.enable_grad():
            v = phi_values.detach().requires_grad_()
            s = speed_values.detach().requires_grad_()
            phi = lsm.NarrowBandField(v, grid, phi0.bcs, nlayers=3, _normalized=True)
            term = lsm.NormalMotionTerm(lsm.MeshField(s, grid, phi0.bcs, _normalized=True))
            out, _ = lsm.rollout(lsm.RK3(), (term,), phi, 0.0, dt, nsteps)
            loss = (geo.volume(out) - 0.3) ** 2
            dphi, dspeed = torch.autograd.grad(loss, (v, s))
        return loss.detach(), (dphi, dspeed)

    return loss_and_grad, phi0, speed0


def phase_band2d_4096(dev, res):
    """The 2D band at N_2D^2 f32. D2b and D4b: BAND_2D_CHECK_STEPS steps
    through the kernels and through their plain versions (values within
    K1's bound, equal masks); ``integrate`` of BAND_2D_STEPS steps counting
    launches (the 2D entries of K6 and K7 once per stage, K8 once per step,
    nothing else) and its ms per step, with D2 (dense) beside D2b; grad2b's
    ``loss_and_grad`` (K6' and K7 forward, K8, the plain band backward)
    with its launches, ms and peak memory; the device's busy share of each.
    At N_BAND_2D_SMALL^2 f64: D2b's trajectory card against CPU (1e-12) and
    grad2b's gradients card (band stepper) against CPU (general path),
    1e-10*scale; in f32 card against CPU by relative L2, against the CPU's
    own spread under a 1-ulp change of phi0. K7 2D on D2b's field under the
    four flags and the BC cases, bit for bit against its plain version. Then
    K6 2D (streamed and in-kernel rotation), K7 2D (flags on and off) and K8
    2D alone on D2b's state,
    beside their plain versions."""
    t, mem, busy, n = res["t"], {}, {}, N_2D
    cells = {}
    for name, make in (("D2b", d2b), ("D4b", d4b)):
        terms, nb, integ = make(n, dev)
        h = nb.grid.min_spacing
        dt = 0.25 * h if name == "D2b" else 0.2 * h * h / 0.1
        (kst, kstate), (pst, pstate) = (
            run_band_stepper(cls, nb, integ, dt, BAND_2D_CHECK_STEPS, terms=terms)
            for cls in (FusedBandStepper, PlainBandStepper))
        got, ref = kst.unpack(kstate), pst.unpack(pstate)
        err, scale, dmask, dcmask = band_diff(got, ref)
        log("band2d_4096", f"{name} {n}^2 f32 RK3 x{BAND_2D_CHECK_STEPS} kernels vs plain: "
                           f"max|diff|={err:.3e} scale={scale:.3e} tol={K1_TOL:g}*scale, mask "
                           f"mismatches {dmask} (compute {dcmask})")
        if not (bool(torch.isfinite(got.values).all()) and err <= K1_TOL * scale
                and dmask == dcmask == 0):
            raise AssertionError(f"{name}: the 2D band kernels and their plain versions disagree")
        res[f"{name}_err"] = err
        k8_after_step("band2d_4096", f"2D {name} {n}^2 f32, step {BAND_2D_CHECK_STEPS + 1}",
                      kst, kstate, BAND_2D_CHECK_STEPS * dt, dt)
        del kst, kstate, pst, pstate
        del got, ref
        eq = lsm.LevelSetEquation(terms=terms, ic=nb, integrator=integ)
        torch.cuda.synchronize()
        reset_counts()
        eq.integrate(1.0, max_steps=BAND_2D_STEPS)
        torch.cuda.synchronize()
        counts = read_counts()
        steps, stages = eq.last_nsteps, len(_STAGES[type(integ)])
        entry = "K6''" if name == "D2b" else "K6'"
        want = dict(NONE_LAUNCHED, K6=stages * steps, K7=stages * steps, K8=steps,
                    **{"K6 2D": stages * steps, "K7 2D": stages * steps, "K8 2D": steps,
                       entry: stages * steps})
        cells[name] = int(eq.state.compute_mask.sum())
        log("band2d_4096", f"{name} integrate: steps={steps} path={eq.last_fast_path} "
                           f"compute-band nodes {cells[name]} of {n * n}, launches {counts}")
        if not (steps == BAND_2D_STEPS and eq.last_fast_path == "band" and counts == want
                and bool(torch.isfinite(eq.state.values).all())):
            raise AssertionError(f"{name}: the 2D band main path check failed")
        if name == "D2b":
            res["launches"].update({k: counts[k] for k in ("K6 2D", "K7 2D", "K8 2D")})
            res["launches"]["K6'' 2D"] = counts["K6''"]
        else:
            res["launches"]["K6' 2D"] = counts["K6'"]
        key = f"{name}_integrate@{n}"
        t[key] = integrate_ms_per_step(terms, nb, integ, path="band")
        mem[key] = peak_gib(lambda: lsm.LevelSetEquation(terms=terms, ic=nb, integrator=integ)
                            .integrate(1.0, max_steps=BAND_2D_STEPS))
        busy[key] = profile_window(f"{name} integrate x{BAND_2D_STEPS} at {n}^2", lambda: (
            lsm.LevelSetEquation(terms=terms, ic=nb, integrator=integ)
            .integrate(1.0, max_steps=BAND_2D_STEPS)))
        del eq, nb
        torch.cuda.empty_cache()
    terms, phi, integ = config("D2", n, dev)
    t[f"D2_integrate@{n}"] = integrate_ms_per_step(terms, phi, integ)
    mem[f"D2_integrate@{n}"] = peak_gib(lambda: lsm.LevelSetEquation(
        terms=terms, ic=phi, integrator=integ).integrate(1.0, max_steps=BAND_2D_STEPS))
    del phi
    torch.cuda.empty_cache()
    # grad2b at N_2D^2 f32
    fn, phi0, speed0 = grad2b(n, GRAD2B_STEPS, torch.float32, dev)
    torch.cuda.synchronize()
    reset_counts()
    loss, (dphi, dspeed) = fn(phi0.values, speed0)
    torch.cuda.synchronize()
    counts = read_counts()
    finite = bool(torch.isfinite(dphi).all()) and bool(torch.isfinite(dspeed).all())
    stages = 3 * GRAD2B_STEPS
    log("band2d_4096", f"grad2b {n}^2 f32 x{GRAD2B_STEPS} RK3 loss_and_grad: loss "
                       f"{float(loss):.6e} finite={finite} launches {counts}")
    if not (finite and counts["K6 2D"] >= stages and counts["K6'"] >= stages
            and counts["K7 2D"] >= stages and counts["K8 2D"] >= GRAD2B_STEPS
            and counts["K6 2D"] == counts["K6"]):
        raise AssertionError("grad2b at 4096^2 failed")
    del dphi, dspeed
    call = lambda: fn(phi0.values, speed0)
    t[f"grad2b@{n}"] = cuda_time(call, warmup=1, reps=3)
    mem[f"grad2b@{n}"] = peak_gib(call)
    busy[f"grad2b@{n}"] = profile_window(f"grad2b loss_and_grad at {n}^2", call)
    del fn, phi0, speed0
    torch.cuda.empty_cache()
    # N_BAND_2D_SMALL^2 f64: card against CPU
    m = N_BAND_2D_SMALL
    out = {}
    for where in ("cpu", dev):
        terms, nb, integ = d2b(m, where, torch.float64)
        eq = lsm.LevelSetEquation(terms=terms, ic=nb, integrator=integ)
        eq.integrate(0.05)
        out[str(where)] = eq
    a, b = out[str(dev)], out["cpu"]
    err, scale, dmask, dcmask = band_diff(a.state, b.state)
    moved = int((a.state.mask != nb.mask).sum())
    log("band2d_4096", f"D2b {m}^2 f64 integrate to t=0.05, card vs CPU: steps "
                       f"{a.last_nsteps}/{b.last_nsteps} paths {a.last_fast_path}/"
                       f"{b.last_fast_path} max|diff|={err:.3e} scale={scale:.3e} (tol "
                       f"1e-12*scale) mask mismatches {dmask} (compute {dcmask}); the band "
                       f"moved: {moved} nodes changed")
    if not (a.last_nsteps == b.last_nsteps and a.last_fast_path == b.last_fast_path == "band"
            and err <= 1e-12 * scale and dmask == dcmask == 0 and moved > 0):
        raise AssertionError("D2b card-vs-CPU trajectory check failed")
    noise = CONFIG5_NOISE * torch.randn((m, m), generator=torch.Generator().manual_seed(7),
                                        dtype=torch.float64)
    pert = torch.randn((m, m), generator=torch.Generator().manual_seed(8))
    grads = {}
    for label, where, dtype, ulp in (("cpu", "cpu", torch.float64, 0.0),
                                     ("card", dev, torch.float64, 0.0),
                                     ("cpu32", "cpu", torch.float32, 0.0),
                                     ("card32", dev, torch.float32, 0.0),
                                     ("cpu32_ulp", "cpu", torch.float32, 2.0 ** -23)):
        fn, phi0, speed0 = grad2b(m, GRAD2B_STEPS, dtype, where)
        v = (phi0.values + noise.to(where, dtype)) * (1 + ulp * pert.to(where, dtype))
        loss, g = fn(v, speed0)
        grads[label] = [x.cpu().double() for x in (loss, *g)]
    card, cpu = grads["card"], grads["cpu"]
    e64 = [float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(card, cpu)]
    l2_32 = [rel_l2(x, y) for x, y in zip(grads["card32"][1:], grads["cpu32"][1:])]
    spread = [rel_l2(x, y) for x, y in zip(grads["cpu32_ulp"][1:], grads["cpu32"][1:])]
    log("band2d_4096", f"grad2b {m}^2 x{GRAD2B_STEPS} RK3: card (band stepper) vs CPU (general "
                       f"path) f64 max|diff|/max|ref| loss {e64[0]:.2e} dphi {e64[1]:.2e} "
                       f"dspeed {e64[2]:.2e} (tol 1e-10); f32 relative L2 dphi {l2_32[0]:.3e} "
                       f"dspeed {l2_32[1]:.3e} (tol {F32_L2_FACTOR:g}x the CPU's 1-ulp spread "
                       f"{spread[0]:.3e}, {spread[1]:.3e})")
    if not (max(e64) <= 1e-10 and all(x <= F32_L2_FACTOR * y for x, y in zip(l2_32, spread))):
        raise AssertionError("grad2b card-vs-CPU gradient check failed")
    res["grad2b_rel"] = {"f64": e64, "f32_l2": l2_32, "cpu_f32_ulp_spread": spread}
    # the kernels alone on D2b's state at N_2D^2
    terms, nb, integ = d2b(n, dev)
    shape, sp, halo = nb.shape, nb.grid.spacing, lsm.NarrowBandField.COMPUTE_HALO
    st_ = FusedBandStepper(terms, nb, integ)
    state = st_.pack(nb)
    P, out_buf = state.bufs[0], state.bufs[1]
    dt = 0.25 * nb.grid.min_spacing
    prog = st_.stage_terms(state, 0.0)
    spec = prog[0][0]
    # the rotation tile-packed, its two 2D components (the embedding's first is zero)
    u = tuple(c.contiguous() for c in st_._slot_values(spec, state, 0.0))[1:]
    coeffs, where = (0.0, 1.0, dt), v2.Where(nb.grid.lo, None, 0.0)
    t["K6_2d"] = cuda_time(lambda: bd.band_stage(P, out_buf, state.ids, state.band, u, coeffs,
                                                 None, sp, shape, st_.tiles, where))
    t["K6_2d_plain"] = cuda_time(lambda: bd.band_stage_plain(
        P, out_buf, state.ids, state.band, u, coeffs, None, sp, shape, st_.tiles, where),
        warmup=1, reps=5)
    t["K6pp_2d"] = cuda_time(lambda: bd.band_stage(P, out_buf, state.ids, state.band, prog,
                                                   coeffs, None, sp, shape, st_.tiles, where))
    t["K6pp_2d_plain"] = cuda_time(lambda: bd.band_stage_plain(
        P, out_buf, state.ids, state.band, prog, coeffs, None, sp, shape, st_.tiles, where),
        warmup=1, reps=5)
    k7_compare("band2d_4096", shape, {"band": nb.bcs, **shell_cases_2d(shape)}, nb.dtype, dev,
               torch.Generator(device=dev).manual_seed(18), vals=nb.values)
    on = torch.ones(2, dtype=torch.int32, device=dev)
    off = torch.zeros(2, dtype=torch.int32, device=dev)
    t["K7_2d"] = cuda_time(lambda: bd.refresh_band_ghosts_fast(P, nb.bcs, shape, on))
    t["K7_2d_off"] = cuda_time(lambda: bd.refresh_band_ghosts_fast(P, nb.bcs, shape, off))
    t["K7_2d_plain"] = cuda_time(lambda: bd.refresh_band_ghosts_plain(P, nb.bcs, shape, on))
    cids, count = bd.compact_ids(box_dilate(state.act, 1), st_.total)
    band = state.band.clone()
    t["K8_2d"] = cuda_time(lambda: bd.band_retube_incremental(P, band, cids, nb.nlayers, halo,
                                                              shape, st_.tiles, count))
    t["K8_2d_plain"] = cuda_time(lambda: bd.band_retube_plain(P, band, cids, nb.nlayers, halo,
                                                              shape, st_.tiles, count),
                                 warmup=1, reps=5)
    flat, valid = bd.tile_index(state.ids, shape, st_.tiles)
    cand = bd.dispatched_cells(cids, shape, st_.tiles)
    reach = box_dilate(cand, k8_reach(nb.nlayers))
    res["band2d_work"] = {
        "dispatched": int(valid.sum()),
        "ops_cells": int(((state.band.view(-1)[flat] != 0) & valid).sum()),
        "cand_cells": int(cand.sum()), "cand_reach_cells": int(reach.sum()),
        "active_reach_cells": int((reach & (band == bd.ACTIVE)).sum()),
        "ghosts": (n + 6) ** 2 - n ** 2, "tiles": st_.tiles, "slots": int(state.count),
        "prog": program_work(spec.coef_static, (1, *shape))}
    log("band2d_4096", f"D2b {n}^2 state: tiles {st_.tiles}, dispatched {int(state.count)} "
                       f"of {st_.total} ({res['band2d_work']['dispatched']} nodes), "
                       f"compute-band nodes {res['band2d_work']['ops_cells']}, K8 candidates "
                       f"{int((cids >= 0).sum())} ({res['band2d_work']['cand_cells']} nodes)")
    for name in [k for k in t if k.endswith(("_2d", "_2d_plain", "_2d_off")) or
                 k.startswith(("D2b", "D4b", "D2_", "grad2b"))]:
        log("band2d_4096", f"f32 {name:24s} median {t[name]:.4f} ms")
    log("band2d_4096", "peak memory: " + ", ".join(f"{k} {v:.3f} GiB" for k, v in mem.items()))
    log("band2d_4096", "wall and device busy ms: " + ", ".join(
        f"{k} {w:.3f}/{b:.3f} ({100 * b / w:.1f}%)" for k, (w, b) in busy.items()))
    res["mem"].update(mem)
    res["busy_2d"] = busy


# -- the ghost kernels' route for an Extrapolation of degree above 7 -------------------


def degree_cases(ndim):
    """Extrapolation(8), Extrapolation(11), and degrees 8 and 11 mixed per
    side with Symmetry and Periodic (an axis of at least 12 nodes)."""
    E = lsm.Extrapolation
    mixed = ([(E(8), lsm.Symmetry()), lsm.Periodic(), (lsm.Symmetry(), E(11))] if ndim == 3
             else [(E(11), lsm.Symmetry()), lsm.Periodic()])
    return {"extrap8": lsm.normalize_bcs(E(8), ndim), "extrap11": lsm.normalize_bcs(E(11), ndim),
            "mixed8_11": lsm.normalize_bcs(mixed, ndim)}


def high_degree_cases(ndim):
    """Degrees 17 and 19 (nodes in three chunks of the table route's loads)
    per side with Periodic and Symmetry (an axis of at least 20 nodes)."""
    E = lsm.Extrapolation
    return {"mixed17_19": lsm.normalize_bcs(
        [(E(19), E(17)), lsm.Periodic(), (lsm.Symmetry(), E(19))] if ndim == 3
        else [(E(19), lsm.Symmetry()), (E(17), E(19))], ndim)}


#: the > 7 route's 3D and 2D parity shapes: the smoke's grid, ragged ones with
#: every axis of at least 12 nodes (Extrapolation(11)), and the main paths';
#: degrees 17 and 19 on shapes of at least 20 nodes an axis (one of exactly 20)
DEGREE_SHAPES = ((40, 72, 136), (12, 19, 33), (130, 12, 75))
DEGREE_2D_SHAPES = ((67, 131), (12, 40), (200, 264))
HIGH_DEGREE_SHAPES = ((40, 72, 136), (20, 23, 41), (67, 131), (20, 33))
#: f64 shapes for a degree in the hundreds (a table of 2 ndim x 3 x 521
#: weights): the route takes any degree
DEVICE_TABLE_SHAPES = ((530, 12, 16), (530, 40))
DEGREE_STEPS = 10  # the 512^3 flagship under Extrapolation(8): RK3 steps of integrate
N_DEGREE_GRAD = 64  # its rollout gradient, card vs CPU, f64
DEGREE_GRAD_FACTOR = 4.0  # that gradient's gate: times the CPU's 1-ulp spread


def device_table_cases(ndim):
    """Extrapolation(520) on axis 0 (its weights, some 1e153, stay finite in
    f64) with Periodic and Symmetry on the other axes."""
    E = lsm.Extrapolation
    return {"extrap520": lsm.normalize_bcs(
        [E(520), lsm.Periodic(), lsm.Symmetry()][:ndim], ndim)}


def table_counts():
    return {name: fn.table_launches for name, fn in (
        ("K2", v2.refresh_ghosts_fast), ("K2ax", v2.refresh_axis_fast),
        ("K4", bwd.fold_ghost_cotangent_fast), ("K7", bd.refresh_band_ghosts_fast))}


def degree_parity(dev, shape, dtype, gen, big=False, cases=None):
    """K2 (and on a 3D shape its single-axis entry), K4 and K7 under each
    degree case at ``shape`` (``cases``, default :func:`degree_cases`): bit
    for bit against their plain versions (:func:`k2_compare`,
    :func:`k4_compare` (against autograd too, below degree 12 and 512^3),
    :func:`k7_compare`); each call on the table route."""
    high = cases is not None
    cases = degree_cases(len(shape)) if cases is None else cases
    if big:  # 512^3: one case, to keep the phase short
        cases = {"mixed8_11": cases["mixed8_11"]}
    before = table_counts()
    for name, bcs in cases.items():
        vals = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        if len(shape) == 3:
            k2_compare("k2_degree", name, vals, bcs, gen)
            P = scribbled(vals, bcs, gen)
            for ax in range(3):
                got = v2.refresh_axis_fast(P.clone(), bcs, shape, ax)
                if not same_bits(got, v2.refresh_axis_plain(P.clone(), bcs, shape, ax)):
                    raise AssertionError(f"K2 axis {ax} differs at {shape} ({name})")
        else:
            P = scribbled(vals, bcs, gen)
            got = v2.refresh_ghosts_fast(P.clone(), bcs, shape)
            if not (same_bits(got, v2.refresh_ghosts_plain(P.clone(), bcs, shape))
                    and same_bits(got, v2.pack_padded(vals, bcs))):
                raise AssertionError(f"K2 2D differs at {shape} ({name})")
        G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
        k4_compare("k2_degree", name, G, bcs, shape, autograd=not (big or high))
        k7_compare("k2_degree", shape, {name: bcs}, dtype, dev, gen, vals=vals)
    after = table_counts()
    n = len(cases)
    want = {"K2": n * (2 if len(shape) == 3 else 1), "K2ax": 3 * n if len(shape) == 3 else 0,
            "K4": 3 * n, "K7": 4 * n}
    got = {k: after[k] - before[k] for k in after}
    if got != want:
        raise AssertionError(f"table route launches at {shape}: {got}, expected {want}")
    log("k2_degree", f"{len(shape)}D {str(dtype)[6:]} shape={shape} {' '.join(cases)}: K2"
                     f"{' (and each axis)' if len(shape) == 3 else ''}, K4 and K7 (four gates) "
                     f"== plain bit for bit, every call on the table route {got}")


def degree_launches(dev, gen):
    """The table route's device activities a call, by the profiler's names,
    f32 under ``Extrapolation(8)``: K2 3D (512^3), K2 2D (N_2D^2), K4 and K7
    (flags on) 3D and 2D each one kernel, no copy. ``{entry: [names]}``."""
    out = {}
    on = torch.ones(2, dtype=torch.int32, device=dev)
    for shape in ((N_MAIN,) * 3, (N_2D,) * 2):
        bcs = lsm.normalize_bcs(lsm.Extrapolation(8), len(shape))
        P = v2.pack_padded(torch.randn(shape, generator=gen, device=dev), bcs)
        G = torch.randn_like(P)
        d = f"{len(shape)}D"
        one = lambda names: len(names) == 1
        out[f"K2 {d}"] = kernel_names(lambda: v2.refresh_ghosts_fast(P, bcs, shape), one)
        out[f"K4 {d}"] = kernel_names(lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape), one)
        out[f"K7 {d}"] = kernel_names(lambda: bd.refresh_band_ghosts_fast(P, bcs, shape, on), one)
        del P, G
    torch.cuda.empty_cache()
    bad = {k: v for k, v in out.items()
           if len(v) != 1 or any(w in v[0].lower() for w in ("memcpy", "memset"))}
    log("k2_degree", "table route, device activities a call (profiler): " + "; ".join(
        f"{k}: {len(v)} {v[0].removeprefix('void ').split('(')[0][-40:] if v else ''}"
        for k, v in out.items()))
    if bad:
        raise AssertionError(f"the table route launched other than one kernel a call: {bad}")
    return out


def degree_device():
    """The device times of K2, K4 and K7 (flags on and off) at 512^3 f32
    under Extrapolation(8) and (7), and of ``g.clone()``, from
    ``tools/ghost_shells.py --parts degree`` in a process of its own (this
    process's profiler under-reads late in the run)."""
    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, "tools/ghost_shells.py", "smoke", "--parts", "degree"],
                         capture_output=True, text=True, check=True, timeout=600).stdout
    line = next(x for x in out.splitlines() if x.startswith("SHELLS smoke"))
    vals = line.split()[2:]
    shells = {k: float(v) for k, v in zip(vals[::2], vals[1::2])}
    log("k2_degree", "512^3 f32 device ms (tools/ghost_shells.py): " + " ".join(
        f"{k} {v:.4f}" for k, v in shells.items() if k.endswith("_device")))
    return shells


def degree_bound(shape, bcs, f32=4):
    """The table route's refresh bound: per phase, each line's ghosts written
    once and the nodes they are built from read once (``2 min(n, P + 1)``
    an extrapolating line, one a ghost otherwise)."""
    nbytes = 0
    for ax, n in enumerate(shape):
        lines = 1
        for d, m in enumerate(shape):
            if d != ax:
                lines *= m + 6 if d < ax else m
        reads = sum(min(n, b.degree + 1) if isinstance(b, lsm.Extrapolation) else 3
                    for b in bcs[ax])
        nbytes += f32 * lines * (6 + reads)
    return bound(nbytes, 0)


def phase_k2_degree(dev, res):
    """K2 (3D, 2D, single axis), K4 (3D, 2D) and K7 (3D, 2D, four gates) on
    the table route, bit for bit against their plain versions under
    Extrapolation(8), Extrapolation(11) and both mixed with Periodic and
    Symmetry, f32 and f64, at DEGREE_SHAPES, DEGREE_2D_SHAPES and 512^3; the
    route's times at 512^3 f32 beside the by-value route's (Extrapolation(7));
    the flagship under Extrapolation(8) on every face: 10 RK3 steps of
    ``integrate`` on the fused path (launches counted), its rollout gradient at
    64^3 card vs CPU (f64), and a band of it stepping as a band."""
    gen = torch.Generator(device=dev).manual_seed(20)
    for dtype in (torch.float32, torch.float64):
        for shape in DEGREE_SHAPES + DEGREE_2D_SHAPES:
            degree_parity(dev, shape, dtype, gen)
        for shape in HIGH_DEGREE_SHAPES:
            degree_parity(dev, shape, dtype, gen, cases=high_degree_cases(len(shape)))
        degree_parity(dev, (N_MAIN,) * 3, dtype, gen, big=True)
    for shape in DEVICE_TABLE_SHAPES:
        degree_parity(dev, shape, torch.float64, gen, cases=device_table_cases(len(shape)))
    per_call = degree_launches(dev, gen)
    shape = (N_MAIN,) * 3
    out = {}
    for label, bcs in (("degree7", lsm.normalize_bcs(lsm.Extrapolation(7), 3)),
                       ("degree8", lsm.normalize_bcs(lsm.Extrapolation(8), 3))):
        vals = torch.randn(shape, generator=gen, device=dev)
        P = v2.pack_padded(vals, bcs)
        G = torch.randn_like(P)
        on = torch.ones(2, dtype=torch.int32, device=dev)
        out[label] = {
            "K2": cuda_time(lambda: v2.refresh_ghosts_fast(P, bcs, shape)),
            "K4": cuda_time(lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape)),
            "K7": cuda_time(lambda: bd.refresh_band_ghosts_fast(P, bcs, shape, on)),
            "K2_bound": degree_bound(shape, bcs)[0]}
        del P, G
    out["launches_per_call"] = {k: len(v) for k, v in per_call.items()}
    out["device"] = degree_device()
    res["k2_degree"] = out
    log("k2_degree", f"{N_MAIN}^3 f32 ms (CUDA events, median of 20): by-value route "
                     f"Extrapolation(7) {out['degree7']}; table route Extrapolation(8) "
                     f"{out['degree8']} [{nvidia_smi()}]")
    # the flagship under Extrapolation(8)
    grid = lsm.Grid((0.0,) * 3, (1.0,) * 3, shape)
    bcs8 = lsm.Extrapolation(8)
    phi = lsm.sample(shapes.zalesak_sphere(), grid, bcs8, device=dev)
    vol0 = float(lsm.volume(phi))
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(rotation), ic=phi, integrator=lsm.RK3())
    torch.cuda.synchronize()
    reset_counts()
    before = table_counts()
    t0 = time.perf_counter()
    eq.integrate(1.0, max_steps=DEGREE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, tables = read_counts(), table_counts()
    steps = eq.last_nsteps
    finite = bool(torch.isfinite(eq.state.values).all())
    rel = abs(float(eq.volume()) - vol0) / vol0
    log("k2_degree", f"{N_MAIN}^3 Zalesak RK3 under Extrapolation(8): steps={steps} "
                     f"path={eq.last_fast_path} launches={launches} table route K2 "
                     f"{tables['K2'] - before['K2']} finite={finite} volume rel change "
                     f"{rel:.2e} {1e3 * wall / steps:.4f} ms/step")
    if not (steps == DEGREE_STEPS and eq.last_fast_path == "fused" and finite
            and rel <= VOL_TOL and launches["K1''"] == 3 * steps
            and launches["K2"] == tables["K2"] - before["K2"] == 3 * steps):
        raise AssertionError("the flagship under Extrapolation(8) did not take the fused path "
                             "through the table route")
    res["launches"]["K2 table"] = tables["K2"] - before["K2"]
    res["k2_degree"]["flagship_ms_per_step"] = 1e3 * wall / steps
    del eq, phi
    # its rollout gradient at 64^3, card vs CPU (f64). A degree-8 extrapolation
    # multiplies round-off near the faces by its weights (their absolute sum
    # is in the thousands), and WENO5's weights pass it on: the card is gated
    # on DEGREE_GRAD_FACTOR times the CPU's own spread under a 1-ulp change of
    # phi0, the f32 gate of phase_grad in f64
    grads = {}
    g64 = lsm.Grid((0.0,) * 3, (1.0,) * 3, (N_DEGREE_GRAD,) * 3)
    dt64 = 0.2 * g64.min_spacing
    p = lsm.sample(shapes.zalesak_sphere(), g64, bcs8, dtype=torch.float64, device="cpu")
    for where in ("cpu", dev):  # the same phi0 bits on both
        v = p.values.to(where)
        before = table_counts()
        _, grads[str(where)] = rollout_grad(p.with_values(v), v.clone().requires_grad_(), dt64, 3)
        k4 = table_counts()["K4"] - before["K4"]
    gen_cpu = torch.Generator().manual_seed(21)
    pert = p.values * (1 + 2.0 ** -52 * torch.randn(g64.shape, generator=gen_cpu,
                                                    dtype=torch.float64))
    g_pert = rollout_grad(p.with_values(pert), pert.clone().requires_grad_(), dt64, 3)[1]
    err = rel_err(grads[str(dev)].cpu(), grads["cpu"])
    spread = rel_err(g_pert, grads["cpu"])
    log("k2_degree", f"rollout gradient {N_DEGREE_GRAD}^3 f64 under Extrapolation(8), 3 RK3 "
                     f"steps: card vs CPU max rel err {err:.3e}; the CPU's under a 1-ulp change "
                     f"of phi0 {spread:.3e} (tol {DEGREE_GRAD_FACTOR:g}x that, at least 1e-10); "
                     f"K4 table launches {k4}")
    res["k2_degree"]["grad_rel_err"], res["k2_degree"]["grad_ulp_spread"] = err, spread
    if not (err <= max(DEGREE_GRAD_FACTOR * spread, 1e-10) and k4 >= 9):
        raise AssertionError(f"the Extrapolation(8) rollout gradient: {err}, K4 {k4}")
    # a band of it: the band stepper, card vs CPU (f64)
    finals = {}
    for where in ("cpu", dev):
        g64 = lsm.Grid((-1.0,) * 3, (1.0,) * 3, (N_DEGREE_GRAD,) * 3)
        p = lsm.sample(shapes.sphere((0.0, 0.0, 0.0), 0.5), g64, bcs8, dtype=torch.float64,
                       device=where)
        nb = lsm.NarrowBandField.from_field(p)
        eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(spin), ic=nb, integrator=lsm.RK3())
        before = table_counts()
        eq.integrate(1.0, max_steps=3)
        finals[str(where)] = (eq.state.values.cpu(), eq.last_fast_path,
                              table_counts()["K7"] - before["K7"])
    (a, pa, _), (b, pb, k7) = finals["cpu"], finals[str(dev)]
    err = float((a - b).abs().max())
    log("k2_degree", f"band {N_DEGREE_GRAD}^3 f64 under Extrapolation(8), 3 RK3 steps: paths "
                     f"{pa}/{pb}, max|card-cpu|={err:.3e}, K7 table launches {k7}")
    if not (pa == pb == "band" and err <= 1e-10 and k7 >= 9):
        raise AssertionError(f"the Extrapolation(8) band: {pa}/{pb}, {err}, K7 {k7}")


# -- the semi-implicit step, the Newton signed distance and the quadrature -------------

N_SI = 512  # SI: the flagship's Zalesak sphere, upwind, SemiImplicitI2OE
SI_STEPS = 3
N_SI_2D = 4096  # configuration 2 under SemiImplicitI2OE
SI_2D_STEPS = 5
N_SI_SMALL, N_SI_GRAD = 48, 32  # card vs CPU, f64: 3 steps; the gradient through a step
N_NSDF = 256  # NSDF: sphere r 0.5 on [-1, 1]^3, f64, lazy coefficients
N_NSDF_SMALL = 32  # card vs CPU, eager
N_QUAD = 64  # Q: the quadrature's sphere
IO_STEPS = 10  # the io phase: FusedStepper.step calls timed by profiling.timed and by events
IO_MONITOR_STEPS = 5  # StepMonitor on the general path: integrate's max_steps
N_IO_VOLUME = 64  # export_volume_mesh's grid: every vertex at %.17g and 6 tets a cell,
# about 40 GB of text at 512^3


def si_run(phi, vel, steps):
    """``integrate`` of ``phi`` under ``AdvectionTerm(vel, "upwind")`` and
    ``SemiImplicitI2OE()`` for ``steps`` steps; each step's BiCGStab
    iterations and relative residual, the warnings raised, ms a step."""
    integ = lsm.SemiImplicitI2OE()
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(vel, scheme="upwind"), ic=phi,
                              integrator=integ)
    solves = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, wall = timed(lambda: eq.integrate(1.0, max_steps=steps, posthook=lambda e: (
            solves.append(dict(e.integrator.last_solve)))))
    warned = [str(w.message) for w in caught if "BiCGStab" in str(w.message)]
    return eq, solves, warned, 1e3 * wall / max(eq.last_nsteps, 1)


def phase_semi_implicit(dev, res):
    """SI: the flagship's Zalesak sphere at 512^3 f32, Periodic, the rotation
    sampled on the grid (a vector MeshField), ``AdvectionTerm(vel,
    scheme="upwind")`` under ``SemiImplicitI2OE()`` (CFL 2): 3 steps of
    ``integrate``: ms a step, iterations a step, the final relative residual,
    peak memory, no non-convergence warning; configuration 2 (Zalesak disk)
    at 4096^2 f32 the same way for 5 steps; card vs CPU at 48^3 f64 after 3
    steps (<= 1e-9 max|phi|, equal iterations); a gradient through a step at
    32^3 f64, card vs CPU."""
    out = {}
    grid, phi, vel = zalesak(N_SI, dev)
    torch.cuda.reset_peak_memory_stats()
    eq, solves, warned, ms = si_run(phi, vel, SI_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(eq.state.values).all())
    resid = ", ".join(f"{s['rel_residual']:.3e}" for s in solves)
    log("semi_implicit", f"SI {N_SI}^3 f32 upwind, CFL 2: steps={eq.last_nsteps} "
                         f"path={eq.last_fast_path} {ms:.1f} ms/step, iterations "
                         f"{[s['iterations'] for s in solves]}, relative residuals [{resid}] "
                         f"(tol {solves[-1]['tol']:.3e}), warnings {warned}, finite={finite}, "
                         f"peak {peak:.2f} GiB [{nvidia_smi()}]")
    out["512"] = {"ms_per_step": ms, "iterations": [s["iterations"] for s in solves],
                  "rel_residual": solves[-1]["rel_residual"], "peak_gib": peak, "warned": warned}
    # the loop test's host read: the busy share of one step on the card
    step_phi = eq.state
    wall, busy = profile_window(f"SI {N_SI}^3 one step", lambda: lsm.SemiImplicitI2OE().advance(
        eq.terms, step_phi, 0.0, 0.5 * float(lsm.compute_cfl(eq.terms, step_phi, 0.0))))
    out["512"]["busy_share"] = busy / wall
    if not (eq.last_nsteps == SI_STEPS and eq.last_fast_path is None and finite and not warned
            and all(0 < s["iterations"] < 500 for s in solves)):
        raise AssertionError(f"SI at {N_SI}^3: {solves}, warnings {warned}")
    del eq, phi, vel, step_phi
    terms, phi2, _ = config("D2", N_SI_2D, dev)
    vel2 = lsm.sample(lambda *xs: rotation2(xs, 0.0), phi2.grid, dtype=phi2.dtype, device=dev,
                      vector=True)
    torch.cuda.reset_peak_memory_stats()
    eq, solves, warned, ms = si_run(phi2, vel2, SI_2D_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(eq.state.values).all())
    log("semi_implicit", f"config 2 {N_SI_2D}^2 f32 upwind: steps={eq.last_nsteps} {ms:.2f} "
                         f"ms/step, iterations {[s['iterations'] for s in solves]}, final "
                         f"relative residual {solves[-1]['rel_residual']:.3e}, warnings "
                         f"{warned}, peak {peak:.3f} GiB")
    out["2d"] = {"ms_per_step": ms, "iterations": [s["iterations"] for s in solves],
                 "rel_residual": solves[-1]["rel_residual"], "peak_gib": peak}
    if not (eq.last_nsteps == SI_2D_STEPS and finite and not warned):
        raise AssertionError(f"SI config 2: {solves}, warnings {warned}")
    del eq, phi2, vel2
    # card vs CPU, f64, the same initial bits
    _, phi_c, vel_c = zalesak(N_SI_SMALL, "cpu", torch.float64)
    runs = {}
    for where in ("cpu", dev):
        p = phi_c.with_values(phi_c.values.to(where))
        v = lsm.MeshField(vel_c.values.to(where), vel_c.grid)
        eq, solves, warned, _ = si_run(p, v, 3)
        runs[str(where)] = (eq.state.values.cpu(), [s["iterations"] for s in solves], eq.t)
    (a, ia, ta), (b, ib, tb) = runs["cpu"], runs[str(dev)]
    err = float((a - b).abs().max()) / float(a.abs().max())
    log("semi_implicit", f"{N_SI_SMALL}^3 f64, 3 steps: card vs CPU max|diff|/max|phi| "
                         f"{err:.3e} (tol 1e-9), iterations card {ib} CPU {ia}")
    if not (err <= 1e-9 and ia == ib and ta == tb):
        raise AssertionError(f"SI card vs CPU: {err}, {ia} / {ib}")
    out["card_vs_cpu"] = err
    # a gradient through one step, card vs CPU
    _, phi_g, vel_g = zalesak(N_SI_GRAD, "cpu", torch.float64)
    w = torch.randn(phi_g.shape, generator=torch.Generator().manual_seed(22),
                    dtype=torch.float64)
    grads = {}
    for where in ("cpu", dev):
        v = phi_g.values.to(where).requires_grad_()
        u = vel_g.values.to(where).requires_grad_()
        new, _ = lsm.SemiImplicitI2OE().advance(
            (lsm.AdvectionTerm(lsm.MeshField(u, vel_g.grid), scheme="upwind"),),
            phi_g.with_values(v), 0.0, 1.5 * phi_g.grid.min_spacing)
        grads[str(where)] = [g.cpu() for g in torch.autograd.grad(
            (new.values * w.to(where)).sum(), (v, u))]
    gerr = max(rel_err(x, y) for x, y in zip(grads[str(dev)], grads["cpu"]))
    log("semi_implicit", f"gradient through a step at {N_SI_GRAD}^3 f64 (phi and velocity): "
                         f"card vs CPU max rel err {gerr:.3e} (tol 1e-9)")
    if not gerr <= 1e-9:
        raise AssertionError(f"SI gradient card vs CPU: {gerr}")
    out["grad_card_vs_cpu"] = gerr
    res["semi_implicit"] = out


def sphere_field(n, dev, dtype=torch.float64, radius=0.5):
    grid = lsm.Grid((-1.0,) * 3, (1.0,) * 3, (n,) * 3)
    return lsm.sample(shapes.sphere((0.0, 0.0, 0.0), radius), grid, lsm.Extrapolation(2),
                      dtype=dtype, device=dev)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_interp_sdf(dev, res):
    """NSDF: a sphere r 0.5 on [-1, 1]^3 at 256^3 f64 (its coefficients past
    ``LAZY_THRESHOLD``: the lazy path on the card): ``NewtonSDF(order=3,
    upsample=2)`` (build time, cut cells, valid samples),
    ``reinitialize_newton`` over every node (time; error against |x| - r over
    all nodes and within 5h), ``hausdorff_distance`` to r 0.48 (0.02); card
    vs CPU at 32^3, eager: the samples to 1e-10, the queries to 1e-10 but at
    lanes whose Newton stop lies one iterate apart (counted, at most 1%)."""
    phi = sphere_field(N_NSDF, dev)
    cf = lsm.InterpolatedField(phi, 3)
    if not cf.is_lazy:
        raise AssertionError("the 256^3 interpolant should be lazy")
    torch.cuda.reset_peak_memory_stats()
    sdf, t_build = timed(lambda: lsm.NewtonSDF(phi, order=3, upsample=2))
    ncut = int((~sdf.cf.proven_empty(surface=True)).sum())
    nvalid = int(sdf.valid.sum())
    new, t_reinit = timed(lambda: lsm.reinitialize_newton(phi, order=3, upsample=2))
    peak = torch.cuda.max_memory_allocated() / 2**30
    coords = phi.grid.dense_coords(dtype=torch.float64, device=dev)
    exact = torch.sqrt(sum(x ** 2 for x in coords)) - 0.5
    err = (new.values - exact).abs()
    near = exact.abs() <= 5 * phi.grid.min_spacing
    err_all, err_near = float(err.max()), float(err[near].max())
    other = lsm.NewtonSDF(sphere_field(N_NSDF, dev, radius=0.48), order=3, upsample=2)
    hd, t_hd = timed(lambda: float(lsm.hausdorff_distance(sdf, other)))
    log("interp_sdf", f"NSDF {N_NSDF}^3 f64 (lazy): build {t_build:.2f} s, cut cells {ncut}, "
                      f"valid samples {nvalid} of {sdf.samples.shape[0]}; reinitialize_newton "
                      f"over {phi.grid.num_nodes} nodes (its own build included; queries 2^20 a "
                      f"KKT batch, closest_point's default on the card) {t_reinit:.2f} s, "
                      f"max|phi - (|x| - r)| all {err_all:.3e}, within 5h {err_near:.3e}; "
                      f"hausdorff_distance(r 0.5, r 0.48) = {hd:.6f} ({t_hd:.2f} s); peak "
                      f"{peak:.2f} GiB [{nvidia_smi()}]")
    res["interp_sdf"] = {"build_s": t_build, "cut_cells": ncut, "valid_samples": nvalid,
                         "reinit_s": t_reinit, "err_all": err_all, "err_near_5h": err_near,
                         "hausdorff": hd, "hausdorff_s": t_hd, "peak_gib": peak}
    if not (err_near <= 1e-5 and err_all <= 1e-3 and abs(hd - 0.02) <= 2e-3 and nvalid > 0):
        raise AssertionError("NSDF at 256^3 out of tolerance")
    del sdf, other, new, coords, exact, err, near, cf
    # card vs CPU at 32^3, eager
    p_cpu = sphere_field(N_NSDF_SMALL, "cpu")
    outs = {}
    for where in ("cpu", dev):
        p = p_cpu.with_values(p_cpu.values.to(where))
        s = lsm.NewtonSDF(p, order=3, upsample=2)
        x = p.grid.dense_coords(dtype=torch.float64, device=where)
        x = torch.stack(x, -1).reshape(-1, 3)[::7]
        outs[str(where)] = (s.samples.cpu(), s.valid.cpu(), s(x).cpu(),
                            lsm.reinitialize_newton(p).values.cpu(), s.cf.is_lazy)
    (sa, va, qa, ra, la), (sb, vb, qb, rb, lb) = outs["cpu"], outs[str(dev)]
    # the samples to 1e-10; a query's KKT Newton freezes its lane at the first
    # iterate whose residual is below 10 sqrt(eps) (JAX's rule), so a lane
    # whose residual lies at that threshold may stop one iterate apart on the
    # card and the CPU (their solves round differently): such lanes are
    # counted and held to the rule's tolerance, the others to 1e-10
    stop_tol = 10 * math.sqrt(torch.finfo(torch.float64).eps)
    err_s = float((sa - sb).abs().max())
    flips, worst = {}, {}
    for name, a, b in (("sdf(x)", qa, qb), ("reinitialize_newton", ra, rb)):
        d = (a - b).abs().reshape(-1)
        flips[name], worst[name] = int((d > 1e-10).sum()), float(d.max())
    log("interp_sdf", f"{N_NSDF_SMALL}^3 f64 eager, card vs CPU: samples {err_s:.3e} (tol 1e-10), "
                      f"valid masks equal {torch.equal(va, vb)}; max|diff| "
                      f"{ {k: f'{v:.3e}' for k, v in worst.items()} }, lanes past 1e-10 "
                      f"(a Newton stop one iterate apart) {flips} of {qa.numel()} and "
                      f"{ra.numel()} (tol {stop_tol:.2e}, at most 1%)")
    if not (err_s <= 1e-10 and torch.equal(va, vb) and not la and not lb
            and max(worst.values()) <= stop_tol and flips["sdf(x)"] <= 0.01 * qa.numel()
            and flips["reinitialize_newton"] <= 0.01 * ra.numel()):
        raise AssertionError(f"NSDF card vs CPU: {err_s}, {worst}, {flips}")
    res["interp_sdf"]["card_vs_cpu"] = {"samples": err_s, "max": worst, "lanes_past_1e-10": flips}


def phase_quadrature(dev, res):
    """Q: the volume and area of a sphere r 0.5 on [-1, 1]^3 at 64^3 from a
    field on the card, its interpolant eager and lazy, against 4/3 pi r^3 and
    4 pi r^2; their times."""
    phi = sphere_field(N_QUAD, dev)
    r = 0.5
    exact = {"volume": 4.0 / 3.0 * math.pi * r ** 3, "area": 4.0 * math.pi * r ** 2}
    out = {}
    for lazy in (False, True):
        cf = lsm.InterpolatedField(phi, 3, lazy=lazy)
        for kind, surface in (("volume", False), ("area", True)):
            quads, t = timed(lambda: lsm.quadrature(cf, surface=surface))
            val = lsm.integrate(None, quads)
            out[f"{kind}_{'lazy' if lazy else 'eager'}"] = {
                "value": val, "rel_err": abs(val - exact[kind]) / exact[kind], "s": t,
                "cells": len(quads)}
    log("quadrature", f"Q {N_QUAD}^3 f64 sphere r {r}: " + ", ".join(
        f"{k} {v['value']:.10f} (rel err {v['rel_err']:.2e}, {v['cells']} cells, "
        f"{v['s']:.2f} s)" for k, v in out.items()))
    res["quadrature"] = out
    same = all(abs(out[f"{k}_lazy"]["value"] - out[f"{k}_eager"]["value"])
               <= 1e-12 * exact[k] for k in exact)
    if not (all(v["rel_err"] <= 1e-4 for v in out.values()) and same):
        raise AssertionError(f"quadrature: {out}")


def trace_kernel_names(run, want, tries=3):
    """The kernel names in the Chrome trace that ``profiling.trace`` writes
    around ``run()``, taken again (calling ``run`` again) up to ``tries``
    times while a pattern of ``want`` names none of them (see
    :func:`kernel_names`: the profiler drops records now and then)."""
    for _ in range(tries):
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp) as logdir:
                run()
            files = sorted(Path(logdir).glob("*.json"))
            events = json.loads(files[0].read_text())["traceEvents"] if len(files) == 1 else []
        names = {e["name"] for e in events if e.get("cat") == "kernel"}
        if all(any(re.search(w, n) for n in names) for w in want.values()):
            break
    return files, names


def phase_io(dev, res):
    """The host-side modules on the flagship (512^3 Zalesak, rotation
    in-kernel, RK3, f32). ``profiling.timed`` around IO_STEPS
    ``FusedStepper.step`` calls at a fixed dt (no CFL read-back), with CUDA
    events recorded around the same steps: timed >= 0.95 x events (it waits
    for the card; the host-only enqueue time beside them); ``StepMonitor`` with a volume
    observable as the posthook of ``integrate`` (the general path: K10),
    IO_MONITOR_STEPS steps: its ts those a plain recording posthook sees in
    the same run, its last volume the final state's; ``profiling.trace``
    around two fused ``integrate`` steps: its Chrome trace names K1''
    (``stage_march_prog_kernel``) and K2 (``refresh_3d_kernel``);
    ``marching_tetrahedra`` of the final state on the card equal to that of
    its CPU copy; a sphere r 0.5 on [-1, 1]^3 at 512^3 f32 sampled on the
    card: read back, marched and welded (times, triangles), watertight (every
    edge of two faces) and its area within 1e-3 of 4 pi r^2;
    ``export_surface_mesh`` and ``write_obj`` of it, and
    ``export_volume_mesh`` at N_IO_VOLUME^3 (cut from 512^3: the text would
    be about 40 GB), into a temporary directory."""
    out = {}
    grid, phi, _ = zalesak(N_MAIN, dev)
    # 1. timed waits for the card
    stepper = FusedStepper(lsm.AdvectionTerm(rotation), phi, lsm.RK3())
    dt = 0.25 * grid.min_spacing
    P0 = stepper.pack(phi.values)

    def block():
        P = P0
        for k in range(IO_STEPS):
            P = stepper.step(P, k * dt, dt)
        return P

    block()
    reset_counts()
    timed_s = {}
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profiling.timed("steps", out=timed_s):
        t0 = time.perf_counter()
        a.record()
        P1 = block()
        b.record()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
    b.synchronize()
    launches = read_counts()
    events_ms, timed_ms = a.elapsed_time(b), 1e3 * timed_s["steps"]
    k1pp, k2, finite = launches["K1''"], launches["K2"], bool(torch.isfinite(P1).all())
    log("io", f"{IO_STEPS} FusedStepper.step (RK3, K1'' in-kernel rotation) at {N_MAIN}^3 f32, "
              f"one run: profiling.timed {timed_ms:.3f} ms, CUDA events around the same steps "
              f"{events_ms:.3f} ms (ratio {timed_ms / events_ms:.4f}, gate >= 0.95), host-only "
              f"enqueue {enqueue_ms:.3f} ms; launches K1'' {k1pp} K2 {k2}; finite {finite} "
              f"[{nvidia_smi()}]")
    out.update(timed_ms=timed_ms, events_ms=events_ms, enqueue_ms=enqueue_ms)
    if not (timed_ms >= 0.95 * events_ms and finite and k1pp == k2 == 3 * IO_STEPS):
        raise AssertionError(f"profiling.timed did not wait for the card: {out}, {launches}")
    del P0, P1, stepper
    # 2. StepMonitor on the general path
    mon = profiling.StepMonitor(observables={"volume": lambda e: e.volume()})
    seen = []

    def posthook(e):
        mon(e)
        seen.append(e.t)

    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(rotation), ic=phi, integrator=lsm.RK3())
    reset_counts()
    eq.integrate(1.0, posthook=posthook, max_steps=IO_MONITOR_STEPS)
    launches = read_counts()
    summary = mon.summary()
    vol = float(eq.volume())
    rel = abs(summary["volume_final"] - vol) / vol
    log("io", f"StepMonitor on integrate's general path (posthook), {N_MAIN}^3: nsteps "
              f"{mon.nsteps}, ts {mon.ts}, volume {mon.records['volume']}, summary {summary}; "
              f"final volume() {vol:.9e} (rel {rel:.2e}); path {eq.last_fast_path}, launches "
              f"K10 {launches['K10']} K1 {launches['K1']}")
    out.update(monitor_nsteps=mon.nsteps, monitor_summary=summary)
    if not (mon.nsteps == IO_MONITOR_STEPS and mon.ts == seen and rel <= 1e-6
            and eq.last_fast_path is None and launches["K10"] == 3 * IO_MONITOR_STEPS
            and launches["K1"] == 0):
        raise AssertionError(f"StepMonitor on the general path: {out}, {launches}")
    # 3. trace sees the kernels
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(rotation), ic=phi, integrator=lsm.RK3())
    eq.integrate(1.0, max_steps=1)
    want = {"K1''": r"\bstage_march_prog_kernel\b", "K2": r"\brefresh_3d_kernel\b"}
    files, names = trace_kernel_names(lambda: eq.integrate(eq.t + 1.0, max_steps=2), want)
    found = {k: sorted(n for n in names if re.search(w, n)) for k, w in want.items()}
    log("io", f"profiling.trace around 2 fused integrate steps: {len(files)} Chrome trace file, "
              f"{len(names)} kernel names; " + "; ".join(
                  f"{k}: {v[0][:80] if v else None}" for k, v in found.items()))
    if not (len(files) == 1 and all(found.values()) and eq.last_fast_path == "fused"):
        raise AssertionError(f"the trace does not name K1'' and K2: {sorted(names)}")
    del phi
    # 4. marching on a card field
    final = eq.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tris_card = lio.marching_tetrahedra(final)
    t_card = time.perf_counter() - t0
    tris_cpu = lio.marching_tetrahedra(final.with_values(final.values.cpu()))
    equal = np.array_equal(tris_card, tris_cpu)
    log("io", f"marching_tetrahedra of the flagship's final {N_MAIN}^3 state: {len(tris_card)} "
              f"triangles from the card field ({t_card:.2f} s, read-back included), equal to "
              f"its CPU copy's: {equal}")
    if not (equal and len(tris_card) > 0):
        raise AssertionError("marching_tetrahedra: card field and CPU copy differ")
    del eq, final, tris_card, tris_cpu
    sph = sphere_field(N_MAIN, dev, dtype=torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals = lio.marching.host_values(sph)
    t_read = time.perf_counter() - t0
    host = lsm.MeshField(torch.from_numpy(vals), sph.grid, sph.bcs)
    t0 = time.perf_counter()
    tris = lio.marching_tetrahedra(host)
    t_march = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces = lio.weld_triangles(tris)
    t_weld = time.perf_counter() - t0
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges[:, 0].astype(np.int64) * len(verts) + edges[:, 1],
                          return_counts=True)
    watertight = bool((counts == 2).all())
    tri = verts[faces]
    area = 0.5 * float(np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                                      axis=1).sum())
    exact = 4.0 * math.pi * 0.25
    rel_area = abs(area - exact) / exact
    log("io", f"sphere r 0.5 at {N_MAIN}^3 f32 on the card: read-back {t_read:.2f} s, march "
              f"{t_march:.2f} s ({len(tris)} triangles), weld {t_weld:.2f} s ({len(verts)} "
              f"vertices, {len(faces)} faces); edges {len(counts)}, every edge of two faces "
              f"{watertight}; area {area:.9f} (rel err {rel_area:.2e}, tol 1e-3) "
              f"[{nvidia_smi()}]")
    out.update(read_s=t_read, march_s=t_march, weld_s=t_weld, triangles=len(tris),
               area_rel_err=rel_area, watertight=watertight)
    if not (watertight and rel_area <= 1e-3):
        raise AssertionError(f"the welded {N_MAIN}^3 sphere: {out}")
    del tris, host, vals
    # 5. export
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        surf = lio.export_surface_mesh(sph, tmp / "sphere")
        t_surf = time.perf_counter() - t0
        t0 = time.perf_counter()
        obj = lio.write_obj(tmp / "sphere.obj", verts, faces)
        t_obj = time.perf_counter() - t0
        small = sphere_field(N_IO_VOLUME, dev, dtype=torch.float32)
        t0 = time.perf_counter()
        vol_mesh = lio.export_volume_mesh(small, tmp / "ball")
        t_vol = time.perf_counter() - t0
        with open(surf) as f:
            surf_ok = any(line.startswith("Triangles") for line in f)
        with open(obj) as f:
            obj_ok = f.read(2) == "v "
        with open(vol_mesh) as f:
            vol_ok = any(line.startswith("Tetrahedra") for line in f)
        sol_ok = "SolAtVertices" in (tmp / "ball.sol").read_text()
        sizes = {p.name: p.stat().st_size for p in sorted(tmp.iterdir())}
    log("io", f"export_surface_mesh {N_MAIN}^3 {t_surf:.2f} s (march, weld and write), "
              f"write_obj {t_obj:.2f} s, export_volume_mesh {N_IO_VOLUME}^3 {t_vol:.2f} s (cut "
              f"from {N_MAIN}^3: every vertex at %.17g and 6 tets a cell, about 40 GB of text "
              f"there); bytes {sizes}; Triangles {surf_ok}, 'v ' {obj_ok}, Tetrahedra {vol_ok}, "
              f"SolAtVertices {sol_ok}; the directory removed {not tmp.exists()}")
    out.update(surface_s=t_surf, obj_s=t_obj, volume_s=t_vol, bytes=sizes)
    res["io"] = out
    if not (surf_ok and obj_ok and vol_ok and sol_ok and not tmp.exists()):
        raise AssertionError(f"the exported files: {sizes}")


def main(argv=()) -> int:
    """Every phase in order; with phase names in ``argv``, only those (a
    partial run: no kernel record, and a last line that says so)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} "
                  f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.load_library()
    log("build", f"{lib.path.name} in {time.perf_counter() - t0:.2f} s "
                 f"(nvcc {lib.build_seconds:.2f} s)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", line.strip())
    for name, info in stage_adjoint_ptxas(lib.log):
        log("build", f"stage adjoint {name}: {info}")
    for name, info in forward_stage_ptxas(lib.log):
        log("build", f"forward stage {name}: {info}")
    res = {"t": {}, "launches": {}, "mem": {}}
    if argv:  # a partial run: what the skipped phases would have recorded starts at 0
        res = collections.defaultdict(float, res)
    res["band_ptxas"] = band_ptxas(lib.log)
    for name, info in res["band_ptxas"].items():
        log("build", f"band {name}: {info}")
    phases = (("device", phase_device), ("k2", phase_k2), ("k1", phase_k1),
                      ("k4k5", phase_k4k5), ("k3", phase_k3), ("k6k7k8", phase_k6k7k8),
                      ("k6k7k8_2d", phase_k6k7k8_2d), ("band_tiles", phase_band_tiles),
                      ("k1kinds", phase_k1kinds), ("k6kinds", phase_k6kinds),
                      ("k3kinds", phase_k3kinds), ("k1analytic", phase_k1analytic),
                      ("k3analytic", phase_k3analytic), ("k6analytic", phase_k6analytic),
                      ("k10k11", phase_k10k11), ("k2_small", phase_k2_small),
                      ("k1_2d", phase_k1_2d), ("k2_degree", phase_k2_degree),
                      ("k512", phase_k512), ("k3_512", phase_k3_512),
                      ("band_512", phase_band_512), ("kinds_512", phase_kinds_512),
                      ("k3kinds_512", phase_k3kinds_512),
                      ("slice", phase_slice), ("main", phase_main), ("grad", phase_grad),
                      ("band", phase_band), ("band2d_4096", phase_band2d_4096), ("kinds", phase_kinds),
                      ("update", phase_update),
                      ("grad_kinds", phase_grad_kinds), ("config5", phase_config5),
                      ("general_512", phase_general_512), ("twod", phase_twod),
                      ("grad_2d", phase_grad_2d),
                      ("general_small", phase_general_small),
                      ("semi_implicit", phase_semi_implicit), ("interp_sdf", phase_interp_sdf),
                      ("quadrature", phase_quadrature), ("io", phase_io), ("k9", phase_k9),
                      ("sharded", phase_sharded), ("sharded_grad", phase_sharded_grad),
                      ("sharded_general", phase_sharded_general), ("dryrun", phase_dryrun),
                      ("timing", phase_timing),
                      ("band_timing", phase_band_timing), ("kinds_timing", phase_kinds_timing),
                      ("general_timing", phase_general_timing),
                      ("analytic_timing", phase_analytic_timing), ("profile", phase_profile),
                      ("revolution", phase_revolution))
    unknown = set(argv) - {name for name, _ in phases}
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    for name, run in phases:
        if argv and name not in argv:
            continue
        t0 = time.perf_counter()
        run(dev, res)
        log(name, f"phase done in {time.perf_counter() - t0:.1f} s")
    if argv:
        print(nvidia_smi())
        print(json.dumps({"partial": list(argv), "passed": True}))
        return 0
    print(json.dumps({"kernels": kernel_records(res)}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def ptxas_summary(build_log, source, names):
    """``(kernel, its mangled template arguments, "N registers, S B spill
    stores, M B static smem")`` of each kernel of ``csrc/<source>`` named in
    ``names`` in nvcc's ``-Xptxas -v`` output (dynamic shared memory is set
    at launch)."""
    key = source.replace(".", "_")
    out, cur, spill = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            cur = next(((name, line.split(name + "I", 1)[1] if name + "I" in line else "")
                        for name in names if key in line and (name + "I" in line
                                                              or name + "E" in line)), None)
        elif cur and "spill stores" in line:
            spill = line.split("bytes stack frame, ")[-1].split(",")[0].strip()
        elif cur and "Used" in line and "registers" in line:
            regs = line.split("Used ")[1].split(" registers")[0]
            smem = line.rsplit(", ", 1)[-1].strip() if "smem" in line else "0 bytes smem"
            out.append((*cur, f"{regs} registers, {spill}, {smem} static"))
            cur = None
    return out


def stage_adjoint_ptxas(build_log):
    """``(kernel, registers, spills and static shared memory)`` of each
    kernel of ``csrc/stage_backward.cu`` (K3, K3'', K3', their 2D marches and
    the reduction)."""
    names = {"stage_bwd_kernel": "K3", "stage_bwd_terms_kernel": "K3'",
             "stage_bwd_2d_kernel": "K3 2D", "stage_bwd_terms_2d_kernel": "K3' 2D",
             "stage_bwd_reduce_kernel": "reduction"}
    out = []
    for name, args, info in ptxas_summary(build_log, "stage_backward.cu", names):
        label = names[name]
        dtype = "f32" if args.startswith("f") else "f64"
        if "Lb1" in args.split("EE", 1)[0][:4]:  # the program instantiation
            label = {"K3": "K3''", "K3'": "K3' (program)", "K3 2D": "K3'' 2D",
                     "K3' 2D": "K3' 2D (program)", "reduction": "reduction (dt)"}[label]
        out.append((f"{label} {dtype}", info))
    return out


def forward_stage_ptxas(build_log):
    """The same for the kernels of ``csrc/weno_stage.cu`` (K1, K1'', K1' with
    reach R; a 3D field of one plane's instantiations without axis 0; "K1''
    per node": the kernel of one thread per node, for a component evaluated
    per node and a field of one plane; "K1' per node": a table with a
    program), of ``csrc/weno_general.cu`` (K10) and of
    ``csrc/weno_stage_2d.cu`` (K1's 2D entries: the 2D march of K1 and
    K1'', and the per-node form)."""
    names = {"stage_march_kernel": "K1", "stage_march_prog_kernel": "K1''",
             "stage_node_prog_kernel": "K1'' per node",
             "stage_terms_march_kernel": "K1' march", "weno_stage_terms_kernel": "K1' per node"}
    out = []
    for name, args, info in ptxas_summary(build_log, "weno_stage.cu", names):
        dtype = "f32" if args.startswith("f") else "f64"
        label = names[name]
        if name == "stage_terms_march_kernel":  # <T, R, kFirst>: "fLi2ELi0E..."
            label += f" R={args[3]}"
            axis0 = "" if args[7] == "0" else " (one plane: axis 0 compiled out)"
        elif name == "weno_stage_terms_kernel":  # <T, kAdvection>
            axis0 = " (advection)" if args[1:4] == "Lb1" else ""
        else:
            axis0 = "" if args[1:4] != "Lb0" else " (one plane: axis 0 compiled out)"
        out.append((f"{label} {dtype}{axis0}", info))
    for name, args, info in ptxas_summary(build_log, "weno_general.cu",
                                          {"general_march_kernel": "K10"}):
        out.append((f"K10 march {'f32' if args.startswith('f') else 'f64'}", info))
    names = {"stage_march_2d_kernel": "2D march", "stage_node_2d_kernel": "2D per node",
             "stage_node_prog_2d_kernel": "K1'' 2D per node"}
    for name, args, info in ptxas_summary(build_log, "weno_stage_2d.cu", names):
        dtype = "f32" if args.startswith("f") else "f64"
        if name == "stage_march_2d_kernel":  # <T, kKind>: "fLi1E"
            label = ("K1", "K1''")[int(args[3])] + " 2D march"
        elif name == "stage_node_prog_2d_kernel":
            label = names[name]
        else:  # <T, kAdvection, kProg>
            label = "K1 2D per node" + (" (advection)" if args[1:4] == "Lb1" else "")
            label += " (program)" if args[5:8] == "Lb1" else ""
        out.append((f"{label} {dtype}", info))
    return out


def band_ptxas(build_log):
    """``{label: "N registers, S spill stores, M static smem; D B dynamic"}``
    of the kernels of ``csrc/band_stage.cu`` (K6, K6', K6''; "2D": the 2D
    entries), ``csrc/band_retube.cu`` (K8's three launches) and K7's (3D
    with and without extrapolation's code, 2D), with the
    dynamic shared memory of the default tiles (16^3; 16 x 64 in 2D) and 3
    layers: K6's box of phi, K8's bit planes."""
    out = {}
    names = {"band_stage_kernel": "K6", "band_stage_terms_kernel": "K6'",
             "band_stage_prog_kernel": "K6''"}
    for name, args, info in ptxas_summary(build_log, "band_stage.cu", names):
        dtype, size = ("f32", 4) if args.startswith("f") else ("f64", 8)
        two_d = args.split("EE", 1)[0].endswith("Li1")
        label = names[name]
        if name == "band_stage_terms_kernel":  # <T, kAdvection, kProgram, kFirst>
            label += " (advection)" if args[1:4] == "Lb1" else ""
            label += " (program)" if args[5:8] == "Lb1" else ""
        box = (16 + 6) * (64 + 6) if two_d else (16 + 6) ** 3
        extra = 3 * 16 if name == "band_stage_prog_kernel" and not two_d else 0
        out[f"{label} {dtype}{' 2D' if two_d else ''}"] = (
            f"{info}; {(box + extra) * size} B dynamic (the tile's box)")
    planes = {False: 5 * 30 * 30 * 1 * 4, True: 5 * 30 * 3 * 4}  # R0 R1 W words, five planes
    for name, args, info in ptxas_summary(build_log, "band_retube.cu",
                                          {"retube_tag_kernel": "K8 T",
                                           "retube_bits_kernel": "K8 A",
                                           "retube_decode_kernel": "K8 B"}):
        if name == "retube_decode_kernel":
            out["K8 B (decode)"] = f"{info}; no dynamic"
            continue
        if name == "retube_tag_kernel":
            out[f"K8 T (tags) {'f32' if args.startswith('f') else 'f64'}"] = f"{info}; no dynamic"
            continue
        two_d = args.split("EE", 1)[0].endswith("Lb1")
        out[f"K8 A {'f32' if args.startswith('f') else 'f64'}{' 2D' if two_d else ''}"] = (
            f"{info}; {planes[two_d]} B dynamic (the bit planes)")
    for name, args, info in ptxas_summary(build_log, "refresh_ghosts.cu",
                                          {"band_refresh_3d_kernel": "K7",
                                           "band_refresh_2d_kernel": "K7 2D"}):
        label = "K7" if name == "band_refresh_3d_kernel" else "K7 2D"
        extrap = " (extrapolation)" if args[1:4] == "Lb1" else ""
        out[f"{label}{extrap} {'f32' if args.startswith('f') else 'f64'}"] = (
            f"{info}; no dynamic")
    return out


def kernel_records(res):
    """One record per kernel for the JSON line; each bound counts what the
    timed call must move and compute at the main path's 512^3 f32 shape (K11
    at D2's N_2D^2)."""
    t, n = res["t"], N_MAIN
    cells, padded, ghosts = n ** 3, (n + 6) ** 3, (n + 6) ** 3 - n ** 3
    f32 = 4
    k3_plain_n = res["K3_plain_n"]
    # a program's arithmetic per node (a table load is none) and its tables'
    # entries (written once, read once) and arithmetic, once per launch
    rot, vortex, spin_w = res["prog_rotation"], res["prog_vortex"], res["prog_spin"]

    def prog_bound(nbytes, ops, w, nodes, dual=False):
        k = 2 if dual else 1  # dual numbers: the t-derivative beside each value
        return bound(nbytes + k * 2 * f32 * w["table_entries"],
                     ops + k * (w["per_node"] * nodes + w["table_ops"]))

    tk = res["t_k3k"]
    work, kwork, w2 = res["band_work"], res["kinds_band_work"], res["band2d_work"]
    plane2d, cells2d, w2d = (N_2D + 6) ** 2, N_2D ** 2, res["k1_2d_work"]
    k9 = res["k9"]["times"]
    k9_main = k9[(2, 2)]  # the (2, 2) mesh: all four blocks per shard
    shells = res["shells"]  # tools/ghost_shells.py's readings, a process of its own
    rows = [
        ("K1 fused_stage (WENO5 advection RK stage)", "weno_stage.cu",
         "lsm_tpu/ops/weno_v2.py:667", "K1", res["k1_err"], t["K1"], t["K1_plain"],
         # reads P and 3 streams, writes the interior
         bound(f32 * (padded + 4 * cells), K1_OPS_PER_CELL * cells), None),
        ("K2 refresh_ghosts_fast (ghost-shell refresh)", "refresh_ghosts.cu",
         "lsm_tpu/ops/weno_v2.py:208", "K2", res["k2_err"], t["K2"], t["K2_plain"],
         # periodic: each ghost written once from one source
         bound(f32 * 2 * ghosts, 0), None),
        ("K3 stage_backward (WENO5 stage adjoint)", "stage_backward.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:731", "K3", res["k3_err"], t["K3"],
         t[f"K3_plain@{k3_plain_n}"],
         # reads P, the folded g, 3 streams; writes dP and 3 du
         bound(f32 * (2 * padded + 7 * cells), K3_OPS_PER_CELL * cells), None),
        ("K4 fold_ghost_cotangent_fast (ghost-cotangent fold, out of place)", "fold_ghosts.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:179", "K4", res["k4_err"], t["K4"], t["K4_plain"],
         # out of place: g read once, the new buffer written once
         bound(f32 * 2 * padded, 2 * ghosts), t["K4_clone"]),
        ("K5 zero_pad_shells (ghost-shell zeroing: the gaps between interior rows)",
         "fold_ghosts.cu", "lsm_tpu/ops/weno_v2_bwd.py:293", "K5", res["k5_err"], t["K5"],
         t["K5_plain"], bound(f32 * ghosts, 0), t["K5_library"]),
        ("K6 band_stage (WENO5 advection RK stage over the active tiles)", "band_stage.cu",
         "lsm_tpu/ops/band_pallas.py:612", "K6", res["k6_err"], t["K6"], t["K6_plain"],
         # per dispatched node: P's centre and the mask read, the output
         # written; on the compute band only, the 3 tile-packed velocity
         # components read and WENO5 computed (the timed call has no aux)
         bound((f32 * 2 + 1) * work["dispatched"] + 3 * f32 * work["ops_cells"],
               K1_OPS_PER_CELL * work["ops_cells"]), None),
        ("K7 refresh_band_ghosts_fast (gated ghost-shell refresh, flags on)",
         "refresh_ghosts.cu", "lsm_tpu/ops/band_pallas.py:187", "K7", res["k7_err"], t["K7"],
         t["K7_plain"], bound(f32 * 2 * work["ghosts"], 0), None),
        ("K8 band_retube_incremental (re-tube of the candidate tiles)", "band_retube.cu",
         "lsm_tpu/ops/band_pallas.py:1185", "K8", res["k8_err"], t["K8"], t["K8_plain"],
         # the mask read within the re-tube's reach of the candidate tiles,
         # phi only at its active nodes (a cell is cut only when its corners
         # are all active), the new mask written on the candidates
         bound(work["cand_reach_cells"] + f32 * work["active_reach_cells"]
               + work["cand_cells"], 0), None),
        ("K1' fused_stage, term-list entry (normal, curvature, eikonal kinds and sums; "
         "config A: curvature + normal motion)", "weno_stage.cu", "lsm_tpu/ops/weno_v2.py:667",
         "K1'", res["k1k_err"], t["K1k_A"], t["K1k_A_plain"],
         # reads P, writes the interior (constant coefficients)
         bound(f32 * (padded + cells), KINDS_OPS["A"] * cells), None),
        ("K6' band_stage, term-list entry (config C: normal motion, streamed speed)",
         "band_stage.cu", "lsm_tpu/ops/band_pallas.py:612", "K6'", res["k6k_err"], t["K6k_C"],
         t["K6k_C_plain"],
         # per dispatched node: P's centre and the mask read, the output
         # written; on the compute band only, the tile-packed speed read
         bound((f32 * 2 + 1) * kwork["dispatched"] + f32 * kwork["ops_cells"],
               KINDS_OPS["C"] * kwork["ops_cells"]), None),
        ("K3' stage_backward_terms (the adjoint of a term-list stage: normal, curvature, "
         "eikonal kinds and sums; config A: curvature + normal motion)", "stage_backward.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:731", "K3'", res["k3k_err"], tk["A"],
         tk[f"A_plain@{N_K3K_PLAIN}"],
         # reads P and the folded g (interior), writes dP (constant coefficients)
         bound(f32 * (2 * padded + cells), K3K_OPS["A"] * cells), None),
        ("K10 weno_stage_pallas 3D (the general path's WENO5 advection stage)",
         "weno_general.cu", "lsm_tpu/ops/weno_pallas.py:263", "K10", res["k10_err"], t["K10"],
         t["K10_plain"],
         # reads the padded phi and 3 streams, writes the interior (no aux)
         bound(f32 * (padded + 4 * cells), K1_OPS_PER_CELL * cells), None),
        (f"K11 weno_stage_pallas 2D (the same in 2D, at {N_2D}^2)", "weno_general.cu",
         "lsm_tpu/ops/weno_pallas.py:294", "K11", res["k11_err"], t["K11"], t["K11_plain"],
         bound(f32 * ((N_2D + 6) ** 2 + 3 * N_2D ** 2), K11_OPS_PER_CELL * N_2D ** 2), None),
        (f"K9 write_shell_blocks (a shard's ghost-shell blocks, in place; the 512^3 flagship on "
         f"a (2, 2) mesh of the card, shard {k9_main['shape']})", "shell_blocks.cu",
         "lsm_tpu/parallel/fused_evolve.py:131", "K9", res["k9"]["err"], k9_main["ms"],
         k9_main["plain_ms"],
         # the four blocks read once and written once
         k9_main["bound"], None),
        (f"K2 refresh_axis_fast (K2's single-axis entry: the axis-2 phase of the sharded "
         f"refresh; the 512^3 flagship on a (2, 2) mesh of the card, shard "
         f"{k9_main['shape']}; device time out of L2, tools/ghost_shells.py)",
         "refresh_ghosts.cu", "lsm_tpu/ops/weno_v2.py:208", "K2ax", res["k9"]["k2ax_err"],
         shells["K2ax_2x2_axis2_device"], k9_main["K2_axis2_plain_ms"],
         k9_main["K2_axis2_bound"], None),
        ("K1'' fused_stage with an in-kernel coefficient program (the rotation)",
         "weno_stage.cu", "lsm_tpu/ops/weno_v2.py:667", "K1''", res["k1a_err"],
         t["K1pp_rotation"], t["K1pp_rotation_plain"],
         # reads P, writes the interior; WENO5 plus the program's arithmetic
         prog_bound(f32 * (padded + cells), K1_OPS_PER_CELL * cells, rot, cells), None),
        ("K3'' stage_backward with an in-kernel coefficient program (the rotation)",
         "stage_backward.cu", "lsm_tpu/ops/weno_v2_bwd.py:731", "K3''", res["k3a_err"],
         t["K3pp_rotation"], t[f"K3pp_vortex_plain@{N_PLAIN_BWD}"],
         # reads P and the folded g, writes dP (no stream, no du)
         prog_bound(f32 * (2 * padded + cells), K3_OPS_PER_CELL * cells, rot, cells), None),
        ("K6'' band_stage with an in-kernel coefficient program (the band bench's rotation)",
         "band_stage.cu", "lsm_tpu/ops/band_pallas.py:612", "K6''", res["k6a_err"], t["K6pp"],
         t["K6pp_plain"],
         # per dispatched node: P's centre and the mask read, the output
         # written; on the compute band WENO5 and the program, nothing streamed
         prog_bound((f32 * 2 + 1) * work["dispatched"], K1_OPS_PER_CELL * work["ops_cells"],
                    spin_w, work["ops_cells"]), None),
        ("K6 2D band_stage, 2D entry (a 2D band on its (n0+6, n1+6) layout; D2b's state at "
         f"{N_2D}^2, the rotation streamed)", "band_stage.cu", "lsm_tpu/ops/band_pallas.py:612",
         "K6 2D", res["k6_2d_err"]["K6 2D"], t["K6_2d"], t["K6_2d_plain"],
         # per dispatched node: P's centre and the mask read, the output
         # written; on the compute band the 2 velocity components read and
         # WENO5 on two axes computed
         bound((f32 * 2 + 1) * w2["dispatched"] + 2 * f32 * w2["ops_cells"],
               K11_OPS_PER_CELL * w2["ops_cells"]), None),
        (f"K7 2D refresh_band_ghosts_fast, 2D entry (flags on, {N_2D}^2)", "refresh_ghosts.cu",
         "lsm_tpu/ops/band_pallas.py:187", "K7 2D", res["k7_2d_err"], t["K7_2d"],
         t["K7_2d_plain"], bound(f32 * 2 * w2["ghosts"], 0), None),
        (f"K8 2D band_retube_incremental, 2D entry (D2b's candidate tiles at {N_2D}^2)",
         "band_retube.cu", "lsm_tpu/ops/band_pallas.py:1185", "K8 2D", res["k8_2d_err"],
         t["K8_2d"], t["K8_2d_plain"],
         bound(w2["cand_reach_cells"] + f32 * w2["active_reach_cells"] + w2["cand_cells"], 0),
         None),
        (f"K1 2D fused_stage, 2D entry (a 2D field on its (n0+6, n1+6) layout, the 2D march; "
         f"D2s: D2's state at {N_2D}^2, the rotation streamed)", "weno_stage_2d.cu",
         "lsm_tpu/ops/weno_v2.py:667", "K1 2D", res["k1_2d_err"]["D2s"], t["K1_2d"],
         t["K1_2d_plain"],
         # reads the padded phi and 2 streams, writes the interior (no aux)
         bound(f32 * (plane2d + 3 * cells2d), K11_OPS_PER_CELL * cells2d), None),
        (f"K1'' 2D fused_stage, 2D entry with an in-kernel coefficient program (D2's rotation "
         f"at {N_2D}^2)", "weno_stage_2d.cu", "lsm_tpu/ops/weno_v2.py:667", "K1'' 2D",
         res["k1_2d_err"]["D2"], t["K1pp_2d_rotation"], t["K1pp_2d_rotation_plain"],
         prog_bound(f32 * (plane2d + cells2d), K11_OPS_PER_CELL * cells2d, w2d["D2"], cells2d),
         None),
        (f"K1' 2D fused_stage, 2D term-list entry (D4 at {N_2D}^2: curvature + normal motion)",
         "weno_stage_2d.cu", "lsm_tpu/ops/weno_v2.py:667", "K1' 2D", res["k1_2d_err"]["D4"],
         t["K1k_2d_D4"], t["K1k_2d_D4_plain"],
         bound(f32 * (plane2d + cells2d), KINDS_OPS["D4"] * cells2d), None),
        (f"K2 2D refresh_ghosts_fast, 2D entry (one launch; D2's buffer at {N_2D}^2, Periodic)",
         "refresh_ghosts.cu", "lsm_tpu/ops/weno_v2.py:208", "K2 2D", res["k2_2d_err"],
         t["K2_2d"], t["K2_2d_plain"],
         # periodic: each ghost written once from one source
         bound(f32 * 2 * (plane2d - cells2d), 0), None),
        (f"K4 2D fold_ghost_cotangent_fast, 2D entry (out of place, one thread a node; a "
         f"cotangent on grad2d's ({N_2D}+6, {N_2D}+6) layout, Periodic)", "fold_ghosts.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:179", "K4 2D", res["k4_2d_err"], t["K4_2d"],
         t["K4_2d_plain"],
         # g read once, the new buffer written once
         bound(f32 * 2 * plane2d, 2 * (plane2d - cells2d)), t["K4_2d_clone"]),
        (f"K5 2D zero_pad_shells, 2D entry (the four ghost slabs at {N_2D}^2)", "fold_ghosts.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:293", "K5 2D", res["k5_2d_err"], t["K5_2d"],
         t["K5_2d_plain"], bound(f32 * (plane2d - cells2d), 0), t["K5_2d_library"]),
        (f"K3 2D stage_backward, 2D entry (grad2d_streamed: D2's state at {N_2D}^2, the "
         f"rotation streamed, du written)", "stage_backward.cu", "lsm_tpu/ops/weno_v2_bwd.py:731",
         "K3 2D", res["k3_2d_4096"]["K3 2D"]["abs"], t["K3_2d"], t["K3_2d_plain"],
         # reads P, the folded g and 2 streams, writes dP and 2 du
         bound(f32 * (2 * plane2d + 5 * cells2d), K3_2D_OPS_PER_CELL * cells2d), None),
        (f"K3'' 2D stage_backward, 2D entry with an in-kernel coefficient program (grad2d: "
         f"D2's rotation at {N_2D}^2)", "stage_backward.cu", "lsm_tpu/ops/weno_v2_bwd.py:731",
         "K3'' 2D", res["k3_2d_4096"]["K3'' 2D"]["abs"], t["K3pp_2d"], t["K3pp_2d_plain"],
         # reads P and the folded g, writes dP; the program's arithmetic besides
         prog_bound(f32 * (2 * plane2d + cells2d), K3_2D_OPS_PER_CELL * cells2d, w2d["D2"],
                    cells2d), None),
        (f"K3' 2D stage_backward_terms, 2D entry (grad2d_kinds: curvature + normal motion at "
         f"a streamed speed, config 4's star at {N_2D}^2)", "stage_backward.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:731", "K3' 2D", res["k3_2d_4096"]["K3' 2D"]["abs"],
         t["K3k_2d"], t["K3k_2d_plain"],
         # reads P, the folded g and the speed, writes dP and the speed's cotangent
         bound(f32 * (2 * plane2d + 3 * cells2d), K3K_OPS_2D * cells2d), None),
        ("K1''/K3''/K6'' program tables (the per-axis subexpressions of a traced coefficient; "
         "the vortex)", "coef_tables.cu", "lsm_tpu/ops/weno_v2.py:508", "tables",
         res["tables_err"], t["tables_vortex"], t["tables_vortex_plain"],
         # each entry written once from the coordinates and t
         bound(f32 * vortex["table_entries"], vortex["table_ops"]), None),
    ]
    out = []
    for name, src, replaces, key, err, ms, plain_ms, (bound_ms, bound_by), lib_ms in rows:
        rec = {"name": name, "route": "cuda", "source": f"lsm_tpu_torch/csrc/{src}",
               "replaces": replaces, "launches": res["launches"][key], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        if key == "K3":
            rec["plain_grid"] = f"{k3_plain_n}^3"
        if key in ("K2", "K4"):  # a call back to back and the profiler's device time; K4's
            # library_ms is g.clone() of the same buffer (its copy floor), timed alike
            rec.update(ms_back_to_back=t[f"{key}_back_to_back"], ms_device=t[f"{key}_device"],
                       ms_device_by_bc={bc: res["shells"][f"{bc}_{key}_device"]
                                        for bc in ("periodic", "extrap2", "mixed7")})
        if key == "K5":  # the device time a call (a process of its own) and back to back;
            # the bound with every sector the shells touch written whole
            rec.update(library_call="masked_fill_", ms_device=shells["K5_device"],
                       ms_back_to_back=shells["K5_b2b"],
                       bound_by_sector_ms=bound(res["k5_sector_bytes"], 0)[0])
        if key == "K2ax":  # the (4, 1) mesh's shard: axes 1 and 2; the event time a call
            # and the profiler's in this process beside the device time
            rec.update(ms_event=shells["K2ax_2x2_axis2_event"],
                       ms_device_in_process=k9_main["K2_axis2_ms"],
                       bound_by_sector_ms=bound(k9_main["K2_axis2_sectors"], 0)[0],
                       ms_axis1_mesh_4x1=shells["K2ax_4x1_axis1_device"],
                       ms_axis2_mesh_4x1=shells["K2ax_4x1_axis2_device"],
                       bound_ms_axis1_mesh_4x1=k9[(4, 1)]["K2_axis1_bound"][0],
                       bound_ms_axis2_mesh_4x1=k9[(4, 1)]["K2_axis2_bound"][0],
                       shard_4x1=list(k9[(4, 1)]["shape"]))
        if key in ("K2", "K4", "K7"):  # the route for an Extrapolation of degree above 7
            # (the by-value kernels' threads reading a table of weights) at 512^3
            # f32 beside the by-value route's Extrapolation(7) in the same run (CUDA events;
            # device times from tools/ghost_shells.py, a process of its own); its kernels a
            # call (the profiler's names); K2's launches on the flagship under Extrapolation(8)
            deg = res["k2_degree"]
            dk = {"K2": "K2", "K4": "K4", "K7": "K7on"}[key]
            rec.update(table_route={
                "source": f"lsm_tpu_torch/csrc/{'fold' if key == 'K4' else 'refresh'}_ghosts.cu",
                "ms_extrapolation8": deg["degree8"][key], "ms_extrapolation7": deg["degree7"][key],
                "ms_device_extrapolation8": deg["device"][f"degree8_{dk}_device"],
                "ms_device_extrapolation7": deg["device"][f"degree7_{dk}_device"],
                "bound_ms_extrapolation8": (deg["degree8"]["K2_bound"] if key != "K4"
                                            else bound(f32 * 2 * padded, 0)[0]),
                "kernels_per_call": {k: n for k, n in deg["launches_per_call"].items()
                                     if k.startswith(key)},
                "launches_flagship_extrapolation8": res["launches"]["K2 table"]
                if key == "K2" else None})
            if key == "K4":
                rec["table_route"]["library_ms_device"] = deg["device"]["degree_clone_device"]
            if key == "K7":
                rec["table_route"]["ms_device_flags_off_extrapolation8"] = deg["device"][
                    "degree8_K7off_device"]
        if key == "K4":
            rec.update(library_call="g.clone()",
                       library_ms_back_to_back=t["K4_clone_back_to_back"],
                       library_ms_device=t["K4_clone_device"])
        if key in ("K7", "K7 2D"):  # the 512^3 band and D2b stay off the faces: the main
            # path's K7 is gated off, one launch reading the two flags (8 B); the profiler's
            # device time and a call back to back (tools/general_band.py, its own process)
            tk2 = {"K7": "K7", "K7 2D": "K7_2d"}[key]
            rec.update(ms_flags_off=t[f"{tk2}_off"], bound_ms_flags_off=bound(8, 0)[0],
                       ms_device=t[f"{tk2}_device"], ms_device_flags_off=t[f"{tk2}_off_device"],
                       ms_back_to_back=t[f"{tk2}_b2b"],
                       ms_back_to_back_flags_off=t[f"{tk2}_off_b2b"])
        if key == "K10":  # with aux (RK3 stages 2 and 3): one more interior read
            rec.update(ms_aux=t["K10_aux"],
                       bound_ms_aux=bound(f32 * (padded + 5 * cells), K1_OPS_PER_CELL * cells)[0])
        if key == "K11":  # with aux; the profiler's device times (tools/general_band.py)
            rec.update(ms_aux=t["K11_aux"], bound_ms_aux=bound(
                f32 * ((N_2D + 6) ** 2 + 4 * N_2D ** 2), K11_OPS_PER_CELL * N_2D ** 2)[0],
                ms_device=t["K11_device"], ms_aux_device=t["K11_aux_device"])
        if key == "K3'":  # plain at its own grid; config C's dense normal motion (streamed
            # speed: its read and its cotangent's write); the parity against plain and oracle
            m = N_K3K_PLAIN
            rec.update(plain_grid=f"{m}^3", ms_at_plain_grid=tk[f"A@{m}"], ms_C=tk["C"],
                       bound_ms_C=bound(f32 * (2 * padded + 3 * cells), K3K_OPS["C"] * cells)[0],
                       ms_C_at_plain_grid=tk[f"C@{m}"], plain_ms_C=tk[f"C_plain@{m}"],
                       rel_err_f64_vs_plain=res["k3k_rel"][0],
                       rel_err_f32_vs_f64_oracle=res["k3k_rel"][1],
                       ops_per_cell={"A": K3K_OPS["A"], "C": K3K_OPS["C"]})
        if key == "K1''":  # the time-dependent vortex
            rec.update(ms_vortex=t["K1pp_vortex"], plain_ms_vortex=t["K1pp_vortex_plain"],
                       bound_ms_vortex=prog_bound(f32 * (padded + cells), K1_OPS_PER_CELL * cells,
                                                  vortex, cells)[0],
                       ms_streamed_K1=t["K1"], program_work={"rotation": rot, "vortex": vortex})
        if key == "K3''":  # the vortex with dt (dual numbers); plain at its own grid
            m = N_PLAIN_BWD
            rec.update(plain_grid=f"{m}^3", plain_case="vortex, dt",
                       ms_vortex_dt=t["K3pp_vortex"], ms_vortex_dt_at_plain_grid=t[
                           f"K3pp_vortex@{m}"], ms_streamed_K3=t["K3"],
                       bound_ms_vortex_dt=prog_bound(f32 * (2 * padded + cells),
                                                     K3_OPS_PER_CELL * cells, vortex, cells,
                                                     dual=True)[0],
                       rel_err_512_sub_box=res["k3a_512_rel"])
        if key in ("K7", "K7 2D"):
            rec["ptxas"] = {k: v for k, v in res["band_ptxas"].items()
                            if k.split(" (")[0].rsplit(" ", 1)[0] == key}
        if key in ("K6", "K6'", "K6''", "K8"):  # ms a call back to back (the host's
            # issue hidden); registers and shared memory (build log)
            rec["ms_back_to_back"] = t[{"K6": "K6_back_to_back", "K6'": "K6k_C_back_to_back",
                                        "K6''": "K6pp_back_to_back",
                                        "K8": "K8_back_to_back"}[key]]
            rec["ptxas"] = {k: v for k, v in res["band_ptxas"].items() if k.split(" ")[0] == key}
        if key == "K6''":
            rec.update(ms_streamed_K6=t["K6"])
        if key == "K6 2D":  # D2b's own entry, the rotation in-kernel (K6'' 2D); D4b's K6'
            rec.update(ms_program=t["K6pp_2d"], plain_ms_program=t["K6pp_2d_plain"],
                       bound_ms_program=prog_bound(
                           (f32 * 2 + 1) * w2["dispatched"], K11_OPS_PER_CELL * w2["ops_cells"],
                           w2["prog"], w2["ops_cells"])[0],
                       max_abs_err_program=res["k6_2d_err"]["K6'' 2D"],
                       max_abs_err_terms=res["k6_2d_err"]["K6' 2D"],
                       launches_program=res["launches"]["K6'' 2D"],
                       launches_terms_D4b=res["launches"]["K6' 2D"], tiles=list(w2["tiles"]),
                       dispatched_tiles=w2["slots"])
        if key in ("K4 2D", "K5 2D", "K3 2D", "K3'' 2D", "K3' 2D"):  # the profiler's device
            # time (tools/grad_2d.py, a process of its own); the max_abs_err of a stage
            # adjoint is its f32 error against the f64 plain version at the main path's
            # shape (grad2d_4096), its relative errors there and at the small shapes
            # (grad2d_parity: f32 against the f64 oracle, f64 against the plain version)
            tk2 = {"K4 2D": "K4_2d", "K5 2D": "K5_2d", "K3 2D": "K3_2d", "K3'' 2D": "K3pp_2d",
                   "K3' 2D": "K3k_2d"}[key]
            rec["ms_device"] = t[f"{tk2}_device"]
            if key.startswith("K3"):
                rec.update(max_rel_err_sub_boxes=res["k3_2d_4096"][key]["rel"],
                           max_rel_err_small_shapes=res["k3_2d_rel"][key],
                           max_rel_err_f64_vs_plain=res["k3_2d_rel"][f"{key} f64"])
        if key == "K4 2D":
            rec.update(library_call="g.clone()", library_ms_device=t["K4_2d_clone_device"])
        if key == "K5 2D":
            rec["library_call"] = "masked_fill_"
        if key == "K3 2D":
            rec.update(ms_aux=t["K3_2d_aux"], bound_ms_aux=bound(
                f32 * (3 * plane2d + 6 * cells2d), K3_2D_OPS_PER_CELL * cells2d)[0])
        if key == "K3'' 2D":  # the vortex with dt; the 2D gradient cells end to end
            rec["cells"] = {k: {"ms": v["ms"], "peak_gib": v["peak_gib"], "plain_autograd_ms":
                                res["grad2d_tool"][f"{k}_plain_autograd_ms"]}
                            for k, v in res["grad2d"].items()}
            rec.update(ms_vortex_dt=t["K3pp_2d_vortex_dt"], bound_ms_vortex_dt=prog_bound(
                f32 * (2 * plane2d + cells2d), K3_2D_OPS_PER_CELL * cells2d, w2d["D3"], cells2d,
                dual=True)[0])
        if key in ("K1 2D", "K1'' 2D", "K1' 2D"):  # with aux (one more read), the per-node form
            tk2 = {"K1 2D": "K1_2d", "K1'' 2D": "K1pp_2d_rotation", "K1' 2D": "K1k_2d_D4"}[key]
            aux_bytes = f32 * (plane2d + 2 * cells2d)  # phi and aux read, the interior written
            bound_aux = {"K1 2D": bound(aux_bytes + 2 * f32 * cells2d,
                                        K11_OPS_PER_CELL * cells2d),
                         "K1'' 2D": prog_bound(aux_bytes, K11_OPS_PER_CELL * cells2d, w2d["D2"],
                                               cells2d),
                         "K1' 2D": bound(aux_bytes, KINDS_OPS["D4"] * cells2d)}[key]
            rec.update(ms_aux=t[f"{tk2}_aux"], ms_per_node=t[f"{tk2}_per_node"],
                       bound_ms_aux=bound_aux[0],
                       route=res["k1_2d_routes"].get(
                           {"K1 2D": "K1 streamed", "K1'' 2D": "K1'' rotation",
                            "K1' 2D": "K1' D4"}[key]),
                       max_rel_err_small_shapes=res["k1_2d_small_err"])
        if key == "K1'' 2D":  # the vortex (components per node), D3's state; D2's busy share
            rec.update(ms_vortex=t["K1pp_2d_vortex"], plain_ms_vortex=t["K1pp_2d_vortex_plain"],
                       ms_vortex_per_node=t["K1pp_2d_vortex_per_node"],
                       bound_ms_vortex=prog_bound(f32 * (plane2d + cells2d),
                                                  K11_OPS_PER_CELL * cells2d, w2d["D3"],
                                                  cells2d)[0],
                       max_abs_err_vortex=res["k1_2d_err"]["D3"],
                       program_work={"rotation": w2d["D2"], "vortex": w2d["D3"]},
                       D2_device_busy_share=res["D2_busy_share"])
        if key == "K9":  # ms: device time (profiler); a call between events beside it; the
            # (4, 1) mesh: the axis-0 pair only; K2's axis-2 phase beside it
            r41 = k9[(4, 1)]
            rec.update(ms_hot_l2=k9_main["ms_hot_l2"],
                       ms_per_launch_in_main_path=res["sharded"]["k9_path_ms"],
                       ms_one_call_with_host=k9_main["call_ms"],
                       plain_ms_one_call_with_host=k9_main["plain_call_ms"],
                       ms_mesh_4x1=r41["ms"], plain_ms_mesh_4x1=r41["plain_ms"],
                       bound_ms_mesh_4x1=r41["bound"][0], shard_4x1=list(r41["shape"]),
                       launches_per_step=res["launches"]["K9"] // SHARDED_STEPS)
        if key == "tables":
            rec.update(ms_rotation=t["tables_rotation"], plain_ms_rotation=t[
                "tables_rotation_plain"], work={"rotation": rot, "vortex": vortex})
        if key == "K1'":  # config B's stage (one streamed sign, 12 B/cell) and the sign
            # recomputed (8 B/cell); the kinds gradient's table (A's terms, a streamed
            # speed); A and it with aux (one more read); D4 at N_2D^2 (the embedding:
            # one padded plane read, the interior written)
            plane2d, cells2d = (N_2D + 6) ** 2, N_2D ** 2
            rec.update(ms_B_frozen=t["K1k_B_frozen"], plain_ms_B_frozen=t["K1k_B_frozen_plain"],
                       bound_ms_B_frozen=bound(f32 * (padded + 2 * cells),
                                               KINDS_OPS["B"] * cells)[0],
                       ms_B_none=t["K1k_B_none"], plain_ms_B_none=t["K1k_B_none_plain"],
                       bound_ms_B_none=bound(f32 * (padded + cells),
                                             KINDS_OPS["B none"] * cells)[0],
                       ms_A_aux=t["K1k_A_aux"],
                       bound_ms_A_aux=bound(f32 * (padded + 2 * cells), KINDS_OPS["A"] * cells)[0],
                       ms_kinds_grad=t["K1k_grad"], ms_kinds_grad_aux=t["K1k_grad_aux"],
                       bound_ms_kinds_grad=bound(f32 * (padded + 2 * cells),
                                                 KINDS_OPS["A"] * cells)[0],
                       ms_D4=t["K1k_D4"], plain_ms_D4=t["K1k_D4_plain"],
                       bound_ms_D4=bound(f32 * (plane2d + cells2d), KINDS_OPS["D4"] * cells2d)[0],
                       launches_D4=res["launches"].get("K1' D4", 0),
                       launches_kinds_grad=res["launches"].get("K1' kinds grad", 0),
                       max_rel_err_march_shapes=res["k1k_march_rel"],
                       routes=res["k1k_routes"], ops_per_cell={
                           k: KINDS_OPS[k] for k in ("A", "B", "B none", "D4")})
        out.append(rec)
    if not all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in out):
        raise AssertionError("a kernel was not measured or not launched on the main path")
    return out


if __name__ == "__main__":
    sys.exit(main(tuple(sys.argv[1:])))
