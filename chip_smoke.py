"""On-card smoke test of the PyTorch + CUDA port (``lsm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one line of results (any failure raises and the script
exits non-zero):

1. device  — ``nvidia-smi`` name and power limit; no CUDA device is an error;
             ``lsm.sample`` with no ``device`` lands on the card.
2. build   — nvcc builds the kernels from ``lsm_tpu_torch/csrc`` (sm_90a, one
             process per source); prints the build time and ptxas
             register/spill counts.
3. k2      — ghost-refresh kernel vs its plain version, five BC cases.
4. k1      — stage kernel vs its plain version, f32 (and f64).
5. k4k5    — ghost-cotangent fold (K4) vs its plain version and the autograd
             transpose of ``pack_padded``, five BC cases; shell zeroing (K5)
             vs its plain version.
6. k3      — stage backward (K3) in f32 vs the f64 autograd oracle of stage +
             refresh, in f64 vs its plain version, in f32 vs its plain version.
7. k512    — K1 and K2 vs their plain versions at the main path's 512^3
             shape, on its own inputs (Zalesak field, rotation velocity).
8. k3_512  — K3 at 512^3 on the main path's inputs: a 64^3 sub-box vs the
             f64 plain backward, the whole buffer finite; K4 and K5 bit for
             bit vs their plain versions at 512^3, on a random cotangent and
             on K3's dP.
9. slice   — 64^3 Zalesak RK3 ``integrate``: CPU (plain) vs card (kernels).
10. main   — the 512^3 Zalesak RK3 main path through
             ``LevelSetEquation.integrate``, counting kernel launches.
11. grad   — the gradient slice: ``value_and_grad`` of one fused FE step at
             512^3 (streamed and callable velocity) with a 64^3 f64
             central-difference check, and of a 20-step RK3 ``rollout``
             under remat at 512^3, counting K1-K5 launches; remat and
             card-vs-CPU gradient checks at 64^3 (f64 max norm; f32
             relative L2 against the CPU's own 1-ulp spread).
12. timing — CUDA-event medians at 512^3: K1-K5, the FE and RK3 steps
             through the kernels and through the plain versions, the
             end-to-end ``integrate`` time per step for FE and RK3, the two
             gradient cells, and the plain backward; peak memory of each.
13. profile — ``torch.profiler`` over 3 RK3 steps of the main path: device
             busy share of the wall time and device time by kernel.

The last two lines are the card (``nvidia-smi``) and a JSON verdict; the line
before them holds the per-kernel JSON record: launches on the main paths,
error against the plain version, time, the plain version's time, the bound
(the larger of the bytes over 3.35 TB/s and the FP32 operations over 67
TFLOP/s, the H100 SXM data sheet's rates) and, where one PyTorch call computes
the same function, that call's time.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import torch

import lsm_tpu_torch as lsm
from lsm_tpu_torch.integrators.fused import FusedStepper
from lsm_tpu_torch.models import shapes
from lsm_tpu_torch.ops import _build
from lsm_tpu_torch.ops import stencils as st
from lsm_tpu_torch.ops import weno_v2 as v2
from lsm_tpu_torch.ops import weno_v2_bwd as bwd

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
FP32_OPS_PER_S = 67e12
# FP32 operations per interior cell, counted from the sources (a division
# counts as one): csrc/weno_stage.cu 88 per axis + 5, csrc/stage_backward.cu
# 202 per axis + 1 (FE form, no aux)
K1_OPS_PER_CELL = 3 * 88 + 5
K3_OPS_PER_CELL = 3 * 202 + 1

COUNTED = {"K1": v2.fused_stage, "K2": v2.refresh_ghosts_fast, "K3": bwd.stage_backward,
           "K4": bwd.fold_ghost_cotangent_fast, "K5": bwd.zero_pad_shells}


def reset_counts():
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


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


def phase_k2(dev, res):
    shape = (40, 72, 136)
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for name, bcs in bc_cases().items():
        vals = torch.randn(shape, generator=gen, device=dev)
        P = v2.pack_padded(vals, bcs)
        shell = torch.ones_like(P, dtype=torch.bool)
        v2.unpack_padded(shell, shape).fill_(False)
        P[shell] = torch.randn(int(shell.sum()), generator=gen, device=dev)  # scribble
        got = v2.refresh_ghosts_fast(P.clone(), bcs, shape)
        ref = v2.refresh_ghosts_plain(P.clone(), bcs, shape)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        err_pad = float((got - v2.pack_padded(vals, bcs)).abs().max())
        log("k2", f"{name:9s} shape={shape} max|kernel-plain|={err:.3e} "
                  f"max|kernel-pad_ghost|={err_pad:.3e}")
        if not (err <= K2_TOL and err_pad <= K2_TOL):
            raise AssertionError(f"K2 parity failed for {name}: {err} / {err_pad} > {K2_TOL}")
        worst = max(worst, err)
    res["k2_err"] = worst


def phase_k1(dev, res):
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype, shape, tol in ((torch.float32, (96, 128, 160), K1_TOL),
                              (torch.float64, (32, 48, 64), 1e-12)):
        grid = lsm.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), shape)
        P = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
        A = torch.randn(v2.padded_shape(shape), generator=gen, device=dev, dtype=dtype)
        xs = v2.node_coords(shape, grid.spacing, grid.lo, dtype, dev)
        u = v2.eval_components(rotation(xs, 0.0), shape, dtype, dev)  # u2 == 0: ties
        for aux, coeffs in ((None, (0.0, 1.0, 1e-3)), (A, (0.75, 0.25, 2.5e-4))):
            got = v2.fused_stage(P, u, coeffs, aux, grid.spacing, shape)
            ref = v2.stage_plain(P, u, coeffs, aux, grid.spacing, shape)
            torch.cuda.synchronize()
            g, r = v2.unpack_padded(got, shape), v2.unpack_padded(ref, shape)
            err = float((g - r).abs().max())
            scale = max(float(r.abs().max()), 1.0)
            ok = bool(torch.isfinite(g).all()) and err <= tol * scale
            log("k1", f"{str(dtype):13s} shape={shape} aux={aux is not None} "
                      f"max|kernel-plain|={err:.3e} scale={scale:.3e} tol={tol:g}*scale")
            if not ok:
                raise AssertionError(f"K1 parity failed: {err} > {tol} * {scale}")
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


def phase_k4k5(dev, res):
    """K4 against its plain version and the autograd transpose of
    ``pack_padded``; K5 against its plain version (bit for bit)."""
    shape = (40, 72, 136)
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = 0.0
    for name, bcs in bc_cases().items():
        G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
        got = bwd.fold_ghost_cotangent_fast(G.clone(), bcs, shape)
        plain = bwd.fold_ghost_cotangent_plain(G.clone(), bcs, shape)
        ref = bwd.fold_ghost_cotangent(G, bcs, shape)
        torch.cuda.synchronize()
        scale = max(float(ref.abs().max()), 1.0)
        err = float((got - plain).abs().max())
        err_ref = float((v2.unpack_padded(got, shape) - ref).abs().max())
        shells_zero = not bool(got[shell_mask(shape, dev)].any())
        log("k4k5", f"K4 {name:9s} shape={shape} max|kernel-plain|={err:.3e} "
                    f"max|kernel-autograd|={err_ref:.3e} scale={scale:.3e} "
                    f"tol={K4_TOL:g}*scale shells_zero={shells_zero}")
        if not (err <= K4_TOL * scale and err_ref <= K4_TOL * scale and shells_zero):
            raise AssertionError(f"K4 parity failed for {name}: {err} / {err_ref}")
        worst = max(worst, err)
    buf = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
    got = bwd.zero_pad_shells(buf.clone(), shape)
    same = bool(torch.equal(got, bwd.zero_pad_shells_plain(buf.clone(), shape)))
    log("k4k5", f"K5 shape={shape} kernel == plain: {same}")
    if not same:
        raise AssertionError("K5 differs from its plain version")
    res["k4_err"], res["k5_err"] = worst, 0.0


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
            gf = bwd.fold_ghost_cotangent_fast(G.clone(), bcs, shape)
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
    u = stepper.velocity(0.0)
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
        gf = bwd.fold_ghost_cotangent_fast(G.clone(), bcs, shape)
        dP, du, dcoef, daux = bwd.stage_backward(src, u, coeffs, aux, gf, sp, shape)
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


def k4k5_512(G, bcs, shape, label, res):
    """K4 and K5 bit for bit against their plain versions on a padded
    buffer of the main path's shape; their max|kernel - plain| go into
    ``res``."""
    got = bwd.fold_ghost_cotangent_fast(G.clone(), bcs, shape)
    err4 = float((got - bwd.fold_ghost_cotangent_plain(G.clone(), bcs, shape)).abs().max())
    del got
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
    u = stepper.velocity(0.0)
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
    gen = torch.Generator(device=dev).manual_seed(3)
    shell = torch.ones_like(P1, dtype=torch.bool)
    v2.unpack_padded(shell, shape).fill_(False)
    Q = P1.clone()
    Q[shell] = torch.randn(int(shell.sum()), generator=gen, device=dev)  # scribble
    got = v2.refresh_ghosts_fast(Q.clone(), bcs, shape)
    ref = v2.refresh_ghosts_plain(Q, bcs, shape)
    err = float((got - ref).abs().max())
    err_pad = float((got - P1).abs().max())
    log("k512", f"K2 periodic {N_MAIN}^3 f32 max|kernel-plain|={err:.3e} "
                f"max|kernel-pad_ghost|={err_pad:.3e}")
    if not (err <= K2_TOL and err_pad <= K2_TOL):
        raise AssertionError(f"K2 parity at {N_MAIN}^3 failed: {err} / {err_pad} > {K2_TOL}")
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
    torch.cuda.reset_peak_memory_stats()
    grid, phi, vel = zalesak(N_MAIN, dev)
    vol0 = float(lsm.volume(phi))
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(vel), ic=phi, integrator=lsm.RK3())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eq.integrate(1.0, max_steps=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = eq.last_nsteps
    vol1 = float(eq.volume())
    finite = bool(torch.isfinite(eq.state.values).all())
    rel = abs(vol1 - vol0) / vol0
    log("main", f"{N_MAIN}^3 RK3 streamed velocity: steps={steps} t={eq.t:.6f} "
                f"path={eq.last_fast_path} launches={launches} finite={finite} "
                f"volume {vol0:.6e} -> {vol1:.6e} (rel {rel:.2e}) wall={wall:.3f}s "
                f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (steps == 10 and eq.last_fast_path == "fused" and finite and rel <= VOL_TOL
            and tuple(eq.state.values.shape) == grid.shape
            and launches == {"K1": 3 * steps, "K2": 3 * steps, "K3": 0, "K4": 0, "K5": 0}):
        raise AssertionError("main path check failed")
    res["launches"] = {"K1": launches["K1"], "K2": launches["K2"]}
    del eq, vel
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(rotation), ic=phi, integrator=lsm.RK3())
    eq.integrate(1.0, max_steps=2)
    finite = bool(torch.isfinite(eq.state.values).all())
    rel = abs(float(eq.volume()) - vol0) / vol0
    log("main", f"{N_MAIN}^3 RK3 callable velocity: steps={eq.last_nsteps} "
                f"path={eq.last_fast_path} finite={finite} volume rel change {rel:.2e}")
    if not (eq.last_nsteps == 2 and eq.last_fast_path == "fused" and finite and rel <= VOL_TOL):
        raise AssertionError("callable-velocity main path check failed")


def fe_grad_loss(v, streams, bcs, sp, shape, dt):
    """Cell (a)'s loss ``sum(unpack(step(pack(phi)))^2)`` of one fused FE
    step through ``fused_step_stage``."""
    P = v2.pack_padded(v, bcs)
    out = v2.fused_step_stage(P, streams, (0.0, 1.0, dt), None, bcs, sp, shape)
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
    loss = fe_grad_loss(v, tuple(u[d] for d in range(3)), bcs, sp, shape, dt)
    gv, gu = torch.autograd.grad(loss, (v, u))
    ok_a = math.isfinite(loss.item()) and bool(torch.isfinite(gv).all()) and bool(
        torch.isfinite(gu).all())
    stream_c = FusedStepper(lsm.AdvectionTerm(rotation), phi, lsm.ForwardEuler()).velocity(0.0)
    loss_c = fe_grad_loss(v, stream_c, bcs, sp, shape, dt)
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
    want = {"K1": 2 * 3 * ROLLOUT_STEPS, "K2": 2 * 3 * ROLLOUT_STEPS, "K3": 3 * ROLLOUT_STEPS,
            "K4": 3 * ROLLOUT_STEPS, "K5": 2 * ROLLOUT_STEPS}
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
    res["launches"].update({k: counts[k] for k in ("K3", "K4", "K5")})


class PlainStepper(FusedStepper):
    """The fused stepper with each stage on the kernels' plain versions, to
    time the plain step on the card (``integrate`` never routes a CUDA
    tensor there)."""

    def stage(self, P, coeffs, t_stage, aux, coeff_values=None):
        out = v2.stage_plain(P, self.velocity(t_stage), coeffs, aux, self.spacing, self.shape)
        return v2.refresh_ghosts_plain(out, self.bcs, self.shape)


def integrate_ms_per_step(term, phi, integrator, steps=10) -> float:
    """End-to-end ms per accepted step of ``integrate``: the median over 20
    calls of ``steps`` steps each (CFL bound, ``.item()`` sync, pack and
    unpack included)."""
    eq = lsm.LevelSetEquation(terms=term, ic=phi, integrator=integrator)

    def run():
        eq.integrate(eq.t + 1.0, max_steps=steps)
        if eq.last_nsteps != steps or eq.last_fast_path != "fused":
            raise AssertionError(f"integrate took {eq.last_nsteps} steps on "
                                 f"{eq.last_fast_path}, not {steps} on fused")

    eq.integrate(eq.t + 1.0, max_steps=2)  # warm-up
    return cuda_time(run, warmup=0) / steps


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
    u = fe.velocity(0.0)
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t["K1"] = cuda_time(lambda: v2.fused_stage(P, u, (0.0, 1.0, dt), None, sp, shape))
    t["K1_aux"] = cuda_time(lambda: v2.fused_stage(P, u, (0.75, 0.25, dt), P, sp, shape))
    t["K2"] = cuda_time(lambda: v2.refresh_ghosts_fast(P, bcs, shape))
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
    res["t"] = t
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
    gf = bwd.fold_ghost_cotangent_fast(G.clone(), bcs, shape)
    coeffs = (0.0, 1.0, dt)
    t["K3"] = cuda_time(lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape))
    t["K3_aux"] = cuda_time(lambda: bwd.stage_backward(P, u, (0.75, 0.25, dt), P, gf, sp,
                                                       shape))
    mem["K3"] = peak_gib(lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape))
    t["K4"] = cuda_time(lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape))
    t["K5"] = cuda_time(lambda: bwd.zero_pad_shells(G, shape))
    mask = shell_mask(shape, dev)
    t["K5_library"] = cuda_time(lambda: G.masked_fill_(mask, 0.0))
    del mask
    t["K4_plain"] = cuda_time(lambda: bwd.fold_ghost_cotangent_plain(G, bcs, shape), warmup=1)
    t["K5_plain"] = cuda_time(lambda: bwd.zero_pad_shells_plain(G, shape), warmup=1)
    del G
    # cell (a): value_and_grad of one FE step, streamed (grads w.r.t. phi and
    # the 3 components) and callable (w.r.t. phi)
    velv = vel.values.clone().requires_grad_()
    phiv = phi.values.clone().requires_grad_()
    stream_c = FusedStepper(lsm.AdvectionTerm(rotation), phi, lsm.ForwardEuler()).velocity(0.0)
    dt_a = 0.25 * grid.min_spacing

    def cell_a_streamed():
        loss = fe_grad_loss(phiv, tuple(velv[d] for d in range(3)), bcs, sp, shape, dt_a)
        return torch.autograd.grad(loss, (phiv, velv))

    def cell_a_callable():
        return torch.autograd.grad(fe_grad_loss(phiv, stream_c, bcs, sp, shape, dt_a), phiv)

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


def profile_window(label, fn):
    """``torch.profiler`` over one call of ``fn`` (warmed up first): wall
    time, device busy share, and the device time by kernel."""
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
    log("profile", f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
                   f"({100 * busy_us / wall_us:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def phase_profile(dev, res):
    """``torch.profiler`` over 3 RK3 steps of the 512^3 main path, one
    ``value_and_grad`` of cell (a) (streamed) and one of cell (b): the device
    busy share and the device time by kernel."""
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


def main() -> int:
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
    res = {}
    for name, run in (("device", phase_device), ("k2", phase_k2), ("k1", phase_k1),
                      ("k4k5", phase_k4k5), ("k3", phase_k3), ("k512", phase_k512),
                      ("k3_512", phase_k3_512), ("slice", phase_slice), ("main", phase_main),
                      ("grad", phase_grad), ("timing", phase_timing),
                      ("profile", phase_profile)):
        t0 = time.perf_counter()
        run(dev, res)
        log(name, f"phase done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernel_records(res)}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_records(res):
    """One record per kernel for the JSON line; each bound counts what the
    timed call must move and compute at the main path's 512^3 f32 shape."""
    t, n = res["t"], N_MAIN
    cells, padded, ghosts = n ** 3, (n + 6) ** 3, (n + 6) ** 3 - n ** 3
    f32 = 4
    k3_plain_n = res["K3_plain_n"]
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
        ("K4 fold_ghost_cotangent_fast (ghost-cotangent fold)", "fold_ghosts.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:179", "K4", res["k4_err"], t["K4"], t["K4_plain"],
         # periodic: each ghost read and zeroed, its source read and written
         bound(f32 * 4 * ghosts, 2 * ghosts), None),
        ("K5 zero_pad_shells (ghost-shell zeroing)", "fold_ghosts.cu",
         "lsm_tpu/ops/weno_v2_bwd.py:293", "K5", res["k5_err"], t["K5"], t["K5_plain"],
         bound(f32 * ghosts, 0), t["K5_library"]),
    ]
    out = []
    for name, src, replaces, key, err, ms, plain_ms, (bound_ms, bound_by), lib_ms in rows:
        rec = {"name": name, "route": "cuda", "source": f"lsm_tpu_torch/csrc/{src}",
               "replaces": replaces, "launches": res["launches"][key], "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        if key == "K3":
            rec["plain_grid"] = f"{k3_plain_n}^3"
        out.append(rec)
    if not all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in out):
        raise AssertionError("a kernel was not measured or not launched on the main path")
    return out


if __name__ == "__main__":
    sys.exit(main())
