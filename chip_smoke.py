"""On-card smoke test of the PyTorch + CUDA port (``lsm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one line of results (any failure raises and the script
exits non-zero):

1. device  — ``nvidia-smi`` name and power limit; no CUDA device is an error.
2. build   — nvcc builds the kernels from ``lsm_tpu_torch/csrc`` (sm_90a);
             prints the build time and ptxas register/spill counts.
3. k2      — ghost-refresh kernel vs its plain version, five BC cases.
4. k1      — stage kernel vs its plain version, f32 (and f64).
5. k512    — both kernels vs their plain versions at the main path's 512^3
             shape, on its own inputs (Zalesak field, rotation velocity).
6. slice   — 64^3 Zalesak RK3 ``integrate``: CPU (plain) vs card (kernels).
7. main    — the 512^3 Zalesak RK3 main path through
             ``LevelSetEquation.integrate``, counting kernel launches.
8. timing  — CUDA-event medians at 512^3: K1, K2, the FE and RK3 steps
             through the kernels and through the plain versions, and the
             end-to-end ``integrate`` time per step (CFL bound and sync
             included) for FE and RK3.
9. profile — ``torch.profiler`` over 3 RK3 steps of the main path: device
             busy share of the wall time and device time by kernel.

The last two lines are the card (``nvidia-smi``) and a JSON verdict; the line
before them holds the per-kernel JSON record.
"""

from __future__ import annotations

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
from lsm_tpu_torch.ops import weno_v2 as v2

N_MAIN = 512
K1_TOL = 1e-5  # relative to max(|ref|, 1): the JAX on-chip parity bound
K2_TOL = 1e-6
VOL_TOL = 1e-3  # relative volume change over the main path's 10 RK3 steps


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
    v2.fused_stage.launches = 0
    v2.refresh_ghosts_fast.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eq.integrate(1.0, max_steps=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": v2.fused_stage.launches, "K2": v2.refresh_ghosts_fast.launches}
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
            and launches["K1"] == 3 * steps and launches["K2"] == 3 * steps):
        raise AssertionError("main path check failed")
    res["launches"] = launches
    del eq, vel
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(rotation), ic=phi, integrator=lsm.RK3())
    eq.integrate(1.0, max_steps=2)
    finite = bool(torch.isfinite(eq.state.values).all())
    rel = abs(float(eq.volume()) - vol0) / vol0
    log("main", f"{N_MAIN}^3 RK3 callable velocity: steps={eq.last_nsteps} "
                f"path={eq.last_fast_path} finite={finite} volume rel change {rel:.2e}")
    if not (eq.last_nsteps == 2 and eq.last_fast_path == "fused" and finite and rel <= VOL_TOL):
        raise AssertionError("callable-velocity main path check failed")


class PlainStepper(FusedStepper):
    """The fused stepper with each stage on the kernels' plain versions, to
    time the plain step on the card (``integrate`` never routes a CUDA
    tensor there)."""

    def stage(self, P, coeffs, t_stage, aux):
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
    res["t"] = t


def phase_profile(dev, res):
    """``torch.profiler`` over 3 RK3 steps of the 512^3 main path: the
    device busy share and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    grid, phi, vel = zalesak(N_MAIN, dev)
    eq = lsm.LevelSetEquation(terms=lsm.AdvectionTerm(vel), ic=phi, integrator=lsm.RK3())
    eq.integrate(1.0, max_steps=1)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eq.integrate(1.0, max_steps=3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    log("profile", f"3 RK3 steps at {N_MAIN}^3: wall {wall_us / 1e3:.3f} ms, device busy "
                   f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


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
    for name, run in (("k2", phase_k2), ("k1", phase_k1), ("k512", phase_k512),
                      ("slice", phase_slice), ("main", phase_main), ("timing", phase_timing),
                      ("profile", phase_profile)):
        t0 = time.perf_counter()
        run(dev, res)
        log(name, f"phase done in {time.perf_counter() - t0:.1f} s")
    t = res["t"]
    kernels = [
        {"name": "K1 fused_stage (WENO5 advection RK stage)", "route": "cuda",
         "source": "lsm_tpu_torch/csrc/weno_stage.cu", "replaces": "lsm_tpu/ops/weno_v2.py:667",
         "launches": res["launches"]["K1"], "max_abs_err": res["k1_err"],
         "ms": t["K1"], "plain_ms": t["K1_plain"]},
        {"name": "K2 refresh_ghosts_fast (ghost-shell refresh)", "route": "cuda",
         "source": "lsm_tpu_torch/csrc/refresh_ghosts.cu",
         "replaces": "lsm_tpu/ops/weno_v2.py:208",
         "launches": res["launches"]["K2"], "max_abs_err": res["k2_err"],
         "ms": t["K2"], "plain_ms": t["K2_plain"]},
    ]
    if not all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels):
        raise AssertionError("a kernel was not measured or not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
