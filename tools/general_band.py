"""Time K11 (the general path's 2D stage), K7 (the band's gated ghost
refresh, 3D and 2D) and K2 (the ghost refresh whose threads K7 shares) of
this tree on the card, in a process of its own (the smoke's timing runs it
so: later in a long process the profiler under-reads device times, PERF.md
section 7).

Run from the root of a tree of this repository (its own ``chip_smoke``
helpers and package), on a machine with one H100:

    python3 tools/general_band.py [label] [--cells] [--k2] [--save PATH]

The calls (f32 unless said):
- K11 at N_2D^2 on D2h's stage inputs (config 2's field padded by
  ``MeshField.pad(3)``, its rotation sampled on the grid, dt half the CFL
  bound), without and with aux (the field's interior);
- K7 at 512^3 on the band cells' buffer (``chip_smoke.sphere_band``: the
  sphere packed under ``Extrapolation(2)``), flags on (1, 1) and off (0, 0);
- K7's 2D entry at N_2D^2 on D2b's buffer, on and off;
- with ``--k2``, K2 on the same 512^3 buffer under ``Extrapolation(2)`` and
  under ``Periodic`` (its instantiation without extrapolation's code), and
  K2's 2D entry on D2b's buffer in f32 and in f64.
For each: the CUDA-event median (``chip_smoke.cuda_time``), the time a call
of 50 issued back to back (``back_to_back_ms``) and the profiler's device
time a call (``device_ms``). ``--cells`` adds ``integrate`` ms per step of
D2h (K11 a stage), the 512^3 band RK3 (K7 a stage, gated off) and D2b (K7's
2D entry a stage). ``--save`` writes the kernels' outputs on those inputs
(K11 without and with aux; K7 under each of the four flags and K2 on the
buffers with their shells scribbled from a seeded generator) for a
comparison of two trees' bits. Prints one line, ``GENBAND <label> key value ...``.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.ops import band as bd  # noqa: E402
from lsm_tpu_torch.ops import weno_general as wg  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402

FLAGS = ((1, 1), (1, 0), (0, 1), (0, 0))


def k11_inputs(dev):
    """D2h's stage inputs at N_2D^2: ``(P, u, aux, spacing, shape, dt)``."""
    terms, phi, _ = cs.config("D2h", cs.N_2D, dev)
    u = wg._components(terms[0].velocity(phi.grid.coords(dtype=phi.dtype, device=dev), 0.0),
                       phi.shape, phi.values)
    dt = 0.5 * float(lsm.compute_cfl(terms, phi, 0.0))
    return phi.pad(v2.GHOST), u, phi.values.contiguous(), phi.spacing, phi.shape, dt


def k7_buffers(dev):
    """``{"3d": (P, bcs, shape), "2d": ...}``: the 512^3 band cells' and D2b's
    packed buffers."""
    nb = cs.sphere_band(cs.N_MAIN, dev)
    out = {"3d": (v2.pack_padded(nb.values, nb.bcs), nb.bcs, nb.shape)}
    del nb
    _, nb2, _ = cs.d2b(cs.N_2D, dev)
    out["2d"] = (v2.pack_padded(nb2.values, nb2.bcs), nb2.bcs, nb2.shape)
    return out


def k2_buffers(bufs):
    """``{label: (P, bcs, shape)}``: K2's calls on K7's buffers (copies)."""
    P3, bcs3, shape3 = bufs["3d"]
    P2, bcs2, shape2 = bufs["2d"]
    return {"3d": (P3.clone(), bcs3, shape3),
            "3d_periodic": (P3.clone(), lsm.normalize_bcs(lsm.Periodic(), 3), shape3),
            "2d": (P2.clone(), bcs2, shape2), "2d_f64": (P2.double(), bcs2, shape2)}


def outputs(k11, bufs, dev):
    """The kernels' outputs for a comparison of bits: K11 without and with
    aux, K7 under each flag and K2 on its buffer with scribbled shells."""
    P, u, aux, sp, shape, dt = k11
    out = {"K11": wg.weno_stage_2d(P, u, sp, shape, (0.0, 1.0, dt)).cpu(),
           "K11_aux": wg.weno_stage_2d(P, u, sp, shape, (0.75, 0.25, dt), aux).cpu()}
    gen = torch.Generator(device=dev).manual_seed(18)
    for dims, (Q, bcs, kshape) in bufs.items():
        shell = cs.shell_mask(kshape, dev)
        S = Q.clone()
        S[shell] = torch.randn(int(shell.sum()), generator=gen, device=dev, dtype=Q.dtype)
        for flags in FLAGS:
            f = torch.tensor(flags, dtype=torch.int32, device=dev)
            got = bd.refresh_band_ghosts_fast(S.clone(), bcs, kshape, f)
            out[f"K7_{dims}_{flags[0]}{flags[1]}"] = got[shell].cpu()
        del S, shell
    for label, (Q, bcs, kshape) in k2_buffers(bufs).items():
        shell = cs.shell_mask(kshape, dev)
        Q[shell] = torch.randn(int(shell.sum()), generator=gen, device=dev, dtype=Q.dtype)
        out[f"K2_{label}"] = v2.refresh_ghosts_fast(Q, bcs, kshape)[shell].cpu()
        del Q, shell
    return out


def main(argv) -> None:
    label = argv[0] if argv and not argv[0].startswith("--") else os.getcwd()
    save = argv[argv.index("--save") + 1] if "--save" in argv else None
    dev = torch.device("cuda", 0)
    k11 = k11_inputs(dev)
    bufs = k7_buffers(dev)
    if save:
        torch.save(outputs(k11, bufs, dev), save)
    P, u, aux, sp, shape, dt = k11
    on = torch.ones(2, dtype=torch.int32, device=dev)
    off = torch.zeros(2, dtype=torch.int32, device=dev)
    P3, bcs3, shape3 = bufs["3d"]
    P2, bcs2, shape2 = bufs["2d"]
    k2 = k2_buffers(bufs) if "--k2" in argv else {}
    calls = {
        "K11": lambda: wg.weno_stage_2d(P, u, sp, shape, (0.0, 1.0, dt)),
        "K11_aux": lambda: wg.weno_stage_2d(P, u, sp, shape, (0.75, 0.25, dt), aux),
        "K7": lambda: bd.refresh_band_ghosts_fast(P3, bcs3, shape3, on),
        "K7_off": lambda: bd.refresh_band_ghosts_fast(P3, bcs3, shape3, off),
        "K7_2d": lambda: bd.refresh_band_ghosts_fast(P2, bcs2, shape2, on),
        "K7_2d_off": lambda: bd.refresh_band_ghosts_fast(P2, bcs2, shape2, off),
        **{f"K2_{label}": (lambda args=args: v2.refresh_ghosts_fast(*args))
           for label, args in k2.items()},
    }
    out = {}
    for key, fn in calls.items():
        out[f"{key}_event"] = cs.cuda_time(fn)
        out[f"{key}_b2b"] = cs.back_to_back_ms(fn)
        out[f"{key}_device"] = cs.device_ms(fn)
    del calls, k11, bufs, k2, P, u, aux, P3, P2
    torch.cuda.empty_cache()
    if "--cells" in argv:
        terms, phi, integ = cs.config("D2h", cs.N_2D, dev)
        out["D2h_ms"] = cs.integrate_ms_per_step(terms, phi, integ, path=None,
                                                 posthook=lambda e: None)
        del terms, phi, integ
        nb = cs.sphere_band(cs.N_MAIN, dev)
        out["band_RK3_ms"] = cs.integrate_ms_per_step(lsm.AdvectionTerm(cs.spin), nb, lsm.RK3(),
                                                      path="band")
        del nb
        torch.cuda.empty_cache()
        terms, nb2, integ = cs.d2b(cs.N_2D, dev)
        out["D2b_ms"] = cs.integrate_ms_per_step(terms, nb2, integ, path="band")
    print(cs.nvidia_smi())
    print("GENBAND", label, " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
