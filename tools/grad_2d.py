"""Time the dense 2D gradient's kernels and cells of this tree at 4096^2 f32,
in a process of its own (the smoke's ``grad_2d`` phase runs it so; later in
a long process the profiler under-reads device times, PERF.md section 7).

Run from the root of a tree of this repository (its own ``chip_smoke``
helpers and package), on a machine with one H100:

    python3 tools/grad_2d.py [label]

On the inputs of the smoke's 2D gradient cells (``chip_smoke.grad2d_cell``):
K4's 2D entry on a random cotangent of grad2d's layout beside ``g.clone()``
(its copy floor) and its plain version; K5's 2D entry beside
``masked_fill_`` and its plain version; K3's 2D entry on grad2d_streamed's
state (the rotation streamed, du written), K3''s on grad2d's (the rotation
in-kernel; the vortex with the stage time's cotangent), K3''s on
grad2d_kinds' (curvature and normal motion at a streamed speed), each beside
its plain version; for each a CUDA-event median (``chip_smoke.cuda_time``)
and the profiler's device time a call (``chip_smoke.device_ms``). Then each
cell's value_and_grad with every stage the plain 2D stage and refresh under
autograd (the route a 2D gradient took on the CPU before the 2D backward
kernels): ms (event median) and peak memory, the yardstick beside the
kernels' cells. Prints one line, ``GRAD2D <label> key value ...``.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.integrators.fused import FusedStepper  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402
from lsm_tpu_torch.ops import weno_v2_bwd as bwd  # noqa: E402


def plain_stage(self, P, coeffs, t_stage, aux, coeff_values=None, t_value=None, entries=None):
    """A stepper's stage as the plain 2D stage and refresh (autograd: the
    yardstick)."""
    return v2.stage_refresh_plain(P, self.stage_terms(t_stage, entries), coeffs, aux, self.bcs,
                                  self.spacing, self.shape, v2.Where(self.lo, None, t_stage))


def main(label: str) -> None:
    dev = torch.device("cuda", 0)
    out = {}
    n = cs.N_2D

    def timed(key, fn, plain=False):
        out[key] = cs.cuda_time(fn, warmup=1 if plain else 3, reps=5 if plain else 20)
        if not plain:
            out[f"{key}_device"] = cs.device_ms(fn)

    gen = torch.Generator(device=dev).manual_seed(8)
    # K4 and K5 on grad2d's layout (Periodic)
    phi, terms_of, _, dt, _ = cs.grad2d_cell("grad2d", n, dev)
    shape, bcs, sp = phi.shape, phi.bcs, phi.spacing
    G = torch.randn(v2.padded_shape(shape), generator=gen, device=dev)
    timed("K4_2d", lambda: bwd.fold_ghost_cotangent_fast(G, bcs, shape))
    timed("K4_2d_clone", lambda: G.clone())
    timed("K4_2d_plain", lambda: bwd.fold_ghost_cotangent_plain(G.clone(), bcs, shape), True)
    mask = cs.shell_mask(shape, dev)
    timed("K5_2d", lambda: bwd.zero_pad_shells(G, shape))
    timed("K5_2d_library", lambda: G.masked_fill_(mask, 0.0))
    timed("K5_2d_plain", lambda: bwd.zero_pad_shells_plain(G, shape), True)
    del mask
    gf = bwd.fold_ghost_cotangent_fast(G, bcs, shape)
    # K3'' on grad2d's state (the rotation; the vortex with dt), K3 on grad2d_streamed's
    st = FusedStepper(terms_of(None), phi, lsm.RK3())
    P = st.pack(phi.values)
    where = v2.Where(st.lo, None, 0.0)
    prog = st.entries[0][0].coef_static
    coeffs = (0.0, 1.0, dt)
    timed("K3pp_2d", lambda: bwd.stage_backward(P, prog, coeffs, None, gf, sp, shape,
                                                where=where))
    timed("K3pp_2d_plain", lambda: bwd.stage_backward_plain(P, prog, coeffs, None, gf, sp, shape,
                                                            where=where), True)
    vortex = FusedStepper((lsm.AdvectionTerm(cs.shapes.vortex_velocity(period=4.0)),), phi,
                          lsm.RK3()).entries[0][0].coef_static
    where3 = v2.Where(st.lo, None, cs.T_STAGE)
    timed("K3pp_2d_vortex_dt", lambda: bwd.stage_backward(P, vortex, coeffs, None, gf, sp, shape,
                                                          where=where3, need_dt=True))
    sphi, sterms_of, _, _, _ = cs.grad2d_cell("grad2d_streamed", n, dev)
    u = FusedStepper(sterms_of(None), sphi, lsm.RK3()).entries[0][1]
    timed("K3_2d", lambda: bwd.stage_backward(P, u, coeffs, None, gf, sp, shape))
    timed("K3_2d_aux", lambda: bwd.stage_backward(P, u, (0.75, 0.25, dt), P, gf, sp, shape))
    timed("K3_2d_plain", lambda: bwd.stage_backward_plain(P, u, coeffs, None, gf, sp, shape),
          True)
    del st, P, u, sphi
    # K3' on grad2d_kinds' state and terms
    kphi, kterms_of, s, kdt, _ = cs.grad2d_cell("grad2d_kinds", n, dev)
    kst = FusedStepper(kterms_of(s), kphi, lsm.RK3())
    KP, kbcs = kst.pack(kphi.values), kphi.bcs
    kgf = bwd.fold_ghost_cotangent_fast(G, kbcs, shape)
    kcoeffs = (0.0, 1.0, kdt)
    timed("K3k_2d", lambda: bwd.stage_backward_terms(KP, kst.entries, kcoeffs, None, kgf,
                                                     kphi.spacing, shape))
    timed("K3k_2d_plain", lambda: bwd.stage_backward_terms_plain(
        KP, kst.entries, kcoeffs, None, kgf, kphi.spacing, shape), True)
    del kst, KP, kgf, G, gf
    torch.cuda.empty_cache()
    # the yardstick: each cell with the plain 2D stage and refresh under autograd
    FusedStepper.stage = plain_stage
    for name in cs.GRAD2D_CELLS:
        cphi, cterms_of, cs_, cdt, nsteps = cs.grad2d_cell(name, n, dev)
        call = lambda: cs.grad2d_value_and_grad(cphi, cterms_of, cs_, cdt, nsteps,
                                                cphi.values.clone().requires_grad_())
        out[f"{name}_plain_autograd_ms"] = cs.cuda_time(call, warmup=1, reps=3)
        out[f"{name}_plain_autograd_peak_gib"] = cs.peak_gib(call)
        del cphi, call
        torch.cuda.empty_cache()
    print(cs.nvidia_smi())
    print("GRAD2D", label, " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.getcwd())
