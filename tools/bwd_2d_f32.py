"""Where a float32 2D stage adjoint leaves the float64 oracle: one case of
the smoke's ``grad2d_parity`` taken apart output by output.

The inputs are ``chip_smoke.bwd_2d_inputs``' (the smoke's own draws, so a
case on the card is the case the smoke checked). For each case of K3/K3''
2D (``chip_smoke.bwd_2d_cases``) at the given shape and boundary condition,
with and without aux, prints per output (dP folded to the interior, each
stream cotangent, each entry of dcoef, daux's interior) the error relative
to ``max|ref|`` of the f32 kernel and of its f32 plain version against the
f64 oracle (float32's WENO epsilon floor), of the kernel against the plain
version, and of the float64 plain version on the f32 input (the f64
buffer rounded to float32, ghosts included) against the oracle: where that
misses as far as the f32 version, the miss comes from the rounding of the
input, not from float32 arithmetic. For dP: the node of the plain
version's largest error, its distance to each face, the values there and,
along an axis whose face is within 3 nodes, the differences of P from the
node through the face's ghosts in both buffers. On the CPU the kernel's
column is the plain version's (the wrappers run it there).

From the repository root:
    python3 tools/bwd_2d_f32.py 129,251 extrap1 [--save out.pt] [--cpu]

``--save`` writes the case's float64 inputs (P64, A64, G64 and the shape)
for a look on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402
from lsm_tpu_torch.ops import weno_v2_bwd as bwd  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", help="n0,n1: a chip_smoke.BWD_2D_SHAPES shape")
    ap.add_argument("bc", help="a chip_smoke.BWD_2D_BCS name")
    ap.add_argument("--save", help="write the case's float64 inputs here")
    ap.add_argument("--cpu", action="store_true", help="on the CPU (the plain versions)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("bwd_2d_f32: no CUDA device (--cpu for the plain versions)")
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    shape = tuple(int(x) for x in args.shape.split(","))
    want, save = args.bc, args.save
    where = v2.Where((0.0, 0.0), None, cs.T_STAGE)
    d = lambda t: None if t is None else t.float()
    if not args.cpu:
        print(cs.nvidia_smi(), flush=True)
    for got_shape, bc_name, phi64, P64, A64, G64, cases in cs.bwd_2d_inputs(dev):
        if got_shape != shape or bc_name != want:
            continue
        bcs, sp = phi64.bcs, phi64.spacing
        if save:
            torch.save({"shape": shape, "bc": bc_name, "P64": P64.cpu(), "A64": A64.cpu(),
                        "G64": G64.cpu()}, save)
        for label, (kernel, terms64) in cases.items():
            if kernel == "K3' 2D":
                continue
            terms32 = cs.cast_terms(terms64, torch.float32)
            for aux, coeffs in ((None, (0.0, 1.0, 0.03)), (A64, (0.75, 0.25, 0.03))):
                gf32 = bwd.fold_ghost_cotangent_fast(d(G64), bcs, shape)
                run = lambda plain: cs.bwd_2d_outputs(
                    cs.bwd_2d_run(d(P64), terms32, coeffs, d(aux), gf32, sp, shape, where,
                                  plain=plain), bcs, shape, True)
                got, plain = run(False), run(True)
                with cs.f32_weno_floor():
                    rounded = cs.bwd_2d_outputs(cs.bwd_2d_run(
                        P64.float().double(), terms64, coeffs, aux, bwd.fold_ghost_cotangent_fast(
                            G64, bcs, shape), sp, shape, where, plain=True), bcs, shape, True)
                with cs.f32_weno_floor():
                    ref = cs.bwd_2d_outputs(bwd.composite_backward_autograd(
                        P64, terms64, coeffs, aux, G64, bcs, sp, shape, where), bcs, shape, True)
                for name in ref:
                    print(f"CASE {label} {bc_name} {shape} aux={aux is not None} {name}: "
                          f"max|ref| {float(ref[name].abs().max()):.6e}, kernel vs oracle "
                          f"{cs.rel_err(got[name], ref[name]):.3e}, plain vs oracle "
                          f"{cs.rel_err(plain[name], ref[name]):.3e}, kernel vs plain "
                          f"{cs.rel_err(got[name], plain[name]):.3e}, f64 plain on the f32 input vs "
                          f"oracle {cs.rel_err(rounded[name], ref[name]):.3e}", flush=True)
                err = (plain["dP"].double() - ref["dP"].double()).abs()
                flat = int(err.argmax())
                i, j = divmod(flat, shape[1])
                print(f"WORST {label} aux={aux is not None} dP node ({i}, {j}) of {shape}: "
                      f"faces at {i}, {shape[0] - 1 - i}, {j}, {shape[1] - 1 - j} nodes; "
                      f"oracle {float(ref['dP'][i, j]):.9e}, plain f32 "
                      f"{float(plain['dP'][i, j]):.9e}, kernel {float(got['dP'][i, j]):.9e}; "
                      f"next largest errors "
                      + ", ".join(f"{float(v):.3e}@{divmod(int(x), shape[1])}" for v, x in
                                  zip(*torch.topk(err.flatten(), 6))), flush=True)
                H = v2.GHOST
                for axis, m in enumerate((i, j)):
                    n = shape[axis]
                    if min(m, n - 1 - m) > 3:
                        continue
                    lo, hi = (0, m + H + 1) if m <= 3 else (m + H, n + 2 * H)
                    line = lambda B: (B[:, j + H] if axis == 0 else B[i + H]).double()[lo:hi]
                    print(f"DIFFS {label} axis {axis} padded {lo} .. {hi - 1}: f64 "
                          + " ".join(f"{float(x):.12e}" for x in line(P64).diff())
                          + "; f32 " + " ".join(f"{float(x):.12e}"
                                                for x in line(P64.float()).diff()), flush=True)
        return 0
    raise SystemExit(f"bwd_2d_f32: no case {shape} {want} in chip_smoke.BWD_2D_SHAPES")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
