"""Tile sweep of the narrow-band stepper on one card.

For each tile shape, on the band bench's 512^3 f32 sphere band (radius 0.5
on [-1, 1]^3, Extrapolation(2), rotation (-y, x, 0) as a callable, FE, dt =
0.25 h, re-tube every step): the dispatched tiles and nodes, the re-tube's
candidate tiles, CUDA-event medians of K6 (one stage) and K8 (one re-tube)
alone and of one FE stepper step, peak memory of the step, and the largest
difference of the state after 3 steps from the first tile shape's (the
results must not depend on the tiles).

From the repository root, on a machine with one H100:
    python3 tools/band_tile_sweep.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.core.narrowband import box_dilate  # noqa: E402
from lsm_tpu_torch.integrators.band_fused import FusedBandStepper  # noqa: E402
from lsm_tpu_torch.ops import band as bd  # noqa: E402

TILES = ((8, 8, 32), (8, 8, 64), (8, 8, 128), (8, 16, 32), (16, 16, 16), (16, 16, 32))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("band_tile_sweep: no CUDA device")
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    nb = cs.sphere_band(cs.N_MAIN, dev)
    shape, sp, halo = nb.shape, nb.grid.spacing, lsm.NarrowBandField.COMPUTE_HALO
    dt = 0.25 * nb.grid.min_spacing
    first = None
    for tiles in TILES:
        st = FusedBandStepper((lsm.AdvectionTerm(cs.spin),), nb, lsm.ForwardEuler(), tiles=tiles)
        state = st.pack(nb)
        P, out = state.bufs
        u = st.stage_terms(state, 0.0)
        _, valid = bd.tile_index(state.ids, shape, tiles)
        cids, _ = bd.compact_ids(box_dilate(state.act, 1), st.total)
        band = state.band.clone()
        k6 = cs.cuda_time(lambda: bd.band_stage(P, out, state.ids, state.band, u, (0.0, 1.0, dt),
                                                None, sp, shape, tiles))
        k8 = cs.cuda_time(lambda: bd.band_retube_incremental(P, band, cids, nb.nlayers, halo,
                                                             shape, tiles))
        step = cs.cuda_time(lambda: st.step(state, 0.0, dt))
        peak = cs.peak_gib(lambda: st.step(state, 0.0, dt))
        s = state
        for k in range(3):
            s = st.step(s, k * dt, dt)
        got = st.unpack(s)
        if first is None:
            first = got
        diff = float((got.values - first.values).abs().max())
        same_mask = torch.equal(got.mask, first.mask)
        print(f"tiles {tiles}: dispatched {int(state.count)} of {st.total} tiles "
              f"({int(valid.sum())} nodes), K8 candidates {int((cids >= 0).sum())}; "
              f"K6 {k6:.4f} ms, K8 {k8:.4f} ms, FE step {step:.4f} ms, peak {peak:.2f} GiB; "
              f"after 3 steps max|diff| from {TILES[0]} {diff:.3e}, masks equal {same_mask}",
              flush=True)
        del st, state, P, out, u, band, s, got


if __name__ == "__main__":
    main()
