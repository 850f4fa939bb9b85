"""Tile sweep of the narrow-band stepper on one card.

For each tile shape, on the band bench's 512^3 f32 sphere band (radius 0.5
on [-1, 1]^3, Extrapolation(2), rotation (-y, x, 0) as a callable, FE, dt =
0.25 h, re-tube every step): the dispatched tiles and nodes, the re-tube's
candidate tiles, CUDA-event medians of K6 (one stage) and K8 (one re-tube)
alone and of one FE stepper step (and the device's time in it, from
``torch.profiler``: the host's share of a step does not depend on the
tiles), peak memory of the step, and the largest
difference of the state after 3 steps from the first tile shape's (the
results must not depend on the tiles).

With ``--2d``: the same on D2b, the 2D band cell (configuration 2's Zalesak
disk at 4096^2 f32 as a 3-layer band, the rotation in-kernel, RK3, dt =
0.25 h), for the 2D tiles, with one RK3 stepper step and the ``integrate``
ms per step beside K6 and K8.

From the repository root, on a machine with one H100:
    python3 tools/band_tile_sweep.py [--2d]
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import lsm_tpu_torch as lsm  # noqa: E402
from lsm_tpu_torch.core.narrowband import box_dilate  # noqa: E402
from lsm_tpu_torch.integrators.band_fused import FusedBandStepper  # noqa: E402
from lsm_tpu_torch.ops import band as bd  # noqa: E402
from lsm_tpu_torch.ops import weno_v2 as v2  # noqa: E402

TILES, TILES_2D = cs.SWEEP_TILES, cs.SWEEP_TILES_2D


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("band_tile_sweep: no CUDA device")
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    if "--2d" in argv:
        terms, nb, integ = cs.d2b(cs.N_2D, dev)
        sweep, where = TILES_2D, v2.Where(nb.grid.lo)
    else:
        terms, nb, integ = (lsm.AdvectionTerm(cs.spin),), cs.sphere_band(cs.N_MAIN, dev), \
            lsm.ForwardEuler()
        sweep, where = TILES, None
    shape, sp, halo = nb.shape, nb.grid.spacing, lsm.NarrowBandField.COMPUTE_HALO
    dt = 0.25 * nb.grid.min_spacing
    first = None
    for tiles in sweep:
        st = FusedBandStepper(terms, nb, integ, tiles=tiles)
        state = st.pack(nb)
        # the 3-step check first, from a state of its own: the timed calls
        # below write the state's buffers and re-tube its band in place
        s = st.pack(nb)
        for k in range(3):
            s = st.step(s, k * dt, dt)
        got = st.unpack(s)
        if first is None:
            first = got
        diff = float((got.values - first.values).abs().max())
        same_mask = torch.equal(got.mask, first.mask)
        del s, got
        P, out = state.bufs[:2]
        u = st.stage_terms(state, 0.0)
        _, valid = bd.tile_index(state.ids, shape, tiles)
        cids, count = bd.compact_ids(box_dilate(state.act, 1), st.total)
        band = state.band.clone()
        k6 = cs.cuda_time(lambda: bd.band_stage(P, out, state.ids, state.band, u, (0.0, 1.0, dt),
                                                None, sp, shape, tiles, where))
        k8 = cs.cuda_time(lambda: bd.band_retube_incremental(P, band, cids, nb.nlayers, halo,
                                                             shape, tiles, count))
        step = cs.cuda_time(lambda: st.step(state, 0.0, dt))
        busy = cs.device_ms(lambda: st.step(state, 0.0, dt))
        peak = cs.peak_gib(lambda: st.step(state, 0.0, dt))
        run = ""
        if "--2d" in argv:
            with tiles_default(tiles):
                ms = cs.integrate_ms_per_step(terms, nb, integ, path="band")
            run = f", integrate {ms:.4f} ms/step"
        print(f"tiles {tiles}: dispatched {int(state.count)} of {st.total} tiles "
              f"({int(valid.sum())} nodes), K8 candidates {int((cids >= 0).sum())}; "
              f"K6 {k6:.4f} ms, K8 {k8:.4f} ms, {type(integ).__name__} step {step:.4f} ms "
              f"(device {busy:.4f}), "
              f"peak {peak:.2f} GiB{run}; after 3 steps max|diff| from {sweep[0]} {diff:.3e}, "
              f"masks equal {same_mask}", flush=True)
        del st, state, P, out, u, band


@contextlib.contextmanager
def tiles_default(tiles):
    """``integrate``'s band steppers built with ``tiles``."""
    init = FusedBandStepper.__init__

    def patched(self, *a, tiles=None, **k):
        init(self, *a, tiles=tiles_, **k)

    tiles_ = tiles
    FusedBandStepper.__init__ = patched
    try:
        yield
    finally:
        FusedBandStepper.__init__ = init


if __name__ == "__main__":
    main(sys.argv[1:])
