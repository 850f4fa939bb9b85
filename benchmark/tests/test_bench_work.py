"""The work counts against hand counts at small shapes."""

import json

import pytest

from benchmark import inputs, work
from benchmark.tests.conftest import ROOT


def cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_forward_step_of_the_rotation():
    terms = cfg("zalesak_sphere_512")["terms"]
    # three stages of WENO5 on three axes (80 each) and the in-kernel velocity
    # (2), the RK combination 3 + 5 + 5, and the CFL bound of the callable (11)
    assert work.forward_step(terms, "float32") == (3 * (240 + 2) + 13 + 11, 4 * (2 + 3 + 3))


def test_forward_step_of_curvature_and_normal_motion():
    terms = cfg("torus_mcf_512")["terms"]
    # 63 + 115 + one sum per stage, the RK combinations, no CFL pass
    assert work.forward_step(terms, "float32") == (3 * (63 + 115 + 1) + 13, 32)


def test_gradient_call_counts_the_streamed_speed():
    c = cfg("torus_mcf_512")
    terms = inputs.terms_of(c, "gradient")
    ops, nbytes = work.gradient_call(terms, "float32", 3, 1)
    fwd_ops = 3 * (63 + 115 + 1) + 13
    adj_ops = 3 * (5 + 2 * 63 + 2 * 115)
    assert ops == 3 * (fwd_ops + adj_ops) + 3
    # forward: 8 + 12 + 12 bytes plus the speed (4) in each stage; backward:
    # 12 + 20 + 20 plus 12 a stage for the speed and its cotangent
    assert nbytes == 3 * ((32 + 12) + (52 + 36)) + 4


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_least_seconds_is_the_larger_bound(dtype):
    nodes = 10 ** 6
    assert work.least_seconds(100, 4, nodes, dtype) == pytest.approx(
        max(4 * nodes / 3.35e12, 100 * nodes / work.PEAK_FLOPS[dtype]))
    assert work.least_seconds(1, 400, nodes, dtype) == pytest.approx(400 * nodes / 3.35e12)
