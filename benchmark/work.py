"""The work a cell's unit needs, counted from its shapes as the algorithm
needs it, and the least time one H100 needs for it.

The counts do not depend on how the program implements a step: each input
byte is read once and each output byte written once, whatever a kernel
reads again; each arithmetic operation of the scheme is counted once per
node (a difference shared by neighbouring stencils once, a comparison,
selection, division, root or power as one). They are a yardstick that stays
put while the program changes, not a model of any kernel.

Per node and stage (counted from the formulas of ``reference.py``):

- WENO5 advection, per axis: the shared backward difference and its scale
  (2), the upwind selection (1), the differences of differences (7), the
  three candidate stencils (12), the indicators' pieces (5) and indicators
  (15), ``max v_i^2`` (9), epsilon and its reciprocal (3), the weights (17),
  the weighted sum and the velocity (8), the sum over axes (1): 80;
- its adjoint, per axis: 141 (the reversed chain, 123, and the scatter of
  the six differences' cotangents, 18);
- normal motion (Godunov on ENO2): 115; curvature: 63; the adjoint of
  either is counted as twice its forward;
- the RK combination ``alpha*aux + beta*phi - gamma*H``: 5 (3 without aux),
  its adjoint 5;
- the CFL bound of a callable velocity: 11 (the velocity, three absolute
  values, three scalings, two sums, a maximum), of a streamed one 9 plus
  its bytes; of a constant coefficient nothing.

Bytes per stage: the input and the output state, the aux state where there
is one, each streamed coefficient component; in a backward stage the input
state, the output's cotangent and the input's, the aux cotangent (read and
written), and per differentiated stream its value and its cotangent (read
and written).
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense FP32 outside the
# tensor cores (FP64 half of it), at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
DTYPE_BYTES = {"float32": 4, "float64": 8}

WENO_AXIS = 80
WENO_AXIS_ADJOINT = 141
TERM_OPS = {"normal": 115, "curvature": 63}
RK_OPS = (3, 5)  # without, with aux
RK_ADJOINT = 5
CFL_CALLABLE = 11
CFL_STREAMED = 9
LOSS_OPS = 3  # the square, the sum, the cotangent


def _velocity_ops(term) -> int:
    """Operations of a callable velocity per node (``rigid_rotation``: two
    affine components)."""
    v = term.get("velocity")
    return 2 if isinstance(v, dict) and v.get("kind") == "rigid_rotation" else 0


def _streams(term) -> int:
    """Streamed components a term reads per node."""
    c = term.get("velocity" if term["kind"] == "advection" else "coef")
    if isinstance(c, dict) and c.get("kind") == "linear_field":
        return 3 if term["kind"] == "advection" else 1
    return 0


def stage_ops(terms, aux: bool) -> int:
    ops = RK_OPS[1 if aux else 0] + (len(terms) - 1)
    for t in terms:
        if t["kind"] == "advection":
            ops += 3 * WENO_AXIS + _velocity_ops(t)
        else:
            ops += TERM_OPS[t["kind"]]
    return ops


def stage_adjoint_ops(terms) -> int:
    ops = RK_ADJOINT
    for t in terms:
        ops += 3 * WENO_AXIS_ADJOINT if t["kind"] == "advection" else 2 * TERM_OPS[t["kind"]]
    return ops


def stage_bytes(terms, aux: bool, b: int) -> int:
    return b * (2 + (1 if aux else 0) + sum(_streams(t) for t in terms))


def stage_adjoint_bytes(terms, aux: bool, b: int, differentiated_streams: int) -> int:
    return b * (3 + (2 if aux else 0) + 3 * differentiated_streams)


def cfl_ops(terms) -> int:
    ops = 0
    for t in terms:
        if t["kind"] == "advection":
            ops += CFL_STREAMED if _streams(t) else CFL_CALLABLE
        elif _streams(t):
            ops += 2
    return ops


def cfl_bytes(terms, b: int) -> int:
    return b * sum(_streams(t) for t in terms)


def rk3_step(terms, b: int):
    """(operations, bytes) per node of one RK3 step."""
    ops = sum(stage_ops(terms, aux) for aux in (False, True, True))
    return ops, sum(stage_bytes(terms, aux, b) for aux in (False, True, True))


def forward_step(terms, dtype: str):
    """(operations, bytes) per node of one accepted step of ``integrate``:
    the CFL bound and the RK3 step."""
    b = DTYPE_BYTES[dtype]
    ops, nbytes = rk3_step(terms, b)
    return ops + cfl_ops(terms), nbytes + cfl_bytes(terms, b)


def gradient_call(terms, dtype: str, nsteps: int, differentiated_streams: int):
    """(operations, bytes) per node of one loss-and-gradient call: the
    rollout, the loss, and the reverse sweep of every stage."""
    b = DTYPE_BYTES[dtype]
    ops, nbytes = rk3_step(terms, b)
    adj_ops = 3 * stage_adjoint_ops(terms)
    adj_bytes = sum(stage_adjoint_bytes(terms, aux, b, differentiated_streams)
                    for aux in (False, True, True))
    return (nsteps * (ops + adj_ops) + LOSS_OPS,
            nsteps * (nbytes + adj_bytes) + b)


def least_seconds(ops_per_node: int, bytes_per_node: int, nodes: int, dtype: str) -> float:
    """The larger of the bytes over the bandwidth and the operations over
    the peak rate."""
    return max(bytes_per_node * nodes / PEAK_BYTES_PER_S, ops_per_node * nodes / PEAK_FLOPS[dtype])


def nodes_of(shape) -> int:
    return math.prod(shape)
